"""The port's multires path (bhr_tpu_torch/ops/multires.py, and the strided
and masked ray-gen of ops/trace_kernel.trace_image) against bhr_tpu's, on
the CPU: the wrappers run their plain versions, bhr_tpu's Pallas kernel
runs in interpret mode (as its own tests/test_multires.py runs it).

Bars. The strided plain trace equals the full plain trace at pixels
(i d, j d) bit for bit in both tiers, and the masked one equals the
unmasked one bit for bit where the mask keeps. Against bhr_tpu's kernel the
chaos-aware bars of tests/test_pallas_parity.py:46-61 hold where the mask
keeps: status equal on >= 99.5% of pixels, directions within 1e-4 on >=
99.5% of the matched, uncaptured ones. A multires frame agrees with
bhr_tpu's within 1 level on >= 99% of pixels, and with the port's own full
render at bhr_tpu's budget (tests/test_multires.py:97-151: mean u8 error
< 3.0, pixels off by > 16 levels under 4%).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bhr_tpu as J
import bhr_tpu_torch as T
from bhr_tpu.models.disk import DiskParams as JDiskParams
from bhr_tpu.ops import multires as jm
from bhr_tpu.ops.pallas_trace import pallas_trace_image
from bhr_tpu_torch.models.disk import DiskParams
from bhr_tpu_torch.ops import multires as tm
from bhr_tpu_torch.ops import trace_kernel
from bhr_tpu_torch.ops.trace import STATUS_CAPTURED, STATUS_ESCAPED
from bhr_tpu_torch.utils.tracing import COUNTS

W, H, STEPS = 96, 66, 200  # 66 and 96 are not multiples of every divisor
DISK_CAM = ([0.0, 3.0, 20.0], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0])
FIELDS = ("final_pos", "final_vel", "status", "steps")


def _scenes(w=W, h=H, steps=STEPS, spin=0.0):
    return (J.SceneParams(screen_width=w, screen_height=h, max_steps=steps,
                          spin=np.float32(spin)),
            T.SceneParams(screen_width=w, screen_height=h, max_steps=steps, spin=spin))


def _ceil(n, d):
    return -(-n // d)


CONFIGS = [dict(), dict(integrator="rk4", adaptive=True, disk=True), dict(model="kerr"),
           dict(integrator="leapfrog", model="kerr_lt", disk=True)]
CONFIG_IDS = ["euler", "rk4-adaptive-disk", "kerr", "leapfrog-kerr_lt-disk"]


@pytest.mark.parametrize("fast", [False, True], ids=["exact", "fast"])
@pytest.mark.parametrize("kw", CONFIGS, ids=CONFIG_IDS)
@pytest.mark.parametrize("d", [2, 3])
def test_strided_reference_equals_full_trace_at_grid_points(kw, fast, d):
    _, scene = _scenes(48, 34, 120, 0.9)
    cam = T.Camera.new(*DISK_CAM)
    cfg = T.TraceConfig(**kw)
    full = trace_kernel.trace_image_reference(cam, scene, cfg, fast_math=fast, device="cpu")
    low = trace_kernel.trace_image_reference(cam, scene, cfg, fast_math=fast, device="cpu",
                                             stride=d, local_shape=(_ceil(34, d), _ceil(48, d)))
    for f in FIELDS:
        assert torch.equal(getattr(low, f), getattr(full, f)[::d, ::d]), f


def test_strided_band_offsets():
    """row0 / col0 place the strided grid: local (i, j) is full pixel
    (i d + row0, j d + col0)."""
    _, scene = _scenes(48, 34, 80)
    cam = T.Camera.default()
    full = trace_kernel.trace_image(cam, scene, device="cpu")
    part = trace_kernel.trace_image(cam, scene, device="cpu", stride=3, local_shape=(5, 7),
                                    row0=4, col0=9)
    for f in FIELDS:
        assert torch.equal(getattr(part, f), getattr(full, f)[4:4 + 15:3, 9:9 + 21:3]), f
    band = trace_kernel.trace_image(cam, scene, device="cpu", local_shape=(10, 48), row0=12)
    assert torch.equal(band.final_vel, full.final_vel[12:22])


def test_strided_and_mask_arguments_are_checked():
    _, scene = _scenes(16, 8, 4)
    cam = T.Camera.default()
    with pytest.raises(ValueError, match="local_shape"):
        trace_kernel.trace_image(cam, scene, device="cpu", stride=2)
    with pytest.raises(ValueError, match="stride"):
        trace_kernel.trace_image(cam, scene, device="cpu", stride=0, local_shape=(4, 8))
    for bad in (torch.ones(4, 8), torch.ones(8, 16, dtype=torch.float64),
                torch.ones(16, 8).t(), np.ones((8, 16), np.float32)):
        with pytest.raises(ValueError, match="mask"):
            trace_kernel.trace_image(cam, scene, device="cpu", mask=bad)


@pytest.mark.parametrize("fast", [False, True], ids=["exact", "fast"])
@pytest.mark.parametrize("kw", CONFIGS, ids=CONFIG_IDS)
def test_masked_reference_keeps_and_fills(kw, fast):
    """mask > 0: the unmasked trace, bit for bit. Elsewhere the stated
    values: the camera position, the initial unit direction, escaped, 0
    steps."""
    _, scene = _scenes(48, 34, 120, 0.9)
    cam = T.Camera.new(*DISK_CAM)
    cfg = T.TraceConfig(**kw)
    mask = (torch.from_numpy(np.random.default_rng(0).random((34, 48))) > 0.6).float()
    mask[10:14] = 0.5  # any positive value keeps
    mask[20] = -1.0
    full = trace_kernel.trace_image(cam, scene, cfg, fast_math=fast, device="cpu")
    got = trace_kernel.trace_image(cam, scene, cfg, fast_math=fast, device="cpu", mask=mask)
    keep = mask > 0
    for f in FIELDS:
        assert torch.equal(getattr(got, f)[keep], getattr(full, f)[keep]), f
    off = ~keep
    assert bool((got.status[off] == STATUS_ESCAPED).all()) and int(got.steps[off].sum()) == 0
    assert torch.equal(got.final_pos[off], cam.position.expand(34, 48, 3)[off])
    _, dirs = T.generate_rays(cam, 48, 34, scene.fov)
    torch.testing.assert_close(got.final_vel[off], dirs[off], rtol=0, atol=2e-7)
    # out= receives the same planes
    out = trace_kernel.empty_trace_result(34, 48, "cpu")
    trace_kernel.trace_image(cam, scene, cfg, fast_math=fast, device="cpu", mask=mask, out=out)
    for f in FIELDS:
        assert torch.equal(getattr(out, f), getattr(got, f)), f


def _assert_match_chaotic(got, want, keep, frac=0.995, vel_atol=1e-4):
    st_t, st_j = got.status.numpy(), np.asarray(want.status)
    same = (st_t == st_j)[keep]
    assert same.mean() >= frac, f"status agrees on {same.mean():.4f}"
    m = keep & (st_t == st_j) & (st_j != STATUS_CAPTURED)
    vd = np.abs(got.final_vel.numpy() - np.asarray(want.final_vel)).max(-1)[m]
    assert (vd <= vel_atol).mean() >= frac, f"vel close on {(vd <= vel_atol).mean():.4f}"


@pytest.mark.parametrize("fast", [False, True], ids=["exact", "fast"])
@pytest.mark.parametrize("kw", [dict(), dict(integrator="rk4", disk=True)],
                         ids=["euler", "rk4-disk"])
def test_strided_and_masked_match_pallas_interpret(kw, fast):
    jscene, scene = _scenes(64, 36, 150)
    jcam, cam = J.Camera.new(*DISK_CAM), T.Camera.new(*DISK_CAM)
    d = 3
    local = (_ceil(36, d), _ceil(64, d))
    want = pallas_trace_image(jcam, jscene, J.TraceConfig(**kw), interpret=True, fast_math=fast,
                              track_steps=False, local_shape=local, stride=d)
    got = trace_kernel.trace_image(cam, scene, T.TraceConfig(**kw), fast_math=fast, device="cpu",
                                   stride=d, local_shape=local)
    _assert_match_chaotic(got, want, np.ones(local, bool))
    mask = np.zeros((36, 64), np.float32)
    mask[8:30, 10:50] = 1.0
    want = pallas_trace_image(jcam, jscene, J.TraceConfig(**kw), interpret=True, fast_math=fast,
                              track_steps=False, mask=jnp.asarray(mask))
    got = trace_kernel.trace_image(cam, scene, T.TraceConfig(**kw), fast_math=fast, device="cpu",
                                   mask=torch.from_numpy(mask))
    _assert_match_chaotic(got, want, mask > 0)
    # masked off: both leave an escaped ray with its initial direction
    off = mask <= 0
    assert (np.asarray(want.status)[off] == STATUS_ESCAPED).all()
    np.testing.assert_allclose(got.final_vel.numpy()[off], np.asarray(want.final_vel)[off],
                               rtol=0, atol=1e-6)


def test_deflection_edges_equals_jax():
    _, scene = _scenes(60, 40, 200)
    low = trace_kernel.trace_image(T.Camera.default(), scene, fast_math=True, device="cpu")
    assert bool((low.status == STATUS_CAPTURED).any()), "the scene must contain a shadow"
    planes = [low.final_vel[..., k] for k in range(3)]
    for threshold in (0.05, 0.2):
        got = tm.deflection_edges(planes, low.status, threshold).numpy()
        want = np.asarray(jm.deflection_edges([jnp.asarray(p.numpy()) for p in planes],
                                              jnp.asarray(low.status.numpy()), threshold))
        np.testing.assert_array_equal(got, want)
    st = low.status.numpy()
    boundary = np.zeros_like(st, bool)
    boundary[:-1] |= st[:-1] != st[1:]
    boundary[1:] |= st[1:] != st[:-1]
    boundary[:, :-1] |= st[:, :-1] != st[:, 1:]
    boundary[:, 1:] |= st[:, 1:] != st[:, :-1]
    assert (got[boundary] > 0).all() and got.mean() < 0.5


def test_select_blackbody_curve_equals_jax():
    """The multires epilogue's blackbody colour: bhr_tpu sums 63 clamped
    segments, the port reads the segment's fp32 prefix sum and delta. The
    values agree within 1e-6 (a colour level is 3.9e-3; the two may differ
    by the rounding of one product), inside and outside the table's range,
    and so does the disk's emission that is built on it."""
    from bhr_tpu.models import disk as jd
    from bhr_tpu_torch.models import disk as td

    rng = np.random.default_rng(3)
    t = np.concatenate([rng.uniform(td.LUT_T_MIN, td.LUT_T_MAX, 4000),
                        [0.0, td.LUT_T_MIN, td.LUT_T_MAX, 2.0 * td.LUT_T_MAX]]).astype(np.float32)
    got = td.temperature_to_color_select(torch.from_numpy(t)).numpy()
    want = np.asarray(jd.temperature_to_color_select(jnp.asarray(t)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # the 64-knot curve lies near the 512-entry table's lerp, not on it
    table = td.temperature_to_color(torch.from_numpy(t)).numpy()
    assert 0.0 < np.abs(got - table).max() < 1.5 / 255.0
    pos = rng.uniform(-12.0, 12.0, (500, 3)).astype(np.float32)
    pos[:, 1] = 0.0
    vel = rng.normal(size=(500, 3)).astype(np.float32)
    vel /= np.linalg.norm(vel, axis=-1, keepdims=True)
    got = td.disk_emission(torch.from_numpy(pos), torch.from_numpy(vel), torch.tensor(15.0),
                           torch.tensor(2.0), DiskParams.for_scene(torch.tensor(2.0)),
                           "select").numpy()
    want = np.asarray(jd.disk_emission(jnp.asarray(pos), jnp.asarray(vel), 15.0, 2.0,
                                       JDiskParams.for_scene(2.0), "select"))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def _texture():
    return T.load_skybox(None, seed=7, shape=(64, 128))


@pytest.mark.parametrize("disk", [False, True], ids=["nodisk", "disk"])
@pytest.mark.parametrize("textured", [False, True], ids=["stars", "texture"])
@pytest.mark.parametrize("divisor", [2, 3])
def test_render_multires_matches_jax_and_full_render(divisor, textured, disk):
    jscene, scene = _scenes(W, H, 300 if disk else STEPS)
    pose = DISK_CAM if disk else ([0.0, 5.0, 15.0], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0])
    jcam, cam = J.Camera.new(*pose), T.Camera.new(*pose)
    tex = _texture() if textured else None
    jtex = J.ops.sampling.pack_texture_rgba8(tex) if textured else None
    ttex = T.texture_from_numpy(tex) if textured else None
    jdp = JDiskParams.for_scene(jscene.schwarzschild_radius) if disk else None
    tdp = DiskParams.for_scene(torch.tensor(2.0)) if disk else None
    want = np.asarray(jm.render_multires(jcam, jscene, jtex, jdp, None,
                                         config=J.TraceConfig(disk=disk), divisor=divisor,
                                         interpret=True, tile=(8, 128))).astype(np.int32)
    cfg = T.TraceConfig(disk=disk)
    got = tm.render_multires(cam, scene, ttex, tdp, config=cfg, device="cpu",
                             divisor=divisor).numpy().astype(np.int32)
    assert got.shape == (H, W, 4) and (got[..., 3] == 255).all()
    diff = np.abs(got - want)[..., :3].max(-1)
    assert (diff <= 1).mean() >= 0.99, (diff <= 1).mean()
    full = T.render_image(cam, scene, config=cfg, fast_math=True, device="cpu", skybox=ttex,
                          disk_params=tdp, lut=T.models.disk.blackbody_lut() if disk else None
                          ).numpy().astype(np.int32)
    err = np.abs(full[..., :3] - got[..., :3])
    assert err.mean() < 3.0, f"mean u8 error {err.mean()}"
    assert (err.max(-1) > 16).mean() < 0.04, "too many off pixels"


def test_render_multires_options_and_refusals():
    _, scene = _scenes(48, 32, 150)
    cam = T.Camera.default()
    tex = T.texture_from_numpy(_texture())
    base = tm.render_multires(cam, scene, tex, device="cpu", divisor=2, packed=True)
    assert base.dtype == torch.int32 and base.shape == (32, 48)
    out = torch.empty_like(base)
    again = tm.render_multires(cam, scene, tex, device="cpu", divisor=2, packed=True, out=out)
    assert again is out and torch.equal(out, base)
    # without the fix-up the shadow's edge blends captured and escaped rays
    rough = tm.render_multires(cam, scene, tex, device="cpu", divisor=2, packed=True,
                               edge_fix=False)
    assert not torch.equal(rough, base)
    # the texture tiers compose with multires
    for kw in (dict(texture_filter="nearest"), dict(texture_subsample=2),
               dict(texture_subsample="checker")):
        frame = tm.render_multires(cam, scene, tex, device="cpu", divisor=2, **kw)
        assert frame.shape == (32, 48, 4)
    luma = tm.render_multires(cam, scene, T.texture_from_numpy(_texture(), texture_filter="luma"),
                              device="cpu", divisor=2, texture_filter="luma")
    assert luma.shape == (32, 48, 4)
    with pytest.raises(ValueError, match="disk_params"):
        tm.render_multires(cam, scene, config=T.TraceConfig(disk=True), device="cpu")
    with pytest.raises(ValueError, match="debug"):
        tm.render_multires(cam, scene.replace(debug_mode=1), device="cpu")


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")


@pytest.mark.gpu
@pytest.mark.parametrize("fast", [False, True], ids=["exact", "fast"])
@pytest.mark.parametrize("kw", CONFIGS, ids=CONFIG_IDS)
def test_strided_and_masked_kernel_match_plain_version_on_gpu(kw, fast):
    """trace_planes' strided and masked ray-gen against their plain
    versions on the card, on every pixel: status and steps agree on >=
    99.5% (the exact tier: every plane bit-equal on >= 99.9%), directions
    within 1e-4 on >= 99.5% of the matched ones; one launch each."""
    _need_cuda()
    scene = T.SceneParams(screen_width=160, screen_height=96, max_steps=200, spin=0.9)
    cam = T.Camera.new(*DISK_CAM)
    cfg = T.TraceConfig(**kw)
    local = (_ceil(96, 3), _ceil(160, 3))
    edge = None
    for what in ("strided", "masked"):
        args = (dict(stride=3, local_shape=local) if what == "strided" else dict(mask=edge))
        counts = (COUNTS["launch.trace_planes"], COUNTS["launch.trace_planes.strided"],
                  COUNTS["launch.trace_planes.masked"])
        got = trace_kernel.trace_image(cam, scene, cfg, fast_math=fast, device="cuda", **args)
        torch.cuda.synchronize()
        assert (COUNTS["launch.trace_planes"], COUNTS["launch.trace_planes.strided"],
                COUNTS["launch.trace_planes.masked"]) == (
            counts[0] + 1, counts[1] + (what == "strided"), counts[2] + (what == "masked"))
        want = trace_kernel.trace_image_reference(cam, scene, cfg, fast_math=fast, device="cuda",
                                                  **args)
        same = (got.status == want.status) & (got.steps == want.steps)
        assert same.float().mean().item() >= 0.995, what
        vd = (got.final_vel - want.final_vel).abs().amax(-1)[same]
        assert (vd <= 1e-4).float().mean().item() >= 0.995, what
        if not fast:
            for f in ("final_pos", "final_vel"):
                eq = (getattr(got, f) == getattr(want, f)).all(-1)
                assert eq.float().mean().item() >= 0.999, (what, f)
        if what == "strided":
            edge = tm.deflection_edges([got.final_vel[..., k] for k in range(3)], got.status, 0.05)
            edge = (edge.repeat_interleave(3, 0).repeat_interleave(3, 1)[:96, :160]).contiguous()
            assert 0.0 < edge.mean().item() < 0.9


@pytest.mark.gpu
def test_render_multires_on_gpu_launches_twice():
    _need_cuda()
    r = T.BlackHoleRenderer(160, 96, "rk4", disk=True, fast_math=True, device="cuda",
                            skybox=_texture())
    cam = T.Camera.new(*DISK_CAM)
    scene = T.SceneParams(max_steps=300)
    counts = (COUNTS["launch.trace_planes"], COUNTS["launch.trace_planes.strided"],
              COUNTS["launch.trace_planes.masked"], COUNTS["launch.render_mono"])
    frame = r.render_frame_multires(cam, scene, divisor=2)
    torch.cuda.synchronize()
    assert (COUNTS["launch.trace_planes"], COUNTS["launch.trace_planes.strided"],
            COUNTS["launch.trace_planes.masked"], COUNTS["launch.render_mono"]) == (
        counts[0] + 2, counts[1] + 1, counts[2] + 1, counts[3])
    full = r.render_frame(cam, scene)
    err = (frame.int() - full.int()).abs()[..., :3].float()
    assert err.mean().item() < 3.0 and (err.amax(-1) > 16).float().mean().item() < 0.04
