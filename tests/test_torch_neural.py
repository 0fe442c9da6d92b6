"""The neural surrogate's Schwarzschild path (N1) of the port against
bhr_tpu, on identical numpy inputs and the committed weights: the model
functions, the MLP at both precision tiers, the kernel's plain version
against bhr_tpu's Pallas kernel in interpret mode, the staged route
against bhr_tpu's staged path, and the renderer's loading, routing, errors
and warnings. The CUDA kernel itself is held against its plain version by
the `gpu`-marked tests at the end.

Tolerances. bhr_tpu on the CPU computes tanh, log, log1p and exp with
XLA's own approximations (its tanh differs from PyTorch's on most inputs,
by a few ulp) and sums a matrix product in another order, so elementwise
functions agree to a few ulp and the MLP to its summation error; in the
default tier a hidden activation whose bf16 rounding falls the other way
moves an output by one bf16 step of that activation times its weight.
Frames use bhr_tpu's own bars for this kernel (tests/test_neural.py:
262-266 and tests/test_neural_kerr.py:478-479): default tier >= 99%
bit-equal and <= 0.1% off by more than 2 levels, capture (black) mask
equal on >= 99.9%; highest tier >= 99.9% bit-equal.
"""

import itertools
import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bhr_tpu as J
import bhr_tpu_torch as T
from bhr_tpu.models import neural as jn
from bhr_tpu.ops.neural_pallas import neural_render_packed as j_neural_render_packed
from bhr_tpu.ops.neural_trace import neural_trace_image as j_neural_trace_image
from bhr_tpu.ops.sampling import unpack_frame as j_unpack
from bhr_tpu.renderer import render_image as j_render_image
from bhr_tpu_torch.models import neural as tn
from bhr_tpu_torch.ops import neural_kernel
from bhr_tpu_torch.ops.neural_trace import neural_trace_image
from bhr_tpu_torch.ops.sampling import unpack_frame
from bhr_tpu_torch.utils import build
from bhr_tpu_torch.utils.tracing import COUNTS

ASSETS = tn.ASSETS_DIR
W, H = 64, 48
SIDE = ([15.0, 5.0, 0.0], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0])  # scripts/golden_diff.py:128


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _params(asset="neural_schwarzschild.npz"):
    jp, _ = jn.load_params(str(ASSETS / asset))
    return jp, T.neural_params_from_numpy(jp)


def _cams(side):
    if side:
        return J.Camera.new(*SIDE), T.Camera.new(*SIDE)
    return J.Camera.default(), T.Camera.default()


def _scenes(w=W, h=H):
    return (J.SceneParams(screen_width=w, screen_height=h, max_steps=500),
            T.SceneParams(screen_width=w, screen_height=h, max_steps=500))


def assert_frames_agree(got, want, highest=False):
    """bhr_tpu's bars for this kernel on two uint8 (H, W, 4) frames."""
    got, want = np.asarray(got).astype(int), np.asarray(want).astype(int)
    diff = np.abs(got[..., :3] - want[..., :3]).max(-1)
    black_same = ((got[..., :3] == 0).all(-1) == (want[..., :3] == 0).all(-1)).mean()
    same = (diff == 0).mean()
    assert (got[..., 3] == 255).all()
    assert same >= (0.999 if highest else 0.99), f"bit-equal on {same:.5f}"
    assert (diff > 2).mean() <= 1e-3, f"{(diff > 2).mean():.5f} off by > 2 levels"
    assert black_same >= 0.999, f"capture mask equal on {black_same:.5f}"


def _reduced(n=4096, seed=3):
    """(r0, rs, cos psi, sin psi) over the trained domain (r0 from 1.3 rs),
    with 128 radial rays (s = 0) and 384 within 0.1% of the critical
    impact parameter (t ~ 0), inbound."""
    rng = np.random.RandomState(seed)
    rs = rng.uniform(0.5, 4.0, n).astype(np.float32)
    r0 = (rs * rng.uniform(1.3, 50.0, n)).astype(np.float32)
    psi = rng.uniform(0.0, np.pi, n).astype(np.float32)
    psi[:64], psi[64:128] = 0.0, np.float32(np.pi)
    c, s = np.cos(psi).astype(np.float32), np.sin(psi).astype(np.float32)
    k = slice(128, 512)
    eps = rng.uniform(-1e-3, 1e-3, 384)
    s[k] = np.clip(2.598076211 * rs[k] * (1 + eps) / r0[k], 0.0, 1.0)
    c[k] = -np.sqrt(1.0 - s[k].astype(np.float64) ** 2)
    return r0, rs, c, s


# ---- the model functions ------------------------------------------------------


def test_ray_features_match_jax():
    """Within 2.4e-7 absolute (1-2 ulp of the log and tanh features; all
    others bit-equal), radial and near-critical rays included."""
    r0, rs, c, s = _reduced()
    want = np.asarray(jn.ray_features(r0, rs, c, s))
    got = tn.ray_features(_t(r0), _t(rs), _t(c), _t(s))
    assert got.shape == (4096, tn.N_FEATURES) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=3e-7)
    t = r0 * s / (2.598076211 * rs) - 1.0
    assert (np.abs(t) < 2e-3).sum() >= 300 and (s == 0).sum() >= 64


def test_delta_envelope_matches_jax():
    """Within 3e-7 relative pointwise (log1p and exp ulps), including the
    spike at the critical impact parameter and radial rays (E ~ 0)."""
    r0, rs, c, s = _reduced()
    want = np.asarray(jn.delta_envelope(r0, rs, s, c))
    got = tn.delta_envelope(_t(r0), _t(rs), _t(s), _t(c)).numpy()
    np.testing.assert_allclose(got, want, rtol=3e-7, atol=0)
    assert np.abs(got[:128]).max() < 1e-7 and got.max() > 10 * np.median(got)


@pytest.mark.parametrize("asset", ["neural_schwarzschild.npz", "neural_schwarzschild_orbit_xl.npz"])
def test_mlp_apply_default_matches_jax_bfloat16(asset):
    """The default tier against bhr_tpu's mlp_apply(dtype=bfloat16): every
    output within 2e-4 of its column's largest magnitude (a bf16 rounding
    of one hidden activation falling the other way), and 95% of them
    within 1e-5."""
    jp, tp = _params(asset)
    feats = np.asarray(jn.ray_features(*_reduced()))
    want = np.asarray(jn.mlp_apply(jp, feats, dtype=jnp.bfloat16))
    got = tn.mlp_apply(tp, _t(feats), precision="default").numpy()
    diff = np.abs(got - want)
    assert (diff <= 2e-4 * np.abs(want).max(0)).all(), diff.max(0)
    assert (diff <= 1e-5).mean() >= 0.95
    # bf16 operands: the fp32 chain is a different function
    fp32 = tn.mlp_apply(tp, _t(feats), precision="highest").numpy()
    assert np.abs(fp32 - got).max() > 10 * diff.max()


def test_mlp_apply_highest_matches_jax_float32():
    """The highest tier against bhr_tpu's fp32 mlp_apply: within 3e-6 of
    each column's largest magnitude (summation order); high is the same
    fp32 chain, and a bfloat16 dtype rounds the operands at any tier."""
    jp, tp = _params()
    feats = np.asarray(jn.ray_features(*_reduced()))
    want = np.asarray(jn.mlp_apply(jp, feats))
    got = tn.mlp_apply(tp, _t(feats), precision="highest").numpy()
    assert (np.abs(got - want) <= 3e-6 * np.abs(want).max(0)).all()
    torch.testing.assert_close(tn.mlp_apply(tp, _t(feats), precision="high"), _t(got),
                               rtol=0, atol=0)
    torch.testing.assert_close(tn.mlp_apply(tp, _t(feats), precision="high", dtype="bfloat16"),
                               tn.mlp_apply(tp, _t(feats)), rtol=0, atol=0)


def test_predict_directions_matches_jax():
    """Unit final directions within 2e-4 of bhr_tpu's at bf16 operands on
    every ray but where the capture flags differ, which is at most 0.1% of
    rays."""
    jp, tp = _params()
    rng = np.random.RandomState(5)
    o = np.array([[0.0, 5.0, 15.0]], np.float32).repeat(2048, 0)
    d = (rng.randn(2048, 3) * [0.3, 0.3, 1.0] - [0.0, 0.3, 1.0]).astype(np.float32)
    vj, cj = jn.predict_directions(jp, o, d, np.zeros(3, np.float32), 2.0, dtype=jnp.bfloat16)
    vt, ct = tn.predict_directions(tp, _t(o), _t(d), torch.zeros(3), torch.tensor(2.0))
    same = np.asarray(cj) == ct.numpy()
    assert same.mean() >= 0.999 and 0.01 < ct.float().mean() < 0.99
    err = np.abs(vt.numpy() - np.asarray(vj)).max(-1)[same & ~ct.numpy()]
    assert (err <= 2e-4).all(), err.max()


def test_load_params_reads_bhr_tpu_assets():
    """The port's copies of the assets are bhr_tpu's, byte for byte, and
    load to the same weights; a Kerr asset is refused."""
    for asset in ("neural_schwarzschild.npz", "neural_schwarzschild_orbit.npz",
                  "neural_schwarzschild_orbit_xl.npz", "neural_kerr.npz",
                  "neural_kerr_default.npz"):
        theirs = ASSETS.parents[1] / "bhr_tpu" / "assets" / asset
        assert (ASSETS / asset).read_bytes() == theirs.read_bytes(), asset
    jp, meta_j = jn.load_params(str(ASSETS / "neural_schwarzschild.npz"))
    tp, meta_t = tn.load_params(ASSETS / "neural_schwarzschild.npz")
    assert tp.model == "schwarzschild" and tp.widths == (128, 128, 128) and len(tp) == 4
    for (wj, bj), (wt, bt) in zip(jp, tp):
        np.testing.assert_array_equal(wt.numpy(), np.asarray(wj))
        np.testing.assert_array_equal(bt.numpy(), np.asarray(bj))
    assert sorted(meta_t) == sorted(meta_j)
    with pytest.raises(ValueError, match="not a Schwarzschild-surrogate"):
        tn.load_params(ASSETS / "neural_kerr.npz")
    with pytest.raises(ValueError, match="unrecognized surrogate shape"):
        T.NeuralSurrogate([(np.zeros((16, 8)), np.zeros(8)), (np.zeros((8, 4)), np.zeros(4))])


# ---- frames against bhr_tpu -----------------------------------------------------


@pytest.mark.parametrize("precision", [None, "highest"], ids=["default", "highest"])
@pytest.mark.parametrize("side", [False, True], ids=["default_cam", "side_cam"])
def test_kernel_plain_version_matches_jax_interpret_kernel(side, precision):
    """neural_render_packed_reference against bhr_tpu's Pallas kernel in
    interpret mode, 64x48, at bhr_tpu's bars for the tier."""
    jp, tp = _params()
    jcam, tcam = _cams(side)
    jsc, tsc = _scenes()
    want = j_unpack(j_neural_render_packed(jp, jcam, jsc, interpret=True, precision=precision))
    got = neural_kernel.neural_render_packed_reference(tp, tcam, tsc, precision=precision,
                                                       device="cpu")
    assert got.shape == (H, W) and got.dtype == torch.int32
    assert_frames_agree(unpack_frame(got), want, highest=precision == "highest")


def test_kernel_plain_version_of_the_wide_net_matches_jax():
    """The 256-wide orbit net (neural_schwarzschild_orbit_xl.npz) from the
    side camera, default tier."""
    jp, tp = _params("neural_schwarzschild_orbit_xl.npz")
    jcam, tcam = _cams(True)
    jsc, tsc = _scenes()
    want = j_unpack(j_neural_render_packed(jp, jcam, jsc, interpret=True))
    got = neural_kernel.neural_render_packed_reference(tp, tcam, tsc, device="cpu")
    assert_frames_agree(unpack_frame(got), want)


@pytest.mark.parametrize("tonemap", ["passthrough", "srgb"])
def test_staged_route_matches_jax_staged_bfloat16(tonemap):
    """The staged route (neural_trace_image + shade_image) against
    bhr_tpu's staged path at bf16 operands (render_image(use_pallas=False,
    neural_dtype='bfloat16')), 64x48, side camera, default-tier bars; the
    trace's status and steps planes as bhr_tpu's."""
    jp, tp = _params()
    jcam, tcam = _cams(True)
    jsc, tsc = _scenes()
    want = j_render_image(jcam, jsc, None, None, None,
                          config=J.ops.trace.TraceConfig(integrator="neural"), use_pallas=False,
                          tile=(8, 128), fast_math=True, tonemap=tonemap, interpret=True,
                          neural_params=jp, neural_dtype="bfloat16")
    got = T.render_image(tcam, tsc, config=T.TraceConfig(integrator="neural"), fast_math=False,
                         device="cpu", tonemap=tonemap, neural_params=tp)
    if tonemap == "passthrough":  # the renderer sends it to the kernel; take the staged route
        res = neural_trace_image(tp, tcam, tsc, device="cpu")
        got = T.renderer.shade_image(res, tcam, tsc, None, None, tonemap=tonemap)
        jres = j_neural_trace_image(jp, jcam, jsc, dtype=jnp.bfloat16)
        np.testing.assert_array_equal(res.steps.numpy(), np.asarray(jres.steps))
        assert (res.status.numpy() == np.asarray(jres.status)).mean() >= 0.999
        np.testing.assert_array_equal(res.final_pos.numpy(), np.asarray(jres.final_pos))
    assert_frames_agree(got, want)


# ---- the renderer ---------------------------------------------------------------


def test_renderer_loads_the_default_asset_and_resolves_auto():
    """integrator='neural' loads neural_schwarzschild.npz (the default
    asset), "auto" resolves to "default" (no train_precision), and the
    trained domain comes from the asset's meta."""
    r = T.BlackHoleRenderer(W, H, "neural", device="cpu")
    _, tp = _params()
    assert r.config.integrator == "neural" and r.config.model == "schwarzschild"
    assert r.neural_precision == "default" and r.neural_params.model == "schwarzschild"
    for (wa, ba), (wb, bb) in zip(r.neural_params, tp):
        assert torch.equal(wa, wb) and torch.equal(ba, bb)
    jr = J.BlackHoleRenderer(W, H, "neural")
    assert r._neural_domain == jr._neural_domain and jr.neural_precision == r.neural_precision
    for kw in (dict(neural_precision="highest"), dict(neural_params=tp),
               dict(neural_params=str(ASSETS / "neural_schwarzschild_orbit.npz"))):
        assert T.BlackHoleRenderer(8, 8, "mlp", device="cpu", **kw).neural_params is not None
    assert T.BlackHoleRenderer(8, 8, "neural", device="cpu",
                               neural_params=tp).neural_precision == "default"


@pytest.mark.parametrize(
    "kw,route",
    [({}, "kernel"), (dict(neural_precision="highest"), "kernel"),
     (dict(neural_precision="high"), "staged"), (dict(tonemap="srgb"), "staged"),
     (dict(tonemap="reinhard", neural_dtype="bfloat16"), "staged"),
     (dict(debug_mode=1), "staged")],
    ids=["default", "highest", "high", "srgb", "reinhard-bf16", "debug"],
)
def test_renderer_routes_as_bhr_tpu(kw, route):
    """render_frame takes the kernel (plain version on the CPU) exactly
    where bhr_tpu/renderer.py:184-209 takes its Pallas kernel, and the
    staged route (ops/neural_trace + shade_image) elsewhere; a frame of a
    net the kernel does not take (hidden width 96) is staged too."""
    debug = kw.pop("debug_mode", 0)
    r = T.BlackHoleRenderer(32, 24, "neural", device="cpu", **kw)
    scene = T.SceneParams(screen_width=32, screen_height=24, max_steps=100, debug_mode=debug)
    cam = T.Camera.new(*SIDE)
    frame = r.render_frame(cam, scene)
    prec = r.neural_precision
    if route == "kernel":
        want = neural_kernel.neural_render_packed(r.neural_params, cam, scene, precision=prec,
                                                  device="cpu")
    else:
        res = neural_trace_image(r.neural_params, cam, scene, device="cpu",
                                 dtype=r.neural_dtype, precision=prec)
        want = T.renderer.shade_image(res, cam, scene, None, None, tonemap=r.tonemap,
                                      packed=True)
    torch.testing.assert_close(frame, unpack_frame(want), rtol=0, atol=0)
    assert neural_kernel.kernel_takes(r.neural_params, scene, tonemap=r.tonemap,
                                      precision=prec) == (route == "kernel")
    narrow = T.NeuralSurrogate([(np.ones((16, 96)) * 0.01, np.zeros(96)),
                                (np.ones((96, 2)) * 0.01, np.zeros(2))])
    assert neural_kernel.kernel_plan(narrow, "default") is None
    assert not neural_kernel.kernel_takes(narrow, scene, tonemap="passthrough",
                                          precision="default")


def test_kernel_plan_fits_shared_memory():
    """kernel_plan's block fits 227 KB for the assets' widths -- the
    default tier's held layout for N1, the streamed one (a ring of four
    chunks) for N2 -- and for every multiple of 128 up to 1152
    (default tier: the chunked layout beyond 256, two activation buffers
    and one or two weight chunks) and 1024 (highest, whose block also holds
    a layer's outputs in registers: at most 256 x 128 of them, in warp
    tiles of 32 pixels); it refuses wider nets, other widths and the high
    tier."""
    def net(width, n_in=16, n_out=2, layers=3):
        dims = [n_in] + [width] * layers + [n_out]
        return T.NeuralSurrogate((np.zeros((a, b)), np.zeros(b)) for a, b in zip(dims, dims[1:]))

    assert neural_kernel.kernel_plan(net(128), "default") == (384, 0, 0, 128)
    assert neural_kernel.kernel_plan(net(256, 22, 3), "default") == (256, 64, 4, 256)
    assert neural_kernel.kernel_plan(net(128), "highest") == (256, 32, 2, 0)
    assert neural_kernel.kernel_plan(net(256, 22, 3), "highest") == (128, 32, 2, 0)
    n1, n2 = [16, 128, 128, 128, 2], [32, 256, 256, 256, 3]
    assert neural_kernel.mlp_dims(net(256, 22, 3)) == n2
    # held: 12 warps' staging rows of 136 bf16, the weights held in rows of
    # in + 8, the head in fp32, 8 floats a pixel; streamed: a ring of four
    # slots of 64 x 256 bf16, two warpgroups' 64 staging rows of 264, two
    # rounds of the block's 128 pixels' features in rows of 40, the head in
    # fp32, 16 mbarriers
    assert neural_kernel.smem_bytes(n1, (384, 0, 0, 128), "default") == (
        12 * 32 * 136 * 2 + (128 * 24 + 2 * 128 * 136) * 2 + (2 * 128 + 12 * 32 * 8) * 4)
    assert neural_kernel.smem_bytes(n2, (256, 64, 4, 256), "default") == (
        4 * 64 * 256 * 2 + 2 * 64 * 264 * 2 + 2 * 128 * 40 * 2 + 3 * 256 * 4 + 16 * 8) == 222_336
    assert neural_kernel.smem_bytes(n2, (128, 64, 2, 0), "default") == (256 + 128) * 264 * 2
    assert neural_kernel.smem_bytes(n2, (128, 32, 2, 0), "highest") == (
        256 * 132 + 2 * 32 * 256) * 4
    for tier, widest in (("default", 1152), ("highest", 1024)):
        for width in range(128, widest + 1, 128):
            plan = neural_kernel.kernel_plan(net(width), tier)
            pix, nc, nbuf, regs = plan
            assert neural_kernel.smem_bytes(neural_kernel.mlp_dims(net(width)), plan,
                                            tier) <= neural_kernel.SMEM_LIMIT
            if regs:  # held (32 pixels a warp) or streamed (256 pixels a cluster's round)
                assert tier == "default" and width <= regs and pix == (384 if regs == 128 else 256)
                assert (nc, nbuf) == ((0, 0) if regs == 128 else (64, 4))
            else:
                assert width % nc == 0 and pix % (16 if tier == "default" else 32) == 0
            assert tier == "default" or pix * width <= 256 * 128
        assert neural_kernel.kernel_plan(net(widest + 128), tier) is None
    assert neural_kernel.kernel_plan(net(192), "default") is None
    assert neural_kernel.kernel_plan(net(128, layers=8), "default") is None
    with pytest.raises(ValueError, match="tiers"):
        neural_kernel.kernel_plan(net(128), "high")


# Seeded random nets, hidden widths (w, 128, w), that reach every block plan
# of the kernel that the committed nets do not, the held instantiation they
# do not (Kerr, 128 wide) and the streamed layout's mixed widths (Kerr, 256
# then 128): (tier, model, w, seed), the list chip_smoke.py:PLAN_NETS
# renders on the card.
PLAN_NETS = (("default", "kerr", 128, 0), ("default", "kerr", 256, 0),
             ("default", "kerr", 384, 0), ("default", "schwarzschild", 512, 4),
             ("default", "kerr", 640, 0), ("default", "schwarzschild", 1152, 0),
             ("highest", "schwarzschild", 384, 0), ("highest", "kerr", 512, 0),
             ("highest", "schwarzschild", 640, 0), ("highest", "kerr", 768, 0),
             ("highest", "schwarzschild", 1024, 2))
PLAN_IDS = [f"{t}-{m}-{w}" for t, m, w, _ in PLAN_NETS]


def random_net(model, width, seed):
    """chip_smoke.random_net: N(0, 1/fan_in) weights (a quarter of that
    scale in the head) and biases of standard deviation 0.1, from numpy's
    generator at `seed`, hidden widths (width, 128, width)."""
    rng = np.random.default_rng(seed)
    kerr = model == "kerr"
    dims = [22 if kerr else 16, width, 128, width, 3 if kerr else 2]
    layers = []
    for i, (a, b) in enumerate(zip(dims, dims[1:])):
        scale = (0.25 if i == len(dims) - 2 else 1.0) / np.sqrt(a)
        layers.append((rng.standard_normal((a, b)) * scale, rng.standard_normal(b) * 0.1))
    return T.NeuralSurrogate(layers)


def _plan_scene(model):
    return T.SceneParams(screen_width=160, screen_height=96, spin=0.9 if model == "kerr" else 0.0)


def test_plan_nets_reach_every_block_plan():
    """The committed nets and PLAN_NETS together reach every plan that
    kernel_plan gives any width it takes, in both tiers, so the `gpu` test
    below launches every branch of the kernel's staging."""
    def net(width, n_in=16, n_out=2):
        dims = [n_in, width, width, n_out]
        return T.NeuralSurrogate((np.zeros((a, b)), np.zeros(b)) for a, b in zip(dims, dims[1:]))

    for tier in ("default", "highest"):
        every = {neural_kernel.kernel_plan(net(w), tier) for w in range(128, 4097, 128)} - {None}
        reached = {neural_kernel.kernel_plan(net(w), tier) for w in (128, 256)}  # the assets
        reached |= {neural_kernel.kernel_plan(random_net(m, w, seed), t)
                    for t, m, w, seed in PLAN_NETS if t == tier}
        assert reached == every, (tier, every - reached)
        assert {plan[2] for plan in reached} == ({0, 1, 2, 4} if tier == "default" else {1, 2})


@pytest.mark.parametrize("case", PLAN_NETS, ids=PLAN_IDS)
def test_plan_net_frames_are_mixed(case):
    """Each PLAN_NETS frame, as the plain version renders it at 160x96,
    has captured (black) and live pixels at both cameras, so holding the
    kernel's frame against it tests the logit and the deflection alike."""
    tier, model, width, seed = case
    net = random_net(model, width, seed)
    for side in (False, True):
        cam = T.Camera.new(*SIDE) if side else T.Camera.default()
        frame = neural_kernel.neural_render_packed_reference(net, cam, _plan_scene(model),
                                                             precision=tier, device="cpu")
        black = (frame.view(torch.uint8).view(96, 160, 4)[..., :3] == 0).all(-1)
        assert 0.05 <= black.float().mean().item() <= 0.95


@pytest.mark.parametrize("hidden", range(1, 8))
def test_streamed_plan_fits_shared_memory(hidden):
    """Every net the streamed plan takes -- `hidden` hidden layers each 128
    or 256 wide, not all held, with the Schwarzschild or the Kerr inputs
    and head -- fits a block's 232,448 bytes (the ring, the staging rows,
    the head's weights, the geometry and the mbarriers); a net of 128-wide
    layers only is held while its weights fit."""
    streamed = 0
    for n_in, n_out in ((16, 2), (22, 3)):
        for widths in itertools.product((128, 256), repeat=hidden):
            dims = [n_in, *widths, n_out]
            net = T.NeuralSurrogate((np.zeros((a, b)), np.zeros(b)) for a, b in zip(dims, dims[1:]))
            plan = neural_kernel.kernel_plan(net, "default")
            if plan != neural_kernel.STREAMED_PLAN:
                assert max(widths) == 128 and plan == (384, 0, 0, 128)
                continue
            streamed += 1
            assert neural_kernel.smem_bytes(neural_kernel.mlp_dims(net), plan,
                                            "default") <= neural_kernel.SMEM_LIMIT == 232448
    assert streamed >= 2 * (2 ** hidden - 1)


def test_net_without_a_block_raises_instead_of_staging():
    """A net bhr_tpu sends to its kernel (hidden widths multiples of 128)
    goes to the kernel here too: one that no block holds (1280 wide, or 9
    layers) raises ValueError, on either device, instead of rendering
    through the staged route."""
    scene = T.SceneParams(screen_width=8, screen_height=8)
    for width, hidden in ((1280, 1), (128, 8)):
        dims = [16] + [width] * hidden + [2]
        net = T.NeuralSurrogate((np.zeros((a, b)), np.zeros(b)) for a, b in zip(dims, dims[1:]))
        assert neural_kernel.kernel_shapes_ok(net)
        assert neural_kernel.kernel_takes(net, scene, tonemap="passthrough", precision="default")
        assert neural_kernel.kernel_plan(net, "default") is None
        r = T.BlackHoleRenderer(8, 8, "neural", neural_params=net, neural_precision="default",
                                device="cpu")
        with pytest.raises(ValueError, match="no block"):
            r.render_frame(scene=scene)
    assert not neural_kernel.kernel_shapes_ok([(np.zeros((16, 2)), np.zeros(2))])
    assert not neural_kernel.kernel_shapes_ok([(np.zeros((16, 128)), np.zeros(128)),
                                               (np.zeros((128, 3)), np.zeros(3))])


def test_kernel_operands_follow_weight_updates():
    """The kernel's operands, kept on the module, are prepared again after
    load_state_dict or an in-place write to a weight, and kept while the
    weights are unchanged."""
    _, tp = _params()
    cpu = torch.device("cpu")
    plan = neural_kernel.kernel_plan(tp, "default")
    key = ("default", str(cpu))

    def operands():
        desc = neural_kernel._mlp_desc(tp, "default", cpu, plan)
        ops = tp._kernel_operands[key][1]
        assert [desc.w[i] for i in range(len(ops))] == [w.data_ptr() for w, _ in ops]
        return desc, ops

    def assert_prepared_from(net, ops):
        for (w, b), (w_want, b_want) in zip(ops, neural_kernel.prep_weights(
                net, precision="default", device=cpu, row_pad=8 if plan[3] else 0)):
            assert torch.equal(w, w_want) and torch.equal(b, b_want)

    desc, ops = operands()
    assert operands()[0] is desc
    _, orbit = _params("neural_schwarzschild_orbit.npz")
    tp.load_state_dict(orbit.state_dict())
    desc2, ops2 = operands()
    assert desc2 is not desc
    assert_prepared_from(orbit, ops2)
    with torch.no_grad():
        tp.b3.add_(1.0)
    desc3, ops3 = operands()
    assert desc3 is not desc2 and torch.equal(ops3[3][1], orbit[3][1] + 1.0)


def test_prep_weights_transposes_pads_and_rounds():
    """W^T (out, in) in bf16 at the default tier (each row followed by 8
    zeros for the fused layout), W (in, out) in fp32 at highest, the Kerr
    net's 22 inputs zero-padded to 32; the bias fp32."""
    jp, tp = _params()
    ops = neural_kernel.prep_weights(tp, precision="default", device="cpu")
    assert [tuple(w.shape) for w, _ in ops] == [(128, 16), (128, 128), (128, 128), (2, 128)]
    assert all(w.dtype == torch.bfloat16 and b.dtype == torch.float32 for w, b in ops)
    torch.testing.assert_close(ops[1][0], tp[1][0].t().to(torch.bfloat16), rtol=0, atol=0)
    padded = neural_kernel.prep_weights(tp, precision="default", device="cpu", row_pad=8)
    assert [tuple(w.shape) for w, _ in padded] == [(128, 24), (128, 136), (128, 136), (2, 136)]
    for (w, _), (wp, _) in zip(ops, padded):
        assert torch.equal(wp[:, :w.shape[1]], w) and (wp[:, w.shape[1]:] == 0).all()
    from bhr_tpu_torch.models import neural_kerr

    kp, _ = neural_kerr.load_params(ASSETS / "neural_kerr.npz")
    kops = neural_kernel.prep_weights(kp, precision="highest", device="cpu")
    assert [tuple(w.shape) for w, _ in kops] == [(32, 256), (256, 256), (256, 256), (256, 3)]
    assert kops[0][0].dtype == torch.float32 and (kops[0][0][22:] == 0).all()
    assert torch.equal(kops[0][0][:22], kp[0][0]) and torch.equal(kops[3][0], kp[3][0])


def test_prep_weights_chunks_for_the_streamed_layout():
    """With `chunks` (the streamed layout), each hidden layer's W^T in
    chunks of 64 output channels, each chunk as wgmma's K-major B without
    swizzle: element (channel 64 c + 8 i + r, input 8 g + e) at
    64 x in x c + 512 g + 64 i + 8 r + e; the head's W^T as it is, unpadded;
    the biases untouched."""
    from bhr_tpu_torch.models import neural_kerr

    kp, _ = neural_kerr.load_params(ASSETS / "neural_kerr.npz")
    rows = neural_kernel.prep_weights(kp, precision="default", device="cpu")
    chunks = neural_kernel.prep_weights(kp, precision="default", device="cpu", chunks=True)
    assert [tuple(w.shape) for w, _ in chunks] == [(256, 32), (256, 256), (256, 256), (3, 256)]
    assert torch.equal(chunks[3][0], rows[3][0])
    for (w, b), (wr, br) in zip(chunks, rows):
        assert torch.equal(b, br) and w.dtype == torch.bfloat16
    for (w, _), (wr, _) in zip(chunks[:3], rows[:3]):
        k = wr.shape[1]
        flat = w.reshape(-1)
        n = torch.arange(wr.shape[0])[:, None]
        j = torch.arange(k)[None, :]
        offset = 64 * k * (n // 64) + 512 * (j // 8) + 64 * (n % 64 // 8) + 8 * (n % 8) + j % 8
        assert torch.equal(flat[offset], wr)
        assert torch.equal(neural_kernel.wgmma_chunks(wr), w)


@pytest.mark.parametrize(
    "kw,match,in_jax",
    [(dict(model="flat"), "supports model", True), (dict(model="kerr_lt"), "supports model", True),
     (dict(disk=True), "accretion disk", True), (dict(adaptive=True), "adaptive", True),
     (dict(multires=2), "multires", True), (dict(neural_precision="fast"), "neural_precision", True),
     (dict(neural_dtype="float16"), "neural_dtype", False),
     (dict(model="kerr", neural_params=ASSETS / "neural_schwarzschild.npz"), "Kerr-surrogate",
      False)],
    ids=["flat", "kerr_lt", "disk", "adaptive", "multires", "precision", "dtype", "wrong-asset"],
)
def test_renderer_neural_value_errors(kw, match, in_jax):
    """The configurations bhr_tpu's renderer refuses for integrator='neural'
    (bhr_tpu/renderer.py:474-500) raise ValueError here too; so do an
    operand type other than float32 and bfloat16 (bhr_tpu would multiply
    in it) and a Schwarzschild asset for the Kerr model."""
    with pytest.raises(ValueError, match=match):
        T.BlackHoleRenderer(8, 8, "neural", device="cpu", **kw)
    if in_jax:
        with pytest.raises(ValueError, match=match):
            J.BlackHoleRenderer(8, 8, "neural", **kw)


def test_euler_ignores_neural_params():
    """neural_params without integrator='neural' is ignored, as in bhr_tpu:
    the frame is the Euler frame."""
    scene = T.SceneParams(screen_width=12, screen_height=8, max_steps=60)
    a = T.BlackHoleRenderer(12, 8, device="cpu", neural_params={}).render_frame(scene=scene)
    b = T.BlackHoleRenderer(12, 8, device="cpu").render_frame(scene=scene)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_render_frame_warns_outside_the_trained_domain(caplog):
    """A camera outside the asset's r_range warns, as bhr_tpu's renderer
    does (tests/test_neural.py:218-233); one inside does not."""
    r = T.BlackHoleRenderer(16, 12, "neural", device="cpu",
                            neural_params=ASSETS / "neural_schwarzschild_orbit.npz")
    scene = T.SceneParams(screen_width=16, screen_height=12, max_steps=100)
    with caplog.at_level(logging.WARNING, logger="bhr_tpu_torch"):
        r.render_frame(T.Camera.new([50.0, 5.0, 0.0], [0, 0, 0], [0, 1, 0]), scene)
    assert any("extrapolating" in rec.message for rec in caplog.records)
    caplog.clear()
    with caplog.at_level(logging.WARNING, logger="bhr_tpu_torch"):
        r.render_frame(T.Camera.default(), scene)
    assert not any("extrapolating" in rec.message for rec in caplog.records)


def test_orbit_animator_renders_neural_frames_like_render_frame():
    """Two orbit frames, each equal to render_frame at its camera, on both
    routes."""
    for kw in ({}, dict(tonemap="srgb")):
        r = T.BlackHoleRenderer(32, 24, "neural", device="cpu", **kw)
        anim = T.OrbitAnimator(r)
        frames = anim.render_frames(2)
        assert frames.shape == (2, 24, 32, 4)
        for k, t in enumerate(anim.frame_times(2)):
            torch.testing.assert_close(frames[k], r.render_frame(T.orbit_camera(t)),
                                       rtol=0, atol=0)


def test_neural_kernel_on_cuda_raises_without_cuda():
    """device='cuda' without a GPU raises and counts no launch; the
    wrapper and the build have no `try`; a net the kernel does not take,
    or the high tier, raises ValueError."""
    import inspect

    _, tp = _params()
    scene = T.SceneParams(screen_width=8, screen_height=8)
    for fn in (neural_kernel.neural_render_packed, build.load_neural_mlp, neural_kernel._mlp_desc):
        assert "try:" not in inspect.getsource(fn)
    with pytest.raises(ValueError, match="tiers"):
        neural_kernel.neural_render_packed(tp, T.Camera.default(), scene, precision="high",
                                           device="cpu")
    if torch.cuda.is_available():
        return
    launches = COUNTS["launch.neural_mlp"]
    for device in ("cuda", torch.device("cuda:0")):
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            neural_kernel.neural_render_packed(tp, T.Camera.default(), scene, device=device)
    assert COUNTS["launch.neural_mlp"] == launches
    assert build.load_neural_mlp.cache_info().currsize == 0


# ---- the kernel against its plain version, on the card ---------------------------


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")


@pytest.mark.gpu
@pytest.mark.parametrize("case", [("neural_schwarzschild.npz", None, False),
                                  ("neural_schwarzschild_orbit_xl.npz", None, True),
                                  ("neural_schwarzschild.npz", "highest", False)],
                         ids=["n1-default", "n1-xl", "n1-highest"])
def test_neural_kernel_matches_plain_version_on_gpu(case):
    _need_cuda()
    asset, precision, side = case
    tp, _ = tn.load_params(ASSETS / asset)
    tp = tp.to("cuda")
    cam = T.Camera.new(*SIDE) if side else T.Camera.default()
    scene = T.SceneParams(screen_width=160, screen_height=96)
    launches = COUNTS["launch.neural_mlp"]
    got = neural_kernel.neural_render_packed(tp, cam, scene, precision=precision, device="cuda")
    torch.cuda.synchronize()
    assert COUNTS["launch.neural_mlp"] == launches + 1
    want = neural_kernel.neural_render_packed_reference(tp, cam, scene, precision=precision,
                                                        device="cuda")
    assert_frames_agree(unpack_frame(got).cpu(), unpack_frame(want).cpu(),
                        highest=precision == "highest")


@pytest.mark.gpu
@pytest.mark.parametrize("case", PLAN_NETS, ids=PLAN_IDS)
def test_neural_kernel_block_plans_on_gpu(case):
    """Every block plan the committed nets do not reach (fewer pixels a
    block, one chunk buffer, 16- or 32-channel chunks, 16- or 32-row
    slabs) against the plain version, at both cameras."""
    _need_cuda()
    tier, model, width, seed = case
    net = random_net(model, width, seed).to("cuda")
    for side in (False, True):
        cam = T.Camera.new(*SIDE) if side else T.Camera.default()
        launches = COUNTS["launch.neural_mlp"]
        got = neural_kernel.neural_render_packed(net, cam, _plan_scene(model), precision=tier,
                                                 device="cuda")
        torch.cuda.synchronize()
        assert COUNTS["launch.neural_mlp"] == launches + 1
        want = neural_kernel.neural_render_packed_reference(net, cam, _plan_scene(model),
                                                            precision=tier, device="cuda")
        assert_frames_agree(unpack_frame(got).cpu(), unpack_frame(want).cpu(),
                            highest=tier == "highest")


@pytest.mark.gpu
@pytest.mark.parametrize("model", ["schwarzschild", "kerr"])
def test_highest_tier_ragged_last_block_on_gpu(model):
    """The highest tier over pixel counts that no block size divides, so
    the last block is masked: a 97x61 frame, and a band of 7 rows of a
    1013x61 frame, each against the plain version at the tier's bar, and
    the band bit-equal to its whole frame's rows (N1 on the committed net,
    N2 on the fp32-trained Kerr net at spin 0.9)."""
    _need_cuda()
    from bhr_tpu_torch.models import neural_kerr

    kerr = model == "kerr"
    tp, _ = (neural_kerr if kerr else tn).load_params(
        ASSETS / ("neural_kerr_default.npz" if kerr else "neural_schwarzschild.npz"))
    tp = tp.to("cuda")
    cam = T.Camera.new(*SIDE) if kerr else T.Camera.default()
    spin = 0.9 if kerr else 0.0
    scene = T.SceneParams(screen_width=97, screen_height=61, spin=spin)
    got = neural_kernel.neural_render_packed(tp, cam, scene, precision="highest", device="cuda")
    want = neural_kernel.neural_render_packed_reference(tp, cam, scene, precision="highest",
                                                        device="cuda")
    assert_frames_agree(unpack_frame(got).cpu(), unpack_frame(want).cpu(), highest=True)
    wide = T.SceneParams(screen_width=1013, screen_height=61, spin=spin)
    whole = neural_kernel.neural_render_packed(tp, cam, wide, precision="highest", device="cuda")
    band = neural_kernel.neural_render_packed_band(tp, cam, wide, 20, 7, precision="highest",
                                                   device="cuda")
    torch.cuda.synchronize()
    assert torch.equal(band, whole[20:27])
    want = neural_kernel.neural_render_packed_reference(tp, cam, wide, precision="highest",
                                                        device="cuda", row0=20,
                                                        local_shape=(7, 1013))
    assert_frames_agree(unpack_frame(band).cpu(), unpack_frame(want).cpu(), highest=True)


@pytest.mark.gpu
@pytest.mark.parametrize("model", ["schwarzschild", "kerr"])
def test_default_tier_ragged_last_block_on_gpu(model):
    """The default tier over pixel counts that no round of the fused
    layout divides, so the last warps' pixels are masked: a 97x61 frame,
    and a band of 7 rows of a 1013x61 frame, each against the plain version
    at the tier's bars, and the band bit-equal to its whole frame's rows (N1
    on the committed net, its weights held; N2 on the committed Kerr net at
    spin 0.9, streamed)."""
    _need_cuda()
    from bhr_tpu_torch.models import neural_kerr

    kerr = model == "kerr"
    tp, _ = (neural_kerr if kerr else tn).load_params(
        ASSETS / ("neural_kerr.npz" if kerr else "neural_schwarzschild.npz"))
    tp = tp.to("cuda")
    assert neural_kernel.kernel_plan(tp, "default")[1:] == ((64, 4, 256) if kerr else (0, 0, 128))
    cam = T.Camera.new(*SIDE) if kerr else T.Camera.default()
    spin = 0.9 if kerr else 0.0
    scene = T.SceneParams(screen_width=97, screen_height=61, spin=spin)
    got = neural_kernel.neural_render_packed(tp, cam, scene, device="cuda")
    want = neural_kernel.neural_render_packed_reference(tp, cam, scene, device="cuda")
    assert_frames_agree(unpack_frame(got).cpu(), unpack_frame(want).cpu())
    wide = T.SceneParams(screen_width=1013, screen_height=61, spin=spin)
    whole = neural_kernel.neural_render_packed(tp, cam, wide, device="cuda")
    band = neural_kernel.neural_render_packed_band(tp, cam, wide, 20, 7, device="cuda")
    torch.cuda.synchronize()
    assert torch.equal(band, whole[20:27])
    want = neural_kernel.neural_render_packed_reference(tp, cam, wide, device="cuda", row0=20,
                                                        local_shape=(7, 1013))
    assert_frames_agree(unpack_frame(band).cpu(), unpack_frame(want).cpu())


@pytest.mark.gpu
def test_streamed_launches_are_counted_on_gpu():
    """launch.neural_mlp.streamed counts each launch of the streamed plan
    -- one a frame, band or direction-plane launch of the Kerr net (and of
    the 256-wide Schwarzschild net) -- and none of the held plan's (N1)."""
    _need_cuda()
    from bhr_tpu_torch.models import neural_kerr

    nets = ((neural_kerr.load_params(ASSETS / "neural_kerr.npz")[0], 0.9, True),
            (tn.load_params(ASSETS / "neural_schwarzschild_orbit_xl.npz")[0], 0.0, True),
            (tn.load_params(ASSETS / "neural_schwarzschild.npz")[0], 0.0, False))
    cam = T.Camera.new(*SIDE)
    for net, spin, streamed in nets:
        net = net.to("cuda")
        plan = neural_kernel.kernel_plan(net, "default")
        assert (plan == neural_kernel.STREAMED_PLAN) == streamed
        scene = T.SceneParams(screen_width=160, screen_height=96, spin=spin)
        before = COUNTS["launch.neural_mlp.streamed"], COUNTS["launch.neural_mlp"]
        for _ in range(3):
            neural_kernel.neural_render_packed(net, cam, scene, device="cuda")
        neural_kernel.neural_render_packed_band(net, cam, scene, 10, 20, device="cuda")
        neural_kernel.neural_trace_dirs(net, cam, scene, device="cuda")
        torch.cuda.synchronize()
        assert COUNTS["launch.neural_mlp"] - before[1] == 4
        assert COUNTS["launch.neural_mlp.streamed"] - before[0] == (5 if streamed else 0)


@pytest.mark.gpu
def test_neural_animation_on_gpu():
    """4 orbit frames, one launch each and no host sync, each as the plain
    version renders it."""
    _need_cuda()
    r = T.BlackHoleRenderer(64, 48, "neural", device="cuda",
                            neural_params=ASSETS / "neural_schwarzschild_orbit.npz")
    anim = T.OrbitAnimator(r)
    anim.render_frames(1)  # build and prepare the weights outside the checked window
    launches = COUNTS["launch.neural_mlp"], COUNTS["launch.render_mono"]
    torch.cuda.set_sync_debug_mode("error")
    frames = anim.render_frames(4, packed=True)
    torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert (COUNTS["launch.neural_mlp"], COUNTS["launch.render_mono"]) == (launches[0] + 4,
                                                                       launches[1])
    for k, t in enumerate(anim.frame_times(4)):
        want = neural_kernel.neural_render_packed_reference(r.neural_params, T.orbit_camera(t),
                                                            r.scene, device="cuda")
        assert_frames_agree(unpack_frame(frames[k]).cpu(), unpack_frame(want).cpu())
