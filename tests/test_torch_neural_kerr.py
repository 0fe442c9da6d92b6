"""The neural surrogate's Kerr path (N2) of the port against bhr_tpu, on
identical numpy inputs and the committed weights (neural_kerr.npz,
bf16-trained; neural_kerr_default.npz, fp32-trained): the Kerr model
functions, the MLP, the kernel's plain version against bhr_tpu's Pallas
kernel in interpret mode at both tiers, the staged route against bhr_tpu's
staged path, precision resolution and the spin-range warning. The CUDA
kernel itself is held against its plain version by the `gpu`-marked tests
at the end. Tolerances and frame bars as in tests/test_torch_neural.py.
"""

import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bhr_tpu as J
import bhr_tpu_torch as T
from bhr_tpu.models import neural as jn
from bhr_tpu.models import neural_kerr as jnk
from bhr_tpu.ops.neural_pallas import neural_render_packed as j_neural_render_packed
from bhr_tpu.ops.sampling import unpack_frame as j_unpack
from bhr_tpu.renderer import render_image as j_render_image
from bhr_tpu_torch.models import neural as tn
from bhr_tpu_torch.models import neural_kerr as tnk
from bhr_tpu_torch.ops import neural_kernel
from bhr_tpu_torch.ops.neural_trace import neural_trace_image
from bhr_tpu_torch.ops.sampling import unpack_frame
from bhr_tpu_torch.utils.tracing import COUNTS
from test_torch_neural import assert_frames_agree

ASSETS = tn.ASSETS_DIR
W, H = 64, 48
SPIN = 0.9
SIDE = ([15.0, 5.0, 0.0], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0])  # scripts/golden_diff.py:128


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _params(asset="neural_kerr.npz"):
    jp, _ = jnk.load_params(str(ASSETS / asset))
    return jp, T.neural_params_from_numpy(jp)


def _setup(side, spin=SPIN, w=W, h=H):
    cams = (J.Camera.new(*SIDE), T.Camera.new(*SIDE)) if side else (J.Camera.default(),
                                                                      T.Camera.default())
    return (*cams, J.SceneParams(screen_width=w, screen_height=h, max_steps=500,
                                 spin=jnp.float32(spin)),
            T.SceneParams(screen_width=w, screen_height=h, max_steps=500, spin=spin))


def _inputs(n=4096, seed=4):
    """Reduced Kerr coordinates: r0 from 1.6 rs, radial rays, rays at the
    spin-shifted critical impact parameter, and a unit spin-axis image
    (uy, wy, ny) in the ray-plane basis."""
    rng = np.random.RandomState(seed)
    rs = rng.uniform(0.5, 4.0, n).astype(np.float32)
    r0 = (rs * rng.uniform(1.6, 50.0, n)).astype(np.float32)
    psi = rng.uniform(0.0, np.pi, n).astype(np.float32)
    psi[:64] = 0.0
    c, s = np.cos(psi).astype(np.float32), np.sin(psi).astype(np.float32)
    axis = rng.randn(n, 3)
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    uy, wy, ny = (axis[:, i].astype(np.float32) for i in range(3))
    xi = (SPIN * ny).astype(np.float32)
    bck = np.asarray(jnk.bc_factor_kerr(xi)) * np.asarray(jnk.redshift_factor(r0, rs))
    k = slice(64, 448)
    s[k] = np.clip(bck[k] * rs[k] * (1 + rng.uniform(-1e-3, 1e-3, 384)) / r0[k], 0.0, 1.0)
    c[k] = -np.sqrt(1.0 - s[k].astype(np.float64) ** 2)
    return r0, rs, c, s, uy, wy, ny


# ---- the model functions ------------------------------------------------------


def test_bc_factor_and_redshift_are_bit_equal_to_jax():
    """The degree-6 polynomial in bhr_tpu's nesting and the clamped
    redshift factor: bit-equal over xi in [-1.1, 1.1] (sqrt of a clamped
    negative at the far end) and the trained r0 range."""
    xi = np.linspace(-1.1, 1.1, 8193).astype(np.float32)
    np.testing.assert_array_equal(tnk.bc_factor_kerr(_t(xi)).numpy(),
                                  np.asarray(jnk.bc_factor_kerr(xi)))
    r0, rs = _inputs()[:2]
    np.testing.assert_array_equal(tnk.redshift_factor(_t(r0), _t(rs)).numpy(),
                                  np.asarray(jnk.redshift_factor(r0, rs)))
    # b_c / rs from 1 (prograde, xi = -1) through 3 sqrt(3) / 2 to ~3.5
    # (7 M retrograde; the fit holds to 2.5e-3 M for |xi| <= 0.955)
    b = tnk.bc_factor_kerr(torch.tensor([-1.0, 0.0, 1.0])).numpy()
    np.testing.assert_allclose(b, [1.0, 2.598076, 3.5], atol=4e-3)


def test_reduce_ray_matches_jax():
    """Bit-equal but for n_hat = u x w, where XLA's cross differs by up to
    1 ulp (6e-8); radial rays (d = -u) included."""
    rng = np.random.RandomState(6)
    o = (rng.randn(2048, 3) * 10).astype(np.float32)
    d = rng.randn(2048, 3).astype(np.float32)
    d[:32] = -o[:32]
    bh = np.array([0.5, -0.25, 1.0], np.float32)
    want = jnk.reduce_ray(o, d, bh)
    got = tnk.reduce_ray(_t(o), _t(d), _t(bh))
    for key in ("r0", "c", "s", "uy", "wy", "u_hat", "w_hat"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)
    for key in ("ny", "n_hat"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=0, atol=1.2e-7)


def test_ray_features_kerr_match_jax():
    """Within 2.4e-7 absolute (the log and tanh features' ulps), radial and
    near-critical rays included."""
    r0, rs, c, s, uy, wy, ny = _inputs()
    want = np.asarray(jnk.ray_features_kerr(r0, rs, np.float32(SPIN), c, s, uy, wy, ny))
    got = tnk.ray_features_kerr(_t(r0), _t(rs), SPIN, _t(c), _t(s), _t(uy), _t(wy), _t(ny))
    assert got.shape == (4096, tnk.N_FEATURES_KERR)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=3e-7)


def test_kerr_envelopes_match_jax():
    """Both envelopes within 3e-7 relative pointwise; E_chi carries
    |a*| + 1e-3."""
    r0, rs, c, s, uy, wy, ny = _inputs()
    want = jnk.kerr_envelopes(r0, rs, np.float32(SPIN), s, c, ny)
    got = tnk.kerr_envelopes(_t(r0), _t(rs), SPIN, _t(s), _t(c), _t(ny))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=3e-7, atol=0)
    torch.testing.assert_close(got[1], got[0] * (torch.tensor(SPIN) + 1e-3), rtol=0, atol=0)


@pytest.mark.parametrize("asset,precision", [("neural_kerr.npz", "default"),
                                             ("neural_kerr_default.npz", "highest")])
def test_mlp_apply_kerr_matches_jax(asset, precision):
    """The 22 -> 256 x 3 -> 3 net: default against bhr_tpu at bf16 (within
    2e-4 of each head's largest magnitude), highest against its fp32 chain
    (within 3e-6)."""
    jp, tp = _params(asset)
    r0, rs, c, s, uy, wy, ny = _inputs()
    feats = np.asarray(jnk.ray_features_kerr(r0, rs, np.float32(SPIN), c, s, uy, wy, ny))
    want = np.asarray(jn.mlp_apply(jp, feats, dtype=jnp.bfloat16 if precision == "default"
                                   else jnp.float32))
    got = tn.mlp_apply(tp, _t(feats), precision=precision).numpy()
    tol = 2e-4 if precision == "default" else 3e-6
    assert (np.abs(got - want) <= tol * np.abs(want).max(0)).all()


# ---- frames against bhr_tpu -----------------------------------------------------


@pytest.mark.parametrize("case", [(True, SPIN), (False, 0.0), (False, SPIN)],
                         ids=["side-spin0.9", "default-spin0", "default-spin0.9"])
def test_kernel_plain_version_matches_jax_interpret_kernel(case):
    """neural_render_packed_reference against bhr_tpu's Pallas kernel in
    interpret mode (neural_kerr.npz, default tier), 64x48, bhr_tpu's bars."""
    side, spin = case
    jp, tp = _params()
    jcam, tcam, jsc, tsc = _setup(side, spin)
    want = j_unpack(j_neural_render_packed(jp, jcam, jsc, interpret=True))
    got = neural_kernel.neural_render_packed_reference(tp, tcam, tsc, device="cpu")
    assert_frames_agree(unpack_frame(got), want)


def test_kernel_plain_version_highest_matches_jax_interpret_kernel():
    """The fp32-trained net (neural_kerr_default.npz) at the highest tier,
    64x48, Camera.default(), spin 0.9: >= 99.9% bit-equal. Its fp32 sums
    taken in another order move a final direction by up to ~1e-4 where the
    net's deflection is large, which flips a star pixel's rounding on
    about a tenth of a percent of pixels (ROADMAP queue C)."""
    jp, tp = _params("neural_kerr_default.npz")
    jcam, tcam, jsc, tsc = _setup(False)
    want = j_unpack(j_neural_render_packed(jp, jcam, jsc, interpret=True, precision="highest"))
    got = neural_kernel.neural_render_packed_reference(tp, tcam, tsc, precision="highest",
                                                       device="cpu")
    assert_frames_agree(unpack_frame(got), want, highest=True)


def test_staged_route_matches_jax_staged_bfloat16():
    """The staged route (srgb tonemap) against bhr_tpu's staged path at bf16
    operands, 64x48, side camera, spin 0.9."""
    jp, tp = _params()
    jcam, tcam, jsc, tsc = _setup(True)
    want = j_render_image(jcam, jsc, None, None, None,
                          config=J.ops.trace.TraceConfig(integrator="neural", model="kerr"),
                          use_pallas=False, tile=(8, 128), fast_math=True, tonemap="srgb",
                          interpret=True, neural_params=jp, neural_dtype="bfloat16")
    got = T.render_image(tcam, tsc, config=T.TraceConfig(integrator="neural", model="kerr"),
                         fast_math=False, device="cpu", tonemap="srgb", neural_params=tp)
    assert_frames_agree(got, want)


def test_auto_resolves_high_and_high_staged_equals_highest_staged():
    """neural_kerr_default.npz (train_precision float32) resolves "auto" to
    "high", as in bhr_tpu, and renders through the staged route; the staged
    route computes high and highest alike (bhr_tpu's CPU test
    tests/test_neural_kerr.py:439-462 asserts the same), and the highest
    kernel's plain version agrees with it at the highest bar."""
    asset = ASSETS / "neural_kerr_default.npz"
    jr = J.BlackHoleRenderer(W, H, integrator="neural", model="kerr", neural_params=str(asset))
    r_auto = T.BlackHoleRenderer(W, H, "neural", model="kerr", neural_params=asset, device="cpu")
    r_hi = T.BlackHoleRenderer(W, H, "neural", model="kerr", neural_params=asset,
                               neural_precision="highest", device="cpu")
    assert r_auto.neural_precision == jr.neural_precision == "high"
    scene = T.SceneParams(screen_width=W, screen_height=H, spin=SPIN)
    assert not neural_kernel.kernel_takes(r_auto.neural_params, scene, tonemap="passthrough",
                                          precision="high")
    cam = T.Camera.new(*SIDE)
    res_high = neural_trace_image(r_auto.neural_params, cam, scene, device="cpu",
                                  precision="high")
    res_highest = neural_trace_image(r_hi.neural_params, cam, scene, device="cpu",
                                     precision="highest")
    for name in ("final_vel", "status"):
        torch.testing.assert_close(getattr(res_high, name), getattr(res_highest, name),
                                   rtol=0, atol=0)
    staged = r_auto.render_frame(cam, scene)
    kernel = r_hi.render_frame(cam, scene)
    assert_frames_agree(kernel, staged, highest=True)


def test_default_kerr_asset_and_spin_warning(caplog):
    """model='kerr' loads neural_kerr.npz with its spin range; a spin
    outside it warns, one inside does not."""
    r = T.BlackHoleRenderer(16, 12, "neural_kerr", device="cpu")
    assert r.config.model == "kerr" and r.neural_params.model == "kerr"
    assert r.neural_precision == "default" and r.neural_params.widths == (256, 256, 256)
    lo, hi = r._neural_spin_range
    assert lo <= SPIN <= hi
    for spin, warns in ((SPIN, False), (hi + 0.5, True)):
        caplog.clear()
        with caplog.at_level(logging.WARNING, logger="bhr_tpu_torch"):
            r.render_frame(scene=T.SceneParams(screen_width=16, screen_height=12, spin=spin))
        assert any("spin range" in rec.message for rec in caplog.records) == warns


# ---- the kernel against its plain version, on the card ---------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("case", [("neural_kerr.npz", None, SPIN), ("neural_kerr.npz", None, 0.0),
                                  ("neural_kerr_default.npz", "highest", SPIN)],
                         ids=["n2-default", "n2-spin0", "n2-highest"])
def test_neural_kerr_kernel_matches_plain_version_on_gpu(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    asset, precision, spin = case
    tp, _ = tnk.load_params(ASSETS / asset)
    tp = tp.to("cuda")
    cam = T.Camera.new(*SIDE)
    scene = T.SceneParams(screen_width=160, screen_height=96, spin=spin)
    launches = COUNTS["launch.neural_mlp"]
    got = neural_kernel.neural_render_packed(tp, cam, scene, precision=precision, device="cuda")
    torch.cuda.synchronize()
    assert COUNTS["launch.neural_mlp"] == launches + 1
    want = neural_kernel.neural_render_packed_reference(tp, cam, scene, precision=precision,
                                                        device="cuda")
    assert_frames_agree(unpack_frame(got).cpu(), unpack_frame(want).cpu(),
                        highest=precision == "highest")
