"""Plugin physics (model="custom") in the port: bhr_tpu's tests/test_plugin.py
cases through bhr_tpu_torch, its plain custom trace against bhr_tpu's
oracle on the same plugin, and the recorder that turns a plugin into the
kernel's CUDA source (bhr_tpu_torch/utils/plugin.py), whose program is
interpreted here in torch fp32 and held bit for bit against the plugin run
on the same tensors. The kernel is held against its plain version by the
`gpu`-marked tests at the end.

Bars. The port against bhr_tpu's oracle: the chaos-aware bars of
tests/test_pallas_parity.py:46-61 (status equal on >= 99.5% of pixels,
velocity within 1e-4 where both agree and the ray is not captured), as
bhr_tpu holds its own kernel against its oracle; a plugin that restates a
built-in model equals the built-in everywhere in status and steps, as
bhr_tpu's test holds it.
"""

import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bhr_tpu as J
import bhr_tpu_torch as T
from bhr_tpu.core.camera import generate_rays as j_generate_rays
from bhr_tpu.ops.trace import trace_rays as j_trace_rays
from bhr_tpu.utils.plugin import load_plugin as j_load_plugin
from bhr_tpu_torch.ops import trace_kernel
from bhr_tpu_torch.ops.trace import STATUS_CAPTURED, trace_rays
from bhr_tpu_torch.utils import plugin
from bhr_tpu_torch.utils.tracing import COUNTS

REPO = pathlib.Path(__file__).resolve().parent.parent
PW_PLUGIN = REPO / "examples" / "plugins" / "paczynski_wiita.py"
W, H, STEPS = 48, 32, 120
CLOSE = ([0.0, 3.0, 11.0], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0])


def _scene(**kw):
    return T.SceneParams(screen_width=W, screen_height=H, max_steps=STEPS, **kw)


def _trace(camera, scene, config, fast_math=False):
    origins, dirs = T.generate_rays(camera, scene.screen_width, scene.screen_height, scene.fov)
    return trace_rays(origins, dirs, scene.black_hole_position, scene.schwarzschild_radius,
                      scene.spin, scene.max_steps, config, fast_math=fast_math)


def _schwarzschild_planes(rel, vel, r, r2, rs, spin):
    """The built-in Schwarzschild acceleration as a plugin, in the oracle's
    literal operation order (bhr_tpu's tests/test_plugin.py)."""
    del spin
    r_vec = (rel[0] / r, rel[1] / r, rel[2] / r)
    rs_over_r = rs / r
    one_m = 1.0 - rs_over_r
    factor = rs / (2.0 * r * r * one_m)
    v_rad = vel[0] * r_vec[0] + vel[1] * r_vec[1] + vel[2] * r_vec[2]
    one_p = 1.0 + rs_over_r
    return (-factor * (vel[0] * one_m - r_vec[0] * v_rad * one_p),
            -factor * (vel[1] * one_m - r_vec[1] * v_rad * one_p),
            -factor * (vel[2] * one_m - r_vec[2] * v_rad * one_p))


def _zero_planes(rel, vel, r, r2, rs, spin):
    z = torch.zeros_like(rel[0])
    return (z, z, z)


def _drag_planes(rel, vel, r, r2, rs, spin):
    """A velocity-dependent toy with every operator form the recorder
    takes: number on either side, c / x, x / 2**k, unary minus, r2, spin,
    and a constant output."""
    k = 0.25 * rs * spin
    inv = 1.0 / r2
    return (-(k * vel[2]) * inv - rel[0] / 4.0, 3.0 - (2 + vel[1]) * 0.5 + rs / r, 0.0)


def test_config_requires_accel():
    with pytest.raises(ValueError, match="custom_accel"):
        T.TraceConfig(model="custom")


def test_plugin_zero_accel_matches_flat():
    """A zero-force plugin reproduces the flat model's trace exactly in the
    exact tier (the same loop and termination bookkeeping). The fast tier
    renormalises the unit velocity by rsqrt every step, an ulp's walk:
    status and steps equal, directions within 1e-5 and positions within
    1e-4 after 120 steps of 0.1."""
    cam, scene = T.Camera.default(), _scene()
    rf = _trace(cam, scene, T.TraceConfig(model="flat"))
    for fast in (False, True):
        rp = _trace(cam, scene, T.TraceConfig(model="custom", custom_accel=_zero_planes,
                                              custom_capture_factor=1.05), fast)
        for name, atol in (("status", 0), ("steps", 0), ("final_vel", 1e-5),
                           ("final_pos", 1e-4)):
            torch.testing.assert_close(getattr(rp, name), getattr(rf, name), rtol=0,
                                       atol=atol if fast else 0, msg=name)


@pytest.mark.parametrize("integrator", ["euler", "rk4", "leapfrog"])
def test_plugin_schwarzschild_matches_builtin(integrator):
    """The Schwarzschild formula as a plugin through the plain version
    equals the built-in model: the same operations in the same order, so
    bit for bit in the exact tier."""
    cam, scene = T.Camera.default(), _scene()
    rp = _trace(cam, scene, T.TraceConfig(integrator=integrator, model="custom",
                                          custom_accel=_schwarzschild_planes,
                                          custom_capture_factor=1.05))
    rs = _trace(cam, scene, T.TraceConfig(integrator=integrator))
    for name in ("status", "steps", "final_pos", "final_vel"):
        assert torch.equal(getattr(rp, name), getattr(rs, name)), name


@pytest.mark.parametrize("integrator", ["euler", "rk4", "leapfrog"])
def test_plain_custom_trace_matches_jax_oracle(integrator):
    """paczynski_wiita.py through the port's plain trace (both tiers)
    against bhr_tpu's oracle with the same file, at the chaos-aware bars,
    from a camera at r = 11.4 whose frame is a third shadow."""
    accel, cap = plugin.load_plugin(str(PW_PLUGIN))
    j_accel, j_cap = j_load_plugin(str(PW_PLUGIN))
    assert cap == j_cap == pytest.approx(1.10)
    jscene = J.SceneParams(screen_width=W, screen_height=H, max_steps=STEPS)
    jcam = J.Camera.new(*CLOSE)
    o, d = j_generate_rays(jcam, W, H, jscene.fov)
    want = j_trace_rays(o, d, jscene.black_hole_position, jscene.schwarzschild_radius,
                        jscene.spin, STEPS, J.TraceConfig(integrator=integrator, model="custom",
                                                          custom_accel=j_accel,
                                                          custom_capture_factor=j_cap))
    so = np.asarray(want.status)
    assert 0.05 < (so == STATUS_CAPTURED).mean() < 0.5
    for fast in (False, True):
        got = _trace(T.Camera.new(*CLOSE), _scene(), T.TraceConfig(
            integrator=integrator, model="custom", custom_accel=accel, custom_capture_factor=cap),
            fast)
        same = got.status.numpy() == so
        assert same.mean() >= 0.995, f"status agrees on {same.mean():.4f}"
        m = same & (so != STATUS_CAPTURED)
        vd = np.abs(got.final_vel.numpy() - np.asarray(want.final_vel)).max(-1)
        assert (vd[m] <= 1e-4).mean() >= 0.995


def test_plugin_not_monolithic_eligible():
    cfg = T.TraceConfig(model="custom", custom_accel=_zero_planes)
    for fast in (False, True):
        assert not trace_kernel.monolithic_eligible(cfg, _scene(), fast_math=fast, skybox=None,
                                                    disk_params=None, tonemap="passthrough")
    with pytest.raises(ValueError, match="plugin physics"):
        trace_kernel.render_packed(T.Camera.default(), _scene(), cfg, device="cpu")


def test_loader_accepts_callable_module_and_path(tmp_path):
    fn, cap = plugin.load_plugin(_zero_planes)
    assert fn is _zero_planes and cap == pytest.approx(1.05)
    f1, c1 = plugin.load_plugin(str(PW_PLUGIN))
    f2, _ = plugin.load_plugin(str(PW_PLUGIN))
    assert f1 is f2 and c1 == pytest.approx(1.10)

    class Mod:
        acceleration = staticmethod(_zero_planes)
        CAPTURE_FACTOR = 1.2

    fn, cap = plugin.load_plugin(Mod())
    assert fn is _zero_planes and cap == pytest.approx(1.2)
    bad = tmp_path / "bad.py"
    bad.write_text("x = 1\n")
    with pytest.raises(ValueError, match="acceleration"):
        plugin.load_plugin(str(bad))
    with pytest.raises(FileNotFoundError):
        plugin.load_plugin(str(tmp_path / "missing.py"))


def test_renderer_custom_physics_renders():
    """bhr_tpu's renderer cases: the file's capture factor, a shadow, and
    the conflicts / custom_physics / multires errors; the frame is the
    staged one, the plain trace and the epilogue."""
    r = T.BlackHoleRenderer(64, 48, custom_physics=str(PW_PLUGIN), device="cpu")
    assert r.config.model == "custom"
    assert r.config.custom_capture_factor == pytest.approx(1.10)
    scene = T.SceneParams(screen_width=64, screen_height=48, max_steps=150)
    cam = T.Camera.new(*CLOSE)
    img = r.render_frame(cam, scene)
    assert img.shape == (48, 64, 4) and (img[..., 3] == 255).all()
    res = trace_kernel.trace_image(cam, scene, r.config, device="cpu")
    assert (res.status == STATUS_CAPTURED).any()
    assert (img[..., :3][res.status == STATUS_CAPTURED] == 0).all()
    torch.testing.assert_close(img, T.shade_image(res, cam, scene, None, None,
                                                  tonemap="passthrough"), rtol=0, atol=0)
    with pytest.raises(ValueError, match="conflicts"):
        T.BlackHoleRenderer(32, 32, model="kerr", custom_physics=_zero_planes, device="cpu")
    with pytest.raises(ValueError, match="custom_physics"):
        T.BlackHoleRenderer(32, 32, model="custom", device="cpu")
    with pytest.raises(ValueError, match="multires"):
        T.BlackHoleRenderer(32, 32, multires=2, custom_physics=_zero_planes, device="cpu")
    with pytest.raises(ValueError, match="multires"):
        r.render_frame_multires(cam, scene)


# ---- the recorder -----------------------------------------------------------------


def _interpret(program, env):
    """Run a recorded program's SSA lines in torch fp32 on `env`'s tensors:
    each line the one operation its CUDA line makes."""
    env = dict(env)

    def val(x):
        return torch.tensor(float(x), dtype=torch.float32) if isinstance(x, np.float32) else env[x]

    for dst, op, a, b in program.ops:
        if op == "neg":
            env[dst] = -val(a)
        else:
            env[dst] = {"add": torch.add, "sub": torch.sub, "mul": torch.mul,
                        "div": torch.div}[op](val(a), val(b))
    return [val(x) for x in program.outputs]


@pytest.mark.parametrize("name", ["paczynski_wiita", "schwarzschild", "drag"])
def test_recorded_program_equals_the_plugin(name):
    """The recorded program, interpreted in torch fp32, is bit for bit the
    plugin called on the same tensors (random rays around the hole, rs and
    spin as 0-d tensors, as the plain version passes them); its CUDA source
    has one correctly rounded line per operation and the constants' fp32
    bits."""
    accel = {"paczynski_wiita": plugin.load_plugin(str(PW_PLUGIN))[0],
             "schwarzschild": _schwarzschild_planes, "drag": _drag_planes}[name]
    rng = np.random.default_rng(6)
    rel = torch.from_numpy(rng.uniform(-20, 20, (3, 4096)).astype(np.float32))
    vel = torch.from_numpy(rng.standard_normal((3, 4096)).astype(np.float32))
    r = torch.sqrt(rel[0] * rel[0] + rel[1] * rel[1] + rel[2] * rel[2])
    rs, spin = torch.tensor(2.0), torch.tensor(0.7)
    env = {"rel.x": rel[0], "rel.y": rel[1], "rel.z": rel[2], "vel.x": vel[0],
           "vel.y": vel[1], "vel.z": vel[2], "r": r, "r2": r * r, "rs": rs, "spin": spin}
    program = plugin.record(accel)
    got = _interpret(program, env)
    want = accel(tuple(rel), tuple(vel), r, r * r, rs, spin)
    for g, w in zip(got, want):
        w = torch.as_tensor(w, dtype=torch.float32)
        assert torch.equal(torch.broadcast_to(g, rel[0].shape), torch.broadcast_to(w, rel[0].shape))
    src = program.cuda_source()
    assert "#define BHR_CUSTOM_ACCEL" in src and "plugin_acceleration" in src
    assert src.count("const float t") == len(program.ops)
    if name == "paczynski_wiita":
        # gm = 0.5 rs and -gm are launch constants: 7 operations a call
        assert program.varying_ops == 7 and "__int_as_float(0x3f000000)" in src
        assert "__fdiv_rn(t2, t4)" in src
    if name == "drag":
        # x / 4.0 is a multiply by the fp32 reciprocal; 1.0 / r2 reciprocal then multiply
        assert "__int_as_float(0x3e800000)" in src and "return {" in src


def test_recorder_refuses_what_the_kernel_cannot_take():
    cases = {"torch function": _zero_planes,
             "comparison": lambda rel, vel, r, r2, rs, spin: (r if r > rs else rs,) * 3,
             r"\*\*": lambda rel, vel, r, r2, rs, spin: (r ** 2,) * 3,
             "numpy function": lambda rel, vel, r, r2, rs, spin: (np.sqrt(r),) * 3,
             "method": lambda rel, vel, r, r2, rs, spin: (r.sqrt(),) * 3,
             "abs": lambda rel, vel, r, r2, rs, spin: (abs(r),) * 3}
    for what, accel in cases.items():
        with pytest.raises(ValueError, match=what):
            plugin.record(accel)
    with pytest.raises(ValueError, match=r"\(ax, ay, az\)"):
        plugin.record(lambda rel, vel, r, r2, rs, spin: r)


# ---- on the card ----------------------------------------------------------------------


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")


@pytest.mark.gpu
@pytest.mark.parametrize("fast", [False, True], ids=["exact", "fast"])
@pytest.mark.parametrize("integrator", ["euler", "rk4", "leapfrog"])
def test_custom_kernel_matches_plain_version_on_gpu(integrator, fast):
    """trace_planes built with paczynski_wiita.py against its plain version
    on the card, adaptive dt and the disk: status and steps equal on >=
    99.5%, the exact tier's planes bit-equal on >= 99.9%; one launch, counted
    in COUNTS["launch.trace_planes.custom"]; the renderer's frame is that launch and the
    epilogue."""
    _need_cuda()
    accel, cap = plugin.load_plugin(str(PW_PLUGIN))
    scene = T.SceneParams(screen_width=160, screen_height=96, max_steps=300)
    cam = T.Camera.new([15.0, 5.0, 0.0], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0])
    cfg = T.TraceConfig(integrator=integrator, model="custom", custom_accel=accel,
                        custom_capture_factor=cap, adaptive=True, disk=True)
    n = COUNTS["launch.trace_planes.custom"]
    got = trace_kernel.trace_image(cam, scene, cfg, fast_math=fast, device="cuda")
    torch.cuda.synchronize()
    assert COUNTS["launch.trace_planes.custom"] == n + 1
    want = trace_kernel.trace_image_reference(cam, scene, cfg, fast_math=fast, device="cuda")
    same = (got.status == want.status) & (got.steps == want.steps)
    assert same.float().mean().item() >= 0.995
    if not fast:
        for f in ("final_pos", "final_vel"):
            assert (getattr(got, f) == getattr(want, f)).all(-1).float().mean().item() >= 0.999
    r = T.BlackHoleRenderer(160, 96, integrator, custom_physics=str(PW_PLUGIN), adaptive=True,
                            disk=True, fast_math=fast, device="cuda")
    frame = r.render_frame(cam, scene)
    plan = r._frame_plan(scene)
    torch.testing.assert_close(frame, T.shade_image(got, cam, scene, plan.disk_params, plan.lut,
                                                    tonemap="passthrough"), rtol=0, atol=0)
