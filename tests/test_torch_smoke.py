"""chip_smoke.py's bar of a kernel frame against its plain version, on
synthetic frames: capture is held on the ray status, not on black pixels,
so dark sky that differs passes and a captured ray that is lit fails."""

import dataclasses
import importlib.util
import os
import re

import pytest
import torch

from bhr_tpu_torch.tools import sass_walk

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(os.path.dirname(__file__), os.pardir, "chip_smoke.py"))
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)


def _frame(rgb):
    """(H, W, 3) uint8 -> packed int32 (H, W) with alpha 255."""
    h, w, _ = rgb.shape
    rgba = torch.cat([rgb, torch.full((h, w, 1), 255, dtype=torch.uint8)], -1).contiguous()
    return rgba.view(torch.int32).view(h, w)


def _scene(seed=0):
    """A 40x40 frame: a captured disc (black), dark sky around it (mostly
    black too, as at 1920x1080x500 where 57% of pixels are black but 10.6%
    of rays are captured), and a few stars."""
    g = torch.Generator().manual_seed(seed)
    yy, xx = torch.meshgrid(torch.arange(40), torch.arange(40), indexing="ij")
    captured = (yy - 20) ** 2 + (xx - 20) ** 2 < 36
    status = torch.where(captured, 2, 0).to(torch.int32)
    rgb = torch.zeros(40, 40, 3, dtype=torch.uint8)
    stars = (torch.rand(40, 40, generator=g) < 0.05) & ~captured
    rgb[stars] = 200
    return rgb, status


@pytest.mark.parametrize("fast", [False, True], ids=["exact", "fast"])
def test_compare_passes_a_frame_that_differs_only_in_dark_sky(fast):
    rgb, status = _scene()
    kernel = rgb.clone()
    sky = (status == 0) & (rgb.amax(-1) == 0)
    idx = sky.nonzero()[:1]  # dark sky one level brighter (the exact bar allows 0.1%)
    kernel[idx[:, 0], idx[:, 1]] = 1
    s = chip_smoke.compare(_frame(kernel), _frame(rgb), fast, status, status.clone())
    assert s["status_agree"] == 1.0 and s["captured_black"] == 1.0
    assert s["max_abs_err"] == 1 and s["black_frac"] > s["captured_frac"]


@pytest.mark.parametrize("fast", [False, True], ids=["exact", "fast"])
def test_compare_fails_a_frame_with_a_lit_captured_ray(fast):
    rgb, status = _scene()
    kernel = rgb.clone()
    kernel[20, 20] = 1  # one level: inside the fast bar, but the ray was captured
    captured = status == 2
    assert captured.sum() < 200  # one lit ray is > 0.5% of the captured rays
    with pytest.raises(AssertionError, match="disagrees"):
        chip_smoke.compare(_frame(kernel), _frame(rgb), fast, status, status.clone())


def test_compare_fails_on_status_alone():
    """Frames alike, but the kernel's status plane disagrees on > 0.5%."""
    rgb, status = _scene()
    k_status = status.clone()
    k_status[:2] = 1
    with pytest.raises(AssertionError, match="status_agree"):
        chip_smoke.compare(_frame(rgb), _frame(rgb), True, k_status, status)


def test_compare_fails_the_exact_tier_on_one_level_everywhere():
    rgb, status = _scene()
    kernel = rgb.clone()
    kernel[..., 0] = torch.where(status == 2, 0, rgb[..., 0].int() + 1).to(torch.uint8)
    with pytest.raises(AssertionError, match="bit_same"):
        chip_smoke.compare(_frame(kernel), _frame(rgb), False, status, status)
    chip_smoke.compare(_frame(kernel), _frame(rgb), True, status, status)  # fast bar holds


def test_compare_lets_a_heatmap_colour_captured_rays():
    """A debug heatmap colours every ray by its step count: captured rays
    are not black there, and only the status and frame bars apply."""
    rgb, status = _scene()
    rgb[status == 2] = 90
    with pytest.raises(AssertionError, match="captured_black"):
        chip_smoke.compare(_frame(rgb), _frame(rgb), False, status, status)
    s = chip_smoke.compare(_frame(rgb), _frame(rgb), False, status, status, heatmap=True)
    assert s["captured_black"] == 0.0 and s["bit_same"] == 1.0


def test_bound_takes_the_larger_of_operations_and_bytes():
    """BASELINE config 5's fast frame: 2.9e9 ray-steps x 116 operations
    (the fast Kerr-Schild Euler step 115 and the disk test 1) over 67
    TFLOP/s bind; with no steps the 32-byte planes over 3.35 TB/s do."""
    ms, by = chip_smoke.bound("render_mono", "kerr", True, "euler", 2_901_389_628, 3840 * 2160,
                              adaptive=False, disk=True)
    assert by == "operations" and abs(ms - 2_901_389_628 * 116 / 67e12 * 1e3) < 1e-9
    ms, by = chip_smoke.bound("trace_planes", "schwarzschild", False, "rk4", 0, 3840 * 2160,
                              adaptive=True, disk=True)
    assert by == "bytes" and abs(ms - 3840 * 2160 * 32 / 3.35e12 * 1e3) < 1e-12


@pytest.mark.parametrize("model, fast, integrator, adaptive, disk, ops", [
    ("schwarzschild", False, "rk4", True, True, 235 + 5 + 2 + 1),
    ("schwarzschild", True, "leapfrog", True, False, 115 + 5 + 1 + 1),
    ("kerr", True, "euler", True, True, 115 + 5 + 1),
    ("kerr", False, "leapfrog", False, False, 380),
])
def test_step_ops_adds_adaptive_dt_and_the_disk_test(model, fast, integrator, adaptive, disk,
                                                     ops):
    assert chip_smoke.step_ops(model, fast, integrator, adaptive=adaptive, disk=disk) == ops


def test_step_ops_counts_shared_work_once():
    """Leapfrog's five Kerr-Schild evaluations need the geometry at q and
    at q' once each: fewer than 2.5 Euler steps in the oracle's form, not
    5, and fewer than 2.75 in the fast tier's, whose dp is cheaper beside its
    geometry; kerr_lt's leapfrog adds two full drags and the velocity part
    of a third."""
    for fast, lo, hi in ((True, 2.7, 2.75), (False, 2.4, 2.5)):
        euler = chip_smoke.step_ops("kerr", fast, "euler", adaptive=False, disk=False)
        leap = chip_smoke.step_ops("kerr", fast, "leapfrog", adaptive=False, disk=False)
        assert lo * euler < leap < hi * euler
    assert chip_smoke.OPS_PER_STEP[("kerr_lt", "exact", "leapfrog")] == 126 + 23 + 23 + 12


def test_ptxas_summary_names_every_instantiation():
    log = "\n".join([
        "ptxas info    : Compiling entry function '_ZN3bhr18render_mono_kernelILb1ELi2ELb1EEEv' "
        "for 'sm_90a'",
        "ptxas info    : Function properties for _ZN3bhr18render_mono_kernelILb1ELi2ELb1EEEv",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 48 registers, used 0 barriers",
        "ptxas info    : Compiling entry function '_ZN3bhr18render_mono_kernelILb0ELi1ELb0EEEv' "
        "for 'sm_90a'",
        "    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads",
        "ptxas info    : Used 255 registers, used 0 barriers",
    ])
    assert sass_walk.ptxas_summary(log) == (
        "fast,leapfrog,ks: 48 registers | exact,rk4: 8 bytes stack frame, 4 bytes spill "
        "stores, 4 bytes spill loads | exact,rk4: 255 registers")
    assert sass_walk.ptxas_summary("") == "already built"


def test_function_hash_follows_the_code():
    """function_hash is the same for the same listing and moves with any
    predicate, opcode or operand."""
    ins = [sass_walk.Ins(0, None, "FADD", None, ("R2", "R2", "R3")),
           sass_walk.Ins(16, "@P0", "EXIT", None, ())]
    same = [sass_walk.Ins(32, None, "FADD", None, ("R2", "R2", "R3")),
            sass_walk.Ins(48, "@P0", "EXIT", None, ())]
    assert sass_walk.function_hash(ins) == sass_walk.function_hash(same)
    assert len(sass_walk.function_hash(ins)) == 16
    others = ([ins[0]._replace(op="FMUL"), ins[1]],
              [ins[0]._replace(args=("R2", "R2", "R4")), ins[1]],
              [ins[0], ins[1]._replace(pred=None)])
    for other in others:
        assert sass_walk.function_hash(other) != sass_walk.function_hash(ins)


def test_ptxas_summary_names_the_neural_layouts():
    """The default tier's layouts by their mangled names: the held fused
    kernel with its register width, the streamed one, the chunked one."""
    def entry(name):
        return (f"ptxas info    : Compiling entry function '_ZN3bhr46_GLOBAL__N__3a75a30a_13_"
                f"neural_mlp_cu_fe53d78c{name}EvNS_6ParamsEjiiNS_7MlpDescEPjPfPi' for 'sm_90a'")

    log = "\n".join([
        entry("19neural_fused_kernelILb0ELi128EE"), "ptxas info    : Used 162 registers",
        entry("22neural_fused_kernel_wsILb1EE"), "ptxas info    : Used 128 registers",
        entry("20neural_render_kernelILb1ELb0EE"), "ptxas info    : Used 107 registers",
    ])
    assert sass_walk.ptxas_summary(log) == (
        "schwarzschild,default,fused128: 162 registers | kerr,default,streamed: 128 registers | "
        "kerr,default,chunked: 107 registers")


def _planes(seed=0, shape=(24, 32)):
    """A TraceResult of seeded unit directions, escaped but for a captured
    block."""
    from bhr_tpu_torch.ops.trace import TraceResult

    g = torch.Generator().manual_seed(seed)
    vel = torch.nn.functional.normalize(torch.randn(*shape, 3, generator=g), dim=-1)
    status = torch.ones(shape, dtype=torch.int32)
    status[8:14, 10:18] = chip_smoke.STATUS_CAPTURED
    return TraceResult(final_pos=torch.randn(*shape, 3, generator=g), final_vel=vel,
                       status=status, steps=torch.full(shape, 7, dtype=torch.int32))


@pytest.mark.parametrize("fast", [False, True], ids=["exact", "fast"])
def test_trace_compare_holds_every_plane(fast):
    """A strided or masked trace against its plain version: the fast tier
    takes directions within 1e-4, the exact tier needs them bit-equal; a
    status or step count that differs on 1% of pixels fails both."""
    p = _planes()
    k = dataclasses.replace(p, final_vel=p.final_vel + 2e-5)
    if fast:
        assert chip_smoke.trace_compare(k, p, True)["vel_bit_same"] < 0.5
    else:
        with pytest.raises(AssertionError, match="plain version"):
            chip_smoke.trace_compare(k, p, False)
    assert chip_smoke.trace_compare(p, p, fast)["max_abs_err"] == 0.0
    steps = p.steps.clone()
    steps[0, :8] = 9  # 8 of 768 rays
    with pytest.raises(AssertionError, match="plain version"):
        chip_smoke.trace_compare(dataclasses.replace(p, steps=steps), p, fast)


def test_multires_compare_is_the_reference_budget():
    full = torch.zeros(20, 20, 4, dtype=torch.uint8)
    near = full.clone()
    near[..., :3] = 2  # mean error 2 levels, none above 16
    assert chip_smoke.multires_compare(near, full)["mean_err"] == 2.0
    far = full.clone()
    far[:, :1, 0] = 40  # 5% of the pixels off by more than 16
    with pytest.raises(AssertionError, match="budget"):
        chip_smoke.multires_compare(far, full)
    with pytest.raises(AssertionError, match="budget"):
        chip_smoke.multires_compare(full + 3, full)


@pytest.mark.parametrize("highest", [False, True], ids=["default", "highest"])
def test_dirs_compare_bars_by_tier(highest):
    """The direction planes: an ulp passes both tiers, 2e-5 only the
    default tier's 1e-4, a status flipped on 1% of pixels neither."""
    p = _planes(1)
    assert chip_smoke.dirs_compare(dataclasses.replace(p, final_vel=p.final_vel + 1.2e-7), p,
                                   highest)["status_agree"] == 1.0
    k = dataclasses.replace(p, final_vel=p.final_vel + 2e-5)
    if highest:
        with pytest.raises(AssertionError, match="direction planes"):
            chip_smoke.dirs_compare(k, p, True)
    else:
        assert chip_smoke.dirs_compare(k, p, False)["vel_close"] == 1.0
    status = p.status.clone()
    status[0, :8] = chip_smoke.STATUS_CAPTURED
    with pytest.raises(AssertionError, match="direction planes"):
        chip_smoke.dirs_compare(dataclasses.replace(p, status=status), p, highest)


def test_neural_bound_of_the_direction_planes():
    """The direction-plane output does the frame's MLP products (the bound
    of both where the MLP binds) and writes 16 bytes a pixel instead of 4."""
    params = [(torch.zeros(16, 128), torch.zeros(128)), (torch.zeros(128, 128), torch.zeros(128)),
              (torch.zeros(128, 2), torch.zeros(2))]
    frame = chip_smoke.neural_bound(params, "schwarzschild", False, 1920 * 1080)
    dirs = chip_smoke.neural_bound(params, "schwarzschild", False, 1920 * 1080, dirs=True)
    assert dirs[1] == "operations" and 0.0 < dirs[0] <= frame[0]
    tiny = [(torch.zeros(16, 2), torch.zeros(2))]  # no hidden layer: the store binds
    ops = (chip_smoke.NEURAL_PIXEL_OPS["schwarzschild"] - chip_smoke.NEURAL_SHADE_OPS)
    want = max(ops / chip_smoke.PEAK_FP32, chip_smoke.DIRS_BYTES_PER_PIXEL / chip_smoke.PEAK_BYTES)
    got = chip_smoke.neural_bound(tiny, "schwarzschild", False, 1000, dirs=True)
    assert got[0] == pytest.approx(want * 1000 * 1e3)


def test_sha16_hashes_the_bytes_in_order():
    """chip_smoke's output hash is sha256 of the tensors' bytes in order, as
    tools/time_trace.py's output_sha256, and EXACT5_SHA pins config 5's
    exact planes, frame and each of its orbit frames."""
    import hashlib

    a = torch.arange(6, dtype=torch.int32).view(2, 3)
    b = torch.tensor([1.5, -0.0])
    want = hashlib.sha256(a.numpy().tobytes() + b.numpy().tobytes()).hexdigest()[:16]
    assert chip_smoke.sha16(a, b) == want
    assert chip_smoke.sha16(a.t().contiguous().t(), b) == want  # a copy of a, not its view
    assert chip_smoke.sha16(b, a) != want
    assert set(chip_smoke.EXACT5_SHA) == {"planes", "frame"} | {
        f"orbit{k}" for k in range(chip_smoke.CONFIG5_FRAMES)}
    assert all(re.fullmatch(r"[0-9a-f]{16}", v) for v in chip_smoke.EXACT5_SHA.values())
