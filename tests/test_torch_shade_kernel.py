"""The staged epilogue's kernel (csrc/shade_planes.cu, ops/shade_kernel.py)
against the plain epilogue (renderer.shade_image_reference).

On the CPU: the route (`shade_kernel_takes`), the counters a CPU frame
leaves alone, and the wrapper's refusals, which come before any library is
loaded. On a CUDA device (marked `gpu`, skipped elsewhere): `shade_image`
through the kernel against the plain epilogue on the same planes, with 0
differing packed words, over BASELINE config 4's 1920x1080 frame at three
orbit frames, two star seeds and both trace tiers, a small exact Kerr disk
frame, a neural staged frame, a band, a cache_deflection re-shade, and
`out=` given and not, strided planes and `out` routed to the plain
epilogue; and the kernel's power x^-0.75 (csrc/common.cuh, by its probe in
tools/hopper_probe) against torch.pow on every fp32 in [1e-6, 4].
"""

import dataclasses

import pytest
import torch

import bhr_tpu_torch as T
from bhr_tpu_torch.models.disk import LUT_STEPS, DiskParams, blackbody_lut
from bhr_tpu_torch.ops import shade_kernel, trace_kernel
from bhr_tpu_torch.renderer import shade_image, shade_image_reference
from bhr_tpu_torch.tools import hopper_probe as hp
from bhr_tpu_torch.utils.tracing import COUNTS

KERNEL, PLAIN = "launch.shade_planes", "epilogue.plain"
SIDE = ([15.0, 5.0, 0.0], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0])


def _scene(**kw):
    return T.SceneParams(screen_width=8, screen_height=6, max_steps=4, **kw)


def _off_host_disk():
    """DiskParams whose values lie off the host (the meta device stands in
    for the card's)."""
    return DiskParams(*(torch.empty((), device="meta") for _ in range(3)))


# ---- the route -----------------------------------------------------------------

ADMIT = {
    "star_field": dict(disk_params=None, lut=None),
    "star_field_and_disk": dict(disk_params="device", lut="table"),
    "broadcast_hit_points_without_disk": dict(disk_params=None, lut=None, strided="pos"),
}
REFUSE = {
    "skybox": dict(skybox="texture"),
    "debug_mode_1": dict(debug_mode=1),
    "reinhard": dict(tonemap="reinhard"),
    "srgb": dict(tonemap="srgb"),
    "select_curve": dict(lut="select"),
    "cpu_device": dict(device="cpu"),
    "disk_without_table": dict(lut=None),
    "kernel_lut_shape": dict(lut="short"),
    "disk_params_on_host": dict(disk_params="host"),
    "strided_planes": dict(strided="vel"),
    "strided_out": dict(strided="out"),
    "strided_hit_points_with_disk": dict(strided="pos"),
}


def _takes(device="cuda", skybox=None, debug_mode=0, tonemap="passthrough",
           disk_params="device", lut="table", strided=None):
    disk = {"device": _off_host_disk(), "host": DiskParams.for_scene(2.0), None: None}
    tables = {"table": torch.zeros((LUT_STEPS, 3)), "short": torch.zeros((128, 3)),
              "select": "select", None: None}
    res = trace_kernel.empty_trace_result(6, 8, "cpu")
    if strided == "vel":
        res = dataclasses.replace(res, final_vel=torch.zeros((8, 6, 3)).transpose(0, 1))
    if strided == "pos":  # the neural route's hit points: the camera broadcast
        res = dataclasses.replace(res, final_pos=torch.zeros(3).expand(6, 8, 3))
    out = torch.zeros((8, 6), dtype=torch.int32).t() if strided == "out" else None
    return shade_kernel.shade_kernel_takes(
        device, _scene(debug_mode=debug_mode),
        skybox=torch.zeros((4, 8), dtype=torch.int32) if skybox else None, tonemap=tonemap,
        disk_params=disk[disk_params], lut=tables[lut],
        planes=shade_kernel.kernel_planes(res, disk[disk_params], out))


@pytest.mark.parametrize("case", sorted(ADMIT))
def test_the_route_admits_a_star_field_frame_on_cuda(case):
    assert _takes(**ADMIT[case])


@pytest.mark.parametrize("case", sorted(REFUSE))
def test_the_route_refuses_what_the_kernel_does_not_shade(case):
    assert _takes() and not _takes(**REFUSE[case])


# ---- a CPU frame: the plain epilogue, no counter moves ---------------------------

def _planes(cam, scene, config):
    return trace_kernel.trace_image_reference(cam, scene, config, device="cpu")


@pytest.mark.parametrize("disk, tonemap", [(False, "passthrough"), (True, "passthrough"),
                                           (True, "srgb")])
def test_a_cpu_frame_takes_the_plain_epilogue_and_counts_nothing(disk, tonemap):
    scene = T.SceneParams(screen_width=16, screen_height=12, max_steps=60)
    cam = T.Camera.new(*SIDE)
    config = T.TraceConfig(integrator="rk4", adaptive=True, disk=disk)
    res = _planes(cam, scene, config)
    dp = DiskParams.for_scene(torch.tensor(2.0)) if disk else None
    lut = blackbody_lut() if disk else None
    before = (COUNTS[KERNEL], COUNTS[PLAIN])
    got = shade_image(res, cam, scene, dp, lut, tonemap=tonemap, seed=11, packed=True)
    assert (COUNTS[KERNEL], COUNTS[PLAIN]) == before
    want = shade_image_reference(res, cam, scene, dp, lut, tonemap=tonemap, seed=11)
    assert torch.equal(got, want)


# ---- the wrapper's refusals ------------------------------------------------------

def _bad_planes(what):
    """(planes, disk_params, lut, out) of a 6x8 frame on the CPU, with one
    thing wrong."""
    h, w = 6, 8
    planes = dataclasses.asdict(trace_kernel.empty_trace_result(h, w, "cpu"))
    disk, lut, out = None, None, None
    if what == "vel_dtype":
        planes["final_vel"] = planes["final_vel"].double()
    elif what == "status_dtype":
        planes["status"] = planes["status"].long()
    elif what == "vel_shape":
        planes["final_vel"] = torch.zeros((h, w, 4))
    elif what == "status_shape":
        planes["status"] = torch.zeros((h, w - 1), dtype=torch.int32)
    elif what == "vel_layout":
        planes["final_vel"] = torch.zeros((w, h, 3)).transpose(0, 1)
    elif what == "status_device":
        planes["status"] = torch.zeros((h, w), dtype=torch.int32, device="meta")
    elif what == "pos_layout":
        planes["final_pos"] = torch.zeros((w, h, 3)).transpose(0, 1)
        disk, lut = DiskParams.for_scene(torch.tensor(2.0)), blackbody_lut()
    elif what == "lut_shape":
        disk, lut = DiskParams.for_scene(torch.tensor(2.0)), torch.zeros((128, 3))
    elif what == "out_dtype":
        out = torch.zeros((h, w), dtype=torch.int64)
    elif what == "cpu_device":
        disk, lut = DiskParams.for_scene(torch.tensor(2.0)), blackbody_lut()
    return T.TraceResult(**planes), disk, lut, out


@pytest.mark.parametrize("what, message", [
    ("vel_dtype", "final_vel must be a contiguous torch.float32"),
    ("status_dtype", "status must be a contiguous torch.int32"),
    ("vel_shape", "final_vel must be an \\(H, W, 3\\) tensor"),
    ("status_shape", "status must be a contiguous torch.int32 \\(6, 8\\)"),
    ("vel_layout", "final_vel must be a contiguous"),
    ("status_device", "status must be a contiguous torch.int32 \\(6, 8\\) tensor on cpu"),
    ("pos_layout", "final_pos must be a contiguous"),
    ("lut_shape", "lut must be a contiguous torch.float32 \\(512, 3\\)"),
    ("out_dtype", "out must be a contiguous torch.int32"),
    ("cpu_device", "runs on a CUDA device, not cpu"),
])
def test_the_wrapper_raises_on_planes_it_cannot_take(what, message):
    res, disk, lut, out = _bad_planes(what)
    before = COUNTS[KERNEL]
    with pytest.raises(ValueError, match=message):
        shade_kernel.shade_planes(res, T.Camera.default(), _scene(), disk, lut, out=out)
    assert COUNTS[KERNEL] == before


def test_the_power_probe_is_torch_pow_on_the_cpu():
    """The probe of the kernel's power runs its plain version, torch.pow, on
    the CPU, over the bit patterns of [1e-6, 4], both ends included."""
    lo, hi = hp.disk_power_bits()
    assert torch.tensor([lo, hi - 1], dtype=torch.int32).view(torch.float32).tolist() == [
        pytest.approx(1e-6), 4.0]
    x = torch.arange(lo, hi, 65537, dtype=torch.int32).view(torch.float32)
    before = COUNTS["launch.probe_ieee<disk_power>"]
    assert torch.equal(hp.ieee("disk_power", x), torch.pow(x, -0.75))
    assert COUNTS["launch.probe_ieee<disk_power>"] == before


# ---- on the card ---------------------------------------------------------------

def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")


def _both(res, cam, scene, disk_params, lut, seed, out=None):
    """The frame through shade_image (the kernel, counted once) and the
    plain epilogue on the same planes; asserts 0 differing words."""
    launches, plain = COUNTS[KERNEL], COUNTS[PLAIN]
    got = shade_image(res, cam, scene, disk_params, lut, tonemap="passthrough", seed=seed,
                      packed=True, out=out)
    torch.cuda.synchronize()
    assert (COUNTS[KERNEL] - launches, COUNTS[PLAIN] - plain) == (1, 0)
    want = shade_image_reference(res, cam, scene, disk_params, lut, tonemap="passthrough",
                                 seed=seed)
    differ = int((got != want).sum())
    assert differ == 0, f"{differ} of {want.numel()} words differ"
    if out is not None:
        assert got.data_ptr() == out.data_ptr()
    return got


def _orbit_camera(renderer, frame):
    anim = T.OrbitAnimator(renderer)
    return anim.camera_fn(anim.frame_times(1, start_frame=frame)[0])


@pytest.mark.gpu
@pytest.mark.parametrize("fast", [False, True], ids=["exact", "fast"])
@pytest.mark.parametrize("seed", [2020, 1_234_567_891])
@pytest.mark.parametrize("frame", [0, 419, 1000])
def test_config4_orbit_frames_match_the_plain_epilogue(frame, seed, fast):
    _need_cuda()
    r = T.BlackHoleRenderer(1920, 1080, "rk4", adaptive=True, disk=True, fast_math=fast,
                            device="cuda")
    cam, scene = _orbit_camera(r, frame), r.frame_scene()
    res = trace_kernel.trace_image(cam, scene, r.config, fast_math=fast, device="cuda")
    out = torch.empty((1080, 1920), dtype=torch.int32, device="cuda") if frame == 419 else None
    plan = r._frame_plan(scene, staged=True)  # the fast tier's frame is monolithic
    _both(res, cam, scene, plan.disk_params, plan.lut, seed, out=out)


@pytest.mark.gpu
def test_an_exact_kerr_disk_frame_matches_the_plain_epilogue():
    _need_cuda()
    r = T.BlackHoleRenderer(320, 192, model="kerr", disk=True, device="cuda")
    scene = r.frame_scene(T.SceneParams(screen_width=320, screen_height=192, max_steps=600,
                                        spin=0.9))
    cam = T.Camera.new(*SIDE)
    res = trace_kernel.trace_image(cam, scene, r.config, device="cuda")
    assert bool((res.status == 3).any())
    plan = r._frame_plan(scene)
    _both(res, cam, scene, plan.disk_params, plan.lut, 2020)


@pytest.mark.gpu
def test_a_neural_staged_frame_matches_the_plain_epilogue():
    _need_cuda()
    from bhr_tpu_torch.ops.neural_trace import neural_trace_image

    r = T.BlackHoleRenderer(320, 180, "neural", neural_precision="high", device="cuda")
    scene, cam = r.frame_scene(), T.Camera.default()
    res = neural_trace_image(r.neural_params, cam, scene, device="cuda",
                             precision=r.neural_precision)
    _both(res, cam, scene, None, None, 7)
    launches = COUNTS[KERNEL]
    frame = r.render_frame(cam, scene)  # the renderer's own staged route
    torch.cuda.synchronize()
    assert COUNTS[KERNEL] == launches + 1 and frame.shape == (180, 320, 4)


@pytest.mark.gpu
def test_a_band_matches_the_plain_epilogue_and_the_frame():
    _need_cuda()
    r = T.BlackHoleRenderer(480, 270, "rk4", adaptive=True, disk=True, device="cuda")
    scene, cam = r.frame_scene(), T.Camera.new(*SIDE)
    band = trace_kernel.trace_image(cam, scene, r.config, device="cuda", row0=100,
                                    local_shape=(70, 480))
    plan = r._frame_plan(scene)
    got = _both(band, cam, scene, plan.disk_params, plan.lut, 2020)
    whole = T.renderer.render_image(cam, scene, config=r.config, fast_math=False,
                                    device="cuda", disk_params=plan.disk_params, lut=plan.lut,
                                    packed=True)
    assert torch.equal(got, whole[100:170])


@pytest.mark.gpu
def test_a_cache_deflection_reshade_matches_the_plain_epilogue():
    _need_cuda()
    r = T.BlackHoleRenderer(480, 270, "rk4", adaptive=True, disk=True, cache_deflection=True,
                            device="cuda")
    cam = T.Camera.new(*SIDE)
    r.render_frame(cam)
    traces, launches = COUNTS["launch.trace_planes"], COUNTS[KERNEL]
    frame = r.render_frame(cam)  # the same geometry: shaded again, not traced
    torch.cuda.synchronize()
    assert (COUNTS["launch.trace_planes"], COUNTS[KERNEL]) == (traces, launches + 1)
    plan = r._frame_plan()
    want = shade_image_reference(r._deflection_result, cam, r.scene, plan.disk_params, plan.lut,
                                 tonemap="passthrough", seed=r.skybox_seed)
    assert int((frame.view(torch.int32).view(270, 480) != want).sum()) == 0


@pytest.mark.gpu
@pytest.mark.parametrize("strided", ["planes", "out"])
def test_strided_planes_or_out_take_the_plain_epilogue(strided):
    _need_cuda()
    r = T.BlackHoleRenderer(480, 270, "rk4", adaptive=True, disk=True, device="cuda")
    scene, cam = r.frame_scene(), T.Camera.new(*SIDE)
    res = trace_kernel.trace_image(cam, scene, r.config, device="cuda")
    plan = r._frame_plan(scene)
    want = shade_image_reference(res, cam, scene, plan.disk_params, plan.lut,
                                 tonemap="passthrough", seed=2020)
    out = None
    if strided == "planes":
        res = dataclasses.replace(res, final_vel=res.final_vel.transpose(0, 1).contiguous()
                                  .transpose(0, 1))
    else:
        out = torch.empty((480, 270), dtype=torch.int32, device="cuda").t()
    before = (COUNTS[KERNEL], COUNTS[PLAIN])
    got = shade_image(res, cam, scene, plan.disk_params, plan.lut, tonemap="passthrough",
                      seed=2020, packed=True, out=out)
    torch.cuda.synchronize()
    assert (COUNTS[KERNEL], COUNTS[PLAIN]) == (before[0], before[1] + 1)
    assert torch.equal(got, want) and (out is None or got.data_ptr() == out.data_ptr())


@pytest.mark.gpu
def test_the_exact_orbit_launches_the_kernel_once_a_frame():
    _need_cuda()
    r = T.BlackHoleRenderer(480, 270, "rk4", adaptive=True, disk=True, device="cuda")
    before = (COUNTS[KERNEL], COUNTS[PLAIN], COUNTS["launch.trace_planes"])
    T.OrbitAnimator(r).render_frames(3, packed=True)
    torch.cuda.synchronize()
    after = (COUNTS[KERNEL], COUNTS[PLAIN], COUNTS["launch.trace_planes"])
    assert tuple(a - b for a, b in zip(after, before)) == (3, 0, 3)
    srgb = T.BlackHoleRenderer(480, 270, "rk4", adaptive=True, disk=True, tonemap="srgb",
                               device="cuda")
    srgb.render_frame(T.Camera.new(*SIDE))
    assert (COUNTS[KERNEL], COUNTS[PLAIN]) == (after[0], after[1] + 1)


@pytest.mark.gpu
def test_the_kernels_power_is_torch_pow_on_every_float_in_its_range():
    """x^-0.75 of disk_temperature (csrc/common.cuh disk_temperature_power,
    launched by its probe), on every fp32 in [1e-6, 4] (the disk's r / r_isco
    lies in [1, 10 / 3]), in chunks of 2^24."""
    _need_cuda()
    lo, hi = hp.disk_power_bits()
    differ = 0
    for start in range(lo, hi, 1 << 24):
        bits = torch.arange(start, min(start + (1 << 24), hi), dtype=torch.int32, device="cuda")
        x = bits.view(torch.float32)
        got = hp.ieee("disk_power", x)
        want = torch.pow(x, -0.75)
        differ += int((got.view(torch.int32) != want.view(torch.int32)).sum())
    assert differ == 0
