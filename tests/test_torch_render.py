"""The port's main path against bhr_tpu's: render_packed (the monolithic
kernel's wrapper, which runs its plain PyTorch version on the CPU) against
pallas_render_packed in interpret mode, the golden image, BlackHoleRenderer,
OrbitAnimator and image output. The kernel itself runs only on a CUDA
device: its tests are marked `gpu` and skip elsewhere.

Bars (the same as chip_smoke.py's):
* exact tier: packed frames bit-equal on >= 99.9% of pixels, the bar of
  tests/test_pallas_parity.py:484-491 for photon-sphere pixels that a
  one-ulp difference between two programs can flip;
* fast tier: the captured (black) mask agrees on >= 99.5% of pixels, and
  every channel is within 1 level on >= 99.5% (the fast tiers round with
  approximate rsqrt/reciprocal and quantize half up).

Against bhr_tpu on the CPU, the exact tier's differing pixels are star
colours one level apart: JAX's CPU rsqrt and tan are an ulp off on some
inputs (tests/test_torch_shading.py), where the port rounds correctly as
the kernel does. On a frame larger than test_pallas_parity.py's 48x32 the
exact tier is held to: black masks agree and channels are within 1 level
on >= 99.9% of pixels, and >= 99.8% are bit-equal.
"""

import os

import numpy as np
import pytest
import torch

import bhr_tpu as J
import bhr_tpu_torch as T
from bhr_tpu.ops.pallas_trace import pallas_render_packed
from bhr_tpu_torch.io import image as timage
from bhr_tpu_torch.ops import trace_kernel
from bhr_tpu_torch.ops.sampling import unpack_frame
from bhr_tpu_torch.utils.tracing import COUNTS

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
EXACT_SAME_MIN = 0.999
LARGE_SAME_MIN = 0.998
FAST_MIN = 0.995
CAMERAS = {
    "default": ([0.0, 5.0, 15.0], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0]),
    "side": ([15.0, 5.0, 0.0], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0]),
}
SIZES = [(48, 32, 120), (160, 96, 200)]


def _u8(packed):
    """Packed frame (numpy u32/i32 or torch int32) -> int (H, W, 4)."""
    if isinstance(packed, torch.Tensor):
        return unpack_frame(packed.cpu()).numpy().astype(np.int32)
    return np.ascontiguousarray(packed).view(np.uint8).reshape(*packed.shape, 4).astype(np.int32)


def _assert_frames_agree(got, want, fast, same_min=EXACT_SAME_MIN):
    """Hold two packed frames to the bars of the tier; returns the stats."""
    g, w = _u8(got), _u8(want)
    same = (np.asarray(got.cpu() if isinstance(got, torch.Tensor) else got).view(np.uint32)
            == np.asarray(want.cpu() if isinstance(want, torch.Tensor) else want).view(np.uint32))
    black_agree = ((g[..., :3] == 0).all(-1) == (w[..., :3] == 0).all(-1)).mean()
    within_1 = (np.abs(g - w).max(-1) <= 1).mean()
    assert (g[..., 3] == 255).all()
    if fast:
        assert black_agree >= FAST_MIN, f"captured mask agrees on {black_agree:.5f}"
        assert within_1 >= FAST_MIN, f"within 1 level on {within_1:.5f}"
    else:
        assert same.mean() >= same_min, f"bit-equal on {same.mean():.5f}"
        assert min(black_agree, within_1) >= EXACT_SAME_MIN, (black_agree, within_1)
    return same.mean(), black_agree, within_1


def _both(cam, size):
    w, h, steps = size
    jc = J.Camera.new(*CAMERAS[cam])
    js = J.SceneParams(screen_width=w, screen_height=h, max_steps=steps)
    tc = T.camera_from_numpy(*(np.asarray(x) for x in (jc.position, jc.forward, jc.right,
                                                        jc.up)))
    ts = T.SceneParams(screen_width=w, screen_height=h, max_steps=steps)
    return jc, js, tc, ts


@pytest.mark.parametrize("fast", [False, True], ids=["exact", "fast"])
@pytest.mark.parametrize("size", SIZES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("cam", sorted(CAMERAS))
def test_render_packed_matches_jax_monolithic(cam, size, fast):
    jc, js, tc, ts = _both(cam, size)
    want = np.asarray(pallas_render_packed(jc, js, J.TraceConfig(), interpret=True,
                                           fast_math=fast))
    launches = COUNTS["launch.render_mono"]
    got = trace_kernel.render_packed(tc, ts, T.TraceConfig(), fast_math=fast, device="cpu")
    assert COUNTS["launch.render_mono"] == launches  # the CPU path launches no kernel
    assert got.shape == (size[1], size[0]) and got.dtype == torch.int32
    _assert_frames_agree(got, want, fast, EXACT_SAME_MIN if size == SIZES[0] else LARGE_SAME_MIN)
    if size[2] >= 200:
        black = (_u8(got)[..., :3] == 0).all(-1).mean()
        assert 0.2 < black < 0.8  # the shadow and the sky are both in view


def test_render_packed_equals_its_reference_on_cpu():
    _, _, tc, ts = _both("side", SIZES[0])
    for fast in (False, True):
        a = trace_kernel.render_packed(tc, ts, fast_math=fast, device="cpu")
        b = trace_kernel.render_packed_reference(tc, ts, fast_math=fast, device="cpu")
        torch.testing.assert_close(a, b, rtol=0, atol=0)
        out = torch.zeros_like(a)
        assert trace_kernel.render_packed(tc, ts, fast_math=fast, device="cpu", out=out) is out
        torch.testing.assert_close(out, a, rtol=0, atol=0)


def test_render_packed_rejects_a_bad_out_tensor():
    _, _, tc, ts = _both("side", SIZES[0])
    for bad in (torch.zeros(32, 48, dtype=torch.int64), torch.zeros(48, 32, dtype=torch.int32),
                torch.zeros(48, 32, dtype=torch.int32).t()):
        with pytest.raises(ValueError, match="out must be"):
            trace_kernel.render_packed(tc, ts, device="cpu", out=bad)


def test_golden_schwarzschild_port():
    """The port's default renderer (exact tier) against the oracle's
    golden image, under the rule of tests/test_golden.py:20-33: at most
    0.5% of pixels off by more than 1 level."""
    r = T.BlackHoleRenderer(64, 64, device="cpu")
    cam = T.Camera.new([15.0, 5.0, 0.0], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0])
    frame = r.render_frame(cam, T.SceneParams(screen_width=64, screen_height=64, max_steps=300))
    golden = timage.read_png(os.path.join(GOLDEN_DIR, "schwarzschild_64.png")).astype(np.int32)
    got = frame.numpy().astype(np.int32)
    assert got.shape == golden.shape == (64, 64, 4)
    bad = (np.abs(got - golden).max(-1) > 1).mean()
    assert bad <= 0.005, f"{bad:.4%} of pixels differ by more than 1 level"


def test_renderer_api():
    r = T.BlackHoleRenderer.new(40, 24, device="cpu")
    assert r.device == torch.device("cpu") and r.context.platform == "cpu"
    assert not r.fast_math and r.config == T.TraceConfig()
    scene = T.SceneParams(screen_width=40, screen_height=24, max_steps=60)
    frame = r.render_frame(T.Camera.default(), scene)
    assert frame.shape == (24, 40, 4) and frame.dtype == torch.uint8
    assert r.output_texture_view is frame
    host = r.get_image_data()
    assert isinstance(host, np.ndarray) and host.dtype == np.uint8
    np.testing.assert_array_equal(host, frame.numpy())
    want = trace_kernel.render_packed(T.Camera.default(), scene, fast_math=False, device="cpu")
    torch.testing.assert_close(frame, unpack_frame(want), rtol=0, atol=0)
    # a scene of another size renders at the renderer's size
    again = r.render_frame(scene=scene.replace(screen_width=8, screen_height=8))
    assert again.shape == (24, 40, 4)
    ctx = T.CudaContext.new("cpu")
    assert T.BlackHoleRenderer.new_with_context(ctx, 8, 8).context is ctx
    assert T.GpuContext is T.CudaContext and T.TpuContext is T.CudaContext


def test_render_image_packed_and_unpacked():
    scene = T.SceneParams(screen_width=16, screen_height=8, max_steps=20)
    kw = dict(config=T.TraceConfig(), fast_math=True, device="cpu")
    packed = T.render_image(T.Camera.default(), scene, packed=True, **kw)
    rgba = T.render_image(T.Camera.default(), scene, **kw)
    assert packed.shape == (8, 16) and packed.dtype == torch.int32
    torch.testing.assert_close(rgba, unpack_frame(packed), rtol=0, atol=0)


@pytest.mark.parametrize("fast", [False, True], ids=["exact", "fast"])
def test_orbit_animator_frames(fast):
    r = T.BlackHoleRenderer(24, 16, device="cpu", fast_math=fast)
    anim = T.OrbitAnimator(r)
    scene = T.SceneParams(screen_width=24, screen_height=16, max_steps=50)
    frames = anim.render_frames(3, fps=10.0, scene=scene)
    assert frames.shape == (3, 16, 24, 4) and frames.dtype == torch.uint8
    packed = anim.render_frames(3, fps=10.0, scene=scene, packed=True)
    assert packed.shape == (3, 16, 24) and packed.dtype == torch.int32
    torch.testing.assert_close(frames, unpack_frame(packed), rtol=0, atol=0)
    # each frame is the single-frame render from its orbit camera, and
    # start_frame resumes a run exactly
    for k, t in enumerate(anim.frame_times(3, fps=10.0)):
        one = trace_kernel.render_packed(T.orbit_camera(t), scene, fast_math=fast, device="cpu")
        torch.testing.assert_close(packed[k], one, rtol=0, atol=0)
    tail = anim.render_frames(2, fps=10.0, start_frame=1, scene=scene, packed=True)
    torch.testing.assert_close(tail, packed[1:], rtol=0, atol=0)
    assert not (frames[1] == frames[0]).all()  # the camera moves


def test_orbit_animator_matches_jax():
    """The exact tier's frames against bhr_tpu's OrbitAnimator (its
    monolithic kernel in a lax.scan, interpret mode): the same orbit, frame
    by frame. The scan computes the orbit cameras inside its own program,
    whose cos/sin may round differently, and a camera an ulp off flips a
    few photon-sphere pixels, so the bars are the chaos-aware ones: black
    masks agree, channels are within 1 level, and words are bit-equal, each
    on >= 99.5% of pixels."""
    w, h, steps = 48, 32, 160
    jr = J.BlackHoleRenderer(w, h, use_pallas=True, interpret=True, fast_math=False)
    js = J.SceneParams(screen_width=w, screen_height=h, max_steps=steps)
    want = np.asarray(J.OrbitAnimator(jr).render_frames(3, fps=4.0, scene=js, packed=True))
    tr = T.BlackHoleRenderer(w, h, device="cpu")
    ts = T.SceneParams(screen_width=w, screen_height=h, max_steps=steps)
    got = T.OrbitAnimator(tr).render_frames(3, fps=4.0, scene=ts, packed=True)
    for k in range(3):
        same, _, _ = _assert_frames_agree(got[k], want[k], fast=True)
        assert same >= FAST_MIN, f"frame {k}: bit-equal on {same:.5f}"


def test_save_image_round_trips(tmp_path):
    r = T.BlackHoleRenderer(20, 12, device="cpu")
    r.render_frame(scene=T.SceneParams(screen_width=20, screen_height=12, max_steps=40))
    path = str(tmp_path / "frame.png")
    r.save_image(path)
    back = timage.read_png(path)
    np.testing.assert_array_equal(back, r.get_image_data())
    from PIL import Image

    np.testing.assert_array_equal(np.asarray(Image.open(path).convert("RGBA")), back)
    timage.save_image(r.output_texture_view, str(tmp_path / "frame.jpg"))
    assert Image.open(str(tmp_path / "frame.jpg")).size == (20, 12)


# ---- the CUDA kernel: runs only where a CUDA device is visible -------------


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")


@pytest.mark.gpu
@pytest.mark.parametrize("fast", [False, True], ids=["exact", "fast"])
@pytest.mark.parametrize("cam", sorted(CAMERAS))
def test_kernel_matches_plain_version_on_gpu(cam, fast):
    _need_cuda()
    _, _, tc, ts = _both(cam, (160, 96, 200))
    launches = COUNTS["launch.render_mono"]
    got = trace_kernel.render_packed(tc, ts, fast_math=fast, device="cuda")
    torch.cuda.synchronize()
    assert COUNTS["launch.render_mono"] == launches + 1
    want = trace_kernel.render_packed_reference(tc, ts, fast_math=fast, device="cuda")
    _assert_frames_agree(got, want, fast)


@pytest.mark.gpu
def test_kernel_animation_on_gpu():
    _need_cuda()
    r = T.BlackHoleRenderer(64, 48, device="cuda", fast_math=True)
    launches = COUNTS["launch.render_mono"]
    frames = T.OrbitAnimator(r).render_frames(4, packed=True)
    torch.cuda.synchronize()
    assert COUNTS["launch.render_mono"] == launches + 4
    assert frames.shape == (4, 48, 64) and frames.device.type == "cuda"
