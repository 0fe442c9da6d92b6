"""chip_smoke.py's bar of a kernel frame against its plain version, on
synthetic frames: capture is held on the ray status, not on black pixels,
so dark sky that differs passes and a captured ray that is lit fails."""

import importlib.util
import os

import pytest
import torch

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
