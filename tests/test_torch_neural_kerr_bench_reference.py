"""The benchmark's plain reference of the Kerr neural surrogate
(bench_torch/reference/neural_kerr.py) and its cell
kerr09sky4k.orbit_neural_kerr, on the CPU.

The reference is held bit for bit against the port's plain Kerr neural
frame (the program's CPU path, through the harness's own entry) at two
orbit frames and at spin 0; its bands against the whole frame; the cell is
resolved from its files by name; the net's digest pin is held; and a run
of the cell by the harness's run_cell, shrunk as
bench_torch/tests/test_correct.py shrinks cells, is correct, and not
correct with the control or any planted fault of calibrate.py in the
program's place."""

import hashlib
import json
import time

import pytest
import torch

from bench_torch import harness
from bench_torch.calibrate import faults
from bench_torch.reference import neural_kerr
from bench_torch.reference.common import orbit_camera
from bhr_tpu_torch.models import neural as tn

CELL = "kerr09sky4k.orbit_neural_kerr"
SEED = 2**31 + 101  # larger than 32 signed bits hold


def small(width=48, height=32, **scene):
    cell = harness.load_cell(CELL)
    cell.config["scene"].update(width=width, height=height, **scene)
    cell.traffic.update(sample_within=2, compare_frames=1, warmup_frames=1)
    return cell


@pytest.mark.parametrize("frame, spin", [(0, 0.9), (37, 0.9), (0, 0.0)],
                         ids=["phase", "phase+37", "spin0"])
def test_reference_equals_the_ports_plain_kerr_neural_frame(frame, spin):
    cell = small(spin=spin)
    s = harness.seeded(cell, SEED)
    anim, render = harness.build_program(cell, s["star_seed"], "cpu")
    r = anim.renderer
    assert r.neural_params.model == "kerr" and r.neural_precision == "default"
    assert r._frame_plan(r.scene).route == "neural" and r.scene.spin == spin
    k = s["phase"] + frame
    want, steps = neural_kerr.render(cell, orbit_camera(k, cell.config["camera"]),
                                     seed=s["star_seed"], device="cpu")
    assert steps is None and want.shape == (32, 48) and want.dtype == torch.int32
    assert harness.numbers(render(k), want) == {"neq_pct": 0.0, "off1_pct": 0.0}
    rgb = want.view(torch.uint8).view(32, 48, 4)[..., :3]
    assert 0.05 < (rgb == 0).all(-1).float().mean() < 0.95  # shadow and sky both in view


def test_the_bands_are_the_frames_rows(monkeypatch):
    cell = small(width=24, height=20)
    cam = orbit_camera(123, cell.config["camera"])
    whole, _ = neural_kerr.render(cell, cam, seed=5, device="cpu")
    monkeypatch.setattr(neural_kerr, "BAND_ROWS", 7)
    banded, _ = neural_kerr.render(cell, cam, seed=5, device="cpu")
    rows, _ = neural_kerr.render(cell, cam, seed=5, device="cpu", rows=(3, 17))
    assert torch.equal(banded, whole) and torch.equal(rows, whole[3:17])


def test_the_cell_resolves_from_its_files():
    cell = harness.load_cell(CELL)
    assert cell.chips == 1 and harness.reference_module(cell) is neural_kerr
    sc = cell.config["scene"]
    assert (sc["width"], sc["height"], sc["max_steps"], sc["spin"]) == (3840, 2160, 500, 0.9)
    assert cell.config["renderer"] == {"integrator": "euler", "model": "kerr", "adaptive": False,
                                       "disk": False, "dt": 0.1}
    assert cell.config["reduced"] == []
    assert cell.traffic["renderer"] == {"integrator": "neural", "neural_precision": "default"}
    assert {m["name"] for m in cell.end_to_end} == {"frame_ms", "frame_ms_p95",
                                                    "frame_ms.neural", "setup_s"}
    assert {m["name"] for m in cell.per_layer} == {"host.issue_ms", "neural.roofline_pct",
                                                  "neural.mfu_pct", "device.idle_pct"}
    assert cell.counts["neural_pixel_ops"]["counts"]["kerr"] == 543
    assert harness._net_shapes(cell) == [(22, 256), (256, 256), (256, 256), (256, 3)]
    assert set(cell.limits["numbers"]) == {"off1_pct"}
    spec = cell.limits["numbers"]["off1_pct"]
    assert spec["lower"] < spec["limit"] < min(spec["upper"], spec["faults_min"])


def test_the_digest_pin_is_held(tmp_path, monkeypatch):
    cell = harness.load_cell(CELL)
    path = harness.asset_path(cell)
    assert path.read_bytes() == (tn.ASSETS_DIR / "neural_kerr.npz").read_bytes()
    assert hashlib.sha256(path.read_bytes()).hexdigest() == cell.traffic["asset_sha256"]
    with open(harness.BENCH_DIR / "traffic" / "orbit_neural_kerr.json") as fh:
        assert json.load(fh)["asset_sha256"] == cell.traffic["asset_sha256"]
    other = tmp_path / "assets" / "neural_kerr.npz"
    other.parent.mkdir()
    data = path.read_bytes()
    other.write_bytes(data[:-1] + bytes([data[-1] ^ 1]))  # one bit flipped
    monkeypatch.setattr(harness, "BENCH_DIR", tmp_path)
    with pytest.raises(ValueError, match="sha256"):
        harness.asset_path(cell)


def run(cell, wrap=None, seconds=0.1):
    """A run of `seconds`: one frame is enough for any fault but the stale
    one, which needs a second frame in the window (`run_stale`)."""
    return harness.run_cell(cell, SEED, seconds, False, t_start=time.perf_counter(),
                            device="cpu", wrap=wrap)


def run_stale(cell, tries=6):
    """A stale run whose window holds at least two frames: its window is
    doubled from 0.8 s until it does, within `tries` runs, so that a loaded
    CPU cannot leave the window a single (correct) frame."""
    seconds = 0.8
    for _ in range(tries):
        out = run(cell, _stale(), seconds)
        if out["attempted"] >= 2:
            return out
        seconds *= 2
    raise AssertionError(f"{tries} stale windows up to {seconds / 2} s held one frame each")


def test_a_sound_run_is_correct():
    out = run(small(40, 24))
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 1
    assert set(out["metrics"]) == {"frame_ms", "frame_ms_p95", "frame_ms.neural", "setup_s"}
    assert out["metrics"]["frame_ms"] == out["metrics"]["frame_ms.neural"]
    assert out["checks"]["off1_pct"]["value"] == 0.0


def _control(cell):
    s = harness.seeded(cell, SEED)

    def wrap(render, k):
        render(k)  # the program still runs; its frame is replaced
        low, _ = neural_kerr.render(cell, orbit_camera(k, cell.config["camera"]),
                                    seed=s["star_seed"], device="cpu", control=True)
        return low[None]
    return wrap


def _stale():
    first = []

    def wrap(render, k):
        first.append(k)
        return render(first[0])
    return wrap


def _planted(kind):
    def wrap(render, k):
        frame = render(k)
        return faults(frame[0], frame[0])[kind][None]
    return wrap


@pytest.mark.parametrize("broken", ["control", "stale", "half_rows", "band_altered"])
def test_a_broken_run_is_not_correct(broken):
    cell = small(40, 24)
    if broken == "stale":
        out = run_stale(cell)
        assert out["attempted"] >= 2
    else:
        wrap = _control(cell) if broken == "control" else _planted(broken)
        out = run(cell, wrap)
    assert not out["correct"], out["checks"]
    if broken == "control":
        assert out["checks"]["off1_pct"]["value"] > 1.0
