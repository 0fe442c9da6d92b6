"""The benchmark's plain Kerr reference (bench_torch/reference/kerr.py) and
its cells kerr09disk4k.orbit_fast and kerr09disk4k.orbit_exact, on the CPU.

The reference is held bit for bit against the port's plain Kerr frame
(the program's CPU path, through the harness's own entry) in both tiers;
its compacting loop against the masked loop it replaces; each cell is
resolved from its files by name; and a run of each cell by the harness's
run_cell, shrunk as bench_torch/tests/test_correct.py shrinks cells, is
correct, and not correct with the control or any planted fault of
calibrate.py in the program's place."""

import dataclasses
import time

import pytest
import torch

from bench_torch import harness
from bench_torch.calibrate import faults
from bench_torch.reference import kerr
from bench_torch.reference.common import (
    STATUS_CAPTURED,
    STATUS_DISK,
    STATUS_ESCAPED,
    generate_rays,
    orbit_camera,
)

CELL = "kerr09disk4k.orbit_fast"
# each cell of the configuration: its tier, the number its limit holds and
# the per-layer metrics it reports
CELLS = {
    "kerr09disk4k.orbit_fast": (True, "off1_pct", {"host.issue_ms", "geodesic.roofline_pct",
                                                   "device.idle_pct"}),
    "kerr09disk4k.orbit_exact": (False, "neq_pct", {"host.issue_ms", "epilogue.device_ms",
                                                    "epilogue.launches",
                                                    "geodesic.roofline_pct",
                                                    "device.idle_pct"}),
}
SEED = 2**31 + 101  # larger than 32 signed bits hold
ESCAPE = 25.0  # so that sky rays escape within the few hundred steps a CPU test can take


def tier_cell(fast: bool, width=48, height=32, max_steps=400):
    """The cell at a small size, in the fast tier or the exact, with the
    escape sphere drawn in to ESCAPE."""
    cell = harness.load_cell(CELL)
    cell.config["scene"].update(width=width, height=height, max_steps=max_steps)
    cell.config["trace"]["escape_radius"] = ESCAPE
    cell.traffic = dict(cell.traffic, renderer={"fast_math": fast})
    return cell


def trace(cell, camera, compact_every=kerr.COMPACT_EVERY):
    sc = cell.config["scene"]
    origins, dirs = generate_rays(camera, sc["width"], sc["height"], sc["fov"], "cpu")
    fast = cell.traffic["renderer"]["fast_math"]
    return kerr.trace(origins, dirs, sc, cell.config["renderer"], cell.config["trace"],
                      fast=fast, compact_every=compact_every)


@pytest.mark.parametrize("fast", [True, False], ids=["fast", "exact"])
def test_reference_equals_the_ports_plain_kerr_frame(fast):
    cell = tier_cell(fast)
    s = harness.seeded(cell, SEED)
    anim, render = harness.build_program(cell, s["star_seed"], "cpu")
    assert anim.renderer.config.model == "kerr" and anim.renderer.fast_math == fast
    anim.renderer.config = dataclasses.replace(anim.renderer.config, escape_radius=ESCAPE)
    k = s["phase"]
    camera = orbit_camera(k, cell.config["camera"])
    hit, vel, status, steps = trace(cell, camera)  # what kerr.render shades
    want = kerr.shade(hit, vel, status, camera, cell, seed=s["star_seed"], fast=fast)
    got = render(k)
    assert harness.numbers(got, want) == {"neq_pct": 0.0, "off1_pct": 0.0}
    assert steps.shape == (32, 48) and int(steps.max()) <= 400
    for kind in (STATUS_ESCAPED, STATUS_CAPTURED, STATUS_DISK):
        assert (status == kind).sum() >= 10, torch.bincount(status.flatten(), minlength=4)


@pytest.mark.parametrize("compact_every", [3, kerr.COMPACT_EVERY])
@pytest.mark.parametrize("fast", [True, False], ids=["fast", "exact"])
def test_the_compacting_loop_equals_the_masked_loop(fast, compact_every):
    cell = tier_cell(fast, width=24, height=16, max_steps=200)
    camera = orbit_camera(harness.seeded(cell, SEED)["phase"], cell.config["camera"])
    masked = trace(cell, camera, 0)
    compacted = trace(cell, camera, compact_every)
    for a, b in zip(masked, compacted):
        assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)
    assert len(set(masked[2].flatten().tolist())) >= 3


@pytest.mark.parametrize("name", sorted(CELLS))
def test_the_cell_resolves_from_its_files(name):
    fast, number, per_layer = CELLS[name]
    cell = harness.load_cell(name)
    assert cell.chips == 1 and harness.reference_module(cell) is kerr
    assert cell.config["renderer"]["model"] == "kerr" and cell.config["scene"]["spin"] == 0.9
    assert (cell.config["scene"]["width"], cell.config["scene"]["height"],
            cell.config["scene"]["max_steps"]) == (3840, 2160, 2000)
    assert cell.config["reduced"] == [] and cell.traffic["renderer"] == {"fast_math": fast}
    assert {m["name"] for m in cell.end_to_end} == {"frame_ms", "frame_ms_p95", "setup_s"}
    assert {m["name"] for m in cell.per_layer} == per_layer
    assert cell.counts["ops_per_step"]["counts"]["kerr.euler.disk"] == 154
    spec = cell.limits["numbers"][number]
    assert set(cell.limits["numbers"]) == {number}
    assert spec["lower"] < spec["limit"] < min(spec["upper"], spec["faults_min"])


def small(name):
    cell = harness.load_cell(name)
    cell.config["scene"].update(width=40, height=24, max_steps=100)
    cell.traffic.update(sample_within=2, compare_frames=1, warmup_frames=1)
    return cell


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


@pytest.mark.parametrize("name", sorted(CELLS))
def test_a_sound_run_is_correct(name):
    out = run(small(name))
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 1
    assert set(out["metrics"]) == {"frame_ms", "frame_ms_p95", "setup_s"}
    assert out["checks"][CELLS[name][1]]["value"] == 0.0


def _control(cell):
    s = harness.seeded(cell, SEED)

    def wrap(render, k):
        render(k)  # the program still runs; its frame is replaced
        low, _ = kerr.render(cell, orbit_camera(k, cell.config["camera"]), seed=s["star_seed"],
                             device="cpu", control=True)
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
@pytest.mark.parametrize("name", sorted(CELLS))
def test_a_broken_run_is_not_correct(name, broken):
    cell = small(name)
    if broken == "stale":
        out = run_stale(cell)
        assert out["attempted"] >= 2
    else:
        wrap = _control(cell) if broken == "control" else _planted(broken)
        out = run(cell, wrap)
    assert not out["correct"], out["checks"]
    if broken == "control":
        number = CELLS[name][1]
        assert out["checks"][number]["value"] > 1.0
