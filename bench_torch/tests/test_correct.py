"""`correct` at a size a CPU test run holds: the port's plain versions (its
CPU path) match the benchmark's own reference bit for bit; a run of each
cell comes out correct; the same run with the timed path broken
underneath, or with the control (the reference in the precision below the
configuration's) in the program's place, comes out not correct.

The run is the harness's own (run_cell) with the look for a card skipped:
the device is the CPU, where the port renders with its plain versions."""

import time

import pytest
import torch

from bench_torch import harness
from bench_torch.calibrate import faults
from bench_torch.reference.common import orbit_camera

CELLS = [w for w in ("sch1080.orbit_fast", "rk4disk1080.orbit_exact", "sch1080.orbit_neural",
                     "rk4disk1080.orbit_fast")]
SEED = 2**31 + 101  # larger than 32 signed bits hold


def small(name):
    cell = harness.load_cell(name)
    cell.config["scene"].update(width=40, height=24, max_steps=100)
    cell.traffic.update(sample_within=2, compare_frames=1, warmup_frames=1)
    return cell


def run(cell, wrap=None):
    return harness.run_cell(cell, SEED, 0.8, False, t_start=time.perf_counter(), device="cpu",
                            wrap=wrap)


@pytest.mark.parametrize("name", CELLS)
def test_reference_matches_the_ports_plain_version(name):
    cell = small(name)
    s = harness.seeded(cell, SEED)
    _, render = harness.build_program(cell, s["star_seed"], "cpu")
    ref = harness.reference_module(cell)
    for k in (s["phase"], s["phase"] + 1):
        want, steps = ref.render(cell, orbit_camera(k, cell.config["camera"]),
                                 seed=s["star_seed"], device="cpu")
        got = harness.numbers(render(k), want)
        assert got == {"neq_pct": 0.0, "off1_pct": 0.0}
        assert (steps is None) == ("asset" in cell.traffic)


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(name):
    out = run(small(name))
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 1
    assert set(out["metrics"]) == {m["name"] for m in harness.load_cell(name).end_to_end}
    assert list(out)[-1] == "checks"
    assert all(c["value"] == 0.0 for c in out["checks"].values())


class Stale:
    """Every frame is the first one the window issued: a step that leaves
    its state unchanged."""

    def __init__(self):
        self.first = None

    def __call__(self, render, k):
        if self.first is None:
            self.first = k
        return render(self.first)


def planted(kind):
    def wrap(render, k):
        frame = render(k)
        return faults(frame[0], frame[0])[kind][None]
    return wrap


@pytest.mark.parametrize("fault", ["stale", "half_rows", "band_altered"])
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_timed_path_is_not_correct(name, fault):
    out = run(small(name), Stale() if fault == "stale" else planted(fault))
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(name):
    cell = small(name)
    s = harness.seeded(cell, SEED)
    ref = harness.reference_module(cell)

    def control(render, k):
        render(k)  # the program still runs; its frame is replaced
        low, _ = ref.render(cell, orbit_camera(k, cell.config["camera"]), seed=s["star_seed"],
                            device="cpu", control=True)
        return low[None]

    out = run(cell, control)
    assert not out["correct"], out["checks"]
    assert max(c["value"] for c in out["checks"].values()) > 1.0


def test_asset_digest_is_held():
    cell = small("sch1080.orbit_neural")
    cell.traffic["asset_sha256"] = "0" * 64
    with pytest.raises(ValueError, match="sha256"):
        harness.asset_path(cell)
    assert torch.get_default_dtype() == torch.float32
