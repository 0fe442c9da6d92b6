"""Every cell of BENCHMARK.json resolves from its files by name, and the
file keeps to the benchmark's contract."""

import json
import re
from pathlib import Path

import pytest

from bench_torch import harness

REPO = Path(__file__).resolve().parents[2]
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves_from_its_files(name):
    cell = harness.load_cell(name)
    assert cell.chips == 1
    assert harness.reference_module(cell).render
    reported = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in reported and {n.split(".")[0] for n in reported} <= {
        "frame_ms", "frame_ms_p95", "setup_s"} and len(reported) >= 2
    assert cell.per_layer, "every cell reports a per-layer metric"
    for m in cell.per_layer:
        assert callable(harness.metric_reader(m["name"]))
        assert m["moves"] in reported
    assert set(cell.limits["numbers"]) <= {"neq_pct", "off1_pct"}
    for spec in cell.limits["numbers"].values():
        assert spec["limit"] > 0
    if "asset" in cell.traffic:
        assert harness.asset_path(cell).exists()
    s = harness.seeded(cell, 2**31 + 17)
    assert 0 <= s["phase"] < cell.config["camera"]["frames_per_orbit"]
    assert s == harness.seeded(cell, 2**31 + 17)


def test_unknown_cell_is_refused():
    with pytest.raises(ValueError, match="no workload"):
        harness.load_cell("no_such.cell")


def test_benchmark_json_keeps_to_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["bench_torch"]
    assert 1 <= BENCH["run_seconds"] <= 51
    configs = {c["name"] for c in BENCH["configs"]}
    used = {w["config"] for w in BENCH["workloads"]}
    assert configs == used
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("bench_torch/") and (REPO / c["file"]).exists()
        assert json.loads((REPO / c["file"]).read_text())["reduced"] == c["reduced"]
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [x["name"] for x in BENCH["configs"] + BENCH["workloads"] + metrics]
    assert all(NAME.match(n) for n in names)
    assert len({m["name"] for m in metrics}) == len(metrics)
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert 1 <= len(w["why"]) <= 200 and w["chips"] in (1, 4)
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        assert set(m.get("workloads", [])) <= set(CELLS)
    assert all(UNIT.match(m["unit"]) and m["better"] in ("lower", "higher") for m in metrics)
