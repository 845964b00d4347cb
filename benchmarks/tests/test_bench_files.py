"""BENCHMARK.json and the files it names: every configuration, traffic mix,
driver and metric reader is there and loads; every per-layer metric's cells
report the end-to-end metric it moves; names and sizes keep to the
contract's limits."""

import json
import re

import pytest

import harness as H

BENCH = H.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) < 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51
    assert BENCH["paths"] == ["benchmarks"]
    assert BENCH["command"][:2] == ["python3", "benchmarks/run.py"]


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_every_cell_loads(w):
    cell = H.Cell(BENCH, w["name"])
    assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and NAME.match(w["config"])
    assert 1 <= len(w["why"]) <= 200 and w["chips"] in (1, 4)
    assert (H.BENCH_DIR / "drivers" / f"{cell.driver}.py").is_file()
    assert cell.traffic["scenario"]
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer, "every cell reports a per-layer metric"


def test_configs_and_metrics():
    for c in BENCH["configs"]:
        cfg = H.load_json(H.ROOT / c["file"])
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert all(NAME.match(k) for k in c["reduced"])
    for m in BENCH["end_to_end"]:
        assert 0 < m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["per_layer"]:
        assert (H.BENCH_DIR / "metrics" / f"{m['name']}.py").is_file()
        assert UNIT.match(m["unit"]) and NAME.match(m["name"])
        H.load_metric(m["name"])


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_metric_cells_report_what_it_moves(m):
    for name in m["workloads"]:
        cell = H.Cell(BENCH, name)
        assert m["moves"] in {e["name"] for e in cell.end_to_end}
        assert m["name"] in {p["name"] for p in cell.per_layer}
