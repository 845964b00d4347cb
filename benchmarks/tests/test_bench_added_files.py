"""A later change adds a traffic mix, a cell and a per-layer metric as new
files and new entries of BENCHMARK.json; the harness finds them by name and
no file it already had changes."""

import hashlib
import json
import os
import shutil
import subprocess
import sys

import harness as H


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in root.rglob("*") if p.is_file() and "__pycache__" not in p.parts}


def test_new_cell_and_metric_are_found(tmp_path):
    bench = tmp_path / "benchmarks"
    shutil.copytree(H.BENCH_DIR, bench, ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(H.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = _digests(bench)

    (bench / "workloads" / "collect_256x1.json").write_text(json.dumps(
        dict(H.load_json(bench / "workloads" / "collect_1024x1.json"), num_envs=256)))
    (bench / "metrics" / "chunks_in_window.py").write_text(
        '"""chunks_in_window: chunks the window completed."""\n\n\n'
        'def read(result):\n    return result["counters"]["chunks"]\n')
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "sampler.collect_256x1", "config": "megaverse_sampler",
                              "traffic": "collect_256x1", "chips": 1, "why": "a smaller batch"})
    for m in spec["end_to_end"]:
        if "workloads" in m and "sampler.collect_1024x1" in m["workloads"]:
            m["workloads"].append("sampler.collect_256x1")
    spec["per_layer"].append({"name": "chunks_in_window", "unit": "count", "better": "higher",
                              "source": "program_counter", "layer": "entry point",
                              "moves": "obs_per_sec", "workloads": ["sampler.collect_256x1"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))

    code = (
        "import harness as H, run as R\n"
        "c = H.Cell(H.load_benchmark(), 'sampler.collect_256x1')\n"
        "assert c.traffic['num_envs'] == 256 and c.driver == 'sampler'\n"
        "assert H.load_driver(c).run\n"
        "names = [m['name'] for m in c.per_layer]\n"
        "assert names == ['chunks_in_window'], names\n"
        "assert [m['name'] for m in c.end_to_end] == "
        "['obs_per_sec', 'setup_s']\n"
        "got = R.read_metrics(c, {'counters': {'chunks': 7}}, True)\n"
        "assert got == {'chunks_in_window': {'value': 7.0, 'unit': 'count'}}, got\n"
        "print('found')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=bench, capture_output=True,
                         text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=f"{bench}{os.pathsep}{H.ROOT}"))
    assert out.returncode == 0 and out.stdout.strip() == "found", out.stderr[-3000:]
    after = _digests(bench)
    assert {k: v for k, v in after.items() if k in before} == before
