"""The port's sampling benchmark on the CPU: bench_torch.py (the twin of
bench.py) and `megaverse_tpu_torch.cli.bench_main`. No JAX compile:
bench.py's action pool is rebuilt from megaverse_tpu.constants, and bench.py
itself is imported only for its `emit`.

- The action pool equals bench.py's for the same sizes (numpy seed 0).
- `emit` prints bench.py's line for the same arguments.
- `bench_scenario` on the CPU: Empty 2 x 1, one timed chunk of 4 steps.
- Two gloo ranks (spawned, sharing the CPU) give the same obs count and the
  same per-env final checksums as one process.
- The suite prints one line per scenario and the aggregate last, and exits
  non-zero when a scenario raised (bench_scenario stubbed: no envs run).
"""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

import megaverse_tpu.constants as JC

import bench_torch
from megaverse_tpu_torch import cli

import torch_port_checks  # noqa: F401  (one torch thread)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load(path, name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def jax_bench_pool(num_envs, num_agents):
    """bench.py:84-92, with the JAX package's constants."""
    rng = np.random.default_rng(0)
    n_pool = 16
    md = np.stack(
        [rng.integers(0, s, size=(n_pool, num_envs, num_agents))
         for s in JC.ACTION_SPACE_SIZES], axis=-1)
    pool = np.zeros(md.shape[:-1], np.int32)
    for h, bits in enumerate(JC.ACTION_HEAD_BITS):
        pool |= np.asarray(bits, np.int32)[md[..., h]]
    return pool


@pytest.fixture
def one_thread(monkeypatch):
    """The spawned ranks inherit this: one intra-op thread each."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


@pytest.fixture
def short_chunks(monkeypatch):
    """bench_scenario with one timed chunk of 4 steps (the suite's own
    64 x 5 is minutes of CPU rendering)."""
    real = bench_torch.bench_scenario
    monkeypatch.setattr(bench_torch, "bench_scenario",
                        lambda *a, **kw: real(*a, **dict(kw, chunk=4, chunks=1)))


@pytest.mark.parametrize("num_envs,num_agents", [(1024, 1), (4096, 1), (3, 2), (5, 4)])
def test_action_pool_equals_bench_py(num_envs, num_agents):
    got = bench_torch.action_pool(num_envs, num_agents)
    want = jax_bench_pool(num_envs, num_agents)
    assert got.dtype == np.int32 and got.shape == (16, num_envs, num_agents)
    np.testing.assert_array_equal(got, want)


def test_emit_matches_bench_py(capsys):
    bench = load("bench.py", "bench_for_emit")
    for args in (("Empty", 4096, 164_321.456, 75_000.0), ("Collect", 1024, 22_506.04, 27_000.0),
                 ("HexMemory", 1024, 31_053.0, 75_000.0)):
        bench.emit(*args)
        want = capsys.readouterr().out
        bench_torch.emit(*args)
        got = capsys.readouterr().out
        assert got == want
        line = json.loads(got)
        assert list(line) == ["metric", "value", "unit", "vs_baseline"]
        assert line["metric"] == f"obs_per_sec_{args[0].lower()}_{args[1]}env"
    assert bench_torch.MEGAVERSE8 == bench.MEGAVERSE8
    assert bench_torch.BASELINE_FPS == bench.BASELINE_FPS
    assert bench_torch.SUITE_NUM_ENVS == bench.SUITE_NUM_ENVS


def test_bench_scenario_on_cpu():
    res = bench_torch.bench_scenario("Empty", num_envs=2, num_agents=1, chunk=4, chunks=1,
                                     device="cpu")
    assert res.n_obs == 8
    assert res.obs_per_sec > 0 and res.seconds > 0
    assert res.obs_per_sec == pytest.approx(res.n_obs / res.seconds)
    assert res.checksums.shape == (2,) and (res.checksums > 0).all()
    assert res.finite


def test_two_ranks_equal_one_process(one_thread):
    kw = dict(num_envs=4, num_agents=1, chunk=4, chunks=1, device="cpu")
    one = bench_torch.bench_scenario("Empty", **kw)
    two = bench_torch.bench_scenario("Empty", n_devices=2, **kw)
    assert two.n_obs == one.n_obs == 16
    np.testing.assert_array_equal(two.checksums, one.checksums)
    assert two.obs_per_sec > 0 and two.finite and one.finite


def test_cuda_default_raises_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable here")
    with pytest.raises(RuntimeError, match="CUDA"):
        bench_torch.bench_scenario("Empty", num_envs=2, num_agents=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        bench_torch.bench_scenario("Empty", num_envs=2, num_agents=1, n_devices=2)


def test_cli_bench_main_prints_one_line(short_chunks, capsys):
    assert cli.bench_main(["--scenario", "Empty", "--num_envs", "2", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line["metric"] == "obs_per_sec_empty_2env"
    assert line["unit"] == "obs/s@128x72" and line["value"] > 0
    assert line["vs_baseline"] == round(line["value"] / 75_000.0, 3)


def test_suite_lines_and_failed_scenario_exit_code(monkeypatch, capsys):
    seen = []

    def fake(name, num_envs, num_agents, n_devices=1, device="cuda"):
        seen.append((name, num_envs, device))
        if name == "Sokoban":
            raise RuntimeError("layout generation failed")
        return bench_torch.BenchResult(1000.0, 100, 0.1, np.zeros(num_envs, np.int64), True)

    monkeypatch.setattr(bench_torch, "bench_scenario", fake)
    assert bench_torch.main(["--device", "cpu", "--num_envs", "8"]) == 1
    out, err = capsys.readouterr()
    lines = [json.loads(x) for x in out.strip().splitlines()]
    assert [x["metric"] for x in lines] == (
        ["obs_per_sec_empty_8env"]
        + [f"obs_per_sec_{n.lower()}_1024env" for n in bench_torch.MEGAVERSE8 if n != "Sokoban"]
        + ["obs_per_sec_megaverse8_aggregate_1024env_per_task"])
    assert lines[-1]["value"] == 1000.0
    assert lines[-1]["vs_baseline"] == round(1000.0 / 125_000.0, 3)
    assert "bench Sokoban failed" in err
    assert seen == [("Empty", 8, "cpu")] + [(n, 1024, "cpu") for n in bench_torch.MEGAVERSE8]
    # without a failure the suite exits 0
    monkeypatch.setattr(bench_torch, "bench_scenario",
                        lambda name, num_envs, **kw: bench_torch.BenchResult(
                            1.0, 1, 1.0, np.zeros(num_envs, np.int64), True))
    assert bench_torch.main(["--device", "cpu"]) == 0
