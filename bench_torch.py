"""Throughput benchmark of the PyTorch/CUDA port: env-steps (= RGB
observations) per second at 128x72. The twin of bench.py: the same suite,
sizes, action pool and JSON lines, through megaverse_tpu_torch.

Mirrors the reference's `megaverse_test_app --performance_test`
(src/apps/megaverse_test_app.cpp:149-171: N envs, random actions, FPS report)
and the DUMMY_SAMPLER sampling benchmark (megaverse_rl/sampling_benchmark.py).
Every step runs the full pipeline: action decode, KCC physics, scenario
logic, auto-reset, and the batched render kernel (the bit-walk form by
default; the MEGAVERSE_* render-mode variables pick another), whose packed
observations stay on the card.

Default mode benches Empty at --num_envs, then the Megaverse-8 suite at
BENCH_SUITE_NUM_ENVS: one JSON line per scenario, then the aggregate as the
FINAL line (total obs / total timed seconds across the 8 tasks).
`--scenario NAME` benches one scenario instead. A scenario that raises is
reported on stderr and the suite goes on, but the run then exits non-zero.

`--n_devices N` runs one process per card (rank r on cuda:r, NCCL; on the
CPU, gloo ranks), each holding `VectorEnv(shard=(r, N))` of the same total
env count; the timed window opens and closes on a barrier, and obs/s is the
total obs over the window's wall time. Fewer than N cards raise.

Runs on the card (`--device cuda`, the default; raises without one) unless
given `--device cpu`.

  python3 bench_torch.py                          # Empty 4096, then the suite at 1024
  python3 bench_torch.py --scenario Collect --num_envs 1024
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from typing import NamedTuple

import numpy as np
import torch

# Per-scenario figures of the original Megaverse on its own machine (64 envs,
# 1 agent, Vulkan, a 10-core i9 and one GPU; BASELINE.md:10-11). Scenarios
# without a published figure are divided by the Empty one.
BASELINE_FPS = {"empty": 75_000.0, "collect": 27_000.0}
BASELINE_EMPTY_FPS = BASELINE_FPS["empty"]
# The aggregate's divisor: the original's published ~1M obs/s on one 8-GPU
# server (BASELINE.md:9), per GPU.
BASELINE_PER_GPU_FPS = 1_000_000.0 / 8

# The Megaverse-8 task suite (megaverse/megaverse_env.py:11-20) in bench order.
MEGAVERSE8 = [
    "TowerBuilding", "ObstaclesEasy", "ObstaclesHard", "Collect",
    "Sokoban", "HexMemory", "HexExplore", "Rearrange",
]
SUITE_NUM_ENVS = int(os.environ.get("BENCH_SUITE_NUM_ENVS", "1024"))
ACTION_POOL = 16
# chunks stepped before the timed window: two, a flush, one more whose flush
# takes its refill
WARMUP_CHUNKS = 3


class BenchResult(NamedTuple):
    obs_per_sec: float
    n_obs: int            # observations in the timed window, over all ranks
    seconds: float        # the timed window's wall time
    checksums: np.ndarray  # int64 [num_envs]: each env's last frame summed, in env order
    finite: bool          # every floating-point leaf of every rank's final state is finite
    env: object = None    # the VectorEnv, left open, with bench_scenario(keep_env=True)


def card() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.CalledProcessError):
        return "no nvidia-smi"


def action_pool(num_envs: int, num_agents: int, n_pool: int = ACTION_POOL) -> np.ndarray:
    """int32 bitmask actions [n_pool, num_envs, num_agents]: uniform choices
    per action head from numpy seed 0, packed head by head (bench.py's pool)."""
    from megaverse_tpu_torch import constants as C

    rng = np.random.default_rng(0)
    md = np.stack([rng.integers(0, s, size=(n_pool, num_envs, num_agents))
                   for s in C.ACTION_SPACE_SIZES], axis=-1)
    pool = np.zeros(md.shape[:-1], np.int32)
    for h, bits in enumerate(C.ACTION_HEAD_BITS):
        pool |= np.asarray(bits, np.int32)[md[..., h]]
    return pool


def _run(scenario_name, num_envs, num_agents, chunk, chunks, device, rank, world_size,
         keep=False):
    """One process's share: reset, warm-up, the timed window. Returns
    (window seconds, last frame's per-env checksums int64 [local envs],
    whether the final state is finite, the env if `keep` else None: it is
    closed unless kept)."""
    import torch.distributed as dist

    from megaverse_tpu_torch.types import tree_leaves
    from megaverse_tpu_torch.vector_env import VectorEnv

    sharded = world_size > 1
    env = VectorEnv(scenario_name, num_envs=num_envs, num_agents_per_env=num_agents,
                    seed=42, device=device, shard=(rank, world_size) if sharded else None)
    try:
        env.reset()
        lo, n = env.env_offset, env.num_envs
        pool = action_pool(num_envs, num_agents)[:, lo:lo + n]
        # Warm-up: two chunks, a flush, and a chunk whose flush takes any
        # refill, so that nothing builds, allocates or refills for the first
        # time inside the timed window.
        for i in range(WARMUP_CHUNKS):
            _, _, csums = env.step_many(pool, chunk)
            int(csums[-1])
            if i:
                env.flush()
        if sharded:
            dist.barrier()
        t0 = time.perf_counter()
        for _ in range(chunks):
            obs, _, csums = env.step_many(pool, chunk)
        # the fence is a read of the last checksum's value, never a launch
        int(csums[-1])
        if sharded:
            dist.barrier()
        dt = time.perf_counter() - t0
        sums = obs.reshape(n, -1).sum(dim=1, dtype=torch.int64)
        finite = all(bool(torch.isfinite(x).all()) for x in tree_leaves(env.state)
                     if x.is_floating_point())
        return dt, sums, finite, env if keep else None
    finally:
        if not keep:
            env.close()


def _rank_main(rank: int, world_size: int, spec: dict) -> None:
    import torch.distributed as dist

    from megaverse_tpu_torch.parallel import maybe_initialize_distributed, shutdown_distributed

    device = torch.device(spec["devices"][rank])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    else:
        torch.set_num_threads(1)
    maybe_initialize_distributed(device=device)
    try:
        dt, sums, finite, _ = _run(spec["scenario"], spec["num_envs"], spec["num_agents"],
                                   spec["chunk"], spec["chunks"], device, rank, world_size)
        # the slowest rank's window, every rank's checksums in rank order, and
        # whether every rank's state is finite
        dt_t = torch.tensor([dt], dtype=torch.float64, device=device)
        dist.all_reduce(dt_t, op=dist.ReduceOp.MAX)
        finite_t = torch.tensor([int(finite)], dtype=torch.int32, device=device)
        dist.all_reduce(finite_t, op=dist.ReduceOp.MIN)
        parts = [torch.empty_like(sums) for _ in range(world_size)]
        dist.all_gather(parts, sums)
        if rank == 0:
            torch.save({"seconds": dt_t.cpu(), "finite": finite_t.cpu(),
                        "checksums": torch.cat(parts).cpu()},
                       os.path.join(spec["out_dir"], "result.pt"))
    finally:
        shutdown_distributed()


def rank_devices(n_devices: int, device: str = "cuda") -> list:
    """One device per rank: cuda:0 .. cuda:N-1 (raises with fewer cards;
    ranks never share a card), or the CPU N times."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("bench_torch runs on a CUDA device by default and none is "
                               "available; pass --device cpu to run on the CPU")
        if torch.cuda.device_count() < n_devices:
            raise RuntimeError(f"--n_devices {n_devices}: only {torch.cuda.device_count()} "
                               "CUDA devices")
        if n_devices == 1:
            return [dev]
        return [torch.device("cuda", r) for r in range(n_devices)]
    return [dev] * n_devices


def bench_scenario(scenario_name: str, num_envs: int, num_agents: int,
                   chunk: int = 64, chunks: int = 5, n_devices: int = 1,
                   device: str = "cuda", keep_env: bool = False) -> BenchResult:
    """Reset, warm up, then time `chunks` step_many chunks of `chunk` steps
    of a `num_envs` x `num_agents` VectorEnv, over `n_devices` ranks. With
    `keep_env` (one rank only) the result holds the env, still open: the
    caller closes it."""
    devices = rank_devices(n_devices, device)
    env = None
    if n_devices == 1:
        dt, sums, finite, env = _run(scenario_name, num_envs, num_agents, chunk, chunks,
                                     devices[0], 0, 1, keep=keep_env)
        checksums = sums.cpu().numpy()
    elif keep_env:
        raise ValueError("keep_env needs one rank")
    else:
        from megaverse_tpu_torch.parallel import spawn

        with tempfile.TemporaryDirectory() as tmp:
            spec = dict(scenario=scenario_name, num_envs=num_envs, num_agents=num_agents,
                        chunk=chunk, chunks=chunks, devices=[str(d) for d in devices],
                        out_dir=tmp)
            spawn(_rank_main, n_devices, f"file://{os.path.join(tmp, 'init')}", args=(spec,))
            out = torch.load(os.path.join(tmp, "result.pt"))
        dt, finite = float(out["seconds"]), bool(out["finite"])
        checksums = out["checksums"].numpy()
    n_obs = num_envs * num_agents * chunk * chunks
    return BenchResult(n_obs / dt, n_obs, dt, checksums, finite, env)


def emit(scenario: str, num_envs: int, fps: float, base: float) -> None:
    print(json.dumps({
        "metric": f"obs_per_sec_{scenario.lower()}_{num_envs}env",
        "value": round(fps, 1),
        "unit": "obs/s@128x72",
        "vs_baseline": round(fps / base, 3),
    }), flush=True)


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--scenario", default=os.environ.get("BENCH_SCENARIO", ""),
                   help="bench ONE scenario instead of the Megaverse-8 suite")
    p.add_argument("--num_envs", type=int,
                   default=int(os.environ.get("BENCH_NUM_ENVS", "4096")))
    p.add_argument("--num_agents", type=int,
                   default=int(os.environ.get("BENCH_NUM_AGENTS", "1")))
    p.add_argument("--n_devices", type=int,
                   default=int(os.environ.get("BENCH_N_DEVICES", "1")),
                   help="split the env batch over this many ranks, one card each")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a GPU) or cpu")
    args = p.parse_args(argv)
    run = lambda name, n: bench_scenario(name, num_envs=n, num_agents=args.num_agents,
                                         n_devices=args.n_devices, device=args.device)

    if args.scenario:
        res = run(args.scenario, args.num_envs)
        emit(args.scenario, args.num_envs, res.obs_per_sec,
             BASELINE_FPS.get(args.scenario.lower(), BASELINE_EMPTY_FPS))
        return 0

    # Suite mode: Empty first (the reference's headline config), then the
    # Megaverse-8 tasks; the aggregate over the 8 tasks is the FINAL line.
    failed = []
    try:
        res = run("Empty", args.num_envs)
        emit("Empty", args.num_envs, res.obs_per_sec, BASELINE_FPS["empty"])
    except Exception as e:  # keep the suite going; the exit code reports it
        print(f"bench Empty failed: {e!r}", file=sys.stderr, flush=True)
        failed.append("Empty")

    total_obs, total_dt = 0, 0.0
    for name in MEGAVERSE8:
        try:
            res = run(name, SUITE_NUM_ENVS)
        except Exception as e:
            print(f"bench {name} failed: {e!r}", file=sys.stderr, flush=True)
            failed.append(name)
            continue
        total_obs += res.n_obs
        total_dt += res.seconds
        emit(name, SUITE_NUM_ENVS, res.obs_per_sec,
             BASELINE_FPS.get(name.lower(), BASELINE_EMPTY_FPS))

    agg = total_obs / total_dt if total_dt else 0.0
    print(json.dumps({
        "metric": f"obs_per_sec_megaverse8_aggregate_{SUITE_NUM_ENVS}env_per_task",
        "value": round(agg, 1),
        "unit": "obs/s@128x72",
        "vs_baseline": round(agg / BASELINE_PER_GPU_FPS, 3),
    }), flush=True)
    if failed:
        print(f"bench: {len(failed)} scenario(s) failed: {', '.join(failed)}",
              file=sys.stderr, flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
