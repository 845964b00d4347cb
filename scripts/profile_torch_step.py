"""Where one step of the PyTorch port spends its time on the GPU.

Runs `VectorEnv.step_many` of megaverse_tpu_torch on one CUDA device under
`torch.profiler` for a short steady window and prints, as JSON lines:

  - the wall time per step (host clock around a chunk that ends in a
    device synchronise), with and without the profiler (what the
    instrumentation costs);
  - the device's busy share of that window (sum of kernel times over wall
    time; the step runs on one stream, so kernels do not overlap) and its
    idle share;
  - kernel launches per step (on the device) and the host's launch calls per
    step (`cudaLaunchKernel`, `cudaGraphLaunch`, copies and fills, from the
    profiler's CPU events), and the ten kernels with the most device time;
  - peak device memory of the run.

    python scripts/profile_torch_step.py [--scenario TowerBuilding[:envs] ...]
        [--num_envs 1024] [--num_agents 1] [--steps 16] [--eager | --both]
        [--trace out.json]

By default the step replays the tick's CUDA graph (`VectorEnv(capture=True)`);
`--eager` steps eagerly (`capture=False`); `--both` profiles the same env
captured, then eager, then captured again, one set of lines each (the
`capture` key). `--scenario` takes any scenarios of the port (all 16: Empty,
TowerBuilding, Collect, the Obstacles family, Sokoban, Rearrange, BoxAGone,
Football, HexExplore, HexMemory), each with its own env count after a colon
(default `--num_envs`), profiled one after the other in one process. The
render kernel form is the one the environment selects (MEGAVERSE_RENDER_MODE
etc.; default: the bit-walk, B2); the line names it.

Needs a GPU; exits non-zero without one. If the profiler reports no device
time on this machine, the device shares are printed as "not measured".
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def chunk_seconds(env, pool, steps: int) -> float:
    t0 = time.perf_counter()
    _, _, csums = env.step_many(pool, steps)
    csums[-1].item()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--scenario", nargs="+", default=["TowerBuilding"])
    ap.add_argument("--num_envs", type=int, default=1024)
    ap.add_argument("--num_agents", type=int, default=1)
    ap.add_argument("--steps", type=int, default=16)
    how = ap.add_mutually_exclusive_group()
    how.add_argument("--eager", action="store_true", help="step eagerly (capture=False)")
    how.add_argument("--both", action="store_true",
                     help="captured, eager, captured again on the same env")
    ap.add_argument("--trace", default=None, help="write a chrome trace here (the last "
                                                  "window profiled)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_step: no CUDA device", file=sys.stderr)
        return 2

    from megaverse_tpu_torch import VectorEnv

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    modes = [True, False, True] if args.both else [not args.eager]
    for spec in args.scenario:
        name, _, n = spec.partition(":")
        num_envs = int(n) if n else args.num_envs
        env = VectorEnv(name, num_envs, args.num_agents, seed=42, capture=modes[0])
        pool = np.random.default_rng(0).integers(
            0, 2048, size=(16, num_envs, args.num_agents)).astype(np.int32)
        env.reset()
        for capture in modes:
            profile_window(env, pool, args, name, num_envs, capture, smi)
        env.close()
    return 0


def profile_window(env, pool, args, name, num_envs, capture, smi) -> None:
    """Warm-up chunk, two timed chunks, one profiled chunk; prints the lines."""
    from megaverse_tpu_torch.ops import raycast_cuda as RC
    from torch.profiler import ProfilerActivity, profile

    env._ticks.capture = capture
    env._ticks.drop()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    chunk_seconds(env, pool, args.steps)               # warm-up: build, caches, capture
    RC.reset_launch_counts()
    plain = [chunk_seconds(env, pool, args.steps) for _ in range(2)]
    hand_written = {k: v / (2 * args.steps) for k, v in RC.LAUNCHES.items() if v}

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall = chunk_seconds(env, pool, args.steps)
    if args.trace:
        os.makedirs(os.path.dirname(os.path.abspath(args.trace)), exist_ok=True)
        prof.export_chrome_trace(args.trace)

    cuda_type = torch.autograd.DeviceType.CUDA
    kernels, host_calls = [], {}
    for k in prof.key_averages():
        if getattr(k, "device_type", None) != cuda_type:
            if k.key.startswith(("cudaLaunch", "cudaGraphLaunch", "cuLaunch", "cudaMemcpy",
                                 "cudaMemset")):
                host_calls[k.key] = int(k.count) / args.steps
            continue
        us = getattr(k, "self_device_time_total", None)
        if us is None:
            us = getattr(k, "self_cuda_time_total", 0.0)
        kernels.append((float(us), int(k.count), k.key))
    kernels.sort(reverse=True)
    busy_s = sum(k[0] for k in kernels) * 1e-6
    launches = sum(k[1] for k in kernels)
    measured = busy_s > 0.0
    emit({"scenario": name, "envs": num_envs, "agents": args.num_agents,
          "steps": args.steps, "capture": capture, "captures": env.captures,
          "gpu": smi, "bucket": env._bucket, "render_mode": vars(env.render_mode),
          "hand_written_launches_per_step": hand_written,
          "ms_per_step": 1e3 * min(plain) / args.steps,
          "ms_per_step_profiled": 1e3 * wall / args.steps,
          "device_busy_share": busy_s / wall if measured else "not measured",
          "device_idle_share": 1.0 - busy_s / wall if measured else "not measured",
          "device_ms_per_step": 1e3 * busy_s / args.steps if measured else "not measured",
          # the profiler slows the host: the device's busy time of the profiled
          # chunk against the wall of the fastest unprofiled one
          "device_idle_share_unprofiled": (1.0 - busy_s / min(plain)
                                           if measured else "not measured"),
          "kernel_launches_per_step": launches / args.steps if measured else "not measured",
          "host_launch_calls_per_step": host_calls,
          "host_launch_calls_per_step_total": sum(host_calls.values()),
          # from before the warm-up chunk (and its capture) on
          "peak_device_memory_bytes": torch.cuda.max_memory_allocated(),
          "peak_device_memory_reserved_bytes": torch.cuda.max_memory_reserved()})
    for us, count, kname in kernels[:10]:
        emit({"scenario": name, "capture": capture, "kernel": kname[:120],
              "launches_per_step": count / args.steps,
              "device_ms_per_step": 1e-3 * us / args.steps,
              "share_of_device_time": us * 1e-6 / busy_s})


if __name__ == "__main__":
    sys.exit(main())
