"""Where one step of the PyTorch port spends its time on the GPU.

Runs `VectorEnv.step_many` of megaverse_tpu_torch on one CUDA device under
`torch.profiler` for a short steady window and prints, as JSON lines:

  - the wall time per step (host clock around a chunk that ends in a
    device synchronise), with and without the profiler (what the
    instrumentation costs);
  - the device's busy share of that window (sum of kernel times over wall
    time; the step runs on one stream, so kernels do not overlap) and its
    idle share;
  - kernel launches per step and the ten kernels with the most device time;
  - peak device memory of the run.

    python scripts/profile_torch_step.py [--scenario TowerBuilding]
        [--num_envs 1024] [--num_agents 1] [--steps 16] [--trace out.json]

`--scenario` takes any scenario of the port (all 16: Empty, TowerBuilding,
Collect, the Obstacles family, Sokoban, Rearrange, BoxAGone, Football,
HexExplore, HexMemory). The render kernel
form is the one the environment selects (MEGAVERSE_RENDER_MODE etc.; default:
the bit-walk, B2); the line names it.

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
    ap.add_argument("--scenario", default="TowerBuilding")
    ap.add_argument("--num_envs", type=int, default=1024)
    ap.add_argument("--num_agents", type=int, default=1)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--trace", default=None, help="write a chrome trace here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_step: no CUDA device", file=sys.stderr)
        return 2

    from megaverse_tpu_torch import VectorEnv
    from megaverse_tpu_torch.ops import raycast_cuda as RC
    from torch.profiler import ProfilerActivity, profile

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    env = VectorEnv(args.scenario, args.num_envs, args.num_agents, seed=42)
    pool = np.random.default_rng(0).integers(
        0, 2048, size=(16, args.num_envs, args.num_agents)).astype(np.int32)
    env.reset()
    chunk_seconds(env, pool, args.steps)               # warm-up: build, caches
    torch.cuda.reset_peak_memory_stats()
    plain = [chunk_seconds(env, pool, args.steps) for _ in range(2)]

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall = chunk_seconds(env, pool, args.steps)
    if args.trace:
        os.makedirs(os.path.dirname(os.path.abspath(args.trace)), exist_ok=True)
        prof.export_chrome_trace(args.trace)

    cuda_type = torch.autograd.DeviceType.CUDA
    kernels = []
    for k in prof.key_averages():
        if getattr(k, "device_type", None) != cuda_type:
            continue
        us = getattr(k, "self_device_time_total", None)
        if us is None:
            us = getattr(k, "self_cuda_time_total", 0.0)
        kernels.append((float(us), int(k.count), k.key))
    kernels.sort(reverse=True)
    busy_s = sum(k[0] for k in kernels) * 1e-6
    launches = sum(k[1] for k in kernels)
    measured = busy_s > 0.0
    emit({"scenario": args.scenario, "envs": args.num_envs, "agents": args.num_agents,
          "steps": args.steps, "gpu": smi, "bucket": env._bucket,
          "render_mode": vars(env.render_mode),
          "render_launches": {k: v for k, v in RC.LAUNCHES.items() if v},
          "ms_per_step": 1e3 * min(plain) / args.steps,
          "ms_per_step_profiled": 1e3 * wall / args.steps,
          "device_busy_share": busy_s / wall if measured else "not measured",
          "device_idle_share": 1.0 - busy_s / wall if measured else "not measured",
          "device_ms_per_step": 1e3 * busy_s / args.steps if measured else "not measured",
          "kernel_launches_per_step": launches / args.steps if measured else "not measured",
          "peak_device_memory_bytes": torch.cuda.max_memory_allocated()})
    for us, count, name in kernels[:10]:
        emit({"scenario": args.scenario, "kernel": name[:120], "launches_per_step": count / args.steps,
              "device_ms_per_step": 1e-3 * us / args.steps,
              "share_of_device_time": us * 1e-6 / busy_s})
    env.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
