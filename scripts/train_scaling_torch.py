#!/usr/bin/env python
"""Data-parallel training rate of the port over 1, 2, ... devices (weak
scaling: the same envs per device), through the trainer's own CLI,
`megaverse_tpu_torch.rl.train --n_devices N` (rank r on cuda:r, NCCL), then
`entry.dryrun_multichip(max N)` (sharded sampling equal to one process's,
replicas bit-equal after one update; raises otherwise).

Prints one JSON line per N with the trainer's `train_summary.json` rates
(env-steps/s over the whole run, samples/s, rollout and update ms per
update, setup seconds), the steady rate (env steps over the rollout + update
time of every update but the first, which pays cuDNN's first calls; refills
and checkpoints left out), and one line for the dryrun, each with the card's
name and power limit. An N given twice is run twice, in the order given.

  python3 scripts/train_scaling_torch.py --n_devices 1 2 4 4 2 1   # needs 4 cards

`--device cpu` runs the ranks on the CPU (gloo), for a rehearsal at small
sizes (`--envs_per_device 2 --hidden_size 32`).
"""

import argparse
import json
import os
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--env", default="Collect")
    p.add_argument("--n_devices", type=int, nargs="+", default=[1, 2, 4])
    p.add_argument("--envs_per_device", type=int, default=512)
    p.add_argument("--num_agents_per_env", type=int, default=2)
    p.add_argument("--rollout", type=int, default=32)
    p.add_argument("--updates", type=int, default=8)
    p.add_argument("--hidden_size", type=int, default=512)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; rank r on cuda:r) or cpu (gloo ranks)")
    p.add_argument("--no_dryrun", action="store_true")
    args = p.parse_args(argv)
    if args.device == "cpu":
        os.environ.setdefault("OMP_NUM_THREADS", "1")   # the ranks share the cores

    from megaverse_tpu_torch import entry
    from megaverse_tpu_torch.rl import train

    import bench_torch

    gpu = bench_torch.card() if args.device == "cuda" else "cpu"
    for n in args.n_devices:
        envs = args.envs_per_device * n
        with tempfile.TemporaryDirectory() as tmp:
            argv_n = ["--env", args.env, "--num_envs", str(envs),
                      "--num_agents_per_env", str(args.num_agents_per_env),
                      "--rollout", str(args.rollout), "--hidden_size", str(args.hidden_size),
                      "--train_for_env_steps", str(args.updates * args.rollout * envs),
                      "--device", args.device, "--n_devices", str(n), "--train_dir", tmp]
            t0 = time.perf_counter()
            if train.main(argv_n) != 0:
                raise SystemExit(f"rl.train failed at --n_devices {n}")
            wall = time.perf_counter() - t0
            summary = json.loads((Path(tmp) / "default" / "train_summary.json").read_text())
        later_ms = sum(summary["rollout_ms"][1:]) + sum(summary["update_ms"][1:])
        steady = (summary["updates"] - 1) * args.rollout * envs / (later_ms / 1e3) \
            if later_ms > 0 else None
        print(json.dumps({
            "phase": "train_scaling", "n_devices": n, "num_envs": envs,
            "agents": args.num_agents_per_env, "rollout": args.rollout,
            "hidden_size": args.hidden_size, "updates": summary["updates"],
            "env_steps_per_s": summary["env_steps_per_s"],
            "steady_env_steps_per_s": steady,
            "samples_per_s": summary["samples_per_s"], "rollout_ms": summary["rollout_ms"],
            "update_ms": summary["update_ms"], "setup_seconds": summary["setup_seconds"],
            "wall_seconds": wall, "peak_device_memory_bytes": summary["peak_device_memory_bytes"],
            "gpu": gpu}), flush=True)
    if not args.no_dryrun:
        report = entry.dryrun_multichip(max(args.n_devices), device=args.device)
        print(json.dumps(dict(report, phase="dryrun_multichip", gpu=gpu)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
