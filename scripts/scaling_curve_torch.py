#!/usr/bin/env python
"""Data-parallel sampling scaling curve of the port (twin of
scripts/scaling_curve.py).

Runs bench_torch.bench_scenario at a fixed TOTAL env count while splitting
the batch over 1..N ranks, one card each (rank r on cuda:r, NCCL; every
N needs N cards), and prints one JSON line per N: obs/s over all ranks and
its ratio to the first N's, beside the card's name and power limit. On the
CPU (`--device cpu`) the ranks are gloo processes sharing the host's cores,
so ideal scaling there is flat, not linear: it checks the sharded path at
small sizes.

  python3 scripts/scaling_curve_torch.py --devices 1,2,4        # needs 4 cards
  python3 scripts/scaling_curve_torch.py --device cpu --devices 1,2 --num_envs 4 \\
      --chunk 4 --chunks 1
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--scenario", default="Empty")
    p.add_argument("--num_envs", type=int, default=2048)
    p.add_argument("--devices", default="1,2,4")
    p.add_argument("--chunk", type=int, default=32)
    p.add_argument("--chunks", type=int, default=3)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; rank r on cuda:r) or cpu (gloo ranks)")
    args = p.parse_args(argv)
    if args.device == "cpu":
        os.environ.setdefault("OMP_NUM_THREADS", "1")   # the ranks share the cores

    import bench_torch

    gpu = bench_torch.card() if args.device == "cuda" else "cpu"
    base = None
    for n in [int(x) for x in args.devices.split(",")]:
        res = bench_torch.bench_scenario(args.scenario, num_envs=args.num_envs, num_agents=1,
                                         chunk=args.chunk, chunks=args.chunks, n_devices=n,
                                         device=args.device)
        if base is None:
            base = res.obs_per_sec
        print(json.dumps({"n_devices": n, "obs_per_sec": round(res.obs_per_sec, 1),
                          "vs_1dev": round(res.obs_per_sec / base, 3),
                          "num_envs": args.num_envs, "seconds": res.seconds, "gpu": gpu}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
