"""Readings for the limits of `correct`: the control, or a planted fault, on
the card at a cell's own size, over several seeds in one process.

    python3 benchmarks/control.py --workload <name> --seeds <n> [<n> ...]
        [--control | --fault <name>] [--seconds 25]

Without `--control` or `--fault` it reads the sound program. `--control`
judges the lower-precision control in the program's place (the reference's
frames from a bfloat16 camera table; the reference's policy and update with
TF32 matrix products); `--fault` plants one of `faults.FAULTS` in the
program. Each seed prints one JSON line of its compared numbers. The window
has to reach the chunk or iteration in which the checked envs' first
episodes end (about 20 s at the cells' sizes). The benchmark's own runs
(`run.py`) never do either.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import harness as H  # noqa: E402
import run as R  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    how = ap.add_mutually_exclusive_group()
    how.add_argument("--control", action="store_true")
    how.add_argument("--fault", default=None)
    ap.add_argument("--seconds", type=float, default=25.0)
    args = ap.parse_args(argv)
    os.environ.update(H.cache_environment())
    import torch

    if not torch.cuda.is_available():
        return R.fail("no CUDA device")
    cell = H.Cell(H.load_benchmark(), args.workload)
    for seed in args.seeds:
        result = R.run_cell(cell, seed, args.seconds, 0, control=args.control, fault=args.fault)
        print(json.dumps({"workload": cell.name, "seed": seed, "control": args.control,
                          "fault": args.fault, "card": H.power_limit(),
                          "checks": {k: v for k, (v, _) in result["checks"].items()}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
