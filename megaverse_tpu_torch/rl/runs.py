"""Experiment sweep launcher: the reference's run-description framework.

Mirrors Sample Factory's launcher as used by megaverse_rl/runs/*.py
(megaverse_rl/runs/megaverse_base_experiments.py:3-8 ParamGrid of env x seed,
single_agent.py / multi_agent.py / multitask.py RunDescriptions,
performance_benchmark.py / training_benchmark.py): a ParamGrid expands to the
cartesian product of CLI overrides, an Experiment binds a grid to a base
command, and a RunDescription groups experiments under one sweep name.

Where the reference fans experiments out over slurm
(megaverse_rl/slurm/sbatch_template.sh), scale here comes from the device
mesh inside each run; the launcher executes runs sequentially (or dry-prints
them for external schedulers).

The port's copy: the training runs' commands run megaverse_tpu_torch.rl.train
and the sampling benchmark's run bench_torch.py at the repo root (both on the
card; append --device cpu to a command for the CPU).

Usage:
  python -m megaverse_tpu_torch.rl.runs --run=megaverse8_single_agent --dry
  python -m megaverse_tpu_torch.rl.runs --run=training_benchmark
  python -m megaverse_tpu_torch.rl.runs --run=sampling_benchmark
"""

from __future__ import annotations

import argparse
import itertools
import os
import shlex
import subprocess
import sys
import tempfile
from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

MEGAVERSE8 = [
    "TowerBuilding", "ObstaclesEasy", "ObstaclesHard", "Collect",
    "Sokoban", "HexMemory", "HexExplore", "Rearrange",
]
SEEDS = [11111, 22222, 33333, 44444, 55555]  # megaverse_base_experiments.py:6


class ParamGrid:
    """Cartesian product of (name, values) pairs (SF launcher semantics)."""

    def __init__(self, grid: Sequence[Tuple[str, Sequence]]):
        self.grid = list(grid)

    def generate_params(self, randomize: bool = False) -> List[Dict]:
        names = [n for n, _ in self.grid]
        combos = list(itertools.product(*[v for _, v in self.grid]))
        if randomize:
            import random

            random.shuffle(combos)
        return [dict(zip(names, c)) for c in combos]


@dataclass
class Experiment:
    name: str
    cmd: str
    params: List[Dict] = field(default_factory=list)

    def commands(self) -> List[Tuple[str, str]]:
        """-> [(experiment_instance_name, full command)]."""
        if not self.params:
            return [(self.name, self.cmd)]
        out = []
        for p in self.params:
            suffix = "_".join(f"{k}_{v}" for k, v in p.items())
            flags = " ".join(f"--{k}={v}" for k, v in p.items())
            out.append((f"{self.name}_{suffix}", f"{self.cmd} {flags}"))
        return out


@dataclass
class RunDescription:
    run_name: str
    experiments: List[Experiment]

    def commands(self) -> List[Tuple[str, str]]:
        return [c for e in self.experiments for c in e.commands()]


# --------------------------------------------------------------------------
# Run registry (translations of megaverse_rl/runs/*)
# --------------------------------------------------------------------------

_TRAIN = (
    f"{sys.executable} -m megaverse_tpu_torch.rl.train --gamma=0.997 --use_rnn=1 "
    "--rnn_num_layers=2 --reward_clip=30 --rollout=32 "
    "--train_for_env_steps=2000000000"
)
_GRID_ENV_SEED = ParamGrid([("env", MEGAVERSE8), ("seed", SEEDS)])

# megaverse_base_experiments.py: same total agents per instance (36) split
# across agents-per-env variants.
EXPERIMENT_1AGENT = Experiment(
    "megaverse_1ag", _TRAIN + " --num_envs=1024 --num_agents_per_env=1",
    _GRID_ENV_SEED.generate_params())
EXPERIMENT_2AGENTS = Experiment(
    "megaverse_2ag", _TRAIN + " --num_envs=512 --num_agents_per_env=2",
    _GRID_ENV_SEED.generate_params())
EXPERIMENT_4AGENTS = Experiment(
    "megaverse_4ag", _TRAIN + " --num_envs=256 --num_agents_per_env=4",
    _GRID_ENV_SEED.generate_params())

_MULTITASK = Experiment(
    "megaverse_multitask8",
    _TRAIN + " --num_envs=1024 --num_agents_per_env=1",
    ParamGrid([("env", ["multitask_megaverse8"]), ("seed", SEEDS)]).generate_params())

_BENCH_TORCH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "bench_torch.py")
_SAMPLING_BENCH = Experiment(
    "benchmark_megaverse",
    f"{shlex.quote(sys.executable)} {shlex.quote(_BENCH_TORCH)}",
    ParamGrid([("scenario", ["ObstaclesHard", "Empty", "Collect"])]).generate_params())

_TRAIN_BENCH = Experiment(
    "train_benchmark_megaverse",
    _TRAIN + " --num_envs=1024 --num_agents_per_env=1 "
             "--train_for_env_steps=5000000",
    ParamGrid([("env", ["ObstaclesHard"])]).generate_params())

RUNS: Dict[str, RunDescription] = {
    # single_agent.py / multi_agent.py / multitask.py
    "megaverse8_single_agent": RunDescription(
        "megaverse8_single_agent", [EXPERIMENT_1AGENT]),
    "megaverse8_multi_agent": RunDescription(
        "megaverse8_multi_agent", [EXPERIMENT_2AGENTS, EXPERIMENT_4AGENTS]),
    "megaverse8_multitask": RunDescription(
        "megaverse8_multitask", [_MULTITASK]),
    # performance_benchmark.py / training_benchmark.py
    "sampling_benchmark": RunDescription(
        "sampling_benchmark", [_SAMPLING_BENCH]),
    "training_benchmark": RunDescription(
        "training_benchmark", [_TRAIN_BENCH]),
}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--run", required=True, choices=sorted(RUNS))
    p.add_argument("--dry", action="store_true", help="print commands only")
    p.add_argument("--train_dir",
                   default=os.path.join(tempfile.gettempdir(), "megaverse_tpu_torch_train"))
    p.add_argument("--max_runs", type=int, default=None,
                   help="cap the number of grid points executed")
    args = p.parse_args(argv)

    cmds = RUNS[args.run].commands()
    if args.max_runs is not None:
        cmds = cmds[: args.max_runs]
    print(f"run {args.run}: {len(cmds)} experiment(s)")
    for name, cmd in cmds:
        if "rl.train" in cmd:
            cmd += f" --train_dir={args.train_dir} --experiment={name}"
        print(f"[{name}] {cmd}", flush=True)
        if args.dry:
            continue
        ret = subprocess.call(shlex.split(cmd))
        if ret != 0:
            print(f"experiment {name} failed with code {ret}")
            return ret
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
