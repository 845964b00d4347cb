"""Count the tensor operations the PyTorch port dispatches per step.

The port's tick is plain PyTorch: every tensor operation is one dispatch from
Python and, on a GPU, one kernel launch (run eagerly, or recorded once into
the tick's CUDA graph and replayed). This script counts them with a
`TorchDispatchMode` hook for one `env_step` and one `render_tables` (the cull
prologue in front of the render kernel) per scenario. The counts do not depend
on the batch size or on the device, so it runs on the CPU at a small batch:

    python scripts/torch_dispatch_count.py [Scenario[:agents] ...]

Without arguments it counts TowerBuilding (1 and 4 agents), Empty, Collect
and ObstaclesHard. `render_tables` is counted under the render mode that the
environment selects (MEGAVERSE_RENDER_MODE etc., default: the bit-walk).
Prints one JSON line per scenario. These are counts, not times.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from megaverse_tpu_torch import VectorEnv  # noqa: E402
from megaverse_tpu_torch.env import env_step, render_tables  # noqa: E402


class CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def count(fn) -> int:
    with CountOps() as mode:
        fn()
    return mode.n


DEFAULT = (("TowerBuilding", 1), ("TowerBuilding", 4), ("Empty", 1), ("Collect", 1),
           ("ObstaclesHard", 1))


def main() -> None:
    wanted = [(a.split(":")[0], int(a.split(":")[1]) if ":" in a else 1)
              for a in sys.argv[1:]] or DEFAULT
    for name, agents in wanted:
        env = VectorEnv(name, 8, agents, seed=0, render=False, device="cpu")
        env.reset()
        act = torch.from_numpy(
            np.random.default_rng(0).integers(0, 2048, size=(8, agents)).astype(np.int32))
        step = count(lambda: env_step(env.scenario, env.state, env.next_scenes, act,
                                      env.shaping))
        prologue = count(lambda: render_tables(env.scenario, env.state,
                                               bucket=env._bucket))
        print(json.dumps({"scenario": name, "agents": agents, "env_step_ops": step,
                          "render_tables_ops": prologue}), flush=True)
        env.close()


if __name__ == "__main__":
    main()
