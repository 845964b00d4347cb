"""Rank functions of tests/test_torch_parallel.py. Not a test module: the
ranks that test spawns import it, so it imports torch and the port only,
never JAX."""

import os
import sys

import torch


def update_rank(rank: int, world_size: int, inputs_path: str, out_dir: str) -> None:
    """One data-parallel `_update_from_batch` of the port's learner on this
    rank's env rows of a fixed batch; saves the parameters and metrics."""
    from megaverse_tpu_torch.parallel import (ParallelLearner, maybe_initialize_distributed,
                                              shutdown_distributed)
    from megaverse_tpu_torch.rl import learner as TL
    from megaverse_tpu_torch.scenarios import make_scenario

    torch.set_num_threads(1)
    maybe_initialize_distributed(device="cpu")
    try:
        d = torch.load(inputs_path)
        cfg = TL.TrainConfig(**d["cfg"], model_dtype=torch.float32)
        learner = TL.Learner(make_scenario("Empty", num_agents=d["agents"]), d["num_envs"],
                             cfg, device="cpu")
        pl = ParallelLearner(learner)
        sl = pl.env_slice
        b = d["batch"]
        batch = TL.RolloutBatch(*(b[k][:, sl] for k in (
            "obs", "actions", "logp", "value", "reward", "done")), init_carry=b["init_carry"][sl])
        ls = TL.LearnerState(d["params"], TL.adam_init(d["params"]), None, d["last_obs"][sl],
                             d["last_carry"][sl], torch.Generator().manual_seed(rank), d["step"])
        ls, metrics = pl._update_from_batch(ls, batch)
        torch.save({"params": ls.params, "metrics": metrics, "envs": pl.envs_per_device,
                    "jax_imported": "jax" in sys.modules},
                   os.path.join(out_dir, f"update{rank}.pt"))
    finally:
        shutdown_distributed()
