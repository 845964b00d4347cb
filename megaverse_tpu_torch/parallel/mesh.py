"""Data parallelism over the env batch (counterpart of
megaverse_tpu/parallel/mesh.py).

The reference scales out with OS threads, Sample Factory worker processes
and slurm (SURVEY 2.3); the JAX package shards the env batch over a device
mesh, replicates the parameters and `pmean`s the gradients inside
`shard_map`. Here each process holds one device and its shard of the envs
(`VectorEnv(..., shard=(rank, world_size))`, or a trainer task that
generates only its envs' layouts): parameters start equal (broadcast from
rank 0), each rank runs its shard's rollout, and the gradients and the
update's metrics are all-reduced to their mean before the clip and Adam, so
every replica takes the same step. Observations never leave their device.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.distributed as dist

from megaverse_tpu_torch.rl.learner import Learner, LearnerState, RolloutBatch
from megaverse_tpu_torch.utils.logging import span


def rank_seed(seed: int, rank: int) -> int:
    """Seed of rank `rank`'s torch.Generator (action sampling, minibatch
    order): one independent stream per rank from (seed, rank), the
    counterpart of the reference's `split(fold_in(rng, 7), n)[rank]`."""
    return int(np.random.SeedSequence((seed, 7, rank)).generate_state(1)[0])


class ParallelLearner:
    """A Learner's update, data-parallel over the ranks of a process group.

    `learner.num_envs` is the GLOBAL batch and must divide by the world size;
    this rank's learner state, rollout and batch hold its `envs_per_device`
    envs (global indices `env_slice`). Advantages are normalised per shard,
    as inside the reference's `shard_map`."""

    def __init__(self, learner: Learner, group=None):
        if not dist.is_initialized():
            raise RuntimeError("ParallelLearner needs a process group: call "
                               "parallel.maybe_initialize_distributed() first")
        self.learner = learner
        self.group = group
        self.world_size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        if learner.num_envs % self.world_size != 0:
            raise ValueError(f"num_envs {learner.num_envs} not divisible by world size "
                             f"{self.world_size}")
        self.envs_per_device = learner.num_envs // self.world_size
        lo = self.rank * self.envs_per_device
        self.env_slice = slice(lo, lo + self.envs_per_device)

    def init(self, seed: int, env_state, obs: torch.Tensor) -> LearnerState:
        """This rank's LearnerState over its envs: rank 0's parameters
        (broadcast), a generator of its own (`rank_seed`)."""
        ls = self.learner.init(seed, env_state, obs)
        src = 0 if self.group is None else dist.get_global_rank(self.group, 0)
        with torch.no_grad():
            for v in ls.params.values():
                dist.broadcast(v, src=src, group=self.group)
        rng = torch.Generator(self.learner.device).manual_seed(rank_seed(seed, self.rank))
        return ls._replace(rng=rng)

    def pmean(self, tree: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Every tensor of `tree` averaged over the ranks (`jax.lax.pmean`):
        one all-reduce of the summed values per dtype, then / world size; the
        result is the same on every rank. Span: "megaverse.pmean"."""
        with span("megaverse.pmean"):
            groups: Dict[torch.dtype, list] = {}
            for k, v in tree.items():
                groups.setdefault(v.dtype, []).append(k)
            out = {}
            for keys in groups.values():
                flat = torch.cat([tree[k].detach().reshape(-1) for k in keys])
                dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=self.group)
                flat = flat / self.world_size
                offset = 0
                for k in keys:
                    n = tree[k].numel()
                    out[k] = flat[offset:offset + n].view_as(tree[k])
                    offset += n
            return out

    def collect_rollout(self, ls: LearnerState, next_scenes, shaping):
        return self.learner.collect_rollout(ls, next_scenes, shaping)

    def _update_from_batch(self, ls: LearnerState, batch: RolloutBatch):
        return self.learner._update_from_batch(ls, batch, pmean=self.pmean)
