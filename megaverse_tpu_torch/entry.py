"""Entry points of the port (counterpart of __graft_entry__.py).

- entry(): the forward step of the flagship model (ActorCritic: conv encoder,
  2-layer GRU core, 6 categorical action heads, value head) on a batch of 16
  observations.
- dryrun_multichip(n): data parallelism over n ranks (one process per
  device, `torch.distributed`): `VectorEnv` sampling sharded over the ranks
  must equal one process's bit for bit (Collect, and HexMemory with walking
  actions: rotated wall boxes, fused wall rows, PVS masks), then one
  sharded training step of the trainer's own task (rollout + PPO update with
  the gradients averaged over the ranks) must leave every replica's
  parameters bit-equal. The reference has no model parallelism to mirror:
  its scale-out is data parallelism over processes (SURVEY 2.3).

Both run on the card unless asked for the CPU (`device="cpu"`).
"""

from __future__ import annotations

import os
import tempfile
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from megaverse_tpu_torch import constants as C


def _device(device) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device; pass device='cpu' to run on the CPU")
        device = "cuda"
    return torch.device(device)


def entry(device=None):
    """(forward, (params, obs, carry)): the flagship policy's forward on 16
    zero frames, parameters from flax's initializers (seed 0)."""
    from torch.func import functional_call

    from megaverse_tpu_torch.models.actor_critic import ActorCritic

    dev = _device(device)
    model = ActorCritic(use_rnn=True).to(dev)
    model.reset_parameters(torch.Generator(dev).manual_seed(0))
    params = {k: v.detach().clone() for k, v in model.state_dict().items()}
    obs = torch.zeros((16, 72, 128, 3), dtype=torch.uint8, device=dev)
    carry = model.initial_carry((16,), dev)

    def forward(params, obs, carry):
        logits, value, new_carry = functional_call(model, params, (obs, carry))
        return logits, value, new_carry

    return forward, (params, obs, carry)


# ---------------------------------------------------------------------------
# Sharded sampling and training, rank by rank.
# ---------------------------------------------------------------------------

def sampling_actions(case: dict, step: int) -> np.ndarray:
    """Global int32 bitmask actions [B, A] of one sampling step: random
    (numpy seed of the case + step) or, with `walk`, forward while turning
    left (walls and culling then really run)."""
    shape = (case["num_envs"], case["num_agents"])
    if case.get("walk"):
        return np.full(shape, C.ACTION_FORWARD | C.ACTION_LOOK_LEFT, np.int32)
    rng = np.random.default_rng(case["seed"] + 1000 * step)
    return rng.integers(0, 2048, size=shape).astype(np.int32)


def _launches_since(before: dict) -> dict:
    from megaverse_tpu_torch.ops.raycast_cuda import LAUNCHES

    return {k: n - before[k] for k, n in LAUNCHES.items()}


def sample(case: dict, device, shard: Optional[tuple] = None) -> dict:
    """Reset + `steps` steps of a `VectorEnv` (this rank's shard of it with
    `shard=(rank, world_size)`): every frame, reward and done on the CPU, and
    the render kernel's launches meanwhile."""
    import dataclasses

    from megaverse_tpu_torch.ops.raycast_cuda import LAUNCHES
    from megaverse_tpu_torch.vector_env import VectorEnv

    before = dict(LAUNCHES)
    env = VectorEnv(case["name"], num_envs=case["num_envs"],
                    num_agents_per_env=case["num_agents"], seed=case["seed"],
                    device=device, shard=shard)
    try:
        if case.get("obs_height"):
            env.scenario.cfg = dataclasses.replace(env.scenario.cfg,
                                                   obs_height=case["obs_height"])
        lo, n = env.env_offset, env.num_envs
        frames = [env.reset().cpu()]
        rewards, dones = [], []
        for t in range(case["steps"]):
            obs, rew, done, _ = env.step(sampling_actions(case, t)[lo:lo + n])
            frames.append(obs.cpu())
            rewards.append(rew.cpu())
            dones.append(done.cpu())
        return {"obs": torch.stack(frames), "reward": torch.stack(rewards),
                "done": torch.stack(dones), "launches": _launches_since(before)}
    finally:
        env.close()


ALLREDUCE_REPEATS = 3


def train_step(spec: dict, device) -> dict:
    """One update of the trainer's task (`rl.train._Task`: this rank's envs'
    layouts, the learner behind `ParallelLearner` when there are several
    ranks): rollout + PPO update. Returns the parameters (CPU), the metrics,
    the rollout and update milliseconds, with several ranks the milliseconds
    of ALLREDUCE_REPEATS all-reduces of the gradients' size timed after the
    update, and the render kernel's launches."""
    from megaverse_tpu_torch.ops.raycast_cuda import LAUNCHES
    from megaverse_tpu_torch.parallel import world
    from megaverse_tpu_torch.rl import train as T
    from megaverse_tpu_torch.rl.learner import TrainConfig

    rank, world_size = world()
    args = T.parse_args(["--env", spec["name"], "--num_envs", str(spec["num_envs"]),
                         "--num_agents_per_env", str(spec["num_agents"]),
                         "--rollout", str(spec["rollout"]),
                         "--hidden_size", str(spec["hidden_size"])])
    cfg = TrainConfig(rollout=args.rollout, hidden_size=args.hidden_size)
    dev = torch.device(device)
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
    before = dict(LAUNCHES)
    t0 = time.perf_counter()
    task = T._Task(spec["name"], args, cfg, spec["seed"], dev, rank, world_size)
    try:
        sync()
        t1 = time.perf_counter()
        ls, batch = task.runner.collect_rollout(task.ls, task.next_scenes, task.shaping)
        sync()
        t2 = time.perf_counter()
        ls, metrics = task.runner._update_from_batch(ls, batch)
        sync()
        t3 = time.perf_counter()
        allreduce_ms = []
        if world_size > 1:
            # the update's all-reduce on its own: a tree of the gradients'
            # shapes and dtype, averaged over the ranks
            for _ in range(ALLREDUCE_REPEATS):
                t4 = time.perf_counter()
                task.runner.pmean(ls.params)
                sync()
                allreduce_ms.append(1e3 * (time.perf_counter() - t4))
    finally:
        task.close()
    return {"params": {k: v.cpu() for k, v in ls.params.items()},
            "metrics": {k: float(v) for k, v in metrics.items()},
            "setup_s": t1 - t0, "rollout_ms": 1e3 * (t2 - t1),
            "update_ms": 1e3 * (t3 - t2), "allreduce_ms": allreduce_ms,
            "envs": task.num_envs, "launches": _launches_since(before)}


def _dryrun_rank(rank: int, world_size: int, spec: dict) -> None:
    from megaverse_tpu_torch.parallel import maybe_initialize_distributed, shutdown_distributed

    device = torch.device(spec["devices"][rank])
    if device.type == "cpu":
        torch.set_num_threads(spec.get("threads", 1))
    else:
        torch.cuda.set_device(device)
    maybe_initialize_distributed(backend=spec.get("backend"), device=device)
    try:
        out = {case["label"]: sample(case, device, shard=(rank, world_size))
               for case in spec.get("sampling", ())}
        if spec.get("train"):
            out["train"] = train_step(spec["train"], device)
        torch.save(out, Path(spec["out_dir"]) / f"rank{rank}.pt")
    finally:
        shutdown_distributed()


def run_ranks(spec: dict) -> list:
    """Spawn one process per entry of spec["devices"] ("cuda:0", "cpu", ...),
    joined into one group (backend spec["backend"], or NCCL for cards and
    gloo for the CPU), each running spec["sampling"] (cases for `sample`,
    each with a "label") on its shard and spec["train"] (for `train_step`)
    if given. Returns each rank's outputs, in rank order."""
    from megaverse_tpu_torch.parallel import spawn

    n = len(spec["devices"])
    with tempfile.TemporaryDirectory() as tmp:
        spawn(_dryrun_rank, n, f"file://{os.path.join(tmp, 'init')}",
              args=(dict(spec, out_dir=tmp),))
        return [torch.load(os.path.join(tmp, f"rank{r}.pt")) for r in range(n)]


def gathered(outputs: list, label: str, key: str) -> torch.Tensor:
    """The ranks' `key` of sampling case `label`, joined along the env axis."""
    return torch.cat([o[label][key] for o in outputs], dim=1)


def replicas_equal(outputs: list) -> bool:
    """Every rank's parameters after the training step equal rank 0's, bit
    for bit."""
    p0 = outputs[0]["train"]["params"]
    return all(torch.equal(o["train"]["params"][k], v) for o in outputs[1:]
               for k, v in p0.items())


# dryrun_multichip's cases, as __graft_entry__.dryrun_multichip: one env per
# rank of each sampling case, two agents per rank's env in the training step.
DRYRUN_SAMPLING = (dict(label="collect", name="Collect", num_agents=1, seed=7, steps=3),
                   dict(label="hexmemory", name="HexMemory", num_agents=1, seed=13, steps=3,
                        walk=True))
DRYRUN_TRAIN = dict(name="Collect", num_agents=2, rollout=2, hidden_size=512, seed=42)


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """Spawn `n_devices` ranks, check sharded sampling against one process
    and the replicas after one training step. Raises AssertionError on any
    difference; returns what it measured. On CUDA rank r runs on cuda:r
    (NCCL), and fewer cards than ranks raise; device="cpu" puts every rank
    on the CPU (gloo).

    Cases: DRYRUN_SAMPLING (Collect n x 1 with random actions, HexMemory
    n x 1 walking, 3 steps each) and DRYRUN_TRAIN (a training step of
    Collect n x 2, rollout 2, hidden 512)."""
    dev = _device(device)
    if dev.type == "cuda":
        if torch.cuda.device_count() < n_devices:
            raise RuntimeError(f"dryrun_multichip({n_devices}): only "
                               f"{torch.cuda.device_count()} CUDA devices")
        devices = [f"cuda:{r}" for r in range(n_devices)]
    else:
        devices = [str(dev)] * n_devices
    sampling = [dict(case, num_envs=n_devices) for case in DRYRUN_SAMPLING]
    t0 = time.perf_counter()
    outputs = run_ranks(dict(devices=devices, sampling=sampling,
                             train=dict(DRYRUN_TRAIN, num_envs=n_devices)))
    report = {"ranks": n_devices, "devices": devices,
              "ranks_seconds": time.perf_counter() - t0, "sampling": {}}
    for case in sampling:
        t1 = time.perf_counter()
        single = sample(case, devices[0])
        for key in ("obs", "reward", "done"):
            if not torch.equal(gathered(outputs, case["label"], key), single[key]):
                raise AssertionError(f"dryrun_multichip: sharded {case['label']} {key} "
                                     "differs from one process's")
        report["sampling"][case["label"]] = {
            "frames": list(single["obs"].shape), "equal": True,
            "single_process_seconds": time.perf_counter() - t1}
    if not replicas_equal(outputs):
        raise AssertionError("dryrun_multichip: the replicas' parameters differ "
                             "after the update")
    report["train"] = {k: [o["train"][k] for o in outputs]
                       for k in ("setup_s", "rollout_ms", "update_ms", "allreduce_ms", "envs")}
    report["train"]["metrics"] = outputs[0]["train"]["metrics"]
    report["train"]["replicas_equal"] = True
    return report


if __name__ == "__main__":
    import argparse
    import json

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--n_devices", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    print(json.dumps(dryrun_multichip(a.n_devices, a.device)))
