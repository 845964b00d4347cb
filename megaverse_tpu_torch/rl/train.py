"""APPO-style training CLI (counterpart of megaverse_tpu/rl/train.py).

Equivalent of megaverse_rl/train_megaverse.py (Sample Factory run_rl): one
process drives the whole pipeline on one card: batched env rollouts (physics
and the render kernel, observations kept on the device) and PPO updates, with
host-side layout generation refilling the auto-reset buffer between rollouts.

Includes the reference integration features: team-spirit annealing 0 -> 1
over max_team_spirit_steps via the runtime reward-shaping API
(megaverse_rl/megaverse_utils.py:75-84), reward-shaping overrides, multitask
round-robin over one shared policy, checkpoints and resume.

Usage:
  python -m megaverse_tpu_torch.rl.train --env Collect --num_envs 512 \\
      --train_for_env_steps 1000000 --num_agents_per_env 2

Runs on the GPU; `--device cpu` runs it on the CPU (the renderer then takes
the kernel's plain PyTorch version). At the end it writes the checkpoint and
`train_summary.json` (rates; per-update rollout and update times, device ms
from CUDA events on a card, host ms on the CPU, with no synchronise of their
own; the update loop's spans, `utils/logging.span`, as host seconds and
calls; last metrics) into <train_dir>/<experiment>.

Data parallel (megaverse_tpu_torch/parallel): `--n_devices N` spawns N
ranks, rank r on cuda:r (or on the CPU with `--device cpu`; gloo there, NCCL
between cards), each holding num_envs / N of the envs: it generates only its
envs' layouts (its slice of the global seed sequence) and refills only its
own envs; the gradients are averaged over the ranks each update and rank 0
writes the checkpoint and the summary. A process started by an outside
launcher with the MEGAVERSE_COORDINATOR variables (or MEGAVERSE_DIST=1 and
torchrun's) runs as its rank of that group instead of spawning.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import sys
import tempfile
import time
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from megaverse_tpu_torch import constants as C
from megaverse_tpu_torch.convert import actor_critic_from_flax
from megaverse_tpu_torch.env import render_batch
from megaverse_tpu_torch.parallel import (
    ParallelLearner,
    maybe_initialize_distributed,
    shutdown_distributed,
    spawn,
    world,
)
from megaverse_tpu_torch.rl.checkpoint import is_port_opt_state, load_checkpoint, save_checkpoint
from megaverse_tpu_torch.rl.learner import Learner, TrainConfig, opt_state_from_numpy
from megaverse_tpu_torch.scenarios import make_scenario
from megaverse_tpu_torch.types import (scene_to_device, stack_scenes, state_from_scene,
                                       tree_map, tree_scatter_)
from megaverse_tpu_torch.utils.logging import IntervalTimer, span, tprof
from megaverse_tpu_torch.vector_env import refill_slot_rung


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--env", default="Empty", help="scenario name")
    p.add_argument("--num_envs", type=int, default=256)
    p.add_argument("--megaverse_num_agents_per_env", "--num_agents_per_env",
                   dest="num_agents_per_env", type=int, default=1)
    p.add_argument("--train_for_env_steps", type=float, default=1e6)
    p.add_argument("--rollout", type=int, default=32)
    p.add_argument("--hidden_size", type=int, default=512)
    p.add_argument("--use_rnn", type=int, default=1)
    p.add_argument("--rnn_num_layers", type=int, default=2)
    p.add_argument("--reward_clip", type=float, default=30.0,
                   help="clamp |reward| before the PPO update; 0 disables")
    p.add_argument("--max_grad_norm", type=float, default=4.0,
                   help="global grad-norm clip; 0 disables (reference runs)")
    p.add_argument("--learning_rate", type=float, default=1e-4)
    p.add_argument("--lr_final", type=float, default=-1.0,
                   help=">=0: linear lr decay to this value over the run")
    p.add_argument("--exploration_coeff", type=float, default=0.001)
    p.add_argument("--exploration_final", type=float, default=-1.0,
                   help=">=0: anneal the exploration coefficient to this "
                        "value with training progress")
    p.add_argument("--ppo_epochs", type=int, default=1,
                   help="PPO epochs over each rollout (SF --ppo_epochs)")
    p.add_argument("--num_minibatches", type=int, default=1,
                   help="env-axis minibatches per epoch")
    p.add_argument("--gamma", type=float, default=0.997)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a GPU) or cpu")
    p.add_argument("--n_devices", type=int, default=None,
                   help="ranks (one per device) to shard the env batch over; "
                        "num_envs must divide by it")
    p.add_argument("--train_dir",
                   default=os.path.join(tempfile.gettempdir(), "megaverse_tpu_torch_train"))
    p.add_argument("--experiment", default="default")
    p.add_argument("--save_every_steps", type=float, default=5e5)
    p.add_argument("--restart_behavior", choices=["resume", "restart"],
                   default="resume",
                   help="resume: restore checkpoint.pkl if present (Sample "
                        "Factory --restart_behavior); restart: train fresh")
    # team spirit annealing (megaverse_params.py:41-55)
    p.add_argument("--megaverse_increase_team_spirit", type=int, default=0)
    p.add_argument("--megaverse_max_team_spirit_steps", type=float, default=1e9)
    p.add_argument("--set_shaping", action="append", default=[],
                   metavar="KEY=VALUE",
                   help="override a reward-shaping weight for training "
                        "(repeatable). Uses the runtime-mutable shaping API "
                        "the reference exposes for PBT "
                        "(scenario.hpp:209-215, megaverse_utils.py:80-84); "
                        "evaluation keeps scenario defaults.")
    return p.parse_args(argv)


def resolve_device(name: str, rank: int = 0, world_size: int = 1) -> torch.device:
    """The device of this rank: `name`, and with several ranks on CUDA the
    rank's own card (LOCAL_RANK when a launcher sets it); a rank without a
    card of its own raises (NCCL refuses two ranks on one card)."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("training runs on a CUDA device by default and none is "
                           "available; pass --device cpu to run on the CPU")
    if device.type == "cuda" and world_size > 1:
        local = int(os.environ.get("LOCAL_RANK", rank))
        if local >= torch.cuda.device_count():
            raise RuntimeError(f"rank {rank} (local rank {local}) has no card of its own: "
                               f"{torch.cuda.device_count()} CUDA devices")
        device = torch.device("cuda", local)
    return device


def _initial_layouts(name: str, num_agents: int, seed: int, num_envs: int, ids):
    """The layout streams of a task's envs `ids` (global indices of its
    `num_envs`; one numpy generator per env, spawned from `seed`) and each
    env's first two layouts, made on the host: (generators advanced past
    them, first layouts, next layouts), the layouts stacked. Each env's
    stream is its own, so any split of `ids` gives the same layouts."""
    scenario = make_scenario(name, num_agents=num_agents)
    ids = list(ids)
    every = np.random.SeedSequence(seed).spawn(num_envs)
    gens = [np.random.Generator(np.random.PCG64(every[i])) for i in ids]
    first = [scenario.generate_checked(g) for g in gens]
    following = [scenario.generate_checked(g) for g in gens]
    return gens, stack_scenes(first), stack_scenes(following)


# A leaf of at least this many bytes crosses from a setup worker as its
# nonzeros alone (flat indices and values) where that halves its bytes: the
# voxel grids (vterrain, vobj: ObstaclesHard's are 2 MB per env) are almost
# empty, and a process pool's pipe moves a few hundred MB/s.
_SPARSE_MIN_BYTES = 1 << 20


def _sparse_pack(batch):
    """A stacked host batch -> (the batch with its large, mostly-zero leaves
    cut to length 0, one entry per leaf: (shape, flat indices, values) of a
    cut leaf's nonzeros, None for the others)."""
    entries = []

    def pack(x):
        flat = x.reshape(-1)
        idx = np.flatnonzero(flat) if x.nbytes >= _SPARSE_MIN_BYTES else None
        if idx is None or len(idx) * (idx.itemsize + x.itemsize) > x.nbytes // 2:
            entries.append(None)
            return x
        entries.append((x.shape, idx, flat[idx]))
        return x[:0]

    return tree_map(pack, batch), entries


def _sparse_unpack(batch, entries):
    """_sparse_pack's inverse."""
    it = iter(entries)

    def unpack(x):
        entry = next(it)
        if entry is None:
            return x
        shape, idx, values = entry
        out = np.zeros(shape, x.dtype)
        out.reshape(-1)[idx] = values
        return out

    return tree_map(unpack, batch)


def _initial_layouts_packed(name: str, num_agents: int, seed: int, num_envs: int, ids):
    """_initial_layouts in a setup worker process, its layouts sparse-packed
    for the way back."""
    gens, first, following = _initial_layouts(name, num_agents, seed, num_envs, ids)
    return gens, _sparse_pack(first), _sparse_pack(following)


def _first_layouts(names, args, rank: int = 0, world_size: int = 1, workers=None):
    """_initial_layouts of every task of `names` (task i seeded with
    `args.seed + 1000 * i`) for this rank's envs. With `workers` above 1 (by
    default one per CPU core when there is more than one task, else none)
    they are made in that many worker processes, each task's envs split into
    one slice per worker; the layouts and the generators' states equal the
    serial path's."""
    seeds = [args.seed + 1000 * i for i in range(len(names))]
    agents = args.num_agents_per_env
    if workers is None:
        workers = len(os.sched_getaffinity(0)) if len(names) > 1 else 0
    n = args.num_envs // world_size
    ids = range(rank * n, (rank + 1) * n)
    if workers <= 1:
        return [_initial_layouts(name, agents, seed, args.num_envs, ids)
                for name, seed in zip(names, seeds)]
    from megaverse_tpu_torch.utils import native
    native.have_native()    # built once here, not by every worker at once
    slices = [s.tolist() for s in np.array_split(np.asarray(ids), workers) if len(s)]
    # spawned, not forked: the parent may hold a CUDA context
    with ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn")) as pool:
        jobs = [[pool.submit(_initial_layouts_packed, name, agents, seed, args.num_envs, s)
                 for s in slices] for name, seed in zip(names, seeds)]
        out = []
        for task in jobs:
            parts = [f.result() for f in task]
            batches = [[_sparse_unpack(*p[k]) for p in parts] for k in (1, 2)]
            out.append((sum((p[0] for p in parts), []),
                        *(tree_map(lambda *xs: np.concatenate(xs), *b) for b in batches)))
        return out


def _make_tasks(names, args, cfg: TrainConfig, device: torch.device, rank: int = 0,
                world_size: int = 1, workers=None):
    """(one _Task per scenario of `names`, task i seeded with
    `args.seed + 1000 * i`; the seconds their first layouts took). `workers`:
    see _first_layouts."""
    t0 = time.perf_counter()
    initial = _first_layouts(names, args, rank, world_size, workers)
    layout_seconds = time.perf_counter() - t0
    # the tasks tick in turn, never concurrently: their tick graphs share one
    # memory pool
    pool = torch.cuda.graph_pool_handle() if device.type == "cuda" else None
    tasks = []
    while initial:      # each task's host layouts go once they are on the device
        i = len(tasks)
        tasks.append(_Task(names[i], args, cfg, args.seed + 1000 * i, device, rank, world_size,
                           initial.pop(0), graph_pool=pool))
    return tasks, layout_seconds


class _Task:
    """One scenario's env batch, generators and learner state.

    Multitask training keeps one _Task per scenario; the policy and optimizer
    state are shared and round-robined across tasks: the analogue of the
    reference multitask factory assigning one task per Sample Factory worker
    while a single learner updates shared weights
    (megaverse/megaverse_env.py:27-39, train_megaverse.py:32-42).
    """

    def __init__(self, name: str, args, cfg: TrainConfig, seed: int, device: torch.device,
                 rank: int = 0, world_size: int = 1, initial=None, graph_pool=None):
        self.name = name
        self.scenario = make_scenario(name, num_agents=args.num_agents_per_env)
        if args.num_envs % world_size:
            raise ValueError(f"--num_envs {args.num_envs} does not divide over "
                             f"{world_size} ranks")
        # this rank's envs: global indices lo .. lo + num_envs - 1
        self.num_envs = args.num_envs // world_size
        lo = rank * self.num_envs
        self.cfg = cfg
        self.device = device
        self._segments = self.scenario.cfg.prop_segments
        self._hw_boxes = 0
        self._hw_props = [0] * len(self._segments) if self._segments else 0

        # each env's layout stream is keyed by its global index; `initial`
        # is what _initial_layouts returns for these envs (_first_layouts)
        if initial is None:
            initial = _initial_layouts(name, args.num_agents_per_env, seed, args.num_envs,
                                       range(lo, lo + self.num_envs))
        self.gens, first, following = initial
        for batch in (first, following):
            self._note_high_water(batch)
        first = scene_to_device(first, device)
        self.next_scenes = scene_to_device(following, device)
        # Render-table bucket (see env.render_batch): 1.5x headroom over the
        # initial high-water mark; rebuilt when a later layout exceeds it.
        self.bucket = self._bucket_for(margin=1.5)
        self.learner = Learner(self.scenario, args.num_envs, cfg, render_bucket=self.bucket,
                               device=device, graph_pool=graph_pool)
        # the learner's rollout and update, data-parallel over the ranks
        self.runner = ParallelLearner(self.learner) if world_size > 1 else self.learner
        rng = torch.arange(lo, lo + self.num_envs, dtype=torch.int64, device=device) \
            + (seed << 20)
        env_state = state_from_scene(first, args.num_agents_per_env, rng)
        obs = render_batch(self.scenario, env_state, fmt="packed", bucket=self.bucket,
                           mode=self.learner.render_mode)
        self.ls = self.runner.init(seed, env_state, obs)
        self.shaping = torch.from_numpy(np.tile(
            self.scenario.shaping_array()[None], (self.num_envs, 1, 1))).to(device)
        self.spirit_col = self.scenario.all_shaping_keys.index(C.P_TEAM_SPIRIT)
        # The asynchronous refill generates the layouts of the envs that reset
        # during rollout k while rollout k+1 runs, and lands them before rollout
        # k+2: safe only while no env can finish twice in that window. Shorter
        # episodes take the synchronous refill (as VectorEnv.step_many guards
        # its overlap).
        min_ep_steps = int(float(self.scenario.cfg.params.get(C.P_EPISODE_LENGTH_SEC, 60.0))
                           / self.scenario.cfg.dt)
        self.async_refill = min_ep_steps >= 3 * cfg.rollout
        self._pool = None
        self._pending = None

    def _bucket_for(self, margin: float):
        roundup = lambda n, q: ((max(int(n), 1) + q - 1) // q) * q
        if self._segments:
            # segmented prop tables (see render_batch): per-segment counts
            pb = tuple(roundup(n * margin, 4) for n in self._hw_props)
        else:
            pb = roundup(self._hw_props * margin, 4)
        return (roundup(self._hw_boxes * margin, 4), pb)

    def _bucket_grew(self) -> bool:
        if self._hw_boxes > self.bucket[0]:
            return True
        if self._segments:
            return any(n > b for n, b in zip(self._hw_props, self.bucket[1]))
        return self._hw_props > self.bucket[1]

    def _note_high_water(self, batch) -> None:
        """Raise the high-water marks of live box and prop rows to a stacked
        host batch's."""
        most = lambda live: int(live.sum(axis=1).max())
        self._hw_boxes = max(self._hw_boxes, most(np.asarray(batch.box_color) > 0))
        live = np.asarray(batch.props.type) != C.PROP_NONE
        if self._segments:
            for i, (_, start, cap) in enumerate(self._segments):
                self._hw_props[i] = max(self._hw_props[i], most(live[:, start:start + cap]))
        else:
            self._hw_props = max(self._hw_props, most(live))

    def _generate(self, idx, pad_to: int = 0):
        """Layouts for envs `idx`, stacked on the host (no device calls: it
        also runs on the refill thread)."""
        batch = stack_scenes([self.scenario.generate_checked(self.gens[i]) for i in idx],
                             pad_to=pad_to)
        self._note_high_water(batch)
        return batch

    def refill(self) -> None:
        """Regenerate the buffered layouts of the envs that reset during the
        last rollout (they consumed theirs: num_frames < rollout). Each env's
        generator stream advances only when its slot refills, so layouts are
        deterministic given the same reset pattern."""
        with span("megaverse.refill"):
            if self._pending is not None:
                # the previous rollout's asynchronous generation
                with span("megaverse.refill.wait"):
                    idx, batch = self._pending.result()
                self._pending = None
                self._apply_refill(idx, batch)
            with span("megaverse.refill.poll"):
                nf = self.ls.env_state.num_frames.cpu().numpy()
            idx = np.nonzero(nf < self.cfg.rollout)[0].tolist()
            if not idx:
                return
            slots = refill_slot_rung(len(idx), self.num_envs)
            if not self.async_refill:
                with span("megaverse.refill.wait"):
                    batch = self._generate(idx, pad_to=slots)
                self._apply_refill(idx, batch)
                return
            if self._pool is None:
                # one worker: per-env generator streams advance in submission order
                self._pool = ThreadPoolExecutor(1, thread_name_prefix=f"gen-{self.name}")
            self._pending = self._pool.submit(
                lambda: (idx, self._generate(idx, pad_to=slots)))

    def _apply_refill(self, idx, batch) -> None:
        # fixed slot ladder, padded host-side; the sentinel rows (index
        # num_envs) are dropped by the scatter
        n = len(idx)
        slots = refill_slot_rung(n, self.num_envs)
        slot_idx = np.concatenate([np.asarray(idx, np.int64),
                                   np.full((slots - n,), self.num_envs, np.int64)])
        # in place: the learner's tick graphs hold these buffers
        with span("megaverse.refill.upload"):
            tree_scatter_(self.next_scenes, slot_idx,
                          scene_to_device(batch, self.device, non_blocking=True))
        if self._bucket_grew():
            self.bucket = self._bucket_for(margin=1.5)
            self.learner.render_bucket = self.bucket
            print(f"[{self.name}] render bucket grew to {self.bucket}", flush=True)

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=True, cancel_futures=True)
            self._pool = None


def resolve_task_list(env_name: str):
    """'multitask_megaverse8' / 'multitask_obstacles' -> task list, else [env]."""
    if "multitask" not in env_name:
        return [env_name]
    from megaverse_tpu_torch.gym_env import MEGAVERSE8, OBSTACLES_MULTITASK

    if env_name.endswith("megaverse8"):
        return list(MEGAVERSE8)
    if env_name.endswith("obstacles"):
        return list(OBSTACLES_MULTITASK)
    raise NotImplementedError(env_name)


def main(argv=None, observer=None):
    """Train as the command line says. `observer(it, tasks, metrics)`, if
    given, is called once after setup (it 0, metrics None) and after every
    update (`it` updates done, the last one on `tasks[(it - 1) % len(tasks)]`)
    with the _Task list; it must not change them. Not with spawned ranks."""
    args = parse_args(argv)
    n = args.n_devices or 1
    launched = bool(os.environ.get("MEGAVERSE_COORDINATOR") or os.environ.get("MEGAVERSE_DIST"))
    if n > 1 and not launched:
        if observer is not None:
            raise ValueError("an observer needs the ranks in this process")
        if args.num_envs % n:
            raise ValueError(f"--num_envs {args.num_envs} does not divide over {n} devices")
        if torch.device(args.device).type == "cuda":
            have = torch.cuda.device_count() if torch.cuda.is_available() else 0
            if have < n:
                raise RuntimeError(f"--n_devices {n}: only {have} CUDA devices")
        out_dir = Path(args.train_dir) / args.experiment
        out_dir.mkdir(parents=True, exist_ok=True)
        # the ranks meet at a file that does not exist yet (no port to pick)
        init = out_dir / f".dist_init_{os.getpid()}_{time.time_ns()}"
        try:
            spawn(_rank_main, n, f"file://{init}",
                  args=(sys.argv[1:] if argv is None else argv,))
        finally:
            init.unlink(missing_ok=True)
        return 0
    return _run(args, observer)


def _rank_main(rank: int, world_size: int, argv) -> None:
    try:
        if _run(parse_args(argv)) != 0:
            raise RuntimeError(f"rank {rank} failed")
    finally:
        shutdown_distributed()


def _run(args, observer=None) -> int:
    maybe_initialize_distributed(device=args.device)
    rank, world_size = world()
    if args.n_devices and world_size != args.n_devices:
        raise RuntimeError(f"--n_devices {args.n_devices}, but the process group has "
                           f"{world_size} ranks")
    device = resolve_device(args.device, rank, world_size)
    if device.type == "cuda" and world_size > 1:
        torch.cuda.set_device(device)
    num_envs = args.num_envs
    cfg = TrainConfig(rollout=args.rollout, lr=args.learning_rate,
                      gamma=args.gamma, hidden_size=args.hidden_size,
                      use_rnn=bool(args.use_rnn),
                      rnn_num_layers=args.rnn_num_layers,
                      reward_clip=args.reward_clip,
                      max_grad_norm=args.max_grad_norm,
                      num_epochs=args.ppo_epochs,
                      num_minibatches=args.num_minibatches,
                      exploration_coeff=args.exploration_coeff,
                      lr_final=args.lr_final,
                      exploration_final=args.exploration_final,
                      total_env_steps=float(args.train_for_env_steps))

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t_setup = time.perf_counter()
    tasks, layout_seconds = _make_tasks(resolve_task_list(args.env), args, cfg, device, rank,
                                        world_size)
    try:
        return _train(args, cfg, tasks, device, num_envs, time.perf_counter() - t_setup,
                      lead=rank == 0, observer=observer, layout_seconds=layout_seconds)
    finally:
        for t in tasks:
            t.close()


def _train(args, cfg: TrainConfig, tasks, device, num_envs: int, setup_seconds: float,
           lead: bool = True, observer=None, layout_seconds=None):
    """The update loop. `num_envs` is the global batch; `lead` (rank 0)
    prints, checkpoints and writes the summary."""
    log = print if lead else (lambda *a, **k: None)
    for spec in args.set_shaping:
        key, _, val = spec.partition("=")
        for t in tasks:
            if key in t.scenario.all_shaping_keys:
                t.shaping[:, :, t.scenario.all_shaping_keys.index(key)].fill_(float(val))
                log(f"[shaping] {t.name}: {key} = {float(val)}", flush=True)
            else:
                log(f"[shaping] {t.name} has no key {key!r}; skipped", flush=True)
    # Policy weights and optimizer state are shared across tasks.
    params, opt_state = tasks[0].ls.params, tasks[0].ls.opt_state

    out_dir = Path(args.train_dir) / args.experiment
    out_dir.mkdir(parents=True, exist_ok=True)
    total = int(args.train_for_env_steps)
    steps_done = 0
    ckpt_path = out_dir / "checkpoint.pkl"
    if args.restart_behavior == "resume" and ckpt_path.exists():
        ckpt = load_checkpoint(ckpt_path)
        if not is_port_opt_state(ckpt["opt_state"]):
            raise ValueError(f"{ckpt_path} holds optax's optimizer state (a checkpoint "
                             "of the JAX package): resume needs the port's own")
        params = {k: v.to(device) for k, v in actor_critic_from_flax(ckpt["params"]).items()}
        opt_state = opt_state_from_numpy(ckpt["opt_state"], device)
        steps_done = int(ckpt["steps"])
        log(f"resumed from {ckpt_path} at {steps_done:,} env steps", flush=True)
    last_save = steps_done
    start_steps = steps_done
    memory_after_setup = setup_peak = None
    if device.type == "cuda":
        memory_after_setup = torch.cuda.memory_allocated(device)
        setup_peak = torch.cuda.max_memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    if observer is not None:
        observer(0, tasks, None)
    # rollout and update times: device ms (CUDA events) on a card, host ms on
    # the CPU, read at the log interval and at the end
    timer = IntervalTimer(device)
    spans_before = tprof().totals()
    metrics, task_metrics = {}, {}
    t0 = time.perf_counter()
    it = 0
    while steps_done < total:
        task = tasks[it % len(tasks)]
        ls = task.ls._replace(params=params, opt_state=opt_state)
        t_start = timer.stamp()
        ls, batch = task.runner.collect_rollout(ls, task.next_scenes, task.shaping)
        t_mid = timer.stamp()
        ls, metrics = task.runner._update_from_batch(ls, batch)
        t_end = timer.stamp()
        timer.add("rollout", t_start, t_mid)
        timer.add("update", t_mid, t_end)
        task.ls = ls
        task_metrics[task.name] = metrics
        params, opt_state = ls.params, ls.opt_state
        steps_done += cfg.rollout * num_envs
        it += 1
        task.refill()

        # team spirit annealing (megaverse_utils.py:75-84)
        if args.megaverse_increase_team_spirit:
            frac = min(1.0, steps_done / args.megaverse_max_team_spirit_steps)
            for t in tasks:
                t.shaping[:, :, t.spirit_col].fill_(frac)
        if observer is not None:
            observer(it, tasks, metrics)

        if it % 10 == 0:
            ms = timer.read()
            m = {k: float(v) for k, v in metrics.items()}
            sps = (steps_done - start_steps) / (time.perf_counter() - t0)
            log(f"steps {steps_done:,}  {sps:,.0f} env-steps/s  "
                f"task {task.name}  loss {m['loss']:.4f}  "
                f"reward {m['reward_mean']:.4f}  entropy {m['entropy']:.3f}  "
                f"rollout {ms['rollout'][-1]:.1f} ms  update {ms['update'][-1]:.1f} ms",
                flush=True)

        if steps_done - last_save >= args.save_every_steps:
            last_save = steps_done
            if lead:
                save_checkpoint(ckpt_path, params, opt_state, steps_done)
            log(f"saved checkpoint at {steps_done:,} steps", flush=True)

    ms = timer.read()
    seconds = time.perf_counter() - t0
    if steps_done > last_save and lead:
        save_checkpoint(ckpt_path, params, opt_state, steps_done)
        log(f"saved checkpoint at {steps_done:,} steps", flush=True)
    if not lead:
        return 0
    trained = steps_done - start_steps
    agents = args.num_agents_per_env
    summary = {
        "env": args.env, "num_envs": num_envs, "num_agents_per_env": agents,
        "n_devices": world()[1],
        "rollout": cfg.rollout, "hidden_size": cfg.hidden_size, "device": str(device),
        "updates": it, "env_steps": trained, "steps_done": steps_done,
        "setup_seconds": setup_seconds, "seconds": seconds,
        # of setup: the tasks' first layouts, made on the host
        "layout_seconds": layout_seconds,
        # env steps count every env once per tick; samples every agent
        "env_steps_per_s": trained / seconds if seconds > 0 else None,
        "samples_per_s": trained * agents / seconds if seconds > 0 else None,
        # update it ran tasks[it % len(tasks)]
        "tasks": [t.name for t in tasks],
        "rollout_ms": ms["rollout"], "update_ms": ms["update"],
        # the update loop's spans (utils/logging.span): host seconds and calls
        "spans": {name: {"seconds": sec, "calls": n}
                  for name, (sec, n) in tprof().totals(since=spans_before).items()},
        "device_memory_after_setup_bytes": memory_after_setup,
        "setup_peak_device_memory_bytes": setup_peak,
        # of the update loop alone
        "peak_device_memory_bytes": (torch.cuda.max_memory_allocated(device)
                                     if device.type == "cuda" else None),
        "metrics": {k: float(v) for k, v in metrics.items()},
        # each task's metrics at its last update
        "task_metrics": {name: {k: float(v) for k, v in m.items()}
                         for name, m in task_metrics.items()},
    }
    (out_dir / "train_summary.json").write_text(json.dumps(summary, indent=1))
    log(f"done: {steps_done:,} env steps in {seconds:.1f}s", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
