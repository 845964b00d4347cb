"""Shared helpers of the benchmark's CPU tests: a cell at a size a test run
can hold, run on the CPU through the harness with the chip check skipped.
Its Collect episodes last 13-16 steps on both sides (`short_episodes`), so
that they end in the window's first chunk or iteration, which every window
holds however slow the CPU."""

from __future__ import annotations

import sys
import types

import numpy as np
import torch

import harness as H
import run as R

SMALL = {
    "sampler.collect_1024x1": {
        "traffic": dict(num_envs=2, check_envs=2, warmup_chunks=3, chunk_steps=4,
                        check_within_chunks=1, check_chunks=1, check_done_envs=1,
                        check_done_within_chunks=1, profile_from_chunk=0, profile_chunks=1)},
    "appo.collect_1024x1": {
        "traffic": dict(num_envs=2, check_envs=2, layout_workers=0, check_frames=1,
                        check_done_envs=1, check_done_within_iterations=1,
                        warmup_iterations=3, profile_from_iteration=0),
        "config": dict(hidden_size=32, rollout=4)},
}


def short_episodes(rank: int) -> None:
    """Collect's layouts, the program's and the reference's alike, with
    episodes of 0.85-1.0 s (13-16 steps, after the 12 of the small cells'
    warm-up) in place of a minute or more; still long enough that no env
    ends twice before its slot is refilled."""
    import megaverse_tpu_torch.scenarios.base as program_base
    from reference.sim.scenarios import base as reference_base

    for base in (program_base, reference_base):
        real = base.Scenario.generate_checked
        if getattr(real, "short_episodes", False):
            continue

        def generate_checked(self, rng, *args, _real=real, **kw):
            scene = _real(self, rng, *args, **kw)
            length = 0.85 + 0.05 * ((int(scene.episode_len_sec) // 2) % 4)
            return scene.replace(episode_len_sec=np.float32(length))
        generate_checked.short_episodes = True
        base.Scenario.generate_checked = generate_checked


def jax_on_rank_1(rank: int) -> None:
    """short_episodes, and a module named `jax` loaded in rank 1 alone."""
    short_episodes(rank)
    if rank == 1:
        sys.modules["jax"] = types.ModuleType("jax")


def small_cell(name: str) -> "H.Cell":
    cell = H.Cell(H.load_benchmark(), name)
    for part, values in SMALL[name].items():
        getattr(cell, part).update(values)
    return cell


def run_small(name: str, seed: int, control: bool = False, fault: str = None,
              seconds: float = 0.05, ranks: int = 0, prepare=short_episodes) -> dict:
    """A run of cell `name` at the small size on the CPU (several ranks as
    gloo processes; `ranks` overrides the cell's chips); its result."""
    torch.set_num_threads(2)
    cell = small_cell(name)
    if ranks:
        cell.chips = ranks
    return R.run_cell(cell, seed, seconds, 0, device_type="cpu", control=control,
                      fault=fault, overrides=SMALL[name], prepare=prepare)
