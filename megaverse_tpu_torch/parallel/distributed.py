"""Multi-process initialisation (counterpart of
megaverse_tpu/parallel/distributed.py).

The reference scales across machines with slurm-launched Sample Factory
processes (SURVEY 2.3); the JAX package wires one process per host into one
runtime with `jax.distributed.initialize`. Here it is `torch.distributed`
with one process per device: NCCL between CUDA devices, gloo on the CPU.

Entry is gated by environment variables, so single-process use needs
nothing:

- `MEGAVERSE_COORDINATOR=host:port` (or a full init URL, `tcp://...` or
  `file://...`) + `MEGAVERSE_NUM_PROCESSES` + `MEGAVERSE_PROCESS_ID`:
  explicit wiring, as the reference reads them;
- `MEGAVERSE_DIST=1`: `env://`, i.e. torchrun's MASTER_ADDR, MASTER_PORT,
  WORLD_SIZE and RANK.

`rl/train.py --n_devices N` spawns its N ranks with `spawn`, which sets the
first three for each child.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

_initialized = False


def default_backend(device=None) -> str:
    """NCCL for a CUDA device (the default device when none is named and a
    GPU is present), gloo for the CPU."""
    if device is None:
        return "nccl" if torch.cuda.is_available() else "gloo"
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def maybe_initialize_distributed(backend: Optional[str] = None, device=None) -> bool:
    """Initialise the default process group when the environment variables
    ask for it. Idempotent. Returns True when running multi-process.

    `backend` overrides the choice by device (`default_backend`): two ranks
    that share one CUDA device need gloo, since NCCL refuses them."""
    global _initialized
    if _initialized or dist.is_initialized():
        _initialized = True
        return True
    backend = backend or default_backend(device)
    coord = os.environ.get("MEGAVERSE_COORDINATOR")
    if coord:
        dist.init_process_group(
            backend, init_method=coord if "://" in coord else f"tcp://{coord}",
            world_size=int(os.environ["MEGAVERSE_NUM_PROCESSES"]),
            rank=int(os.environ["MEGAVERSE_PROCESS_ID"]))
        _initialized = True
        return True
    if os.environ.get("MEGAVERSE_DIST"):
        dist.init_process_group(backend, init_method="env://")
        _initialized = True
        return True
    return False


def shutdown_distributed() -> None:
    global _initialized
    if dist.is_initialized():
        dist.destroy_process_group()
    _initialized = False


def world() -> tuple:
    """(rank, world size) of this process; (0, 1) without a process group."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def _rank_entry(rank: int, fn, world_size: int, init_method: str, args) -> None:
    os.environ["MEGAVERSE_COORDINATOR"] = init_method
    os.environ["MEGAVERSE_NUM_PROCESSES"] = str(world_size)
    os.environ["MEGAVERSE_PROCESS_ID"] = str(rank)
    fn(rank, world_size, *args)


def spawn(fn, world_size: int, init_method: str, args=()) -> None:
    """Run fn(rank, world_size, *args) in `world_size` new processes (start
    method "spawn": fresh interpreters that import only what `fn`'s module
    imports), with the MEGAVERSE_COORDINATOR variables set so that
    `maybe_initialize_distributed` in `fn` joins them into one group at
    `init_method` (`file://<path>` of a file that does not exist yet, or
    `tcp://host:port`). Waits for all; raises if any fails. `fn` must be a
    module-level function."""
    import torch.multiprocessing as mp

    mp.start_processes(_rank_entry, args=(fn, world_size, init_method, tuple(args)),
                       nprocs=world_size, join=True, start_method="spawn")
