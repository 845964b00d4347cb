"""Masked row copy: the deferred auto-reset's device half.

For every env whose `done` flag is set, copy its rows of a list of source
tensors into the matching destination tensors, in place. The deferred reset
(`env.apply_deferred_resets`) uses it for the layout-copy leaves of the state
(grids, box and prop tables): the counterpart of the reference's K-slot
gather/scatter under `lax.cond` (megaverse_tpu/env.py apply_deferred_resets).

On a CUDA tensor `masked_copy_` launches the hand-written kernel of
csrc/masked_copy.cu (built at first use, bound with ctypes, like the render
kernel): one launch covers every leaf, one wave of blocks strides over the
(env, 64 KB chunk of a row) items, and a round of items whose envs are not
done ends after one parallel read of their flags, so the bytes moved follow
the envs that finished, a done env's rows spread over all SMs, and the choice
needs no read on the host. On the CPU it takes the plain version,
`masked_copy_plain_`: the inline select (`torch.where`) per leaf.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import Sequence

import torch

# `masked_copy_` adds one to LAUNCHES["masked_copy"] where it launches the kernel.
from megaverse_tpu_torch.ops.raycast_cuda import CSRC_DIR, LAUNCHES, build_library

_lib = None
_lib_lock = threading.Lock()


def load_library():
    """Build (first use) and bind csrc/masked_copy.cu. Raises on failure."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build_library(CSRC_DIR / "masked_copy.cu")))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.mv_masked_copy.restype = i
        lib.mv_masked_copy.argtypes = [i, p, p, p, p, i, i, p]
        lib.mv_masked_copy_max_leaves.restype = i
        _lib = lib
        return _lib


# blocks per SM of the kernel's one wave (NTHREADS = 256 threads each)
BLOCKS_PER_SM = 8


@functools.lru_cache(maxsize=None)
def _grid_blocks(device_index: int) -> int:
    return BLOCKS_PER_SM * torch.cuda.get_device_properties(device_index).multi_processor_count


def _check(dsts: Sequence[torch.Tensor], srcs: Sequence[torch.Tensor],
           done: torch.Tensor) -> None:
    if len(dsts) != len(srcs):
        raise ValueError(f"{len(dsts)} destinations, {len(srcs)} sources")
    if done.dtype != torch.bool or done.dim() != 1:
        raise ValueError(f"done: bool [B] expected, got {done.dtype} {tuple(done.shape)}")
    for i, (d, s) in enumerate(zip(dsts, srcs)):
        if d.shape != s.shape or d.dtype != s.dtype or d.shape[0] != done.shape[0]:
            raise ValueError(f"leaf {i}: dst {d.dtype} {tuple(d.shape)}, src {s.dtype} "
                             f"{tuple(s.shape)}, done [{done.shape[0]}]")


def masked_copy_plain_(dsts: Sequence[torch.Tensor], srcs: Sequence[torch.Tensor],
                       done: torch.Tensor) -> None:
    """Plain version of `masked_copy_` (any device): dst = where(done, src,
    dst) per leaf, written back into dst."""
    _check(dsts, srcs, done)
    for d, s in zip(dsts, srcs):
        p = done.reshape(done.shape + (1,) * (d.dim() - 1))
        d.copy_(torch.where(p, s, d))


def masked_copy_(dsts: Sequence[torch.Tensor], srcs: Sequence[torch.Tensor],
                 done: torch.Tensor) -> None:
    """For every b with done[b], dst[b] = src[b] for each (dst, src) pair
    (same shape [B, ...] and dtype); in place. CUDA tensors launch the
    kernel (raising on failure), CPU tensors take the plain version."""
    if done.device.type != "cuda":
        masked_copy_plain_(dsts, srcs, done)
        return
    _check(dsts, srcs, done)
    dev = done.device
    for i, x in enumerate((*dsts, *srcs)):
        if x.device != dev or not x.is_contiguous():
            raise ValueError(f"tensor {i}: must be contiguous on {dev}")
    done = done.contiguous()
    lib = load_library()
    pairs = [(d, s) for d, s in zip(dsts, srcs) if d.numel()]
    n = len(pairs)
    if n > lib.mv_masked_copy_max_leaves():
        raise ValueError(f"{n} leaves: the kernel takes at most "
                         f"{lib.mv_masked_copy_max_leaves()}")
    u64 = ctypes.c_ulonglong * max(n, 1)
    dst_p = u64(*[d.data_ptr() for d, _ in pairs])
    src_p = u64(*[s.data_ptr() for _, s in pairs])
    rows = u64(*[d[0].numel() * d.element_size() for d, _ in pairs])
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        LAUNCHES["masked_copy"] += 1
        err = lib.mv_masked_copy(n, dst_p, src_p, rows, done.data_ptr(), done.shape[0],
                                 _grid_blocks(dev.index), stream)
    if err != 0:
        raise RuntimeError(f"masked copy kernel launch failed: CUDA error {err}")


def bytes_moved(dsts: Sequence[torch.Tensor], num_done: int) -> int:
    """Bytes the copy must move for `num_done` finished envs: each of their
    rows read once and written once."""
    return 2 * num_done * sum(d[0].numel() * d.element_size() for d in dsts if d.numel())
