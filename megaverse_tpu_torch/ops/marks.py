"""Device markers: empty named kernels that cut the captured tick into its
stages in a profiler's trace.

Kernels replayed from a CUDA graph carry no host range, and most of the
tick's are PyTorch's elementwise, scan and cat kernels, whose names say
nothing of the stage that launched them. `capture.tick` therefore launches
`megaverse_mark_tick` at its start, `megaverse_mark_reset` where the deferred
reset begins (after the write-back) and `megaverse_mark_cull` where the
render's cull prologue begins; the render kernel closes the tick. They are
captured into the graph like any other launch. The kernels live in
csrc/marks.cu (built at first use, bound with ctypes, as the masked copy's);
`RC.LAUNCHES` does not count them. On the CPU `mark` does nothing.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from megaverse_tpu_torch.ops.raycast_cuda import CSRC_DIR, build_library

# marker name -> the index `mv_mark` takes; the kernel is "megaverse_mark_<name>"
MARKS = {"tick": 0, "reset": 1, "cull": 2}
KERNEL_PREFIX = "megaverse_mark_"

_lib = None
_lib_lock = threading.Lock()


def load_library():
    """Build (first use) and bind csrc/marks.cu. Raises on failure."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build_library(CSRC_DIR / "marks.cu")))
        lib.mv_mark.restype = ctypes.c_int
        lib.mv_mark.argtypes = [ctypes.c_int, ctypes.c_void_p]
        _lib = lib
        return _lib


def mark(name: str, device: torch.device) -> None:
    """Launch the marker kernel `name` ("tick", "reset" or "cull") on the
    current stream of a CUDA `device` (raising on failure); nothing on the
    CPU."""
    which = MARKS[name]
    if device.type != "cuda":
        return
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = load_library().mv_mark(which, stream)
    if err != 0:
        raise RuntimeError(f"marker kernel {KERNEL_PREFIX}{name}: CUDA error {err}")
