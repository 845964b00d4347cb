"""Object stacking (pick up, place and carry props with Interact) as one kernel.

`stacking_step` launches the hand-written kernel of csrc/stacking.cu (built
at first use, bound with ctypes, like the render kernel) on CUDA tensors:
one thread per env runs the env's per-agent passes in agent order, with
the same float32 operations as the plain code in its order, so the result
is bit-equal to it on the card. `scenarios.components.object_stacking_step`
calls it on CUDA tensors and takes the plain version,
`object_stacking_step_plain`, on the CPU.

The Python scalars of the plain code reach the kernel as the float32 values
PyTorch casts them to (`Consts`), computed here with the same expressions.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import Optional, Tuple

import numpy as np
import torch

from megaverse_tpu_torch import constants as C
# `stacking_step` adds one to LAUNCHES["stacking"] where it launches the kernel.
from megaverse_tpu_torch.ops.raycast_cuda import CSRC_DIR, LAUNCHES, build_library
from megaverse_tpu_torch.types import EnvState, GridConfig


class Consts(ctypes.Structure):
    """csrc/stacking.cu's `Consts`, field for field."""
    _fields_ = ([(n, ctypes.c_int) for n in ("X", "NY", "NW", "Z", "max_drop")]
                + [(n, ctypes.c_float) for n in (
                    "origin_x", "origin_y", "origin_z", "vs", "inv_vs", "body_y", "camera_y",
                    "pick_x", "pick_y", "pick_z", "carry_x", "carry_y", "carry_z",
                    "carry_scale", "inv_carry_scale")])


@functools.lru_cache(maxsize=None)
def consts(cfg: GridConfig, max_drop_scan: int) -> Consts:
    """The kernel's constants for one grid. Each float is the plain code's
    Python expression (evaluated in double, as Python does); ctypes rounds
    it to float32 as PyTorch rounds a scalar operand. `tensor / x` on CUDA
    is a multiply by the reciprocal of x, taken in double."""
    x, y, z = cfg.dims
    pick = [float(v) for v in np.asarray(C.AGENT_PICKUP_SPOT, np.float32)]
    p = C.AGENT_PICKUP_SPOT
    carry = [float(v) for v in np.asarray((p[0], p[1] - 0.3, p[2]), np.float32)]
    return Consts(
        X=x, NY=y, NW=-(-y // 32), Z=z, max_drop=max_drop_scan,
        origin_x=cfg.origin[0], origin_y=cfg.origin[1], origin_z=cfg.origin[2],
        vs=cfg.voxel_size, inv_vs=1.0 / cfg.voxel_size, body_y=C.AGENT_BODY_OFFSET_Y,
        camera_y=C.AGENT_BODY_OFFSET_Y + C.AGENT_CAMERA_OFFSET_Y,
        pick_x=pick[0], pick_y=pick[1], pick_z=pick[2],
        carry_x=carry[0], carry_y=carry[1], carry_z=carry[2],
        carry_scale=C.CARRYING_SCALE, inv_carry_scale=1.0 / C.CARRYING_SCALE)


_lib = None
_lib_lock = threading.Lock()


def load_library():
    """Build (first use) and bind csrc/stacking.cu. Raises on failure."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build_library(CSRC_DIR / "stacking.cu")))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.mv_stacking_step.restype = i
        lib.mv_stacking_step.argtypes = ([ctypes.POINTER(Consts), i, i, i] + [p] * 9
                                         + [i] + [p] * 10)
        lib.mv_stacking_consts_size.restype = i
        lib.mv_stacking_consts_size.argtypes = []
        lib.mv_stacking_max_drop.restype = i
        lib.mv_stacking_max_drop.argtypes = []
        if lib.mv_stacking_consts_size() != ctypes.sizeof(Consts):
            raise RuntimeError("csrc/stacking.cu and ops/stacking.py disagree on the "
                               "Consts layout")
        _lib = lib
        return _lib


def _check(cfg: GridConfig, state: EnvState, action: torch.Tensor,
           place_zone: Optional[torch.Tensor]) -> None:
    """The kernel's inputs: dtypes, shapes, contiguity, one device. The place
    zone may repeat one row over the batch (batch stride 0)."""
    pos = state.agents.pos
    if pos.dim() != 3:
        raise ValueError(f"agents.pos: [B, A, 3] expected, got {tuple(pos.shape)}")
    b, a = pos.shape[:2]
    p = state.props.pos.shape[1] if state.props.pos.dim() == 3 else 0
    if p < 1:
        raise ValueError(f"props.pos: [B, P, 3] with P >= 1 expected, got "
                         f"{tuple(state.props.pos.shape)}")
    x, y, z = cfg.dims
    f32, i32 = torch.float32, torch.int32
    named = {
        "action": (action, i32, (b, a)),
        "agents.pos": (pos, f32, (b, a, 3)),
        "agents.yaw": (state.agents.yaw, f32, (b, a)),
        "agents.pitch": (state.agents.pitch, f32, (b, a)),
        "agents.carried": (state.agents.carried, torch.int16, (b, a)),
        "props.pos": (state.props.pos, f32, (b, p, 3)),
        "props.scale": (state.props.scale, f32, (b, p, 3)),
        "props.flags": (state.props.flags, torch.uint8, (b, p)),
        "vobj": (state.vobj, torch.int16, (b, x, y, z)),
        "cols": (state.cols, i32, (b, x, -(-y // 32), z)),
    }
    if place_zone is not None:
        named["place_zone"] = (place_zone, i32, (b, 4))
    dev = pos.device
    for k, (t, dtype, shape) in named.items():
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{k}: {dtype} {shape} expected, got {t.dtype} {tuple(t.shape)}")
        if t.device != dev:
            raise ValueError(f"{k}: on {t.device}, agents.pos on {dev}")
        if k == "place_zone":
            if t.stride(1) != 1 or t.stride(0) not in (0, 4):
                raise ValueError(f"place_zone: rows of 4 contiguous ints expected, "
                                 f"strides {t.stride()}")
        elif not t.is_contiguous():
            raise ValueError(f"{k}: must be contiguous")


def stacking_step(cfg: GridConfig, state: EnvState, action: torch.Tensor,
                  place_zone: Optional[torch.Tensor] = None,
                  max_drop_scan: int = 16) -> Tuple[torch.Tensor, ...]:
    """Launch the kernel on CUDA inputs (raising on any failure). `vobj` and
    `cols` are updated in place; returns the new (props pos, scale, flags,
    carried, picked, placed, place_voxel), allocated here."""
    _check(cfg, state, action, place_zone)
    dev = state.agents.pos.device
    if dev.type != "cuda":
        raise ValueError(f"the stacking kernel takes CUDA tensors, got {dev}")
    lib = load_library()
    if not 0 <= max_drop_scan <= lib.mv_stacking_max_drop():
        raise ValueError(f"max_drop_scan {max_drop_scan}: the kernel takes 0 to "
                         f"{lib.mv_stacking_max_drop()}")
    b, a = state.agents.pos.shape[:2]
    props = state.props
    tables = (props.pos, props.scale, props.flags, state.agents.carried)
    out = tuple(torch.empty_like(t) for t in tables)
    picked = torch.empty((b, a), dtype=torch.bool, device=dev)
    placed = torch.empty_like(picked)
    place_voxel = torch.empty((b, a, 3), dtype=torch.int32, device=dev)
    zone = None if place_zone is None else place_zone.data_ptr()
    zone_stride = 0 if place_zone is None else place_zone.stride(0)
    ag = state.agents
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        LAUNCHES["stacking"] += 1
        err = lib.mv_stacking_step(
            ctypes.byref(consts(cfg, int(max_drop_scan))), b, a, props.pos.shape[1],
            *[t.data_ptr() for t in (action, ag.pos, ag.yaw, ag.pitch, *tables)],
            zone, zone_stride, state.vobj.data_ptr(), state.cols.data_ptr(),
            *[t.data_ptr() for t in (*out, picked, placed, place_voxel)], stream)
    if err != 0:
        raise RuntimeError(f"stacking kernel launch failed: CUDA error {err}")
    return (*out, picked, placed, place_voxel)
