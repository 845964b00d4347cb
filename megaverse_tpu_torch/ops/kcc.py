"""The character controller's physics block as one kernel.

`physics_step` is the physics of one tick (env.cpp:126): `player_step`, then
`resolve_agent_collisions` (ops/physics.py). On a CUDA tensor it launches the
hand-written kernel of csrc/kcc.cu (built at first use, bound with ctypes,
like the render kernel): one thread per agent, the agents of an env in one
block, the same float32 operations as the plain code in its order, so the
result is bit-equal to it on the card. On the CPU it takes the plain
version, `physics_step_plain`: the two functions of ops/physics.py.

The Python scalars of the plain code reach the kernel as the float32 values
PyTorch casts them to (`Consts`), computed here with the same expressions.
"""

from __future__ import annotations

import ctypes
import functools
import math
import threading
from typing import Optional, Tuple

import numpy as np
import torch

from megaverse_tpu_torch import constants as C
from megaverse_tpu_torch.ops import grid as G
from megaverse_tpu_torch.ops import physics as P
# `physics_step` adds one to LAUNCHES["kcc"] where it launches the kernel.
from megaverse_tpu_torch.ops.raycast_cuda import CSRC_DIR, LAUNCHES, build_library
from megaverse_tpu_torch.types import AgentState, GridConfig

# threads a block holds where an env's agents fit (a multiple of num_agents)
BLOCK_THREADS = 64
# the agent fields the kernel reads and writes anew, in its argument order
KCC_FIELDS = ("pos", "vvel", "hvel", "jumping", "on_ground")


class Consts(ctypes.Structure):
    """csrc/kcc.cu's `Consts`, field for field."""
    _fields_ = ([(n, ctypes.c_int) for n in ("X", "NY", "NW", "Z", "span_x", "span_z")]
                + [(n, ctypes.c_float) for n in (
                    "origin_x", "origin_y", "origin_z", "vs", "inv_vs",
                    "dt", "inv_dt", "grav_dt", "jump_speed", "neg_fall_speed", "fall_speed",
                    "step_height", "eps", "fric_dt", "half_y", "clamp_margin",
                    "boundary_eps", "max_rise", "max_drop",
                    "r", "r2_sweep", "inv_r", "onorm_axis", "onorm_diag",
                    "r_cap", "r2_cap", "dmax2", "r2_obb", "r2_obb_near", "two_r", "v_lim",
                    "e24", "e12", "e9", "e6", "e5", "e4")])


def _reciprocal(x: float) -> float:
    """PyTorch's `tensor / x` on CUDA is a multiply by the reciprocal of the
    Python scalar, taken in double and rounded to float32 (ctypes rounds)."""
    return 1.0 / x


@functools.lru_cache(maxsize=None)
def consts(cfg: GridConfig, dt: float) -> Consts:
    """The kernel's constants for one grid and tick length. Each float is the
    plain code's Python expression (evaluated in double, as Python does);
    ctypes rounds it to float32 as PyTorch rounds a scalar operand."""
    x, y, z = cfg.dims
    sx, sz = P._span_xz(cfg)
    r = P.HALF_XZ
    r_cap = float(np.float32(r))
    slope = 0.70710678        # the column scans' max_slope_cos
    d_max = float(np.float32(r_cap) * np.sqrt(np.maximum(
        np.float32(1.0) - np.float32(slope) * np.float32(slope), np.float32(0.0))))
    return Consts(
        X=x, NY=y, NW=-(-y // 32), Z=z, span_x=sx, span_z=sz,
        origin_x=cfg.origin[0], origin_y=cfg.origin[1], origin_z=cfg.origin[2],
        vs=cfg.voxel_size, inv_vs=_reciprocal(cfg.voxel_size),
        dt=dt, inv_dt=_reciprocal(dt), grav_dt=C.KCC_GRAVITY * dt,
        jump_speed=C.KCC_JUMP_SPEED, neg_fall_speed=-C.KCC_FALL_SPEED,
        fall_speed=C.KCC_FALL_SPEED, step_height=C.KCC_STEP_HEIGHT, eps=C.KCC_EPSILON,
        fric_dt=C.KCC_NORMAL_DECELERATION * dt, half_y=P.HALF_Y,
        clamp_margin=P.CLAMP_MARGIN, boundary_eps=G.BOUNDARY_EPS,
        max_rise=P.MAX_RISE, max_drop=P.MAX_DROP,
        r=r, r2_sweep=r * r, inv_r=_reciprocal(r),
        onorm_axis=1.0, onorm_diag=1.0 / math.sqrt(2.0),
        r_cap=r_cap, r2_cap=r_cap * r_cap, dmax2=d_max * d_max,
        r2_obb=r * r, r2_obb_near=0.5 * r * r,
        two_r=2 * r, v_lim=2 * P.HALF_Y - 0.05,
        e24=1e-24, e12=1e-12, e9=1e-9, e6=1e-6, e5=1e-5, e4=1e-4)


_lib = None
_lib_lock = threading.Lock()


def load_library():
    """Build (first use) and bind csrc/kcc.cu. Raises on failure."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build_library(CSRC_DIR / "kcc.cu")))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.mv_kcc_step.restype = i
        lib.mv_kcc_step.argtypes = [ctypes.POINTER(Consts), i, i, i] + [p] * 7 + [i] + [p] * 6
        lib.mv_kcc_consts_size.restype = i
        lib.mv_kcc_consts_size.argtypes = []
        lib.mv_kcc_max_threads.restype = i
        lib.mv_kcc_max_threads.argtypes = []
        if lib.mv_kcc_consts_size() != ctypes.sizeof(Consts):
            raise RuntimeError("csrc/kcc.cu and ops/kcc.py disagree on the Consts layout")
        _lib = lib
        return _lib


def _check(cfg: GridConfig, agents: AgentState, cols: torch.Tensor,
           obbs: Optional[torch.Tensor]) -> None:
    """The kernel's inputs: dtypes, shapes, contiguity, one device."""
    if agents.pos.dim() != 3:
        raise ValueError(f"pos: [B, A, 3] expected, got {tuple(agents.pos.shape)}")
    b, a = agents.pos.shape[:2]
    x, y, z = cfg.dims
    want = {"pos": (torch.float32, (b, a, 3)), "vvel": (torch.float32, (b, a)),
            "hvel": (torch.float32, (b, a, 3)), "jumping": (torch.bool, (b, a)),
            "on_ground": (torch.bool, (b, a))}
    named = {k: getattr(agents, k) for k in KCC_FIELDS}
    named["cols"] = cols
    want["cols"] = (torch.int32, (b, x, -(-y // 32), z))
    if obbs is not None:
        named["obbs"] = obbs
        want["obbs"] = (torch.float32, (b, *obbs.shape[1:2], 7))
    dev = agents.pos.device
    for k, t in named.items():
        dtype, shape = want[k]
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{k}: {dtype} {shape} expected, got {t.dtype} {tuple(t.shape)}")
        if t.device != dev:
            raise ValueError(f"{k}: on {t.device}, pos on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{k}: must be contiguous")


def physics_step_plain(cfg: GridConfig, agents: AgentState, dt: float, cols: torch.Tensor,
                       obbs: Optional[torch.Tensor] = None) -> AgentState:
    """Plain version of `physics_step` (any device)."""
    agents = P.player_step(cfg, agents, dt, cols=cols, obbs=obbs)
    return P.resolve_agent_collisions(agents, cfg, cols=cols, obbs=obbs)


def kcc_step(cfg: GridConfig, agents: AgentState, dt: float, cols: torch.Tensor,
             obbs: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, ...]:
    """Launch the kernel on CUDA inputs (raising on any failure): the new
    (pos, vvel, hvel, jumping, on_ground), allocated here."""
    _check(cfg, agents, cols, obbs)
    dev = agents.pos.device
    if dev.type != "cuda":
        raise ValueError(f"the KCC kernel takes CUDA tensors, got {dev}")
    lib = load_library()
    b, a = agents.pos.shape[:2]
    threads = a * max(1, BLOCK_THREADS // a)
    if threads > lib.mv_kcc_max_threads():
        raise ValueError(f"{a} agents per env: the kernel takes at most "
                         f"{lib.mv_kcc_max_threads()}")
    w = 0 if obbs is None else obbs.shape[1]
    rows = [getattr(agents, k) for k in KCC_FIELDS]
    out = tuple(torch.empty_like(t) for t in rows)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        LAUNCHES["kcc"] += 1
        err = lib.mv_kcc_step(
            ctypes.byref(consts(cfg, float(dt))), b, a, threads,
            *[t.data_ptr() for t in (*rows, cols)], obbs.data_ptr() if w else None, w,
            *[t.data_ptr() for t in out], stream)
    if err != 0:
        raise RuntimeError(f"KCC kernel launch failed: CUDA error {err}")
    return out


def physics_step(cfg: GridConfig, agents: AgentState, dt: float, cols: torch.Tensor,
                 obbs: Optional[torch.Tensor] = None) -> AgentState:
    """One physics tick of every agent (player_step, then the agents'
    pairwise push) on the packed columns `cols` [B, X, NW, Z] and the rotated
    walls `obbs` [B, W, 7] (None: no walls). CUDA tensors launch the kernel,
    CPU tensors take the plain version."""
    if cols.device.type != "cuda":
        return physics_step_plain(cfg, agents, dt, cols, obbs)
    rows = agents.replace(**{k: getattr(agents, k).contiguous() for k in KCC_FIELDS})
    out = kcc_step(cfg, rows, dt, cols.contiguous(),
                   None if obbs is None else obbs.contiguous())
    return agents.replace(**dict(zip(KCC_FIELDS, out)))
