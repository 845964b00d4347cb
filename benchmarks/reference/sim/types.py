"""Core state types for reference.sim (counterpart of megaverse_tpu/types.py).

The JAX package keeps one unbatched `EnvState` pytree per world and adds the
batch with `jax.vmap`. Here every dynamic field is a torch tensor with an
explicit leading env axis `B`, grouped in plain dataclasses; `tree_map` and
friends walk the tensor leaves the way `jax.tree.map` does. Host-side layouts
(`SceneData` straight out of a scenario's `generate`) hold numpy arrays of one
world without the `B` axis; `stack_scenes` batches them.

Static configuration lives in frozen dataclasses (`GridConfig`, `EnvConfig`).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Mapping, Sequence, Tuple

import numpy as np
import torch

from reference.sim import constants as C


@dataclasses.dataclass(frozen=True)
class GridConfig:
    """Static dense voxel-grid geometry for a scenario. `origin` is the world
    coordinate of the min corner of voxel (0,0,0); world->voxel is
    floor((p - origin) / voxel_size) (ref voxel_grid.hpp:144-149)."""

    dims: Tuple[int, int, int]
    voxel_size: float = 1.0
    origin: Tuple[float, float, float] = (0.0, 0.0, 0.0)


@dataclasses.dataclass(frozen=True)
class EnvConfig:
    """Static environment configuration. FloatParams (ref env.hpp:85) are fixed
    at construction; only reward shaping is runtime-mutable and is carried as
    a tensor."""

    scenario_name: str
    num_agents: int
    grid: GridConfig
    max_props: int
    params: Mapping[str, float]
    dt: float = C.DEFAULT_DT
    obs_width: int = C.OBS_WIDTH
    obs_height: int = C.OBS_HEIGHT
    # Typed prop-table layout: ((ptype, start, cap), ...). Empty = one untyped
    # region of max_props rows.
    prop_segments: Tuple[Tuple[int, int, int], ...] = ()
    # Whether device-side scenario logic reads these grids; when False they
    # ship as (1,1,1) placeholders.
    needs_terrain_grid: bool = False
    needs_object_grid: bool = False

    def param(self, name: str) -> float:
        return float(self.params[name])


# ---------------------------------------------------------------------------
# Tree helpers over dataclasses of tensors.
# ---------------------------------------------------------------------------

class Tree:
    """Base of the state dataclasses: `replace` like flax's PyTreeNode."""

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


def _is_leaf(x) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray, np.generic))


def tree_map(fn, tree, *rest):
    """Apply fn to every tensor/array leaf of `tree` (and the matching leaves
    of `rest`), rebuilding the same dataclass structure. `None` and empty
    tuples pass through."""
    if tree is None or (isinstance(tree, tuple) and not tree):
        return tree
    if _is_leaf(tree):
        return fn(tree, *rest)
    if dataclasses.is_dataclass(tree):
        return type(tree)(**{
            f.name: tree_map(fn, getattr(tree, f.name),
                             *[getattr(r, f.name) for r in rest])
            for f in dataclasses.fields(tree)})
    raise TypeError(f"tree_map: unsupported node {type(tree)!r}")


def tree_leaves(tree) -> list:
    out = []
    tree_map(lambda x: out.append(x), tree)
    return out


def _bcast_pred(pred: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    return pred.reshape(pred.shape + (1,) * (ref.dim() - pred.dim()))


def tree_select(pred: torch.Tensor, on_true, on_false):
    """Per-env select over every leaf: pred is bool [B]. A leaf that is the
    same tensor on both sides passes through as it is (no copy)."""
    return tree_map(
        lambda a, b: a if a is b else torch.where(_bcast_pred(pred, a), a, b),
        on_true, on_false)


def tree_index(tree, idx: torch.Tensor):
    """Gather rows `idx` of the leading axis of every leaf."""
    return tree_map(lambda x: x[idx], tree)


def tree_scatter(dst, idx: torch.Tensor, src):
    """Write rows of `src` at leading-axis positions `idx` of `dst` and return
    the result. A row whose index equals dst's leading size is DROPPED (the
    sentinel that JAX's `.at[idx].set(mode="drop")` ignores; PyTorch would
    raise): every leaf is padded by one scratch row that absorbs those writes
    and is sliced off again. Real indices must be unique."""
    idx = idx.to(torch.long)

    def put(d, s):
        n = d.shape[0]
        pad = torch.cat([d, d[:1]], dim=0)
        pad.index_copy_(0, idx, s.to(d.dtype))
        return pad[:n]

    return tree_map(put, dst, src)


def tree_scatter_(dst, idx, src):
    """In-place `tree_scatter`: write rows of `src` into the leaves of `dst`
    at leading-axis positions `idx`, a HOST index vector (numpy or CPU
    tensor). Rows whose index equals dst's leading size are dropped, here on
    the host, so only the real rows are copied and every leaf keeps its
    storage. Real indices must be unique. Returns `dst`."""
    idx = np.asarray(idx, np.int64)
    leaves = tree_leaves(dst)
    if not leaves:
        return dst
    keep = np.nonzero(idx < leaves[0].shape[0])[0]
    if keep.size == 0:
        return dst
    device = leaves[0].device
    rows, at = (torch.from_numpy(np.ascontiguousarray(x)) for x in (keep, idx[keep]))
    if device.type == "cuda":
        rows, at = (x.pin_memory().to(device, non_blocking=True) for x in (rows, at))

    def put(d, s):
        d.index_copy_(0, at, s.index_select(0, rows).to(d.dtype))
        return d

    tree_map(put, dst, src)
    return dst


def tree_copy_(dst, src):
    """Copy every leaf of `src` into the matching leaf of `dst` in place,
    skipping a leaf that already is dst's tensor. Returns `dst`."""
    def put(d, s):
        if s is not d:
            d.copy_(s)
        return d

    tree_map(put, dst, src)
    return dst


@functools.lru_cache(maxsize=None)
def _device_const(values: tuple, dtype: torch.dtype, device: str) -> torch.Tensor:
    return torch.tensor(values, dtype=dtype, device=device)


def _frozen(v):
    if isinstance(v, (list, tuple, np.ndarray)):
        return tuple(_frozen(x) for x in v)
    return v.item() if isinstance(v, np.generic) else v


def device_const(values, dtype: torch.dtype, like) -> torch.Tensor:
    """The constant tensor of `values` (nested sequences of Python numbers)
    on the device of `like` (a tensor or a device), made once per values,
    dtype and device and cached: a tick takes its constants from the cache
    and never copies them from the host again. Callers must not write into
    the result."""
    device = like.device if isinstance(like, torch.Tensor) else torch.device(like)
    return _device_const(_frozen(values), dtype, str(device))


# ---------------------------------------------------------------------------
# State.
# ---------------------------------------------------------------------------

PROP_FLAG_SOLID = 1
PROP_FLAG_VISIBLE = 2
PROP_FLAG_MOVABLE = 4


@dataclasses.dataclass
class PropState(Tree):
    """Fixed-size table of drawable/collidable objects ("props"). A prop with
    type == PROP_NONE is an unused slot. `scale` holds per-axis half-extents
    for boxes and per-axis radii for quadrics; a negative y-scale on a cone
    means "flipped" (diamond bottom halves)."""

    type: Any    # int8  [B,P]
    pos: Any     # f32   [B,P,3] world-space center
    scale: Any   # f32   [B,P,3]
    yaw: Any     # f32   [B,P] rotation about +Y (PROP_ROTBOX)
    color: Any   # uint8 [B,P] palette index
    color2: Any  # uint8 [B,P] PROP_ROTBOX_WALL's bottom-edging color
    flags: Any   # uint8 [B,P] bit0 solid, bit1 visible, bit2 movable


@dataclasses.dataclass
class AgentState(Tree):
    """Kinematic agent state (agent.hpp:105-121, kcc.hpp:149-206). `pos` is
    the capsule center."""

    pos: Any        # f32 [B,A,3]
    yaw: Any        # f32 [B,A] rotation about +Y; forward = (-sin, 0, -cos)
    pitch: Any      # f32 [B,A]
    vvel: Any       # f32 [B,A] vertical velocity
    hvel: Any       # f32 [B,A,3] horizontal velocity, y always 0
    jumping: Any    # bool [B,A]
    on_ground: Any  # bool [B,A]
    carried: Any    # int16 [B,A] carried prop index, -1 if none
    spawn_pos: Any  # f32 [B,A,3]

    @staticmethod
    def create(batch: int, num_agents: int, device=None) -> "AgentState":
        b, a = batch, num_agents
        f = dict(dtype=torch.float32, device=device)
        return AgentState(
            pos=torch.zeros((b, a, 3), **f),
            yaw=torch.zeros((b, a), **f),
            pitch=torch.zeros((b, a), **f),
            vvel=torch.zeros((b, a), **f),
            hvel=torch.zeros((b, a, 3), **f),
            jumping=torch.zeros((b, a), dtype=torch.bool, device=device),
            # Reference parity: onGround() is |vvel|<eps && |voffset|<eps
            # (kcc.cpp:679-682) -- TRUE for a freshly spawned controller even
            # mid-air, so the first tick accelerates with the ground budget.
            on_ground=torch.ones((b, a), dtype=torch.bool, device=device),
            carried=torch.full((b, a), -1, dtype=torch.int16, device=device),
            spawn_pos=torch.zeros((b, a, 3), **f),
        )


@dataclasses.dataclass
class SceneData(Tree):
    """Everything produced by procedural episode generation (one layout per
    env): the payload of the auto-reset layout buffer. The solid bit of the
    voxel grid ships packed along Y into 32-bit words per (x, z) column
    (ops/grid.pack_solid_columns_np); the words are held as int32 (same bits
    as the JAX package's uint32)."""

    cols: Any       # int32 [B,X,W,Z]
    vterrain: Any   # uint8 [B,X,Y,Z] (or [B,1,1,1])
    vobj: Any       # int16 [B,X,Y,Z] prop index + 1 (0 = none)
    box_lo: Any     # f32 [B,M,3]
    box_hi: Any     # f32 [B,M,3]
    box_color: Any  # uint8 [B,M] palette index, 0 = unused slot
    props: PropState
    agent_spawn: Any      # f32 [B,A,3]
    agent_yaw: Any        # f32 [B,A]
    episode_len_sec: Any  # f32 [B]
    scen: Any = None      # scenario-specific dataclass (fixed shapes) or None


@dataclasses.dataclass
class EnvState(Tree):
    """Full dynamic state of a batch of environments (Env::EnvState,
    env.hpp:124-170, plus the per-episode scene content)."""

    cols: Any
    vterrain: Any
    vobj: Any
    box_lo: Any
    box_hi: Any
    box_color: Any
    props: PropState
    agents: AgentState

    done: Any             # bool [B]
    num_frames: Any       # int32 [B]
    episode_sec: Any      # f32 [B]
    episode_len_sec: Any  # f32 [B]
    last_reward: Any      # f32 [B,A]
    total_reward: Any     # f32 [B,A]
    true_objective: Any   # f32 [B,A]

    # Per-env stream counter. The JAX package splits a PRNG key every step,
    # but no device code of any scenario draws from it, so the port carries a
    # plain int64 counter that advances the same way.
    rng: Any              # int64 [B]

    scen: Any = None


def stack_scenes(scenes: Sequence[SceneData], pad_to: int = 0) -> SceneData:
    """Stack per-env host layouts (numpy leaves, no batch axis) into one
    batched numpy SceneData; `pad_to` repeats the first layout up to a fixed
    row count."""
    pad = max(0, pad_to - len(scenes))

    def stack(*xs):
        arr = np.stack([np.asarray(x) for x in xs])
        if pad:
            arr = np.concatenate([arr, np.repeat(arr[:1], pad, axis=0)])
        return arr

    return tree_map(stack, scenes[0], *scenes[1:])


def scene_to_device(scene: SceneData, device, non_blocking: bool = False) -> SceneData:
    """Batched numpy SceneData -> tensors on `device` (pinned staging +
    asynchronous copy when the target is a GPU)."""
    dev = torch.device(device)

    def put(x):
        t = torch.from_numpy(np.ascontiguousarray(x))
        if dev.type == "cuda":
            return t.pin_memory().to(dev, non_blocking=non_blocking)
        return t

    return tree_map(put, scene)


def state_from_scene(scene: SceneData, num_agents: int, rng: torch.Tensor) -> EnvState:
    """Fresh EnvState from a batch of generated layouts (Env::reset consuming
    the scenario's generation output, env.cpp:57-76)."""
    b = scene.agent_yaw.shape[0]
    dev = scene.agent_yaw.device
    agents = AgentState.create(b, num_agents, dev).replace(
        pos=scene.agent_spawn, yaw=scene.agent_yaw, spawn_pos=scene.agent_spawn)
    zeros_a = torch.zeros((b, num_agents), dtype=torch.float32, device=dev)
    return EnvState(
        cols=scene.cols, vterrain=scene.vterrain, vobj=scene.vobj,
        box_lo=scene.box_lo, box_hi=scene.box_hi, box_color=scene.box_color,
        props=scene.props, agents=agents,
        done=torch.zeros((b,), dtype=torch.bool, device=dev),
        num_frames=torch.zeros((b,), dtype=torch.int32, device=dev),
        episode_sec=torch.zeros((b,), dtype=torch.float32, device=dev),
        episode_len_sec=scene.episode_len_sec,
        last_reward=zeros_a, total_reward=zeros_a, true_objective=zeros_a,
        rng=rng, scen=scene.scen,
    )


def multidiscrete_to_bitmask(actions: torch.Tensor) -> torch.Tensor:
    """Factorized actions [..., 6] -> the reference bitmask encoding
    (bindings/megaverse.cpp:100-117)."""
    actions = actions.to(torch.long)
    mask = torch.zeros(actions.shape[:-1], dtype=torch.int32, device=actions.device)
    for h, bits in enumerate(C.ACTION_HEAD_BITS):
        table = device_const(bits, torch.int32, actions)
        mask = mask | table[actions[..., h]]
    return mask
