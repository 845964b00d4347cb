"""Scenario base class and host-side episode generation utilities.

A scenario has two halves:

1. **Generation** (host, numpy): procedural episode layout -> `SceneData`
   arrays. This replaces the reference's Scenario::reset scene building
   (scenario.hpp:108, e.g. scenario_obstacles.cpp:51-195). Branchy, sequential
   algorithms (retry loops, spanning trees, BFS) run here in numpy and feed
   a device-side layout buffer; the step consumes layouts by masked select, so
   auto-reset needs no host round trip.

2. **Step logic** (device, torch): function over a batched EnvState run after
   physics each tick (ref Scenario::step, scenario.hpp:128), plus reward
   shaping.

Reward shaping (ref scenario.hpp:184-215) is runtime-mutable per agent, so it is
carried as a [B, A, K] tensor whose columns follow `shaping_keys` order.

Counterpart of megaverse_tpu/scenarios/base.py.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from reference.sim import constants as C
from reference.sim.types import (
    EnvConfig,
    EnvState,
    GridConfig,
    PropState,
    SceneData,
    PROP_FLAG_SOLID,
    PROP_FLAG_VISIBLE,
    PROP_FLAG_MOVABLE,
    device_const,
)


# ---------------------------------------------------------------------------
# Host-side scene construction.
# ---------------------------------------------------------------------------

class LayoutOverflow(ValueError):
    """A generated layout's merged-box count exceeded the scenario's static
    render capacity (an artifact of fixed-shape device tables; the reference
    has no such cap). Callers regenerate from the same stream."""


class HostScene:
    """Mutable numpy scene under construction; `finish()` -> SceneData arrays.

    When the scenario declares typed prop segments (cfg.prop_segments), the
    prop table is laid out as fixed per-type regions and add_prop places each
    prop at its type's segment cursor. The renderer then compiles exactly one
    intersection routine per homogeneous cluster instead of dispatching on the
    type of every row, and the render bucket slices each segment's live prefix
    independently.
    """

    def __init__(self, cfg: EnvConfig):
        self.cfg = cfg
        x, y, z = cfg.grid.dims
        self.vtype = np.zeros((x, y, z), np.uint8)
        self.vcolor = np.zeros((x, y, z), np.uint8)
        self.vterrain = np.zeros((x, y, z), np.uint8)
        self.vobj = np.zeros((x, y, z), np.int16)
        self.extra_boxes: List[Tuple[np.ndarray, np.ndarray, int]] = []
        p = cfg.max_props
        self.props_type = np.full((p,), C.PROP_NONE, np.int8)
        self.props_pos = np.zeros((p, 3), np.float32)
        self.props_scale = np.zeros((p, 3), np.float32)
        self.props_yaw = np.zeros((p,), np.float32)
        self.props_color = np.zeros((p,), np.uint8)
        self.props_color2 = np.zeros((p,), np.uint8)
        self.props_flags = np.zeros((p,), np.uint8)
        # cursor per segment; the legacy (unsegmented) layout is one untyped
        # segment spanning the whole table.
        self._segs = {ptype: [start, start, start + cap]
                      for ptype, start, cap in cfg.prop_segments}
        self._legacy_cursor = 0
        self.agent_spawn = np.zeros((cfg.num_agents, 3), np.float32)
        self.agent_yaw = np.zeros((cfg.num_agents,), np.float32)
        self.episode_len_sec = float(cfg.params.get(C.P_EPISODE_LENGTH_SEC, 60.0))
        self.scen: Any = None

    # -- voxel helpers ------------------------------------------------------
    def world_to_voxel(self, p) -> np.ndarray:
        g = self.cfg.grid
        return np.floor((np.asarray(p, np.float64) - np.asarray(g.origin)) / g.voxel_size).astype(np.int64)

    def fill_box_voxels(self, imin, imax, vtype=C.VOXEL_SOLID | C.VOXEL_OPAQUE,
                        color: int = 0, terrain: int = 0) -> None:
        """Fill voxel index range [imin, imax] inclusive."""
        x0, y0, z0 = np.maximum(imin, 0)
        dims = self.cfg.grid.dims
        x1, y1, z1 = np.minimum(imax, np.asarray(dims) - 1)
        if x1 < x0 or y1 < y0 or z1 < z0:
            return
        sl = (slice(x0, x1 + 1), slice(y0, y1 + 1), slice(z0, z1 + 1))
        self.vtype[sl] |= np.uint8(vtype)
        if color:
            self.vcolor[sl] = np.uint8(color)
        if terrain:
            self.vterrain[sl] |= np.uint8(terrain)

    def add_static_box(self, scale, translation, color: int,
                       solid: bool = True, opaque: bool = True) -> None:
        """World-space box with half-extents `scale` centered at `translation`.

        Mirrors layout_utils addStaticCollidingBox (layout_utils.cpp:72-85):
        drawn as one render box; collision via voxelization into the grid.
        """
        scale = np.asarray(scale, np.float64)
        translation = np.asarray(translation, np.float64)
        lo = translation - scale
        hi = translation + scale
        if opaque:
            self.extra_boxes.append((lo.astype(np.float32), hi.astype(np.float32), color))
        if solid:
            # Voxelize for collision only (color stays 0 so the greedy merge
            # does not emit a duplicate render box for these voxels).
            imin = self.world_to_voxel(lo + 1e-6)
            imax = self.world_to_voxel(hi - 1e-6)
            self.fill_box_voxels(imin, imax, C.VOXEL_SOLID, color=0)

    def add_terrain_quad(self, x0: float, z0: float, x1: float, z1: float,
                         y: float, terrain: int) -> None:
        """Thin overlay quad on top of the floor (layout_utils.cpp:53-68)."""
        color = C.TERRAIN_COLOR_IDX[terrain]
        lo = np.array([x0, y, z0], np.float32)
        hi = np.array([x1, y + 0.05, z1], np.float32)
        self.extra_boxes.append((lo, hi, color))
        # Terrain bits on the voxels just above the quad (for game logic).
        imin = self.world_to_voxel(lo + 1e-6)
        imax = self.world_to_voxel([hi[0] - 1e-6, y + 1e-6, hi[2] - 1e-6])
        self.fill_box_voxels(imin, imax, vtype=0, terrain=terrain)

    # -- props --------------------------------------------------------------
    def prop_room(self, ptype: int) -> int:
        """Free slots for this prop type (its segment, or the shared table)."""
        if self._segs:
            start, cur, end = self._segs[ptype]
            return end - cur
        return self.cfg.max_props - self._legacy_cursor

    def num_props(self) -> int:
        """Total live props placed so far."""
        if self._segs:
            return sum(cur - start for start, cur, end in self._segs.values())
        return self._legacy_cursor

    def add_prop(self, ptype: int, pos, scale, color: int,
                 solid: bool = False, movable: bool = False, yaw: float = 0.0,
                 color2: int = 0) -> int:
        flags = PROP_FLAG_VISIBLE
        if solid:
            flags |= PROP_FLAG_SOLID
        if movable:
            flags |= PROP_FLAG_MOVABLE
        if self._segs:
            if ptype not in self._segs:
                raise ValueError(
                    f"{self.cfg.scenario_name}: prop type {ptype} has no "
                    f"declared segment ({self.cfg.prop_segments})")
            seg = self._segs[ptype]
            if seg[1] >= seg[2]:
                raise ValueError(
                    f"{self.cfg.scenario_name}: segment for prop type {ptype} "
                    f"is full (cap {seg[2] - seg[0]})")
            idx = seg[1]
            seg[1] += 1
        else:
            if self._legacy_cursor >= self.cfg.max_props:
                raise ValueError(
                    f"scene has more than max_props={self.cfg.max_props} props")
            idx = self._legacy_cursor
            self._legacy_cursor += 1
        if ptype == C.PROP_ROTBOX_WALL:
            # renderer invariant (constants.py WALL_EDGE_*): wall stands on
            # the floor, center-y == y half-extent
            assert abs(float(pos[1]) - float(scale[1])) < 1e-5, (pos, scale)
        self.props_type[idx] = ptype
        self.props_pos[idx] = np.asarray(pos, np.float32)
        self.props_scale[idx] = np.asarray(scale, np.float32)
        self.props_yaw[idx] = float(yaw)
        self.props_color[idx] = color
        self.props_color2[idx] = color2
        self.props_flags[idx] = flags
        return idx

    def add_movable_box(self, voxel) -> int:
        """Movable 0.39-half-extent box occupying `voxel` (int coords).

        Mirrors ObjectStackingComponent::addDrawablesAndCollisions
        (component_object_stacking.hpp:170-198): drawn at the voxel center,
        collision via the voxel grid, registered in the object-slot field.
        """
        g = self.cfg.grid
        voxel = np.asarray(voxel, np.int64)
        center = np.asarray(g.origin) + (voxel + 0.5) * g.voxel_size
        idx = self.add_prop(
            C.PROP_BOX, center, (0.39, 0.39, 0.39), C.COLOR_IDX["MOVABLE_BOX"],
            solid=True, movable=True,
        )
        self.vobj[tuple(voxel)] = idx + 1
        self.vtype[tuple(voxel)] |= C.VOXEL_SOLID
        return idx

    # -- agents -------------------------------------------------------------
    def spawn_agents_at(self, positions, rng: np.random.Generator,
                        yaws=None) -> None:
        """Standard spawn (scenario_default.hpp:80-97): +(.5,0,.5) cell centering,
        +agentHeight vertical offset (agent.cpp:45), random yaw. Pass explicit
        `yaws` (reference-stream mode: frand(rng) * 2pi per agent in spawn
        order, scenario_default.hpp:86) to bypass the numpy draw."""
        positions = np.asarray(positions, np.float64)
        for i in range(self.cfg.num_agents):
            p = positions[i] + np.array([0.5, 0.0, 0.5])
            self.agent_spawn[i] = p + np.array([0.0, C.AGENT_HEIGHT, 0.0])
            self.agent_yaw[i] = (yaws[i] if yaws is not None
                                 else rng.random() * 2.0 * np.pi)

    # -- finalize -----------------------------------------------------------
    def finish(self, max_boxes: int, scen: Any = None) -> SceneData:
        g = self.cfg.grid
        boxes = greedy_merge_boxes(self.vtype, self.vcolor, g)
        boxes += self.extra_boxes
        boxes = _morton_sort_boxes(boxes)
        if len(boxes) > max_boxes:
            raise LayoutOverflow(
                f"scene has {len(boxes)} render boxes > max_boxes={max_boxes} "
                f"({self.cfg.scenario_name})"
            )
        m = max_boxes
        box_lo = np.zeros((m, 3), np.float32)
        box_hi = np.zeros((m, 3), np.float32)
        box_color = np.zeros((m,), np.uint8)
        for i, (lo, hi, col) in enumerate(boxes):
            box_lo[i], box_hi[i], box_color[i] = lo, hi, col

        from reference.sim.ops.grid import pack_solid_columns_np

        one = np.zeros((1, 1, 1), np.uint8)
        data = SceneData(
            cols=pack_solid_columns_np(self.vtype),
            vterrain=self.vterrain if self.cfg.needs_terrain_grid else one,
            vobj=(self.vobj if self.cfg.needs_object_grid
                  else one.astype(np.int16)),
            box_lo=box_lo,
            box_hi=box_hi,
            box_color=box_color,
            props=PropState(
                type=self.props_type, pos=self.props_pos,
                scale=self.props_scale, yaw=self.props_yaw,
                color=self.props_color, color2=self.props_color2,
                flags=self.props_flags,
            ),
            agent_spawn=self.agent_spawn,
            agent_yaw=self.agent_yaw,
            episode_len_sec=np.float32(self.episode_len_sec),
            scen=scen if scen is not None else self.scen,
        )
        # Host-only debug view of the dense grid (NOT a dataclass field: the
        # device never ships it; layout tests inspect OPAQUE etc.).
        data.host_vtype = self.vtype
        data.host_vcolor = self.vcolor
        return data


def _morton_sort_boxes(boxes):
    """Order render boxes by Morton code of their center (x/z interleaved,
    y lowest bits — layouts are mostly planar).

    The render kernel groups consecutive table rows into CLUSTER_K-row
    clusters with one conservative AABB each (ops/raycast_cuda.py); the
    greedy merge emits boxes in x-major scan order, so clusters were long
    z-streaks. Morton order makes neighbors in the table neighbors in space,
    which tightens every cluster AABB and with it frustum/occlusion culling.
    Pure reordering: closest-hit images are order-independent (per-pixel min
    with deterministic tie-break)."""
    if len(boxes) <= 4:
        return boxes

    def spread2(v):  # 10-bit value -> bits interleaved with one zero
        v &= 0x3FF
        v = (v | (v << 16)) & 0x30000FF
        v = (v | (v << 8)) & 0x300F00F
        v = (v | (v << 4)) & 0x30C30C3
        v = (v | (v << 2)) & 0x9249249
        return v

    def key(box):
        lo, hi, _ = box
        c = (np.asarray(lo, np.float64) + np.asarray(hi, np.float64)) * 2.0
        xi, yi, zi = (int(c[0]) & 0x3FF), (int(c[1]) & 0xFF), (int(c[2]) & 0x3FF)
        return (spread2(xi) << 2 | spread2(zi) << 1) << 8 | yi

    return sorted(boxes, key=key)


def greedy_merge_boxes(vtype: np.ndarray, vcolor: np.ndarray, g: GridConfig):
    """Greedy merge of identical (opaque, color) voxels into boxes.

    Host-side equivalent of VoxelGridComponent::toBoundingBoxes
    (component_voxel_grid.hpp:108-187): expands axis-aligned parallelepipeds of
    matching voxels so the renderer tests a handful of boxes instead of
    thousands of voxels (x, then y, then z scan order; each seed voxel expands
    along z, then x, then y). The numpy path alone
    (the program may take a native kernel for it).
    """
    opaque = (vtype & C.VOXEL_OPAQUE) != 0
    # Voxels that are solid but not opaque still need rendering in the
    # reference only when OPAQUE is set; solid-only voxels are invisible
    # colliders. Merge the visible ones.
    visible = opaque | (((vtype & C.VOXEL_SOLID) != 0) & (vcolor > 0))
    todo = visible.copy()
    boxes = []
    xs, ys, zs = np.nonzero(todo)
    order = np.lexsort((zs, ys, xs))
    dims = vtype.shape
    for k in order:
        x, y, z = int(xs[k]), int(ys[k]), int(zs[k])
        if not todo[x, y, z]:
            continue
        col = vcolor[x, y, z]
        # expand along z
        z2 = z
        while z2 + 1 < dims[2] and todo[x, y, z2 + 1] and vcolor[x, y, z2 + 1] == col:
            z2 += 1
        # expand along x
        x2 = x
        while x2 + 1 < dims[0] and np.all(todo[x2 + 1, y, z:z2 + 1]) and np.all(vcolor[x2 + 1, y, z:z2 + 1] == col):
            x2 += 1
        # expand along y
        y2 = y
        while y2 + 1 < dims[1] and np.all(todo[x:x2 + 1, y2 + 1, z:z2 + 1]) and np.all(vcolor[x:x2 + 1, y2 + 1, z:z2 + 1] == col):
            y2 += 1
        todo[x:x2 + 1, y:y2 + 1, z:z2 + 1] = False
        vs = g.voxel_size
        origin = np.asarray(g.origin)
        lo = origin + np.array([x, y, z]) * vs
        hi = origin + (np.array([x2, y2, z2]) + 1) * vs
        boxes.append((lo.astype(np.float32), hi.astype(np.float32), int(col)))
    return boxes


# ---------------------------------------------------------------------------
# Scenario base.
# ---------------------------------------------------------------------------

class Scenario:
    """Base scenario. Subclasses override generation + device step logic."""

    name: str = "base"
    # Static capacity knobs (per scenario).
    max_boxes: int = 64
    max_props: int = 8
    # Typed prop segments ((ptype, cap), ...). When declared, the prop table
    # is laid out as per-type regions (see HostScene) and max_props is
    # derived as the sum of caps.
    prop_segments: Tuple[Tuple[int, int], ...] = ()
    # Which voxel grids the scenario's DEVICE logic reads (vtype is always
    # shipped packed; vcolor never is: it only drives the host-side render merge).
    needs_terrain_grid: bool = False
    needs_object_grid: bool = False
    shaping_keys: Tuple[str, ...] = ()
    # Dataclass of the scenario's extra per-env state (EnvState.scen), or None.
    scen_cls: Optional[type] = None

    def __init__(self, num_agents: int = 1, params: Optional[Dict[str, float]] = None):
        self.num_agents = num_agents
        resolved = self.default_params()
        resolved.update(params or {})
        self.params = resolved
        seg_layout = []
        start = 0
        for ptype, cap in self.prop_segments:
            seg_layout.append((int(ptype), start, int(cap)))
            start += int(cap)
        max_props = start if seg_layout else self.max_props
        self.cfg = EnvConfig(
            scenario_name=self.name,
            num_agents=num_agents,
            grid=self.grid_config(),
            max_props=max_props,
            params=resolved,
            prop_segments=tuple(seg_layout),
            needs_terrain_grid=self.needs_terrain_grid,
            needs_object_grid=self.needs_object_grid,
        )

    # -- static config ------------------------------------------------------
    def grid_config(self) -> GridConfig:
        raise NotImplementedError

    def collision_obbs(self, state) -> "Optional[Any]":
        """Per-env y-rotated collision boxes [B, W, 7] (cx, cy, cz, hx, hy,
        hz, yaw) for scenarios whose walls are exact rotated bodies in the
        reference (hex mazes, component_hexagonal_maze.cpp:79-113), or None.
        Rows with hy <= 0 are inert padding."""
        return None

    # scen leaves that are pure copies of the generated layout (never mutated
    # in-episode): excluded from the per-step auto-reset select and patched by
    # the K-slot deferred scatter instead (env.py defer_reset).
    deferred_scen_fields: Tuple[str, ...] = ()

    def render_row_mask(self, states) -> "Optional[Any]":
        """Conservative per-prop-row visibility bits bool [B, A, prop_cap]
        for a BATCH of envs, or None. A False bit promises no camera ray
        from that agent can hit the row's primitive this frame; the culling
        prologue ANDs it into the per-tile survival bits (the image is
        bit-identical by construction). The hex scenarios provide one."""
        return None

    def default_params(self) -> Dict[str, float]:
        # ref scenario.hpp:225-231
        return {
            C.P_EPISODE_LENGTH_SEC: 60.0,
            C.P_VERTICAL_LOOK_LIMIT: 0.2,
            C.P_USE_UI_REWARD_INDICATORS: 0.0,
        }

    def default_reward_shaping(self) -> Dict[str, float]:
        """ref Scenario::initRewardShaping + defaultRewardShaping."""
        return {C.P_TEAM_SPIRIT: 0.0, **self._reward_shaping()}

    def _reward_shaping(self) -> Dict[str, float]:
        return {}

    @property
    def all_shaping_keys(self) -> List[str]:
        return [C.P_TEAM_SPIRIT, *self.shaping_keys]

    def shaping_array(self, overrides: Optional[Dict[str, float]] = None) -> np.ndarray:
        """[A, K] runtime reward-shaping array in all_shaping_keys order."""
        base = self.default_reward_shaping()
        if overrides:
            base.update(overrides)
        row = np.array([base[k] for k in self.all_shaping_keys], np.float32)
        return np.tile(row, (self.num_agents, 1))

    def shaping(self, shaping_arr: torch.Tensor, key: str) -> torch.Tensor:
        """Column [B, A] of the shaping tensor for `key` (device-side)."""
        return shaping_arr[..., self.all_shaping_keys.index(key)]

    # -- generation (host) --------------------------------------------------
    def generate(self, rng: np.random.Generator) -> SceneData:
        raise NotImplementedError

    def generate_checked(self, rng, ref_stream: bool = False) -> SceneData:
        """generate() with bounded regeneration on capacity overflow — the
        analogue of the reference's layout-retry loops
        (scenario_obstacles.cpp:69-161). The reference has no box capacity,
        so an overflow is an artifact of our fixed-shape tables; regenerating
        advances the env's stream deterministically (PARITY.md deviation #3).
        """
        last = None
        for _ in range(20):
            try:
                return (self.generate_ref(rng) if ref_stream
                        else self.generate(rng))
            except LayoutOverflow as e:
                last = e
        raise last

    # Scenarios overriding generate_ref replicate the reference engine's
    # exact per-episode draw ORDER from its mt19937 stream (see
    # utils/refrng.py): layout geometry is then bit-identical to the C++
    # engine's under the same seed chain.
    supports_ref_stream: bool = False

    def generate_ref(self, rng) -> SceneData:
        """Reference-stream generation (rng: utils.refrng.Rng). Only for
        scenarios with supports_ref_stream = True."""
        raise NotImplementedError(
            f"{self.name}: reference-stream generation not implemented")

    # -- device-side scenario logic ----------------------------------------
    def scen_step(
        self, state: EnvState, action: torch.Tensor, shaping: torch.Tensor
    ) -> Tuple[EnvState, torch.Tensor]:
        """Post-physics task logic on the batched state: returns (state,
        per-agent rewards [B, A]). Must also maintain state.true_objective.
        Default: nothing."""
        return state, torch.zeros_like(state.last_reward)

    def pre_physics(self, state: EnvState, action: torch.Tensor) -> EnvState:
        """Hook before the physics step (ref Scenario::preStep)."""
        return state

    # -- team reward helpers (ref scenario.hpp:259-307) ---------------------
    def team_affinity(self) -> np.ndarray:
        """[A] static team id per agent; default all same team."""
        return np.zeros((self.num_agents,), np.int32)

    def reward_team(
        self, rewards: torch.Tensor, shaping: torch.Tensor, key: str,
        agent_idx_mask: torch.Tensor, multiplier,
    ) -> torch.Tensor:
        """Vectorized rewardTeam (scenario.hpp:291-298).

        `agent_idx_mask` [B, A] is 1.0 for the acting agent(s); `multiplier`
        is a float or a [B] / [B, A] tensor. The acting agent gets
        (1 - teamSpirit) * r; every teammate (incl. actor) gets
        teamSpirit * r / teamSize."""
        r = self.shaping(shaping, key)
        spirit = self.shaping(shaping, C.P_TEAM_SPIRIT)
        team = device_const(self.team_affinity().tolist(), torch.int32, rewards)
        same_team = (team[:, None] == team[None, :]).to(torch.float32)  # [A, A]
        team_size = same_team.sum(dim=1)

        if torch.is_tensor(multiplier) and multiplier.dim() == 1:
            multiplier = multiplier[:, None]
        mult = multiplier * agent_idx_mask
        direct = r * mult * (1.0 - spirit)
        # Each acting agent j contributes r_i * spirit_i * mult_j / teamSize_i
        # to every teammate i.
        contrib = (same_team[None] * mult[:, None, :]).sum(dim=2)
        shared = r * spirit * contrib / team_size
        return rewards + direct + shared

    def reward_agent(
        self, rewards: torch.Tensor, shaping: torch.Tensor, key: str,
        agent_idx_mask: torch.Tensor, multiplier,
    ) -> torch.Tensor:
        """rewardAgent (scenario.hpp:259-262)."""
        r = self.shaping(shaping, key)
        return rewards + r * multiplier * agent_idx_mask

    def reward_all(self, rewards: torch.Tensor, shaping: torch.Tensor, key: str,
                   multiplier) -> torch.Tensor:
        r = self.shaping(shaping, key)
        return rewards + r * multiplier
