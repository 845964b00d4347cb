"""HexExplore and HexMemory scenarios (counterpart of
megaverse_tpu/scenarios/hex.py): honeycomb mazes.

ref: scenarios/src/scenario_hex_explore.cpp (find the violet diamond;
spawn maximizing distance to it) and scenario_hex_memory.cpp (landmark object
shows the "good" shape/color; collect good objects, avoid bad ones), both on
the HexagonalMazeComponent maze (component_hexagonal_maze.cpp:19-128: Kruskal
honeycomb, scale 3.5, random wall height 0.85-1.4, random wall-omission
probability, landmark decorations, colored edging).

Maze walls are y-rotated thin boxes: each wall + its bottom edging strip is
rendered as ONE fused PROP_ROTBOX_WALL row (the edging geometry is derived
from the wall's extents, C.WALL_EDGE_*, and the row carries both colors).
Landmark tabs stay plain PROP_ROTBOX rows. Collision is exact via per-env
OBB tables (ops/physics.player_step(obbs=...): capsule-vs-rotated-box
push-out after the grid slide, plus wall-top landing support), matching the
reference's Bullet wall bodies (component_hexagonal_maze.cpp:109-113; only the
main wall box collides, landmarks and edging are drawables).

Generation (host, numpy) is the JAX package's, line for line, so both give
equal layouts from one seed; hex layouts have no reference-stream mode. The
per-cell visibility tables (utils/pvs.py) become a per-row render mask
(ops/pvs.py) that the bit-walk's cull ANDs into its cluster bits.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List

import numpy as np
import torch

from megaverse_tpu_torch import constants as C
from megaverse_tpu_torch.ops import pvs as PVOPS
from megaverse_tpu_torch.scenarios import register_scenario
from megaverse_tpu_torch.scenarios.base import HostScene, Scenario
from megaverse_tpu_torch.scenarios.components import _put, _take, hide_props
from megaverse_tpu_torch.types import (EnvState, GridConfig, SceneData, Tree,
                                       PROP_FLAG_VISIBLE, device_const)
from megaverse_tpu_torch.utils.hexmaze import HoneycombMaze, maze_walls

K_EXPLORE = "exploreSolved"
K_MEM_GOOD = "memoryCollectGood"
K_MEM_BAD = "memoryCollectBad"

MAZE_SCALE = 3.5
GRID_SIDE = 104  # covers size-8 maze: xmax = 3.5*sqrt(3)*7.5 ~ 45.5
GRID_ORIGIN = (-52.0, -1.0, -52.0)

SHAPE_PILLAR, SHAPE_DIAMOND, SHAPE_SPHERE = 0, 1, 2
_SHAPE_SCALE = {
    SHAPE_SPHERE: np.array([0.75, 0.75, 0.75]),
    SHAPE_PILLAR: np.array([0.5, 2.0, 0.5]),
    SHAPE_DIAMOND: np.array([0.17, 0.45, 0.17]) * 2.2,
}
_SHAPE_SHIFT = {
    SHAPE_SPHERE: np.array([0.5, 0.1, 0.5]),
    SHAPE_PILLAR: np.array([0.5, 0.05, 0.5]),
    SHAPE_DIAMOND: np.array([0.5, 0.6, 0.5]),
}


def add_shape(scene: HostScene, shape: int, color: int, loc, scale) -> int:
    """addObject (scenario_hex_memory.cpp:173-184): returns first prop idx."""
    loc = np.asarray(loc, np.float64)
    scale = np.asarray(scale, np.float64)
    if shape == SHAPE_SPHERE:
        return scene.add_prop(C.PROP_SPHERE, loc, scale, color)
    if shape == SHAPE_DIAMOND:
        top = scene.add_prop(C.PROP_CONE, loc, scale, color)
        scene.add_prop(C.PROP_CONE, loc - np.array([0, scale[1], 0]),
                       scale * np.array([1, -1, 1]), color)
        return top
    # pillar: cylinder + two caps (layout_utils.cpp addPillar)
    top = scene.add_prop(C.PROP_CYLINDER, loc, scale, color)
    cap_scale = np.array([scale[0] * 1.2, 0.15, scale[2] * 1.2])
    cap_t = np.array([0, 0.47, 0]) * scale
    scene.add_prop(C.PROP_CYLINDER, loc + cap_t, cap_scale, color)
    scene.add_prop(C.PROP_CYLINDER, loc - cap_t, cap_scale, color)
    return top


# Conservative PVS is computed for mazes up to this wall-omission level:
# above it the maze is mostly open (few walls -> cheap to render, visibility
# genuinely long-range) and the portal DFS cost stops paying for itself.
PVS_OMIT_MAX = 0.45
PVS_BUDGET = 4000  # DFS nodes per source cell (utils/pvs.cell_visibility)


def build_maze(scene: HostScene, rng: np.random.Generator, min_size: int,
               max_size: int, omit_min: float, omit_max: float):
    """Generate the maze into the scene; returns (maze, size, wall_obbs, pvs).

    Mirrors HexagonalMazeComponent::reset + addDrawablesAndCollisions. Wall
    and landmark props draw from the ROTBOX segment; collision is a list of
    EXACT y-rotated wall boxes (cx, cy, cz, hx, hy, hz, yaw) resolved by the
    physics OBB pass — matching the reference, where only the main wall box
    gets a RigidBody (cpp:109-113; landmarks and edging are drawables only).
    The OBB list is unconditional, so running out of render rows never
    changes physics.

    `pvs` is None (PVS skipped: open maze) or a dict with the conservative
    per-cell visibility data the scenario turns into render-row masks:
    centers_m [C,2] maze-unit cell centers, cellvis [C,C] bool, wall_segs_m
    [W,4] maze-unit wall segments and wall_rows [W] absolute prop-row
    indices (only walls that got a render row), walltop (world y of the
    wall-top plane)."""
    size = int(rng.integers(min_size, max_size))
    maze = HoneycombMaze(size, rng)
    wall_height = rng.random() * 0.55 + 0.85
    omit_p = rng.random() * (omit_max - omit_min) + omit_min
    landmark_p = rng.random() * 0.15 + 0.15
    bottom_edging_color = int(C.ALL_COLORS[rng.integers(0, len(C.ALL_COLORS))])
    _top_edging_color = int(C.ALL_COLORS[rng.integers(0, len(C.ALL_COLORS))])

    xmin, ymin, xmax, ymax = (b * MAZE_SCALE for b in maze.bounds())

    # floor (thin colliding box, component_hexagonal_maze.cpp:47-50)
    floor_color = int(C.LAYOUT_COLORS[rng.integers(0, len(C.LAYOUT_COLORS))])
    scene.extra_boxes.append((
        np.array([xmin, -0.05, ymin], np.float32),
        np.array([xmax, 0.0, ymax], np.float32), floor_color))
    imin = scene.world_to_voxel([xmin, -0.9, ymin])
    imax = scene.world_to_voxel([xmax, -0.1, ymax])
    scene.fill_box_voxels(imin, imax, C.VOXEL_SOLID, color=0)

    kept: List[int] = []
    walls = maze_walls(maze, rng, omit_p, kept_out=kept)

    # Conservative cell-to-cell PVS (utils/pvs.py) for closed-enough mazes;
    # open mazes skip it (few walls -> cheap render, visibility genuinely
    # long-range, and the portal DFS cost stops paying for itself).
    cellvis = None
    if omit_p <= PVS_OMIT_MAX:
        from megaverse_tpu_torch.utils.pvs import cell_visibility

        cellvis = cell_visibility(maze, set(kept), budget=PVS_BUDGET)

    # Order walls so consecutive prop rows cull together: renderer clusters
    # are CONSECUTIVE table rows, so a cluster should hold walls that are
    # both SPATIALLY tight (small cluster AABB -> sharp frustum culling) and
    # CO-VISIBLE (shared PVS bits -> sharp occlusion culling; a pure spatial
    # Morton order interleaves opposite sides of a wall line, diluting a
    # 0.23 visible-row fraction to ~0.8 at cluster level, while a pure
    # co-visibility order strings clusters along corridors, fattening their
    # AABBs and doubling frustum survivors — measured both). A DFS preorder
    # over the PORTAL graph gives both at once: corridor cells come out in
    # runs, and walls keyed by their first adjacent cell in that order are
    # neighbors exactly when they bound the same corridor stretch. (Hex has
    # no reference-stream parity to preserve — maze topology comes from
    # std::random_device in the reference.)
    def _morton_xy(mx, mz):
        mx, mz = int(mx + 64), int(mz + 64)
        code = 0
        for b in range(8):
            code |= ((mx >> b) & 1) << (2 * b) | ((mz >> b) & 1) << (2 * b + 1)
        return code

    if len(walls):
        from megaverse_tpu_torch.utils.pvs import maze_portal_arrays

        neigh, open_, _ = maze_portal_arrays(maze, set(kept))
        order = np.full((len(maze.cells),), -1, np.int64)
        stack = [0]
        nseen = 0
        while stack:
            cell = stack.pop()
            if order[cell] >= 0:
                continue
            order[cell] = nseen
            nseen += 1
            for n in range(6):
                j = neigh[cell, n]
                if j >= 0 and open_[cell, n] and order[j] < 0:
                    stack.append(j)
        order[order < 0] = nseen  # unreachable cells (shouldn't happen)

        ctrs = maze.centers

        def wall_key(w):
            mid = np.array([(w[0] + w[2]) * 0.5, (w[1] + w[3]) * 0.5])
            d2 = ((ctrs - mid) ** 2).sum(axis=1)
            near = np.argsort(d2)[:3]
            touch = near[d2[near] <= (1.0 + 0.1) ** 2]
            first = int(order[touch].min()) if len(touch) else int(order[near[0]])
            return (first, _morton_xy(mid[0] * MAZE_SCALE, mid[1] * MAZE_SCALE))

        walls = sorted(walls, key=wall_key)

    lm_rows: List[int] = []
    lm_xz: List[tuple] = []
    wall_obbs = []
    wall_rows: List[int] = []
    wall_segs_m: List[tuple] = []
    for (x1, z1, x2, z2) in walls:
        x1, z1, x2, z2 = (c * MAZE_SCALE for c in (x1, z1, x2, z2))
        seg = np.hypot(x1 - x2, z1 - z2)
        half_len = 0.5 * seg
        cx, cz = (x1 + x2) / 2, (z1 + z2) / 2
        dx_, dz_ = x1 - x2, z1 - z2
        rot_y = np.pi / 2 if abs(dx_) < 1e-6 else -np.arctan(dz_ / dx_)

        # landmarks (decorative tabs, component_hexagonal_maze.cpp:96-108)
        if rng.random() < landmark_p and scene.prop_room(C.PROP_ROTBOX) > 8:
            lw = 0.15
            lh = lw * half_len / wall_height
            n_land = int(rng.integers(2, 5))
            wall_scale = np.array([half_len, wall_height, 0.15])
            for li in range(n_land):
                l_scale = np.array([lw, lh, rng.random() * 1.2 + 1.5])
                l_t = np.array([(1.0 if li % 2 == 1 else 0.0) * lw * 2,
                                (1.0 if li > 1 else 0.0) * lh * 2 - 0.2, 0.0])
                world_scale = wall_scale * l_scale
                local = wall_scale * l_t
                rc, rs = np.cos(rot_y), np.sin(rot_y)
                wx = cx + rc * local[0] + rs * local[2]
                wz = cz - rs * local[0] + rc * local[2]
                color = int(C.ALL_COLORS[rng.integers(0, len(C.ALL_COLORS))])
                lrow = scene.add_prop(
                    C.PROP_ROTBOX, (wx, wall_height + local[1], wz),
                    world_scale, color, yaw=rot_y)
                # landmark tabs sit fully below the wall-top plane (max top
                # 0.8*wh + 0.78 < 2*wh for wh >= 0.85), so they are
                # PVS-gated like walls
                lm_rows.append(lrow)
                lm_xz.append((wx, wz))

        if scene.prop_room(C.PROP_ROTBOX_WALL) >= 1:
            # wall + bottom edging FUSED into one primitive row: the edging
            # geometry (half_len*1.02 x wall_height*0.12 x 0.2, sitting on
            # the floor) is derived in the renderer from the wall's extents
            # (C.WALL_EDGE_*), and the row carries both colors — halves the
            # dominant row population of hex scenes
            row = scene.add_prop(C.PROP_ROTBOX_WALL, (cx, wall_height, cz),
                                 (half_len, wall_height, 0.15),
                                 C.COLOR_IDX["DARK_BLUE"], yaw=rot_y,
                                 color2=bottom_edging_color)
            wall_rows.append(row)
            wall_segs_m.append((x1 / MAZE_SCALE, z1 / MAZE_SCALE,
                                x2 / MAZE_SCALE, z2 / MAZE_SCALE))

        # exact collision body (cpp:109-113): center at wallTranslation,
        # half extents (length, wallHeight, 0.15)
        wall_obbs.append((cx, wall_height, cz, half_len, wall_height, 0.15,
                          rot_y))

    pvs = None
    if cellvis is not None:
        pvs = dict(
            centers_m=maze.centers,
            cellvis=cellvis,
            wall_segs_m=np.asarray(wall_segs_m, np.float64).reshape(-1, 4),
            wall_rows=np.asarray(wall_rows, np.int64),
            lm_rows=np.asarray(lm_rows, np.int64),
            lm_xz=np.asarray(lm_xz, np.float64).reshape(-1, 2),
            walltop=2.0 * wall_height,
        )
    return maze, size, wall_obbs, pvs


# ---------------------------------------------------------------------------
# PVS device tables (see utils/pvs.py for the algorithm, ops/pvs.py for the
# render-time lookup)
# ---------------------------------------------------------------------------

PVS_CMAX = 169  # honeycomb cell count at max size 8: 3*8*7 + 1


def make_pvs_tables(pvs, prop_cap: int, obj_pts_world=None,
                    obj_radius: float = 0.5, obj_rows=None):
    """Fixed-shape per-env PVS arrays for the scen pytree.

    Returns (centers [PVS_CMAX, 2] f32 world-xz padded +1e9,
    rows16 [PVS_CMAX+1, ceil(prop_cap/16)] i32 per-cell row-visibility bits
    with an all-ones sentinel row, walltop f32; walltop <= 0 disables).

    Gated rows: every wall row (visible from cell c iff any cell its
    inflated footprint touches is in c's PVS) and, optionally, per-object
    prop rows (obj_pts_world [K, 2] world-xz centers, obj_rows[k] = list of
    absolute prop rows) — objects must sit fully below the wall-top plane,
    which HexMemory's 0.6-scaled collectibles do (max top 1.17 < min top
    1.7); taller always-visible props simply stay ungated. All other rows
    (landmarks, boxes) stay visible."""
    from megaverse_tpu_torch.utils.pvs import (pack_rows16, point_adjacency,
                                         wall_adjacency)

    w16 = -(-prop_cap // 16)
    centers = np.full((PVS_CMAX, 2), 1e9, np.float32)
    if pvs is None:
        rows16 = np.full((PVS_CMAX + 1, w16), 0xFFFF, np.int32)
        return centers, rows16, np.float32(-1.0)
    c = pvs["centers_m"].shape[0]
    cv = pvs["cellvis"].astype(np.uint8)
    rowvis = np.ones((PVS_CMAX + 1, prop_cap), bool)
    if len(pvs["wall_rows"]):
        adj = wall_adjacency(pvs["centers_m"], pvs["wall_segs_m"])
        rowvis[:c, pvs["wall_rows"]] = (cv @ adj.astype(np.uint8)) > 0
    if len(pvs["lm_rows"]):
        # landmark tabs: protrude <= ~0.5 world units from the wall face
        ladj = point_adjacency(pvs["centers_m"], pvs["lm_xz"] / MAZE_SCALE,
                               0.6 / MAZE_SCALE)
        rowvis[:c, pvs["lm_rows"]] = (cv @ ladj.astype(np.uint8)) > 0
    if obj_rows:
        padj = point_adjacency(pvs["centers_m"],
                               np.asarray(obj_pts_world) / MAZE_SCALE,
                               obj_radius / MAZE_SCALE)
        obj_vis = (cv @ padj.astype(np.uint8)) > 0
        for k, rows in enumerate(obj_rows):
            for r in rows:
                rowvis[:c, r] = obj_vis[:, k]
    centers[:c] = pvs["centers_m"] * MAZE_SCALE
    return centers, pack_rows16(rowvis), np.float32(pvs["walltop"])


def _hex_row_mask(scenario, states):
    """Shared render_row_mask of the hex scenarios: bool [B, A, prop_cap]."""
    sc = states.scen
    return PVOPS.row_mask(states.agents.pos, sc.pvs_centers, sc.pvs_rows16,
                          sc.pvs_walltop, scenario.cfg.max_props, MAZE_SCALE)


def _agent_center(state: EnvState) -> torch.Tensor:
    """The agents' visual origins [B, A, 3] (capsule center + body offset)."""
    off = device_const((0.0, C.AGENT_BODY_OFFSET_Y, 0.0), torch.float32, state.agents.pos)
    return state.agents.pos + off


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt((v * v).sum(dim=-1))


def first_true(mask: torch.Tensor, dim: int) -> torch.Tensor:
    """One-hot along `dim` of the first True of `mask` (all False where it
    has none), as `jnp.argmax` over a bool row picks it."""
    first = mask.to(torch.int32).argmax(dim=dim, keepdim=True)
    ids = torch.arange(mask.shape[dim], device=mask.device)
    shape = [1] * mask.dim()
    shape[dim] = -1
    return mask & (ids.view(shape) == first)


def _finish_timer(state: EnvState, solve_now: torch.Tensor) -> torch.Tensor:
    """doneWithTimer (scenario.hpp:114-117): 0.3 s left once solved."""
    return torch.where(
        solve_now, torch.maximum(state.episode_sec, state.episode_len_sec - 0.3),
        state.episode_sec)


# ---------------------------------------------------------------------------
# HexExplore
# ---------------------------------------------------------------------------

# Fixed capacity of the per-env wall-OBB table (max measured walls at maze
# size 8 is ~364; generation asserts). Padding rows carry hy = -1 (inert).
WALL_OBB_MAX = 420


def pad_wall_obbs(wall_obbs) -> np.ndarray:
    obbs = np.zeros((WALL_OBB_MAX, 7), np.float32)
    obbs[:, 4] = -1.0
    if wall_obbs:
        arr = np.asarray(wall_obbs, np.float32)
        assert arr.shape[0] <= WALL_OBB_MAX, arr.shape
        obbs[: arr.shape[0]] = arr
    return obbs


@dataclasses.dataclass
class HexExploreState(Tree):
    reward_pos: Any    # f32 [B,3] world
    reward_prop: Any   # i32 [B] (top cone of the diamond)
    solved: Any        # bool [B]
    wall_obbs: Any     # f32 [B,WALL_OBB_MAX,7] exact collision walls
    pvs_centers: Any   # f32 [B,PVS_CMAX,2] world cell centers (+1e9 pad)
    pvs_rows16: Any    # i32 [B,PVS_CMAX+1,W16] row-visibility bits
    pvs_walltop: Any   # f32 [B] wall-top plane y; <= 0 disables PVS


class HexExploreScenario(Scenario):
    name = "HexExplore"
    scen_cls = HexExploreState
    max_boxes = 8
    ROTBOX_MAX = 440   # landmark tabs
    prop_segments = ((C.PROP_ROTBOX, ROTBOX_MAX),
                     (C.PROP_ROTBOX_WALL, WALL_OBB_MAX),
                     (C.PROP_CONE, 2))
    shaping_keys = (K_EXPLORE,)
    deferred_scen_fields = ("wall_obbs", "pvs_centers", "pvs_rows16")

    def grid_config(self) -> GridConfig:
        return GridConfig(dims=(GRID_SIDE, 6, GRID_SIDE), voxel_size=1.0,
                          origin=GRID_ORIGIN)

    def _reward_shaping(self) -> Dict[str, float]:
        return {K_EXPLORE: 5.0}

    def collision_obbs(self, state):
        return state.scen.wall_obbs

    def render_row_mask(self, states):
        return _hex_row_mask(self, states)

    def generate(self, rng: np.random.Generator) -> SceneData:
        scene = HostScene(self.cfg)
        maze, size, wall_obbs, pvs = build_maze(scene, rng, 2, 8, 0.1, 0.4)

        cell = int(rng.integers(0, len(maze.cells)))
        cx, cz = maze.centers[cell] * MAZE_SCALE
        reward_pos = np.array([cx, 0.0, cz], np.float32)

        # violet diamond, scale 1.9 (scenario_hex_explore.cpp:103-107)
        s = 1.9
        top = add_shape(scene, SHAPE_DIAMOND, C.COLOR_IDX["VIOLET"],
                        reward_pos + np.array([0, 1.2, 0]),
                        np.array([0.17 * s, 0.35 * s, 0.17 * s]))

        # spawn: farthest shuffled cell (scenario_hex_explore.cpp:60-99)
        order = rng.permutation(len(maze.cells))
        best, best_d = None, -1.0
        for ci in order:
            sx, sz = maze.centers[ci] * MAZE_SCALE
            spawn = np.array([sx, 0.1, sz])
            d = np.linalg.norm(reward_pos - spawn)
            if d > best_d:
                best, best_d = spawn, d
            if d > size * MAZE_SCALE:
                break
        rot = 2 * np.pi / self.num_agents
        positions = [best + np.array([np.sin(i * rot), 0, np.cos(i * rot)])
                     for i in range(self.num_agents)]
        scene.spawn_agents_at(np.asarray(positions), rng)

        cap = scene.props_type.shape[0]
        centers, rows16, walltop = make_pvs_tables(pvs, cap)
        scen = HexExploreState(
            reward_pos=reward_pos,
            reward_prop=np.int32(top),
            solved=np.asarray(False),
            wall_obbs=pad_wall_obbs(wall_obbs),
            pvs_centers=centers,
            pvs_rows16=rows16,
            pvs_walltop=walltop,
        )
        return scene.finish(self.max_boxes, scen=scen)

    def scen_step(self, state: EnvState, action: torch.Tensor, shaping: torch.Tensor):
        f32 = torch.float32
        rewards = torch.zeros_like(state.last_reward)
        sc: HexExploreState = state.scen

        dist = _norm(_agent_center(state) - sc.reward_pos[:, None, :])   # [B,A]
        near = dist < 1.2
        solve_now = near.any(dim=1) & ~sc.solved                          # [B]
        solver = first_true(near, dim=1).to(f32) * solve_now.to(f32)[:, None]
        rewards = self.reward_team(rewards, shaping, K_EXPLORE, solver, 1.0)

        # hide the diamond (both cones)
        flags = hide_props(state.props.flags, sc.reward_prop[:, None], solve_now[:, None])
        solved = sc.solved | solve_now
        state = state.replace(
            props=state.props.replace(flags=flags),
            scen=sc.replace(solved=solved),
            episode_sec=_finish_timer(state, solve_now),
            true_objective=solved.to(f32)[:, None].expand_as(
                state.true_objective).contiguous(),
        )
        return state, rewards


# ---------------------------------------------------------------------------
# HexMemory
# ---------------------------------------------------------------------------

MEM_MAX_OBJECTS = 160  # ceil(0.45 * 168) good + same bad


@dataclasses.dataclass
class HexMemoryState(Tree):
    obj_pos: Any         # f32 [B,K,3]
    obj_good: Any        # bool [B,K]
    obj_active: Any      # bool [B,K]
    obj_prop: Any        # i32 [B,K] first prop index
    obj_nprops: Any      # i32 [B,K] how many props (1..3)
    num_good: Any        # i32 [B]
    good_collected: Any  # i32 [B]
    solved: Any          # bool [B]
    wall_obbs: Any       # f32 [B,WALL_OBB_MAX,7] exact collision walls
    pvs_centers: Any     # f32 [B,PVS_CMAX,2] world cell centers (+1e9 pad)
    pvs_rows16: Any      # i32 [B,PVS_CMAX+1,W16] row-visibility bits
    pvs_walltop: Any     # f32 [B] wall-top plane y; <= 0 disables PVS


class HexMemoryScenario(Scenario):
    name = "HexMemory"
    scen_cls = HexMemoryState
    max_boxes = 8
    # walls/edging/landmark tabs | pillar cylinders | diamond cones | spheres
    # (objects + the landmark object can all be one shape in the worst case)
    prop_segments = (
        (C.PROP_ROTBOX, 440),
        (C.PROP_ROTBOX_WALL, WALL_OBB_MAX),
        (C.PROP_CYLINDER, 3 * MEM_MAX_OBJECTS + 3),
        (C.PROP_CONE, 2 * MEM_MAX_OBJECTS + 2),
        (C.PROP_SPHERE, MEM_MAX_OBJECTS + 1),
    )
    shaping_keys = (K_MEM_GOOD, K_MEM_BAD)
    deferred_scen_fields = ("obj_pos", "obj_good", "obj_prop", "obj_nprops",
                            "wall_obbs", "pvs_centers", "pvs_rows16")

    def grid_config(self) -> GridConfig:
        return GridConfig(dims=(GRID_SIDE, 6, GRID_SIDE), voxel_size=1.0,
                          origin=GRID_ORIGIN)

    def _reward_shaping(self) -> Dict[str, float]:
        return {K_MEM_GOOD: 1.0, K_MEM_BAD: -1.0}

    def collision_obbs(self, state):
        return state.scen.wall_obbs

    def render_row_mask(self, states):
        return _hex_row_mask(self, states)

    def generate(self, rng: np.random.Generator) -> SceneData:
        scene = HostScene(self.cfg)
        maze, size, wall_obbs, pvs = build_maze(scene, rng, 2, 8, 0.1, 0.95)

        # center cell = landmark (scenario_hex_memory.cpp:40-53)
        d2 = np.sum(maze.centers ** 2, axis=1)
        center_idx = int(np.argmin(np.sqrt(d2)))
        ccx, ccz = maze.centers[center_idx] * MAZE_SCALE
        landmark = np.array([ccx, 1.0, ccz])

        coords = []
        for ci in range(len(maze.cells)):
            if ci == center_idx:
                continue
            cx, cz = maze.centers[ci]
            off = np.array([rng.random() - 0.5, 0.0, rng.random() - 0.5])
            c = np.array([cx, 0.5, cz]) + off
            coords.append(np.array([c[0] * MAZE_SCALE, c[1], c[2] * MAZE_SCALE]))
        coords = np.asarray(coords) if coords else np.zeros((0, 3))
        coords = coords[rng.permutation(len(coords))]

        frac = rng.random() * 0.25 + 0.2
        n_good = int(np.round(np.ceil(frac * len(coords))))
        n_bad = n_good if len(coords) >= 2 * n_good else 0
        good_coords = coords[:n_good]
        bad_coords = coords[n_good:n_good + n_bad]

        # Place each group in Morton order of position: the renderer's
        # clusters are consecutive prop rows, and shuffled placement order
        # gives 8-object clusters maze-wide AABBs that survive every tile's
        # frustum test (measured: objects were 35% of surviving rows).
        # Which objects are good/bad is decided above by the shuffle —
        # only the draw order changes.
        def _obj_morton(c):
            mx, mz = int(c[0] + 64), int(c[2] + 64)
            code = 0
            for b in range(8):
                code |= (((mx >> b) & 1) << (2 * b)
                         | ((mz >> b) & 1) << (2 * b + 1))
            return code

        good_coords = sorted(good_coords, key=_obj_morton)
        bad_coords = sorted(bad_coords, key=_obj_morton)

        # shapes/colors (scenario_hex_memory.cpp:160-170)
        shapes = [SHAPE_PILLAR, SHAPE_DIAMOND, SHAPE_SPHERE]
        good_color = int(C.OBJECT_COLORS[rng.integers(0, len(C.OBJECT_COLORS))])
        good_shape = shapes[rng.integers(0, 3)]
        bad_color, bad_shape = good_color, good_shape
        while bad_color == good_color and bad_shape == good_shape:
            bad_color = int(C.OBJECT_COLORS[rng.integers(0, len(C.OBJECT_COLORS))])
            bad_shape = shapes[rng.integers(0, 3)]

        add_shape(scene, good_shape, good_color,
                  landmark + _SHAPE_SHIFT[good_shape], _SHAPE_SCALE[good_shape])

        k = MEM_MAX_OBJECTS
        obj_pos = np.zeros((k, 3), np.float32)
        obj_good = np.zeros((k,), bool)
        obj_active = np.zeros((k,), bool)
        obj_prop = np.zeros((k,), np.int32)
        obj_nprops = np.zeros((k,), np.int32)
        obj_scale = 0.6
        i = 0
        obj_xz: List[np.ndarray] = []
        obj_rows: List[List[int]] = []
        for group, is_good in ((good_coords, True), (bad_coords, False)):
            shape = good_shape if is_good else bad_shape
            color = good_color if is_good else bad_color
            needed = {SHAPE_SPHERE: (C.PROP_SPHERE, 1),
                      SHAPE_DIAMOND: (C.PROP_CONE, 2),
                      SHAPE_PILLAR: (C.PROP_CYLINDER, 3)}[shape]
            for coord in group:
                if i >= k or scene.prop_room(needed[0]) < needed[1]:
                    break
                loc = coord + _SHAPE_SHIFT[shape] * obj_scale
                first = add_shape(scene, shape, color, loc, _SHAPE_SCALE[shape] * obj_scale)
                nprops = {SHAPE_SPHERE: 1, SHAPE_DIAMOND: 2, SHAPE_PILLAR: 3}[shape]
                obj_pos[i] = coord
                obj_good[i] = is_good
                obj_active[i] = True
                obj_prop[i] = first
                obj_nprops[i] = nprops
                obj_xz.append(np.asarray([loc[0], loc[2]]))
                obj_rows.append([first + off for off in range(nprops)])
                i += 1

        # agents: deterministic ring spawn (scenario_hex_memory.cpp:127-157)
        a = self.num_agents
        rot = 2 * np.pi / a
        for j in range(a):
            p = 1.5 * np.array([np.sin(rot * j), 0.3, np.cos(rot * j)])
            scene.agent_spawn[j] = p + np.array([0.5, C.AGENT_HEIGHT, 0.5])
            scene.agent_yaw[j] = rot * j

        n_good_actual = int(obj_good.sum())
        scene.episode_len_sec = self.params[C.P_EPISODE_LENGTH_SEC] + 3.0 * n_good_actual

        cap = scene.props_type.shape[0]
        centers, rows16, walltop = make_pvs_tables(
            pvs, cap, obj_pts_world=obj_xz, obj_radius=0.55,
            obj_rows=obj_rows)
        scen = HexMemoryState(
            obj_pos=obj_pos, obj_good=obj_good, obj_active=obj_active,
            obj_prop=obj_prop, obj_nprops=obj_nprops,
            num_good=np.int32(n_good_actual),
            good_collected=np.int32(0),
            solved=np.asarray(False),
            wall_obbs=pad_wall_obbs(wall_obbs),
            pvs_centers=centers,
            pvs_rows16=rows16,
            pvs_walltop=walltop,
        )
        return scene.finish(self.max_boxes, scen=scen)

    def scen_step(self, state: EnvState, action: torch.Tensor, shaping: torch.Tensor):
        f32 = torch.float32
        rewards = torch.zeros_like(state.last_reward)
        sc: HexMemoryState = state.scen

        # solve check BEFORE collection (scenario_hex_memory.cpp:86-90)
        solve_now = (sc.good_collected >= sc.num_good) & ~sc.solved       # [B]
        episode_sec = _finish_timer(state, solve_now)
        solved = sc.solved | solve_now

        t = _agent_center(state)
        dist = _norm(sc.obj_pos[:, :, None, :] - t[:, None, :, :])        # [B,K,A]
        near = (dist < 1.0) & sc.obj_active[:, :, None]
        collected = near.any(dim=2)                                       # [B,K]
        # the first agent near each object (the reference's argmax over a
        # bool row)
        collector = first_true(near, dim=2)
        good_n = ((collected & sc.obj_good)[:, :, None] & collector).sum(dim=1).to(f32)
        bad_n = ((collected & ~sc.obj_good)[:, :, None] & collector).sum(dim=1).to(f32)
        rewards = self.reward_team(rewards, shaping, K_MEM_GOOD, good_n, 1.0)
        rewards = self.reward_team(rewards, shaping, K_MEM_BAD, bad_n, 1.0)

        # hide collected objects (up to 3 props each), one pass per prop in
        # turn, each reading the flags the one before wrote; rows of objects
        # that do not hide go to the scratch column of `_put`
        flags = state.props.flags
        last = flags.shape[1] - 1
        for off in range(3):
            rows = torch.clamp(sc.obj_prop.long() + off, max=last)
            hide = collected & (sc.obj_nprops > off)
            flags = _put(flags, rows, _take(flags, rows) & (0xFF ^ PROP_FLAG_VISIBLE), hide)

        sc = sc.replace(
            obj_active=sc.obj_active & ~collected,
            good_collected=sc.good_collected
            + (collected & sc.obj_good).sum(dim=1).to(torch.int32),
            solved=solved,
        )
        state = state.replace(
            props=state.props.replace(flags=flags),
            scen=sc,
            episode_sec=episode_sec,
            true_objective=solved.to(f32)[:, None].expand_as(
                state.true_objective).contiguous(),
        )
        return state, rewards


register_scenario("HexExplore", HexExploreScenario)
register_scenario("HexMemory", HexMemoryScenario)
