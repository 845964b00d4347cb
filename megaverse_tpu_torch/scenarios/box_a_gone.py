"""BoxAGone scenario (counterpart of megaverse_tpu/scenarios/box_a_gone.py):
disappearing-platform last-man-standing.

ref: scenarios/src/scenario_box_a_gone.cpp + scenario_box_a_gone.hpp.
A 24x24 walled arena (voxel size 2) with 2-3 levels of thin tiles; stepping
onto a new tile arms it: it swaps to a green "temporary" platform that
inflates and vanishes after 15 ticks (step, cpp:97-177); leaving a tile
accelerates its timer to 3 ticks. Per-step reward while off the floor;
touching the floor penalizes. Each agent is its own team (hpp:92).
Episode 300 s, vertical look limit 0.75 (hpp:74-79).

Deviation (as in the JAX package): tiles sit flush with their voxel TOP
(collision is the full voxel), where the reference floats them mid-voxel on
thin Bullet boxes — same mechanics, tiles drawn ~1 m higher.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from megaverse_tpu_torch import constants as C
from megaverse_tpu_torch.ops import grid as G
from megaverse_tpu_torch.scenarios import register_scenario
from megaverse_tpu_torch.scenarios.base import HostScene, Scenario
from megaverse_tpu_torch.scenarios.components import _put, _take
from megaverse_tpu_torch.types import (
    EnvState, GridConfig, PROP_FLAG_VISIBLE, SceneData, Tree, device_const)
from megaverse_tpu_torch.utils.refrng import ref_spawn_yaw

K_FLOOR = "boxagoneTouchedFloor"
K_STEP = "boxagonePerStepReward"

VOXEL = 2.0
SIZE = 24
T_MAX = 3 * 18 * 18  # 3 levels x up to 18x18 tiles
L_MAX = 3            # max levels (rand_range(2, 4))
_TILE_COLORS = ("ORANGE", "BLUE", "VIOLET")


@dataclasses.dataclass
class BoxAGoneState(Tree):
    """Tile state on DENSE per-level grids [L_MAX, SIZE, SIZE]: arming and
    expiry are elementwise, the prop-table updates gather through the static
    cell <-> prop-row maps, and the column-grid solidity is recomputed each
    step as base_cols | (active << level_h)."""
    tile_voxel: Any        # i32 [B,T,3] voxel per tile, generation order (static)
    tile_prop: Any         # i32 [B,L,S,S] prop row per cell, -1 = no tile (static)
    prop_cell: Any         # i32 [B,T_MAX] flat cell (l*S*S + x*S + z) per tile
    #                        prop row, -1 dead (static inverse map)
    level_h: Any           # i32 [B,L] level voxel heights, -1 absent
    base_cols: Any         # i32 [B,S,1,S] packed solid columns (the JAX
    #                        package's uint32 bits) WITHOUT tile bits (static)
    tile_active: Any       # bool [B,L,S,S] (still standing)
    tile_ticks: Any        # i32 [B,L,S,S]; -1 = not armed
    last_tile: Any         # i32 [B,A] flat cell agent stands on (-1 none)
    seconds_off_floor: Any  # f32 [B,A] secondsBeforeTouchedFloor
    finished: Any          # bool [B]


class BoxAGoneScenario(Scenario):
    name = "BoxAGone"
    scen_cls = BoxAGoneState
    max_boxes = 16
    prop_segments = ((C.PROP_BOX, T_MAX),)
    shaping_keys = (K_FLOOR, K_STEP)

    def default_params(self) -> Dict[str, float]:
        p = super().default_params()
        p[C.P_EPISODE_LENGTH_SEC] = 300.0
        p[C.P_VERTICAL_LOOK_LIMIT] = 0.75
        return p

    def _reward_shaping(self) -> Dict[str, float]:
        return {K_FLOOR: -0.1, K_STEP: 0.01}

    def team_affinity(self) -> np.ndarray:
        return np.arange(self.num_agents, dtype=np.int32)

    def grid_config(self) -> GridConfig:
        return GridConfig(dims=(SIZE, 14, SIZE), voxel_size=VOXEL, origin=(0.0, 0.0, 0.0))

    # ------------------------------------------------------------- generate
    def generate(self, rng: np.random.Generator) -> SceneData:
        rr = lambda lo, hi: int(rng.integers(lo, hi))
        num_levels = rr(2, 4)
        levels = []
        spawn_cells = []
        level_h = 1
        for level in range(num_levels):
            level_h += rr(2, 4)
            ll, lw = rr(10, 19), rr(10, 19)
            sx, sz = SIZE // 2 - ll // 2, SIZE // 2 - lw // 2
            skip_p = rng.random() * 0.2
            tiles = []
            for x in range(sx, sx + ll):
                for z in range(sz, sz + lw):
                    if rng.random() < skip_p:
                        continue
                    tiles.append((x, z))
                    if level == num_levels - 1:
                        spawn_cells.append((x, level_h, z))
            levels.append((level_h, tiles))
        if not spawn_cells:
            spawn_cells = [(SIZE // 2, 1, SIZE // 2)]
        while len(spawn_cells) < self.num_agents:
            spawn_cells.append(spawn_cells[0])
        order = rng.permutation(len(spawn_cells))
        spawns = [spawn_cells[order[i]] for i in range(self.num_agents)]
        yaws = [rng.random() * 2 * np.pi for _ in range(self.num_agents)]
        return self._build(levels, spawns, yaws)

    supports_ref_stream = True

    def generate_ref(self, rng) -> SceneData:
        """Reference draw order (BoxAGoneScenario::reset, cpp:41-96: numLevels
        -> per level height/length/width/skipProb f32 + per-cell skip frand
        (x-major) -> spawn pad + std::shuffle; then spawnAgents yaws)."""
        num_levels = rng.rand_range(2, 4)
        levels = []
        spawn_cells = []
        level_h = 1
        for level in range(num_levels):
            level_h += rng.rand_range(2, 4)
            ll = rng.rand_range(10, 19)
            lw = rng.rand_range(10, 19)
            sx, sz = SIZE // 2 - ll // 2, SIZE // 2 - lw // 2
            skip_p = np.float32(np.float32(rng.frand()) * np.float32(0.2))
            tiles = []
            for x in range(sx, sx + ll):
                for z in range(sz, sz + lw):
                    if np.float32(rng.frand()) < skip_p:
                        continue
                    tiles.append((x, z))
                    if level == num_levels - 1:
                        spawn_cells.append((x, level_h, z))
            levels.append((level_h, tiles))
        if not spawn_cells:  # cannot occur for skipProb <= 0.2; safety only
            spawn_cells = [(SIZE // 2, 1, SIZE // 2)]
        while len(spawn_cells) < self.num_agents:
            spawn_cells.append(spawn_cells[0])
        rng.shuffle(spawn_cells)
        spawns = spawn_cells[:self.num_agents]
        yaws = [ref_spawn_yaw(rng) for _ in range(self.num_agents)]
        return self._build(levels, spawns, yaws)

    def _build(self, levels, spawns, yaws) -> SceneData:
        scene = HostScene(self.cfg)
        white = C.COLOR_IDX["WHITE"]

        # floor + walls (height 8 voxels)
        scene.vtype[0:SIZE, 0, 0:SIZE] |= C.VOXEL_SOLID | C.VOXEL_OPAQUE
        scene.vcolor[0:SIZE, 0, 0:SIZE] = white
        for (xs, zs) in ((np.s_[0:1], np.s_[0:SIZE]), (np.s_[SIZE - 1:SIZE], np.s_[0:SIZE]),
                         (np.s_[0:SIZE], np.s_[0:1]), (np.s_[0:SIZE], np.s_[SIZE - 1:SIZE])):
            scene.vtype[xs, 0:8, zs] |= C.VOXEL_SOLID | C.VOXEL_OPAQUE
            scene.vcolor[xs, 0:8, zs] = white

        tile_voxel = np.zeros((T_MAX, 3), np.int32)
        tile_prop = np.full((L_MAX, SIZE, SIZE), -1, np.int32)
        prop_cell = np.full((T_MAX,), -1, np.int32)
        level_hs = np.full((L_MAX,), -1, np.int32)
        tile_active = np.zeros((L_MAX, SIZE, SIZE), bool)
        ti = 0
        obj_size = 0.42 * VOXEL
        thickness = obj_size * 0.045

        for level, (level_h, tiles) in enumerate(levels):
            color = C.COLOR_IDX[_TILE_COLORS[level % 3]]
            level_hs[level] = level_h
            for (x, z) in tiles:
                if ti >= T_MAX:
                    continue
                # tile drawn flush with the voxel top (see deviation note)
                center = np.array([
                    (x + 0.5) * VOXEL, (level_h + 1) * VOXEL - thickness, (z + 0.5) * VOXEL])
                idx = scene.add_prop(C.PROP_BOX, center,
                                     (obj_size, thickness, obj_size), color)
                scene.vtype[x, level_h, z] |= C.VOXEL_SOLID
                tile_voxel[ti] = [x, level_h, z]
                tile_prop[level, x, z] = idx
                prop_cell[idx] = level * SIZE * SIZE + x * SIZE + z
                tile_active[level, x, z] = True
                ti += 1

        # ref spawn: ((v + .5) * voxelSize); agents stand on top of the tile
        for i, sp in enumerate(spawns):
            scene.agent_spawn[i] = [
                (sp[0] + 0.5) * VOXEL,
                (sp[1] + 1) * VOXEL + C.AGENT_HALF_HEIGHT + 0.05,
                (sp[2] + 0.5) * VOXEL]
            scene.agent_yaw[i] = yaws[i]

        # packed columns WITHOUT the tile bits: the step recomputes
        # state.cols = base | (active << level_h) instead of scattering
        # per-tile deltas (level heights stay below bit 31)
        base_cols = G.pack_solid_columns_np(scene.vtype).copy()
        for level in range(L_MAX):
            h = int(level_hs[level])
            if h < 0:
                continue
            base_cols[:, 0, :] &= ~np.where(tile_active[level], np.int32(1 << h),
                                            np.int32(0))

        a = self.num_agents
        scen = BoxAGoneState(
            tile_voxel=tile_voxel,
            tile_prop=tile_prop,
            prop_cell=prop_cell,
            level_h=level_hs,
            base_cols=base_cols,
            tile_active=tile_active,
            tile_ticks=np.full((L_MAX, SIZE, SIZE), -1, np.int32),
            last_tile=np.full((a,), -1, np.int32),
            seconds_off_floor=np.zeros((a,), np.float32),
            finished=np.asarray(False),
        )
        return scene.finish(self.max_boxes, scen=scen)

    # ------------------------------------------------------------- step
    def scen_step(self, state: EnvState, action: torch.Tensor, shaping: torch.Tensor):
        num_agents = self.num_agents
        cfg = self.cfg.grid
        f32, i32 = torch.float32, torch.int32
        dev = state.agents.pos.device
        rewards = torch.zeros_like(state.last_reward)
        sc: BoxAGoneState = state.scen
        bsz = sc.level_h.shape[0]

        t = state.agents.pos + device_const((0.0, C.AGENT_BODY_OFFSET_Y, 0.0), f32, dev)
        coords = G.world_to_voxel(cfg, t)                              # [B,A,3]
        touches_floor = coords[..., 1] < 3

        rewards = self.reward_team(rewards, shaping, K_FLOOR, touches_floor.to(f32), 1.0)
        rewards = self.reward_team(rewards, shaping, K_STEP, (~touches_floor).to(f32), 1.0)
        seconds = torch.where(~touches_floor, state.episode_sec[:, None],
                              sc.seconds_off_floor)

        # which tile is each agent standing on? Agents stand ON the voxel top,
        # so the tile voxel is one below the agent's voxel: the level by height
        # match (the first matching level), then one gather per agent.
        below_y = coords[..., 1] - 1
        # level_h >= 0 guard: a below.y of -1 (an agent in the bottom voxel
        # row) must not match an absent level's -1 sentinel
        lvl_match = ((sc.level_h[:, None, :] == below_y[..., None])
                     & (sc.level_h[:, None, :] >= 0))                  # [B,A,L]
        has_lvl = lvl_match.any(dim=2)
        lvl = lvl_match.to(i32).argmax(dim=2)                          # first match
        bx, bz = coords[..., 0], coords[..., 2]
        in_b = (bx >= 0) & (bx < SIZE) & (bz >= 0) & (bz < SIZE)
        gx = torch.clamp(bx, 0, SIZE - 1)
        gz = torch.clamp(bz, 0, SIZE - 1)
        active_here = sc.tile_active[G._bidx(lvl), lvl.long(), gx.long(), gz.long()]
        on = has_lvl & in_b & active_here & state.agents.on_ground
        agent_tile = torch.where(on, lvl.to(i32) * SIZE * SIZE + gx * SIZE + gz,
                                 torch.full_like(gx, -1))              # i32 [B,A]

        # Per-agent arming runs SEQUENTIALLY in agent order, matching the
        # reference's agent loop (scenario_box_a_gone.cpp:100-148): agent i's
        # arming / previous-tile acceleration is visible to agent i+1 within
        # the same tick. Each pass touches one cell (and one prop row) per
        # env: a gather and a masked scatter along dim 1 with a [B, 1] index;
        # a pass that does not write routes its row to a scratch column.
        ticks = sc.tile_ticks.reshape(bsz, -1)                          # flat cells
        prop_of = sc.tile_prop.reshape(bsz, -1)
        last_tile = sc.last_tile
        props = state.props
        colors, scales = props.color, props.scale
        green = torch.full((bsz, 1), C.COLOR_IDX["GREEN"], dtype=colors.dtype, device=dev)
        for a in range(num_agents):
            tile_a = agent_tile[:, a:a + 1]                             # [B,1]
            prev = last_tile[:, a:a + 1]
            changed = (tile_a >= 0) & (tile_a != prev)
            # previous tile's timer -> min(current, 3) (cpp:120-125)
            prev_idx = torch.clamp(prev, min=0).long()
            tick_prev = _take(ticks, prev_idx)
            clip = changed & (prev >= 0) & (tick_prev >= 0)
            ticks = _put(ticks, prev_idx, torch.clamp(tick_prev, max=3), clip)
            # arm the new tile with 15 ticks if not armed (cpp:127-141)
            cur_idx = torch.clamp(tile_a, min=0).long()
            arm = changed & (_take(ticks, cur_idx) < 0)
            ticks = _put(ticks, cur_idx, torch.full_like(tile_a, 15), arm)
            # visual: armed tile turns green and inflates 1.05x
            pidx = torch.clamp(_take(prop_of, cur_idx), min=0).long()  # valid whenever arm
            colors = _put(colors, pidx, green, arm)
            scales = _put(scales, pidx, _take(scales, pidx) * 1.05, arm)
            last_tile = torch.cat([last_tile[:, :a], torch.where(changed, tile_a, prev),
                                   last_tile[:, a + 1:]], dim=1)
        props = props.replace(color=colors, scale=scales)

        # tick down armed tiles (cpp:152-173): elementwise on the grids; the
        # prop-table updates gather through the static inverse map prop_cell
        armed = ticks > 0
        ticks = torch.where(armed, ticks - 1, ticks)
        expiring = armed & (ticks == 0)
        inflating = armed & (ticks > 0) & (ticks <= 5)
        cell = torch.clamp(sc.prop_cell, min=0).long()                  # [B,T_MAX]
        has_tile = sc.prop_cell >= 0
        infl_row = torch.gather(inflating, 1, cell) & has_tile
        exp_row = torch.gather(expiring, 1, cell) & has_tile
        props = props.replace(scale=torch.where(infl_row[..., None], props.scale * 1.03,
                                                props.scale))

        # expiry: hide prop, clear voxel solidity
        props = props.replace(flags=torch.where(
            exp_row, props.flags & (0xFF ^ PROP_FLAG_VISIBLE), props.flags))
        tile_active = sc.tile_active & ~expiring.reshape(sc.tile_active.shape)
        # packed solid columns = static base | active tiles at their level
        # heights, built as int32 words (the heights stay below bit 31)
        ov = torch.zeros((bsz, SIZE, SIZE), dtype=i32, device=dev)
        for level in range(L_MAX):
            h = sc.level_h[:, level]
            bit = torch.where(h >= 0, torch.ones_like(h) << torch.clamp(h, min=0),
                              torch.zeros_like(h))
            ov = ov | torch.where(tile_active[:, level], bit[:, None, None],
                                  torch.zeros_like(ov))
        cols = sc.base_cols | ov[:, :, None, :]

        all_on_floor = touches_floor.all(dim=1)
        finish_now = all_on_floor & ~sc.finished
        episode_sec = torch.where(
            finish_now,
            torch.maximum(state.episode_sec, state.episode_len_sec - 0.3),
            state.episode_sec)

        sc = sc.replace(
            tile_ticks=ticks.reshape(sc.tile_ticks.shape),
            tile_active=tile_active, last_tile=last_tile,
            seconds_off_floor=seconds, finished=sc.finished | finish_now)

        # trueObjective (hpp:56-71): winner-take-all if multi-agent (ties go
        # to the lowest agent index, as jnp.argmax)
        if num_agents > 1:
            best = torch.argmax(sc.seconds_off_floor, dim=1)
            tobj = (torch.arange(num_agents, device=dev)[None, :]
                    == best[:, None]).to(f32)
        else:
            tobj = sc.seconds_off_floor / state.episode_len_sec[:, None]

        state = state.replace(
            cols=cols, props=props, scen=sc, episode_sec=episode_sec,
            true_objective=tobj)
        return state, rewards


def num_tiles(scen: BoxAGoneState) -> int:
    """Live tile count of one layout (host-side helper; tile t <-> prop row t)."""
    return int((np.asarray(scen.prop_cell) >= 0).sum())


def tile_cell(scen: BoxAGoneState, t: int) -> int:
    """Flat dense-grid cell index (l*S*S + x*S + z) of tile `t` of one layout
    (host-side helper for tests/introspection)."""
    v = np.asarray(scen.tile_voxel)[t]
    lvl = int(np.nonzero(np.asarray(scen.level_h) == v[1])[0][0])
    return int(lvl * SIZE * SIZE + v[0] * SIZE + v[2])


register_scenario("BoxAGone", BoxAGoneScenario)
