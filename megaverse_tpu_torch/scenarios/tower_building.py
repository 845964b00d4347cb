"""TowerBuilding scenario (counterpart of
megaverse_tpu/scenarios/tower_building.py).

ref: scenarios/src/scenario_tower_building.cpp + scenario_tower_building.hpp.
A walled platform with a building zone and a "materials" patch of movable
boxes (TowerBuildingPlatform::init, scenario_tower_building.cpp:19-103);
rewards: first pickup, first zone visit with an object, and a collective
tower reward equal to the delta of sum(height*0.05 + min(0.05*2^h, 20)) over
boxes in the zone (calculateTowerReward, scenario_tower_building.cpp:232-258).
trueObjective = highest tower (hpp:42). teamSpirit defaults to 0.1 (hpp:47).
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
from megaverse_tpu_torch.scenarios.components import (
    fall_detection_step,
    in_zone_xz,
    object_stacking_step,
)
from megaverse_tpu_torch.types import EnvState, GridConfig, SceneData, Tree, device_const
from megaverse_tpu_torch.utils.refrng import ref_spawn_yaw

K_PICKED = "towerPickedUpObject"
K_VISITED = "towerVisitedBuildingZoneWithObject"
K_BUILD = "towerBuildingReward"

MAX_LEN = 30   # length rr(12,30)
MAX_WID = 25   # width rr(12,25)
MAX_BOXES = 8 * 8 + 25  # materials rect (<=7x7=49) + random objects (<=25)


def _height_coeff(y: torch.Tensor) -> torch.Tensor:
    """buildingRewardCoeffForHeight (scenario_tower_building.cpp:248-253)."""
    y = y.to(torch.float32)
    return y * 0.05 + torch.clamp(0.05 * torch.exp2(y), max=20.0)


@dataclasses.dataclass
class TowerState(Tree):
    zone: Any            # i32 [B,4]: x0, x1, z0, z1 (voxel coords)
    picked_flag: Any     # bool [B,A]
    visited_flag: Any    # bool [B,A]
    highest_tower: Any   # i32 [B]
    zone_reward: Any     # f32 [B] current tower reward sum


class TowerBuildingScenario(Scenario):
    name = "TowerBuilding"
    scen_cls = TowerState
    max_boxes = 24
    prop_segments = ((C.PROP_BOX, MAX_BOXES),)
    needs_object_grid = True  # tower reward scans the object-slot grid
    shaping_keys = (K_PICKED, K_VISITED, K_BUILD)

    def grid_config(self) -> GridConfig:
        return GridConfig(dims=(MAX_LEN, 24, MAX_WID), voxel_size=1.0, origin=(0.0, 0.0, 0.0))

    def _reward_shaping(self) -> Dict[str, float]:
        return {C.P_TEAM_SPIRIT: 0.1, K_PICKED: 0.1, K_VISITED: 0.1, K_BUILD: 1.0}

    # ------------------------------------------------------------- generate
    def generate(self, rng: np.random.Generator) -> SceneData:
        rr = lambda lo, hi: int(rng.integers(lo, hi))
        layout_color = int(C.LAYOUT_COLORS[rr(0, len(C.LAYOUT_COLORS))])
        while layout_color == C.COLOR_IDX["BUILDING_ZONE"]:
            layout_color = int(C.LAYOUT_COLORS[rr(0, len(C.LAYOUT_COLORS))])
        wall_color = int(C.LAYOUT_COLORS[rr(0, len(C.LAYOUT_COLORS))])
        draw_walls = bool(rng.integers(0, 2))
        dims = self._draw_platform(rr)
        cand = self._candidates(dims)
        cand = cand[rng.permutation(len(cand))]
        max_rand = min(len(cand) - self.num_agents, 25)
        n_objects = rr(0, max(1, max_rand)) if max_rand >= 0 else 0
        return self._build(dims, layout_color, wall_color, draw_walls, cand,
                           n_objects, rng=rng)

    supports_ref_stream = True

    def generate_ref(self, rng) -> SceneData:
        """Reference draw order (TowerBuildingScenario::reset,
        scenario_tower_building.cpp:129-153 + TowerBuildingPlatform::init,
        cpp:19-103 + DefaultScenario::spawnAgents): layout color (rejecting
        BUILDING_ZONE), platform dims/zones, candidate shuffle, object count,
        THEN wall color + randomBool, then per-agent spawn yaws."""
        lc = lambda: int(C.LAYOUT_COLORS[rng.rand_range(0, len(C.LAYOUT_COLORS))])
        layout_color = lc()
        while layout_color == C.COLOR_IDX["BUILDING_ZONE"]:
            layout_color = lc()
        dims = self._draw_platform(rng.rand_range)
        cand = self._candidates(dims)
        cand_list = [tuple(c) for c in cand]
        rng.shuffle(cand_list)
        cand = np.asarray(cand_list, np.int64).reshape(-1, 3)
        max_rand = min(len(cand) - self.num_agents, 25)
        n_objects = rng.rand_range(0, max(1, max_rand)) if max_rand >= 0 else 0
        wall_color = lc()
        draw_walls = rng.random_bool()
        yaws = [ref_spawn_yaw(rng) for _ in range(self.num_agents)]
        return self._build(dims, layout_color, wall_color, draw_walls, cand,
                           n_objects, yaws=yaws)

    @staticmethod
    def _draw_platform(rr):
        """TowerBuildingPlatform::init dims (cpp:19-55), draw order exact."""
        height = rr(5, 7)
        length = rr(12, 30)
        width = rr(12, 25)
        bz_l = rr(3, 9)
        bz_w = rr(3, 9)
        mat_l = rr(2, 8)
        mat_w = rr(2, 8)
        length = max(bz_l + mat_l + 3, length)
        width = max(bz_w + mat_w + 3, width)
        bz_x = rr(1, length - bz_l - 1)
        bz_z = rr(1, width - bz_w - 1)
        mat_x = rr(1, length - mat_l - 1)
        mat_z = rr(1, width - mat_w - 1)
        return dict(height=height, length=length, width=width,
                    bz_l=bz_l, bz_w=bz_w, mat_l=mat_l, mat_w=mat_w,
                    bz_x=bz_x, bz_z=bz_z, mat_x=mat_x, mat_z=mat_z)

    @staticmethod
    def _candidates(d):
        """Interior spawn candidates (x, 2, z), x-major (cpp:40-43)."""
        return np.array([(x, 2, z) for x in range(1, d["length"] - 1)
                         for z in range(1, d["width"] - 1)], np.int64)

    def _build(self, d, layout_color, wall_color, draw_walls, cand,
               n_objects, rng=None, yaws=None) -> SceneData:
        scene = HostScene(self.cfg)
        height, length, width = d["height"], d["length"], d["width"]
        bz_l, bz_w, bz_x, bz_z = d["bz_l"], d["bz_w"], d["bz_x"], d["bz_z"]
        mat_l, mat_w, mat_x, mat_z = d["mat_l"], d["mat_w"], d["mat_x"], d["mat_z"]

        # floor + 4 walls (Platform::addFloor/addWalls, platforms.hpp:167-190)
        scene.vtype[0:length, 0, 0:width] |= C.VOXEL_SOLID | C.VOXEL_OPAQUE
        scene.vcolor[0:length, 0, 0:width] = layout_color
        wall_flags = C.VOXEL_SOLID | (C.VOXEL_OPAQUE if draw_walls else 0)
        for (xs, zs) in ((np.s_[0:1], np.s_[0:width]),
                         (np.s_[length - 1:length], np.s_[0:width]),
                         (np.s_[0:length], np.s_[0:1]),
                         (np.s_[0:length], np.s_[width - 1:width])):
            scene.vtype[xs, 0:height, zs] |= wall_flags
            if draw_walls:
                scene.vcolor[xs, 0:height, zs] = wall_color

        # building zone overlay (terrain quad at y=1)
        scene.add_terrain_quad(bz_x, bz_z, bz_x + bz_l, bz_z + bz_w, 1.0,
                               C.TERRAIN_BUILDING_ZONE)

        # spawn candidates arrive pre-shuffled (draw order differs by mode)
        a = self.num_agents
        agent_cells = cand[:min(a, len(cand))]
        while len(agent_cells) < a:
            agent_cells = np.concatenate([agent_cells, agent_cells[:1]])
        spawn_idx = a

        obj_cells = cand[spawn_idx:spawn_idx + n_objects].copy()
        # inside materials rect stay at y=2, otherwise drop to floor (y=1)
        in_mat = ((obj_cells[:, 0] >= mat_x) & (obj_cells[:, 0] < mat_x + mat_l)
                  & (obj_cells[:, 2] >= mat_z) & (obj_cells[:, 2] < mat_z + mat_w)) if len(obj_cells) else np.zeros(0, bool)
        obj_cells[~in_mat, 1] = 1
        # bulk materials rectangle at y=1
        bulk = np.array([(x, 1, z) for x in range(mat_x, mat_x + mat_l)
                         for z in range(mat_z, mat_z + mat_w)], np.int64)
        all_objs = np.concatenate([obj_cells, bulk]) if len(obj_cells) else bulk

        scene.spawn_agents_at(agent_cells.astype(np.float64), rng, yaws=yaws)
        init_zone_reward = 0.0
        for cell in all_objs:
            scene.add_movable_box(cell)
            if bz_x <= cell[0] < bz_x + bz_l and bz_z <= cell[2] < bz_z + bz_w:
                y = float(cell[1])
                init_zone_reward += y * 0.05 + min(0.05 * 2.0 ** y, 20.0)

        # episode len += 4 s per movable box (scenario_tower_building.cpp:263-266)
        scene.episode_len_sec = self.params[C.P_EPISODE_LENGTH_SEC] + 4.0 * len(all_objs)

        scen = TowerState(
            zone=np.array([bz_x, bz_x + bz_l, bz_z, bz_z + bz_w], np.int32),
            picked_flag=np.zeros((a,), bool),
            visited_flag=np.zeros((a,), bool),
            highest_tower=np.int32(0),
            zone_reward=np.float32(init_zone_reward),
        )
        return scene.finish(self.max_boxes, scen=scen)

    # ------------------------------------------------------------- step
    def _tower_reward(self, state: EnvState, zone: torch.Tensor) -> torch.Tensor:
        """calculateTowerReward from the object-slot grid -> f32 [B]."""
        dims = self.cfg.grid.dims
        dev = zone.device
        xi = torch.arange(dims[0], device=dev).view(1, -1, 1, 1)
        zi = torch.arange(dims[2], device=dev).view(1, 1, 1, -1)
        yi = torch.arange(dims[1], device=dev)
        zn = zone.view(-1, 4, 1, 1, 1)
        in_zone = ((xi >= zn[:, 0]) & (xi < zn[:, 1]) & (zi >= zn[:, 2]) & (zi < zn[:, 3]))
        has_obj = state.vobj != 0
        coeff = _height_coeff(yi).view(1, 1, -1, 1)
        return torch.where(in_zone & has_obj, coeff, torch.zeros_like(coeff)).sum(dim=(1, 2, 3))

    def scen_step(self, state: EnvState, action: torch.Tensor, shaping: torch.Tensor):
        cfg = self.cfg.grid
        f32 = torch.float32
        rewards = torch.zeros_like(state.last_reward)

        res = object_stacking_step(cfg, state, action, place_zone=state.scen.zone)
        state = res.state
        sc: TowerState = state.scen

        # pickedObject: first pickup reward (scenario_tower_building.cpp:216-225)
        first_pick = res.picked & ~sc.picked_flag
        rewards = self.reward_agent(rewards, shaping, K_PICKED, first_pick.to(f32), 1.0)
        sc = sc.replace(picked_flag=sc.picked_flag | res.picked)

        # placedObject: collective tower reward delta + highest tower
        new_total = self._tower_reward(state, sc.zone)
        delta = new_total - sc.zone_reward
        any_placed = res.placed.any(dim=1)
        placer_mask = (res.placed & (torch.cumsum(res.placed.to(torch.int32), dim=1) == 1)).to(f32)
        rewards = self.reward_team(
            rewards, shaping, K_BUILD, placer_mask,
            torch.where(any_placed, delta, torch.zeros_like(delta)))
        sc = sc.replace(zone_reward=torch.where(any_placed, new_total, sc.zone_reward))

        placed_heights = torch.where(
            res.placed & in_zone_xz(sc.zone, res.place_voxel),
            res.place_voxel[..., 1], torch.zeros_like(res.place_voxel[..., 1]))
        # buildingZone.min.y == 1, highest = y - 1 + 1 (cpp:213)
        sc = sc.replace(highest_tower=torch.maximum(
            sc.highest_tower, placed_heights.amax(dim=1).to(torch.int32)))

        # fall detection
        state, _fell = fall_detection_step(cfg, state.replace(scen=sc))
        sc = state.scen

        # visiting the zone while carrying (scenario_tower_building.cpp:177-196)
        off = device_const((0.0, C.AGENT_BODY_OFFSET_Y, 0.0), f32, state.agents.pos)
        agent_voxel = G.world_to_voxel(cfg, state.agents.pos + off)
        carrying = state.agents.carried >= 0
        in_zone = in_zone_xz(sc.zone, agent_voxel)
        first_visit = carrying & in_zone & ~sc.visited_flag
        rewards = self.reward_team(rewards, shaping, K_VISITED, first_visit.to(f32), 1.0)
        sc = sc.replace(visited_flag=sc.visited_flag | first_visit)

        state = state.replace(
            scen=sc,
            true_objective=sc.highest_tower.to(f32)[:, None].expand_as(
                state.true_objective).contiguous(),
        )
        return state, rewards


register_scenario("TowerBuilding", TowerBuildingScenario)
