"""Obstacles scenario family (+ Test benchmark scenario); counterpart of
megaverse_tpu/scenarios/obstacles.py.

ref: scenarios/src/scenario_obstacles.cpp + scenario_obstacles.hpp.
A chain of platforms (Start + N random wall/lava/step/gap platforms with turn
corners + Exit), regenerated up to 20 times on self-collision
(reset, scenario_obstacles.cpp:51-195). Movable-box budget from
requiresMovableBoxesToTraverse distributed over preceding platforms
(cpp:172-188), green diamond bonus objects (cpp:190-194, 253-259). Step logic:
exit-pad detection, lava teleport-back, all-agents-at-exit solve
(cpp:197-239). Difficulty variants are FloatParams presets (hpp:94-268).

Deviation from the reference: the dense voxel grid is finite, so the whole
generated course is translated to fit the grid and layouts whose bounding box
exceeds the grid are treated like self-collisions (regenerated). The
reference's sparse hash grid has no such bound.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from megaverse_tpu_torch import constants as C
from megaverse_tpu_torch.ops import grid as G
from megaverse_tpu_torch.scenarios import register_scenario
from megaverse_tpu_torch.scenarios.base import HostScene, Scenario
from megaverse_tpu_torch.scenarios.components import (
    fall_detection_step,
    hide_props,
    object_stacking_step,
)
from megaverse_tpu_torch.scenarios import platforms as P
from megaverse_tpu_torch.types import (EnvState, GridConfig, SceneData, Tree, device_const,
                                       tree_map)
from megaverse_tpu_torch.utils.refrng import ref_spawn_yaw

K_AT_EXIT = "obstaclesAgentAtExit"
K_ALL_AT_EXIT = "obstaclesAllAgentsAtExit"
K_EXTRA = "obstaclesExtraReward"
K_CARRIED = "obstaclesAgentCarriedObjectToExit"


@dataclasses.dataclass
class ObstaclesState(Tree):
    reward_voxel: Any   # i32 [B,R,3] diamond voxels
    reward_prop: Any    # i32 [B,R]
    reward_active: Any  # bool [B,R]
    reached_exit: Any   # bool [B,A]
    solved: Any         # bool [B]


class ObstaclesScenario(Scenario):
    name = "Obstacles"
    scen_cls = ObstaclesState
    platform_types: Tuple[str, ...] = ("WALL", "LAVA", "STEP", "GAP")
    max_boxes = 192  # up to ~8 AABBs per chain segment + terrain quads
    R_MAX = 32  # bonus diamonds: <=1 per non-start/exit segment
    BOX_MAX = 128  # movable boxes
    prop_segments = ((C.PROP_BOX, BOX_MAX), (C.PROP_CONE, 2 * R_MAX))
    needs_terrain_grid = True  # exit pads / lava detection
    needs_object_grid = True   # pick/place stacking
    shaping_keys = (K_AT_EXIT, K_ALL_AT_EXIT, K_EXTRA, K_CARRIED)

    def default_params(self) -> Dict[str, float]:
        p = super().default_params()
        # ref scenario_obstacles.hpp:48-68
        p.update({
            "obstaclesMinNumPlatforms": 1, "obstaclesMaxNumPlatforms": 2,
            "obstaclesMinGap": 1, "obstaclesMaxGap": 2,
            "obstaclesMinLava": 1, "obstaclesMaxLava": 4,
            "obstaclesMinHeight": 1, "obstaclesMaxHeight": 3,
            "obstaclesNumAllowedMaxDifficulty": 1,
        })
        return p

    def _reward_shaping(self) -> Dict[str, float]:
        return {K_AT_EXIT: 1.0, K_ALL_AT_EXIT: 5.0, K_EXTRA: 0.5, K_CARRIED: 0.0}

    def grid_config(self) -> GridConfig:
        n = int(self.params["obstaclesMaxNumPlatforms"])
        side = min(48 + 24 * n, 128)
        ymax = 16 + 4 * n
        return GridConfig(dims=(side, min(ymax, 40), side), voxel_size=1.0,
                          origin=(0.0, 0.0, 0.0))

    # ------------------------------------------------------------- generate
    def generate(self, rng: np.random.Generator) -> SceneData:
        return self._generate_impl(rng, ref=False)

    supports_ref_stream = True

    def generate_ref(self, rng) -> SceneData:
        """Reference draw order (ObstaclesScenario::reset,
        scenario_obstacles.cpp:51-195): drawWalls -> <=20 layout attempts
        (platform chain: type/init/generate draws through the shared
        platform classes) -> layout/wall colors -> start-platform agent
        spawn points -> movable-box budget distribution -> per-platform
        object positions -> bonus-reward positions -> spawnAgents yaws.
        The platform classes draw through Platform.rr, which dispatches on
        the rng type, so the whole chain consumes the mt19937 stream in the
        C++ order. Deviation #3 (finite dense grid) still applies: a layout
        that overflows the grid consumes extra regeneration attempts the
        reference would not."""
        return self._generate_impl(rng, ref=True)

    def _generate_impl(self, rng, ref: bool) -> SceneData:
        fp = self.params
        if ref:
            rr = rng.rand_range
            frand32 = lambda: np.float32(rng.frand())
            yaw_draw = lambda: ref_spawn_yaw(rng)
        else:
            rr = lambda lo, hi: int(rng.integers(lo, hi))
            frand32 = lambda: np.float32(rng.random())
            yaw_draw = lambda: rng.random() * 2 * np.pi
        draw_walls = bool(rr(0, 2))
        dims = np.asarray(self.cfg.grid.dims)

        for attempt in range(40):
            platforms: List[P.Platform] = []
            num_platforms = rr(int(round(fp["obstaclesMinNumPlatforms"])),
                               int(round(fp["obstaclesMaxNumPlatforms"])) + 1)

            start = P.StartPlatform(rng, fp)
            start.init()
            start.generate()
            start.transform = P.Transform()
            platforms.append(start)
            required_width = start.width
            prev = start

            n_max_diff = 0
            allowed_max_diff = int(fp["obstaclesNumAllowedMaxDifficulty"])

            ok = True
            for _ in range(num_platforms):
                orientation = [P.ORIENTATION_STRAIGHT, P.ORIENTATION_TURN_LEFT,
                               P.ORIENTATION_TURN_RIGHT][rr(0, 3)]
                w = required_width if orientation == P.ORIENTATION_STRAIGHT else -1

                newp = None
                while newp is None or (newp.is_max_difficulty() and n_max_diff >= allowed_max_diff):
                    ptype = self.platform_types[rr(0, len(self.platform_types))]
                    newp = P.make_platform(ptype, rng, P.WALLS_WEST | P.WALLS_EAST, fp, w)
                    newp.init()
                if newp.is_max_difficulty():
                    n_max_diff += 1

                newp.generate()
                newp.attach_to(prev.anchor(), orientation, prev.width)
                platforms.append(newp)

                if orientation != P.ORIENTATION_STRAIGHT:
                    walls = P.WALLS_NORTH | (
                        P.WALLS_WEST if orientation == P.ORIENTATION_TURN_LEFT else P.WALLS_EAST)
                    trans = P.TransitionPlatform(rng, walls, fp,
                                                 length=newp.width - 1, width=prev.width)
                    trans.init()
                    trans.generate()
                    trans.transform = prev.anchor()
                    platforms.append(trans)

                prev = newp
                required_width = newp.width

            exitp = P.ExitPlatform(rng, fp, required_width)
            exitp.init()
            exitp.generate()
            exitp.transform = prev.anchor()
            platforms.append(exitp)

            # self-collision check (cpp:146-166): skip adjacent pairs
            collide = False
            for j in range(len(platforms)):
                for k in range(0, j - 2):
                    if platforms[j].collides_with(platforms[k]):
                        collide = True
                        break
                if collide:
                    break

            # grid-fit check (deviation: finite dense grid)
            lo = np.full(3, np.inf)
            hi = np.full(3, -np.inf)
            for p in platforms:
                blo, bhi = p.world_bbox()
                lo = np.minimum(lo, blo)
                hi = np.maximum(hi, bhi)
            fits = bool(np.all(hi - lo <= dims - 2)) and (lo[1] >= -1e-6)

            if not collide and fits:
                break
        # world shift so everything sits inside the grid
        shift = np.floor(-lo + 1).astype(np.int64)
        shift[1] = 0

        scene = HostScene(self.cfg)
        layout_idx = rr(0, len(C.LAYOUT_COLORS))
        wall_idx = rr(0, len(C.LAYOUT_COLORS))
        layout_color = int(C.LAYOUT_COLORS[layout_idx])
        wall_color = int(C.LAYOUT_COLORS[wall_idx])
        # draw-stream debug capture (reference-parity golden tests)
        self._dbg = dict(
            attempt=attempt, walls=draw_walls, n_platforms=num_platforms,
            plats=[(type(q).__name__, q.length, q.width, q.height)
                   for q in platforms],
            colors=(layout_idx, wall_idx))

        def fill_boxes(p: P.Platform, boxes, color, opaque):
            for box in boxes:
                blo, bhi = p.transform.box_world(box.lo, box.hi)
                imin = np.floor(blo + 1e-6).astype(np.int64) + shift
                imax = np.floor(bhi - 1e-6).astype(np.int64) + shift
                scene.fill_box_voxels(imin, imax, C.VOXEL_SOLID, color=0)
                if opaque:
                    # render box (merged large box, like the reference's
                    # per-AABB drawables)
                    g = self.cfg.grid
                    o = np.asarray(g.origin)
                    scene.extra_boxes.append((
                        (o + (blo + shift)).astype(np.float32),
                        (o + (bhi + shift)).astype(np.float32), color))

        for p in platforms:
            fill_boxes(p, p.layout_boxes, layout_color, True)
            fill_boxes(p, p.wall_boxes, wall_color, draw_walls)
            for terrain, tboxes in p.terrain_boxes.items():
                for box in tboxes:
                    blo, bhi = p.transform.box_world(box.lo, box.hi)
                    blo, bhi = blo + shift, bhi + shift
                    imin = np.floor(blo + 1e-6).astype(np.int64)
                    imax = np.ceil(bhi - 1e-6).astype(np.int64) - 1
                    scene.fill_box_voxels(imin, imax, vtype=0, terrain=terrain)
                    # overlay quad (layout_utils.cpp:53-68)
                    color = C.TERRAIN_COLOR_IDX[terrain]
                    scene.extra_boxes.append((
                        np.array([blo[0], blo[1], blo[2]], np.float32),
                        np.array([bhi[0], blo[1] + 0.05, bhi[2]], np.float32),
                        color))

        # agents on the start platform
        spawns = start.agent_spawn_points(self.num_agents)
        while len(spawns) < self.num_agents:
            spawns.append(spawns[0].copy())
        spawns = [s + shift for s in spawns]

        # movable boxes (cpp:172-188)
        num_boxes = [0] * len(platforms)
        for i in range(1, len(platforms)):
            for _ in range(platforms[i].requires_movable_boxes()):
                idx = rr(max(0, i - 2), i)
                num_boxes[idx] += 1

        object_cells: List[np.ndarray] = []
        for i, p in enumerate(platforms):
            # float chain: frand * 0.5f -> f32 product with the count, then
            # lround (half away from zero), cpp:181-183
            frac = np.float32(frand32() * np.float32(0.5))
            prod = np.float32(frac * np.float32(num_boxes[i]))
            fl = float(np.floor(prod))
            extra = int(fl) + int(float(prod) - fl >= 0.5) + rr(0, 2)
            cells = p.generate_object_positions(num_boxes[i] + extra)
            object_cells.extend(cells)

        object_cells = object_cells[: self.BOX_MAX]
        for cell in object_cells:
            scene.add_movable_box(cell + shift)

        # bonus reward diamonds (cpp:190-194, 253-259)
        reward_cells: List[np.ndarray] = []
        for i in range(1, len(platforms) - 1):
            n = rr(0, 2)
            reward_cells.extend(platforms[i].generate_object_positions(n))
        reward_cells = reward_cells[: self.R_MAX]

        # spawnAgents runs after the scenario reset draws (env.cpp:66-68)
        yaws = np.asarray([yaw_draw() for _ in range(self.num_agents)],
                          np.float32)
        scene.spawn_agents_at(np.asarray(spawns, np.float64), None, yaws=yaws)

        reward_voxel = np.zeros((self.R_MAX, 3), np.int32)
        reward_prop = np.zeros((self.R_MAX,), np.int32)
        reward_active = np.zeros((self.R_MAX,), bool)
        for i, cell in enumerate(reward_cells):
            cell = cell + shift
            pos = cell.astype(np.float64) + np.array([0.5, 0.7, 0.5])
            scale = np.array([0.17, 0.45, 0.17]) * 0.8
            top = scene.add_prop(C.PROP_CONE, pos, scale, C.COLOR_IDX["GREEN"])
            scene.add_prop(C.PROP_CONE, pos - np.array([0.0, scale[1], 0.0]),
                           scale * np.array([1, -1, 1]), C.COLOR_IDX["GREEN"])
            reward_voxel[i] = cell
            reward_prop[i] = top
            reward_active[i] = True

        # episode length (cpp:263-268)
        scene.episode_len_sec = max(
            self.params[C.P_EPISODE_LENGTH_SEC],
            num_platforms * 35.0 + len(object_cells) * 1.0,
        )

        scen = ObstaclesState(
            reward_voxel=reward_voxel,
            reward_prop=reward_prop,
            reward_active=reward_active,
            reached_exit=np.zeros((self.num_agents,), bool),
            solved=np.asarray(False),
        )
        return scene.finish(self.max_boxes, scen=scen)

    # ------------------------------------------------------------- step
    def scen_step(self, state: EnvState, action: torch.Tensor, shaping: torch.Tensor):
        cfg = self.cfg.grid
        f32 = torch.float32
        rewards = torch.zeros_like(state.last_reward)

        res = object_stacking_step(cfg, state, action)
        state = res.state
        state, _fell = fall_detection_step(cfg, state)  # agentFell: no penalty
        sc: ObstaclesState = state.scen

        off = device_const((0.0, C.AGENT_BODY_OFFSET_Y, 0.0), f32, state.agents.pos)
        agent_voxel = G.world_to_voxel(cfg, state.agents.pos + off)   # [B,A,3]
        terrain = G.gather_voxel(cfg, state.vterrain, agent_voxel)    # [B,A]

        at_exit = (terrain & C.TERRAIN_EXIT) != 0
        on_lava = (terrain & C.TERRAIN_LAVA) != 0

        # exit rewards (first time per agent)
        newly = at_exit & ~sc.reached_exit
        rewards = self.reward_team(rewards, shaping, K_AT_EXIT, newly.to(f32), 1.0)
        carrying = state.agents.carried >= 0
        rewards = self.reward_team(rewards, shaping, K_CARRIED,
                                   (newly & carrying).to(f32), 1.0)
        sc = sc.replace(reached_exit=sc.reached_exit | newly)

        # lava: teleport back like a fall, no penalty (cpp:225, 276-281).
        # fall_detection_step teleports everyone when the threshold is +inf;
        # select only the agents on lava.
        lava_state, _ = fall_detection_step(cfg, state, fall_threshold=float("inf"))
        agents = tree_map(
            lambda t, f: torch.where(
                on_lava.reshape(on_lava.shape + (1,) * (t.dim() - 2)), t, f),
            lava_state.agents, state.agents)
        state = state.replace(agents=agents)

        # bonus diamonds
        match = ((sc.reward_voxel[:, :, None, :] == agent_voxel[:, None, :, :]).all(dim=-1)
                 & sc.reward_active[:, :, None])                      # [B,R,A]
        collected = match.any(dim=2)
        # one-hot of the first matching agent per diamond
        collector = match & (torch.cumsum(match.to(torch.int32), dim=2) == 1)
        cnt = collector.sum(dim=1).to(f32)                            # [B,A]
        rewards = self.reward_team(rewards, shaping, K_EXTRA, cnt, 1.0)

        flags = hide_props(state.props.flags, sc.reward_prop, collected)
        state = state.replace(props=state.props.replace(flags=flags))
        sc = sc.replace(reward_active=sc.reward_active & ~collected)

        # all agents at exit -> solved (cpp:234-239)
        solve_now = at_exit.all(dim=1) & ~sc.solved                   # [B]
        bonus = self.shaping(shaping, K_ALL_AT_EXIT)
        rewards = rewards + torch.where(solve_now[:, None], bonus, torch.zeros_like(bonus))
        episode_sec = torch.where(
            solve_now,
            torch.maximum(state.episode_sec, state.episode_len_sec - 0.3),
            state.episode_sec)
        sc = sc.replace(solved=sc.solved | solve_now)

        state = state.replace(
            scen=sc,
            episode_sec=episode_sec,
            true_objective=sc.solved.to(f32)[:, None].expand_as(
                state.true_objective).contiguous(),
        )
        return state, rewards


class TestScenario(ObstaclesScenario):
    name = "Test"

    def default_params(self):
        p = super().default_params()
        p["obstaclesMinNumPlatforms"] = 0
        p["obstaclesMaxNumPlatforms"] = 0
        p[C.P_EPISODE_LENGTH_SEC] = 6.0
        return p


class ObstaclesEasyScenario(ObstaclesScenario):
    name = "ObstaclesEasy"


class ObstaclesMediumScenario(ObstaclesScenario):
    name = "ObstaclesMedium"

    def default_params(self):
        p = super().default_params()
        p.update({"obstaclesMinNumPlatforms": 2, "obstaclesMaxNumPlatforms": 4,
                  "obstaclesMinLava": 2, "obstaclesMaxLava": 5})
        return p


class ObstaclesHardScenario(ObstaclesScenario):
    name = "ObstaclesHard"

    def default_params(self):
        p = super().default_params()
        p.update({"obstaclesMinNumPlatforms": 2, "obstaclesMaxNumPlatforms": 7,
                  "obstaclesMinGap": 2, "obstaclesMaxGap": 3,
                  "obstaclesMinLava": 3, "obstaclesMaxLava": 10,
                  "obstaclesMinHeight": 2, "obstaclesMaxHeight": 4})
        return p


class _OnePlatformType(ObstaclesScenario):
    def default_params(self):
        p = super().default_params()
        p.update({"obstaclesMinNumPlatforms": 1, "obstaclesMaxNumPlatforms": 4,
                  "obstaclesMinGap": 1, "obstaclesMaxGap": 3,
                  "obstaclesMinLava": 2, "obstaclesMaxLava": 10,
                  "obstaclesMinHeight": 1, "obstaclesMaxHeight": 3})
        return p

    def _reward_shaping(self):
        rs = super()._reward_shaping()
        rs[K_CARRIED] = 1.0
        return rs


class ObstaclesOnlyWallsScenario(_OnePlatformType):
    name = "ObstaclesWalls"
    platform_types = ("WALL",)


class ObstaclesOnlyStepsScenario(_OnePlatformType):
    name = "ObstaclesSteps"
    platform_types = ("STEP",)


class ObstaclesOnlyLavaScenario(_OnePlatformType):
    name = "ObstaclesLava"
    platform_types = ("LAVA",)


for _cls in (TestScenario, ObstaclesEasyScenario, ObstaclesMediumScenario,
             ObstaclesHardScenario, ObstaclesOnlyWallsScenario,
             ObstaclesOnlyStepsScenario, ObstaclesOnlyLavaScenario):
    register_scenario(_cls.name, _cls)
