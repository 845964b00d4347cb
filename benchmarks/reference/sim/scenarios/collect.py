"""Collect scenario (counterpart of megaverse_tpu/scenarios/collect.py):
Perlin-noise landscape, good/bad reward diamonds.

ref: scenarios/src/scenario_collect.cpp + scenario_collect.hpp.
Landscape: randomized-frequency octave Perlin heightmap over a random-size
floor (createLandscape, scenario_collect.cpp:35-143); rewards are +-1 diamonds
(70% good, half placed on peaks); collection by walking into the voxel
(step, scenario_collect.cpp:145-178); movable boxes + pick/place; fall
detection with a small penalty (agentFell, scenario_collect.cpp:214-218).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from reference.sim import constants as C
from reference.sim.ops import grid as G
from reference.sim.scenarios import register_scenario
from reference.sim.scenarios.base import HostScene, Scenario
from reference.sim.scenarios.components import (
    fall_detection_step,
    hide_props,
    object_stacking_step,
)
from reference.sim.types import EnvState, GridConfig, SceneData, Tree, device_const
from reference.sim.utils.perlin import PerlinNoise2D
from reference.sim.utils.refperlin import SivPerlin
from reference.sim.utils.refrng import ref_spawn_yaw
from reference.sim.utils.refsort import std_sort

MAX_W = 42                 # maxWidth/maxLength, scenario_collect.cpp:57
R_MAX = 85                 # numRewards <= round(0.05*41*41)+1
OBJ_MAX = 68               # movable boxes bound (objectsMin+1 at area 41x41)

K_GOOD = "collectSingleGood"
K_BAD = "collectSingleBad"
K_ALL = "collectAll"
K_ABYSS = "collectAbyss"

_LANDSCAPE_COLORS = [C.COLOR_IDX[n] for n in (
    "WHITE", "VERY_LIGHT_GREEN", "VERY_LIGHT_BLUE", "VERY_LIGHT_GREY",
    "VERY_LIGHT_ORANGE", "GREY", "DARK_GREY")]
_FLOOR_COLORS = [C.COLOR_IDX[n] for n in ("GREY", "DARK_GREY", "DARK_GREY")]


@dataclasses.dataclass
class CollectState(Tree):
    reward_voxel: Any    # i32 [B,R,3]
    reward_val: Any      # f32 [B,R] (+1 / -1; 0 = unused slot)
    reward_prop: Any     # i32 [B,R] index of the diamond's top cone (bottom = +1)
    reward_active: Any   # bool [B,R]
    num_positive: Any    # i32 [B]
    positives_collected: Any  # i32 [B]
    solved: Any          # bool [B]


class CollectScenario(Scenario):
    name = "Collect"
    scen_cls = CollectState
    max_boxes = 1024
    # typed prop regions: movable boxes | diamond cones (two per diamond)
    prop_segments = ((C.PROP_BOX, OBJ_MAX), (C.PROP_CONE, 2 * R_MAX))
    needs_object_grid = True  # pick/place stacking
    shaping_keys = (K_GOOD, K_BAD, K_ALL, K_ABYSS)

    def grid_config(self) -> GridConfig:
        # floor at y=0; terrain up to intensity*(1-0.2) ~ 14 voxels high.
        return GridConfig(dims=(MAX_W, 20, MAX_W), voxel_size=1.0, origin=(0.0, 0.0, 0.0))

    def _reward_shaping(self) -> Dict[str, float]:
        # scenario_collect.hpp:44-51
        return {K_GOOD: 1.0, K_BAD: -1.0, K_ALL: 5.0, K_ABYSS: -0.5}

    # ------------------------------------------------------------- generate
    def generate(self, rng: np.random.Generator) -> SceneData:
        land_color = int(rng.choice(_LANDSCAPE_COLORS))
        floor_color = int(rng.choice(_FLOOR_COLORS))

        width = int(rng.integers(8, MAX_W))
        length = int(rng.integers(8, MAX_W))

        frequency = float(rng.integers(1, 100)) / 10.0
        octaves = int(rng.integers(1, 10))
        noise_seed = int(rng.integers(0, 1_000_000_000))
        perlin = PerlinNoise2D(noise_seed)
        fx = MAX_W / frequency
        fz = MAX_W / frequency
        intensity = int(rng.integers(5, 18))
        ground_level = rng.random() * 0.5 + 0.2

        xs = np.arange(1, length - 1)
        zs = np.arange(1, width - 1)
        gx, gz = np.meshgrid(xs, zs, indexing="ij")
        noise = perlin.octave_noise_0_1(gx / fx, gz / fz, octaves)
        ycoord = intensity * (noise - ground_level)
        heights = np.where(ycoord >= 1, np.rint(ycoord).astype(np.int64), 0)

        spawn_height = np.ones((length, width), np.int64)
        spawn_height[1:length - 1, 1:width - 1] = np.where(heights > 0, heights + 1, 1)

        # spawn positions: interior cells at their column tops, shuffled
        sp = np.stack([gx.ravel(), spawn_height[1:length - 1, 1:width - 1].ravel(), gz.ravel()], 1)
        order = rng.permutation(len(sp))
        sp = sp[order]

        a = self.num_agents
        agent_cells = sp[:a]
        offset = a

        num_rewards = int(rng.integers(1, int(np.rint(0.05 * width * length)) + 2))
        num_rewards = min(num_rewards, len(sp) - offset, R_MAX)
        n_random = max(num_rewards // 2, 1) if num_rewards > 0 else 0
        n_random = min(n_random, num_rewards)
        reward_cells = [sp[offset:offset + n_random]]
        offset += n_random
        # remaining rewards on the highest peaks (stable sort by height desc)
        rest = sp[offset:]
        heights_rest = spawn_height[rest[:, 0], rest[:, 2]]
        order2 = np.argsort(-heights_rest, kind="stable")
        rest = rest[order2]
        n_peak = num_rewards - n_random
        reward_cells.append(rest[:n_peak])
        rest = rest[n_peak:]
        reward_cells = np.concatenate(reward_cells) if num_rewards else np.zeros((0, 3), np.int64)

        rest = rest[rng.permutation(len(rest))]
        objects_min = max(3, int(length * width * 0.04))
        objects_max = min(objects_min + 1, int(np.rint(0.07 * width * length)) + 2)
        num_objects = min(int(rng.integers(objects_min, max(objects_max, objects_min + 1))),
                          len(rest), OBJ_MAX)
        object_cells = rest[:num_objects]

        yaws = np.asarray([rng.random() * 2.0 * np.pi for _ in range(a)],
                          np.float32)
        reward_good = np.asarray([rng.random() > 0.3 for _ in range(len(reward_cells))])
        return self._build(land_color, floor_color, width, length, heights,
                           agent_cells, reward_cells, object_cells,
                           reward_good, yaws)

    supports_ref_stream = True

    def generate_ref(self, rng) -> SceneData:
        """Reference draw order (createLandscape, scenario_collect.cpp:35-143;
        then spawnAgents yaws, then per-reward good/bad frand draws in
        addEpisodeDrawables, cpp:184-212). Heights reproduce the C++ exactly:
        bit-exact siv Perlin (utils/refperlin.py), f32 groundLevel chain,
        lround via exact floor/frac decomposition; the unstable
        sort-by-height uses the libstdc++ introsort replica
        (utils/refsort.py), the spawn shuffles the std::shuffle replica."""
        land_color = _LANDSCAPE_COLORS[rng.rand_range(0, len(_LANDSCAPE_COLORS))]
        floor_color = _FLOOR_COLORS[rng.rand_range(0, len(_FLOOR_COLORS))]
        width = rng.rand_range(8, MAX_W)
        length = rng.rand_range(8, MAX_W)
        frequency = float(rng.rand_range(1, 100)) / 10.0
        octaves = rng.rand_range(1, 10)
        noise_seed = rng.rand_range(0, 1_000_000_000)
        perlin = SivPerlin(noise_seed)
        fx = MAX_W / frequency
        fz = MAX_W / frequency
        intensity = rng.rand_range(5, 18)
        # float chain: frand * 0.5f + 0.2f (f32), promoted to double below
        gl = float(np.float32(np.float32(rng.frand()) * np.float32(0.5))
                   + np.float32(0.2))

        xs = np.arange(1, length - 1, dtype=np.int64)
        zs = np.arange(1, width - 1, dtype=np.int64)
        gx, gz = np.meshgrid(xs, zs, indexing="ij")
        noise = perlin.accumulated_octave_2d_0_1(gx / fx, gz / fz, octaves)
        ycoord = intensity * (noise - gl)
        # lround for positive doubles without the floor(x+0.5) rounding trap
        yfloor = np.floor(ycoord)
        yround = (yfloor + (ycoord - yfloor >= 0.5)).astype(np.int64)
        heights = np.where(ycoord >= 1, yround, 0)

        spawn_height = np.ones((length, width), np.int64)
        spawn_height[1:length - 1, 1:width - 1] = np.where(heights > 0, heights + 1, 1)

        # x-major interior cell list, std::shuffle'd (cpp:101-109)
        sp = [(int(x), int(spawn_height[x, z]), int(z))
              for x in range(1, length - 1) for z in range(1, width - 1)]
        rng.shuffle(sp)

        a = self.num_agents
        agent_cells = np.asarray(sp[:a], np.int64)
        offset = a

        wl = 0.05 * width * length
        fl = np.floor(wl)
        num_rewards = rng.rand_range(1, int(fl + (wl - fl >= 0.5)) + 2)
        num_rewards = min(num_rewards, len(sp) - offset)
        n_random = max(num_rewards // 2, 1)
        reward_cells = list(sp[offset:offset + n_random])
        offset += n_random

        # unstable sort-by-height desc over the TAIL (cpp:124-132)
        tail = sp[offset:]
        std_sort(tail, lambda p0, p1: p0[1] > p1[1])
        sp[offset:] = tail
        n_peak = num_rewards - n_random
        reward_cells += sp[offset:offset + n_peak]
        offset += n_peak

        tail = sp[offset:]
        rng.shuffle(tail)
        sp[offset:] = tail
        objects_min = max(3, int(length * width * 0.04))
        wl7 = 0.07 * width * length
        fl7 = np.floor(wl7)
        objects_max = min(objects_min + 1, int(fl7 + (wl7 - fl7 >= 0.5)) + 2)
        num_objects = min(rng.rand_range(objects_min, max(objects_max, objects_min + 1)),
                          len(sp) - offset)
        # STRICT < (cpp:139): an exactly-exhausting object count spawns none
        object_cells = (np.asarray(sp[offset:offset + num_objects], np.int64)
                        if offset + num_objects < len(sp)
                        else np.zeros((0, 3), np.int64))

        yaws = np.asarray([ref_spawn_yaw(rng) for _ in range(a)], np.float32)
        reward_good = np.asarray(
            [np.float32(rng.frand()) > np.float32(0.3) for _ in reward_cells])
        return self._build(land_color, floor_color, width, length, heights,
                           agent_cells, np.asarray(reward_cells, np.int64).reshape(-1, 3),
                           object_cells, reward_good, yaws)

    def _build(self, land_color, floor_color, width, length, heights,
               agent_cells, reward_cells, object_cells, reward_good, yaws):
        scene = HostScene(self.cfg)
        # terrain voxels (solid columns 1..h)
        ymax = int(heights.max()) if heights.size else 0
        for y in range(1, ymax + 1):
            mask = heights >= y
            xs_f, zs_f = np.nonzero(mask)
            scene.vtype[xs_f + 1, y, zs_f + 1] |= C.VOXEL_SOLID | C.VOXEL_OPAQUE
            scene.vcolor[xs_f + 1, y, zs_f + 1] = land_color
        # floor (y = 0)
        scene.vtype[:length, 0, :width] |= C.VOXEL_SOLID | C.VOXEL_OPAQUE
        scene.vcolor[:length, 0, :width] = floor_color

        # agents
        scene.spawn_agents_at(np.asarray(agent_cells, np.float64), None, yaws=yaws)

        # movable boxes
        for cell in np.asarray(object_cells, np.int64)[:OBJ_MAX]:
            scene.add_movable_box(cell)

        # reward diamonds (addEpisodeDrawables, scenario_collect.cpp:180-212)
        reward_voxel = np.zeros((R_MAX, 3), np.int32)
        reward_val = np.zeros((R_MAX,), np.float32)
        reward_prop = np.zeros((R_MAX,), np.int32)
        reward_active = np.zeros((R_MAX,), bool)
        num_positive = 0
        reward_cells = np.asarray(reward_cells, np.int64)[:R_MAX]
        for i, cell in enumerate(reward_cells):
            pos = cell.astype(np.float64) + np.array([0.5, 0.8, 0.5])
            if reward_good[i]:
                val, color = 1.0, C.COLOR_IDX["GREEN"]
                num_positive += 1
            else:
                val, color = -1.0, C.COLOR_IDX["RED"]
            # diamond = top cone + flipped bottom cone (layout_utils addDiamond)
            top = scene.add_prop(C.PROP_CONE, pos, (0.17, 0.45, 0.17), color)
            scene.add_prop(C.PROP_CONE, pos - np.array([0.0, 0.45, 0.0]),
                           (0.17, -0.45, 0.17), color)
            reward_voxel[i] = cell
            reward_val[i] = val
            reward_prop[i] = top
            reward_active[i] = True

        # episode length += 2 s per reward (scenario_collect.hpp:53-57)
        scene.episode_len_sec = self.params[C.P_EPISODE_LENGTH_SEC] + 2.0 * len(reward_cells)

        scen = CollectState(
            reward_voxel=reward_voxel,
            reward_val=reward_val,
            reward_prop=reward_prop,
            reward_active=reward_active,
            num_positive=np.int32(num_positive),
            positives_collected=np.int32(0),
            solved=np.asarray(False),
        )
        return scene.finish(self.max_boxes, scen=scen)

    # ------------------------------------------------------------- step
    def scen_step(self, state: EnvState, action: torch.Tensor, shaping: torch.Tensor):
        cfg = self.cfg.grid
        f32 = torch.float32
        rewards = torch.zeros_like(state.last_reward)

        # components (scenario_collect.cpp:147-148)
        res = object_stacking_step(cfg, state, action)
        state = res.state
        state, fell = fall_detection_step(cfg, state)
        # agentFell -> rewardAgent(collectSingleBad) (scenario_collect.cpp:214-218)
        rewards = self.reward_agent(rewards, shaping, K_BAD, fell.to(f32), 1.0)

        sc: CollectState = state.scen
        # agent voxel (absoluteTransformation().translation() = visual origin)
        off = device_const((0.0, C.AGENT_BODY_OFFSET_Y, 0.0), f32, state.agents.pos)
        agent_voxel = G.world_to_voxel(cfg, state.agents.pos + off)  # [B,A,3]

        match = ((sc.reward_voxel[:, :, None, :] == agent_voxel[:, None, :, :]).all(dim=-1)
                 & sc.reward_active[:, :, None])                     # [B,R,A]
        collected = match.any(dim=2)                                 # [B,R]
        # one-hot of the first matching agent per reward (the reference's
        # argmax over a bool row)
        collector = match & (torch.cumsum(match.to(torch.int32), dim=2) == 1)

        good_n = ((collected & (sc.reward_val > 0))[:, :, None] & collector).sum(dim=1).to(f32)
        bad_n = ((collected & (sc.reward_val < 0))[:, :, None] & collector).sum(dim=1).to(f32)
        rewards = self.reward_team(rewards, shaping, K_GOOD, good_n, 1.0)
        rewards = self.reward_team(rewards, shaping, K_BAD, bad_n, 1.0)

        # hide collected diamonds (both cones)
        flags = hide_props(state.props.flags, sc.reward_prop, collected)
        state = state.replace(props=state.props.replace(flags=flags))

        newly_positive = (collected & (sc.reward_val > 0)).sum(dim=1).to(torch.int32)
        positives = sc.positives_collected + newly_positive
        any_collect = collected.any(dim=1)
        solve_now = any_collect & (positives >= sc.num_positive) & ~sc.solved   # [B]
        # solver = lowest-indexed collecting agent (ref: loop order)
        collecting_agents = match.any(dim=1)                         # [B,A]
        solver_mask = (
            collecting_agents
            & (torch.cumsum(collecting_agents.to(torch.int32), dim=1) == 1)
        ).to(f32) * solve_now.to(f32)[:, None]
        rewards = self.reward_team(rewards, shaping, K_ALL, solver_mask, 1.0)

        # doneWithTimer (scenario.hpp:114-117): default 0.3 s remaining
        episode_sec = torch.where(
            solve_now,
            torch.maximum(state.episode_sec, state.episode_len_sec - 0.3),
            state.episode_sec,
        )

        solved = sc.solved | solve_now
        sc = sc.replace(
            reward_active=sc.reward_active & ~collected,
            positives_collected=positives,
            solved=solved,
        )
        state = state.replace(
            scen=sc,
            episode_sec=episode_sec,
            true_objective=solved.to(f32)[:, None].expand_as(
                state.true_objective).contiguous(),
        )
        return state, rewards


register_scenario("Collect", CollectScenario)
