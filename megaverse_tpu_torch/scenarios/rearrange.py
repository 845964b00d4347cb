"""Rearrange scenario (counterpart of megaverse_tpu/scenarios/rearrange.py).

ref: scenarios/src/scenario_rearrange.cpp + scenario_rearrange.hpp.
A 19x14 walled room with two pedestals: the target arrangement (2-8 items of
random shape x color, generated by BFS within a +-2 box, cpp:64-124) displayed
on the left pedestal, and a shuffled interactive copy on the right
(arrangementDrawables, cpp:202-265). Agents rearrange the right-side objects
with pick/place; reward for each new maximum of matching objects and for the
full match (checkDone, cpp:162-179). Invisible solid rings at y=1 block the
pedestals (addEpisodeDrawables, cpp:267-276).
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
from megaverse_tpu_torch.scenarios.components import object_stacking_step
from megaverse_tpu_torch.types import EnvState, GridConfig, SceneData, Tree, device_const
from megaverse_tpu_torch.utils.refrng import ref_spawn_yaw

K_ONE_MORE = "rearrangeOneMoreObjectCorrectPosition"
K_ALL = "rearrangeAllObjectsCorrectPosition"

N_MAX = 8
LEFT = np.array([5, 2, 5])
RIGHT = np.array([13, 2, 5])
# (x0, x1, z0, z1) of the voxels objects may be placed in
PLACE_ZONE = (int(RIGHT[0]) - 2, int(RIGHT[0]) + 3, int(RIGHT[2]) - 2, int(RIGHT[2]) + 3)

# shape id -> (prop type, visual scale) (arrangementDrawables, cpp:204-211)
_SHAPES = (
    (C.PROP_CYLINDER, np.array([0.9, 2.0, 0.9]) * 0.45),
    (C.PROP_CAPSULE, np.array([0.8, 0.5, 0.8]) * 0.45),
    (C.PROP_BOX, np.array([1.0, 1.0, 1.0]) * 0.45),
    (C.PROP_SPHERE, np.array([1.0, 1.0, 1.0]) * 0.45),
)


@dataclasses.dataclass
class RearrangeState(Tree):
    arr_offset: Any    # i32 [B,N,3] target offsets from RIGHT center
    arr_shape: Any     # i32 [B,N] shape ids
    arr_color: Any     # i32 [B,N]
    arr_valid: Any     # bool [B,N]
    obj_prop: Any      # i32 [B,N] interactive object prop index
    obj_shape: Any     # i32 [B,N]
    obj_color: Any     # i32 [B,N]
    obj_valid: Any     # bool [B,N]
    max_matching: Any  # i32 [B]
    solved: Any        # bool [B]


class RearrangeScenario(Scenario):
    name = "Rearrange"
    scen_cls = RearrangeState
    max_boxes = 32
    # items are (display + interactive) of a random shape each; every typed
    # region must hold the worst case of all 2*N_MAX being that shape
    prop_segments = (
        (C.PROP_CYLINDER, 2 * N_MAX),
        (C.PROP_CAPSULE, 2 * N_MAX),
        (C.PROP_BOX, 2 * N_MAX),
        (C.PROP_SPHERE, 2 * N_MAX),
    )
    needs_object_grid = True  # pick/place stacking
    shaping_keys = (K_ONE_MORE, K_ALL)

    def grid_config(self) -> GridConfig:
        return GridConfig(dims=(19, 10, 14), voxel_size=1.0, origin=(0.0, 0.0, 0.0))

    def _reward_shaping(self) -> Dict[str, float]:
        return {K_ONE_MORE: 1.0, K_ALL: 10.0}

    # ------------------------------------------------------------- generate
    def _generate_arrangement(self, rr, shuffle_dirs):
        """BFS arrangement (generateArrangement, cpp:64-124). `shuffle_dirs`
        permutes the PERSISTENT direction list in place each round, exactly
        like the reference's std::shuffle of its `directions` vector."""
        size = rr(2, 8)
        dirs = [np.array(d) for d in
                ((-1, 0, 0), (1, 0, 0), (0, 1, 0), (0, 0, -1), (0, 0, 1))]

        def random_item(offset):
            shape = rr(0, 4)
            color = int(C.OBJECT_COLORS[rr(0, len(C.OBJECT_COLORS))])
            return (shape, color, offset)

        items = [random_item(np.zeros(3, np.int64))]
        used = {(0, 0, 0)}
        queue = [items[0]]
        while queue and len(items) < size:
            curr = queue.pop(0)
            max_branches = rr(1, 6)
            max_branches = rr(1, max_branches + 1)
            shuffle_dirs(dirs)
            n_branches = 0
            for d in dirs:
                off = curr[2] + d
                below = off - np.array([0, 1, 0])
                if off[1] >= 2 or abs(off[0]) >= 2 or abs(off[2]) >= 2:
                    continue
                if tuple(off) in used:
                    continue
                if not (off[1] == 0 or tuple(below) in used):
                    continue
                item = random_item(off)
                queue.append(item)
                items.append(item)
                used.add(tuple(off))
                n_branches += 1
                if n_branches >= max_branches or len(items) >= size:
                    break
        return items

    def _right_offsets(self, items, rr):
        """Interactive-copy placement (arrangementDrawables interactive=True,
        cpp:215-233): the first numUnmoved keep their offsets, the rest
        rejection-sample free (x,0,z) cells in [-2,2]^2."""
        occupied = {tuple(it[2]) for it in items}
        num_unmoved = rr(0, len(items))
        offs = []
        for i, (shape, color, off) in enumerate(items):
            pos_off = off
            if i >= num_unmoved:
                new_off = off
                while tuple(new_off) in occupied:
                    new_off = np.array([rr(-2, 3), 0, rr(-2, 3)], np.int64)
                occupied.add(tuple(new_off))
                pos_off = new_off
            offs.append(pos_off)
        return offs

    def _spawn_positions(self, rr, length, width):
        # agentStartingPositions (cpp:216-236): <=20 attempts per agent,
        # rejecting cells within 2 of either pedestal center.
        positions = np.zeros((self.num_agents, 3))
        for i in range(self.num_agents):
            for _ in range(20):
                ax = rr(2, length - 1)
                az = rr(2, width - 1)
                if abs(ax - LEFT[0]) < 2 and abs(az - LEFT[2]) < 2:
                    continue
                if abs(ax - RIGHT[0]) < 2 and abs(az - RIGHT[2]) < 2:
                    continue
                positions[i] = [ax, 2, az]
                break
        return positions

    def generate(self, rng: np.random.Generator) -> SceneData:
        rr = lambda lo, hi: int(rng.integers(lo, hi))
        draw_walls = bool(rr(0, 2))
        height = rr(4, 7)

        def np_shuffle(dirs):
            order = rng.permutation(len(dirs))
            dirs[:] = [dirs[i] for i in order]

        items = self._generate_arrangement(rr, np_shuffle)
        right_offsets = self._right_offsets(items, rr)
        positions = self._spawn_positions(rr, 19, 14)
        yaws = np.asarray([rng.random() * 2 * np.pi
                           for _ in range(self.num_agents)], np.float32)
        return self._build(draw_walls, height, items, right_offsets,
                           positions, yaws)

    supports_ref_stream = True

    def generate_ref(self, rng) -> SceneData:
        """Reference draw order (RearrangeScenario::reset, cpp:46-62:
        platform height -> addPlatform randomBool walls -> BFS arrangement;
        then spawnAgents position draws + yaws, scenario_default.hpp:80-97;
        then the interactive-copy draws in addEpisodeDrawables,
        cpp:215-233)."""
        height = rng.rand_range(4, 7)
        draw_walls = rng.random_bool()
        items = self._generate_arrangement(rng.rand_range, rng.shuffle)
        positions = self._spawn_positions(rng.rand_range, 19, 14)
        yaws = np.asarray([ref_spawn_yaw(rng) for _ in range(self.num_agents)],
                          np.float32)
        right_offsets = self._right_offsets(items, rng.rand_range)
        return self._build(draw_walls, height, items, right_offsets,
                           positions, yaws)

    def _build(self, draw_walls, height, items, right_offsets, positions,
               yaws) -> SceneData:
        scene = HostScene(self.cfg)
        length, width = 19, 14

        dark = C.COLOR_IDX["DARK_GREY"]
        # floor + walls (RearrangePlatform + vg.addPlatform)
        scene.vtype[0:length, 0, 0:width] |= C.VOXEL_SOLID | C.VOXEL_OPAQUE
        scene.vcolor[0:length, 0, 0:width] = dark
        wall_flags = C.VOXEL_SOLID | (C.VOXEL_OPAQUE if draw_walls else 0)
        for (xs, zs) in ((np.s_[0:1], np.s_[0:width]),
                         (np.s_[length - 1:length], np.s_[0:width]),
                         (np.s_[0:length], np.s_[0:1]),
                         (np.s_[0:length], np.s_[width - 1:width])):
            scene.vtype[xs, 0:height, zs] |= wall_flags
            if draw_walls:
                scene.vcolor[xs, 0:height, zs] = dark

        # invisible solid rings at y=1 around both pedestals (cpp:270-276)
        for center in (LEFT, RIGHT):
            scene.vtype[center[0] - 3:center[0] + 4, 1,
                        center[2] - 3:center[2] + 4] |= C.VOXEL_SOLID

        # pedestals (cpp:281-295)
        pc = np.array([9.5, 0.0, 7.0])
        scene.add_static_box((8.35, 0.5, 5.65), pc + [0, 1, 0], dark, solid=False)
        lf = LEFT.astype(float)
        rt = RIGHT.astype(float)
        white = C.COLOR_IDX["WHITE"]
        blue = C.COLOR_IDX["BLUE"]
        scene.add_static_box((3, 0.5, 3), lf + [0.5, -0.5, 0.5], white, solid=False)
        scene.add_static_box((1.5, 0.5, 1.5), lf + [0.5, -0.45, 0.5], dark, solid=False)
        scene.add_static_box((3, 0.5, 3), lf + [1.0, -0.66, 1.0], white, solid=False)
        scene.add_static_box((3, 0.5, 3), lf + [1.5, -0.82, 1.5], white, solid=False)
        scene.add_static_box((3, 0.5, 3), rt + [0.5, -0.5, 0.5], blue, solid=False)
        scene.add_static_box((1.5, 0.5, 1.5), rt + [0.5, -0.45, 0.5], dark, solid=False)
        scene.add_static_box((3, 0.5, 3), rt + [0, -0.66, 1.0], blue, solid=False)
        scene.add_static_box((3, 0.5, 3), rt + [-0.5, -0.82, 1.5], blue, solid=False)

        arr_offset = np.zeros((N_MAX, 3), np.int32)
        arr_shape = np.zeros((N_MAX,), np.int32)
        arr_color = np.zeros((N_MAX,), np.int32)
        arr_valid = np.zeros((N_MAX,), bool)
        obj_prop = np.zeros((N_MAX,), np.int32)
        obj_shape = np.zeros((N_MAX,), np.int32)
        obj_color = np.zeros((N_MAX,), np.int32)
        obj_valid = np.zeros((N_MAX,), bool)

        # display copy (left, non-interactive)
        for i, (shape, color, off) in enumerate(items):
            ptype, scale = _SHAPES[shape]
            center = (LEFT + off).astype(float) + 0.5
            scene.add_prop(ptype, center, scale, color)
            arr_offset[i] = off
            arr_shape[i] = shape
            arr_color[i] = color
            arr_valid[i] = True

        # interactive copy (right)
        for i, (shape, color, off) in enumerate(items):
            pos = RIGHT + right_offsets[i]
            ptype, scale = _SHAPES[shape]
            center = pos.astype(float) + 0.5
            idx = scene.add_prop(ptype, center, scale, color, solid=True, movable=True)
            scene.vobj[tuple(pos)] = idx + 1
            scene.vtype[tuple(pos)] |= C.VOXEL_SOLID
            obj_prop[i] = idx
            obj_shape[i] = shape
            obj_color[i] = color
            obj_valid[i] = True

        scene.spawn_agents_at(positions, None, yaws=yaws)

        scen = RearrangeState(
            arr_offset=arr_offset, arr_shape=arr_shape, arr_color=arr_color,
            arr_valid=arr_valid, obj_prop=obj_prop, obj_shape=obj_shape,
            obj_color=obj_color, obj_valid=obj_valid,
            max_matching=np.int32(0),
            solved=np.asarray(False),
        )
        sd = scene.finish(self.max_boxes, scen=scen)
        # host-side initial matching (maxMatchingObjects, cpp:279)
        scen.max_matching = np.int32(self._count_matching_host(sd))
        return sd

    def _count_matching_host(self, sd: SceneData) -> int:
        sc = sd.scen
        match = 0
        for i in range(N_MAX):
            if not sc.obj_valid[i]:
                continue
            pos = np.floor(np.asarray(sd.props.pos)[sc.obj_prop[i]]).astype(int)
            off = pos - RIGHT
            for j in range(N_MAX):
                if (sc.arr_valid[j] and sc.arr_shape[j] == sc.obj_shape[i]
                        and sc.arr_color[j] == sc.obj_color[i]
                        and np.array_equal(sc.arr_offset[j], off)):
                    match += 1
                    break
        return match

    # ------------------------------------------------------------- step
    def _count_matching(self, state: EnvState) -> torch.Tensor:
        """Interactive items on a target cell of their shape and colour,
        carried ones excluded: int [B]."""
        sc: RearrangeState = state.scen
        cfg = self.cfg.grid
        obj_prop = sc.obj_prop.long()
        pos = state.props.pos[G._bidx(obj_prop), obj_prop]              # [B,N,3]
        right = device_const(RIGHT, torch.int32, pos)
        off = G.world_to_voxel(cfg, pos) - right
        ag_carried = state.agents.carried.to(torch.int32)               # [B,A]
        carried = ((sc.obj_prop[:, :, None] == ag_carried[:, None, :])
                   & (ag_carried[:, None, :] >= 0)).any(dim=2)          # [B,N]
        # item i matches if there is a target j with its shape/color/offset
        same = ((sc.arr_shape[:, None, :] == sc.obj_shape[:, :, None])
                & (sc.arr_color[:, None, :] == sc.obj_color[:, :, None])
                & (sc.arr_offset[:, None, :, :] == off[:, :, None, :]).all(dim=-1)
                & sc.arr_valid[:, None, :])                             # [B,N,N]
        return (same.any(dim=2) & sc.obj_valid & ~carried).sum(dim=1)

    def scen_step(self, state: EnvState, action: torch.Tensor, shaping: torch.Tensor):
        f32 = torch.float32
        rewards = torch.zeros_like(state.last_reward)
        cfg = self.cfg.grid
        # objects go down within 2 voxels of the right pedestal's centre in x
        # and z: the half-open rectangle RIGHT +- (2, 3), one row for every env
        zone = device_const(PLACE_ZONE, torch.int32, action).expand(action.shape[0], 4)
        res = object_stacking_step(cfg, state, action, place_zone=zone)
        state = res.state
        sc: RearrangeState = state.scen

        # checkDone after pick or place (cpp:149-179)
        acted = res.picked | res.placed                                 # [B,A]
        any_acted = acted.any(dim=1)
        matches = self._count_matching(state)                           # [B]
        improved = (matches > sc.max_matching) & any_acted
        actor = (acted & (torch.cumsum(acted.to(torch.int32), dim=1) == 1)).to(f32)
        rewards = self.reward_team(rewards, shaping, K_ONE_MORE,
                                   actor * improved.to(f32)[:, None], 1.0)
        n_items = sc.arr_valid.sum(dim=1)
        solve_now = (matches >= n_items) & any_acted & ~sc.solved
        rewards = self.reward_team(rewards, shaping, K_ALL,
                                   actor * solve_now.to(f32)[:, None], 1.0)
        episode_sec = torch.where(
            solve_now,
            torch.maximum(state.episode_sec, state.episode_len_sec - 0.3),
            state.episode_sec)

        solved = sc.solved | solve_now
        sc = sc.replace(
            max_matching=torch.where(improved, matches, sc.max_matching).to(torch.int32),
            solved=solved)
        state = state.replace(
            scen=sc, episode_sec=episode_sec,
            true_objective=solved.to(f32)[:, None].expand_as(
                state.true_objective).contiguous())
        return state, rewards


register_scenario("Rearrange", RearrangeScenario)
