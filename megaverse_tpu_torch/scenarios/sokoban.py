"""Sokoban scenario (counterpart of megaverse_tpu/scenarios/sokoban.py):
Boxoban levels at voxel size 2.

ref: scenarios/src/scenario_sokoban.cpp + scenario_sokoban.hpp.
Parses '# $ . @ *' char maps (createLayout, cpp:120-166): floor at y=0,
invisible solid walls (y=1..2) capped with orange blocks, light-green goal
pads, dark-blue pushable boxes. Discrete box pushing on Interact with
manhattan-adjacency + occupancy checks and goal-count rewards (step,
cpp:168-233). Episode length 80 s (hpp:50-54).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List

import numpy as np
import torch

from megaverse_tpu_torch import constants as C
from megaverse_tpu_torch.ops import grid as G
from megaverse_tpu_torch.scenarios import register_scenario
from megaverse_tpu_torch.scenarios.base import HostScene, Scenario
from megaverse_tpu_torch.scenarios.components import pickup_spot
from megaverse_tpu_torch.types import EnvState, GridConfig, SceneData, Tree, device_const
from megaverse_tpu_torch.utils.boxoban import LevelSource
from megaverse_tpu_torch.utils.refrng import ref_spawn_yaw

K_ON = "sokobanBoxOnTarget"
K_OFF = "sokobanBoxLeavesTarget"
K_ALL = "sokobanAllBoxesOnTarget"

SIZE = 10       # boxoban levels are 10x10
VOXEL = 2.0     # ref voxelSize = 2 (hpp:67)
MAX_SOKO_BOXES = 8

_FLOOR_COLORS = [C.COLOR_IDX[n] for n in (
    "WHITE", "VERY_LIGHT_YELLOW", "VERY_LIGHT_BLUE", "VERY_LIGHT_ORANGE", "DARK_GREY")]


@dataclasses.dataclass
class SokobanState(Tree):
    goal: Any            # bool [B,X,Z] goal pads
    wall: Any            # bool [B,X,Z] wall cells
    num_boxes: Any       # i32 [B]
    boxes_on_goal: Any   # i32 [B]
    solved: Any          # bool [B]


class SokobanScenario(Scenario):
    name = "Sokoban"
    scen_cls = SokobanState
    max_boxes = 64
    prop_segments = ((C.PROP_BOX, MAX_SOKO_BOXES),)
    needs_object_grid = True  # discrete box pushing
    shaping_keys = (K_ON, K_OFF, K_ALL)

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._levels = LevelSource()

    def default_params(self) -> Dict[str, float]:
        p = super().default_params()
        p[C.P_EPISODE_LENGTH_SEC] = 80.0
        return p

    def _reward_shaping(self) -> Dict[str, float]:
        return {K_ON: 1.0, K_OFF: -1.0, K_ALL: 10.0}

    def grid_config(self) -> GridConfig:
        return GridConfig(dims=(SIZE, 4, SIZE), voxel_size=VOXEL, origin=(0.0, 0.0, 0.0))

    # ------------------------------------------------------------- generate
    def generate(self, rng: np.random.Generator) -> SceneData:
        rows = self._levels.sample(rng)
        floor_color = int(_FLOOR_COLORS[int(rng.integers(0, len(_FLOOR_COLORS)))])
        yaws = (rng.random(self.num_agents) * 2 * np.pi).astype(np.float32)
        return self._build(rows, floor_color, yaws)

    supports_ref_stream = True

    def generate_ref(self, rng) -> SceneData:
        # Reference draw order per reset (env.cpp:57-76 + scenario_sokoban.cpp):
        # [cache empty only] randomSample(levelFiles) + std::shuffle(levels)
        # (reloadLevels, cpp:81-102) -> pop back (no draw, cpp:104-118) ->
        # floorColor randomSample of 5 (createLayout, cpp:120-126) ->
        # per-agent spawn yaw (scenario_default.hpp:86). The level cache hangs
        # off `rng`, the env's persistent stream object (utils/boxoban.py).
        rows = self._levels.sample_ref(rng)
        floor_color = int(_FLOOR_COLORS[rng.rand_range(0, len(_FLOOR_COLORS))])
        yaws = np.asarray([ref_spawn_yaw(rng) for _ in range(self.num_agents)],
                          np.float32)
        return self._build(rows, floor_color, yaws)

    def _build(self, rows, floor_color: int, yaws: np.ndarray) -> SceneData:
        scene = HostScene(self.cfg)

        goal = np.zeros((SIZE, SIZE), bool)
        wall = np.zeros((SIZE, SIZE), bool)
        boxes: List[np.ndarray] = []
        player = None

        for x in range(min(len(rows), SIZE)):
            row = rows[x]
            for z in range(min(len(row), SIZE)):
                ch = row[z]
                scene.vtype[x, 0, z] |= C.VOXEL_SOLID | C.VOXEL_OPAQUE
                scene.vcolor[x, 0, z] = floor_color
                if ch == "#":
                    scene.vtype[x, 1:3, z] |= C.VOXEL_SOLID  # invisible solid
                    wall[x, z] = True
                if ch in ".+*":
                    goal[x, z] = True
                if ch in "@+":
                    player = (x, z)
                if ch in "$*":
                    boxes.append(np.array([x, 1, z]))

        # wall caps (orange, h=0.35) and goal pads (light green, h=0.025),
        # addEpisodeDrawables cpp:237-255 — merged along z runs per row.
        def emit_runs(mask, height, color):
            for x in range(SIZE):
                z = 0
                while z < SIZE:
                    if mask[x, z]:
                        z0 = z
                        while z < SIZE and mask[x, z]:
                            z += 1
                        scene.extra_boxes.append((
                            np.array([x * VOXEL, VOXEL, z0 * VOXEL], np.float32),
                            np.array([(x + 1) * VOXEL, VOXEL + height, z * VOXEL], np.float32),
                            color))
                    else:
                        z += 1

        emit_runs(wall, 0.7, C.COLOR_IDX["LIGHT_ORANGE"])
        emit_runs(goal, 0.05, C.COLOR_IDX["LIGHT_GREEN"])

        # agents spawn around the player cell (createLayout, cpp:150-157)
        px, pz = player if player else (1, 1)
        spawns = np.zeros((self.num_agents, 3), np.float32)
        for i in range(self.num_agents):
            ax = px + (i % 2) * 0.5
            az = pz + (1 if (i % 4) > 1 else 0) * 0.5
            spawns[i] = [ax * VOXEL + 0.5, VOXEL + 0.3 * i * VOXEL + C.AGENT_HEIGHT,
                         az * VOXEL + 0.5]
        scene.agent_spawn = spawns
        scene.agent_yaw = np.asarray(yaws, np.float32)

        # pushable boxes: dark blue, drawn (1, 0.45, 1)*0.8 half extents at
        # y offset +0.2*vs (cpp:257-275); voxel-solid for physics.
        for cell in boxes:
            x, y, z = cell
            center = np.array([(x + 0.5) * VOXEL, (y + 0.2) * VOXEL, (z + 0.5) * VOXEL])
            idx = scene.add_prop(C.PROP_BOX, center, (0.8, 0.36, 0.8),
                                 C.COLOR_IDX["DARK_BLUE"], solid=True, movable=True)
            scene.vobj[x, y, z] = idx + 1
            scene.vtype[x, y, z] |= C.VOXEL_SOLID

        scen = SokobanState(
            goal=goal, wall=wall,
            num_boxes=np.int32(len(boxes)),
            boxes_on_goal=np.int32(sum(1 for b in boxes if goal[b[0], b[2]])),
            solved=np.asarray(False),
        )
        return scene.finish(self.max_boxes, scen=scen)

    # ------------------------------------------------------------- step
    def scen_step(self, state: EnvState, action: torch.Tensor, shaping: torch.Tensor):
        """Multi-agent ticks run as SEQUENTIAL per-agent passes, matching the
        reference's per-agent push loop (scenario_sokoban.cpp:168-233): agent
        i's push mutates the object grid agent i+1 then queries in the same
        tick (a push can clear, or newly block, a later agent's target cell).
        Single-agent envs take the one-pass path directly."""
        if self.num_agents == 1:
            return self._soko_pass(state, action, shaping)
        rewards = torch.zeros_like(state.last_reward)
        idx = torch.arange(self.num_agents, device=action.device)
        for a in range(self.num_agents):
            act_a = torch.where(idx == a, action, action & ~C.ACTION_INTERACT)
            state, r = self._soko_pass(state, act_a, shaping)
            rewards = rewards + r
        return state, rewards

    def _soko_pass(self, state: EnvState, action: torch.Tensor, shaping: torch.Tensor):
        cfg = self.cfg.grid
        num_agents = self.num_agents
        f32 = torch.float32
        dev = state.agents.pos.device
        rewards = torch.zeros_like(state.last_reward)
        sc: SokobanState = state.scen

        interact = (action & C.ACTION_INTERACT) != 0                 # [B,A]
        spot = pickup_spot(state.agents)                             # [B,A,3] world
        box_voxel = G.world_to_voxel(cfg, spot)                      # [B,A,3]
        off = device_const((0.0, C.AGENT_BODY_OFFSET_Y, 0.0), f32, dev)
        agent_voxel = G.world_to_voxel(cfg, state.agents.pos + off)

        vobj = G.gather_voxel(cfg, state.vobj, box_voxel)           # [B,A]
        has_box = vobj != 0
        man = (box_voxel - agent_voxel).abs().sum(dim=-1)
        delta = box_voxel - agent_voxel
        desired = box_voxel + delta

        # target occupancy checks (cpp:190-203)
        occupied_by_agent = (
            desired[:, :, None, :] == agent_voxel[:, None, :, :]).all(dim=-1).any(dim=2)
        dims = device_const(cfg.dims, torch.int32, dev)
        des_in = ((desired >= 0) & (desired < dims)).all(dim=-1)
        des_x = torch.clamp(desired[..., 0], 0, SIZE - 1).long()
        des_z = torch.clamp(desired[..., 2], 0, SIZE - 1).long()
        bi = G._bidx(des_x)
        des_wall = sc.wall[bi, des_x, des_z]
        des_obj = G.gather_voxel(cfg, state.vobj, desired) != 0

        push = (interact & has_box & (man == 1) & ~occupied_by_agent
                & des_in & ~des_wall & ~des_obj)
        # conflicts: same box pushed by two agents, or same destination; the
        # lower agent index wins, so the kept rows name distinct cells
        same_box = (box_voxel[:, :, None, :] == box_voxel[:, None, :, :]).all(dim=-1)
        same_dst = (desired[:, :, None, :] == desired[:, None, :, :]).all(dim=-1)
        earlier = torch.tril(torch.ones((num_agents, num_agents), dtype=torch.bool,
                                        device=dev), diagonal=-1)
        lost = ((same_box | same_dst) & earlier & push[:, None, :]).any(dim=2) & push
        push = push & ~lost

        # apply pushes; masked coords (-1 -> dropped): only pushing rows write
        box_idx = torch.clamp(vobj.long() - 1, min=0)
        none = torch.full_like(box_voxel, -1)
        src = torch.where(push[..., None], box_voxel, none)
        dst = torch.where(push[..., None], desired, none)
        vobj_f = G.set_voxel(cfg, state.vobj, src, 0)
        vobj_f = G.set_voxel(cfg, vobj_f, dst, vobj)
        cols_f = G.update_cols(cfg, state.cols, src, False)
        cols_f = G.update_cols(cfg, cols_f, dst, True)

        # agents that do not push add a zero delta to row 0: an accumulate, so
        # they never race a pusher of that row
        props = state.props
        dpos = delta.to(f32) * VOXEL
        new_pos = props.pos.clone()
        new_pos.index_put_((G._bidx(box_idx).expand(box_idx.shape), box_idx),
                           torch.where(push[..., None], dpos, torch.zeros_like(dpos)),
                           accumulate=True)
        state = state.replace(cols=cols_f, vobj=vobj_f, props=props.replace(pos=new_pos))

        # goal bookkeeping (cpp:209-226)
        src_goal = sc.goal[bi, torch.clamp(box_voxel[..., 0], 0, SIZE - 1).long(),
                           torch.clamp(box_voxel[..., 2], 0, SIZE - 1).long()]
        dst_goal = sc.goal[bi, des_x, des_z]
        onto = push & ~src_goal & dst_goal
        leave = push & src_goal & ~dst_goal
        rewards = self.reward_team(rewards, shaping, K_ON, onto.to(f32), 1.0)
        rewards = self.reward_team(rewards, shaping, K_OFF, leave.to(f32), 1.0)

        on_goal = sc.boxes_on_goal + onto.sum(dim=1) - leave.sum(dim=1)
        solve_now = (on_goal == sc.num_boxes) & onto.any(dim=1) & ~sc.solved    # [B]
        # the first agent (in index order) that pushed a box onto a goal
        solver_mask = (onto & (torch.cumsum(onto.to(torch.int32), dim=1) == 1)).to(f32) \
            * solve_now.to(f32)[:, None]
        rewards = self.reward_team(rewards, shaping, K_ALL, solver_mask, 1.0)
        episode_sec = torch.where(
            solve_now,
            torch.maximum(state.episode_sec, state.episode_len_sec - 0.3),
            state.episode_sec)

        solved = sc.solved | solve_now
        sc = sc.replace(boxes_on_goal=on_goal.to(torch.int32), solved=solved)
        state = state.replace(
            scen=sc, episode_sec=episode_sec,
            true_objective=solved.to(f32)[:, None].expand_as(
                state.true_objective).contiguous())
        return state, rewards


register_scenario("Sokoban", SokobanScenario)
