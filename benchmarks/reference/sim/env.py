"""The sim step and the renderer of the frozen reference: plain PyTorch
copies of the port's `env_step` (its inline auto-reset select: the deferred
reset's masked copy computes the same), of its primitive and camera tables,
and of its table renderer's unculled, in-order form (every form of the
program's render kernel gives this image). No kernel, no cull tables.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from reference.sim import constants as C
from reference.sim.ops import physics as P
from reference.sim.ops import raycast as R
from reference.sim.scenarios.base import Scenario
from reference.sim.types import (
    PROP_FLAG_VISIBLE,
    AgentState,
    EnvConfig,
    EnvState,
    PropState,
    SceneData,
    device_const,
    state_from_scene,
    tree_select,
)

INF = 1e30
PRIM_AABB = R.PRIM_AABB
PRIM_ELLIPSOID = R.PRIM_ELLIPSOID
PRIM_CYLINDER = R.PRIM_CYLINDER
PRIM_CONE = R.PRIM_CONE
PRIM_CONE_FLIPPED = R.PRIM_CONE_FLIPPED
PRIM_EYEBOX = R.PRIM_EYEBOX
PRIM_ROTBOX = R.PRIM_ROTBOX
PRIM_ROTBOX_WALL = R.PRIM_ROTBOX_WALL
# conservative bound radius of the eye box: |offset| + |half extents|
_EYE_BOUND = 0.54


class StepResult(NamedTuple):
    state: EnvState
    reward: torch.Tensor          # f32 [B, A]
    done: torch.Tensor            # bool [B] (pre-reset, ref bindings semantics)
    true_objective: torch.Tensor  # f32 [B, A] captured pre-reset (vector_env.cpp:96-103)


DEFERRED_RESET_FIELDS = (
    "cols", "vterrain", "vobj", "box_lo", "box_hi", "box_color", "props")


def env_step(
    scenario: Scenario,
    state: EnvState,
    next_scene: SceneData,
    action: torch.Tensor,     # int32 [B, A] bitmask
    shaping: torch.Tensor,    # f32 [B, A, K]
) -> StepResult:
    """One tick of every env of the batch. No host synchronisation: every
    data-dependent choice is a masked select.

    The step advances the state's voxel grids (`vobj`, `cols`) IN PLACE:
    `state` is consumed (pass a copy to keep it)."""
    cfg = scenario.cfg
    dt = cfg.dt
    vlimit = cfg.param(C.P_VERTICAL_LOOK_LIMIT)

    # Controls (env.cpp:89-122).
    agents = P.apply_look(state.agents, action, dt, vlimit)
    agents = P.apply_acceleration(agents, action, dt)
    state = state.replace(agents=agents)

    # Scenario preStep (env.cpp:124).
    state = scenario.pre_physics(state, action)

    # Physics (env.cpp:126: bWorld.stepSimulation -> KCC playerStep per agent).
    # The packed solid-column grid is the state's canonical collision
    # representation (packed at generation time, updated incrementally by the
    # voxel-mutating scenarios).
    cols = state.cols
    obbs = scenario.collision_obbs(state)
    agents = P.player_step(cfg.grid, state.agents, dt, cols=cols, obbs=obbs)
    agents = P.resolve_agent_collisions(agents, cfg.grid, cols=cols, obbs=obbs)
    state = state.replace(agents=agents)

    # Scenario logic + rewards (env.cpp:131).
    state, reward = scenario.scen_step(state, action, shaping)

    # Timers (env.cpp:133-151). scen_step may have bumped episode_sec via
    # doneWithTimer semantics before the += dt.
    episode_sec = state.episode_sec + dt
    done = state.done | (episode_sec >= state.episode_len_sec)
    state = state.replace(
        episode_sec=episode_sec,
        done=done,
        last_reward=reward,
        total_reward=state.total_reward + reward,
        num_frames=state.num_frames + 1,
    )

    # Capture trueObjective before auto-reset (vector_env.cpp:94-103).
    true_objective = state.true_objective

    # Masked auto-reset from the pre-generated layout (inline select).
    rng = state.rng + 1
    fresh = state_from_scene(next_scene, cfg.num_agents, rng)
    state = tree_select(done, fresh, state.replace(rng=rng))

    return StepResult(state, reward, done, true_objective)



@functools.lru_cache(maxsize=None)
def _packed_palette(device_str: str) -> torch.Tensor:
    # packed-int palette (float-exact: values <= 0xFFFFFF < 2^24)
    pal8 = np.round(np.asarray(C.PALETTE) * 255.0).astype(np.int64)
    packed = (pal8[:, 0] << 16) | (pal8[:, 1] << 8) | pal8[:, 2]
    return torch.tensor(packed, dtype=torch.float32, device=device_str)


def build_prim_table(cfg: EnvConfig, box_lo: torch.Tensor, box_hi: torch.Tensor,
                     box_color: torch.Tensor, props: PropState, agents: AgentState,
                     include_agent_rows: bool = True) -> torch.Tensor:
    """Unified primitive tables [B, M_total, 12].

    include_agent_rows=False drops the agent body/eye rows: for first-person
    rendering with a single agent they can never be visible (the camera sits
    inside both and inside hits are culled)."""
    dev = box_lo.device
    f32 = torch.float32
    palette = _packed_palette(str(dev))
    bsz, m = box_color.shape

    # Layout boxes.
    t_box = (box_color > 0).to(f32) - 1.0   # PRIM_AABB (0) for live boxes, -1 dead
    rows_box = torch.cat(
        [t_box[..., None], box_lo, box_hi, palette[box_color.long()][..., None],
         torch.zeros((bsz, m, 4), dtype=f32, device=dev)], dim=-1)

    # Props.
    p = props.type.shape[1]
    pt = props.type.to(torch.int32)
    visible = ((props.flags & PROP_FLAG_VISIBLE) != 0) & (pt != C.PROP_NONE)
    sc = props.scale.abs()
    flipped = props.scale[..., 1] < 0

    ktype = torch.full_like(pt, -1)
    for cond, k in (
            (pt == C.PROP_ROTBOX_WALL, PRIM_ROTBOX_WALL),
            (pt == C.PROP_ROTBOX, PRIM_ROTBOX),
            ((pt == C.PROP_CONE) & flipped, PRIM_CONE_FLIPPED),
            ((pt == C.PROP_CONE) & ~flipped, PRIM_CONE),
            (pt == C.PROP_CYLINDER, PRIM_CYLINDER),
            ((pt == C.PROP_SPHERE) | (pt == C.PROP_CAPSULE), PRIM_ELLIPSOID),
            (pt == C.PROP_BOX, PRIM_AABB)):
        ktype = torch.where(cond, torch.full_like(pt, k), ktype)
    ktype = torch.where(visible, ktype, torch.full_like(pt, -1)).to(f32)

    is_box = (pt == C.PROP_BOX)[..., None]
    is_rot = ((pt == C.PROP_ROTBOX) | (pt == C.PROP_ROTBOX_WALL))[..., None]
    a_vec = torch.where(is_box, props.pos - sc, props.pos)
    ry = torch.where(pt == C.PROP_CAPSULE, 2.0 * sc[..., 1], sc[..., 1])
    radii = torch.stack([sc[..., 0], ry, sc[..., 2]], dim=-1)
    quad_b = torch.stack([sc[..., 0], sc[..., 2], 0.5 * sc[..., 1]], dim=-1)
    # rotbox rows ship (yaw, cos yaw, sin yaw): the kernel reads the
    # precomputed trig instead of evaluating it per row per pixel
    rot_b = torch.stack([props.yaw, torch.cos(props.yaw), torch.sin(props.yaw)], dim=-1)
    is_ell = ((pt == C.PROP_SPHERE) | (pt == C.PROP_CAPSULE))[..., None]
    b_vec = torch.where(is_box, props.pos + sc,
                        torch.where(is_rot, rot_b, torch.where(is_ell, radii, quad_b)))
    c_vec = torch.where(is_rot, sc, torch.zeros_like(sc))
    # col 11: the fused wall row's edging packed colour
    is_wall = pt == C.PROP_ROTBOX_WALL
    col11 = torch.where(is_wall, palette[props.color2.long()],
                        torch.zeros((bsz, p), dtype=f32, device=dev))
    rows_prop = torch.cat(
        [ktype[..., None], a_vec, b_vec, palette[props.color.long()][..., None],
         c_vec, col11[..., None]], dim=-1)

    if not include_agent_rows:
        return torch.cat([rows_box, rows_prop], dim=1).contiguous()

    # Agent bodies + eye boxes.
    num_agents = agents.pos.shape[1]
    body_off = device_const((0.0, C.AGENT_BODY_OFFSET_Y + 0.09, 0.0), f32, dev)
    body_c = agents.pos + body_off
    body_r = device_const((0.35, 0.72, 0.35), f32, dev).expand(bsz, num_agents, 3)
    agent_colors = np.asarray(C.AGENT_COLORS)
    body_idx = device_const(agent_colors[np.arange(num_agents) % len(agent_colors)].tolist(),
                            torch.long, dev)
    body_rgb = palette[body_idx].expand(bsz, num_agents)
    z4 = torch.zeros((bsz, num_agents, 4), dtype=f32, device=dev)
    full = lambda v: torch.full((bsz, num_agents, 1), float(v), dtype=f32, device=dev)
    rows_body = torch.cat(
        [full(PRIM_ELLIPSOID), body_c, body_r, body_rgb[..., None], z4], dim=-1)

    cam_off = device_const(
        (0.0, C.AGENT_BODY_OFFSET_Y + C.AGENT_CAMERA_OFFSET_Y, 0.0), f32, dev)
    cam_pos = agents.pos + cam_off
    eye_rgb = palette[C.COLOR_IDX["AGENT_EYES"]].expand(bsz, num_agents)
    rows_eyes = torch.cat(
        [full(PRIM_EYEBOX), cam_pos,
         torch.stack([agents.yaw, agents.pitch, torch.zeros_like(agents.yaw)], dim=-1),
         eye_rgb[..., None], z4], dim=-1)

    return torch.cat([rows_box, rows_prop, rows_body, rows_eyes], dim=1).contiguous()


def build_cams(cfg: EnvConfig, agents: AgentState, time_fraction: torch.Tensor,
               last_reward: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Camera tables [B, A, 8]: eye xyz, yaw, pitch, time_fraction [B],
    lastReward (column 6, drives the UI reward indicators), pad."""
    bsz, num_agents = agents.yaw.shape
    dev = agents.pos.device
    eye = agents.pos + device_const(
        (0.0, C.AGENT_BODY_OFFSET_Y + C.AGENT_CAMERA_OFFSET_Y, 0.0), torch.float32, dev)
    tf = time_fraction.to(torch.float32).reshape(bsz, 1).expand(bsz, num_agents)
    lr = (torch.zeros_like(agents.yaw) if last_reward is None
          else last_reward.to(torch.float32).expand(bsz, num_agents))
    return torch.cat(
        [eye, agents.yaw[..., None], agents.pitch[..., None], tf[..., None],
         lr[..., None], torch.zeros_like(agents.yaw)[..., None]], dim=-1).contiguous()


def unpack_rgb(packed: torch.Tensor) -> torch.Tensor:
    """int32 [..., H, W] packed -> uint8 [..., H, W, 3]."""
    r = (packed >> 16) & 0xFF
    g = (packed >> 8) & 0xFF
    b = packed & 0xFF
    return torch.stack([r, g, b], dim=-1).to(torch.uint8)


def row_bounds(prims: torch.Tensor):
    """Conservative world AABB (lo, hi) [B, M, 3] of every row of prim tables
    [B, M, 12], per type (the port's cluster bounds, row by row); dead rows
    (type < 0) get an inverted box that no ray enters."""
    ptype = prims[:, :, 0].to(torch.int32)
    a = prims[:, :, 1:4]
    b = prims[:, :, 4:7]
    c = prims[:, :, 8:11]

    # Conservative half extents about center `a` for non-box rows.
    quad_he = torch.stack([b[..., 0], b[..., 2], b[..., 1]], dim=-1)  # cyl/cone
    # y-rotated box: exact world AABB of the rotated extents (b carries
    # (yaw, cos yaw, sin yaw) for rotbox rows)
    cy, sy = b[..., 1].abs(), b[..., 2].abs()
    rot_he = torch.stack(
        [c[..., 0] * cy + c[..., 2] * sy, c[..., 1], c[..., 0] * sy + c[..., 2] * cy],
        dim=-1)
    is_t = lambda t: (ptype == t)[..., None]
    he = torch.where(is_t(PRIM_ELLIPSOID), b, quad_he)
    he = torch.where(is_t(PRIM_EYEBOX), torch.full_like(he, _EYE_BOUND), he)
    he = torch.where(is_t(PRIM_ROTBOX), rot_he, he)
    # fused wall rows: the AABB must also cover the derived edging box
    whx = c[..., 0] * float(np.float32(C.WALL_EDGE_LEN_SCALE))
    whz = torch.clamp(c[..., 2], min=float(np.float32(C.WALL_EDGE_HZ)))
    wall_he = torch.stack(
        [whx * cy + whz * sy, c[..., 1], whx * sy + whz * cy], dim=-1)
    he = torch.where(is_t(PRIM_ROTBOX_WALL), wall_he, he)

    is_box = is_t(PRIM_AABB)
    lo = torch.where(is_box, a, a - he)
    hi = torch.where(is_box, b, a + he)
    dead = (ptype < 0)[..., None]
    lo = torch.where(dead, torch.full_like(lo, INF), lo)
    hi = torch.where(dead, torch.full_like(hi, -INF), hi)

    return lo, hi


def scene_tables(scenario: Scenario, states):
    """(cams [B, A, 8], prim table [B, M, 12]) of a batch of states: every
    box and prop row at full capacity, dead rows typed -1; the agents' own
    rows only where a camera can see another agent."""
    cfg = scenario.cfg
    remaining = torch.clamp(
        (states.episode_len_sec - states.episode_sec) / states.episode_len_sec, min=0.0)
    cams = build_cams(cfg, states.agents, remaining, states.last_reward)
    prims = build_prim_table(cfg, states.box_lo, states.box_hi, states.box_color,
                             states.props, states.agents,
                             include_agent_rows=cfg.num_agents > 1)
    return cams, prims


def render(scenario: Scenario, states, ray_dtype=None) -> torch.Tensor:
    """Packed int32 frames [B, A, H, W] of a batch of states. `ray_dtype`
    (the lower-precision control) rounds the camera table to that dtype
    before the rays are made."""
    cfg = scenario.cfg
    cams, prims = scene_tables(scenario, states)
    if ray_dtype is not None:
        cams = cams.to(ray_dtype).to(torch.float32)
    ui = float(cfg.params.get(C.P_USE_UI_REWARD_INDICATORS, 0.0)) > 0
    return R.render_table_packed(cams, prims, cfg.obs_height, cfg.obs_width, ui)

