"""Device-side reusable scenario components (counterpart of
megaverse_tpu/scenarios/components.py).

Branch-free batched reimplementations of the reference ScenarioComponents:

- object stacking (pick up / place movable objects with Interact):
  scenarios/include/scenarios/component_object_stacking.hpp:28-206. Object
  pointers become integer prop indices: the grid field `vobj` holds
  (prop index + 1) per voxel, and AgentState.carried holds the carried prop.
  On CUDA tensors one launch of a hand-written kernel (ops/stacking.py); the
  batched code here is its plain version.
- fall detection (teleport fallen agents back):
  scenarios/include/scenarios/component_fall_detection.hpp:16-62.
- hiding collected reward diamonds (Collect, Obstacles).

All tensors carry the env batch explicitly: agents [B, A, ...], props
[B, P, ...], grids [B, X, Y, Z].
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from megaverse_tpu_torch import constants as C
from megaverse_tpu_torch.ops import grid as G
from megaverse_tpu_torch.ops import stacking as S
from megaverse_tpu_torch.types import (
    EnvState, GridConfig, PROP_FLAG_SOLID, PROP_FLAG_VISIBLE, device_const)

CARRYING_SCALE = C.CARRYING_SCALE  # component_object_stacking.hpp:63


def rot_yaw_pitch(yaw, pitch, v):
    """R_y(yaw) @ R_x(pitch) @ v for a constant local vector v (len-3)."""
    cp, sp = torch.cos(pitch), torch.sin(pitch)
    y1 = cp * v[1] - sp * v[2]
    z1 = sp * v[1] + cp * v[2]
    cy, sy = torch.cos(yaw), torch.sin(yaw)
    x2 = cy * v[0] + sy * z1
    z2 = -sy * v[0] + cy * z1
    return torch.stack([x2, y1, z2], dim=-1)


def _vec3(v, like: torch.Tensor) -> torch.Tensor:
    return device_const(v, torch.float32, like)


def camera_anchor(agents, local: Tuple[float, float, float]) -> torch.Tensor:
    """World position of a camera-frame anchor for each agent [B,A,3]: the
    scene-graph chain agent -> cameraObject(+0.41, pitch) -> child
    (agent.cpp:28-40); the agent visual origin sits +0.05 above the capsule
    center (agent.cpp:95)."""
    base = agents.pos + _vec3(
        [0.0, C.AGENT_BODY_OFFSET_Y + C.AGENT_CAMERA_OFFSET_Y, 0.0], agents.pos)
    local = [float(x) for x in np.asarray(local, np.float32)]
    return base + rot_yaw_pitch(agents.yaw, agents.pitch, local)


def pickup_spot(agents) -> torch.Tensor:
    """Interact anchor (0,-0.44,-1) camera-local (agent.cpp:40)."""
    return camera_anchor(agents, C.AGENT_PICKUP_SPOT)


def carry_anchor(agents) -> torch.Tensor:
    """Carried-object position: pickup spot + (0,-0.3,0) local
    (component_object_stacking.hpp:117-121)."""
    p = C.AGENT_PICKUP_SPOT
    return camera_anchor(agents, (p[0], p[1] - 0.3, p[2]))


def _take(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table [B, P, ...] gathered at idx [B, A] (long) -> [B, A, ...]."""
    return table[G._bidx(idx), idx]


def _put(table: torch.Tensor, idx: torch.Tensor, value: torch.Tensor,
         mask: torch.Tensor) -> torch.Tensor:
    """Out-of-place table[b, idx[b, a]] = value[b, a] for the rows where
    `mask` holds. Masked-off rows (agents that do not act; their idx is a
    clamped placeholder) are routed to a scratch row, so they can never race
    an acting agent that names the same slot. Acting rows of one env name
    distinct slots."""
    n = table.shape[1]
    pad = torch.cat([table, table[:, :1]], dim=1)
    tgt = torch.where(mask, idx, torch.full_like(idx, n))
    pad[G._bidx(tgt).expand(tgt.shape), tgt] = value.to(table.dtype)
    return pad[:, :n]


def update_carried_props(state: EnvState) -> EnvState:
    """Move carried props to their carry anchors (parenting replacement): the
    reference's carried object is a scene-graph child of the pickup spot; here
    its world position is written each tick after physics."""
    carried = state.agents.carried  # [B, A] int, -1 = none
    anchors = carry_anchor(state.agents)  # [B, A, 3]
    has = carried >= 0
    idx = torch.clamp(carried, min=0).long()
    pos = state.props.pos
    return state.replace(props=state.props.replace(pos=_put(pos, idx, anchors, has)))


class StackingResult(NamedTuple):
    state: EnvState
    picked: torch.Tensor       # bool [B, A] picked an object this tick
    placed: torch.Tensor       # bool [B, A] placed an object this tick
    place_voxel: torch.Tensor  # int32 [B, A, 3] voxel where placed (valid if placed)


def in_zone_xz(zone: torch.Tensor, voxel: torch.Tensor) -> torch.Tensor:
    """Voxels [B,A,3] inside the x/z rectangle zone [B,4] = (x0, x1, z0, z1),
    half-open -> bool [B,A] (TowerBuilding's isInBuildingZone,
    scenario_tower_building.cpp:227-230; Rearrange's placement area)."""
    z = zone[:, None, :]
    return ((voxel[..., 0] >= z[..., 0]) & (voxel[..., 0] < z[..., 1])
            & (voxel[..., 2] >= z[..., 2]) & (voxel[..., 2] < z[..., 3]))


def object_stacking_step(
    cfg: GridConfig,
    state: EnvState,
    action: torch.Tensor,
    place_zone: Optional[torch.Tensor] = None,
    max_drop_scan: int = 16,
) -> StackingResult:
    """Interact handling: place carried object / pick up facing object.

    Mirrors ObjectStackingComponent::onInteractAction
    (component_object_stacking.hpp:59-167), agent by agent in index order.
    On CUDA tensors one launch of the stacking kernel
    (ops/stacking.stacking_step), bit-equal to the plain version
    `object_stacking_step_plain`, which the CPU takes. `vobj` and `cols` are
    updated in place.

    place_zone: None, or int32 [B,4] (x0, x1, z0, z1), half-open: objects are
    placed only in voxels inside it (ref canPlaceObject callback)."""
    if state.vobj.device.type != "cuda":
        return object_stacking_step_plain(cfg, state, action, place_zone, max_drop_scan)
    agents, props = state.agents, state.props
    rows = dict(pos=agents.pos.contiguous(), yaw=agents.yaw.contiguous(),
                pitch=agents.pitch.contiguous(), carried=agents.carried.contiguous())
    table = dict(pos=props.pos.contiguous(), scale=props.scale.contiguous(),
                 flags=props.flags.contiguous())
    pos, scale, flags, carried, picked, placed, place_voxel = S.stacking_step(
        cfg, state.replace(agents=agents.replace(**rows), props=props.replace(**table)),
        action.contiguous(), place_zone, max_drop_scan)
    state = state.replace(props=props.replace(pos=pos, scale=scale, flags=flags),
                          agents=agents.replace(carried=carried))
    return StackingResult(state, picked, placed, place_voxel)


def object_stacking_step_plain(
    cfg: GridConfig,
    state: EnvState,
    action: torch.Tensor,
    place_zone: Optional[torch.Tensor] = None,
    max_drop_scan: int = 16,
) -> StackingResult:
    """Plain version of `object_stacking_step` (any device).

    Multi-agent ticks are processed SEQUENTIALLY in agent order, exactly like
    the reference's per-agent loop: agent i's placement/pick mutates the
    world state agent i+1 then queries within the same tick. Single-agent
    envs take the one-pass path directly."""
    num_agents = state.agents.pos.shape[1]
    if num_agents == 1:
        return _stacking_pass(cfg, state, action, place_zone, max_drop_scan)

    picked = torch.zeros_like(state.agents.jumping)
    placed = torch.zeros_like(picked)
    place_voxel = torch.zeros(picked.shape + (3,), dtype=torch.int32, device=picked.device)
    idx = torch.arange(num_agents, device=picked.device)
    for a in range(num_agents):
        # only agent a interacts in this pass (the conflict-resolution
        # matrices inside the pass become no-ops)
        act_a = torch.where(idx == a, action, action & ~C.ACTION_INTERACT)
        res = _stacking_pass(cfg, state, act_a, place_zone, max_drop_scan)
        state = res.state
        picked = picked | res.picked
        placed = placed | res.placed
        place_voxel = torch.where(res.placed[..., None], res.place_voxel, place_voxel)
    return StackingResult(state, picked, placed, place_voxel)


def _stacking_pass(cfg, state, action, place_zone=None, max_drop_scan=16) -> StackingResult:
    agents = state.agents
    num_agents = agents.pos.shape[1]
    dev = agents.pos.device
    interact = (action & C.ACTION_INTERACT) != 0

    # ---------------- place branch (carrying something) --------------------
    carrying = agents.carried >= 0
    want_place = interact & carrying
    cidx = torch.clamp(agents.carried, min=0).long()

    obj_pos = _take(state.props.pos, cidx)  # [B,A,3] carried object position
    place_voxel = G.world_to_voxel(cfg, obj_pos)  # [B,A,3]

    solid_pv = G.solid_from_cols(cfg, state.cols, place_voxel)
    vo = G.gather_voxel(cfg, state.vobj, place_voxel)
    dims = device_const(cfg.dims, torch.int32, dev)
    in_grid = ((place_voxel >= 0) & (place_voxel < dims)).all(dim=-1)
    # "empty": not solid and no object (hpp:96). Out-of-grid counts as empty in
    # the reference (sparse grid); in-grid is required here so the object
    # table and grid stay consistent.
    voxel_empty = ~solid_pv & (vo == 0) & in_grid

    # No agent standing in that voxel (hpp:82-94; compares agent voxel coords).
    agent_voxels = G.world_to_voxel(
        cfg, agents.pos + _vec3([0.0, C.AGENT_BODY_OFFSET_Y, 0.0], agents.pos))
    same = (place_voxel[:, :, None, :] == agent_voxels[:, None, :, :]).all(dim=-1)
    other = ~torch.eye(num_agents, dtype=torch.bool, device=dev)
    collides_agent = (same & other).any(dim=2)

    ok_place = want_place & voxel_empty & ~collides_agent
    if place_zone is not None:
        ok_place = ok_place & in_zone_xz(place_zone, place_voxel)

    # Gravity settle: descend while the voxel below is non-solid and has no
    # object (hpp:101-115), bounded scan.
    down = device_const((0, 1, 0), torch.int32, dev)
    settled = place_voxel
    for _ in range(max_drop_scan):
        below = settled - down
        bs = G.solid_from_cols(cfg, state.cols, below)
        bo = G.gather_voxel(cfg, state.vobj, below)
        support = bs | (bo != 0) | (below[..., 1] < 0)
        settled = torch.where(support[..., None], settled, below)

    # Resolve conflicts: two agents placing into the same settled voxel ->
    # lowest index wins.
    same_target = (settled[:, :, None, :] == settled[:, None, :, :]).all(dim=-1)
    earlier = torch.tril(torch.ones((num_agents, num_agents), dtype=torch.bool, device=dev),
                         diagonal=-1)
    conflict = (same_target & earlier & ok_place[:, None, :]).any(dim=2)
    ok_place = ok_place & ~conflict

    # Apply placements.
    center = G.voxel_center(cfg, settled)
    props = state.props
    pp = _put(props.pos, cidx, center, ok_place)
    ps = _put(props.scale, cidx, _take(props.scale, cidx) / CARRYING_SCALE, ok_place)
    pf = _put(props.flags, cidx, _take(props.flags, cidx) | PROP_FLAG_SOLID, ok_place)
    # masked coords (-1 -> dropped): only the winning rows scatter
    masked = torch.where(ok_place[..., None], settled, torch.full_like(settled, -1))
    vobj = G.set_voxel(cfg, state.vobj, masked, (cidx + 1).to(state.vobj.dtype))
    cols = G.update_cols(cfg, state.cols, masked, True)
    carried = torch.where(ok_place, torch.full_like(agents.carried, -1), agents.carried)

    state = state.replace(
        cols=cols, vobj=vobj,
        props=props.replace(pos=pp, scale=ps, flags=pf),
        agents=agents.replace(carried=carried),
    )

    # ---------------- pick branch (empty-handed) ---------------------------
    want_pick = interact & ~carrying
    spot = pickup_spot(state.agents)
    v0 = G.world_to_voxel(cfg, spot)

    picked = torch.zeros_like(want_pick)
    pick_idx = torch.zeros(want_pick.shape, dtype=torch.long, device=dev)
    pick_voxel = v0
    up = device_const((0, 1, 0), torch.int32, dev)
    # Scan up to 2 voxels upward (pickupHeight <= 1, hpp:137-141): pick the
    # first voxel containing an object with nothing stacked on top.
    for h in range(2):
        voxel = v0 + up * h
        above = voxel + up
        vo = G.gather_voxel(cfg, state.vobj, voxel)
        va = G.gather_voxel(cfg, state.vobj, above)
        hit = want_pick & ~picked & (vo != 0) & (va == 0)
        pick_idx = torch.where(hit, vo.long() - 1, pick_idx)
        pick_voxel = torch.where(hit[..., None], voxel, pick_voxel)
        picked = picked | hit

    # Conflict resolution: same object targeted by several agents -> lowest
    # agent index wins.
    same_obj = pick_idx[:, :, None] == pick_idx[:, None, :]
    lost = (same_obj & earlier & picked[:, None, :]).any(dim=2) & picked
    picked = picked & ~lost

    props = state.props
    ps = _put(props.scale, pick_idx, _take(props.scale, pick_idx) * CARRYING_SCALE, picked)
    pf = _put(props.flags, pick_idx,
              _take(props.flags, pick_idx) & (0xFF ^ PROP_FLAG_SOLID), picked)
    masked = torch.where(picked[..., None], pick_voxel, torch.full_like(pick_voxel, -1))
    vobj = G.set_voxel(cfg, state.vobj, masked, 0)
    cols = G.update_cols(cfg, state.cols, masked, False)
    carried = torch.where(picked, pick_idx.to(state.agents.carried.dtype),
                          state.agents.carried)

    state = state.replace(
        cols=cols, vobj=vobj,
        props=props.replace(scale=ps, flags=pf),
        agents=state.agents.replace(carried=carried),
    )
    state = update_carried_props(state)

    return StackingResult(state, picked, ok_place, settled)


def fall_detection_step(cfg: GridConfig, state: EnvState,
                        fall_threshold: float = -20.0,
                        max_up_scan: int = 16) -> Tuple[EnvState, torch.Tensor]:
    """Teleport agents below `fall_threshold` back above their spawn position.

    Mirrors FallDetectionComponent::step/resetAgent
    (component_fall_detection.hpp:33-62): the respawn voxel climbs up from the
    initial position while occupied. Returns (state, fell_mask [B, A])."""
    agents = state.agents
    visual_y = agents.pos[..., 1] + C.AGENT_BODY_OFFSET_Y
    fell = visual_y < fall_threshold

    # Initial position -> voxel; climb while non-empty (one two-word gather +
    # count-trailing-ones, bit-exact vs the sequential loop).
    start = agents.spawn_pos - _vec3([0.0, C.AGENT_HEIGHT, 0.0], agents.pos)
    voxel = G.first_free_above(cfg, state.cols, G.world_to_voxel(cfg, start),
                               max_scan=max_up_scan)

    # teleport: warp (kcc.cpp:509-517) zeroes velocities. The reference
    # teleports to the voxel center and lets penetration recovery push the
    # capsule up; here the capsule bottom is placed directly on the voxel floor.
    target = G.voxel_center(cfg, voxel)
    ty = target[..., 1] - 0.5 * cfg.voxel_size + C.AGENT_HALF_HEIGHT + 0.01
    target = torch.stack([target[..., 0], ty, target[..., 2]], dim=-1)
    new_pos = torch.where(fell[..., None], target, agents.pos)
    agents = agents.replace(
        pos=new_pos,
        hvel=torch.where(fell[..., None], torch.zeros_like(agents.hvel), agents.hvel),
        vvel=torch.where(fell, torch.zeros_like(agents.vvel), agents.vvel),
    )
    return state.replace(agents=agents), fell


def hide_props(flags: torch.Tensor, top: torch.Tensor, hide: torch.Tensor) -> torch.Tensor:
    """Clear the visible bit of prop rows `top` and `top + 1` (a diamond's two
    cones) where `hide` holds. flags uint8 [B,P], top int [B,R], hide bool
    [B,R]. Rows that do not hide are routed to a scratch column, so every
    write that lands in the table stores the same value (no write race)."""
    bsz, p = flags.shape
    mark = torch.zeros((bsz, p + 1), dtype=torch.bool, device=flags.device)
    top = top.long()
    scratch = torch.full_like(top, p)
    mark.scatter_(1, torch.where(hide, top, scratch), True)
    mark.scatter_(1, torch.where(hide, top + 1, scratch), True)
    return torch.where(mark[:, :p], flags & (0xFF ^ PROP_FLAG_VISIBLE), flags)
