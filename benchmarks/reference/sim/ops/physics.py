"""Batched kinematic character controller (counterpart of
megaverse_tpu/ops/physics.py).

Reimplements the *semantics* of the reference's modified Bullet
btKinematicCharacterController (env/src/kinematic_character_controller.cpp:528-602:
stepUp -> stepForwardAndStrafe -> stepDown, plus the acceleration model in
setAcceleration, kcc.cpp:753-792) as branch-free tensor code over the packed
solid-column grid. Convex sweeps against axis-aligned voxel geometry reduce to
column scans and a bounded-iteration sweep-and-slide reproducing the Quake2
stop rule of the reference's slide loop (kcc.cpp:337-393).

The agent capsule (r=0.33, cylinder h=1.05; agent.cpp:52-54) collides
CIRCLE-exactly in the horizontal plane and sphere-exactly against
floors/ceilings; the full [bottom, top] extent blocks horizontally.

Agent tensors are [B, A, ...]; `cols` is [B, X, W, Z]; the exact y-rotated
wall boxes of the hex mazes (`obbs`) are [B, W, 7], so the wall passes work on
[B, A, W].
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from reference.sim import constants as C
from reference.sim.ops import grid as G
from reference.sim.types import AgentState, GridConfig, device_const

HALF_XZ = C.AGENT_CAPSULE_RADIUS        # 0.33
HALF_Y = C.AGENT_HALF_HEIGHT            # 0.855
# Maximum vertical travel in one tick: terminal velocity * dt at 15 Hz, plus
# the step offset. Static bound for the column scans.
MAX_DROP = C.KCC_FALL_SPEED * C.DEFAULT_DT + C.KCC_STEP_HEIGHT + 0.1
MAX_RISE = C.KCC_JUMP_SPEED * C.DEFAULT_DT + C.KCC_STEP_HEIGHT + 0.1
CLAMP_MARGIN = 1e-3


def _span_xz(cfg: GridConfig) -> Tuple[int, int]:
    s = G.span_for(cfg, (2 * HALF_XZ, 2 * HALF_XZ))
    return (s[0], s[1])


def _where(cond, a, b):
    """torch.where accepting Python scalars on either side."""
    ref = a if torch.is_tensor(a) else b
    if not torch.is_tensor(a):
        a = torch.full_like(ref, a)
    if not torch.is_tensor(b):
        b = torch.full_like(ref, b)
    return torch.where(cond, a, b)


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt((v * v).sum(dim=-1))


def forward_dir(yaw: torch.Tensor) -> torch.Tensor:
    """Forward direction from yaw (ref agent.cpp:135-142: -Z forward at yaw 0)."""
    return torch.stack([-torch.sin(yaw), torch.zeros_like(yaw), -torch.cos(yaw)], dim=-1)


def strafe_left_dir(yaw: torch.Tensor) -> torch.Tensor:
    """Strafe-left direction (ref agent.cpp:144-150: -X at yaw 0)."""
    return torch.stack([-torch.cos(yaw), torch.zeros_like(yaw), torch.sin(yaw)], dim=-1)


def apply_look(agents: AgentState, action: torch.Tensor, dt: float,
               vertical_limit: float) -> AgentState:
    """Yaw / pitch integration (ref env.cpp:105-113, agent.cpp:100-126)."""
    look_l = (action & C.ACTION_LOOK_LEFT) != 0
    look_r = (action & C.ACTION_LOOK_RIGHT) != 0
    zero = torch.zeros_like(agents.yaw)
    dyaw = _where(look_l, C.AGENT_ROTATE_RADIANS * dt,
                  _where(look_r, -C.AGENT_ROTATE_RADIANS * dt, zero))
    yaw = agents.yaw + dyaw

    look_u = (action & C.ACTION_LOOK_UP) != 0
    look_d = (action & C.ACTION_LOOK_DOWN) != 0
    dpitch = _where(
        look_u, C.AGENT_ROTATE_X_RADIANS * dt,
        _where(look_d, -C.AGENT_ROTATE_X_RADIANS * dt * C.AGENT_LOOK_DOWN_FACTOR, zero))
    pitch = torch.clamp(agents.pitch + dpitch, -vertical_limit, vertical_limit)
    return agents.replace(yaw=yaw, pitch=pitch)


def apply_acceleration(agents: AgentState, action: torch.Tensor, dt: float) -> AgentState:
    """Acceleration + jump from the action bitmask (env.cpp:89-122 and
    kcc.cpp setAcceleration:753-792)."""
    fwd = forward_dir(agents.yaw)
    left = strafe_left_dir(agents.yaw)
    f32 = torch.float32

    bit = lambda m: ((action & m) != 0).to(f32)
    zero = torch.zeros_like(agents.yaw)
    a_fwd = bit(C.ACTION_FORWARD) - torch.where(
        (action & C.ACTION_FORWARD) == 0, bit(C.ACTION_BACKWARD), zero)
    a_left = bit(C.ACTION_LEFT) - torch.where(
        (action & C.ACTION_LEFT) == 0, bit(C.ACTION_RIGHT), zero)
    acc = fwd * a_fwd[..., None] + left * a_left[..., None]

    on_ground = agents.on_ground
    acc_mag = _norm(acc)[..., None]
    max_acc = _where(on_ground, torch.full_like(zero, C.KCC_MAX_ACCELERATION),
                     C.KCC_MAX_AIR_ACCELERATION)[..., None]
    acc = torch.where(acc_mag > C.KCC_EPSILON,
                      acc * max_acc / torch.clamp(acc_mag, min=1e-9),
                      torch.zeros_like(acc))

    hvel = agents.hvel
    # Ground branch: accelerate then enforce speed limit (kcc.cpp:764-781).
    g_vel = hvel + acc * dt
    g_speed = _norm(g_vel)
    dv = C.KCC_OVERSPEED_DECELERATION * dt
    over = g_speed > C.KCC_MAX_HORIZONTAL_SPEED
    scale_hard = (g_speed - dv) / torch.clamp(g_speed, min=1e-9)
    scale_soft = C.KCC_MAX_HORIZONTAL_SPEED / torch.clamp(g_speed, min=1e-9)
    g_scale = _where(over, torch.where(g_speed - dv > C.KCC_MAX_HORIZONTAL_SPEED,
                                       scale_hard, scale_soft), 1.0)
    g_vel = g_vel * g_scale[..., None]

    # Air branch: only accept the new velocity if it stays under the air speed
    # cap or decreases speed (kcc.cpp:782-791).
    a_vel = hvel + acc * dt
    a_speed = _norm(a_vel)
    cur_speed = _norm(hvel)
    a_ok = (a_speed <= C.KCC_MAX_AIR_SPEED) | (a_speed < cur_speed)
    a_vel = torch.where(a_ok[..., None], a_vel, hvel)

    hvel = torch.where(on_ground[..., None], g_vel, a_vel)

    # Jump (env.cpp:120-121, agent.cpp:157-161).
    do_jump = ((action & C.ACTION_JUMP) != 0) & on_ground
    vvel = _where(do_jump, C.KCC_JUMP_SPEED, agents.vvel)
    jumping = agents.jumping | do_jump

    return agents.replace(hvel=hvel, vvel=vvel, jumping=jumping)


# Neighbor cells considered by the horizontal sweep (the center's own cell is
# penetration-recovery territory, as in the reference's ghost overlap logic).
_SWEEP_CELLS = ((-1, -1), (-1, 0), (-1, 1), (0, -1),
                (0, 1), (1, -1), (1, 0), (1, 1))


def _sweep_horizontal(cfg: GridConfig, cols: torch.Tensor, pos: torch.Tensor,
                      dx: torch.Tensor, dz: torch.Tensor):
    """CIRCLE-exact first time-of-impact for the capsule translating by
    (dx, 0, dz).

    Axis-aligned specialization of the ghost-object convex sweep
    (kcc.cpp:360-364): in the horizontal plane the capsule is a circle of
    radius r, so sweeping vs solid voxel cells is a point sweep vs cells
    expanded by r with ROUNDED corners: entry faces are plane crossings and
    corner contacts are one quadratic each (|p0 + t d - corner| = r). With
    r + |d| < voxel_size the swept circle stays inside the 3x3 cell block
    around the center's cell, so the 8 neighbor cells are the complete
    candidate set. A circle already touching an expanded cell reports t=0
    with the closest-feature normal. Hits whose normal does not oppose the
    motion are discarded (the sweep callback's slope filter, kcc.cpp:52-93).

    Returns (t [0..1] fraction before impact, hit bool, nx, nz) where
    (nx, 0, nz) is the world contact normal of the earliest hit."""
    r = HALF_XZ
    vs = cfg.voxel_size
    assert vs > r + C.KCC_MAX_HORIZONTAL_SPEED * C.DEFAULT_DT, (
        "3x3 sweep window requires voxel_size > r + max travel per tick")
    # The 8 neighbor cells ride a trailing axis [..., 8] and each cell's 7
    # contact candidates (touch, x face, z face, 4 corner arcs) a second one,
    # so one pass of tensor ops covers what a loop over cells would; the
    # earliest candidate is then taken with a first-minimum argmin, which is
    # the loop's strict `t < t_best` in cell-then-candidate order.
    offs = device_const(_SWEEP_CELLS, torch.int32, pos)   # [8, 2]
    px = pos[..., 0, None]
    pz = pos[..., 2, None]
    bottom = pos[..., 1, None] - HALF_Y
    top = pos[..., 1, None] + HALF_Y
    dx = dx[..., None]
    dz = dz[..., None]
    cix = G.axis_index(cfg, 0, px) + offs[:, 0]
    ciz = G.axis_index(cfg, 2, pz) + offs[:, 1]
    solid = G.cols_cell_solid(cfg, cols, cix, ciz, bottom, top)            # [..., 8]

    dx_safe = _where(dx.abs() < 1e-12, 1e-12, dx)
    dz_safe = _where(dz.abs() < 1e-12, 1e-12, dz)
    cx0 = cfg.origin[0] + cix.to(torch.float32) * vs
    cx1 = cx0 + vs
    cz0 = cfg.origin[2] + ciz.to(torch.float32) * vs
    cz1 = cz0 + vs
    zero = torch.zeros_like(cx0)
    one = torch.ones_like(cx0)

    # blocked-at-start: circle already touches the expanded cell
    ex = px - torch.minimum(torch.maximum(px, cx0), cx1)
    ez = pz - torch.minimum(torch.maximum(pz, cz0), cz1)
    d2 = ex * ex + ez * ez
    dlen = torch.sqrt(torch.clamp(d2, min=1e-24))
    degen = d2 < 1e-12
    # degenerate exact-boundary touch: push straight back toward center
    onorm = device_const([1.0 / math.sqrt(ox * ox + oz * oz) for ox, oz in _SWEEP_CELLS],
                         torch.float32, pos)
    tnx = torch.where(degen, -offs[:, 0].to(torch.float32) * onorm, ex / dlen)
    tnz = torch.where(degen, -offs[:, 1].to(torch.float32) * onorm, ez / dlen)
    touch = solid & (d2 <= r * r) & (tnx * dx + tnz * dz <= 0.0)

    # entry-face crossings (plane at face -/+ r; contact point must lie on
    # the flat section of the expanded cell)
    face_x = torch.where(dx > 0, cx0 - r, cx1 + r)
    t_fx = (face_x - px) / dx_safe
    z_at = pz + t_fx * dz
    v_fx = (solid & (dx.abs() > 1e-9) & (t_fx >= 0.0) & (t_fx <= 1.0)
            & (z_at >= cz0) & (z_at <= cz1))
    n_fx = torch.where(dx > 0, -one, one)

    face_z = torch.where(dz > 0, cz0 - r, cz1 + r)
    t_fz = (face_z - pz) / dz_safe
    x_at = px + t_fz * dx
    v_fz = (solid & (dz.abs() > 1e-9) & (t_fz >= 0.0) & (t_fz <= 1.0)
            & (x_at >= cx0) & (x_at <= cx1))
    n_fz = torch.where(dz > 0, -one, one)

    # corner arcs: |p0 + t d - corner| = r, entry root; valid only in the
    # corner's Voronoi region (point outside the cell on both axes). Corners
    # in the order (x0,z0), (x0,z1), (x1,z0), (x1,z1) on a trailing axis.
    a = (dx * dx + dz * dz)[..., None]
    a_safe = torch.clamp(a, min=1e-12)
    ccx = torch.stack([cx0, cx0, cx1, cx1], dim=-1)                        # [..., 8, 4]
    ccz = torch.stack([cz0, cz1, cz0, cz1], dim=-1)
    pxc, pzc, dxc, dzc = px[..., None], pz[..., None], dx[..., None], dz[..., None]
    rx = pxc - ccx
    rz = pzc - ccz
    b = 2.0 * (rx * dxc + rz * dzc)
    c0 = rx * rx + rz * rz - r * r
    disc = b * b - 4.0 * a_safe * c0
    t_c = (-b - torch.sqrt(torch.clamp(disc, min=0.0))) / (2.0 * a_safe)
    xo = pxc + t_c * dxc
    zo = pzc + t_c * dzc
    x_lo = device_const((True, True, False, False), torch.bool, pos)
    z_lo = device_const((True, False, True, False), torch.bool, pos)
    out_x = torch.where(x_lo, xo <= cx0[..., None], xo >= cx1[..., None])
    out_z = torch.where(z_lo, zo <= cz0[..., None], zo >= cz1[..., None])
    v_c = (solid[..., None] & (a > 1e-12) & (disc >= 0.0) & (b < 0.0)
           & (t_c >= 0.0) & (t_c <= 1.0) & out_x & out_z)
    n_cx = (rx + t_c * dxc) / r
    n_cz = (rz + t_c * dzc) / r

    # candidates per cell in the order touch, x face, z face, corners
    t_all = torch.cat([torch.stack([zero, t_fx, t_fz], dim=-1), t_c], dim=-1)   # [..., 8, 7]
    v_all = torch.cat([torch.stack([touch, v_fx, v_fz], dim=-1), v_c], dim=-1)
    nx_all = torch.cat([torch.stack([tnx, n_fx, zero], dim=-1), n_cx], dim=-1)
    nz_all = torch.cat([torch.stack([tnz, zero, n_fz], dim=-1), n_cz], dim=-1)
    t_all = torch.where(v_all, t_all, torch.full_like(t_all, math.inf)).flatten(-2)
    first = t_all.argmin(dim=-1, keepdim=True)          # first minimum wins
    t_best = t_all.gather(-1, first)[..., 0]
    hit = torch.isfinite(t_best)
    nx_best = nx_all.flatten(-2).gather(-1, first)[..., 0]
    nz_best = nz_all.flatten(-2).gather(-1, first)[..., 0]
    zero_b = torch.zeros_like(t_best)
    t = _where(hit, t_best, 1.0)
    return t, hit, torch.where(hit, nx_best, zero_b), torch.where(hit, nz_best, zero_b)


def _slide_horizontal(cfg: GridConfig, cols: torch.Tensor, pos: torch.Tensor,
                      dx: torch.Tensor, dz: torch.Tensor) -> torch.Tensor:
    """stepForwardAndStrafe (kcc.cpp:337-393): bounded-iteration sweep-and-
    slide with the Quake2 stop rule.

    Each iteration sweeps the CURRENT displacement from the ORIGINAL position;
    on impact the component along the contact normal is truncated at the hit
    fraction (updateTargetPositionBasedOnCollision, kcc.cpp:313-329) and the
    perpendicular component kept in full; movement is cancelled outright when
    the re-targeted displacement is ~zero (<= 1 cm) or opposes the original
    velocity. Axis-aligned faces converge in <= 3 sweeps; one extra masked
    iteration absorbs corner-arc re-contacts, so 4 replace the reference's
    <= 10."""
    odx, odz = dx, dz
    active = (dx.abs() + dz.abs()) > 0.0
    zero = torch.zeros_like(dx)
    for _ in range(4):
        t, hit, nx, nz = _sweep_horizontal(cfg, cols, pos, dx, dz)
        hit = hit & active
        ndot = nx * dx + nz * dz                 # <= 0 for blocking hits
        par_new = torch.clamp(ndot * t + CLAMP_MARGIN, max=0.0)
        ndx = torch.where(hit, dx - nx * (ndot - par_new), dx)
        ndz = torch.where(hit, dz - nz * (ndot - par_new), dz)
        l2 = ndx * ndx + ndz * ndz
        cancel = hit & ((l2 <= 1e-4) | (ndx * odx + ndz * odz <= 0.0))
        dx = torch.where(cancel, zero, ndx)
        dz = torch.where(cancel, zero, ndz)
        active = active & hit & ~cancel
    return torch.stack([pos[..., 0] + dx, pos[..., 1], pos[..., 2] + dz], dim=-1)


def player_step(cfg: GridConfig, agents: AgentState, dt: float,
                cols: torch.Tensor, obbs=None) -> AgentState:
    """One physics tick for all agents (ref playerStep, kcc.cpp:528-602) on
    the packed solid-column grid `cols`. `obbs` [B, W, 7] adds exact
    y-rotated wall boxes (hex mazes): horizontal blocking by capsule-vs-OBB
    push-out after the grid slide (the momentum arrest then sees the
    corrected travel) and landing support from wall tops in stepDown."""
    pos0 = agents.pos
    was_on_ground = agents.on_ground

    # Gravity + velocity clamps (kcc.cpp:556-562).
    vvel = agents.vvel - C.KCC_GRAVITY * dt
    vvel = torch.clamp(vvel, max=C.KCC_JUMP_SPEED)
    vvel = torch.clamp(vvel, min=-C.KCC_FALL_SPEED)
    voffset = vvel * dt

    pos = pos0
    top = pos[..., 1] + HALF_Y
    zero = torch.zeros_like(vvel)

    # --- stepUp (kcc.cpp:223-304) ---
    step_h = _where(vvel < 0, C.KCC_STEP_HEIGHT, zero)
    up_dist = step_h + torch.clamp(voffset, min=0.0)
    # capsule-exact ceiling: the TOP sphere contacts a cell's underside at
    # cell_bottom + (r - sqrt(r^2 - d^2)) per column
    ceil_y, ceil_found = G.cols_capsule_ceiling_above(
        cfg, cols, pos[..., 0], pos[..., 2], top, MAX_RISE, _span_xz(cfg), HALF_XZ)
    free_rise = _where(ceil_found, torch.clamp(ceil_y - top - CLAMP_MARGIN, min=0.0),
                       math.inf)
    blocked_up = free_rise < up_dist
    rise = torch.minimum(up_dist, free_rise)
    pos = torch.stack([pos[..., 0], pos[..., 1] + rise, pos[..., 2]], dim=-1)

    # step offset bookkeeping (kcc.cpp:264-303)
    frac = rise / torch.clamp(up_dist, min=1e-9)
    step_offset = torch.where(
        blocked_up,
        _where(voffset > 0, C.KCC_STEP_HEIGHT, step_h * frac),
        step_h)
    hit_ceiling_rising = blocked_up & (voffset > 0)
    vvel = torch.where(hit_ceiling_rising, zero, vvel)
    voffset = torch.where(hit_ceiling_rising, zero, voffset)

    # --- stepForwardAndStrafe (kcc.cpp:337-393), iterative sweep-slide ---
    pre_slide = pos
    pos = _slide_horizontal(cfg, cols, pos,
                            agents.hvel[..., 0] * dt, agents.hvel[..., 2] * dt)
    if obbs is not None:
        pos = _obb_push_xz(pos, obbs, pre_slide)

    # --- stepDown (kcc.cpp:400-442) ---
    down_vel = torch.where(vvel < 0, -vvel, zero)
    clamp_fall = ((down_vel > 0) & (down_vel > C.KCC_FALL_SPEED)
                  & (was_on_ground | ~agents.jumping))
    down_vel = _where(clamp_fall, C.KCC_FALL_SPEED, down_vel)
    drop = step_offset + down_vel * dt

    bottom = pos[..., 1] - HALF_Y
    # capsule-exact landing: the bottom SPHERE rests dip(d) below a cell's
    # top at horizontal distance d, and slips off past the 45-degree filter
    floor_y, floor_found = G.cols_capsule_floor_below(
        cfg, cols, pos[..., 0], pos[..., 2], bottom, MAX_DROP, _span_xz(cfg), HALF_XZ)
    if obbs is not None:
        # wall tops are floor candidates too (landing on maze walls)
        otop, ofound = obb_floor_support(pos, obbs)
        ok = ofound & (otop <= bottom + CLAMP_MARGIN)
        better = ok & (~floor_found | (otop > floor_y))
        floor_y = torch.where(better, otop, floor_y)
        floor_found = floor_found | ok
    # Land if a floor top lies within the drop distance below (or at) the
    # capsule bottom.
    land = floor_found & (floor_y >= bottom - drop)
    new_bottom = torch.where(land, floor_y, bottom - drop)
    pos = torch.stack([pos[..., 0], new_bottom + HALF_Y, pos[..., 2]], dim=-1)

    vvel = torch.where(land, zero, vvel)
    voffset = torch.where(land, zero, voffset)
    jumping = agents.jumping & ~land

    # Momentum arrest: actual horizontal travel (kcc.cpp:576-578).
    hvel = (pos - pos0) / dt
    hvel = torch.stack([hvel[..., 0], zero, hvel[..., 2]], dim=-1)

    # onGround per ref semantics (kcc.cpp:679-682): vvel and voffset both ~0.
    on_ground = (vvel.abs() < C.KCC_EPSILON) & (voffset.abs() < C.KCC_EPSILON)

    # Ground friction (kcc.cpp:592-599).
    speed = _norm(hvel)
    fric_scale = (torch.clamp(speed - C.KCC_NORMAL_DECELERATION * dt, min=0.0)
                  / torch.clamp(speed, min=1e-9))
    hvel = torch.where(on_ground[..., None], hvel * fric_scale[..., None], hvel)

    return agents.replace(pos=pos, vvel=vvel, hvel=hvel, jumping=jumping,
                          on_ground=on_ground)


def _obb_local_xz(pos: torch.Tensor, obbs: torch.Tensor):
    """World XZ -> per-wall local (u: along length, v: along thickness).

    pos [B, A, 3], obbs [B, W, 7] (cx, cy, cz, hx, hy, hz, yaw) ->
    (u, v) each [B, A, W]. Same rotation convention as the renderer's
    PRIM_ROTBOX and the reference's layoutBox.rotateY
    (component_hexagonal_maze.cpp:107)."""
    cy_ = torch.cos(obbs[:, None, :, 6])
    sy_ = torch.sin(obbs[:, None, :, 6])
    ox = pos[..., 0:1] - obbs[:, None, :, 0]
    oz = pos[..., 2:3] - obbs[:, None, :, 2]
    u = cy_ * ox - sy_ * oz
    v = sy_ * ox + cy_ * oz
    return u, v


def resolve_obb_walls(agents: AgentState, obbs: torch.Tensor,
                      prev_pos: torch.Tensor = None, iters: int = 3,
                      dt: float = C.DEFAULT_DT) -> AgentState:
    """Exact capsule-vs-rotated-wall horizontal collision as a pass of its
    own: agents are pushed out of their deepest-penetrating wall along the
    capsule(circle r)-vs-rectangle contact normal, `iters` times, and the
    push is folded into the horizontal velocity the way playerStep derives
    it from actual travel (kcc.cpp:576-578).

    The reference collides agents with y-rotated Bullet boxes for hex-maze
    walls (component_hexagonal_maze.cpp:79-113; only the main wall box gets
    a RigidBody). obbs [B, W, 7]; rows with hy < 0 are inert. `prev_pos`
    (positions before the horizontal move) picks the push side when a step
    carries the center past the wall's midplane."""
    if obbs.shape[1] == 0:
        return agents
    if prev_pos is None:
        prev_pos = agents.pos
    pos = _obb_push_xz(agents.pos, obbs, prev_pos, iters)
    moved = ((pos - agents.pos).abs() > 0).any(dim=-1)
    delta = (pos - agents.pos) / dt
    hvel = agents.hvel + delta
    hvel = torch.stack([hvel[..., 0], torch.zeros_like(hvel[..., 1]), hvel[..., 2]], dim=-1)
    hvel = torch.where(moved[..., None], hvel, agents.hvel)
    return agents.replace(pos=pos, hvel=hvel)


def _obb_push_xz(pos: torch.Tensor, obbs: torch.Tensor, prev_pos: torch.Tensor,
                 iters: int = 3) -> torch.Tensor:
    """Positional core of resolve_obb_walls: push capsule centers [B, A, 3]
    out of the rotated walls obbs [B, W, 7], the deepest wall per agent and
    iteration (the first of equal depths, as `jnp.argmax` picks it). Used
    directly inside player_step so the momentum arrest sees the corrected
    travel."""
    r = HALF_XZ
    _, v_prev = _obb_local_xz(prev_pos, obbs)                 # [B, A, W]
    one = torch.ones_like(v_prev)
    side_prev = torch.where(v_prev >= 0, one, -one)
    cy_, hx = obbs[:, None, :, 1], obbs[:, None, :, 3]
    hy, hv = obbs[:, None, :, 4], obbs[:, None, :, 5]
    yaw = obbs[:, None, :, 6].expand(v_prev.shape)
    zero = torch.zeros_like(v_prev)

    def at(x, w):
        return x.gather(-1, w)[..., 0]

    for _ in range(iters):
        u, v = _obb_local_xz(pos, obbs)
        bottom = pos[..., 1:2] - HALF_Y
        top = pos[..., 1:2] + HALF_Y
        v_overlap = (bottom < cy_ + hy) & (top > cy_ - hy)

        du = u - torch.minimum(torch.maximum(u, -hx), hx)
        dv = v - torch.minimum(torch.maximum(v, -hv), hv)
        dist = torch.sqrt(du * du + dv * dv)
        inside = (u.abs() <= hx) & (v.abs() <= hv)
        pen_out = torch.clamp(r - dist, min=0.0)             # outside-rect case
        pen_in = hv + r - side_prev * v                      # crossed/inside case
        pen = torch.where(inside, pen_in, pen_out)
        pen = torch.where(v_overlap & (hy > 0), pen, zero)   # [B, A, W]

        w = pen.argmax(dim=-1, keepdim=True)                 # deepest wall per agent
        p = at(pen, w)
        live = p > 1e-6
        w_inside, w_dist, w_side = at(inside, w), at(dist, w), at(side_prev, w)
        # contact normal in the wall's frame
        d_safe = torch.clamp(w_dist, min=1e-9)
        nu = torch.where(w_inside, torch.zeros_like(p), at(du, w) / d_safe)
        nv = torch.where(w_inside, w_side, at(dv, w) / d_safe)
        # degenerate exact touch: push along the previous side of the
        # thickness axis
        degen = ~w_inside & (w_dist < 1e-9)
        nu = torch.where(degen, torch.zeros_like(p), nu)
        nv = torch.where(degen, w_side, nv)
        w_yaw = at(yaw, w)
        cyw, syw = torch.cos(w_yaw), torch.sin(w_yaw)
        px = cyw * nu + syw * nv
        pz = -syw * nu + cyw * nv
        push = torch.stack([px, torch.zeros_like(px), pz], dim=-1)
        pos = pos + torch.where(live[..., None], push * p[..., None], torch.zeros_like(push))
    return pos


def obb_floor_support(pos: torch.Tensor, obbs: torch.Tensor):
    """Highest wall-top floor candidate under each agent.

    pos [B, A, 3] (capsule centers), obbs [B, W, 7] -> (top_y [B, A],
    found [B, A]): the largest cy + hy - dip over walls whose rectangle lies
    within the capsule's 45-degree contact reach horizontally. stepDown
    combines it with the voxel-grid floor scan, so agents land on and stand
    on maze walls (the jump apex of 1.2 m clears the 0.85-1.4 m walls).
    Without a candidate the top is -inf and `found` False."""
    if obbs.shape[1] == 0:
        z = torch.zeros(pos.shape[:-1], dtype=torch.float32, device=pos.device)
        return z, torch.zeros(pos.shape[:-1], dtype=torch.bool, device=pos.device)
    r = HALF_XZ
    u, v = _obb_local_xz(pos, obbs)
    hx, hz = obbs[:, None, :, 3], obbs[:, None, :, 5]
    du = u - torch.minimum(torch.maximum(u, -hx), hx)
    dv = v - torch.minimum(torch.maximum(v, -hz), hz)
    d2 = du * du + dv * dv
    # the capsule contact model of the voxel floor scan: the bottom sphere
    # rests dip(d) below the wall top and slips off past the 45-degree
    # contact filter (d <= r*sin(45))
    near = (d2 <= 0.5 * r * r) & (obbs[:, None, :, 4] > 0)
    dip = r - torch.sqrt(torch.clamp(r * r - d2, min=0.0))
    top = obbs[:, None, :, 1] + obbs[:, None, :, 4] - dip
    best = torch.where(near, top, torch.full_like(top, -math.inf)).amax(dim=-1)
    return best, torch.isfinite(best)


def resolve_agent_collisions(agents: AgentState, cfg: GridConfig = None,
                             cols: torch.Tensor = None, obbs=None) -> AgentState:
    """Pairwise capsule-capsule horizontal push-out (agents are in each
    other's collision masks, agent.cpp:63; recoverFromPenetration
    kcc.cpp:156-221). Symmetric positional correction; when the grid is
    provided the push goes through the same sweep as walking, so an agent
    shoved toward a wall stops at the wall, and `obbs` [B, W, 7] pushes it
    back out of any rotated wall after the slide."""
    pos = agents.pos
    num_agents = pos.shape[1]
    if num_agents <= 1:
        return agents

    diff = pos[:, :, None, :] - pos[:, None, :, :]  # [B, A, A, 3]
    d_xz = torch.sqrt(diff[..., 0] ** 2 + diff[..., 2] ** 2 + 1e-12)
    v_overlap = diff[..., 1].abs() < 2 * HALF_Y - 0.05
    eye = torch.eye(num_agents, dtype=torch.bool, device=pos.device)
    overlap = (~eye) & v_overlap & (d_xz < 2 * HALF_XZ)

    push_mag = torch.where(overlap, (2 * HALF_XZ - d_xz) * 0.5, torch.zeros_like(d_xz))
    dir_xz = torch.stack([diff[..., 0], torch.zeros_like(d_xz), diff[..., 2]], -1) / d_xz[..., None]
    # Degenerate case: coincident centers -> push along +x deterministically.
    degen = overlap & (d_xz < 1e-5)
    plus_x = device_const((1.0, 0.0, 0.0), pos.dtype, pos)
    dir_xz = torch.where(degen[..., None], plus_x, dir_xz)
    push = (push_mag[..., None] * dir_xz).sum(dim=2)  # [B, A, 3]
    if cfg is None or cols is None:
        return agents.replace(pos=pos + push)
    new_pos = _slide_horizontal(cfg, cols, pos, push[..., 0], push[..., 2])
    if obbs is not None:
        new_pos = _obb_push_xz(new_pos, obbs, pos)
    return agents.replace(pos=new_pos)
