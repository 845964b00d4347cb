"""Batched analytic raycasting renderer in plain PyTorch.

Counterpart of megaverse_tpu/ops/raycast.py, restricted to the TABLE renderer
(`render_table_packed`): each (env, agent, pixel) traces one primary ray
against a unified primitive table (row layout in ops/raycast_cuda.py) with a
Python loop over table rows and `torch.where` selects of the running closest
hit. It is the plain version of the CUDA kernel in csrc/render.cu and repeats
that kernel's arithmetic expression by expression, so the two agree to the last
bit wherever the elementary functions do. The CPU tests run it; on a CUDA
tensor nothing on the product path calls it.

Camera model: ref env_renderer.hpp:34-38 (hfov 100 deg, near 0.01, far 120)
and agent.cpp:28-38. Shading: single Blinn-Phong light at (0,4,2), intensity
0.66 (v4r_env_renderer.cpp:219-221).

All tensors carry explicit leading [B, A] axes; pixel planes are [B, A, H, W].
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from reference.sim import constants as C

INF = 1e30
TILE_H = 8
TILE_W = 128
NEAR = float(C.CAMERA_NEAR)
FAR = float(C.CAMERA_FAR)

PRIM_AABB = 0
PRIM_ELLIPSOID = 1
PRIM_CYLINDER = 2
PRIM_CONE = 3
PRIM_CONE_FLIPPED = 4
PRIM_EYEBOX = 5
PRIM_ROTBOX = 6
PRIM_ROTBOX_WALL = 7

_EYE_HALF = (0.25, 0.12, 0.2)       # scenario_default.hpp:120
_EYE_OFFSET = (0.0, 0.0, -0.19)


def camera_tangents(height: int, width: int):
    """(tan_h, tan_v) as float32 scalars: half-FOV tangents of the camera."""
    tan_h = np.tan(np.deg2rad(C.CAMERA_FOV_DEG / 2)).astype(np.float32)
    tan_v = np.float32(tan_h * height / width)
    return tan_h, tan_v


# Layout of render_constants(); csrc/render.cu indexes the same table.
K_TAN_H, K_TAN_V, K_BAR_DEN, K_BAR_V, K_BAR_HALF_V = 0, 1, 2, 3, 4
K_IND_HALF_U, K_IND_CU, K_IND_DEN, K_BAR_RGB, K_GREEN_RGB, K_RED_RGB = 5, 6, 7, 8, 11, 14
K_COUNT = 17


def render_constants(height: int, width: int) -> np.ndarray:
    """float32 [K_COUNT]: every derived constant of the ray set-up and the HUD
    (camera tangents, bar / reward-indicator extents in normalized device
    coords, the flat-shaded HUD colours). The plain renderer and the CUDA
    kernel both read this one table, so they compare pixels against identical
    thresholds."""
    tan_h, tan_v = camera_tangents(height, width)
    k = np.zeros((K_COUNT,), np.float32)
    k[K_TAN_H] = tan_h
    k[K_TAN_V] = tan_v
    k[K_BAR_DEN] = np.float32(0.2) * tan_h
    k[K_BAR_V] = -0.131 / (0.2 * float(tan_v))
    k[K_BAR_HALF_V] = 0.0015 / (0.2 * float(tan_v))
    k[K_IND_HALF_U] = 0.06 / (0.2 * float(tan_h))
    k[K_IND_CU] = 0.23 / (0.2 * float(tan_h))
    k[K_IND_DEN] = np.float32(0.2) * tan_v
    shade = 0.3 + C.LIGHT_COLOR[0]
    for base, name in ((K_BAR_RGB, "BLUE"), (K_GREEN_RGB, "GREEN"), (K_RED_RGB, "RED")):
        k[base:base + 3] = C.PALETTE[C.COLOR_IDX[name]] * shade
    return k


class Rays(NamedTuple):
    """Per-agent rays with precomputed reciprocals. Origins broadcast as
    [B, A, 1, 1]; everything else is [B, A, H, W]. oxix/oyiy/oziz are the
    hoisted origin * reciprocal products of the slab tests."""
    ox: torch.Tensor
    oy: torch.Tensor
    oz: torch.Tensor
    dx: torch.Tensor
    dy: torch.Tensor
    dz: torch.Tensor
    ix: torch.Tensor
    iy: torch.Tensor
    iz: torch.Tensor
    oxix: torch.Tensor
    oyiy: torch.Tensor
    oziz: torch.Tensor


def _recip(d: torch.Tensor) -> torch.Tensor:
    eps = 1e-12
    return 1.0 / torch.where(d.abs() < eps, torch.full_like(d, eps), d)


def _div(a: torch.Tensor, s: float) -> torch.Tensor:
    """a / s as an IEEE division on every device. PyTorch's CUDA kernel for
    `tensor / python_scalar` multiplies by the rounded reciprocal instead,
    which differs from the render kernel's division in the last place."""
    return a / torch.full((), s, dtype=a.dtype, device=a.device)


@functools.lru_cache(maxsize=8)
def _pixel_grid_host(height: int, width: int):
    one, half, two = np.float32(1.0), np.float32(0.5), np.float32(2.0)
    cols = np.arange(width, dtype=np.float32)
    rows = np.arange(height, dtype=np.float32)
    uu = (cols + half) / np.float32(width) * two - one
    vv = one - (rows + half) / np.float32(height) * two
    return uu, vv


def pixel_grid(height: int, width: int, device):
    """(uu, vv): normalized device coords of pixel centers, [1,1,H,W]. Made on
    the host in float32 (IEEE divisions, as in the render kernel) and shipped
    to `device`."""
    uu, vv = _pixel_grid_host(height, width)
    uu = torch.from_numpy(uu).to(device).view(1, 1, 1, width)
    vv = torch.from_numpy(vv).to(device).view(1, 1, height, 1)
    return uu.expand(1, 1, height, width), vv.expand(1, 1, height, width)


def camera_rays(cams: torch.Tensor, height: int, width: int):
    """World-space unit ray directions (dx, dy, dz) [B,A,H,W] for the camera
    table cams [B,A,8] (eye xyz, yaw, pitch, ...)."""
    tan_h, tan_v = camera_tangents(height, width)
    uu, vv = pixel_grid(height, width, cams.device)
    u = uu * float(tan_h)
    v = vv * float(tan_v)
    inv_len = torch.rsqrt(u * u + v * v + 1.0)
    dx0 = u * inv_len
    dy0 = v * inv_len
    dz0 = -inv_len

    yaw = cams[:, :, 3, None, None]
    pitch = cams[:, :, 4, None, None]
    cy, sy = torch.cos(yaw), torch.sin(yaw)
    cp, sp = torch.cos(pitch), torch.sin(pitch)
    # world dir = R_y(yaw) @ R_x(pitch) @ d_cam
    y1 = cp * dy0 - sp * dz0
    z1 = sp * dy0 + cp * dz0
    dx = cy * dx0 + sy * z1
    dy = y1
    dz = -sy * dx0 + cy * z1
    return dx, dy, dz


def make_rays(cams: torch.Tensor, height: int, width: int) -> Rays:
    dx, dy, dz = camera_rays(cams, height, width)
    ox = cams[:, :, 0, None, None]
    oy = cams[:, :, 1, None, None]
    oz = cams[:, :, 2, None, None]
    ix, iy, iz = _recip(dx), _recip(dy), _recip(dz)
    return Rays(ox, oy, oz, dx, dy, dz, ix, iy, iz, ox * ix, oy * iy, oz * iz)


# ---------------------------------------------------------------------------
# Per-primitive tests. Primitive parameters are [B,1,1,1] (one table row per
# env) and broadcast against the [B,A,H,W] rays. Hits with t <= near or from
# inside are culled (rasterizer backface-culling semantics, so agents don't
# see their own body/eyes from inside). Each returns (t, nx, ny, nz).
# ---------------------------------------------------------------------------

def slab_interval(lo, hi, oxix, oyiy, oziz, rix, riy, riz):
    """Slab test of rays against the box (lo, hi): (tmin, tmax, tminx,
    tminy), the entry and exit parameters and the entry on the x and y
    axes."""
    t1x = lo[0] * rix - oxix
    t2x = hi[0] * rix - oxix
    t1y = lo[1] * riy - oyiy
    t2y = hi[1] * riy - oyiy
    t1z = lo[2] * riz - oziz
    t2z = hi[2] * riz - oziz
    tminx = torch.minimum(t1x, t2x)
    tminy = torch.minimum(t1y, t2y)
    tminz = torch.minimum(t1z, t2z)
    tmin = torch.maximum(tminx, torch.maximum(tminy, tminz))
    tmax = torch.minimum(torch.maximum(t1x, t2x),
                         torch.minimum(torch.maximum(t1y, t2y),
                                       torch.maximum(t1z, t2z)))
    return tmin, tmax, tminx, tminy


def _slab(lo, hi, oxix, oyiy, oziz, rdx, rdy, rdz, rix, riy, riz):
    tmin, tmax, tminx, tminy = slab_interval(lo, hi, oxix, oyiy, oziz, rix, riy, riz)
    hit = (tmax >= tmin) & (tmin > NEAR)
    t = torch.where(hit, tmin, torch.full_like(tmin, INF))
    # Normal: entry axis, facing against the ray.
    is_x = tmin == tminx
    is_y = (~is_x) & (tmin == tminy)
    zero = torch.zeros_like(tmin)
    nx = torch.where(is_x, -torch.sign(rdx), zero)
    ny = torch.where(is_y, -torch.sign(rdy), zero)
    nz = torch.where(is_x | is_y, zero, -torch.sign(rdz))
    return t, nx, ny, nz


def box_hit(rays: Rays, lo, hi):
    """Axis-aligned slab test; lo/hi are 3-sequences of broadcastable tensors."""
    return _slab(lo, hi, rays.oxix, rays.oyiy, rays.oziz,
                 rays.dx, rays.dy, rays.dz, rays.ix, rays.iy, rays.iz)


def ellipsoid_hit(rays: Rays, center, radii):
    """|(p-c)/r| = 1; near root only (inside -> miss)."""
    irx, iry, irz = 1.0 / radii[0], 1.0 / radii[1], 1.0 / radii[2]
    qx = (rays.ox - center[0]) * irx
    qy = (rays.oy - center[1]) * iry
    qz = (rays.oz - center[2]) * irz
    ddx = rays.dx * irx
    ddy = rays.dy * iry
    ddz = rays.dz * irz
    a = ddx * ddx + ddy * ddy + ddz * ddz
    b = qx * ddx + qy * ddy + qz * ddz
    c0 = qx * qx + qy * qy + qz * qz - 1.0
    disc = b * b - a * c0
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t = (-b - sq) / torch.clamp(a, min=1e-12)
    hit = (disc > 0) & (t > NEAR)
    t = torch.where(hit, t, torch.full_like(t, INF))
    nx = (rays.ox + t * rays.dx - center[0]) * irx * irx
    ny = (rays.oy + t * rays.dy - center[1]) * iry * iry
    nz = (rays.oz + t * rays.dz - center[2]) * irz * irz
    inv = torch.rsqrt(nx * nx + ny * ny + nz * nz + 1e-18)
    return t, nx * inv, ny * inv, nz * inv


def cylinder_hit(rays: Rays, center, rx, rz, half_h):
    """Closed elliptic cylinder along y."""
    qx = (rays.ox - center[0]) / rx
    qz = (rays.oz - center[2]) / rz
    ddx = rays.dx / rx
    ddz = rays.dz / rz
    a = ddx * ddx + ddz * ddz
    b = qx * ddx + qz * ddz
    c0 = qx * qx + qz * qz - 1.0
    disc = b * b - a * c0
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t_side = (-b - sq) / torch.clamp(a, min=1e-12)
    y_side = rays.oy + t_side * rays.dy - center[1]
    side_ok = (disc > 0) & (t_side > NEAR) & (y_side.abs() <= half_h)
    inf = torch.full_like(t_side, INF)
    t_side = torch.where(side_ok, t_side, inf)

    sign = -torch.sign(rays.dy)
    cap_y = center[1] + sign * half_h
    t_cap = (cap_y - rays.oy) * rays.iy
    px = (rays.ox + t_cap * rays.dx - center[0]) / rx
    pz = (rays.oz + t_cap * rays.dz - center[2]) / rz
    cap_ok = (t_cap > NEAR) & (px * px + pz * pz <= 1.0)
    t_cap = torch.where(cap_ok, t_cap, inf)

    use_cap = t_cap < t_side
    t = torch.minimum(t_side, t_cap)
    snx = (rays.ox + t * rays.dx - center[0]) / (rx * rx)
    snz = (rays.oz + t * rays.dz - center[2]) / (rz * rz)
    inv = torch.rsqrt(snx * snx + snz * snz + 1e-18)
    zero = torch.zeros_like(t)
    nx = torch.where(use_cap, zero, snx * inv)
    ny = torch.where(use_cap, sign, zero)
    nz = torch.where(use_cap, zero, snz * inv)
    return t, nx, ny, nz


def cone_hit(rays: Rays, center, rx, rz, half_h, s: float):
    """Cone along y: apex at center + s*(0,half_h,0), elliptic base radius
    (rx, rz) at the opposite end; s = -1 mirrors it (diamond bottom halves,
    layout_utils.cpp addDiamond)."""
    apex_y = center[1] + s * half_h
    qx = (rays.ox - center[0]) / rx
    qz = (rays.oz - center[2]) / rz
    qy = (rays.oy - apex_y) * s
    ddx = rays.dx / rx
    ddz = rays.dz / rz
    ddy = rays.dy * s
    k = 1.0 / (2.0 * half_h)
    kd = k * ddy
    a = ddx * ddx + ddz * ddz - kd * kd
    b = qx * ddx + qz * ddz - k * k * qy * ddy
    kq = k * qy
    c0 = qx * qx + qz * qz - kq * kq
    disc = b * b - a * c0
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    asafe = torch.where(a.abs() < 1e-12, torch.full_like(a, 1e-12), a)
    t1 = (-b - sq) / asafe
    t2 = (-b + sq) / asafe

    def ok(t):
        yy = qy + t * ddy
        return (disc > 0) & (t > NEAR) & (yy <= 0) & (yy >= -2.0 * half_h)

    inf = torch.full_like(t1, INF)
    t_side = torch.where(ok(t1), t1, torch.where(ok(t2), t2, inf))

    base_y = apex_y - s * 2.0 * half_h
    t_cap = (base_y - rays.oy) * rays.iy
    px = (rays.ox + t_cap * rays.dx - center[0]) / rx
    pz = (rays.oz + t_cap * rays.dz - center[2]) / rz
    cap_ok = (t_cap > NEAR) & (px * px + pz * pz <= 1.0)
    t_cap = torch.where(cap_ok, t_cap, inf)

    use_cap = t_cap < t_side
    t = torch.minimum(t_side, t_cap)
    relx = rays.ox + t * rays.dx - center[0]
    rely = rays.oy + t * rays.dy - apex_y
    relz = rays.oz + t * rays.dz - center[2]
    snx = relx / (rx * rx)
    sny = -(k * k) * rely
    snz = relz / (rz * rz)
    inv = torch.rsqrt(snx * snx + sny * sny + snz * snz + 1e-18)
    zero = torch.zeros_like(t)
    nx = torch.where(use_cap, zero, snx * inv)
    ny = torch.where(use_cap, torch.full_like(t, -s), sny * inv)
    nz = torch.where(use_cap, zero, snz * inv)
    return t, nx, ny, nz


def eyebox_hit(rays: Rays, cam, byaw, bpitch):
    """Yaw/pitch-rotated eye box of another agent: ray -> that agent's camera
    frame, slab test, normal back to world."""
    cyj, syj = torch.cos(byaw), torch.sin(byaw)
    cpj, spj = torch.cos(bpitch), torch.sin(bpitch)
    ox, oy, oz = rays.ox - cam[0], rays.oy - cam[1], rays.oz - cam[2]
    lx = cyj * ox - syj * oz
    lz1 = syj * ox + cyj * oz
    ly = cpj * oy + spj * lz1
    lz = -spj * oy + cpj * lz1
    dlx = cyj * rays.dx - syj * rays.dz
    dlz1 = syj * rays.dx + cyj * rays.dz
    dly = cpj * rays.dy + spj * dlz1
    dlz = -spj * rays.dy + cpj * dlz1
    rix, riy, riz = _recip(dlx), _recip(dly), _recip(dlz)
    lo = tuple(o - h for o, h in zip(_EYE_OFFSET, _EYE_HALF))
    hi = tuple(o + h for o, h in zip(_EYE_OFFSET, _EYE_HALF))
    t, nlx, nly, nlz = _slab(lo, hi, lx * rix, ly * riy, lz * riz,
                             dlx, dly, dlz, rix, riy, riz)
    wy = cpj * nly - spj * nlz
    wz1 = spj * nly + cpj * nlz
    wx = cyj * nlx + syj * wz1
    wz = -syj * nlx + cyj * wz1
    return t, wx, wy, wz


def _rot_frame(rays: Rays, center, cyj, syj):
    ox, oy, oz = rays.ox - center[0], rays.oy - center[1], rays.oz - center[2]
    lx = cyj * ox - syj * oz
    lz = syj * ox + cyj * oz
    dlx = cyj * rays.dx - syj * rays.dz
    dlz = syj * rays.dx + cyj * rays.dz
    rix, riz = _recip(dlx), _recip(dlz)
    return oy, dlx, dlz, rix, riz, lx * rix, oy * rays.iy, lz * riz


def rotbox_hit(rays: Rays, center, cyj, syj, half):
    """y-rotated box; cyj/syj are the row's precomputed cos/sin of its yaw."""
    _, dlx, dlz, rix, riz, oxix, oyiy, oziz = _rot_frame(rays, center, cyj, syj)
    t, nlx, nly, nlz = _slab(
        (-half[0], -half[1], -half[2]), half, oxix, oyiy, oziz,
        dlx, rays.dy, dlz, rix, rays.iy, riz)
    wx = cyj * nlx + syj * nlz
    wz = -syj * nlx + cyj * nlz
    return t, wx, nly, wz


def rotbox_wall_hit(rays: Rays, center, cyj, syj, half, wcol, ecol):
    """Fused hex wall + derived bottom edging: shared rotated-ray products,
    two slab tests; the edging (drawn after the wall) wins only a strictly
    closer hit. Also returns the per-pixel packed colour plane."""
    hx, hy, hz = half
    _, dlx, dlz, rix, riz, oxix, oyiy, oziz = _rot_frame(rays, center, cyj, syj)
    tw, nlx, nly, nlz = _slab((-hx, -hy, -hz), (hx, hy, hz), oxix, oyiy, oziz,
                              dlx, rays.dy, dlz, rix, rays.iy, riz)
    ehx = float(np.float32(C.WALL_EDGE_LEN_SCALE)) * hx
    ehz = torch.full_like(hx, float(np.float32(C.WALL_EDGE_HZ)))
    cy0 = center[1]
    te, elx, ely, elz = _slab(
        (-ehx, -cy0, -ehz),
        (ehx, float(np.float32(2.0 * C.WALL_EDGE_H_FRAC)) * hy - cy0, ehz),
        oxix, oyiy, oziz, dlx, rays.dy, dlz, rix, rays.iy, riz)
    use_e = te < tw
    t = torch.where(use_e, te, tw)
    nlx = torch.where(use_e, elx, nlx)
    nly = torch.where(use_e, ely, nly)
    nlz = torch.where(use_e, elz, nlz)
    col = torch.where(use_e, ecol.expand_as(t), wcol.expand_as(t))
    wx = cyj * nlx + syj * nlz
    wz = -syj * nlx + cyj * nlz
    return t, wx, nly, wz, col


def row_hit(rays: Rays, row: torch.Tensor, ptype: int):
    """Intersection of table row `row` [B,12] read as primitive type `ptype`.
    Returns (t, nx, ny, nz, col); col is None unless the routine yields a
    per-pixel colour (fused wall rows)."""
    r = [row[:, c].view(-1, 1, 1, 1) for c in range(12)]
    a = (r[1], r[2], r[3])
    b = (r[4], r[5], r[6])
    if ptype == PRIM_AABB:
        return (*box_hit(rays, a, b), None)
    if ptype == PRIM_ELLIPSOID:
        return (*ellipsoid_hit(rays, a, b), None)
    if ptype == PRIM_CYLINDER:
        return (*cylinder_hit(rays, a, b[0], b[1], b[2]), None)
    if ptype == PRIM_CONE:
        return (*cone_hit(rays, a, b[0], b[1], b[2], 1.0), None)
    if ptype == PRIM_CONE_FLIPPED:
        return (*cone_hit(rays, a, b[0], b[1], b[2], -1.0), None)
    if ptype == PRIM_EYEBOX:
        return (*eyebox_hit(rays, a, b[0], b[1]), None)
    if ptype == PRIM_ROTBOX:
        return (*rotbox_hit(rays, a, b[1], b[2], (r[8], r[9], r[10])), None)
    if ptype == PRIM_ROTBOX_WALL:
        return rotbox_wall_hit(rays, a, b[1], b[2], (r[8], r[9], r[10]),
                               r[7], r[11])
    raise ValueError(f"unknown primitive type {ptype}")


# ---------------------------------------------------------------------------
# Shading, HUD, packing.
# ---------------------------------------------------------------------------

def pow_shininess(x: torch.Tensor) -> torch.Tensor:
    """x ** LIGHT_SHININESS by repeated squaring (integer exponent); the
    multiplication order is the one the kernel uses. x must be >= 0."""
    n = int(C.LIGHT_SHININESS)
    acc = None
    sq = x
    while n:
        if n & 1:
            acc = sq if acc is None else acc * sq
        n >>= 1
        if n:
            sq = sq * sq
    return acc


def shade_planes(rays: Rays, t, nx, ny, nz, cpk):
    """Blinn-Phong, single light (v4r addLight((0,4,2), 0.66)), no attenuation.
    `cpk` is the packed albedo (float holding (r8<<16)|(g8<<8)|b8). Returns
    unclipped float planes (r, g, b) [B,A,H,W]."""
    pk = cpk.to(torch.int32)
    cr = _div(((pk >> 16) & 0xFF).to(torch.float32), 255.0)
    cg = _div(((pk >> 8) & 0xFF).to(torch.float32), 255.0)
    cb = _div((pk & 0xFF).to(torch.float32), 255.0)

    px = rays.ox + t * rays.dx
    py = rays.oy + t * rays.dy
    pz = rays.oz + t * rays.dz
    lx = C.LIGHT_POSITION[0] - px
    ly = C.LIGHT_POSITION[1] - py
    lz = C.LIGHT_POSITION[2] - pz
    inv = torch.rsqrt(lx * lx + ly * ly + lz * lz + 1e-12)
    lx, ly, lz = lx * inv, ly * inv, lz * inv
    ndl = torch.clamp(nx * lx + ny * ly + nz * lz, min=0.0)
    # half vector (ray dir is unit, pointing away from the eye)
    hx, hy, hz = lx - rays.dx, ly - rays.dy, lz - rays.dz
    inv_h = torch.rsqrt(hx * hx + hy * hy + hz * hz + 1e-12)
    ndh = torch.clamp(nx * hx + ny * hy + nz * hz, min=0.0) * inv_h
    spec = pow_shininess(ndh)

    lc = float(np.float32(C.LIGHT_COLOR[0]))  # grey light
    diff = 0.3 + ndl * lc
    sp_term = spec * lc
    miss = t >= FAR
    r = torch.where(miss, torch.full_like(t, C.SKY_COLOR[0]), cr * diff + sp_term)
    g = torch.where(miss, torch.full_like(t, C.SKY_COLOR[1]), cg * diff + sp_term)
    b = torch.where(miss, torch.full_like(t, C.SKY_COLOR[2]), cb * diff + sp_term)
    return r, g, b


def hud_planes(cams: torch.Tensor, planes, height: int, width: int,
               ui_indicators: bool = False):
    """Remaining-time bar (scenario_default.hpp:140-145, 164-169) and, with
    `ui_indicators`, the reward indicator quads (GREEN at camera-space x=-0.23
    while lastReward > eps, RED at +0.23 while < -eps; half extents (0.06,
    0.04*|lastReward|), scenario_default.hpp:147-186), composited in 2D.
    cams[..., 5] is the remaining-time fraction, cams[..., 6] lastReward."""
    k = [float(v) for v in render_constants(height, width)]
    uu, vv = pixel_grid(height, width, cams.device)
    time_frac = cams[:, :, 5, None, None]
    bar_half_u = _div(0.24 * time_frac, k[K_BAR_DEN])
    in_bar = (uu.abs() <= bar_half_u) & ((vv - k[K_BAR_V]).abs() <= k[K_BAR_HALF_V])
    r, g, b = (torch.where(in_bar, torch.full_like(p, k[K_BAR_RGB + c]), p)
               for c, p in enumerate(planes))
    if not ui_indicators:
        return r, g, b
    lr = cams[:, :, 6, None, None]
    feps = 1.19209290e-07  # FLT_EPSILON (scenario_default.hpp:172)
    half_v = _div(0.04 * lr.abs(), k[K_IND_DEN])
    in_v_ind = vv.abs() <= half_v
    pos_m = (lr > feps) & ((uu + k[K_IND_CU]).abs() <= k[K_IND_HALF_U]) & in_v_ind
    neg_m = (lr < -feps) & ((uu - k[K_IND_CU]).abs() <= k[K_IND_HALF_U]) & in_v_ind
    out = []
    for c, p in enumerate((r, g, b)):
        p = torch.where(neg_m, torch.full_like(p, k[K_RED_RGB + c]), p)
        p = torch.where(pos_m, torch.full_like(p, k[K_GREEN_RGB + c]), p)
        out.append(p)
    return tuple(out)


def pack_planes(r, g, b) -> torch.Tensor:
    """Three float planes -> packed RGB int32 ((r8<<16)|(g8<<8)|b8)."""
    to8 = lambda c: torch.clamp(c * 255.0 + 0.5, 0.0, 255.0).to(torch.int32)
    return (to8(r) << 16) | (to8(g) << 8) | to8(b)


# ---------------------------------------------------------------------------
# Table renderer.
# ---------------------------------------------------------------------------

def render_table_packed(cams: torch.Tensor, prims: torch.Tensor, height: int,
                        width: int, ui_indicators: bool = False,
                        row_order: Optional[Sequence[int]] = None,
                        row_mask: Optional[torch.Tensor] = None,
                        tiebreak: Optional[bool] = None,
                        far_start: Optional[bool] = None) -> torch.Tensor:
    """Render cams [B,A,8] against prims [B,M,12] -> packed int32 [B,A,H,W];
    the traversal is `trace_table`'s."""
    rays, bt, _, bnx, bny, bnz, bc = trace_table(cams, prims, height, width, row_order,
                                                 row_mask, tiebreak, far_start)
    planes = shade_planes(rays, bt, bnx, bny, bnz, bc)
    planes = hud_planes(cams, planes, height, width, ui_indicators)
    return pack_planes(*planes)


def trace_table(cams: torch.Tensor, prims: torch.Tensor, height: int, width: int,
                row_order: Optional[Sequence[int]] = None,
                row_mask: Optional[torch.Tensor] = None,
                tiebreak: Optional[bool] = None,
                far_start: Optional[bool] = None):
    """Closest hit of every pixel's ray in the table: (rays, t, row, nx, ny,
    nz, packed colour), each [B,A,H,W] but the rays; `row` is the winning
    row's index, M where no row won.

    Default: rows in table order with the strict `t < best` carry starting at
    +INF (the unculled in-order form). With `row_order` (any sequence of row
    indices) and/or `row_mask` (bool, broadcastable to [B,A,T,M], T = H/8:
    which rows each 8-row pixel tile may test) the carry is the bit-walk
    form's: it starts at the far plane and breaks ties towards the lowest row
    index, which makes the image independent of visiting order and equal to
    the in-order one. `tiebreak` and `far_start` override those two choices
    one by one (the clustered in-order form masks rows but keeps the strict
    carry from +INF; the sorted form without distance bounds breaks ties but
    starts at +INF).
    """
    bsz, num_agents, _ = cams.shape
    num_prims = prims.shape[1]
    rays = make_rays(cams, height, width)
    shape = (bsz, num_agents, height, width)
    dev = cams.device
    if tiebreak is None:
        tiebreak = row_order is not None or row_mask is not None
    if far_start is None:
        far_start = tiebreak
    if row_order is None:
        row_order = range(num_prims)
    zero = torch.zeros(shape, dtype=torch.float32, device=dev)
    bt = torch.full(shape, FAR if far_start else INF, dtype=torch.float32, device=dev)
    bidx = torch.full(shape, num_prims, dtype=torch.int32, device=dev)
    bnx, bny, bnz, bc = zero, zero, zero, zero
    inf = torch.full(shape, INF, dtype=torch.float32, device=dev)
    if row_mask is not None:
        assert height % TILE_H == 0
        tiles = height // TILE_H
        pix_mask = row_mask.expand(bsz, num_agents, tiles, num_prims) \
            .repeat_interleave(TILE_H, dim=2)                 # [B,A,H,M]

    # one transfer of the type column decides which routines each row needs
    types_host = prims[:, :, 0].detach().to("cpu").numpy().astype(np.int64)
    for i in row_order:
        i = int(i)
        kinds = sorted({int(min(k, 7)) for k in types_host[:, i] if k >= 0})
        if not kinds:
            continue
        row = prims[:, i]
        ptype = row[:, 0].to(torch.int32).view(-1, 1, 1, 1).clamp(max=7)
        col_row = row[:, 7].view(-1, 1, 1, 1)
        t, nx, ny, nz, col = inf, zero, zero, zero, col_row.expand(shape)
        for k in kinds:
            tk, nxk, nyk, nzk, ck = row_hit(rays, row, k)
            m = ptype == k
            t = torch.where(m, tk, t)
            nx = torch.where(m, nxk, nx)
            ny = torch.where(m, nyk, ny)
            nz = torch.where(m, nzk, nz)
            if ck is not None:
                col = torch.where(m, ck, col)
        if row_mask is not None:
            t = torch.where(pix_mask[:, :, :, i, None], t, inf)
        if tiebreak:
            closer = (t < bt) | ((t == bt) & (i < bidx))
        else:
            closer = t < bt
        bidx = torch.where(closer, torch.full_like(bidx, i), bidx)
        bt = torch.where(closer, t, bt)
        bnx = torch.where(closer, nx, bnx)
        bny = torch.where(closer, ny, bny)
        bnz = torch.where(closer, nz, bnz)
        bc = torch.where(closer, col, bc)
    return rays, bt, bidx, bnx, bny, bnz, bc
