"""Voxel-grid queries on packed solid columns (counterpart of
megaverse_tpu/ops/grid.py).

The reference's sparse hash-map VoxelGrid (util/voxel_grid.hpp:57-165) becomes
small fixed-shape dense arrays; the SOLID bit is packed along Y into 32-bit
words per (x, z) column, so one column gather plus bit tests answers the
physics queries.

Every function is batched over envs explicitly: grids are [B, X, Y|W, Z] and
coordinates / positions are [B, ...] with the same leading B. Column words are
stored as int32 (the same bits as the JAX package's uint32); bit arithmetic is
done on int64 copies holding the unsigned 32-bit value, so shifts are logical
and bit 31 behaves. Out-of-range reads are clamped and masked, out-of-range
writes dropped, explicitly (PyTorch raises where JAX clamps).
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from reference.sim import constants as C
from reference.sim.types import GridConfig, device_const

# Keeps AABBs strictly inside voxel cells when touching boundaries (standing
# exactly on a floor is not a horizontal collision with it).
BOUNDARY_EPS = 1e-4
_U32 = 0xFFFFFFFF


def _origin(cfg: GridConfig, like: torch.Tensor) -> torch.Tensor:
    return device_const(cfg.origin, torch.float32, like)


def _dims(cfg: GridConfig, like: torch.Tensor) -> torch.Tensor:
    return device_const(cfg.dims, torch.int32, like)


def _bidx(like: torch.Tensor) -> torch.Tensor:
    """Env index [B,1,...] broadcastable against `like` [B, ...]."""
    b = like.shape[0]
    return torch.arange(b, device=like.device).view((b,) + (1,) * (like.dim() - 1))


def world_to_voxel(cfg: GridConfig, p: torch.Tensor) -> torch.Tensor:
    """World position -> integer voxel coords (ref voxel_grid.hpp:144-149)."""
    return torch.floor((p - _origin(cfg, p)) / cfg.voxel_size).to(torch.int32)


def axis_index(cfg: GridConfig, axis: int, w: torch.Tensor) -> torch.Tensor:
    """World coordinate along one axis -> voxel index along that axis."""
    return torch.floor((w - cfg.origin[axis]) / cfg.voxel_size).to(torch.int32)


def voxel_center(cfg: GridConfig, ii: torch.Tensor) -> torch.Tensor:
    return _origin(cfg, ii) + (ii.to(torch.float32) + 0.5) * cfg.voxel_size


def _valid_clip(cfg: GridConfig, ii: torch.Tensor):
    dims = _dims(cfg, ii)
    valid = ((ii >= 0) & (ii < dims)).all(dim=-1)
    iic = torch.minimum(torch.clamp(ii, min=0), dims - 1).long()
    return valid, iic


def gather_voxel(cfg: GridConfig, field: torch.Tensor, ii: torch.Tensor) -> torch.Tensor:
    """Gather field [B,X,Y,Z] at integer coords [B,...,3]; out-of-bounds -> 0."""
    valid, iic = _valid_clip(cfg, ii)
    vals = field[_bidx(valid), iic[..., 0], iic[..., 1], iic[..., 2]]
    return torch.where(valid, vals, torch.zeros_like(vals))


def set_voxel(cfg: GridConfig, field: torch.Tensor, ii: torch.Tensor, value) -> torch.Tensor:
    """Write value(s) at integer coords [B,...,3] INTO `field` (an integer
    grid [B,X,Y,Z]) and return it; out-of-bounds writes are DROPPED (callers
    mask inactive rows by passing coords of -1). Kept rows must name distinct
    cells. Only the named cells are touched: each kept row adds the
    difference between its value and the cell's current one (exact under
    integer wraparound), a dropped row adds 0 at its clamped cell, so it
    never clobbers a kept row's write there."""
    valid, iic = _valid_clip(cfg, ii)
    if torch.is_tensor(value):
        value = value.to(field.dtype).expand(valid.shape)
    else:
        value = torch.full(valid.shape, value, dtype=field.dtype, device=field.device)
    at = (_bidx(valid).expand(valid.shape), iic[..., 0], iic[..., 1], iic[..., 2])
    delta = torch.where(valid, value - field[at], torch.zeros_like(value))
    field.index_put_(at, delta, accumulate=True)
    return field


def span_for(cfg: GridConfig, size_world) -> Tuple[int, ...]:
    """Static per-axis voxel span (max cells covered) for a box of given size:
    an interval of length L at arbitrary alignment overlaps up to
    floor(L / voxel) + 2 cells."""
    return tuple(int(math.floor(s / cfg.voxel_size)) + 2 for s in size_world)


def _offsets(device, *spans: int) -> torch.Tensor:
    """[prod(spans), len(spans)] integer offset table (static)."""
    grids = torch.meshgrid(*[torch.arange(s, dtype=torch.int32, device=device)
                             for s in spans], indexing="ij")
    return torch.stack(grids, dim=-1).reshape(-1, len(spans))


# ---------------------------------------------------------------------------
# Packed-column representation.
# ---------------------------------------------------------------------------

def pack_solid_columns_np(vtype) -> np.ndarray:
    """Host-side pack of one [X, Y, Z] voxel-flag grid -> int32 [X, W, Z],
    W = ceil(Y/32); bit y%32 of word y//32 is the SOLID flag of cell y. Used
    by layout generation so the device never re-scans the dense grid."""
    x, y, z = vtype.shape
    w = -(-y // 32)
    solid = ((vtype & C.VOXEL_SOLID) != 0).astype(np.uint32)
    if w * 32 - y:
        solid = np.pad(solid, ((0, 0), (0, w * 32 - y), (0, 0)))
    solid = solid.reshape(x, w, 32, z)
    shifts = np.arange(32, dtype=np.uint32)[None, None, :, None]
    return np.sum(solid << shifts, axis=2, dtype=np.uint32).view(np.int32)


def _to_u(words: torch.Tensor) -> torch.Tensor:
    """int32 storage -> int64 holding the unsigned 32-bit value."""
    return words.to(torch.int64) & _U32


def _to_i32(u: torch.Tensor) -> torch.Tensor:
    """int64 unsigned 32-bit value -> int32 storage (two's complement)."""
    return torch.where(u >= 2 ** 31, u - 2 ** 32, u).to(torch.int32)


def pack_solid_columns(cfg: GridConfig, vtype: torch.Tensor) -> torch.Tensor:
    """[B, X, Y, Z] voxel flags -> int32 [B, X, W, Z] packed SOLID columns."""
    b = vtype.shape[0]
    x, y, z = cfg.dims
    w = -(-y // 32)
    solid = ((vtype & C.VOXEL_SOLID) != 0).to(torch.int64)
    pad = w * 32 - y
    if pad:
        solid = torch.nn.functional.pad(solid, (0, 0, 0, pad))
    solid = solid.reshape(b, x, w, 32, z)
    shifts = torch.arange(32, dtype=torch.int64, device=vtype.device).view(1, 1, 1, 32, 1)
    return _to_i32((solid << shifts).sum(dim=3))


def update_cols(cfg: GridConfig, cols: torch.Tensor, ii: torch.Tensor, solid) -> torch.Tensor:
    """Set/clear the SOLID bit of packed columns at integer coords [B,...,3]
    IN `cols` and return it. Out-of-bounds writes are dropped (pass coords
    of -1 to mask rows out); `solid` is a boolean (broadcast to the coord
    batch). Several coords may share one packed WORD (same x,z column,
    different y), so the update is an accumulate-add of single-bit deltas
    guarded by the bit's current value: associative and exact under int32
    wraparound, and it touches only the words named. Precondition: no two
    kept rows name the SAME CELL."""
    valid, iic = _valid_clip(cfg, ii)
    xw = iic[..., 0]
    yw = iic[..., 1] >> 5
    zw = iic[..., 2]
    bi = _bidx(valid).expand(valid.shape)
    bit = torch.ones_like(yw) << (iic[..., 1] & 31)          # int64
    old = _to_u(cols[bi, xw, yw, zw])
    already = (old & bit) != 0
    if torch.is_tensor(solid):
        solid = solid.to(torch.bool).expand(valid.shape)
    else:
        solid = torch.full(valid.shape, bool(solid), dtype=torch.bool, device=cols.device)
    delta = torch.where(valid & (solid != already), bit, torch.zeros_like(bit))
    delta = torch.where(solid, delta, -delta)
    cols.index_put_((bi, xw, yw, zw), _to_i32(delta & _U32), accumulate=True)
    return cols


def solid_from_cols(cfg: GridConfig, cols: torch.Tensor, ii: torch.Tensor) -> torch.Tensor:
    """SOLID flag at integer coords [B,...,3] from packed columns;
    out-of-bounds coords read False."""
    valid, iic = _valid_clip(cfg, ii)
    word = _to_u(cols[_bidx(valid), iic[..., 0], iic[..., 1] >> 5, iic[..., 2]])
    bit = (word >> (iic[..., 1] & 31)) & 1
    return valid & (bit != 0)


def _col_word(cols: torch.Tensor, bi, xc, wi, zc) -> torch.Tensor:
    """Unsigned cols[b, x, wi, z] with wi clamped; out-of-range words read 0."""
    nw = cols.shape[-2]
    w = _to_u(cols[bi, xc, torch.clamp(wi, max=nw - 1), zc])
    return torch.where(wi < nw, w, torch.zeros_like(w))


def _highest_bit(v: torch.Tensor) -> torch.Tensor:
    """Index of the highest set bit of an unsigned 32-bit value (0 -> 0)."""
    hb = torch.zeros_like(v)
    for s in (16, 8, 4, 2, 1):
        big = (v >> (hb + s)) > 0
        hb = torch.where(big, hb + s, hb)
    return hb.to(torch.int32)


def _lowest_bit(v: torch.Tensor) -> torch.Tensor:
    return _highest_bit(v & (-v))


def first_free_above(cfg: GridConfig, cols: torch.Tensor, ii: torch.Tensor,
                     max_scan: int) -> torch.Tensor:
    """Climb coords [B,...,3] upward while their voxel is SOLID, capped at
    max_scan steps: bit-exact replacement for the sequential loop
    `voxel.y += 1 while solid(voxel)` (FallDetectionComponent's respawn climb,
    component_fall_detection.hpp:49-56). One two-word gather plus a
    count-trailing-ones. Out-of-bounds coords read "free" and stay put.
    Requires max_scan <= 32."""
    assert max_scan <= 32
    dx, _, dz = cfg.dims
    x, y0, z = ii[..., 0], ii[..., 1], ii[..., 2]
    xz_ok = (x >= 0) & (x < dx) & (z >= 0) & (z < dz) & (y0 >= 0)
    xc = torch.clamp(x, 0, dx - 1).long()
    zc = torch.clamp(z, 0, dz - 1).long()
    y0c = torch.clamp(y0, min=0).long()
    wi = y0c >> 5
    s = y0c & 31
    bi = _bidx(xz_ok)
    w0 = _col_word(cols, bi, xc, wi, zc)
    w1 = _col_word(cols, bi, xc, wi + 1, zc)
    # 32-bit window: bit k = SOLID at cell y0 + k (bits past the grid top are
    # 0 = free, matching the loop's out-of-bounds stop)
    win = (w0 >> s) | torch.where(s == 0, torch.zeros_like(w1), (w1 << (32 - s)) & _U32)
    m = ~win & _U32                    # 1 = free
    dy = torch.where(m == 0, torch.full_like(s, 32).to(torch.int32), _lowest_bit(m))
    dy = torch.where(xz_ok, torch.clamp(dy, max=max_scan), torch.zeros_like(dy))
    return torch.stack([x, y0 + dy.to(y0.dtype), z], dim=-1)


def _gather_cols(cfg: GridConfig, cols: torch.Tensor, ix: torch.Tensor, iz: torch.Tensor):
    """Unsigned column words at integer (ix, iz) [B,...]; out of bounds -> 0.
    Returns int64 [B, ..., W]."""
    x, _, z = cfg.dims
    valid = (ix >= 0) & (ix < x) & (iz >= 0) & (iz < z)
    ixc = torch.clamp(ix, 0, x - 1).long()
    izc = torch.clamp(iz, 0, z - 1).long()
    vals = _to_u(cols[_bidx(valid), ixc, :, izc])  # [B, ..., W]
    return torch.where(valid[..., None], vals, torch.zeros_like(vals))


def _mask_below(h: torch.Tensor) -> torch.Tensor:
    """Unsigned mask with bits [0, h) set; h clipped to [0, 32]."""
    h = torch.clamp(h, 0, 32).to(torch.int64)
    return (torch.ones_like(h) << h) - 1


def _range_mask(y0: torch.Tensor, y1: torch.Tensor, word: int) -> torch.Tensor:
    """Unsigned mask of bits for cells [y0, y1] inclusive within word index."""
    return _mask_below(y1 + 1 - 32 * word) & (~_mask_below(y0 - 32 * word) & _U32)


def _footprint_index(cfg, x0, x1, z0, z1, span_xz):
    sx, sz = span_xz
    ix0 = axis_index(cfg, 0, x0 + BOUNDARY_EPS)
    ix1 = axis_index(cfg, 0, x1 - BOUNDARY_EPS)
    iz0 = axis_index(cfg, 2, z0 + BOUNDARY_EPS)
    iz1 = axis_index(cfg, 2, z1 - BOUNDARY_EPS)
    off = _offsets(x0.device, sx, sz)  # [S, 2]
    ix = ix0[..., None] + off[..., 0]
    iz = iz0[..., None] + off[..., 1]
    in_range = (ix <= ix1[..., None]) & (iz <= iz1[..., None])
    return ix, iz, in_range


def _footprint_cols(cfg: GridConfig, cols, x0, x1, z0, z1, span_xz):
    """Column words under a footprint with in-range mask. Returns
    (words int64 [B,...,S,W], in_range bool [B,...,S])."""
    ix, iz, in_range = _footprint_index(cfg, x0, x1, z0, z1, span_xz)
    return _gather_cols(cfg, cols, ix, iz), in_range


def cols_aabb_hits_solid(cfg, cols, lo, hi, span_xz) -> torch.Tensor:
    """True if world AABB [lo, hi] ([B,...,3]) overlaps any SOLID voxel."""
    words, in_range = _footprint_cols(
        cfg, cols, lo[..., 0], hi[..., 0], lo[..., 2], hi[..., 2], span_xz)
    iy0 = axis_index(cfg, 1, lo[..., 1] + BOUNDARY_EPS)
    iy1 = axis_index(cfg, 1, hi[..., 1] - BOUNDARY_EPS)
    ny = cfg.dims[1]
    iy0 = torch.clamp(iy0, min=0)[..., None]
    iy1 = torch.clamp(iy1, max=ny - 1)[..., None]
    hit = torch.zeros(words.shape[:-2], dtype=torch.bool, device=words.device)
    for w in range(words.shape[-1]):
        m = _range_mask(iy0, iy1, w)
        hit = hit | (in_range & ((words[..., w] & m) != 0)).any(dim=-1)
    return hit


def cols_cell_solid(cfg, cols, ix, iz, ylo, yhi) -> torch.Tensor:
    """Any SOLID bit in column (ix, iz) within world-y range [ylo, yhi]
    (same BOUNDARY_EPS index rounding as cols_aabb_hits_solid)."""
    words = _gather_cols(cfg, cols, ix, iz)
    iy0 = torch.clamp(axis_index(cfg, 1, ylo + BOUNDARY_EPS), min=0)
    iy1 = torch.clamp(axis_index(cfg, 1, yhi - BOUNDARY_EPS), max=cfg.dims[1] - 1)
    hit = torch.zeros(ix.shape, dtype=torch.bool, device=ix.device)
    for w in range(words.shape[-1]):
        m = _range_mask(iy0, iy1, w)
        hit = hit | ((words[..., w] & m) != 0)
    return hit


def cols_highest_floor_below(cfg, cols, x0, x1, z0, z1, bottom, max_drop, span_xz):
    """Landing height for a box footprint dropping from `bottom` ->
    (top_y, found): the highest SOLID voxel whose top lies in
    [bottom - max_drop, bottom + eps] (stepDown sweep, kcc.cpp:400-442)."""
    words, in_range = _footprint_cols(cfg, cols, x0, x1, z0, z1, span_xz)
    iy_top = axis_index(cfg, 1, bottom + BOUNDARY_EPS) - 1
    # -1 widens one cell so the exact-equality candidate survives; the top_y
    # post-filter restores the precise bound.
    iy_lo = axis_index(cfg, 1, bottom - max_drop) - 1
    ny = cfg.dims[1]
    iy0 = torch.clamp(iy_lo, 0, ny - 1)[..., None]
    iy1 = torch.clamp(iy_top, -1, ny - 1)[..., None]
    best = torch.full(words.shape[:-1], -1, dtype=torch.int32, device=words.device)
    for w in range(words.shape[-1]):
        m = _range_mask(iy0, iy1, w)
        bits = words[..., w] & m
        hb = _highest_bit(bits) + 32 * w
        best = torch.where((bits != 0) & in_range, torch.maximum(best, hb), best)
    best = best.amax(dim=-1)
    found = best >= 0
    top_y = cfg.origin[1] + (best.to(torch.float32) + 1.0) * cfg.voxel_size
    ok = found & (top_y >= bottom - max_drop)
    return torch.where(ok, top_y, torch.full_like(top_y, -math.inf)), ok


def cols_lowest_ceiling_above(cfg, cols, x0, x1, z0, z1, top, max_rise, span_xz):
    """Ceiling height for a box footprint rising from `top` ->
    (bottom_y, found) (stepUp, kcc.cpp:223-304)."""
    words, in_range = _footprint_cols(cfg, cols, x0, x1, z0, z1, span_xz)
    iy_bot = axis_index(cfg, 1, top - BOUNDARY_EPS) + 1
    iy_hi = axis_index(cfg, 1, top + max_rise)
    ny = cfg.dims[1]
    iy0 = torch.clamp(iy_bot, 0, ny - 1)[..., None]
    iy1 = torch.clamp(iy_hi, -1, ny - 1)[..., None]
    big = 1 << 30
    best = torch.full(words.shape[:-1], big, dtype=torch.int32, device=words.device)
    for w in range(words.shape[-1]):
        m = _range_mask(iy0, iy1, w)
        bits = words[..., w] & m
        lb = _lowest_bit(bits) + 32 * w
        best = torch.where((bits != 0) & in_range, torch.minimum(best, lb), best)
    best = best.amin(dim=-1)
    found = best < big
    bot_y = cfg.origin[1] + best.to(torch.float32) * cfg.voxel_size
    ok = found & (bot_y < top + max_rise)
    return torch.where(ok, bot_y, torch.full_like(bot_y, math.inf)), ok


def _capsule_column_geom(cfg: GridConfig, cx, cz, radius, span_xz):
    """Per-column footprint geometry for a vertical capsule of `radius` at
    (cx, cz): gathered coordinates (ix, iz [B,...,S]), horizontal squared
    distance d2 from the axis to each column's nearest point, and the
    in-range mask."""
    ix, iz, in_range = _footprint_index(
        cfg, cx - radius, cx + radius, cz - radius, cz + radius, span_xz)
    vs = cfg.voxel_size
    clx = cfg.origin[0] + ix.to(torch.float32) * vs
    clz = cfg.origin[2] + iz.to(torch.float32) * vs
    dx = torch.clamp(torch.maximum(clx - cx[..., None], cx[..., None] - (clx + vs)), min=0.0)
    dz = torch.clamp(torch.maximum(clz - cz[..., None], cz[..., None] - (clz + vs)), min=0.0)
    return ix, iz, dx * dx + dz * dz, in_range


def cols_capsule_floor_below(cfg: GridConfig, cols, cx, cz, bottom, max_drop,
                             span_xz, radius: float,
                             max_slope_cos: float = 0.70710678):
    """Capsule-exact landing support on packed columns -> (support_y, found).

    The capsule's bottom SPHERE rests on a column's highest solid cell at
    support_y = cell_top - (r - sqrt(r^2 - d^2)), d the horizontal distance
    from the capsule axis to the column's nearest point (the dip Bullet's
    capsule-vs-box contact produces at box edges). Columns beyond
    d = r*sin(slope) cannot support: the contact normal tilts past the
    controller's 45-degree slope filter (kcc.cpp:52-93). Columns under the
    axis (d = 0) reproduce the flat AABB answer (dip = 0).

    The y-scan extends `radius` above `bottom` because a dipped rest sits
    BELOW its supporting cell's top; the per-column effective-support filter
    (support_y <= bottom + eps) restores exactness."""
    r = float(np.float32(radius))
    ix, iz, d2, in_range = _capsule_column_geom(cfg, cx, cz, radius, span_xz)
    words = _gather_cols(cfg, cols, ix, iz)
    dip = r - torch.sqrt(torch.clamp(r * r - d2, min=0.0))
    d_max = float(np.float32(r) * np.sqrt(np.maximum(
        np.float32(1.0) - np.float32(max_slope_cos) * np.float32(max_slope_cos),
        np.float32(0.0))))
    can_support = in_range & (d2 <= d_max * d_max)

    iy_top = axis_index(cfg, 1, bottom + r + BOUNDARY_EPS) - 1
    iy_lo = axis_index(cfg, 1, bottom - max_drop) - 1
    ny = cfg.dims[1]
    iy0 = torch.clamp(iy_lo, 0, ny - 1)[..., None]
    iy1 = torch.clamp(iy_top, -1, ny - 1)[..., None]
    best = torch.full(words.shape[:-1], -1, dtype=torch.int32, device=words.device)
    for w in range(words.shape[-1]):
        m = _range_mask(iy0, iy1, w)
        bits = words[..., w] & m
        hb = _highest_bit(bits) + 32 * w
        best = torch.where((bits != 0) & can_support, torch.maximum(best, hb), best)
    top_col = cfg.origin[1] + (best.to(torch.float32) + 1.0) * cfg.voxel_size
    eff = top_col - dip
    bot = bottom[..., None]
    ok_col = (best >= 0) & (eff <= bot + BOUNDARY_EPS) & (eff >= bot - max_drop)
    eff = torch.where(ok_col, eff, torch.full_like(eff, -math.inf))
    support = eff.amax(dim=-1)
    found = torch.isfinite(support)
    return torch.where(found, support, torch.full_like(support, -math.inf)), found


def cols_capsule_ceiling_above(cfg: GridConfig, cols, cx, cz, top, max_rise,
                               span_xz, radius: float,
                               max_slope_cos: float = 0.70710678):
    """Capsule-exact ceiling blocking on packed columns -> (block_y, found):
    the mirror image of cols_capsule_floor_below for the TOP sphere (stepUp's
    ceiling-filtered sweep, kcc.cpp:241-249)."""
    r = float(np.float32(radius))
    ix, iz, d2, in_range = _capsule_column_geom(cfg, cx, cz, radius, span_xz)
    words = _gather_cols(cfg, cols, ix, iz)
    dip = r - torch.sqrt(torch.clamp(r * r - d2, min=0.0))
    d_max = float(np.float32(r) * np.sqrt(np.maximum(
        np.float32(1.0) - np.float32(max_slope_cos) * np.float32(max_slope_cos),
        np.float32(0.0))))
    can_block = in_range & (d2 <= d_max * d_max)

    iy_bot = axis_index(cfg, 1, top - r - BOUNDARY_EPS) + 1
    iy_hi = axis_index(cfg, 1, top + max_rise)
    ny = cfg.dims[1]
    iy0 = torch.clamp(iy_bot, 0, ny - 1)[..., None]
    iy1 = torch.clamp(iy_hi, -1, ny - 1)[..., None]
    big = 1 << 30
    best = torch.full(words.shape[:-1], big, dtype=torch.int32, device=words.device)
    for w in range(words.shape[-1]):
        m = _range_mask(iy0, iy1, w)
        bits = words[..., w] & m
        lb = _lowest_bit(bits) + 32 * w
        best = torch.where((bits != 0) & can_block, torch.minimum(best, lb), best)
    bot_col = cfg.origin[1] + best.to(torch.float32) * cfg.voxel_size
    eff = bot_col + dip
    topx = top[..., None]
    ok_col = (best < big) & (eff >= topx - BOUNDARY_EPS) & (eff < topx + max_rise)
    eff = torch.where(ok_col, eff, torch.full_like(eff, math.inf))
    block = eff.amin(dim=-1)
    found = torch.isfinite(block)
    return torch.where(found, block, torch.full_like(block, math.inf)), found
