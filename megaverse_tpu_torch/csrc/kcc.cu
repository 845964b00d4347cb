// Batched kinematic character controller: ops/physics.py's player_step and
// resolve_agent_collisions in one launch (ops/kcc.py).
//
// Replaces no TPU kernel: the reference runs the controller as plain JAX
// that XLA fuses (megaverse_tpu/ops/physics.py). In eager PyTorch the same
// code is some 1,440 elementwise kernels a tick (the 4 x 8 x 7 candidates of
// the sweep-and-slide, the column scans), each on a few KB, so the work was
// bound by launches. Here one thread runs one agent's tick straight through
// in registers; the agents of one env share a block, so the pairwise push of
// resolve_agent_collisions follows a barrier. What bounds it is latency: a
// few dependent reads of the packed columns (L2-resident) and a serial
// chain of float operations per agent; bytes are the agent rows and the
// column words of a 3 x 3 window.
//
// Exactness: every float32 operation of the plain code is kept, in its
// order (no FMA contraction: -fmad=false; no fast-math). Python scalars
// enter as the float32 values PyTorch casts them to (the host computes
// them, `Consts`), and `tensor / python_scalar`, which PyTorch on CUDA runs
// as a multiply by the scalar's reciprocal (taken in double, rounded to
// float32), is that multiply here (`inv_vs`, `inv_dt`, `inv_r`). torch.clamp / minimum / maximum keep their
// NaN rules. argmin / argmax keep the first extremum. The sum over agents of
// the pairwise push keeps the reduction's order (four accumulators, agent j
// into j % 4, then combined in order). Work whose result the plain code
// masks away is skipped: a sweep cell that is not solid, a slide iteration
// after the displacement went inactive, a wall that is inert, out of the
// agent's vertical range or farther than its half-extents plus one metre
// (its penetration and floor support are then exactly 0 / none).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define MAX_THREADS 256

// Field order and types mirror ops/kcc.py's `Consts` (checked through
// mv_kcc_consts_size).
struct Consts {
  // packed solid columns [B, X, NW, Z]; NY cells along y
  int X, NY, NW, Z;
  int span_x, span_z;       // capsule footprint span (grid.span_for)
  float origin_x, origin_y, origin_z;
  float vs;                 // voxel size
  float inv_vs;             // reciprocal of the voxel size
  // player_step
  float dt, inv_dt;
  float grav_dt;            // KCC_GRAVITY * dt
  float jump_speed, neg_fall_speed, fall_speed, step_height;
  float eps;                // KCC_EPSILON
  float fric_dt;            // KCC_NORMAL_DECELERATION * dt
  float half_y, clamp_margin, boundary_eps;
  float max_rise, max_drop;
  // sweep
  float r, r2_sweep, inv_r;
  float onorm_axis, onorm_diag;
  // capsule column scans (r of float32(radius))
  float r_cap, r2_cap, dmax2;
  // rotated walls
  float r2_obb, r2_obb_near;
  // agent collisions
  float two_r, v_lim;
  // small literals of the plain code
  float e24, e12, e9, e6, e5, e4;
};

struct Sweep {    // one sweep origin: the capsule's position and its 8 cells
  float px, pz;
  int ix, iz;
  unsigned solid; // bit k: cell k of kCells holds a SOLID cell in [bottom, top]
};

__constant__ int kCells[8][2] = {{-1, -1}, {-1, 0}, {-1, 1}, {0, -1},
                                 {0, 1},   {1, -1}, {1, 0},  {1, 1}};

// ----------------------------------------------------------- torch's rules
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}
__device__ __forceinline__ float clamp_max(float v, float hi) {
  return isnan(v) ? v : fminf(v, hi);
}
__device__ __forceinline__ float tmin(float a, float b) {   // torch.minimum
  return isnan(a) ? a : (isnan(b) ? b : fminf(a, b));
}
__device__ __forceinline__ float tmax(float a, float b) {   // torch.maximum
  return isnan(a) ? a : (isnan(b) ? b : fmaxf(a, b));
}

// ------------------------------------------------------------------ grid
__device__ __forceinline__ int axis_index(float w, float origin, const Consts& c) {
  return (int)floorf((w - origin) * c.inv_vs);
}

// unsigned word `w` of column (ix, iz); out of the grid: 0
__device__ __forceinline__ unsigned col_word(const int* __restrict__ cols, int b, int ix,
                                             int iz, int w, const Consts& c) {
  if (ix < 0 || ix >= c.X || iz < 0 || iz >= c.Z) return 0u;
  return (unsigned)__ldg(cols + (((long long)b * c.X + ix) * c.NW + w) * c.Z + iz);
}

__device__ __forceinline__ unsigned mask_below(int h) {   // bits [0, h), h in [0, 32]
  h = h < 0 ? 0 : (h > 32 ? 32 : h);
  return (unsigned)((1ull << h) - 1ull);
}

__device__ __forceinline__ unsigned range_mask(int y0, int y1, int w) {
  return mask_below(y1 + 1 - 32 * w) & ~mask_below(y0 - 32 * w);
}

// grid.cols_cell_solid over the 8 cells of a sweep origin
__device__ Sweep sweep_origin(const int* __restrict__ cols, int b, float px, float py,
                              float pz, const Consts& c) {
  Sweep s;
  s.px = px;
  s.pz = pz;
  s.ix = axis_index(px, c.origin_x, c);
  s.iz = axis_index(pz, c.origin_z, c);
  const float bottom = py - c.half_y;
  const float top = py + c.half_y;
  int iy0 = axis_index(bottom + c.boundary_eps, c.origin_y, c);
  int iy1 = axis_index(top - c.boundary_eps, c.origin_y, c);
  iy0 = iy0 < 0 ? 0 : iy0;
  iy1 = iy1 > c.NY - 1 ? c.NY - 1 : iy1;
  s.solid = 0u;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int cx = s.ix + kCells[k][0], cz = s.iz + kCells[k][1];
    bool hit = false;
    for (int w = 0; w < c.NW; ++w)
      hit |= (col_word(cols, b, cx, cz, w, c) & range_mask(iy0, iy1, w)) != 0u;
    s.solid |= (unsigned)hit << k;
  }
  return s;
}

// grid._capsule_column_geom for footprint column (i, j): index and d2
__device__ __forceinline__ float column_d2(float cx, float cz, int ix, int iz, const Consts& c) {
  const float clx = (float)ix * c.vs + c.origin_x;
  const float clz = (float)iz * c.vs + c.origin_z;
  const float dx = clamp_min(tmax(clx - cx, cx - (clx + c.vs)), 0.0f);
  const float dz = clamp_min(tmax(clz - cz, cz - (clz + c.vs)), 0.0f);
  return dx * dx + dz * dz;
}

struct Footprint {
  int ix0, ix1, iz0, iz1;
};

__device__ __forceinline__ Footprint footprint(float cx, float cz, const Consts& c) {
  Footprint f;
  f.ix0 = axis_index((cx - c.r) + c.boundary_eps, c.origin_x, c);
  f.ix1 = axis_index((cx + c.r) - c.boundary_eps, c.origin_x, c);
  f.iz0 = axis_index((cz - c.r) + c.boundary_eps, c.origin_z, c);
  f.iz1 = axis_index((cz + c.r) - c.boundary_eps, c.origin_z, c);
  return f;
}

// grid.cols_capsule_ceiling_above -> block_y (inf where none)
__device__ float capsule_ceiling(const int* __restrict__ cols, int b, float cx, float cz,
                                 float top, const Consts& c) {
  const Footprint f = footprint(cx, cz, c);
  int iy0 = axis_index((top - c.r_cap) - c.boundary_eps, c.origin_y, c) + 1;
  int iy1 = axis_index(top + c.max_rise, c.origin_y, c);
  iy0 = iy0 < 0 ? 0 : (iy0 > c.NY - 1 ? c.NY - 1 : iy0);
  iy1 = iy1 < -1 ? -1 : (iy1 > c.NY - 1 ? c.NY - 1 : iy1);
  float block = INFINITY;
  for (int i = 0; i < c.span_x; ++i) {
    for (int j = 0; j < c.span_z; ++j) {
      const int ix = f.ix0 + i, iz = f.iz0 + j;
      if (ix > f.ix1 || iz > f.iz1) continue;               // in_range
      const float d2 = column_d2(cx, cz, ix, iz, c);
      if (!(d2 <= c.dmax2)) continue;                       // can_block
      int best = -1;
      for (int w = 0; w < c.NW && best < 0; ++w) {
        const unsigned bits = col_word(cols, b, ix, iz, w, c) & range_mask(iy0, iy1, w);
        if (bits) best = __ffs(bits) - 1 + 32 * w;
      }
      if (best < 0) continue;
      const float dip = c.r_cap - sqrtf(clamp_min(c.r2_cap - d2, 0.0f));
      const float eff = ((float)best * c.vs + c.origin_y) + dip;
      if (eff >= top - c.boundary_eps && eff < top + c.max_rise) block = fminf(block, eff);
    }
  }
  return block;
}

// grid.cols_capsule_floor_below -> support_y (-inf where none)
__device__ float capsule_floor(const int* __restrict__ cols, int b, float cx, float cz,
                              float bottom, const Consts& c) {
  const Footprint f = footprint(cx, cz, c);
  int iy1 = axis_index((bottom + c.r_cap) + c.boundary_eps, c.origin_y, c) - 1;
  int iy0 = axis_index(bottom - c.max_drop, c.origin_y, c) - 1;
  iy0 = iy0 < 0 ? 0 : (iy0 > c.NY - 1 ? c.NY - 1 : iy0);
  iy1 = iy1 < -1 ? -1 : (iy1 > c.NY - 1 ? c.NY - 1 : iy1);
  float support = -INFINITY;
  for (int i = 0; i < c.span_x; ++i) {
    for (int j = 0; j < c.span_z; ++j) {
      const int ix = f.ix0 + i, iz = f.iz0 + j;
      if (ix > f.ix1 || iz > f.iz1) continue;
      const float d2 = column_d2(cx, cz, ix, iz, c);
      if (!(d2 <= c.dmax2)) continue;                       // can_support
      int best = -1;
      for (int w = c.NW - 1; w >= 0 && best < 0; --w) {
        const unsigned bits = col_word(cols, b, ix, iz, w, c) & range_mask(iy0, iy1, w);
        if (bits) best = 31 - __clz(bits) + 32 * w;
      }
      if (best < 0) continue;
      const float dip = c.r_cap - sqrtf(clamp_min(c.r2_cap - d2, 0.0f));
      const float eff = (((float)best + 1.0f) * c.vs + c.origin_y) - dip;
      if (eff <= bottom + c.boundary_eps && eff >= bottom - c.max_drop)
        support = fmaxf(support, eff);
    }
  }
  return support;
}

// -------------------------------------------------------- sweep and slide
// physics._sweep_horizontal: earliest valid candidate, cells in kCells
// order, candidates touch, x face, z face, corners (x0,z0) (x0,z1) (x1,z0)
// (x1,z1); the first strict minimum, as argmin keeps it.
__device__ bool sweep(const Sweep& s, float dx, float dz, const Consts& c, float& t_out,
                      float& nx_out, float& nz_out) {
  const float px = s.px, pz = s.pz;
  const float dx_safe = fabsf(dx) < c.e12 ? c.e12 : dx;
  const float dz_safe = fabsf(dz) < c.e12 ? c.e12 : dz;
  const float a = dx * dx + dz * dz;
  const float a_safe = clamp_min(a, c.e12);
  float t_best = INFINITY, nx_best = 0.0f, nz_best = 0.0f;
  for (int k = 0; k < 8; ++k) {
    if (!((s.solid >> k) & 1u)) continue;
    const int ox = kCells[k][0], oz = kCells[k][1];
    const float cx0 = (float)(s.ix + ox) * c.vs + c.origin_x;
    const float cx1 = cx0 + c.vs;
    const float cz0 = (float)(s.iz + oz) * c.vs + c.origin_z;
    const float cz1 = cz0 + c.vs;
    // touch: the circle already overlaps the expanded cell
    {
      const float ex = px - tmin(tmax(px, cx0), cx1);
      const float ez = pz - tmin(tmax(pz, cz0), cz1);
      const float d2 = ex * ex + ez * ez;
      const float dlen = sqrtf(clamp_min(d2, c.e24));
      const bool degen = d2 < c.e12;
      const float onorm = (ox != 0 && oz != 0) ? c.onorm_diag : c.onorm_axis;
      const float tnx = degen ? -(float)ox * onorm : ex / dlen;
      const float tnz = degen ? -(float)oz * onorm : ez / dlen;
      if (d2 <= c.r2_sweep && tnx * dx + tnz * dz <= 0.0f && 0.0f < t_best) {
        t_best = 0.0f;
        nx_best = tnx;
        nz_best = tnz;
      }
    }
    {  // x face
      const float face = dx > 0.0f ? cx0 - c.r : cx1 + c.r;
      const float t = (face - px) / dx_safe;
      const float z_at = pz + t * dz;
      if (fabsf(dx) > c.e9 && t >= 0.0f && t <= 1.0f && z_at >= cz0 && z_at <= cz1 &&
          t < t_best) {
        t_best = t;
        nx_best = dx > 0.0f ? -1.0f : 1.0f;
        nz_best = 0.0f;
      }
    }
    {  // z face
      const float face = dz > 0.0f ? cz0 - c.r : cz1 + c.r;
      const float t = (face - pz) / dz_safe;
      const float x_at = px + t * dx;
      if (fabsf(dz) > c.e9 && t >= 0.0f && t <= 1.0f && x_at >= cx0 && x_at <= cx1 &&
          t < t_best) {
        t_best = t;
        nx_best = 0.0f;
        nz_best = dz > 0.0f ? -1.0f : 1.0f;
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {  // corner arcs
      const bool x_lo = q < 2, z_lo = (q & 1) == 0;
      const float ccx = x_lo ? cx0 : cx1;
      const float ccz = z_lo ? cz0 : cz1;
      const float rx = px - ccx;
      const float rz = pz - ccz;
      const float bq = 2.0f * (rx * dx + rz * dz);
      const float c0 = (rx * rx + rz * rz) - c.r2_sweep;
      const float disc = bq * bq - (4.0f * a_safe) * c0;
      const float t = (-bq - sqrtf(clamp_min(disc, 0.0f))) / (2.0f * a_safe);
      const float xo = px + t * dx;
      const float zo = pz + t * dz;
      const bool out_x = x_lo ? xo <= cx0 : xo >= cx1;
      const bool out_z = z_lo ? zo <= cz0 : zo >= cz1;
      if (a > c.e12 && disc >= 0.0f && bq < 0.0f && t >= 0.0f && t <= 1.0f && out_x &&
          out_z && t < t_best) {
        t_best = t;
        nx_best = (rx + t * dx) * c.inv_r;
        nz_best = (rz + t * dz) * c.inv_r;
      }
    }
  }
  const bool hit = isfinite(t_best);
  t_out = hit ? t_best : 1.0f;
  nx_out = hit ? nx_best : 0.0f;
  nz_out = hit ? nz_best : 0.0f;
  return hit;
}

// physics._slide_horizontal from (px, py, pz) by (dx, dz): the new x, z
__device__ void slide(const int* __restrict__ cols, int b, float px, float py, float pz,
                      float dx, float dz, const Consts& c, float& x_out, float& z_out) {
  const Sweep s = sweep_origin(cols, b, px, py, pz, c);
  const float odx = dx, odz = dz;
  bool active = (fabsf(dx) + fabsf(dz)) > 0.0f;
  for (int it = 0; it < 4 && active; ++it) {
    float t, nx, nz;
    const bool hit = sweep(s, dx, dz, c, t, nx, nz);
    const float ndot = nx * dx + nz * dz;
    const float par_new = clamp_max(ndot * t + c.clamp_margin, 0.0f);
    const float ndx = hit ? dx - nx * (ndot - par_new) : dx;
    const float ndz = hit ? dz - nz * (ndot - par_new) : dz;
    const float l2 = ndx * ndx + ndz * ndz;
    const bool cancel = hit && (l2 <= c.e4 || ndx * odx + ndz * odz <= 0.0f);
    dx = cancel ? 0.0f : ndx;
    dz = cancel ? 0.0f : ndz;
    active = hit && !cancel;
  }
  x_out = px + dx;
  z_out = pz + dz;
}

// ----------------------------------------------------------- rotated walls
// obbs rows: cx, cy, cz, hx, hy, hz, yaw
__device__ __forceinline__ void obb_local(float px, float pz, const float* w, float& u,
                                          float& v) {
  const float cy = cosf(w[6]), sy = sinf(w[6]);
  const float ox = px - w[0], oz = pz - w[2];
  u = cy * ox - sy * oz;
  v = sy * ox + cy * oz;
}

// a wall whose penetration and floor support are exactly none at (px, py, pz):
// inert, out of the capsule's vertical range, or beyond its half-extents plus
// a metre horizontally (then the rectangle lies more than r away)
__device__ __forceinline__ bool wall_far(float px, float pz, const float* w) {
  const float ox = px - w[0], oz = pz - w[2];
  const float reach = fabsf(w[3]) + fabsf(w[5]) + 1.0f;
  return ox * ox + oz * oz > reach * reach;
}

struct WallTerms {
  float v, du, dv, dist, side;
  bool inside;
};

// the wall-frame terms of _obb_push_xz for one wall at (px, pz), (qx, qz)
// the position before the move (side_prev)
__device__ __forceinline__ WallTerms wall_terms(float px, float pz, float qx, float qz,
                                                const float* w) {
  WallTerms t;
  float u, u_prev, v_prev;
  obb_local(px, pz, w, u, t.v);
  obb_local(qx, qz, w, u_prev, v_prev);
  t.side = v_prev >= 0.0f ? 1.0f : -1.0f;
  const float hx = w[3], hv = w[5];
  t.du = u - tmin(tmax(u, -hx), hx);
  t.dv = t.v - tmin(tmax(t.v, -hv), hv);
  t.dist = sqrtf(t.du * t.du + t.dv * t.dv);
  t.inside = fabsf(u) <= hx && fabsf(t.v) <= hv;
  return t;
}

// physics._obb_push_xz: `iters` pushes out of the deepest wall (the first of
// equal depths); (qx, qz) the position before the move
__device__ void obb_push(const float* __restrict__ walls, int W, float& px, float& py,
                         float& pz, float qx, float qz, const Consts& c) {
  for (int it = 0; it < 3; ++it) {
    const float bottom = py - c.half_y;
    const float top = py + c.half_y;
    float p = 0.0f;
    int best = -1;
    for (int i = 0; i < W; ++i) {
      const float* w = walls + 7 * i;
      const float wy = w[1], hy = w[4];
      if (!(bottom < wy + hy && top > wy - hy && hy > 0.0f)) continue;   // pen 0
      if (wall_far(px, pz, w)) continue;                                // pen 0
      const WallTerms t = wall_terms(px, pz, qx, qz, w);
      const float pen = t.inside ? (w[5] + c.r) - t.side * t.v : clamp_min(c.r - t.dist, 0.0f);
      if (pen > p) {
        p = pen;
        best = i;
      }
    }
    if (!(p > c.e6)) continue;      // live; pos unchanged
    const float* w = walls + 7 * best;
    const WallTerms t = wall_terms(px, pz, qx, qz, w);
    const float d_safe = clamp_min(t.dist, c.e9);
    float nu = t.inside ? 0.0f : t.du / d_safe;
    float nv = t.inside ? t.side : t.dv / d_safe;
    if (!t.inside && t.dist < c.e9) {
      nu = 0.0f;
      nv = t.side;
    }
    const float cyw = cosf(w[6]), syw = sinf(w[6]);
    const float push_x = cyw * nu + syw * nv;
    const float push_z = -syw * nu + cyw * nv;
    px = px + push_x * p;
    py = py + 0.0f * p;
    pz = pz + push_z * p;
  }
}

// physics.obb_floor_support -> the highest wall-top support (-inf where none)
__device__ float obb_floor(const float* __restrict__ walls, int W, float px, float pz,
                           const Consts& c) {
  float best = -INFINITY;
  for (int i = 0; i < W; ++i) {
    const float* w = walls + 7 * i;
    if (!(w[4] > 0.0f) || wall_far(px, pz, w)) continue;      // near is false
    float u, v;
    obb_local(px, pz, w, u, v);
    const float hx = w[3], hz = w[5];
    const float du = u - tmin(tmax(u, -hx), hx);
    const float dv = v - tmin(tmax(v, -hz), hz);
    const float d2 = du * du + dv * dv;
    if (!(d2 <= c.r2_obb_near)) continue;
    const float dip = c.r - sqrtf(clamp_min(c.r2_obb - d2, 0.0f));
    best = fmaxf(best, (w[1] + w[4]) - dip);
  }
  return best;
}

// ------------------------------------------------------------------ kernel
__global__ void __launch_bounds__(MAX_THREADS)
kcc_kernel(const Consts c, int num_agents, int count, const float* __restrict__ pos_in,
           const float* __restrict__ vvel_in, const float* __restrict__ hvel_in,
           const bool* __restrict__ jumping_in, const bool* __restrict__ on_ground_in,
           const int* __restrict__ cols, const float* __restrict__ obbs, int W,
           float* __restrict__ pos_out, float* __restrict__ vvel_out,
           float* __restrict__ hvel_out, bool* __restrict__ jumping_out,
           bool* __restrict__ on_ground_out) {
  extern __shared__ float shared_pos[];   // [blockDim.x][3] where num_agents > 1
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = g < count;
  const int b = live ? g / num_agents : 0;
  const float* walls = W > 0 ? obbs + (long long)b * W * 7 : nullptr;
  float x = 0.0f, y = 0.0f, z = 0.0f;
  if (live) {
    // ---------------- player_step
    const float x0 = pos_in[3 * g], y0 = pos_in[3 * g + 1], z0 = pos_in[3 * g + 2];
    const bool was_on_ground = on_ground_in[g];
    const bool jumping0 = jumping_in[g];
    // gravity and velocity clamps
    float vvel = vvel_in[g] - c.grav_dt;
    vvel = clamp_max(vvel, c.jump_speed);
    vvel = clamp_min(vvel, c.neg_fall_speed);
    float voffset = vvel * c.dt;
    x = x0;
    y = y0;
    z = z0;
    const float top = y + c.half_y;
    // stepUp
    const float step_h = vvel < 0.0f ? c.step_height : 0.0f;
    const float up_dist = step_h + clamp_min(voffset, 0.0f);
    const float ceil_y = capsule_ceiling(cols, b, x, z, top, c);
    const float free_rise = isfinite(ceil_y)
        ? clamp_min((ceil_y - top) - c.clamp_margin, 0.0f) : INFINITY;
    const bool blocked_up = free_rise < up_dist;
    const float rise = tmin(up_dist, free_rise);
    y = y + rise;
    const float frac = rise / clamp_min(up_dist, c.e9);
    const float step_offset = blocked_up
        ? (voffset > 0.0f ? c.step_height : step_h * frac) : step_h;
    if (blocked_up && voffset > 0.0f) {
      vvel = 0.0f;
      voffset = 0.0f;
    }
    // stepForwardAndStrafe
    const float sx = x, sz = z;
    slide(cols, b, x, y, z, hvel_in[3 * g] * c.dt, hvel_in[3 * g + 2] * c.dt, c, x, z);
    if (W > 0) obb_push(walls, W, x, y, z, sx, sz, c);
    // stepDown
    float down_vel = vvel < 0.0f ? -vvel : 0.0f;
    if (down_vel > 0.0f && down_vel > c.fall_speed && (was_on_ground || !jumping0))
      down_vel = c.fall_speed;
    const float drop = step_offset + down_vel * c.dt;
    const float bottom = y - c.half_y;
    float floor_y = capsule_floor(cols, b, x, z, bottom, c);
    bool floor_found = isfinite(floor_y);
    if (W > 0) {
      const float otop = obb_floor(walls, W, x, z, c);
      const bool ok = isfinite(otop) && otop <= bottom + c.clamp_margin;
      if (ok && (!floor_found || otop > floor_y)) floor_y = otop;
      floor_found = floor_found || ok;
    }
    const bool land = floor_found && floor_y >= bottom - drop;
    const float new_bottom = land ? floor_y : bottom - drop;
    y = new_bottom + c.half_y;
    if (land) {
      vvel = 0.0f;
      voffset = 0.0f;
    }
    // momentum arrest, onGround, friction
    float hx = (x - x0) * c.inv_dt;
    float hz = (z - z0) * c.inv_dt;
    const bool on_ground = fabsf(vvel) < c.eps && fabsf(voffset) < c.eps;
    if (on_ground) {
      const float speed = sqrtf(hx * hx + hz * hz);
      const float fric = clamp_min(speed - c.fric_dt, 0.0f) / clamp_min(speed, c.e9);
      hx = hx * fric;
      hz = hz * fric;
    }
    vvel_out[g] = vvel;
    hvel_out[3 * g] = hx;
    hvel_out[3 * g + 1] = 0.0f;
    hvel_out[3 * g + 2] = hz;
    jumping_out[g] = jumping0 && !land;
    on_ground_out[g] = on_ground;
  }
  if (num_agents > 1) {
    // ---------------- resolve_agent_collisions
    const int t = threadIdx.x;
    shared_pos[3 * t] = x;
    shared_pos[3 * t + 1] = y;
    shared_pos[3 * t + 2] = z;
    __syncthreads();
    if (live) {
      const int first = t - g % num_agents;     // the env's first agent in the block
      const int self = g % num_agents;
      float acc_x[4] = {0.0f, 0.0f, 0.0f, 0.0f}, acc_z[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      for (int j = 0; j < num_agents; ++j) {
        const float* o = shared_pos + 3 * (first + j);
        const float ddx = x - o[0], ddy = y - o[1], ddz = z - o[2];
        const float d_xz = sqrtf((ddx * ddx + ddz * ddz) + c.e12);
        const bool overlap = j != self && fabsf(ddy) < c.v_lim && d_xz < c.two_r;
        const float push_mag = overlap ? (c.two_r - d_xz) * 0.5f : 0.0f;
        float dir_x = ddx / d_xz, dir_z = ddz / d_xz;
        if (overlap && d_xz < c.e5) {
          dir_x = 1.0f;
          dir_z = 0.0f;
        }
        acc_x[j & 3] = acc_x[j & 3] + push_mag * dir_x;
        acc_z[j & 3] = acc_z[j & 3] + push_mag * dir_z;
      }
      const float push_x = ((acc_x[0] + acc_x[1]) + acc_x[2]) + acc_x[3];
      const float push_z = ((acc_z[0] + acc_z[1]) + acc_z[2]) + acc_z[3];
      float nx, nz;
      slide(cols, b, x, y, z, push_x, push_z, c, nx, nz);
      float ny = y;
      if (W > 0) obb_push(walls, W, nx, ny, nz, x, z, c);
      x = nx;
      y = ny;
      z = nz;
    }
  }
  if (live) {
    pos_out[3 * g] = x;
    pos_out[3 * g + 1] = y;
    pos_out[3 * g + 2] = z;
  }
}

extern "C" {

int mv_kcc_consts_size() { return (int)sizeof(Consts); }

int mv_kcc_max_threads() { return MAX_THREADS; }

// One tick of `batch` envs x `num_agents` agents: device pointers of the
// agent rows (pos [B, A, 3], vvel [B, A], hvel [B, A, 3], jumping and
// on_ground bool [B, A]), the packed columns (int32 [B, X, NW, Z]) and the
// walls (float [B, W, 7], null where W is 0); outputs of the same shapes.
// `threads`: the block, a multiple of num_agents. Returns cudaGetLastError()
// after the launch (-1: bad arguments); the launch runs on `stream`.
int mv_kcc_step(const Consts* consts, int batch, int num_agents, int threads,
                const float* pos, const float* vvel, const float* hvel, const bool* jumping,
                const bool* on_ground, const int* cols, const float* obbs, int W,
                float* pos_out, float* vvel_out, float* hvel_out, bool* jumping_out,
                bool* on_ground_out, cudaStream_t stream) {
  if (batch < 0 || num_agents < 1 || threads < num_agents || threads > MAX_THREADS ||
      threads % num_agents != 0 || W < 0 || (W > 0 && obbs == nullptr))
    return -1;
  const int count = batch * num_agents;
  if (count == 0) return (int)cudaGetLastError();
  const int blocks = (count + threads - 1) / threads;
  const size_t smem = num_agents > 1 ? (size_t)threads * 3 * sizeof(float) : 0;
  kcc_kernel<<<blocks, threads, smem, stream>>>(*consts, num_agents, count, pos, vvel, hvel,
                                                jumping, on_ground, cols, obbs, W, pos_out,
                                                vvel_out, hvel_out, jumping_out,
                                                on_ground_out);
  return (int)cudaGetLastError();
}

}  // extern "C"
