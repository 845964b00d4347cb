// Analytic raycast renderer for NVIDIA Hopper (sm_90a): forms B1 to B6.
//
// Replaces the Pallas TPU kernel `_render_kernel` of
// megaverse_tpu/ops/raycast_pallas.py (launched from its `render_packed`).
// Its six forms are one kernel template here, `render_kernel<FORM, MERGED>`:
//   B1  unculled, in table order (loop over all M rows, generic row test,
//       strict `t < best` carry, best starts at +INF);
//   B2  bit-walk: per 8x128 pixel tile, walk the tile's front-to-back
//       supercluster list, test member bits, skip members and stop the walk on
//       the depth bound, run 8-row clusters through the body chosen by the
//       cluster tag, tie-break carry on the row index, depth bound refreshed
//       lazily by a block reduction;
//   B3  clustered, in table order: every cluster's box is slab-tested per
//       pixel against the current depths, a block-wide vote decides whether
//       its rows run;
//   B4  B3 through a sorted list (per agent or per tile), optionally ending
//       early on the list's distance bounds;
//   B5  two-level: per-tile lists over superclusters, members re-tested;
//   B6  any of B1-B5 with ONE block per (env, agent) frame that loops the
//       frame's tiles (MERGED = true) instead of one block per sub-block.
// All write packed RGB int32 [B, A, H, 128].
//
// What bounds it on this card: arithmetic, not memory. A frame reads a few KB
// of tables per env and writes 4 bytes per pixel, while every visited table
// row costs some 30-150 f32 operations per pixel. The design therefore spends
// nothing on data movement tricks: one thread owns one pixel, its ray and its
// closest-hit carry live in registers, and every table value is a
// block-uniform load that the read-only cache broadcasts. What it does about
// the arithmetic is the culling of B2-B5: the tables cut the rows a tile
// visits from M to the handful in front of the nearest occluder.
//
// Block shape: 256 threads = 2 pixel rows x 128 columns; four sub-blocks share
// one 8-row tile (and its cull lists). The reference decides per 8-row tile
// whether any ray can reach a cluster; here the vote (__syncthreads_or) and
// the depth bound (block_max) are per 2-row sub-block, a subset of that tile:
// fewer rows run, the image is the same (a skipped row can never win). All
// loop conditions depend only on table values, on that vote and on that
// maximum, which every thread receives, so no thread leaves a loop alone.
//
// Exactness: every form must produce the image of B1 bit for bit, which rests
// on every row body computing a bit-equal `t` for the same row. The bodies
// share the intersection routines below, and the file MUST be compiled with
// -fmad=false (nvcc would otherwise contract a*b-c into FMA differently per
// inlined call site) and WITHOUT --use_fast_math. Only rsqrtf, sinf, cosf,
// sqrtf and IEEE division are used; never __sinf/__cosf/__fdividef.

#include <cuda_runtime.h>

namespace {

constexpr float INF_T = 1e30f;
constexpr float NEAR_T = 0.01f;
constexpr float FAR_T = 120.0f;
constexpr float SLACK = 0.01f;
constexpr int TILE_H = 8;
constexpr int TILE_W = 128;
constexpr int SUB_ROWS = 2;                  // pixel rows per block
constexpr int SUBS = TILE_H / SUB_ROWS;      // blocks per tile
constexpr int NTHREADS = SUB_ROWS * TILE_W;
constexpr int NWARPS = NTHREADS / 32;
constexpr int ROW_W = 12;                    // f32 per primitive row
constexpr int CLUSTER_K = 8;
constexpr int SUPER_K = 4;
constexpr int CODE_DIRECT = 3;

// Indices into the constant table built by ops/raycast.py render_constants().
enum {
  K_TAN_H = 0, K_TAN_V, K_BAR_DEN, K_BAR_V, K_BAR_HALF_V, K_IND_HALF_U,
  K_IND_CU, K_IND_DEN, K_BAR_RGB, K_GREEN_RGB = K_BAR_RGB + 3,
  K_RED_RGB = K_GREEN_RGB + 3, K_COUNT = K_RED_RGB + 3
};

struct Ray {
  float ex, ey, ez;
  float dx, dy, dz;
  float ix, iy, iz;
  float exix, eyiy, eziz;
};

// One row's hit: distance, world normal, packed colour (float holding
// (r8<<16)|(g8<<8)|b8).
struct Hit {
  float t, nx, ny, nz, c;
};

// Closest-hit carry. `code` is the deferred AABB face-axis code (0/1/2);
// CODE_DIRECT means the normal lives in nx/ny/nz.
struct Carry {
  float t;
  int idx;
  float nx, ny, nz;
  int code;
  float c;
};

__device__ __forceinline__ float sgnf(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
}

__device__ __forceinline__ float recip_safe(float d) {
  return 1.0f / (fabsf(d) < 1e-12f ? 1e-12f : d);
}

// Slab test on hoisted origin*reciprocal products. Returns t (INF_T on a miss)
// and the entry-face axis code.
__device__ __forceinline__ float slab(float lox, float loy, float loz,
                                      float hix, float hiy, float hiz,
                                      float oxix, float oyiy, float oziz,
                                      float rix, float riy, float riz,
                                      int& code) {
  float t1x = lox * rix - oxix;
  float t2x = hix * rix - oxix;
  float t1y = loy * riy - oyiy;
  float t2y = hiy * riy - oyiy;
  float t1z = loz * riz - oziz;
  float t2z = hiz * riz - oziz;
  float tminx = fminf(t1x, t2x);
  float tminy = fminf(t1y, t2y);
  float tminz = fminf(t1z, t2z);
  float tmin = fmaxf(tminx, fmaxf(tminy, tminz));
  float tmax = fminf(fmaxf(t1x, t2x), fminf(fmaxf(t1y, t2y), fmaxf(t1z, t2z)));
  bool hit = (tmax >= tmin) && (tmin > NEAR_T);
  code = (tmin == tminx) ? 0 : ((tmin == tminy) ? 1 : 2);
  return hit ? tmin : INF_T;
}

// Normal of a slab hit: -sign(d) on the coded axis.
__device__ __forceinline__ void slab_normal(int code, float rdx, float rdy,
                                            float rdz, float& nx, float& ny,
                                            float& nz) {
  nx = (code == 0) ? -sgnf(rdx) : 0.0f;
  ny = (code == 1) ? -sgnf(rdy) : 0.0f;
  nz = (code == 2) ? -sgnf(rdz) : 0.0f;
}

__device__ __forceinline__ float prim_aabb(const Ray& r, float a0, float a1,
                                           float a2, float b0, float b1,
                                           float b2, int& code) {
  return slab(a0, a1, a2, b0, b1, b2, r.exix, r.eyiy, r.eziz, r.ix, r.iy, r.iz,
              code);
}

__device__ __forceinline__ void prim_ellipsoid(const Ray& r, float cx0,
                                               float cy0, float cz0, float rx,
                                               float ry, float rz, Hit& h) {
  float irx = 1.0f / rx, iry = 1.0f / ry, irz = 1.0f / rz;
  float qx = (r.ex - cx0) * irx;
  float qy = (r.ey - cy0) * iry;
  float qz = (r.ez - cz0) * irz;
  float ddx = r.dx * irx;
  float ddy = r.dy * iry;
  float ddz = r.dz * irz;
  float a = ddx * ddx + ddy * ddy + ddz * ddz;
  float b = qx * ddx + qy * ddy + qz * ddz;
  float c0 = qx * qx + qy * qy + qz * qz - 1.0f;
  float disc = b * b - a * c0;
  float sq = sqrtf(fmaxf(disc, 0.0f));
  float t = (-b - sq) / fmaxf(a, 1e-12f);
  bool hit = (disc > 0.0f) && (t > NEAR_T);
  t = hit ? t : INF_T;
  float nx = (r.ex + t * r.dx - cx0) * irx * irx;
  float ny = (r.ey + t * r.dy - cy0) * iry * iry;
  float nz = (r.ez + t * r.dz - cz0) * irz * irz;
  float inv = rsqrtf(nx * nx + ny * ny + nz * nz + 1e-18f);
  h.t = t;
  h.nx = nx * inv;
  h.ny = ny * inv;
  h.nz = nz * inv;
}

__device__ __forceinline__ void prim_cylinder(const Ray& r, float cx0,
                                              float cy0, float cz0, float rx,
                                              float rz, float half_h, Hit& h) {
  float qx = (r.ex - cx0) / rx;
  float qz = (r.ez - cz0) / rz;
  float ddx = r.dx / rx;
  float ddz = r.dz / rz;
  float a = ddx * ddx + ddz * ddz;
  float b = qx * ddx + qz * ddz;
  float c0 = qx * qx + qz * qz - 1.0f;
  float disc = b * b - a * c0;
  float sq = sqrtf(fmaxf(disc, 0.0f));
  float t_side = (-b - sq) / fmaxf(a, 1e-12f);
  float y_side = r.ey + t_side * r.dy - cy0;
  bool side_ok = (disc > 0.0f) && (t_side > NEAR_T) && (fabsf(y_side) <= half_h);
  t_side = side_ok ? t_side : INF_T;

  float sign = -sgnf(r.dy);
  float cap_y = cy0 + sign * half_h;
  float t_cap = (cap_y - r.ey) * r.iy;
  float px = (r.ex + t_cap * r.dx - cx0) / rx;
  float pz = (r.ez + t_cap * r.dz - cz0) / rz;
  bool cap_ok = (t_cap > NEAR_T) && (px * px + pz * pz <= 1.0f);
  t_cap = cap_ok ? t_cap : INF_T;

  bool use_cap = t_cap < t_side;
  float t = fminf(t_side, t_cap);
  float snx = (r.ex + t * r.dx - cx0) / (rx * rx);
  float snz = (r.ez + t * r.dz - cz0) / (rz * rz);
  float inv = rsqrtf(snx * snx + snz * snz + 1e-18f);
  h.t = t;
  h.nx = use_cap ? 0.0f : snx * inv;
  h.ny = use_cap ? sign : 0.0f;
  h.nz = use_cap ? 0.0f : snz * inv;
}

// s = +1: apex up; s = -1: flipped (diamond bottom halves).
__device__ __forceinline__ void prim_cone(const Ray& r, float cx0, float cy0,
                                          float cz0, float rx, float rz,
                                          float half_h, float s, Hit& h) {
  float apex_y = cy0 + s * half_h;
  float qx = (r.ex - cx0) / rx;
  float qz = (r.ez - cz0) / rz;
  float qy = (r.ey - apex_y) * s;
  float ddx = r.dx / rx;
  float ddz = r.dz / rz;
  float ddy = r.dy * s;
  float k = 1.0f / (2.0f * half_h);
  float kd = k * ddy;
  float a = ddx * ddx + ddz * ddz - kd * kd;
  float b = qx * ddx + qz * ddz - k * k * qy * ddy;
  float kq = k * qy;
  float c0 = qx * qx + qz * qz - kq * kq;
  float disc = b * b - a * c0;
  float sq = sqrtf(fmaxf(disc, 0.0f));
  float asafe = (fabsf(a) < 1e-12f) ? 1e-12f : a;
  float t1 = (-b - sq) / asafe;
  float t2 = (-b + sq) / asafe;
  float y1 = qy + t1 * ddy;
  float y2 = qy + t2 * ddy;
  float two_h = 2.0f * half_h;
  bool ok1 = (disc > 0.0f) && (t1 > NEAR_T) && (y1 <= 0.0f) && (y1 >= -two_h);
  bool ok2 = (disc > 0.0f) && (t2 > NEAR_T) && (y2 <= 0.0f) && (y2 >= -two_h);
  float t_side = ok1 ? t1 : (ok2 ? t2 : INF_T);

  float base_y = apex_y - s * 2.0f * half_h;
  float t_cap = (base_y - r.ey) * r.iy;
  float px = (r.ex + t_cap * r.dx - cx0) / rx;
  float pz = (r.ez + t_cap * r.dz - cz0) / rz;
  bool cap_ok = (t_cap > NEAR_T) && (px * px + pz * pz <= 1.0f);
  t_cap = cap_ok ? t_cap : INF_T;

  bool use_cap = t_cap < t_side;
  float t = fminf(t_side, t_cap);
  float relx = r.ex + t * r.dx - cx0;
  float rely = r.ey + t * r.dy - apex_y;
  float relz = r.ez + t * r.dz - cz0;
  float snx = relx / (rx * rx);
  float sny = -(k * k) * rely;
  float snz = relz / (rz * rz);
  float inv = rsqrtf(snx * snx + sny * sny + snz * snz + 1e-18f);
  h.t = t;
  h.nx = use_cap ? 0.0f : snx * inv;
  h.ny = use_cap ? -s : sny * inv;
  h.nz = use_cap ? 0.0f : snz * inv;
}

// Yaw/pitch-rotated eye box of another agent.
__device__ __forceinline__ void prim_eyebox(const Ray& r, float cx0, float cy0,
                                            float cz0, float byaw, float bpitch,
                                            Hit& h) {
  float cyj = cosf(byaw), syj = sinf(byaw);
  float cpj = cosf(bpitch), spj = sinf(bpitch);
  float ox = r.ex - cx0, oy = r.ey - cy0, oz = r.ez - cz0;
  float lx = cyj * ox - syj * oz;
  float lz1 = syj * ox + cyj * oz;
  float ly = cpj * oy + spj * lz1;
  float lz = -spj * oy + cpj * lz1;
  float dlx = cyj * r.dx - syj * r.dz;
  float dlz1 = syj * r.dx + cyj * r.dz;
  float dly = cpj * r.dy + spj * dlz1;
  float dlz = -spj * r.dy + cpj * dlz1;
  float rix = recip_safe(dlx), riy = recip_safe(dly), riz = recip_safe(dlz);
  int code;
  // eye offset (0, 0, -0.19) -/+ half extents (0.25, 0.12, 0.2)
  float t = slab(-0.25f, -0.12f, -0.39f, 0.25f, 0.12f, (float)(-0.19 + 0.2),
                 lx * rix, ly * riy, lz * riz, rix, riy, riz, code);
  float nlx, nly, nlz;
  slab_normal(code, dlx, dly, dlz, nlx, nly, nlz);
  float wy = cpj * nly - spj * nlz;
  float wz1 = spj * nly + cpj * nlz;
  h.t = t;
  h.nx = cyj * nlx + syj * wz1;
  h.ny = wy;
  h.nz = -syj * nlx + cyj * wz1;
}

// y-rotated box; cyj/syj are the row's precomputed cos/sin.
__device__ __forceinline__ void prim_rotbox(const Ray& r, float cx0, float cy0,
                                            float cz0, float cyj, float syj,
                                            float hx, float hy, float hz,
                                            Hit& h) {
  float ox = r.ex - cx0, oy = r.ey - cy0, oz = r.ez - cz0;
  float lx = cyj * ox - syj * oz;
  float lz = syj * ox + cyj * oz;
  float dlx = cyj * r.dx - syj * r.dz;
  float dlz = syj * r.dx + cyj * r.dz;
  float rix = recip_safe(dlx), riz = recip_safe(dlz);
  int code;
  float t = slab(-hx, -hy, -hz, hx, hy, hz, lx * rix, oy * r.iy, lz * riz, rix,
                 r.iy, riz, code);
  float nlx, nly, nlz;
  slab_normal(code, dlx, r.dy, dlz, nlx, nly, nlz);
  h.t = t;
  h.nx = cyj * nlx + syj * nlz;
  h.ny = nly;
  h.nz = -syj * nlx + cyj * nlz;
}

// Fused hex wall + derived bottom edging: shared rotated-ray products, two
// slab tests; the edging (drawn after the wall) wins only a strictly closer
// hit. Sets the per-pixel colour.
__device__ __forceinline__ void prim_rotbox_wall(const Ray& r, float cx0,
                                                 float cy0, float cz0,
                                                 float cyj, float syj, float hx,
                                                 float hy, float hz, float wcol,
                                                 float ecol, Hit& h) {
  float ox = r.ex - cx0, oy = r.ey - cy0, oz = r.ez - cz0;
  float lx = cyj * ox - syj * oz;
  float lz = syj * ox + cyj * oz;
  float dlx = cyj * r.dx - syj * r.dz;
  float dlz = syj * r.dx + cyj * r.dz;
  float rix = recip_safe(dlx), riz = recip_safe(dlz);
  float oxix_l = lx * rix, oyiy_l = oy * r.iy, oziz_l = lz * riz;
  int wcode, ecode;
  float tw = slab(-hx, -hy, -hz, hx, hy, hz, oxix_l, oyiy_l, oziz_l, rix, r.iy,
                  riz, wcode);
  float ehx = 1.02f * hx;   // WALL_EDGE_LEN_SCALE
  float ehz = 0.2f;         // WALL_EDGE_HZ
  // edging world-y span is [0, 2*0.12*hy], relative to the wall centre cy0
  float te = slab(-ehx, -cy0, -ehz, ehx, 0.24f * hy - cy0, ehz, oxix_l, oyiy_l,
                  oziz_l, rix, r.iy, riz, ecode);
  bool use_e = te < tw;
  float nlx, nly, nlz;
  slab_normal(use_e ? ecode : wcode, dlx, r.dy, dlz, nlx, nly, nlz);
  h.t = use_e ? te : tw;
  h.c = use_e ? ecol : wcol;
  h.nx = cyj * nlx + syj * nlz;
  h.ny = nly;
  h.nz = -syj * nlx + cyj * nlz;
}

// Generic row test: one intersection routine chosen by the row's type (a
// block-uniform branch). Dead rows (type < 0) miss.
__device__ __forceinline__ void row_hit(const Ray& r, const float* __restrict__ p,
                                        Hit& h) {
  int ptype = (int)__ldg(p + 0);
  float a0 = __ldg(p + 1), a1 = __ldg(p + 2), a2 = __ldg(p + 3);
  float b0 = __ldg(p + 4), b1 = __ldg(p + 5), b2 = __ldg(p + 6);
  h.c = __ldg(p + 7);
  int k = ptype < 0 ? 0 : (ptype > 7 ? 7 : ptype);
  switch (k) {
    case 0: {
      int code;
      h.t = prim_aabb(r, a0, a1, a2, b0, b1, b2, code);
      slab_normal(code, r.dx, r.dy, r.dz, h.nx, h.ny, h.nz);
      break;
    }
    case 1: prim_ellipsoid(r, a0, a1, a2, b0, b1, b2, h); break;
    case 2: prim_cylinder(r, a0, a1, a2, b0, b1, b2, h); break;
    case 3: prim_cone(r, a0, a1, a2, b0, b1, b2, 1.0f, h); break;
    case 4: prim_cone(r, a0, a1, a2, b0, b1, b2, -1.0f, h); break;
    case 5: prim_eyebox(r, a0, a1, a2, b0, b1, h); break;
    case 6:
      prim_rotbox(r, a0, a1, a2, b1, b2, __ldg(p + 8), __ldg(p + 9),
                  __ldg(p + 10), h);
      break;
    default:
      prim_rotbox_wall(r, a0, a1, a2, b1, b2, __ldg(p + 8), __ldg(p + 9),
                       __ldg(p + 10), h.c, __ldg(p + 11), h);
      break;
  }
  if (ptype < 0) h.t = INF_T;
}

// Carry updates. TIE=false: strict `t < best` (in-order traversal). TIE=true:
// ties resolve to the lowest row index, which is what in-order traversal's
// strict compare produces, so any visiting order yields the same image.
template <bool TIE>
__device__ __forceinline__ bool closer_than(const Carry& c, float t, int i) {
  if (TIE) return (t < c.t) || ((t == c.t) && (i < c.idx));
  return t < c.t;
}

template <bool TIE>
__device__ __forceinline__ void take_hit(Carry& c, const Hit& h, int i) {
  if (closer_than<TIE>(c, h.t, i)) {
    c.t = h.t;
    c.idx = i;
    c.nx = h.nx;
    c.ny = h.ny;
    c.nz = h.nz;
    c.code = CODE_DIRECT;
    c.c = h.c;
  }
}

// Homogeneous row bodies (all live rows of the cluster share a type).
template <bool TIE>
__device__ __forceinline__ void body_aabb(const Ray& r, const float* __restrict__ p,
                                          int i, Carry& c) {
  // Deferred-normal variant: only (t, face-axis code) enter the carry; the
  // normal is rebuilt once in the epilogue.
  bool live = __ldg(p + 0) >= 0.0f;
  int code;
  float t = prim_aabb(r, __ldg(p + 1), __ldg(p + 2), __ldg(p + 3), __ldg(p + 4),
                      __ldg(p + 5), __ldg(p + 6), code);
  t = live ? t : INF_T;
  if (closer_than<TIE>(c, t, i)) {
    c.t = t;
    c.idx = i;
    c.code = code;
    c.c = __ldg(p + 7);
  }
}

template <bool TIE>
__device__ __forceinline__ void body_rotbox(const Ray& r, const float* __restrict__ p,
                                            int i, Carry& c) {
  Hit h;
  h.c = __ldg(p + 7);
  prim_rotbox(r, __ldg(p + 1), __ldg(p + 2), __ldg(p + 3), __ldg(p + 5),
              __ldg(p + 6), __ldg(p + 8), __ldg(p + 9), __ldg(p + 10), h);
  if (!(__ldg(p + 0) >= 0.0f)) h.t = INF_T;
  take_hit<TIE>(c, h, i);
}

template <bool TIE>
__device__ __forceinline__ void body_wall(const Ray& r, const float* __restrict__ p,
                                          int i, Carry& c) {
  Hit h;
  prim_rotbox_wall(r, __ldg(p + 1), __ldg(p + 2), __ldg(p + 3), __ldg(p + 5),
                   __ldg(p + 6), __ldg(p + 8), __ldg(p + 9), __ldg(p + 10),
                   __ldg(p + 7), __ldg(p + 11), h);
  if (!(__ldg(p + 0) >= 0.0f)) h.t = INF_T;
  take_hit<TIE>(c, h, i);
}

template <bool TIE>
__device__ __forceinline__ void body_ellipsoid(const Ray& r, const float* __restrict__ p,
                                               int i, Carry& c) {
  Hit h;
  h.c = __ldg(p + 7);
  prim_ellipsoid(r, __ldg(p + 1), __ldg(p + 2), __ldg(p + 3), __ldg(p + 4),
                 __ldg(p + 5), __ldg(p + 6), h);
  if (!(__ldg(p + 0) >= 0.0f)) h.t = INF_T;
  take_hit<TIE>(c, h, i);
}

template <bool TIE>
__device__ __forceinline__ void body_cylinder(const Ray& r, const float* __restrict__ p,
                                              int i, Carry& c) {
  Hit h;
  h.c = __ldg(p + 7);
  prim_cylinder(r, __ldg(p + 1), __ldg(p + 2), __ldg(p + 3), __ldg(p + 4),
                __ldg(p + 5), __ldg(p + 6), h);
  if (!(__ldg(p + 0) >= 0.0f)) h.t = INF_T;
  take_hit<TIE>(c, h, i);
}

template <bool TIE>
__device__ __forceinline__ void body_cone(const Ray& r, const float* __restrict__ p,
                                          int i, Carry& c) {
  // The flip sign comes from the row type, so CONE / CONE_FLIPPED mixed
  // clusters (diamond halves) share one body.
  float ptype = __ldg(p + 0);
  float s = (ptype == 3.0f) ? 1.0f : -1.0f;
  Hit h;
  h.c = __ldg(p + 7);
  prim_cone(r, __ldg(p + 1), __ldg(p + 2), __ldg(p + 3), __ldg(p + 4),
            __ldg(p + 5), __ldg(p + 6), s, h);
  if (!(ptype >= 0.0f)) h.t = INF_T;
  take_hit<TIE>(c, h, i);
}

template <bool TIE>
__device__ __forceinline__ void body_generic(const Ray& r, const float* __restrict__ p,
                                             int i, Carry& c) {
  Hit h;
  row_hit(r, p, h);
  take_hit<TIE>(c, h, i);
}

// Maximum of v over the block, returned to every thread. Every thread of the
// block must call it.
__device__ __forceinline__ float block_max(float v, float* smem) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  __syncthreads();  // the previous call's readers are done with smem
  if ((threadIdx.x & 31) == 0) smem[threadIdx.x >> 5] = v;
  __syncthreads();
  float m = smem[0];
#pragma unroll
  for (int w = 1; w < NWARPS; ++w) m = fmaxf(m, smem[w]);
  return m;
}

struct Pixel {
  int b, a, tile, x, y;   // env, agent, tile row, pixel column, pixel row
  float uu, vv;           // normalized device coords of the pixel centre
};

// `blk` numbers the 2-row sub-blocks of the whole batch: sub-block fastest,
// then tile row, agent, env. It is blockIdx.x for the tiled launch and runs
// over one frame's sub-blocks inside a block of the merged launch.
__device__ __forceinline__ Pixel locate(int blk, int num_agents, int tiles,
                                        int height) {
  Pixel px;
  int sub = blk % SUBS;
  blk /= SUBS;
  px.tile = blk % tiles;
  blk /= tiles;
  px.a = blk % num_agents;
  px.b = blk / num_agents;
  px.x = threadIdx.x & (TILE_W - 1);
  px.y = px.tile * TILE_H + sub * SUB_ROWS + (threadIdx.x >> 7);
  px.uu = ((float)px.x + 0.5f) / (float)TILE_W * 2.0f - 1.0f;
  px.vv = 1.0f - ((float)px.y + 0.5f) / (float)height * 2.0f;
  return px;
}

__device__ __forceinline__ Ray make_ray(const Pixel& px, const float* __restrict__ cam,
                                        const float* __restrict__ kc) {
  float u = px.uu * __ldg(kc + K_TAN_H);
  float v = px.vv * __ldg(kc + K_TAN_V);
  float inv_len = rsqrtf(u * u + v * v + 1.0f);
  float dx0 = u * inv_len;
  float dy0 = v * inv_len;
  float dz0 = -inv_len;
  float yaw = __ldg(cam + 3), pitch = __ldg(cam + 4);
  float cy = cosf(yaw), sy = sinf(yaw);
  float cp = cosf(pitch), sp = sinf(pitch);
  // world dir = R_y(yaw) @ R_x(pitch) @ d_cam
  float y1 = cp * dy0 - sp * dz0;
  float z1 = sp * dy0 + cp * dz0;
  Ray r;
  r.ex = __ldg(cam + 0);
  r.ey = __ldg(cam + 1);
  r.ez = __ldg(cam + 2);
  r.dx = cy * dx0 + sy * z1;
  r.dy = y1;
  r.dz = -sy * dx0 + cy * z1;
  r.ix = recip_safe(r.dx);
  r.iy = recip_safe(r.dy);
  r.iz = recip_safe(r.dz);
  r.exix = r.ex * r.ix;
  r.eyiy = r.ey * r.iy;
  r.eziz = r.ez * r.iz;
  return r;
}

// x ** 300 by repeated squaring, in the multiplication order of
// ops/raycast.py pow_shininess.
__device__ __forceinline__ float pow300(float x) {
  float x2 = x * x;
  float x4 = x2 * x2;
  float x8 = x4 * x4;
  float x16 = x8 * x8;
  float x32 = x16 * x16;
  float x64 = x32 * x32;
  float x128 = x64 * x64;
  float x256 = x128 * x128;
  return ((x4 * x8) * x32) * x256;
}

__device__ __forceinline__ int to8(float c) {
  return (int)fminf(fmaxf(c * 255.0f + 0.5f, 0.0f), 255.0f);
}

// Decode the normal, shade (Blinn-Phong, light (0,4,2) x 0.6667, shininess
// 300), composite the HUD, pack and store.
__device__ __forceinline__ void epilogue(const Pixel& px, const Ray& ray,
                                         const Carry& c,
                                         const float* __restrict__ cam,
                                         const float* __restrict__ kc,
                                         int ui_indicators, int height,
                                         int num_agents, int* __restrict__ out) {
  float nx = c.nx, ny = c.ny, nz = c.nz;
  if (c.code < CODE_DIRECT)
    slab_normal(c.code, ray.dx, ray.dy, ray.dz, nx, ny, nz);

  int pk = (int)c.c;
  float cr = (float)((pk >> 16) & 0xFF) / 255.0f;
  float cg = (float)((pk >> 8) & 0xFF) / 255.0f;
  float cb = (float)(pk & 0xFF) / 255.0f;

  float t = c.t;
  float hx0 = ray.ex + t * ray.dx;
  float hy0 = ray.ey + t * ray.dy;
  float hz0 = ray.ez + t * ray.dz;
  float lx = 0.0f - hx0;
  float ly = 4.0f - hy0;
  float lz = 2.0f - hz0;
  float inv = rsqrtf(lx * lx + ly * ly + lz * lz + 1e-12f);
  lx = lx * inv;
  ly = ly * inv;
  lz = lz * inv;
  float ndl = fmaxf(nx * lx + ny * ly + nz * lz, 0.0f);
  float hx = lx - ray.dx, hy = ly - ray.dy, hz = lz - ray.dz;
  float inv_h = rsqrtf(hx * hx + hy * hy + hz * hz + 1e-12f);
  float ndh = fmaxf(nx * hx + ny * hy + nz * hz, 0.0f) * inv_h;
  float spec = pow300(ndh);

  const float lc = 0.6667f;
  float diff = 0.3f + ndl * lc;
  float sp_term = spec * lc;
  bool miss = t >= FAR_T;
  float r = miss ? 0.1333f : cr * diff + sp_term;
  float g = miss ? 0.1333f : cg * diff + sp_term;
  float b = miss ? 0.1333f : cb * diff + sp_term;

  // HUD time bar (scenario_default.hpp:140-145, 164-169)
  float time_frac = __ldg(cam + 5);
  float bar_half_u = 0.24f * time_frac / __ldg(kc + K_BAR_DEN);
  bool in_bar = (fabsf(px.uu) <= bar_half_u) &&
                (fabsf(px.vv - __ldg(kc + K_BAR_V)) <= __ldg(kc + K_BAR_HALF_V));
  if (in_bar) {
    r = __ldg(kc + K_BAR_RGB + 0);
    g = __ldg(kc + K_BAR_RGB + 1);
    b = __ldg(kc + K_BAR_RGB + 2);
  }
  if (ui_indicators) {
    // Reward indicator quads (scenario_default.hpp:147-162, 171-186)
    float lr = __ldg(cam + 6);
    const float feps = 1.19209290e-07f;
    float half_v = 0.04f * fabsf(lr) / __ldg(kc + K_IND_DEN);
    bool in_v = fabsf(px.vv) <= half_v;
    float ind_cu = __ldg(kc + K_IND_CU), ind_half_u = __ldg(kc + K_IND_HALF_U);
    bool pos_m = (lr > feps) && (fabsf(px.uu + ind_cu) <= ind_half_u) && in_v;
    bool neg_m = (lr < -feps) && (fabsf(px.uu - ind_cu) <= ind_half_u) && in_v;
    if (pos_m) {
      r = __ldg(kc + K_GREEN_RGB + 0);
      g = __ldg(kc + K_GREEN_RGB + 1);
      b = __ldg(kc + K_GREEN_RGB + 2);
    } else if (neg_m) {
      r = __ldg(kc + K_RED_RGB + 0);
      g = __ldg(kc + K_RED_RGB + 1);
      b = __ldg(kc + K_RED_RGB + 2);
    }
  }
  int packed = (to8(r) << 16) | (to8(g) << 8) | to8(b);
  size_t o = (((size_t)px.b * num_agents + px.a) * height + px.y) * TILE_W + px.x;
  out[o] = packed;
}

// ---------------------------------------------------------------------------
// Traversals. One `trace<FORM>` per form of the reference kernel; each handles
// one 256-thread sub-block (2 pixel rows) and leaves the closest hit in `c`.
// Every loop bound and every branch into a row body below depends only on
// table values, on a block-wide vote (__syncthreads_or) or on block_max, so
// all threads of a block take the same path and reach the same barriers.
// ---------------------------------------------------------------------------
enum { FORM_B1 = 1, FORM_B2, FORM_B3, FORM_B4, FORM_B5 };

struct Args {
  const float* __restrict__ cams;       // [B, A, 8]
  const float* __restrict__ prims;      // [B, M, 12]
  const float* __restrict__ clusters;   // [B, G, 8]             (B2-B5)
  const float* __restrict__ sclusters;  // [B, S, 8]             (B5)
  const int* __restrict__ order;        // [B, A, (T,) L]        (B4, B5)
  const float* __restrict__ dist;       // like order, or null   (B4, B5)
  const int* __restrict__ sclist;       // [B, A, T, S]          (B2)
  const int* __restrict__ clbits;       // [B, A, T, words]      (B2)
  const float* __restrict__ scdist;     // [B, A, T, S]          (B2)
  const float* __restrict__ cdist;      // [B, A, G]             (B2)
  const float* __restrict__ kc;         // render constants
  int* __restrict__ out;                // [B, A, H, 128]
  int* __restrict__ visits;             // [sub-blocks, 2] or null
  int num_agents, height, num_prims, num_clusters, num_words;
  int list_len;                         // L: entries per list of `order`
  int per_tile;                         // lists per (env, agent, tile)
  int ui_indicators;
};

struct Walk {
  const float* table;   // this env's prim rows
  const float* ctab;    // this env's cluster boxes
  size_t ba;            // env * A + agent
  size_t bat;           // (env * A + agent) * T + tile
  int ran_aabb, ran_other;   // clusters run, by body (for `visits`)
};

template <bool TIE>
__device__ __forceinline__ void run_cluster(const Ray& ray,
                                            const float* __restrict__ table,
                                            const float* __restrict__ clusters,
                                            int gc, Carry& c) {
  int tag = (int)__ldg(clusters + (size_t)gc * 8 + 6);
  const int base = gc * CLUSTER_K;
  const float* p = table + (size_t)base * ROW_W;
  switch (tag) {
    case 0:
#pragma unroll 1
      for (int j = 0; j < CLUSTER_K; ++j)
        body_aabb<TIE>(ray, p + j * ROW_W, base + j, c);
      break;
    case 6:
#pragma unroll 1
      for (int j = 0; j < CLUSTER_K; ++j)
        body_rotbox<TIE>(ray, p + j * ROW_W, base + j, c);
      break;
    case 1:
#pragma unroll 1
      for (int j = 0; j < CLUSTER_K; ++j)
        body_ellipsoid<TIE>(ray, p + j * ROW_W, base + j, c);
      break;
    case 2:
#pragma unroll 1
      for (int j = 0; j < CLUSTER_K; ++j)
        body_cylinder<TIE>(ray, p + j * ROW_W, base + j, c);
      break;
    case 3:
    case 4:
    case 8:  // TAG_CONE_MIXED
#pragma unroll 1
      for (int j = 0; j < CLUSTER_K; ++j)
        body_cone<TIE>(ray, p + j * ROW_W, base + j, c);
      break;
    case 7:
#pragma unroll 1
      for (int j = 0; j < CLUSTER_K; ++j)
        body_wall<TIE>(ray, p + j * ROW_W, base + j, c);
      break;
    default:
#pragma unroll 1
      for (int j = 0; j < CLUSTER_K; ++j)
        body_generic<TIE>(ray, p + j * ROW_W, base + j, c);
      break;
  }
}

// Run cluster gc and count it for `visits`.
template <bool TIE>
__device__ __forceinline__ void visit_cluster(const Ray& ray, Walk& w, int gc,
                                              Carry& c) {
  run_cluster<TIE>(ray, w.table, w.ctab, gc, c);
  if ((int)__ldg(w.ctab + (size_t)gc * 8 + 6) == 0) ++w.ran_aabb; else ++w.ran_other;
}

// Can this pixel's ray still find a hit closer than `bt` inside the box
// (lo xyz, hi xyz)? No `tmin > near` term: a camera inside the box must still
// process it. SLACK absorbs the rounding between these slab products and the
// per-type intersection routines (a quadric's hit can land an ulp before the
// box entry); it assumes unit ray directions. A dead box (point at +INF)
// gives tmin = +inf or tmax = -inf and never passes.
__device__ __forceinline__ bool box_reachable(const Ray& r,
                                              const float* __restrict__ box,
                                              float bt) {
  float t1x = __ldg(box + 0) * r.ix - r.exix;
  float t2x = __ldg(box + 3) * r.ix - r.exix;
  float t1y = __ldg(box + 1) * r.iy - r.eyiy;
  float t2y = __ldg(box + 4) * r.iy - r.eyiy;
  float t1z = __ldg(box + 2) * r.iz - r.eziz;
  float t2z = __ldg(box + 5) * r.iz - r.eziz;
  float tmin = fmaxf(fminf(t1x, t2x), fmaxf(fminf(t1y, t2y), fminf(t1z, t2z)));
  float tmax = fminf(fmaxf(t1x, t2x), fminf(fmaxf(t1y, t2y), fmaxf(t1z, t2z)));
  return (tmax >= tmin) && (tmax > 0.0f) && (tmin < bt + SLACK);
}

// Does cluster gc own eight rows of the table? False for the clusters that
// pad the cluster table to whole superclusters when the prim table itself was
// not padded (form B5): no row past num_prims is ever read.
__device__ __forceinline__ bool cluster_has_rows(int gc, int num_prims) {
  return gc >= 0 && gc * CLUSTER_K + CLUSTER_K <= num_prims;
}

template <int FORM>
__device__ __forceinline__ void trace(const Args& A, const Pixel& px,
                                      const Ray& ray, Walk& w, Carry& c,
                                      float* red);

// B1: unculled, every row in table order, generic row test, strict carry.
template <>
__device__ __forceinline__ void trace<FORM_B1>(const Args& A, const Pixel& px,
                                               const Ray& ray, Walk& w,
                                               Carry& c, float* red) {
  c.t = INF_T;
#pragma unroll 1
  for (int i = 0; i < A.num_prims; ++i)
    body_generic<false>(ray, w.table + (size_t)i * ROW_W, i, c);
}

// B2: bit-walk over the tile's front-to-back supercluster list.
template <>
__device__ __forceinline__ void trace<FORM_B2>(const Args& A, const Pixel& px,
                                               const Ray& ray, Walk& w,
                                               Carry& c, float* red) {
  const int num_super = A.num_clusters / SUPER_K;
  const int* sl = A.sclist + w.bat * num_super;
  const float* sd = A.scdist + w.bat * num_super;
  const unsigned* cw =
      reinterpret_cast<const unsigned*>(A.clbits) + w.bat * A.num_words;
  const float* cd = A.cdist + w.ba * A.num_clusters;

  // The depth starts at the FAR plane (not +INF): hits at t >= far render as
  // sky either way, and a tile whose rays all miss then has maxt == far
  // instead of an unskippable +INF bound.
  c.t = FAR_T;

  // maxt is an upper bound on this block's per-ray depths. cdist/scdist are
  // geometric lower bounds (eye -> cluster AABB distance; ray dirs are unit
  // length) on t of any member hit; SLACK absorbs their rounding, so a skipped
  // cluster's hits satisfy t > maxt >= best strictly: neither a win nor a tie.
  float maxt = FAR_T;
  int nproc = 0;
  for (int g = 0; g < num_super; ++g) {
    int gs = __ldg(sl + g);
    if (gs >= num_super) break;                      // sentinel: end of list
    if (!(__ldg(sd + g) <= maxt + SLACK)) break;     // list is ascending
    int ran = 0;
#pragma unroll 1
    for (int j = 0; j < SUPER_K; ++j) {
      int gc = gs * SUPER_K + j;
      unsigned bit = (__ldg(cw + (gc >> 5)) >> (gc & 31)) & 1u;
      if (bit && (__ldg(cd + gc) <= maxt + SLACK)) {
        visit_cluster<true>(ray, w, gc, c);
        ran = 1;
      }
    }
    nproc += ran;
    // Refresh the bound after the 1st, 5th, 9th, ... processed supercluster:
    // most of its value comes from the nearest occluder; staleness only delays
    // skips (maxt only ever overestimates the depths).
    if (ran && ((nproc & 3) == 1)) maxt = block_max(c.t, red);
  }
}

// B3: clustered, in table order. Per cluster one slab test of its box against
// the pixel's current depth, a block-wide vote, then the rows. Strict carry
// from +INF: rows run in table order, and a skipped row could at best tie.
template <>
__device__ __forceinline__ void trace<FORM_B3>(const Args& A, const Pixel& px,
                                               const Ray& ray, Walk& w,
                                               Carry& c, float* red) {
  c.t = INF_T;
  const int groups = A.num_prims / CLUSTER_K;
  for (int g = 0; g < groups; ++g) {
    if (__syncthreads_or(box_reachable(ray, w.ctab + (size_t)g * 8, c.t)))
      visit_cluster<false>(ray, w, g, c);
  }
}

// B4: B3 visited through a list. `order` may be ANY permutation of the
// clusters, so the carry breaks ties towards the lowest row index. With
// `dist` (ascending lower bounds on the hit distance of the listed clusters)
// the depth starts at the far plane and the walk ends at the first entry
// beyond the block's largest depth, which is refreshed (one block reduction)
// after every cluster whose rows ran.
template <>
__device__ __forceinline__ void trace<FORM_B4>(const Args& A, const Pixel& px,
                                               const Ray& ray, Walk& w,
                                               Carry& c, float* red) {
  const size_t list = (A.per_tile ? w.bat : w.ba) * (size_t)A.list_len;
  const int* ord = A.order + list;
  const float* dst = A.dist ? A.dist + list : nullptr;
  c.t = dst ? FAR_T : INF_T;
  float maxt = FAR_T;
  for (int g = 0; g < A.list_len; ++g) {
    if (dst && !(maxt >= __ldg(dst + g))) break;
    int gc = __ldg(ord + g);
    if (!cluster_has_rows(gc, A.num_prims)) continue;
    if (__syncthreads_or(box_reachable(ray, w.ctab + (size_t)gc * 8, c.t))) {
      visit_cluster<true>(ray, w, gc, c);
      if (dst) maxt = block_max(c.t, red);
    }
  }
}

// B5: two levels. The tile's list is over superclusters; one slab test and
// vote per listed supercluster prunes 4 clusters x 8 rows, its members are
// then tested as in B3 against the running depths.
template <>
__device__ __forceinline__ void trace<FORM_B5>(const Args& A, const Pixel& px,
                                               const Ray& ray, Walk& w,
                                               Carry& c, float* red) {
  const int num_super = A.num_clusters / SUPER_K;
  const float* sctab = A.sclusters + (size_t)px.b * num_super * 8;
  const size_t list = (A.per_tile ? w.bat : w.ba) * (size_t)A.list_len;
  const int* ord = A.order + list;
  const float* dst = A.dist + list;
  c.t = FAR_T;
  float maxt = FAR_T;
  for (int gpos = 0; gpos < A.list_len; ++gpos) {
    if (!(maxt >= __ldg(dst + gpos))) break;
    int gsc = __ldg(ord + gpos);
    if (gsc < 0 || gsc >= num_super) continue;
    if (!__syncthreads_or(box_reachable(ray, sctab + (size_t)gsc * 8, c.t)))
      continue;
#pragma unroll 1
    for (int j = 0; j < SUPER_K; ++j) {
      int gc = gsc * SUPER_K + j;
      if (!cluster_has_rows(gc, A.num_prims)) continue;
      if (__syncthreads_or(box_reachable(ray, w.ctab + (size_t)gc * 8, c.t))) {
        visit_cluster<true>(ray, w, gc, c);
        maxt = block_max(c.t, red);
      }
    }
  }
}

// One kernel for every form. Tiled launch (MERGED = false): one block per
// 2-row sub-block, grid B * A * T * SUBS. Merged launch (B6): one block per
// (env, agent) frame that loops the frame's T * SUBS sub-blocks.
template <int FORM, bool MERGED>
__global__ void __launch_bounds__(NTHREADS)
render_kernel(const __grid_constant__ Args A) {
  __shared__ float red[NWARPS];
  const int tiles = A.height / TILE_H;
  const int per_frame = tiles * SUBS;
  const int first = MERGED ? blockIdx.x * per_frame : blockIdx.x;
  const int count = MERGED ? per_frame : 1;
#pragma unroll 1
  for (int k = 0; k < count; ++k) {
    const int blk = first + k;
    Pixel px = locate(blk, A.num_agents, tiles, A.height);
    Walk w;
    w.ba = (size_t)px.b * A.num_agents + px.a;
    w.bat = w.ba * tiles + px.tile;
    w.table = A.prims + (size_t)px.b * A.num_prims * ROW_W;
    w.ctab = A.clusters + (size_t)px.b * A.num_clusters * 8;
    w.ran_aabb = w.ran_other = 0;
    const float* cam = A.cams + w.ba * 8;
    Ray ray = make_ray(px, cam, A.kc);

    Carry c;
    c.idx = A.num_prims;
    c.nx = c.ny = c.nz = 0.0f;
    c.code = CODE_DIRECT;
    c.c = 0.0f;
    trace<FORM>(A, px, ray, w, c, red);

    epilogue(px, ray, c, cam, A.kc, A.ui_indicators, A.height, A.num_agents,
             A.out);
    // Optional measurement output: how many clusters this sub-block ran.
    if (A.visits != nullptr && threadIdx.x == 0) {
      A.visits[2 * (size_t)blk + 0] = w.ran_aabb;
      A.visits[2 * (size_t)blk + 1] = w.ran_other;
    }
  }
}

template <int FORM>
int launch(const Args& A, int batch, int merged, cudaStream_t stream) {
  const int frames = batch * A.num_agents;
  if (frames > 0) {
    if (merged)
      render_kernel<FORM, true><<<frames, NTHREADS, 0, stream>>>(A);
    else
      render_kernel<FORM, false>
          <<<frames * (A.height / TILE_H) * SUBS, NTHREADS, 0, stream>>>(A);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch form `form` (1..5 = B1..B5) of the renderer, tiled or (merged != 0)
// as form B6. Every pointer is a device pointer; those a form does not read
// may be null, and so may `dist` (B4 without early exit) and `visits`.
// Returns cudaGetLastError() after the launch (0 = accepted, -1 = unknown
// form); the launch runs asynchronously on `stream`.
int mv_render(int form, int merged, const float* cams, const float* prims,
              const float* clusters, const float* sclusters, const int* order,
              const float* dist, const int* sclist, const int* clbits,
              const float* scdist, const float* cdist, const float* kc,
              int* out, int* visits, int batch, int num_agents, int height,
              int num_prims, int num_clusters, int num_words, int list_len,
              int per_tile, int ui_indicators, cudaStream_t stream) {
  Args A;
  A.cams = cams;
  A.prims = prims;
  A.clusters = clusters;
  A.sclusters = sclusters;
  A.order = order;
  A.dist = dist;
  A.sclist = sclist;
  A.clbits = clbits;
  A.scdist = scdist;
  A.cdist = cdist;
  A.kc = kc;
  A.out = out;
  A.visits = visits;
  A.num_agents = num_agents;
  A.height = height;
  A.num_prims = num_prims;
  A.num_clusters = num_clusters;
  A.num_words = num_words;
  A.list_len = list_len;
  A.per_tile = per_tile;
  A.ui_indicators = ui_indicators;
  switch (form) {
    case FORM_B1: return launch<FORM_B1>(A, batch, merged, stream);
    case FORM_B2: return launch<FORM_B2>(A, batch, merged, stream);
    case FORM_B3: return launch<FORM_B3>(A, batch, merged, stream);
    case FORM_B4: return launch<FORM_B4>(A, batch, merged, stream);
    case FORM_B5: return launch<FORM_B5>(A, batch, merged, stream);
    default: return -1;
  }
}

// 256-thread sub-blocks per 8-row tile (sizes the `visits` buffer: 2 ints a
// sub-block, whichever launch shape).
int mv_render_blocks_per_tile() { return SUBS; }

int mv_render_const_count() { return K_COUNT; }

}  // extern "C"
