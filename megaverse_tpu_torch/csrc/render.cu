// Analytic raycast renderer for NVIDIA Hopper (sm_90a): forms B1 to B6.
//
// Replaces the Pallas TPU kernel `_render_kernel` of
// megaverse_tpu/ops/raycast_pallas.py (launched from its `render_packed`).
// Its six forms are one kernel template here, `render_kernel<FORM, MERGED>`:
//   B1  unculled, in table order (every live row, strict `t < best` carry,
//       best starts at +INF); the table streams through shared memory;
//   B2  bit-walk: per 8x128 pixel tile, walk the tile's front-to-back
//       supercluster list, test member bits, skip members and stop the walk on
//       the depth bound, slab-test each candidate cluster's box against the
//       pixels' depths (block vote), run its 8 rows from shared memory,
//       tie-break carry on the row index, depth bound refreshed after each
//       list entry that ran rows;
//   B3  clustered, in table order: the env's live cluster boxes, staged in
//       shared memory, are slab-tested per pixel 32 at a time against the
//       current depths, one block-wide vote per batch; the rows of the
//       clusters that passed are staged together and each runs if a second
//       vote, at the depths of that moment, still passes it;
//   B4  B3 through a list (per agent or per tile, any permutation): the
//       list's entries and their boxes are staged 32 at a time, voted on
//       once per batch and the passing rows staged together, as in B3, but
//       each warp runs (and re-votes on) only what its own pixels reach;
//       with the list's distance bounds the walk ends at the first batch
//       beyond the block's largest depth;
//   B5  two-level: per-tile lists over superclusters, staged 32 at a time
//       with their members' boxes; one vote on the superclusters, then one
//       on the members of 8 passing ones at a time, rows as in B4;
//   B6  any of B1-B5 launched frame by frame (MERGED = true): resident blocks
//       take whole (env, agent) frames from a queue and loop their
//       sub-blocks, staging what the frame shares once (B2: the clusters its
//       tiles can visit; B3: the env's boxes; B5: the env's cluster and
//       supercluster boxes); idle blocks join the frames still running.
// All write packed RGB int32 [B, A, H, W]: W = 128 and H a multiple of 8
// for B2-B5, whose cull tables are per 8x128 tile; B1 needs no table and takes
// any H x W (tiles across and down, the ragged edge traced and not stored),
// which the free camera (env.render_custom_camera) renders through.
//
// What bounds it on this card: arithmetic, not memory. A frame reads a few KB
// of tables per env and writes 4 bytes per pixel, while every visited table
// row costs some 30-150 f32 operations per pixel. What the design does about
// it:
//  - culling (B2-B5): the tables and the block votes cut the rows a pixel
//    visits from M to the handful in front of the nearest occluder;
//  - two pixels per thread (B1-B3): a row read once from shared memory, its
//    type switch and the walk's control serve two rays; B4 and B5 instead
//    decide per warp whether a cluster's rows run;
//  - few barriers: B3-B5 vote on 32 clusters per barrier and never on a dead
//    one (Collect's bucketed table is mostly dead slots);
//  - asynchronous staging: one thread hands the next rows to the
//    Tensor Memory Accelerator (cp.async.bulk, completion on an mbarrier)
//    while the block computes on the current ones, and rows are read as three
//    16-byte vectors from shared memory instead of a dozen scalar loads.
//
// Block shape: 256 threads = 2 lanes of 128 columns. With P pixels per thread
// (`pixels_per_thread<FORM>`: 2 for B1-B3, 1 for B4 and B5) a block covers
// 2 P pixel rows of an 8-row tile (a "sub-block"), so a tile has 8 / (2 P)
// sub-blocks. The reference decides per 8-row tile whether any ray
// can reach a cluster; here the vote (__syncthreads_or) and the depth bound
// (block_max) are per sub-block, a subset of that tile, and B4 and B5 run a
// cluster's rows per warp (32 columns by P rows): fewer rows run, the image is
// the same (a skipped row can never win). All loop conditions depend only on
// table values, on that vote and on that maximum, which every thread
// receives, so no thread leaves a loop alone; B4's and B5's row runs are
// uniform per warp and hold no barrier.
//
// Exactness: every form must produce the image of B1 bit for bit, which rests
// on every row computing a bit-equal `t` for the same row. All forms run a row
// through the same `row_dispatch`, and the file MUST be compiled with
// -fmad=false (nvcc would otherwise contract a*b-c into FMA differently per
// inlined call site) and WITHOUT --use_fast_math. Only rsqrtf, sinf, cosf,
// sqrtf and IEEE division are used; never __sinf/__cosf/__fdividef. Dead rows
// (type < 0) are skipped: their t is +INF, which never beats nor, in an image,
// differs from a miss.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float INF_T = 1e30f;
constexpr float NEAR_T = 0.01f;
constexpr float FAR_T = 120.0f;
constexpr float SLACK = 0.01f;
constexpr int TILE_H = 8;
constexpr int TILE_W = 128;
constexpr int LANES = 2;                     // pixel rows of one pass of the threads
constexpr int NTHREADS = LANES * TILE_W;
constexpr int NWARPS = NTHREADS / 32;
constexpr int VISIT_SEGMENTS = TILE_W / 32;  // warps across a pixel row
constexpr int ROW_W = 12;                    // f32 per primitive row
constexpr int CLUSTER_K = 8;
constexpr int SUPER_K = 4;
constexpr int CODE_DIRECT = 3;
constexpr int CLUSTER_FLOATS = CLUSTER_K * ROW_W;   // one cluster's rows: 384 B
constexpr int BOX_FLOATS = 8;                       // one cluster box: 32 B
constexpr int SLOT_FLOATS = CLUSTER_FLOATS + BOX_FLOATS;
constexpr int B2_SLOTS = 3;                  // staged clusters (ring)
constexpr int B1_CHUNK = 128;                // rows per staged chunk of B1
constexpr int B1_STAGES = 2;
constexpr int B3_BATCH = 32;                 // clusters per B3 vote (one mask bit each)
constexpr int BOX_CHUNK = 512;               // cluster boxes B3 stages at a time (16 KB)
constexpr int FRAME_K = 64;                  // clusters B6 over B2 stages per frame (26 KB)
constexpr int NBARS = 4;                     // >= B2_SLOTS + 1, B1_STAGES
constexpr int BAR_BOXES = 0;                 // B3: the box chunk
constexpr int BAR_ROWS = 1;                  // B3: the voted clusters' rows
constexpr int BAR_FRAME = 3;                 // B6 over B2: the frame's clusters

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

// A primitive row (layout in ops/raycast_cuda.py): three 16-byte vectors.
struct Row {
  float type, a0, a1, a2;
  float b0, b1, b2, col;
  float c0, c1, c2, col2;
};

// Rows and boxes start at multiples of 16 bytes (48-byte rows, 32-byte boxes,
// tables checked for 16-byte alignment by the wrapper). SHARED: `p` points
// into shared memory; otherwise into the global table, read through the
// read-only path.
template <bool SHARED>
__device__ __forceinline__ Row load_row(const float* p) {
  const float4* q = reinterpret_cast<const float4*>(p);
  float4 x, y, z;
  if (SHARED) {
    x = q[0]; y = q[1]; z = q[2];
  } else {
    x = __ldg(q); y = __ldg(q + 1); z = __ldg(q + 2);
  }
  return Row{x.x, x.y, x.z, x.w, y.x, y.y, y.z, y.w, z.x, z.y, z.z, z.w};
}

// A cluster or supercluster box: lo xyz, hi xyz, homogeneity tag.
struct Box {
  float lx, ly, lz, hx, hy, hz, tag;
};

template <bool SHARED>
__device__ __forceinline__ Box load_box(const float* p) {
  const float4* q = reinterpret_cast<const float4*>(p);
  float4 x, y;
  if (SHARED) {
    x = q[0]; y = q[1];
  } else {
    x = __ldg(q); y = __ldg(q + 1);
  }
  return Box{x.x, x.y, x.z, x.w, y.x, y.y, y.z};
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

// One live row (type >= 0) against the P rays of this thread. The switch is
// on a value every thread of the block reads alike, so it never diverges.
// AABB rows carry only (t, face-axis code): the normal is rebuilt once in the
// epilogue by the same slab_normal a direct normal would come from.
template <bool TIE, int P>
__device__ __forceinline__ void row_dispatch(const Ray (&r)[P], const Row& w, int i,
                                             Carry (&c)[P]) {
  const int k = (int)w.type;
  if (k == 0) {
#pragma unroll
    for (int p = 0; p < P; ++p) {
      int code;
      float t = prim_aabb(r[p], w.a0, w.a1, w.a2, w.b0, w.b1, w.b2, code);
      if (closer_than<TIE>(c[p], t, i)) {
        c[p].t = t;
        c[p].idx = i;
        c[p].code = code;
        c[p].c = w.col;
      }
    }
    return;
  }
#pragma unroll
  for (int p = 0; p < P; ++p) {
    Hit h;
    h.c = w.col;
    switch (k) {
      case 1: prim_ellipsoid(r[p], w.a0, w.a1, w.a2, w.b0, w.b1, w.b2, h); break;
      case 2: prim_cylinder(r[p], w.a0, w.a1, w.a2, w.b0, w.b1, w.b2, h); break;
      case 3: prim_cone(r[p], w.a0, w.a1, w.a2, w.b0, w.b1, w.b2, 1.0f, h); break;
      case 4: prim_cone(r[p], w.a0, w.a1, w.a2, w.b0, w.b1, w.b2, -1.0f, h); break;
      case 5: prim_eyebox(r[p], w.a0, w.a1, w.a2, w.b0, w.b1, h); break;
      case 6: prim_rotbox(r[p], w.a0, w.a1, w.a2, w.b1, w.b2, w.c0, w.c1, w.c2, h); break;
      default:
        prim_rotbox_wall(r[p], w.a0, w.a1, w.a2, w.b1, w.b2, w.c0, w.c1, w.c2, w.col,
                         w.col2, h);
        break;
    }
    take_hit<TIE>(c[p], h, i);
  }
}

// The 8 rows of one cluster, starting at row index `base`.
template <bool TIE, int P, bool SHARED>
__device__ __forceinline__ void run_cluster(const Ray (&r)[P], const float* rows, int base,
                                            Carry (&c)[P]) {
#pragma unroll 1
  for (int j = 0; j < CLUSTER_K; ++j) {
    const Row w = load_row<SHARED>(rows + j * ROW_W);
    if (w.type >= 0.0f) row_dispatch<TIE, P>(r, w, base + j, c);
  }
}

// Order-preserving compaction over the block: the place of this thread's
// `keep` among the kept ones of threads with a lower index, counted from
// `total`, which grows by the block's count. Every thread must call it; `cnt`
// holds NWARPS ints.
__device__ __forceinline__ int block_rank(bool keep, int& total, int* cnt) {
  const unsigned bal = __ballot_sync(0xffffffffu, keep);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) cnt[warp] = __popc(bal);
  __syncthreads();
  int off = total, sum = 0;
#pragma unroll
  for (int k = 0; k < NWARPS; ++k) {
    const int x = cnt[k];
    off += k < warp ? x : 0;
    sum += x;
  }
  __syncthreads();  // cnt is read before its next use
  total += sum;
  return off + __popc(bal & ((1u << lane) - 1u));
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

template <int P>
__device__ __forceinline__ float max_depth(const Carry (&c)[P]) {
  float m = c[0].t;
#pragma unroll
  for (int p = 1; p < P; ++p) m = fmaxf(m, c[p].t);
  return m;
}

// Can this pixel's ray still find a hit closer than `bt` inside the box? No
// `tmin > near` term: a camera inside the box must still process it. SLACK
// absorbs the rounding between these slab products and the per-type
// intersection routines (a quadric's hit can land an ulp before the box
// entry); it assumes unit ray directions. A dead box (point at +INF) gives
// tmin = +inf or tmax = -inf and never passes. ops/raycast_cuda.py
// box_reachable_plain is its plain version.
__device__ __forceinline__ bool box_reachable(const Ray& r, const Box& b, float bt) {
  float t1x = b.lx * r.ix - r.exix;
  float t2x = b.hx * r.ix - r.exix;
  float t1y = b.ly * r.iy - r.eyiy;
  float t2y = b.hy * r.iy - r.eyiy;
  float t1z = b.lz * r.iz - r.eziz;
  float t2z = b.hz * r.iz - r.eziz;
  float tmin = fmaxf(fminf(t1x, t2x), fmaxf(fminf(t1y, t2y), fminf(t1z, t2z)));
  float tmax = fminf(fmaxf(t1x, t2x), fminf(fmaxf(t1y, t2y), fmaxf(t1z, t2z)));
  return (tmax >= tmin) && (tmax > 0.0f) && (tmin < bt + SLACK);
}

// Can any of this thread's rays reach the box? (The vote's predicate.)
template <int P>
__device__ __forceinline__ bool any_reachable(const Ray (&r)[P], const Box& b,
                                              const Carry (&c)[P]) {
  bool any = false;
#pragma unroll
  for (int p = 0; p < P; ++p) any |= box_reachable(r[p], b, c[p].t);
  return any;
}

struct Pixel {
  int b, a, x, y;         // env, agent, pixel column, pixel row
  float uu, vv;           // normalized device coords of the pixel centre
};

// The camera of one frame, shared by every ray of a block.
struct Cam {
  float ex, ey, ez, cy, sy, cp, sp;
};

__device__ __forceinline__ Cam load_cam(const float* __restrict__ cam) {
  Cam k;
  k.ex = __ldg(cam + 0);
  k.ey = __ldg(cam + 1);
  k.ez = __ldg(cam + 2);
  float yaw = __ldg(cam + 3), pitch = __ldg(cam + 4);
  k.cy = cosf(yaw);
  k.sy = sinf(yaw);
  k.cp = cosf(pitch);
  k.sp = sinf(pitch);
  return k;
}

// Pixel column x0 + (thread's lane in the row), row y of a height x width
// view; a pixel past the view's right or bottom edge is traced (every thread
// takes part in the block's barriers) but never stored (`epilogue`).
__device__ __forceinline__ Pixel make_pixel(int b, int a, int x0, int y, int height,
                                            int width) {
  Pixel px;
  px.b = b;
  px.a = a;
  px.x = x0 + (threadIdx.x & (TILE_W - 1));
  px.y = y;
  px.uu = ((float)px.x + 0.5f) / (float)width * 2.0f - 1.0f;
  px.vv = 1.0f - ((float)px.y + 0.5f) / (float)height * 2.0f;
  return px;
}

__device__ __forceinline__ Ray make_ray(const Pixel& px, const Cam& k,
                                        const float* __restrict__ kc) {
  float u = px.uu * __ldg(kc + K_TAN_H);
  float v = px.vv * __ldg(kc + K_TAN_V);
  float inv_len = rsqrtf(u * u + v * v + 1.0f);
  float dx0 = u * inv_len;
  float dy0 = v * inv_len;
  float dz0 = -inv_len;
  // world dir = R_y(yaw) @ R_x(pitch) @ d_cam
  float y1 = k.cp * dy0 - k.sp * dz0;
  float z1 = k.sp * dy0 + k.cp * dz0;
  Ray r;
  r.ex = k.ex;
  r.ey = k.ey;
  r.ez = k.ez;
  r.dx = k.cy * dx0 + k.sy * z1;
  r.dy = y1;
  r.dz = -k.sy * dx0 + k.cy * z1;
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
// 300), composite the HUD, pack and store; with ANY_SIZE (B1) a pixel past
// the view's right or bottom edge is not stored.
template <bool ANY_SIZE>
__device__ __forceinline__ void epilogue(const Pixel& px, const Ray& ray,
                                         const Carry& c,
                                         const float* __restrict__ cam,
                                         const float* __restrict__ kc,
                                         int ui_indicators, int height, int width,
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
  if (ANY_SIZE && (px.x >= width || px.y >= height)) return;
  size_t o = (((size_t)px.b * num_agents + px.a) * height + px.y) * width + px.x;
  out[o] = packed;
}

// ---------------------------------------------------------------------------
// Asynchronous staging: bulk copies global -> shared memory by the Tensor
// Memory Accelerator, completion counted in bytes on an mbarrier (one arrival:
// the issuing thread's expect_tx). Sizes and addresses are multiples of 16.
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void bar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Wait for the completion of barrier `slot`'s current phase; `phase` holds
// one parity bit per barrier (the same in every thread). A copy that never
// lands (a fault) traps after some seconds instead of hanging the card.
__device__ __forceinline__ void bar_wait(uint64_t* bars, int slot, uint32_t& phase) {
  const uint32_t addr = smem_u32(bars + slot);
  const uint32_t parity = (phase >> slot) & 1u;
  uint32_t done;
  uint32_t spins = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (++spins == (1u << 24)) __trap();
  } while (!done);
  phase ^= 1u << slot;
}

// ---------------------------------------------------------------------------
// Traversals. One `trace_*` per form of the reference kernel; each handles one
// sub-block (2 P pixel rows) and leaves the closest hit of every pixel in `c`.
// Every loop bound and every branch into a row below depends only on table
// values or shared-memory words every thread reads alike, on a block-wide
// vote (__syncthreads_or, B3's vote words) or on block_max, so all threads of
// a block take the same path and reach the same barriers. The one exception,
// B4's and B5's run of the rows a vote copied (run_voted), is a loop of a
// warp's own, with no barrier inside.
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
  int* __restrict__ out;                // [B, A, H, W]
  int* __restrict__ visits;             // [B, A, H, 2] or null
  int* __restrict__ work;               // [B * A + 1] zeros: B6's work queue
  int num_frames;                       // B * A
  int num_agents, height, num_prims, num_clusters, num_words;
  int width;                            // W: 128 for B2-B5, any for B1
  int list_len;                         // L: entries per list of `order`
  int per_tile;                         // lists per (env, agent, tile)
  int ui_indicators;
};

struct Walk {
  const float* table;   // this env's prim rows
  const float* ctab;    // this env's cluster boxes
  size_t ba;            // env * A + agent
  size_t bat;           // (env * A + agent) * T + tile
  int ran_aabb, ran_other;   // clusters run, by tag (for `visits`)
};

// Shared memory a block's traversal works in, and what it holds across the
// sub-blocks of a merged launch.
struct Stage {
  unsigned char* dyn;   // dynamic shared memory (B1: row chunks; B2: ring + walk
                        // tables, B6 over B2 also the frame's clusters; B3: boxes,
                        // live list, rows of a vote; B4, B5: rows of a vote, the
                        // list batch's boxes and ids, B6 over B5 the env's boxes)
  uint64_t* bars;       // NBARS mbarriers
  float* red;           // NWARPS floats for block_max
  int* cnt;             // NWARPS ints for block_rank
  unsigned* votes;      // 2 * NWARPS vote words (B3-B5)
  int* bcast;           // one int thread 0 hands to the block
  uint32_t phase;       // parity bit per barrier
  int key;              // what `dyn` holds across sub-blocks, -1 = nothing:
                        // B3 env * chunks + chunk; B6 over B2 the frame; B6
                        // over B5 the env
  int nlive;            // B3: live clusters of the staged chunk
};

__device__ __forceinline__ void count_visit(Walk& w, const Box& bx) {
  if ((int)bx.tag == 0) ++w.ran_aabb; else ++w.ran_other;
}

// Does cluster gc own eight rows of the table? False for the clusters that
// pad the cluster table to whole superclusters when the prim table itself was
// not padded (form B5): no row past num_prims is ever read.
__device__ __forceinline__ bool cluster_has_rows(int gc, int num_prims) {
  return gc >= 0 && gc * CLUSTER_K + CLUSTER_K <= num_prims;
}

// B1: unculled, every live row in table order, strict carry from +INF. The
// table streams through shared memory in chunks of B1_CHUNK rows, B1_STAGES
// chunks in flight: while the block runs chunk n, chunk n + 1 is arriving.
template <int P>
__device__ __forceinline__ void trace_b1(const Args& A, Walk& w, const Ray (&ray)[P],
                                         Carry (&c)[P], Stage& s) {
  float* stage = reinterpret_cast<float*>(s.dyn);
  const int m = A.num_prims;
  const int chunks = (m + B1_CHUNK - 1) / B1_CHUNK;
  auto fetch = [&](int ch) {
    if (threadIdx.x == 0) {
      const int r0 = ch * B1_CHUNK;
      const int n = min(B1_CHUNK, m - r0);
      const int slot = ch % B1_STAGES;
      const uint32_t bytes = (uint32_t)n * ROW_W * 4;
      bar_expect(s.bars + slot, bytes);
      bulk_load(stage + slot * B1_CHUNK * ROW_W, w.table + (size_t)r0 * ROW_W, bytes,
                s.bars + slot);
    }
  };
#pragma unroll
  for (int p = 0; p < P; ++p) c[p].t = INF_T;
  __syncthreads();  // a merged launch's previous sub-block is done with the stages
  for (int ch = 0; ch < min(B1_STAGES, chunks); ++ch) fetch(ch);
#pragma unroll 1
  for (int ch = 0; ch < chunks; ++ch) {
    const int slot = ch % B1_STAGES;
    bar_wait(s.bars, slot, s.phase);
    const float* rows = stage + slot * B1_CHUNK * ROW_W;
    const int r0 = ch * B1_CHUNK;
    const int n = min(B1_CHUNK, m - r0);
    // 32 rows at a time, each lane reads one row's type; the ballot (the
    // same in every warp) lists the live ones, in order
#pragma unroll 1
    for (int j0 = 0; j0 < n; j0 += 32) {
      const int j = j0 + (threadIdx.x & 31);
      unsigned live = __ballot_sync(0xffffffffu, j < n && rows[j * ROW_W] >= 0.0f);
#pragma unroll 1
      while (live) {
        const int jj = j0 + __ffs(live) - 1;
        live &= live - 1;
        row_dispatch<false, P>(ray, load_row<true>(rows + jj * ROW_W), r0 + jj, c);
      }
    }
    if (ch + B1_STAGES < chunks) {
      __syncthreads();  // every thread is done reading this slot
      fetch(ch + B1_STAGES);
    }
  }
}

// B6 over B2: the clusters the frame's walks can visit, staged once per frame.
// They are the union over the frame's tiles of the clusters whose tile bit is
// set and whose eye distance is within the far plane (the walk visits no
// other). The first FRAME_K of them, in table order, are copied (rows + box,
// 416 bytes each) into `fst`; `map[gc]` is a cluster's slot there, or -1 for a
// cluster the walk then streams through the ring as the tiled launch does.
__device__ __forceinline__ void stage_frame_b2(const Args& A, const Walk& w, Stage& s,
                                               float* fst, short* map, short* slot_gc) {
  const int G = A.num_clusters;
  const int tiles = A.height / TILE_H;
  __syncthreads();  // the previous frame's walks are done with fst and map
  const unsigned* bits = reinterpret_cast<const unsigned*>(A.clbits) +
                         w.ba * tiles * (size_t)A.num_words;
  int total = 0;
  for (int g0 = 0; g0 < G; g0 += NTHREADS) {
    const int gc = g0 + threadIdx.x;
    bool want = false;
    if (gc < G && __ldg(A.cdist + w.ba * G + gc) <= FAR_T + SLACK) {
      unsigned u = 0;
      for (int t = 0; t < tiles; ++t) u |= __ldg(bits + t * A.num_words + (gc >> 5));
      want = (u >> (gc & 31)) & 1u;
    }
    const int k = block_rank(want, total, s.cnt);
    const bool kept = want && k < FRAME_K;
    if (gc < G) map[gc] = kept ? (short)k : (short)-1;
    if (kept) slot_gc[k] = (short)gc;
  }
  __syncthreads();  // slot_gc is complete
  const int n = min(total, FRAME_K);
  if (n > 0) {
    if (threadIdx.x < 32) {
      if (threadIdx.x == 0) bar_expect(s.bars + BAR_FRAME, (uint32_t)n * SLOT_FLOATS * 4);
      __syncwarp();
      for (int k = threadIdx.x; k < n; k += 32) {
        const int gc = slot_gc[k];
        float* dst = fst + k * SLOT_FLOATS;
        bulk_load(dst, w.table + (size_t)gc * CLUSTER_FLOATS, CLUSTER_FLOATS * 4,
                  s.bars + BAR_FRAME);
        bulk_load(dst + CLUSTER_FLOATS, w.ctab + (size_t)gc * BOX_FLOATS, BOX_FLOATS * 4,
                  s.bars + BAR_FRAME);
      }
    }
    bar_wait(s.bars, BAR_FRAME, s.phase);
  }
  s.key = (int)w.ba;
}

// B2: bit-walk over the tile's front-to-back supercluster list.
//
// The tile's walk tables (sclist, scdist, clbits, cdist) are staged in shared
// memory once. A candidate is a member cluster whose tile bit is set and
// whose eye distance is within the depth bound, in list order; the walk ends
// at the sentinel or at the first supercluster beyond the bound (the list is
// ascending). One thread stages the next two candidates' rows and boxes (416
// bytes each) in a ring of B2_SLOTS slots while the block votes on and runs
// the current one. The bound only falls, so a candidate found earlier is
// re-checked when its turn comes; a prefetched cluster that is then skipped
// costs one copy, never a pixel. Before its rows run, the candidate's box is slab-tested
// against every pixel's current depth (box_reachable, __syncthreads_or): a
// cluster no pixel can reach holds no row whose t could beat or tie any
// pixel's best. MERGED (B6): the candidates the frame has staged
// (stage_frame_b2) are read where they lie, without a copy or a wait.
template <int P, bool MERGED>
__device__ __forceinline__ void trace_b2(const Args& A, Walk& w, const Ray (&ray)[P],
                                         Carry (&c)[P], Stage& s) {
  const int G = A.num_clusters;
  const int S = G / SUPER_K;
  float* fst = reinterpret_cast<float*>(s.dyn);
  float* ring = fst + (MERGED ? FRAME_K * SLOT_FLOATS : 0);
  int* sl = reinterpret_cast<int*>(ring + B2_SLOTS * SLOT_FLOATS);
  float* sd = reinterpret_cast<float*>(sl + S);
  unsigned* cw = reinterpret_cast<unsigned*>(sd + S);
  float* cd = reinterpret_cast<float*>(cw + A.num_words);
  short* map = reinterpret_cast<short*>(cd + G);
  if (MERGED && s.key != (int)w.ba) stage_frame_b2(A, w, s, fst, map, map + G);
  // staged slot of cluster gc, or -1: it comes through the ring
  auto staged = [&](int gc) -> int { return MERGED ? (int)map[gc] : -1; };

  __syncthreads();  // a merged launch's previous sub-block is done with all of it
  {
    const int* gsl = A.sclist + w.bat * S;
    const float* gsd = A.scdist + w.bat * S;
    const unsigned* gcw = reinterpret_cast<const unsigned*>(A.clbits) + w.bat * A.num_words;
    const float* gcd = A.cdist + w.ba * G;
    for (int i = threadIdx.x; i < S; i += NTHREADS) {
      sl[i] = __ldg(gsl + i);
      sd[i] = __ldg(gsd + i);
    }
    for (int i = threadIdx.x; i < A.num_words; i += NTHREADS) cw[i] = __ldg(gcw + i);
    for (int i = threadIdx.x; i < G; i += NTHREADS) cd[i] = __ldg(gcd + i);
  }
  __syncthreads();

  // The depth starts at the FAR plane (not +INF): hits at t >= far render as
  // sky either way, and a tile whose rays all miss then has maxt == far
  // instead of an unskippable +INF bound.
#pragma unroll
  for (int p = 0; p < P; ++p) c[p].t = FAR_T;
  // maxt is an upper bound on this block's per-ray depths. cdist/scdist are
  // geometric lower bounds (eye -> cluster AABB distance; ray dirs are unit
  // length) on t of any member hit; SLACK absorbs their rounding, so a skipped
  // cluster's hits satisfy t > maxt >= best strictly: neither a win nor a tie.
  float maxt = FAR_T;

  // Walk positions: list entry * SUPER_K + member. First candidate at or
  // after `q` under the bound `mt`, or -1 when the walk ends first.
  const int end = S * SUPER_K;
  auto next = [&](int q, float mt) -> int {
    for (; q < end; ++q) {
      const int e = q / SUPER_K;
      if (sl[e] >= S || !(sd[e] <= mt + SLACK)) return -1;
      const int gc = sl[e] * SUPER_K + q % SUPER_K;
      if (((cw[gc >> 5] >> (gc & 31)) & 1u) && cd[gc] <= mt + SLACK) return q;
    }
    return -1;
  };
  auto cluster_of = [&](int q) { return sl[q / SUPER_K] * SUPER_K + q % SUPER_K; };
  auto fetch = [&](int q, int slot) {
    const int gc = cluster_of(q);
    if (threadIdx.x == 0 && staged(gc) < 0) {
      float* dst = ring + slot * SLOT_FLOATS;
      bar_expect(s.bars + slot, SLOT_FLOATS * 4);
      bulk_load(dst, w.table + (size_t)gc * CLUSTER_FLOATS, CLUSTER_FLOATS * 4, s.bars + slot);
      bulk_load(dst + CLUSTER_FLOATS, w.ctab + (size_t)gc * BOX_FLOATS, BOX_FLOATS * 4,
                s.bars + slot);
    }
  };

  // Two candidates are always in flight: candidate n sits in slot
  // n % B2_SLOTS and n + 1 in the next; n + 2 is fetched once every thread
  // has voted on n, i.e. is done with n - 1's slot, which it takes. A staged
  // candidate keeps its place in this count but takes no copy and no wait.
  int cur = next(0, maxt);
  int nxt = cur >= 0 ? next(cur + 1, maxt) : -1;
  if (cur >= 0) fetch(cur, 0);
  if (nxt >= 0) fetch(nxt, 1);
  int n = 0;
  int entry_ran = 0;  // the current list entry (supercluster) ran rows
#pragma unroll 1
  while (cur >= 0) {
    const int slot = n % B2_SLOTS;
    const int gc = cluster_of(cur);
    const int k = staged(gc);
    if (k < 0) bar_wait(s.bars, slot, s.phase);
    const int e = cur / SUPER_K;
    if (!(sd[e] <= maxt + SLACK)) {
      // the bound fell below this supercluster since it was found: the walk
      // is over; drain the copy in flight before the slots are reused
      if (nxt >= 0 && staged(cluster_of(nxt)) < 0)
        bar_wait(s.bars, (n + 1) % B2_SLOTS, s.phase);
      break;
    }
    const float* slot_rows = k >= 0 ? fst + k * SLOT_FLOATS : ring + slot * SLOT_FLOATS;
    const Box bx = load_box<true>(slot_rows + CLUSTER_FLOATS);
    const bool want = cd[gc] <= maxt + SLACK;
    const bool vote = __syncthreads_or(want && any_reachable<P>(ray, bx, c));
    const int after = nxt >= 0 ? next(nxt + 1, maxt) : -1;
    if (after >= 0) fetch(after, (n + 2) % B2_SLOTS);
    if (vote) {
      run_cluster<true, P, true>(ray, slot_rows, gc * CLUSTER_K, c);
      count_visit(w, bx);
      entry_ran = 1;
    }
    if (entry_ran && (nxt < 0 || nxt / SUPER_K != e)) {
      // leaving list entry e, which ran rows: refresh the bound (staleness
      // would only delay skips: maxt only ever overestimates the depths)
      maxt = block_max(max_depth<P>(c), s.red);
      entry_ran = 0;
    }
    cur = nxt;
    nxt = after;
    ++n;
  }
}

// The block's vote on a batch of up to 32 boxes: `m` holds this thread's bits
// (box j reachable by one of its rays), the result the OR over the block, in
// every thread. One warp reduction and one barrier. Two sets of vote words,
// picked by the count `votes` of the caller: the next vote writes the other
// set, and the one after it follows a barrier that every reader of this one
// passed.
__device__ __forceinline__ unsigned block_or(unsigned m, Stage& s, int& votes) {
  m = __reduce_or_sync(0xffffffffu, m);
  unsigned* vw = s.votes + (votes & 1) * NWARPS;
  ++votes;
  if ((threadIdx.x & 31) == 0) vw[threadIdx.x >> 5] = m;
  __syncthreads();
  m = 0;
#pragma unroll
  for (int k = 0; k < NWARPS; ++k) m |= vw[k];
  return m;
}

// B3: clustered, in table order, strict carry from +INF (a skipped row could
// at best tie, and in table order a tie keeps the earlier row).
//
// The env's cluster boxes are staged in shared memory by one bulk copy (in
// chunks of BOX_CHUNK; a merged launch keeps them across the frame's
// sub-blocks) and listed once: dead boxes (low corner at +INF) never enter
// the list, so they cost no test and no barrier. The live list is voted on
// B3_BATCH clusters at a time: every thread slab-tests its pixels against the
// batch's boxes at its current depths, which gives one bit per cluster, and
// the block ORs the masks (a warp reduction, one word per warp, one barrier).
// Depths only fall, so a vote taken at the batch's start passes every cluster
// a later vote would pass; a cluster no pixel can reach holds no row that
// beats or ties any pixel's best. The rows of the clusters that passed are
// bulk-copied together (384 bytes each) and run in table order; before each
// runs, its box is voted on again at the depths of that moment
// (__syncthreads_or), which drops the clusters that an earlier one of the
// batch has since hidden.
template <int P>
__device__ __forceinline__ void trace_b3(const Args& A, Walk& w, int env, const Ray (&ray)[P],
                                         Carry (&c)[P], Stage& s) {
  const int G = A.num_clusters;
  const int cap = min(G, BOX_CHUNK);
  float* boxes = reinterpret_cast<float*>(s.dyn);
  float* ring = boxes + cap * BOX_FLOATS;
  int* live = reinterpret_cast<int*>(ring + B3_BATCH * CLUSTER_FLOATS);
  const int chunks = (G + BOX_CHUNK - 1) / BOX_CHUNK;
#pragma unroll
  for (int p = 0; p < P; ++p) c[p].t = INF_T;
  int votes = 0;
#pragma unroll 1
  for (int ch = 0; ch < chunks; ++ch) {
    const int g0 = ch * BOX_CHUNK;
    const int key = env * chunks + ch;
    if (s.key != key) {
      const int n = min(BOX_CHUNK, G - g0);
      __syncthreads();  // every thread is done with the boxes and list held so far
      if (threadIdx.x == 0) {
        bar_expect(s.bars + BAR_BOXES, (uint32_t)n * BOX_FLOATS * 4);
        bulk_load(boxes, w.ctab + (size_t)g0 * BOX_FLOATS, (uint32_t)n * BOX_FLOATS * 4,
                  s.bars + BAR_BOXES);
      }
      bar_wait(s.bars, BAR_BOXES, s.phase);
      int total = 0;
      for (int i0 = 0; i0 < n; i0 += NTHREADS) {
        const int i = i0 + threadIdx.x;
        const bool lv = i < n && boxes[i * BOX_FLOATS] < 1e29f;
        const int k = block_rank(lv, total, s.cnt);
        if (lv) live[k] = i;
      }
      __syncthreads();  // the list is complete
      s.key = key;
      s.nlive = total;
    }
#pragma unroll 1
    for (int base = 0; base < s.nlive; base += B3_BATCH) {
      const int nb = min(B3_BATCH, s.nlive - base);
      unsigned m = 0;
#pragma unroll 1
      for (int j = 0; j < nb; ++j) {
        const Box bx = load_box<true>(boxes + live[base + j] * BOX_FLOATS);
        if (any_reachable<P>(ray, bx, c)) m |= 1u << j;
      }
      m = block_or(m, s, votes);
      if (m == 0) continue;
      // the ring's slot j takes the batch's cluster j; every thread is done
      // with the previous batch's rows (it has passed the barrier above)
      if (threadIdx.x == 0) {
        bar_expect(s.bars + BAR_ROWS, (uint32_t)__popc(m) * CLUSTER_FLOATS * 4);
        for (unsigned r = m; r; r &= r - 1) {
          const int j = __ffs(r) - 1;
          bulk_load(ring + j * CLUSTER_FLOATS,
                    w.table + (size_t)(g0 + live[base + j]) * CLUSTER_FLOATS,
                    CLUSTER_FLOATS * 4, s.bars + BAR_ROWS);
        }
      }
      bar_wait(s.bars, BAR_ROWS, s.phase);
#pragma unroll 1
      while (m) {
        const int j = __ffs(m) - 1;
        m &= m - 1;
        const int gl = live[base + j];
        const Box bx = load_box<true>(boxes + gl * BOX_FLOATS);
        if (!__syncthreads_or(any_reachable<P>(ray, bx, c))) continue;
        run_cluster<false, P, true>(ray, ring + j * CLUSTER_FLOATS, (g0 + gl) * CLUSTER_K, c);
        count_visit(w, bx);
      }
    }
  }
}

// Position of the (n + 1)-th lowest set bit of m.
__device__ __forceinline__ int nth_bit(unsigned m, int n) {
  for (; n > 0; --n) m &= m - 1;
  return __ffs(m) - 1;
}

// The rows of one cluster (from shared memory) under the tie-break rule of
// row_dispatch<true>, at the cost of the strict carry. Clusters do not share
// rows, so the rows of this one are either all below the index of a pixel's
// best row or all above it. Below: a tie wins, i.e. `t <= best`, which is
// `t < best'` for best' the next float above best (best is positive and
// finite: FAR_T, INF_T or a hit). Above: a tie loses, the strict rule. After
// a row of this cluster has won, the later ones lie above it: strict again,
// as the strict carry does by itself. If no row won, best' goes back to best.
template <int P>
__device__ __forceinline__ void run_cluster_tie(const Ray (&r)[P], const float* rows, int base,
                                                Carry (&c)[P]) {
  float t0[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    t0[p] = c[p].t;
    if (base < c[p].idx) c[p].t = __int_as_float(__float_as_int(t0[p]) + 1);
  }
  run_cluster<false, P, true>(r, rows, base, c);
#pragma unroll
  for (int p = 0; p < P; ++p)
    if ((unsigned)(c[p].idx - base) >= (unsigned)CLUSTER_K) c[p].t = t0[p];
}

// B4 and B5: the rows of the clusters the block's vote passed (`all`),
// together, then, in each warp, those its own pixels passed (`mine`), in bit
// order. Bit j stands for cluster gc_of(j), its box at box_of(j). One thread
// bulk-copies each cluster of `all` (8 rows, 384 bytes) into ring slot j on
// one phase of BAR_ROWS and the block waits once. A warp then decides alone:
// the rows lie in shared memory, so a warp whose pixels cannot reach a
// cluster skips it without a barrier. Before a cluster runs, the warp votes
// on its box again at the depths of that moment (__any_sync), which drops
// what an earlier one has since hidden; its first needs no re-vote, since no
// row has run in the warp after the vote that passed it. The carry breaks
// ties towards the lowest row index (run_cluster_tie), so the list's order
// does not change the image. The ring is rewritten only after the next
// vote's barrier, which every reader of this one passes first; what gc_of
// and box_of read must be kept until a barrier after this call.
template <int P, class GcOf, class BoxOf>
__device__ __forceinline__ void run_voted(Walk& w, const Ray (&ray)[P], Carry (&c)[P], Stage& s,
                                          float* ring, unsigned all, unsigned mine, GcOf gc_of,
                                          BoxOf box_of) {
  if (threadIdx.x == 0) {
    bar_expect(s.bars + BAR_ROWS, (uint32_t)__popc(all) * CLUSTER_FLOATS * 4);
    for (unsigned r = all; r; r &= r - 1) {
      const int j = __ffs(r) - 1;
      bulk_load(ring + j * CLUSTER_FLOATS, w.table + (size_t)gc_of(j) * CLUSTER_FLOATS,
                CLUSTER_FLOATS * 4, s.bars + BAR_ROWS);
    }
  }
  bar_wait(s.bars, BAR_ROWS, s.phase);
  bool ran = false;
#pragma unroll 1
  while (mine) {
    const int j = __ffs(mine) - 1;
    mine &= mine - 1;
    const Box bx = load_box<true>(box_of(j));
    if (ran && !__any_sync(0xffffffffu, any_reachable<P>(ray, bx, c))) continue;
    run_cluster_tie<P>(ray, ring + j * CLUSTER_FLOATS, gc_of(j) * CLUSTER_K, c);
    count_visit(w, bx);
    ran = true;
  }
}

// Copy a box into the list batch in shared memory, from the global table or
// (SHARED) from the env's staged one; false for a dead box (low corner at
// +INF), which is then never voted on.
template <bool SHARED>
__device__ __forceinline__ bool stage_box(float* dst, const float* src) {
  const float4* q = reinterpret_cast<const float4*>(src);
  float4 x, y;
  if (SHARED) {
    x = q[0]; y = q[1];
  } else {
    x = __ldg(q); y = __ldg(q + 1);
  }
  float4* d = reinterpret_cast<float4*>(dst);
  d[0] = x;
  d[1] = y;
  return x.x < 1e29f;
}

// B6 over B5: what a frame shares is its env's box tables. The G cluster
// boxes, then the G / SUPER_K supercluster boxes, are staged at `envb` once
// per env, when G <= BOX_CHUNK, so that a batch's staging reads only its
// list entries from global memory (over B4 this read slower: PERF.md, B4 and B5).
// Returns whether they are staged.
__device__ __forceinline__ bool stage_env_boxes(const Args& A, int env, Stage& s, float* envb,
                                                const float* ctab, const float* sctab) {
  const int G = A.num_clusters;
  if (G > BOX_CHUNK) return false;
  if (s.key != env) {
    __syncthreads();  // every thread is done with the boxes held so far
    if (threadIdx.x == 0) {
      const uint32_t cb = (uint32_t)G * BOX_FLOATS * 4;
      const uint32_t sb = (uint32_t)(G / SUPER_K) * BOX_FLOATS * 4;
      bar_expect(s.bars + BAR_BOXES, cb + sb);
      bulk_load(envb, ctab, cb, s.bars + BAR_BOXES);
      bulk_load(envb + G * BOX_FLOATS, sctab, sb, s.bars + BAR_BOXES);
    }
    bar_wait(s.bars, BAR_BOXES, s.phase);
    s.key = env;
  }
  return true;
}

// B4: B3 through a list (`order`, per agent or per tile). The list may be ANY
// permutation of the clusters, so the carry breaks ties towards the lowest
// row index. It is walked B3_BATCH entries at a time. Warp 0 stages a batch:
// each lane reads one entry (`order`, and `dist` where given) and, for a
// cluster that owns rows and whose box is live, copies the box into shared
// memory; no other entry is voted on, so padding and dead clusters cost no
// test and no barrier. Each thread slab-tests its pixels against the staged
// boxes at its current depths; the warp's OR says what the warp may run, the
// block's (block_or, one barrier) what is copied (run_voted). With `dist`,
// ascending lower bounds on the hit distance of the listed clusters, the
// depth starts at the far plane and the walk ends at the first entry beyond
// the block's largest depth `maxt`: a batch is cut there, at the `maxt` of
// the batch's start (one block reduction after each batch that copied rows;
// an older, larger `maxt` only keeps more entries, and the vote drops what
// no pixel reaches), and a batch that was cut is the last. Without `dist` the
// depth starts at +INF and the whole list is walked.
template <int P>
__device__ __forceinline__ void trace_b4(const Args& A, Walk& w, const Ray (&ray)[P],
                                         Carry (&c)[P], Stage& s) {
  float* ring = reinterpret_cast<float*>(s.dyn);
  float* boxes = ring + B3_BATCH * CLUSTER_FLOATS;
  int* gcs = reinterpret_cast<int*>(boxes + B3_BATCH * BOX_FLOATS);
  // two pairs (candidates, cut), one per batch parity: a thread reads its
  // batch's pair right after the staging barrier, and warp 0 rewrites it only
  // after the next batch's staging barrier
  unsigned* meta = reinterpret_cast<unsigned*>(gcs + B3_BATCH);
  const size_t list = (A.per_tile ? w.bat : w.ba) * (size_t)A.list_len;
  const int* ord = A.order + list;
  const float* dst = A.dist ? A.dist + list : nullptr;
#pragma unroll
  for (int p = 0; p < P; ++p) c[p].t = dst ? FAR_T : INF_T;
  float maxt = FAR_T;
  int votes = 0;
#pragma unroll 1
  for (int base = 0, n = 0; base < A.list_len; base += B3_BATCH, ++n) {
    unsigned* mt = meta + (n & 1) * 2;
    if (threadIdx.x < 32) {
      const int j = threadIdx.x, g = base + j;
      const bool in = g < A.list_len;
      const int gc = in ? __ldg(ord + g) : -1;
      const bool within = in && (dst == nullptr || maxt >= __ldg(dst + g));
      const unsigned beyond = __ballot_sync(0xffffffffu, !within);
      const int cut = beyond ? __ffs(beyond) - 1 : B3_BATCH;
      bool ok = j < cut && cluster_has_rows(gc, A.num_prims);
      if (ok) {
        ok = stage_box<false>(boxes + j * BOX_FLOATS, w.ctab + (size_t)gc * BOX_FLOATS);
        gcs[j] = gc;
      }
      const unsigned cand = __ballot_sync(0xffffffffu, ok);
      if (j == 0) {
        mt[0] = cand;
        mt[1] = (unsigned)cut;
      }
    }
    __syncthreads();
    const unsigned cand = mt[0];
    const int cut = (int)mt[1];
    unsigned all = 0;
    if (cand) {
      unsigned m = 0;
#pragma unroll 1
      for (unsigned r = cand; r; r &= r - 1) {
        const int j = __ffs(r) - 1;
        if (any_reachable<P>(ray, load_box<true>(boxes + j * BOX_FLOATS), c)) m |= 1u << j;
      }
      const unsigned mine = __reduce_or_sync(0xffffffffu, m);
      all = block_or(mine, s, votes);
      if (all)
        run_voted<P>(w, ray, c, s, ring, all, mine, [&](int j) { return gcs[j]; },
                     [&](int j) { return boxes + j * BOX_FLOATS; });
    }
    if (cut < B3_BATCH) break;  // an entry beyond the bound, or the list's end
    // the next staging rewrites boxes and gcs: a barrier after the last reader
    if (all) {
      if (dst) maxt = block_max(max_depth<P>(c), s.red);
      else __syncthreads();
    }
  }
}

// B5: two levels. The tile's list is over superclusters (SUPER_K clusters
// each) and ends early as B4's does, on the supercluster bounds `dist`. A
// batch of B3_BATCH entries is staged by five warps at once: warp 0 reads the
// entries and copies the boxes of the listed superclusters in range, warps
// 1-4 the boxes of their members (lane l: member l % 4 of entry
// 8 (warp - 1) + l / 4); a dead box, a supercluster out of range or a member
// without rows is never voted on. The block votes on the batch's
// superclusters, takes the passing ones in list order 8 at a time, votes on
// their (up to 32) members at the depths of that moment, and runs what passed
// (run_voted). A warp tests only the members of the superclusters it passed
// itself: a member's box lies inside its supercluster's, so a ray that
// cannot reach the one cannot reach the other. Superclusters and members
// share the tie-break carry.
template <int P, bool MERGED>
__device__ __forceinline__ void trace_b5(const Args& A, Walk& w, int env, const Ray (&ray)[P],
                                         Carry (&c)[P], Stage& s) {
  const int num_super = A.num_clusters / SUPER_K;
  const float* sctab = A.sclusters + (size_t)env * num_super * BOX_FLOATS;
  float* ring = reinterpret_cast<float*>(s.dyn);
  float* sboxes = ring + B3_BATCH * CLUSTER_FLOATS;
  float* mboxes = sboxes + B3_BATCH * BOX_FLOATS;   // member j of entry k at SUPER_K k + j
  int* gscs = reinterpret_cast<int*>(mboxes + SUPER_K * B3_BATCH * BOX_FLOATS);
  // per batch parity (as B4's): candidates, cut, and 4 words of member bits
  // (word v, bit SUPER_K (k - 8 v) + j: member j of entry k can be voted on)
  unsigned* meta = reinterpret_cast<unsigned*>(gscs + B3_BATCH);
  float* envb = reinterpret_cast<float*>(meta + 2 * (2 + SUPER_K));  // clusters, superclusters
  const bool env_boxes = MERGED && stage_env_boxes(A, env, s, envb, w.ctab, sctab);
  const float* env_sc = envb + A.num_clusters * BOX_FLOATS;
  const size_t list = (A.per_tile ? w.bat : w.ba) * (size_t)A.list_len;
  const int* ord = A.order + list;
  const float* dst = A.dist + list;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int p = 0; p < P; ++p) c[p].t = FAR_T;
  float maxt = FAR_T;
  int votes = 0;
#pragma unroll 1
  for (int base = 0, n = 0; base < A.list_len; base += B3_BATCH, ++n) {
    unsigned* mt = meta + (n & 1) * (2 + SUPER_K);
    if (warp <= SUPER_K) {
      const int k = warp == 0 ? lane : 8 * (warp - 1) + lane / SUPER_K;
      const int g = base + k;
      const bool in = g < A.list_len;
      const int gsc = in ? __ldg(ord + g) : -1;
      const bool within = in && maxt >= __ldg(dst + g);
      const bool listed = within && gsc >= 0 && gsc < num_super;
      if (warp == 0) {
        const unsigned beyond = __ballot_sync(0xffffffffu, !within);
        const int cut = beyond ? __ffs(beyond) - 1 : B3_BATCH;
        bool ok = lane < cut && listed;
        if (ok) {
          ok = env_boxes ? stage_box<true>(sboxes + lane * BOX_FLOATS, env_sc + gsc * BOX_FLOATS)
                         : stage_box<false>(sboxes + lane * BOX_FLOATS,
                                            sctab + (size_t)gsc * BOX_FLOATS);
          gscs[lane] = gsc;
        }
        const unsigned cand = __ballot_sync(0xffffffffu, ok);
        if (lane == 0) {
          mt[0] = cand;
          mt[1] = (unsigned)cut;
        }
      } else {
        const int j = lane % SUPER_K;
        const int gc = gsc * SUPER_K + j;
        float* mb = mboxes + (SUPER_K * k + j) * BOX_FLOATS;
        const bool ok = listed && cluster_has_rows(gc, A.num_prims) &&
                        (env_boxes ? stage_box<true>(mb, envb + gc * BOX_FLOATS)
                                   : stage_box<false>(mb, w.ctab + (size_t)gc * BOX_FLOATS));
        const unsigned bits = __ballot_sync(0xffffffffu, ok);
        if (lane == 0) mt[1 + warp] = bits;
      }
    }
    __syncthreads();
    const unsigned cand = mt[0];
    const int cut = (int)mt[1];
    bool copied = false;
    if (cand) {
      unsigned msc = 0;
#pragma unroll 1
      for (unsigned r = cand; r; r &= r - 1) {
        const int k = __ffs(r) - 1;
        if (any_reachable<P>(ray, load_box<true>(sboxes + k * BOX_FLOATS), c)) msc |= 1u << k;
      }
      const unsigned sc_mine = __reduce_or_sync(0xffffffffu, msc);
      unsigned sc_all = block_or(sc_mine, s, votes);
#pragma unroll 1
      while (sc_all) {
        // the next (up to) 8 passing superclusters in list order; bit
        // SUPER_K i + j of the member vote is member j of the i-th of them
        unsigned gm = 0;
        for (int i = 0; i < 8 && sc_all; ++i) {
          gm |= sc_all & (0u - sc_all);
          sc_all &= sc_all - 1;
        }
        unsigned m = 0;
        int i = 0;
#pragma unroll 1
        for (unsigned r = gm; r; r &= r - 1, ++i) {
          const int k = __ffs(r) - 1;
          if (!((sc_mine >> k) & 1u)) continue;
          const unsigned mem = (mt[2 + (k >> 3)] >> (SUPER_K * (k & 7))) & 0xFu;
          for (unsigned q = mem; q; q &= q - 1) {
            const int j = __ffs(q) - 1;
            if (any_reachable<P>(ray, load_box<true>(mboxes + (SUPER_K * k + j) * BOX_FLOATS), c))
              m |= 1u << (SUPER_K * i + j);
          }
        }
        const unsigned mine = __reduce_or_sync(0xffffffffu, m);
        const unsigned all = block_or(mine, s, votes);
        if (all) {
          run_voted<P>(
              w, ray, c, s, ring, all, mine,
              [&](int b) { return gscs[nth_bit(gm, b / SUPER_K)] * SUPER_K + b % SUPER_K; },
              [&](int b) {
                return mboxes + (SUPER_K * nth_bit(gm, b / SUPER_K) + b % SUPER_K) * BOX_FLOATS;
              });
          copied = true;
        }
      }
    }
    if (cut < B3_BATCH) break;  // an entry beyond the bound, or the list's end
    // one barrier after the last reader of the staged batch, as in B4
    if (copied) maxt = block_max(max_depth<P>(c), s.red);
  }
}

// Pixels per thread of each form. B1-B3 share a row read from shared memory
// and the walk's control between two rays; one or four read slower on the
// card (PERF.md, "Launch shapes"). B4 and B5 run a cluster per warp, and a
// warp of 32 x 1 pixels skips more clusters than one of 32 x 2: one pixel
// reads faster there (PERF.md, "Launch shapes" of B4 and B5).
template <int FORM>
__host__ __device__ constexpr int pixels_per_thread() {
  return FORM == FORM_B4 || FORM == FORM_B5 ? 1 : 2;
}

// Pixel rows of one block: LANES * P. P = 1 gives the 2-row sub-blocks of
// four blocks per tile, P = 2 two blocks per tile.
template <int P>
__host__ __device__ constexpr int subs_per_tile() {
  static_assert(TILE_H % (LANES * P) == 0, "a tile holds whole sub-blocks");
  return TILE_H / (LANES * P);
}

// Tiles of 8 x 128 pixels down and across a frame: ceil(H / 8) x ceil(W / 128).
// B2-B5 take H % 8 == 0 and W == 128 (their cull tables are per tile of a
// 128-wide view), so a frame is one column of tiles there, and their code
// keeps the width a constant (`any_size<FORM>`): only B1 pays for the
// column offset and the edge test.
__host__ __device__ inline int tiles_down(const Args& A) { return (A.height + TILE_H - 1) / TILE_H; }
__host__ __device__ inline int tiles_across(const Args& A) { return (A.width + TILE_W - 1) / TILE_W; }

template <int FORM>
__host__ __device__ constexpr bool any_size() { return FORM == FORM_B1; }

template <int P>
__host__ __device__ inline int subs_per_frame(const Args& A) {
  return tiles_down(A) * tiles_across(A) * subs_per_tile<P>();
}

// Sub-block `sub` (tile-major: tile rows, then the tiles across one) of frame
// `frame` (env * A + agent): its rays, the form's traversal, the epilogue.
template <int FORM, bool MERGED>
__device__ __forceinline__ void render_sub(const Args& A, Stage& s, int frame, int sub) {
  constexpr int P = pixels_per_thread<FORM>();
  constexpr int SUBS = subs_per_tile<P>();
  constexpr bool ANY_SIZE = any_size<FORM>();
  const int tiles = tiles_down(A);
  const int across = ANY_SIZE ? tiles_across(A) : 1;
  const int width = ANY_SIZE ? A.width : TILE_W;
  const int tile = sub / SUBS / across;
  const int x0 = ANY_SIZE ? (sub / SUBS % across) * TILE_W : 0;
  const int part = sub % SUBS;
  const int a = frame % A.num_agents;
  const int b = frame / A.num_agents;
  Walk w;
  w.ba = (size_t)frame;
  w.bat = w.ba * tiles + tile;
  w.table = A.prims + (size_t)b * A.num_prims * ROW_W;
  w.ctab = A.clusters + (size_t)b * A.num_clusters * BOX_FLOATS;
  w.ran_aabb = w.ran_other = 0;
  const float* cam = A.cams + w.ba * 8;
  const Cam camk = load_cam(cam);
  const int y0 = tile * TILE_H + part * LANES * P + (threadIdx.x >> 7);

  Pixel px[P];
  Ray ray[P];
  Carry c[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    px[p] = make_pixel(b, a, x0, y0 + LANES * p, A.height, width);
    ray[p] = make_ray(px[p], camk, A.kc);
    c[p].idx = A.num_prims;
    c[p].nx = c[p].ny = c[p].nz = 0.0f;
    c[p].code = CODE_DIRECT;
    c[p].c = 0.0f;
  }
  if constexpr (FORM == FORM_B1) trace_b1<P>(A, w, ray, c, s);
  else if constexpr (FORM == FORM_B2) trace_b2<P, MERGED>(A, w, ray, c, s);
  else if constexpr (FORM == FORM_B3) trace_b3<P>(A, w, b, ray, c, s);
  else if constexpr (FORM == FORM_B4) trace_b4<P>(A, w, ray, c, s);
  else trace_b5<P, MERGED>(A, w, b, ray, c, s);

#pragma unroll
  for (int p = 0; p < P; ++p)
    epilogue<ANY_SIZE>(px[p], ray[p], c[p], cam, A.kc, A.ui_indicators, A.height, width,
                       A.num_agents, A.out);
  // Optional measurement output (zeroed by the caller): per pixel row, the
  // clusters whose rows ran, summed over the row's segments of 32 pixels (one
  // warp's columns; VISIT_SEGMENTS per tile). B4 and B5 decide per warp, the
  // other forms per sub-block; a row wider than one tile (B1 at any size)
  // sums its tiles, hence the atomics there too.
  if (A.visits != nullptr) {
    if constexpr (FORM == FORM_B4 || FORM == FORM_B5) {
      if ((threadIdx.x & 31) == 0) {
        for (int p = 0; p < P; ++p) {
          const size_t o = 2 * (w.ba * A.height + y0 + LANES * p);
          atomicAdd(A.visits + o + 0, w.ran_aabb);
          atomicAdd(A.visits + o + 1, w.ran_other);
        }
      }
    } else if (threadIdx.x == 0) {
      const int ytop = tile * TILE_H + part * LANES * P;
      for (int r = 0; r < LANES * P && (!ANY_SIZE || ytop + r < A.height); ++r) {
        const size_t o = 2 * (w.ba * A.height + ytop + r);
        atomicAdd(A.visits + o + 0, w.ran_aabb * VISIT_SEGMENTS);
        atomicAdd(A.visits + o + 1, w.ran_other * VISIT_SEGMENTS);
      }
    }
  }
}

// Thread 0 takes the next ticket of counter `ctr` and hands it to the block.
__device__ __forceinline__ int claim(int* ctr, int* bcast) {
  __syncthreads();  // every thread has read the previous ticket
  if (threadIdx.x == 0) *bcast = atomicAdd(ctr, 1);
  __syncthreads();
  return *bcast;
}

// The highest frame whose sub-blocks are not all taken yet, or -1.
__device__ __forceinline__ int find_open(const Args& A, int per_frame, Stage& s) {
  for (int hi = A.num_frames - 1; hi >= 0; hi -= NTHREADS) {
    const int f = hi - (int)threadIdx.x;
    const bool open = f >= 0 && __ldcg(A.work + 1 + f) < per_frame;
    const float m = block_max(open ? (float)f : -1.0f, s.red);
    if (m >= 0.0f) return (int)m;
  }
  return -1;
}

// One kernel for every form. Tiled launch (MERGED = false): one block per
// sub-block, grid B * A * T * subs. Merged launch (B6): a grid of resident
// blocks takes whole frames from a queue (work[0]) and, within a frame, its
// sub-blocks in order from the frame's counter (work[1 + frame]); per-frame
// staging (B2: the frame's clusters; B3, B5: the env's boxes) serves all of
// them. A block that finds the queue empty joins the latest frame that still
// has sub-blocks to take, so the launch ends within about one sub-block of
// its last frame instead of one frame.
// Registers per thread grow with P: 4 blocks of 256 threads per SM at P = 1,
// 3 at P = 2.
template <int FORM, bool MERGED>
__global__ void __launch_bounds__(NTHREADS, pixels_per_thread<FORM>() == 1 ? 4 : 3)
render_kernel(const __grid_constant__ Args A) {
  constexpr int P = pixels_per_thread<FORM>();
  extern __shared__ __align__(16) unsigned char dyn[];
  __shared__ float red[NWARPS];
  __shared__ int cnt[NWARPS];
  __shared__ unsigned votes[2 * NWARPS];
  __shared__ int bcast;
  __shared__ __align__(8) uint64_t bars[NBARS];
  const int per_frame = subs_per_frame<P>(A);
  Stage s{dyn, bars, red, cnt, votes, &bcast, 0u, -1, 0};
  if (threadIdx.x == 0) {
    for (int i = 0; i < NBARS; ++i) bar_init(bars + i);
    bar_init_fence();
  }
  __syncthreads();
  if constexpr (!MERGED) {
    render_sub<FORM, false>(A, s, blockIdx.x / per_frame, blockIdx.x % per_frame);
  } else {
    int frame = -1;
#pragma unroll 1
    for (;;) {
      const int sub = frame >= 0 ? claim(A.work + 1 + frame, s.bcast) : per_frame;
      if (sub < per_frame) {
        render_sub<FORM, true>(A, s, frame, sub);
        continue;
      }
      frame = claim(A.work, s.bcast);
      if (frame >= A.num_frames) frame = find_open(A, per_frame, s);
      if (frame < 0) break;
    }
  }
}

// Dynamic shared memory of a form's launch.
size_t smem_bytes(int form, int merged, int num_clusters, int num_words) {
  const size_t g = (size_t)num_clusters;
  switch (form) {
    case FORM_B1: return (size_t)B1_STAGES * B1_CHUNK * ROW_W * 4;
    case FORM_B2: {
      const size_t walk = 2 * (g / SUPER_K) + num_words + g;
      const size_t frame = merged ? (size_t)FRAME_K * SLOT_FLOATS * 4 + (g + FRAME_K) * 2 : 0;
      return ((size_t)B2_SLOTS * SLOT_FLOATS + walk) * 4 + frame;
    }
    case FORM_B3: {
      const size_t cap = g < (size_t)BOX_CHUNK ? g : (size_t)BOX_CHUNK;
      return (cap * BOX_FLOATS + (size_t)B3_BATCH * CLUSTER_FLOATS + cap) * 4;
    }
    // ring, batch boxes, cluster ids, two sets of batch words (trace_b4)
    case FORM_B4: return ((size_t)B3_BATCH * (CLUSTER_FLOATS + BOX_FLOATS + 1) + 2 * 2) * 4;
    // ring, supercluster and member boxes, supercluster ids, batch words
    // (trace_b5); merged, the env's cluster and supercluster boxes
    case FORM_B5:
      return ((size_t)B3_BATCH * (CLUSTER_FLOATS + (1 + SUPER_K) * BOX_FLOATS + 1) +
              2 * (2 + SUPER_K) +
              (merged && g <= (size_t)BOX_CHUNK ? (g + g / SUPER_K) * BOX_FLOATS : 0)) * 4;
    default: return 0;
  }
}

template <int FORM>
int launch(const Args& A, int merged, size_t smem, cudaStream_t stream) {
  constexpr int P = pixels_per_thread<FORM>();
  if (A.num_frames <= 0) return (int)cudaGetLastError();
  void (*kern)(const Args) =
      merged ? render_kernel<FORM, true> : render_kernel<FORM, false>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  int grid = A.num_frames * subs_per_frame<P>(A);
  if (merged) {
    // as many blocks as the card holds at once, at most one per frame
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, NTHREADS, smem);
    if (e != cudaSuccess) return (int)e;
    grid = min(A.num_frames, max(1, sms * per_sm));
  }
  kern<<<grid, NTHREADS, smem, stream>>>(A);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch form `form` (1..5 = B1..B5) of the renderer, tiled or (merged != 0)
// as form B6. Every pointer is a device pointer; those a form does not read
// may be null, and so may `dist` (B4 without early exit) and `visits`.
// `work` (merged launches only) holds B * A + 1 zeros. The output is
// [B, A, height, width]: B1 takes any size, B2-B5 need height % 8 == 0 and
// width == 128 (the wrapper checks). Returns
// cudaGetLastError() after the launch (0 = accepted, -1 = unknown form); the
// launch runs asynchronously on `stream`.
int mv_render(int form, int merged, const float* cams, const float* prims,
              const float* clusters, const float* sclusters, const int* order,
              const float* dist, const int* sclist, const int* clbits,
              const float* scdist, const float* cdist, const float* kc,
              int* out, int* visits, int* work, int batch, int num_agents, int height,
              int width, int num_prims, int num_clusters, int num_words, int list_len,
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
  A.work = work;
  A.num_frames = batch * num_agents;
  A.num_agents = num_agents;
  A.height = height;
  A.width = width;
  A.num_prims = num_prims;
  A.num_clusters = num_clusters;
  A.num_words = num_words;
  A.list_len = list_len;
  A.per_tile = per_tile;
  A.ui_indicators = ui_indicators;
  if (merged && work == nullptr) return -1;
  const size_t smem = smem_bytes(form, merged, num_clusters, num_words);
  switch (form) {
    case FORM_B1: return launch<FORM_B1>(A, merged, smem, stream);
    case FORM_B2: return launch<FORM_B2>(A, merged, smem, stream);
    case FORM_B3: return launch<FORM_B3>(A, merged, smem, stream);
    case FORM_B4: return launch<FORM_B4>(A, merged, smem, stream);
    case FORM_B5: return launch<FORM_B5>(A, merged, smem, stream);
    default: return -1;
  }
}

int mv_render_const_count() { return K_COUNT; }

}  // extern "C"
