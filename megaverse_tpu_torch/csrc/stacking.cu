// Object stacking: scenarios/components.py's object_stacking_step (pick up,
// place and carry movable props with Interact) in one launch
// (ops/stacking.py).
//
// Replaces no TPU kernel: the reference runs the component as plain JAX that
// XLA fuses (megaverse_tpu/scenarios/components.py). In eager PyTorch one
// pass of it is some 945 small kernels (the voxel gathers, the 16-step
// gravity settle, the scatters), and a tick runs one pass per agent, in
// agent order, because the reference's per-agent loop lets agent a see what
// agents 0..a-1 changed (component_object_stacking.hpp:59-167). Here one
// thread runs one env's passes straight through: in pass a only agent a
// interacts, so the plain code's conflict rules (lowest index wins) have
// nothing to decide. What bounds it is latency: a handful of dependent
// reads of the prop table, the object grid and the packed columns per pass.
//
// A block holds ENVS envs. Its threads first copy those envs' prop rows
// (pos, scale, flags) and carried indices into the outputs, which the plain
// code returns as new tensors; then one thread per env works on its own
// rows of the outputs and on its own rows of `vobj` and `cols`, which it
// updates in place, as ops/grid.set_voxel and update_cols do. A thread
// reads back what it wrote, so those reads take the coherent path.
//
// Exactness: every float32 operation of the plain code is kept, in its
// order (no FMA contraction: -fmad=false; no fast-math). Python scalars
// enter as the float32 values PyTorch casts them to (`Consts`, computed on
// the host), and `tensor / python_scalar`, which PyTorch on CUDA runs as a
// multiply by the scalar's reciprocal (taken in double, rounded to float32),
// is that multiply here (`inv_vs`, `inv_carry_scale`). Integer coordinates
// wrap as int32 tensors do.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define ENVS 32            // envs a block works on (one warp)
#define THREADS 256        // threads a block copies with
#define MAX_DROP 32        // the longest gravity settle the kernel takes
#define ACTION_INTERACT (1 << 8)
#define PROP_FLAG_SOLID 1

// Field order and types mirror ops/stacking.py's `Consts` (checked through
// mv_stacking_consts_size).
struct Consts {
  // object grid [B, X, NY, Z]; packed solid columns [B, X, NW, Z]
  int X, NY, NW, Z;
  int max_drop;             // the gravity settle's bound (max_drop_scan)
  float origin_x, origin_y, origin_z;
  float vs, inv_vs;         // voxel size and its reciprocal
  float body_y;             // AGENT_BODY_OFFSET_Y
  float camera_y;           // AGENT_BODY_OFFSET_Y + AGENT_CAMERA_OFFSET_Y
  float pick_x, pick_y, pick_z;     // the pickup spot, camera-local
  float carry_x, carry_y, carry_z;  // the carry anchor, camera-local
  float carry_scale, inv_carry_scale;
};

struct Grid {      // one env's object grid and packed columns
  int16_t* vobj;
  int* cols;
};

__device__ __forceinline__ int wrap_add(int a, int b) {   // int32 tensor addition
  return (int)((unsigned)a + (unsigned)b);
}

__device__ __forceinline__ bool in_grid(int x, int y, int z, const Consts& c) {
  return x >= 0 && x < c.X && y >= 0 && y < c.NY && z >= 0 && z < c.Z;
}

// grid.world_to_voxel along one axis
__device__ __forceinline__ int to_voxel(float w, float origin, const Consts& c) {
  return (int)floorf((w - origin) * c.inv_vs);
}

// grid.gather_voxel: the object slot (prop index + 1) of a cell; out of the grid: 0
__device__ __forceinline__ int vobj_at(const Grid& g, int x, int y, int z, const Consts& c) {
  if (!in_grid(x, y, z, c)) return 0;
  return g.vobj[((long long)x * c.NY + y) * c.Z + z];
}

// grid.solid_from_cols: the SOLID bit of a cell; out of the grid: false
__device__ __forceinline__ bool solid_at(const Grid& g, int x, int y, int z, const Consts& c) {
  if (!in_grid(x, y, z, c)) return false;
  const unsigned w = (unsigned)g.cols[((long long)x * c.NW + (y >> 5)) * c.Z + z];
  return ((w >> (y & 31)) & 1u) != 0u;
}

// grid.set_voxel and grid.update_cols at one in-grid cell
__device__ __forceinline__ void write_cell(const Grid& g, int x, int y, int z, int16_t slot,
                                           bool solid, const Consts& c) {
  if (!in_grid(x, y, z, c)) return;
  g.vobj[((long long)x * c.NY + y) * c.Z + z] = slot;
  int* word = g.cols + ((long long)x * c.NW + (y >> 5)) * c.Z + z;
  const unsigned bit = 1u << (y & 31);
  *word = (int)(solid ? ((unsigned)*word | bit) : ((unsigned)*word & ~bit));
}

// components.camera_anchor for one agent and one camera-local vector
// (rot_yaw_pitch's order: pitch about x, then yaw about y)
__device__ __forceinline__ void camera_anchor(const float* __restrict__ pos, float yaw,
                                              float pitch, float lx, float ly, float lz,
                                              const Consts& c, float out[3]) {
  const float bx = __ldg(pos) + 0.0f;
  const float by = __ldg(pos + 1) + c.camera_y;
  const float bz = __ldg(pos + 2) + 0.0f;
  const float cp = cosf(pitch), sp = sinf(pitch);
  const float y1 = cp * ly - sp * lz;
  const float z1 = sp * ly + cp * lz;
  const float cy = cosf(yaw), sy = sinf(yaw);
  const float x2 = cy * lx + sy * z1;
  const float z2 = (-sy) * lx + cy * z1;
  out[0] = bx + x2;
  out[1] = by + y1;
  out[2] = bz + z2;
}

// Copy n bytes, 16 at a time where both ends allow it, with a block's threads.
__device__ __forceinline__ void copy_bytes(char* dst, const char* __restrict__ src,
                                           long long n) {
  long long i0 = 0;
  if ((((uintptr_t)dst | (uintptr_t)src) & 15u) == 0) {
    const long long n16 = n >> 4;
    for (long long i = threadIdx.x; i < n16; i += blockDim.x)
      reinterpret_cast<uint4*>(dst)[i] = __ldg(reinterpret_cast<const uint4*>(src) + i);
    i0 = n16 << 4;
  }
  for (long long i = i0 + threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
}

// ------------------------------------------------------------------ kernel
__global__ void __launch_bounds__(THREADS)
stacking_kernel(const Consts c, int batch, int num_agents, int num_props,
                const int* __restrict__ action, const float* __restrict__ agent_pos,
                const float* __restrict__ yaw, const float* __restrict__ pitch,
                const float* __restrict__ prop_pos_in, const float* __restrict__ prop_scale_in,
                const uint8_t* __restrict__ flags_in, const int16_t* __restrict__ carried_in,
                const int* __restrict__ zone, int zone_stride, int16_t* vobj, int* cols,
                float* prop_pos, float* prop_scale, uint8_t* flags, int16_t* carried,
                bool* picked_out, bool* placed_out, int* place_voxel_out) {
  const int A = num_agents, P = num_props;
  const int b0 = blockIdx.x * ENVS;
  const int nb = min(ENVS, batch - b0);
  // the block's envs' rows of the tables the plain code returns anew
  copy_bytes(reinterpret_cast<char*>(prop_pos + (long long)b0 * P * 3),
             reinterpret_cast<const char*>(prop_pos_in + (long long)b0 * P * 3),
             (long long)nb * P * 3 * 4);
  copy_bytes(reinterpret_cast<char*>(prop_scale + (long long)b0 * P * 3),
             reinterpret_cast<const char*>(prop_scale_in + (long long)b0 * P * 3),
             (long long)nb * P * 3 * 4);
  copy_bytes(reinterpret_cast<char*>(flags + (long long)b0 * P),
             reinterpret_cast<const char*>(flags_in + (long long)b0 * P), (long long)nb * P);
  copy_bytes(reinterpret_cast<char*>(carried + (long long)b0 * A),
             reinterpret_cast<const char*>(carried_in + (long long)b0 * A),
             (long long)nb * A * 2);
  __syncthreads();
  if ((int)threadIdx.x >= nb) return;

  const int b = b0 + threadIdx.x;
  const long long cells = (long long)c.X * c.NY * c.Z;
  const Grid g = {vobj + b * cells, cols + b * ((long long)c.X * c.NW * c.Z)};
  float* pos = prop_pos + (long long)b * P * 3;
  float* scale = prop_scale + (long long)b * P * 3;
  uint8_t* flag = flags + (long long)b * P;
  int16_t* carry = carried + (long long)b * A;
  const int* act = action + (long long)b * A;
  const float* apos = agent_pos + (long long)b * A * 3;
  const float* ayaw = yaw + (long long)b * A;
  const float* apitch = pitch + (long long)b * A;
  int zx0 = 0, zx1 = 0, zz0 = 0, zz1 = 0;
  if (zone != nullptr) {
    const int* zb = zone + (long long)b * zone_stride;
    zx0 = __ldg(zb);
    zx1 = __ldg(zb + 1);
    zz0 = __ldg(zb + 2);
    zz1 = __ldg(zb + 3);
  }

  for (int a = 0; a < A; ++a) {   // pass a: agent a alone interacts
    const long long ab = (long long)b * A + a;
    const bool interact = (__ldg(act + a) & ACTION_INTERACT) != 0;
    const int held = carry[a];
    const bool carrying = held >= 0;
    const bool want_place = interact && carrying;

    // ------------- place (hpp:66-128): the carried prop's voxel, its tests,
    // then the gravity settle. A single agent's settled voxel is an output
    // whether it placed or not, so there the settle always runs.
    bool ok_place = false;
    int px = 0, py = 0, pz = 0, settled_y = 0;
    if (want_place || A == 1) {
      const int ci = carrying ? held : 0;
      px = to_voxel(pos[3 * ci], c.origin_x, c);
      py = to_voxel(pos[3 * ci + 1], c.origin_y, c);
      pz = to_voxel(pos[3 * ci + 2], c.origin_z, c);
      if (want_place) {
        ok_place = in_grid(px, py, pz, c) && !solid_at(g, px, py, pz, c) &&
                   vobj_at(g, px, py, pz, c) == 0;
        // no other agent standing in that voxel (hpp:82-94)
        for (int j = 0; j < A && ok_place; ++j) {
          if (j == a) continue;
          const float* p = apos + 3 * j;
          ok_place = !(to_voxel(__ldg(p) + 0.0f, c.origin_x, c) == px &&
                       to_voxel(__ldg(p + 1) + c.body_y, c.origin_y, c) == py &&
                       to_voxel(__ldg(p + 2) + 0.0f, c.origin_z, c) == pz);
        }
        if (zone != nullptr)
          ok_place = ok_place && px >= zx0 && px < zx1 && pz >= zz0 && pz < zz1;
      }
      if (ok_place || A == 1) {
        // descend while the cell below is neither solid nor holds an object
        // nor lies under the grid (hpp:101-115): the cells below are known up
        // front, so their reads go out together
        unsigned support = 0u;
#pragma unroll
        for (int k = 0; k < MAX_DROP; ++k) {
          if (k < c.max_drop) {
            const int y = wrap_add(py, -1 - k);
            const bool s = y < 0 || solid_at(g, px, y, pz, c) || vobj_at(g, px, y, pz, c) != 0;
            support |= (unsigned)s << k;
          }
        }
        const int fall = support != 0u ? __ffs(support) - 1 : c.max_drop;
        settled_y = wrap_add(py, -fall);
      }
    }
    if (ok_place) {
      const int ci = held;
      pos[3 * ci] = c.origin_x + ((float)px + 0.5f) * c.vs;
      pos[3 * ci + 1] = c.origin_y + ((float)settled_y + 0.5f) * c.vs;
      pos[3 * ci + 2] = c.origin_z + ((float)pz + 0.5f) * c.vs;
      for (int k = 0; k < 3; ++k) scale[3 * ci + k] = scale[3 * ci + k] * c.inv_carry_scale;
      flag[ci] = (uint8_t)(flag[ci] | PROP_FLAG_SOLID);
      write_cell(g, px, settled_y, pz, (int16_t)(ci + 1), true, c);
      carry[a] = -1;
    }
    // the settled voxel where the agent placed; with several agents 0
    // elsewhere, as the plain code's per-pass select leaves it
    const bool keep = A == 1 || ok_place;
    placed_out[ab] = ok_place;
    place_voxel_out[3 * ab] = keep ? px : 0;
    place_voxel_out[3 * ab + 1] = keep ? settled_y : 0;
    place_voxel_out[3 * ab + 2] = keep ? pz : 0;

    // ------------- pick (hpp:130-166): the first of two voxels upward from
    // the pickup spot that holds an object with nothing on top of it
    bool hit = false;
    if (interact && !carrying) {
      float spot[3];
      camera_anchor(apos + 3 * a, __ldg(ayaw + a), __ldg(apitch + a), c.pick_x, c.pick_y,
                    c.pick_z, c, spot);
      const int vx = to_voxel(spot[0], c.origin_x, c);
      const int vy = to_voxel(spot[1], c.origin_y, c);
      const int vz = to_voxel(spot[2], c.origin_z, c);
      const int y1 = wrap_add(vy, 1), y2 = wrap_add(vy, 2);
      const int o0 = vobj_at(g, vx, vy, vz, c);
      const int o1 = vobj_at(g, vx, y1, vz, c);
      const int o2 = vobj_at(g, vx, y2, vz, c);
      int slot = 0, hy = 0;
      if (o0 != 0 && o1 == 0) {
        hit = true;
        slot = o0;
        hy = vy;
      } else if (o1 != 0 && o2 == 0) {
        hit = true;
        slot = o1;
        hy = y1;
      }
      const int pi = slot - 1;
      if (hit && pi >= 0 && pi < P) {
        for (int k = 0; k < 3; ++k) scale[3 * pi + k] = scale[3 * pi + k] * c.carry_scale;
        flag[pi] = (uint8_t)(flag[pi] & (0xFF ^ PROP_FLAG_SOLID));
        write_cell(g, vx, hy, vz, 0, false, c);
        carry[a] = (int16_t)pi;
      }
    }
    picked_out[ab] = hit;

    // ------------- update_carried_props: every carried prop to its agent's
    // carry anchor
    for (int j = 0; j < A; ++j) {
      const int cj = carry[j];
      if (cj < 0 || cj >= P) continue;
      float anchor[3];
      camera_anchor(apos + 3 * j, __ldg(ayaw + j), __ldg(apitch + j), c.carry_x, c.carry_y,
                    c.carry_z, c, anchor);
      pos[3 * cj] = anchor[0];
      pos[3 * cj + 1] = anchor[1];
      pos[3 * cj + 2] = anchor[2];
    }
  }
}

extern "C" {

int mv_stacking_consts_size() { return (int)sizeof(Consts); }

int mv_stacking_max_drop() { return MAX_DROP; }

// One tick's stacking passes of `batch` envs x `num_agents` agents over
// `num_props` props: device pointers of the inputs (action int32 [B, A];
// agent pos float [B, A, 3], yaw and pitch [B, A]; prop pos and scale float
// [B, P, 3], flags uint8 [B, P]; carried int16 [B, A]; the place zone
// int32 (x0, x1, z0, z1) every `zone_stride` ints, or null), the grids
// updated in place (vobj int16 [B, X, NY, Z], cols int32 [B, X, NW, Z]) and
// the outputs (prop pos, scale, flags and carried as their inputs; picked
// and placed bool [B, A]; place_voxel int32 [B, A, 3]). Returns
// cudaGetLastError() after the launch (-1: bad arguments); the launch runs
// on `stream`.
int mv_stacking_step(const Consts* consts, int batch, int num_agents, int num_props,
                     const int* action, const float* agent_pos, const float* yaw,
                     const float* pitch, const float* prop_pos_in, const float* prop_scale_in,
                     const uint8_t* flags_in, const int16_t* carried_in, const int* zone,
                     int zone_stride, int16_t* vobj, int* cols, float* prop_pos,
                     float* prop_scale, uint8_t* flags, int16_t* carried, bool* picked,
                     bool* placed, int* place_voxel, cudaStream_t stream) {
  if (batch < 0 || num_agents < 1 || num_props < 1 || zone_stride < 0 ||
      consts->max_drop < 0 || consts->max_drop > MAX_DROP)
    return -1;
  if (batch == 0) return (int)cudaGetLastError();
  const int blocks = (batch + ENVS - 1) / ENVS;
  stacking_kernel<<<blocks, THREADS, 0, stream>>>(
      *consts, batch, num_agents, num_props, action, agent_pos, yaw, pitch, prop_pos_in,
      prop_scale_in, flags_in, carried_in, zone, zone_stride, vobj, cols, prop_pos,
      prop_scale, flags, carried, picked, placed, place_voxel);
  return (int)cudaGetLastError();
}

}  // extern "C"
