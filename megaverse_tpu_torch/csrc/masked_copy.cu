// Masked row copy for the deferred auto-reset (ops/masked_copy.py).
//
// Replaces no TPU kernel: the reference completes its deferred reset in plain
// JAX (megaverse_tpu/env.py apply_deferred_resets, a K-slot scatter under
// lax.cond). For every env b whose done[b] is set, copy row b of each source
// tensor into row b of its destination tensor. A "leaf" is one (dst, src)
// pair of tensors with the same [B, ...] shape, contiguous, `row_bytes` bytes
// per env; the copy is a byte copy, so any dtype goes.
//
// Bound by bytes: the done envs' rows read once and written once. The work
// is split into items, one per (env, CHUNK_BYTES chunk of one leaf's row), so
// a done env's megabytes spread over many SMs. One wave of blocks strides
// over the items in rounds of NTHREADS: each thread reads the done flag of
// one item of the round, and a round in which no item's env is done ends
// after that one parallel read, so the bytes moved scale with the envs that
// finished, with no read on the host (the stand-in for the reference's
// lax.cond). A done item's chunk is copied in 16-byte vectors, UNROLL loads
// in flight per thread before the stores.
//
// The leaf table travels by value in the kernel's parameters, so a launch
// needs no upload and is captured whole into a CUDA graph.

#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_LEAVES 48
#define NTHREADS 256
#define UNROLL 4
#define CHUNK_BYTES (64ull * 1024ull)

struct Leaf {
  unsigned long long dst;
  unsigned long long src;
  unsigned long long row_bytes;
  unsigned long long end_chunk;  // one past this leaf's last chunk of a row
};

struct Table {
  int num_leaves;
  int chunks_per_env;  // chunks of all leaves' rows of one env
  Leaf leaf[MAX_LEAVES];
};

__device__ __forceinline__ void copy_bytes(unsigned char* __restrict__ dst,
                                           const unsigned char* __restrict__ src,
                                           unsigned long long n) {
  const unsigned long long tid = threadIdx.x;
  unsigned long long start = 0;
  if ((((uintptr_t)dst ^ (uintptr_t)src) & 15) == 0) {
    // bytes up to the first 16-byte boundary, then 16-byte vectors
    unsigned long long head = (16 - ((uintptr_t)dst & 15)) & 15;
    if (head > n) head = n;
    if (tid < head) dst[tid] = src[tid];
    const unsigned long long nvec = (n - head) / 16;
    uint4* d4 = reinterpret_cast<uint4*>(dst + head);
    const uint4* s4 = reinterpret_cast<const uint4*>(src + head);
    unsigned long long i = tid;
    for (; i + (UNROLL - 1) * NTHREADS < nvec; i += UNROLL * NTHREADS) {
      uint4 v[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) v[u] = s4[i + u * NTHREADS];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) d4[i + u * NTHREADS] = v[u];
    }
    for (; i < nvec; i += NTHREADS) d4[i] = s4[i];
    start = head + nvec * 16;
  }
  for (unsigned long long i = start + tid; i < n; i += NTHREADS) dst[i] = src[i];
}

__global__ void __launch_bounds__(NTHREADS)
masked_copy_kernel(const __grid_constant__ Table T, const unsigned char* __restrict__ done,
                   int batch) {
  __shared__ unsigned int hit[NTHREADS / 32];  // one bit per item of the round
  const long long cpe = T.chunks_per_env;
  const long long items = (long long)batch * cpe;
  const long long stride = gridDim.x;
  // round r holds the items blockIdx.x + (r * NTHREADS + t) * stride
  for (long long base = blockIdx.x; base < items; base += stride * NTHREADS) {
    const long long mine = base + (long long)threadIdx.x * stride;
    const int flag = mine < items && done[mine / cpe];
    const unsigned int bits = __ballot_sync(0xffffffffu, flag);
    if ((threadIdx.x & 31) == 0) hit[threadIdx.x / 32] = bits;
    if (!__syncthreads_or(flag)) continue;
    for (int t = 0; t < NTHREADS; ++t) {
      const unsigned int word = hit[t / 32] >> (t & 31);
      if (!word) {          // no later item of this word is done
        t |= 31;
        continue;
      }
      t += __ffs(word) - 1;
      const long long item = base + (long long)t * stride;
      const long long b = item / cpe;
      const unsigned long long c = (unsigned long long)(item - b * cpe);
      int l = 0;
      while (c >= T.leaf[l].end_chunk) ++l;
      const Leaf L = T.leaf[l];
      const unsigned long long first = l ? T.leaf[l - 1].end_chunk : 0;
      const unsigned long long off = (c - first) * CHUNK_BYTES;
      const unsigned long long left = L.row_bytes - off;
      const unsigned long long row = (unsigned long long)b * L.row_bytes + off;
      copy_bytes(reinterpret_cast<unsigned char*>(L.dst) + row,
                 reinterpret_cast<const unsigned char*>(L.src) + row,
                 left < CHUNK_BYTES ? left : CHUNK_BYTES);
    }
    __syncthreads();  // `hit` is rewritten by the next round
  }
}

extern "C" {

int mv_masked_copy_max_leaves() { return MAX_LEAVES; }

// dst[i], src[i]: device pointers of leaf i, row_bytes[i] (> 0) its bytes per
// env; done: bool [batch] on the device; blocks: the grid (one wave: SMs x
// blocks per SM). Returns cudaGetLastError() after the launch (-1: too many
// leaves); the launch runs asynchronously on `stream`.
int mv_masked_copy(int num_leaves, const unsigned long long* dst,
                   const unsigned long long* src, const unsigned long long* row_bytes,
                   const unsigned char* done, int batch, int blocks, cudaStream_t stream) {
  if (num_leaves > MAX_LEAVES || num_leaves < 0 || blocks < 1) return -1;
  Table T;
  T.num_leaves = num_leaves;
  unsigned long long chunks = 0;
  for (int i = 0; i < num_leaves; ++i) {
    chunks += (row_bytes[i] + CHUNK_BYTES - 1) / CHUNK_BYTES;
    T.leaf[i].dst = dst[i];
    T.leaf[i].src = src[i];
    T.leaf[i].row_bytes = row_bytes[i];
    T.leaf[i].end_chunk = chunks;
  }
  T.chunks_per_env = (int)chunks;
  if (num_leaves == 0 || batch <= 0) return (int)cudaGetLastError();
  const long long items = (long long)batch * (long long)chunks;
  const int grid = items < blocks ? (int)items : blocks;
  masked_copy_kernel<<<grid, NTHREADS, 0, stream>>>(T, done, batch);
  return (int)cudaGetLastError();
}

}  // extern "C"
