// Empty marker kernels for the device trace (ops/marks.py).
//
// Replaces no TPU kernel and computes nothing. `capture.tick` launches one at
// the start of the tick, one where the deferred reset begins and one where
// the render's cull prologue begins; captured into the tick's CUDA graph
// with everything else, they cut the graph's unnamed kernels into the sim
// step, the reset and the prologue in a profiler's trace, where kernels
// replayed from a graph carry no host range. The names are unmangled
// (extern "C") so that the trace shows them as written here. Each launch is
// one block of one thread that returns at once: about a microsecond of
// device time.

#include <cuda_runtime.h>

extern "C" {

__global__ void megaverse_mark_tick() {}
__global__ void megaverse_mark_reset() {}
__global__ void megaverse_mark_cull() {}

// which: 0 tick, 1 reset, 2 cull. Returns cudaGetLastError() after the launch
// (-1: no such marker); the launch runs asynchronously on `stream`.
int mv_mark(int which, cudaStream_t stream) {
  switch (which) {
    case 0: megaverse_mark_tick<<<1, 1, 0, stream>>>(); break;
    case 1: megaverse_mark_reset<<<1, 1, 0, stream>>>(); break;
    case 2: megaverse_mark_cull<<<1, 1, 0, stream>>>(); break;
    default: return -1;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
