// K7: a copy of one NCHW activation over ghost-BN blocks, for Hopper
// (sm_90a).  bf16 or f32, copied bit for bit.
//
// Replaces the TPU kernel of tools/bn_kernel_bench.py::_call_copy (the
// Pallas copy with the selected ghost-BN plan's exact blocks and grid:
// the pure-DMA ceiling of that plan).  Here the plan is the walk of
// ghost_bn_walk.cuh: block (cb, g) of a (C / kc, G) grid copies the ng
// contiguous runs of kc channels of ghost group g, 16 bytes a thread, with
// a scalar head and tail where a run is not 16-byte aligned.  So its time
// is the ceiling of that walk: what K1 and K2 cost beyond K7 is what they
// will cost beyond the walk once they take it (their own walk,
// ghost_bn_slice.cuh, is still one block a channel, 2 or 4 bytes a thread).
//
// What bounds it on the H100: bytes, one read of x and one write of y.
// At the ResNet-50 stem, (256, 64, 112, 112) bf16, that is 822 MB, 0.245
// ms at 3.35 TB/s.  The walk gives each block tens of KB in runs that are
// whole 16-byte vectors, several loads in flight a thread, on a grid of a
// few waves of the card's 132 SMs (ghost_bn_walk.cuh).

#include <cuda_runtime.h>
#include <stdint.h>

#include "ghost_bn_walk.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(WALK_THREADS)
bn_copy_kernel(const T* __restrict__ x, T* __restrict__ y, int C, int HW, int ng,
               int kc) {
  const int64_t run = static_cast<int64_t>(kc) * HW;
  const int64_t plane = static_cast<int64_t>(C) * HW;
  const int64_t base = static_cast<int64_t>(blockIdx.y) * ng * plane + blockIdx.x * run;
  copy_runs(x + base, y + base, run, plane, ng);
}

}  // namespace

// The channels a block of bn_copy copies for these arguments (walk_channels);
// launches nothing.
extern "C" int bn_copy_channels(int dtype, int G, int C, int HW, int ng) {
  return walk_channels(C, HW, dtype == 0 ? 4 : 2, ng, G);
}

// dtype: 0 = float32, 1 = bfloat16 (copied as 16-bit words).
// Returns cudaGetLastError() after the launch.
extern "C" int bn_copy(int dtype, const void* x, void* y, int G, int C, int HW, int ng,
                       void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int kc = bn_copy_channels(dtype, G, C, HW, ng);
  const dim3 grid(C / kc, G);
  if (dtype == 0)
    bn_copy_kernel<float><<<grid, WALK_THREADS, 0, s>>>(
        static_cast<const float*>(x), static_cast<float*>(y), C, HW, ng, kc);
  else
    bn_copy_kernel<uint16_t><<<grid, WALK_THREADS, 0, s>>>(
        static_cast<const uint16_t*>(x), static_cast<uint16_t*>(y), C, HW, ng, kc);
  return static_cast<int>(cudaGetLastError());
}
