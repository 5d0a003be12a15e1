// K7: a copy of one NCHW activation with K1's own geometry, for Hopper
// (sm_90a).  bf16 or f32, copied bit for bit.
//
// Replaces the TPU kernel of tools/bn_kernel_bench.py::_call_copy (the
// Pallas copy with the selected ghost-BN plan's exact blocks and grid:
// the pure-DMA ceiling of that plan).  Here there is one plan, K1's: the
// grid is (C, G), one block of kThreads threads per (channel, ghost
// group), and each block walks its slice with K1's SliceIter
// (ghost_bn_slice.cuh), reading x and writing y at the offsets, and in
// the order, that K1's second loop reads x and writes y.  So its time is
// the ceiling of K1's access pattern: what K1 costs beyond it is K1's
// first read of the slice and its arithmetic.  It is a yardstick, not a
// fast copy: it loads 2 or 4 bytes a thread as K1 does, not 16.
//
// What bounds it on the H100: bytes, one read of x and one write of y.
// At the ResNet-50 stem, (256, 64, 112, 112) bf16, that is 822 MB, 0.245
// ms at 3.35 TB/s.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ghost_bn_slice.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(kThreads)
bn_copy_kernel(const T* __restrict__ x, T* __restrict__ y, int C, int HW, int ng) {
  const int c = blockIdx.x;
  const int g = blockIdx.y;
  const int64_t plane = static_cast<int64_t>(C) * HW;
  const int64_t base = (static_cast<int64_t>(g) * ng * C + c) * HW;
  for (SliceIter it(base, plane, HW); it.p < ng; it.next()) {
    const int64_t o = it.offset();
    y[o] = x[o];
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (copied as 16-bit words).
// Returns cudaGetLastError() after the launch.
extern "C" int bn_copy(int dtype, const void* x, void* y, int G, int C, int HW, int ng,
                       void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(C, G);
  if (dtype == 0)
    bn_copy_kernel<float><<<grid, kThreads, 0, s>>>(static_cast<const float*>(x),
                                                  static_cast<float*>(y), C, HW, ng);
  else
    bn_copy_kernel<uint16_t><<<grid, kThreads, 0, s>>>(
        static_cast<const uint16_t*>(x), static_cast<uint16_t*>(y), C, HW, ng);
  return static_cast<int>(cudaGetLastError());
}
