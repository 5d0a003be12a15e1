// The walk of one ghost-BN block over its slice, shared by K1/K2
// (ghost_bn.cu) and K7 (bn_copy.cu), so the copy reads and writes in
// exactly K1's order.
//
// Block (c, g) of the (C, G) grid owns channel c of ghost group g: `ng`
// contiguous H*W planes, `plane` = C*H*W elements apart in NCHW.  The
// kThreads threads of the block stride through the slice in row-major
// (plane, offset) order, so the loads of a warp are coalesced within a
// plane.
#pragma once

#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// Walks the slice of one block: `ng` planes of `hw` elements, planes
// `plane` elements apart.  The (plane, offset) pair advances without a
// division per element.
struct SliceIter {
  int p, j, dp, dj, hw;
  int64_t plane, base;
  __device__ SliceIter(int64_t base_, int64_t plane_, int hw_)
      : hw(hw_), plane(plane_), base(base_) {
    p = threadIdx.x / hw;
    j = threadIdx.x - p * hw;
    dp = blockDim.x / hw;
    dj = blockDim.x - dp * hw;
  }
  __device__ __forceinline__ int64_t offset() const { return base + p * plane + j; }
  __device__ __forceinline__ void next() {
    p += dp;
    j += dj;
    if (j >= hw) {
      j -= hw;
      ++p;
    }
  }
};

}  // namespace
