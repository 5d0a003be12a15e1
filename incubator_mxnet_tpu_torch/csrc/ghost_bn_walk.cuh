// The walk of a ghost-BN block over contiguous runs, 16 bytes a thread.
// K7 (bn_copy.cu) copies with it; it is the walk that K1 and K2
// (ghost_bn.cu, still on ghost_bn_slice.cuh) are to take next.
//
// Block (cb, g) of a (C / kc, G) grid owns the kc consecutive channels
// cb * kc .. cb * kc + kc - 1 of ghost group g.  For each of the group's ng
// images that is one contiguous run of kc * HW elements in NCHW; the runs
// of a block lie C * HW elements apart.  walk_channels picks kc from the
// shape: the smallest divisor of C whose run is a whole number of 16-byte
// vectors and whose block reads at least WALK_MIN_BLOCK_BYTES, unless that
// leaves fewer than WALK_MIN_BLOCKS blocks (a few waves of the H100's 132
// SMs): then the largest such kc below it.  When no divisor gives whole
// vectors, kc = 1.  At ResNet-50's BN shapes (C a multiple of 64) the runs
// then also start on 16 bytes: kc = 1 at the stem (25 KB runs, 401 KB a
// block, 1024 blocks), kc = 4 at 14x14, kc = 8 and 16 at 7x7.
//
// copy_runs moves a block's runs in 16-byte vectors, WALK_UNROLL loads in
// flight a thread before its stores.  When x and y start on 16 bytes and
// the runs and planes are whole vectors (every ResNet shape), the vectors
// of all ng runs form one sequence that the threads stride through, so a
// run shorter than the block (49 or 98 vectors at 7x7 to 28x28) leaves no
// thread idle.  Otherwise copy_run takes one run at a time: a scalar head
// up to the destination's 16-byte boundary, vectors, a scalar tail (the
// odd shapes, C = 3 or HW = 5); every element is scalar where source and
// destination differ in alignment mod 16.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W, variants built side by
// side: 8 loads in flight a thread beat 4 at the large shapes, 16 lost to
// occupancy; streaming cache hints (ld.global.nc.L1::no_allocate,
// st.global.cs) gained nothing, so the accesses are plain; a linear
// grid-stride copy of the whole tensor with the same accesses was no
// faster than this walk.  K7 stays 1.04-1.07x the CUDA runtime's
// device-to-device memcpy (Tensor.copy_) at the stem (chip_smoke.py phase
// 4c, PERF.md).
//
// What K1 and K2 need beyond a copy (for the redesign that gives them this
// walk): a 16-byte vector straddles two channels when HW is not a multiple
// of its elements (HW = 49 and 196 at ResNet's 7x7 and 14x14), so each
// element's channel is (its index in the run) / HW, and the per-channel
// sums of a block are kc partials reduced across the block, not one.  K1
// and K2 read their slice twice (the sums, then the outputs), so a block's
// kc * ng * HW elements (25 KB at 28x28, 401 KB at the stem) have to stay
// in L2 or in shared memory between the two passes.

#pragma once

#include <stdint.h>

#define WALK_THREADS 256
#define WALK_VEC_BYTES 16
#define WALK_UNROLL 8
#define WALK_MIN_BLOCK_BYTES (24 * 1024)
#define WALK_MIN_BLOCKS (4 * 132)

namespace {

// kc for C channels of HW elements of `esize` bytes, ng images a group and
// G groups (see the note above).
inline int walk_channels(int C, int HW, int esize, int ng, int G) {
  int best = 0;
  for (int kc = 1; kc <= C; ++kc) {
    if (C % kc || (static_cast<int64_t>(kc) * HW * esize) % WALK_VEC_BYTES) continue;
    if (best && static_cast<int64_t>(C / kc) * G < WALK_MIN_BLOCKS) break;
    best = kc;
    if (static_cast<int64_t>(ng) * kc * HW * esize >= WALK_MIN_BLOCK_BYTES) break;
  }
  return best ? best : 1;
}

// Copies the n elements at src to dst with the block's threads: a scalar
// head up to dst's 16-byte boundary, 16-byte vectors, a scalar tail; every
// element scalar where src and dst differ in alignment mod 16.
template <typename T>
__device__ __forceinline__ void copy_run(const T* __restrict__ src, T* __restrict__ dst,
                                         int64_t n) {
  constexpr int kVec = WALK_VEC_BYTES / sizeof(T);
  const uintptr_t sa = reinterpret_cast<uintptr_t>(src);
  const uintptr_t da = reinterpret_cast<uintptr_t>(dst);
  int64_t head = n;  // no common alignment: every element scalar
  if ((sa - da) % WALK_VEC_BYTES == 0) {
    head = (WALK_VEC_BYTES - da % WALK_VEC_BYTES) % WALK_VEC_BYTES / sizeof(T);
    if (head > n) head = n;
  }
  const int64_t nvec = (n - head) / kVec;
  const int64_t tail = head + nvec * kVec;
  for (int64_t i = threadIdx.x; i < head; i += blockDim.x) dst[i] = src[i];
  for (int64_t i = tail + threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
  const uint4* vs = reinterpret_cast<const uint4*>(src + head);
  uint4* vd = reinterpret_cast<uint4*>(dst + head);
  for (int64_t v0 = threadIdx.x; v0 < nvec; v0 += WALK_UNROLL * blockDim.x) {
    uint4 r[WALK_UNROLL];
#pragma unroll
    for (int u = 0; u < WALK_UNROLL; ++u) {
      const int64_t v = v0 + u * blockDim.x;
      if (v < nvec) r[u] = vs[v];
    }
#pragma unroll
    for (int u = 0; u < WALK_UNROLL; ++u) {
      const int64_t v = v0 + u * blockDim.x;
      if (v < nvec) vd[v] = r[u];
    }
  }
}

// Walks (run p, vector v) pairs in row-major order, `step` pairs a step,
// without a division a step.
struct RunIter {
  int64_t p, v, dp, dv, nvec;
  __device__ RunIter(int64_t start, int64_t step, int64_t nvec_)
      : p(start / nvec_), v(start % nvec_), dp(step / nvec_), dv(step % nvec_),
        nvec(nvec_) {}
  __device__ __forceinline__ void next() {
    p += dp;
    v += dv;
    if (v >= nvec) {
      v -= nvec;
      ++p;
    }
  }
};

// Copies the block's ng runs of `run` elements, `plane` elements apart,
// from src to dst.  Where src and dst start on 16 bytes and run and plane
// are whole vectors, the block walks the vectors of all its runs as one
// sequence, so short runs (49 vectors at 7x7) still give every thread
// WALK_UNROLL loads in flight; otherwise copy_run takes one run at a time.
template <typename T>
__device__ __forceinline__ void copy_runs(const T* __restrict__ src, T* __restrict__ dst,
                                          int64_t run, int64_t plane, int ng) {
  constexpr int kVec = WALK_VEC_BYTES / sizeof(T);
  const uintptr_t ends =
      reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst);
  if (ends % WALK_VEC_BYTES || run % kVec || plane % kVec) {
    for (int p = 0; p < ng; ++p) copy_run(src + p * plane, dst + p * plane, run);
    return;
  }
  const uint4* vs = reinterpret_cast<const uint4*>(src);
  uint4* vd = reinterpret_cast<uint4*>(dst);
  const int64_t pv = plane / kVec;  // vectors from one run to the next
  for (RunIter it(threadIdx.x, blockDim.x, run / kVec); it.p < ng;) {
    uint4 r[WALK_UNROLL];
    int64_t o[WALK_UNROLL];
#pragma unroll
    for (int u = 0; u < WALK_UNROLL; ++u) {
      o[u] = it.p < ng ? it.p * pv + it.v : -1;
      if (o[u] >= 0) r[u] = vs[o[u]];
      it.next();
    }
#pragma unroll
    for (int u = 0; u < WALK_UNROLL; ++u)
      if (o[u] >= 0) vd[o[u]] = r[u];
  }
}

}  // namespace
