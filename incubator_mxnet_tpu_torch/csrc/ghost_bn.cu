// Ghost batch norm (+ residual add, + ReLU), forward and backward, for
// Hopper (sm_90a).  NCHW-contiguous tensors, bf16 or f32, f32 statistics.
//
// Replaces the TPU kernels of incubator_mxnet_tpu/parallel/fused_bn.py:
//   K1 ghost_bn_fwd  <- _call_fwd (_fwd_kernel, _fwd_kernel_res, the
//                       lane-fold view) and _call_fwd_tiled
//                       (_stats_tile_kernel, _norm_tile_kernel[_res])
//   K2 ghost_bn_bwd  <- _call_bwd (_bwd_kernel, _bwd_kernel_res,
//                       _bwd_kernel_res_dual) and _call_bwd_tiled
//                       (_bwd_red_tile_kernel*, _bwd_dx_tile_kernel,
//                       _bwd_dx_from_dr_tile_kernel)
// The TPU needed three forms (whole-L window, lane-fold, spatial tiles)
// to fit its VMEM window; here one block per (ghost group g, channel c)
// walks its slice straight from device memory, so one kernel per
// direction covers every layer shape.
//
// What bounds it on the H100: bytes.  Per element the forward does about
// 7 f32 operations and the backward about 12, against 2-6 bytes moved, far
// below the card's ~20 f32 operations per byte of HBM bandwidth.  The
// least traffic is one read of every input and one write of every output.
//
// What the design does about it: the slice of block (g, c) is `ng`
// contiguous H*W planes, so the loads of a warp are coalesced.  Loop 1
// reduces the slice (f32 sum and sum of squares forward; sum(gp) and
// sum(gp * xhat) backward) with a warp-shuffle block reduction; loop 2
// reads the slice again and writes the outputs.  The second read hits
// the 50 MB L2 when the slices of the resident blocks fit in it (the
// 7x7, 14x14 and 28x28 layers: at most ~100 KB a slice); at the 112x112
// stem and the 56x56 layers a slice is 0.2-0.4 MB and the second read
// mostly goes to device memory.  A one-read design (thread-block clusters
// holding the slice in distributed shared memory, or a split-L two-pass
// with partial sums) is later work.  The grid is (C, G); at H*W = 49 a
// block holds a 16 x 49 slice and C = 2048 gives 32,768 blocks, so the
// small layers still fill the card.
//
// Numerics follow the reference (fused_bn.py _gbn_ref / _gbn_bwd_jnp):
// single-pass moments, var = max(E[x^2] - mean^2, 0) (not Welford),
// rstd = rsqrt(var + eps), y = x * (gamma * rstd) + (beta - mean * gamma *
// rstd) [+ residual] [ReLU].  The backward mask is the saved y > 0 in the
// residual forms and the recomputed xhat * gamma + beta > 0 otherwise.
// ReLU keeps NaN (as jnp.maximum does), so a non-finite step stays
// visible to the train step's finiteness guard.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ghost_bn_slice.cuh"

namespace {

__device__ __forceinline__ float load(const float* p, int64_t i) { return p[i]; }
__device__ __forceinline__ float load(const __nv_bfloat16* p, int64_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store(float* p, int64_t i, float v) { p[i] = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, int64_t i, float v) {
  p[i] = __float2bfloat16(v);
}

// ReLU that keeps NaN, like jnp.maximum(v, 0).
__device__ __forceinline__ float relu_nan(float v) { return v < 0.f ? 0.f : v; }

// Sum a and b over the block; every thread gets both totals.
__device__ __forceinline__ void block_sum2(float& a, float& b) {
  __shared__ float sa[kThreads / 32];
  __shared__ float sb[kThreads / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
    sa[warp] = a;
    sb[warp] = b;
  }
  __syncthreads();
  const int nwarps = blockDim.x >> 5;
  a = lane < nwarps ? sa[lane] : 0.f;
  b = lane < nwarps ? sb[lane] : 0.f;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
}

template <typename T, bool kRes, bool kRelu>
__global__ void __launch_bounds__(kThreads)
ghost_bn_fwd_kernel(const T* __restrict__ x, const T* __restrict__ r,
                    const float* __restrict__ gamma, const float* __restrict__ beta,
                    T* __restrict__ y, float* __restrict__ mean_out,
                    float* __restrict__ var_out, int C, int HW, int ng, float eps) {
  const int c = blockIdx.x;
  const int g = blockIdx.y;
  const int64_t plane = static_cast<int64_t>(C) * HW;
  const int64_t base = (static_cast<int64_t>(g) * ng * C + c) * HW;

  float s = 0.f, ss = 0.f;
  for (SliceIter it(base, plane, HW); it.p < ng; it.next()) {
    const float v = load(x, it.offset());
    s += v;
    ss += v * v;
  }
  block_sum2(s, ss);
  const float cnt = static_cast<float>(ng) * static_cast<float>(HW);
  const float m = s / cnt;
  const float var = fmaxf(ss / cnt - m * m, 0.f);
  const float rstd = rsqrtf(var + eps);
  const float gm = gamma[c];
  const float scale = gm * rstd;
  const float shift = beta[c] - m * gm * rstd;

  for (SliceIter it(base, plane, HW); it.p < ng; it.next()) {
    const int64_t o = it.offset();
    float v = load(x, o) * scale + shift;
    if (kRes) v += load(r, o);
    if (kRelu) v = relu_nan(v);
    store(y, o, v);
  }
  if (threadIdx.x == 0) {
    mean_out[static_cast<int64_t>(g) * C + c] = m;
    var_out[static_cast<int64_t>(g) * C + c] = var;
  }
}

// kRes: residual form (mask from the saved y, writes dR = gp).
// kDual: a second cotangent gy2 is summed in on load.
template <typename T, bool kRelu, bool kRes, bool kDual>
__global__ void __launch_bounds__(kThreads)
ghost_bn_bwd_kernel(const T* __restrict__ gy, const T* __restrict__ gy2,
                    const T* __restrict__ x, const T* __restrict__ y,
                    const float* __restrict__ gamma, const float* __restrict__ beta,
                    const float* __restrict__ mean, const float* __restrict__ var,
                    T* __restrict__ dx, T* __restrict__ dr,
                    float* __restrict__ dg_part, float* __restrict__ db_part,
                    int C, int HW, int ng, float eps) {
  const int c = blockIdx.x;
  const int g = blockIdx.y;
  const int64_t plane = static_cast<int64_t>(C) * HW;
  const int64_t base = (static_cast<int64_t>(g) * ng * C + c) * HW;
  const int64_t sidx = static_cast<int64_t>(g) * C + c;
  const float m = mean[sidx];
  const float rstd = rsqrtf(var[sidx] + eps);
  const float gm = gamma[c];
  const float bt = kRes ? 0.f : beta[c];

  auto masked = [&](int64_t o, float xhat) {
    float gv = load(gy, o);
    if (kDual) gv += load(gy2, o);
    if (!kRelu) return gv;
    const bool keep = kRes ? (load(y, o) > 0.f) : (xhat * gm + bt > 0.f);
    return keep ? gv : 0.f;
  };

  float sdb = 0.f, sdg = 0.f;
  for (SliceIter it(base, plane, HW); it.p < ng; it.next()) {
    const int64_t o = it.offset();
    const float xhat = (load(x, o) - m) * rstd;
    const float gp = masked(o, xhat);
    sdb += gp;
    sdg += gp * xhat;
  }
  block_sum2(sdb, sdg);
  const float cnt = static_cast<float>(ng) * static_cast<float>(HW);
  const float k = gm * rstd;

  for (SliceIter it(base, plane, HW); it.p < ng; it.next()) {
    const int64_t o = it.offset();
    const float xhat = (load(x, o) - m) * rstd;
    const float gp = masked(o, xhat);
    store(dx, o, k * (gp - (sdb + xhat * sdg) / cnt));
    if (kRes) store(dr, o, gp);
  }
  if (threadIdx.x == 0) {
    dg_part[sidx] = sdg;
    db_part[sidx] = sdb;
  }
}

template <typename T>
void launch_fwd(const void* x, const void* r, const float* gamma, const float* beta,
                void* y, float* mean, float* var, int G, int C, int HW, int ng,
                float eps, int relu, cudaStream_t stream) {
  const dim3 grid(C, G);
  const T* xp = static_cast<const T*>(x);
  const T* rp = static_cast<const T*>(r);
  T* yp = static_cast<T*>(y);
  if (r != nullptr) {
    if (relu)
      ghost_bn_fwd_kernel<T, true, true><<<grid, kThreads, 0, stream>>>(
          xp, rp, gamma, beta, yp, mean, var, C, HW, ng, eps);
    else
      ghost_bn_fwd_kernel<T, true, false><<<grid, kThreads, 0, stream>>>(
          xp, rp, gamma, beta, yp, mean, var, C, HW, ng, eps);
  } else {
    if (relu)
      ghost_bn_fwd_kernel<T, false, true><<<grid, kThreads, 0, stream>>>(
          xp, rp, gamma, beta, yp, mean, var, C, HW, ng, eps);
    else
      ghost_bn_fwd_kernel<T, false, false><<<grid, kThreads, 0, stream>>>(
          xp, rp, gamma, beta, yp, mean, var, C, HW, ng, eps);
  }
}

template <typename T, bool kRelu, bool kRes>
void launch_bwd_dual(bool dual, const dim3& grid, cudaStream_t stream, const T* gy,
                     const T* gy2, const T* x, const T* y, const float* gamma,
                     const float* beta, const float* mean, const float* var, T* dx,
                     T* dr, float* dg, float* db, int C, int HW, int ng, float eps) {
  if (dual)
    ghost_bn_bwd_kernel<T, kRelu, kRes, true><<<grid, kThreads, 0, stream>>>(
        gy, gy2, x, y, gamma, beta, mean, var, dx, dr, dg, db, C, HW, ng, eps);
  else
    ghost_bn_bwd_kernel<T, kRelu, kRes, false><<<grid, kThreads, 0, stream>>>(
        gy, gy2, x, y, gamma, beta, mean, var, dx, dr, dg, db, C, HW, ng, eps);
}

template <typename T>
void launch_bwd(const void* gy, const void* gy2, const void* x, const void* y,
                const float* gamma, const float* beta, const float* mean,
                const float* var, void* dx, void* dr, float* dg, float* db, int G,
                int C, int HW, int ng, float eps, int relu, cudaStream_t stream) {
  const dim3 grid(C, G);
  const T* gyp = static_cast<const T*>(gy);
  const T* gy2p = static_cast<const T*>(gy2);
  const T* xp = static_cast<const T*>(x);
  const T* yp = static_cast<const T*>(y);
  T* dxp = static_cast<T*>(dx);
  T* drp = static_cast<T*>(dr);
  const bool dual = gy2 != nullptr;
  const bool res = y != nullptr;
  if (relu && res)
    launch_bwd_dual<T, true, true>(dual, grid, stream, gyp, gy2p, xp, yp, gamma, beta,
                                   mean, var, dxp, drp, dg, db, C, HW, ng, eps);
  else if (relu)
    launch_bwd_dual<T, true, false>(dual, grid, stream, gyp, gy2p, xp, yp, gamma, beta,
                                    mean, var, dxp, drp, dg, db, C, HW, ng, eps);
  else if (res)
    launch_bwd_dual<T, false, true>(dual, grid, stream, gyp, gy2p, xp, yp, gamma, beta,
                                    mean, var, dxp, drp, dg, db, C, HW, ng, eps);
  else
    launch_bwd_dual<T, false, false>(dual, grid, stream, gyp, gy2p, xp, yp, gamma, beta,
                                     mean, var, dxp, drp, dg, db, C, HW, ng, eps);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  r may be null (no residual).
// Returns cudaGetLastError() after the launch.
extern "C" int ghost_bn_fwd(int dtype, const void* x, const void* r, const void* gamma,
                            const void* beta, void* y, void* mean, void* var, int G,
                            int C, int HW, int ng, float eps, int relu, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* gp = static_cast<const float*>(gamma);
  const float* bp = static_cast<const float*>(beta);
  float* mp = static_cast<float*>(mean);
  float* vp = static_cast<float*>(var);
  if (dtype == 0)
    launch_fwd<float>(x, r, gp, bp, y, mp, vp, G, C, HW, ng, eps, relu, s);
  else
    launch_fwd<__nv_bfloat16>(x, r, gp, bp, y, mp, vp, G, C, HW, ng, eps, relu, s);
  return static_cast<int>(cudaGetLastError());
}

// gy2 may be null (single cotangent); y and dr are both null (no
// residual) or both set (residual form).  dg and db are (G, C) partials.
extern "C" int ghost_bn_bwd(int dtype, const void* gy, const void* gy2, const void* x,
                            const void* y, const void* gamma, const void* beta,
                            const void* mean, const void* var, void* dx, void* dr,
                            void* dg, void* db, int G, int C, int HW, int ng, float eps,
                            int relu, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* gp = static_cast<const float*>(gamma);
  const float* bp = static_cast<const float*>(beta);
  const float* mp = static_cast<const float*>(mean);
  const float* vp = static_cast<const float*>(var);
  float* dgp = static_cast<float*>(dg);
  float* dbp = static_cast<float*>(db);
  if (dtype == 0)
    launch_bwd<float>(gy, gy2, x, y, gp, bp, mp, vp, dx, dr, dgp, dbp, G, C, HW, ng, eps,
                      relu, s);
  else
    launch_bwd<__nv_bfloat16>(gy, gy2, x, y, gp, bp, mp, vp, dx, dr, dgp, dbp, G, C, HW,
                              ng, eps, relu, s);
  return static_cast<int>(cudaGetLastError());
}
