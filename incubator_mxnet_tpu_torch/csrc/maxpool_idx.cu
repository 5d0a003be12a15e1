// Max pooling that also stores the winning in-window slot, for Hopper
// (sm_90a).  NCHW-contiguous input, bf16 or f32.
//
// Replaces incubator_mxnet_tpu/parallel/maxpool_idx.py maxpool_with_index
// (its Pallas `_kernel`): the pooled maximum with -inf padding, plus an
// int8 plane holding the first row-major in-window argmax (strict >, so
// ties keep the earlier slot: the winner that select_and_scatter_add and
// MXNet's pool.h unpool_max_* pick).  The backward routes gradients from
// the int8 plane alone (maxpool_idx.py indexed_unpool, plain torch).
//
// What bounds it on the H100: bytes.  The stem (256, 64, 112, 112) bf16
// reads 411 MB and writes 103 MB of output and 51 MB of indices; nine
// compares per output are nothing beside that.
//
// What the design does about it: one thread per output element loops
// over the kh x kw window.  Neighbouring threads own neighbouring output
// columns, so a warp's loads of one window row cover a contiguous run of
// input (stride 2 at the stem), and the overlapping windows of the 3x3/2
// stem re-read their shared input rows from L1/L2, not from device
// memory.  Outputs are written once, coalesced.  Padding is handled by
// bounds checks instead of a padded copy of the input.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float load(const float* p, int64_t i) { return p[i]; }
__device__ __forceinline__ float load(const __nv_bfloat16* p, int64_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store(float* p, int64_t i, float v) { p[i] = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, int64_t i, float v) {
  p[i] = __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
maxpool_idx_kernel(const T* __restrict__ x, T* __restrict__ out, int8_t* __restrict__ idx,
                   int64_t total, int H, int W, int OH, int OW, int kh, int kw, int sh,
                   int sw, int ph, int pw) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t o = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; o < total;
       o += stride) {
    const int ox = static_cast<int>(o % OW);
    const int64_t t = o / OW;
    const int oy = static_cast<int>(t % OH);
    const int64_t nc = t / OH;
    const int64_t plane = nc * H * W;
    const int y0 = oy * sh - ph;
    const int x0 = ox * sw - pw;
    float best = 0.f;
    int win = 0;
    int lin = 0;
    for (int ky = 0; ky < kh; ++ky) {
      const int iy = y0 + ky;
      const bool row_in = iy >= 0 && iy < H;
      for (int kx = 0; kx < kw; ++kx, ++lin) {
        const int ix = x0 + kx;
        const float v = (row_in && ix >= 0 && ix < W)
                            ? load(x, plane + static_cast<int64_t>(iy) * W + ix)
                            : -INFINITY;
        if (lin == 0) {
          best = v;
        } else if (v > best) {
          best = v;
          win = lin;
        } else if (isnan(v)) {
          best = v;  // jnp.maximum propagates NaN; the index keeps its slot
        }
      }
    }
    store(out, o, best);
    idx[o] = static_cast<int8_t>(win);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  ph/pw are the low-edge paddings; the
// caller sizes OH/OW (the high edge may pad more).  Returns
// cudaGetLastError() after the launch.
extern "C" int maxpool_idx_fwd(int dtype, const void* x, void* out, void* idx, int N,
                               int C, int H, int W, int OH, int OW, int kh, int kw, int sh,
                               int sw, int ph, int pw, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t total = static_cast<int64_t>(N) * C * OH * OW;
  int64_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 1048576) blocks = 1048576;
  if (blocks < 1) blocks = 1;
  int8_t* ip = static_cast<int8_t*>(idx);
  if (dtype == 0)
    maxpool_idx_kernel<float><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<float*>(out), ip, total, H, W, OH, OW,
        kh, kw, sh, sw, ph, pw);
  else
    maxpool_idx_kernel<__nv_bfloat16><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(out), ip, total,
        H, W, OH, OW, kh, kw, sh, sw, ph, pw);
  return static_cast<int>(cudaGetLastError());
}
