// Max pooling that also stores the winning in-window slot (K3), for Hopper
// (sm_90a).  NCHW-contiguous input, f32, bf16, f16 or f64 (the dtypes
// the reference's Pallas kernel takes: its plan checks no dtype).  The
// compares run in f32 (f64 for f64 input), where each input value is
// exact, so the winner and the stored maximum are the input's own.
//
// Replaces incubator_mxnet_tpu/parallel/maxpool_idx.py maxpool_with_index
// (its Pallas `_kernel`): the pooled maximum with -inf padding, plus an
// int8 plane holding the first row-major in-window argmax (strict >, so
// ties keep the earlier slot: the winner that select_and_scatter_add and
// MXNet's pool.h unpool_max_* pick).  NaN propagates to the maximum while
// the index keeps its slot, as jnp.maximum and the strict compare do.  The
// backward routes gradients from the int8 plane alone (maxpool_idx.py
// indexed_unpool, plain torch).
//
// What bounds it on the H100: bytes.  The stem (256, 64, 112, 112) bf16
// reads 411 MB and writes 103 MB of output and 51 MB of indices, 0.169 ms
// at 3.35 TB/s; but the compares come close (below).
//
// The design: one read of each input row from device memory.  A band is
// output rows [oy0, oy1) of one (n, c) plane; it reads input rows
// [oy0 sh - ph, (oy1 - 1) sh - ph + kh) clipped to the plane, which in
// NCHW are one contiguous run.  The run is staged into shared memory by
// one 1D bulk copy (bulk_copy.cuh) completing on an mbarrier; where the
// run does not start or end on 16 bytes (odd W in bf16, an input off the
// 16-byte grid) the bulk copy takes the 16-byte-aligned interior and at
// most 15 bytes at each end are loaded by threads.  The -inf halo comes
// from bounds checks on the window's rows and columns, never from a
// padded copy.  A band is a whole plane where it fits MP_STAGE_BYTES (the
// stem: 25,088 bytes of bf16 input), else the plane is cut into bands of
// equal rows (f32 224x224 planes: 200 KB); kh > sh makes neighbouring
// bands overlap by kh - sh input rows, read twice.  CTAs are persistent:
// as many as fit on the card at once (four an SM at the stem), each
// walking every gridDim.x-th band with MP_STAGES stages, so the next
// band's copy is in flight while this one is compared and written.
//
// Out of shared memory the windows of 3x3/2 (the stem) and 3x3/1 are
// walked in strips (pool_band_strips): a thread takes one output column
// of a strip of output rows, keeping the input row that consecutive
// windows share in registers, and a warp whose 32 strips read no padding
// runs a loop without bounds checks.  Other windows take the whole-window
// walk (pool_band): a thread takes outputs tid, tid + 256, ... in
// row-major order.  Either way a warp reads 32 neighbouring windows (bf16
// at stride 2: 4-byte spacing, no bank conflict) and writes 32
// neighbouring outputs and indices, and the window is unrolled for 3x3
// and 2x2.  Where even kh input rows of one output row exceed
// MP_STAGE_BYTES, the whole-window walk reads device memory directly, one
// output row a band.
//
// At the stem in bf16 the instructions an output, not the bytes, set the
// time: the f32 stem moves twice the bytes for the same outputs at about
// the rate of K7's copy, and in variants built side by side (on an NVIDIA
// H100 80GB HBM3 at 700 W, the L2 flushed before each launch) each step
// that cut instructions an output cut the bf16 time: the strips against
// one thread an output reading its 9 values, then the unchecked loop.
// Putting the edge columns' strips last, or a third stage, was slower.
// Its times beside the parent's are in PERF.md (chip_smoke.py phase 4).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "bulk_copy.cuh"

#define MP_THREADS 256
#define MP_STAGES 2
#define MP_STAGE_BYTES (48 * 1024)

namespace {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }
__device__ __forceinline__ double to_f(double v) { return v; }
__device__ __forceinline__ void store(float* p, int64_t i, float v) { p[i] = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, int64_t i, float v) {
  p[i] = __float2bfloat16(v);
}
__device__ __forceinline__ void store(__half* p, int64_t i, float v) { p[i] = __float2half(v); }
__device__ __forceinline__ void store(double* p, int64_t i, double v) { p[i] = v; }

// the type a window's compares run in
template <typename T>
struct Acc {
  using type = float;
};
template <>
struct Acc<double> {
  using type = double;
};

// Output rows [oy0, oy1) of plane p and the input rows [iy0, iy1) they
// read; lo and hi bound those input rows in elements of the whole tensor.
struct Band {
  int64_t plane, lo, hi;
  int oy0, oy1, iy0;
  __device__ __forceinline__ Band(int64_t b, int bpp, int rows, int H, int W, int OH, int kh,
                                  int sh, int ph) {
    // a 32-bit division where the band index fits (64-bit division is a
    // long software sequence)
    plane = b <= INT32_MAX ? static_cast<int>(b) / bpp : b / bpp;
    oy0 = static_cast<int>(b - plane * bpp) * rows;
    oy1 = min(OH, oy0 + rows);
    iy0 = max(0, oy0 * sh - ph);
    const int iy1 = min(H, (oy1 - 1) * sh - ph + kh);
    const int64_t base = plane * H * W;
    lo = base + static_cast<int64_t>(iy0) * W;
    hi = base + static_cast<int64_t>(max(iy1, iy0)) * W;
  }
};

// The part of a band's run a bulk copy takes: [a, b) bytes of global
// memory, both on 16 bytes (b <= a: none); the run's element lo lands at
// stage + 16 - (a - lo bytes), so a lands on stage + 16.
struct Span {
  uintptr_t lo, hi, a, b;
  __device__ __forceinline__ Span(const void* x, const Band& bd, int esize) {
    lo = reinterpret_cast<uintptr_t>(x) + static_cast<uintptr_t>(bd.lo) * esize;
    hi = reinterpret_cast<uintptr_t>(x) + static_cast<uintptr_t>(bd.hi) * esize;
    a = (lo + 15) & ~static_cast<uintptr_t>(15);
    b = hi & ~static_cast<uintptr_t>(15);
  }
  __device__ __forceinline__ bool bulk() const { return b > a; }
};

// max that propagates NaN (max.NaN.f32)
__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}
// f64 has no max.NaN: the first NaN seen, else the larger
__device__ __forceinline__ double max_nan(double a, double b) {
  return isnan(a) ? a : isnan(b) ? b : fmax(a, b);
}

// One window's running maximum and first argmax over its slots in
// row-major order, as the reference scans them: a slot wins only when it
// is strictly greater, so ties keep the earlier slot.  `run` is the
// maximum with NaN propagated (max.NaN): once a NaN has been seen every
// later compare is false, so the index keeps the slot it had, and the
// output is that NaN; `best` is the winning value itself (its sign of
// zero included).
template <typename A>
struct Window {
  A best, run;
  int win;
  __device__ __forceinline__ void first(A v) {
    best = run = v;
    win = 0;
  }
  __device__ __forceinline__ void take(A v, int lin) {
    const bool p = v > run;
    best = p ? v : best;
    win = p ? lin : win;
    run = max_nan(run, v);
  }
  __device__ __forceinline__ A out() const { return isnan(run) ? run : best; }
};

// The pooled maximum and first argmax of the band's outputs, from `src`,
// which holds input rows iy0.. of the band at pitch W (shared memory, or
// the input itself): thread tid takes outputs tid, tid + MP_THREADS, ...
// in row-major order, each window read whole (KH, KW 0: any window, else
// unrolled).
template <typename T, int KH, int KW>
__device__ __forceinline__ void pool_band(const T* src, const Band& bd, T* out, int8_t* idx,
                                          int H, int W, int OH, int OW, int kh_, int kw_,
                                          int sh, int sw, int ph, int pw) {
  using A = typename Acc<T>::type;
  const int kh = KH ? KH : kh_, kw = KW ? KW : kw_;
  const int n = (bd.oy1 - bd.oy0) * OW;
  const int dy = MP_THREADS / OW, dx = MP_THREADS - dy * OW;
  int oy = bd.oy0 + static_cast<int>(threadIdx.x) / OW;
  int ox = static_cast<int>(threadIdx.x) % OW;
  const int64_t ob = (bd.plane * OH + bd.oy0) * OW;
  for (int j = threadIdx.x; j < n; j += MP_THREADS) {
    const int y0 = oy * sh - ph, x0 = ox * sw - pw;
    Window<A> w;
#pragma unroll
    for (int r = 0; r < (KH ? KH : 1); ++r) {
      for (int rr = 0; rr < (KH ? 1 : kh); ++rr) {
        const int ky = KH ? r : rr;
        const int iy = y0 + ky;
        const bool row_in = static_cast<unsigned>(iy) < static_cast<unsigned>(H);
        const T* row = src + (iy - bd.iy0) * W;
#pragma unroll
        for (int c = 0; c < (KW ? KW : 1); ++c) {
          for (int cc = 0; cc < (KW ? 1 : kw); ++cc) {
            const int kx = KW ? c : cc;
            const int ix = x0 + kx;
            const A v = row_in && static_cast<unsigned>(ix) < static_cast<unsigned>(W)
                            ? to_f(row[ix])
                            : static_cast<A>(-INFINITY);
            if (ky == 0 && kx == 0)
              w.first(v);
            else
              w.take(v, ky * kw + kx);
          }
        }
      }
    }
    store(out, ob + j, w.out());
    idx[ob + j] = static_cast<int8_t>(w.win);
    oy += dy;
    ox += dx;
    if (ox >= OW) {
      ox -= OW;
      ++oy;
    }
  }
}

// The same for a KH x KW window at row stride SH <= KH, walked in
// strips: item (strip, ox) is output column ox of a strip of output rows,
// one after another, so the KH - SH input rows two consecutive windows
// share stay in registers (at the stem's 3x3/2 a window reads 6 values of
// shared memory, not 9) and the column checks are made once an item.  A
// band has as many strips as its threads take in one pass
// (MP_THREADS / OW), so a warp reads neighbouring windows of one row (bf16
// at stride 2: 4-byte spacing, no bank conflict) and writes 32
// neighbouring outputs and indices.  A warp whose strips all lie inside
// the plane (at the stem all but the first strip and the first column)
// takes the loop without bounds checks.
template <typename T, int KH, int KW, int SH>
__device__ __forceinline__ void pool_band_strips(const T* src, const Band& bd, T* out,
                                                 int8_t* idx, int H, int W, int OH, int OW,
                                                 int sw, int ph, int pw) {
  using A = typename Acc<T>::type;
  const int rows = bd.oy1 - bd.oy0;
  out += (bd.plane * OH + bd.oy0) * OW;  // the band's outputs, 32-bit offsets
  idx += (bd.plane * OH + bd.oy0) * OW;
  const int per = min(rows, max(1, MP_THREADS / OW));  // strips wanted
  const int sr = (rows + per - 1) / per;                // rows a strip
  const int items = (rows + sr - 1) / sr * OW;
  for (int it = threadIdx.x; it < items; it += MP_THREADS) {
    const int st = it / OW, ox = it - st * OW;
    const int oya = bd.oy0 + st * sr, oyb = min(bd.oy1, oya + sr);
    const int x0 = ox * sw - pw;
    const bool inside = x0 >= 0 && x0 + KW <= W && oya * SH - ph >= 0 &&
                        (oyb - 1) * SH - ph + KH <= H;
    auto walk = [&](auto checked) {  // std::true_type: check rows and columns
      constexpr bool kChecked = decltype(checked)::value;
      bool col_in[KW];
#pragma unroll
      for (int c = 0; c < KW; ++c)
        col_in[c] = !kChecked || static_cast<unsigned>(x0 + c) < static_cast<unsigned>(W);
      A v[KH][KW];
      auto load_row = [&](A (&r)[KW], int iy) {
        const bool row_in = !kChecked || static_cast<unsigned>(iy) < static_cast<unsigned>(H);
        const T* row = src + (iy - bd.iy0) * W + x0;
#pragma unroll
        for (int c = 0; c < KW; ++c)
          r[c] = row_in && col_in[c] ? to_f(row[c]) : static_cast<A>(-INFINITY);
      };
      int y0 = oya * SH - ph;
#pragma unroll
      for (int r = 0; r < KH - SH; ++r) load_row(v[r], y0 + r);
      for (int oy = oya, o = (oya - bd.oy0) * OW + ox; oy < oyb; ++oy, y0 += SH, o += OW) {
#pragma unroll
        for (int r = KH - SH; r < KH; ++r) load_row(v[r], y0 + r);
        Window<A> w;
        w.first(v[0][0]);
#pragma unroll
        for (int lin = 1; lin < KH * KW; ++lin) w.take(v[lin / KW][lin % KW], lin);
        store(out, o, w.out());
        idx[o] = static_cast<int8_t>(w.win);
#pragma unroll
        for (int r = 0; r < KH - SH; ++r)
#pragma unroll
          for (int c = 0; c < KW; ++c) v[r][c] = v[r + SH][c];
      }
    };
    if (__all_sync(__activemask(), inside))
      walk(std::false_type());
    else
      walk(std::true_type());
  }
}

// A band's outputs: strips for a KH x KW window at row stride SH, or (SH
// 0) the whole-window walk (KH, KW 0: any window)
template <typename T, int KH, int KW, int SH>
__device__ __forceinline__ void pool(const T* src, const Band& bd, T* out, int8_t* idx, int H,
                                     int W, int OH, int OW, int kh, int kw, int sh, int sw,
                                     int ph, int pw) {
  if constexpr (SH != 0)
    pool_band_strips<T, KH, KW, SH>(src, bd, out, idx, H, W, OH, OW, sw, ph, pw);
  else
    pool_band<T, KH, KW>(src, bd, out, idx, H, W, OH, OW, kh, kw, sh, sw, ph, pw);
}

// Persistent CTAs over `nbands` bands of `rows` output rows (bpp a
// plane).  kStaged: each band's run staged in one of MP_STAGES buffers of
// `stage` bytes; else read from device memory.
template <typename T, int KH, int KW, int SH, bool kStaged>
__global__ void __launch_bounds__(MP_THREADS)
maxpool_idx_kernel(const T* __restrict__ x, T* __restrict__ out, int8_t* __restrict__ idx,
                   int64_t nbands, int bpp, int rows, int stage, int H, int W, int OH,
                   int OW, int kh, int kw, int sh, int sw, int ph, int pw) {
  if (!kStaged) {
    for (int64_t b = blockIdx.x; b < nbands; b += gridDim.x) {
      const Band bd(b, bpp, rows, H, W, OH, kh, sh, ph);
      pool<T, KH, KW, SH>(x + bd.lo, bd, out, idx, H, W, OH, OW, kh, kw, sh, sw, ph, pw);
    }
    return;
  }
  extern __shared__ float4 smem4[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem4);
  __shared__ uint64_t bar[MP_STAGES];
  constexpr int es = sizeof(T);

  // thread 0 arms stage s's barrier and copies band b's aligned interior
  auto issue = [&](int64_t b, int s) {
    const Span sp(x, Band(b, bpp, rows, H, W, OH, kh, sh, ph), es);
    const unsigned bytes = sp.bulk() ? static_cast<unsigned>(sp.b - sp.a) : 0u;
    bar_expect(&bar[s], bytes);
    if (bytes) bulk_load(smem + s * stage + 16, reinterpret_cast<const void*>(sp.a), bytes,
                         &bar[s]);
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < MP_STAGES; ++s) bar_init(&bar[s]);
    for (int s = 0; s < MP_STAGES; ++s) {
      const int64_t b = blockIdx.x + static_cast<int64_t>(s) * gridDim.x;
      if (b < nbands) issue(b, s);
    }
  }
  __syncthreads();
  int i = 0;
  for (int64_t b = blockIdx.x; b < nbands; b += gridDim.x, ++i) {
    const int s = i % MP_STAGES;
    const Band bd(b, bpp, rows, H, W, OH, kh, sh, ph);
    const Span sp(x, bd, es);
    // element lo of the band at st[0]
    const T* st = reinterpret_cast<const T*>(smem + s * stage + 16 -
                                             (sp.bulk() ? sp.a - sp.lo : 0));
    // the ends the bulk copy does not take (all of a run under 32 bytes)
    const int head = static_cast<int>(((sp.bulk() ? sp.a : sp.hi) - sp.lo) / es);
    const int tail = sp.bulk() ? static_cast<int>((sp.hi - sp.b) / es) : 0;
    if (head + tail > 0) {
      T* w = const_cast<T*>(st);
      const int t = threadIdx.x;
      if (t < head) w[t] = x[bd.lo + t];
      const int64_t tb = static_cast<int64_t>(sp.b - sp.lo) / es;
      if (t >= 32 && t < 32 + tail) w[tb + t - 32] = x[bd.lo + tb + t - 32];
      __syncthreads();
    }
    bar_wait(&bar[s], (i / MP_STAGES) & 1);
    pool<T, KH, KW, SH>(st, bd, out, idx, H, W, OH, OW, kh, kw, sh, sw, ph, pw);
    fence_proxy_async();  // this thread's reads and writes of stage s come first
    __syncthreads();      // every thread is done with stage s
    const int64_t next = b + static_cast<int64_t>(MP_STAGES) * gridDim.x;
    if (threadIdx.x == 0 && next < nbands) issue(next, s);
  }
}

// How a launch runs: bands of `rows` output rows, bpp a plane; staged in
// buffers of `stage` bytes, or read from device memory (staged 0).
struct Plan {
  int rows, bpp, staged, stage;
};

// The largest band whose run (at most (rows - 1) sh + kh input rows, and
// 32 bytes for the unaligned ends) fits MP_STAGE_BYTES, evened out over
// the plane; one output row a band, unstaged, where kh rows do not fit.
Plan plan(int esize, int H, int W, int OH, int kh, int sh) {
  const int64_t row_bytes = static_cast<int64_t>(W) * esize;
  const int64_t fit = (MP_STAGE_BYTES - 32) / row_bytes;  // input rows a stage holds
  if (fit < kh && fit < H) return Plan{1, OH, 0, 0};
  int rows = fit >= H ? OH : static_cast<int>((fit - kh) / sh + 1);
  if (rows > OH) rows = OH;
  const int bpp = (OH + rows - 1) / rows;
  rows = (OH + bpp - 1) / bpp;
  const int64_t in_rows = min(static_cast<int64_t>(H), static_cast<int64_t>(rows - 1) * sh + kh);
  const int stage = static_cast<int>((in_rows * row_bytes + 32 + 15) / 16 * 16);
  return Plan{rows, bpp, 1, stage};
}

template <typename T, int KH, int KW, int SH>
int launch(const Plan& pl, int64_t nbands, cudaStream_t s, const T* x, T* out, int8_t* idx,
           int H, int W, int OH, int OW, int kh, int kw, int sh, int sw, int ph, int pw) {
  auto* kernel = pl.staged ? &maxpool_idx_kernel<T, KH, KW, SH, true>
                           : &maxpool_idx_kernel<T, KH, KW, SH, false>;
  const int smem = pl.staged ? MP_STAGES * pl.stage : 0;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, MP_THREADS, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int64_t resident = static_cast<int64_t>(sms) * per_sm;
  if (resident < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const unsigned grid = static_cast<unsigned>(resident < nbands ? resident : nbands);
  kernel<<<grid, MP_THREADS, smem, s>>>(x, out, idx, nbands, pl.bpp, pl.rows, pl.stage, H, W,
                                        OH, OW, kh, kw, sh, sw, ph, pw);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_window(const void* x, void* out, void* idx, int N, int C, int H, int W, int OH,
                  int OW, int kh, int kw, int sh, int sw, int ph, int pw, cudaStream_t s) {
  const Plan pl = plan(sizeof(T), H, W, OH, kh, sh);
  const int64_t nbands = static_cast<int64_t>(N) * C * pl.bpp;
  const T* xp = static_cast<const T*>(x);
  T* op = static_cast<T*>(out);
  int8_t* ip = static_cast<int8_t*>(idx);
  // strips for the windows of ResNet's stem (3x3/2) and 3x3/1; 2x2
  // windows (no row to share at stride 2) and the rest whole
  if (kh == 3 && kw == 3 && sh == 2)
    return launch<T, 3, 3, 2>(pl, nbands, s, xp, op, ip, H, W, OH, OW, kh, kw, sh, sw, ph, pw);
  if (kh == 3 && kw == 3 && sh == 1)
    return launch<T, 3, 3, 1>(pl, nbands, s, xp, op, ip, H, W, OH, OW, kh, kw, sh, sw, ph, pw);
  if (kh == 2 && kw == 2)
    return launch<T, 2, 2, 0>(pl, nbands, s, xp, op, ip, H, W, OH, OW, kh, kw, sh, sw, ph, pw);
  return launch<T, 0, 0, 0>(pl, nbands, s, xp, op, ip, H, W, OH, OW, kh, kw, sh, sw, ph, pw);
}

// bytes an element of a dtype code (below)
int esize(int dtype) { return dtype == 0 ? 4 : dtype == 3 ? 8 : 2; }

}  // namespace

// The output rows a band of K3 takes for this shape (0: read from device
// memory, unstaged, one row a band); launches nothing.
extern "C" int maxpool_idx_band_rows(int dtype, int H, int W, int OH, int kh, int sh) {
  const Plan pl = plan(esize(dtype), H, W, OH, kh, sh);
  return pl.staged ? pl.rows : 0;
}

// dtype: 0 = float32, 1 = bfloat16, 2 = float16, 3 = float64.  ph/pw are the low-edge paddings; the
// caller sizes OH/OW (the high edge may pad more).  Returns
// cudaGetLastError() after the launch (or the error of sizing it).
extern "C" int maxpool_idx_fwd(int dtype, const void* x, void* out, void* idx, int N,
                               int C, int H, int W, int OH, int OW, int kh, int kw, int sh,
                               int sw, int ph, int pw, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N < 1 || C < 1 || OH < 1 || OW < 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype) {
    case 0:
      return launch_window<float>(x, out, idx, N, C, H, W, OH, OW, kh, kw, sh, sw, ph, pw, s);
    case 1:
      return launch_window<__nv_bfloat16>(x, out, idx, N, C, H, W, OH, OW, kh, kw, sh, sw, ph,
                                          pw, s);
    case 2:
      return launch_window<__half>(x, out, idx, N, C, H, W, OH, OW, kh, kw, sh, sw, ph, pw, s);
    case 3:
      return launch_window<double>(x, out, idx, N, C, H, W, OH, OW, kh, kw, sh, sw, ph, pw, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
