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
// The TPU needed three forms (whole-L window, lane-fold, spatial tiles) to
// fit its VMEM window, and held the window so that its backward reads
// each input once.  Here one kernel a direction covers every layer shape,
// with two forms behind the same entry.
//
// What bounds it on the H100: bytes.  Per element the forward does about
// 7 f32 operations and the backward about 12, against 2-10 bytes moved,
// far below the card's ~20 f32 operations per byte of HBM bandwidth.  The
// least traffic is one read of every input and one write of every output.
//
// The walk is K7's (ghost_bn_walk.cuh): slice (cb, g) is kc channels of
// ghost group g, ng contiguous runs of kc * HW elements, kc from
// walk_channels capped at GBN_MAX_KC (its per-channel arrays are static).
// Each element's channel is (its index in the run) / HW: a 16-byte vector
// straddles two channels at HW = 49 and 196.
//
// The staged form (one read of each input): a slice's runs of every tensor
// the kernel reads (K1: x, + the residual r; K2: gy, + gy2 of the dual
// form, x, + the saved y of the residual forms) are copied once into
// shared memory by 1D bulk copies (cp.async.bulk, one a run, completing on
// an mbarrier), and both passes read them there.  Where a slice is larger
// than GBN_SHARE_BYTES a thread-block cluster of cs CTAs (cs a power of
// two dividing ng, at most GBN_MAX_CLUSTER) shares it, each CTA holding
// ng / cs of the runs.  The CTAs are persistent: as many clusters as fit on
// the card at once, each walking every clusters-th slice; a share of at
// most GBN_DOUBLE_BYTES has two buffers, so the next slice's copy is in
// flight while this one is summed and written (larger shares take one, and
// the two CTAs an SM then overlap each other).  A slice's sums are taken
// channel by channel by groups of warps (no barrier a channel); after one
// cluster barrier every CTA adds the cs CTAs' partial pairs in rank order
// through distributed shared memory, so all of them hold the same totals
// (the partials alternate between two buffers from slice to slice).  The
// sums read 16-byte units where HW is a whole number of them, 8-byte
// units where it is one of those (HW = 196 in bf16), else elements.  Then
// each CTA writes its runs' outputs from shared memory, 16 bytes a thread
// in K7's order.  A slice of one channel (kc = 1) has a write loop of its
// own with the coefficients in registers; with several, each 16-byte
// unit's channels come from one division (Span) and the coefficients from
// a per-slice table in shared memory.  At
// ResNet-50's bf16 shapes, batch 256, ng 16:
//   112x112x64: K1 401 KB a slice, a cluster of 4; K2 (gy, x) 802 KB, 8;
//   56x56x64: K1 100 KB, one CTA; K2 200 KB, 2;  56x56x256 exits: K2 (gy,
//     gy2, x, y) 401 KB, 4;
//   28x28 and smaller: at most 100 KB a slice, one CTA, two buffers up to
//     56 KB.
// f32 doubles every figure and stays staged up to GBN_MAX_SHARE a CTA.
// Chosen on an NVIDIA H100 80GB HBM3 at 700 W against variants built side
// by side (flushed device time over the 53 BN layers of a ResNet-50 step):
// shares of 28-64 KB with clusters of up to 16, shares of 200 KB, 512 or
// 1024 threads a CTA, two buffers at one CTA an SM, and more channels a
// slice at 7x7 and 14x14 were each slower; the kc = 1 write loop took 10 %
// off K2 (PERF.md).
//
// The two-read form: where a run is not a whole number of 16-byte
// vectors, a tensor does not start on 16 bytes (the odd shapes, C = 3 or
// HW = 5; views), or a share does not fit GBN_MAX_SHARE with a cluster
// that divides ng, the same kernels, one CTA a slice, read the runs
// straight from device memory element by element, once for the sums and
// once for the outputs.  No ResNet-50 shape at batch 256 takes it.
//
// Numerics follow the reference (fused_bn.py _gbn_ref / _gbn_bwd_jnp):
// single-pass moments, var = max(E[x^2] - mean^2, 0) (not Welford),
// rstd = rsqrt(var + eps), y = x * (gamma * rstd) + (beta - mean * gamma *
// rstd) [+ residual] [ReLU].  The backward mask is the saved y > 0 in the
// residual forms and the recomputed xhat * gamma + beta > 0 otherwise;
// dX = gamma * rstd * (gp - (sum(gp) / n + xhat * sum(gp * xhat) / n)),
// the two quotients taken once a channel (the reference divides their sum
// by n: the same up to rounding).  ReLU keeps NaN (as jnp.maximum does), so
// a non-finite step stays visible to the train step's finiteness guard.
// Sums are taken in a fixed order: a launch is deterministic.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "bulk_copy.cuh"
#include "ghost_bn_walk.cuh"

#define GBN_MAX_KC 64
#define GBN_MAX_CLUSTER 8
#define GBN_SHARE_BYTES (100 * 1024)
#define GBN_DOUBLE_BYTES (56 * 1024)
#define GBN_MAX_SHARE (224 * 1024)
#define GBN_THREADS 256
#define GBN_MIN_BLOCKS 2

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = GBN_THREADS / 32;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// V elements, loaded and stored as one access (16 bytes when V fills them)
template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T e[V];
};
template <int V, typename T>
__device__ __forceinline__ Pack<T, V> ld(const T* p) {
  return *reinterpret_cast<const Pack<T, V>*>(p);
}
template <int V, typename T>
__device__ __forceinline__ void st(T* p, const Pack<T, V>& v) {
  *reinterpret_cast<Pack<T, V>*>(p) = v;
}

// ReLU that keeps NaN, like jnp.maximum(v, 0).
__device__ __forceinline__ float relu_nan(float v) { return v < 0.f ? 0.f : v; }

// Walks (p, v) pairs of nl runs of n units in row-major order, from
// `start`, `step` pairs a step, without a division a step (32-bit: a
// block's units fit).
struct Iter {
  int p, v, dp, dv, n;
  __device__ __forceinline__ Iter(int start, int step, int n_)
      : p(start / n_), v(start % n_), dp(step / n_), dv(step % n_), n(n_) {}
  __device__ __forceinline__ void next() {
    p += dp;
    v += dv;
    if (v >= n) {
      v -= n;
      ++p;
    }
  }
};

// What a CTA walks: slice s (channel block cb of ghost group g) of a
// (C / kc) x G grid of slices, its share (images rank * nl ..
// rank * nl + nl - 1 of the group) as rank `rank` of a cluster of cs.
struct Geo {
  int C, HW, ng, kc, cs, rank, nl, ncb;
  int64_t run, plane;
  __device__ __forceinline__ Geo(int C_, int HW_, int ng_, int kc_, int cs_)
      : C(C_), HW(HW_), ng(ng_), kc(kc_), cs(cs_) {
    rank = blockIdx.x % cs;
    nl = ng / cs;
    ncb = C / kc;
    run = static_cast<int64_t>(kc) * HW;
    plane = static_cast<int64_t>(C) * HW;
  }
  __device__ __forceinline__ int cb(int s) const { return s % ncb; }
  __device__ __forceinline__ int g(int s) const { return s / ncb; }
  // the first element of the share's first run
  __device__ __forceinline__ int64_t goff(int s) const {
    return (static_cast<int64_t>(g(s)) * ng + rank * nl) * plane +
           static_cast<int64_t>(cb(s)) * run;
  }
};

// The share of slice s of each of the nt tensors src[0..nt) into sm
// (tensor t's run p at sm + (t * nl + p) * run), completing on b.  Warp 0
// issues one bulk copy a run; the block's earlier reads and writes of sm
// are done (a __syncthreads), and the proxy fence orders them before the
// copies' writes.
template <typename T>
__device__ __forceinline__ void issue(T* sm, const T* const (&src)[4], int nt,
                                      const Geo& w, int s, uint64_t* b) {
  if (threadIdx.x >= 32) return;
  fence_proxy_async();
  const unsigned bytes = static_cast<unsigned>(w.run * sizeof(T));
  if (threadIdx.x == 0) bar_expect(b, bytes * w.nl * nt);
  __syncwarp();
  const int64_t go = w.goff(s);
  for (int i = threadIdx.x; i < w.nl * nt; i += 32) {
    const int t = i / w.nl, p = i - t * w.nl;
    bulk_load(sm + i * w.run, src[t] + go + p * w.plane, bytes, b);
  }
}

// Per-channel sums of a share: channel c of run p is at src + p * pitch
// + c * HW.  The block's warps form min(kc, kWarps) groups; group gi takes
// channels gi, gi + groups, ..., its threads striding through the
// channel's units of V elements (f(pointer, run, offset in the channel, c,
// a, b) adds a unit to the thread's pair), each warp reduces by shuffles,
// and part[c], part[kc + c] are the warps' pairs added in a fixed order.
// No barrier a channel; ends with the block synchronised.
template <int V, typename T, typename F>
__device__ __forceinline__ void channel_sums(const T* src, int64_t pitch, const Geo& w,
                                             float* wpart, float* part, F f) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int groups = min(w.kc, kWarps), wpc = kWarps / groups, gi = warp / wpc;
  if (gi < groups) {
    const int k = warp - gi * wpc;
    for (int c = gi; c < w.kc; c += groups) {
      float a = 0.f, b = 0.f;
      const T* base = src + static_cast<int64_t>(c) * w.HW;
      for (Iter it(k * 32 + lane, wpc * 32, w.HW / V); it.p < w.nl; it.next())
        f(base + it.p * pitch + it.v * V, it.p, it.v * V, c, a, b);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        a += __shfl_xor_sync(0xffffffffu, a, o);
        b += __shfl_xor_sync(0xffffffffu, b, o);
      }
      if (lane == 0) {
        wpart[c * wpc + k] = a;
        wpart[GBN_MAX_KC + c * wpc + k] = b;
      }
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < w.kc; c += blockDim.x) {
    float a = 0.f, b = 0.f;
    for (int k = 0; k < wpc; ++k) {
      a += wpart[c * wpc + k];
      b += wpart[GBN_MAX_KC + c * wpc + k];
    }
    part[c] = a;
    part[w.kc + c] = b;
  }
}

// Which channels the V elements of a unit at offset i0 of a run belong to:
// c0 = i0 / HW for the first nb of them and c0 + 1 for the rest (nb >= V:
// all of them in c0).  Where HW < V a unit can span more than two channels
// (`few` is false): each element then takes its own, (i0 + e) / HW.
struct Span {
  int c0, nb;
  bool few;
  __device__ __forceinline__ Span(int i0, int HW, int kc, int V) {
    c0 = kc == 1 ? 0 : i0 / HW;
    nb = kc == 1 ? V : (c0 + 1) * HW - i0;
    few = kc == 1 || HW >= V;
  }
};

// The totals of this slice over the cluster: part itself where cs = 1,
// else tot, the sum over the cluster's cs CTAs of their part[0..n) in rank
// order (every CTA of the cluster adds the same numbers in the same
// order).  Ends with the block synchronised.  part alternates between two
// buffers from slice to slice, so that one cluster barrier a slice keeps
// a CTA from overwriting partials another CTA may still read.
__device__ __forceinline__ const float* totals(const float* part, float* tot, int n, int cs) {
  if (cs == 1) {
    __syncthreads();
    return part;
  }
  cg::cluster_group cl = cg::this_cluster();
  cl.sync();  // every CTA's partials are in its shared memory
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    float s = 0.f;
    for (int r = 0; r < cs; ++r) s += cl.map_shared_rank(part, r)[i];
    tot[i] = s;
  }
  __syncthreads();
  return tot;
}

// The loop of a persistent CTA over its slices s = cluster, cluster +
// clusters, ...: in the staged form the share of slice i lands in buffer
// i % nbuf (of nbuf, at sm + buffer * nt * share) and the copy of slice
// i + nbuf is issued as soon as slice i's outputs are written, so with two
// buffers the next slice's copy overlaps this one's sums and writes.
// body(s, i, buffer or null) does one slice and ends with the block
// synchronised.
template <bool kStaged, typename T, typename Body>
__device__ __forceinline__ void slices(const Geo& w, int G, int nbuf, int nt, T* sm,
                                       const T* const (&src)[4], uint64_t* bar,
                                       Body body) {
  const int nsl = w.ncb * G;
  const int ncl = gridDim.x / w.cs;
  const int64_t stride = nt * w.nl * w.run;  // elements of one buffer
  int s = blockIdx.x / w.cs;
  if (kStaged) {
    if (threadIdx.x == 0)
      for (int b = 0; b < nbuf; ++b) bar_init(&bar[b]);
    __syncthreads();
    for (int b = 0; b < nbuf && s + b * ncl < nsl; ++b)
      issue(sm + b * stride, src, nt, w, s + b * ncl, &bar[b]);
  }
  for (int i = 0; s < nsl; s += ncl, ++i) {
    T* buf = nullptr;
    if (kStaged) {
      const int b = i % nbuf;
      bar_wait(&bar[b], (i / nbuf) & 1);
      buf = sm + b * stride;
    }
    body(s, i, buf);
    if (kStaged && s + nbuf * ncl < nsl)
      issue(buf, src, nt, w, s + nbuf * ncl, &bar[i % nbuf]);
  }
  if (w.cs > 1) cg::this_cluster().sync();  // no CTA leaves while others read it
}

// --- K1 -------------------------------------------------------------------

template <typename T, bool kRes, bool kRelu, bool kStaged>
__global__ void __launch_bounds__(GBN_THREADS, GBN_MIN_BLOCKS)
ghost_bn_fwd_kernel(const T* __restrict__ x, const T* __restrict__ r,
                    const float* __restrict__ gamma, const float* __restrict__ beta,
                    T* __restrict__ y, float* __restrict__ mean_out,
                    float* __restrict__ var_out, int G, int C, int HW, int ng, int kc,
                    int cs, int nbuf, float eps) {
  constexpr int kVec = WALK_VEC_BYTES / sizeof(T);
  constexpr int V = kStaged ? kVec : 1;
  extern __shared__ float4 smem4[];
  __shared__ float wpart[2 * GBN_MAX_KC], part[2][2 * GBN_MAX_KC], tot[2 * GBN_MAX_KC];
  __shared__ float tsc[GBN_MAX_KC], tsh[GBN_MAX_KC];  // scale, shift (kc > 1)
  __shared__ uint64_t bar[2];
  const Geo w(C, HW, ng, kc, cs);
  const float cnt = static_cast<float>(ng) * static_cast<float>(HW);

  auto body = [&](int s, int i, const T* buf) {
    const int64_t go = w.goff(s);
    const int cb = w.cb(s), g = w.g(s);
    // the shares of x (and r): staged one after the other, or in device
    // memory
    const T* sx = kStaged ? buf : x + go;
    const T* sr = kStaged ? buf + w.nl * w.run : r + go;
    const int64_t pitch = kStaged ? w.run : w.plane;
    auto add = [&](auto a, float& s1, float& s2) {
#pragma unroll
      for (int e = 0; e < static_cast<int>(sizeof(a.e) / sizeof(T)); ++e) {
        const float v = to_f(a.e[e]);
        s1 += v;
        s2 += v * v;
      }
    };
    float* pt = part[i & 1];
    if (kStaged && HW % kVec == 0)
      channel_sums<kVec>(sx, pitch, w, wpart, pt,
                         [&](const T* p, int, int, int, float& a, float& b) {
                           add(ld<kVec>(p), a, b);
                         });
    else if (kStaged && HW % (kVec / 2) == 0)
      channel_sums<kVec / 2>(sx, pitch, w, wpart, pt,
                             [&](const T* p, int, int, int, float& a, float& b) {
                               add(ld<kVec / 2>(p), a, b);
                             });
    else
      channel_sums<1>(sx, pitch, w, wpart, pt,
                      [&](const T* p, int, int, int, float& a, float& b) {
                        add(ld<1>(p), a, b);
                      });
    const float* tt = totals(pt, tot, 2 * kc, cs);

    // y = x * scale + shift of channel c (the statistics from the totals)
    auto coef = [&](int c, float& scale, float& shift) {
      const int cgl = cb * kc + c;
      const float m = tt[c] / cnt;
      const float var = fmaxf(tt[kc + c] / cnt - m * m, 0.f);
      const float rstd = rsqrtf(var + eps);
      const float gm = gamma[cgl];
      scale = gm * rstd;
      shift = beta[cgl] - m * gm * rstd;
    };
    if (w.rank == 0)
      for (int c = threadIdx.x; c < kc; c += blockDim.x) {
        const float m = tt[c] / cnt;
        mean_out[static_cast<int64_t>(g) * C + cb * kc + c] = m;
        var_out[static_cast<int64_t>(g) * C + cb * kc + c] =
            fmaxf(tt[kc + c] / cnt - m * m, 0.f);
      }
    float sc0, sh0, sc1 = 0.f, sh1 = 0.f;
    coef(0, sc0, sh0);
    if (kc > 1) {  // a table of every channel's coefficients
      for (int c = threadIdx.x; c < kc; c += blockDim.x) coef(c, tsc[c], tsh[c]);
      __syncthreads();
    }
    // the write pass, one loop for one channel a slice and one for several
    auto write = [&](auto multi) {
      constexpr bool kMulti = decltype(multi)::value;
      for (Iter it(threadIdx.x, blockDim.x, static_cast<int>(w.run / V)); it.p < w.nl;
           it.next()) {
        const int i0 = it.v * V;
        const int64_t so = it.p * pitch + i0;
        const Pack<T, V> xv = ld<V>(sx + so);
        Pack<T, V> rv;
        if (kRes) rv = ld<V>(sr + so);
        Span sp(i0, HW, kc, V);
        if (kMulti) {
          sc0 = tsc[sp.c0];
          sh0 = tsh[sp.c0];
          if (sp.nb < V && sp.few) {
            sc1 = tsc[sp.c0 + 1];
            sh1 = tsh[sp.c0 + 1];
          }
        }
        Pack<T, V> out;
#pragma unroll
        for (int e = 0; e < V; ++e) {
          float a = sc0, b = sh0;
          if (kMulti && e >= sp.nb && sp.few) {
            a = sc1;
            b = sh1;
          } else if (kMulti && e >= sp.nb) {
            a = tsc[(i0 + e) / HW];
            b = tsh[(i0 + e) / HW];
          }
          float v = to_f(xv.e[e]) * a + b;
          if (kRes) v += to_f(rv.e[e]);
          if (kRelu) v = relu_nan(v);
          out.e[e] = from_f<T>(v);
        }
        st<V>(y + go + it.p * w.plane + i0, out);
      }
    };
    if (kc > 1)
      write(std::true_type());
    else
      write(std::false_type());
    __syncthreads();  // the buffer is free for the next slice's copy
  };
  const T* const src[4] = {x, kRes ? r : x, x, x};
  slices<kStaged>(w, G, nbuf, kRes ? 2 : 1, reinterpret_cast<T*>(smem4), src, bar, body);
}

// --- K2 -------------------------------------------------------------------

// The statistics and affine parameters of one channel in the backward.
struct Chan {
  float m, rstd, gm, bt;
};

// kRes: residual form (mask from the saved y, writes dR = gp).
// kDual: a second cotangent gy2 is summed in on load.
template <typename T, bool kRelu, bool kRes, bool kDual, bool kStaged>
__global__ void __launch_bounds__(GBN_THREADS, GBN_MIN_BLOCKS)
ghost_bn_bwd_kernel(const T* __restrict__ gy, const T* __restrict__ gy2,
                    const T* __restrict__ x, const T* __restrict__ y,
                    const float* __restrict__ gamma, const float* __restrict__ beta,
                    const float* __restrict__ mean, const float* __restrict__ var,
                    T* __restrict__ dx, T* __restrict__ dr,
                    float* __restrict__ dg_part, float* __restrict__ db_part, int G, int C,
                    int HW, int ng, int kc, int cs, int nbuf, float eps) {
  constexpr int kVec = WALK_VEC_BYTES / sizeof(T);
  constexpr int V = kStaged ? kVec : 1;
  constexpr int kNt = 2 + kDual + kRes;  // staged tensors: gy (, gy2), x (, y)
  constexpr bool kMaskY = kRelu && kRes;  // the mask is the saved y > 0
  extern __shared__ float4 smem4[];
  __shared__ float wpart[2 * GBN_MAX_KC], part[2][2 * GBN_MAX_KC], tot[2 * GBN_MAX_KC];
  __shared__ Chan tch[GBN_MAX_KC];                      // kc > 1: each channel's
  __shared__ float tmb[GBN_MAX_KC], tmg[GBN_MAX_KC];   // Chan, sdb / n, sdg / n
  __shared__ uint64_t bar[2];
  const Geo w(C, HW, ng, kc, cs);
  const float cnt = static_cast<float>(ng) * static_cast<float>(HW);
  const int64_t share = w.nl * w.run;

  // the masked cotangent of one element: g (+ g2) where the mask keeps it
  auto masked = [&](float g, float g2, float yv, float xhat, const Chan& ch) {
    float gv = g;
    if (kDual) gv += g2;
    if (!kRelu) return gv;
    const bool keep = kMaskY ? yv > 0.f : xhat * ch.gm + ch.bt > 0.f;
    return keep ? gv : 0.f;
  };

  auto body = [&](int s, int i, const T* buf) {
    const int64_t go = w.goff(s);
    const int cb = w.cb(s), g = w.g(s);
    auto chan = [&](int c) {
      const int cgl = cb * kc + c;
      const int64_t sidx = static_cast<int64_t>(g) * C + cgl;
      return Chan{mean[sidx], rsqrtf(var[sidx] + eps), gamma[cgl], kRes ? 0.f : beta[cgl]};
    };
    // the shares of gy (, gy2), x (, y): staged one after the other, or in
    // device memory
    const T* sg = kStaged ? buf : gy + go;
    const T* sg2 = kStaged ? buf + share : gy2 + go;
    const T* sx = kStaged ? buf + (1 + kDual) * share : x + go;
    const T* sy = kStaged ? buf + (2 + kDual) * share : y + go;
    const int64_t pitch = kStaged ? w.run : w.plane;

    // adds the units at offset o of the shares, all of channel c (a
    // thread's units come channel by channel: ch is loaded once a channel)
    int cur = -1;
    Chan ch{};
    auto add = [&](auto vec, int64_t o, int c, float& sdb, float& sdg) {
      constexpr int U = decltype(vec)::value;
      const Pack<T, U> xa = ld<U>(sx + o), ga = ld<U>(sg + o);
      const Pack<T, U> g2a = ld<U>(kDual ? sg2 + o : sx + o);
      const Pack<T, U> ya = ld<U>(kMaskY ? sy + o : sx + o);
      if (c != cur) {
        ch = chan(c);
        cur = c;
      }
#pragma unroll
      for (int e = 0; e < U; ++e) {
        const float xhat = (to_f(xa.e[e]) - ch.m) * ch.rstd;
        const float gp = masked(to_f(ga.e[e]), kDual ? to_f(g2a.e[e]) : 0.f,
                                kMaskY ? to_f(ya.e[e]) : 0.f, xhat, ch);
        sdb += gp;
        sdg += gp * xhat;
      }
    };
    float* pt = part[i & 1];
    if (kStaged && HW % kVec == 0)
      channel_sums<kVec>(sx, pitch, w, wpart, pt,
                         [&](const T* p, int, int, int c, float& a, float& b) {
                           add(std::integral_constant<int, kVec>(), p - sx, c, a, b);
                         });
    else if (kStaged && HW % (kVec / 2) == 0)
      channel_sums<kVec / 2>(sx, pitch, w, wpart, pt,
                             [&](const T* p, int, int, int c, float& a, float& b) {
                               add(std::integral_constant<int, kVec / 2>(), p - sx, c, a,
                                   b);
                             });
    else
      channel_sums<1>(sx, pitch, w, wpart, pt,
                      [&](const T* p, int, int, int c, float& a, float& b) {
                        add(std::integral_constant<int, 1>(), p - sx, c, a, b);
                      });
    const float* tt = totals(pt, tot, 2 * kc, cs);
    if (w.rank == 0)
      for (int c = threadIdx.x; c < kc; c += blockDim.x) {
        const int64_t sidx = static_cast<int64_t>(g) * C + cb * kc + c;
        db_part[sidx] = tt[c];
        dg_part[sidx] = tt[kc + c];
      }

    // dx of one element of channel ch and its gp; mb = sdb / cnt and
    // mg = sdg / cnt of the channel, taken once a channel
    auto grad = [&](float xv, float gv, float g2v, float yv, const Chan& ch, float mb,
                    float mg, float& gp) {
      const float xhat = (xv - ch.m) * ch.rstd;
      gp = masked(gv, g2v, yv, xhat, ch);
      const float kk = ch.gm * ch.rstd;
      return kk * (gp - (mb + xhat * mg));
    };
    Chan c0 = chan(0), c1 = c0;
    float db0 = tt[0] / cnt, dg0 = tt[kc] / cnt, db1 = 0.f, dg1 = 0.f;
    if (kc > 1) {  // a table of every channel's
      for (int c = threadIdx.x; c < kc; c += blockDim.x) {
        tch[c] = chan(c);
        tmb[c] = tt[c] / cnt;
        tmg[c] = tt[kc + c] / cnt;
      }
      __syncthreads();
    }
    // the write pass, one loop for one channel a slice and one for several
    auto write = [&](auto multi) {
      constexpr bool kMulti = decltype(multi)::value;
      for (Iter it(threadIdx.x, blockDim.x, static_cast<int>(w.run / V)); it.p < w.nl;
           it.next()) {
        const int i0 = it.v * V;
        const int64_t so = it.p * pitch + i0;
        const Pack<T, V> xv = ld<V>(sx + so), gv = ld<V>(sg + so);
        Pack<T, V> g2v, yv;
        if (kDual) g2v = ld<V>(sg2 + so);
        if (kMaskY) yv = ld<V>(sy + so);
        Span sp(i0, HW, kc, V);
        if (kMulti) {
          c0 = tch[sp.c0];
          db0 = tmb[sp.c0];
          dg0 = tmg[sp.c0];
          if (sp.nb < V && sp.few) {
            c1 = tch[sp.c0 + 1];
            db1 = tmb[sp.c0 + 1];
            dg1 = tmg[sp.c0 + 1];
          }
        }
        Pack<T, V> dxo, dro;
#pragma unroll
        for (int e = 0; e < V; ++e) {
          Chan ch = c0;
          float sdb = db0, sdg = dg0;
          if (kMulti && e >= sp.nb && sp.few) {
            ch = c1;
            sdb = db1;
            sdg = dg1;
          } else if (kMulti && e >= sp.nb) {
            const int c = (i0 + e) / HW;
            ch = tch[c];
            sdb = tmb[c];
            sdg = tmg[c];
          }
          float gp;
          dxo.e[e] = from_f<T>(grad(to_f(xv.e[e]), to_f(gv.e[e]),
                                    kDual ? to_f(g2v.e[e]) : 0.f,
                                    kMaskY ? to_f(yv.e[e]) : 0.f, ch, sdb, sdg, gp));
          if (kRes) dro.e[e] = from_f<T>(gp);
        }
        const int64_t o = go + it.p * w.plane + i0;
        st<V>(dx + o, dxo);
        if (kRes) st<V>(dr + o, dro);
      }
    };
    if (kc > 1)
      write(std::true_type());
    else
      write(std::false_type());
    __syncthreads();  // the buffer is free for the next slice's copy
  };
  const T* const src[4] = {gy, kDual ? gy2 : x, kDual ? x : (kRes ? y : x), y};
  slices<kStaged>(w, G, nbuf, kNt, reinterpret_cast<T*>(smem4), src, bar, body);
}

// --- launch ---------------------------------------------------------------

// How a launch runs: kc channels a block; staged (one read, a cluster of cs
// CTAs, nbuf buffers of `share` bytes a CTA) or the two-read form (cs 1, no
// shared memory beyond the tables).
struct Plan {
  int kc, cs, staged, nbuf;
  size_t share;
  size_t smem() const { return nbuf * share; }
};

// nt: the tensors a block stages (K1 x, + r; K2 gy, x, + gy2, + y);
// aligned: every tensor of the launch starts on 16 bytes
Plan plan(int esize, int nt, int G, int C, int HW, int ng, bool aligned) {
  Plan pl{walk_channels(C, HW, esize, ng, G, GBN_MAX_KC), 1, 0, 0, 0};
  const int64_t run_bytes = static_cast<int64_t>(pl.kc) * HW * esize;
  if (!aligned || run_bytes % WALK_VEC_BYTES) return pl;
  const int64_t slice = static_cast<int64_t>(ng) * run_bytes * nt;
  int cs = 1;
  while (slice / cs > GBN_SHARE_BYTES && 2 * cs <= GBN_MAX_CLUSTER && ng % (2 * cs) == 0)
    cs *= 2;
  if (slice / cs > GBN_MAX_SHARE) return pl;
  pl.cs = cs;
  pl.staged = 1;
  pl.share = static_cast<size_t>(slice / cs);
  pl.nbuf = pl.share <= GBN_DOUBLE_BYTES ? 2 : 1;
  return pl;
}

bool on16(const void* p) { return reinterpret_cast<uintptr_t>(p) % WALK_VEC_BYTES == 0; }

// Launches `kernel` over the plan's slices: the two-read form one CTA a
// slice; the staged form persistent, as many clusters as fit on the card
// at once (each walks every clusters-th slice), at most one a slice.
template <typename... KArgs, typename... Args>
int launch(void (*kernel)(KArgs...), const Plan& pl, int G, int C, cudaStream_t s,
           Args... args) {
  const int smem = static_cast<int>(pl.smem());
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int slices = (C / pl.kc) * G;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(slices * pl.cs);
  cfg.blockDim = dim3(GBN_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = pl.cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = pl.cs > 1 ? 1 : 0;
  if (pl.staged) {
    int resident = 0;
    if (pl.cs > 1) {
      e = cudaOccupancyMaxActiveClusters(&resident, kernel, &cfg);
    } else {
      int dev = 0, sms = 0, per_sm = 0;
      e = cudaGetDevice(&dev);
      if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, GBN_THREADS, smem);
      resident = sms * per_sm;
    }
    if (e != cudaSuccess) return static_cast<int>(e);
    if (resident < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    cfg.gridDim = dim3((resident < slices ? resident : slices) * pl.cs);
  }
  e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kRes, bool kRelu>
int fwd_form(const Plan& pl, cudaStream_t s, const T* x, const T* r, const float* gamma,
             const float* beta, T* y, float* mean, float* var, int G, int C, int HW,
             int ng, float eps) {
  auto* kernel = pl.staged ? &ghost_bn_fwd_kernel<T, kRes, kRelu, true>
                           : &ghost_bn_fwd_kernel<T, kRes, kRelu, false>;
  return launch(kernel, pl, G, C, s, x, r, gamma, beta, y, mean, var, G, C, HW, ng, pl.kc,
                pl.cs, pl.nbuf, eps);
}

template <typename T>
int launch_fwd(const void* x, const void* r, const float* gamma, const float* beta,
               void* y, float* mean, float* var, int G, int C, int HW, int ng, float eps,
               int relu, cudaStream_t s) {
  const T* xp = static_cast<const T*>(x);
  const T* rp = static_cast<const T*>(r);
  T* yp = static_cast<T*>(y);
  const Plan pl = plan(sizeof(T), r == nullptr ? 1 : 2, G, C, HW, ng,
                       on16(x) && on16(y) && (r == nullptr || on16(r)));
  if (r != nullptr)
    return relu ? fwd_form<T, true, true>(pl, s, xp, rp, gamma, beta, yp, mean, var, G, C,
                                          HW, ng, eps)
                : fwd_form<T, true, false>(pl, s, xp, rp, gamma, beta, yp, mean, var, G,
                                           C, HW, ng, eps);
  return relu ? fwd_form<T, false, true>(pl, s, xp, rp, gamma, beta, yp, mean, var, G, C,
                                         HW, ng, eps)
              : fwd_form<T, false, false>(pl, s, xp, rp, gamma, beta, yp, mean, var, G, C,
                                          HW, ng, eps);
}

template <typename T, bool kRelu, bool kRes, bool kDual>
int bwd_form(const Plan& pl, cudaStream_t s, const T* gy, const T* gy2, const T* x,
             const T* y, const float* gamma, const float* beta, const float* mean,
             const float* var, T* dx, T* dr, float* dg, float* db, int G, int C, int HW,
             int ng, float eps) {
  auto* kernel = pl.staged ? &ghost_bn_bwd_kernel<T, kRelu, kRes, kDual, true>
                           : &ghost_bn_bwd_kernel<T, kRelu, kRes, kDual, false>;
  return launch(kernel, pl, G, C, s, gy, gy2, x, y, gamma, beta, mean, var, dx, dr, dg, db,
                G, C, HW, ng, pl.kc, pl.cs, pl.nbuf, eps);
}

template <typename T, bool kRelu, bool kRes>
int bwd_dual(bool dual, const Plan& pl, cudaStream_t s, const T* gy, const T* gy2,
             const T* x, const T* y, const float* gamma, const float* beta,
             const float* mean, const float* var, T* dx, T* dr, float* dg, float* db, int G,
             int C, int HW, int ng, float eps) {
  return dual ? bwd_form<T, kRelu, kRes, true>(pl, s, gy, gy2, x, y, gamma, beta, mean,
                                               var, dx, dr, dg, db, G, C, HW, ng, eps)
              : bwd_form<T, kRelu, kRes, false>(pl, s, gy, gy2, x, y, gamma, beta, mean,
                                                var, dx, dr, dg, db, G, C, HW, ng, eps);
}

template <typename T>
int launch_bwd(const void* gy, const void* gy2, const void* x, const void* y,
               const float* gamma, const float* beta, const float* mean, const float* var,
               void* dx, void* dr, float* dg, float* db, int G, int C, int HW, int ng,
               float eps, int relu, cudaStream_t s) {
  const T* gyp = static_cast<const T*>(gy);
  const T* gy2p = static_cast<const T*>(gy2);
  const T* xp = static_cast<const T*>(x);
  const T* yp = static_cast<const T*>(y);
  T* dxp = static_cast<T*>(dx);
  T* drp = static_cast<T*>(dr);
  const bool dual = gy2 != nullptr;
  const bool res = y != nullptr;
  const bool aligned = on16(gy) && on16(x) && on16(dx) && (!dual || on16(gy2)) &&
                       (!res || (on16(y) && on16(dr)));
  const Plan pl = plan(sizeof(T), 2 + dual + res, G, C, HW, ng, aligned);
  if (relu && res)
    return bwd_dual<T, true, true>(dual, pl, s, gyp, gy2p, xp, yp, gamma, beta, mean, var,
                                   dxp, drp, dg, db, G, C, HW, ng, eps);
  if (relu)
    return bwd_dual<T, true, false>(dual, pl, s, gyp, gy2p, xp, yp, gamma, beta, mean, var,
                                    dxp, drp, dg, db, G, C, HW, ng, eps);
  if (res)
    return bwd_dual<T, false, true>(dual, pl, s, gyp, gy2p, xp, yp, gamma, beta, mean, var,
                                    dxp, drp, dg, db, G, C, HW, ng, eps);
  return bwd_dual<T, false, false>(dual, pl, s, gyp, gy2p, xp, yp, gamma, beta, mean, var,
                                   dxp, drp, dg, db, G, C, HW, ng, eps);
}

}  // namespace

// The channels a block of K1/K2 owns for these arguments; launches nothing.
extern "C" int ghost_bn_channels(int dtype, int G, int C, int HW, int ng) {
  return walk_channels(C, HW, dtype == 0 ? 4 : 2, ng, G, GBN_MAX_KC);
}

// The CTAs of the cluster that shares a block's slice of `tensors` staged
// tensors (K1 1, 2 with a residual; K2 2, + 1 for gy2, + 1 for the saved y
// of the residual forms) when every tensor starts on 16
// bytes, or 0 where the launch takes the two-read form; launches nothing.
extern "C" int ghost_bn_cluster(int dtype, int G, int C, int HW, int ng, int tensors) {
  const Plan pl = plan(dtype == 0 ? 4 : 2, tensors, G, C, HW, ng, true);
  return pl.staged ? pl.cs : 0;
}

// dtype: 0 = float32, 1 = bfloat16.  r may be null (no residual).
// Returns cudaGetLastError() after the launch (or the error of the launch
// or of raising the shared-memory limit).
extern "C" int ghost_bn_fwd(int dtype, const void* x, const void* r, const void* gamma,
                            const void* beta, void* y, void* mean, void* var, int G,
                            int C, int HW, int ng, float eps, int relu, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* gp = static_cast<const float*>(gamma);
  const float* bp = static_cast<const float*>(beta);
  float* mp = static_cast<float*>(mean);
  float* vp = static_cast<float*>(var);
  if (dtype == 0) return launch_fwd<float>(x, r, gp, bp, y, mp, vp, G, C, HW, ng, eps, relu, s);
  return launch_fwd<__nv_bfloat16>(x, r, gp, bp, y, mp, vp, G, C, HW, ng, eps, relu, s);
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
    return launch_bwd<float>(gy, gy2, x, y, gp, bp, mp, vp, dx, dr, dgp, dbp, G, C, HW, ng,
                             eps, relu, s);
  return launch_bwd<__nv_bfloat16>(gy, gy2, x, y, gp, bp, mp, vp, dx, dr, dgp, dbp, G, C, HW,
                                   ng, eps, relu, s);
}
