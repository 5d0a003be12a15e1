// Flash attention for Hopper (sm_90a): forward (K4 flash_attn_fwd), dQ
// (K5 flash_attn_bwd_dq) and dK/dV (K6 flash_attn_bwd_dkv).  Inputs are
// (BH, S, D) contiguous, bf16 or f32, with D <= 128 and D % 8 == 0; all
// arithmetic is f32 (bf16 values are widened as they are staged).
//
// Replaces incubator_mxnet_tpu/parallel/flash_attention.py: `_fwd` (its
// Pallas `_fwd_kernel`) and the two calls of `_bwd` (`_bwd_dq_kernel`,
// `_bwd_dkv_kernel`).  The numerics are the reference's: scores are
// filled with -1e30 (not -inf) where the right-aligned causal mask
// j <= i + (Sk - Sq) hides a key, so exp(m_prev - m_new) never reads
// inf - inf; in the forward p is zeroed while a row's running max is
// still the fill (a row with no visible key gives O = 0 and
// LSE = -1e30 + log(1e-30)); l is floored at 1e-30; in the backward P is
// exp(S - LSE), zeroed on the raw (filled) score, never from LSE.
//
// Design.  On the TPU the K-tile axis is a sequential grid dimension that
// carries m, l and the accumulator in VMEM scratch; here that carry is a
// loop inside one block.  Tiles are 64 queries x 64 keys, fixed here (the
// wrapper's block_q/block_k tile only the plain version).  256 threads,
// as a 16 x 16 grid (ty, tx): a thread owns 4 rows (ty*4 .. ty*4+3) and
// the columns tx, tx+16, ...; the 16 threads of a row are one half-warp,
// so row max and row sum are shuffles.  Operand tiles are staged in
// dynamic shared memory as f32 with a row pitch of D + 4 floats (16-byte
// rows, and 8 consecutive rows fall on distinct banks for float4 reads);
// the products are register-tiled FMAs on the CUDA cores.
//   K4: one block per (b*h, query tile), heaviest causal tile first; the
//       Q tile stays in shared memory, K/V tiles stream through it up to
//       the last tile any of its rows can see (tiles above the diagonal
//       are never loaded, the boundary tile is masked); m, l and the
//       f32 accumulator (up to 4 x 8 values a thread) live in registers.
//   K5: one block per (b*h, query tile): Q and dO resident, K/V tiles
//       streamed; S = Q K^T and dP = dO V^T in registers, dS through
//       shared memory, dQ += dS K accumulated in registers.
//   K6: one block per (b*h, key tile): K and V resident, Q/dO tiles
//       streamed from the first query tile that sees the key tile;
//       dV += P^T dO and dK += dS^T Q accumulated in registers.  Each
//       block owns its output rows: no atomics.
// Any Sq and Sk: a ragged last tile is zero-filled in shared memory and
// masked.  Shared memory at D = 128 is 116 KB (K4), 149 KB (K5) and
// 166.5 KB (K6), above the 48 KB default, so every launch first raises
// cudaFuncAttributeMaxDynamicSharedMemorySize.
//
// What bounds it on the H100: operations.  At the LM's shapes (B 4, H 8,
// S 2048, D 128, causal, f32) the 67.1 M visible (i, j) pairs cost
// 2 x 2 x D FLOP each for K4 (S and PV): 34.4 GFLOP, 0.51 ms at the
// 67 TFLOP/s f32 rate, against 134 MB of inputs and outputs, 0.04 ms.
// K5 makes 3 products (0.77 ms), K6 makes 4 (1.03 ms).  For bf16 inputs
// the bound is the tensor cores' 989 TFLOP/s: a product of bf16 values is
// exact in f32, so it is the same work.
//
// What this simple design leaves on the table: it runs on the CUDA cores
// with FMAs, not on the tensor cores (no mma/wgmma), stages tiles with
// plain loads (no cp.async/TMA, so loads do not overlap compute), and
// runs one block per SM at D = 128.  A tensor-core version is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;          // query rows per tile
constexpr int kBK = 64;          // keys per tile
constexpr int kR = 4;            // rows a thread owns
constexpr int kC = 4;            // score columns a thread owns (kBK / 16)
constexpr int kPitchP = kBK + 4; // row pitch of the P / dS tiles
constexpr float kNegInf = -1e30f;

// --- staging: global (T) -> shared (f32), 16 bytes a thread -------------

__device__ __forceinline__ void stage16(float* dst, const float* src) {
  *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
}
__device__ __forceinline__ void stage16(float* dst, const __nv_bfloat16* src) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
  const float2 c = __bfloat1622float2(h[2]), d = __bfloat1622float2(h[3]);
  reinterpret_cast<float4*>(dst)[0] = make_float4(a.x, a.y, b.x, b.y);
  reinterpret_cast<float4*>(dst)[1] = make_float4(c.x, c.y, d.x, d.y);
}

template <typename T>
struct Elems {
  static constexpr int kPer16 = 16 / sizeof(T);
};

// rows [row0, row0 + kRows) of a (S, D) slice into sm (pitch D + 4); rows
// at or past S are zero-filled
template <int kRows, typename T>
__device__ void load_tile(float* sm, const T* g, int row0, int S, int D) {
  constexpr int kV = Elems<T>::kPer16;
  const int per_row = D / kV;
  const int lds = D + 4;
  for (int v = threadIdx.x; v < kRows * per_row; v += kThreads) {
    const int r = v / per_row;
    const int c = (v - r * per_row) * kV;
    float* dst = sm + r * lds + c;
    if (row0 + r < S) {
      stage16(dst, g + static_cast<int64_t>(row0 + r) * D + c);
    } else {
#pragma unroll
      for (int e = 0; e < kV; e += 4)
        *reinterpret_cast<float4*>(dst + e) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

__device__ __forceinline__ void store(float* p, int64_t i, float v) { p[i] = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, int64_t i, float v) {
  p[i] = __float2bfloat16(v);
}

// --- register-tiled products on shared-memory tiles ----------------------

// acc[i][j] += sum_d A[ty*4+i][d] * B[tx+16j][d]   (A B^T, depth D)
__device__ __forceinline__ void product_nt(float (&acc)[kR][kC], const float* A,
                                           const float* B, int ld, int D, int ty,
                                           int tx) {
  for (int d = 0; d < D; d += 4) {
    float4 a[kR], b[kC];
#pragma unroll
    for (int i = 0; i < kR; ++i)
      a[i] = *reinterpret_cast<const float4*>(A + (ty * kR + i) * ld + d);
#pragma unroll
    for (int j = 0; j < kC; ++j)
      b[j] = *reinterpret_cast<const float4*>(B + (tx + 16 * j) * ld + d);
#pragma unroll
    for (int i = 0; i < kR; ++i)
#pragma unroll
      for (int j = 0; j < kC; ++j) {
        acc[i][j] = fmaf(a[i].x, b[j].x, acc[i][j]);
        acc[i][j] = fmaf(a[i].y, b[j].y, acc[i][j]);
        acc[i][j] = fmaf(a[i].z, b[j].z, acc[i][j]);
        acc[i][j] = fmaf(a[i].w, b[j].w, acc[i][j]);
      }
  }
}

// acc[i][j] += sum_k A[ty*4+i][k] * B[k][col[j]]   (A B, depth kBK; A has
// pitch kPitchP, B pitch ldb)
template <int DC>
__device__ __forceinline__ void product_nn(float (&acc)[kR][DC], const float* A,
                                           const float* B, int ldb,
                                           const int (&col)[DC], int ty) {
#pragma unroll 2
  for (int k = 0; k < kBK; k += 4) {
    float4 a[kR];
#pragma unroll
    for (int i = 0; i < kR; ++i)
      a[i] = *reinterpret_cast<const float4*>(A + (ty * kR + i) * kPitchP + k);
#pragma unroll
    for (int j = 0; j < DC; ++j) {
      const float* b = B + k * ldb + col[j];
      const float b0 = b[0], b1 = b[ldb], b2 = b[2 * ldb], b3 = b[3 * ldb];
#pragma unroll
      for (int i = 0; i < kR; ++i) {
        acc[i][j] = fmaf(a[i].x, b0, acc[i][j]);
        acc[i][j] = fmaf(a[i].y, b1, acc[i][j]);
        acc[i][j] = fmaf(a[i].z, b2, acc[i][j]);
        acc[i][j] = fmaf(a[i].w, b3, acc[i][j]);
      }
    }
  }
}

// reductions over the 16 threads (one half-warp) that share a row
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ bool visible(int row, int key, int Sq, int Sk, int offset,
                                        int causal) {
  return row < Sq && key < Sk && (!causal || key <= row + offset);
}

// number of key tiles that rows [q0, q0 + kBQ) can see
__device__ __forceinline__ int key_tiles(int q0, int Sq, int Sk, int causal) {
  const int nk = (Sk + kBK - 1) / kBK;
  if (!causal) return nk;
  const int last_row = min(q0 + kBQ, Sq) - 1;
  const int last_key = last_row + (Sk - Sq);
  return last_key < 0 ? 0 : min(nk, last_key / kBK + 1);
}

// --- K4: forward ----------------------------------------------------------

template <typename T, int DC>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, float* __restrict__ lse,
                 int Sq, int Sk, int D, float scale, int causal) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int lds = D + 4;
  float* sQ = sm;
  float* sK = sQ + kBQ * lds;
  float* sV = sK + kBK * lds;
  float* sP = sV + kBK * lds;

  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int nq = (Sq + kBQ - 1) / kBQ;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x)) * kBQ;  // heaviest first
  const int64_t bh = blockIdx.y;
  const int offset = Sk - Sq;
  const T* kb = k + bh * Sk * D;
  const T* vb = v + bh * Sk * D;
  load_tile<kBQ>(sQ, q + bh * Sq * D, q0, Sq, D);

  int col[DC];
#pragma unroll
  for (int j = 0; j < DC; ++j) col[j] = min(tx + 16 * j, D - 1);
  float m[kR], l[kR], acc[kR][DC];
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DC; ++j) acc[i][j] = 0.f;
  }

  const int nk = key_tiles(q0, Sq, Sk, causal);
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the last tile's readers are done
    load_tile<kBK>(sK, kb, k0, Sk, D);
    load_tile<kBK>(sV, vb, k0, Sk, D);
    __syncthreads();
    float s[kR][kC];
#pragma unroll
    for (int i = 0; i < kR; ++i)
#pragma unroll
      for (int j = 0; j < kC; ++j) s[i][j] = 0.f;
    product_nt(s, sQ, sK, lds, D, ty, tx);
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      const int row = q0 + ty * kR + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kC; ++j) {
        s[i][j] = visible(row, k0 + tx + 16 * j, Sq, Sk, offset, causal)
                      ? s[i][j] * scale
                      : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kC; ++j) {
        const float p = m_new > kNegInf / 2 ? expf(s[i][j] - m_new) : 0.f;
        sP[(ty * kR + i) * kPitchP + tx + 16 * j] = p;
        sum += p;
      }
      l[i] = alpha * l[i] + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DC; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();
    product_nn<DC>(acc, sP, sV, lds, col, ty);
  }

  T* ob = out + bh * Sq * D;
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int row = q0 + ty * kR + i;
    if (row >= Sq) continue;
    const float lf = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DC; ++j) {
      const int c = tx + 16 * j;
      if (c < D) store(ob, static_cast<int64_t>(row) * D + c, acc[i][j] / lf);
    }
    if (tx == 0) lse[bh * Sq + row] = m[i] + logf(lf);
  }
}

// --- K5: dQ ---------------------------------------------------------------

template <typename T, int DC>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    T* __restrict__ dq, int Sq, int Sk, int D, float scale, int causal) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int lds = D + 4;
  float* sQ = sm;
  float* sdO = sQ + kBQ * lds;
  float* sK = sdO + kBQ * lds;
  float* sV = sK + kBK * lds;
  float* sdS = sV + kBK * lds;

  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int nq = (Sq + kBQ - 1) / kBQ;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x)) * kBQ;
  const int64_t bh = blockIdx.y;
  const int offset = Sk - Sq;
  const T* kb = k + bh * Sk * D;
  const T* vb = v + bh * Sk * D;
  load_tile<kBQ>(sQ, q + bh * Sq * D, q0, Sq, D);
  load_tile<kBQ>(sdO, dout + bh * Sq * D, q0, Sq, D);

  int col[DC];
#pragma unroll
  for (int j = 0; j < DC; ++j) col[j] = min(tx + 16 * j, D - 1);
  float lse_r[kR], delta_r[kR], acc[kR][DC];
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int row = q0 + ty * kR + i;
    lse_r[i] = row < Sq ? lse[bh * Sq + row] : 0.f;
    delta_r[i] = row < Sq ? delta[bh * Sq + row] : 0.f;
#pragma unroll
    for (int j = 0; j < DC; ++j) acc[i][j] = 0.f;
  }

  const int nk = key_tiles(q0, Sq, Sk, causal);
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();
    load_tile<kBK>(sK, kb, k0, Sk, D);
    load_tile<kBK>(sV, vb, k0, Sk, D);
    __syncthreads();
    float s[kR][kC], dp[kR][kC];
#pragma unroll
    for (int i = 0; i < kR; ++i)
#pragma unroll
      for (int j = 0; j < kC; ++j) s[i][j] = dp[i][j] = 0.f;
    product_nt(s, sQ, sK, lds, D, ty, tx);
    product_nt(dp, sdO, sV, lds, D, ty, tx);
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      const int row = q0 + ty * kR + i;
#pragma unroll
      for (int j = 0; j < kC; ++j) {
        const float sv = visible(row, k0 + tx + 16 * j, Sq, Sk, offset, causal)
                             ? s[i][j] * scale
                             : kNegInf;
        const float p = sv > kNegInf / 2 ? expf(sv - lse_r[i]) : 0.f;
        sdS[(ty * kR + i) * kPitchP + tx + 16 * j] = p * (dp[i][j] - delta_r[i]) * scale;
      }
    }
    __syncthreads();
    product_nn<DC>(acc, sdS, sK, lds, col, ty);
  }

  T* gb = dq + bh * Sq * D;
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int row = q0 + ty * kR + i;
    if (row >= Sq) continue;
#pragma unroll
    for (int j = 0; j < DC; ++j) {
      const int c = tx + 16 * j;
      if (c < D) store(gb, static_cast<int64_t>(row) * D + c, acc[i][j]);
    }
  }
}

// --- K6: dK and dV --------------------------------------------------------

template <typename T, int DC>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     T* __restrict__ dk, T* __restrict__ dv, int Sq, int Sk, int D,
                     float scale, int causal) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int lds = D + 4;
  float* sK = sm;
  float* sV = sK + kBK * lds;
  float* sQ = sV + kBK * lds;
  float* sdO = sQ + kBQ * lds;
  float* sP = sdO + kBQ * lds;       // P^T: rows are keys, columns queries
  float* sdS = sP + kBK * kPitchP;   // dS^T
  float* sLse = sdS + kBK * kPitchP;
  float* sDelta = sLse + kBQ;

  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int k0 = blockIdx.x * kBK;  // early key tiles have the most work
  const int64_t bh = blockIdx.y;
  const int offset = Sk - Sq;
  const T* qb = q + bh * Sq * D;
  const T* db = dout + bh * Sq * D;
  load_tile<kBK>(sK, k + bh * Sk * D, k0, Sk, D);
  load_tile<kBK>(sV, v + bh * Sk * D, k0, Sk, D);

  int col[DC];
#pragma unroll
  for (int j = 0; j < DC; ++j) col[j] = min(tx + 16 * j, D - 1);
  float acc_k[kR][DC], acc_v[kR][DC];
#pragma unroll
  for (int i = 0; i < kR; ++i)
#pragma unroll
    for (int j = 0; j < DC; ++j) acc_k[i][j] = acc_v[i][j] = 0.f;

  const int nq = (Sq + kBQ - 1) / kBQ;
  // the first query row that sees key k0 is k0 - offset
  const int qt0 = causal ? max(0, k0 - offset) / kBQ : 0;
  for (int qt = qt0; qt < nq; ++qt) {
    const int q0 = qt * kBQ;
    __syncthreads();
    load_tile<kBQ>(sQ, qb, q0, Sq, D);
    load_tile<kBQ>(sdO, db, q0, Sq, D);
    if (threadIdx.x < kBQ) {
      const int row = q0 + threadIdx.x;
      sLse[threadIdx.x] = row < Sq ? lse[bh * Sq + row] : 0.f;
      sDelta[threadIdx.x] = row < Sq ? delta[bh * Sq + row] : 0.f;
    }
    __syncthreads();
    float s[kR][kC], dp[kR][kC];
#pragma unroll
    for (int i = 0; i < kR; ++i)
#pragma unroll
      for (int j = 0; j < kC; ++j) s[i][j] = dp[i][j] = 0.f;
    product_nt(s, sK, sQ, lds, D, ty, tx);    // S^T = K Q^T
    product_nt(dp, sV, sdO, lds, D, ty, tx);  // dP^T = V dO^T
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      const int key = k0 + ty * kR + i;
#pragma unroll
      for (int j = 0; j < kC; ++j) {
        const int r = tx + 16 * j;
        const float sv = visible(q0 + r, key, Sq, Sk, offset, causal) ? s[i][j] * scale
                                                                       : kNegInf;
        const float p = sv > kNegInf / 2 ? expf(sv - sLse[r]) : 0.f;
        sP[(ty * kR + i) * kPitchP + r] = p;
        sdS[(ty * kR + i) * kPitchP + r] = p * (dp[i][j] - sDelta[r]) * scale;
      }
    }
    __syncthreads();
    product_nn<DC>(acc_v, sP, sdO, lds, col, ty);
    product_nn<DC>(acc_k, sdS, sQ, lds, col, ty);
  }

  T* kg = dk + bh * Sk * D;
  T* vg = dv + bh * Sk * D;
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int key = k0 + ty * kR + i;
    if (key >= Sk) continue;
#pragma unroll
    for (int j = 0; j < DC; ++j) {
      const int c = tx + 16 * j;
      if (c < D) {
        store(kg, static_cast<int64_t>(key) * D + c, acc_k[i][j]);
        store(vg, static_cast<int64_t>(key) * D + c, acc_v[i][j]);
      }
    }
  }
}

// --- launch ---------------------------------------------------------------

template <typename Kernel, typename... Args>
int launch(Kernel kernel, dim3 grid, size_t smem, cudaStream_t s, Args... args) {
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<grid, kThreads, smem, s>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

size_t tile_floats(int D) { return static_cast<size_t>(kBQ) * (D + 4); }

bool bad_shape(int BH, int Sq, int Sk, int D) {
  return BH < 1 || BH > 65535 || Sq < 1 || Sk < 1 || D < 8 || D > 128 || D % 8;
}

template <typename T, int DC>
int fwd(const void* q, const void* k, const void* v, void* out, void* lse, int BH, int Sq,
        int Sk, int D, float scale, int causal, cudaStream_t s) {
  const size_t smem = (3 * tile_floats(D) + kBQ * kPitchP) * sizeof(float);
  const dim3 grid((Sq + kBQ - 1) / kBQ, BH);
  return launch(flash_fwd_kernel<T, DC>, grid, smem, s, static_cast<const T*>(q),
                static_cast<const T*>(k), static_cast<const T*>(v), static_cast<T*>(out),
                static_cast<float*>(lse), Sq, Sk, D, scale, causal);
}

template <typename T, int DC>
int bwd_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
           const void* delta, void* dq, int BH, int Sq, int Sk, int D, float scale,
           int causal, cudaStream_t s) {
  const size_t smem = (4 * tile_floats(D) + kBQ * kPitchP) * sizeof(float);
  const dim3 grid((Sq + kBQ - 1) / kBQ, BH);
  return launch(flash_bwd_dq_kernel<T, DC>, grid, smem, s, static_cast<const T*>(q),
                static_cast<const T*>(k), static_cast<const T*>(v),
                static_cast<const T*>(dout), static_cast<const float*>(lse),
                static_cast<const float*>(delta), static_cast<T*>(dq), Sq, Sk, D, scale,
                causal);
}

template <typename T, int DC>
int bwd_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
            const void* delta, void* dk, void* dv, int BH, int Sq, int Sk, int D,
            float scale, int causal, cudaStream_t s) {
  const size_t smem =
      (4 * tile_floats(D) + 2 * kBK * kPitchP + 2 * kBQ) * sizeof(float);
  const dim3 grid((Sk + kBK - 1) / kBK, BH);
  return launch(flash_bwd_dkv_kernel<T, DC>, grid, smem, s, static_cast<const T*>(q),
                static_cast<const T*>(k), static_cast<const T*>(v),
                static_cast<const T*>(dout), static_cast<const float*>(lse),
                static_cast<const float*>(delta), static_cast<T*>(dk),
                static_cast<T*>(dv), Sq, Sk, D, scale, causal);
}

// the accumulator width (columns a thread keeps: 2, 4 or 8 x 16 >= D)
#define FLASH_DISPATCH(fn, T, D, ...)                            \
  ((D) <= 32 ? fn<T, 2>(__VA_ARGS__)                             \
             : (D) <= 64 ? fn<T, 4>(__VA_ARGS__) : fn<T, 8>(__VA_ARGS__))

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q (BH, Sq, D), k and v (BH, Sk, D),
// out like q, lse (BH, Sq) f32.  Returns cudaGetLastError() after the
// launch (or the error of raising the shared-memory limit).
extern "C" int flash_attn_fwd(int dtype, const void* q, const void* k, const void* v,
                              void* out, void* lse, int BH, int Sq, int Sk, int D,
                              float scale, int causal, void* stream) {
  if (bad_shape(BH, Sq, Sk, D)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0
             ? FLASH_DISPATCH(fwd, float, D, q, k, v, out, lse, BH, Sq, Sk, D, scale,
                              causal, s)
             : FLASH_DISPATCH(fwd, __nv_bfloat16, D, q, k, v, out, lse, BH, Sq, Sk, D,
                              scale, causal, s);
}

// dout like q; lse and delta = rowsum(dO * O) (BH, Sq) f32; dq like q.
extern "C" int flash_attn_bwd_dq(int dtype, const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse, const void* delta,
                                 void* dq, int BH, int Sq, int Sk, int D, float scale,
                                 int causal, void* stream) {
  if (bad_shape(BH, Sq, Sk, D)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0
             ? FLASH_DISPATCH(bwd_dq, float, D, q, k, v, dout, lse, delta, dq, BH, Sq,
                              Sk, D, scale, causal, s)
             : FLASH_DISPATCH(bwd_dq, __nv_bfloat16, D, q, k, v, dout, lse, delta, dq,
                              BH, Sq, Sk, D, scale, causal, s);
}

// as flash_attn_bwd_dq; dk and dv like k and v.
extern "C" int flash_attn_bwd_dkv(int dtype, const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse, const void* delta,
                                  void* dk, void* dv, int BH, int Sq, int Sk, int D,
                                  float scale, int causal, void* stream) {
  if (bad_shape(BH, Sq, Sk, D)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0
             ? FLASH_DISPATCH(bwd_dkv, float, D, q, k, v, dout, lse, delta, dk, dv, BH,
                              Sq, Sk, D, scale, causal, s)
             : FLASH_DISPATCH(bwd_dkv, __nv_bfloat16, D, q, k, v, dout, lse, delta, dk,
                              dv, BH, Sq, Sk, D, scale, causal, s);
}
