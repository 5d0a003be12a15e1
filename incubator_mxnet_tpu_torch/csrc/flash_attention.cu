// Flash attention for Hopper (sm_90a): forward (K4 flash_attn_fwd), dQ
// (K5 flash_attn_bwd_dq) and dK/dV (K6 flash_attn_bwd_dkv).  Inputs are
// (BH, S, D) contiguous, bf16 or f32, with D <= 128 and D % 8 == 0;
// softmax, sums and outputs' arithmetic are f32.
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
// On the TPU the K-tile axis is a sequential grid dimension that carries
// m, l and the accumulator in VMEM scratch; here that carry is a loop
// inside one block.  The wrapper's block_q/block_k tile only the plain
// version; the tiles here are fixed.  Any Sq and Sk: a ragged last tile
// is zero-filled in shared memory and masked.  Every launch first raises
// cudaFuncAttributeMaxDynamicSharedMemorySize above the 48 KB default.
//
// K4, on the tensor cores.  mma.sync.m16n8k8 TF32 with f32 sums, in the
// 3xTF32 split that keeps f32 accuracy: each f32 operand x is cut into
// hi = tf32(x) and lo = tf32(x - hi), and a product takes three passes,
// lo*hi + hi*lo, then hi*hi.  A bf16 value is exact in TF32, so for bf16
// inputs S = Q K^T takes one pass and P V two (P is f32 and split).  One
// block of 8 warps per (query tile of 128 rows, b*h), 16 rows a warp, in
// FlashAttention-2's order: the Q tile stays in shared memory, K/V tiles
// stream through it by 16-byte cp.async in the input's dtype (tile kt + 1
// loads while tile kt computes), up to the last tile any of its rows can
// see; only tiles that cross the diagonal or the ragged edge are masked.
// S lives in mma C fragments: thread (g = lane / 4, t = lane % 4) holds
// rows g, g + 8 and keys 2t, 2t + 1 of each 8 keys, so a row's max and
// sum are shuffles within its quad.  P stays in registers: S's C fragment
// is P V's A fragment once the k slots are permuted (slot t is key 2t,
// slot t + 4 key 2t + 1) and V's rows are read in that order.  A tile
// holds 64 keys; each 8-deep step of S loads and splits the K fragments
// of all 64 keys first, then runs the lo passes over them, then the hi
// pass, so no mma waits on the one before it.  D pads to the 8-column
// fragment (D <= 32, 64, 128 as 32, 64, 128) with zero columns in shared
// memory.  The query tile is the grid's y, heaviest causal tile first
// across all b*h, so the light tiles fill the tail.  Shared memory at
// D = 128: 198 KB for f32 (one block an SM), 102 KB for bf16 (two blocks
// an SM, at 128 registers a thread).  Splitting f32 K and V tiles once
// per block into (hi, lo) pairs, instead of in every warp, measured
// slower: the extra pass and barrier cost more than the ALU work saved.
// Its time beside SDPA's is row 6 of PERF.md's kernel table
// (chip_smoke.py phase 4).
//
// K5 and K6 are the first, simple design on the CUDA cores: tiles of 64
// queries x 64 keys, 256 threads as a 16 x 16 grid (ty, tx); a thread
// owns 4 rows (ty*4 .. ty*4+3) and the columns tx, tx+16, ...; the 16
// threads of a row are one half-warp.  Operand tiles are staged in
// dynamic shared memory as f32 with a row pitch of D + 4 floats; the
// products are register-tiled FMAs.
//   K5: one block per (b*h, query tile): Q and dO resident, K/V tiles
//       streamed; S = Q K^T and dP = dO V^T in registers, dS through
//       shared memory, dQ += dS K accumulated in registers.
//   K6: one block per (b*h, key tile): K and V resident, Q/dO tiles
//       streamed from the first query tile that sees the key tile;
//       dV += P^T dO and dK += dS^T Q accumulated in registers.  Each
//       block owns its output rows: no atomics.
// Their shared memory at D = 128 is 149 KB (K5) and 166.5 KB (K6).
//
// What bounds them on the H100: operations.  At the LM's shapes (B 4,
// H 8, S 2048, D 128, causal, f32) the 67.1 M visible (i, j) pairs cost
// 2 x 2 x D FLOP each for K4 (S and PV): 34.4 GFLOP against 134 MB of
// inputs and outputs (0.04 ms).  On the tensor cores in 3xTF32 that is
// 3 x 34.4 GFLOP at 495 TFLOP/s: 0.208 ms (0.51 ms for f32 FMAs at
// 67 TFLOP/s).  K5 makes 3 products (0.77 ms on the CUDA cores), K6 makes
// 4 (1.03 ms).  mma.sync does not reach the tensor cores' full rate on
// Hopper (wgmma does; it takes TF32 B operands only K-major) and each
// TF32 split costs ALU instructions: K4's next step is wgmma with TMA.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;          // query rows per tile (K5, K6)
constexpr int kBQ4 = 128;        // K4's query rows per block, 16 a warp
constexpr int kBK4 = 64;         // K4's keys per tile
constexpr int kThreads4 = 2 * kBQ4;
constexpr int kBK = 64;          // keys per tile
constexpr int kR = 4;            // rows a thread owns
constexpr int kC = 4;            // score columns a thread owns (kBK / 16)
constexpr int kPitchP = kBK + 4; // row pitch of the P / dS tiles
constexpr float kNegInf = -1e30f;

// --- PTX wrappers ---------------------------------------------------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// copy `bytes` (0 or 16) from global to shared; the rest of the 16 is
// zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ unsigned to_tf32(float x) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// d += a b for one m16n8k8 TF32 fragment (f32 accumulate).  Thread
// (g = lane / 4, t = lane % 4) holds A (16 x 8) at rows g, g + 8 and
// columns t, t + 4 (a0: g,t  a1: g+8,t  a2: g,t+4  a3: g+8,t+4), B (8 x 8)
// at rows t, t + 4 and column g, and C at rows g, g + 8 and columns 2t,
// 2t + 1 (c0: g,2t  c1: g,2t+1  c2: g+8,2t  c3: g+8,2t+1).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// --- end of PTX wrappers --------------------------------------------------

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

__device__ __forceinline__ bool visible(int row, int key, int Sq, int Sk, int offset,
                                        int causal) {
  return row < Sq && key < Sk && (!causal || key <= row + offset);
}

// number of key tiles (of `keys`) that rows [q0, q0 + rows) can see
__device__ __forceinline__ int key_tiles(int q0, int Sq, int Sk, int causal,
                                         int rows = kBQ, int keys = kBK) {
  const int nk = (Sk + keys - 1) / keys;
  if (!causal) return nk;
  const int last_row = min(q0 + rows, Sq) - 1;
  const int last_key = last_row + (Sk - Sq);
  return last_key < 0 ? 0 : min(nk, last_key / keys + 1);
}

// --- K4: forward, on the tensor cores ------------------------------------

// rows [row0, row0 + kRows) of a (S, D) slice into sm (row pitch ld
// elements of T) by 16-byte cp.async, in the input's dtype; rows at or
// past S are zero-filled by the copy's source size
template <int kRows, typename T>
__device__ __forceinline__ void async_tile(T* sm, const T* g, int row0, int S, int D,
                                           int ld) {
  constexpr int kV = 16 / sizeof(T);
  const int per_row = D / kV;
  for (int v = threadIdx.x; v < kRows * per_row; v += kThreads4) {
    const int r = v / per_row;
    const int c = (v - r * per_row) * kV;
    const bool ok = row0 + r < S;
    cp_async16(sm + r * ld + c, ok ? g + static_cast<int64_t>(row0 + r) * D + c : g,
               ok ? 16 : 0);
  }
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// the TF32 parts of x: hi = tf32(x) and, for a float, lo = tf32(x - hi).
// A bf16 value is exact in TF32: hi is its bits and lo is never used.
template <typename T>
__device__ __forceinline__ void split(T x, unsigned& hi, unsigned& lo) {
  const float f = to_f32(x);
  if (sizeof(T) == 4) {
    hi = to_tf32(f);
    lo = to_tf32(f - __uint_as_float(hi));
  } else {
    hi = __float_as_uint(f);
  }
}

template <typename T, int DC>
__device__ __forceinline__ void flash_fwd_body(const T* __restrict__ q,
                                               const T* __restrict__ k,
                                               const T* __restrict__ v, T* __restrict__ out,
                                               float* __restrict__ lse, int Sq, int Sk,
                                               int D, float scale, int causal) {
  constexpr int NT = 2 * DC;       // 8-column fragments of O
  constexpr int DP = 8 * NT;       // D padded to them (DP >= D)
  constexpr int KT = kBK4 / 8;     // 8-key fragments of S
  constexpr bool kF32 = sizeof(T) == 4;
  constexpr int ld = DP + 16 / static_cast<int>(sizeof(T));  // row pitch
  extern __shared__ float4 smem4[];
  T* sQ = reinterpret_cast<T*>(smem4);
  T* sK = sQ + kBQ4 * ld;          // two stages each of K and V
  T* sV = sK + 2 * kBK4 * ld;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  // blocks start in the order of their linear index, x fastest: the query
  // tile is y, heaviest (causal: last) first, so the tail is light
  const int nq = (Sq + kBQ4 - 1) / kBQ4;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.y)) * kBQ4;
  const int64_t bh = blockIdx.x;
  const int offset = Sk - Sq;
  const T* kb = k + bh * Sk * D;
  const T* vb = v + bh * Sk * D;
  const int r0 = q0 + warp * 16 + g;  // this thread's rows: r0 and r0 + 8
  const T* qr = sQ + (warp * 16 + g) * ld;

  float o[NT][4], m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  if (D < DP) {  // columns [D, DP) of every row: zeros, never loaded
    const int per_row = (DP - D) * static_cast<int>(sizeof(T)) / 16;
    for (int i = threadIdx.x; i < (kBQ4 + 4 * kBK4) * per_row; i += kThreads4) {
      const int r = i / per_row;
      reinterpret_cast<float4*>(sQ + r * ld + D)[i - r * per_row] =
          make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  const int nk = key_tiles(q0, Sq, Sk, causal, kBQ4, kBK4);
  if (nk > 0) {
    async_tile<kBQ4>(sQ, q + bh * Sq * D, q0, Sq, D, ld);
    async_tile<kBK4>(sK, kb, 0, Sk, D, ld);
    async_tile<kBK4>(sV, vb, 0, Sk, D, ld);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<0>();
    __syncthreads();  // tile kt is in; every warp is done with tile kt - 1
    if (kt + 1 < nk) {  // tile kt + 1 loads into kt - 1's stage while kt computes
      const int nb = (kt + 1) & 1;
      async_tile<kBK4>(sK + nb * kBK4 * ld, kb, (kt + 1) * kBK4, Sk, D, ld);
      async_tile<kBK4>(sV + nb * kBK4 * ld, vb, (kt + 1) * kBK4, Sk, D, ld);
      cp_async_commit();
    }
    const T* sk = sK + (kt & 1) * kBK4 * ld;
    const T* sv = sV + (kt & 1) * kBK4 * ld;
    const int k0 = kt * kBK4;

    // S = Q K^T: the warp's 16 rows x 64 keys, 3 TF32 passes (1 for bf16)
    float s[KT][4];
#pragma unroll
    for (int j = 0; j < KT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int d0 = 0; d0 < DP; d0 += 8) {
      unsigned ah[4], al[4];
      split(qr[d0 + t], ah[0], al[0]);
      split(qr[8 * ld + d0 + t], ah[1], al[1]);
      split(qr[d0 + t + 4], ah[2], al[2]);
      split(qr[8 * ld + d0 + t + 4], ah[3], al[3]);
      unsigned bh2[KT][2], bl2[KT][2];
#pragma unroll
      for (int j = 0; j < KT; ++j) {
        const T* kr = sk + (j * 8 + g) * ld + d0 + t;
        split(kr[0], bh2[j][0], bl2[j][0]);
        split(kr[4], bh2[j][1], bl2[j][1]);
      }
      if (kF32) {
#pragma unroll
        for (int j = 0; j < KT; ++j) mma_tf32(s[j], al, bh2[j]);
#pragma unroll
        for (int j = 0; j < KT; ++j) mma_tf32(s[j], ah, bl2[j]);
      }
#pragma unroll
      for (int j = 0; j < KT; ++j) mma_tf32(s[j], ah, bh2[j]);
    }

    // scale and mask; thread t holds keys 2t and 2t + 1 of each fragment,
    // and a row's 4 threads (one quad) reduce by shuffles
    const bool full = k0 + kBK4 <= Sk && (!causal || k0 + kBK4 - 1 <= q0 + offset);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < KT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + j * 8 + 2 * t + (e & 1);
        float x = s[j][e] * scale;
        if (!full && !(key < Sk && (!causal || key <= r0 + 8 * (e >> 1) + offset)))
          x = kNegInf;
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float m_new[2], alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      m_new[h] = fmaxf(m[h], mx[h]);
      alpha[h] = __expf(m[h] - m_new[h]);
      m[h] = m_new[h];
    }
#pragma unroll
    for (int j = 0; j < KT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const float p = m_new[h] > kNegInf / 2 ? __expf(s[j][e] - m_new[h]) : 0.f;
        s[j][e] = p;
        sum[h] += p;
      }
    // l stays a per-thread partial sum (alpha is the same across the
    // quad); the quad adds its partials once, after the last tile
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = alpha[h] * l[h] + sum[h];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // O += P V with P from registers: S's C fragment (keys 2t, 2t + 1)
    // is PV's A fragment once the k slots are permuted: slot t is key 2t
    // and slot t + 4 key 2t + 1, and the V rows are read in that order
#pragma unroll
    for (int c = 0; c < KT; ++c) {
      unsigned ph[4], pl[4];
      split(s[c][0], ph[0], pl[0]);
      split(s[c][2], ph[1], pl[1]);
      split(s[c][1], ph[2], pl[2]);
      split(s[c][3], ph[3], pl[3]);
      const T* vr = sv + (c * 8 + 2 * t) * ld + g;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        unsigned vh[2], vl[2];
        split(vr[n * 8], vh[0], vl[0]);
        split(vr[ld + n * 8], vh[1], vl[1]);
        if (kF32) mma_tf32(o[n], ph, vl);
        mma_tf32(o[n], pl, vh);
        mma_tf32(o[n], ph, vh);
      }
    }
  }

  T* ob = out + bh * Sq * D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const int row = r0 + 8 * h;
    if (row >= Sq) continue;
    const float lf = fmaxf(l[h], 1e-30f);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      if (n * 8 >= D) break;
      const int64_t i = static_cast<int64_t>(row) * D + n * 8 + 2 * t;
      store(ob, i, o[n][2 * h] / lf);
      store(ob, i + 1, o[n][2 * h + 1] / lf);
    }
    if (t == 0) lse[bh * Sq + row] = m[h] + logf(lf);
  }
}

// f32 tiles take 198 KB of shared memory at D = 128: one block an SM,
// with the registers left to the compiler; bf16 tiles take 102 KB, and two
// blocks fit an SM when a thread keeps to 128 registers
template <int DC>
__global__ void __launch_bounds__(kThreads4)
flash_fwd_kernel_f32(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     float* __restrict__ lse, int Sq, int Sk, int D, float scale,
                     int causal) {
  flash_fwd_body<float, DC>(q, k, v, out, lse, Sq, Sk, D, scale, causal);
}

template <int DC>
__global__ void __launch_bounds__(kThreads4, 2)
flash_fwd_kernel_bf16(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                      float* __restrict__ lse, int Sq, int Sk, int D, float scale,
                      int causal) {
  flash_fwd_body<__nv_bfloat16, DC>(q, k, v, out, lse, Sq, Sk, D, scale, causal);
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

template <int kN = kThreads, typename Kernel, typename... Args>
int launch(Kernel kernel, dim3 grid, size_t smem, cudaStream_t s, Args... args) {
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<grid, kN, smem, s>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

size_t tile_floats(int D) { return static_cast<size_t>(kBQ) * (D + 4); }

bool bad_shape(int BH, int Sq, int Sk, int D) {
  return BH < 1 || BH > 65535 || Sq < 1 || Sk < 1 || D < 8 || D > 128 || D % 8;
}

template <typename T, int DC>
int fwd(const void* q, const void* k, const void* v, void* out, void* lse, int BH, int Sq,
        int Sk, int D, float scale, int causal, cudaStream_t s) {
  // the Q tile and two stages each of K and V, in T, at a row pitch of
  // 16 DC elements (D padded) + 16 bytes
  const size_t smem =
      static_cast<size_t>(kBQ4 + 4 * kBK4) * (16 * DC + 16 / sizeof(T)) * sizeof(T);
  const dim3 grid(BH, (Sq + kBQ4 - 1) / kBQ4);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(out);
  float* lt = static_cast<float*>(lse);
  if constexpr (sizeof(T) == 4)
    return launch<kThreads4>(flash_fwd_kernel_f32<DC>, grid, smem, s, qt, kt, vt, ot, lt,
                             Sq, Sk, D, scale, causal);
  else
    return launch<kThreads4>(flash_fwd_kernel_bf16<DC>, grid, smem, s, qt, kt, vt, ot, lt,
                             Sq, Sk, D, scale, causal);
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
