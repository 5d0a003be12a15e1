// Flash attention for Hopper (sm_90a): forward (K4 flash_attn_fwd), dQ
// (K5 flash_attn_bwd_dq) and dK/dV (K6 flash_attn_bwd_dkv).  Inputs are
// (BH, S, D) contiguous on 16 bytes, bf16 or f32, with D % 8 == 0 (the
// wrapper pads other head dims to a multiple of 8 and copies other
// layouts); softmax, sums and outputs' arithmetic are f32.
//
// Replaces incubator_mxnet_tpu/parallel/flash_attention.py: `_fwd` (its
// Pallas `_fwd_kernel`) and the two calls of `_bwd` (`_bwd_dq_kernel`,
// `_bwd_dkv_kernel`).  The numerics are the reference's: scores are
// filled with -1e30 (not -inf) where the right-aligned causal mask
// j <= i + (Sk - Sq) hides a key, so exp(m_prev - m_new) never reads
// inf - inf; in the forward p is zeroed while a row's running max is
// still the fill (a row with no visible key gives O = 0 and
// LSE = -1e30 + log(1e-30)); l is floored at 1e-30; in the backward P is
// exp(S - LSE), zeroed on the raw (filled) score, never from LSE, and
// dS = P (dP - delta) scale with delta = rowsum(dO O) from the caller.
//
// On the TPU the K-tile axis is a sequential grid dimension that carries
// m, l and the accumulator in VMEM scratch; here that carry is a loop
// inside one block.  The wrapper's block_q/block_k tile only the plain
// version; the tiles here are fixed by D.  Any Sq and Sk: a ragged last tile
// is zero-filled in shared memory and masked.  Every launch first raises
// cudaFuncAttributeMaxDynamicSharedMemorySize above the 48 KB default.
//
// All three run on the tensor cores: mma.sync.m16n8k8 TF32 with f32 sums,
// in the 3xTF32 split that keeps f32 accuracy: each f32 operand x is cut
// into hi = tf32(x) and lo = tf32(x - hi), and a product takes three
// passes, lo*hi + hi*lo, then hi*hi.  A bf16 value is exact in TF32, so
// for bf16 inputs a product of two inputs (Q K^T, dO V^T) takes one pass
// and a product of P or dS (f32, split) with an input two.  Each block is
// 8 warps, 16 rows a warp.  A thread (g = lane / 4, t = lane % 4) holds a
// score tile in mma C fragments: rows g, g + 8 and columns 2t, 2t + 1 of
// each 8 columns.  That C fragment is the A fragment of the next product
// once its k slots are permuted (slot t is column 2t, slot t + 4 column
// 2t + 1) and the B operand's rows are read in that order, so P and dS
// never leave registers (product_pv).  A product with the other operand's
// rows as columns (S = Q K^T, dP = dO V^T) reads both from shared memory
// and splits them per 8-deep step, the lo passes of all its fragments
// before the hi pass, so no mma waits on the one before it (product_abt).
// Resident tiles are loaded once; streamed tiles come in two stages by
// 16-byte cp.async in the input's dtype (tile i + 1 loads while tile i
// computes, one barrier a tile).  D pads to the 8-column fragment (D <= 32,
// 64, 128, 256 as 32, 64, 128, 256: the accumulator width DC of
// FLASH_DISPATCH) with zero columns in shared memory, at a row pitch of 16
// bytes more than that (conflict-free fragment reads).  Only
// tiles that cross the diagonal or the ragged edge are masked.  Exp is
// __expf.  The grid is (b*h, tile), heaviest causal tile first across all
// b*h, so the light tiles fill the tail.
//
// Three forms, one launch of each kernel a call in all of them.  The
// D <= 128 forms (DC <= 8) take 128 rows a block, one warp per 16 rows.
// The D <= 256 form (DC = 16) keeps every f32 tile of D = 128 in shared
// memory by halving the rows a block (kBQ4W, kBRW: 64) and the streamed
// tile (kBK4W 32, kBSW 16), and keeps the accumulators a thread at
// D = 128's count by giving each 16 rows two warps: both form the scores
// (S, dP) over all of D, each accumulates half of D's columns (O, dQ, dK
// and dV).  The scores are computed twice; that form is for D = 256 to
// run at all, not yet to be fast.  Above 256 (DC = 0, the D-streamed
// form) a row tile of D columns does not fit: a block owns kCW = 128
// output columns (the grid's z, chunk 0 writing the LSE) of the D <= 128
// form's 128 rows and tiles, and forms the scores over D by streaming
// kDK = 32-column chunks of its operands in two cp.async stages, a ragged
// last chunk zero-filled by the copies.  Every chunk block forms the
// scores anew (at D = 512, four times), so that form too is for any D to
// run, not yet to be fast.
//
// K4: 128 query rows a block, Q resident, 64-key K/V tiles streamed up to
// the last tile any of its rows can see; the running max and sum are quad
// shuffles.  Shared memory at D = 128: 198 KB for f32 (one block an SM),
// 102 KB for bf16 (two blocks an SM, at 128 registers a thread).
// Splitting f32 K and V tiles once per block into (hi, lo) pairs, instead
// of in every warp, measured slower: the extra pass and barrier cost more
// than the ALU work saved.
//
// K5 (dQ): 128 query rows a block, Q and dO resident, 32-key K/V tiles
// streamed; S = Q K^T and dP = dO V^T in C fragments, the LSE and delta of
// a thread's two rows in registers, dS formed in place and dQ += dS K with
// K's rows read as B.  A warp skips the key tiles its own 16 rows cannot
// see.  Shared memory at D = 128 (pitch 132 floats): Q + dO 132 KB, two
// stages of 32-key K + V 66 KB, 198 KB for f32 (one block an SM); 102 KB
// for bf16 (two blocks an SM, at 128 registers a thread).  64-key tiles
// would fit f32 only single-buffered, with no overlap of copy and compute.
//
// K6 (dK, dV): 128 key rows a block, K and V resident, 32-query Q/dO tiles
// streamed from the first tile that sees the block's keys; S^T = K Q^T and
// dP^T = V dO^T in C fragments, with Q and dO read as B at [query][d]; the
// LSE and delta of the tile's 32 queries in a small shared array per
// stage, read for a thread's columns 2t, 2t + 1; P^T and dS^T in place
// feed dV += P^T dO and dK += dS^T Q.  Each block owns its output rows:
// no atomics.  A warp skips the query tiles that see none of its 16 keys.
// Shared memory at D = 128: 198.5 KB for f32, 102.5 KB for bf16; the dK
// and dV accumulators (2 x 64 f32 a thread at D = 128) keep it at one
// block an SM in both dtypes, with the registers left to the compiler.
//
// Registers a thread at D = 128 (nvcc -Xptxas -v for sm_90a): K5 181 for
// f32, no spills; 128 for bf16, the cap for two blocks an SM, at the
// price of 16 bytes of spill stores and 8 of loads (a one-block build was
// not timed).  K6 250 for f32 and 228 for bf16, no spills: the two
// 64-register sums plus S^T, dP^T and the B splits of one 8-deep step;
// 64-query tiles would need 32 more.  K4 179 for f32, no spills; 128 for
// bf16, 24 bytes of spill stores.  At D = 256 (the D <= 256 form): K4 165
// for f32, no spills, 128 for bf16 with 28 bytes of spill stores and 28
// of loads; K5 152 and 126, K6 226 and 216, no spills.
//
// What bounds them on the H100: operations.  At the LM's shapes (B 4, H 8,
// S 2048, D 128, causal, f32) the 67.1 M visible (i, j) pairs cost 2 x D
// FLOP a product each: K4 makes 2 products (S, PV), 34.4 GFLOP against
// 134 MB of inputs and outputs (0.04 ms); K5 makes 3 (S, dP, dQ), K6 4
// (S, dP, dV, dK).  On the CUDA cores (67 TFLOP/s) that is 0.513, 0.770
// and 1.026 ms; on the tensor cores in 3xTF32 (three TF32 passes at 495
// TFLOP/s) 0.208, 0.312 and 0.417 ms.  mma.sync does not reach the tensor
// cores' full rate on Hopper (wgmma does; it takes TF32 B operands only
// K-major) and each TF32 split costs ALU instructions: the next step is
// wgmma with TMA.  Their times beside SDPA's are rows 6-8 of PERF.md's
// kernel table (chip_smoke.py phase 4).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;    // 8 warps, 16 rows a warp (or 2 warps per 16 rows)
constexpr int kBQ4 = 128;        // K4's query rows per block
constexpr int kBK4 = 64;         // K4's keys per tile
constexpr int kBR = 128;         // K5's query rows, K6's key rows per block
constexpr int kBS = 32;          // K5's keys, K6's queries per streamed tile
// the same at 128 < D <= 256 (DC = 16): half the rows, two warps per 16
// rows, each owning half of D's accumulator columns
constexpr int kBQ4W = 64;
constexpr int kBK4W = 32;
constexpr int kBRW = 64;
constexpr int kBSW = 16;
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

__device__ __forceinline__ void store(float* p, int64_t i, float v) { p[i] = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, int64_t i, float v) {
  p[i] = __float2bfloat16(v);
}

// number of tiles of `keys` keys that rows [q0, q0 + rows) can see
__device__ __forceinline__ int key_tiles(int q0, int Sq, int Sk, int causal, int rows,
                                         int keys) {
  const int nk = (Sk + keys - 1) / keys;
  if (!causal) return nk;
  const int last_row = min(q0 + rows, Sq) - 1;
  const int last_key = last_row + (Sk - Sq);
  return last_key < 0 ? 0 : min(nk, last_key / keys + 1);
}

// rows [row0, row0 + kRows) of a (S, D) slice into sm (row pitch ld
// elements of T) by 16-byte cp.async, in the input's dtype; rows at or
// past S are zero-filled by the copy's source size
template <int kRows, typename T>
__device__ __forceinline__ void async_tile(T* sm, const T* g, int row0, int S, int D,
                                           int ld) {
  constexpr int kV = 16 / sizeof(T);
  const int per_row = D / kV;
  for (int v = threadIdx.x; v < kRows * per_row; v += kThreads) {
    const int r = v / per_row;
    const int c = (v - r * per_row) * kV;
    const bool ok = row0 + r < S;
    cp_async16(sm + r * ld + c, ok ? g + static_cast<int64_t>(row0 + r) * D + c : g,
               ok ? 16 : 0);
  }
}

// columns [D, DP) of `rows` rows at sm (pitch ld): zeros, never loaded
template <typename T, int DP>
__device__ __forceinline__ void zero_pad(T* sm, int rows, int D, int ld) {
  if (D == DP) return;
  const int per_row = (DP - D) * static_cast<int>(sizeof(T)) / 16;
  for (int i = threadIdx.x; i < rows * per_row; i += kThreads) {
    const int r = i / per_row;
    reinterpret_cast<float4*>(sm + r * ld + D)[i - r * per_row] =
        make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// x rounded to TF32 as cvt.rna.tf32.f32 rounds it (to nearest, ties away
// from zero, onto 10 mantissa bits), in two integer ops: on sm_90a the cvt
// compiles to a longer sequence (FSETP/SEL checks), and this form measured
// ~20% faster in K4-K6 with bit-identical results
__device__ __forceinline__ unsigned tf32_bits(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// the TF32 parts of x: hi = tf32(x) and, for a float, lo = tf32(x - hi).
// A bf16 value is exact in TF32: hi is its bits and lo is never used.
template <typename T>
__device__ __forceinline__ void split(T x, unsigned& hi, unsigned& lo) {
  const float f = to_f32(x);
  if (sizeof(T) == 4) {
    hi = tf32_bits(f);
    lo = tf32_bits(f - __uint_as_float(hi));
  } else {
    hi = __float_as_uint(f);
  }
}

// --- the two warp products ------------------------------------------------

// c[j] += A B_j^T over depth DP: A is the warp's 16 rows at a, B_j the 8
// rows at b + 8j ld (both pitch ld, in shared memory); c in C fragments.
// 3 TF32 passes for f32 inputs, 1 for bf16.
template <typename T, int DP, int NB>
__device__ __forceinline__ void product_abt(float (&c)[NB][4], const T* a, const T* b,
                                            int ld) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const T* ar = a + g * ld;
#pragma unroll
  for (int d0 = 0; d0 < DP; d0 += 8) {
    unsigned ah[4], al[4];
    split(ar[d0 + t], ah[0], al[0]);
    split(ar[8 * ld + d0 + t], ah[1], al[1]);
    split(ar[d0 + t + 4], ah[2], al[2]);
    split(ar[8 * ld + d0 + t + 4], ah[3], al[3]);
    unsigned bh[NB][2], bl[NB][2];
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const T* br = b + (j * 8 + g) * ld + d0 + t;
      split(br[0], bh[j][0], bl[j][0]);
      split(br[4], bh[j][1], bl[j][1]);
    }
    if (sizeof(T) == 4) {
#pragma unroll
      for (int j = 0; j < NB; ++j) mma_tf32(c[j], al, bh[j]);
#pragma unroll
      for (int j = 0; j < NB; ++j) mma_tf32(c[j], ah, bl[j]);
    }
#pragma unroll
    for (int j = 0; j < NB; ++j) mma_tf32(c[j], ah, bh[j]);
  }
}

// o += P B: P (16 x 8 KT, f32) in C fragments, as product_abt leaves it;
// B's 8 KT rows at b (pitch ld, in shared memory), NT 8-column fragments
// wide.  P's C fragment is the A fragment once slot t is column 2t and slot
// t + 4 column 2t + 1, so B's rows are read in that order.  P is split:
// 3 passes for f32 B, 2 for bf16.
template <typename T, int NT, int KT>
__device__ __forceinline__ void product_pv(float (&o)[NT][4], const float (&p)[KT][4],
                                           const T* b, int ld) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int c = 0; c < KT; ++c) {
    unsigned ph[4], pl[4];
    split(p[c][0], ph[0], pl[0]);
    split(p[c][2], ph[1], pl[1]);
    split(p[c][1], ph[2], pl[2]);
    split(p[c][3], ph[3], pl[3]);
    const T* br = b + (c * 8 + 2 * t) * ld + g;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      unsigned vh[2], vl[2];
      split(br[n * 8], vh[0], vl[0]);
      split(br[ld + n * 8], vh[1], vl[1]);
      if (sizeof(T) == 4) mma_tf32(o[n], ph, vl);
      mma_tf32(o[n], pl, vh);
      mma_tf32(o[n], ph, vh);
    }
  }
}

template <int R, int C>
__device__ __forceinline__ void zero(float (&x)[R][C]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < C; ++j) x[i][j] = 0.f;
}

// rows r0, r0 + 8 of a warp's (16, 8 NT) C-fragment tile, columns c0 ..
// c0 + 8 NT - 1, into (S, D) at out; rows at or past S and columns at or
// past D are not stored
template <typename T, int NT>
__device__ __forceinline__ void store_rows(T* out, const float (&o)[NT][4], int r0, int S,
                                           int D, int c0) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + 8 * h;
    if (row >= S) continue;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      if (c0 + n * 8 >= D) break;
      const int64_t i = static_cast<int64_t>(row) * D + c0 + n * 8 + 2 * t;
      store(out, i, o[n][2 * h]);
      store(out, i + 1, o[n][2 * h + 1]);
    }
  }
}

// --- K4: forward ----------------------------------------------------------

// kRows query rows a block, kTile-key tiles (kBQ4, kBK4; kBQ4W, kBK4W at
// DC = 16).  At D = 128 f32 tiles take 198 KB of shared memory: one block
// an SM, with the registers left to the compiler; bf16 tiles take 102 KB,
// and two blocks fit an SM when a thread keeps to 128 registers.  At
// D = 256: 64 rows and 2 x 2 stages of 32 keys, 195 KB f32, 99 KB bf16.
template <typename T, int DC, int kRows, int kTile>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 4 ? 1 : 2)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, float* __restrict__ lse,
                 int Sq, int Sk, int D, float scale, int causal) {
  constexpr int kSplit = kThreads / 2 / kRows;  // warps per 16 rows
  constexpr int NT = 2 * DC / kSplit;  // 8-column fragments of O a warp holds
  constexpr int DP = 16 * DC;      // D padded to the fragments (DP >= D)
  constexpr int KT = kTile / 8;    // 8-key fragments of S
  constexpr int ld = DP + 16 / static_cast<int>(sizeof(T));  // row pitch
  extern __shared__ float4 smem4[];
  T* sQ = reinterpret_cast<T*>(smem4);
  T* sK = sQ + kRows * ld;         // two stages each of K and V
  T* sV = sK + 2 * kTile * ld;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int rw = warp / kSplit;            // the warp's 16 rows
  const int c0 = warp % kSplit * NT * 8;   // and its first output column
  // blocks start in the order of their linear index, x fastest: the query
  // tile is y, heaviest (causal: last) first, so the tail is light
  const int nq = (Sq + kRows - 1) / kRows;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.y)) * kRows;
  const int64_t bh = blockIdx.x;
  const int offset = Sk - Sq;
  const T* kb = k + bh * Sk * D;
  const T* vb = v + bh * Sk * D;
  const int r0 = q0 + rw * 16 + g;  // this thread's rows: r0 and r0 + 8
  const T* qw = sQ + rw * 16 * ld;

  float o[NT][4], m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  zero(o);
  zero_pad<T, DP>(sQ, kRows + 4 * kTile, D, ld);
  const int nk = key_tiles(q0, Sq, Sk, causal, kRows, kTile);
  if (nk > 0) {
    async_tile<kRows>(sQ, q + bh * Sq * D, q0, Sq, D, ld);
    async_tile<kTile>(sK, kb, 0, Sk, D, ld);
    async_tile<kTile>(sV, vb, 0, Sk, D, ld);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<0>();
    __syncthreads();  // tile kt is in; every warp is done with tile kt - 1
    if (kt + 1 < nk) {  // tile kt + 1 loads into kt - 1's stage while kt computes
      const int nb = (kt + 1) & 1;
      async_tile<kTile>(sK + nb * kTile * ld, kb, (kt + 1) * kTile, Sk, D, ld);
      async_tile<kTile>(sV + nb * kTile * ld, vb, (kt + 1) * kTile, Sk, D, ld);
      cp_async_commit();
    }
    const T* sk = sK + (kt & 1) * kTile * ld;
    const T* sv = sV + (kt & 1) * kTile * ld;
    const int k0 = kt * kTile;

    // S = Q K^T over all of D: the warp's 16 rows x kTile keys (at kSplit 2
    // both warps of the rows form it)
    float s[KT][4];
    zero(s);
    product_abt<T, DP, KT>(s, qw, sk, ld);

    // scale and mask; thread t holds keys 2t and 2t + 1 of each fragment,
    // and a row's 4 threads (one quad) reduce by shuffles
    const bool full = k0 + kTile <= Sk && (!causal || k0 + kTile - 1 <= q0 + offset);
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
    product_pv<T, NT, KT>(o, s, sv + c0, ld);  // O += P V, P from registers
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const float lf = fmaxf(l[h], 1e-30f);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      o[n][2 * h] /= lf;
      o[n][2 * h + 1] /= lf;
    }
    const int row = r0 + 8 * h;
    if (t == 0 && c0 == 0 && row < Sq) lse[bh * Sq + row] = m[h] + logf(lf);
  }
  store_rows<T, NT>(out + bh * Sq * D, o, r0, Sq, D, c0);
}

// --- K5: dQ ---------------------------------------------------------------

// kRows query rows a block, kTile-key tiles (kBR, kBS; kBRW, kBSW at
// DC = 16).  At D = 128 f32 tiles take 198 KB of shared memory, so one
// block an SM; bf16 tiles 102 KB, so two at 128 registers a thread.  At
// D = 256: 64 rows each of Q and dO and 2 x 2 stages of 16 keys, 195 KB
// f32, 99 KB bf16.
template <typename T, int DC, int kRows, int kTile>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 4 ? 1 : 2)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    T* __restrict__ dq, int Sq, int Sk, int D, float scale, int causal) {
  constexpr int kSplit = kThreads / 2 / kRows;  // warps per 16 rows
  constexpr int NT = 2 * DC / kSplit;  // 8-column fragments of dQ a warp holds
  constexpr int DP = 16 * DC;      // D padded to the fragments
  constexpr int KT = kTile / 8;    // 8-key fragments of S, dP and dS
  constexpr int ld = DP + 16 / static_cast<int>(sizeof(T));
  extern __shared__ float4 smem4[];
  T* sQ = reinterpret_cast<T*>(smem4);
  T* sdO = sQ + kRows * ld;
  T* sK = sdO + kRows * ld;        // two stages each of K and V
  T* sV = sK + 2 * kTile * ld;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int rw = warp / kSplit;            // the warp's 16 rows
  const int c0 = warp % kSplit * NT * 8;   // and its first dQ column
  const int nq = (Sq + kRows - 1) / kRows;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.y)) * kRows;  // heaviest first
  const int64_t bh = blockIdx.x;
  const int offset = Sk - Sq;
  const T* kb = k + bh * Sk * D;
  const T* vb = v + bh * Sk * D;
  const int w0 = q0 + rw * 16;     // the warp's first row
  const int r0 = w0 + g;           // this thread's rows: r0 and r0 + 8
  const T* qw = sQ + rw * 16 * ld;
  const T* dw = sdO + rw * 16 * ld;

  float lse_r[2], delta_r[2], acc[NT][4];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + 8 * h;
    lse_r[h] = row < Sq ? lse[bh * Sq + row] : 0.f;
    delta_r[h] = row < Sq ? delta[bh * Sq + row] : 0.f;
  }
  zero(acc);
  zero_pad<T, DP>(sQ, 2 * kRows + 4 * kTile, D, ld);
  const int nk = key_tiles(q0, Sq, Sk, causal, kRows, kTile);
  const int nk_warp = w0 < Sq ? key_tiles(w0, Sq, Sk, causal, 16, kTile) : 0;
  if (nk > 0) {
    async_tile<kRows>(sQ, q + bh * Sq * D, q0, Sq, D, ld);
    async_tile<kRows>(sdO, dout + bh * Sq * D, q0, Sq, D, ld);
    async_tile<kTile>(sK, kb, 0, Sk, D, ld);
    async_tile<kTile>(sV, vb, 0, Sk, D, ld);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<0>();
    __syncthreads();  // tile kt is in; every warp is done with tile kt - 1
    if (kt + 1 < nk) {
      const int nb = (kt + 1) & 1;
      async_tile<kTile>(sK + nb * kTile * ld, kb, (kt + 1) * kTile, Sk, D, ld);
      async_tile<kTile>(sV + nb * kTile * ld, vb, (kt + 1) * kTile, Sk, D, ld);
      cp_async_commit();
    }
    if (kt >= nk_warp) continue;  // the warp's rows see no key of this tile
    const T* sk = sK + (kt & 1) * kTile * ld;
    const T* sv = sV + (kt & 1) * kTile * ld;
    const int k0 = kt * kTile;

    float s[KT][4], dp[KT][4];
    zero(s);
    zero(dp);
    product_abt<T, DP, KT>(s, qw, sk, ld);   // S = Q K^T
    product_abt<T, DP, KT>(dp, dw, sv, ld);  // dP = dO V^T
    // dS = P (dP - delta) scale in place of S; P is 0 where the mask fills
    // the score, which also keeps rows that see no key at exactly 0
    const bool full = k0 + kTile <= Sk && (!causal || k0 + kTile - 1 <= w0 + offset);
#pragma unroll
    for (int j = 0; j < KT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const int key = k0 + j * 8 + 2 * t + (e & 1);
        const bool seen =
            full || (key < Sk && (!causal || key <= r0 + 8 * h + offset));
        const float p = seen ? __expf(s[j][e] * scale - lse_r[h]) : 0.f;
        s[j][e] = p * (dp[j][e] - delta_r[h]) * scale;
      }
    product_pv<T, NT, KT>(acc, s, sk + c0, ld);  // dQ += dS K
  }
  store_rows<T, NT>(dq + bh * Sq * D, acc, r0, Sq, D, c0);
}

// --- K6: dK and dV --------------------------------------------------------

// the LSE and delta of queries [q0, q0 + kTile) into sl and sd; rows at or
// past Sq get 0 (they are masked)
template <int kTile>
__device__ __forceinline__ void stage_rows(float* sl, float* sd, const float* lse,
                                           const float* delta, int q0, int Sq) {
  const int i = threadIdx.x;
  if (i < kTile) {
    sl[i] = q0 + i < Sq ? lse[q0 + i] : 0.f;
  } else if (i < 2 * kTile) {
    sd[i - kTile] = q0 + i - kTile < Sq ? delta[q0 + i - kTile] : 0.f;
  }
}

// kRows key rows a block, kTile-query tiles (kBR, kBS; kBRW, kBSW at
// DC = 16).  One block an SM in both dtypes: the dK and dV sums take
// 2 x 4 NT registers a thread besides S^T, dP^T and the splits (at
// D = 256 two warps share 16 keys, so 2 x 64 as at D = 128)
template <typename T, int DC, int kRows, int kTile>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     T* __restrict__ dk, T* __restrict__ dv, int Sq, int Sk, int D,
                     float scale, int causal) {
  constexpr int kSplit = kThreads / 2 / kRows;  // warps per 16 keys
  constexpr int NT = 2 * DC / kSplit;  // 8-column fragments of dK, dV a warp holds
  constexpr int DP = 16 * DC;
  constexpr int QT = kTile / 8;    // 8-query fragments of S^T, dP^T and dS^T
  constexpr int ld = DP + 16 / static_cast<int>(sizeof(T));
  extern __shared__ float4 smem4[];
  T* sK = reinterpret_cast<T*>(smem4);
  T* sV = sK + kRows * ld;
  T* sQ = sV + kRows * ld;         // two stages each of Q and dO
  T* sdO = sQ + 2 * kTile * ld;
  float* sL = reinterpret_cast<float*>(sdO + 2 * kTile * ld);  // two stages of LSE
  float* sDelta = sL + 2 * kTile;                              // and of delta

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.y * kRows;  // the first key tiles (causal: heaviest) first
  const int64_t bh = blockIdx.x;
  const int offset = Sk - Sq;
  const T* qb = q + bh * Sq * D;
  const T* db = dout + bh * Sq * D;
  const float* lb = lse + bh * Sq;
  const float* deb = delta + bh * Sq;
  const int rw = warp / kSplit;            // the warp's 16 keys
  const int c0 = warp % kSplit * NT * 8;   // and its first dK, dV column
  const int w0 = k0 + rw * 16;     // the warp's first key
  const int key0 = w0 + g;         // this thread's keys: key0 and key0 + 8
  const T* kw = sK + rw * 16 * ld;
  const T* vw = sV + rw * 16 * ld;

  float acc_k[NT][4], acc_v[NT][4];
  zero(acc_k);
  zero(acc_v);
  zero_pad<T, DP>(sK, 2 * kRows + 4 * kTile, D, ld);
  const int nq = (Sq + kTile - 1) / kTile;
  // the first query that sees key j is j - offset
  const int qt0 = causal ? max(0, k0 - offset) / kTile : 0;
  const int qt_warp = w0 >= Sk ? nq : causal ? max(0, w0 - offset) / kTile : 0;
  async_tile<kRows>(sK, k + bh * Sk * D, k0, Sk, D, ld);
  async_tile<kRows>(sV, v + bh * Sk * D, k0, Sk, D, ld);
  async_tile<kTile>(sQ, qb, qt0 * kTile, Sq, D, ld);
  async_tile<kTile>(sdO, db, qt0 * kTile, Sq, D, ld);
  cp_async_commit();
  stage_rows<kTile>(sL, sDelta, lb, deb, qt0 * kTile, Sq);
  for (int qt = qt0; qt < nq; ++qt) {
    const int st = (qt - qt0) & 1;
    cp_async_wait<0>();
    __syncthreads();  // tile qt is in; every warp is done with tile qt - 1
    if (qt + 1 < nq) {
      const int nb = st ^ 1;
      async_tile<kTile>(sQ + nb * kTile * ld, qb, (qt + 1) * kTile, Sq, D, ld);
      async_tile<kTile>(sdO + nb * kTile * ld, db, (qt + 1) * kTile, Sq, D, ld);
      cp_async_commit();
      stage_rows<kTile>(sL + nb * kTile, sDelta + nb * kTile, lb, deb, (qt + 1) * kTile, Sq);
    }
    if (qt < qt_warp) continue;  // no query of this tile sees the warp's keys
    const T* sq = sQ + st * kTile * ld;
    const T* sd = sdO + st * kTile * ld;
    const float* tl = sL + st * kTile;
    const float* td = sDelta + st * kTile;
    const int q0 = qt * kTile;

    // P^T = exp(S^T scale - LSE) with S^T = K Q^T: rows are the warp's
    // keys, columns the tile's queries (thread t: 2t, 2t + 1 of each 8)
    float s[QT][4];
    zero(s);
    product_abt<T, DP, QT>(s, kw, sq, ld);
    const bool full = q0 + kTile <= Sq && w0 + 16 <= Sk &&
                      (!causal || w0 + 15 <= q0 + offset);
#pragma unroll
    for (int j = 0; j < QT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + 2 * t + (e & 1);
        const int key = key0 + 8 * (e >> 1);
        const bool seen = full || (q0 + col < Sq && key < Sk &&
                                   (!causal || key <= q0 + col + offset));
        s[j][e] = seen ? __expf(s[j][e] * scale - tl[col]) : 0.f;
      }
    product_pv<T, NT, QT>(acc_v, s, sd + c0, ld);  // dV += P^T dO

    float dp[QT][4];
    zero(dp);
    product_abt<T, DP, QT>(dp, vw, sd, ld);   // dP^T = V dO^T
#pragma unroll
    for (int j = 0; j < QT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + 2 * t + (e & 1);
        s[j][e] *= (dp[j][e] - td[col]) * scale;  // dS^T
      }
    product_pv<T, NT, QT>(acc_k, s, sq + c0, ld);  // dK += dS^T Q
  }
  store_rows<T, NT>(dk + bh * Sk * D, acc_k, key0, Sk, D, c0);
  store_rows<T, NT>(dv + bh * Sk * D, acc_v, key0, Sk, D, c0);
}

// --- the D-streamed form (D > 256) ----------------------------------------

// No tile of D > 256 columns stays in shared memory, so a block owns kCW
// output columns (the grid's z) of the D <= 128 form's rows (kBQ4, kBR)
// and forms the scores (S, and dP in the backward) over all of D by
// streaming kDK-column chunks of its operands: a tile of keys (K4, K5) or
// queries (K6) takes nd = ceil(D / kDK) score steps, then one value step
// that stages the tile's kCW columns the block accumulates.  The steps run
// in two cp.async stages, one barrier a step.  Every chunk block forms the
// scores anew (at D = 512, four times); the accumulators a thread are the
// D = 128 form's (NT = 16).
constexpr int kCW = 128;   // output columns a block
constexpr int kDK = 32;    // D columns a score step stages

// elements of one stage: the larger of a score step (score_rows rows of a
// kDK chunk) and a value step (value_rows rows of a kCW chunk), each at
// its pitch (16 bytes more than the chunk)
template <typename T>
__host__ __device__ constexpr int stream_stage(int score_rows, int value_rows) {
  return score_rows * (kDK + 16 / static_cast<int>(sizeof(T))) >
                 value_rows * (kCW + 16 / static_cast<int>(sizeof(T)))
             ? score_rows * (kDK + 16 / static_cast<int>(sizeof(T)))
             : value_rows * (kCW + 16 / static_cast<int>(sizeof(T)));
}

// rows [row0, row0 + kRows) x columns [c0, c0 + kW) of a (S, D) slice into
// sm (pitch ld) by 16-byte cp.async; rows at or past S and columns at or
// past D are zero-filled by the copy's source size (a ragged chunk's
// padding is exact zeros)
template <int kRows, int kW, typename T>
__device__ __forceinline__ void async_chunk(T* sm, const T* g, int row0, int S, int D, int c0,
                                            int ld) {
  constexpr int kV = 16 / sizeof(T);
  constexpr int per_row = kW / kV;
  for (int v = threadIdx.x; v < kRows * per_row; v += kThreads) {
    const int r = v / per_row;
    const int c = (v - r * per_row) * kV;
    const bool ok = row0 + r < S && c0 + c < D;
    cp_async16(sm + r * ld + c, ok ? g + static_cast<int64_t>(row0 + r) * D + c0 + c : g,
               ok ? 16 : 0);
  }
}

// the step after (tile, j) of a walk of nd score steps and one value step
// a tile
__device__ __forceinline__ void next_step(int& tile, int& j, int nd) {
  if (++j > nd) {
    j = 0;
    ++tile;
  }
}

// K4, D-streamed: kBQ4 query rows x kCW columns of O a block, 64-key
// tiles; a score step stages a chunk of Q and of K, the value step the
// block's columns of V.  The LSE is the same for every chunk: chunk 0
// writes it.
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_fwd_streamed_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, T* __restrict__ out,
                          float* __restrict__ lse, int Sq, int Sk, int D, float scale,
                          int causal) {
  constexpr int kRows = kBQ4, kTile = kBK4;
  constexpr int NT = kCW / 8, KT = kTile / 8;
  constexpr int ldk = kDK + 16 / static_cast<int>(sizeof(T));
  constexpr int ldc = kCW + 16 / static_cast<int>(sizeof(T));
  constexpr int kStage = stream_stage<T>(kRows + kTile, kTile);
  extern __shared__ float4 smem4[];
  T* sm = reinterpret_cast<T*>(smem4);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int nq = (Sq + kRows - 1) / kRows;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.y)) * kRows;  // heaviest first
  const int c0 = blockIdx.z * kCW;
  const int64_t bh = blockIdx.x;
  const int offset = Sk - Sq;
  const T* qb = q + bh * Sq * D;
  const T* kb = k + bh * Sk * D;
  const T* vb = v + bh * Sk * D;
  const int r0 = q0 + warp * 16 + g;  // this thread's rows: r0 and r0 + 8
  const int nd = (D + kDK - 1) / kDK;
  const int nk = key_tiles(q0, Sq, Sk, causal, kRows, kTile);

  auto issue = [&](int kt, int j, int stage) {
    T* st = sm + stage * kStage;
    if (j < nd) {
      async_chunk<kRows, kDK>(st, qb, q0, Sq, D, j * kDK, ldk);
      async_chunk<kTile, kDK>(st + kRows * ldk, kb, kt * kTile, Sk, D, j * kDK, ldk);
    } else {
      async_chunk<kTile, kCW>(st, vb, kt * kTile, Sk, D, c0, ldc);
    }
    cp_async_commit();
  };

  float o[NT][4], s[KT][4], m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  zero(o);
  zero(s);
  if (nk > 0) issue(0, 0, 0);
  for (int kt = 0, j = 0, i = 0; kt < nk; next_step(kt, j, nd), ++i) {
    cp_async_wait<0>();
    __syncthreads();  // step i is in; every warp is done with step i - 1
    int nkt = kt, nj = j;
    next_step(nkt, nj, nd);
    if (nkt < nk) issue(nkt, nj, (i + 1) & 1);
    const T* st = sm + (i & 1) * kStage;
    if (j < nd) {  // S += Q K^T over this chunk of D
      product_abt<T, kDK, KT>(s, st + warp * 16 * ldk, st + kRows * ldk, ldk);
      continue;
    }
    const int k0 = kt * kTile;
    const bool full = k0 + kTile <= Sk && (!causal || k0 + kTile - 1 <= q0 + offset);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int jj = 0; jj < KT; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + jj * 8 + 2 * t + (e & 1);
        float x = s[jj][e] * scale;
        if (!full && !(key < Sk && (!causal || key <= r0 + 8 * (e >> 1) + offset)))
          x = kNegInf;
        s[jj][e] = x;
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
    for (int jj = 0; jj < KT; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const float p = m_new[h] > kNegInf / 2 ? __expf(s[jj][e] - m_new[h]) : 0.f;
        s[jj][e] = p;
        sum[h] += p;
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = alpha[h] * l[h] + sum[h];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }
    product_pv<T, NT, KT>(o, s, st, ldc);  // O += P V over the block's columns
    zero(s);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const float lf = fmaxf(l[h], 1e-30f);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      o[n][2 * h] /= lf;
      o[n][2 * h + 1] /= lf;
    }
    const int row = r0 + 8 * h;
    if (t == 0 && blockIdx.z == 0 && row < Sq) lse[bh * Sq + row] = m[h] + logf(lf);
  }
  store_rows<T, NT>(out + bh * Sq * D, o, r0, Sq, D, c0);
}

// K5, D-streamed: kBR query rows x kCW columns of dQ a block, 32-key
// tiles; a score step stages a chunk each of Q, dO, K and V, the value
// step the block's columns of K.
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_streamed_kernel(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v, const T* __restrict__ dout,
                             const float* __restrict__ lse, const float* __restrict__ delta,
                             T* __restrict__ dq, int Sq, int Sk, int D, float scale,
                             int causal) {
  constexpr int kRows = kBR, kTile = kBS;
  constexpr int NT = kCW / 8, KT = kTile / 8;
  constexpr int ldk = kDK + 16 / static_cast<int>(sizeof(T));
  constexpr int ldc = kCW + 16 / static_cast<int>(sizeof(T));
  constexpr int kStage = stream_stage<T>(2 * kRows + 2 * kTile, kTile);
  extern __shared__ float4 smem4[];
  T* sm = reinterpret_cast<T*>(smem4);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int nq = (Sq + kRows - 1) / kRows;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.y)) * kRows;  // heaviest first
  const int c0 = blockIdx.z * kCW;
  const int64_t bh = blockIdx.x;
  const int offset = Sk - Sq;
  const T* qb = q + bh * Sq * D;
  const T* db = dout + bh * Sq * D;
  const T* kb = k + bh * Sk * D;
  const T* vb = v + bh * Sk * D;
  const int w0 = q0 + warp * 16;   // the warp's first row
  const int r0 = w0 + g;           // this thread's rows: r0 and r0 + 8
  const int nd = (D + kDK - 1) / kDK;

  float lse_r[2], delta_r[2], acc[NT][4], s[KT][4], dp[KT][4];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + 8 * h;
    lse_r[h] = row < Sq ? lse[bh * Sq + row] : 0.f;
    delta_r[h] = row < Sq ? delta[bh * Sq + row] : 0.f;
  }
  zero(acc);
  zero(s);
  zero(dp);
  const int nk = key_tiles(q0, Sq, Sk, causal, kRows, kTile);
  const int nk_warp = w0 < Sq ? key_tiles(w0, Sq, Sk, causal, 16, kTile) : 0;

  auto issue = [&](int kt, int j, int stage) {
    T* st = sm + stage * kStage;
    if (j < nd) {
      async_chunk<kRows, kDK>(st, qb, q0, Sq, D, j * kDK, ldk);
      async_chunk<kRows, kDK>(st + kRows * ldk, db, q0, Sq, D, j * kDK, ldk);
      async_chunk<kTile, kDK>(st + 2 * kRows * ldk, kb, kt * kTile, Sk, D, j * kDK, ldk);
      async_chunk<kTile, kDK>(st + (2 * kRows + kTile) * ldk, vb, kt * kTile, Sk, D,
                              j * kDK, ldk);
    } else {
      async_chunk<kTile, kCW>(st, kb, kt * kTile, Sk, D, c0, ldc);
    }
    cp_async_commit();
  };

  if (nk > 0) issue(0, 0, 0);
  for (int kt = 0, j = 0, i = 0; kt < nk; next_step(kt, j, nd), ++i) {
    cp_async_wait<0>();
    __syncthreads();  // step i is in; every warp is done with step i - 1
    int nkt = kt, nj = j;
    next_step(nkt, nj, nd);
    if (nkt < nk) issue(nkt, nj, (i + 1) & 1);
    if (kt >= nk_warp) continue;  // the warp's rows see no key of this tile
    const T* st = sm + (i & 1) * kStage;
    if (j < nd) {  // S += Q K^T, dP += dO V^T over this chunk of D
      product_abt<T, kDK, KT>(s, st + warp * 16 * ldk, st + 2 * kRows * ldk, ldk);
      product_abt<T, kDK, KT>(dp, st + (kRows + warp * 16) * ldk,
                              st + (2 * kRows + kTile) * ldk, ldk);
      continue;
    }
    const int k0 = kt * kTile;
    const bool full = k0 + kTile <= Sk && (!causal || k0 + kTile - 1 <= w0 + offset);
#pragma unroll
    for (int jj = 0; jj < KT; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const int key = k0 + jj * 8 + 2 * t + (e & 1);
        const bool seen = full || (key < Sk && (!causal || key <= r0 + 8 * h + offset));
        const float p = seen ? __expf(s[jj][e] * scale - lse_r[h]) : 0.f;
        s[jj][e] = p * (dp[jj][e] - delta_r[h]) * scale;
      }
    product_pv<T, NT, KT>(acc, s, st, ldc);  // dQ += dS K over the block's columns
    zero(s);
    zero(dp);
  }
  store_rows<T, NT>(dq + bh * Sq * D, acc, r0, Sq, D, c0);
}

// K6, D-streamed: kBR key rows x kCW columns of dK and dV a block,
// 32-query tiles; a score step stages a chunk each of K, V, Q and dO, the
// value step the block's columns of dO and Q; the tile's LSE and delta
// are staged with its first step, in two buffers by the tile's parity.
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_streamed_kernel(const T* __restrict__ q, const T* __restrict__ k,
                              const T* __restrict__ v, const T* __restrict__ dout,
                              const float* __restrict__ lse, const float* __restrict__ delta,
                              T* __restrict__ dk, T* __restrict__ dv, int Sq, int Sk, int D,
                              float scale, int causal) {
  constexpr int kRows = kBR, kTile = kBS;
  constexpr int NT = kCW / 8, QT = kTile / 8;
  constexpr int ldk = kDK + 16 / static_cast<int>(sizeof(T));
  constexpr int ldc = kCW + 16 / static_cast<int>(sizeof(T));
  constexpr int kStage = stream_stage<T>(2 * kRows + 2 * kTile, 2 * kTile);
  extern __shared__ float4 smem4[];
  T* sm = reinterpret_cast<T*>(smem4);
  float* sL = reinterpret_cast<float*>(sm + 2 * kStage);  // two buffers of LSE
  float* sDelta = sL + 2 * kTile;                         // and of delta

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.y * kRows;  // the first key tiles (causal: heaviest) first
  const int c0 = blockIdx.z * kCW;
  const int64_t bh = blockIdx.x;
  const int offset = Sk - Sq;
  const T* qb = q + bh * Sq * D;
  const T* db = dout + bh * Sq * D;
  const T* kb = k + bh * Sk * D;
  const T* vb = v + bh * Sk * D;
  const float* lb = lse + bh * Sq;
  const float* deb = delta + bh * Sq;
  const int w0 = k0 + warp * 16;   // the warp's first key
  const int key0 = w0 + g;         // this thread's keys: key0 and key0 + 8
  const int nd = (D + kDK - 1) / kDK;

  float acc_k[NT][4], acc_v[NT][4], s[QT][4], dp[QT][4];
  zero(acc_k);
  zero(acc_v);
  zero(s);
  zero(dp);
  const int nq = (Sq + kTile - 1) / kTile;
  // the first query that sees key j is j - offset
  const int qt0 = causal ? max(0, k0 - offset) / kTile : 0;
  const int qt_warp = w0 >= Sk ? nq : causal ? max(0, w0 - offset) / kTile : 0;

  auto issue = [&](int qt, int j, int stage) {
    T* st = sm + stage * kStage;
    if (j < nd) {
      async_chunk<kRows, kDK>(st, kb, k0, Sk, D, j * kDK, ldk);
      async_chunk<kRows, kDK>(st + kRows * ldk, vb, k0, Sk, D, j * kDK, ldk);
      async_chunk<kTile, kDK>(st + 2 * kRows * ldk, qb, qt * kTile, Sq, D, j * kDK, ldk);
      async_chunk<kTile, kDK>(st + (2 * kRows + kTile) * ldk, db, qt * kTile, Sq, D,
                              j * kDK, ldk);
    } else {
      async_chunk<kTile, kCW>(st, db, qt * kTile, Sq, D, c0, ldc);
      async_chunk<kTile, kCW>(st + kTile * ldc, qb, qt * kTile, Sq, D, c0, ldc);
    }
    cp_async_commit();
    if (j == 0) {
      const int b = (qt - qt0) & 1;
      stage_rows<kTile>(sL + b * kTile, sDelta + b * kTile, lb, deb, qt * kTile, Sq);
    }
  };

  if (qt0 < nq) issue(qt0, 0, 0);
  for (int qt = qt0, j = 0, i = 0; qt < nq; next_step(qt, j, nd), ++i) {
    cp_async_wait<0>();
    __syncthreads();  // step i is in; every warp is done with step i - 1
    int nqt = qt, nj = j;
    next_step(nqt, nj, nd);
    if (nqt < nq) issue(nqt, nj, (i + 1) & 1);
    if (qt < qt_warp) continue;  // no query of this tile sees the warp's keys
    const T* st = sm + (i & 1) * kStage;
    if (j < nd) {  // S^T += K Q^T, dP^T += V dO^T over this chunk of D
      product_abt<T, kDK, QT>(s, st + warp * 16 * ldk, st + 2 * kRows * ldk, ldk);
      product_abt<T, kDK, QT>(dp, st + (kRows + warp * 16) * ldk,
                              st + (2 * kRows + kTile) * ldk, ldk);
      continue;
    }
    const float* tl = sL + ((qt - qt0) & 1) * kTile;
    const float* td = sDelta + ((qt - qt0) & 1) * kTile;
    const int q0 = qt * kTile;
    const bool full = q0 + kTile <= Sq && w0 + 16 <= Sk && (!causal || w0 + 15 <= q0 + offset);
#pragma unroll
    for (int jj = 0; jj < QT; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = jj * 8 + 2 * t + (e & 1);
        const int key = key0 + 8 * (e >> 1);
        const bool seen =
            full || (q0 + col < Sq && key < Sk && (!causal || key <= q0 + col + offset));
        s[jj][e] = seen ? __expf(s[jj][e] * scale - tl[col]) : 0.f;
      }
    product_pv<T, NT, QT>(acc_v, s, st, ldc);  // dV += P^T dO
#pragma unroll
    for (int jj = 0; jj < QT; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = jj * 8 + 2 * t + (e & 1);
        s[jj][e] *= (dp[jj][e] - td[col]) * scale;  // dS^T
      }
    product_pv<T, NT, QT>(acc_k, s, st + kTile * ldc, ldc);  // dK += dS^T Q
    zero(s);
    zero(dp);
  }
  store_rows<T, NT>(dk + bh * Sk * D, acc_k, key0, Sk, D, c0);
  store_rows<T, NT>(dv + bh * Sk * D, acc_v, key0, Sk, D, c0);
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

// bytes of `rows` shared-memory rows of T at the kernels' pitch: D padded
// to 16 DC elements, + 16 bytes
template <typename T, int DC>
size_t tile_bytes(int rows) {
  return static_cast<size_t>(rows) * (16 * DC + 16 / sizeof(T)) * sizeof(T);
}

// rows a block of K4 and of K5/K6 at head dim D: the D <= 256 form's
// 64-row tiles above 128, the 128-row tiles of the D <= 128 form below it
// and in the D-streamed form above 256
int rows_q4(int D) { return D > 128 && D <= 256 ? kBQ4W : kBQ4; }
int rows_r(int D) { return D > 128 && D <= 256 ? kBRW : kBR; }
// the kCW-column chunks of a launch (the grid's z): 1 up to D = 256
int chunks(int D) { return D > 256 ? (D + kCW - 1) / kCW : 1; }

// b*h is the grid's x (up to 2^31 - 1); the grid's y, `tiles` row tiles of
// the launch, and its z, the column chunks, are at most 65535 each.  The
// wrapper pads head dims to a multiple of 8.
bool bad_shape(int BH, int Sq, int Sk, int D, int tiles) {
  return BH < 1 || Sq < 1 || Sk < 1 || D < 8 || D % 8 || tiles > 65535 || chunks(D) > 65535;
}

template <typename T, int DC>
int fwd(const void* q, const void* k, const void* v, void* out, void* lse, int BH, int Sq,
        int Sk, int D, float scale, int causal, cudaStream_t s) {
  if constexpr (DC == 0) {  // the D-streamed form: two stages
    const size_t smem = 2 * stream_stage<T>(kBQ4 + kBK4, kBK4) * sizeof(T);
    const dim3 grid(BH, (Sq + kBQ4 - 1) / kBQ4, chunks(D));
    return launch(flash_fwd_streamed_kernel<T>, grid, smem, s, static_cast<const T*>(q),
                  static_cast<const T*>(k), static_cast<const T*>(v), static_cast<T*>(out),
                  static_cast<float*>(lse), Sq, Sk, D, scale, causal);
  } else {
    constexpr int R = DC <= 8 ? kBQ4 : kBQ4W, K = DC <= 8 ? kBK4 : kBK4W;
    // the Q tile and two stages each of K and V
    const size_t smem = tile_bytes<T, DC>(R + 4 * K);
    const dim3 grid(BH, (Sq + R - 1) / R);
    return launch(flash_fwd_kernel<T, DC, R, K>, grid, smem, s, static_cast<const T*>(q),
                  static_cast<const T*>(k), static_cast<const T*>(v), static_cast<T*>(out),
                  static_cast<float*>(lse), Sq, Sk, D, scale, causal);
  }
}

template <typename T, int DC>
int bwd_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
           const void* delta, void* dq, int BH, int Sq, int Sk, int D, float scale,
           int causal, cudaStream_t s) {
  if constexpr (DC == 0) {
    const size_t smem = 2 * stream_stage<T>(2 * kBR + 2 * kBS, kBS) * sizeof(T);
    const dim3 grid(BH, (Sq + kBR - 1) / kBR, chunks(D));
    return launch(flash_bwd_dq_streamed_kernel<T>, grid, smem, s, static_cast<const T*>(q),
                  static_cast<const T*>(k), static_cast<const T*>(v),
                  static_cast<const T*>(dout), static_cast<const float*>(lse),
                  static_cast<const float*>(delta), static_cast<T*>(dq), Sq, Sk, D, scale,
                  causal);
  } else {
    constexpr int R = DC <= 8 ? kBR : kBRW, S = DC <= 8 ? kBS : kBSW;
    // Q and dO, and two stages each of K and V
    const size_t smem = tile_bytes<T, DC>(2 * R + 4 * S);
    const dim3 grid(BH, (Sq + R - 1) / R);
    return launch(flash_bwd_dq_kernel<T, DC, R, S>, grid, smem, s, static_cast<const T*>(q),
                  static_cast<const T*>(k), static_cast<const T*>(v),
                  static_cast<const T*>(dout), static_cast<const float*>(lse),
                  static_cast<const float*>(delta), static_cast<T*>(dq), Sq, Sk, D, scale,
                  causal);
  }
}

template <typename T, int DC>
int bwd_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
            const void* delta, void* dk, void* dv, int BH, int Sq, int Sk, int D,
            float scale, int causal, cudaStream_t s) {
  if constexpr (DC == 0) {
    // two stages, and two buffers each of the LSE and delta
    const size_t smem = 2 * stream_stage<T>(2 * kBR + 2 * kBS, 2 * kBS) * sizeof(T) +
                        4 * kBS * sizeof(float);
    const dim3 grid(BH, (Sk + kBR - 1) / kBR, chunks(D));
    return launch(flash_bwd_dkv_streamed_kernel<T>, grid, smem, s, static_cast<const T*>(q),
                  static_cast<const T*>(k), static_cast<const T*>(v),
                  static_cast<const T*>(dout), static_cast<const float*>(lse),
                  static_cast<const float*>(delta), static_cast<T*>(dk),
                  static_cast<T*>(dv), Sq, Sk, D, scale, causal);
  } else {
    constexpr int R = DC <= 8 ? kBR : kBRW, S = DC <= 8 ? kBS : kBSW;
    // K and V, two stages each of Q and dO, and two of the LSE and delta
    const size_t smem = tile_bytes<T, DC>(2 * R + 4 * S) + 4 * S * sizeof(float);
    const dim3 grid(BH, (Sk + R - 1) / R);
    return launch(flash_bwd_dkv_kernel<T, DC, R, S>, grid, smem, s, static_cast<const T*>(q),
                  static_cast<const T*>(k), static_cast<const T*>(v),
                  static_cast<const T*>(dout), static_cast<const float*>(lse),
                  static_cast<const float*>(delta), static_cast<T*>(dk),
                  static_cast<T*>(dv), Sq, Sk, D, scale, causal);
  }
}

// the accumulator width (DC: 8-column fragments / 2; D padded to 16 DC),
// or 0: the D-streamed form
#define FLASH_DISPATCH(fn, T, D, ...)                                      \
  ((D) <= 32    ? fn<T, 2>(__VA_ARGS__)                                    \
   : (D) <= 64  ? fn<T, 4>(__VA_ARGS__)                                    \
   : (D) <= 128 ? fn<T, 8>(__VA_ARGS__)                                    \
   : (D) <= 256 ? fn<T, 16>(__VA_ARGS__)                                   \
                : fn<T, 0>(__VA_ARGS__))

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q (BH, Sq, D), k and v (BH, Sk, D),
// out like q, lse (BH, Sq) f32.  Returns cudaGetLastError() after the
// launch (or the error of raising the shared-memory limit).
extern "C" int flash_attn_fwd(int dtype, const void* q, const void* k, const void* v,
                              void* out, void* lse, int BH, int Sq, int Sk, int D,
                              float scale, int causal, void* stream) {
  if (bad_shape(BH, Sq, Sk, D, (Sq - 1) / rows_q4(D) + 1))
    return static_cast<int>(cudaErrorInvalidValue);
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
  if (bad_shape(BH, Sq, Sk, D, (Sq - 1) / rows_r(D) + 1))
    return static_cast<int>(cudaErrorInvalidValue);
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
  if (bad_shape(BH, Sq, Sk, D, (Sk - 1) / rows_r(D) + 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0
             ? FLASH_DISPATCH(bwd_dkv, float, D, q, k, v, dout, lse, delta, dk, dv, BH,
                              Sq, Sk, D, scale, causal, s)
             : FLASH_DISPATCH(bwd_dkv, __nv_bfloat16, D, q, k, v, dout, lse, delta, dk,
                              dv, BH, Sq, Sk, D, scale, causal, s);
}
