// R2: C = A B for row-major float32 A (M, K), B (K, N), C (M, N).  A user
// kernel for the port's rtc runtime (rtc.CudaModule): NVRTC compiles this
// text at run time, nvcc never builds it, so it includes no header.
// Signature for get_kernel:
//   "const float *a, const float *b, float *c, int M, int N, int K"
// Launch (rtc.launch_mm): block (MM_THREADS, 1, 1), grid
// (ceil(N / MM_TILE), ceil(M / MM_TILE), 1), MM_SMEM_BYTES of dynamic
// shared memory (56 KB: above the 48 KB default, so the launch raises the
// kernel's limit first).
//
// Replaces the JAX package's rtc.py::_Kernel.launch running the
// `mm_kernel` of tests/test_subgraph_rtc.py (a Pallas kernel,
// o_ref[...] = jnp.dot(a_ref[...], b_ref[...]) in float32).
//
// What bounds it on the H100: operations.  At the LM's output projection,
// (8192, 1024) @ (1024, 1024), it does 17.2 GFLOP against 46 MB of
// traffic.  It runs on the tensor cores in TF32 with the 3xTF32 split,
// which keeps float32 accuracy: each operand x is cut into
// hi = tf32(x) and lo = tf32(x - hi), and a product takes three TF32
// passes, lo*hi + hi*lo first, then hi*hi (lo*lo, 2^-22 of the product,
// is dropped).  Its bound is 3 x 17.2 GFLOP at 495 TFLOP/s dense TF32:
// 0.104 ms, against 0.256 ms for float32 FMAs at 67 TFLOP/s.
//
// Design.  One block of 8 warps computes a 128 x 128 tile of C; warp w
// owns the 64 x 32 sub-tile at rows 64 (w / 4), columns 32 (w % 4), as
// 4 x 4 fragments of mma.sync.m16n8k8 (64 f32 sums a thread).  K is
// walked in slices of 16 through a 3-stage ring of shared memory filled
// by cp.async: slice k + 2 loads while slice k is multiplied, with one
// barrier a slice.  A's slice is stored 128 x 16 with a row pitch of 20
// floats and B's 16 x 128 with a pitch of 136, so the fragment reads of a
// warp (row lane / 4, column lane % 4) fall on 32 distinct banks.  Rows
// whose pitch is a multiple of 4 floats (K and N both multiples of 4, and
// 16-byte aligned arrays) load 16 bytes a copy; otherwise the same kernel
// loads 4 bytes a copy.  Either way the ragged edge is zero-filled by the
// copy's source size, and outputs past M or N are not stored.  Sums run
// in another order than cuBLAS's, so results agree to float32 rounding,
// not bit for bit.  Its time beside torch.matmul's (TF32 off) is row 9b
// of PERF.md's kernel table (chip_smoke.py phase 4c).

#define MM_TILE 128
#define MM_THREADS 256
#define MM_KSTEP 16
#define MM_STAGES 3
#define MM_PITCH_A (MM_KSTEP + 4)
#define MM_PITCH_B (MM_TILE + 8)
#define MM_STAGE_FLOATS (MM_TILE * MM_PITCH_A + MM_KSTEP * MM_PITCH_B)
#define MM_SMEM_BYTES (MM_STAGES * MM_STAGE_FLOATS * 4)

// --- PTX wrappers ---------------------------------------------------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  unsigned r;
  asm("{ .reg .u64 t; cvta.to.shared.u64 t, %1; cvt.u32.u64 %0, t; }"
      : "=r"(r) : "l"(p));
  return r;
}

// copy `bytes` (0 or the full size) from global to shared; the rest of
// the destination is zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
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

// d += a b for one m16n8k8 TF32 fragment (f32 accumulate)
__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// --- end of PTX wrappers --------------------------------------------------

__device__ __forceinline__ void split(float x, unsigned& hi, unsigned& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// slice k0 of A (MM_TILE x MM_KSTEP) and B (MM_KSTEP x MM_TILE) into stage `sm`
__device__ __forceinline__ void load_slice(float* sm, const float* a, const float* b,
                                           int M, int N, int K, int row0, int col0,
                                           int k0, bool vec) {
  float* sa = sm;
  float* sb = sm + MM_TILE * MM_PITCH_A;
#pragma unroll
  for (int i = 0; i < MM_TILE * MM_KSTEP / 4 / MM_THREADS; ++i) {
    const int v = threadIdx.x + i * MM_THREADS;
    // A: MM_KSTEP / 4 chunks of 4 floats a row
    const int r = v / (MM_KSTEP / 4), c = v % (MM_KSTEP / 4) * 4;
    const int gr = row0 + r, gk = k0 + c;
    float* da = sa + r * MM_PITCH_A + c;
    const float* srca = a + (long long)gr * K + gk;
    // B: MM_TILE / 4 chunks a row
    const int kr = v / (MM_TILE / 4), cc = v % (MM_TILE / 4) * 4;
    const int gkb = k0 + kr, gc = col0 + cc;
    float* db = sb + kr * MM_PITCH_B + cc;
    const float* srcb = b + (long long)gkb * N + gc;
    if (vec) {
      const bool oka = gr < M && gk < K, okb = gkb < K && gc < N;
      cp_async16(da, oka ? srca : a, oka ? 16 : 0);
      cp_async16(db, okb ? srcb : b, okb ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool oka = gr < M && gk + e < K, okb = gkb < K && gc + e < N;
        cp_async4(da + e, oka ? srca + e : a, oka ? 4 : 0);
        cp_async4(db + e, okb ? srcb + e : b, okb ? 4 : 0);
      }
    }
  }
}

extern "C" __global__ void __launch_bounds__(256)
mm_kernel(const float *a, const float *b, float *c, int M, int N, int K) {
  extern __shared__ float4 mm_smem4[];
  float* smem = reinterpret_cast<float*>(mm_smem4);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  const int row0 = blockIdx.y * MM_TILE, col0 = blockIdx.x * MM_TILE;
  const bool vec = (K % 4 == 0) && (N % 4 == 0) &&
                   (((unsigned long long)a | (unsigned long long)b) & 15) == 0;
  const int nk = (K + MM_KSTEP - 1) / MM_KSTEP;

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < MM_STAGES - 1; ++s) {
    if (s < nk)
      load_slice(smem + s * MM_STAGE_FLOATS, a, b, M, N, K, row0, col0,
                 s * MM_KSTEP, vec);
    cp_async_commit();
  }

  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<MM_STAGES - 2>();
    __syncthreads();  // slice kt is in; every warp is done with slice kt - 1
    const int nxt = kt + MM_STAGES - 1;
    if (nxt < nk)
      load_slice(smem + (nxt % MM_STAGES) * MM_STAGE_FLOATS, a, b, M, N, K, row0,
                 col0, nxt * MM_KSTEP, vec);
    cp_async_commit();

    const float* sa = smem + (kt % MM_STAGES) * MM_STAGE_FLOATS;
    const float* sb = sa + MM_TILE * MM_PITCH_A;
#pragma unroll
    for (int kk = 0; kk < MM_KSTEP; kk += 8) {
      unsigned bh[4][2], bl[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = wn + j * 8 + g;
        split(sb[(kk + t) * MM_PITCH_B + n], bh[j][0], bl[j][0]);
        split(sb[(kk + t + 4) * MM_PITCH_B + n], bh[j][1], bl[j][1]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float* ar = sa + (wm + i * 16 + g) * MM_PITCH_A + kk + t;
        unsigned ah[4], al[4];
        split(ar[0], ah[0], al[0]);
        split(ar[8 * MM_PITCH_A], ah[1], al[1]);
        split(ar[4], ah[2], al[2]);
        split(ar[8 * MM_PITCH_A + 4], ah[3], al[3]);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          mma_tf32(acc[i][j], al, bh[j]);
          mma_tf32(acc[i][j], ah, bl[j]);
          mma_tf32(acc[i][j], ah, bh[j]);
        }
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + wm + i * 16 + g + 8 * h;
      if (r >= M) continue;
      float* cr = c + (long long)r * N;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = col0 + wn + j * 8 + 2 * t;
        if (col < N) cr[col] = acc[i][j][2 * h];
        if (col + 1 < N) cr[col + 1] = acc[i][j][2 * h + 1];
      }
    }
  }
}
