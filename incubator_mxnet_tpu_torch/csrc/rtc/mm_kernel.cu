// R2: C = A B for row-major float32 A (M, K), B (K, N), C (M, N).  A user
// kernel for the port's rtc runtime (rtc.CudaModule): NVRTC compiles this
// text at run time, nvcc never builds it.  Signature for get_kernel:
//   "const float *a, const float *b, float *c, int M, int N, int K"
// Launch: block (256, 1, 1), grid (ceil(N / 64), ceil(M / 64), 1)
// (rtc.launch_mm).
//
// Replaces the JAX package's rtc.py::_Kernel.launch running the
// `mm_kernel` of tests/test_subgraph_rtc.py (a Pallas kernel,
// o_ref[...] = jnp.dot(a_ref[...], b_ref[...]) in float32).
//
// What bounds it on the H100: operations.  At the LM's output projection,
// (8192, 1024) @ (1024, 1024), it does 17.2 GFLOP of float32 products
// against 46 MB of traffic; float32 runs on the CUDA cores at 67 TFLOP/s
// (the tensor cores take TF32 at best, which would change the result).
//
// The design, simple first: one block computes a 64 x 64 tile of C, each
// of its 256 threads a 4 x 4 grid of outputs strided 16 apart (so the
// threads of a warp read neighbouring shared-memory words).  A walks
// K in slices of 16: the block stages a 64 x 16 slice of A (transposed)
// and a 16 x 64 slice of B in shared memory, then every thread does 16
// rank-1 updates of its 4 x 4 sums from registers.  Ragged edges load as
// 0 and are not stored.  Each product sums in K order, as a plain loop
// would; cuBLAS sums in another order, so results agree to float32
// rounding, not bit for bit.

#define MM_TILE 64
#define MM_KSTEP 16

extern "C" __global__ void __launch_bounds__(256)
mm_kernel(const float* a, const float* b, float* c, int M, int N, int K) {
  __shared__ float sa[MM_KSTEP][MM_TILE + 1];
  __shared__ float sb[MM_KSTEP][MM_TILE];
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int row0 = blockIdx.y * MM_TILE;
  const int col0 = blockIdx.x * MM_TILE;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += MM_KSTEP) {
    // A slice: 64 rows x 16 k; consecutive threads read consecutive k
    for (int i = threadIdx.x; i < MM_TILE * MM_KSTEP; i += blockDim.x) {
      const int r = i / MM_KSTEP;
      const int kk = i % MM_KSTEP;
      const int gr = row0 + r;
      const int gk = k0 + kk;
      sa[kk][r] = (gr < M && gk < K) ? a[static_cast<long long>(gr) * K + gk] : 0.f;
    }
    // B slice: 16 k x 64 columns; consecutive threads read consecutive columns
    for (int i = threadIdx.x; i < MM_KSTEP * MM_TILE; i += blockDim.x) {
      const int kk = i / MM_TILE;
      const int cc = i % MM_TILE;
      const int gk = k0 + kk;
      const int gc = col0 + cc;
      sb[kk][cc] = (gk < K && gc < N) ? b[static_cast<long long>(gk) * N + gc] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < MM_KSTEP; ++kk) {
      float ar[4], br[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ar[i] = sa[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) br[j] = sb[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gr = row0 + ty + 16 * i;
    if (gr >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gc = col0 + tx + 16 * j;
      if (gc < N) c[static_cast<long long>(gr) * N + gc] = acc[i][j];
    }
  }
}
