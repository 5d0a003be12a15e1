// R1: y = 2x + 1 over n float32 values.  A user kernel for the port's
// rtc runtime (rtc.CudaModule): NVRTC compiles this text at run time, nvcc
// never builds it.  Signature for get_kernel:
//   "const float *x, float *y, int n"
//
// Replaces the JAX package's rtc.py::_Kernel.launch running the
// `scale_kernel` of tests/test_subgraph_rtc.py (a Pallas kernel,
// o_ref[...] = x_ref[...] * 2.0 + 1.0).
//
// What bounds it on the H100: bytes, one read of x and one write of y
// (8 bytes an element) at 3.35 TB/s.  The design: float4 loads and stores
// in a grid-stride loop, SCALE_UNROLL float4 loads in flight a thread
// before its stores.  A scalar head of up to 3 elements brings y (and x,
// when the two share their alignment mod 16) to a 16-byte boundary, and a
// scalar tail covers what is left after the last float4.  When x and y
// differ in alignment mod 16 (a user may pass views), every element takes
// the scalar grid-stride loop.  Any grid works; rtc.launch_scale sizes it
// from the card's SM count, SCALE_BLOCKS_PER_SM blocks of SCALE_THREADS.
// The result is exact in float32: x * 2 is exact, so a fused multiply-add
// rounds once, as the plain x * 2 + 1 does.

#define SCALE_THREADS 256
#define SCALE_UNROLL 4
#define SCALE_BLOCKS_PER_SM 4

extern "C" __global__ void scale_kernel(const float* x, float* y, int n) {
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const unsigned long long xa = reinterpret_cast<unsigned long long>(x);
  const unsigned long long ya = reinterpret_cast<unsigned long long>(y);
  if ((xa - ya) % 16) {
    for (long long i = tid; i < n; i += stride) y[i] = x[i] * 2.0f + 1.0f;
    return;
  }
  long long head = (16 - ya % 16) % 16 / 4;
  if (head > n) head = n;
  const long long nvec = (n - head) / 4;
  const long long tail = head + nvec * 4;
  for (long long i = tid; i < head; i += stride) y[i] = x[i] * 2.0f + 1.0f;
  for (long long i = tail + tid; i < n; i += stride) y[i] = x[i] * 2.0f + 1.0f;
  const float4* xv = reinterpret_cast<const float4*>(x + head);
  float4* yv = reinterpret_cast<float4*>(y + head);
  for (long long v0 = tid; v0 < nvec; v0 += SCALE_UNROLL * stride) {
    float4 r[SCALE_UNROLL];
#pragma unroll
    for (int u = 0; u < SCALE_UNROLL; ++u) {
      const long long v = v0 + u * stride;
      if (v < nvec) r[u] = __ldg(xv + v);
    }
#pragma unroll
    for (int u = 0; u < SCALE_UNROLL; ++u) {
      const long long v = v0 + u * stride;
      if (v < nvec) {
        r[u].x = r[u].x * 2.0f + 1.0f;
        r[u].y = r[u].y * 2.0f + 1.0f;
        r[u].z = r[u].z * 2.0f + 1.0f;
        r[u].w = r[u].w * 2.0f + 1.0f;
        yv[v] = r[u];
      }
    }
  }
}
