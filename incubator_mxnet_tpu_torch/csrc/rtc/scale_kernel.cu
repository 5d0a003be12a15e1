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
// (8 bytes an element) at 3.35 TB/s.  One thread an element, neighbouring
// threads on neighbouring addresses; a grid-stride loop covers any n.
// The result is exact in float32: x * 2 is exact, so a fused multiply-add
// rounds once, as the plain x * 2 + 1 does.

extern "C" __global__ void scale_kernel(const float* x, float* y, int n) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    y[i] = x[i] * 2.0f + 1.0f;
  }
}
