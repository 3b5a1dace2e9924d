// Kernel B5a: chained sincos, the transcendental ceiling of the
// measurement kernels' own pattern.
//
// Replaces the TPU kernel benchmarks/device_peaks.py
// `transc_sincos_pallas` (inner `kern`).  k links of
//
//   v = cos(v) + 0.5 sin(v)
//
// on every element of a (rows, cols) float32 array; two transcendentals
// per link.  Kernels B1-B4 take cos and sin of one argument with the
// full-precision sincosf (the diversity reaches +-3 rad), so the link is
// one sincosf -- one range reduction for both -- and one FMA, which
// rounds exactly as cos(v) + 0.5 sin(v) does (0.5 sin(v) is exact).
// Bound and design: transc_chain.cuh.
//
// Built with  nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// (ops/cuda_build.py) and called through ctypes
// (benchmarks/device_peaks.py).

#include <cuda_runtime.h>

#include "transc_chain.cuh"

namespace {

struct SincosLink {
  __device__ float operator()(float v) const {
    float s, c;
    sincosf(v, &s, &c);
    return fmaf(0.5f, s, c);
  }
};

}  // namespace

extern "C" {

// k links on n contiguous floats, x -> out, on `stream` (a cudaStream_t)
// of CUDA device `device`.  Returns cudaGetLastError(): 0 when the launch
// was accepted.
int transc_sincos(const float* x, float* out, long long n, int k,
                  int device, void* stream) {
  return transc_chain::launch<SincosLink>(x, out, n, k, device, stream);
}

const char* transc_sincos_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
