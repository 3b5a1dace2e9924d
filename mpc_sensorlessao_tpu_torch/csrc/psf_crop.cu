// Kernel B3: PSF crop of one field per item (the unfused measure).
//
// Replaces the TPU kernel mpc_sensorlessao_tpu/ops/pallas_kernels.py
// `_psf_kernel` (wrapper `psf_crop_intensity`).  For every item n of a
// batch of total phases (scenario x diversity, already summed) it computes
//
//   out[n] = |A F_n A^T|^2 * scale,     F_n = pupil e^{i phase_n}.
//
// Bound: FP32 issue and shared-memory loads, as B1 -- 4 w R^2 + 4 w^2 R
// FMAs per item against R^2 floats of phase read.  Against the fused
// kernels it reads the materialised total phase (n_div times the bytes)
// and takes n_div times the sincosf, and with one field per block each
// operator value loaded from shared memory feeds 4 FMAs instead of 12.
//
// Design: the tiling of B1 (psf_tiles.cuh) with one field per block,
// grid (N); 16 accumulator floats a thread.  float32 throughout, sincosf
// (not __sincosf), no fast math.
//
// Built with  nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// (ops/cuda_build.py) and called through ctypes (ops/psf_kernels.py).

#include <cuda_runtime.h>

#include "psf_tiles.cuh"

namespace {

using psf_tiles::kCrop;
using psf_tiles::kThreads;
using psf_tiles::kTile;
using psf_tiles::kWarps;

__global__ void __launch_bounds__(kThreads)
psf_crop_kernel(const float* __restrict__ phase,  // (N, R, R)
                const float* __restrict__ pupil,  // (R, R)
                const float* __restrict__ are,    // (w, R)
                const float* __restrict__ aim,    // (w, R)
                float* __restrict__ out,          // (N, w, w)
                int R, int w, float scale) {
  const float* ph = phase + static_cast<size_t>(blockIdx.x) * R * R;
  auto fields = [=](size_t idx, float2* f) {
    float s, c;
    sincosf(ph[idx], &s, &c);
    const float p = pupil[idx];
    f[0] = make_float2(p * c, p * s);
  };
  psf_tiles::crop_intensity<1>(fields, are, aim,
                               out + static_cast<size_t>(blockIdx.x) * w * w,
                               R, w, scale);
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` (a cudaStream_t) of CUDA device
// `device`.  Returns cudaGetLastError(): 0 when the launch was accepted.
int psf_crop(const float* phase, const float* pupil, const float* are,
             const float* aim, float* out, int batch, int R, int w,
             float scale, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch <= 0) return 0;
  if (R <= 0 || w <= 0 || w > kCrop) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  psf_crop_kernel<<<batch, dim3(kTile, kWarps), 0,
                    static_cast<cudaStream_t>(stream)>>>(
      phase, pupil, are, aim, out, R, w, scale);
  return static_cast<int>(cudaGetLastError());
}

const char* psf_crop_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
