// Kernel B2: fused diversity-PSF measure for a general stack of n_div
// diversity maps.
//
// Replaces the TPU kernel mpc_sensorlessao_tpu/ops/pallas_kernels.py
// `_psf_div_kernel` (wrapper `psf_crop_diversity`).  For every scenario b
// and diversity d it computes
//
//   out[b, d] = |A F_bd A^T|^2 * scale,
//   F_bd = pupil (c cd_d - s sd_d, s cd_d + c sd_d),
//
// c, s = cos, sin of the residual phase (taken once per pixel and block)
// and cd_d, sd_d the precomputed cos/sin of the diversity map d -- the
// angle-addition identity of the TPU kernel, so the (B, n_div, R, R)
// summed phase is never formed.
//
// Bound: as B1, FP32 issue and shared-memory loads -- 4 w R^2 + 4 w^2 R
// FMAs per (scenario, diversity) against R^2 floats of phase read per
// scenario; the maps are shared by all scenarios and stay in L2.
//
// Design: the tiling of B1 (psf_tiles.cuh).  The TPU kernel unrolls all
// n_div diversities in one program; here each diversity holds 16
// accumulator floats a thread, so a whole 5-map stack in one block would
// spill.  The diversities go in groups of at most 3 instead: grid
// (B, n_div / 3) of 3-field blocks, plus one launch of 1- or 2-field
// blocks for the rest; each block takes the phase's sincosf itself.
// Everything is float32 with sincosf (not __sincosf) and no fast math:
// the diversity alone reaches +-3 rad.
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

constexpr int kGroup = 3;            // diversities per block

// Block (b, group): diversities d0 + G * blockIdx.y + [0, G).
template <int G>
__global__ void __launch_bounds__(kThreads)
psf_div_kernel(const float* __restrict__ phase,  // (B, R, R)
               const float* __restrict__ pupil,  // (R, R)
               const float* __restrict__ cosd,   // (n_div, R, R)
               const float* __restrict__ sind,   // (n_div, R, R)
               const float* __restrict__ are,    // (w, R)
               const float* __restrict__ aim,    // (w, R)
               float* __restrict__ out,          // (B, n_div, w, w)
               int R, int w, int n_div, int d0, float scale) {
  const size_t plane = static_cast<size_t>(R) * R;
  const int d = d0 + G * blockIdx.y;
  const float* ph = phase + blockIdx.x * plane;
  const float* cd = cosd + d * plane;
  const float* sd = sind + d * plane;
  auto fields = [=](size_t idx, float2* f) {
    float s, c;
    sincosf(ph[idx], &s, &c);
    const float p = pupil[idx];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float cg = cd[g * plane + idx], sg = sd[g * plane + idx];
      f[g] = make_float2(p * (c * cg - s * sg), p * (s * cg + c * sg));
    }
  };
  float* o = out + (static_cast<size_t>(blockIdx.x) * n_div + d) * w * w;
  psf_tiles::crop_intensity<G>(fields, are, aim, o, R, w, scale);
}

template <int G>
void launch(dim3 grid, cudaStream_t stream, const float* phase,
            const float* pupil, const float* cosd, const float* sind,
            const float* are, const float* aim, float* out, int R, int w,
            int n_div, int d0, float scale) {
  psf_div_kernel<G><<<grid, dim3(kTile, kWarps), 0, stream>>>(
      phase, pupil, cosd, sind, are, aim, out, R, w, n_div, d0, scale);
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` (a cudaStream_t) of CUDA device
// `device`.  Returns cudaGetLastError(): 0 when the launches were
// accepted.
int psf_div(const float* phase, const float* pupil, const float* cosd,
            const float* sind, const float* are, const float* aim,
            float* out, int batch, int n_div, int R, int w, float scale,
            int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch <= 0 || n_div <= 0) return 0;
  if (R <= 0 || w <= 0 || w > kCrop) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int full = n_div / kGroup;
  const int rest = n_div % kGroup;
  const int d0 = full * kGroup;
  if (full > 0) {
    launch<kGroup>(dim3(batch, full), s, phase, pupil, cosd, sind, are, aim,
                   out, R, w, n_div, 0, scale);
  }
  if (rest == 1) {
    launch<1>(dim3(batch, 1), s, phase, pupil, cosd, sind, are, aim, out, R,
              w, n_div, d0, scale);
  } else if (rest == 2) {
    launch<2>(dim3(batch, 1), s, phase, pupil, cosd, sind, are, aim, out, R,
              w, n_div, d0, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* psf_div_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
