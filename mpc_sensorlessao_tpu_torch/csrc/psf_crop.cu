// Kernel B3: PSF crop of one field per item (the unfused measure), with
// both DFT stages on the tensor cores at float32 accuracy (3xTF32).
//
// Replaces the TPU kernel mpc_sensorlessao_tpu/ops/pallas_kernels.py
// `_psf_kernel` (wrapper `psf_crop_intensity`).  For every item n of a
// batch of total phases (scenario x diversity, already summed) it computes
//
//   out[n] = |A F_n A^T|^2 * scale,     F_n = pupil e^{i phase_n}.
//
// What bounds it: the DFT stages, as in B1 -- B3's items are B1's fields,
// so at N = 3 B its tensor-core work is B1's (3 passes of 62.0 GFLOP at
// R=128, N=12,288).  Against B1 it also reads the materialised total
// phases (3x the phase bytes: 805 MB at that shape) and takes 3x the
// sincosf (201 M), both overlapped with the products through cp.async.
//
// Design: the tensor-core DFT engine of B1 (psf_mma.cuh), one block per
// three consecutive items, grid ceil(N / 3).  Its field-forming policy
// loads the three items' phases and the pupil a K tile -- four maps, B1's
// shared-memory footprint -- and takes a full-precision sincosf per item
// and pixel (no angle addition: the +-3 rad diversity is already inside
// each total phase).  In the last block, items at or beyond N read as
// zero fields and store nothing.
//
// psf_crop_bf16 is the TPU kernel's compute_dtype="bfloat16" branch on the
// same engine and policy (Precision::kBf16: one bf16 pass, f32 sums): the
// fields pupil (cos, sin), the operator and the stage-1 rows are each
// rounded to bf16 as the stages load them (pallas_kernels.py:34-51).
//
// Built with  nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// (ops/cuda_build.py) and called through ctypes (ops/psf_kernels.py).

#include <cuda_runtime.h>

#include "psf_mma.cuh"

namespace {

using psf_mma::kFields;
using psf_mma::kTilePixels;
using psf_mma::Precision;

// Block k: items 3 k, 3 k + 1, 3 k + 2 of the N.
struct PhaseFields {
  static constexpr int kMaps = kFields + 1;   // the items' phases, pupil
  static constexpr bool kRecombine = false;
  const float* phase;                         // (N, R, R)
  const float* pupil;                         // (R, R)
  float* out_;                                // (N, w, w)
  int n;

  __device__ int first() const { return kFields * blockIdx.x; }
  __device__ const float* map(int a, int R) const {
    // an absent item reads (as zeros) from the last one's plane
    return a == kFields ? pupil
                        : phase + static_cast<size_t>(min(first() + a, n - 1)) *
                                      R * R;
  }
  __device__ bool present(int a) const {
    return a == kFields || first() + a < n;
  }
  __device__ int fields() const { return min(kFields, n - first()); }
  __device__ float* out(int w) const {
    return out_ + static_cast<size_t>(first()) * w * w;
  }
  __device__ void form(const float* m, float2 (&f)[kFields]) const {
    const float p = m[kFields * kTilePixels];
    const int live = fields();
#pragma unroll
    for (int j = 0; j < kFields; ++j) {
      f[j] = make_float2(0.f, 0.f);
      if (j < live) {
        float s, c;
        sincosf(m[j * kTilePixels], &s, &c);
        f[j] = make_float2(p * c, p * s);
      }
    }
  }
};

// Dynamic shared memory a block of the kernel of precision P takes.
constexpr size_t smem_bytes(Precision p) {
  return psf_mma::smem_bytes(PhaseFields::kMaps, p);
}

__global__ void __launch_bounds__(psf_mma::kThreads, 2)
psf_crop_kernel(PhaseFields fields, psf_mma::Band band, int R, int w,
                float scale, int vec16) {
  psf_mma::crop_block<Precision::kTf32x3>(fields, band, R, w, scale, vec16);
}

__global__ void __launch_bounds__(psf_mma::kThreads, 2)
psf_crop_bf16_kernel(PhaseFields fields, psf_mma::Band band, int R, int w,
                     float scale, int vec16) {
  psf_mma::crop_block<Precision::kBf16>(fields, band, R, w, scale, vec16);
}

// Lays the operator out in `work` and launches `kernel` (of precision P,
// psf_mma::launch) on `stream` of CUDA device `device`; the first error.
template <Precision P>
int launch(void (*kernel)(PhaseFields, psf_mma::Band, int, int, float,
                          int),
           const float* phase, const float* pupil, const float* are,
           const float* aim, float* work, float* out, int batch, int R,
           int w, float scale, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch <= 0) return 0;
  using psf_mma::aligned16;
  const int vec16 = R % 4 == 0 && aligned16(phase) && aligned16(pupil);
  return static_cast<int>(psf_mma::launch(
      kernel, dim3((batch + kFields - 1) / kFields), smem_bytes(P),
      PhaseFields{phase, pupil, out, batch}, are, aim, work, R, w, scale,
      vec16, static_cast<cudaStream_t>(stream)));
}

}  // namespace

extern "C" {

// Lays the operator out in `work` -- ceil(w / 32) * ceil(R / 32) * 32 *
// 32 * 2 floats, 16-byte aligned, allocated by the caller -- and launches
// the kernel (once per band pair of a crop wider than 32 px), all on
// `stream` (a cudaStream_t) of CUDA device `device`.  Returns the first
// error: 0 when every launch was accepted.
int psf_crop(const float* phase, const float* pupil, const float* are,
             const float* aim, float* work, float* out, int batch, int R,
             int w, float scale, int device, void* stream) {
  return launch<Precision::kTf32x3>(psf_crop_kernel, phase, pupil, are, aim,
                                    work, out, batch, R, w, scale, device,
                                    stream);
}

// As psf_crop, with the DFT stages' operands in bf16: the
// compute_dtype="bfloat16" branch of the TPU kernel.
int psf_crop_bf16(const float* phase, const float* pupil, const float* are,
                  const float* aim, float* work, float* out, int batch,
                  int R, int w, float scale, int device, void* stream) {
  return launch<Precision::kBf16>(psf_crop_bf16_kernel, phase, pupil, are,
                                  aim, work, out, batch, R, w, scale, device,
                                  stream);
}

// Dynamic shared memory a block of either kernel takes, in bytes.
int psf_crop_smem_bytes() {
  return static_cast<int>(smem_bytes(Precision::kTf32x3));
}
int psf_crop_bf16_smem_bytes() {
  return static_cast<int>(smem_bytes(Precision::kBf16));
}

const char* psf_crop_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
const char* psf_crop_bf16_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
