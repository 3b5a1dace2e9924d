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
// Design: the tensor-core DFT engine psf_mma.cuh, one block per
// three consecutive items, grid ceil(N / 3).  Its field-forming policy
// loads the three items' phases and the pupil a K tile -- four maps, B4's
// shared-memory footprint -- and takes a full-precision sincosf per item
// and pixel (no angle addition: the +-3 rad diversity is already inside
// each total phase).  In the last block, items at or beyond N read as
// zero fields and store nothing.
//
// psf_crop_bf16 is the TPU kernel's compute_dtype="bfloat16" branch
// (pallas_kernels.py:34-51) on the Hopper engine psf_wgmma.cuh, as its
// crop policy (CropBf16 below): wgmma on the stacked (2w, R) operator
// (the TPU kernel's rr = are fr - aim fi is S1[are][fr] - S1[aim][fi]),
// the fields pupil (cos, sin) formed in float32 and stored once in bf16,
// the stage-1 rows rounded in registers, persistent blocks with a
// producer warp keeping the phase tiles in flight under the forming.
//
// Built with  nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// (ops/cuda_build.py) and called through ctypes (ops/psf_kernels.py).

#include <cuda_runtime.h>

#include "psf_mma.cuh"
#include "psf_wgmma.cuh"

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

// psf_wgmma.cuh's crop policy.  Pair q is triples 2 q and 2 q + 1 of
// the N items (the last triple repeated where their count is odd); a
// stage holds the pupil and the two triples' phases.  T holds pupil (cos,
// sin) of each item's phase, three sincosf a pixel, formed in float32 and
// rounded once.  An item at or past N reads the last one's plane and
// stores nothing.
struct CropBf16 {
  static constexpr int kInputs = 2;    // pupil (R, R); phase (N, R, R)
  static constexpr int kShared = 1, kOwn = kFields, kIlp = 4;
  static constexpr bool kRecombine = false;
  float* out;                          // (N, w, w)
  int n;

  __host__ __device__ static constexpr int input(int m) {
    return m < kShared ? 0 : 1;
  }
  __host__ __device__ int triples() const { return (n + kOwn - 1) / kOwn; }
  __host__ __device__ int pairs() const { return (triples() + 1) / 2; }
  __device__ int plane(int m, int q) const {
    if (m < kShared) return 0;
    const int t = min(2 * q + (m - kShared) / kOwn, triples() - 1);
    return min(kOwn * t + (m - kShared) % kOwn, n - 1);
  }
  __device__ float* crop(int q, int wg, int d, int w) const {
    const int i = kOwn * (2 * q + wg) + d;
    return i < n ? out + static_cast<size_t>(i) * w * w : nullptr;
  }
  // one field at a time (not unrolled): kIlp sincosf chains in flight
  // and two parts' registers, not three times as many beside O and S
  __device__ static void form(const float* st, const float* ph,
                              unsigned char* tb, int y, int xg) {
    using psf_wgmma::kMapTile;
#pragma unroll 1
    for (int j = 0; j < kOwn; ++j) {
      psf_wgmma::form_field<kIlp>(
          tb, 2 * j, y, xg, [&](int e, float& re, float& im) {
            float s, c;
            sincosf(ph[j * kMapTile + e], &s, &c);
            re = st[e] * c;
            im = st[e] * s;
          });
    }
  }
};

// Dynamic shared memory a block of the float32 kernel takes.
constexpr size_t kSmemBytes =
    psf_mma::smem_bytes(PhaseFields::kMaps, Precision::kTf32x3);

__global__ void __launch_bounds__(psf_mma::kThreads, 2)
psf_crop_kernel(PhaseFields fields, psf_mma::Band band, int R, int w,
                float scale, int vec16) {
  psf_mma::crop_block<Precision::kTf32x3>(fields, band, R, w, scale, vec16);
}

__global__ void __launch_bounds__(psf_wgmma::kThreads, 1)
psf_crop_bf16_kernel(
    const __grid_constant__ psf_wgmma::Inputs<CropBf16> in,
    const CropBf16 pol, const psf_wgmma::Args a) {
  psf_wgmma::block(in, pol, a);
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
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch <= 0) return 0;
  using psf_mma::aligned16;
  const int vec16 = R % 4 == 0 && aligned16(phase) && aligned16(pupil);
  return static_cast<int>(psf_mma::launch(
      psf_crop_kernel, dim3((batch + kFields - 1) / kFields), kSmemBytes,
      PhaseFields{phase, pupil, out, batch}, are, aim, work, R, w, scale,
      vec16, static_cast<cudaStream_t>(stream)));
}

// As psf_crop, with the DFT stages' operands in bf16: the
// compute_dtype="bfloat16" branch of the TPU kernel, on psf_wgmma.cuh.
// `work` takes the operator's bf16 image, ceil(w / 32) * 64 * 64 *
// ceil(R / 64) * 2 bytes (within psf_crop's scratch).
int psf_crop_bf16(const float* phase, const float* pupil, const float* are,
                  const float* aim, float* work, float* out, int batch,
                  int R, int w, float scale, int device, void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch <= 0) return 0;
  return static_cast<int>(psf_wgmma::launch(
      psf_crop_bf16_kernel, CropBf16{out, batch}, {pupil, phase},
      {1, batch}, are, aim, work, R, w, scale,
      static_cast<cudaStream_t>(stream)));
}

// Dynamic shared memory a block of either kernel takes, in bytes: for
// the bf16 kernel at the main path's R=128 and a crop of one band (it
// grows with R and the crop's bands).
int psf_crop_smem_bytes() { return static_cast<int>(kSmemBytes); }
int psf_crop_bf16_smem_bytes() {
  return static_cast<int>(
      psf_wgmma::smem_bytes<CropBf16>(128, 1, psf_wgmma::kMaxStages));
}

const char* psf_crop_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
const char* psf_crop_bf16_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
