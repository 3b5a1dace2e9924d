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
// sincosf (201 M), the copies overlapped with the products by the
// engine's producer warp.
//
// Design: the Hopper engine psf_wgmma.cuh in 3xTF32 (block_tf32) with
// the crop policy below (Crop<true>), two triples of consecutive items a
// block pass, one a consumer warpgroup.  A stage holds the pupil (shared)
// and each consumer's three phases, 7 maps: 30,720 B a stage with its
// operator tile, so 3 stages fit beside the T buffers (207,872 B).  The
// consumers form pupil (cos, sin) of one item's phase at a time, two
// items' loops interleaved (form_field_tf32: a full-precision sincosf an
// item and pixel, no angle addition, since the +-3 rad diversity is
// already inside each total phase), split each part into TF32 hi and lo,
// and run each k8 step as
// three wgmma (hi*hi into one accumulator, lo*hi and hi*lo into another,
// added at the strip's end); no recombination.  Items at or past N read
// a present plane and store nothing.  It replaced the mma.sync engine
// psf_mma.cuh (one 256-thread block per triple, two __syncthreads a
// step; retired with kernel B4's move to this engine).
//
// psf_crop_bf16 is the TPU kernel's compute_dtype="bfloat16" branch
// (pallas_kernels.py:34-51) on the same engine, as Crop<false> (block:
// one bf16 pass, the operator held whole in shared memory; the TPU
// kernel's rr = are fr - aim fi is S1[are][fr] - S1[aim][fi]): the fields
// pupil (cos, sin) formed in float32 and stored once in bf16, the
// stage-1 rows rounded in registers.
//
// Built with  nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// (ops/cuda_build.py) and called through ctypes (ops/psf_kernels.py).

#include <cuda_runtime.h>

#include "psf_wgmma.cuh"

namespace {

using psf_wgmma::kFields;

// psf_wgmma.cuh's crop policy.  Pair q is triples 2 q and 2 q + 1 of
// the N items (the last triple repeated where their count is odd); a
// stage holds the pupil and the two triples' phases.  T holds pupil (cos,
// sin) of each item's phase, three sincosf a pixel, formed in float32 and
// rounded to bf16 once (kTf32 false) or split into TF32 hi and lo (kTf32).
// An item at or past N reads the last one's plane and stores nothing.
template <bool kTf32>
struct Crop {
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
  // a field at a time, unrolled by two (two fields' sincosf chains and
  // stores interleaved, then the third's): each field's parts in
  // registers, not all three fields' beside O and S (and C)
  __device__ static void form(const float* st, const float* ph,
                              unsigned char* tb, int y, int xg) {
    constexpr int kMapTile =
        kTf32 ? psf_wgmma::tf32::kMapTile : psf_wgmma::kMapTile;
#pragma unroll 2
    for (int j = 0; j < kOwn; ++j) {
      auto part = [&](int e, float& re, float& im) {
        float s, c;
        sincosf(ph[j * kMapTile + e], &s, &c);
        re = st[e] * c;
        im = st[e] * s;
      };
      if constexpr (kTf32) {
        psf_wgmma::form_field_tf32(
            tb, 2 * j, y, xg,
            [&](int, int e, float& re, float& im) { part(e, re, im); });
      } else {
        psf_wgmma::form_field<kIlp>(tb, 2 * j, y, xg, part);
      }
    }
  }
};
using CropTf32 = Crop<true>;
using CropBf16 = Crop<false>;

__global__ void __launch_bounds__(psf_wgmma::kThreads, 1)
psf_crop_kernel(const __grid_constant__ psf_wgmma::Inputs<CropTf32> in,
                const CropTf32 pol, const psf_wgmma::Args a) {
  psf_wgmma::block_tf32(in, pol, a);
}

__global__ void __launch_bounds__(psf_wgmma::kThreads, 1)
psf_crop_bf16_kernel(
    const __grid_constant__ psf_wgmma::Inputs<CropBf16> in,
    const CropBf16 pol, const psf_wgmma::Args a) {
  psf_wgmma::block(in, pol, a);
}

}  // namespace

extern "C" {

// Lays the operator's 3xTF32 image out in `work` -- ceil(w / 32) * 256 *
// (R rounded up to 32) floats, 16-byte aligned, allocated by the caller
// -- and launches the kernel (once per band pair of a crop wider than 32
// px), all on `stream` (a cudaStream_t) of CUDA device `device`.  Returns
// the first error: 0 when every launch was accepted.
int psf_crop(const float* phase, const float* pupil, const float* are,
             const float* aim, float* work, float* out, int batch, int R,
             int w, float scale, int device, void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch <= 0) return 0;
  return static_cast<int>(psf_wgmma::launch_tf32(
      psf_crop_kernel, CropTf32{out, batch}, {pupil, phase}, {1, batch},
      are, aim, work, R, w, scale, static_cast<cudaStream_t>(stream)));
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

// Dynamic shared memory a block of either kernel takes, in bytes: the
// float32 kernel's at any R on the current device, the bf16 one's at the
// main path's R=128 and a crop of one band (it grows with R and the
// crop's bands).
int psf_crop_smem_bytes() {
  return static_cast<int>(psf_wgmma::tf32::launch_smem<CropTf32>());
}
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
