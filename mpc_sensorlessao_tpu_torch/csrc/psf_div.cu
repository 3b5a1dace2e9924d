// Kernel B2: fused diversity-PSF measure for a general stack of n_div
// diversity maps, with both DFT stages on the tensor cores at float32
// accuracy (3xTF32).
//
// Replaces the TPU kernel mpc_sensorlessao_tpu/ops/pallas_kernels.py
// `_psf_div_kernel` (wrapper `psf_crop_diversity`).  For every scenario b
// and diversity d it computes
//
//   out[b, d] = |A F_bd A^T|^2 * scale,
//   F_bd = (c pcd_d - s psd_d, s pcd_d + c psd_d),
//
// c, s = cos, sin of the residual phase (taken once per pixel and block)
// and pcd_d, psd_d = pupil cos, pupil sin of the diversity map d, formed
// once per call by the wrapper (exact: the pupil is a 0/1 mask) -- the
// angle-addition identity of the TPU kernel, so the (B, n_div, R, R)
// summed phase is never formed.
//
// What bounds it: the DFT stages, as in B1 (3 passes of 62.0 GFLOP per
// call at R=128, B=4096 on three maps); the maps are shared by all
// scenarios and stay in L2.
//
// Design: the tensor-core DFT engine of B1 (psf_mma.cuh), one block per
// scenario and group of up to three diversities, grid (B, ceil(n_div /
// 3)).  Its field-forming policy loads the phase and the group's pcd and
// psd a K tile -- 7 maps, 74,752 B of shared memory a block, still two
// blocks per SM -- and takes one full-precision sincosf per pixel, then
// angle addition per diversity.  A group of 1 or 2 diversities (the last,
// when 3 does not divide n_div) reads the missing maps as zeros, so their
// fields are zero, and stores nothing for them: one instantiation and one
// warp layout, since the engine's warp roles are cut for three fields,
// and the loop's route (n_div = 3) has no such group.
//
// psf_div_bf16 is the TPU kernel's compute_dtype="bfloat16" branch on the
// same engine and policy (Precision::kBf16: one bf16 pass, f32 sums): the
// fields formed in float32, the operator and the stage-1 rows are each
// rounded to bf16 as the stages load them (pallas_kernels.py:85-107).
//
// Built with  nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// (ops/cuda_build.py) and called through ctypes (ops/psf_kernels.py).

#include <cuda_runtime.h>

#include "psf_mma.cuh"

namespace {

using psf_mma::kFields;
using psf_mma::kTilePixels;
using psf_mma::Precision;

// Block (b, k): scenario b, diversities 3 k, 3 k + 1, 3 k + 2 of the n_div.
template <Precision P>
struct DiversityFields {
  // phase, then (pcd, psd) of each diversity of the group
  static constexpr int kMaps = 1 + 2 * kFields;
  static constexpr bool kRecombine = false;
  const float* phase;                 // (B, R, R)
  const float* pcd;                   // (n_div, R, R)
  const float* psd;                   // (n_div, R, R)
  float* out_;                        // (B, n_div, w, w)
  int n_div;

  __device__ int first() const { return kFields * blockIdx.y; }
  __device__ const float* map(int a, int R) const {
    const size_t plane = static_cast<size_t>(R) * R;
    if (a == 0) return phase + blockIdx.x * plane;
    // an absent diversity reads (as zeros) from the last one's plane
    const int d = min(first() + (a - 1) / 2, n_div - 1);
    return (a % 2 ? pcd : psd) + d * plane;
  }
  __device__ bool present(int a) const {
    return a == 0 || first() + (a - 1) / 2 < n_div;
  }
  __device__ int fields() const { return min(kFields, n_div - first()); }
  __device__ float* out(int w) const {
    return out_ +
           (static_cast<size_t>(blockIdx.x) * n_div + first()) * w * w;
  }
  __device__ void form(const float* m, float2 (&f)[kFields]) const {
    float s, c;
    sincosf(m[0], &s, &c);
#pragma unroll
    for (int j = 0; j < kFields; ++j) {
      const float pc = m[(1 + 2 * j) * kTilePixels],
                  ps = m[(2 + 2 * j) * kTilePixels];
      if constexpr (P == Precision::kBf16) {
        // each product rounded, then their sum, as the TPU kernel forms
        // the field it rounds to bf16: nvcc's fused multiply-add rounds
        // once and flips that rounding now and then, which moved a crop
        // pixel by 1.2e-4 of the peak on random diversity maps
        f[j] = make_float2(__fmul_rn(c, pc) - __fmul_rn(s, ps),
                           __fmul_rn(s, pc) + __fmul_rn(c, ps));
      } else {
        f[j] = make_float2(c * pc - s * ps, s * pc + c * ps);
      }
    }
  }
};

// Dynamic shared memory a block of the kernel of precision P takes.
constexpr size_t smem_bytes(Precision p) {
  return psf_mma::smem_bytes(DiversityFields<Precision::kTf32x3>::kMaps, p);
}

__global__ void __launch_bounds__(psf_mma::kThreads, 2)
psf_div_kernel(DiversityFields<Precision::kTf32x3> fields,
               psf_mma::Band band, int R, int w, float scale, int vec16) {
  psf_mma::crop_block<Precision::kTf32x3>(fields, band, R, w, scale, vec16);
}

__global__ void __launch_bounds__(psf_mma::kThreads, 2)
psf_div_bf16_kernel(DiversityFields<Precision::kBf16> fields,
                    psf_mma::Band band, int R, int w, float scale,
                    int vec16) {
  psf_mma::crop_block<Precision::kBf16>(fields, band, R, w, scale, vec16);
}

// Lays the operator out in `work` and launches `kernel` (of precision P,
// psf_mma::launch) on `stream` of CUDA device `device`; the first error.
template <Precision P>
int launch(void (*kernel)(DiversityFields<P>, psf_mma::Band, int, int,
                          float, int),
           const float* phase, const float* pcd, const float* psd,
           const float* are, const float* aim, float* work, float* out,
           int batch, int n_div, int R, int w, float scale, int device,
           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch <= 0 || n_div <= 0) return 0;
  using psf_mma::aligned16;
  const int vec16 =
      R % 4 == 0 && aligned16(phase) && aligned16(pcd) && aligned16(psd);
  const dim3 grid(batch, (n_div + kFields - 1) / kFields);
  return static_cast<int>(psf_mma::launch(
      kernel, grid, smem_bytes(P),
      DiversityFields<P>{phase, pcd, psd, out, n_div}, are, aim, work, R, w,
      scale, vec16, static_cast<cudaStream_t>(stream)));
}

}  // namespace

extern "C" {

// Lays the operator out in `work` -- ceil(w / 32) * ceil(R / 32) * 32 *
// 32 * 2 floats, 16-byte aligned, allocated by the caller -- and launches
// the kernel (once per band pair of a crop wider than 32 px), all on
// `stream` (a cudaStream_t) of CUDA device `device`.  Returns the first
// error: 0 when every launch was accepted.
int psf_div(const float* phase, const float* pcd, const float* psd,
            const float* are, const float* aim, float* work, float* out,
            int batch, int n_div, int R, int w, float scale, int device,
            void* stream) {
  return launch(psf_div_kernel, phase, pcd, psd, are, aim, work, out, batch,
                n_div, R, w, scale, device, stream);
}

// As psf_div, with the DFT stages' operands in bf16: the
// compute_dtype="bfloat16" branch of the TPU kernel.
int psf_div_bf16(const float* phase, const float* pcd, const float* psd,
                 const float* are, const float* aim, float* work, float* out,
                 int batch, int n_div, int R, int w, float scale, int device,
                 void* stream) {
  return launch(psf_div_bf16_kernel, phase, pcd, psd, are, aim, work, out,
                batch, n_div, R, w, scale, device, stream);
}

// Dynamic shared memory a block of either kernel takes, in bytes.
int psf_div_smem_bytes() {
  return static_cast<int>(smem_bytes(Precision::kTf32x3));
}
int psf_div_bf16_smem_bytes() {
  return static_cast<int>(smem_bytes(Precision::kBf16));
}

const char* psf_div_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
const char* psf_div_bf16_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
