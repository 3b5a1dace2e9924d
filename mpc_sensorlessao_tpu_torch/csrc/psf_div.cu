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
// Design: the tensor-core DFT engine psf_mma.cuh, one block per
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
// psf_div_bf16 is the TPU kernel's compute_dtype="bfloat16" branch
// (pallas_kernels.py:85-87, :99-100, :106-107) on the Hopper engine
// psf_wgmma.cuh, as its div policy (DivBf16 below): wgmma on the stacked
// (2w, R) operator, the fields formed in float32 and stored once in bf16,
// the stage-1 rows rounded in registers, persistent blocks with a
// producer warp.
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

// Block (b, k): scenario b, diversities 3 k, 3 k + 1, 3 k + 2 of the n_div.
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
      f[j] = make_float2(c * pc - s * ps, s * pc + c * ps);
    }
  }
};

// psf_wgmma.cuh's div policy.  Pair q is group k = q / h of up to three
// diversities (3 k, 3 k + 1, 3 k + 2 of the n_div) and scenarios 2 (q %
// h) and 2 (q % h) + 1, h = ceil(B / 2) pairs a group (the last scenario
// repeated where B is odd); a stage holds the group's pcd_d, psd_d and
// the two scenarios' phases.  T holds each field's (re, im): each product
// rounded, then their sum, as the TPU kernel forms the field it rounds to
// bf16 -- nvcc's fused multiply-add rounds once and flips that rounding
// now and then, which moved a crop pixel by 1.2e-4 of the peak on random
// diversity maps.  An absent diversity of the last group reads the last
// one's maps and stores nothing.
struct DivBf16 {
  static constexpr int kInputs = 3;    // pcd, psd (n_div, R, R); phase
  static constexpr int kShared = 2 * kFields, kOwn = 1, kIlp = 4;
  static constexpr bool kRecombine = false;
  float* out;                          // (B, n_div, w, w)
  int batch, n_div;

  __host__ __device__ static constexpr int input(int m) {
    return m < kShared ? m % 2 : 2;
  }
  __host__ __device__ int half() const { return (batch + 1) / 2; }
  __host__ __device__ int pairs() const {
    return (n_div + kFields - 1) / kFields * half();
  }
  __device__ int plane(int m, int q) const {
    return m < kShared ? min(kFields * (q / half()) + m / 2, n_div - 1)
                       : min(2 * (q % half()) + m - kShared, batch - 1);
  }
  __device__ float* crop(int q, int wg, int d, int w) const {
    const int b = 2 * (q % half()) + wg, j = kFields * (q / half()) + d;
    return b < batch && j < n_div
               ? out + (static_cast<size_t>(b) * n_div + j) * w * w
               : nullptr;
  }
  __device__ static void form(const float* st, const float* ph,
                              unsigned char* tb, int y, int xg) {
    using psf_wgmma::kMapTile;
    psf_wgmma::form_t<kIlp>(tb, y, xg, [&](int e, float (&v)[6]) {
      float s, c;
      sincosf(ph[e], &s, &c);
#pragma unroll
      for (int d = 0; d < kFields; ++d) {
        const float pc = st[2 * d * kMapTile + e],
                    ps = st[(2 * d + 1) * kMapTile + e];
        v[2 * d] = __fmul_rn(c, pc) - __fmul_rn(s, ps);
        v[2 * d + 1] = __fmul_rn(s, pc) + __fmul_rn(c, ps);
      }
    });
  }
};

// Dynamic shared memory a block of the float32 kernel takes.
constexpr size_t kSmemBytes =
    psf_mma::smem_bytes(DiversityFields::kMaps, Precision::kTf32x3);

__global__ void __launch_bounds__(psf_mma::kThreads, 2)
psf_div_kernel(DiversityFields fields, psf_mma::Band band, int R, int w,
               float scale, int vec16) {
  psf_mma::crop_block<Precision::kTf32x3>(fields, band, R, w, scale, vec16);
}

__global__ void __launch_bounds__(psf_wgmma::kThreads, 1)
psf_div_bf16_kernel(
    const __grid_constant__ psf_wgmma::Inputs<DivBf16> in,
    const DivBf16 pol, const psf_wgmma::Args a) {
  psf_wgmma::block(in, pol, a);
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
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch <= 0 || n_div <= 0) return 0;
  using psf_mma::aligned16;
  const int vec16 =
      R % 4 == 0 && aligned16(phase) && aligned16(pcd) && aligned16(psd);
  const dim3 grid(batch, (n_div + kFields - 1) / kFields);
  return static_cast<int>(psf_mma::launch(
      psf_div_kernel, grid, kSmemBytes,
      DiversityFields{phase, pcd, psd, out, n_div}, are, aim, work, R, w,
      scale, vec16, static_cast<cudaStream_t>(stream)));
}

// As psf_div, with the DFT stages' operands in bf16: the
// compute_dtype="bfloat16" branch of the TPU kernel, on psf_wgmma.cuh.
// `work` takes the operator's bf16 image, ceil(w / 32) * 64 * 64 *
// ceil(R / 64) * 2 bytes (within psf_div's scratch).
int psf_div_bf16(const float* phase, const float* pcd, const float* psd,
                 const float* are, const float* aim, float* work, float* out,
                 int batch, int n_div, int R, int w, float scale, int device,
                 void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch <= 0 || n_div <= 0) return 0;
  return static_cast<int>(psf_wgmma::launch(
      psf_div_bf16_kernel, DivBf16{out, batch, n_div}, {pcd, psd, phase},
      {n_div, n_div, batch}, are, aim, work, R, w, scale,
      static_cast<cudaStream_t>(stream)));
}

// Dynamic shared memory a block of either kernel takes, in bytes: for
// the bf16 kernel at the main path's R=128 and a crop of one band (it
// grows with R and the crop's bands).
int psf_div_smem_bytes() { return static_cast<int>(kSmemBytes); }
int psf_div_bf16_smem_bytes() {
  return static_cast<int>(
      psf_wgmma::smem_bytes<DivBf16>(128, 1, psf_wgmma::kMaxStages));
}

const char* psf_div_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
const char* psf_div_bf16_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
