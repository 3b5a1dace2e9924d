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
// c, s = cos, sin of the residual phase (taken once a pixel and group of
// up to three diversities)
// and pcd_d, psd_d = pupil cos, pupil sin of the diversity map d, formed
// once per call by the wrapper (exact: the pupil is a 0/1 mask) -- the
// angle-addition identity of the TPU kernel, so the (B, n_div, R, R)
// summed phase is never formed.
//
// What bounds it: the DFT stages, as in B1 (3 passes of 62.0 GFLOP per
// call at R=128, B=4096 on three maps); the maps are shared by all
// scenarios and stay in L2.
//
// Design: the Hopper engine psf_wgmma.cuh in 3xTF32 (block_tf32) with
// the div policy below (Div<true>), two scenarios of one group of up to
// three diversities a block pass, one a consumer warpgroup.  A stage
// holds the group's pcd_d and psd_d (shared by both consumers) and each
// consumer's phase, 8 maps: 32,768 B a stage with its operator tile, so
// 3 stages fit beside the T buffers (214,016 B), where B1's 5 maps take
// 4.  The consumers take one full-precision sincosf a pixel (four rows at
// once), then form the three fields by angle addition one at a time
// (six parts of four rows at once spilled), split each part into TF32
// hi and lo (form_field_tf32), and run each k8 step as three wgmma
// (hi*hi into one accumulator, lo*hi and hi*lo into another, added at
// the strip's end); no recombination.  A ragged last group (n_div not a multiple of 3)
// reads a present diversity in place of each absent one and stores
// nothing for it; an odd B repeats its last scenario in the second
// consumer, which stores nothing.  It replaced the mma.sync engine
// psf_mma.cuh (one 256-thread block per scenario and group, two
// __syncthreads a step; retired with kernel B4's move to this engine).
//
// psf_div_bf16 is the TPU kernel's compute_dtype="bfloat16" branch
// (pallas_kernels.py:85-87, :99-100, :106-107) on the same engine, as
// Div<false> (block: one bf16 pass, the operator held whole in shared
// memory): the fields formed in float32 and stored once in bf16, the
// stage-1 rows rounded in registers.
//
// Built with  nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// (ops/cuda_build.py) and called through ctypes (ops/psf_kernels.py).

#include <cuda_runtime.h>

#include "psf_wgmma.cuh"

namespace {

using psf_wgmma::kFields;

// psf_wgmma.cuh's div policy.  Pair q is group k = q / h of up to three
// diversities (3 k, 3 k + 1, 3 k + 2 of the n_div) and scenarios 2 (q %
// h) and 2 (q % h) + 1, h = ceil(B / 2) pairs a group (the last scenario
// repeated where B is odd); a stage holds the group's pcd_d, psd_d and
// the two scenarios' phases.  T holds each field's (re, im): each product
// rounded, then their sum -- as the TPU kernel forms the field it rounds
// to bf16 (kTf32 false; nvcc's fused multiply-add rounds once and flips
// that rounding now and then, which moved a crop pixel by 1.2e-4 of the
// peak on random diversity maps), or splits into TF32 hi and lo (kTf32:
// float32 accuracy, the plain version's products).  An absent diversity
// of the last group reads the last one's maps and stores nothing.
template <bool kTf32>
struct Div {
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
    if constexpr (kTf32) {
      // the four rows' sincosf first, then a field at a time: all six
      // parts of four rows at once spill beside O, S and C
      using psf_wgmma::tf32::kMapTile;
      float s[4], c[4];
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const int e = (4 * xg + h) * psf_wgmma::kStrip + y;
        sincosf(ph[e], &s[h], &c[h]);
      }
#pragma unroll
      for (int d = 0; d < kFields; ++d) {
        psf_wgmma::form_field_tf32(
            tb, 2 * d, y, xg, [&](int h, int e, float& re, float& im) {
              const float pc = st[2 * d * kMapTile + e],
                          ps = st[(2 * d + 1) * kMapTile + e];
              re = __fmul_rn(c[h], pc) - __fmul_rn(s[h], ps);
              im = __fmul_rn(s[h], pc) + __fmul_rn(c[h], ps);
            });
      }
    } else {
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
  }
};
using DivTf32 = Div<true>;
using DivBf16 = Div<false>;

__global__ void __launch_bounds__(psf_wgmma::kThreads, 1)
psf_div_kernel(const __grid_constant__ psf_wgmma::Inputs<DivTf32> in,
               const DivTf32 pol, const psf_wgmma::Args a) {
  psf_wgmma::block_tf32(in, pol, a);
}

__global__ void __launch_bounds__(psf_wgmma::kThreads, 1)
psf_div_bf16_kernel(
    const __grid_constant__ psf_wgmma::Inputs<DivBf16> in,
    const DivBf16 pol, const psf_wgmma::Args a) {
  psf_wgmma::block(in, pol, a);
}

}  // namespace

extern "C" {

// Lays the operator's 3xTF32 image out in `work` -- ceil(w / 32) * 256 *
// (R rounded up to 32) floats, 16-byte aligned, allocated by the caller
// -- and launches the kernel (once per band pair of a crop wider than 32
// px), all on `stream` (a cudaStream_t) of CUDA device `device`.  Returns
// the first error: 0 when every launch was accepted.
int psf_div(const float* phase, const float* pcd, const float* psd,
            const float* are, const float* aim, float* work, float* out,
            int batch, int n_div, int R, int w, float scale, int device,
            void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch <= 0 || n_div <= 0) return 0;
  return static_cast<int>(psf_wgmma::launch_tf32(
      psf_div_kernel, DivTf32{out, batch, n_div}, {pcd, psd, phase},
      {n_div, n_div, batch}, are, aim, work, R, w, scale,
      static_cast<cudaStream_t>(stream)));
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

// Dynamic shared memory a block of either kernel takes, in bytes: the
// float32 kernel's at any R on the current device, the bf16 one's at the
// main path's R=128 and a crop of one band (it grows with R and the
// crop's bands).
int psf_div_smem_bytes() {
  return static_cast<int>(psf_wgmma::tf32::launch_smem<DivTf32>());
}
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
