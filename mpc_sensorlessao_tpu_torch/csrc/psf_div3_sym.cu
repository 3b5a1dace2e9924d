// Kernel B1: fused diversity-PSF measure for the symmetric triple (-a, 0, +a),
// with both DFT stages on the tensor cores at float32 accuracy (3xTF32).
//
// Replaces the TPU kernel mpc_sensorlessao_tpu/ops/pallas_kernels.py
// `_psf_div3_sym_kernel` (wrapper `psf_crop_diversity_sym3`).  For every
// scenario b it computes, for the three defocus diversities d in
// (-a, 0, +a),
//
//   out[b, d] = |A F_d A^T|^2 * scale,     F_d = pupil e^{i (phase_b + d Z4)}
//
// with A the (w, R) partial centered DFT (w = 2c+1, any c).  cos/sin of the
// residual phase are taken ONCE per pixel; the three fields follow by the
// angle-addition identity from pcd = pupil cos(a Z4) and psd = pupil
// sin(a Z4):
//   F_0  = pupil (c, s)
//   F_+a = (c pcd - s psd, s pcd + c psd)
//   F_-a = (c pcd + s psd, s pcd - c psd).
//
// What bounds it, and the design: the tensor-core DFT engine that B1, B2
// and B3 share (psf_mma.cuh), whose block here is one scenario's three
// diversities: 62.0 GFLOP of DFT stages per call at R=128, B=4096, 98.7%
// of the work.  The FP32 design this replaced ran them as scalar fmaf
// chains and took 1.954 ms there (NVIDIA H100 80GB HBM3, 700 W),
// issue-bound on FP32 and shared-memory loads.  B1's field-forming policy
// (psf_sym3.cuh, shared with B4) loads four maps a K tile (phase, pupil,
// pcd, psd) and takes one full-precision sincosf per pixel -- the
// diversity alone reaches +-3 rad.
//
// psf_div3_sym_bf16 is the TPU kernel's compute_dtype="bfloat16" branch
// on the Hopper engine psf_wgmma.cuh (wgmma on the TPU kernel's stacked
// (2w, R) operator, fields stored once in bf16, persistent blocks with a
// producer warp) as its sym3 policy, rounding where the TPU kernel
// rounds: the operator, the four products and F_0, and each field's
// stage-1 rows, which it forms from the products' rows in float32 first.
//
// Built with  nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// (ops/cuda_build.py) and called through ctypes (ops/psf_kernels.py).

#include <cuda_runtime.h>

#include "psf_mma.cuh"
#include "psf_sym3.cuh"
#include "psf_wgmma.cuh"

namespace {

using psf_mma::Precision;
// the +- fields formed per pixel in float32; for kBf16 the JAX kernel's
// rounded products, as pseudo-fields recombined on the stage-1 rows
// (pallas_kernels.py:161-171)
template <Precision P>
using Sym3Fields = psf_sym3::Fields<P, P == Precision::kBf16>;

__global__ void __launch_bounds__(psf_mma::kThreads, 2)
psf_div3_sym_kernel(Sym3Fields<Precision::kTf32x3> fields,
                    psf_mma::Band band, int R, int w, float scale,
                    int vec16) {
  psf_mma::crop_block<Precision::kTf32x3>(fields, band, R, w, scale, vec16);
}

// psf_wgmma.cuh's sym3 policy: pair q is scenarios 2 q and 2 q + 1 (the
// last repeated where B is odd); a stage holds pupil, pcd, psd and the
// two scenarios' phases.  T holds the pseudo-fields P = (t1, t3), F_0 and
// Q = (t2, -t4), rounded as psf_sym3::Fields<kBf16, true>::form rounds
// them, and their stage-1 sums are recombined into the triple's fields.
struct Sym3Bf16 {
  static constexpr int kInputs = 4;    // pupil, pcd, psd; phase (B, R, R)
  static constexpr int kShared = 3, kOwn = 1, kIlp = 4;
  static constexpr bool kRecombine = true;
  float* out;                          // (B, 3, w, w)
  int batch;

  __host__ __device__ static constexpr int input(int m) {
    return m < kShared ? m : kShared;
  }
  __host__ __device__ int pairs() const { return (batch + 1) / 2; }
  __device__ int plane(int m, int q) const {
    return m < kShared ? 0 : min(2 * q + m - kShared, batch - 1);
  }
  __device__ float* crop(int q, int wg, int d, int w) const {
    const int b = 2 * q + wg;
    return b < batch ? out + (static_cast<size_t>(b) * 3 + d) * w * w
                     : nullptr;
  }
  __device__ static void form(const float* st, const float* ph,
                              unsigned char* tb, int y, int xg) {
    using psf_wgmma::kMapTile;
    psf_wgmma::form_t<kIlp>(tb, y, xg, [&](int e, float (&v)[6]) {
      const float p = st[e], pc = st[kMapTile + e],
                  ps = st[2 * kMapTile + e];
      float s, c;
      sincosf(ph[e], &s, &c);
      const float t1 = c * pc, t2 = s * ps, t3 = s * pc, t4 = c * ps;
      v[0] = t1;
      v[1] = t3;
      v[2] = p * c;
      v[3] = p * s;
      v[4] = t2;
      v[5] = -t4;
    });
  }
};

__global__ void __launch_bounds__(psf_wgmma::kThreads, 1)
psf_div3_sym_bf16_kernel(
    const __grid_constant__ psf_wgmma::Inputs<Sym3Bf16> in,
    const Sym3Bf16 pol, const psf_wgmma::Args a) {
  psf_wgmma::block(in, pol, a);
}

}  // namespace

extern "C" {

// Lays the operator out in `work` -- ceil(w / 32) * ceil(R / 32) * 32 *
// 32 * 2 floats, 16-byte aligned, allocated by the caller -- and launches
// the kernel (once per band pair of a crop wider than 32 px), all on
// `stream` (a cudaStream_t) of CUDA device `device`.  Returns the first
// error: 0 when every launch was accepted.
int psf_div3_sym(const float* phase, const float* pupil, const float* pcd,
                 const float* psd, const float* are, const float* aim,
                 float* work, float* out, int batch, int R, int w,
                 float scale, int device, void* stream) {
  return psf_sym3::launch(psf_div3_sym_kernel, phase, pupil, pcd, psd, are,
                          aim, work, out, batch, R, w, scale, device, stream);
}

// As psf_div3_sym, with the DFT stages' operands in bf16: the
// compute_dtype="bfloat16" branch of the TPU kernel, on psf_wgmma.cuh.
// `work` takes the operator's bf16 image, ceil(w / 32) * 64 * 64 *
// ceil(R / 64) * 2 bytes (within psf_div3_sym's scratch).
int psf_div3_sym_bf16(const float* phase, const float* pupil,
                      const float* pcd, const float* psd, const float* are,
                      const float* aim, float* work, float* out, int batch,
                      int R, int w, float scale, int device, void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch <= 0) return 0;
  return static_cast<int>(psf_wgmma::launch(
      psf_div3_sym_bf16_kernel, Sym3Bf16{out, batch},
      {pupil, pcd, psd, phase}, {1, 1, 1, batch}, are, aim, work, R, w,
      scale, static_cast<cudaStream_t>(stream)));
}

// Dynamic shared memory a block of either kernel takes, in bytes: for
// the bf16 kernel at the main path's R=128 and a crop of one band (it
// grows with R and the crop's bands).
int psf_div3_sym_smem_bytes() {
  return static_cast<int>(psf_sym3::smem_bytes(Precision::kTf32x3));
}
int psf_div3_sym_bf16_smem_bytes() {
  return static_cast<int>(
      psf_wgmma::smem_bytes<Sym3Bf16>(128, 1, psf_wgmma::kMaxStages));
}

const char* psf_div3_sym_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
const char* psf_div3_sym_bf16_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
