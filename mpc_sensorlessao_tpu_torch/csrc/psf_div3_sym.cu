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
// with A the (w, R) partial centered DFT (w = 2c+1 <= 32).  cos/sin of the
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
// loads four maps a K tile (phase, pupil, pcd, psd) and takes one
// full-precision sincosf per pixel -- the diversity alone reaches +-3 rad.
//
// psf_div3_sym_bf16 is the TPU kernel's compute_dtype="bfloat16" branch on
// the same engine (Precision::kBf16: one bf16 pass, f32 sums), rounding
// where the TPU kernel rounds: the operator, the four products and F_0,
// and each field's stage-1 rows, which it forms from the products' rows in
// float32 first.
//
// Built with  nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// (ops/cuda_build.py) and called through ctypes (ops/psf_kernels.py).

#include <cuda_runtime.h>

#include "psf_mma.cuh"

namespace {

using psf_mma::kFields;
using psf_mma::kTilePixels;
using psf_mma::Precision;

// Block b: scenario b's fields (-a, 0, +a) by angle addition.  For kBf16
// the fields formed are the JAX kernel's rounded products, as the
// pseudo-fields P = c pcd + i s pcd, F_0 and Q = s psd - i c psd; their
// float32 stage-1 rows recombine into the (-a, 0, +a) rows G_P + G_Q,
// G_0, G_P - G_Q before G is rounded (pallas_kernels.py:161-171).
template <Precision P>
struct Sym3Fields {
  static constexpr int kMaps = 4;     // phase, pupil, pcd, psd
  const float* phase;                 // (B, R, R)
  const float* pupil;                 // (R, R)
  const float* pcd;                   // (R, R)
  const float* psd;                   // (R, R)
  float* out_;                        // (B, 3, w, w)

  __device__ const float* map(int a, int R) const {
    return a == 0   ? phase + static_cast<size_t>(blockIdx.x) * R * R
           : a == 1 ? pupil
           : a == 2 ? pcd
                    : psd;
  }
  __device__ bool present(int) const { return true; }
  __device__ int fields() const { return kFields; }
  __device__ float* out(int w) const {
    return out_ + static_cast<size_t>(blockIdx.x) * kFields * w * w;
  }
  __device__ void form(const float* m, float2 (&f)[kFields]) const {
    const float p = m[kTilePixels], pc = m[2 * kTilePixels],
                ps = m[3 * kTilePixels];
    float s, c;
    sincosf(m[0], &s, &c);
    const float t1 = c * pc, t2 = s * ps, t3 = s * pc, t4 = c * ps;
    if constexpr (P == Precision::kBf16) {
      f[0] = make_float2(t1, t3);     // P
      f[1] = make_float2(p * c, p * s);
      f[2] = make_float2(t2, -t4);    // Q
    } else {
      f[0] = make_float2(t1 + t2, t3 - t4);
      f[1] = make_float2(p * c, p * s);
      f[2] = make_float2(t1 - t2, t3 + t4);
    }
  }
  __device__ void recombine(float (&g)[kFields][4]) const {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float gp = g[0][r], gq = g[2][r];
      g[0][r] = gp + gq;
      g[2][r] = gp - gq;
    }
  }
};

// Dynamic shared memory a block of the kernel of precision P takes.
constexpr size_t smem_bytes(Precision p) {
  return psf_mma::smem_bytes(Sym3Fields<Precision::kTf32x3>::kMaps, p);
}

__global__ void __launch_bounds__(psf_mma::kThreads, 2)
psf_div3_sym_kernel(Sym3Fields<Precision::kTf32x3> fields,
                    const float2* __restrict__ tiles, int R, int w,
                    float scale, int vec16) {
  psf_mma::crop_block<Precision::kTf32x3>(fields, tiles, R, w, scale, vec16);
}

__global__ void __launch_bounds__(psf_mma::kThreads, 2)
psf_div3_sym_bf16_kernel(Sym3Fields<Precision::kBf16> fields,
                         const float2* __restrict__ tiles, int R, int w,
                         float scale, int vec16) {
  psf_mma::crop_block<Precision::kBf16>(fields, tiles, R, w, scale, vec16);
}

// Lays the operator out in `work` and launches `kernel`, both on `stream`
// of CUDA device `device`; cudaGetLastError() after both.
template <Precision P>
int launch(void (*kernel)(Sym3Fields<P>, const float2*, int, int, float,
                          int),
           const float* phase, const float* pupil, const float* pcd,
           const float* psd, const float* are, const float* aim, float* work,
           float* out, int batch, int R, int w, float scale, int device,
           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = psf_mma::prepare(kernel, smem_bytes(P), are, aim, work, R, w, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  // the maps go to shared memory in 16-byte copies where rows allow it
  using psf_mma::aligned16;
  const int vec16 = R % 4 == 0 && aligned16(phase) && aligned16(pupil) &&
                    aligned16(pcd) && aligned16(psd);
  kernel<<<batch, psf_mma::kThreads, smem_bytes(P), s>>>(
      Sym3Fields<P>{phase, pupil, pcd, psd, out},
      reinterpret_cast<float2*>(work), R, w, scale, vec16);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Lays the operator out in `work` -- ceil(R / 32) * 32 * 32 * 2 floats,
// 16-byte aligned, allocated by the caller -- and launches the kernel,
// both on `stream` (a cudaStream_t) of CUDA device `device`.  Returns
// cudaGetLastError(): 0 when both launches were accepted.
int psf_div3_sym(const float* phase, const float* pupil, const float* pcd,
                 const float* psd, const float* are, const float* aim,
                 float* work, float* out, int batch, int R, int w,
                 float scale, int device, void* stream) {
  return launch(psf_div3_sym_kernel, phase, pupil, pcd, psd, are, aim, work,
                out, batch, R, w, scale, device, stream);
}

// As psf_div3_sym, with the DFT stages' operands in bf16: the
// compute_dtype="bfloat16" branch of the TPU kernel.
int psf_div3_sym_bf16(const float* phase, const float* pupil,
                      const float* pcd, const float* psd, const float* are,
                      const float* aim, float* work, float* out, int batch,
                      int R, int w, float scale, int device, void* stream) {
  return launch(psf_div3_sym_bf16_kernel, phase, pupil, pcd, psd, are, aim,
                work, out, batch, R, w, scale, device, stream);
}

// Dynamic shared memory a block of either kernel takes, in bytes.
int psf_div3_sym_smem_bytes() {
  return static_cast<int>(smem_bytes(Precision::kTf32x3));
}
int psf_div3_sym_bf16_smem_bytes() {
  return static_cast<int>(smem_bytes(Precision::kBf16));
}

const char* psf_div3_sym_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
const char* psf_div3_sym_bf16_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
