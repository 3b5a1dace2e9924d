// The field-forming policy and the host launch of kernel B4
// (psf_div3_sym_thin.cu, both precisions), which computes kernel B1's
// function (psf_div3_sym.cu): for every scenario b the symmetric
// diversity triple (-a, 0, +a),
//
//   out[b, d] = |A F_d A^T|^2 * scale,     F_d = pupil e^{i (phase_b + d Z4)}
//
// on the tensor-core DFT engine psf_mma.cuh, one block a scenario (and
// band pair of a crop wider than 32 px).  cos/sin of the residual phase are taken ONCE
// per pixel (full-precision sincosf: the diversity alone reaches +-3 rad);
// the fields follow by angle addition from pcd = pupil cos(a Z4) and
// psd = pupil sin(a Z4), the four products t1 = c pcd, t2 = s psd,
// t3 = s pcd, t4 = c psd and F_0 = pupil (c, s):
//   F_-a = (t1 + t2, t3 - t4),   F_+a = (t1 - t2, t3 + t4).
// B4 forms the pseudo-fields P = t1 + i t3, F_0 and Q = t2 - i t4, and
// recombines their float32 stage-1 rows into the fields', G_-a = G_P +
// G_Q and G_+a = G_P - G_Q, before G is stored (and, for kBf16, rounded):
// the TPU kernels' thin-row recombination (pallas_kernels.py:161-171 for
// B1, :178-234 for B4).  B1's entries form and recombine the same
// pseudo-fields on their own engine, psf_wgmma.cuh; the float32 one ran
// this policy on psf_mma.cuh, forming F_-a, F_0, F_+a at every pixel,
// until it moved there.

#pragma once

#include <cuda_runtime.h>

#include "psf_mma.cuh"

namespace psf_sym3 {

using psf_mma::kFields;
using psf_mma::kTilePixels;
using psf_mma::Precision;

// Block b: scenario b's fields (-a, 0, +a), recombined on the stage-1
// rows.
template <Precision P>
struct Fields {
  static constexpr int kMaps = 4;     // phase, pupil, pcd, psd
  static constexpr bool kRecombine = true;
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
    f[0] = make_float2(t1, t3);       // P
    f[1] = make_float2(p * c, p * s);
    f[2] = make_float2(t2, -t4);      // Q
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

// Dynamic shared memory a block of a kernel of precision p takes.
constexpr size_t smem_bytes(Precision p) {
  return psf_mma::smem_bytes(Fields<Precision::kTf32x3>::kMaps, p);
}

// Lays the operator out in `work` and launches `kernel` (psf_mma::launch),
// on `stream` of CUDA device `device`; the first error.
template <Precision P>
int launch(void (*kernel)(Fields<P>, psf_mma::Band, int, int, float, int),
           const float* phase, const float* pupil, const float* pcd,
           const float* psd, const float* are, const float* aim, float* work,
           float* out, int batch, int R, int w, float scale, int device,
           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch <= 0) return 0;
  // the maps go to shared memory in 16-byte copies where rows allow it
  using psf_mma::aligned16;
  const int vec16 = R % 4 == 0 && aligned16(phase) && aligned16(pupil) &&
                    aligned16(pcd) && aligned16(psd);
  return static_cast<int>(psf_mma::launch(
      kernel, dim3(batch), smem_bytes(P),
      Fields<P>{phase, pupil, pcd, psd, out}, are, aim, work, R, w,
      scale, vec16, static_cast<cudaStream_t>(stream)));
}

}  // namespace psf_sym3
