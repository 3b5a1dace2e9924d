// psf_wgmma.cuh's sym3 policy, the field policy of the symmetric triple
// (-a, 0, +a): kernel B1 (psf_div3_sym.cu) and kernel B4
// (psf_div3_sym_thin.cu) both instantiate the engine's blocks with it,
// so that their outputs agree bit for bit.
//
// A work item is a scenario; pair q is scenarios 2 q and 2 q + 1 (the
// last repeated where B is odd); a stage holds pupil, pcd, psd (shared by
// both consumers) and the two scenarios' phases.  T holds the
// pseudo-fields P = (t1, t3), F_0 = pupil (c, s) and Q = (t2, -t4), with
// t1 = c pcd, t2 = s psd, t3 = s pcd, t4 = c psd (c, s = cos, sin of the
// phase, one sincosf a pixel) -- rounded to bf16 once (kTf32 false: the
// TPU kernels' compute_dtype="bfloat16" branch, which rounds the products
// and F_0) or split into TF32 hi and lo (kTf32: float32 accuracy) -- and
// their stage-1 sums are recombined in float32 into the triple's fields,
// F_-a = P + Q and F_+a = P - Q: the TPU kernels' U +- W
// (mpc_sensorlessao_tpu/ops/pallas_kernels.py:161-171 in
// `_psf_div3_sym_kernel`, :193-212 in `_psf_div3_sym_thin_kernel`).

#pragma once

#include "psf_wgmma.cuh"

namespace psf_wgmma {

template <bool kTf32>
struct Sym3 {
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
    constexpr int kMapTile = kTf32 ? tf32::kMapTile : psf_wgmma::kMapTile;
    auto part = [&](int e, float (&v)[6]) {
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
    };
    if constexpr (kTf32) {
      form_t_tf32(tb, y, xg, part);
    } else {
      form_t<kIlp>(tb, y, xg, part);
    }
  }
};
using Sym3Tf32 = Sym3<true>;
using Sym3Bf16 = Sym3<false>;

// Launches `kernel` -- a __global__ wrapper of block_tf32 (kTf32) or block
// over Sym3 -- for `batch` scenarios, after laying the operator's image
// out in `work`, all on `stream` of CUDA device `device`: the float32 or
// bf16 entry of B1 or B4.  Returns the first error, 0 when every launch
// was accepted.
template <bool kTf32, class Kernel>
int launch_sym3(Kernel kernel, const float* phase, const float* pupil,
                const float* pcd, const float* psd, const float* are,
                const float* aim, float* work, float* out, int batch, int R,
                int w, float scale, int device, void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch <= 0) return 0;
  const Sym3<kTf32> pol{out, batch};
  const auto s = static_cast<cudaStream_t>(stream);
  if constexpr (kTf32) {
    return static_cast<int>(launch_tf32(kernel, pol, {pupil, pcd, psd, phase},
                                        {1, 1, 1, batch}, are, aim, work, R,
                                        w, scale, s));
  } else {
    return static_cast<int>(launch(kernel, pol, {pupil, pcd, psd, phase},
                                   {1, 1, 1, batch}, are, aim, work, R, w,
                                   scale, s));
  }
}

// Dynamic shared memory a block of the float32 kernel takes at any R on
// the current device (kTf32), or of the bf16 one at the main path's R=128
// and a crop of one band (it grows with R and the crop's bands).
template <bool kTf32>
int sym3_smem_bytes() {
  if constexpr (kTf32) {
    return static_cast<int>(tf32::launch_smem<Sym3<true>>());
  } else {
    return static_cast<int>(smem_bytes<Sym3<false>>(128, 1, kMaxStages));
  }
}

}  // namespace psf_wgmma
