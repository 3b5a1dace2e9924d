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
// What bounds it: 62.0 GFLOP of DFT stages per call at R=128, B=4096
// (98.7% of the work), taken in three TF32 passes for float32 accuracy:
// 0.3759 ms at the card's published 495 TFLOP/s TF32, 0.464 ms at the
// measured 400.6.  cos/sin take one full-precision sincosf a pixel (the
// diversity alone reaches +-3 rad).
//
// The design: the Hopper engine psf_wgmma.cuh in 3xTF32 (block_tf32)
// with its sym3 policy (psf_wgmma_sym3.cuh, which kernel B4 instantiates
// too), one scenario a consumer warpgroup.  The TPU
// kernel's stacked (2w, R) operator is stage 1's wgmma A operand, streamed
// a chunk a stage from an image split into TF32 hi and lo planes; the
// pseudo-fields P = (t1, t3), F_0 and Q = (t2, -t4) are formed once a
// pixel and split into hi and lo as the B operand; each k8 step is three
// wgmma (hi*hi into one accumulator, lo*hi and hi*lo into another); the
// fields' rows are recombined in float32, F_-a = P + Q and F_+a = P - Q
// (the TPU kernel's U +- W, pallas_kernels.py:161-171), and fed to stage
// 2 from registers.  Measured (NVIDIA H100 80GB HBM3, 700 W;
// benchmarks/kernel_variants.py, PERF.md): 0.78 ms at R=128, B=4096
// against 1.34 ms for the mma.sync design it replaced (the engine
// psf_mma.cuh with the field policy psf_sym3.cuh, forming F_-a, F_0, F_+a
// at every pixel; both retired, last held by commit 19f54fa) in the same
// call, and 0.65 against 1.17 ms at R=512, B=256.  Knock-out builds (benchmarks/bf16_knockouts.py) put ~0.25 ms in
// the field forming and ~0.25 ms in stage 1's wgmma, which overlap little:
// the forming's stores and the products' operand reads share the shared
// memory's bandwidth, which the operand reads alone keep ~80% busy.  Its
// error against the plain version is 1.3e-6 of the peak at R=128 and
// 2.2e-6 at R=512 (the mma.sync design's 2.0e-6 and 3.8e-6).
//
// psf_div3_sym_bf16 is the TPU kernel's compute_dtype="bfloat16" branch
// on the same engine (block: one bf16 pass, the operator held whole in
// shared memory), rounding where the TPU kernel rounds: the operator, the
// four products and F_0, and each field's stage-1 rows, which it forms
// from the products' rows in float32 first.
//
// Built with  nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// (ops/cuda_build.py) and called through ctypes (ops/psf_kernels.py).

#include <cuda_runtime.h>

#include "psf_wgmma.cuh"
#include "psf_wgmma_sym3.cuh"

namespace {

using psf_wgmma::Sym3Bf16;
using psf_wgmma::Sym3Tf32;

__global__ void __launch_bounds__(psf_wgmma::kThreads, 1)
psf_div3_sym_kernel(const __grid_constant__ psf_wgmma::Inputs<Sym3Tf32> in,
                    const Sym3Tf32 pol, const psf_wgmma::Args a) {
  psf_wgmma::block_tf32(in, pol, a);
}

__global__ void __launch_bounds__(psf_wgmma::kThreads, 1)
psf_div3_sym_bf16_kernel(
    const __grid_constant__ psf_wgmma::Inputs<Sym3Bf16> in,
    const Sym3Bf16 pol, const psf_wgmma::Args a) {
  psf_wgmma::block(in, pol, a);
}

}  // namespace

extern "C" {

// Lays the operator's 3xTF32 image out in `work` -- ceil(w / 32) * 256 *
// (R rounded up to 32) floats, 16-byte aligned, allocated by the caller
// -- and launches the kernel (once per band pair of a crop wider than 32
// px), all on `stream` (a cudaStream_t) of CUDA device `device`.  Returns
// the first error: 0 when every launch was accepted.
int psf_div3_sym(const float* phase, const float* pupil, const float* pcd,
                 const float* psd, const float* are, const float* aim,
                 float* work, float* out, int batch, int R, int w,
                 float scale, int device, void* stream) {
  return psf_wgmma::launch_sym3<true>(psf_div3_sym_kernel, phase, pupil, pcd,
                                      psd, are, aim, work, out, batch, R, w,
                                      scale, device, stream);
}

// As psf_div3_sym, with the DFT stages' operands in bf16: the
// compute_dtype="bfloat16" branch of the TPU kernel.  `work` takes the
// operator's bf16 image, ceil(w / 32) * 64 * 64 * ceil(R / 64) * 2 bytes
// (within psf_div3_sym's scratch).
int psf_div3_sym_bf16(const float* phase, const float* pupil,
                      const float* pcd, const float* psd, const float* are,
                      const float* aim, float* work, float* out, int batch,
                      int R, int w, float scale, int device, void* stream) {
  return psf_wgmma::launch_sym3<false>(psf_div3_sym_bf16_kernel, phase,
                                       pupil, pcd, psd, are, aim, work, out,
                                       batch, R, w, scale, device, stream);
}

// Dynamic shared memory a block of either kernel takes, in bytes: the
// float32 kernel's at any R on the current device, the bf16 one's at the
// main path's R=128 and a crop of one band (it grows with R and the
// crop's bands).
int psf_div3_sym_smem_bytes() { return psf_wgmma::sym3_smem_bytes<true>(); }
int psf_div3_sym_bf16_smem_bytes() {
  return psf_wgmma::sym3_smem_bytes<false>();
}

const char* psf_div3_sym_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
const char* psf_div3_sym_bf16_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
