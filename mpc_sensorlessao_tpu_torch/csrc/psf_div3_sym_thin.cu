// Kernel B4: kernel B1's function (the symmetric triple (-a, 0, +a)) with
// the +- recombination done on the thin row intermediate, with both DFT
// stages on the tensor cores at float32 accuracy (3xTF32).
//
// Replaces the TPU kernel mpc_sensorlessao_tpu/ops/pallas_kernels.py
// `_psf_div3_sym_thin_kernel` (:178-234, pallas_call :257; wrapper
// `psf_crop_diversity_sym3_thin`).  Output and arguments are B1's
// (psf_div3_sym.cu):
//
//   out[b, d] = |A F_d A^T|^2 * scale,   F_d = pupil e^{i (phase_b + d Z4)},
//
// for any crop width w.  The TPU kernel sends the six real products of
// cos, sin of the phase with pcd, psd and the pupil through the first DFT
// stage unmixed and recombines the fields' (w, R) rows from theirs, so as
// not to hold B1's packed (R, 2R) operands in VMEM.  The products pair up,
// with no rounding, into three complex pseudo-fields P = t1 + i t3, F_0 =
// t5 + i t6 and Q = t2 - i t4 (t1 = c pcd, t2 = s psd, t3 = s pcd, t4 = c
// psd, t5 = pupil c, t6 = pupil s), whose float32 stage-1 rows recombine
// into the fields', G_-a = G_P + G_Q and G_+a = G_P - G_Q, before stage
// 2: the same sums the TPU kernel forms on its rows.
//
// The design: that is what the Hopper engine psf_wgmma.cuh's sym3 policy
// (psf_wgmma_sym3.cuh) forms and recombines, with the same bf16 rounding
// points, and on that engine a field is formed a 16-column strip at a
// time into shared-memory T buffers: there is no R^2-sized copy left to
// avoid.  So B4 is B1's design under B4's entry points -- block_tf32 (3
// TF32 passes: hi*hi and the lo*hi + hi*lo corrections in two
// accumulators) for psf_div3_sym_thin, block (one bf16 pass, f32 sums)
// for psf_div3_sym_thin_bf16 -- and its outputs equal B1's bit for bit.
// It runs 3 TF32 passes of 62.0 GFLOP of DFT stages per call at R=128,
// B=4096 (0.3759 ms at the card's published 495 TFLOP/s TF32).
//
// Before it, B4 ran the mma.sync engine psf_mma.cuh with the field
// policy psf_sym3.cuh (both retired; last held by commit 19f54fa):
// 1.2807-1.2877 ms in float32 and 0.6602-0.6695 ms in bf16 at R=128,
// B=4096, w=31 (NVIDIA H100 80GB HBM3, 700 W; benchmarks/kernel_variants.py,
// PERF.md).  The FP32 design before that ran the six products' first
// stage as scalar fmaf chains and took 2.3298 ms there.
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
psf_div3_sym_thin_kernel(
    const __grid_constant__ psf_wgmma::Inputs<Sym3Tf32> in,
    const Sym3Tf32 pol, const psf_wgmma::Args a) {
  psf_wgmma::block_tf32(in, pol, a);
}

__global__ void __launch_bounds__(psf_wgmma::kThreads, 1)
psf_div3_sym_thin_bf16_kernel(
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
int psf_div3_sym_thin(const float* phase, const float* pupil,
                      const float* pcd, const float* psd, const float* are,
                      const float* aim, float* work, float* out, int batch,
                      int R, int w, float scale, int device, void* stream) {
  return psf_wgmma::launch_sym3<true>(psf_div3_sym_thin_kernel, phase, pupil,
                                      pcd, psd, are, aim, work, out, batch, R,
                                      w, scale, device, stream);
}

// As psf_div3_sym_thin, with the DFT stages' operands in bf16: the
// compute_dtype="bfloat16" branch of the TPU kernel.  `work` takes the
// operator's bf16 image (within psf_div3_sym_thin's scratch).
int psf_div3_sym_thin_bf16(const float* phase, const float* pupil,
                           const float* pcd, const float* psd,
                           const float* are, const float* aim, float* work,
                           float* out, int batch, int R, int w, float scale,
                           int device, void* stream) {
  return psf_wgmma::launch_sym3<false>(psf_div3_sym_thin_bf16_kernel, phase,
                                       pupil, pcd, psd, are, aim, work, out,
                                       batch, R, w, scale, device, stream);
}

// Dynamic shared memory a block of either kernel takes, in bytes (as
// psf_div3_sym's).
int psf_div3_sym_thin_smem_bytes() {
  return psf_wgmma::sym3_smem_bytes<true>();
}
int psf_div3_sym_thin_bf16_smem_bytes() {
  return psf_wgmma::sym3_smem_bytes<false>();
}

const char* psf_div3_sym_thin_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
const char* psf_div3_sym_thin_bf16_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
