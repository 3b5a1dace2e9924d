// Kernel B4: kernel B1's function (the symmetric triple (-a, 0, +a)) with
// the +- recombination done on the thin row intermediate, with both DFT
// stages on the tensor cores at float32 accuracy (3xTF32).
//
// Replaces the TPU kernel mpc_sensorlessao_tpu/ops/pallas_kernels.py
// `_psf_div3_sym_thin_kernel` (wrapper `psf_crop_diversity_sym3_thin`).
// Output and arguments are B1's (psf_div3_sym.cu):
//
//   out[b, d] = |A F_d A^T|^2 * scale,   F_d = pupil e^{i (phase_b + d Z4)},
//
// for any crop width w.  The TPU kernel sends the six real products of
// cos, sin of the phase with pcd, psd and the pupil through the first DFT
// stage unmixed and recombines the fields' (w, R) rows from theirs.  Here
// the products pair up, with no rounding, into three complex pseudo-fields
// P = t1 + i t3, F_0 = t5 + i t6 and Q = t2 - i t4 (t1 = c pcd, t2 = s psd,
// t3 = s pcd, t4 = c psd, t5 = pupil c, t6 = pupil s), whose float32
// stage-1 rows recombine in registers into the fields', G_-a = G_P + G_Q
// and G_+a = G_P - G_Q, before stage 2: the same sums the TPU kernel forms
// on its rows, and the same tensor-core work as B1.
//
// What bounds it, and the design: the mma.sync engine psf_mma.cuh that B1
// ran until it moved to psf_wgmma.cuh, with the field-forming policy of
// psf_sym3.cuh, recombining in both precisions: 3 TF32 passes of 62.0
// GFLOP of DFT stages per call at R=128, B=4096.  It stays on this engine
// as the yardstick of B1's old design in the kernel A/B.  The FP32 design this replaced ran the six products'
// first stage as scalar fmaf chains (48 row accumulators a thread) and
// took 2.3298 ms there (NVIDIA H100 80GB HBM3, 700 W), 16.1% of the
// tensor bound.
//
// psf_div3_sym_thin_bf16 is the TPU kernel's compute_dtype="bfloat16"
// branch on the same engine (Precision::kBf16: one bf16 pass, f32 sums),
// rounding where the TPU kernel rounds (pallas_kernels.py:193-212): the
// operator and the six products (a product is one multiply, so P, F_0 and
// Q round as the products do), and each field's stage-1 rows after the
// +- recombination in float32.  It is B1 bf16's old instantiation, under
// B4's entry.
//
// Built with  nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// (ops/cuda_build.py) and called through ctypes (ops/psf_kernels.py).

#include <cuda_runtime.h>

#include "psf_mma.cuh"
#include "psf_sym3.cuh"

namespace {

using psf_mma::Precision;
// the pseudo-fields P, F_0, Q, recombined on the stage-1 rows
template <Precision P>
using ThinFields = psf_sym3::Fields<P>;

__global__ void __launch_bounds__(psf_mma::kThreads, 2)
psf_div3_sym_thin_kernel(ThinFields<Precision::kTf32x3> fields,
                         psf_mma::Band band, int R, int w,
                         float scale, int vec16) {
  psf_mma::crop_block<Precision::kTf32x3>(fields, band, R, w, scale, vec16);
}

__global__ void __launch_bounds__(psf_mma::kThreads, 2)
psf_div3_sym_thin_bf16_kernel(ThinFields<Precision::kBf16> fields,
                              psf_mma::Band band, int R, int w,
                              float scale, int vec16) {
  psf_mma::crop_block<Precision::kBf16>(fields, band, R, w, scale, vec16);
}

}  // namespace

extern "C" {

// Lays the operator out in `work` -- ceil(w / 32) * ceil(R / 32) * 32 *
// 32 * 2 floats, 16-byte aligned, allocated by the caller -- and launches
// the kernel (once per band pair of a crop wider than 32 px), all on
// `stream` (a cudaStream_t) of CUDA device `device`.  Returns the first
// error: 0 when every launch was accepted.
int psf_div3_sym_thin(const float* phase, const float* pupil,
                      const float* pcd, const float* psd, const float* are,
                      const float* aim, float* work, float* out, int batch,
                      int R, int w, float scale, int device, void* stream) {
  return psf_sym3::launch(psf_div3_sym_thin_kernel, phase, pupil, pcd, psd,
                          are, aim, work, out, batch, R, w, scale, device,
                          stream);
}

// As psf_div3_sym_thin, with the DFT stages' operands in bf16: the
// compute_dtype="bfloat16" branch of the TPU kernel.
int psf_div3_sym_thin_bf16(const float* phase, const float* pupil,
                           const float* pcd, const float* psd,
                           const float* are, const float* aim, float* work,
                           float* out, int batch, int R, int w, float scale,
                           int device, void* stream) {
  return psf_sym3::launch(psf_div3_sym_thin_bf16_kernel, phase, pupil, pcd,
                          psd, are, aim, work, out, batch, R, w, scale,
                          device, stream);
}

// Dynamic shared memory a block of either kernel takes, in bytes.
int psf_div3_sym_thin_smem_bytes() {
  return static_cast<int>(psf_sym3::smem_bytes(Precision::kTf32x3));
}
int psf_div3_sym_thin_bf16_smem_bytes() {
  return static_cast<int>(psf_sym3::smem_bytes(Precision::kBf16));
}

const char* psf_div3_sym_thin_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
const char* psf_div3_sym_thin_bf16_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
