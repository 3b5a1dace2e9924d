// Kernel B4: kernel B1's function (the symmetric triple (-a, 0, +a)) with
// the +- recombination done on the thin row intermediate.
//
// Replaces the TPU kernel mpc_sensorlessao_tpu/ops/pallas_kernels.py
// `_psf_div3_sym_thin_kernel` (wrapper `psf_crop_diversity_sym3_thin`).
// Output and arguments are B1's (psf_div3_sym.cu):
//
//   out[b, d] = |A F_d A^T|^2 * scale,   F_d = pupil e^{i (phase_b + d Z4)}.
//
// Instead of forming the three complex fields per pixel, the six REAL
// products of the TPU kernel
//
//   t1 = c pcd, t2 = s psd, t3 = s pcd, t4 = c psd, t5 = pupil c,
//   t6 = pupil s          (c, s = cos, sin of the phase; pcd, psd =
//                           pupil cos(a Z4), pupil sin(a Z4))
//
// go through the first DFT stage unmixed, U_k = A t_k (2 FMAs per real
// element: the same 12 w R^2 FMAs as B1's three complex fields), and the
// fields' row intermediates follow by linearity on the (w, R) rows:
//
//   G_-a = (U1 + U2) + i (U3 - U4),  G_0 = U5 + i U6,
//   G_+a = (U1 - U2) + i (U3 + U4).
//
// On the TPU this removed six R^2-sized VMEM copies; B1 makes no such
// copies on Hopper, so here it saves only B1's four per-pixel adds, and
// holds 48 row accumulators a thread instead of 24.  Bound as B1: FP32
// issue and shared-memory loads.  Design as B1 otherwise: one block of
// 8 warps per scenario, 32 x 32 tiles of the six products in shared
// memory, rows and the 3 x w x w output in registers; the operator-tile
// load, the second-stage fold and the store are psf_tiles.cuh's.  float32
// throughout, sincosf (not __sincosf), no fast math.
//
// Built with  nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// (ops/cuda_build.py) and called through ctypes (ops/psf_kernels.py).

#include <cuda_runtime.h>

#include "psf_tiles.cuh"

namespace {

using psf_tiles::kCrop;
using psf_tiles::kRowsPerWarp;
using psf_tiles::kThreads;
using psf_tiles::kTile;
using psf_tiles::kWarps;

constexpr int kProducts = 6;

__global__ void __launch_bounds__(kThreads)
psf_div3_sym_thin_kernel(const float* __restrict__ phase,  // (B, R, R)
                         const float* __restrict__ pupil,  // (R, R)
                         const float* __restrict__ pcd,    // (R, R)
                         const float* __restrict__ psd,    // (R, R)
                         const float* __restrict__ are,    // (w, R)
                         const float* __restrict__ aim,    // (w, R)
                         float* __restrict__ out,          // (B, 3, w, w)
                         int R, int w, float scale) {
  // product tiles [k][x][y] (6 x 4 KB); the same bytes hold the three
  // complex row intermediates [d][u][y] for the second stage
  __shared__ float2 buf[3][kTile][kTile];
  float(*prod)[kTile][kTile] = reinterpret_cast<float(*)[kTile][kTile]>(buf);
  // operator tile transposed, [k][u] = A[u][k0 + k]; padded row
  __shared__ float2 at[kTile][kCrop + 1];

  const int lane = threadIdx.x;
  const int warp = threadIdx.y;
  const float* ph = phase + static_cast<size_t>(blockIdx.x) * R * R;

  // out_d[u][v] for u = warp + kWarps * j, v = lane
  float o_re[3][kRowsPerWarp] = {};
  float o_im[3][kRowsPerWarp] = {};

  for (int y0 = 0; y0 < R; y0 += kTile) {
    // U_k[u][y] = (are t_k, aim t_k)[u][y], u = warp + kWarps * j,
    // y = y0 + lane
    float u_re[kProducts][kRowsPerWarp] = {};
    float u_im[kProducts][kRowsPerWarp] = {};
    const int y = y0 + lane;

    for (int x0 = 0; x0 < R; x0 += kTile) {
      for (int i = warp; i < kTile; i += kWarps) {
        const int x = x0 + i;
        float t[kProducts] = {};
        if (x < R && y < R) {
          const size_t idx = static_cast<size_t>(x) * R + y;
          float s, c;
          sincosf(ph[idx], &s, &c);
          const float p = pupil[idx], pc = pcd[idx], ps = psd[idx];
          t[0] = c * pc;
          t[1] = s * ps;
          t[2] = s * pc;
          t[3] = c * ps;
          t[4] = p * c;
          t[5] = p * s;
        }
#pragma unroll
        for (int q = 0; q < kProducts; ++q) prod[q][i][lane] = t[q];
      }
      psf_tiles::load_operator_tile(at, are, aim, x0, R, w);
      __syncthreads();

#pragma unroll 4
      for (int k = 0; k < kTile; ++k) {
        float t[kProducts];
#pragma unroll
        for (int q = 0; q < kProducts; ++q) t[q] = prod[q][k][lane];
#pragma unroll
        for (int j = 0; j < kRowsPerWarp; ++j) {
          const float2 a = at[k][warp + kWarps * j];
#pragma unroll
          for (int q = 0; q < kProducts; ++q) {
            u_re[q][j] = fmaf(a.x, t[q], u_re[q][j]);
            u_im[q][j] = fmaf(a.y, t[q], u_im[q][j]);
          }
        }
      }
      __syncthreads();
    }

    // recombine on the rows, G = A f = (U_fr.re - U_fi.im, U_fr.im +
    // U_fi.re), and fold the strip into the output:
    // out_d[u][v] += sum_y G_d[u][y] A[v][y]
#pragma unroll
    for (int j = 0; j < kRowsPerWarp; ++j) {
      const int u = warp + kWarps * j;
      // -a: fr = t1 + t2, fi = t3 - t4
      buf[0][u][lane] = make_float2(
          u_re[0][j] + u_re[1][j] - u_im[2][j] + u_im[3][j],
          u_im[0][j] + u_im[1][j] + u_re[2][j] - u_re[3][j]);
      // 0: fr = t5, fi = t6
      buf[1][u][lane] = make_float2(u_re[4][j] - u_im[5][j],
                                    u_im[4][j] + u_re[5][j]);
      // +a: fr = t1 - t2, fi = t3 + t4
      buf[2][u][lane] = make_float2(
          u_re[0][j] - u_re[1][j] - u_im[2][j] - u_im[3][j],
          u_im[0][j] - u_im[1][j] + u_re[2][j] + u_re[3][j]);
    }
    psf_tiles::fold_strip<3>(buf, at, are, aim, y0, R, w, o_re, o_im);
  }
  psf_tiles::store_intensity<3>(
      o_re, o_im, out + static_cast<size_t>(blockIdx.x) * 3 * w * w, w,
      scale);
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` (a cudaStream_t) of CUDA device
// `device`.  Returns cudaGetLastError(): 0 when the launch was accepted.
int psf_div3_sym_thin(const float* phase, const float* pupil,
                      const float* pcd, const float* psd, const float* are,
                      const float* aim, float* out, int batch, int R, int w,
                      float scale, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch <= 0) return 0;
  if (R <= 0 || w <= 0 || w > kCrop) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  psf_div3_sym_thin_kernel<<<batch, dim3(kTile, kWarps), 0,
                             static_cast<cudaStream_t>(stream)>>>(
      phase, pupil, pcd, psd, are, aim, out, R, w, scale);
  return static_cast<int>(cudaGetLastError());
}

const char* psf_div3_sym_thin_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
