// Kernel B1: fused diversity-PSF measure for the symmetric triple (-a, 0, +a).
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
// Work per scenario (w padded to 32): first stage G_d = A F_d, about
// 3 w R^2 complex multiply-adds (4 FMAs each); second stage G_d A^T,
// 3 w^2 R (w/R of the first: 25% at R=128, 6% at R=512); plus R^2
// sincosf.  At R=128 that is 7.9 M FMAs per scenario against 64 KB of
// phase read -- ~120 FMAs per byte, so the kernel is bound by FP32 issue
// and shared-memory loads, not by device memory.  Everything is float32:
// sincosf (not __sincosf) and no --use_fast_math, because the diversity
// alone reaches +-3 rad.
//
// Design (a simple one that is right; tensor cores, TMA and bf16 operands
// are later work):
//   * one block of 8 warps per scenario, looping over the field in 32x32
//     tiles, so any R (up to 512 and beyond) works -- the R x R field
//     never has to fit in shared memory;
//   * for each 32-column strip y0.. the block walks the rows x0.. in
//     tiles: it forms the three field tiles in shared memory (computing
//     cos/sin as it goes) and accumulates the row intermediate
//     G_d[u, y] = sum_x A[u, x] F_d[x, y] in registers (lane = y,
//     warp = 4 crop rows u);
//   * when the strip is done, G goes to shared memory and is folded at
//     once into the 3 x w x w complex output, which each thread keeps in
//     registers (lane = v, warp = 4 crop rows u) for the whole scenario.
//   Neither the (B, 3, R, R) fields nor the (B, 3, w, R) row intermediate
//   ever reaches device memory -- what the TPU kernel kept in VMEM.
//
// Built with  nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// (ops/cuda_build.py) and called through ctypes (ops/psf_kernels.py).

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;            // field tile edge = warp width
constexpr int kWarps = 8;            // warps per block
constexpr int kCrop = 32;            // crop width padded to a warp
constexpr int kRowsPerWarp = kCrop / kWarps;

__global__ void __launch_bounds__(kTile * kWarps)
psf_div3_sym_kernel(const float* __restrict__ phase,  // (B, R, R)
                    const float* __restrict__ pupil,  // (R, R)
                    const float* __restrict__ pcd,    // (R, R)
                    const float* __restrict__ psd,    // (R, R)
                    const float* __restrict__ are,    // (w, R)
                    const float* __restrict__ aim,    // (w, R)
                    float* __restrict__ out,          // (B, 3, w, w)
                    int R, int w, float scale) {
  // field tiles [d][x][y] as (re, im); reused for G [d][u][y]
  __shared__ float2 field[3][kTile][kTile];
  // operator tile transposed, [k][u] = A[u][k0 + k]; padded row
  __shared__ float2 at[kTile][kCrop + 1];

  const int lane = threadIdx.x;
  const int warp = threadIdx.y;
  const float* ph = phase + static_cast<size_t>(blockIdx.x) * R * R;

  // out_d[u][v] for u = warp + kWarps * j, v = lane
  float o_re[3][kRowsPerWarp] = {};
  float o_im[3][kRowsPerWarp] = {};

  for (int y0 = 0; y0 < R; y0 += kTile) {
    // G_d[u][y] for u = warp + kWarps * j, y = y0 + lane
    float g_re[3][kRowsPerWarp] = {};
    float g_im[3][kRowsPerWarp] = {};
    const int y = y0 + lane;

    for (int x0 = 0; x0 < R; x0 += kTile) {
      for (int i = warp; i < kTile; i += kWarps) {
        const int x = x0 + i;
        float2 fm = make_float2(0.f, 0.f), f0 = fm, fp = fm;
        if (x < R && y < R) {
          const size_t idx = static_cast<size_t>(x) * R + y;
          float s, c;
          sincosf(ph[idx], &s, &c);
          const float p = pupil[idx], pc = pcd[idx], ps = psd[idx];
          const float t1 = c * pc, t2 = s * ps, t3 = s * pc, t4 = c * ps;
          fm = make_float2(t1 + t2, t3 - t4);
          f0 = make_float2(p * c, p * s);
          fp = make_float2(t1 - t2, t3 + t4);
        }
        field[0][i][lane] = fm;
        field[1][i][lane] = f0;
        field[2][i][lane] = fp;
      }
      for (int u = warp; u < kCrop; u += kWarps) {
        const int x = x0 + lane;
        const bool ok = u < w && x < R;
        const size_t idx = static_cast<size_t>(u) * R + x;
        at[lane][u] = ok ? make_float2(are[idx], aim[idx])
                         : make_float2(0.f, 0.f);
      }
      __syncthreads();

#pragma unroll 4
      for (int k = 0; k < kTile; ++k) {
        const float2 f[3] = {field[0][k][lane], field[1][k][lane],
                             field[2][k][lane]};
#pragma unroll
        for (int j = 0; j < kRowsPerWarp; ++j) {
          const float2 a = at[k][warp + kWarps * j];
#pragma unroll
          for (int d = 0; d < 3; ++d) {
            g_re[d][j] = fmaf(a.x, f[d].x, fmaf(-a.y, f[d].y, g_re[d][j]));
            g_im[d][j] = fmaf(a.x, f[d].y, fmaf(a.y, f[d].x, g_im[d][j]));
          }
        }
      }
      __syncthreads();
    }

    // fold the strip into the output: out_d[u][v] += sum_y G_d[u][y] A[v][y]
#pragma unroll
    for (int j = 0; j < kRowsPerWarp; ++j) {
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        field[d][warp + kWarps * j][lane] =
            make_float2(g_re[d][j], g_im[d][j]);
      }
    }
    for (int v = warp; v < kCrop; v += kWarps) {
      const bool ok = v < w && y < R;
      const size_t idx = static_cast<size_t>(v) * R + y;
      at[lane][v] = ok ? make_float2(are[idx], aim[idx])
                       : make_float2(0.f, 0.f);
    }
    __syncthreads();

#pragma unroll 4
    for (int k = 0; k < kTile; ++k) {
      const float2 a = at[k][lane];
#pragma unroll
      for (int j = 0; j < kRowsPerWarp; ++j) {
#pragma unroll
        for (int d = 0; d < 3; ++d) {
          const float2 g = field[d][warp + kWarps * j][k];
          o_re[d][j] = fmaf(g.x, a.x, fmaf(-g.y, a.y, o_re[d][j]));
          o_im[d][j] = fmaf(g.x, a.y, fmaf(g.y, a.x, o_im[d][j]));
        }
      }
    }
    __syncthreads();
  }

  const int v = lane;
  float* o = out + static_cast<size_t>(blockIdx.x) * 3 * w * w;
#pragma unroll
  for (int j = 0; j < kRowsPerWarp; ++j) {
    const int u = warp + kWarps * j;
    if (u < w && v < w) {
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        o[(d * w + u) * w + v] =
            (o_re[d][j] * o_re[d][j] + o_im[d][j] * o_im[d][j]) * scale;
      }
    }
  }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` (a cudaStream_t) of CUDA device
// `device`.  Returns cudaGetLastError(): 0 when the launch was accepted.
int psf_div3_sym(const float* phase, const float* pupil, const float* pcd,
                 const float* psd, const float* are, const float* aim,
                 float* out, int batch, int R, int w, float scale,
                 int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch <= 0) return 0;
  if (R <= 0 || w <= 0 || w > kCrop) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  psf_div3_sym_kernel<<<batch, dim3(kTile, kWarps), 0,
                        static_cast<cudaStream_t>(stream)>>>(
      phase, pupil, pcd, psd, are, aim, out, R, w, scale);
  return static_cast<int>(cudaGetLastError());
}

const char* psf_div3_sym_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
