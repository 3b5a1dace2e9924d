// Tiled partial-DFT helpers of kernel B4 (psf_div3_sym_thin.cu), on the
// FP32 units: for one block's item, with
//
//   out[g] = |A F_g A^T|^2 * scale,      A the (w, R) partial DFT, w <= 32,
//
// one block of 8 warps, 32 x 32 tiles through shared memory, the row
// intermediate and the w x w output kept in registers, so nothing of size
// R^2 or w R leaves the SM.  B4 runs its own first stage on real products
// and takes the operator-tile load, the second-stage fold and the store
// from here.  Work per field: 4 w R^2 + 4 w^2 R FP32 FMAs (w padded to
// 32) against R^2 floats of phase read: FP32-issue and shared-memory-load
// bound, not memory bound.  (B1, B2 and B3 run on the tensor cores:
// psf_mma.cuh.)

#pragma once

#include <cuda_runtime.h>

namespace psf_tiles {

constexpr int kTile = 32;            // field tile edge = warp width
constexpr int kWarps = 8;            // warps per block
constexpr int kCrop = 32;            // crop width padded to a warp
constexpr int kRowsPerWarp = kCrop / kWarps;
constexpr int kThreads = kTile * kWarps;

// The operator tile of columns c0 + [0, kTile), transposed:
// at[k][u] = A[u][c0 + k], zero where u >= w or c0 + k >= R.
__device__ __forceinline__ void load_operator_tile(
    float2 (*at)[kCrop + 1], const float* __restrict__ are,
    const float* __restrict__ aim, int c0, int R, int w) {
  const int lane = threadIdx.x;
  for (int u = threadIdx.y; u < kCrop; u += kWarps) {
    const int c = c0 + lane;
    const bool ok = u < w && c < R;
    const size_t idx = static_cast<size_t>(u) * R + c;
    at[lane][u] = ok ? make_float2(are[idx], aim[idx]) : make_float2(0.f, 0.f);
  }
}

// Second stage of one strip y0 + [0, kTile): with the G row
// intermediates rows[g][u][y - y0] written to shared memory by the
// caller, o_g[u][v] += sum_y rows_g[u][y] A[v][y] for u = warp + kWarps j,
// v = lane.  Synchronises before and after, so `rows` and `at` are free
// again on return.
template <int G>
__device__ __forceinline__ void fold_strip(
    float2 (*rows)[kTile][kTile], float2 (*at)[kCrop + 1],
    const float* __restrict__ are, const float* __restrict__ aim, int y0,
    int R, int w, float (&o_re)[G][kRowsPerWarp],
    float (&o_im)[G][kRowsPerWarp]) {
  const int warp = threadIdx.y;
  load_operator_tile(at, are, aim, y0, R, w);
  __syncthreads();

#pragma unroll 4
  for (int k = 0; k < kTile; ++k) {
    const float2 a = at[k][threadIdx.x];
#pragma unroll
    for (int j = 0; j < kRowsPerWarp; ++j) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float2 gv = rows[g][warp + kWarps * j][k];
        o_re[g][j] = fmaf(gv.x, a.x, fmaf(-gv.y, a.y, o_re[g][j]));
        o_im[g][j] = fmaf(gv.x, a.y, fmaf(gv.y, a.x, o_im[g][j]));
      }
    }
  }
  __syncthreads();
}

// out[g][u][v] = |o_g[u][v]|^2 * scale for u, v < w: this item's (G, w, w)
// output.
template <int G>
__device__ __forceinline__ void store_intensity(
    const float (&o_re)[G][kRowsPerWarp],
    const float (&o_im)[G][kRowsPerWarp], float* __restrict__ out, int w,
    float scale) {
  const int v = threadIdx.x;
#pragma unroll
  for (int j = 0; j < kRowsPerWarp; ++j) {
    const int u = threadIdx.y + kWarps * j;
    if (u < w && v < w) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        out[(g * w + u) * w + v] =
            (o_re[g][j] * o_re[g][j] + o_im[g][j] * o_im[g][j]) * scale;
      }
    }
  }
}

}  // namespace psf_tiles
