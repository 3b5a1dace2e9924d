// Tiled partial-DFT crop shared by kernels B2 (psf_div.cu), B3
// (psf_crop.cu) and B4 (psf_div3_sym_thin.cu): for G complex fields F_g
// (R x R) of one block's item it computes
//
//   out[g] = |A F_g A^T|^2 * scale,      A the (w, R) partial DFT, w <= 32,
//
// with the design of kernel B1 (psf_div3_sym.cu): one block of 8 warps,
// 32 x 32 field tiles through shared memory, the row intermediate
// G_g = A F_g and the w x w output kept in registers (16 G floats a
// thread), so nothing of size R^2 or w R leaves the SM.  The caller forms
// the fields pixel by pixel (cos/sin of its phase and its maps), which is
// where B2 and B3 differ; B4 runs its own first stage on real products
// and shares the operator-tile load, the second-stage fold and the store.
// Work per field: 4 w R^2 + 4 w^2 R FP32 FMAs (w padded to 32) against
// R^2 floats of phase read: FP32-issue and shared-memory-load bound, not
// memory bound.

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

// Called by every thread of a (kTile, kWarps) block.  `fields(idx, f)`
// writes the G field values (re, im) of the in-grid pixel idx = x R + y
// into f[0..G).  `out` is this item's (G, w, w) output.
template <int G, class Fields>
__device__ __forceinline__ void crop_intensity(const Fields& fields,
                                               const float* __restrict__ are,
                                               const float* __restrict__ aim,
                                               float* __restrict__ out,
                                               int R, int w, float scale) {
  // field tiles [g][x][y]; reused for the row intermediate [g][u][y]
  __shared__ float2 field[G][kTile][kTile];
  // operator tile transposed, [k][u] = A[u][k0 + k]; padded row
  __shared__ float2 at[kTile][kCrop + 1];

  const int lane = threadIdx.x;
  const int warp = threadIdx.y;

  // out_g[u][v] for u = warp + kWarps * j, v = lane
  float o_re[G][kRowsPerWarp] = {};
  float o_im[G][kRowsPerWarp] = {};

  for (int y0 = 0; y0 < R; y0 += kTile) {
    // G_g[u][y] for u = warp + kWarps * j, y = y0 + lane
    float g_re[G][kRowsPerWarp] = {};
    float g_im[G][kRowsPerWarp] = {};
    const int y = y0 + lane;

    for (int x0 = 0; x0 < R; x0 += kTile) {
      for (int i = warp; i < kTile; i += kWarps) {
        const int x = x0 + i;
        float2 f[G];
        if (x < R && y < R) {
          fields(static_cast<size_t>(x) * R + y, f);
        } else {
#pragma unroll
          for (int g = 0; g < G; ++g) f[g] = make_float2(0.f, 0.f);
        }
#pragma unroll
        for (int g = 0; g < G; ++g) field[g][i][lane] = f[g];
      }
      load_operator_tile(at, are, aim, x0, R, w);
      __syncthreads();

#pragma unroll 4
      for (int k = 0; k < kTile; ++k) {
        float2 f[G];
#pragma unroll
        for (int g = 0; g < G; ++g) f[g] = field[g][k][lane];
#pragma unroll
        for (int j = 0; j < kRowsPerWarp; ++j) {
          const float2 a = at[k][warp + kWarps * j];
#pragma unroll
          for (int g = 0; g < G; ++g) {
            g_re[g][j] = fmaf(a.x, f[g].x, fmaf(-a.y, f[g].y, g_re[g][j]));
            g_im[g][j] = fmaf(a.x, f[g].y, fmaf(a.y, f[g].x, g_im[g][j]));
          }
        }
      }
      __syncthreads();
    }

    // fold the strip into the output
#pragma unroll
    for (int j = 0; j < kRowsPerWarp; ++j) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        field[g][warp + kWarps * j][lane] =
            make_float2(g_re[g][j], g_im[g][j]);
      }
    }
    fold_strip<G>(field, at, are, aim, y0, R, w, o_re, o_im);
  }
  store_intensity<G>(o_re, o_im, out, w, scale);
}

}  // namespace psf_tiles
