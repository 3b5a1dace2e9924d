// Kernel T1: the decorrelated frozen-flow turbulence.  For each scenario b
// of a (B,) step tensor, the piston-removed pupil phase
//
//   raw[b]  = sum_l  bilinear window of screen l at step_px[l] * step[b]
//   out[b]  = (raw[b] - masked mean of raw[b]) * mask
//
// in one pass over the phase (wrapper ops/phase_screens.py
// `piston_removed_phase_at`).
//
// Replaces no TPU kernel: the JAX package samples the windows with vmap
// and dynamic_slice (mpc_sensorlessao_tpu/ops/phase_screens.py:253-290)
// and removes the piston in XLA; the port's plain version gathers the
// (B, L, R+1, R+1) windows, blends and sums them and removes the piston in
// eight PyTorch passes over multi-gigabyte temporaries.
//
// The arithmetic is the plain version's to the bit: the offsets
// step_px * step, the floor, the non-negative modulo by the period
// N = Ns - (R + 1), the tap weights (1-fy)(1-fx), (1-fy)fx, fy(1-fx), fy fx,
// the blend ((a00 w00 + a01 w01) + a10 w10) + a11 w11 and the layer sum
// (p0 + p1) + p2, each written with __fmul_rn / __fadd_rn so that -O3 does
// not contract them into FMAs.  Only the summation order of the masked
// mean differs; it is fixed (lanes down their columns, a shuffle tree, the
// warps in order, the cluster's CTAs in rank order), so the result is
// deterministic and uses no atomics.
//
// What bounds it: bytes.  At B=2048, R=512, L=3 one write of the phase
// (2.15 GB, 0.72 ms at the card's measured 3.000 TB/s) and, where L2 serves
// none of them, one read of each scenario's L windows of (R+1)^2 floats
// (6.47 GB, 2.16 ms): 0.72-2.87 ms.  The three padded screens (78.7 MB)
// exceed the 50 MB L2, so the upper end is the honest one.
//
// The design: one thread-block cluster of 8 CTAs (the portable size) per
// scenario.  The phase's rows go in blocks of 8, CTA r of the cluster
// taking blocks r, r + 8, r + 16, ..., so that every CTA holds a like share
// of the pupil (with one contiguous band a CTA, the edge bands hold under
// half the pupil pixels of the middle ones and their SMs wait at the
// cluster's barrier: 4.35 ms against 3.89 at B=2048, R=512 on an H100).
// A CTA keeps its blocks' raw phase in shared memory (128 KB at R=512),
// and their mask (32 KB), while it sums the layers into it: a warp takes a
// 32-column strip of a block and loads its 9 tap rows of all three layers
// together (54 loads in flight a lane), each tap about once, and none that
// no pupil pixel needs (~21% of them).  Its masked partial sum goes to the
// cluster through distributed shared memory; every CTA adds the 8 partials
// in rank order, subtracts the mean and writes its blocks once, with
// 16-byte stores where R is a multiple of 8.  Traffic: the windows' pupil
// taps read about once and the phase written once.  The clusters take the
// scenarios in the order of their steps (the wrapper's argsort), so that
// the clusters in flight read overlapping windows and share them in L2
// (3.88 -> 3.56 ms).
// Where the blocks do not fit in shared memory (R above ~600) they are
// kept in the output instead, read back from L2.  Measured: 3.56 ms at
// B=2048, R=512, L=3 on an H100 (81% of the bound's upper end; PERF.md).
//
// Built with  nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// (ops/cuda_build.py) and called through ctypes (ops/phase_screens.py).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;           // CTAs a scenario
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 8;              // rows of a block; a CTA takes every
                                      // kCluster-th block of the phase
constexpr int kGroup = 3;             // layers whose taps load together
constexpr int kStaticReserve = 1024;  // static shared memory, rounded up

// One layer's window on the screen and its tap weights, in float32 as the
// plain version forms them (phase_screens._bilinear_windows, _weights).
struct Window {
  const float* origin;                // tap (0, 0) of the window
  float w00, w01, w10, w11;
};

__device__ __forceinline__ Window window(const float* screens,
                                         const float* step_px, float s,
                                         int l, int Ns, int N) {
  const float oy = __fmul_rn(step_px[2 * l], s);
  const float ox = __fmul_rn(step_px[2 * l + 1], s);
  const float iy = floorf(oy), ix = floorf(ox);
  const float fy = __fsub_rn(oy, iy), fx = __fsub_rn(ox, ix);
  long long r0 = static_cast<long long>(iy) % N;
  long long c0 = static_cast<long long>(ix) % N;
  if (r0 < 0) r0 += N;
  if (c0 < 0) c0 += N;
  const float gy = __fsub_rn(1.0f, fy), gx = __fsub_rn(1.0f, fx);
  Window w;
  w.origin = screens + static_cast<size_t>(l) * Ns * Ns + r0 * Ns + c0;
  w.w00 = __fmul_rn(gy, gx);
  w.w01 = __fmul_rn(gy, fx);
  w.w10 = __fmul_rn(fy, gx);
  w.w11 = __fmul_rn(fy, fx);
  return w;
}

__device__ __forceinline__ float blend(const Window& w, float a, float b,
                                       float c, float d) {
  return __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(w.w00, a),
                                       __fmul_rn(w.w01, b)),
                             __fmul_rn(w.w10, c)),
                   __fmul_rn(w.w11, d));
}

// The n <= kGroup layers w of one block's column c: rows [k0, k0 + rows)
// of the phase, kept at band[j * R + c] with their mask at mask[j * R + c].
// At every pupil pixel it sums the layers' blends in order onto the band
// (the group of layer 0 stores the sum) and, in the last group, adds the
// pixel's raw phase to acc.  The block's kRows + 1 tap rows of every layer
// are loaded together, each once, and only where a pupil pixel needs them.
__device__ __forceinline__ void block(const Window (&w)[kGroup], int n,
                                      float* band, const unsigned char* mask,
                                      int k0, int rows, int c, int R, int Ns,
                                      bool first, bool last, float& acc) {
  bool m[kRows];
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    m[j] = c < R && j < rows && mask[j * R + c];
  }
  float a[kGroup][kRows + 1], b[kGroup][kRows + 1];
#pragma unroll
  for (int g = 0; g < kGroup; ++g) {
    const float* p = w[g].origin + static_cast<size_t>(k0) * Ns + c;
#pragma unroll
    for (int j = 0; j <= kRows; ++j) {
      const bool need = g < n && ((j < kRows && m[j]) || (j > 0 && m[j - 1]));
      a[g][j] = need ? __ldg(p + j * Ns) : 0.0f;
      b[g][j] = need ? __ldg(p + j * Ns + 1) : 0.0f;
    }
  }
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    if (!m[j]) continue;
    float* dst = band + j * R + c;
    float v = blend(w[0], a[0][j], b[0][j], a[0][j + 1], b[0][j + 1]);
    if (!first) v = __fadd_rn(*dst, v);
#pragma unroll
    for (int g = 1; g < kGroup; ++g) {
      if (g < n) {
        v = __fadd_rn(v, blend(w[g], a[g][j], b[g][j], a[g][j + 1],
                               b[g][j + 1]));
      }
    }
    *dst = v;
    if (last) acc = __fadd_rn(acc, v);
  }
}

__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 1)
phase_window_kernel(const float* __restrict__ screens,
                    const float* __restrict__ step_px,
                    const float* __restrict__ step,
                    const unsigned char* __restrict__ mask,
                    const float* __restrict__ npix,
                    const long long* __restrict__ order,
                    float* __restrict__ out, int L, int Ns, int R,
                    int blocks, int on_chip) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float warp_sum[kWarps];
  __shared__ float cta_sum;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = static_cast<int>(order[blockIdx.x / kCluster]);
  const int N = Ns - (R + 1);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // this CTA's blocks: i -> the phase's block rank + i * kCluster, whose
  // rows start at first_row(i); kept at i * kRows * R in shared memory
  // where they fit, else in place in the output
  const int nblocks = (R + kRows - 1) / kRows;
  const int mine = max(0, (nblocks - rank + kCluster - 1) / kCluster);
  const int block_elems = kRows * R;
  auto first_row = [&](int i) { return (rank + i * kCluster) * kRows; };
  float* const phase = out + static_cast<size_t>(b) * R * R;
  float* const stash = on_chip ? smem : nullptr;
  unsigned char* const smask = reinterpret_cast<unsigned char*>(
      smem + static_cast<size_t>(blocks) * block_elems);
  auto band = [&](int i) {
    return on_chip ? stash + static_cast<size_t>(i) * block_elems
                   : phase + static_cast<size_t>(first_row(i)) * R;
  };
  auto band_mask = [&](int i) -> const unsigned char* {
    return on_chip ? smask + static_cast<size_t>(i) * block_elems
                   : mask + static_cast<size_t>(first_row(i)) * R;
  };
  // whole blocks: the copies below go 16 bytes at a time
  const bool whole = R % kRows == 0;
  if (on_chip) {
    if (whole) {
      const int per = block_elems / 16;
#pragma unroll 4
      for (int i = threadIdx.x; i < mine * per; i += kThreads) {
        reinterpret_cast<int4*>(smask)[i] = reinterpret_cast<const int4*>(
            mask + static_cast<size_t>(first_row(i / per)) * R)[i % per];
      }
    } else {
      for (int i = threadIdx.x; i < mine * block_elems; i += kThreads) {
        const int row = first_row(i / block_elems) + i % block_elems / R;
        if (row < R) smask[i] = mask[static_cast<size_t>(row) * R + i % R];
      }
    }
    __syncthreads();
  }

  // -- the layers' sum into the blocks, and the masked partial sum
  const float s = step[b];
  const int chunks = (R + 31) / 32;
  float acc = 0.0f;
  for (int l0 = 0; l0 < L; l0 += kGroup) {
    const int n = min(kGroup, L - l0);
    Window w[kGroup];
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      w[g] = window(screens, step_px, s, g < n ? l0 + g : l0, Ns, N);
    }
    for (int item = warp; item < mine * chunks; item += kWarps) {
      const int i = item / chunks;
      const int k0 = first_row(i);
      block(w, n, band(i), band_mask(i), k0, min(kRows, R - k0),
            item % chunks * 32 + lane, R, Ns, l0 == 0, l0 + n == L, acc);
    }
  }
#pragma unroll
  for (int d = 16; d > 0; d /= 2) {
    acc = __fadd_rn(acc, __shfl_down_sync(0xffffffffu, acc, d));
  }
  if (lane == 0) warp_sum[warp] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = 0.0f;
    for (int i = 0; i < kWarps; ++i) t = __fadd_rn(t, warp_sum[i]);
    cta_sum = t;
  }

  // -- the cluster's partial sums, added in rank order by every thread
  cluster.sync();
  float total = 0.0f;
  for (int i = 0; i < kCluster; ++i) {
    total = __fadd_rn(total, *cluster.map_shared_rank(&cta_sum, i));
  }
  const float mean = __fdiv_rn(total, *npix);
  // done with the other CTAs' shared memory: they may exit after this
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");

  // -- (raw - mean) * mask, written once
  if (whole) {
    const int per = block_elems / 4;
#pragma unroll 4
    for (int i = threadIdx.x; i < mine * per; i += kThreads) {
      const int blk = i / per, j = i % per;
      const float4 v = reinterpret_cast<const float4*>(band(blk))[j];
      const uchar4 m = reinterpret_cast<const uchar4*>(band_mask(blk))[j];
      reinterpret_cast<float4*>(phase + static_cast<size_t>(first_row(blk))
                                * R)[j] =
          make_float4(m.x ? __fsub_rn(v.x, mean) : 0.0f,
                      m.y ? __fsub_rn(v.y, mean) : 0.0f,
                      m.z ? __fsub_rn(v.z, mean) : 0.0f,
                      m.w ? __fsub_rn(v.w, mean) : 0.0f);
    }
  } else {
    for (int i = threadIdx.x; i < mine * block_elems; i += kThreads) {
      const int blk = i / block_elems, j = i % block_elems;
      const int row = first_row(blk) + j / R;
      if (row < R) {
        phase[static_cast<size_t>(row) * R + j % R] =
            band_mask(blk)[j] ? __fsub_rn(band(blk)[j], mean) : 0.0f;
      }
    }
  }
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

}  // namespace

extern "C" {

// out (B, R, R) float32 <- the piston-removed phase of screens (L, Ns, Ns)
// float32 at the per-scenario steps step (B,) float32, with the wind steps
// step_px (L, 2) float32, the pupil mask (R, R) bool (one byte a pixel)
// and its pixel count npix (one float32, on the device), on `stream` (a
// cudaStream_t) of CUDA device `device`.  The clusters take the scenarios
// in the order `order` (B,) int64, a permutation: scenarios in the order
// of their steps have overlapping windows, which the clusters in flight
// then read from L2.  Returns the first error: 0 when the launch was
// accepted.
int phase_window(const float* screens, const float* step_px,
                 const float* step, const unsigned char* mask,
                 const float* npix, const long long* order, float* out,
                 int batch, int L, int Ns, int R, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch <= 0) return 0;
  if (L <= 0 || R <= 0 || Ns <= R + 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = ((R + kRows - 1) / kRows + kCluster - 1) / kCluster;
  size_t bytes =
      static_cast<size_t>(blocks) * kRows * R * (sizeof(float) + 1);
  const int on_chip = bytes + kStaticReserve <= static_cast<size_t>(optin);
  if (!on_chip) bytes = 0;
  err = cudaFuncSetAttribute(phase_window_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  phase_window_kernel<<<kCluster * batch, kThreads, bytes,
                        static_cast<cudaStream_t>(stream)>>>(
      screens, step_px, step, mask, npix, order, out, L, Ns, R, blocks,
      on_chip);
  return static_cast<int>(cudaGetLastError());
}

const char* phase_window_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
