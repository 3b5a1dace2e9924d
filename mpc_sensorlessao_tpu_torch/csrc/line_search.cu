// Kernel L1: the fastMPC line search's bank of step lengths.  For each
// scenario b the residual of the candidate state (U, X, nu) + t (dU, dX,
// dnu) is affine in t but for the box barrier,
//
//   rd_u(t) = a_u + t l_u + k (1/(u_max - U - t dU) - 1/(U + t dU - u_min))
//   rd_x(t) = a_x + t l_x,        rp(t) = a_p + t l_p,
//
// with the GEMMs of the residual's linear maps run once on the state and
// once on the direction (wrapper ops/newton_kkt.py `line_search_bank`).
// From one read of the scenario's eight vectors (a block of 128 threads a
// scenario) it forms, for t = 0 and each t of the bank {1, 1/2, ...,
// 1/2^15}, the residual norm sqrt(|rd_u|^2 + |rd_x|^2 + |rp|^2) and the
// strict box test u_min < U + t dU < u_max, then picks the first t whose
// norm is at most (1 - alpha t) times t = 0's and whose controls stay
// inside, else the smallest t.  One instance for float32, the main path's,
// and one for float64.
//
// Replaces no TPU kernel: the JAX package evaluates the bank with vmap
// over its residuals (mpc_sensorlessao_tpu/ops/newton_kkt.py
// line_search_step), and the port before this kernel built the 16
// candidate states as (B, 16, T, .) tensors and ran the six GEMMs of the
// residuals on them.
//
// Each element is evaluated as a + t l, never as the expanded quadratic
// |a|^2 + 2t a.l + t^2 |l|^2: at t = 1 the Newton step drives rp and rd_x
// to zero, which the quadratic would lose to cancellation.  The per-element
// arithmetic is the plain version's (`line_search_bank_ref`), written with
// round-to-nearest intrinsics (`Rn`) so that -O3 does not contract it into
// FMAs; only the order of the sums differs (a thread's elements in order,
// a shuffle tree, the warps in order), so the result is deterministic and
// uses no atomics.  The decision is one warp's: lane c tests candidate
// c - 1 and a ballot gives the first accepted.
//
// What bounds it (float32, B=2048, T=32, m=144, n=119), the larger of:
// - bytes: the eight vectors once, 134.7 KB a scenario, 275.8 MB in all:
//   0.092 ms at the card's measured 3.000 TB/s;
// - the MUFU: two IEEE reciprocals a control element and step
//   (__frcp_rn: a MUFU.RCP and its refinement), 3.2e8 in all on 16 lanes
//   an SM: 0.079 ms at 132 SMs and 1.98 GHz;
// - issue slots: the SASS issues 36.2 instructions a control element and
//   step (the reciprocals' range checks and refinement, the barrier, the
//   box test, the loop's loads and modulo) and 7.4 a state element and
//   step, 6.8e9 in all through the 4 x 32 slots an SM has a clock:
//   0.203 ms.  The instructions bind; chip_smoke.py reads them from the
//   SASS and times the kernel beside them (PERF.md section 6).
//
// Built with  nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// (ops/cuda_build.py) and called through ctypes (ops/newton_kkt.py).

#include <cuda_runtime.h>

namespace {

constexpr int kCandidates = 16;            // newton_kkt.LS_CANDIDATES
constexpr int kSteps = kCandidates + 1;    // t = 0, then the bank
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

// Round-to-nearest arithmetic, never contracted, in either precision.
template <typename F>
struct Rn;

template <>
struct Rn<float> {
  static __device__ float add(float a, float b) { return __fadd_rn(a, b); }
  static __device__ float sub(float a, float b) { return __fsub_rn(a, b); }
  static __device__ float mul(float a, float b) { return __fmul_rn(a, b); }
  static __device__ float rcp(float a) { return __frcp_rn(a); }
  static __device__ float fma(float a, float b, float c) {
    return __fmaf_rn(a, b, c);
  }
  static __device__ float sqrt(float a) { return __fsqrt_rn(a); }
};

template <>
struct Rn<double> {
  static __device__ double add(double a, double b) { return __dadd_rn(a, b); }
  static __device__ double sub(double a, double b) { return __dsub_rn(a, b); }
  static __device__ double mul(double a, double b) { return __dmul_rn(a, b); }
  static __device__ double rcp(double a) { return __drcp_rn(a); }
  static __device__ double fma(double a, double b, double c) {
    return __fma_rn(a, b, c);
  }
  static __device__ double sqrt(double a) { return __dsqrt_rn(a); }
};

// The eight (batch, T, .) vectors of the bank.
template <typename F>
struct Vectors {
  const F *U, *dU, *a_u, *l_u, *a_x, *l_x, *a_p, *l_p;
};

template <typename F>
__global__ void __launch_bounds__(kThreads)
line_search_kernel(Vectors<F> v, const F* __restrict__ u_min,
                   const F* __restrict__ u_max,
                   const F* __restrict__ barrier_k,
                   const F* __restrict__ ts, F alpha, int Tm, int m, int Tn,
                   F* __restrict__ norms, int* __restrict__ pick,
                   F* __restrict__ t_out) {
  using R = Rn<F>;
  __shared__ F partial[kWarps][kSteps];
  __shared__ unsigned outside_w[kWarps];
  const int b = blockIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t ou = static_cast<size_t>(b) * Tm;
  const size_t ox = static_cast<size_t>(b) * Tn;
  const F* __restrict__ U = v.U + ou;
  const F* __restrict__ dU = v.dU + ou;
  const F* __restrict__ a_u = v.a_u + ou;
  const F* __restrict__ l_u = v.l_u + ou;
  const F* __restrict__ a_x = v.a_x + ox;
  const F* __restrict__ l_x = v.l_x + ox;
  const F* __restrict__ a_p = v.a_p + ox;
  const F* __restrict__ l_p = v.l_p + ox;
  F t[kSteps];
  t[0] = F(0);
#pragma unroll
  for (int c = 0; c < kCandidates; ++c) t[c + 1] = __ldg(ts + c);
  const F k = __ldg(barrier_k);
  F acc[kSteps];
#pragma unroll
  for (int c = 0; c < kSteps; ++c) acc[c] = F(0);
  unsigned outside = 0;  // bit c: candidate c leaves the box somewhere

  // -- the controls: barrier, dual residual, box test
  for (int i = threadIdx.x; i < Tm; i += kThreads) {
    const int j = i % m;
    const F u0 = __ldg(U + i), du = __ldg(dU + i);
    const F a = __ldg(a_u + i), l = __ldg(l_u + i);
    const F lo = __ldg(u_min + j), hi = __ldg(u_max + j);
#pragma unroll
    for (int c = 0; c < kSteps; ++c) {
      const F u = R::add(u0, R::mul(t[c], du));
      const F bar = R::mul(k, R::sub(R::rcp(R::sub(hi, u)),
                                     R::rcp(R::sub(u, lo))));
      const F r = R::add(R::add(a, R::mul(t[c], l)), bar);
      acc[c] = R::fma(r, r, acc[c]);
      if (c > 0 && !(u > lo && u < hi)) outside |= 1u << (c - 1);
    }
  }
  // -- the states: dual and primal residuals, affine in t
  for (int i = threadIdx.x; i < Tn; i += kThreads) {
    const F ax = __ldg(a_x + i), lx = __ldg(l_x + i);
    const F ap = __ldg(a_p + i), lp = __ldg(l_p + i);
#pragma unroll
    for (int c = 0; c < kSteps; ++c) {
      const F rx = R::add(ax, R::mul(t[c], lx));
      const F rp = R::add(ap, R::mul(t[c], lp));
      acc[c] = R::fma(rp, rp, R::fma(rx, rx, acc[c]));
    }
  }

  // -- the block's sums and box tests, the warps in order
#pragma unroll
  for (int c = 0; c < kSteps; ++c) {
#pragma unroll
    for (int d = 16; d > 0; d /= 2) {
      acc[c] = R::add(acc[c], __shfl_down_sync(0xffffffffu, acc[c], d));
    }
  }
  outside = __reduce_or_sync(0xffffffffu, outside);
  if (lane == 0) {
#pragma unroll
    for (int c = 0; c < kSteps; ++c) partial[warp][c] = acc[c];
    outside_w[warp] = outside;
  }
  __syncthreads();

  // -- warp 0: lane c holds t = 0's norm (c = 0) or candidate c - 1's,
  // tests it and the first accepted one is picked, else the smallest step
  if (warp == 0) {
    F s = F(0);
    unsigned out = 0;
    for (int w = 0; w < kWarps; ++w) {
      if (lane < kSteps) s = R::add(s, partial[w][lane]);
      out |= outside_w[w];
    }
    const F norm = R::sqrt(s);
    if (lane < kSteps) norms[static_cast<size_t>(b) * kSteps + lane] = norm;
    const F base = __shfl_sync(0xffffffffu, norm, 0);
    const int c = lane - 1;
    bool ok = false;
    if (lane >= 1 && lane < kSteps && !((out >> c) & 1u)) {
      ok = norm <= R::mul(R::sub(F(1), R::mul(alpha, __ldg(ts + c))), base);
    }
    const unsigned oks = __ballot_sync(0xffffffffu, ok);
    if (lane == 0) {
      const int first = oks ? __ffs(oks) - 2 : kCandidates - 1;
      pick[b] = first;
      t_out[b] = __ldg(ts + first);
    }
  }
}

template <typename F>
cudaError_t launch(const void* const* vec, const void* u_min,
                   const void* u_max, const void* barrier_k, const void* ts,
                   double alpha, int batch, int T, int m, int n, void* norms,
                   int* pick, void* t, cudaStream_t stream) {
  const Vectors<F> v{
      static_cast<const F*>(vec[0]), static_cast<const F*>(vec[1]),
      static_cast<const F*>(vec[2]), static_cast<const F*>(vec[3]),
      static_cast<const F*>(vec[4]), static_cast<const F*>(vec[5]),
      static_cast<const F*>(vec[6]), static_cast<const F*>(vec[7])};
  line_search_kernel<F><<<batch, kThreads, 0, stream>>>(
      v, static_cast<const F*>(u_min), static_cast<const F*>(u_max),
      static_cast<const F*>(barrier_k), static_cast<const F*>(ts),
      static_cast<F>(alpha), T * m, m, T * n, static_cast<F*>(norms), pick,
      static_cast<F*>(t));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The line search of `batch` scenarios: U, dU, a_u, l_u (batch, T, m) and
// a_x, l_x, a_p, l_p (batch, T, n), the box u_min, u_max (m,), the
// barrier weight barrier_k and the bank ts (16,), all float64 where
// `is_double` is set, else float32, contiguous on CUDA device `device`,
// and the decrease factor alpha (rounded to float32 for a float32 call).
// Writes norms (batch, 17) in the same precision -- the residual norm at
// t = 0, then at each t of the bank --, the picked candidate's index pick
// (batch,) int32 and its step t (batch,), on `stream` (a cudaStream_t).
// Returns the first error: 0 when the launch was accepted.
int line_search(const void* U, const void* dU, const void* a_u,
                const void* l_u, const void* a_x, const void* l_x,
                const void* a_p, const void* l_p, const void* u_min,
                const void* u_max, const void* barrier_k, const void* ts,
                double alpha, int is_double, int batch, int T, int m, int n,
                void* norms, int* pick, void* t, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch <= 0) return 0;
  if (T <= 0 || m <= 0 || n <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const void* vec[8] = {U, dU, a_u, l_u, a_x, l_x, a_p, l_p};
  const auto s = static_cast<cudaStream_t>(stream);
  err = is_double ? launch<double>(vec, u_min, u_max, barrier_k, ts, alpha,
                                   batch, T, m, n, norms, pick, t, s)
                  : launch<float>(vec, u_min, u_max, barrier_k, ts, alpha,
                                  batch, T, m, n, norms, pick, t, s);
  return static_cast<int>(err);
}

const char* line_search_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
