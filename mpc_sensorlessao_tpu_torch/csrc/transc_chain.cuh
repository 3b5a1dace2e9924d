// Chained elementwise transcendentals: the body that kernels B5a
// (transc_sincos.cu) and B5b (transc_cos.cu) share.
//
// For every element i of a float32 array it runs k links of a chain,
//
//   v = x[i];  repeat k times: v = Link()(v);  out[i] = v,
//
// with k a runtime argument, so that the two depths of the slope
// measurement (benchmarks/device_peaks.py) run the same code and nothing
// can be folded or hoisted: each link depends on the one before.
//
// Bound: operations.  At (4096, 4096) and k = 32 the chain does 32 links
// per element against 8 bytes moved per element; the links' instructions
// (full precision: no --use_fast_math, no MUFU) take far longer than the
// read and the write.  B5a's link is libdevice's sincosf; B5b's is its own
// cos link (transc_cos.cu), which does cosf's FP32 work in fewer issue
// slots.
//
// Design: one thread per element, kIlp independent elements per thread
// (kThreads apart, so neighbouring threads touch neighbouring addresses)
// so the FP32 pipe has independent instructions to issue while a link's
// dependent chain waits; a grid-stride loop over chunks of
// kThreads * kIlp elements, with the grid sized to the blocks the card
// holds at once.  Ragged ends are masked.  chain_kernel applies a link to
// one element at a time (B5a); group_chain_kernel hands a link all kIlp
// elements of a thread at once (B5b), so that it can take one range check
// for all of them.

#pragma once

#include <cuda_runtime.h>

namespace transc_chain {

constexpr int kThreads = 256;
constexpr int kIlp = 4;

template <class Link>
__global__ void __launch_bounds__(kThreads)
chain_kernel(const float* __restrict__ x, float* __restrict__ out,
             long long n, int k) {
  const long long chunk = static_cast<long long>(kThreads) * kIlp;
  for (long long base = blockIdx.x * chunk + threadIdx.x; base < n;
       base += gridDim.x * chunk) {
    float v[kIlp];
#pragma unroll
    for (int j = 0; j < kIlp; ++j) {
      const long long i = base + j * kThreads;
      v[j] = i < n ? x[i] : 0.0f;
    }
    for (int link = 0; link < k; ++link) {
#pragma unroll
      for (int j = 0; j < kIlp; ++j) v[j] = Link()(v[j]);
    }
#pragma unroll
    for (int j = 0; j < kIlp; ++j) {
      const long long i = base + j * kThreads;
      if (i < n) out[i] = v[j];
    }
  }
}

template <class GroupLink>
__global__ void __launch_bounds__(kThreads)
group_chain_kernel(const float* __restrict__ x, float* __restrict__ out,
                   long long n, int k) {
  const long long chunk = static_cast<long long>(kThreads) * kIlp;
  for (long long base = blockIdx.x * chunk + threadIdx.x; base < n;
       base += gridDim.x * chunk) {
    float v[kIlp];
#pragma unroll
    for (int j = 0; j < kIlp; ++j) {
      const long long i = base + j * kThreads;
      v[j] = i < n ? x[i] : 0.0f;
    }
    // counted down: the loop's test needs no reload of k
    for (int link = k; link > 0; --link) GroupLink()(v);
#pragma unroll
    for (int j = 0; j < kIlp; ++j) {
      const long long i = base + j * kThreads;
      if (i < n) out[i] = v[j];
    }
  }
}

// Launches `kernel` (chain_kernel or group_chain_kernel) over n elements
// on `stream` of `device`.  Returns a cudaError_t as int: 0 when the
// launch was accepted.
template <class Kernel>
int launch_kernel(Kernel kernel, const float* x, float* out, long long n,
                  int k, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n < 0 || k < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long chunks = (n + kThreads * kIlp - 1) / (kThreads * kIlp);
  const long long resident = static_cast<long long>(sms) * per_sm;
  const int blocks = static_cast<int>(chunks < resident ? chunks : resident);
  kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, out, n, k);
  return static_cast<int>(cudaGetLastError());
}

// chain_kernel<Link> over n elements (see launch_kernel).
template <class Link>
int launch(const float* x, float* out, long long n, int k, int device,
           void* stream) {
  return launch_kernel(chain_kernel<Link>, x, out, n, k, device, stream);
}

}  // namespace transc_chain
