// The tensor-core DFT engine of kernel B4 (psf_div3_sym_thin.cu), both
// its float32 and its bf16 entry; B1 (psf_div3_sym.cu), B2 (psf_div.cu)
// and B3 (psf_crop.cu) ran on it until all their entries moved to
// psf_wgmma.cuh.  B4 stays on it as the yardstick of their old design.
// For the three complex fields F_d (R x R) of one block it computes
//
//   out[d] = |A F_d A^T|^2 * scale,      A the (w, R) partial DFT, any w,
//
// with both DFT stages on the tensor cores at float32 accuracy (3xTF32).
// How the three fields are formed from the maps of a tile is a
// field-forming policy's (below; psf_sym3.cuh's); the DFT stages, the
// tiling and the prefetch are this header's.
//
// What bounds it.  Nearly all the work is the two complex matrix products
// (stage 1 G_d = A F_d, stage 2 G_d A^T): 62.0 GFLOP per 3 x 4096 fields
// at R=128.  They run as mma.sync.m16n8k8 TF32 products.  One TF32 pass
// keeps 11 significant bits and errs by 1e-4 of the peak on B1's function,
// 200x the float32 plain version (tests/test_torch_ops.py emulates both),
// so every float32 operand x is split into hi = rna_tf32(x) and lo =
// rna_tf32(x - hi), and each product is lo*hi + hi*lo + hi*hi (3xTF32),
// as close to the exact result as the float32 plain version.  That
// triples the tensor-core work, so a kernel is bound first by TF32
// tensor-core issue for the 3 passes (94.4 M mma per 3 x 4096 fields at
// R=128), then by the shared-memory fragment loads that feed them and the
// hi/lo splits.
//
// Design:
//   * one block of 8 warps per three fields (4096 blocks at the main
//     path's B, two resident per SM), walking the R x R grid in 32-column
//     strips; any R works (a field never has to fit in shared memory);
//   * shared memory holds float32 (re, im) pairs, at a row stride that
//     keeps the 8-byte fragment loads free of bank conflicts; each value
//     is split into hi/lo in registers as its fragment is loaded, which
//     moves half the bytes of storing the split and frees the
//     field-forming step of it;
//   * stage 1 per strip and 32-row K tile: the policy forms the three
//     field tiles from the tile's maps, which cp.async brought into shared
//     memory during the previous step's products; each warp accumulates a
//     16 x 24 tile of G (32 crop rows x 3 fields x 32 columns, re and im:
//     24 floats a thread) with 12 mma per k8 step and 8-column tile:
//     Gre = Are Fre + Aim (-Fim), Gim = Aim Fre + Are Fim, 3 passes each;
//   * stage 2 per strip: the strip's G goes to shared memory, and each
//     warp folds it into its 16 x 8 tile of the (3, w, w) complex output,
//     O_d += G_d A_strip^T, which stays in registers for the whole block
//     (24 floats a thread).  The strip's products accumulate in the (then
//     free) G registers and are added to O in float32: the tensor cores'
//     accumulation is not IEEE round to nearest, and one chain over all
//     strips left 1.6x the error against the plain version at R=512
//     (5.9e-6 against 3.8e-6 of the peak in chip_smoke.py's kernel check,
//     NVIDIA H100 80GB HBM3, 700 W);
//   * a small kernel (operator_tiles) lays the operator out once per call
//     as 32 x 32 tiles of (re, im), in bands of 32 rows, zero-padded to a
//     whole number of bands and tiles; they stream from L2 into a
//     double-buffered shared-memory ring with cp.async, the next tile
//     arriving while the current one is used.  The stream is, per strip,
//     the R/32 tiles of stage 1, then the strip's own tile for stage 2;
//   * a crop wider than 32 px is cut into nb = ceil(w / 32) bands of 32
//     rows and columns, and the kernel is launched once per (row band,
//     column band) pair of the output, the pair's operator bands and
//     offsets a kernel argument (Band), read from the constant bank: as a
//     value the loops kept (the pair from a third grid axis) it spilled
//     a kernel at 128 registers.  Each block forms its fields, runs stage 1 on
//     its row band of A and stage 2 on its column band.  A w <= 32 crop
//     (nb = 1) is one launch; a wider one forms each field nb^2 times and
//     runs stage 1 nb times over (stage 2 once), the price of keeping each
//     block's O one 32 x 32 tile: all nb column bands of O would not fit
//     beside the loops at 128 registers;
//   * the K loops are unrolled only as far as the 128 registers a thread
//     (two blocks per SM) hold without spilling.
//   Neither the (3, R, R) fields nor the (3, w, R) row intermediate ever
//   reaches device memory -- what the TPU kernels kept in VMEM.
//
// Fragment layouts (PTX ISA, mma.m16n8k8 .tf32; g = lane / 4, t = lane % 4):
//   A (16 x 8, row): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
//   B (8 x 8, col):  b0 (t, g), b1 (t + 4, g)
//   C (16 x 8):      c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)
//
// Precision::kBf16, the JAX kernels' compute_dtype="bfloat16" branch:
// every operand of both DFT stages rounded to bf16 (round to nearest
// even, as torch and XLA round), the sums in float32 -- one pass of
// mma.sync.m16n8k16 .bf16 with f32 accumulation, no hi/lo split.  Shared
// memory holds float32 as for 3xTF32, and each value is rounded as its
// fragment loads: the operator, the field tiles the policy formed and the
// strip's G (stage 1 is complete by then), each rounded once, so the
// stages read what the JAX kernel reads.  Fragment layouts (PTX ISA,
// mma.m16n8k16 .bf16; two bf16 a register, the first in the low half):
//   A (16 x 16, row): a0 a1 (g, 2t 2t+1), a2 a3 (g + 8, 2t 2t+1),
//                     a4 a5 (g, 2t+8 2t+9), a6 a7 (g + 8, 2t+8 2t+9)
//   B (16 x 8, col):  b0 b1 (2t 2t+1, g), b2 b3 (2t+8 2t+9, g)
//   C (16 x 8):       as for m16n8k8.
// A product sums over k in any order, so the fragments' k = 2t + e + 8h
// (e, h in {0, 1}) read the tile's column (A) or row (B) t + 4e + 8h:
// the k8 fragments' 8-byte, conflict-free loads of two k8 steps, paired.
// The precision-specific parts -- the K depth kK, the fragment type Frag
// and the complex parts' mma -- are one trait each, so each DFT stage
// has one loop body for both precisions.
// The G a warp holds in stage 1 is one column tile of all three fields,
// so that the policy can recombine them in registers before G is
// stored.
// The result O waits in shared memory between strips (kOSlots floats a
// thread, read and written by that thread alone): in registers it
// spilled beside the bf16 loops' operands at 128 registers.
//
// A field-forming policy F is a small struct, built by its kernel from
// the kernel's arguments, with
//   static constexpr int kMaps;       (R, R) maps a K tile loads (held in
//                                     registers: 4 fit at 128)
//   const float* map(int a, int R);   map a's plane for this block
//   float* out(int w);                the first field's (w, w) output;
//                                     field d's follows at d w^2
//   void form(const float* m, float2 (&f)[kFields]);
//                                     the three fields at one pixel, where
//                                     m[a * kTile * kTile] is map a's value
//   void recombine(float (&g)[kFields][4]);
//                                     in either precision: the float32
//                                     stage-1 rows of the formed fields at
//                                     4 pixels -> those of the fields
//                                     measured
// (all const __device__ members).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace psf_mma {

constexpr int kTile = 32;           // field tile edge, K tile depth
constexpr int kWarps = 8;           // warps per block
constexpr int kThreads = 32 * kWarps;
constexpr int kCrop = 32;           // crop band: two m16 tiles
constexpr int kFields = 3;          // fields per block
constexpr int kTilePixels = kTile * kTile;
// row stride, in (re, im) pairs, of the shared-memory tiles: A fragments
// read rows g, B fragments rows t, both free of bank conflicts for 8-byte
// loads at a stride of 4 mod 16
constexpr int kStride = kTile + 4;
constexpr int kFieldPairs = kFields * kTile * kStride;  // field, then G
constexpr int kOpPairs = kCrop * kStride;

// Operand precision of the DFT stages: float32 accuracy (3xTF32), or the
// bf16 operands of the JAX kernels' compute_dtype="bfloat16" branch
enum class Precision { kTf32x3, kBf16 };

// Crop bands of a w-px crop.
constexpr int bands(int w) { return (w + kCrop - 1) / kCrop; }

// The band pair a launch computes: the operator tiles of its row band of
// A (stage 1) and of its column band (stage 2), and where its 32 x 32
// part of each crop starts.
struct Band {
  const float2* rows;   // operator tiles of A's rows u0.. (operator_tiles)
  const float2* cols;   // operator tiles of A's rows v0..
  int u0, v0;           // the pair's first crop row and column
};

// float32 slots a thread holds of the block's result O: re and im of its
// 4 elements of each field's 16 x 8 tile
constexpr int kOSlots = 2 * kFields * 4;

// Dynamic shared memory of a block whose K tiles load `maps` maps; kBf16
// also keeps O there, kOSlots floats a thread.
constexpr size_t smem_bytes(int maps, Precision p = Precision::kTf32x3) {
  return (kFieldPairs + 2 * kOpPairs) * sizeof(float2) +
         maps * kTilePixels * sizeof(float) +
         (p == Precision::kBf16 ? kOSlots * kThreads * sizeof(float) : 0);
}

// one mma.sync.m16n8k8 TF32 product: c += a b
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// one mma.sync.m16n8k16 bf16 product, f32 accumulation: c += a b
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// TF32 round to nearest, ties away from zero (cvt.rna.tf32.f32): add half
// of the 13 dropped bits to the magnitude, then drop them
__device__ __forceinline__ uint32_t tf32_rna(uint32_t x) {
  return (x + 0x1000u) & 0xFFFFE000u;
}

// x = hi + lo to float32 accuracy, hi and lo TF32
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(__float_as_uint(x));
  lo = tf32_rna(__float_as_uint(x - __uint_as_float(hi)));
}

// lo and hi rounded to bf16 (to nearest, ties to even), lo in the low half
__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// The operands of N fragment registers (4: A, 2: B) at precision P: the
// re and im Part of complex values v, kValues of them a register, given
// in register order; neg_im() is -im.
template <Precision P, int N>
struct Frag;

// 3xTF32: one value a register, as its TF32 (hi, lo) halves
template <int N>
struct Frag<Precision::kTf32x3, N> {
  static constexpr int kValues = 1;
  struct Part {
    uint32_t hi[N], lo[N];
  };
  Part re, im;
  __device__ __forceinline__ explicit Frag(const float2 (&v)[N]) {
#pragma unroll
    for (int r = 0; r < N; ++r) {
      split(v[r].x, re.hi[r], re.lo[r]);
      split(v[r].y, im.hi[r], im.lo[r]);
    }
  }
  __device__ __forceinline__ Part neg_im() const {
    Part p;
#pragma unroll
    for (int r = 0; r < N; ++r) {
      p.hi[r] = im.hi[r] ^ 0x80000000u;
      p.lo[r] = im.lo[r] ^ 0x80000000u;
    }
    return p;
  }
};

// bf16: values 2r and 2r + 1 packed in register r
template <int N>
struct Frag<Precision::kBf16, N> {
  static constexpr int kValues = 2;
  struct Part {
    uint32_t v[N];
  };
  Part re, im;
  __device__ __forceinline__ explicit Frag(const float2 (&v)[2 * N]) {
#pragma unroll
    for (int r = 0; r < N; ++r) {
      re.v[r] = bf16x2(v[2 * r].x, v[2 * r + 1].x);
      im.v[r] = bf16x2(v[2 * r].y, v[2 * r + 1].y);
    }
  }
  // both halves' sign bits flipped
  __device__ __forceinline__ Part neg_im() const {
    Part p;
#pragma unroll
    for (int r = 0; r < N; ++r) p.v[r] = im.v[r] ^ 0x80008000u;
    return p;
  }
};

// c += a b in float32 accuracy: lo*hi + hi*lo + hi*hi
__device__ __forceinline__ void mma(
    float (&c)[4], const Frag<Precision::kTf32x3, 4>::Part& a,
    const Frag<Precision::kTf32x3, 2>::Part& b) {
  mma_tf32(c, a.lo, b.hi);
  mma_tf32(c, a.hi, b.lo);
  mma_tf32(c, a.hi, b.hi);
}

// c += a b, bf16 operands, f32 accumulation
__device__ __forceinline__ void mma(float (&c)[4],
                                    const Frag<Precision::kBf16, 4>::Part& a,
                                    const Frag<Precision::kBf16, 2>::Part& b) {
  mma_bf16(c, a.v, b.v);
}

// K depth of one mma at precision P
template <Precision P>
constexpr int kK = P == Precision::kBf16 ? 16 : 8;

// The A fragment (16 x kK) of the block whose element (g, t) is at p, row
// stride kStride: value e of register r at row g + 8 (r % 2), column
// t + 4 (e + kValues (r / 2)) (see the fragment layouts above)
template <Precision P>
__device__ __forceinline__ Frag<P, 4> a_frag(const float2* p) {
  constexpr int V = Frag<P, 4>::kValues;
  float2 v[4 * V];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int e = 0; e < V; ++e) {
      v[V * r + e] = p[(r % 2) * 8 * kStride + 4 * (e + V * (r / 2))];
    }
  }
  return Frag<P, 4>(v);
}

// The B fragment (kK x 8) whose element (t, g) is at p, consecutive k
// `k_stride` apart: value e of register r at k = t + 4 (e + kValues r)
template <Precision P>
__device__ __forceinline__ Frag<P, 2> b_frag(const float2* p, int k_stride) {
  constexpr int V = Frag<P, 2>::kValues;
  float2 v[2 * V];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int e = 0; e < V; ++e) v[V * r + e] = p[4 * (e + V * r) * k_stride];
  }
  return Frag<P, 2>(v);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// copies `bytes` (16 or 0) of src and zero-fills the rest of the 16
__device__ __forceinline__ void cp_async16_fill(void* dst, const void* src,
                                                unsigned bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   smem_addr(dst)), "l"(src), "r"(bytes));
}

// copies `bytes` (4 or 0) of src and zero-fills the rest of the 4
__device__ __forceinline__ void cp_async4_fill(void* dst, const void* src,
                                               unsigned bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(
                   smem_addr(dst)), "l"(src), "r"(bytes));
}

// Operator tiles: tiles[i][k][u][x] = A[32 i + u][32 k + x] as (re, im)
// for band i, zero for 32 i + u >= w or 32 k + x >= R; nb * nk * 32 * 32
// pairs.
__global__ void operator_tiles(const float* __restrict__ are,
                               const float* __restrict__ aim,
                               float2* __restrict__ tiles, int R, int w,
                               int nk, int nb) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= nb * nk * kCrop * kTile) return;
  const int tile = e / (kCrop * kTile);   // i * nk + k
  const int u = tile / nk * kCrop + (e / kTile) % kCrop;
  const int x = tile % nk * kTile + e % kTile;
  float2 a = make_float2(0.f, 0.f);
  if (u < w && x < R) {
    a = make_float2(are[static_cast<size_t>(u) * R + x],
                    aim[static_cast<size_t>(u) * R + x]);
  }
  tiles[e] = a;
}

// The block's three crops, their `band` pair; called by every thread of
// a kThreads block launched with smem_bytes(F::kMaps, P) of dynamic shared
// memory.
// `vec16`: R % 4 == 0 and every map 16-byte aligned.
template <Precision P, class F>
__device__ __forceinline__ void crop_block(const F& fields, const Band& band,
                                           int R, int w, float scale,
                                           int vec16) {
  constexpr bool kBf16 = P == Precision::kBf16;
  extern __shared__ float4 smem[];
  // the three field tiles [d][x][y], then the strip's G [d][u][y]
  float2* const fbuf = reinterpret_cast<float2*>(smem);
  float2* const ring = fbuf + kFieldPairs;    // two operator tiles [u][x]
  // the next field tile's maps: [map][row][column]
  float* const raw = reinterpret_cast<float*>(ring + 2 * kOpPairs);
  // kBf16: O, slot k of thread i at [k][i] (conflict-free)
  float* const obuf = raw + F::kMaps * kTilePixels;

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;
  const int nk = (R + kTile - 1) / kTile;
  const int steps = nk * (nk + 1);          // per strip: nk K tiles + 1
  // the block's map planes, held in registers across the K loop
  const float* plane[F::kMaps];
#pragma unroll
  for (int a = 0; a < F::kMaps; ++a) plane[a] = fields.map(a, R);

  // stage 1 roles: m16 tile m1 of the band's 32 crop rows, column tile n1
  // of each field j (of the strip's 96 columns), which recombine needs
  const int m1 = warp & 1, n1 = warp >> 1;
  // stage 2 roles: m16 tile m2 of the output rows u, n8 tile n2 of v
  const int m2 = warp & 1, n2 = warp >> 1;

  // stage 1: the strip's G; stage 2: the strip's part of O
  float g_re[3][4] = {}, g_im[3][4] = {};
  float o_re[kFields][4] = {}, o_im[kFields][4] = {};
  // the slot of O's element (d, r), re (0) or im (1), in obuf
  auto slot = [&](int d, int r, int im) {
    return (2 * (4 * d + r) + im) * kThreads + threadIdx.x;
  };
  if constexpr (kBf16) {
    // O waits in shared memory between strips: the 24 registers it would
    // hold do not fit beside the bf16 loops' operands at 128 registers
#pragma unroll
    for (int k = 0; k < kOSlots; ++k) obuf[k * kThreads + threadIdx.x] = 0.f;
  }

  // operator tile of `step` into its ring slot, two pairs a copy: of the
  // row band for stage 1, of the column band for stage 2
  auto load_tile = [&](int step) {
    const int strip = step / (nk + 1), j = step % (nk + 1);
    const float2* src = (j < nk ? band.rows : band.cols) +
                        static_cast<size_t>(j < nk ? j : strip) * kCrop *
                            kTile;
    float2* dst = ring + (step & 1) * kOpPairs;
#pragma unroll
    for (int i = 0; i < kCrop * kTile / 2 / kThreads; ++i) {
      const int e = 2 * (threadIdx.x + i * kThreads);
      cp_async16_fill(dst + (e / kTile) * kStride + e % kTile, src + e, 16u);
    }
  };
  // the maps of field tile rows 32 kt.., columns 32 strip.. into raw,
  // zero outside the R x R grid
  auto load_raw = [&](int kt, int strip) {
    const int x0 = kt * kTile, y0 = strip * kTile;
    if (vec16) {
      // one 16-byte chunk of each map a thread
      const int i = threadIdx.x / 8, c = 4 * (threadIdx.x % 8);
      const int x = x0 + i, y = y0 + c;
      const bool ok = x < R && y < R;
      const size_t idx = ok ? static_cast<size_t>(x) * R + y : 0;
#pragma unroll
      for (int a = 0; a < F::kMaps; ++a) {
        cp_async16_fill(raw + (a * kTile + i) * kTile + c, plane[a] + idx,
                        ok ? 16u : 0u);
      }
    } else {
#pragma unroll
      for (int r = 0; r < kTile / kWarps; ++r) {
        const int i = warp + kWarps * r, x = x0 + i, y = y0 + lane;
        const bool ok = x < R && y < R;
        const size_t idx = ok ? static_cast<size_t>(x) * R + y : 0;
#pragma unroll
        for (int a = 0; a < F::kMaps; ++a) {
          cp_async4_fill(raw + (a * kTile + i) * kTile + lane,
                         plane[a] + idx, ok ? 4u : 0u);
        }
      }
    }
  };

  load_tile(0);
  load_raw(0, 0);
  asm volatile("cp.async.commit_group;");
  asm volatile("cp.async.wait_group 0;" ::: "memory");
  __syncthreads();
  for (int step = 0; step < steps; ++step) {
    const int strip = step / (nk + 1), kt = step % (nk + 1);
    const bool stage1 = kt < nk;

    if (stage1) {
      // the field tiles from raw: rows i, column lane, all 4 rows' map
      // values in registers
#pragma unroll
      for (int r = 0; r < kTile / kWarps; ++r) {
        const int i = warp + kWarps * r;
        float2 f[kFields];
        fields.form(raw + i * kTile + lane, f);
#pragma unroll
        for (int d = 0; d < kFields; ++d) {
          fbuf[(d * kTile + i) * kStride + lane] = f[d];
        }
      }
    } else {
      // the strip's G from the stage-1 accumulators: rows u, u + 8,
      // columns yo, yo + 1 as two (re, im) pairs a store
      fields.recombine(g_re);
      fields.recombine(g_im);
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const int yo = 8 * n1 + 2 * t;
        float4* row = reinterpret_cast<float4*>(
            fbuf + (j * kCrop + 16 * m1 + g) * kStride + yo);
        row[0] = make_float4(g_re[j][0], g_im[j][0], g_re[j][1], g_im[j][1]);
        row[4 * kStride] =
            make_float4(g_re[j][2], g_im[j][2], g_re[j][3], g_im[j][3]);
#pragma unroll
        for (int r = 0; r < 4; ++r) g_re[j][r] = g_im[j][r] = 0.f;
      }
    }
    // fbuf ready; raw and the other ring slot are free
    __syncthreads();
    if (step + 1 < steps) load_tile(step + 1);
    if (stage1 && (kt + 1 < nk || strip + 1 < nk)) {
      // the maps of the next stage-1 step: this strip's next K tile, else
      // the next strip's first
      if (kt + 1 < nk) {
        load_raw(kt + 1, strip);
      } else {
        load_raw(0, strip + 1);
      }
    }
    asm volatile("cp.async.commit_group;");
    const float2* op = ring + (step & 1) * kOpPairs;

    if (stage1) {
      // G += A F: re = Are Fre + Aim (-Fim), im = Aim Fre + Are Fim.
      // Unrolled as far as 128 registers hold: one k16 step for kBf16
      // (two spilled with O in registers), two k8 steps for 3xTF32.
#pragma unroll (P == Precision::kBf16 ? 1 : 2)
      for (int ks = 0; ks < kTile / kK<P>; ++ks) {
        // A fragments of the operator rows u = 16 m1 + (g, g + 8)
        const Frag<P, 4> a =
            a_frag<P>(op + (16 * m1 + g) * kStride + kK<P> * ks + t);
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          // B fragments of the field rows x = kK ks + t.., column g
          const Frag<P, 2> f = b_frag<P>(
              fbuf + (j * kTile + kK<P> * ks + t) * kStride + 8 * n1 + g,
              kStride);
          const auto nf = f.neg_im();
          mma(g_re[j], a.re, f.re);
          mma(g_re[j], a.im, nf);
          mma(g_im[j], a.im, f.re);
          mma(g_im[j], a.re, f.im);
        }
      }
    } else {
      // the strip's products go to the G registers, zero since G went to
      // shared memory, and are added to O in float32 at the end of the
      // strip: the tensor cores' accumulation is not IEEE round to
      // nearest, and O would otherwise take every strip's mma chain.
      // G A^T: re = Gre Are^T + Gim (-Aim)^T, im = Gre Aim^T + Gim Are^T
#pragma unroll (P == Precision::kBf16 ? 1 : 2)  // as stage 1
      for (int ks = 0; ks < kTile / kK<P>; ++ks) {
        // B fragments of A_strip^T: B[y][v] = A[v][y], v = 8 n2 + g,
        // y = kK ks + t..
        const Frag<P, 2> b =
            b_frag<P>(op + (8 * n2 + g) * kStride + kK<P> * ks + t, 1);
        const auto nb = b.neg_im();
#pragma unroll
        for (int d = 0; d < kFields; ++d) {
          // A fragments of G_d rows u = 16 m2 + (g, g + 8)
          const Frag<P, 4> gf = a_frag<P>(
              fbuf + (d * kCrop + 16 * m2 + g) * kStride + kK<P> * ks + t);
          mma(g_re[d], gf.re, b.re);
          mma(g_re[d], gf.im, nb);
          mma(g_im[d], gf.re, b.im);
          mma(g_im[d], gf.im, b.re);
        }
      }
#pragma unroll
      for (int d = 0; d < kFields; ++d) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          if constexpr (kBf16) {
            obuf[slot(d, r, 0)] += g_re[d][r];
            obuf[slot(d, r, 1)] += g_im[d][r];
          } else {
            o_re[d][r] += g_re[d][r];
            o_im[d][r] += g_im[d][r];
          }
          g_re[d][r] = g_im[d][r] = 0.f;
        }
      }
    }
    // the next step's operator tile and maps have landed; fbuf is free
    asm volatile("cp.async.wait_group 0;" ::: "memory");
    __syncthreads();
  }

  if constexpr (kBf16) {
#pragma unroll
    for (int d = 0; d < kFields; ++d) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        o_re[d][r] = obuf[slot(d, r, 0)];
        o_im[d][r] = obuf[slot(d, r, 1)];
      }
    }
  }
  float* o = fields.out(w);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int u = band.u0 + 16 * m2 + g + 8 * (r / 2);
    const int v = band.v0 + 8 * n2 + 2 * t + r % 2;
    if (u < w && v < w) {
#pragma unroll
      for (int d = 0; d < kFields; ++d) {
        o[(d * w + u) * w + v] =
            (o_re[d][r] * o_re[d][r] + o_im[d][r] * o_im[d][r]) * scale;
      }
    }
  }
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// Runs `kernel` on `grid` blocks of kThreads, on `stream` of the current
// device: checks R and w, lets `kernel` take `smem` bytes of dynamic
// shared memory, lays the operator out in `work` -- bands(w) * ceil(R /
// 32) * 32 * 32 * 2 floats, 16-byte aligned, allocated by the caller --
// and launches `kernel` (fields, band, R, w, scale, vec16) once per band
// pair of the crop.  Returns the first error.
template <class Kernel, class F>
cudaError_t launch(Kernel kernel, dim3 grid, size_t smem, const F& fields,
                   const float* are, const float* aim, float* work, int R,
                   int w, float scale, int vec16, cudaStream_t stream) {
  if (R <= 0 || w <= 0) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int nk = (R + kTile - 1) / kTile, nb = bands(w);
  const size_t per_band = static_cast<size_t>(nk) * kCrop * kTile;
  float2* const tiles = reinterpret_cast<float2*>(work);
  const int pairs = nb * nk * kCrop * kTile;
  operator_tiles<<<(pairs + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      are, aim, tiles, R, w, nk, nb);
  for (int i = 0; i < nb; ++i) {
    for (int j = 0; j < nb; ++j) {
      const Band band{tiles + i * per_band, tiles + j * per_band, kCrop * i,
                      kCrop * j};
      kernel<<<grid, kThreads, smem, stream>>>(fields, band, R, w, scale,
                                                vec16);
    }
  }
  return cudaGetLastError();
}

}  // namespace psf_mma
