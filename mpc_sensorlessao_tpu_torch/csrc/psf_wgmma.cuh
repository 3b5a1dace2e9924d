// The Hopper engine of the PSF kernels B1-B4, both entries of each: B1's
// psf_div3_sym and psf_div3_sym_bf16 (psf_div3_sym.cu), B4's
// psf_div3_sym_thin and psf_div3_sym_thin_bf16 (psf_div3_sym_thin.cu, on
// B1's policy: `_psf_div3_sym_thin_kernel`, :178-234, pallas_call :257,
// computes B1's function), B2's psf_div and psf_div_bf16 (psf_div.cu)
// and B3's psf_crop and psf_crop_bf16 (psf_crop.cu), the float32 and compute_dtype="bfloat16" branches of
// the TPU kernels mpc_sensorlessao_tpu/ops/pallas_kernels.py
// `_psf_div3_sym_kernel` (:115-175, pallas_call :309), `_psf_div_kernel`
// (:65-112, pallas_call :365) and `_psf_kernel` (:26-62, pallas_call
// :408), on warpgroup matrix products (wgmma), asynchronous copies
// completing on mbarriers, and persistent blocks.  It replaced the
// mma.sync engine psf_mma.cuh (retired with its last kernel, B4; last
// held by commit 19f54fa).  For the three fields F_d of every work
// item it computes
//
//   out[item, d] = |A F_d A^T|^2 * scale,
//
// with A the (w, R) partial centered DFT.  In bf16 (block) it rounds
// where the TPU kernel rounds: the operator, the six bf16 parts a field
// policy forms a pixel, and each field's stage-1 rows G = [rr; ri] once;
// every sum in float32.  In 3xTF32 (block_tf32, the float32 entries)
// every operand is split into TF32 hi and lo, x = hi + lo to float32
// accuracy, and each product is lo*hi + hi*lo + hi*hi, as the retired
// mma.sync engine took it; its differences from the bf16 block are
// listed above block_tf32.
//
// The policies (a struct beside each entry; what the engine asks of one
// is listed above `block`).  Each says which maps a pipeline stage holds,
// how a work item maps to its phase planes and output crops, how the six
// parts of T are formed, and whether P +- Q is recombined:
//   * sym3 (B1 and B4, psf_wgmma_sym3.cuh): an item is a scenario; a
//     stage holds pupil, pcd, psd (shared by both consumers) and each
//     consumer's phase, 5 maps.  The
//     parts are the pseudo-fields P = (t1, t3), F_0 and Q = (t2, -t4),
//     t1 = c pcd, t2 = s psd, t3 = s pcd, t4 = c psd and F_0 = pupil (c,
//     s) (c, s = cos, sin of the phase, one sincosf a pixel), each
//     rounded; the stage-1 sums are recombined, F_-a = P + Q, F_+a = P - Q
//     (pallas_kernels.py:161-171, the TPU kernel's U +- W);
//   * div (B2): an item is a scenario and a group of up to three of the
//     n_div diversities, the two consumers of a block on two scenarios of
//     one group; a stage holds the group's pcd_d and psd_d (pupil cos and
//     sin of diversity d, formed by the wrapper) and each consumer's
//     phase, 8 maps.  The parts are (re, im) of F_d = (c pcd_d - s psd_d,
//     s pcd_d + c psd_d), each product rounded (__fmul_rn: a fused
//     multiply-add rounds once and flips bf16 roundings), their sum in
//     float32, then rounded once, as pup (cp cd - sp sd) in the TPU kernel
//     (exact: the pupil is a 0/1 mask); in 3xTF32 that sum is split into
//     hi and lo, the four rows' sincosf first and then a field at a time
//     (form_field_tf32).  No recombination.  A ragged last group
//     reads a present diversity in place of an absent one and stores
//     nothing for it;
//   * crop (B3): an item is three consecutive planes of the (N, R, R)
//     total phases (on the loop's route one scenario's diversities); a
//     stage holds the pupil (shared) and each consumer's three phases, 7
//     maps.  The parts are pupil (cos, sin) of each phase, three sincosf
//     a pixel, rounded once, formed a field at a time (form_field, the
//     loop unrolled by two):
//     all three at once, 12 sincosf chains beside O and S, took 0.78 ms
//     where this takes 0.61; in 3xTF32 likewise, split into hi and lo
//     (form_field_tf32).  No recombination.  Planes at or past N read a
//     present plane and store nothing.
//
// What bounds them.  At R=128, B=4096, w=31 the two DFT stages are 62.0
// GFLOP a kernel (0.063 ms at the card's published 989 TFLOP/s bf16).
// B1 and B2 move 0.094 ms of bytes (the (B, R, R) phase, the crops) and
// take 67 M sincosf (about 0.07 ms); B3 reads the 3B total-phase planes,
// 805 MB, 0.2545 ms, and takes 201 M sincosf, about as long: each is
// bound by its bytes and its field forming, which the design overlaps.
// The mma.sync design they replaced (psf_mma.cuh, Precision::kBf16, B4's
// bf16 entry until it was retired) re-read and re-rounded the operator at
// every use, kept the fields and G in shared memory as float32, ended
// each of its 20 steps a block in a full barrier, and sent the result
// through shared memory every strip.
//
// The design follows the TPU kernels' algebra, S1 = A2 [fr | fi] with the
// stacked operator A2 = [are; aim] (2w, R), written so in `_psf_div_kernel`
// and as separate are / aim dots in `_psf_kernel`, whose rr = are fr - aim
// fi is S1[are][fr] - S1[aim][fi] all the same:
//   * A2 is the wgmma A operand of stage 1: M = 64 rows, one crop band of
//     32 rows u (a wider crop is cut into bands of 32 rows and columns,
//     one launch a band pair, as the mma.sync engine did).  Its rows are
//     permuted: in each 16-row slice (one warp's rows of the accumulator)
//     rows 0-7 are are[u..u+7] and rows 8-15 aim[u..u+7], so that the
//     thread holding S1[are_u][.] also holds S1[aim_u][.] (accumulator
//     rows g and g + 8).  The crop's rr = S1[are] fr - S1[aim] fi,
//     ri = S1[are] fi + S1[aim] fr, which in the TPU kernel pairs row u
//     with row w + u, then needs no shared memory.  A small kernel
//     (operator_image) rounds A2 to bf16 once a call into the K-major
//     layout wgmma reads with its 128-byte swizzle (K padded with zeros
//     to whole 64-row stages); each persistent block loads it into shared
//     memory once, with one bulk copy;
//   * T, the B operand of stage 1, holds the policy's six parts of a
//     16-column strip of the field as [re | im] column blocks: N = 96,
//     K = 64 field rows a stage.  The consumer threads form it from the
//     maps (8 pixels of one column a thread, kIlp at a time for the
//     sincosf chains to overlap), round it to bf16 once and store it
//     once, 16 bytes a store, in the same swizzled layout (no bank
//     conflict);
//   * each thread takes the three fields' float32 stage-1 sums at the
//     same position (recombined first where the policy says), forms rr
//     and ri, and rounds them to bf16 in registers;
//   * those registers are, as they stand, the wgmma A fragments of stage
//     2, O_d += G_d A2_strip^T (M = 64 rows rr_u, ri_u; N = 64 columns
//     are_v, aim_v in the same permuted order, read from the same
//     shared-memory copy of A2, which is K-major for B too; K = the
//     strip's 16 columns).  O stays in the accumulator registers for the
//     whole item, and the epilogue forms orr = rr are' - ri aim',
//     oi = rr aim' + ri are' and (orr^2 + oi^2) scale in the thread that
//     holds all four, writing the item's crops with no atomics;
//   * a block is a producer warpgroup, one warp of which issues every
//     copy, and two consumer warpgroups, one item each, persistent (one
//     block an SM, walking pairs of items).  The producer keeps a ring of
//     up to 4 stages in flight, each a 64-row x 16-column tile of every
//     map of the stage (the shared maps once for both consumers: half
//     their L2 traffic): by TMA where the maps' row pitch is a multiple
//     of 16 bytes and the maps 16-byte aligned, by 4-byte cp.async
//     otherwise (R=98, say), both completing on the stage's mbarrier.  A
//     consumer warpgroup forms stage k + 1's T (its sincosf and products)
//     while stage k's wgmma group is in flight (two T buffers,
//     wgmma.wait_group 1), and frees a stage to the producer as soon as T
//     is formed.  The second consumer starts a stage behind the first, so
//     that one's waits at the end of a strip (for its last stage-1 group,
//     then for stage 2) fall in the other's forming.  The last pair of an
//     odd count repeats its last item in the second consumer, which
//     stores nothing;
//   * registers: a block of three warpgroups at one block an SM starts at
//     168 registers a thread; the producer warpgroup gives its back
//     (setmaxnreg 40) and the consumers take 232, room for O's 96
//     accumulators, stage 1's 48 and the 12 fragment registers without a
//     spill.  The roles are warp-uniform values, so that each warpgroup's
//     branch holds its wgmma whole and none is serialized.
// Shared memory: a stage is 4 KB a map (sym3 20 KB, div 32 KB, crop 28
// KB), beside 48 KB of T buffers and the operator's image (16 KB at
// R=128 for a crop of one band).  Where fewer than 2 stages fit beside
// the image, the launch returns cudaErrorInvalidValue: above R = 1088
// (sym3), 896 (div), 960 (crop) for a crop of one band, above R = 512,
// 448, 448 for a wider one.
// 3xTF32 (block_tf32) keeps 2 x 24 KB of T buffers a consumer, streams
// both stages' operator tiles with the maps (16 KB a stage beside 2 KB a
// map), and takes the same shared memory at any R: 4 stages for sym3
// (222,208 B), 3 for div (214,016) and crop (207,872), which 4 stages
// (246,784 and 238,592) would take past the H100's 232,448; no R is
// refused.  At R=128, B=4096 it does 3 x 62.0 GFLOP (0.3759 ms at the
// published 495 TFLOP/s TF32), and its stage-1 operand reads alone keep
// the shared memory ~80% busy.
// Measured (NVIDIA H100 80GB HBM3, 700 W; benchmarks/kernel_variants.py,
// benchmarks/bf16_knockouts.py, PERF.md) at R=128, B=4096, w=31, against
// the mma.sync design in the same call: sym3 0.35 ms (0.66), div 0.37-
// 0.38 (0.84), crop 0.61-0.62 (0.92); in 3xTF32 sym3 0.78 (1.34), div
// 0.89-0.90 (1.43), crop 1.03 (1.53), their forming ~0.25 / 0.30 / 0.43
// and stage 1's wgmma ~0.19-0.26 of it, little overlapped: without
// forming and loads ~0.50 ms of products and waits remain, near the
// measured TF32 ceiling.  Knock-out builds split the bf16 ones: the
// field forming costs about 0.19 / 0.16 / 0.30 ms (its sincosf 0.09 /
// 0.06 / 0.26), stage 1's wgmma 0.02-0.04, the TMA loads 0.01-0.03; with
// forming and loads both out about 0.13 ms remain, the products and the
// waits at each strip's end.  Keeping the next strip's forming in front
// of those waits spilled at 232 registers.
// The wgmma sums are not IEEE round to nearest, as mma.sync's were not;
// stage 1 accumulates over K = R on the tensor cores as the old engine
// did, and the P +- Q and rr / ri sums are float32 in the TPU kernel's
// order.
//
// Fragment layouts (PTX ISA, wgmma .m64nNk16 and .m64nNk8, warp i of the
// warpgroup holds rows 16 i..16 i + 15; g = lane / 4, t = lane % 4):
//   accumulator: d[4 j + e + 2 r] at row 16 i + g + 8 r, column 8 j + 2 t + e
//   A (registers, bf16): a0 (g, 2t 2t+1), a1 (g + 8, 2t 2t+1),
//                        a2 (g, 2t+8 2t+9), a3 (g + 8, 2t+8 2t+9)
//   A (registers, tf32): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4),
//                        a3 (g + 8, t + 4)
// -- the accumulator of two 8-column blocks is the bf16 A fragment of one
// k16 slice; for tf32, an 8-column block's pair (2t, 2t + 1) lands at K
// (t, t + 4), one fixed permutation of each 8 columns, which stage 2's
// operator image takes too (a common K permutation leaves the sum as it
// is).

#pragma once

#include <cuda.h>          // CUtensorMap and its enums; no libcuda is linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace psf_wgmma {

constexpr int kConsumers = 2;          // consumer warpgroups: an item each
constexpr int kThreads = 128 * (kConsumers + 1);       // + the producer's
constexpr int kConsumerRegs = 232;     // setmaxnreg: 2 x 128 x 232 +
constexpr int kProducerRegs = 40;      //   128 x 40 <= 65536
constexpr int kRows = 64;              // stage 1's M: one band's A2 rows
constexpr int kBand = 32;              // crop rows (columns) a band
constexpr int kStrip = 16;             // field columns a strip: stage 2's K
constexpr int kChunk = 64;             // field rows a stage: stage 1's K
constexpr int kParts = 6;              // three fields' (or P, F_0, Q's) re, im
constexpr int kFields = 3;             // output crops an item
constexpr int kN1 = kParts * kStrip;   // stage 1's N
constexpr int kMapTile = kChunk * kStrip;              // floats
constexpr int kTBytes = kChunk * kN1 * 2;              // 12288
constexpr int kMaxStages = 4;
constexpr int kAlign = 1024;           // slack to align the dynamic smem
constexpr int kAtom = 64;              // K columns of a 128-byte swizzle atom
constexpr int kAtomBytes = kAtom * 2 * 8;              // its 8-row pattern

// Padded K extent of the operator (field rows and columns: whole stages,
// so that every stage runs the same four k16 products), and the bytes of
// one band of its image.
__host__ __device__ constexpr int padded(int R) {
  return (R + kChunk - 1) / kChunk * kChunk;
}
__host__ __device__ constexpr int image_bytes(int R) {
  return kRows * padded(R) * 2;
}

// Maps a stage of policy P holds: its shared ones, then each consumer's.
template <class P>
__host__ __device__ constexpr int maps() {
  return P::kShared + kConsumers * P::kOwn;
}
template <class P>
__host__ __device__ constexpr int stage_bytes() {
  return maps<P>() * kMapTile * 4;
}

// Dynamic shared memory of a launch of policy P whose operator copy holds
// `images` bands, with `stages` ring stages.
template <class P>
constexpr size_t smem_bytes(int R, int images, int stages) {
  return kAlign + static_cast<size_t>(stages) * stage_bytes<P>() +
         2 * kConsumers * kTBytes +
         static_cast<size_t>(images) * image_bytes(R);
}

// The 3xTF32 precision's layout.  A stage is 32 field rows (one 128-byte
// swizzle row of float32 K), and every wgmma operand is held as two TF32
// planes, hi and lo.  The operator's image in device memory is, for each
// crop band, stage 1's chunks (kOpTile each: the band's 64 permuted rows
// x 32 columns, the hi atom, then the lo atom), then stage 2's strips
// (kColTile each: the 64 rows x the strip's 16 columns, hi in K 0-15 and
// lo in K 16-31 of each 128-byte row, the columns permuted in each
// 8-group, see block_tf32): 1024 bytes a padded row of the grid.
namespace tf32 {
constexpr int kChunk = 32;             // field rows a stage: stage 1's K
constexpr int kMapTile = kChunk * kStrip;              // floats
constexpr int kPlane = kN1 * 128;      // T's hi (or lo) plane, bytes
constexpr int kTBytes = 2 * kPlane;    // 24576
constexpr int kAtomBytes = kRows * 128;                // 8192
constexpr int kOpTile = 2 * kAtomBytes;                // a chunk's hi, lo
constexpr int kColTile = kAtomBytes;   // a strip's stage-2 operand
constexpr int kColSlots = 2;           // strips' operands in flight

__host__ __device__ constexpr int padded(int R) {
  return (R + kChunk - 1) / kChunk * kChunk;
}
// bytes of stage 1's part of a band's image, and of the whole band
__host__ __device__ constexpr size_t stage1_bytes(int R) {
  return static_cast<size_t>(padded(R) / kChunk) * kOpTile;
}
__host__ __device__ constexpr size_t image_bytes(int R) {
  return stage1_bytes(R) + static_cast<size_t>(padded(R) / kStrip) * kColTile;
}
// a ring stage of policy P: the chunk's operator tile, then its maps
template <class P>
__host__ __device__ constexpr int stage_bytes() {
  return kOpTile + maps<P>() * kMapTile * 4;
}
// Dynamic shared memory of a launch of policy P with `stages` ring
// stages, at any R.
template <class P>
constexpr size_t smem_bytes(int stages) {
  return kAlign + static_cast<size_t>(stages) * stage_bytes<P>() +
         2 * kConsumers * kTBytes + kColSlots * kColTile;
}
}  // namespace tf32

// A kernel's arguments: policy P's float32 (planes, R, R) inputs as TMA
// descriptors (unused where the launch copies by cp.async) and pointers,
// a __grid_constant__ whose address the copies take; then the policy and
// the launch's Args, by value, which the loops read from the constant
// bank (in one struct with the descriptors they were read through
// generic loads, again after every asm memory clobber).
template <class P>
struct Inputs {
  CUtensorMap map[P::kInputs];
  const float* ptr[P::kInputs];
};

struct Args {
  const unsigned char* rows;           // stage 1's band of the image
  const unsigned char* cols;           // stage 2's band
  int R, w, u0, v0, stages, tma;
  float scale;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// -------------------------------------------------------------- barriers

__device__ __forceinline__ void mbar_init(uint64_t* b, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(b)),
               "r"(count));
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* b, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
                   "r"(smem_addr(b)), "r"(bytes) : "memory");
}
// `bytes` more to arrive on b, without an arrival of this thread
__device__ __forceinline__ void mbar_expect_tx_only(uint64_t* b,
                                                    unsigned bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;" ::"r"(
                   smem_addr(b)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_addr(b)) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* b, unsigned parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_addr(b)), "r"(parity) : "memory");
  } while (!done);
}
// the 128 threads of consumer warpgroup `wg` (named barrier 1 + wg)
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
}

// ----------------------------------------------------------------- copies

// `bytes` (a multiple of 16) of global src into shared dst, completing on b
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, uint64_t* b) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)), "l"(src), "r"(bytes),
      "r"(smem_addr(b)) : "memory");
}
__device__ __forceinline__ void tma_3d(void* dst, const CUtensorMap* map,
                                       int c0, int c1, int c2, uint64_t* b) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];" ::"r"(smem_addr(dst)),
      "l"(map), "r"(c0), "r"(c1), "r"(c2), "r"(smem_addr(b)) : "memory");
}
// copies `bytes` (4 or 0) of src and zero-fills the rest of the 4
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          unsigned bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(
                   smem_addr(dst)), "l"(src), "r"(bytes) : "memory");
}

// ------------------------------------------------------------------ wgmma

// Descriptor of a K-major operand at p (1024-byte aligned) in the 128-byte
// swizzle: 128-byte rows of 64 K values, 8-row groups kAtomBytes apart
// (the leading offset is unused for this layout: 16 bytes by convention).
__device__ __forceinline__ uint64_t desc(const void* p) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(16 >> 4) << 16 |
         static_cast<uint64_t>(kAtomBytes >> 4) << 32 | 1ull << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// Orders the compiler's accesses to accumulator registers after a
// wgmma.wait_group (and before an issue): the asynchronous products write
// them behind its back.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define PSF_F8(d, i)                                                   \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),          \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 x 96) (+)= A (64 x 16, shared) B (16 x 96, shared); acc = 0: d = A B
__device__ __forceinline__ void wgmma_n96(float (&d)[48], uint64_t a,
                                          uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47}, "
      "%48, %49, p, 1, 1, 0, 0;\n}\n"
      : PSF_F8(d, 0), PSF_F8(d, 8), PSF_F8(d, 16), PSF_F8(d, 24),
        PSF_F8(d, 32), PSF_F8(d, 40)
      : "l"(a), "l"(b), "r"(acc)
      : "memory");
}

// d (64 x 64) (+)= A (64 x 16, registers) B (16 x 64, shared)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : PSF_F8(d, 0), PSF_F8(d, 8), PSF_F8(d, 16), PSF_F8(d, 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc)
      : "memory");
}

// d (64 x 96) (+)= A (64 x 8, shared) B (8 x 96, shared), TF32 operands
__device__ __forceinline__ void wgmma_tf32_n96(float (&d)[48], uint64_t a,
                                               uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47}, "
      "%48, %49, p, 1, 1;\n}\n"
      : PSF_F8(d, 0), PSF_F8(d, 8), PSF_F8(d, 16), PSF_F8(d, 24),
        PSF_F8(d, 32), PSF_F8(d, 40)
      : "l"(a), "l"(b), "r"(acc)
      : "memory");
}

// d (64 x 64) (+)= A (64 x 8, registers) B (8 x 64, shared), TF32
// operands
__device__ __forceinline__ void wgmma_rs_tf32_n64(float (&d)[32],
                                                  const uint32_t (&a)[4],
                                                  uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : PSF_F8(d, 0), PSF_F8(d, 8), PSF_F8(d, 16), PSF_F8(d, 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc)
      : "memory");
}

#undef PSF_F8

// lo and hi rounded to bf16 (to nearest, ties to even), lo in the low half
__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
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

// ------------------------------------------------------------- operator

// The image of band `band` of A2: element (m, x) of its kRows x padded(R)
// K-major matrix, m = 16 k + 8 p + i the operator row u = 32 band + 8 k +
// i of are (p = 0) or aim (p = 1), rounded to bf16; zero for u >= w or
// x >= R.  wgmma's 128-byte swizzle: kAtom-column atoms, in each a
// 128-byte row per m, whose 16-byte chunk c sits at c ^ (m % 8).
__global__ void operator_image(const float* __restrict__ are,
                               const float* __restrict__ aim,
                               uint16_t* __restrict__ image, int R, int w,
                               int bands) {
  const int Rp = padded(R);
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= bands * kRows * Rp) return;
  const int band = e / (kRows * Rp), m = e / Rp % kRows, x = e % Rp;
  const int u = band * kBand + 8 * (m / 16) + m % 8;
  const float* src = (m / 8) % 2 ? aim : are;
  const float v = u < w && x < R ? src[static_cast<size_t>(u) * R + x] : 0.f;
  const size_t at = static_cast<size_t>(band) * kRows * Rp +
                    static_cast<size_t>(x / kAtom) * kRows * kAtom +
                    m * kAtom + ((x % kAtom / 8) ^ (m % 8)) * 8 + x % 8;
  image[at] = __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// The 3xTF32 image of band `band` of A2 (tf32:: above): each element
// (m, x) split into TF32 hi and lo, m as in operator_image.  Stage 1's
// chunk x / 32 holds it at K x % 32 of row m in its hi and its lo atom;
// stage 2's strip s = x' / 16 holds, at K j of row m, column x = 16 s +
// 8 (j / 8) + 2 (j % 4) + j % 8 / 4 (hi; lo at K 16 + j): each 8-group's
// columns in the order that stage 2's register fragments take them.
// One thread an element of either part.
__global__ void operator_image_tf32(const float* __restrict__ are,
                                    const float* __restrict__ aim,
                                    uint32_t* __restrict__ image, int R,
                                    int w, int bands) {
  const int Rp = tf32::padded(R);
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= bands * 2 * kRows * Rp) return;
  const int band = e / (2 * kRows * Rp), f = e % (2 * kRows * Rp);
  const int m = f / Rp % kRows, k = f % Rp;
  const int u = band * kBand + 8 * (m / 16) + m % 8;
  const float* src = (m / 8) % 2 ? aim : are;
  size_t hi_at, lo_at;                 // in words from the band's start
  int x;
  if (f < kRows * Rp) {
    x = k;
    hi_at = static_cast<size_t>(k / tf32::kChunk) * (tf32::kOpTile / 4) +
            m * 32 + ((k % 32 / 4) ^ (m % 8)) * 4 + k % 4;
    lo_at = hi_at + tf32::kAtomBytes / 4;
  } else {
    const int s = k / kStrip, j = k % kStrip;
    x = kStrip * s + 8 * (j / 8) + 2 * (j % 4) + j % 8 / 4;
    const size_t row = tf32::stage1_bytes(R) / 4 +
                       static_cast<size_t>(s) * (tf32::kColTile / 4) + m * 32;
    hi_at = row + ((j / 4) ^ (m % 8)) * 4 + j % 4;
    lo_at = row + ((4 + j / 4) ^ (m % 8)) * 4 + j % 4;
  }
  const float v = u < w && x < R ? src[static_cast<size_t>(u) * R + x] : 0.f;
  uint32_t* const b = image + static_cast<size_t>(band) *
                                  (tf32::image_bytes(R) / 4);
  split(v, b[hi_at], b[lo_at]);
}

// -------------------------------------------------------------- the block

// T of one stage: the six parts that `part` (e, v) forms in float32 at
// element e of the stage's map tiles, for field rows x = 8 xg..8 xg + 7
// of column y, kIlp pixels at a time, rounded to bf16 once, into the B
// operand's swizzled K-major layout: a 128-byte row per n = 16 part + y,
// one 16-byte store a part (the chunk xg of row n, at xg ^ (n % 8)).
template <int kIlp, class Part>
__device__ __forceinline__ void form_t(unsigned char* tb, int y, int xg,
                                       Part part) {
  uint32_t pk[kParts][4];
#pragma unroll
  for (int i = 0; i < 8; i += kIlp) {
    float v[kIlp][kParts];
#pragma unroll
    for (int h = 0; h < kIlp; ++h) part((8 * xg + i + h) * kStrip + y, v[h]);
#pragma unroll
    for (int h = 0; h < kIlp; h += 2) {
#pragma unroll
      for (int q = 0; q < kParts; ++q) {
        pk[q][(i + h) / 2] = bf16x2(v[h][q], v[h + 1][q]);
      }
    }
  }
#pragma unroll
  for (int q = 0; q < kParts; ++q) {
    const int n = kStrip * q + y;
    *reinterpret_cast<uint4*>(tb + n * 128 + (xg ^ (n % 8)) * 16) =
        make_uint4(pk[q][0], pk[q][1], pk[q][2], pk[q][3]);
  }
}

// Parts q0 and q0 + 1 of T (one field's re and im) as `part` (e, re, im)
// forms them in float32 at element e of the stage's map tiles; otherwise
// as form_t.
template <int kIlp, class Part>
__device__ __forceinline__ void form_field(unsigned char* tb, int q0, int y,
                                           int xg, Part part) {
  uint32_t pk[2][4];
#pragma unroll
  for (int i = 0; i < 8; i += kIlp) {
    float v[kIlp][2];
#pragma unroll
    for (int h = 0; h < kIlp; ++h) {
      part((8 * xg + i + h) * kStrip + y, v[h][0], v[h][1]);
    }
#pragma unroll
    for (int h = 0; h < kIlp; h += 2) {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        pk[q][(i + h) / 2] = bf16x2(v[h][q], v[h + 1][q]);
      }
    }
  }
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int n = kStrip * (q0 + q) + y;
    *reinterpret_cast<uint4*>(tb + n * 128 + (xg ^ (n % 8)) * 16) =
        make_uint4(pk[q][0], pk[q][1], pk[q][2], pk[q][3]);
  }
}

// The stage-1 sums S of a strip (one thread's 48; part q's in column
// block q) -> the three fields' G = [rr; ri] rows at the thread's
// positions, in float32: out(d, h, rr, ri) for field d's column pairs
// 8 h + 2 t + e (e = 0, 1) of rows rr_u (rr[e]) and ri_u (ri[e]).  Field d
// is parts 2d (re) and 2d + 1 (im), or with kRecombine the parts are (P,
// F_0, Q) and the fields P + Q, F_0, P - Q.
template <bool kRecombine, class Out>
__device__ __forceinline__ void crop_sums(const float (&S)[48], Out out) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float rr[kFields][2], ri[kFields][2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      // part q's sum at row are_u (r = 0) or aim_u (r = 1), column h, e
      auto at = [&](int q, int r) { return S[4 * (2 * q + h) + e + 2 * r]; };
#pragma unroll
      for (int d = 0; d < kFields; ++d) {
        float re[2], im[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          if (!kRecombine || d == 1) {
            re[r] = at(2 * d, r);
            im[r] = at(2 * d + 1, r);
          } else if (d == 0) {           // F_-a = P + Q
            re[r] = at(0, r) + at(4, r);
            im[r] = at(1, r) + at(5, r);
          } else {                       // F_+a = P - Q
            re[r] = at(0, r) - at(4, r);
            im[r] = at(1, r) - at(5, r);
          }
        }
        rr[d][e] = re[0] - im[1];        // are fr - aim fi
        ri[d][e] = im[0] + re[1];        // are fi + aim fr
      }
    }
#pragma unroll
    for (int d = 0; d < kFields; ++d) out(d, h, rr[d], ri[d]);
  }
}

// crop_sums -> the A fragments of stage 2 (k16: one a field), rounded to
// bf16 once
template <bool kRecombine>
__device__ __forceinline__ void crop_rows(const float (&S)[48],
                                          uint32_t (&fr)[kFields][4]) {
  crop_sums<kRecombine>(S, [&](int d, int h, const float (&rr)[2],
                               const float (&ri)[2]) {
    fr[d][2 * h] = bf16x2(rr[0], rr[1]);
    fr[d][2 * h + 1] = bf16x2(ri[0], ri[1]);
  });
}

// crop_sums -> the TF32 A fragments of stage 2, split into hi and lo: k8
// step h of field d, whose K index t (t + 4) holds column 8 h + 2 t (+ 1)
// of the strip -- the accumulator's column pair, taken as it stands
template <bool kRecombine>
__device__ __forceinline__ void crop_rows_tf32(
    const float (&S)[48], uint32_t (&hi)[kFields][2][4],
    uint32_t (&lo)[kFields][2][4]) {
  crop_sums<kRecombine>(S, [&](int d, int h, const float (&rr)[2],
                               const float (&ri)[2]) {
    split(rr[0], hi[d][h][0], lo[d][h][0]);     // (g, t)
    split(ri[0], hi[d][h][1], lo[d][h][1]);     // (g + 8, t)
    split(rr[1], hi[d][h][2], lo[d][h][2]);     // (g, t + 4)
    split(ri[1], hi[d][h][3], lo[d][h][3]);     // (g + 8, t + 4)
  });
}

// Part q of a 3xTF32 stage's T at field rows x = 4 xg..4 xg + 3 of column
// y, v[h] at row 4 xg + h: each value split into hi and lo (x = hi + lo to
// float32 accuracy, both TF32) and stored once in its plane of the
// swizzled K-major layout: a 128-byte row per n = 16 q + y, 32 K values,
// one 16-byte store a plane (chunk xg of row n, at xg ^ (n % 8)).
__device__ __forceinline__ void store_part_tf32(unsigned char* tb, int q,
                                                int y, int xg,
                                                const float (&v)[4]) {
  uint32_t hi[4], lo[4];
#pragma unroll
  for (int h = 0; h < 4; ++h) split(v[h], hi[h], lo[h]);
  const int n = kStrip * q + y;
  unsigned char* const at = tb + n * 128 + (xg ^ (n % 8)) * 16;
  *reinterpret_cast<uint4*>(at) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
  *reinterpret_cast<uint4*>(at + tf32::kPlane) =
      make_uint4(lo[0], lo[1], lo[2], lo[3]);
}

// T of one 3xTF32 stage: the six parts that `part` (e, v) forms in
// float32 for field rows x = 4 xg..4 xg + 3 of column y, all four at
// once, each stored by store_part_tf32.
template <class Part>
__device__ __forceinline__ void form_t_tf32(unsigned char* tb, int y, int xg,
                                            Part part) {
  float v[4][kParts];
#pragma unroll
  for (int h = 0; h < 4; ++h) part((4 * xg + h) * kStrip + y, v[h]);
#pragma unroll
  for (int q = 0; q < kParts; ++q) {
    const float p[4] = {v[0][q], v[1][q], v[2][q], v[3][q]};
    store_part_tf32(tb, q, y, xg, p);
  }
}

// Parts q0 and q0 + 1 of a 3xTF32 stage's T (one field's re and im) as
// `part` (h, e, re, im) forms them in float32 for the thread's row h at
// element e; otherwise as form_t_tf32.
template <class Part>
__device__ __forceinline__ void form_field_tf32(unsigned char* tb, int q0,
                                                int y, int xg, Part part) {
  float re[4], im[4];
#pragma unroll
  for (int h = 0; h < 4; ++h) {
    part(h, (4 * xg + h) * kStrip + y, re[h], im[h]);
  }
  store_part_tf32(tb, q0, y, xg, re);
  store_part_tf32(tb, q0 + 1, y, xg, im);
}

// Consumer wg's output of pair q from its stage-2 sums O (rows rr_u, ri_u
// with u = a.u0 + 8 wi + g; columns are_v, aim_v): orr = rr are' - ri
// aim', oi = rr aim' + ri are', (orr^2 + oi^2) scale, no atomics.
template <class P>
__device__ __forceinline__ void store_crops(const P& pol,
                                            const float (&O)[kFields][32],
                                            int q, int wg, int wi, int g,
                                            int t, const Args& a) {
  const int u = a.u0 + 8 * wi + g;
#pragma unroll
  for (int d = 0; d < kFields; ++d) {
    float* const o = pol.crop(q, wg, d, a.w);
    if (o == nullptr) continue;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int v = a.v0 + 8 * k + 2 * t + e;
        if (u < a.w && v < a.w) {
          // rows rr_u (+0), ri_u (+2); columns are_v (2k), aim_v (2k+1)
          const float orr = O[d][4 * (2 * k) + e] -
                            O[d][4 * (2 * k + 1) + e + 2];
          const float oi = O[d][4 * (2 * k + 1) + e] +
                           O[d][4 * (2 * k) + e + 2];
          o[u * a.w + v] = (orr * orr + oi * oi) * a.scale;
        }
      }
    }
  }
}

// What the engine asks of a field policy P:
//   kInputs            its float32 (planes, R, R) inputs (Inputs)
//   kShared, kOwn      maps a stage holds for both consumers, and for each
//   kIlp               pixels a consumer thread forms at once
//   kRecombine         whether its parts are (P, F_0, Q) (crop_rows)
//   input(m)           the input of stage map m (shared maps first, then
//                      consumer 0's, then consumer 1's): constexpr, a
//                      constant in the unrolled copy loops
//   pairs()            pairs of work items (host and device)
//   plane(m, q)        the plane of map m's input for pair q
//   crop(q, wg, d, w)  consumer wg's (w, w) output crop of field d for
//                      pair q, or nullptr: nothing to store
//   form(st, own, tb, y, xg)  T (form_t) from a stage's shared maps st
//                      and the consumer's own maps own
// One persistent block: called by every thread of a kThreads block
// launched with smem_bytes<P>(R, images, a.stages) of dynamic shared
// memory.
template <class P>
__device__ __forceinline__ void block(const Inputs<P>& in, const P& pol,
                                      const Args& a) {
  constexpr int kMaps = maps<P>();
  constexpr unsigned kStageBytes = stage_bytes<P>();
  extern __shared__ unsigned char smem_raw[];
  __shared__ uint64_t full[kMaxStages], empty[kMaxStages], op_bar, skew;
  // aligned by an offset from the shared array itself, so that the
  // compiler keeps every access below in shared memory (LDS/STS, not
  // generic loads)
  unsigned char* const base =
      smem_raw + (kAlign - smem_addr(smem_raw) % kAlign) % kAlign;
  float* const ring = reinterpret_cast<float*>(base);
  unsigned char* const tbuf = base + a.stages * kStageBytes;
  unsigned char* const img1 = tbuf + 2 * kConsumers * kTBytes;
  const int R = a.R, Rp = padded(R);
  const unsigned img_bytes = image_bytes(R);
  const bool one_band = a.rows == a.cols;
  unsigned char* const img2 = one_band ? img1 : img1 + img_bytes;
  const int strips = (R + kStrip - 1) / kStrip, chunks = Rp / kChunk;
  const int pairs = pol.pairs();
  // warp-uniform roles (shuffled from lane 0), so that the compiler sees
  // each warpgroup take one branch whole
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < a.stages; ++s) {
      mbar_init(&full[s], a.tma ? 1 : 32);
      mbar_init(&empty[s], kConsumers);
    }
    mbar_init(&op_bar, 1);
    mbar_init(&skew, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers) {
    // ------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (__shfl_sync(0xffffffffu, threadIdx.x / 32 % 4, 0) != 0) return;
    if (lane == 0) {
      mbar_expect_tx(&op_bar, (one_band ? 1 : 2) * img_bytes);
      bulk_copy(img1, a.rows, img_bytes, &op_bar);
      if (!one_band) bulk_copy(img2, a.cols, img_bytes, &op_bar);
    }
    int stage = 0;
    unsigned phase = 0;
    for (int q = blockIdx.x; q < pairs; q += gridDim.x) {
      for (int s = 0; s < strips; ++s) {
        for (int kc = 0; kc < chunks; ++kc) {
          mbar_wait(&empty[stage], phase ^ 1);
          float* const dst = ring + stage * kMaps * kMapTile;
          const int y0 = s * kStrip, x0 = kc * kChunk;
          if (a.tma) {
            if (lane == 0) {
              mbar_expect_tx(&full[stage], kStageBytes);
#pragma unroll
              for (int m = 0; m < kMaps; ++m) {
                tma_3d(dst + m * kMapTile, &in.map[P::input(m)], y0, x0,
                       pol.plane(m, q), &full[stage]);
              }
            }
          } else {
            // rows not 16-byte aligned: 4-byte copies, zero outside R x R
#pragma unroll 1
            for (int m = 0; m < kMaps; ++m) {
              // the input's pointer by comparison, not by a dynamic index
              // into the kernel's parameters
              const float* src = in.ptr[0];
#pragma unroll
              for (int i = 1; i < P::kInputs; ++i) {
                if (P::input(m) == i) src = in.ptr[i];
              }
              src += static_cast<size_t>(pol.plane(m, q)) * R * R;
#pragma unroll 4
              for (int i = 0; i < kMapTile / 32; ++i) {
                const int e = lane + 32 * i;
                const int x = x0 + e / kStrip, y = y0 + e % kStrip;
                const bool ok = x < R && y < R;
                cp_async4(dst + m * kMapTile + e,
                          src + (ok ? static_cast<size_t>(x) * R + y : 0),
                          ok ? 4u : 0u);
              }
            }
            asm volatile(
                "cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
                    smem_addr(&full[stage])) : "memory");
          }
          if (++stage == a.stages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    asm volatile("cp.async.wait_all;" ::: "memory");
  } else {
    // ------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
    const int tid = threadIdx.x % 128, wi = tid / 32;
    const int g = lane / 4, t = lane % 4;
    const int fy = tid % kStrip, fxg = tid / kStrip;   // forming role
    const int own = (P::kShared + wg * P::kOwn) * kMapTile;
    unsigned char* const my_t = tbuf + wg * 2 * kTBytes;
    const uint64_t a1 = desc(img1), b2 = desc(img2);
    // descriptor offset of k16 slice i of the image: 32 bytes a slice
    // within an atom, kRows 128-byte rows an atom
    auto slice = [](int i) -> uint64_t {
      return (i / 4 * kRows * 128 + i % 4 * 32) >> 4;
    };
    constexpr uint64_t kStep = 32 >> 4;                // T's k16 slice
    float S[48] = {}, O[kFields][32] = {};
    uint32_t fr[kFields][4];
    int stage = 0, tile = 0;
    unsigned phase = 0;
    mbar_wait(&op_bar, 0);
    // the second warpgroup runs a stage behind the first, so that one's
    // waits at the end of a strip overlap the other's forming
    if (wg == 1) mbar_wait(&skew, 0);
    for (int q = blockIdx.x; q < pairs; q += gridDim.x) {
      for (int s = 0; s < strips; ++s) {
        for (int kc = 0; kc < chunks; ++kc, ++tile) {
          mbar_wait(&full[stage], phase);
          const float* st = ring + stage * kMaps * kMapTile;
          unsigned char* const tb = my_t + (tile & 1) * kTBytes;
          P::form(st, st + own, tb, fy, fxg);
          asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
          warpgroup_sync(wg);
          if (tid == 0) {
            mbar_arrive(&empty[stage]);
            if (wg == 0 && tile == 0) mbar_arrive(&skew);
          }
          if (++stage == a.stages) {
            stage = 0;
            phase ^= 1;
          }
          const uint64_t bt = desc(tb);
          fence_regs(S);
          wgmma_fence();
#pragma unroll
          for (int j = 0; j < kChunk / kStrip; ++j) {
            wgmma_n96(S, a1 + slice(4 * kc + j), bt + j * kStep,
                      kc > 0 || j > 0);
          }
          wgmma_commit();
          // the previous stage's products are done: its T buffer is free
          wgmma_wait<1>();
        }
        // stage 2 of the strip: the crop's rows from S, their products
        // into O
        wgmma_wait<0>();
        fence_regs(S);
#pragma unroll
        for (int d = 0; d < kFields; ++d) fence_regs(O[d]);
        crop_rows<P::kRecombine>(S, fr);
        wgmma_fence();
#pragma unroll
        for (int d = 0; d < kFields; ++d) {
          wgmma_rs_n64(O[d], fr[d], b2 + slice(s), s > 0);
        }
        wgmma_commit();
        // the fragment registers are free again before the next forming
        wgmma_wait<0>();
      }
#pragma unroll
      for (int d = 0; d < kFields; ++d) fence_regs(O[d]);
      store_crops(pol, O, q, wg, wi, g, t, a);
    }
  }
}

// The block in 3xTF32 (launched by launch_tf32): block's roles, policy
// and skew, with
//   * stages of tf32::kChunk = 32 field rows; T (policy P's form, on
//     form_t_tf32 or form_field_tf32) and every operator tile in hi and
//     lo planes, and each k8 step of a
//     product as three wgmma, lo*hi + hi*lo + hi*hi (3xTF32, as the
//     retired mma.sync engine).  Stage 1 sums hi*hi in S and the two
//     corrections in C, added in float32 at the strip's end: the tensor
//     cores' sums round toward zero, so each wgmma on a large sum takes a
//     bias; with all three on S, B1 erred 3.9e-6 of the peak at R=512
//     (NVIDIA H100 80GB HBM3, 700 W), and C's sums are 2^-11 as large;
//   * stage 1's operator streamed with the maps, a chunk's tile a
//     stage, so that shared memory does not grow with R (held whole, as
//     the bf16 block holds it, it took no less time at R=128); a stage is
//     freed once the products that read it are done, by each consumer
//     warp (its wgmma.wait);
//   * stage 2's operator streamed a strip at a time into two slots of
//     its own: its K rows are the strip's columns in the order the
//     accumulator's column pairs (2 t, 2 t + 1) take as the register
//     fragments' K indices (t, t + 4), so that S's registers are the A
//     fragments as they stand, split into hi and lo (crop_rows_tf32);
//   * each field's strip of stage 2 summed on the tensor cores into a
//     partial P from zero, and added to O in float32:
//     the tensor cores' sums round toward zero, and a chain over every
//     strip errs more at large R (as the retired mma.sync engine
//     found).
template <class P>
__device__ __forceinline__ void block_tf32(const Inputs<P>& in,
                                           const P& pol, const Args& a) {
  constexpr int kMaps = maps<P>();
  using tf32::kColTile;
  using tf32::kOpTile;
  extern __shared__ unsigned char smem_raw[];
  __shared__ uint64_t full[kMaxStages], empty[kMaxStages];
  __shared__ uint64_t col_full[tf32::kColSlots], col_empty[tf32::kColSlots];
  __shared__ uint64_t skew;
  constexpr unsigned kStageBytes = tf32::stage_bytes<P>();
  unsigned char* const base =
      smem_raw + (kAlign - smem_addr(smem_raw) % kAlign) % kAlign;
  unsigned char* const tbuf = base + a.stages * kStageBytes;
  unsigned char* const cols = tbuf + 2 * kConsumers * tf32::kTBytes;
  const int R = a.R;
  const int strips = (R + kStrip - 1) / kStrip;
  const int chunks = tf32::padded(R) / tf32::kChunk;
  const int pairs = pol.pairs();
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < a.stages; ++s) {
      mbar_init(&full[s], a.tma ? 1 : 32);
      mbar_init(&empty[s], 4 * kConsumers);      // each consumer warp
    }
    for (int c = 0; c < tf32::kColSlots; ++c) {
      mbar_init(&col_full[c], 1);
      mbar_init(&col_empty[c], 4 * kConsumers);
    }
    mbar_init(&skew, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers) {
    // ------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (__shfl_sync(0xffffffffu, threadIdx.x / 32 % 4, 0) != 0) return;
    int stage = 0, slot = 0;
    unsigned phase = 0, col_phase = 0;
    for (int q = blockIdx.x; q < pairs; q += gridDim.x) {
      for (int s = 0; s < strips; ++s) {
        // the strip's stage-2 operator tile
        mbar_wait(&col_empty[slot], col_phase ^ 1);
        if (lane == 0) {
          mbar_expect_tx(&col_full[slot], kColTile);
          bulk_copy(cols + slot * kColTile, a.cols + s * kColTile, kColTile,
                    &col_full[slot]);
        }
        if (++slot == tf32::kColSlots) {
          slot = 0;
          col_phase ^= 1;
        }
        for (int kc = 0; kc < chunks; ++kc) {
          mbar_wait(&empty[stage], phase ^ 1);
          unsigned char* const dst = base + stage * kStageBytes;
          float* const mp = reinterpret_cast<float*>(dst + kOpTile);
          const int y0 = s * kStrip, x0 = kc * tf32::kChunk;
          if (a.tma) {
            if (lane == 0) {
              mbar_expect_tx(&full[stage], kStageBytes);
              bulk_copy(dst, a.rows + kc * kOpTile, kOpTile, &full[stage]);
#pragma unroll
              for (int m = 0; m < kMaps; ++m) {
                tma_3d(mp + m * tf32::kMapTile, &in.map[P::input(m)], y0, x0,
                       pol.plane(m, q), &full[stage]);
              }
            }
          } else {
            if (lane == 0) {
              mbar_expect_tx_only(&full[stage], kOpTile);
              bulk_copy(dst, a.rows + kc * kOpTile, kOpTile, &full[stage]);
            }
            // rows not 16-byte aligned: 4-byte copies, zero outside R x R
#pragma unroll 1
            for (int m = 0; m < kMaps; ++m) {
              const float* src = in.ptr[0];
#pragma unroll
              for (int i = 1; i < P::kInputs; ++i) {
                if (P::input(m) == i) src = in.ptr[i];
              }
              src += static_cast<size_t>(pol.plane(m, q)) * R * R;
#pragma unroll 4
              for (int i = 0; i < tf32::kMapTile / 32; ++i) {
                const int e = lane + 32 * i;
                const int x = x0 + e / kStrip, y = y0 + e % kStrip;
                const bool ok = x < R && y < R;
                cp_async4(mp + m * tf32::kMapTile + e,
                          src + (ok ? static_cast<size_t>(x) * R + y : 0),
                          ok ? 4u : 0u);
              }
            }
            asm volatile(
                "cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
                    smem_addr(&full[stage])) : "memory");
          }
          if (++stage == a.stages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    asm volatile("cp.async.wait_all;" ::: "memory");
  } else {
    // ------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
    const int tid = threadIdx.x % 128, wi = tid / 32;
    const int g = lane / 4, t = lane % 4;
    const int fy = tid % kStrip, fxg = tid / kStrip;   // forming role
    const int own = (P::kShared + wg * P::kOwn) * tf32::kMapTile;
    unsigned char* const my_t = tbuf + wg * 2 * tf32::kTBytes;
    // descriptor offsets (16-byte units): a k8 step, a lo atom, T's lo
    // plane, stage 2's lo K
    constexpr uint64_t kStep = 32 >> 4, kOpLo = tf32::kAtomBytes >> 4;
    constexpr uint64_t kTLo = tf32::kPlane >> 4, kColLo = 64 >> 4;
    // stage 1's hi*hi sums, and its lo*hi + hi*lo corrections apart
    float S[48], C[48], O[kFields][32];
    int stage = 0, tile = 0, slot = 0;
    unsigned phase = 0, col_phase = 0;
    if (wg == 1) mbar_wait(&skew, 0);
    for (int q = blockIdx.x; q < pairs; q += gridDim.x) {
#pragma unroll
      for (int d = 0; d < kFields; ++d) {
#pragma unroll
        for (int i = 0; i < 32; ++i) O[d][i] = 0.f;
      }
      for (int s = 0; s < strips; ++s) {
        // S and C are rewritten here, so that they are dead during stage 2
#pragma unroll
        for (int i = 0; i < 48; ++i) S[i] = C[i] = 0.f;
        int prev = 0;
        for (int kc = 0; kc < chunks; ++kc, ++tile) {
          mbar_wait(&full[stage], phase);
          unsigned char* const st = base + stage * kStageBytes;
          const float* mp = reinterpret_cast<const float*>(st + kOpTile);
          unsigned char* const tb = my_t + (tile & 1) * tf32::kTBytes;
          P::form(mp, mp + own, tb, fy, fxg);
          asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
          warpgroup_sync(wg);
          if (tid == 0 && wg == 0 && tile == 0) mbar_arrive(&skew);
          const uint64_t ad = desc(st);
          const uint64_t bt = desc(tb);
          fence_regs(S);
          fence_regs(C);
          wgmma_fence();
#pragma unroll
          for (int j = 0; j < tf32::kChunk / 8; ++j) {
            const uint64_t ak = ad + j * kStep, bk = bt + j * kStep;
            wgmma_tf32_n96(C, ak + kOpLo, bk, 1);          // lo * hi
            wgmma_tf32_n96(C, ak, bk + kTLo, 1);           // hi * lo
            wgmma_tf32_n96(S, ak, bk, 1);                  // hi * hi
          }
          wgmma_commit();
          // the previous stage's products are done: its T buffer is free,
          // and so is the stage
          wgmma_wait<1>();
          if (kc > 0 && lane == 0) mbar_arrive(&empty[prev]);
          prev = stage;
          if (++stage == a.stages) {
            stage = 0;
            phase ^= 1;
          }
        }
        wgmma_wait<0>();
        if (lane == 0) mbar_arrive(&empty[prev]);
        // stage 2 of the strip: the crop's rows from S, a field's
        // products at a time into P, added to O
        fence_regs(S);
        fence_regs(C);
#pragma unroll
        for (int i = 0; i < 48; ++i) S[i] += C[i];
        uint32_t hi[kFields][2][4], lo[kFields][2][4];
        crop_rows_tf32<P::kRecombine>(S, hi, lo);
        mbar_wait(&col_full[slot], col_phase);
        const uint64_t bc = desc(cols + slot * kColTile);
#pragma unroll
        for (int d = 0; d < kFields; ++d) {
          float Pd[32];
#pragma unroll
          for (int i = 0; i < 32; ++i) Pd[i] = 0.f;
          wgmma_fence();
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const uint64_t bh = bc + h * kStep;
            wgmma_rs_tf32_n64(Pd, lo[d][h], bh, 1);        // lo * hi
            wgmma_rs_tf32_n64(Pd, hi[d][h], bh + kColLo, 1);   // hi * lo
            wgmma_rs_tf32_n64(Pd, hi[d][h], bh, 1);        // hi * hi
          }
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(Pd);
#pragma unroll
          for (int i = 0; i < 32; ++i) O[d][i] += Pd[i];
        }
        if (lane == 0) mbar_arrive(&col_empty[slot]);
        if (++slot == tf32::kColSlots) {
          slot = 0;
          col_phase ^= 1;
        }
      }
      store_crops(pol, O, q, wg, wi, g, t, a);
    }
  }
}

// ------------------------------------------------------------------- host

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the CUDA runtime's entry-point
// query: nothing links libcuda
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return err == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A float32 (planes, R, R) input whose boxes are 16 columns x `rows` rows
// x 1 plane; zeros outside it.
inline bool encode(CUtensorMap* map, const float* p, int R, int planes,
                   int rows = kChunk) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(R),
                              static_cast<cuuint64_t>(R),
                              static_cast<cuuint64_t>(planes)};
  const cuuint64_t strides[2] = {dims[0] * 4, dims[0] * dims[1] * 4};
  const cuuint32_t box[3] = {kStrip, static_cast<cuuint32_t>(rows), 1},
                   elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(p),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Lays the operator's bf16 image out in `work` (bands(w) * image_bytes(R)
// bytes, 16-byte aligned, allocated by the caller) and launches `kernel`
// (Inputs<P>, P, Args) with policy `pol` on its inputs `in` (planes[i]
// planes of R x R each) once per band pair of the crop, persistent: one
// block an SM, at most one a pair of items.  On `stream` of the current
// device; returns the first error.
// The current device's SM count and the shared memory a block may opt in
// to.
inline cudaError_t device_limits(int& sms, int& optin) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  return err;
}

// The TMA descriptors of a launch's inputs where every input allows them
// (rows a multiple of 16 bytes, 16-byte aligned), boxes of `rows` rows;
// inputs.ptr always.  Returns false where a descriptor cannot be made;
// tma says whether the launch copies by TMA.
template <class P>
bool tensor_maps(Inputs<P>& inputs, const float* const (&in)[P::kInputs],
                 const int (&planes)[P::kInputs], int R, int rows,
                 int& tma) {
  tma = R % 4 == 0;
  for (int i = 0; i < P::kInputs; ++i) {
    inputs.ptr[i] = in[i];
    tma = tma && aligned16(in[i]);
  }
  for (int i = 0; tma && i < P::kInputs; ++i) {
    if (!encode(&inputs.map[i], in[i], R, planes[i], rows)) return false;
  }
  return true;
}

template <class P, class Kernel>
cudaError_t launch(Kernel kernel, const P& pol,
                   const float* const (&in)[P::kInputs],
                   const int (&planes)[P::kInputs], const float* are,
                   const float* aim, void* work, int R, int w, float scale,
                   cudaStream_t stream) {
  if (R <= 0 || w <= 0) return cudaErrorInvalidValue;
  int sms = 0, optin = 0;
  cudaError_t err = device_limits(sms, optin);
  if (err != cudaSuccess) return err;
  const int nb = (w + kBand - 1) / kBand;
  const int Rp = padded(R);
  uint16_t* const image = static_cast<uint16_t*>(work);
  const int elems = nb * kRows * Rp;
  operator_image<<<(elems + 255) / 256, 256, 0, stream>>>(are, aim, image, R,
                                                          w, nb);
  Inputs<P> inputs{};
  Args args{};
  int tma = 0;
  if (!tensor_maps(inputs, in, planes, R, kChunk, tma)) {
    return cudaErrorInvalidValue;
  }
  args.R = R;
  args.w = w;
  args.tma = tma;
  args.scale = scale;
  const int pairs = pol.pairs();
  const size_t band_elems = static_cast<size_t>(kRows) * Rp;
  for (int i = 0; i < nb; ++i) {
    for (int j = 0; j < nb; ++j) {
      const int images = i == j ? 1 : 2;
      // the static barriers take the last 128 bytes of the opt-in limit
      const long room = static_cast<long>(optin) - 128 -
                        static_cast<long>(smem_bytes<P>(R, images, 0));
      const int stages = static_cast<int>(
          room < 0 ? 0 : (room / stage_bytes<P>() < kMaxStages
                              ? room / stage_bytes<P>() : kMaxStages));
      if (stages < 2) return cudaErrorInvalidValue;
      const size_t smem = smem_bytes<P>(R, images, stages);
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (err != cudaSuccess) return err;
      args.rows = reinterpret_cast<const unsigned char*>(image +
                                                         i * band_elems);
      args.cols = reinterpret_cast<const unsigned char*>(image +
                                                         j * band_elems);
      args.u0 = kBand * i;
      args.v0 = kBand * j;
      args.stages = stages;
      kernel<<<pairs < sms ? pairs : sms, kThreads, smem, stream>>>(
          inputs, pol, args);
    }
  }
  return cudaGetLastError();
}

namespace tf32 {
// Ring stages of policy P where a block may opt in to `optin` bytes of
// shared memory: as many as fit, at most kMaxStages (the static barriers
// take the last 128 bytes).  At the H100's 232,448: 4 for sym3 (5 maps a
// stage), 3 for div (8) and crop (7).
template <class P>
int stages(int optin) {
  const long left = static_cast<long>(optin) - 128 -
                    static_cast<long>(smem_bytes<P>(0));
  const long fit = left < 0 ? 0 : left / stage_bytes<P>();
  return static_cast<int>(fit < kMaxStages ? fit : kMaxStages);
}
// Dynamic shared memory a launch of policy P takes on the current device
// (at any R), or 0 where fewer than 2 stages fit.
template <class P>
size_t launch_smem() {
  int sms = 0, optin = 0;
  if (device_limits(sms, optin) != cudaSuccess) return 0;
  const int n = stages<P>(optin);
  return n < 2 ? 0 : smem_bytes<P>(n);
}
}  // namespace tf32

// As launch, for block_tf32: lays the operator's 3xTF32 image out in
// `work` (bands(w) * tf32::image_bytes(R) bytes, 16-byte aligned,
// allocated by the caller) and launches `kernel` once per band pair of
// the crop, persistent.  A launch takes the same shared memory at any R,
// so no R is refused.
template <class P, class Kernel>
cudaError_t launch_tf32(Kernel kernel, const P& pol,
                        const float* const (&in)[P::kInputs],
                        const int (&planes)[P::kInputs], const float* are,
                        const float* aim, void* work, int R, int w,
                        float scale, cudaStream_t stream) {
  if (R <= 0 || w <= 0) return cudaErrorInvalidValue;
  int sms = 0, optin = 0;
  cudaError_t err = device_limits(sms, optin);
  if (err != cudaSuccess) return err;
  const int nb = (w + kBand - 1) / kBand;
  const int elems = nb * 2 * kRows * tf32::padded(R);
  unsigned char* const image = static_cast<unsigned char*>(work);
  operator_image_tf32<<<(elems + 255) / 256, 256, 0, stream>>>(
      are, aim, reinterpret_cast<uint32_t*>(image), R, w, nb);
  Inputs<P> inputs{};
  Args args{};
  int tma = 0;
  if (!tensor_maps(inputs, in, planes, R, tf32::kChunk, tma)) {
    return cudaErrorInvalidValue;
  }
  const int stages = tf32::stages<P>(optin);
  if (stages < 2) return cudaErrorInvalidValue;
  const size_t smem = tf32::smem_bytes<P>(stages);
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  args.R = R;
  args.w = w;
  args.tma = tma;
  args.stages = stages;
  args.scale = scale;
  const int pairs = pol.pairs();
  const size_t band_bytes = tf32::image_bytes(R);
  for (int i = 0; i < nb; ++i) {
    for (int j = 0; j < nb; ++j) {
      args.rows = image + i * band_bytes;
      args.cols = image + j * band_bytes + tf32::stage1_bytes(R);
      args.u0 = kBand * i;
      args.v0 = kBand * j;
      kernel<<<pairs < sms ? pairs : sms, kThreads, smem, stream>>>(
          inputs, pol, args);
    }
  }
  return cudaGetLastError();
}

}  // namespace psf_wgmma
