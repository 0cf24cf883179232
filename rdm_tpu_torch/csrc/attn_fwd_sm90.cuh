// One attention-forward core for Hopper (sm_90a): TMA copies, wgmma
// products, scores and the output in registers.
//
//   o = softmax(q k^T * scale) v      over bf16 BSHD memory, f32 scores
//
// Replaces the bodies of two TPU kernels that compute this function:
// rdm_tpu/ops/flash_attention.py:38 `_attn_kernel` (csrc/flash_attn_fwd.cu:
// head_dim 32, 64, 96 or 128, causal or not) and
// rdm_tpu/ops/block_kernel.py:154 `_packed_attn_kernel` (csrc/packed_attn.cu:
// q, k, v [B, S, C] with head h at channels [32h, 32h + 32) is exactly BSHD
// [B, S, C / 32, 32], non-causal). Semantics are the TPU kernels': scores
// times scale * log2(e) and exp2; under `causal` a key after the query
// (query i sees keys j <= i + Sk - Sq) gets -1e9, a finite value, so a row
// with no visible key averages all keys; keys >= Sk of a ragged tile get
// -inf; p is rounded to bf16 for the PV product (against the running row
// max), the f32 denominator sums the unrounded p, and o = O / l in bf16.
//
// What bounds it on the H100 (SXM, 132 SMs). Operations: 4 B H Sq Sk D FLOP
// (halved where causal tiles are skipped) at 989 TFLOP/s. Bytes: q, k, v, o
// once, 2 (Sq + Sk) B H D * 2. And the exponentials: every score costs one
// ex2 on the SFU, 16 per SM per clock, B H Sq Sk / (132 * 16 * clock). At
// head_dim 32 the last one is the floor: [40, 1024, 12, 32] takes 503M ex2,
// 0.12 ms at 1.98 GHz, against 0.065 ms of tensor-core work and 0.019 ms of
// bytes. So the design is built to keep the SFU busy:
//
// - Scores and output in registers. One CTA is one warpgroup that owns 64
//   query rows of one (image, head). S [64, 64] of a key tile and the
//   output O [64, D] live in its registers as wgmma accumulators; nothing
//   of them goes through shared memory.
// - Many warps to hide latency. With 64-key tiles a thread holds at most
//   ~128 registers at D = 32, so four CTAs share an SM (two at D = 64):
//   16 warps, whose softmax phases (SFU, FP32) and product phases (tensor
//   cores, barrier waits) interleave on the SM. A CTA of two warpgroups
//   (128 rows) with 128-key tiles needs ~220 registers a thread, so it fits
//   once per SM, and its two warpgroups wait on each other at the shared
//   ring; in trials on the H100 it was the slower shape at the RDM's
//   non-causal shapes.
// - Copies by TMA. q, k and v each get a 4-D tensor map {D, H, S, B}
//   (innermost first); a box is one 32-column panel of one head of one
//   image, `rows` long, 64-byte swizzled, so a tile never reads the next
//   image's rows (rows past S come back zero) and each k16 step of wgmma
//   stays inside one panel, for every head_dim. Q is loaded once; K/V tiles
//   go round a ring of kStages stages, each with a "full" mbarrier
//   (transaction bytes) and an "empty" one (one arrival per warp). Thread
//   0 issues the copies, two tiles ahead. No producer warp: the register
//   file is split by SM quarter, so a fifth warp costs as many registers
//   as four more, and setmaxnreg did not lift ptxas's allocation for the
//   consumers.
// - S = Q K^T is wgmma m64n64k16, both operands from shared memory,
//   K-major as they lie. PV = P V is m64n{D}k16 with P in registers: the S
//   accumulator, converted to bf16x2, is the register A fragment of the
//   next product (FA3's observation); V is read MN-major through the
//   transpose bit, not transposed in memory.
// - Online softmax in registers: a running max and f32 denominator per
//   row, quad shuffles for the row max (the denominator's quad sum waits
//   for the end), and scale * log2(e) and -m folded into one FFMA per score
//   before ex2. The next tile's S = Q K^T is issued before this tile's
//   softmax, so the tensor cores run while the SFU does. PV goes into an
//   accumulator of its own, and O = O * exp2(m_old - m_new) + PV after it:
//   rescaling O between the two asynchronous products would make ptxas
//   serialize them.
// - Causal key tiles past the CTA's last visible key are skipped (their
//   p is exp2(-1e9 - m) = 0 exactly) where Sk >= Sq.
// - o is written from registers, two bf16 per store, rows >= Sq skipped.
//
// The flash backward's first launch (csrc/flash_attn_bwd.cu) is this
// kernel with kStats: the same walk, then each row's softmax statistics
// in place of o (write_stats).
//
// The host side builds the three tensor maps per call
// (cuTensorMapEncodeTiled through cudaGetDriverEntryPoint, so nothing
// links -lcuda) and passes them as __grid_constant__ parameters.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace rdmk {
namespace attn {

typedef __nv_bfloat16 bf16;

constexpr int kPanel = 32;        // columns of a TMA box: 64 bytes, one
                                  // 64-byte swizzle row
constexpr int kRowBytes = kPanel * 2;
constexpr int kRows = 64;         // query rows of a CTA (one warpgroup)
constexpr int kTK = 64;           // keys of a tile
constexpr int kStages = 4;        // K/V ring depth
constexpr int kThreads = 128;
constexpr float kMasked = -1e9f;  // the TPU kernel's causal mask value

// Shared memory of one CTA: Q | K ring | V ring | barriers, every panel
// on a 1 KB boundary (the 64-byte swizzle repeats every 512 bytes).
template <int D>
struct Smem {
  static_assert(D == 32 || D == 64 || D == 96 || D == 128,
                "head_dim in {32, 64, 96, 128}");
  static constexpr int kPanels = D / kPanel;
  static constexpr int kQPanel = kRows * kRowBytes;
  static constexpr int kKPanel = kTK * kRowBytes;
  static constexpr int kTile = kPanels * kKPanel;  // one K or V tile
  static constexpr int kKOff = kPanels * kQPanel;
  static constexpr int kVOff = kKOff + kStages * kTile;
  static constexpr int kBarOff = kVOff + kStages * kTile;
  // + 2 kStages + 1 barriers, + 1024 to align the base
  static constexpr int kBytes = kBarOff + 8 * (2 * kStages + 1) + 1024;
};

// ------------------------------------------------------------- PTX pieces

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One box {32 columns, 1 head, rows, 1 image} at (col, head, row, image)
// into shared memory at `dst`, completing on `bar`.
__device__ __forceinline__ void tma_load(const CUtensorMap* map,
                                         uint32_t dst, uint32_t bar, int col,
                                         int head, int row, int image) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(head),
      "r"(row), "r"(image)
      : "memory");
}

// One box of a 2-D tensor map at (col, row) into shared memory at `dst`,
// completing on `bar` (the kNN search's table chunks and queries).
__device__ __forceinline__ void tma_load_2d(const CUtensorMap* map,
                                            uint32_t dst, uint32_t bar,
                                            int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row)
      : "memory");
}

// The same box multicast to every CTA of the cluster in `mask`: it lands
// at `dst` in each of them and completes on each one's barrier at `bar`.
__device__ __forceinline__ void tma_load_2d_mc(const CUtensorMap* map,
                                               uint32_t dst, uint32_t bar,
                                               int col, int row,
                                               uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.multicast::cluster [%0], [%1, {%3, %4}], [%2], %5;\n" ::"r"(
          dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row),
      "h"(mask)
      : "memory");
}

// One arrival on the barrier at the same shared offset `bar` in CTA `rank`
// of the cluster (this CTA's own included).
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar,
                                                    uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(bar), "r"(rank));
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];\n" ::"r"(
                   remote)
               : "memory");
}

// wgmma shared-memory descriptor of a 64-byte-swizzled operand: start
// address, leading and stride byte offsets (>> 4), layout type 2 (B64).
__device__ __forceinline__ uint64_t sw64_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)2 << 62);
}

// The descriptor of a K-major operand whose rows are PWB bytes (one TMA
// box wide) and swizzled across PWB bytes: 128 (layout type 1), 64 (2) or
// 32 (3); eight rows repeat the pattern, so SBO is 8 PWB.
template <int PWB>
__device__ __forceinline__ uint64_t sw_desc(uint32_t addr) {
  static_assert(PWB == 128 || PWB == 64 || PWB == 32, "swizzle width");
  constexpr uint64_t kType = PWB == 128 ? 1 : PWB == 64 ? 2 : 3;
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)((8 * PWB) >> 4) << 32) | (kType << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pins registers at this point of the program, so the compiler keeps
// them in place across an asynchronous wgmma.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// d[N / 2] (+)= A [64, 16] (shared, descriptor a) @ B^T, B [N, 16] (shared,
// descriptor b), both K-major: the m64nNk16 accumulator of one warpgroup.
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a,
                                         uint64_t b, int scale_d);
// d[N / 2] (+)= A [64, 16] (registers, bf16x2) @ B [16, N] (shared,
// MN-major).
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t b,
                                         int scale_d);

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t a,
                                              uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31 "
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

// (the backward's S^T = K Q^T over 32-query tiles at head_dim 96 and 128)
template <>
__device__ __forceinline__ void wgmma_ss<32>(float (&d)[16], uint64_t a,
                                              uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15 "
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(a), "l"(b), "r"(scale_d));
}

// (the kNN search's S^T = T Q^T over 8 and 16 queries)
template <>
__device__ __forceinline__ void wgmma_ss<8>(float (&d)[4], uint64_t a,
                                              uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3 "
      "}, %4, %5, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<16>(float (&d)[8], uint64_t a,
                                              uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7 "
      "}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16],
                                              const uint32_t (&a)[4],
                                              uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15 "
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<96>(float (&d)[48],
                                              const uint32_t (&a)[4],
                                              uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47 "
      "}, {%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63 "
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// d[N / 2] (+)= A [64, 16] (shared, K-major, descriptor a) @ B [16, N]
// (shared, MN-major through the transpose bit, descriptor b): the block
// GEMM core's product (csrc/block_gemm_sm90.cuh), whose weights lie
// row-major [K, N] as V does here.
template <int N>
__device__ __forceinline__ void wgmma_ss_mn(float (&d)[N / 2], uint64_t a,
                                            uint64_t b, int scale_d);

template <>
__device__ __forceinline__ void wgmma_ss_mn<64>(float (&d)[32], uint64_t a,
                                                 uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31 "
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss_mn<128>(float (&d)[64], uint64_t a,
                                                 uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63 "
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

// -------------------------------------------------------------- the core

// Key tiles that query rows [r0, r0 + 64) visit. Under `causal` with
// Sk >= Sq every query sees key 0, so tiles past the rows' last visible key
// contribute exp2(-1e9 - m) = 0 exactly and are skipped; with Sk < Sq rows
// with no visible key average all keys, so nothing is skipped.
__device__ __forceinline__ int key_tiles(int r0, int Sq, int Sk,
                                         bool causal) {
  int n = (Sk + kTK - 1) / kTK;
  if (causal && Sk >= Sq)
    n = min(n, (min(r0 + kRows, Sq) - 1 + Sk - Sq) / kTK + 1);
  return n;
}

// K and V tile u (keys [64u, 64u + 64)) into ring stage u % kStages.
template <int D>
__device__ __forceinline__ void load_kv(const CUtensorMap* tk,
                                        const CUtensorMap* tv, uint32_t ks,
                                        uint32_t vs, uint32_t full, int u,
                                        int h, int b) {
  using L = Smem<D>;
  const int s = u % kStages;
  mbar_expect_tx(full + 8 * s, 2 * L::kTile);
#pragma unroll
  for (int p = 0; p < L::kPanels; ++p) {
    const uint32_t off = s * L::kTile + p * L::kKPanel;
    tma_load(tk, ks + off, full + 8 * s, p * kPanel, h, u * kTK, b);
    tma_load(tv, vs + off, full + 8 * s, p * kPanel, h, u * kTK, b);
  }
}

// A CTA's state. This thread holds rows `row` and `row + 8` of the 64,
// columns 8j + col + {0, 1} of every n8 block j of the S and O
// accumulators (elements 4j + {0, 1} and 4j + {2, 3}).
template <int D, bool CAUSAL>
struct Rows {
  using L = Smem<D>;
  const CUtensorMap *tk, *tv;
  uint32_t qs, ks, vs, full, empty;  // shared addresses
  int Sq, Sk, r0, qpos, col, lane;   // qpos: causal position of `row`
  int nkt, h, b;                     // key tiles, head, image
  float scale_log2;
  float acc[D / 2], pv[D / 2];
  float m0, m1;  // running row max (log2 domain)
  float l0, l1;  // this thread's share of the denominators

  // S = Q K_t^T, issued and committed (not waited for)
  __device__ __forceinline__ void issue_qk(float (&s)[kTK / 2], int t) {
    const uint32_t kt = ks + (t % kStages) * L::kTile;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t in_panel = (kk & 1) * 32;  // bytes of a k16 step
      wgmma_ss<kTK>(
          s, sw64_desc(qs + (kk >> 1) * L::kQPanel + in_panel, 16, 512),
          sw64_desc(kt + (kk >> 1) * L::kKPanel + in_panel, 16, 512),
          kk > 0);
    }
    wgmma_commit();
  }

  // PV = P V_t, issued and committed; P the bf16x2 A fragments of each k16
  // step of keys
  __device__ __forceinline__ void issue_pv(const uint32_t (&p)[kTK / 4],
                                           int t) {
    const uint32_t vt = vs + (t % kStages) * L::kTile;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTK / 16; ++kk) {
      const uint32_t a[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2],
                             p[4 * kk + 3]};
      // MN-major V: 32 columns per 64-byte row, the next 32 one panel on
      // (LBO), the next 8 keys 512 bytes on (SBO)
      wgmma_rs<D>(pv, a,
                  sw64_desc(vt + kk * 16 * kRowBytes, L::kKPanel,
                            8 * kRowBytes),
                  kk > 0);
    }
    wgmma_commit();
  }

  // At the start of tile t thread 0 refills the stage of tile t - 2 with
  // tile t + 2, so tile t + 1 has been in flight for a tile. Tiles
  // 0 .. kStages - 1 were issued before the loop.
  __device__ __forceinline__ void produce(int t) {
    const int u = t + kStages - 2;
    if (threadIdx.x == 0 && u >= kStages && u < nkt) {
      mbar_wait(empty + 8 * (u % kStages), (u / kStages - 1) & 1);
      load_kv<D>(tk, tv, ks, vs, full, u, h, b);
    }
    __syncwarp();
  }

  // Tile t, its scores in `cur`. With kNext, S of tile t + 1 is issued
  // into `nxt` first, so the tensor cores run it during this softmax.
  template <bool kNext>
  __device__ __forceinline__ void tile(float (&cur)[kTK / 2],
                                       float (&nxt)[kTK / 2], int t) {
    produce(t);
    if (kNext) {
      mbar_wait(full + 8 * ((t + 1) % kStages), ((t + 1) / kStages) & 1);
      issue_qk(nxt, t + 1);
    }
    const int k0 = t * kTK;
    float mult = scale_log2;
    if (k0 + kTK > Sk || (CAUSAL && k0 + kTK - 1 > r0 + Sk - Sq)) {
      // an edge tile: scale here, mask, and multiply by 1 below
#pragma unroll
      for (int i = 0; i < kTK / 2; ++i) {
        const int key = k0 + 8 * (i >> 2) + col + (i & 1);
        const int pos = qpos + ((i & 2) ? 8 : 0);
        cur[i] = key >= Sk                 ? -INFINITY
                 : (CAUSAL && key > pos) ? kMasked
                                         : cur[i] * scale_log2;
      }
      mult = 1.f;
    }
    float x0 = -INFINITY, x1 = -INFINITY;
#pragma unroll
    for (int i = 0; i < kTK / 2; i += 4) {
      x0 = fmaxf(x0, fmaxf(cur[i], cur[i + 1]));
      x1 = fmaxf(x1, fmaxf(cur[i + 2], cur[i + 3]));
    }
    x0 = fmaxf(x0, __shfl_xor_sync(0xffffffffu, x0, 1));
    x0 = fmaxf(x0, __shfl_xor_sync(0xffffffffu, x0, 2));
    x1 = fmaxf(x1, __shfl_xor_sync(0xffffffffu, x1, 1));
    x1 = fmaxf(x1, __shfl_xor_sync(0xffffffffu, x1, 2));
    const float n0 = fmaxf(m0, x0 * mult), n1 = fmaxf(m1, x1 * mult);
    const float a0 = ex2(m0 - n0), a1 = ex2(m1 - n1);
    m0 = n0;
    m1 = n1;
    uint32_t p[kTK / 4];
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int i = 0; i < kTK / 2; i += 4) {
      const float e0 = ex2(fmaf(cur[i], mult, -n0));
      const float e1 = ex2(fmaf(cur[i + 1], mult, -n0));
      const float e2 = ex2(fmaf(cur[i + 2], mult, -n1));
      const float e3 = ex2(fmaf(cur[i + 3], mult, -n1));
      s0 += e0 + e1;
      s1 += e2 + e3;
      p[i / 2] = pack_bf16(e0, e1);
      p[i / 2 + 1] = pack_bf16(e2, e3);
    }
    l0 = l0 * a0 + s0;
    l1 = l1 * a1 + s1;
    issue_pv(p, t);
    wgmma_wait<0>();
    fence_regs(p);
    fence_regs(pv);
    if (kNext) fence_regs(nxt);
#pragma unroll
    for (int i = 0; i < D / 2; i += 4) {  // O = O * exp2(m_old - m_new) + PV
      acc[i] = fmaf(acc[i], a0, pv[i]);
      acc[i + 1] = fmaf(acc[i + 1], a0, pv[i + 1]);
      acc[i + 2] = fmaf(acc[i + 2], a1, pv[i + 2]);
      acc[i + 3] = fmaf(acc[i + 3], a1, pv[i + 3]);
    }
    // hand the stage back to the producer, one arrival per warp
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * (t % kStages));
    __syncwarp();
  }
};

// Rows of the flash backward's statistics: Sq rounded up to the 64 rows of
// a CTA. They lie as stats[((b H + h) 3 + c) Sqp + row], c = 0 the row max
// m (log2 domain), 1 its 1 / l, 2 delta.
__host__ __device__ __forceinline__ int stat_rows(int Sq) {
  return (Sq + kRows - 1) / kRows * kRows;
}

// The epilogue of the backward's statistics launch (csrc/flash_attn_bwd.cu),
// in place of o: each row's m, 1 / l and delta = rowsum(dO O), O = (sum p v)
// / l still in f32 registers; rows past Sq (up to stat_rows) get zeros.
template <int D, bool CAUSAL>
__device__ __forceinline__ void write_stats(const Rows<D, CAUSAL>& w,
                                            int row, float l0, float l1,
                                            const bf16* __restrict__ dout,
                                            float* __restrict__ stats,
                                            int Sq, int H) {
  const float i0 = 1.0f / l0, i1 = 1.0f / l1;
  const size_t stride = (size_t)H * D;
  const bf16* g = dout + ((size_t)w.b * Sq * H + w.h) * D + w.col;
  float d0 = 0.f, d1 = 0.f;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    if (row < Sq) {
      const float2 x = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(g + row * stride + 8 * j));
      d0 = fmaf(x.x, w.acc[4 * j], fmaf(x.y, w.acc[4 * j + 1], d0));
    }
    if (row + 8 < Sq) {
      const float2 x = __bfloat1622float2(*reinterpret_cast<
          const __nv_bfloat162*>(g + (row + 8) * stride + 8 * j));
      d1 = fmaf(x.x, w.acc[4 * j + 2], fmaf(x.y, w.acc[4 * j + 3], d1));
    }
  }
  d0 += __shfl_xor_sync(0xffffffffu, d0, 1);
  d0 += __shfl_xor_sync(0xffffffffu, d0, 2);
  d1 += __shfl_xor_sync(0xffffffffu, d1, 1);
  d1 += __shfl_xor_sync(0xffffffffu, d1, 2);
  if ((w.lane & 3) == 0) {
    const int Sqp = stat_rows(Sq);
    float* st = stats + (size_t)(w.b * H + w.h) * 3 * Sqp;
    const bool ok0 = row < Sq, ok1 = row + 8 < Sq;
    st[row] = ok0 ? w.m0 : 0.f;
    st[Sqp + row] = ok0 ? i0 : 0.f;
    st[2 * Sqp + row] = ok0 ? d0 * i0 : 0.f;
    st[row + 8] = ok1 ? w.m1 : 0.f;
    st[Sqp + row + 8] = ok1 ? i1 : 0.f;
    st[2 * Sqp + row + 8] = ok1 ? d1 * i1 : 0.f;
  }
}

// One CTA: 64 query rows of one (image, head); grid (ceil(Sq / 64), H, B),
// one warpgroup. Registers: <= 128 a thread at D = 32 (four CTAs an SM),
// <= 255 above (two). kStats: the flash backward's statistics launch,
// which writes write_stats' m, 1 / l and delta from dout into stats in
// place of o; the forward's instantiations (kStats false) do not read
// either pointer.
template <int D, bool CAUSAL, bool kStats = false>
__global__ void __launch_bounds__(kThreads, D == 32 ? 4 : 2)
    attn_fwd_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    bf16* __restrict__ o, int Sq, int Sk, int H,
                    float scale_log2, const bf16* __restrict__ dout,
                    float* __restrict__ stats) {
  using L = Smem<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t qbar = base + L::kBarOff + 16 * kStages;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  Rows<D, CAUSAL> w;
  w.tk = &tk;
  w.tv = &tv;
  w.qs = base;
  w.ks = base + L::kKOff;
  w.vs = base + L::kVOff;
  w.full = base + L::kBarOff;            // kStages "full" barriers
  w.empty = w.full + 8 * kStages;        // kStages "empty" barriers
  w.Sq = Sq;
  w.Sk = Sk;
  w.r0 = blockIdx.x * kRows;
  w.h = blockIdx.y;
  w.b = blockIdx.z;
  w.nkt = key_tiles(w.r0, Sq, Sk, CAUSAL);
  const int row = w.r0 + warp * 16 + (lane >> 2);
  w.qpos = row + Sk - Sq;
  w.col = 2 * (lane & 3);
  w.lane = lane;
  w.scale_log2 = scale_log2;
#pragma unroll
  for (int i = 0; i < D / 2; ++i) w.acc[i] = 0.f;
  w.m0 = w.m1 = -INFINITY;
  w.l0 = w.l1 = 0.f;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(w.full + 8 * s, 1);
      mbar_init(w.empty + 8 * s, kThreads / 32);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    // Q once, and the first kStages K/V tiles
    mbar_expect_tx(qbar, kRows * D * 2);
    for (int p = 0; p < L::kPanels; ++p)
      tma_load(&tq, w.qs + p * L::kQPanel, qbar, p * kPanel, w.h, w.r0, w.b);
    for (int u = 0; u < min(w.nkt, kStages); ++u)
      load_kv<D>(&tk, &tv, w.ks, w.vs, w.full, u, w.h, w.b);
  }
  __syncthreads();

  // Every wgmma of the steady state is issued unconditionally, two tiles
  // an iteration, so the two score buffers swap roles without copies.
  float sa[kTK / 2], sb[kTK / 2];
  mbar_wait(qbar, 0);
  mbar_wait(w.full, 0);
  w.issue_qk(sa, 0);
  wgmma_wait<0>();
  fence_regs(sa);
  int t = 0;
  for (; t + 2 < w.nkt; t += 2) {
    w.template tile<true>(sa, sb, t);
    w.template tile<true>(sb, sa, t + 1);
  }
  if (t + 1 < w.nkt) {
    w.template tile<true>(sa, sb, t);
    w.template tile<false>(sb, sa, t + 1);
  } else {
    w.template tile<false>(sa, sb, t);
  }

  // o = O / l: a row's denominator is in four shares across its quad
  float l0 = w.l0, l1 = w.l1;
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  if constexpr (kStats) {
    write_stats<D, CAUSAL>(w, row, l0, l1, dout, stats, Sq, H);
  } else {
    const float i0 = 1.0f / l0, i1 = 1.0f / l1;
    const size_t stride = (size_t)H * D;
    bf16* out = o + ((size_t)w.b * Sq * H + w.h) * D + w.col;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      if (row < Sq)
        *reinterpret_cast<uint32_t*>(out + row * stride + 8 * j) =
            pack_bf16(w.acc[4 * j] * i0, w.acc[4 * j + 1] * i0);
      if (row + 8 < Sq)
        *reinterpret_cast<uint32_t*>(out + (row + 8) * stride + 8 * j) =
            pack_bf16(w.acc[4 * j + 2] * i1, w.acc[4 * j + 3] * i1);
    }
  }
}

// ------------------------------------------------------------------- host

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, looked up once through the runtime
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// The tensor map of a BSHD tensor [B, S, H, D] of bf16 (esize 2) or int8
// codes (esize 1): dims {D, H, S, B} innermost first, boxes of `rows` rows
// of one head, {32, 1, rows, 1} in bf16 (64 bytes) and a whole head
// {D, 1, rows, 1} in codes (32 or 64 bytes), swizzled across the box's
// bytes; rows past S zero-filled.
inline bool make_map(CUtensorMap* map, const void* ptr, int B, int S, int H,
                     int D, int rows, int esize = 2) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * esize,
                                 (cuuint64_t)H * D * esize,
                                 (cuuint64_t)S * H * D * esize};
  const int box_cols = esize == 2 ? kPanel : D;
  const cuuint32_t box[4] = {(cuuint32_t)box_cols, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map,
            esize == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                       : CU_TENSOR_MAP_DATA_TYPE_UINT8,
            4, const_cast<void*>(ptr), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE,
            box_cols * esize == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                   : CU_TENSOR_MAP_SWIZZLE_32B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The tensor map of a bf16 row-major [rows, cols] matrix: dims {cols,
// rows} innermost first, boxes {box_cols, box_rows}, swizzled across the
// box's box_cols * 2 bytes (128, 64 or 32), rows and columns past the
// matrix zero-filled.
inline bool make_map_2d(CUtensorMap* map, const void* ptr, int rows,
                        int cols, int box_cols, int box_rows) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  const CUtensorMapSwizzle sw = box_cols == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
                                : box_cols == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                 : CU_TENSOR_MAP_SWIZZLE_32B;
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The calling thread's device, its primary context made current.
// cuTensorMapEncodeTiled needs a current context, and a thread that has
// made no runtime call yet has none (an autograd worker whose first CUDA
// work is a kernel of this library, say).
inline cudaError_t bind_device(int* dev) {
  cudaError_t e = cudaGetDevice(dev);
  return e == cudaSuccess ? cudaSetDevice(*dev) : e;
}

// The shared-memory opt-in of `kernel` on device `dev`, once per device (a
// bit per device ordinal in `done`).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, int dev,
                       unsigned long long& done) {
  if (dev < 64 && (done >> dev & 1)) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess && dev < 64) done |= 1ull << dev;
  return e;
}

// Launches `kernel` by cudaLaunchKernelEx: `grid` x `threads`, `smem` bytes
// of dynamic shared memory, in clusters of `cluster` CTAs along x where
// cluster > 1, and, where `pdl`, by programmatic stream serialization: it
// may start while the launch before it in the stream finishes, and waits on
// griddepcontrol.wait before it reads what that launch writes. Returns a
// cudaError_t.
template <typename Kernel, typename... A>
int launch_ex(Kernel kernel, dim3 grid, int threads, int smem,
              cudaStream_t stream, int cluster, bool pdl, const A&... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[2];
  int n = 0;
  if (cluster > 1) {
    attr[n].id = cudaLaunchAttributeClusterDimension;
    attr[n].val.clusterDim.x = cluster;
    attr[n].val.clusterDim.y = 1;
    attr[n].val.clusterDim.z = 1;
    ++n;
  }
  if (pdl) {
    attr[n].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[n].val.programmaticStreamSerializationAllowed = 1;
    ++n;
  }
  cfg.attrs = attr;
  cfg.numAttrs = n;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

// q [B, Sq, H, D], k / v [B, Sk, H, D], o like q, all bf16, contiguous and
// 16-byte aligned; returns a cudaError_t.
template <int D, bool CAUSAL>
int launch_attn_fwd(const void* q, const void* k, const void* v, void* o,
                    int B, int Sq, int Sk, int H, float scale_log2,
                    cudaStream_t stream) {
  using L = Smem<D>;
  int dev = 0;
  cudaError_t e = bind_device(&dev);
  if (e != cudaSuccess) return (int)e;
  CUtensorMap mq, mk, mv;
  if (!make_map(&mq, q, B, Sq, H, D, kRows) ||
      !make_map(&mk, k, B, Sk, H, D, kTK) ||
      !make_map(&mv, v, B, Sk, H, D, kTK))
    return (int)cudaErrorInvalidValue;
  static unsigned long long smem_set = 0;
  e = allow_smem(attn_fwd_kernel<D, CAUSAL>, L::kBytes, dev, smem_set);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((Sq + kRows - 1) / kRows, H, B);
  attn_fwd_kernel<D, CAUSAL><<<grid, kThreads, L::kBytes, stream>>>(
      mq, mk, mv, static_cast<bf16*>(o), Sq, Sk, H, scale_log2, nullptr,
      nullptr);
  return (int)cudaGetLastError();
}

}  // namespace attn
}  // namespace rdmk
