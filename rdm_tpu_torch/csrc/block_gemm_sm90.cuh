// One block-GEMM core for Hopper (sm_90a): TMA copies into an mbarrier
// ring fed by a producer warp, wgmma products, the accumulators in
// registers, one prologue and four epilogues.
//
//   out[R, N] = epilogue(A[R, K] @ W[K, N])     bf16 in, f32 accumulation
//
// Replaces the bodies of four TPU kernels of the SpatialTransformer block:
// rdm_tpu/ops/block_kernel.py:127 `_ln_qkv_kernel` (csrc/ln_qkv.cu, one
// launch), :361 `_post_cross_kernel` (with the context folding of
// make_cross_mats :500; csrc/post_cross.cu, three launches), :423
// `_geglu_ff_kernel` (csrc/geglu_ff_sm90.cu, two launches) and :264
// `_post_ff_kernel` (csrc/post_ff.cu: post_cross's three launches, then
// the FF launch below, block_gemm_ff_kernel, which keeps the GEGLU hidden
// in shared memory across a cluster):
//
//   kResidual  out = res + bf16(A @ W + bias)                 A streamed
//              (post_cross's x1 and xmid, geglu_ff's y)
//   kCross     q2 = bf16(LN(src)) @ W; per 32-column head (64 for
//              kCross64) the cross-attention over the row's image's T
//              context tokens, T <= 16 (any T for kCrossLong, kCross64):
//              out = bf16(sum_t bf16(softmax_t(bf16(q2) ck_t * scale)) cv_t)
//   kGeglu     h = bf16(LN(src));
//              out = bf16((h @ Wa + ba) * gelu(h @ Wg + bg))
//              (two accumulators sharing each A descriptor; exact erf)
//   kQkv       h = bf16(LN(src)); [q | k | v] = bf16(h @ Wqkv), N = 3C:
//              each 8-column group goes to q, k or v (ln_qkv)
//
// and, in its s8 launches (block_gemm_s8_kernel, "the s8 launches" below),
// the int8 block's :140 `_ln_qkv_kernel_q` (csrc/ln_qkv_q.cu, one launch),
// :397 `_post_cross_kernel_q` (csrc/post_cross_q.cu, three) and :456
// `_geglu_ff_kernel_q` (csrc/geglu_ff_q.cu, two): int8 codes times int8
// weights into int32, the same epilogues on the dequantized f32 fragments.
//
// The roundings are the JAX block's and the first CUDA version's: x1, the
// LayerNorm output, q2, p, o, f and q, k, v are bf16 where they were bf16
// there, so splitting post_cross into three launches and geglu_ff into two
// (and ln_qkv's tiles) changes only the order of f32 sums. The TPU
// kernel's per-image block matrices, row-global max, -1e9 pad columns and
// -75 clamp are TPU artifacts and are not carried over (an exact per-head
// max instead).
//
// What bounds it on the H100 (SXM, 132 SMs): the products, 2 R N K (x2 for
// kGeglu) at 989 TFLOP/s; the bytes (A, W, the residual, out once) are far
// below at every main-path site. A CTA owns BM = 64 or 128 rows and BN =
// 64 or 128 columns, so the tiles that fill the card come from both
// dimensions: post_cross's C = 960 site (R = 512) runs 120 CTAs where the
// first version ran 16. The host plan (ops/block_kernel.py `gemm_plan`)
// takes the first of a launch kind's tiles that still gives every SM a
// CTA, and a CTA may walk several column tiles of its row block
// (`tiles_per_cta`) so the LayerNorm prologue is not redone per tile.
// Measured on the H100 by profile_gemm.py's cut builds, the products are
// not what bounds these launches: the LayerNorm, the cross-attention and
// the GEGLU's erf are CUDA-core work, and the ping-pong tiles let one
// warpgroup's epilogue run under the other's products.
//
// - Copies by TMA. W [K, N] stays row-major: boxes of 64 K-rows x 32
//   columns, 64-byte swizzled, read by wgmma as an MN-major B operand
//   (transpose bit), as the attention core reads V. A streamed [R, K] comes
//   in boxes of BM rows x 32 columns, K-major, as the attention core's Q.
//   One stage holds a K-step of 64: two A panels and BN / 32 W panels per
//   weight. The producer warp (one lane a ring) keeps the ring full and
//   waits only on the "empty" barriers; W panels wholly past N are not
//   loaded (their columns are never stored), nor is an A panel wholly past
//   K, whose stage slots are zeroed once where K % 64 != 0 (the W rows
//   facing them are zero-filled by TMA, so stale rows of the same CTA add
//   exactly 0).
// - The LayerNorm prologue (kCross, kGeglu, kQkv): the producer brings the
//   CTA's BM rows of src [R, K] into shared memory by TMA first (K / 32
//   boxes of BM rows, all in flight at once, on one barrier), then the
//   ring. The consumer warps normalise the panel in place, a warp two rows
//   at a time, in bf16x2 arithmetic (f32 statistics, each op rounded to
//   bf16, as the plain `layer_norm` of ops/block_kernel.py rounds), and
//   fence the generic proxy's writes before wgmma reads them. (Rows read
//   by the warps themselves would wait on one global load after another.)
//   The panel serves every column tile of the CTA: 120 KB at BM = 64,
//   K = 960.
// - Consumers: one or two warpgroups issue m64nBNk16 wgmma (A K-major, W
//   MN-major, both from shared memory) per K-step, keep one commit group in
//   flight and hand a stage back when the group after it is issued. A
//   split tile gives each warpgroup 64 of its rows; a ping-pong tile gives
//   two warpgroups alternate column tiles of all its 64 or 128 rows.
//   Epilogues work on the accumulator fragments in registers: no shared
//   staging tile. This thread holds rows 16 w + lane / 4 and + 8 of each
//   64-row wgmma tile, columns 8 j + 2 (lane % 4) + {0, 1}; after the
//   epilogue's arithmetic a 4 x 4 transpose of bf16x2 words inside each
//   quad (three shuffles) gives every thread 8 contiguous columns, so out
//   is written, and the residual read, in 16-byte rows. (Two columns a
//   store fill half of each 32-byte sector, and the residual's loads are
//   all issued before the first store, which they might alias.)
// - The cross-attention epilogue: a head is 32 or 64 columns, four or
//   eight n8 blocks, so the four threads of a quad hold one row's head; a
//   score is a quad sum of 8- or 16-term dot products. Rows of one tile may
//   belong to two images (image = row / S), each row reads its own image's
//   ck, cv. Past 16 tokens the context is walked in chunks of 16, twice
//   (cross_epilogue; kCrossLong, kCross64), so T has no limit. The context
//   is [B, T, C] for the U-Net and time-major [T, B, C] for the RARM
//   decode (DEC, read where it lies: image stride C, token stride B C).
//
// The decode chain's launches (DEC, csrc/decode_post_ff.cu; replaces
// rdm_tpu/ops/decode_kernel.py:275 `_post_ff_kernel`) and decode_attn's
// projection (kQkv, csrc/decode_attn.cu; with `_attn_kernel`'s int8 cache
// also the f32 k and v rows, `qkv_f32_rows`) run at R = B <= 64 rows,
// where a launch is bound by streaming W (16-32 FLOP a byte at B = 16-32)
// and one 64-row block has too few column tiles to keep the card's memory
// busy (12 at N = 768, 36 at the projection's 3C). So:
// - a K split across a thread-block cluster of KS <= 8 CTAs (grid.x =
//   column tiles x KS): rank r of a cluster takes the whole 64-wide
//   K-steps [r nkb / KS, (r + 1) nkb / KS) of its column tile and loads
//   only that slice of A (or of the LayerNorm's K columns feeding the
//   products) and of W. After its last K-step each rank r > 0 writes the
//   f32 fragments of its warps that hold live rows (rows < R) straight
//   into a region of rank 0's shared memory (mapa, st.shared::cluster)
//   and arrives on the cluster barrier; rank 0, once past it, adds them
//   to its own in rank order and runs the epilogue. No atomics, no global
//   workspace: two calls are bit-equal. The LayerNorm statistics need
//   whole rows, so each rank brings and normalises its live rows in full.
// - tokens stay on M and are not swapped onto N: at B = 16 a 64-row tile
//   wastes 3/4 of its tensor work, but a K-step's product (0.5 MFLOP,
//   ~0.07 us of an SM's tensor rate) is a fifth of the time its 8 KB of W
//   take to arrive at an SM's share of the memory rate, and the
//   epilogues, the LayerNorm panel and the cross-attention keep the
//   row-per-thread layout they were written for. TMA brings only the
//   first rb = R rounded up to 8 rows of A or src (DecodeArgs::rb); the
//   rows past them reach only outputs that are not stored.
// - the cross-attention, one query row per image and a 64-column head a
//   tile, runs four rows a warp over the tile's live rows
//   (cross_rows_epilogue): at B = 16 they all sit in warp 0's fragments.
// - int8 weights (WT = int8_t, the int8_weights serving mode): TMA brings
//   int8 [64, 64] boxes of W; the consumer warpgroup converts them to bf16
//   (exact) into the stage's bf16 W panels, fences the generic proxy and
//   runs the bf16 wgmma on them, as `_wdot` converts the codes to the
//   activation dtype. The bf16 column scale multiplies the f32
//   accumulator before the bias, in every epilogue.
// - programmatic dependent launch between the chain's launches: each CTA
//   lets the next launch start at once (`griddepcontrol.launch_dependents`
//   first); the producer issues the W loads of its first stages (no
//   earlier launch writes W), then `griddepcontrol.wait`, then the A /
//   src loads; the consumers wait too before an epilogue reads the
//   residual. The U-Net's launches stay plain stream launches.
#pragma once

#include <algorithm>
#include <map>
#include <mutex>
#include <tuple>
#include <type_traits>

#include "attn_fwd_sm90.cuh"

namespace rdmk {
namespace gemm {

using attn::bf16;

// kCross takes 32-column heads and up to kCtx context tokens; kCrossLong
// any number of tokens; kCross64 64-column heads and any number of tokens
// (cross_epilogue); kCross64Short, the decode's up to kCtx tokens, 64-column
// heads and one query row an image (cross_rows_epilogue).
enum Kind {
  kResidual = 0, kCross = 1, kGeglu = 2, kQkv = 3, kCross64 = 4,
  kCrossLong = 5, kCross64Short = 6
};
__host__ __device__ constexpr bool is_cross(int kind) {
  return kind == kCross || kind == kCross64 || kind == kCrossLong ||
         kind == kCross64Short;
}

constexpr int kBK = 64;           // K of a ring stage
constexpr int kPW = 32;           // columns of a TMA box (64 bytes)
constexpr int kWPanel = kBK * 64;  // bytes of one W box
constexpr int kMaxStages = 8;
constexpr int kSmemLimit = 232448;
constexpr int kMaxKS = 8;         // CTAs of a K-split cluster (portable)

// Shared memory of one CTA of BM rows after its base is aligned to 1 KB:
// the normalised A panel (all but kResidual; ceil(K / 64) * 2 panels of BM
// rows x 64 bytes) | the ring (stages x [two A panels (kResidual) | NW x
// BN / 32 W panels | with int8 weights, NW int8 boxes of 64 K-rows x BN
// bytes]) | a K split's receive region (split_bytes) | full[stages],
// empty[stages], the panel's barrier. Mirrored by ops/block_kernel.py
// `gemm_smem`.
__host__ __device__ constexpr int a_panel_bytes(int bm) { return bm * 64; }
__host__ __device__ constexpr int n_weights(int kind) {
  return kind == kGeglu ? 2 : 1;
}
__host__ __device__ constexpr int panel_region(int kind, int bm, int K) {
  return kind == kResidual ? 0 : (K + kBK - 1) / kBK * 2 * a_panel_bytes(bm);
}
__host__ __device__ constexpr int a_stage_bytes(int kind, int bm) {
  return kind == kResidual ? 2 * a_panel_bytes(bm) : 0;
}
__host__ __device__ constexpr int w_stage_bytes(int kind, int bn) {
  return n_weights(kind) * (bn / kPW) * kWPanel;  // bf16, as wgmma reads W
}
__host__ __device__ constexpr int stage_bytes(int kind, int bm, int bn,
                                              bool w8 = false) {
  return a_stage_bytes(kind, bm) + w_stage_bytes(kind, bn) +
         (w8 ? n_weights(kind) * bn * kBK : 0);
}
// With a K split over ks CTAs, rank 0 receives the others' f32 partial
// tiles in a region of its own after the ring: ks - 1 of them, the
// fragments of the warps that hold live rows (16 rows a warp, of the
// first `rows`). The others write them there while rank 0 still computes,
// so one cluster barrier after the writes is all the sum waits for.
__host__ __device__ constexpr int split_bytes(int kind, int bm, int bn,
                                              int ks, int rows) {
  return (ks - 1) * n_weights(kind) * (((rows < bm ? rows : bm) + 15) / 16) *
         64 * bn;
}
__host__ __device__ constexpr int data_bytes(int kind, int bm, int bn, int K,
                                             int stages, bool w8, int ks,
                                             int rows) {
  return panel_region(kind, bm, K) + stages * stage_bytes(kind, bm, bn, w8) +
         split_bytes(kind, bm, bn, ks, rows);
}
__host__ __device__ constexpr int smem_bytes(int kind, int bm, int bn, int K,
                                             int stages, bool w8 = false,
                                             int ks = 1, int rows = 64) {
  return 1024 + data_bytes(kind, bm, bn, K, stages, w8, ks, rows) +
         8 * (2 * stages + 1);
}

// What the prologue and epilogues read and write. Unused fields are null.
struct Args {
  const float* ln_s;   // LayerNorm scale and bias [K] (all but kResidual)
  const float* ln_b;
  const float* bias0;  // [N]: b (kResidual), ba (kGeglu)
  const float* bias1;  // [N]: bg (kGeglu)
  const bf16* res;     // [R, N] (kResidual)
  const bf16* ck;      // [R / S, T, N] (kCross)
  const bf16* cv;
  bf16* out;           // [R, N]; q [R, N / 3] (kQkv)
  int R, N, K, S, T, stages, tiles_per_cta;
  float scale;
  bf16* out1;          // k, v [R, N / 3] (kQkv)
  bf16* out2;
};

// A decode launch's (DEC) Args: the bf16 column scales [N] of int8 w0, w1.
// Its context ck, cv is time-major [T, R, N] (one query row per image),
// a layout fixed at compile time: a field more in Args moves ptxas's
// register allocation of every U-Net instantiation.
// rb: the rows a TMA box of A or src brings, R rounded up to 8 (at most
// BM): the tile's rows past them are never loaded, so a batch of 16 moves
// a quarter of a 64-row box (the rows they leave in shared memory reach
// only outputs that are not stored).
// outf1, outf2 (kQkv, the int8_kv mode): the f32 k and v rows [R, N / 3]
// beside their bf16 ones, or null.
struct DecodeArgs : Args {
  const bf16* ws0;
  const bf16* ws1;
  int rb;
  float* outf1;
  float* outf2;
};

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// q8(v) = clip(rint(v * inv), +-127) in the low byte of the result (inv
// = 1 / the scale, multiplied, not divided by; the product rounded on its
// own, so it is never contracted into anything). The clipped product plus
// 1.5 * 2^23 rounds half to even onto an integer, as rint does, and its
// bits are 0x4B400000 + the code: four FP32 operations where a float ->
// int conversion runs at an eighth of their rate on sm_90.
__device__ __forceinline__ uint32_t q8(float v, float inv) {
  const float c = fminf(fmaxf(__fmul_rn(v, inv), -127.f), 127.f);
  return __float_as_uint(__fadd_rn(c, 12582912.f));
}
// two codes in the low 16 bits (the upper ones are not zero)
__device__ __forceinline__ uint32_t q8x2(float a, float b, float inv) {
  return __byte_perm(q8(a, inv), q8(b, inv), 0x0040);
}
// the low 16 bits of a, then those of b
__device__ __forceinline__ uint32_t lo16x2(uint32_t a, uint32_t b) {
  return __byte_perm(a, b, 0x5410);
}

__device__ __forceinline__ float2 ld_bf16x2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Byte offset of 16-byte vector v (columns 8v .. 8v + 7) of row r in a
// panel region of BM-row, 64-byte-swizzled K-major panels: the layout a
// {32, BM} TMA box with CU_TENSOR_MAP_SWIZZLE_64B gives (16-byte chunk
// bits 4-5 XOR address bits 7-8).
__device__ __forceinline__ int panel_offset(int r, int v, int bm) {
  return (v >> 2) * a_panel_bytes(bm) + r * 64 +
         (((v & 3) ^ ((r >> 1) & 3)) << 4);
}

// The LayerNorm prologue: the panel region holds rows row0 .. row0 + BM of
// src once `pbar` completes (TMA; rows >= R zero-filled, or never loaded
// past a decode launch's rb, their outputs never stored); normalise its
// first `rows` rows in place (BM, or the live rows of a decode launch: a
// zero row left as it is adds 0 to rows never stored). A lane keeps its
// share of a row (vectors lane + 32 i, i < kLNVec: K <= 1536) and of the
// scale and bias, converted to bf16 once, in registers; a warp takes two
// rows at a time so their reductions overlap. Consumer threads only; ends
// with the consumers' barrier.
constexpr int kLNVec = 6;
constexpr int kMaxLNK = 32 * 8 * kLNVec;

template <int CW, int BM>
__device__ __forceinline__ void layer_norm_prologue(unsigned char* panel,
                                                    uint32_t pbar,
                                                    const Args& p,
                                                    int rows) {
  constexpr int kWarps = 4 * CW;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int K = p.K, nvec = K / 8;
  const float inv_k = 1.0f / (float)K;
  if (K % kBK)  // the zero panel past K of the last K-step
    for (int i = threadIdx.x; i < a_panel_bytes(BM) / 16; i += 128 * CW)
      *reinterpret_cast<uint4*>(panel + (K / kPW) * a_panel_bytes(BM) +
                                16 * i) = make_uint4(0, 0, 0, 0);
  __nv_bfloat162 gs[kLNVec][4], gb[kLNVec][4];
#pragma unroll
  for (int i = 0; i < kLNVec; ++i) {
    const int v = lane + 32 * i;
    if (v >= nvec) break;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = 8 * v + 2 * e;
      gs[i][e] = __float22bfloat162_rn(
          __ldg(reinterpret_cast<const float2*>(p.ln_s + c)));
      gb[i][e] = __float22bfloat162_rn(
          __ldg(reinterpret_cast<const float2*>(p.ln_b + c)));
    }
  }
  attn::mbar_wait(pbar, 0);
  for (int r0 = warp; r0 < rows; r0 += 2 * kWarps) {
    uint4 x[2][kLNVec];
    float sum[2] = {0.f, 0.f}, sq[2] = {0.f, 0.f};
#pragma unroll
    for (int k = 0; k < 2; ++k) {
#pragma unroll
      for (int i = 0; i < kLNVec; ++i) {
        const int v = lane + 32 * i;
        if (v >= nvec) break;
        x[k][i] = *reinterpret_cast<const uint4*>(
            panel + panel_offset(r0 + k * kWarps, v, BM));
        const __nv_bfloat162* h =
            reinterpret_cast<const __nv_bfloat162*>(&x[k][i]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(h[e]);
          sum[k] += f.x + f.y;
          sq[k] += f.x * f.x + f.y * f.y;
        }
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        sum[k] += __shfl_xor_sync(0xffffffffu, sum[k], o);
        sq[k] += __shfl_xor_sync(0xffffffffu, sq[k], o);
      }
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const float mean = sum[k] * inv_k;
      const float var = fmaxf(sq[k] * inv_k - mean * mean, 0.f);
      // native bf16x2 ops, each rounding its exact result once (the _rn
      // forms keep ptxas from contracting the mul and add into an fma)
      const __nv_bfloat162 mean2 = __float2bfloat162_rn(mean);
      const __nv_bfloat162 rstd2 = __float2bfloat162_rn(rsqrtf(var + 1e-5f));
#pragma unroll
      for (int i = 0; i < kLNVec; ++i) {
        const int v = lane + 32 * i;
        if (v >= nvec) break;
        __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&x[k][i]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const __nv_bfloat162 y = __hsub2_rn(h[e], mean2);
          h[e] = __hadd2_rn(__hmul2_rn(__hmul2_rn(y, rstd2), gs[i][e]),
                            gb[i][e]);
        }
        *reinterpret_cast<uint4*>(
            panel + panel_offset(r0 + k * kWarps, v, BM)) = x[k][i];
      }
    }
  }
  // the panel is read by wgmma (the async proxy) next
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync 1, %0;\n" ::"n"(128 * CW) : "memory");
}

__device__ __forceinline__ uint32_t pick(const uint32_t (&w)[4], int i) {
  return i == 0 ? w[0] : i == 1 ? w[1] : i == 2 ? w[2] : w[3];
}

// A quad's 4 x 4 transpose of bf16x2 words: w[jj] holds this thread's two
// columns (8 jj + 2 q, + 1; q = lane % 4) of n8 block jj of a 32-column
// group; returns the 8 columns of block q, in order (one 16-byte store).
// Every lane of the warp must call it.
__device__ __forceinline__ uint4 quad_transpose(const uint32_t (&w)[4],
                                                int q) {
  uint32_t got[4];
  got[0] = pick(w, q);
#pragma unroll
  for (int k = 1; k < 4; ++k)  // partner q ^ k sends its word of block q
    got[k] = __shfl_xor_sync(0xffffffffu, pick(w, q ^ k), k);
  return make_uint4(pick(got, q), pick(got, q ^ 1), pick(got, q ^ 2),
                    pick(got, q ^ 3));
}

__device__ __forceinline__ uint4 add_bf16x8(uint4 a, uint4 b) {
  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&b);
  uint32_t o[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 u = __bfloat1622float2(x[e]), v = __bfloat1622float2(y[e]);
    o[e] = attn::pack_bf16(u.x + v.x, u.y + v.y);
  }
  return make_uint4(o[0], o[1], o[2], o[3]);
}

// This thread's rows r0 + 8 h (h = 0, 1) and, after quad_transpose, the
// 8 columns n0 + 32 m + 8 q of each 32-column group m of the tile. Groups
// at or past N are skipped by the whole warp (N % 32 == 0).

// out = res + bf16(acc + bias): the residual's 16-byte rows are all loaded
// before the first store.
template <int BN>
__device__ __forceinline__ void residual_epilogue(const float (&acc)[BN / 2],
                                                  const Args& p, int r0,
                                                  int n0, int q) {
  constexpr int G = BN / 32;
  const int N = p.N;
  uint4 res[G][2];
#pragma unroll
  for (int m = 0; m < G; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + 8 * h, col = n0 + 32 * m + 8 * q;
      if (col < N && row < p.R)
        res[m][h] = __ldg(reinterpret_cast<const uint4*>(
            p.res + (size_t)row * N + col));
    }
#pragma unroll
  for (int m = 0; m < G; ++m) {
    if (n0 + 32 * m >= N) break;
    float2 b[4];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
      b[jj] = __ldg(reinterpret_cast<const float2*>(
          p.bias0 + n0 + 32 * m + 8 * jj + 2 * q));
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t w[4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int i = 4 * (4 * m + jj) + 2 * h;
        w[jj] = attn::pack_bf16(acc[i] + b[jj].x, acc[i + 1] + b[jj].y);
      }
      const uint4 y = quad_transpose(w, q);
      const int row = r0 + 8 * h;
      if (row < p.R)
        *reinterpret_cast<uint4*>(p.out + (size_t)row * N + n0 + 32 * m +
                                  8 * q) = add_bf16x8(res[m][h], y);
    }
  }
}

// out = bf16((acc_a + ba) * gelu(acc_g + bg)), exact erf.
template <int BN>
__device__ __forceinline__ void geglu_epilogue(const float (&a)[BN / 2],
                                               const float (&g)[BN / 2],
                                               const Args& p, int r0, int n0,
                                               int q) {
  const int N = p.N;
#pragma unroll
  for (int m = 0; m < BN / 32; ++m) {
    if (n0 + 32 * m >= N) break;
    float2 ba[4], bg[4];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int col = n0 + 32 * m + 8 * jj + 2 * q;
      ba[jj] = __ldg(reinterpret_cast<const float2*>(p.bias0 + col));
      bg[jj] = __ldg(reinterpret_cast<const float2*>(p.bias1 + col));
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t w[4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float f[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * (4 * m + jj) + 2 * h + e;
          const float av = a[i] + (e ? ba[jj].y : ba[jj].x);
          const float gv = g[i] + (e ? bg[jj].y : bg[jj].x);
          f[e] = av * (0.5f * gv * (1.0f + erff(gv * 0.7071067811865476f)));
        }
        w[jj] = attn::pack_bf16(f[0], f[1]);
      }
      const uint4 y = quad_transpose(w, q);
      const int row = r0 + 8 * h;
      if (row < p.R)
        *reinterpret_cast<uint4*>(p.out + (size_t)row * N + n0 + 32 * m +
                                  8 * q) = y;
    }
  }
}

// [q | k | v] = bf16(acc): a 32-column group lies in one of the three
// (N / 3 % 32 == 0), so the warp picks the output once a group.
template <int BN>
__device__ __forceinline__ void qkv_epilogue(const float (&acc)[BN / 2],
                                             const Args& p, int r0, int n0,
                                             int q) {
  const int N = p.N, C = N / 3;
#pragma unroll
  for (int m = 0; m < BN / 32; ++m) {
    const int gc = n0 + 32 * m;
    if (gc >= N) break;
    const int which = gc / C;
    bf16* out = which == 0 ? p.out : which == 1 ? p.out1 : p.out2;
    const int col = gc - which * C + 8 * q;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t w[4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int i = 4 * (4 * m + jj) + 2 * h;
        w[jj] = attn::pack_bf16(acc[i], acc[i + 1]);
      }
      const uint4 y = quad_transpose(w, q);
      const int row = r0 + 8 * h;
      if (row < p.R)
        *reinterpret_cast<uint4*>(out + (size_t)row * C + col) = y;
    }
  }
}

// The decode's kQkv (DEC) with f32 rows asked for: k and v as the f32
// accumulators hold them, unrounded, for the int8 cache's row scale over
// all C channels (a 64-column tile sees only its own). Two columns a
// store: a quad's four threads write one row's 32 contiguous bytes.
template <int BN>
__device__ __forceinline__ void qkv_f32_rows(const float (&acc)[BN / 2],
                                             const DecodeArgs& p, int r0,
                                             int n0, int q) {
  if (p.outf1 == nullptr) return;
  const int N = p.N, C = N / 3;
#pragma unroll
  for (int m = 0; m < BN / 32; ++m) {
    const int gc = n0 + 32 * m;
    if (gc >= N) break;
    const int which = gc / C;
    if (which == 0) continue;
    float* f = (which == 1 ? p.outf1 : p.outf2) + gc - which * C + 2 * q;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + 8 * h;
      if (row >= p.R) continue;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int i = 4 * (4 * m + jj) + 2 * h;
        *reinterpret_cast<float2*>(f + (size_t)row * C + 8 * jj) =
            make_float2(acc[i], acc[i + 1]);
      }
    }
  }
}

// Per head of HD columns (32 or 64) of the tile: q2 = bf16(acc), scores
// against the row's image's ck [T, HD] times scale, p = bf16(exp(s - max) /
// sum) with the exact max and sum over all T, o = sum_t p cv_t in f32 ->
// bf16. Without CHUNKS (kCross, T <= kCtx: the main path's T = 4) this is
// one pass with the scores in registers. With CHUNKS the tokens go in
// chunks of kCtx: a first pass walks the chunks for the running max and
// sum (the sum rescaled when the max grows), a second recomputes each
// chunk's scores for p and o. Two instantiations, so the main path's code
// is the one pass alone (with the walk beside it in one kernel the T = 4
// launch ran ~20% longer in the RDM forward, profile_rdm.py).
// Within a chunk tokens go four at a time, so their loads and quad sums
// overlap. Shuffles run on every lane (the head and T are uniform over the
// warp); rows >= R compute on a clamped row and store nothing.
constexpr int kCtx = 16;

template <int BN, int HD, bool CHUNKS, bool TM = false, bool O8 = false>
__device__ __forceinline__ void cross_epilogue(const float (&acc)[BN / 2],
                                               const Args& p, int r0, int n0,
                                               int q, int8_t* out8 = nullptr,
                                               float inv_out = 0.f) {
  static_assert(HD == 32 || HD == 64, "a head is one or two 32-column groups");
  constexpr int kChunk = 4;
  constexpr int NB = HD / 8;  // n8 blocks of a head
  const int N = p.N, T = p.T, cq = 2 * q;
#pragma unroll
  for (int hh = 0; hh < BN / HD; ++hh) {
    const int hcol = n0 + hh * HD;
    if (hcol >= N) break;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + 8 * h;
      const int img = min(row, p.R - 1) / p.S;
      // token t of the row's image at cbase + t * tstride: [B, T, C], or
      // time-major [T, B, C] (TM)
      const size_t cbase =
          (TM ? (size_t)img * N : (size_t)img * T * N) + hcol + cq;
      const size_t tstride = TM ? (size_t)p.R * N : N;
      float qv[2 * NB];
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        qv[2 * j] = round_bf16(acc[4 * (NB * hh + j) + 2 * h]);
        qv[2 * j + 1] = round_bf16(acc[4 * (NB * hh + j) + 2 * h + 1]);
      }
      float sc[kCtx];
      // the scores of tokens t0 .. t0 + kCtx - 1 (those < T) into sc; their max
      auto scores = [&](int t0) {
        float cm = -INFINITY;
#pragma unroll
        for (int tt = 0; tt < kCtx; tt += kChunk) {
          if (t0 + tt >= T) break;
          float s[kChunk];
#pragma unroll
          for (int u = 0; u < kChunk; ++u) {
            s[u] = 0.f;
            if (t0 + tt + u < T) {
              const bf16* kr = p.ck + cbase + (size_t)(t0 + tt + u) *
                                                  (TM ? tstride : N);
#pragma unroll
              for (int j = 0; j < NB; ++j) {
                const float2 k = ld_bf16x2(kr + 8 * j);
                s[u] += qv[2 * j] * k.x + qv[2 * j + 1] * k.y;
              }
            }
          }
#pragma unroll
          for (int u = 0; u < kChunk; ++u) {
            sc[tt + u] = quad_sum(s[u]) * p.scale;
            if (t0 + tt + u < T) cm = fmaxf(cm, sc[tt + u]);
          }
        }
        return cm;
      };
      // sc = exp(s - m) for the chunk's tokens
      auto exps = [&](int t0, float m) {
#pragma unroll
        for (int u = 0; u < kCtx; ++u) {
          if (t0 + u >= T) break;
          sc[u] = __expf(sc[u] - m);
        }
      };
      float o[2 * NB];
#pragma unroll
      for (int i = 0; i < 2 * NB; ++i) o[i] = 0.f;
      float den = 0.f, inv = 0.f;
      // o += p v over the chunk's tokens, p = bf16(sc * inv)
      auto pv = [&](int t0) {
#pragma unroll
        for (int u = 0; u < kCtx; ++u) {
          if (t0 + u >= T) break;
          const float pt = round_bf16(sc[u] * inv);
          const bf16* vr =
              p.cv + cbase + (size_t)(t0 + u) * (TM ? tstride : N);
#pragma unroll
          for (int j = 0; j < NB; ++j) {
            const float2 v = ld_bf16x2(vr + 8 * j);
            o[2 * j] += pt * v.x;
            o[2 * j + 1] += pt * v.y;
          }
        }
      };
      if constexpr (!CHUNKS) {  // one exact pass, the scores in registers
        const float mx = scores(0);
#pragma unroll
        for (int u = 0; u < kCtx; ++u) {
          if (u >= T) break;
          sc[u] = __expf(sc[u] - mx);
          den += sc[u];
        }
        inv = 1.0f / den;
        pv(0);
      } else {  // the running max and sum, then p and o chunk by chunk
        float mx = -INFINITY;
        for (int t0 = 0; t0 < T; t0 += kCtx) {
          const float nm = fmaxf(mx, scores(t0));
          den *= __expf(mx - nm);  // 0 on the first chunk
          exps(t0, nm);
#pragma unroll
          for (int u = 0; u < kCtx; ++u) {
            if (t0 + u >= T) break;
            den += sc[u];
          }
          mx = nm;
        }
        inv = 1.0f / den;
        for (int t0 = 0; t0 < T; t0 += kCtx) {
          scores(t0);
          exps(t0, mx);
          pv(t0);
        }
      }
#pragma unroll
      for (int m = 0; m < HD / 32; ++m) {
        uint32_t w[4];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          if constexpr (O8)  // the f32 o quantized (the s8 launches)
            w[jj] = q8x2(o[2 * (4 * m + jj)], o[2 * (4 * m + jj) + 1],
                         inv_out);
          else
            w[jj] = attn::pack_bf16(o[2 * (4 * m + jj)],
                                    o[2 * (4 * m + jj) + 1]);
        }
        const uint4 y = quad_transpose(w, q);
        if (row < p.R) {
          if constexpr (O8)  // four code pairs: one 8-byte store
            *reinterpret_cast<uint2*>(out8 + (size_t)row * N + hcol +
                                      32 * m + 8 * q) =
                make_uint2(lo16x2(y.x, y.y), lo16x2(y.z, y.w));
          else
            *reinterpret_cast<uint4*>(p.out + (size_t)row * N + hcol +
                                      32 * m + 8 * q) = y;
        }
      }
    }
  }
}

// ------------------------------------------ the decode launches' pieces

__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return (int)r;
}
__device__ __forceinline__ int cluster_size() {
  uint32_t n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(n));
  return (int)n;
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// The shared address `addr` of this CTA, in CTA `rank` of the cluster
__device__ __forceinline__ uint32_t cluster_addr(uint32_t addr, int rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(addr), "r"(rank));
  return remote;
}
// 16 bytes to a (cluster_addr) shared address of another CTA; fire and
// forget, made visible by the next cluster barrier's release
__device__ __forceinline__ void st_cluster_f4(uint32_t remote, float a,
                                              float b, float c, float d) {
  asm volatile(
      "st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(remote),
      "f"(a), "f"(b), "f"(c), "f"(d)
      : "memory");
}
__device__ __forceinline__ void prefetch_l1(const void* p) {
  asm volatile("prefetch.global.L1 [%0];\n" ::"l"(p));
}

// Rank 0 of a decode launch, waiting for the others' partial tiles: bring
// the lines its epilogue will read into L1 (the residual rows, or the
// rows' time-major context tokens of the tile's head), so the epilogue's
// loads do not wait on L2.
template <int KIND, int BN>
__device__ __forceinline__ void prefetch_epilogue(const Args& p, int r0,
                                                  int n0, int q) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + 8 * h;
    if (row >= p.R) break;
    if constexpr (KIND == kResidual) {
#pragma unroll
      for (int m = 0; m < BN / 32; ++m)
        if (n0 + 32 * m < p.N)
          prefetch_l1(p.res + (size_t)row * p.N + n0 + 32 * m + 8 * q);
    } else if constexpr (is_cross(KIND)) {
      // one 64-column head a tile: a token's k or v row is one 128-byte
      // line; the quad's four threads take every fourth token
      const size_t cb = (size_t)row * p.N + n0;  // [T, R, N]
      for (int t = q; t < p.T; t += 4) {
        prefetch_l1(p.ck + cb + (size_t)t * p.R * p.N);
        prefetch_l1(p.cv + cb + (size_t)t * p.R * p.N);
      }
    }
  }
}
// Programmatic dependent launch: wait for the launch before this one to
// finish and its writes to be visible (a no-op in a plain launch); let the
// launch after this one start.
__device__ __forceinline__ void griddep_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}
__device__ __forceinline__ void griddep_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// acc *= the bf16 scale of its column (int8 weights), before any bias
template <int BN>
__device__ __forceinline__ void scale_cols(float (&acc)[BN / 2],
                                           const bf16* ws, int N, int n0,
                                           int q) {
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = n0 + 8 * j + 2 * q;
    if (col >= N) break;
    const float2 s = ld_bf16x2(ws + col);
    acc[4 * j] *= s.x;
    acc[4 * j + 1] *= s.y;
    acc[4 * j + 2] *= s.x;
    acc[4 * j + 3] *= s.y;
  }
}

// The stage's int8 W boxes (NW x [64 K-rows, 64 columns], 64-byte rows
// swizzled as TMA lands them) -> its bf16 W panels (NW x 2 x [64 K-rows,
// 32 columns], the layout a bf16 box has), exactly; one warpgroup, each
// thread two 16-byte chunks of a box. A chunk of row r lies at r * 64 +
// ((c ^ (r / 2 % 4)) << 4) in both layouts. A code v becomes the f32
// 2^23 + v + 128 by a byte permute, minus 2^23 + 128 (exact), whose upper
// half is bf16(v) (|v| <= 128 needs 8 bits of mantissa): byte permutes
// and f32 adds, where an int -> float conversion runs at a quarter of
// their rate.
template <int NW>
__device__ __forceinline__ void convert_w8(unsigned char* w16,
                                           const unsigned char* w8) {
#pragma unroll
  for (int w = 0; w < NW; ++w)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = (threadIdx.x & 127) + 128 * i;
      const int r = idx & 63, c = idx >> 6, sw = (r >> 1) & 3;
      const uint4 v = *reinterpret_cast<const uint4*>(
          w8 + w * 64 * kBK + r * 64 + ((c ^ sw) << 4));
      const uint32_t* b = reinterpret_cast<const uint32_t*>(&v);
      uint32_t o[8];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const uint32_t x = b[e] ^ 0x80808080u;  // v + 128, four bytes
        uint32_t f[4];
#pragma unroll
        for (int k = 0; k < 4; ++k)
          f[k] = __float_as_uint(
              __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7650 + k)) -
              8388736.0f);
        o[2 * e] = __byte_perm(f[0], f[1], 0x7632);
        o[2 * e + 1] = __byte_perm(f[2], f[3], 0x7632);
      }
      unsigned char* panel = w16 + (2 * w + (c >> 1)) * kWPanel + r * 64;
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<uint4*>(panel +
                                  (((2 * (c & 1) + h) ^ sw) << 4)) =
            make_uint4(o[4 * h], o[4 * h + 1], o[4 * h + 2], o[4 * h + 3]);
    }
}

// The decode's cross-attention (kCross64Short, DEC: a 64-column tile is
// one head, T <= kCtx tokens, one query row per image, the context
// time-major [T, R, N]). At B = 16 a 64-row tile's live rows all sit in
// warp 0's fragments, so cross_epilogue would run the whole head's
// attention on one warp of the CTA. Instead the warpgroup stages bf16(q2)
// of its live rows in shared memory (`qs`, 128 bytes a row) and takes
// them four rows a warp, eight lanes a row and eight dims a lane (16-byte
// loads of k, v and out): a score is an 8-lane sum; p = bf16(exp(s - max)
// / sum) over all T, as cross_epilogue; o = sum_t p v_t in f32 -> bf16.
// Consumer threads only (one warpgroup); the shared memory it reuses must
// be free (the products and the split's sum done).
template <int BN>
__device__ __forceinline__ void cross_rows_epilogue(
    const float (&acc)[BN / 2], const Args& p, unsigned char* qs, int row0,
    int r_in, int n0, int q) {
  static_assert(BN == 64, "one 64-column head a tile");
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int live = min(64, p.R - row0), N = p.N, T = p.T;
  asm volatile("bar.sync 1, 128;\n" ::: "memory");  // qs is free
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r_in + 8 * h;
    if (r < live)
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
        *reinterpret_cast<uint32_t*>(qs + r * 128 + 16 * j + 4 * q) =
            attn::pack_bf16(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  }
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
  const int sub = lane >> 3, d0 = 8 * (lane & 7);
  for (int r0 = 4 * warp; r0 < live; r0 += 16) {
    const int row = min(r0 + sub, live - 1);  // every lane shuffles
    float qv[8];
    {
      const uint4 u = *reinterpret_cast<const uint4*>(qs + row * 128 + 2 * d0);
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(h[e]);
        qv[2 * e] = f.x;
        qv[2 * e + 1] = f.y;
      }
    }
    const size_t img = row0 + row;  // image = row (S = 1)
    const size_t cb = img * N + n0 + d0, ts = (size_t)p.R * N;
    float sc[kCtx];
    float mx = -INFINITY;
#pragma unroll
    for (int t = 0; t < kCtx; ++t) {
      if (t >= T) break;
      const uint4 u = *reinterpret_cast<const uint4*>(p.ck + cb + t * ts);
      const __nv_bfloat162* k = reinterpret_cast<const __nv_bfloat162*>(&u);
      float s = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(k[e]);
        s += qv[2 * e] * f.x + qv[2 * e + 1] * f.y;
      }
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      s += __shfl_xor_sync(0xffffffffu, s, 4);
      sc[t] = s * p.scale;
      mx = fmaxf(mx, sc[t]);
    }
    float den = 0.f;
#pragma unroll
    for (int t = 0; t < kCtx; ++t) {
      if (t >= T) break;
      sc[t] = __expf(sc[t] - mx);
      den += sc[t];
    }
    const float inv = 1.0f / den;
    float o[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) o[e] = 0.f;
#pragma unroll
    for (int t = 0; t < kCtx; ++t) {
      if (t >= T) break;
      const float pt = round_bf16(sc[t] * inv);
      const uint4 u = *reinterpret_cast<const uint4*>(p.cv + cb + t * ts);
      const __nv_bfloat162* v = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(v[e]);
        o[2 * e] += pt * f.x;
        o[2 * e + 1] += pt * f.y;
      }
    }
    if (r0 + sub < live)
      *reinterpret_cast<uint4*>(p.out + img * N + n0 + d0) =
          make_uint4(attn::pack_bf16(o[0], o[1]), attn::pack_bf16(o[2], o[3]),
                     attn::pack_bf16(o[4], o[5]), attn::pack_bf16(o[6], o[7]));
  }
}

// The decode's residual and GEGLU epilogues (DEC) the same way: the
// warpgroup stages the f32 accumulators of its live rows in shared memory
// (`stg`, [NW][64 rows][BN], 256 bytes a row) and takes them four rows a
// warp, eight columns a lane, with residual_epilogue's and
// geglu_epilogue's arithmetic and one 16-byte store a lane.
template <int KIND, int BN>
__device__ __forceinline__ void rows_epilogue(const float (&a)[BN / 2],
                                              const float (&g)[BN / 2],
                                              const Args& p,
                                              unsigned char* stg, int row0,
                                              int r_in, int n0, int q) {
  static_assert(BN == 64, "a row of the tile is 256 bytes of f32");
  constexpr int NW = n_weights(KIND);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int live = min(64, p.R - row0), N = p.N;
  asm volatile("bar.sync 1, 128;\n" ::: "memory");  // stg is free
#pragma unroll
  for (int w = 0; w < NW; ++w)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r_in + 8 * h;
      if (r < live)
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
          *reinterpret_cast<float2*>(stg + (w * 64 + r) * 256 + 32 * j +
                                     8 * q) =
              make_float2(w ? g[4 * j + 2 * h] : a[4 * j + 2 * h],
                          w ? g[4 * j + 2 * h + 1] : a[4 * j + 2 * h + 1]);
    }
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
  const int c0 = 8 * (lane & 7), col = n0 + c0;
  for (int row = 4 * warp + (lane >> 3); row < live; row += 16) {
    float v[NW][8];
#pragma unroll
    for (int w = 0; w < NW; ++w)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float4 f = *reinterpret_cast<const float4*>(
            stg + (w * 64 + row) * 256 + 4 * c0 + 16 * e);
        v[w][4 * e] = f.x;
        v[w][4 * e + 1] = f.y;
        v[w][4 * e + 2] = f.z;
        v[w][4 * e + 3] = f.w;
      }
    const size_t gr = (size_t)(row0 + row) * N + col;
    uint32_t o[4];
    if constexpr (KIND == kResidual) {
      const uint4 res = __ldg(reinterpret_cast<const uint4*>(p.res + gr));
      uint32_t y[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 b =
            __ldg(reinterpret_cast<const float2*>(p.bias0 + col + 2 * e));
        y[e] = attn::pack_bf16(v[0][2 * e] + b.x, v[0][2 * e + 1] + b.y);
      }
      const uint4 sum = add_bf16x8(res, make_uint4(y[0], y[1], y[2], y[3]));
      o[0] = sum.x;
      o[1] = sum.y;
      o[2] = sum.z;
      o[3] = sum.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float f[2];
        const float2 ba =
            __ldg(reinterpret_cast<const float2*>(p.bias0 + col + 2 * e));
        const float2 bg =
            __ldg(reinterpret_cast<const float2*>(p.bias1 + col + 2 * e));
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const float av = v[0][2 * e + u] + (u ? ba.y : ba.x);
          const float gv = v[NW - 1][2 * e + u] + (u ? bg.y : bg.x);
          f[u] = av * (0.5f * gv * (1.0f + erff(gv * 0.7071067811865476f)));
        }
        o[e] = attn::pack_bf16(f[0], f[1]);
      }
    }
    *reinterpret_cast<uint4*>(p.out + gr) = make_uint4(o[0], o[1], o[2], o[3]);
  }
}

// One CTA: rows [BM by, + BM) and column tiles [tiles_per_cta bx,
// + tiles_per_cta) of out; warps 0 .. 4 CW - 1 the consumers, warp 4 CW the
// producer. Split (PP false): warpgroup g owns rows 64 g .. 64 g + 63 of
// every column tile, BM = 64 CW. Ping-pong (PP true, CW = 2): warpgroup g
// owns the CTA's column tiles g, g + 2, ... with all BM rows (BM / 64 wgmma
// tiles), so one warpgroup's epilogue runs while the other's products do.
// Each ping-pong warpgroup then has a ring of its own, half the stages,
// filled by a producer lane of its own: one ring read by two warpgroups
// out of step would let a parity wait pass a phase early.
// ta: the streamed A (kResidual) or the LayerNorm's src (the others),
// [R, K], box {32, BM}; tw0, tw1: the weights (box {32, 64}, int8 {64, 64};
// tw1 only for kGeglu).
// DEC (the decode chain's launches: one 64 x 64 split tile a CTA, K % 64
// == 0): the K split over the cluster, programmatic dependent launch and
// live-row LayerNorm of the header's note; WT = int8_t only there.
template <int CW, int BM, int BN, bool PP, int KIND, typename WT = bf16,
          bool DEC = false>
__global__ void __launch_bounds__(128 * CW + 32,
                                  CW == 2 ? 1 : DEC ? 2 : BN == 64 ? 3 : 2)
    block_gemm_kernel(const __grid_constant__ CUtensorMap ta,
                      const __grid_constant__ CUtensorMap tw0,
                      const __grid_constant__ CUtensorMap tw1,
                      const std::conditional_t<DEC, DecodeArgs, Args> p) {
  using namespace attn;
  static_assert(PP ? CW == 2 && (BM == 64 || BM == 128) : BM == 64 * CW,
                "a split tile gives each warpgroup 64 rows");
  constexpr bool W8 = std::is_same<WT, int8_t>::value;
  static_assert(!DEC || (CW == 1 && BN == 64 && !PP),
                "a decode launch runs the 64 x 64 split tile");
  static_assert(!W8 || DEC, "int8 weights in the decode launches only");
  constexpr int kCons = 128 * CW;
  constexpr int MT = PP ? BM / 64 : 1;  // wgmma row tiles a warpgroup
  constexpr int NW = n_weights(KIND);
  constexpr bool kLN = KIND != kResidual;
  constexpr int kAPanel = a_panel_bytes(BM);
  constexpr int kAStage = a_stage_bytes(KIND, BM);
  constexpr int kStage = stage_bytes(KIND, BM, BN, W8);
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);
  const int ST = p.stages;
  const uint32_t panel = base;
  const uint32_t ring = base + panel_region(KIND, BM, p.K);
  // the K split: this CTA's rank in its cluster and the cluster's size
  const int kr = DEC ? cluster_rank() : 0, ks = DEC ? cluster_size() : 1;
  const uint32_t full = [&] {
    if constexpr (DEC)
      return base + data_bytes(KIND, BM, BN, p.K, ST, W8, ks, p.rb);
    else
      return ring + ST * kStage;
  }();
  const uint32_t empty = full + 8 * ST;
  const uint32_t pbar = empty + 8 * ST;  // the LayerNorm panel's arrival

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = blockIdx.y * BM;
  const int ntiles = (p.N + BN - 1) / BN;
  const int t_begin = (DEC ? blockIdx.x / ks : blockIdx.x) * p.tiles_per_cta;
  const int t_end = min(ntiles, t_begin + p.tiles_per_cta);
  const int nkb = (p.K + kBK - 1) / kBK;
  const int kb0 = DEC ? kr * nkb / ks : 0;  // this rank's K-steps
  const int kb1 = DEC ? (kr + 1) * nkb / ks : nkb;
  const bool k_tail = p.K % kBK != 0;  // the last K-step has one A panel
  const int RS = PP ? ST / 2 : ST;     // stages of a ring
  const int t_step = PP ? 2 : 1;       // a ring's column tiles

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, PP ? 4 : kCons / 32);  // its reader's warps
    }
    mbar_init(pbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (!kLN && k_tail) {  // stage slots an A panel past K leaves unwritten
    for (int s = 0; s < ST; ++s)
      for (int i = threadIdx.x; i < kAStage / 16; i += blockDim.x)
        *reinterpret_cast<uint4*>(gbase + (ring - base) + s * kStage +
                                  16 * i) = make_uint4(0, 0, 0, 0);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kCons / 32) {
    // ------------------------------------------------------ the producer
    if constexpr (DEC) {
      if (lane == 0) {
        // the next launch may start: it waits for this one to finish
        // before it reads what this one writes
        griddep_launch_dependents();
        const int n0 = t_begin * BN;
        const int npan = min(BN / kPW, (p.N - n0 + kPW - 1) / kPW);
        const int abytes = kLN ? 0 : 2 * p.rb * 64;
        const int wbytes = W8 ? NW * BN * kBK : NW * npan * kWPanel;
        const int nk = kb1 - kb0, pre = min(ST, nk);
        auto load_w = [&](uint32_t st, uint32_t bar, int kb) {
#pragma unroll
          for (int w = 0; w < NW; ++w) {
            if constexpr (W8)
              tma_load_2d(w ? &tw1 : &tw0,
                          st + kAStage + w_stage_bytes(KIND, BN) +
                              w * BN * kBK,
                          bar, n0, kb * kBK);
            else
              for (int q = 0; q < npan; ++q)
                tma_load_2d(w ? &tw1 : &tw0,
                            st + kAStage + (w * (BN / kPW) + q) * kWPanel,
                            bar, n0 + q * kPW, kb * kBK);
          }
        };
        // W of the first stages: no earlier launch writes it
        for (int i = 0; i < pre; ++i) {
          mbar_expect_tx(full + 8 * i, abytes + wbytes);
          load_w(ring + i * kStage, full + 8 * i, kb0 + i);
        }
        griddep_wait();  // A / src are the launch before's output
        if (kLN) {
          mbar_expect_tx(pbar, (p.K / kPW) * p.rb * 64);
          for (int q = 0; q < p.K / kPW; ++q)
            tma_load_2d(&ta, panel + q * kAPanel, pbar, q * kPW, row0);
        }
        int s = 0, phase = 0;
        for (int i = 0; i < nk; ++i) {
          const uint32_t st = ring + s * kStage, bar = full + 8 * s;
          if (i >= pre) {
            mbar_wait(empty + 8 * s, phase ^ 1);
            mbar_expect_tx(bar, abytes + wbytes);
            load_w(st, bar, kb0 + i);
          }
          if (!kLN)
            for (int a = 0; a < 2; ++a)
              tma_load_2d(&ta, st + a * kAPanel, bar,
                          (kb0 + i) * kBK + a * kPW, row0);
          if (++s == ST) {
            s = 0;
            phase ^= 1;
          }
        }
      }
      __syncwarp();
      if (ks > 1) {  // the consumers' cluster barrier
        cluster_arrive();
        cluster_wait();
      }
      return;
    }
    if (lane < (PP ? 2 : 1)) {  // lane r fills ring r
      if (kLN && lane == 0) {  // the LayerNorm's rows, every panel at once
        mbar_expect_tx(pbar, (p.K / kPW) * kAPanel);
        for (int q = 0; q < p.K / kPW; ++q)
          tma_load_2d(&ta, panel + q * kAPanel, pbar, q * kPW, row0);
      }
      const int r0s = lane * RS;  // the ring's first stage
      int s = 0, phase = 0, it = 0;
      for (int t = t_begin + lane; t < t_end; t += t_step) {
        const int n0 = t * BN;
        const int npan = min(BN / kPW, (p.N - n0 + kPW - 1) / kPW);
        for (int kb = 0; kb < nkb; ++kb, ++it) {
          const int apan = kLN ? 0 : (k_tail && kb == nkb - 1 ? 1 : 2);
          if (it >= RS) mbar_wait(empty + 8 * (r0s + s), phase ^ 1);
          const uint32_t st = ring + (r0s + s) * kStage;
          const uint32_t bar = full + 8 * (r0s + s);
          mbar_expect_tx(bar, apan * kAPanel + NW * npan * kWPanel);
          for (int a = 0; a < apan; ++a)
            tma_load_2d(&ta, st + a * kAPanel, bar, kb * kBK + a * kPW, row0);
#pragma unroll
          for (int w = 0; w < NW; ++w)
            for (int q = 0; q < npan; ++q)
              tma_load_2d(w ? &tw1 : &tw0,
                          st + kAStage + (w * (BN / kPW) + q) * kWPanel, bar,
                          n0 + q * kPW, kb * kBK);
          if (++s == RS) {
            s = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // ------------------------------------------------------- the consumers
  if (kLN)
    layer_norm_prologue<CW, BM>(gbase, pbar, p,
                                DEC ? min(BM, p.R - row0) : BM);
  const int g = warp >> 2;  // consumer warpgroup
  const int q = lane & 3;
  // the first of this thread's rows in wgmma row tile m: 64 m (ping-pong)
  // or 64 g (split) into the block, then 16 (warp % 4) + lane / 4
  const int r_in = 16 * (warp & 3) + (lane >> 2) + (PP ? 0 : 64 * g);
  const int r0s = PP ? g * RS : 0;  // this warpgroup's ring
  int s = 0, phase = 0, prev = 0;
  float acc[NW][MT][BN / 2];
  for (int t = t_begin + (PP ? g : 0); t < t_end; t += t_step) {
    for (int kb = kb0; kb < kb1; ++kb) {
      mbar_wait(full + 8 * (r0s + s), phase);
      const uint32_t st = ring + (r0s + s) * kStage;
      if constexpr (W8) {  // int8 boxes -> bf16 panels, for wgmma to read
        convert_w8<NW>(gbase + (st - base) + kAStage,
                       gbase + (st - base) + kAStage +
                           w_stage_bytes(KIND, BN));
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        asm volatile("bar.sync 1, %0;\n" ::"n"(kCons) : "memory");
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        const uint32_t a_k =
            (kLN ? panel + (2 * kb + (kk >> 1)) * kAPanel
                 : st + (kk >> 1) * kAPanel) +
            (PP ? 0 : 64 * g * 64) + (kk & 1) * 32;
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const uint64_t da = sw64_desc(a_k + m * 64 * 64, 16, 512);
#pragma unroll
          for (int w = 0; w < NW; ++w)
            wgmma_ss_mn<BN>(
                acc[w][m], da,
                sw64_desc(st + kAStage + w * (BN / kPW) * kWPanel + kk * 1024,
                          kWPanel, 512),
                DEC ? (kb != kb0 || kk != 0) : (kb | kk) != 0);
        }
      }
      wgmma_commit();
      wgmma_wait<1>();
      if (kb > kb0) {  // the group before this one is done with its stage
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + 8 * (r0s + prev));
      }
      prev = s;
      if (++s == RS) {
        s = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * (r0s + prev));
    if constexpr (DEC) {
      // a partial tile's float4 j of weight w for this thread, if its
      // warp holds live rows (warps 0 .. lw - 1), in the split's region
      const int lw = (p.rb + 15) / 16;
      const bool live = warp < lw;
      const uint32_t split = ring + ST * kStage;
      auto slot = [&](int r, int w, int j) {
        return split + 16 * ((((r - 1) * NW + w) * (BN / 8) + j) * 32 * lw +
                             threadIdx.x);
      };
      if (ks > 1) {
        if (kr != 0) {  // rank r's tile into rank 0's slot r - 1
          if (live) {
#pragma unroll
            for (int w = 0; w < NW; ++w)
#pragma unroll
              for (int j = 0; j < BN / 8; ++j)
                st_cluster_f4(cluster_addr(slot(kr, w, j), 0),
                              acc[w][0][4 * j], acc[w][0][4 * j + 1],
                              acc[w][0][4 * j + 2], acc[w][0][4 * j + 3]);
          }
          cluster_arrive();
          cluster_wait();
          return;
        }
        cluster_arrive();
      }
      griddep_wait();  // the residual is the launch before's output
      prefetch_epilogue<KIND, BN>(p, row0 + r_in, t * BN, q);
      if (ks > 1) {
        cluster_wait();  // the others' tiles have landed
        // in rank order (bit-equal calls); dead warps' rows are not stored
        for (int r = 1; r < (live ? ks : 1); ++r)
#pragma unroll
          for (int w = 0; w < NW; ++w)
#pragma unroll
            for (int j = 0; j < BN / 8; ++j) {
              const float4 v = *reinterpret_cast<const float4*>(
                  gbase + (slot(r, w, j) - base));
              acc[w][0][4 * j] += v.x;
              acc[w][0][4 * j + 1] += v.y;
              acc[w][0][4 * j + 2] += v.z;
              acc[w][0][4 * j + 3] += v.w;
            }
      }
    }
    const int n0 = t * BN;
#pragma unroll
    for (int m = 0; m < MT; ++m) {
#pragma unroll
      for (int w = 0; w < NW; ++w) fence_regs(acc[w][m]);
      if constexpr (W8) {
        scale_cols<BN>(acc[0][m], p.ws0, p.N, n0, q);
        if constexpr (NW == 2) scale_cols<BN>(acc[1][m], p.ws1, p.N, n0, q);
      }
      const int r0 = row0 + 64 * m + r_in;
      if constexpr (DEC && (KIND == kResidual || KIND == kGeglu))
        rows_epilogue<KIND, BN>(acc[0][m], acc[NW - 1][m], p, gbase, row0,
                                r_in, n0, q);
      else if constexpr (KIND == kResidual)
        residual_epilogue<BN>(acc[0][m], p, r0, n0, q);
      else if constexpr (DEC && KIND == kCross64Short)
        cross_rows_epilogue<BN>(acc[0][m], p, gbase, row0, r_in, n0, q);
      else if constexpr (is_cross(KIND))
        cross_epilogue<BN,
                       KIND == kCross64 || KIND == kCross64Short ? 64 : 32,
                       KIND == kCrossLong || KIND == kCross64, DEC>(
            acc[0][m], p, r0, n0, q);
      else if constexpr (KIND == kGeglu)
        geglu_epilogue<BN>(acc[0][m], acc[1][m], p, r0, n0, q);
      else {
        qkv_epilogue<BN>(acc[0][m], p, r0, n0, q);
        if constexpr (DEC) qkv_f32_rows<BN>(acc[0][m], p, r0, n0, q);
      }
    }
  }
}

// ------------------------------------------------------- the FF launch
//
// post_ff's fourth launch (csrc/post_ff.cu; after post_cross's three it
// completes rdm_tpu/ops/block_kernel.py:264 `_post_ff_kernel`):
//
//   h3  = bf16(LN3(xm; n3s, n3b))
//   f_r = bf16((h3 @ wa[:, F_r] + ba) * gelu(h3 @ wg[:, F_r] + bg))
//   y   = xm + bf16(sum_r f_r @ w2[F_r, :] + b2)
//
// with the GEGLU hidden f never in device memory, where the split pair
// (kGeglu, then kResidual over f) writes R x F bf16 and reads it back.
// A cluster of n CTAs (the plan's ranks; past 8 a non-portable cluster)
// takes one 64-row block, rank r the whole 64-column f tiles [r NT / n,
// (r + 1) NT / n) of the NT = F / 64:
// - kGeglu's LayerNorm prologue: xm's rows by TMA, LN3 in place (every
//   rank normalises the same rows);
// - per f tile the value and gate products as one m64n128k16 wgmma a k16
//   step (a stage's wa and wg boxes, 64 K-rows x 64 columns each, 128-byte
//   rows and swizzle, lie side by side: 128 columns, the value's n8 blocks
//   0-7 and the gate's 8-15 of the accumulator; 128-byte boxes ran the
//   launch 9-10% faster than the core's 64-byte ones), then
//   the GEGLU in registers, written as bf16 into the rank's f slice in
//   shared memory, in the panel's K-major 64-byte-swizzled layout, which
//   the down product reads as its A operand (40-96 KB at the U-Net's
//   sites);
// - the down product per 128-column tile of y, K = this rank's f columns,
//   the warpgroups on alternate tiles (each on a 64-column half of every
//   tile took ~10% longer: as many K-steps for half the products): a
//   partial tile of the sum over F, in registers;
// - the K split's sum across the cluster, decode_post_ff's scheme spread
//   over owners: 32-column unit u of y belongs to rank u mod n (every rank
//   runs epilogues); each rank writes its f32 partial of a unit straight
//   into a slot of the owner's shared memory (mapa, st.shared::cluster, a
//   slot per sender) over the LayerNorm panel, which every rank has left
//   once the first cluster barrier is passed. In rounds of `round_units`
//   units (a multiple of n and of 4, as many as the panel's bytes hold):
//   the round's partials written, a cluster barrier; each owner adds its
//   units' n partials in rank order, adds b2, rounds to bf16 and adds the
//   xm residual (residual_epilogue); a second barrier frees the slots for
//   the next round. No atomics and no global workspace: two calls are
//   bit-equal, and the split changes only the order of f32 sums (per f
//   slice, then in rank order).
// Two warpgroups a CTA on the same 64 rows and no producer warp: each
// warpgroup has a ring of its own that runs through both products (its
// wa | wg stages, 16 KB, then its w2 stages of 64 f rows x 64 columns),
// its first thread issuing a load as soon as the warpgroup's four warps
// have handed back the stage it refills, so a ring stays full across
// tiles, products and rounds, and every thread of the cluster takes part
// in the cluster barriers in program order. One warpgroup's epilogues and
// waits run under the other's products (one warpgroup a CTA ran the
// launch 5-14% longer). A producer warp filling both rings, with the sum's
// barriers as mbarriers the CTAs arrive on across the cluster, ran it no
// faster (within 3%): the ring's handshakes themselves cost ~0.45 us a
// K-step (profile_gemm.py --ff with every cut applied).
// Shared memory shapes the design: the LN3 panel (C x 128 bytes, 120 KB
// at C = 960), the f slice (8 KB an f tile) and the ring share the 227
// KB, so a CTA runs alone on its SM and a cluster of n takes n SMs of one
// GPC; the card keeps fewer clusters of more CTAs resident (on an H100
// SXM 66 of 2, 30 of 4, 7 of 9 to 16: `rdm_ff_clusters`). The plan
// (ops/block_kernel.py `ff_plan`) takes, of the rank counts that leave the
// ring 4 stages, the one with the fewest waves of clusters times a CTA's
// K-steps: 2, 6 and 16 ranks at C = 384, 576, 960 (8 images).
constexpr int kFFStage = 16384;  // a ring stage: 64 K-rows x 128 columns
constexpr int kFFBox = 8192;     // a weight box: 64 K-rows x 64 columns
constexpr int kFFUnit = 32;      // columns of a unit of the K split's sum
constexpr int kFFUnitBytes = 64 * kFFUnit * 4;  // its f32 partial, 8 KB
constexpr int kMaxFFRanks = 16;

// The FF launch's Args: ln_s, ln_b = n3s, n3b; bias0 = b2; res = xm; out =
// y; N = K = C; and the GEGLU's biases [F].
struct FFArgs : Args {
  const float* ba;
  const float* bg;
  int F, round_units;
};

// Shared memory of an FF CTA after its base is aligned to 1 KB: the LN3
// panel, later the round's unit slots (whichever is larger) | the f slice
// (the most f tiles a rank takes) | the ring | full[stages],
// empty[stages], the panel's barrier. Mirrored by ops/block_kernel.py
// `ff_smem`.
__host__ __device__ constexpr int ff_region0(int C, int round_units) {
  return panel_region(kGeglu, 64, C) > round_units * kFFUnitBytes
             ? panel_region(kGeglu, 64, C)
             : round_units * kFFUnitBytes;
}
__host__ __device__ constexpr int ff_f_bytes(int F, int ranks) {
  return (F / 64 + ranks - 1) / ranks * 2 * a_panel_bytes(64);
}
__host__ __device__ constexpr int ff_smem_bytes(int C, int F, int ranks,
                                                int stages,
                                                int round_units) {
  return 1024 + ff_region0(C, round_units) + ff_f_bytes(F, ranks) +
         stages * kFFStage + 8 * (2 * stages + 1);
}

// The wgmma descriptor of a k16 step of a ring stage, read MN-major: two
// 128-byte-swizzled boxes of 64 K-rows x 64 columns side by side (LBO, the
// next 64 columns, one box on; SBO, the next 8 K-rows, 1 KB on; layout
// type 1, the 128-byte swizzle).
__device__ __forceinline__ uint64_t ff_w_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)(kFFBox >> 4) << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

// f = bf16((acc_a + ba) * gelu(acc_g + bg)) of one 64-column f tile, exact
// erf, into f tile `lt` of the slice at `fs` after quad_transpose: this
// thread's rows r_in and r_in + 8, 16 bytes a store.
__device__ __forceinline__ void ff_geglu_smem(const float (&acc)[64],
                                              const FFArgs& p,
                                              unsigned char* fs, int lt,
                                              int col0, int r_in, int q) {
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    float2 ba[4], bg[4];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int col = col0 + 32 * m + 8 * jj + 2 * q;
      ba[jj] = __ldg(reinterpret_cast<const float2*>(p.ba + col));
      bg[jj] = __ldg(reinterpret_cast<const float2*>(p.bg + col));
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t w[4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float hv[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * (4 * m + jj) + 2 * h + e;
          const float av = acc[i] + (e ? ba[jj].y : ba[jj].x);
          const float gv = acc[32 + i] + (e ? bg[jj].y : bg[jj].x);
          hv[e] = av * (0.5f * gv * (1.0f + erff(gv * 0.7071067811865476f)));
        }
        w[jj] = attn::pack_bf16(hv[0], hv[1]);
      }
      *reinterpret_cast<uint4*>(
          fs + panel_offset(r_in + 8 * h, 4 * (2 * lt + m) + q, 64)) =
          quad_transpose(w, q);
    }
  }
}

// One CTA of the FF launch: rank `cluster_rank` of row block blockIdx.y,
// two warpgroups on the same 64 rows (g = 0, 1), each with a ring of its
// own (stages [g ST / 2, (g + 1) ST / 2)) whose loads its first thread
// issues: in the up products warpgroup g takes the f tiles g, g + 2, ...
// of the rank's slice, in the down product the 128-column y tiles g, g +
// 2, ... of each round of the sum. ta: xm [R, C], box {32, 64}; twa, twg: wa, wg [C, F]; tw2: w2
// [F, C] (boxes {64, 64}). BM = 64 only (a template, so only post_ff.cu
// builds it).
template <int BM>
__global__ void __launch_bounds__(256, 1)
    block_gemm_ff_kernel(const __grid_constant__ CUtensorMap ta,
                         const __grid_constant__ CUtensorMap twa,
                         const __grid_constant__ CUtensorMap twg,
                         const __grid_constant__ CUtensorMap tw2,
                         const FFArgs p) {
  using namespace attn;
  static_assert(BM == 64, "two warpgroups on 64 rows");
  constexpr int kAPanel = a_panel_bytes(BM);
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);
  const int C = p.K, ST = p.stages, RS = ST / 2, ru = p.round_units;
  const int n = cluster_size(), rank = cluster_rank();
  const int ntf = p.F / 64;
  const int f0 = rank * ntf / n, nft = (rank + 1) * ntf / n - f0;
  const int nkb = (C + kBK - 1) / kBK;  // the up products' K-steps
  const int nu = C / kFFUnit;
  const uint32_t panel = base;  // LN3(xm); the slots in the down phase
  const uint32_t fs = base + ff_region0(C, ru);
  const uint32_t ring = fs + ff_f_bytes(p.F, n);
  const uint32_t full = ring + ST * kFFStage;
  const uint32_t empty = full + 8 * ST;
  const uint32_t pbar = empty + 8 * ST;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, q = lane & 3;
  const int g = warp >> 2, tid = threadIdx.x & 127;  // warpgroup, its thread
  const int row0 = blockIdx.y * BM;
  const int r_in = 16 * (warp & 3) + (lane >> 2);
  // this warpgroup's loads: its f tiles' K-steps, then its half of every
  // y tile that has one (columns 128 ty + 64 g < C) for each f K-step
  // y's 128-column tiles go by rounds of tr; warpgroup g takes tiles
  // g, g + 2, ... of each round (`per` of a whole one)
  const int nty = (C + 127) / 128, tr = ru / 4, per = (tr - g + 1) / 2;
  int ndn = 0;
  for (int t0 = 0; t0 < nty; t0 += tr)
    ndn += (min(tr, nty - t0) - g + 1) / 2;
  const int n_up = (nft - g + 1) / 2 * nkb, n_all = n_up + ndn * nft;
  const uint32_t ring_g = ring + g * RS * kFFStage;
  const uint32_t full_g = full + 8 * g * RS, empty_g = empty + 8 * g * RS;

  // this warpgroup's ring load i into its stage: the up products' wa | wg
  // boxes (64 K-rows of f tile f0 + g + 2 (i / nkb)), then the down
  // product's w2 boxes (64 f rows of this rank's K-step, the 128 columns
  // of its y tile that lie before C)
  auto issue = [&](int i) {
    const uint32_t st = ring_g + (i % RS) * kFFStage;
    const uint32_t bar = full_g + 8 * (i % RS);
    if (i < n_up) {
      const int col = (f0 + g + 2 * (i / nkb)) * 64, k0 = (i % nkb) * kBK;
      mbar_expect_tx(bar, kFFStage);
      tma_load_2d(&twa, st, bar, col, k0);
      tma_load_2d(&twg, st + kFFBox, bar, col, k0);
    } else {
      const int j = (i - n_up) / nft, k0 = (f0 + (i - n_up) % nft) * kBK;
      const int n0 = 128 * (j / per * tr + g + 2 * (j % per));
      const int nbox = n0 + 64 < C ? 2 : 1;
      mbar_expect_tx(bar, nbox * kFFBox);
      for (int b = 0; b < nbox; ++b)
        tma_load_2d(&tw2, st + b * kFFBox, bar, n0 + 64 * b, k0);
    }
  };
  // hand back load j's stage (this warp's products on it are done); the
  // warpgroup's first thread refills it with load j + RS once all four of
  // its warps have
  auto release = [&](int j) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty_g + 8 * (j % RS));
    if (tid == 0 && j + RS < n_all) {
      mbar_wait(empty_g + 8 * (j % RS), (j / RS) & 1);
      issue(j + RS);
    }
    __syncwarp();
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4);  // its warpgroup's warps
    }
    mbar_init(pbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {  // xm's rows
    mbar_expect_tx(pbar, (C / kPW) * kAPanel);
    for (int c = 0; c < C / kPW; ++c)
      tma_load_2d(&ta, panel + c * kAPanel, pbar, c * kPW, row0);
  }
  if (tid == 0)  // each ring's first stages
    for (int i = 0; i < min(RS, n_all); ++i) issue(i);
  layer_norm_prologue<2, BM>(gbase, pbar, p, BM);

  // the up products, f tile by f tile, f into the slice
  float acc[64];
  int i = 0;  // this warpgroup's ring load
  for (int lt = g; lt < nft; lt += 2) {
    for (int kb = 0; kb < nkb; ++kb, ++i) {
      mbar_wait(full_g + 8 * (i % RS), (i / RS) & 1);
      const uint32_t st = ring_g + (i % RS) * kFFStage;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        wgmma_ss_mn<128>(
            acc,
            sw64_desc(panel + (2 * kb + (kk >> 1)) * kAPanel + (kk & 1) * 32,
                      16, 512),
            ff_w_desc(st + kk * 2048), (kb | kk) != 0);
      wgmma_commit();
      wgmma_wait<1>();
      if (kb > 0) release(i - 1);
    }
    wgmma_wait<0>();
    release(i - 1);
    fence_regs(acc);
    ff_geglu_smem(acc, p, gbase + (fs - base), lt, (f0 + lt) * 64, r_in, q);
  }
  // the slice (generic writes) is read by wgmma (the async proxy) next;
  // past this cluster barrier every rank's panel takes partial tiles
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
  cluster_arrive();

  // the down product, this warpgroup's y tiles of each round, and the K
  // split's sum by rounds
  for (int u0 = 0, rd = 0; u0 < nu; u0 += ru, ++rd) {
    const int u1 = min(nu, u0 + ru);
    bool waited = false;
    for (int ty = rd * tr + g; 4 * ty < u1; ty += 2) {
      for (int kb = 0; kb < nft; ++kb, ++i) {
        mbar_wait(full_g + 8 * (i % RS), (i / RS) & 1);
        const uint32_t st = ring_g + (i % RS) * kFFStage;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk)
          wgmma_ss_mn<128>(
              acc,
              sw64_desc(fs + (2 * kb + (kk >> 1)) * kAPanel + (kk & 1) * 32,
                        16, 512),
              ff_w_desc(st + kk * 2048), (kb | kk) != 0);
        wgmma_commit();
        wgmma_wait<1>();
        if (kb > 0) release(i - 1);
      }
      wgmma_wait<0>();
      release(i - 1);
      fence_regs(acc);
      // the owners' slots are free: every rank is past its up products
      // (the first round) or has read the round before's partials
      if (!waited) cluster_wait();
      waited = true;
      // unit u's partial into slot (u - u0) / n * n + rank of its owner
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int u = 4 * ty + m;
        if (u >= u1) break;
        const uint32_t to = cluster_addr(
            panel + ((u - u0) / n * n + rank) * kFFUnitBytes + 16 * tid,
            u % n);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int a0 = 4 * (4 * m + jj);
          st_cluster_f4(to + 2048 * jj, acc[a0], acc[a0 + 1], acc[a0 + 2],
                        acc[a0 + 3]);
        }
      }
    }
    if (!waited) cluster_wait();
    cluster_arrive();  // the round's partials have landed once all pass
    cluster_wait();
    // this rank's units of the round, alternately to the warpgroups: the
    // n partials in rank order, then y = xm + bf16(sum + b2)
    for (int u = u0 + rank + g * n; u < u1; u += 2 * n) {
      const unsigned char* from = gbase + (panel - base) +
                                  (u - u0) / n * n * kFFUnitBytes + 16 * tid;
      float s[16];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float4 v =
            *reinterpret_cast<const float4*>(from + 2048 * jj);
        s[4 * jj] = v.x;
        s[4 * jj + 1] = v.y;
        s[4 * jj + 2] = v.z;
        s[4 * jj + 3] = v.w;
      }
      for (int j = 1; j < n; ++j)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const float4 v = *reinterpret_cast<const float4*>(
              from + j * kFFUnitBytes + 2048 * jj);
          s[4 * jj] += v.x;
          s[4 * jj + 1] += v.y;
          s[4 * jj + 2] += v.z;
          s[4 * jj + 3] += v.w;
        }
      residual_epilogue<kFFUnit>(s, p, row0 + r_in, u * kFFUnit, q);
    }
    if (u1 < nu) cluster_arrive();  // this CTA's slots are read
  }
}

// ------------------------------------------------------- the s8 launches
//
// The int8 SpatialTransformer block (csrc/ln_qkv_q.cu, one launch: q | k |
// v; csrc/post_cross_q.cu, three: x1, cross, xmid; csrc/geglu_ff_q.cu,
// two: up, down; the serving mode's weight and activation int8 products):
// out = epilogue(A8 @ W8^T) with A8
// [R, K] and W8 [N, K] int8 codes, wgmma m64nBNk32.s32.s8.s8 into int32
// accumulators, dequantized in f32 as acc * (a * ws[n]), the product
// formed first (rdm_tpu/ops/block_kernel.py `_qdot`), before the bias.
// - 8-bit wgmma reads both operands K-major (it has no transpose bit), so
//   W goes in as it lies, [out, in] (`quantize_block_weights`): TMA boxes
//   of BN rows x 128 bytes of K, 128-byte swizzled, one per weight a stage;
//   a stage is a K-step of 128 codes, four k32 instructions. A streamed
//   (kStream8: the o codes of xmid, the hidden codes of down) comes in
//   boxes of BM rows x 128 bytes beside them. TMA zero-fills W's columns
//   past K, so whatever an A slot holds there adds exactly 0 (integer
//   products); the panels the prologue writes are zeroed past K anyway.
// - A not yet quantized (kQuant8: x1's attn; kNormQuant8: qkv's x, cross's
//   x1 and up's xm, LayerNorm first) is read by the consumer warps
//   straight from global memory, a row at a time (no bf16 panel in shared
//   memory), normalised in registers with layer_norm_prologue's bf16x2
//   arithmetic, quantized, and written as codes in the layout TMA would
//   have written (code_prologue); the panel of BM x K bytes serves every
//   column tile of the CTA: 60 KB at K = 960, BM = 64. The launches with a
//   prologue take 64-row tiles (`gemm_plan`'s "resq8", "cross8", "geglu8",
//   "qkv8"): a CTA of more rows redoes more of its row block's prologue
//   per column tile, and the 128-row ping-pong GEGLU tile spills
//   (profile_gemm.py --tiles8). kQkv's N = 3C walks many column tiles a
//   CTA; where shared memory keeps one CTA an SM (C = 960) its ping-pong
//   tile's eight warps share the prologue. Sharing the prologue across a
//   cluster of a row block's CTAs (codes written into every panel through
//   distributed shared memory) and loading the next rows under the
//   current rows' arithmetic were both measured slower (PERF.md §6).
// - Epilogues on the dequantized f32 fragments: qkv_epilogue and
//   residual_epilogue as the bf16 launches run them (q | k | v; x1, xmid,
//   down), cross_epilogue with the f32 o quantized to codes (O8: the TPU
//   kernel quantizes num / den in f32, never a bf16 o), geglu_q8_epilogue
//   (the gated hidden quantized from f32). Codes are written 8 bytes a
//   thread after quad_transpose.
constexpr int kBK8 = 128;  // K of an s8 ring stage: 128 codes
enum Src8 { kStream8 = 0, kQuant8 = 1, kNormQuant8 = 2 };

// Shared memory of an s8 CTA after its base is aligned to 1 KB: the code
// panel (kQuant8, kNormQuant8: ceil(K / 128) panels of BM rows x 128
// bytes) | the ring (stages x [one A box (kStream8) | NW W boxes of BN
// rows x 128 bytes]) | full[stages], empty[stages]. Mirrored by
// ops/block_kernel.py `gemm_smem` (its "*8" kinds).
__host__ __device__ constexpr int panel8_region(int src, int bm, int K) {
  return src == kStream8 ? 0 : (K + kBK8 - 1) / kBK8 * bm * kBK8;
}
__host__ __device__ constexpr int stage8_bytes(int kind, int src, int bm,
                                               int bn) {
  return (src == kStream8 ? bm * kBK8 : 0) + n_weights(kind) * bn * kBK8;
}
__host__ __device__ constexpr int smem8_bytes(int kind, int src, int bm,
                                              int bn, int K, int stages) {
  return 1024 + panel8_region(src, bm, K) +
         stages * stage8_bytes(kind, src, bm, bn) + 16 * stages;
}

// An s8 launch's Args: the f32 column scales [N] of w0, w1; a, the A
// codes' scale (inv_a = 1 / a, what the prologue quantizes its rows with);
// inv_out, 1 / the scale of the output codes out8 [R, N] (kCross*,
// kGeglu); src, the bf16 rows [R, K] the prologue quantizes.
struct Q8Args : Args {
  const float* ws0;
  const float* ws1;
  const bf16* src;
  int8_t* out8;
  float a, inv_a, inv_out;
};

// d[N / 2] (+)= A [64, 32] (shared, K-major, descriptor a) @ B^T, B [N, 32]
// (shared, K-major, descriptor b): int8 x int8 -> int32, exact.
template <int N>
__device__ __forceinline__ void wgmma_s8(int (&d)[N / 2], uint64_t a,
                                         uint64_t b, int scale_d);

template <>
__device__ __forceinline__ void wgmma_s8<64>(int (&d)[32], uint64_t a,
                                           uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31 "
      "}, %32, %33, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_s8<128>(int (&d)[64], uint64_t a,
                                           uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63 "
      "}, %64, %65, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <int N>
__device__ __forceinline__ void fence_regs_s32(int (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// Byte offset of codes 8v .. 8v + 7 of row r in an s8 panel region of
// BM-row, 128-byte-swizzled K-major panels: the layout a {128, BM} TMA box
// with CU_TENSOR_MAP_SWIZZLE_128B gives (16-byte chunk bits 4-6 XOR
// address bits 7-9).
__device__ __forceinline__ int panel8_offset(int r, int v, int bm) {
  return (v >> 4) * bm * kBK8 + r * kBK8 +
         ((((v >> 1) & 7) ^ (r & 7)) << 4) + ((v & 1) << 3);
}

// The code prologue: rows row0 .. row0 + BM of p.src [R, K] (rows past R
// read row R - 1; their outputs are never stored), LayerNormed (LN) as
// layer_norm_prologue does it, quantized with p.inv_a into the panel,
// codes past K zero. A lane loads its share of two rows (vectors lane +
// 32 i, 16 bytes each, K <= kMaxLNK) before it reduces either. Consumer
// threads only; ends with the consumers' barrier.
template <int CW, int BM, bool LN>
__device__ __forceinline__ void code_prologue(unsigned char* panel,
                                              const Q8Args& p, int row0) {
  constexpr int kWarps = 4 * CW;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int K = p.K, nvec = K / 8;
  const int pvec = (K + kBK8 - 1) / kBK8 * (kBK8 / 8);
  const float inv_k = 1.0f / (float)K, inv = p.inv_a;
  __nv_bfloat162 gs[kLNVec][4], gb[kLNVec][4];
  if constexpr (LN) {
#pragma unroll
    for (int i = 0; i < kLNVec; ++i) {
      const int v = lane + 32 * i;
      if (v >= nvec) break;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * v + 2 * e;
        gs[i][e] = __float22bfloat162_rn(
            __ldg(reinterpret_cast<const float2*>(p.ln_s + c)));
        gb[i][e] = __float22bfloat162_rn(
            __ldg(reinterpret_cast<const float2*>(p.ln_b + c)));
      }
    }
  }
  for (int r0 = warp; r0 < BM; r0 += 2 * kWarps) {
    uint4 x[2][kLNVec];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const uint4* src = reinterpret_cast<const uint4*>(
          p.src + (size_t)min(row0 + r0 + k * kWarps, p.R - 1) * K);
#pragma unroll
      for (int i = 0; i < kLNVec; ++i) {
        const int v = lane + 32 * i;
        if (v >= nvec) break;
        x[k][i] = __ldg(src + v);
      }
    }
    if constexpr (LN) {
      float sum[2] = {0.f, 0.f}, sq[2] = {0.f, 0.f};
#pragma unroll
      for (int k = 0; k < 2; ++k)
#pragma unroll
        for (int i = 0; i < kLNVec; ++i) {
          const int v = lane + 32 * i;
          if (v >= nvec) break;
          const __nv_bfloat162* h =
              reinterpret_cast<const __nv_bfloat162*>(&x[k][i]);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 f = __bfloat1622float2(h[e]);
            sum[k] += f.x + f.y;
            sq[k] += f.x * f.x + f.y * f.y;
          }
        }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          sum[k] += __shfl_xor_sync(0xffffffffu, sum[k], o);
          sq[k] += __shfl_xor_sync(0xffffffffu, sq[k], o);
        }
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const float mean = sum[k] * inv_k;
        const float var = fmaxf(sq[k] * inv_k - mean * mean, 0.f);
        const __nv_bfloat162 mean2 = __float2bfloat162_rn(mean);
        const __nv_bfloat162 rstd2 =
            __float2bfloat162_rn(rsqrtf(var + 1e-5f));
#pragma unroll
        for (int i = 0; i < kLNVec; ++i) {
          const int v = lane + 32 * i;
          if (v >= nvec) break;
          __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&x[k][i]);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const __nv_bfloat162 y = __hsub2_rn(h[e], mean2);
            h[e] = __hadd2_rn(__hmul2_rn(__hmul2_rn(y, rstd2), gs[i][e]),
                              gb[i][e]);
          }
        }
      }
    }
#pragma unroll
    for (int k = 0; k < 2; ++k)
#pragma unroll
      for (int i = 0; i < kLNVec; ++i) {
        const int v = lane + 32 * i;
        if (v >= pvec) break;
        uint2 c = make_uint2(0u, 0u);
        if (v < nvec) {
          const __nv_bfloat162* h =
              reinterpret_cast<const __nv_bfloat162*>(&x[k][i]);
          uint32_t w[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 f = __bfloat1622float2(h[e]);
            w[e] = q8x2(f.x, f.y, inv);
          }
          c = make_uint2(lo16x2(w[0], w[1]), lo16x2(w[2], w[3]));
        }
        *reinterpret_cast<uint2*>(
            panel + panel8_offset(r0 + k * kWarps, v, BM)) = c;
      }
  }
  // the panel is read by wgmma (the async proxy) next
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync 1, %0;\n" ::"n"(128 * CW) : "memory");
}

// f = acc * (a * ws[col]) in f32, each product rounded on its own (the
// int32 sum converted to f32 by round-to-nearest, as torch's .float());
// columns past N get scale 0 and are never stored.
template <int BN>
__device__ __forceinline__ void dequant(float (&f)[BN / 2],
                                        const int (&acc)[BN / 2],
                                        const float* ws, float a, int N,
                                        int n0, int q) {
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = n0 + 8 * j + 2 * q;
    const float2 w = col < N ? __ldg(reinterpret_cast<const float2*>(ws + col))
                             : make_float2(0.f, 0.f);
    const float s0 = __fmul_rn(a, w.x), s1 = __fmul_rn(a, w.y);
    f[4 * j] = __fmul_rn((float)acc[4 * j], s0);
    f[4 * j + 1] = __fmul_rn((float)acc[4 * j + 1], s1);
    f[4 * j + 2] = __fmul_rn((float)acc[4 * j + 2], s0);
    f[4 * j + 3] = __fmul_rn((float)acc[4 * j + 3], s1);
  }
}

// out8 = q8((a + ba) * gelu(g + bg), inv_out) from the dequantized value
// and gate fragments, exact erf, f never rounded to bf16; 8 codes a store.
template <int BN>
__device__ __forceinline__ void geglu_q8_epilogue(const float (&a)[BN / 2],
                                                  const float (&g)[BN / 2],
                                                  const Q8Args& p, int r0,
                                                  int n0, int q) {
  const int N = p.N;
#pragma unroll
  for (int m = 0; m < BN / 32; ++m) {
    if (n0 + 32 * m >= N) break;
    float2 ba[4], bg[4];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int col = n0 + 32 * m + 8 * jj + 2 * q;
      ba[jj] = __ldg(reinterpret_cast<const float2*>(p.bias0 + col));
      bg[jj] = __ldg(reinterpret_cast<const float2*>(p.bias1 + col));
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t w[4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float hv[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * (4 * m + jj) + 2 * h + e;
          const float av = __fadd_rn(a[i], e ? ba[jj].y : ba[jj].x);
          const float gv = __fadd_rn(g[i], e ? bg[jj].y : bg[jj].x);
          hv[e] =
              av * (0.5f * gv * (1.0f + erff(gv * 0.7071067811865476f)));
        }
        w[jj] = q8x2(hv[0], hv[1], p.inv_out);
      }
      const uint4 y = quad_transpose(w, q);
      const int row = r0 + 8 * h;
      if (row < p.R)
        *reinterpret_cast<uint2*>(p.out8 + (size_t)row * N + n0 + 32 * m +
                                  8 * q) =
            make_uint2(lo16x2(y.x, y.y), lo16x2(y.z, y.w));
    }
  }
}

// One s8 CTA: rows [BM by, + BM) and column tiles [tiles_per_cta bx,
// + tiles_per_cta) of out, split or ping-pong warpgroups and a ring per
// ping-pong warpgroup as block_gemm_kernel; SRC where A comes from (the
// ring, kStream8, or the code prologue). ta: the streamed A codes [R, K],
// box {128, BM} (kStream8; else unused); tw0, tw1: the weights [N, K],
// box {128, BN} (tw1 only for kGeglu).
template <int CW, int BM, int BN, bool PP, int KIND, int SRC>
__global__ void __launch_bounds__(128 * CW + 32,
                                  CW == 2 ? 1 : BN == 64 ? 3 : 2)
    block_gemm_s8_kernel(const __grid_constant__ CUtensorMap ta,
                         const __grid_constant__ CUtensorMap tw0,
                         const __grid_constant__ CUtensorMap tw1,
                         const Q8Args p) {
  using namespace attn;
  static_assert(PP ? CW == 2 && (BM == 64 || BM == 128) : BM == 64 * CW,
                "a split tile gives each warpgroup 64 rows");
  static_assert((KIND == kResidual) == (SRC != kNormQuant8),
                "the LayerNorm kinds normalise their rows; a residual "
                "launch streams its codes or quantizes its rows");
  constexpr int kCons = 128 * CW;
  constexpr int MT = PP ? BM / 64 : 1;  // wgmma row tiles a warpgroup
  constexpr int NW = n_weights(KIND);
  constexpr int kAPanel = BM * kBK8;    // a K-step of the CTA's rows
  constexpr int kAStage = SRC == kStream8 ? kAPanel : 0;
  constexpr int kWBox = BN * kBK8;      // a K-step of BN weight rows
  constexpr int kStage = kAStage + NW * kWBox;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);
  const int ST = p.stages;
  const uint32_t panel = base;
  const uint32_t ring = base + panel8_region(SRC, BM, p.K);
  const uint32_t full = ring + ST * kStage;
  const uint32_t empty = full + 8 * ST;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = blockIdx.y * BM;
  const int ntiles = (p.N + BN - 1) / BN;
  const int t_begin = blockIdx.x * p.tiles_per_cta;
  const int t_end = min(ntiles, t_begin + p.tiles_per_cta);
  const int nkb = (p.K + kBK8 - 1) / kBK8;
  const int RS = PP ? ST / 2 : ST;  // stages of a ring
  const int t_step = PP ? 2 : 1;    // a ring's column tiles

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, PP ? 4 : kCons / 32);  // its reader's warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kCons / 32) {
    // ------------------------------------------------------ the producer
    if (lane < (PP ? 2 : 1)) {  // lane r fills ring r
      const int r0s = lane * RS;
      int s = 0, phase = 0, it = 0;
      for (int t = t_begin + lane; t < t_end; t += t_step)
        for (int kb = 0; kb < nkb; ++kb, ++it) {
          if (it >= RS) mbar_wait(empty + 8 * (r0s + s), phase ^ 1);
          const uint32_t st = ring + (r0s + s) * kStage;
          const uint32_t bar = full + 8 * (r0s + s);
          mbar_expect_tx(bar, kStage);  // boxes count whole, fill included
          if (SRC == kStream8) tma_load_2d(&ta, st, bar, kb * kBK8, row0);
#pragma unroll
          for (int w = 0; w < NW; ++w)
            tma_load_2d(w ? &tw1 : &tw0, st + kAStage + w * kWBox, bar,
                        kb * kBK8, t * BN);
          if (++s == RS) {
            s = 0;
            phase ^= 1;
          }
        }
    }
    return;
  }

  // ------------------------------------------------------- the consumers
  if constexpr (SRC != kStream8)
    code_prologue<CW, BM, SRC == kNormQuant8>(gbase, p, row0);
  const int g = warp >> 2;  // consumer warpgroup
  const int q = lane & 3;
  const int r_in = 16 * (warp & 3) + (lane >> 2) + (PP ? 0 : 64 * g);
  const int r0s = PP ? g * RS : 0;  // this warpgroup's ring
  int s = 0, phase = 0, prev = 0;
  int acc[NW][MT][BN / 2];
  for (int t = t_begin + (PP ? g : 0); t < t_end; t += t_step) {
    for (int kb = 0; kb < nkb; ++kb) {
      mbar_wait(full + 8 * (r0s + s), phase);
      const uint32_t st = ring + (r0s + s) * kStage;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK8 / 32; ++kk) {
        const uint32_t a_k = (SRC == kStream8 ? st : panel + kb * kAPanel) +
                             (PP ? 0 : 64 * g * kBK8) + kk * 32;
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const uint64_t da = sw_desc<kBK8>(a_k + m * 64 * kBK8);
#pragma unroll
          for (int w = 0; w < NW; ++w)
            wgmma_s8<BN>(acc[w][m], da,
                         sw_desc<kBK8>(st + kAStage + w * kWBox + kk * 32),
                         (kb | kk) != 0);
        }
      }
      wgmma_commit();
      wgmma_wait<1>();
      if (kb > 0) {  // the group before this one is done with its stage
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + 8 * (r0s + prev));
      }
      prev = s;
      if (++s == RS) {
        s = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * (r0s + prev));
    const int n0 = t * BN;  // the tile's first column
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      float f[NW][BN / 2];
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        fence_regs_s32(acc[w][m]);
        dequant<BN>(f[w], acc[w][m], w ? p.ws1 : p.ws0, p.a, p.N, n0, q);
      }
      const int r0 = row0 + 64 * m + r_in;
      if constexpr (KIND == kResidual)
        residual_epilogue<BN>(f[0], p, r0, n0, q);
      else if constexpr (KIND == kGeglu)
        geglu_q8_epilogue<BN>(f[0], f[NW - 1], p, r0, n0, q);
      else if constexpr (KIND == kQkv)
        qkv_epilogue<BN>(f[0], p, r0, n0, q);
      else
        cross_epilogue<BN, KIND == kCross64 ? 64 : 32, KIND != kCross,
                       false, true>(f[0], p, r0, n0, q, p.out8, p.inv_out);
    }
  }
}

// ------------------------------------------------------------------- host

// A launch's plan (ops/block_kernel.py `gemm_plan`): rows BM and columns
// BN of a tile, ping-pong or split warpgroups, column tiles a CTA walks,
// ring stages. The tiles built are those of `GEMM_TILES` there: split
// (BM, BN) = (128, 128), (64, 128), (64, 64) for kResidual; split
// (64, 64) for the cross kinds; ping-pong (128, 64) and (64, 64) for
// kGeglu; split (128, 128) and ping-pong (64, 128) for kQkv.
// ks: CTAs of a K-split cluster (the decode launches; 1 elsewhere).
struct Plan {
  int bm, bn, pp, tiles_per_cta, stages;
  int ks = 1;
};

inline bool plan_ok(const Plan& pl, int kind, int K) {
  const bool built =
      kind == kResidual
          ? !pl.pp && ((pl.bm == 128 && pl.bn == 128) ||
                       (pl.bm == 64 && (pl.bn == 64 || pl.bn == 128)))
      : is_cross(kind) ? !pl.pp && pl.bm == 64 && pl.bn == 64
      : kind == kGeglu
          ? pl.pp && pl.bn == 64 && (pl.bm == 64 || pl.bm == 128)
          : pl.bn == 128 && pl.bm == (pl.pp ? 64 : 128);
  return built && (pl.pp == 0 || pl.pp == 1) && pl.tiles_per_cta >= 1 &&
         pl.stages >= (pl.pp ? 4 : 2) && pl.stages % (pl.pp ? 2 : 1) == 0 &&
         pl.stages <= kMaxStages &&
         smem_bytes(kind, pl.bm, pl.bn, K, pl.stages) <= kSmemLimit;
}

// The tensor map of an int8 row-major [rows, cols] matrix: boxes
// {box_cols, box_rows}, a box's rows swizzled across their 128 bytes (the
// s8 launches' boxes of 128 codes) or else across 64 bytes, as a bf16 box
// of 32 columns is; rows and columns past the matrix zero-filled.
inline bool make_map_u8(CUtensorMap* map, const void* ptr, int rows,
                        int cols, int box_cols, int box_rows) {
  const attn::EncodeTiledFn fn = attn::encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(ptr),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            box_cols == kBK8 ? CU_TENSOR_MAP_SWIZZLE_128B
                             : CU_TENSOR_MAP_SWIZZLE_64B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The tensor map of a row-major [rows, cols] matrix of `esize`-byte
// elements (bf16 or int8) in boxes {box_cols, box_rows} with no swizzle: a
// box lands in shared memory row after row as it lies in memory (for
// readers of 16-byte runs along a row, as decode_attn's consumers are).
inline bool make_map_flat(CUtensorMap* map, const void* ptr, int rows,
                          int cols, int box_cols, int box_rows, int esize) {
  const attn::EncodeTiledFn fn = attn::encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * esize};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return fn(map, esize == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                            : CU_TENSOR_MAP_DATA_TYPE_UINT8,
            2, const_cast<void*>(ptr), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A kept tensor map's key: (layout, device, pointer, six numbers). kMap2d's
// are rows, cols, box_cols, box_rows, esize, swizzle (cached_map);
// kMapBshd's B, S, H, D, rows, esize (cached_map_bshd).
enum { kMap2d, kMapBshd };
typedef std::tuple<int, int, uintptr_t, int, int, int, int, int, int> MapKey;

// The tensor map `key` describes, built once and kept: a map holds only the
// address, shape and box, so a new tensor at the same address with the
// same shape is described by the same map. The weights and caches live
// across calls; activations and scratch come back to the same addresses
// from PyTorch's caching allocator, call after call.
inline bool kept_map(CUtensorMap* map, const MapKey& key) {
  static std::mutex mu;
  static std::map<MapKey, CUtensorMap> cache;
  std::lock_guard<std::mutex> lock(mu);
  auto it = cache.find(key);
  if (it == cache.end()) {
    const void* ptr = reinterpret_cast<const void*>(std::get<2>(key));
    const int d0 = std::get<3>(key), d1 = std::get<4>(key),
              d2 = std::get<5>(key), d3 = std::get<6>(key),
              d4 = std::get<7>(key), d5 = std::get<8>(key);
    CUtensorMap m;
    if (!(std::get<0>(key) == kMapBshd
              ? attn::make_map(&m, ptr, d0, d1, d2, d3, d4, d5)
          : !d5       ? make_map_flat(&m, ptr, d0, d1, d2, d3, d4)
          : d4 == 2   ? attn::make_map_2d(&m, ptr, d0, d1, d2, d3)
                      : make_map_u8(&m, ptr, d0, d1, d2, d3)))
      return false;
    if (cache.size() >= 4096) cache.clear();
    it = cache.emplace(key, m).first;
  }
  *map = it->second;
  return true;
}

// The kept tensor map of a row-major [rows, cols] matrix of `esize`-byte
// elements (bf16 or int8) in boxes {box_cols, box_rows}, swizzled as the
// core's operands are (make_map_2d, make_map_u8) or, with swizzle off,
// flat (make_map_flat).
inline bool cached_map(CUtensorMap* map, int dev, const void* ptr, int rows,
                       int cols, int box_cols, int box_rows, int esize,
                       bool swizzle = true) {
  return kept_map(map, MapKey(kMap2d, dev, reinterpret_cast<uintptr_t>(ptr),
                              rows, cols, box_cols, box_rows, esize,
                              swizzle));
}

// The kept tensor map of a BSHD tensor [B, S, H, D] of `esize`-byte
// elements in boxes of `rows` rows of one head (attn::make_map).
inline bool cached_map_bshd(CUtensorMap* map, int dev, const void* ptr,
                            int B, int S, int H, int D, int rows, int esize) {
  return kept_map(map, MapKey(kMapBshd, dev, reinterpret_cast<uintptr_t>(ptr),
                              B, S, H, D, rows, esize));
}

// The tensor map of a bf16 weight [rows, cols] (boxes {32, 64}).
inline bool weight_map(CUtensorMap* map, int dev, const void* w, int rows,
                       int cols) {
  return cached_map(map, dev, w, rows, cols, kPW, kBK, 2);
}

template <int CW, int BM, int BN, bool PP, int KIND>
cudaError_t launch_tile(const CUtensorMap& ta, const CUtensorMap& tw0,
                        const CUtensorMap& tw1, const Args& a, int dev,
                        cudaStream_t stream) {
  static unsigned long long smem_set = 0;  // the opt-in, once per device
  static std::mutex mu;
  {
    std::lock_guard<std::mutex> lock(mu);
    const cudaError_t e =
        attn::allow_smem(block_gemm_kernel<CW, BM, BN, PP, KIND>, kSmemLimit,
                         dev, smem_set);
    if (e != cudaSuccess) return e;
  }
  const int ntiles = (a.N + BN - 1) / BN;
  const dim3 grid((ntiles + a.tiles_per_cta - 1) / a.tiles_per_cta,
                  (a.R + BM - 1) / BM);
  block_gemm_kernel<CW, BM, BN, PP, KIND>
      <<<grid, 128 * CW + 32, smem_bytes(KIND, BM, BN, a.K, a.stages),
         stream>>>(ta, tw0, tw1, a);
  return cudaGetLastError();
}

// One launch of the core: out = epilogue(A @ W). A is `a_src` [R, K],
// streamed (kResidual) or normalised (the others); w0 (and w1 for kGeglu)
// [K, N]. Returns a cudaError_t.
template <int KIND>
int launch(const Plan& pl, const void* a_src, const void* w0, const void* w1,
           Args a, cudaStream_t stream) {
  if (!plan_ok(pl, KIND, a.K) || a.R < 1 || a.N % kPW || a.K % kPW ||
      (KIND != kResidual && a.K > kMaxLNK))
    return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t e = attn::bind_device(&dev);
  if (e != cudaSuccess) return (int)e;
  CUtensorMap ta, tw0, tw1;
  if (!weight_map(&tw0, dev, w0, a.K, a.N) ||
      !weight_map(&tw1, dev, KIND == kGeglu ? w1 : w0, a.K, a.N) ||
      !attn::make_map_2d(&ta, a_src, a.R, a.K, kPW, pl.bm))
    return (int)cudaErrorInvalidValue;
  a.stages = pl.stages;
  a.tiles_per_cta = pl.tiles_per_cta;
  if constexpr (KIND == kQkv)
    e = pl.pp ? launch_tile<2, 64, 128, true, KIND>(ta, tw0, tw1, a, dev,
                                                    stream)
              : launch_tile<2, 128, 128, false, KIND>(ta, tw0, tw1, a, dev,
                                                      stream);
  else if constexpr (KIND == kGeglu)
    e = pl.bm == 128
            ? launch_tile<2, 128, 64, true, KIND>(ta, tw0, tw1, a, dev,
                                                  stream)
            : launch_tile<2, 64, 64, true, KIND>(ta, tw0, tw1, a, dev,
                                                 stream);
  else if (pl.bm == 64 && pl.bn == 64)
    e = launch_tile<1, 64, 64, false, KIND>(ta, tw0, tw1, a, dev, stream);
  else if constexpr (KIND == kResidual)
    e = pl.bm == 128
            ? launch_tile<2, 128, 128, false, KIND>(ta, tw0, tw1, a, dev,
                                                    stream)
            : launch_tile<1, 64, 128, false, KIND>(ta, tw0, tw1, a, dev,
                                                   stream);
  return (int)e;
}

// One launch of the decode chain (DEC): out = epilogue(A @ W) at R rows
// with the 64 x 64 split tile, a CTA a column tile, the K-steps split over
// clusters of pl.ks CTAs; ck, cv time-major [T, R, N]; WT = int8_t: w0 /
// w1 int8 codes with a.ws0 / a.ws1 their column scales. pdl: the launch
// may start while the one before it in the stream finishes (programmatic
// stream serialization). Returns a cudaError_t; cudaErrorInvalidValue for
// a plan or shape it does not take.
template <int KIND, typename WT>
int launch_decode(const Plan& pl, const void* a_src, const void* w0,
                  const void* w1, DecodeArgs a, bool pdl,
                  cudaStream_t stream) {
  constexpr bool W8 = std::is_same<WT, int8_t>::value;
  constexpr int BM = 64, BN = 64;
  auto kernel = block_gemm_kernel<1, BM, BN, false, KIND, WT, true>;
  const int nkb = a.K / kBK;
  a.rb = a.R >= BM ? BM : (a.R + 7) / 8 * 8;
  const int smem = smem_bytes(KIND, BM, BN, a.K, pl.stages, W8, pl.ks, a.rb);
  if (pl.bm != BM || pl.bn != BN || pl.pp != 0 || pl.tiles_per_cta != 1 ||
      pl.stages < 2 || pl.stages > kMaxStages || smem > kSmemLimit ||
      pl.ks < 1 || pl.ks > kMaxKS || pl.ks > nkb || a.R < 1 ||
      a.N < BN || a.N % BN || a.K < kBK || a.K % kBK ||
      (KIND != kResidual && a.K > kMaxLNK) ||
      (is_cross(KIND) && KIND != kCross64 && a.T > kCtx))
    return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t e = attn::bind_device(&dev);
  if (e != cudaSuccess) return (int)e;
  const int wbox = W8 ? BN : kPW, esize = W8 ? 1 : 2;
  CUtensorMap ta, tw0, tw1;
  if (!cached_map(&tw0, dev, w0, a.K, a.N, wbox, kBK, esize) ||
      !cached_map(&tw1, dev, KIND == kGeglu ? w1 : w0, a.K, a.N, wbox, kBK,
                  esize) ||
      !cached_map(&ta, dev, a_src, a.R, a.K, kPW, a.rb, 2))
    return (int)cudaErrorInvalidValue;
  a.stages = pl.stages;
  a.tiles_per_cta = 1;
  static unsigned long long smem_set = 0;  // the opt-in, once per device
  static std::mutex mu;
  {
    std::lock_guard<std::mutex> lock(mu);
    e = attn::allow_smem(kernel, kSmemLimit, dev, smem_set);
    if (e != cudaSuccess) return (int)e;
  }
  return attn::launch_ex(kernel, dim3(a.N / BN * pl.ks, (a.R + BM - 1) / BM),
                         128 + 32, smem, stream, pl.ks, pdl, ta, tw0, tw1, a);
}


// ------------------------------------------------ the s8 launches, host

// An s8 plan's tiles are those of `GEMM_TILES` there ("residual8": split
// (128, 128), (64, 128), (64, 64); "resq8", "cross8": split (64, 64);
// "geglu8": ping-pong (64, 64); "qkv8": split or ping-pong (64, 128)).
inline bool plan8_ok(const Plan& pl, int kind, int src, int K) {
  const bool built =
      kind == kResidual && src == kStream8
          ? !pl.pp && ((pl.bm == 128 && pl.bn == 128) ||
                       (pl.bm == 64 && (pl.bn == 64 || pl.bn == 128)))
      : kind == kQkv ? pl.bm == 64 && pl.bn == 128
                     : pl.pp == (kind == kGeglu) && pl.bm == 64 && pl.bn == 64;
  return built && pl.ks == 1 && pl.tiles_per_cta >= 1 &&
         pl.stages >= (pl.pp ? 4 : 2) && pl.stages % (pl.pp ? 2 : 1) == 0 &&
         pl.stages <= kMaxStages &&
         smem8_bytes(kind, src, pl.bm, pl.bn, K, pl.stages) <= kSmemLimit;
}

template <int CW, int BM, int BN, bool PP, int KIND, int SRC>
cudaError_t launch_tile8(const CUtensorMap& ta, const CUtensorMap& tw0,
                         const CUtensorMap& tw1, const Q8Args& a, int dev,
                         cudaStream_t stream) {
  static unsigned long long smem_set = 0;  // the opt-in, once per device
  static std::mutex mu;
  {
    std::lock_guard<std::mutex> lock(mu);
    const cudaError_t e = attn::allow_smem(
        block_gemm_s8_kernel<CW, BM, BN, PP, KIND, SRC>, kSmemLimit, dev,
        smem_set);
    if (e != cudaSuccess) return e;
  }
  const int ntiles = (a.N + BN - 1) / BN;
  const dim3 grid((ntiles + a.tiles_per_cta - 1) / a.tiles_per_cta,
                  (a.R + BM - 1) / BM);
  block_gemm_s8_kernel<CW, BM, BN, PP, KIND, SRC>
      <<<grid, 128 * CW + 32, smem8_bytes(KIND, SRC, BM, BN, a.K, a.stages),
         stream>>>(ta, tw0, tw1, a);
  return cudaGetLastError();
}

// One s8 launch of the core: out = epilogue(A8 @ W8^T), A8 the codes
// `a8` [R, K] (kStream8) or a.src's rows quantized by the prologue; w0
// (and w1 for kGeglu) int8 [N, K] with a.ws0 (a.ws1) their column scales.
// Returns a cudaError_t; cudaErrorInvalidValue for a plan or shape it does
// not take.
template <int KIND, int SRC>
int launch_s8(const Plan& pl, const void* a8, const void* w0,
              const void* w1, Q8Args a, cudaStream_t stream) {
  if (!plan8_ok(pl, KIND, SRC, a.K) || a.R < 1 || a.N % kPW || a.K % kPW ||
      (SRC != kStream8 && a.K > kMaxLNK))
    return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t e = attn::bind_device(&dev);
  if (e != cudaSuccess) return (int)e;
  CUtensorMap ta, tw0, tw1;
  if (!cached_map(&tw0, dev, w0, a.N, a.K, kBK8, pl.bn, 1) ||
      !cached_map(&tw1, dev, KIND == kGeglu ? w1 : w0, a.N, a.K, kBK8, pl.bn,
                  1) ||
      !(SRC == kStream8 ? cached_map(&ta, dev, a8, a.R, a.K, kBK8, pl.bm, 1)
                        : (ta = tw0, true)))
    return (int)cudaErrorInvalidValue;
  a.stages = pl.stages;
  a.tiles_per_cta = pl.tiles_per_cta;
  if constexpr (KIND == kGeglu)
    e = launch_tile8<2, 64, 64, true, KIND, SRC>(ta, tw0, tw1, a, dev,
                                                 stream);
  else if constexpr (KIND == kQkv)
    e = pl.pp ? launch_tile8<2, 64, 128, true, KIND, SRC>(ta, tw0, tw1, a,
                                                          dev, stream)
              : launch_tile8<1, 64, 128, false, KIND, SRC>(ta, tw0, tw1, a,
                                                           dev, stream);
  else if (pl.bm == 64 && pl.bn == 64)
    e = launch_tile8<1, 64, 64, false, KIND, SRC>(ta, tw0, tw1, a, dev,
                                                  stream);
  else if constexpr (KIND == kResidual && SRC == kStream8)
    e = pl.bm == 128
            ? launch_tile8<2, 128, 128, false, KIND, SRC>(ta, tw0, tw1, a,
                                                          dev, stream)
            : launch_tile8<1, 64, 128, false, KIND, SRC>(ta, tw0, tw1, a,
                                                         dev, stream);
  return (int)e;
}

}  // namespace gemm
}  // namespace rdmk
