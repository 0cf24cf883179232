// Shared pieces of the flash-attention forward and backward kernels
// (csrc/flash_attn_fwd.cu, csrc/flash_attn_bwd.cu).
//
// Tensors are BSHD bf16, contiguous: element (b, s, h, d) of a tensor with
// S rows sits at ((b * S + s) * H + h) * HD + d, so one head of one image is
// a [S, HD] matrix with row stride H * HD and the kernels read it in place
// (the TPU wrapper's four BSHD <-> BHSD transposes do not exist here).
// Tiles are [64, HD] bf16 in shared memory, brought in by cp.async; every
// product is an nvcuda::wmma 16x16x16 bf16 product with f32 accumulation,
// four warps per thread block, each warp owning 16 rows of a 64-row tile.
//
// Scores live in the log2 domain: s = q.k * scale * log2(e), exponentiated
// with exp2, as the TPU kernel folds the change of base into the scale.
// Masks are the TPU kernel's: under `causal` a key after the query (query i
// sees keys j <= i + Sk - Sq) gets -1e9, a finite value, so a row with no
// visible key averages all keys as the plain version does; keys past Sk of
// a ragged last tile drop out (-inf).
#pragma once

#include "block_common.cuh"

namespace rdmk {
namespace flash {

constexpr int TQ = 64;             // query rows of a tile (16 per warp)
constexpr int TK = 64;             // key rows of a tile
constexpr float kMasked = -1e9f;   // the TPU kernel's _NEG_INF

template <int HD>
struct Dims {
  static_assert(HD % 32 == 0 && HD <= 128, "head_dim in {32, 64, 96, 128}");
  // bf16 row stride of a [64, HD] tile: +8 keeps rows 16-byte aligned and
  // 16-row fragment offsets 32-byte aligned
  static constexpr int ldh = HD + 8;
  // f32 row stride of a warp's [16, max(64, HD)] staging tile
  static constexpr int lds = (HD > TK ? HD : TK) + 4;
  // bf16 row stride of a warp's [16, 64] P / dS tile
  static constexpr int ldp = TK + 8;
  static constexpr size_t tile_bytes =
      align128((size_t)64 * ldh * sizeof(bf16));
  static constexpr int tile_elems = (int)(tile_bytes / sizeof(bf16));
  static constexpr size_t stage_bytes =
      align128((size_t)4 * 16 * lds * sizeof(float));
  static constexpr size_t ptile_bytes =
      align128((size_t)4 * 16 * ldp * sizeof(bf16));
};

typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>
    FragBT;

// Async copy of rows [r0, r0 + 64) of one head ([S, HD], row stride
// `stride` elements, `src` already at the head's first row) into a tile;
// rows >= S are zero-filled.
template <int HD>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int r0,
                                          int S, int stride) {
  constexpr int V = HD / 8;  // 16-byte vectors per row
  for (int i = threadIdx.x; i < 64 * V; i += kThreads) {
    const int r = i / V, c = i - (i / V) * V;
    const bool ok = r0 + r < S;
    cp_async16(dst + r * Dims<HD>::ldh + c * 8,
               src + (size_t)(ok ? r0 + r : 0) * stride + c * 8, ok);
  }
}

// Key tiles a query tile [q0, q0 + 64) visits. Under `causal` with
// Sk >= Sq every query sees key 0, so tiles past the tile's last visible
// key contribute exp2(-1e9 - m) = 0 exactly and are skipped (half the
// work at Sq = Sk); with Sk < Sq rows with no visible key average all keys,
// so nothing is skipped.
__device__ __forceinline__ int key_tiles(int q0, int Sq, int Sk,
                                         bool causal) {
  int n = (Sk + TK - 1) / TK;
  if (causal && Sk >= Sq) {
    const int last = min(q0 + TQ - 1, Sq - 1) + (Sk - Sq);
    n = min(n, last / TK + 1);
  }
  return n;
}

// First query tile that sees any key of the key tile [k0, k0 + 64), under
// the same rule as key_tiles.
__device__ __forceinline__ int first_query_tile(int k0, int Sq, int Sk,
                                                bool causal) {
  if (!causal || Sk < Sq) return 0;
  const int first = k0 - (Sk - Sq);
  return first <= 0 ? 0 : first / TQ;
}

// A raw q.k product -> the masked log2-domain score of key `key` for the
// query at causal position `qpos` (= query index + Sk - Sq).
__device__ __forceinline__ float masked_score(float raw, float scale_log2,
                                              int key, int qpos, int Sk,
                                              bool causal) {
  if (key >= Sk) return -INFINITY;
  return (causal && key > qpos) ? kMasked : raw * scale_log2;
}

// acc[j] (j < 4) = A [16, HD] (row-major, shared, stride lda) @ B^T where B
// is a [64, HD] tile: a warp's [16, 64] block of q k^T or dO v^T.
template <int HD>
__device__ __forceinline__ void rows_by_tile_t(FragC (&acc)[4], const bf16* a,
                                               const bf16* tile) {
#pragma unroll
  for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[j], 0.f);
#pragma unroll
  for (int kk = 0; kk < HD; kk += 16) {
    FragA fa;
    wmma::load_matrix_sync(fa, a + kk, Dims<HD>::ldh);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      FragBT fb;
      wmma::load_matrix_sync(fb, tile + (j * 16) * Dims<HD>::ldh + kk,
                             Dims<HD>::ldh);
      wmma::mma_sync(acc[j], fa, fb, acc[j]);
    }
  }
}

// acc[j] (j < HD / 16) += P [16, 64] (bf16, shared, stride ldp) @ tile
// [64, HD]: a warp's [16, HD] block of P V, P^T dO, dS^T Q or dS K.
template <int HD>
__device__ __forceinline__ void p_by_tile(FragC (&acc)[HD / 16],
                                          const bf16* p, const bf16* tile) {
#pragma unroll
  for (int kk = 0; kk < TK; kk += 16) {
    FragA fa;
    wmma::load_matrix_sync(fa, p + kk, Dims<HD>::ldp);
#pragma unroll
    for (int j = 0; j < HD / 16; ++j) {
      FragB fb;
      wmma::load_matrix_sync(fb, tile + kk * Dims<HD>::ldh + j * 16,
                             Dims<HD>::ldh);
      wmma::mma_sync(acc[j], fa, fb, acc[j]);
    }
  }
}

template <int N>
__device__ __forceinline__ void store_frags(float* dst, int ld,
                                            FragC (&acc)[N]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
    wmma::store_matrix_sync(dst + j * 16, acc[j], ld, wmma::mem_row_major);
}

// A warp's [16, HD] f32 staging block, times `mul`, -> bf16 rows
// [r0, r0 + 16) of one head (row stride `stride`), rows >= S skipped; two
// lanes per row, HD / 2 channels each.
template <int HD>
__device__ __forceinline__ void write_rows(bf16* dst, int stride,
                                           const float* stage, int r0, int S,
                                           float mul) {
  const int lane = threadIdx.x & 31;
  const int r = lane >> 1, half = lane & 1;
  if (r0 + r >= S) return;
  const float* src = stage + r * Dims<HD>::lds + half * (HD / 2);
  bf16* out = dst + (size_t)(r0 + r) * stride + half * (HD / 2);
#pragma unroll
  for (int c = 0; c < HD / 2; c += 8) {
    float v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = src[c + i] * mul;
    store8(out + c, v);
  }
}

}  // namespace flash
}  // namespace rdmk
