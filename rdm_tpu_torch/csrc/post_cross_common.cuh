// The attention half of a SpatialTransformer block for one [BM, C] row
// block, shared by csrc/post_cross.cu (which writes its output) and
// csrc/post_ff.cu (which goes on with the GEGLU feed-forward):
//   x1   = x + (attn @ wo + bo)
//   h2   = LayerNorm(x1; n2s, n2b)
//   q2   = h2 @ wq2
//   o_h  = softmax_t(q2_h . ck[img, t, h] * d^-1/2) . cv[img, :, h]
//   xmid = x1 + (o @ wo2 + bo2)
// for rows r0 .. r0 + BM of x, attn [R, C] bf16 (image of row r is r / S),
// with ck, cv [B, T, C] the context keys/values projected outside. See
// post_cross.cu for the rounding and the design.
#pragma once

#include "block_common.cuh"

namespace rdmk {

constexpr int kMaxCtx = 16;  // the one-pass cross-attention's context

// One row's cross-attention over one head of HD columns (32 or 64):
//   o = sum_t bf16(softmax_t(bf16(q) . k_t * scale)) v_t      (f32)
// with the exact max and sum over all T context tokens. Without LONG
// (T <= kMaxCtx) one pass keeps the scores in a local array; with LONG
// (any T) a first walk takes the running max and sum (the sum rescaled
// when the max grows) and a second recomputes each score for p and o. The
// two are separate kernels, as the block-GEMM core's kCross and
// kCrossLong, so the main path's code is the one pass alone. qrow: the f32
// q2 of the head; kb, vb: the head's first column of the image's ck, cv
// (row stride C).
template <int HD, bool LONG>
__device__ __forceinline__ void cross_head(const float* qrow, const bf16* kb,
                                           const bf16* vb, int C, int T,
                                           float scale, float (&o)[HD]) {
  float qv[HD];
#pragma unroll
  for (int d = 0; d < HD; ++d) qv[d] = round_bf16(qrow[d]);
  auto score = [&](int tc) {
    float s = 0.f;
#pragma unroll
    for (int d8 = 0; d8 < HD; d8 += 8) {
      float kv[8];
      load8(kv, kb + (size_t)tc * C + d8);
#pragma unroll
      for (int j = 0; j < 8; ++j) s += qv[d8 + j] * kv[j];
    }
    return s * scale;
  };
  auto add_pv = [&](int tc, float pt) {
#pragma unroll
    for (int d8 = 0; d8 < HD; d8 += 8) {
      float vv[8];
      load8(vv, vb + (size_t)tc * C + d8);
#pragma unroll
      for (int j = 0; j < 8; ++j) o[d8 + j] += pt * vv[j];
    }
  };
#pragma unroll
  for (int d = 0; d < HD; ++d) o[d] = 0.f;
  float mx = -INFINITY, den = 0.f;
  if constexpr (!LONG) {
    float sc[kMaxCtx];
    for (int tc = 0; tc < T; ++tc) {
      sc[tc] = score(tc);
      mx = fmaxf(mx, sc[tc]);
    }
    for (int tc = 0; tc < T; ++tc) {
      sc[tc] = __expf(sc[tc] - mx);
      den += sc[tc];
    }
    const float inv = 1.0f / den;
    for (int tc = 0; tc < T; ++tc) add_pv(tc, round_bf16(sc[tc] * inv));
  } else {
    for (int tc = 0; tc < T; ++tc) {
      const float s = score(tc), nm = fmaxf(mx, s);
      den = den * __expf(mx - nm) + __expf(s - nm);  // 0 * 0 on the first
      mx = nm;
    }
    const float inv = 1.0f / den;
    for (int tc = 0; tc < T; ++tc)
      add_pv(tc, round_bf16(__expf(score(tc) - mx) * inv));
  }
}

// pa, px1, po: three [BM, C] shared panels (pa ends holding LN2(x1), px1
// x1); bs holds bchunk_bytes(1), cs staging_bytes(1). store(r, gr, gc,
// res) takes xmid[gr, gc .. gc + 8) (f32, rounded by the store) for each
// row gr < R; every thread has synced when this returns.
template <int HD, bool LONG, typename Store>
__device__ __forceinline__ void post_cross_rows(
    const bf16* __restrict__ x, const bf16* __restrict__ attn,
    const bf16* __restrict__ ck, const bf16* __restrict__ cv,
    const bf16* __restrict__ wo, const float* __restrict__ bo,
    const float* __restrict__ n2s, const float* __restrict__ n2b,
    const bf16* __restrict__ wq2, const bf16* __restrict__ wo2,
    const float* __restrict__ bo2, int R, int S, int C, int T, float scale,
    int r0, bf16* pa, bf16* px1, bf16* po, bf16* bs, float* cs,
    Store store) {
  constexpr int kHeadDim = HD;
  const int ldp = panel_ld(C);
  const int ntiles = (C + BN - 1) / BN;

  load_panel_async(pa, attn, C, r0, R, C);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // 1. x1 = x + (attn @ wo + bo)
  const bf16* w_o[1] = {wo};
  for (int t = 0; t < ntiles; ++t) {
    const int n0 = t * BN;
    FragC acc[1][2];
    panel_gemm<1>(acc, pa, C, w_o, C, n0, bs);
    store_acc(cs, acc[0]);
    __syncthreads();
    for (int i = threadIdx.x; i < BM * BN / 8; i += kThreads) {
      const int r = i / (BN / 8), c8 = (i - r * (BN / 8)) * 8;
      const int gr = r0 + r, gc = n0 + c8;
      if (gc >= C) continue;
      float res[8];
      if (gr < R) {
        float xv[8];
        load8(xv, x + (size_t)gr * C + gc);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          res[j] = xv[j] + round_bf16(cs[r * kLdC + c8 + j] + __ldg(bo + gc + j));
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) res[j] = 0.f;
      }
      store8(px1 + r * ldp + gc, res);
    }
    __syncthreads();
  }

  // 2. h2 = LN2(x1), over the attn panel (no longer needed)
  layer_norm_panel(pa, px1, C, n2s, n2b);
  __syncthreads();

  // 3. q2 = h2 @ wq2 tile by tile; each 64-column tile holds two whole
  //    heads of 32 (one of 64), whose cross-attention runs in the
  //    epilogue: one thread per (row, head) pair, T context tokens, exact
  //    per-head max (cross_head).
  const bf16* w_q[1] = {wq2};
  for (int t = 0; t < ntiles; ++t) {
    const int n0 = t * BN;
    FragC acc[1][2];
    panel_gemm<1>(acc, pa, C, w_q, C, n0, bs);
    store_acc(cs, acc[0]);
    __syncthreads();
    constexpr int kHeadsPerTile = BN / kHeadDim;
    for (int p = threadIdx.x; p < BM * kHeadsPerTile; p += kThreads) {
      const int r = p / kHeadsPerTile, hh = p - r * kHeadsPerTile;
      const int col = n0 + hh * kHeadDim;
      if (col >= C) continue;
      const int gr = r0 + r;
      bf16* dst = po + r * ldp + col;
      float o[kHeadDim];
      if (gr < R) {
        const int img = gr / S;
        cross_head<kHeadDim, LONG>(
            cs + r * kLdC + hh * kHeadDim, ck + (size_t)img * T * C + col,
            cv + (size_t)img * T * C + col, C, T, scale, o);
      } else {
#pragma unroll
        for (int d = 0; d < kHeadDim; ++d) o[d] = 0.f;
      }
#pragma unroll
      for (int d8 = 0; d8 < kHeadDim; d8 += 8) store8(dst + d8, o + d8);
    }
    __syncthreads();
  }

  // 4. xmid = x1 + (o @ wo2 + bo2)
  const bf16* w_o2[1] = {wo2};
  for (int t = 0; t < ntiles; ++t) {
    const int n0 = t * BN;
    FragC acc[1][2];
    panel_gemm<1>(acc, po, C, w_o2, C, n0, bs);
    store_acc(cs, acc[0]);
    __syncthreads();
    for (int i = threadIdx.x; i < BM * BN / 8; i += kThreads) {
      const int r = i / (BN / 8), c8 = (i - r * (BN / 8)) * 8;
      const int gr = r0 + r, gc = n0 + c8;
      if (gc >= C || gr >= R) continue;
      float x1v[8], res[8];
      load8(x1v, px1 + r * ldp + gc);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        res[j] = x1v[j] + round_bf16(cs[r * kLdC + c8 + j] + __ldg(bo2 + gc + j));
      store(r, gr, gc, res);
    }
    __syncthreads();
  }
}

}  // namespace rdmk
