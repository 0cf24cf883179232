// The whole post-attention half of a SpatialTransformer block: out-
// projection + residual, LN2 + cross-attention + out-projection +
// residual, then LN3 + GEGLU feed-forward + residual, in four launches of
// the block-GEMM core.
//
// Replaces rdm_tpu/ops/block_kernel.py:264 `_post_ff_kernel` (the single
// kernel 3 that fused_transformer_block runs under RDM_TPU_SPLIT_K3=0).
// For x, attn [R, C] bf16 (R = B*S, image of row r is r / S), the
// projected context ck, cv [B, T, C] and F = 4C:
//   1-3. xm = post_cross(x, attn): rdm_post_cross (csrc/post_cross.cu),
//        its three launches with the same plans, so xm is post_cross's to
//        the bit; x1, o and xm go through device memory in bf16
//   4.   y  = xm + bf16(sum_j f_j @ w2[j] + b2),
//        f_j = bf16((h3 @ wa_j + ba_j) * gelu(h3 @ wg_j + bg_j)),
//        h3 = bf16(LN3(xm))                (block_gemm_ff_kernel, one
//                                           cluster of CTAs a 64-row block)
// The TPU kernel's point is that the GEGLU hidden f [R, F] never leaves
// fast memory: it carried an f32 [M, C] accumulator across a sequential
// grid axis over F. The FF launch keeps f in shared memory instead, each
// CTA of a cluster a slice of F, and sums the slices' partial products
// across the cluster in rank order (csrc/block_gemm_sm90.cuh, "the FF
// launch"), where the split pair writes f to device memory and reads it
// back (25 / 9 / 4 MB at the U-Net's C = 384 / 576 / 960 sites, 8 images).
//
// What bounds it on the H100: 2*R*C*(3C + 3F) FLOP (36/20/14 GFLOP at
// C = 384/576/960, R = 8192/2048/512) on the tensor cores, operations, as
// for the split pair; the FF launch's share 6*R*C*F.
#include "block_gemm_sm90.cuh"

// csrc/post_cross.cu
extern "C" int rdm_post_cross(const void* x, const void* attn, const void* ck,
                              const void* cv, const void* wo, const void* bo,
                              const void* n2s, const void* n2b,
                              const void* wq2, const void* wo2,
                              const void* bo2, void* x1, void* o, void* out,
                              int R, int S, int C, int T, int head_dim,
                              float scale, int bm_r, int bn_r, int pp_r,
                              int tpc_r, int st_r, int bm_c, int bn_c,
                              int pp_c, int tpc_c, int st_c, void* stream);

namespace rdmk {
namespace gemm {

// The FF kernel's opt-ins on device `dev`, once per device: clusters past
// 8 CTAs and a CTA's shared-memory maximum.
static cudaError_t ff_opt_in(int dev) {
  static unsigned long long done = 0;
  static std::mutex mu;
  std::lock_guard<std::mutex> lock(mu);
  auto kernel = block_gemm_ff_kernel<64>;
  if (!(dev < 64 && (done >> dev & 1))) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
  }
  return attn::allow_smem(kernel, kSmemLimit, dev, done);
}

// The FF launch: y [R, C] from xm [R, C] over clusters of `ranks` CTAs
// (ops/block_kernel.py `ff_plan`: ranks, ring stages, units a round).
// Returns a cudaError_t; cudaErrorInvalidValue for a plan or shape it does
// not take.
static int launch_ff(const void* xm, const void* n3s, const void* n3b,
                     const void* wa, const void* wg, const void* ba,
                     const void* bg, const void* w2, const void* b2, void* y,
                     int R, int C, int F, int ranks, int stages,
                     int round_units, cudaStream_t stream) {
  const int smem = ff_smem_bytes(C, F, ranks, stages, round_units);
  if (R < 1 || C < kPW || C % kPW || C > kMaxLNK || F < 64 || F % 64 ||
      ranks < 1 || ranks > kMaxFFRanks || ranks > F / 64 || stages < 4 ||
      stages % 2 || stages > kMaxStages || round_units < 4 ||
      round_units % 4 ||
      round_units % ranks || smem > kSmemLimit)
    return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t e = attn::bind_device(&dev);
  if (e != cudaSuccess) return (int)e;
  CUtensorMap ta, twa, twg, tw2;
  // xm in the core's 64-byte boxes; the weights in 128-byte ones
  if (!cached_map(&ta, dev, xm, R, C, kPW, 64, 2) ||
      !cached_map(&twa, dev, wa, C, F, 64, kBK, 2) ||
      !cached_map(&twg, dev, wg, C, F, 64, kBK, 2) ||
      !cached_map(&tw2, dev, w2, F, C, 64, kBK, 2))
    return (int)cudaErrorInvalidValue;
  e = ff_opt_in(dev);
  if (e != cudaSuccess) return (int)e;
  FFArgs a{};
  a.ln_s = (const float*)n3s;
  a.ln_b = (const float*)n3b;
  a.bias0 = (const float*)b2;
  a.res = (const bf16*)xm;
  a.out = (bf16*)y;
  a.R = R;
  a.N = C;
  a.K = C;
  a.S = 1;
  a.T = 1;
  a.stages = stages;
  a.tiles_per_cta = 1;
  a.ba = (const float*)ba;
  a.bg = (const float*)bg;
  a.F = F;
  a.round_units = round_units;
  return attn::launch_ex(block_gemm_ff_kernel<64>,
                         dim3(ranks, (R + 63) / 64), 256, smem, stream, ranks,
                         false, ta, twa, twg, tw2, a);
}

}  // namespace gemm
}  // namespace rdmk

// x1, o, xm: scratch [R, C] (xm is post_cross's output); the plans of
// post_cross's residual and cross launches, then the FF launch's.
extern "C" int rdm_post_ff(const void* x, const void* attn, const void* ck,
                           const void* cv, const void* wo, const void* bo,
                           const void* n2s, const void* n2b, const void* wq2,
                           const void* wo2, const void* bo2, const void* n3s,
                           const void* n3b, const void* wa, const void* wg,
                           const void* ba, const void* bg, const void* w2,
                           const void* b2, void* x1, void* o, void* xm,
                           void* out, int R, int S, int C, int T, int F,
                           int head_dim, float scale, int bm_r, int bn_r,
                           int pp_r, int tpc_r, int st_r, int bm_c, int bn_c,
                           int pp_c, int tpc_c, int st_c, int ranks,
                           int stages, int round_units, void* stream) {
  const int e = rdm_post_cross(x, attn, ck, cv, wo, bo, n2s, n2b, wq2, wo2,
                               bo2, x1, o, xm, R, S, C, T, head_dim, scale,
                               bm_r, bn_r, pp_r, tpc_r, st_r, bm_c, bn_c,
                               pp_c, tpc_c, st_c, stream);
  if (e) return e;
  return rdmk::gemm::launch_ff(xm, n3s, n3b, wa, wg, ba, bg, w2, b2, out, R,
                               C, F, ranks, stages, round_units,
                               (cudaStream_t)stream);
}

// The FF launch alone (for timing it apart from post_cross's three):
// y [R, C] from post_cross's xm [R, C] with `ff_plan`'s three ints.
extern "C" int rdm_ff(const void* xm, const void* n3s, const void* n3b,
                      const void* wa, const void* wg, const void* ba,
                      const void* bg, const void* w2, const void* b2,
                      void* y, int R, int C, int F, int ranks, int stages,
                      int round_units, void* stream) {
  return rdmk::gemm::launch_ff(xm, n3s, n3b, wa, wg, ba, bg, w2, b2, y, R, C,
                               F, ranks, stages, round_units,
                               (cudaStream_t)stream);
}

// The most clusters of `ranks` FF CTAs (at a CTA's shared-memory maximum)
// the current device keeps resident at once, for ops/block_kernel.py
// `ff_plan`; a negative cudaError_t on failure.
extern "C" int rdm_ff_clusters(int ranks) {
  using namespace rdmk::gemm;
  if (ranks < 1 || ranks > kMaxFFRanks) return -(int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t e = rdmk::attn::bind_device(&dev);
  if (e == cudaSuccess) e = ff_opt_in(dev);
  if (e != cudaSuccess) return -(int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ranks, 1, 1);
  cfg.blockDim = dim3(256, 1, 1);
  cfg.dynamicSmemBytes = kSmemLimit;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = ranks;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  int n = 0;
  e = cudaOccupancyMaxActiveClusters(&n, block_gemm_ff_kernel<64>, &cfg);
  return e != cudaSuccess ? -(int)e : n;
}
