// Flash-attention backward for Hopper (sm_90a): dq, dk, dv of
// o = softmax(q k^T * scale) v over BSHD bf16, given dO, in three launches
// of TMA copies and wgmma products with every tile in registers.
//
// Replaces rdm_tpu/ops/flash_attention.py:126 `_attn_bwd_kernel`. Same
// function: P recomputed from q and k in f32 (the causal mask aligned to
// the end of the keys: query i sees keys j <= i + Sk - Sq, a key after it
// gets -1e9, so a row with no visible key averages all keys),
// dV = P^T dO, dP = dO V^T, dS = P (dP - rowsum(dP P)),
// dQ = bf16(dS) K * scale, dK = bf16(dS)^T Q * scale, sums in f32, outputs
// in q's, k's and v's type.
//
// What differs from the TPU. The TPU kernel carries dK / dV across the q
// blocks of a sequential grid; on Hopper CTAs run in parallel and in no
// order. This file computes the same sums deterministically, with no
// atomics (the same inputs give bit-equal dq, dk, dv on every call):
//   1. attn_fwd_kernel<D, CAUSAL, kStats = true>, one CTA per (image,
//      head, 64 query rows): the forward core (attn_fwd_sm90.cuh) with
//      another epilogue, `write_stats`. It writes each row's max m (log2
//      domain), 1 / l and delta = rowsum(dO O), O = (sum p v) / l still
//      in f32 registers (rowsum(dO O) = rowsum(dP P); the core's PV rounds
//      p to bf16 as the forward does). Rows past Sq, up to the next
//      multiple of 64, get m = 1 / l = delta = 0, so their P is 0 below.
//   2. attn_bwd_dkdv_kernel, one CTA per (image, head, 64 keys): K and V
//      once by TMA; Q and dO tiles and their statistics go round a ring
//      of kStages stages (TMA for the tiles, one bulk copy per statistic).
//      Per query tile: S^T = K Q^T and dP^T = V dO^T as SS wgmma (both
//      operands K-major as they lie); P^T and dS^T in registers, the
//      statistics indexed by accumulator column; dV += bf16(P^T) dO and
//      dK += bf16(dS^T) Q as RS wgmma, the A fragments converted from the
//      accumulators (as the forward's PV), dO and Q read MN-major through
//      the transpose bit. dK and dV stay in registers across the walk.
//      Under `causal` with Sk >= Sq the walk starts at the first query
//      tile that sees the CTA's keys.
//   3. attn_bwd_dq_kernel, one CTA per (image, head, 64 query rows): Q and
//      dO once; K and V go round the ring. Per key tile: S = Q K^T and
//      dP = dO V^T (SS), dS in registers, dQ += bf16(dS) K (RS, K
//      MN-major). Key tiles past the rows' last visible key are skipped
//      under `causal` with Sk >= Sq, as in the forward.
// In launches 2 and 3 the next tile's two SS products are issued right
// after this tile's RS products, so the tensor cores take both back to
// back; every wgmma of the loop is unconditional, and masks are values
// (-1e9, -inf), never a branch around a wgmma.
//
// Rounding. dP on the tensor cores (bf16 products, f32 sums) equals the
// TPU kernel's f32 product of bf16 inputs. P is rounded to bf16 for
// dV = P^T dO, where the TPU kernel keeps it in f32; dS is rounded to bf16
// for dQ and dK as the TPU kernel does. The plain version
// (ops/flash_attention.py) follows the TPU kernel.
//
// What bounds it on the H100 (132 SMs). Operations: the TPU cost
// estimate's five products, 10 B H Sq Sk D FLOP (halved where causal
// tiles are skipped), at 989 TFLOP/s; bytes: q, k, v, dO read once and
// dq, dk, dv written once, 7 B H S D * 2. At the ds-2 site ([40, 1024, 12,
// 32]) that is 161 GFLOP, 0.163 ms. This design does nine products (S
// three times, dP twice, PV once, then dV, dK, dQ) and three exponentials
// per visible score (one per launch), so its own floor is the SFU's:
// 3 B H Sq Sk ex2 at 16 per SM per clock, 0.36 ms at that site and
// 1.98 GHz, above the operations bound at head_dim 32. Registers: a
// thread holds S^T and dP^T (TQ / 2 f32 each) and dK, dV (D / 2 each) in
// launch 2, so the query tile is 64 wide at D <= 64 and 32 wide at D = 96
// and 128; launch 3 holds S, dP (32 each) and dQ (D / 2).
#include "attn_fwd_sm90.cuh"

namespace rdmk {
namespace attn {

// 1-D bulk copy of `bytes` (a multiple of 16) from global memory into
// shared memory at `dst`, completing on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// ------------------------------------------------------------- dK and dV

// Launch 2's shared memory: K | V | Q ring | dO ring | statistics ring |
// barriers, every panel on a 1 KB boundary.
template <int D>
struct KVSmem {
  static constexpr int kTQ = D <= 64 ? 64 : 32;  // queries of a tile
  static constexpr int kPanels = D / kPanel;
  static constexpr int kKPanel = kTK * kRowBytes;
  static constexpr int kQPanel = kTQ * kRowBytes;
  static constexpr int kKTile = kPanels * kKPanel;
  static constexpr int kQTile = kPanels * kQPanel;
  static constexpr int kStat = 3 * kTQ * 4;  // m, 1 / l, delta of a tile
  static constexpr int kVOff = kKTile;
  static constexpr int kQOff = 2 * kKTile;
  static constexpr int kDOOff = kQOff + kStages * kQTile;
  static constexpr int kStatOff = kDOOff + kStages * kQTile;
  static constexpr int kBarOff = kStatOff + kStages * kStat;
  static constexpr int kBytes = kBarOff + 8 * (2 * kStages + 1) + 1024;
};

// First query tile (of `tq` rows) that sees any key of [k0, k0 + 64): under
// `causal` with Sk >= Sq the earlier ones see none of them (p = 0
// exactly); with Sk < Sq rows with no visible key average all keys.
__device__ __forceinline__ int first_query_tile(int k0, int Sq, int Sk,
                                                bool causal, int tq) {
  if (!causal || Sk < Sq) return 0;
  const int first = k0 - (Sk - Sq);
  return first <= 0 ? 0 : first / tq;
}

template <int D, bool CAUSAL>
struct KeyCols {
  using L = KVSmem<D>;
  static constexpr int TQ = L::kTQ;
  const CUtensorMap *tq, *tdo;
  const float* gstat;               // this (image, head)'s statistics
  const float* sstat;               // the statistics ring (generic)
  uint32_t ks, vs, qs, dos, ss, full, empty;
  int Sq, Sk, Sqp, t0, n, h, b, krow, col, lane;
  float scale_log2;
  float gk[D / 2], gv[D / 2];       // dK, dV

  // query tile u of the walk (rows (t0 + u) TQ ..) into stage u % kStages
  __device__ __forceinline__ void load_q(int u) {
    const int s = u % kStages, q0 = (t0 + u) * TQ;
    const uint32_t bar = full + 8 * s;
    mbar_expect_tx(bar, 2 * L::kQTile + L::kStat);
#pragma unroll
    for (int p = 0; p < L::kPanels; ++p) {
      const uint32_t off = s * L::kQTile + p * L::kQPanel;
      tma_load(tq, qs + off, bar, p * kPanel, h, q0, b);
      tma_load(tdo, dos + off, bar, p * kPanel, h, q0, b);
    }
#pragma unroll
    for (int c = 0; c < 3; ++c)
      bulk_load(ss + s * L::kStat + c * TQ * 4, gstat + c * Sqp + q0,
                TQ * 4, bar);
  }

  // S^T = K Q_u^T and dP^T = V dO_u^T, issued and committed
  __device__ __forceinline__ void issue_ss(float (&s)[TQ / 2],
                                           float (&dp)[TQ / 2], int u) {
    const uint32_t q = qs + (u % kStages) * L::kQTile;
    const uint32_t d = dos + (u % kStages) * L::kQTile;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t in_panel = (kk & 1) * 32;
      wgmma_ss<TQ>(s,
                   sw64_desc(ks + (kk >> 1) * L::kKPanel + in_panel, 16, 512),
                   sw64_desc(q + (kk >> 1) * L::kQPanel + in_panel, 16, 512),
                   kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t in_panel = (kk & 1) * 32;
      wgmma_ss<TQ>(dp,
                   sw64_desc(vs + (kk >> 1) * L::kKPanel + in_panel, 16, 512),
                   sw64_desc(d + (kk >> 1) * L::kQPanel + in_panel, 16, 512),
                   kk > 0);
    }
    wgmma_commit();
  }

  // dV += P^T dO_u and dK += dS^T Q_u, the A fragments in registers, dO
  // and Q MN-major (LBO the panel stride, SBO 8 rows), issued and committed
  __device__ __forceinline__ void issue_rs(const uint32_t (&pp)[TQ / 4],
                                           const uint32_t (&pd)[TQ / 4],
                                           int u) {
    const uint32_t q = qs + (u % kStages) * L::kQTile;
    const uint32_t d = dos + (u % kStages) * L::kQTile;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TQ / 16; ++kk) {
      const uint32_t a[4] = {pp[4 * kk], pp[4 * kk + 1], pp[4 * kk + 2],
                             pp[4 * kk + 3]};
      wgmma_rs<D>(gv, a,
                  sw64_desc(d + kk * 16 * kRowBytes, L::kQPanel,
                            8 * kRowBytes),
                  1);
    }
#pragma unroll
    for (int kk = 0; kk < TQ / 16; ++kk) {
      const uint32_t a[4] = {pd[4 * kk], pd[4 * kk + 1], pd[4 * kk + 2],
                             pd[4 * kk + 3]};
      wgmma_rs<D>(gk, a,
                  sw64_desc(q + kk * 16 * kRowBytes, L::kQPanel,
                            8 * kRowBytes),
                  1);
    }
    wgmma_commit();
  }

  // Tile u of the walk, its S^T and dP^T in s and dp. With kNext the
  // products of tile u + 1 are issued into s and dp after this tile's RS
  // products.
  template <bool kNext>
  __device__ __forceinline__ void tile(float (&s)[TQ / 2],
                                       float (&dp)[TQ / 2], int u) {
    const int refill = u + kStages - 2;  // the stage of tile u - 2
    if (threadIdx.x == 0 && refill >= kStages && refill < n) {
      mbar_wait(empty + 8 * (refill % kStages),
                (refill / kStages - 1) & 1);
      load_q(refill);
    }
    __syncwarp();
    const float* st = sstat + (u % kStages) * (L::kStat / 4);
    const int qpos0 = (t0 + u) * TQ + Sk - Sq;  // causal position of col 0
    uint32_t pp[TQ / 4], pd[TQ / 4];
#pragma unroll
    for (int i = 0; i < TQ / 2; i += 4) {
      const int c = 8 * (i >> 2) + col;  // this thread's query columns c, c+1
      const float2 m = *reinterpret_cast<const float2*>(st + c);
      const float2 il = *reinterpret_cast<const float2*>(st + TQ + c);
      const float2 dl = *reinterpret_cast<const float2*>(st + 2 * TQ + c);
      float x[4] = {fmaf(s[i], scale_log2, -m.x),
                    fmaf(s[i + 1], scale_log2, -m.y),
                    fmaf(s[i + 2], scale_log2, -m.x),
                    fmaf(s[i + 3], scale_log2, -m.y)};
      if (CAUSAL) {
        x[0] = krow > qpos0 + c ? kMasked - m.x : x[0];
        x[1] = krow > qpos0 + c + 1 ? kMasked - m.y : x[1];
        x[2] = krow + 8 > qpos0 + c ? kMasked - m.x : x[2];
        x[3] = krow + 8 > qpos0 + c + 1 ? kMasked - m.y : x[3];
      }
      const float p0 = ex2(x[0]) * il.x, p1 = ex2(x[1]) * il.y;
      const float p2 = ex2(x[2]) * il.x, p3 = ex2(x[3]) * il.y;
      pp[i / 2] = pack_bf16(p0, p1);
      pp[i / 2 + 1] = pack_bf16(p2, p3);
      pd[i / 2] = pack_bf16(p0 * (dp[i] - dl.x), p1 * (dp[i + 1] - dl.y));
      pd[i / 2 + 1] =
          pack_bf16(p2 * (dp[i + 2] - dl.x), p3 * (dp[i + 3] - dl.y));
    }
    issue_rs(pp, pd, u);
    if (kNext) {
      mbar_wait(full + 8 * ((u + 1) % kStages), ((u + 1) / kStages) & 1);
      issue_ss(s, dp, u + 1);
    }
    wgmma_wait<0>();
    fence_regs(pp);
    fence_regs(pd);
    fence_regs(gk);
    fence_regs(gv);
    if (kNext) {
      fence_regs(s);
      fence_regs(dp);
    }
    // hand the stage back to the producer, one arrival per warp
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * (u % kStages));
    __syncwarp();
  }
};

// grid (ceil(Sk / 64), H, B), one warpgroup of 64 keys
template <int D, bool CAUSAL>
__global__ void __launch_bounds__(kThreads, 2)
    attn_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ CUtensorMap tdo,
                         const float* __restrict__ stats,
                         bf16* __restrict__ dk, bf16* __restrict__ dv,
                         int Sq, int Sk, int H, float scale_log2,
                         float scale) {
  using L = KVSmem<D>;
  constexpr int TQ = L::kTQ;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int k0 = blockIdx.x * kTK;
  KeyCols<D, CAUSAL> w;
  w.tq = &tq;
  w.tdo = &tdo;
  w.Sq = Sq;
  w.Sk = Sk;
  w.Sqp = stat_rows(Sq);
  w.h = blockIdx.y;
  w.b = blockIdx.z;
  w.gstat = stats + (size_t)(w.b * H + w.h) * 3 * w.Sqp;
  w.sstat = reinterpret_cast<const float*>(smem_raw + (base - raw) +
                                           L::kStatOff);
  w.ks = base;
  w.vs = base + L::kVOff;
  w.qs = base + L::kQOff;
  w.dos = base + L::kDOOff;
  w.ss = base + L::kStatOff;
  w.full = base + L::kBarOff;
  w.empty = w.full + 8 * kStages;
  const uint32_t kvbar = w.empty + 8 * kStages;
  w.t0 = first_query_tile(k0, Sq, Sk, CAUSAL, TQ);
  w.n = (Sq + TQ - 1) / TQ - w.t0;  // >= 1: key k0 < Sk is seen
  w.krow = k0 + warp * 16 + (lane >> 2);
  w.col = 2 * (lane & 3);
  w.lane = lane;
  w.scale_log2 = scale_log2;
#pragma unroll
  for (int i = 0; i < D / 2; ++i) w.gk[i] = w.gv[i] = 0.f;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(w.full + 8 * s, 1);
      mbar_init(w.empty + 8 * s, kThreads / 32);
    }
    mbar_init(kvbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(kvbar, 2 * L::kKTile);
    for (int p = 0; p < L::kPanels; ++p) {
      tma_load(&tk, w.ks + p * L::kKPanel, kvbar, p * kPanel, w.h, k0, w.b);
      tma_load(&tv, w.vs + p * L::kKPanel, kvbar, p * kPanel, w.h, k0, w.b);
    }
    for (int u = 0; u < min(w.n, kStages); ++u) w.load_q(u);
  }
  __syncthreads();

  float s[TQ / 2], dp[TQ / 2];
  mbar_wait(kvbar, 0);
  mbar_wait(w.full, 0);
  w.issue_ss(s, dp, 0);
  wgmma_wait<0>();
  fence_regs(s);
  fence_regs(dp);
  for (int u = 0; u + 1 < w.n; ++u) w.template tile<true>(s, dp, u);
  w.template tile<false>(s, dp, w.n - 1);

  const size_t stride = (size_t)H * D;
  const size_t off = ((size_t)w.b * Sk * H + w.h) * D + w.col;
  const int r = w.krow;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    if (r < Sk) {
      *reinterpret_cast<uint32_t*>(dk + off + r * stride + 8 * j) =
          pack_bf16(w.gk[4 * j] * scale, w.gk[4 * j + 1] * scale);
      *reinterpret_cast<uint32_t*>(dv + off + r * stride + 8 * j) =
          pack_bf16(w.gv[4 * j], w.gv[4 * j + 1]);
    }
    if (r + 8 < Sk) {
      *reinterpret_cast<uint32_t*>(dk + off + (r + 8) * stride + 8 * j) =
          pack_bf16(w.gk[4 * j + 2] * scale, w.gk[4 * j + 3] * scale);
      *reinterpret_cast<uint32_t*>(dv + off + (r + 8) * stride + 8 * j) =
          pack_bf16(w.gv[4 * j + 2], w.gv[4 * j + 3]);
    }
  }
}

// -------------------------------------------------------------------- dQ

// Launch 3's shared memory: Q | dO | K ring | V ring | barriers.
template <int D>
struct QSmem {
  using F = Smem<D>;  // the forward's tile sizes
  static constexpr int kDOOff = F::kPanels * F::kQPanel;
  static constexpr int kKOff = 2 * kDOOff;
  static constexpr int kVOff = kKOff + kStages * F::kTile;
  static constexpr int kBarOff = kVOff + kStages * F::kTile;
  static constexpr int kBytes = kBarOff + 8 * (2 * kStages + 1) + 1024;
};

template <int D, bool CAUSAL>
struct QueryRows {
  using F = Smem<D>;
  const CUtensorMap *tk, *tv;
  uint32_t qs, dos, ks, vs, full, empty;
  int Sk, qpos, col, lane, nkt, h, b;
  float scale_log2;
  float m0, m1, il0, il1, dl0, dl1;  // statistics of rows qpos, qpos + 8
  float gq[D / 2];                   // dQ

  // S = Q K_t^T and dP = dO V_t^T, issued and committed
  __device__ __forceinline__ void issue_ss(float (&s)[kTK / 2],
                                           float (&dp)[kTK / 2], int t) {
    const uint32_t kt = ks + (t % kStages) * F::kTile;
    const uint32_t vt = vs + (t % kStages) * F::kTile;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t in_panel = (kk & 1) * 32;
      wgmma_ss<kTK>(
          s, sw64_desc(qs + (kk >> 1) * F::kQPanel + in_panel, 16, 512),
          sw64_desc(kt + (kk >> 1) * F::kKPanel + in_panel, 16, 512),
          kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t in_panel = (kk & 1) * 32;
      wgmma_ss<kTK>(
          dp, sw64_desc(dos + (kk >> 1) * F::kQPanel + in_panel, 16, 512),
          sw64_desc(vt + (kk >> 1) * F::kKPanel + in_panel, 16, 512),
          kk > 0);
    }
    wgmma_commit();
  }

  template <bool kNext>
  __device__ __forceinline__ void tile(float (&s)[kTK / 2],
                                       float (&dp)[kTK / 2], int t) {
    const int refill = t + kStages - 2;  // the stage of tile t - 2
    if (threadIdx.x == 0 && refill >= kStages && refill < nkt) {
      mbar_wait(empty + 8 * (refill % kStages),
                (refill / kStages - 1) & 1);
      load_kv<D>(tk, tv, ks, vs, full, refill, h, b);
    }
    __syncwarp();
    const int k0 = t * kTK;
    uint32_t pd[kTK / 4];
#pragma unroll
    for (int i = 0; i < kTK / 2; i += 4) {
      const int key = k0 + 8 * (i >> 2) + col;  // keys key, key + 1
      float x[4] = {fmaf(s[i], scale_log2, -m0),
                    fmaf(s[i + 1], scale_log2, -m0),
                    fmaf(s[i + 2], scale_log2, -m1),
                    fmaf(s[i + 3], scale_log2, -m1)};
      if (CAUSAL) {
        x[0] = key > qpos ? kMasked - m0 : x[0];
        x[1] = key + 1 > qpos ? kMasked - m0 : x[1];
        x[2] = key > qpos + 8 ? kMasked - m1 : x[2];
        x[3] = key + 1 > qpos + 8 ? kMasked - m1 : x[3];
      }
      if (key >= Sk) x[0] = x[2] = -INFINITY;
      if (key + 1 >= Sk) x[1] = x[3] = -INFINITY;
      const float p0 = ex2(x[0]) * il0, p1 = ex2(x[1]) * il0;
      const float p2 = ex2(x[2]) * il1, p3 = ex2(x[3]) * il1;
      pd[i / 2] = pack_bf16(p0 * (dp[i] - dl0), p1 * (dp[i + 1] - dl0));
      pd[i / 2 + 1] = pack_bf16(p2 * (dp[i + 2] - dl1),
                                p3 * (dp[i + 3] - dl1));
    }
    // dQ += dS K_t, K MN-major
    const uint32_t kt = ks + (t % kStages) * F::kTile;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTK / 16; ++kk) {
      const uint32_t a[4] = {pd[4 * kk], pd[4 * kk + 1], pd[4 * kk + 2],
                             pd[4 * kk + 3]};
      wgmma_rs<D>(gq, a,
                  sw64_desc(kt + kk * 16 * kRowBytes, F::kKPanel,
                            8 * kRowBytes),
                  1);
    }
    wgmma_commit();
    if (kNext) {
      mbar_wait(full + 8 * ((t + 1) % kStages), ((t + 1) / kStages) & 1);
      issue_ss(s, dp, t + 1);
    }
    wgmma_wait<0>();
    fence_regs(pd);
    fence_regs(gq);
    if (kNext) {
      fence_regs(s);
      fence_regs(dp);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * (t % kStages));
    __syncwarp();
  }
};

// grid (ceil(Sq / 64), H, B), one warpgroup of 64 query rows
template <int D, bool CAUSAL>
__global__ void __launch_bounds__(kThreads, D == 32 ? 3 : 2)
    attn_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap tdo,
                       const float* __restrict__ stats,
                       bf16* __restrict__ dq, int Sq, int Sk, int H,
                       float scale_log2, float scale) {
  using L = QSmem<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = blockIdx.x * kRows;
  const int row = r0 + warp * 16 + (lane >> 2);
  QueryRows<D, CAUSAL> w;
  w.tk = &tk;
  w.tv = &tv;
  w.qs = base;
  w.dos = base + L::kDOOff;
  w.ks = base + L::kKOff;
  w.vs = base + L::kVOff;
  w.full = base + L::kBarOff;
  w.empty = w.full + 8 * kStages;
  const uint32_t qbar = w.empty + 8 * kStages;
  w.Sk = Sk;
  w.qpos = row + Sk - Sq;
  w.col = 2 * (lane & 3);
  w.lane = lane;
  w.h = blockIdx.y;
  w.b = blockIdx.z;
  w.nkt = key_tiles(r0, Sq, Sk, CAUSAL);
  w.scale_log2 = scale_log2;
  {
    const int Sqp = stat_rows(Sq);
    const float* st = stats + (size_t)(w.b * H + w.h) * 3 * Sqp;
    w.m0 = st[row];
    w.m1 = st[row + 8];
    w.il0 = st[Sqp + row];
    w.il1 = st[Sqp + row + 8];
    w.dl0 = st[2 * Sqp + row];
    w.dl1 = st[2 * Sqp + row + 8];
  }
#pragma unroll
  for (int i = 0; i < D / 2; ++i) w.gq[i] = 0.f;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(w.full + 8 * s, 1);
      mbar_init(w.empty + 8 * s, kThreads / 32);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(qbar, 2 * kRows * D * 2);
    for (int p = 0; p < Smem<D>::kPanels; ++p) {
      tma_load(&tq, w.qs + p * Smem<D>::kQPanel, qbar, p * kPanel, w.h, r0,
               w.b);
      tma_load(&tdo, w.dos + p * Smem<D>::kQPanel, qbar, p * kPanel, w.h,
               r0, w.b);
    }
    for (int u = 0; u < min(w.nkt, kStages); ++u)
      load_kv<D>(&tk, &tv, w.ks, w.vs, w.full, u, w.h, w.b);
  }
  __syncthreads();

  float s[kTK / 2], dp[kTK / 2];
  mbar_wait(qbar, 0);
  mbar_wait(w.full, 0);
  w.issue_ss(s, dp, 0);
  wgmma_wait<0>();
  fence_regs(s);
  fence_regs(dp);
  for (int t = 0; t + 1 < w.nkt; ++t) w.template tile<true>(s, dp, t);
  w.template tile<false>(s, dp, w.nkt - 1);

  const size_t stride = (size_t)H * D;
  bf16* out = dq + ((size_t)w.b * Sq * H + w.h) * D + w.col;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    if (row < Sq)
      *reinterpret_cast<uint32_t*>(out + row * stride + 8 * j) =
          pack_bf16(w.gq[4 * j] * scale, w.gq[4 * j + 1] * scale);
    if (row + 8 < Sq)
      *reinterpret_cast<uint32_t*>(out + (row + 8) * stride + 8 * j) =
          pack_bf16(w.gq[4 * j + 2] * scale, w.gq[4 * j + 3] * scale);
  }
}

// ------------------------------------------------------------------- host

template <int D, bool CAUSAL>
int launch_attn_bwd(const void* q, const void* k, const void* v,
                    const void* dout, void* dq, void* dk, void* dv,
                    float* stats, int B, int Sq, int Sk, int H,
                    float scale_log2, float scale, cudaStream_t stream) {
  constexpr int TQ = KVSmem<D>::kTQ;
  int dev = 0;
  cudaError_t e = bind_device(&dev);
  if (e != cudaSuccess) return (int)e;
  // q and dO in boxes of 64 rows (launches 1, 3) and of TQ (launch 2)
  CUtensorMap mq, mk, mv, mdo, mqt, mdot;
  if (!make_map(&mq, q, B, Sq, H, D, kRows) ||
      !make_map(&mdo, dout, B, Sq, H, D, kRows) ||
      !make_map(&mk, k, B, Sk, H, D, kTK) ||
      !make_map(&mv, v, B, Sk, H, D, kTK))
    return (int)cudaErrorInvalidValue;
  if (TQ == kRows) {
    mqt = mq;
    mdot = mdo;
  } else if (!make_map(&mqt, q, B, Sq, H, D, TQ) ||
             !make_map(&mdot, dout, B, Sq, H, D, TQ)) {
    return (int)cudaErrorInvalidValue;
  }
  static unsigned long long set_stats = 0, set_kv = 0, set_q = 0;
  e = allow_smem(attn_fwd_kernel<D, CAUSAL, true>, Smem<D>::kBytes, dev,
                 set_stats);
  if (e == cudaSuccess)
    e = allow_smem(attn_bwd_dkdv_kernel<D, CAUSAL>, KVSmem<D>::kBytes, dev,
                   set_kv);
  if (e == cudaSuccess)
    e = allow_smem(attn_bwd_dq_kernel<D, CAUSAL>, QSmem<D>::kBytes, dev,
                   set_q);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid_q((Sq + kRows - 1) / kRows, H, B);
  const dim3 grid_k((Sk + kTK - 1) / kTK, H, B);
  attn_fwd_kernel<D, CAUSAL, true>
      <<<grid_q, kThreads, Smem<D>::kBytes, stream>>>(
          mq, mk, mv, nullptr, Sq, Sk, H, scale_log2,
          static_cast<const bf16*>(dout), stats);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  attn_bwd_dkdv_kernel<D, CAUSAL>
      <<<grid_k, kThreads, KVSmem<D>::kBytes, stream>>>(
          mqt, mk, mv, mdot, stats, static_cast<bf16*>(dk),
          static_cast<bf16*>(dv), Sq, Sk, H, scale_log2, scale);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  attn_bwd_dq_kernel<D, CAUSAL>
      <<<grid_q, kThreads, QSmem<D>::kBytes, stream>>>(
          mq, mk, mv, mdo, stats, static_cast<bf16*>(dq), Sq, Sk, H,
          scale_log2, scale);
  return (int)cudaGetLastError();
}

}  // namespace attn
}  // namespace rdmk

namespace {

template <int D>
int launch(const void* q, const void* k, const void* v, const void* dout,
           void* dq, void* dk, void* dv, float* stats, int B, int Sq, int Sk,
           int H, int causal, float scale_log2, float scale,
           cudaStream_t s) {
  using namespace rdmk::attn;
  return causal ? launch_attn_bwd<D, true>(q, k, v, dout, dq, dk, dv, stats,
                                           B, Sq, Sk, H, scale_log2, scale,
                                           s)
                : launch_attn_bwd<D, false>(q, k, v, dout, dq, dk, dv, stats,
                                            B, Sq, Sk, H, scale_log2, scale,
                                            s);
}

}  // namespace

// q, dout [B, Sq, H, D], k / v [B, Sk, H, D], dq / dk / dv like them, all
// bf16, contiguous and 16-byte aligned; stats: f32 scratch of
// B * H * 3 * (Sq rounded up to 64), written by the first launch and read
// by the other two. Returns a cudaError_t.
extern "C" int rdm_flash_bwd(const void* q, const void* k, const void* v,
                             const void* dout, void* dq, void* dk, void* dv,
                             void* stats, int B, int Sq, int Sk, int H,
                             int D, int causal, float scale_log2,
                             float scale, void* stream) {
  auto s = (cudaStream_t)stream;
  float* st = static_cast<float*>(stats);
  switch (D) {
    case 32: return launch<32>(q, k, v, dout, dq, dk, dv, st, B, Sq, Sk, H,
                               causal, scale_log2, scale, s);
    case 64: return launch<64>(q, k, v, dout, dq, dk, dv, st, B, Sq, Sk, H,
                               causal, scale_log2, scale, s);
    case 96: return launch<96>(q, k, v, dout, dq, dk, dv, st, B, Sq, Sk, H,
                               causal, scale_log2, scale, s);
    case 128: return launch<128>(q, k, v, dout, dq, dk, dv, st, B, Sq, Sk,
                                 H, causal, scale_log2, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
