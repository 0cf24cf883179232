// Exact top-k dot-product search over the retrieval table: two launches.
//
// Replaces rdm_tpu/ops/knn_kernel.py:_knn_kernel (driven by
// knn_search_fused): queries q [B, D] bf16 against the L2-normalised table
// [N, D] bf16, f32-accumulated products, -> the k best (score, id) of each
// query, ordered by score descending, ties to the lower id. The TPU kernel
// walked the table in 4096-row blocks in order on one core, carrying a
// running top-k in scratch from one grid step to the next; CTAs of a CUDA
// grid run in parallel and in no order, so the walk becomes a split:
//
//   1. knn_search_kernel: a persistent grid, one stripe of the table
//      (slice_rows rows, a multiple of 128) per cluster, one CTA an SM.
//      A CTA holds NQ queries (8 .. 64) in shared memory for the whole
//      stripe and streams the stripe through a ring of `stages` stages,
//      each one TMA box of 128 rows x one panel of PW columns. A producer
//      warp issues the boxes and waits only on the ring's "empty"
//      barriers. Two consumer warpgroups take the stripe's 128-row chunks
//      in turn and compute S^T = T Q^T, 128 rows x NQ queries, with SS
//      wgmma m64nNQk16 (table rows are M, two 64-row tiles into two
//      accumulators; queries N; both operands K-major as they lie),
//      accumulating a chunk's panels in registers and handing each stage
//      back as soon as its products are done.
//      Then the warpgroup selects, while the other one runs the next
//      chunk's products: each thread tests its accumulator entries
//      against its queries' current k-th (score, id), kept in shared
//      memory beside the sorted lists; winners go to a per-query buffer
//      of kCand slots through warp-aggregated atomics, and a buffer
//      kMergeAt full is merged into its list by one warp (ranks counted
//      by ballots). The two warpgroups select in chunk order, passing
//      the turn by named barriers, so the lists and buffers need no
//      lock. A winner that finds its buffer full waits for the next
//      round of the same chunk, after its buffer was merged (the first
//      chunks of a stripe pass most scores); after the stripe's last
//      chunk every buffer is merged. The lists ([B, slices, k]) go to
//      device memory.
//      Up to 64 queries share one CTA; up to 128 take a cluster of two
//      CTAs, up to 256 a cluster of four, 64 queries each, and every box
//      is multicast to all of them, each CTA loading its share of the
//      rows, so one pass over the table serves 256 queries. (128 queries
//      a CTA, in 128 KB, leave the ring 7 stages of 64 rows at D = 512:
//      too few bytes in flight.) The stripes are as many as such clusters
//      run at once (a cluster shares a GPC: 30 of four on an H100 SXM).
//      Larger batches take groups of cluster x NQ queries (grid.y), each
//      group one pass.
//   2. knn_merge_kernel: one CTA per query sorts its slices x k candidates
//      by (score desc, id asc) with a bitonic sort in shared memory and
//      writes the first k, ids as int64.
//
// Order is the total order (score desc, id asc) everywhere, so neither the
// order of the candidate buffer's atomics, nor the rounds, nor the stripe
// split changes the result. Rows >= N are zero-filled by TMA and masked by
// value (row < N), never by a branch around a wgmma; query rows >= B are
// zero-filled and never become candidates. Nothing pads the table, so no
// id >= N can come back (the TPU wrapper padded N with zero rows, which
// scored 0 and could win).
//
// What bounds it on the H100: the bytes of one pass over the table,
// N * D * 2 (1.31 GB for 1,281,280 x 512: 0.39 ms at 3.35 TB/s) per query
// group; the products, 2 * B * N * D operations (0.34 ms at 989 TFLOP/s
// for B = 256), come near that floor only at B = 256; and the selection,
// about k (1 + ln(rows / k)) winners per query and stripe, runs on the
// CUDA cores beside them. The ring keeps up to 8 boxes (128 KB at
// D = 512) in flight per SM, for the ~25 KB an SM needs to draw its share
// of 3.35 TB/s. The panel is 64 columns (128-byte swizzle) when D is a
// multiple of 64, else 32 (64-byte) or 16 (32-byte).
#include "attn_fwd_sm90.cuh"

namespace rdmk {
namespace knn {


constexpr int kTile = 64;        // table rows of a wgmma: its M
constexpr int kTiles = 2;        // wgmma tiles (accumulators) a chunk
constexpr int kRC = kTile * kTiles;  // table rows of a chunk and a stage
constexpr int kCand = 16;        // candidate slots per query
constexpr int kMergeAt = 8;      // a buffer this full is merged
constexpr int kGroups = 2;       // consumer warpgroups, alternate chunks
constexpr int kConsumers = 128 * kGroups;
constexpr int kThreads = kConsumers + 32;  // and the producer warp
constexpr int kMaxCluster = 4;
constexpr int kMaxK = 128;
constexpr int kMaxMerge = 16384;  // candidates one merge CTA sorts
constexpr int kMergeThreads = 512;
constexpr int kNoId = 0x7fffffff;
constexpr int kSmemLimit = 232448;

__host__ __device__ constexpr int panel_cols(int D) {
  return D % 64 == 0 ? 64 : D % 32 == 0 ? 32 : 16;
}

// Shared memory of one search CTA (after aligning the base to 1 KB):
// queries (D / PW panels of nq rows) | ring (stages x 128 rows x a panel)
// | lists (f32 scores, int ids) [nq, k] | candidates [nq, kCand] | counts
// [nq] | thresholds, each list's k-th (score [nq], id [nq]) | barriers
// (stages full, stages empty, one for the queries).
struct Layout {
  int ring, ls, li, cs, ci, cnt, thr, tid, bar, bytes;
};

__host__ __device__ inline Layout layout(int nq, int D, int k, int stages) {
  Layout L;
  L.ring = nq * D * 2;
  L.ls = L.ring + stages * kRC * panel_cols(D) * 2;
  L.li = L.ls + nq * k * 4;
  L.cs = L.li + nq * k * 4;
  L.ci = L.cs + nq * kCand * 4;
  L.cnt = L.ci + nq * kCand * 4;
  L.thr = L.cnt + nq * 4;
  L.tid = L.thr + nq * 4;
  L.bar = (L.tid + nq * 4 + 7) / 8 * 8;
  L.bytes = L.bar + 8 * (2 * stages + 1) + 1024;
  return L;
}

__device__ __forceinline__ bool better(float a, int ia, float b, int ib) {
  return a > b || (a == b && ia < ib);
}

// A barrier of one consumer warpgroup (named barrier 1 + wg) that also
// returns whether any of its threads passed v.
__device__ __forceinline__ bool group_any(bool v, int wg) {
  uint32_t r;
  asm volatile(
      "{\n.reg .pred p, q;\nsetp.ne.u32 p, %1, 0;\n"
      "bar.red.or.pred q, %2, 128, p;\nselp.u32 %0, 1, 0, q;\n}\n"
      : "=r"(r)
      : "r"((uint32_t)v), "r"(1 + wg)
      : "memory");
  return r != 0;
}

// Named barriers over both consumer warpgroups: one waits, the other
// arrives (the turn to select passes from one to the other).
__device__ __forceinline__ void pair_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(kConsumers) : "memory");
}
__device__ __forceinline__ void pair_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(kConsumers)
               : "memory");
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::
          : "memory");
}

// Merges one query's n (<= kCand) candidates into its sorted list of k,
// one warp, with no shared-memory round trips between the steps: lane j
// (+ 32 t) holds list entry j, lane c candidate c. Each candidate in turn
// is broadcast; a ballot counts the list entries better than it (its
// place in the list), and each entry counts the candidates better than
// it. An entry's new rank is its old one plus that count, a candidate's
// its place plus the candidates better than it; ranks >= k drop out. Ids
// in one list are distinct, so the ranks are too. The entry that lands at
// k - 1 also writes the query's threshold.
__device__ __noinline__ void merge_query(float* Ls, int* Li,
                                        const float* Xs, const int* Xi,
                                        float* thr, int* tid, int n, int k,
                                        int lane) {
  constexpr int T = kMaxK / 32;
  float es[T];
  int ei[T], before[T];
#pragma unroll
  for (int t = 0; t < T; ++t) {
    const int j = lane + 32 * t;
    es[t] = j < k ? Ls[j] : -INFINITY;
    ei[t] = j < k ? Li[j] : kNoId;
    before[t] = 0;
  }
  const bool mine = lane < n;
  const float xs = mine ? Xs[lane] : 0.f;
  const int xi = mine ? Xi[lane] : 0;
  int place = 0, ahead = 0;
#pragma unroll 1
  for (int c = 0; c < n; ++c) {
    const float cs = __shfl_sync(0xffffffffu, xs, c);
    const int ci = __shfl_sync(0xffffffffu, xi, c);
    int above = 0;
#pragma unroll
    for (int t = 0; t < T; ++t) {
      if (32 * t >= k) break;
      const bool in = lane + 32 * t < k;
      const bool b = in && better(es[t], ei[t], cs, ci);
      above += __popc(__ballot_sync(0xffffffffu, b));
      before[t] += in && !b;
    }
    if (lane == c) place = above;
    ahead += better(cs, ci, xs, xi);
  }
  __syncwarp();
#pragma unroll
  for (int t = 0; t < T; ++t) {
    const int j = lane + 32 * t, r = j + before[t];
    if (j < k && r < k) {
      Ls[r] = es[t];
      Li[r] = ei[t];
      if (r == k - 1) {
        *thr = es[t];
        *tid = ei[t];
      }
    }
  }
  if (mine && place + ahead < k) {
    const int r = place + ahead;
    Ls[r] = xs;
    Li[r] = xi;
    if (r == k - 1) {
      *thr = xs;
      *tid = xi;
    }
  }
  __syncwarp();
}

// One winner per lane where `pass`, all of query q's winners of the warp
// (the lanes with the same lane % 4) counted by one atomic: each gets a
// slot of the query's buffer; returns whether this lane's winner found
// one (a full buffer leaves it for the next round).
__device__ __noinline__ bool append_winner(bool pass, int q, float score,
                                           int row, int lane, int* cnt,
                                           float* cs, int* ci) {
  const unsigned win = __ballot_sync(0xffffffffu, pass);
  const unsigned grp = win & (0x11111111u << (lane & 3));
  const int leader = grp ? __ffs(grp) - 1 : 0;
  int at = 0;
  if (pass && lane == leader) at = atomicAdd(&cnt[q], __popc(grp));
  at = __shfl_sync(0xffffffffu, at, leader);
  const int pos = at + __popc(grp & ((1u << lane) - 1));
  if (!pass || pos >= kCand) return false;
  cs[q * kCand + pos] = score;
  ci[q * kCand + pos] = row;
  return true;
}

// One CTA: stripe blockIdx.x / cs of the table against queries
// [q0, q0 + NQ), q0 = (blockIdx.y * cs + rank) * NQ; cs CTAs of a cluster
// (consecutive blockIdx.x) share the stripe. PW: columns of a panel.
// Warps 0-3 and 4-7 are the two consumer warpgroups (chunks c with
// c % 2 = 0 and 1), warp 8 the producer.
template <int NQ, int PW>
__global__ void __launch_bounds__(kThreads, 1)
    knn_search_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tt,
                      float* __restrict__ part_s, int* __restrict__ part_i,
                      int B, int N, int D, int k, int slice_rows,
                      int n_slices, int stages, int cs) {
  using namespace attn;
  constexpr int PWB = PW * 2;          // bytes of a panel row
  constexpr int kStage = kRC * PWB;    // bytes of a ring stage
  constexpr int kAcc = NQ / 2;         // floats a thread of one tile
  constexpr int kVals = kTiles * kAcc;  // scores a thread of a chunk
  static_assert(kVals <= 64, "one 64-bit mask of a thread's scores");
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* gb = smem_raw + (base - raw);
  const Layout L = layout(NQ, D, k, stages);
  float* ls = reinterpret_cast<float*>(gb + L.ls);
  int* li = reinterpret_cast<int*>(gb + L.li);
  float* cs_ = reinterpret_cast<float*>(gb + L.cs);
  int* ci = reinterpret_cast<int*>(gb + L.ci);
  int* cnt = reinterpret_cast<int*>(gb + L.cnt);
  float* thr = reinterpret_cast<float*>(gb + L.thr);
  int* tid = reinterpret_cast<int*>(gb + L.tid);
  const uint32_t qs = base, ring = base + L.ring;
  const uint32_t full = base + L.bar, empty = full + 8 * stages;
  const uint32_t qbar = empty + 8 * stages;

  const int rank = blockIdx.x % cs, stripe = blockIdx.x / cs;
  const int q0 = (blockIdx.y * cs + rank) * NQ;
  const int nqv = max(0, min(NQ, B - q0));
  const int r_begin = stripe * slice_rows;
  const int r_end = min(N, r_begin + slice_rows);
  const int n_chunks = (r_end - r_begin + kRC - 1) / kRC;
  const int panels = D / PW;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  for (int i = threadIdx.x; i < NQ * k; i += kThreads) {
    ls[i] = -INFINITY;
    li[i] = kNoId;
  }
  for (int i = threadIdx.x; i < NQ; i += kThreads) {
    cnt[i] = 0;
    thr[i] = i < nqv ? -INFINITY : INFINITY;  // no padding query passes
    tid[i] = i < nqv ? kNoId : -1;
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4 * cs);  // a warpgroup's warps, each CTA
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (cs > 1) cluster_sync();  // the peer's barriers exist

  if (warp == kConsumers / 32) {
    // ------------------------------------------------------ the producer
    if (lane == 0) {
      if (nqv > 0) {
        mbar_expect_tx(qbar, panels * NQ * PWB);
        for (int p = 0; p < panels; ++p)
          tma_load_2d(&tq, qs + p * NQ * PWB, qbar, p * PW, q0);
      }
      const int rows = kRC / cs;  // rows of a box this CTA loads
      const uint16_t mask = (uint16_t)((1u << cs) - 1);
      const int n_loads = n_chunks * panels;
      int s = 0, phase = 0;
      for (int u = 0; u < n_loads; ++u) {
        if (u >= stages) mbar_wait(empty + 8 * s, phase ^ 1);
        mbar_expect_tx(full + 8 * s, kStage);
        const int c = u / panels, p = u - c * panels;
        const uint32_t dst = ring + s * kStage + rank * rows * PWB;
        const int row = r_begin + c * kRC + rank * rows;
        if (cs > 1)
          tma_load_2d_mc(&tt, dst, full + 8 * s, p * PW, row, mask);
        else
          tma_load_2d(&tt, dst, full + 8 * s, p * PW, row);
        if (++s == stages) {
          s = 0;
          phase ^= 1;
        }
      }
    }
    __syncwarp();
  } else {
    // ------------------------------------------------- the consumers
    if (nqv > 0) mbar_wait(qbar, 0);
    const int wg = warp >> 2, wq = warp & 3;
    // this thread's entries: rows rq, rq + 8 of each 64-row tile of a
    // chunk, queries 8j + qc + {0, 1} of every n8 block j; entry v of the
    // chunk is acc[v / kAcc][v % kAcc]
    const int rq = wq * 16 + (lane >> 2), qc = 2 * (lane & 3);
    float acc[kTiles][kAcc];
    auto release = [&](int st) {  // stage st back to every producer
      __syncwarp();
      if (lane == 0) {
        if (cs > 1) {
          for (int r = 0; r < cs; ++r)
            mbar_arrive_cluster(empty + 8 * st, r);
        } else {
          mbar_arrive(empty + 8 * st);
        }
      }
    };
    for (int c = wg; c < n_chunks; c += kGroups) {
      // A stage's parity names its phase only while the load before it
      // in that stage has landed: so a warpgroup waits for its chunk's
      // stages only after the other one has seen every stage of the
      // chunk before (named barriers 6 and 7), as with one consumer.
      if (c > 0) pair_sync(6 + wg);
      int prev = 0;
      for (int p = 0; p < panels; ++p) {
        const int u = c * panels + p, s = u % stages;
        mbar_wait(full + 8 * s, (u / stages) & 1);
        if (p == panels - 1 && c + 1 < n_chunks)
          pair_arrive(6 + (wg ^ 1));
        wgmma_fence();
#pragma unroll
        for (int t = 0; t < kTiles; ++t)
#pragma unroll
          for (int kk = 0; kk < PW / 16; ++kk)
            wgmma_ss<NQ>(acc[t],
                         sw_desc<PWB>(ring + s * kStage + t * kTile * PWB +
                                      kk * 32),
                         sw_desc<PWB>(qs + p * NQ * PWB + kk * 32),
                         (p | kk) != 0);
        wgmma_commit();
        if (p > 0) {
          wgmma_wait<1>();
          release(prev);
        }
        prev = s;
      }
      wgmma_wait<0>();
#pragma unroll
      for (int t = 0; t < kTiles; ++t) fence_regs(acc[t]);
      release(prev);

      // Select, in chunk order: the other warpgroup's products run
      // meanwhile. A winner beats its query's k-th (score, id), read once
      // a round from shared memory (a merge only raises it, so a
      // threshold read before a merge is a safe one); winners go to the
      // query's buffer, and a buffer kMergeAt full (every one after the
      // stripe's last chunk) is merged. Rounds repeat while a winner
      // found its buffer full.
      if (c > 0) pair_sync(3 + wg);
      const int row0 = r_begin + c * kRC + rq;
      const bool last = c + 1 == n_chunks;
      uint64_t todo = ~0ull >> (64 - kVals);
      while (true) {
        float2 th[NQ / 8];
        int2 ti[NQ / 8];
#pragma unroll
        for (int j = 0; j < NQ / 8; ++j) {
          th[j] = *reinterpret_cast<const float2*>(thr + 8 * j + qc);
          ti[j] = *reinterpret_cast<const int2*>(tid + 8 * j + qc);
        }
#pragma unroll
        for (int v = 0; v < kVals; ++v) {
          const int i = v % kAcc;
          const float2 t2 = th[i >> 2];
          const int2 i2 = ti[i >> 2];
          const int row = row0 + (v / kAcc) * kTile + ((i & 2) ? 8 : 0);
          if (!(row < r_end && better(acc[v / kAcc][i], row,
                                      (i & 1) ? t2.y : t2.x,
                                      (i & 1) ? i2.y : i2.x)))
            todo &= ~(1ull << v);
        }
        // the entries (v) where some lane of the warp has a winner
        const uint64_t warp_todo =
            (uint64_t)__reduce_or_sync(0xffffffffu, (uint32_t)(todo >> 32))
                << 32 |
            __reduce_or_sync(0xffffffffu, (uint32_t)todo);
        bool appended = false;
        if (warp_todo) {
#pragma unroll
          for (int v = 0; v < kVals; ++v) {
            if (!((warp_todo >> v) & 1)) continue;
            const int i = v % kAcc;
            const bool pass = (todo >> v) & 1;
            if (append_winner(pass, 8 * (i >> 2) + qc + (i & 1),
                              acc[v / kAcc][i],
                              row0 + (v / kAcc) * kTile + ((i & 2) ? 8 : 0),
                              lane, cnt, cs_, ci))
              todo &= ~(1ull << v);
            appended |= pass;
          }
        }
        if (!group_any(appended || last, wg)) break;
        {
          // warp wq merges queries wq + 4 l; lane l reads that one's
          // count. A winner still pending found its buffer full, so the
          // buffer is merged.
          const int at_least = last ? 1 : kMergeAt;
          for (int qb = 0; qb < nqv; qb += 128) {
            const int mq = qb + wq + 4 * lane;
            const int mine = mq < nqv ? min(cnt[mq], kCand) : 0;
            unsigned busy = __ballot_sync(0xffffffffu, mine >= at_least);
            while (busy) {
              const int src = __ffs(busy) - 1;
              busy &= busy - 1;
              const int q = qb + wq + 4 * src;
              merge_query(ls + q * k, li + q * k, cs_ + q * kCand,
                          ci + q * kCand, thr + q, tid + q,
                          __shfl_sync(0xffffffffu, mine, src), k, lane);
              if (lane == 0) cnt[q] = 0;
            }
          }
        }
        if (!group_any(todo != 0, wg)) break;
      }
      if (c + 1 < n_chunks) {
        __threadfence_block();
        pair_arrive(3 + (wg ^ 1));  // the next chunk's warpgroup selects
      }
    }

    pair_sync(5);  // the last selection is done
    for (int i = threadIdx.x; i < nqv * k; i += kConsumers) {
      const int q = i / k, j = i - q * k;
      const size_t o = ((size_t)(q0 + q) * n_slices + stripe) * k + j;
      part_s[o] = ls[i];
      part_i[o] = li[i];
    }
  }
  __syncwarp();
  if (cs > 1) cluster_sync();  // no arrival or copy into an exited CTA
}

__global__ void __launch_bounds__(kMergeThreads)
    knn_merge_kernel(const float* __restrict__ part_s,
                     const int* __restrict__ part_i, float* __restrict__ out_s,
                     long long* __restrict__ out_i, int m, int m_pad, int k) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* ss = reinterpret_cast<float*>(smem);
  int* si = reinterpret_cast<int*>(ss + m_pad);
  const size_t b = blockIdx.x;
  for (int i = threadIdx.x; i < m_pad; i += blockDim.x) {
    const bool ok = i < m;
    ss[i] = ok ? part_s[b * m + i] : -INFINITY;
    si[i] = ok ? part_i[b * m + i] : kNoId;
  }
  __syncthreads();
  // bitonic sort, the better entry first
  for (int size = 2; size <= m_pad; size <<= 1)
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < m_pad; i += blockDim.x) {
        const int j = i ^ stride;
        if (j <= i) continue;
        const float a = ss[i], c = ss[j];
        const int ia = si[i], ic = si[j];
        const bool swap = (i & size) == 0 ? better(c, ic, a, ia)
                                          : better(a, ia, c, ic);
        if (swap) {
          ss[i] = c;
          ss[j] = a;
          si[i] = ic;
          si[j] = ia;
        }
      }
      __syncthreads();
    }
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    out_s[b * k + j] = ss[j];
    out_i[b * k + j] = si[j];
  }
}

template <int NQ, int PW>
int launch_search(const CUtensorMap& tq, const CUtensorMap& tt,
                  float* part_s, int* part_i, int B, int N, int D, int k,
                  int cs, int groups, int slice_rows, int n_slices,
                  int stages, int dev, cudaStream_t stream) {
  auto kernel = knn_search_kernel<NQ, PW>;
  const int bytes = layout(NQ, D, k, stages).bytes;
  // one opt-in per device and instantiation, for the most any call takes
  static unsigned long long smem_set = 0;
  const cudaError_t ea = attn::allow_smem(kernel, kSmemLimit, dev, smem_set);
  if (ea != cudaSuccess) return (int)ea;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_slices * cs, groups, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, tq, tt, part_s,
                                           part_i, B, N, D, k, slice_rows,
                                           n_slices, stages, cs);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

template <int PW>
int dispatch_nq(int nq, const CUtensorMap& tq, const CUtensorMap& tt,
                float* ps, int* pi, int B, int N, int D, int k, int cs,
                int groups, int slice_rows, int n_slices, int stages,
                int dev, cudaStream_t st) {
  switch (nq) {
    case 8:
      return launch_search<8, PW>(tq, tt, ps, pi, B, N, D, k, cs, groups,
                                  slice_rows, n_slices, stages, dev, st);
    case 16:
      return launch_search<16, PW>(tq, tt, ps, pi, B, N, D, k, cs, groups,
                                   slice_rows, n_slices, stages, dev, st);
    case 32:
      return launch_search<32, PW>(tq, tt, ps, pi, B, N, D, k, cs, groups,
                                   slice_rows, n_slices, stages, dev, st);
    default:
      return launch_search<64, PW>(tq, tt, ps, pi, B, N, D, k, cs, groups,
                                   slice_rows, n_slices, stages, dev, st);
  }
}

// How many clusters of cs CTAs of knn_search_kernel<nq, PW> the card runs
// at once (a cluster's CTAs share a GPC, so this can be less than the SM
// count over cs), or minus a cudaError_t.
template <int NQ, int PW>
int cluster_slots(int D, int k, int stages, int cs) {
  int dev = 0;
  cudaError_t e = attn::bind_device(&dev);
  if (e != cudaSuccess) return -(int)e;
  auto kernel = knn_search_kernel<NQ, PW>;
  static unsigned long long smem_set = 0;
  e = attn::allow_smem(kernel, kSmemLimit, dev, smem_set);
  if (e != cudaSuccess) return -(int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cs, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = layout(NQ, D, k, stages).bytes;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  e = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
  return e == cudaSuccess ? n : -(int)e;
}

template <int PW>
int slots_nq(int nq, int D, int k, int stages, int cs) {
  switch (nq) {
    case 8:
      return cluster_slots<8, PW>(D, k, stages, cs);
    case 16:
      return cluster_slots<16, PW>(D, k, stages, cs);
    case 32:
      return cluster_slots<32, PW>(D, k, stages, cs);
    default:
      return cluster_slots<64, PW>(D, k, stages, cs);
  }
}

}  // namespace knn
}  // namespace rdmk

// q [B, D], db [N, D] bf16 contiguous, 16-byte aligned -> part_s
// [B, n_slices, k] f32 and part_i [B, n_slices, k] int32: each stripe's k
// best (score, id), sorted; a stripe with fewer than k rows pads its list
// with (-inf, INT_MAX). Stripe s covers rows [s * slice_rows,
// min(N, (s + 1) * slice_rows)). nq queries a CTA, cs CTAs a cluster,
// groups x cs x nq >= B; `stages` ring stages. The plan
// (rdm_tpu_torch/ops/knn_kernel.py `plan`) picks them; this checks them.
extern "C" int rdm_knn_search(const void* q, const void* db, void* part_s,
                              void* part_i, int B, int N, int D, int k,
                              int nq, int cs, int groups, int slice_rows,
                              int n_slices, int stages, void* stream) {
  using namespace rdmk::knn;
  const bool nq_ok = nq == 8 || nq == 16 || nq == 32 || nq == 64;
  if (B < 1 || N < 1 || D < 16 || D % 16 || k < 1 || k > kMaxK || !nq_ok ||
      cs < 1 || cs > kMaxCluster || (cs & (cs - 1)) || groups < 1 ||
      (long long)groups * cs * nq < B ||
      (long long)(groups - 1) * cs * nq >= B || slice_rows < 1 ||
      slice_rows % kRC || n_slices < 1 ||
      (long long)slice_rows * (n_slices - 1) >= N ||
      (long long)slice_rows * n_slices < N || stages < 2 ||
      layout(nq, D, k, stages).bytes > kSmemLimit ||
      (uintptr_t)q % 16 || (uintptr_t)db % 16)
    return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t e = rdmk::attn::bind_device(&dev);
  if (e != cudaSuccess) return (int)e;
  const int pw = panel_cols(D);
  CUtensorMap tq, tt;
  if (!rdmk::attn::make_map_2d(&tq, q, B, D, pw, nq) ||
      !rdmk::attn::make_map_2d(&tt, db, N, D, pw, kRC / cs))
    return (int)cudaErrorInvalidValue;
  float* ps = static_cast<float*>(part_s);
  int* pi = static_cast<int*>(part_i);
  cudaStream_t st = (cudaStream_t)stream;
  if (pw == 64)
    return dispatch_nq<64>(nq, tq, tt, ps, pi, B, N, D, k, cs, groups,
                           slice_rows, n_slices, stages, dev, st);
  if (pw == 32)
    return dispatch_nq<32>(nq, tq, tt, ps, pi, B, N, D, k, cs, groups,
                           slice_rows, n_slices, stages, dev, st);
  return dispatch_nq<16>(nq, tq, tt, ps, pi, B, N, D, k, cs, groups,
                         slice_rows, n_slices, stages, dev, st);
}

// The clusters of cs CTAs of the search at (nq, D, k, stages) that the
// current device runs at once, or minus a cudaError_t.
extern "C" int rdm_knn_cluster_slots(int nq, int D, int k, int stages,
                                     int cs) {
  using namespace rdmk::knn;
  if (!(nq == 8 || nq == 16 || nq == 32 || nq == 64) || D < 16 || D % 16 ||
      k < 1 || k > kMaxK || cs < 1 || cs > kMaxCluster || stages < 2 ||
      layout(nq, D, k, stages).bytes > kSmemLimit)
    return -(int)cudaErrorInvalidValue;
  const int pw = panel_cols(D);
  if (pw == 64) return slots_nq<64>(nq, D, k, stages, cs);
  if (pw == 32) return slots_nq<32>(nq, D, k, stages, cs);
  return slots_nq<16>(nq, D, k, stages, cs);
}

// part_s / part_i [B, m] (m = n_slices * k candidates per query) -> out_s
// [B, k] f32 and out_i [B, k] int64, by (score desc, id asc); m_pad is the
// power of two >= m that the bitonic sort runs over.
extern "C" int rdm_knn_merge(const void* part_s, const void* part_i,
                             void* out_s, void* out_i, int B, int m,
                             int m_pad, int k, void* stream) {
  using namespace rdmk::knn;
  if (B < 1 || k < 1 || k > m || m > m_pad || m_pad > kMaxMerge ||
      (m_pad & (m_pad - 1)))
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)m_pad * 8;
  int dev = 0;
  cudaError_t err = rdmk::attn::bind_device(&dev);
  if (err != cudaSuccess) return (int)err;
  static unsigned long long smem_set = 0;
  err = rdmk::attn::allow_smem(knn_merge_kernel, kMaxMerge * 8, dev,
                               smem_set);
  if (err != cudaSuccess) return (int)err;
  const int threads = m_pad / 2 < kMergeThreads
                          ? (m_pad / 2 < 32 ? 32 : m_pad / 2)
                          : kMergeThreads;
  knn_merge_kernel<<<B, threads, smem, (cudaStream_t)stream>>>(
      static_cast<const float*>(part_s), static_cast<const int*>(part_i),
      static_cast<float*>(out_s), static_cast<long long*>(out_i), m, m_pad,
      k);
  return (int)cudaGetLastError();
}
