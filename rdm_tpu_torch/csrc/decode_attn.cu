// The self-attention half of one RARM decode step: LN1 and the q/k/v
// projection as a launch of the block-GEMM core, then the cached causal
// attention as a split-KV launch over thread-block clusters.
//
// Replaces rdm_tpu/ops/decode_kernel.py:135 `_attn_kernel` (and its
// `quantized` / `int8_kv` variants). For x [B, C] bf16, one new token per
// batch row, the time-major caches kc, vc [T, B, C] and heads of d = 64:
//   1. [q | k | v] = bf16(bf16(LN1(x)) @ wqkv)      (rdm_decode_proj:
//      launch_decode<kQkv> of csrc/block_gemm_sm90.cuh at R = B rows, K
//      split over a cluster as `gemm_plan("qkv", split_k=True)` plans it;
//      LayerNorm with f32 statistics and bf16 arithmetic; each 8-column
//      group of the [B, 3C] result to q, k or v)
//   2. out[b, h] = sum_t softmax_t(s)_t v_t over t < pos and the current
//      position, s_t = q[b, h] . k_t * d^-1/2        (rdm_decode_attn)
// With a bf16 in-place commit, k and v of launch 1 land in row pos of the
// caches (`k_new` / `v_new` are those rows); deferred (commit=False), in
// buffers of their own, the caches untouched. Launch 2 reads rows < pos
// of the caches and takes the current position from the exact k_new /
// v_new, so where row pos is written does not matter to it.
//
// The serving options of the TPU kernel:
//   int8_weights - wqkv is int8 codes with a bf16 scale per output column,
//                  applied to the f32 product (`_wdot`): launch 1 streams
//                  the codes and converts them in shared memory.
//   int8_kv      - the caches hold int8 codes with one f32 scale per (row,
//                  batch row), ks, vs [T, B]; a past row's k scale
//                  multiplies its score and its v scale its probability.
//                  Launch 1 also writes the f32 k and v rows (knf, vnf):
//                  a 64-column tile cannot take a row's absmax over C.
//                  Launch 2 commits row pos once per batch row, in rank 0
//                  of head group 0's cluster (its producer warp, once its
//                  boxes are issued): scale = max(max|row|,
//                  1e-12) / 127 over all C, codes rint(row / scale)
//                  clipped to +-127 (`quantize_rows` bit for bit on the
//                  same f32 row).
//
// What bounds it on the H100 (132 SMs, 3.35 TB/s). Launch 1 streams wqkv,
// 3.5 MB at C = 768 (1.8 MB int8), against 2 B C 3C = 57 / 113 MFLOP at B =
// 16 / 32: ~1.1 us. Launch 2 reads the cache rows < pos, 2 pos B C 2 bytes
// (12.5 MB at B = 16, pos = 255: 3.7 us; half in int8), for 4 FLOP an
// element: a score is a 64-term dot product of one query, so there is no
// matrix product for the tensor cores to take (one query row a (batch
// row, head)). What Hopper gives this launch is the copy engine, the
// clusters and programmatic dependent launch:
//
// - Split-KV over a cluster. The grid is (splits, heads / G, B), a
//   cluster the `splits` CTAs of one (batch row, group of G heads): rank r
//   takes cache rows [r rows, (r + 1) rows) below pos (`rows` a multiple
//   of the 16-row box), so B = 16, pos >= 63 puts 192 or more CTAs on the
//   cache stream where one block a (head, batch row) put 192 on it at
//   every pos. The host plan (ops/decode_kernel.py `attn_plan`) takes up
//   to 8 splits, about 4 CTAs an SM.
// - TMA. A 2-D tensor map over a cache seen as [T, B C] (row stride B C
//   elements) gives one box of 16 rows x G 64 columns at (b C + g G 64,
//   t): G = 4 heads make 512 contiguous bytes a row (256 int8). A producer
//   warp issues the boxes of the CTA's rows into an mbarrier ring of up to
//   4 stages of K and V boxes (the whole split at B = 16) before anything
//   else, the rest as the consumers hand stages back.
// - Four consumer warps, a warp one head (G = 4; with G = 2 or 1 the
//   head's rows are dealt out to 2 or 4 warps), eight lanes a row and
//   eight dims a lane: a score is an 8-lane shuffle sum, and each 8-lane
//   group keeps an exp2-domain online-softmax state (m, l, acc[8]) over
//   its rows of each box (every fourth at G = 4: four rows a box, scored
//   together, then one rescale of the state). The four states of a warp
//   are merged by shuffles.
// - Rank-ordered merge. Every warp of every rank writes its state (acc
//   [64], m, l) into rank 0's shared memory: the other ranks by
//   asynchronous stores (st.async) that count their bytes on a barrier of
//   rank 0's, so rank 0 waits for exactly those bytes and no rank waits on
//   a cluster-wide barrier after its stores. Rank 0 then merges, per head, in
//   (rank, warp) order with the current position last, and normalises.
//   No atomics, no global workspace: two calls are bit-equal. A split with
//   no live rows (pos = 0) gives m = -inf, l = 0.
// - The int8 scale caches [T, B, 1] have 4-byte rows, below TMA's 16-byte
//   box minimum; a map whose box spans 4 batch rows would need B % 4 == 0
//   (a map's row stride is a multiple of 16 bytes), so the CTA's scales
//   come by plain loads, issued before the wait, while the boxes are in
//   flight (a split has at most kMaxRows = 256 rows).
// - One wave. A CTA's life is a few microseconds of fixed latency (the
//   first box, q, the cluster's merge), so a second wave of CTAs doubles
//   the launch: the launcher (`ring_depth`) keeps the ring shallow enough
//   that the built kernel's registers, threads and shared memory let
//   every CTA of the grid be resident at once, with a CTA an SM to spare
//   for the clusters' packing.
//
// Programmatic dependent launch, and why the cache may be read early.
// Launch 1 lets launch 2 start at once; launch 2's producer issues its
// cache boxes before anything waits, and only the consumers wait
// (griddepcontrol.wait) before they read q / k_new / v_new / knf / vnf.
// So the cache stream runs under the projection. That is sound because
// every cache row < pos that launch 2 reads was written by a launch W
// that ran to completion, with its writes visible, before launch 2 of
// this step could start:
//   (a) W is this layer's launch 1 (bf16 commit) or launch 2 (int8
//       commit) of an earlier step, or a `commit_rows` launch, which is a
//       plain stream launch: every launch after it starts after it ends.
//   (b) Launch 2 triggers its dependents only after its own wait, i.e.
//       after its launch 1 has completed, and, in the CTA that commits an
//       int8 row, after that commit and a __threadfence(). Each launch of
//       these chains waits (griddepcontrol.wait) in every CTA before it
//       ends, so a launch's completion implies its predecessors'. Every
//       later launch in the stream starts after launch 2's trigger.
//   So rows written by launch 1 or launch 2 of step s are complete before
//   any launch of step s + 1 starts. Launch 1 of this step writes only
//   row pos, which launch 2 never reads (its boxes may cover rows >= pos
//   of the last stage; those rows are masked, never used). Every write
//   of launch 2 (out, the int8 row) comes after its wait, so no earlier
//   launch still reads what it overwrites. Launch 1 of the next layer, or
//   decode_post_ff's first launch, may then start under launch 2.
// `pdl` = 0 makes both plain stream launches (the same bits: PDL moves
// only when work starts).
#include "block_gemm_sm90.cuh"

namespace rdmk {
namespace dattn {

using attn::bf16;
using attn::mbar_arrive;
using attn::mbar_expect_tx;
using attn::mbar_init;
using attn::mbar_wait;
using attn::smem_u32;
using attn::tma_load_2d;

constexpr int kHD = 64;         // head_dim
constexpr int kRB = 16;         // cache rows of a box: a ring stage
constexpr int kWarps = 4;       // consumer warps
constexpr int kThreads = 32 * (kWarps + 1);
constexpr int kMaxStages = 4;
constexpr int kMaxSplits = 8;   // CTAs of a cluster (portable)
constexpr int kRec = 68;        // floats of a warp's state: acc[64], m, l, 2
constexpr int kSmemCap = 131072;  // the opt-in; plans stay far below
constexpr int kMaxRows = 2 * 32 * kWarps;  // a split's rows (int8 scales)

// Shared memory of a CTA:
// 128 bytes of alignment | the ring (stages x K box, V box of kRB rows x G
// heads) | with int8 caches the split's k and v scales (rows f32 each) and
// the f32 k and v rows of the commit (C each, used in the committing CTA)
// | the receive region (splits x kWarps states, used in rank 0) | full and
// empty barriers, the commit's and the receive region's barriers.
__host__ __device__ constexpr int box_bytes(int G, int esize) {
  return kRB * G * kHD * esize;
}
__host__ __device__ constexpr int attn_smem(int G, int esize, int stages,
                                            int splits, int rows, int C) {
  return 128 + stages * 2 * box_bytes(G, esize) +
         (esize == 1 ? 8 * rows + 8 * C : 0) + splits * kWarps * kRec * 4 +
         16 * stages + 16;
}

struct AttnArgs {
  const bf16* q;      // [B, C]
  const bf16* kn;     // [B, C], the current position's k and v
  const bf16* vn;
  void* kc;           // the caches [T, B, C]: int8 codes written at pos
  void* vc;
  float* ks;          // [T, B] scales (int8 caches)
  float* vs;
  const float* knf;   // [B, C] f32 k, v rows (int8 caches)
  const float* vnf;
  bf16* out;          // [B, C]
  int pos, B, C, rows;
  int stages;         // the ring's depth (`ring_depth`)
  float scale_log2;   // d^-1/2 log2(e)
};

__device__ __forceinline__ void load8(const bf16* p, float (&f)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 v = __bfloat1622float2(h[e]);
    f[2 * e] = v.x;
    f[2 * e + 1] = v.y;
  }
}

// Eight int8 codes, exactly: v + 128 as a byte under the exponent of 2^23
// (a byte permute) minus 2^23 + 128, where an int -> float conversion runs
// at a quarter of the rate (the core's convert_w8 does the same).
__device__ __forceinline__ void load8(const int8_t* p, float (&f)[8]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const uint32_t w[2] = {u.x ^ 0x80808080u, u.y ^ 0x80808080u};
#pragma unroll
  for (int e = 0; e < 8; ++e)
    f[e] = __uint_as_float(__byte_perm(w[e >> 2], 0x4B000000u,
                                       0x7650 + (e & 3))) -
           8388736.0f;
}

// 16 bytes to a (mapa) shared address of another CTA of the cluster,
// completing their transaction bytes on that CTA's barrier `bar` (mapa)
__device__ __forceinline__ void st_async_f4(uint32_t remote, float a, float b,
                                            float c, float d, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], "
      "{%1, %2, %3, %4}, [%5];\n" ::"r"(remote),
      "f"(a), "f"(b), "f"(c), "f"(d), "r"(bar)
      : "memory");
}

__device__ __forceinline__ int8_t code8(float v, float scale) {
  return (int8_t)fminf(fmaxf(rintf(__fdiv_rn(v, scale)), -127.f), 127.f);
}

// (m, l, acc) <- the merge of two exp2-domain softmax states; a state
// with no rows has m = -inf and weighs 0.
__device__ __forceinline__ void merge_state(float& m, float& l, float (&acc)[8],
                                      float mo, float lo,
                                      const float (&ao)[8]) {
  const float M = fmaxf(m, mo);
  const float ca = m == -INFINITY ? 0.f : attn::ex2(m - M);
  const float cb = mo == -INFINITY ? 0.f : attn::ex2(mo - M);
  l = l * ca + lo * cb;
#pragma unroll
  for (int e = 0; e < 8; ++e) acc[e] = acc[e] * ca + ao[e] * cb;
  m = M;
}

// The int8 commit of row pos for batch row b, by one warp (the producer
// warp of the committing CTA, idle once its boxes are issued): both f32
// rows come into shared memory (`rowf`, 2 C floats) by one bulk copy each
// on barrier `cbar`, so a single round trip serves the absmax over all C
// and every code; then both scales.
__device__ void commit_int8_row(const AttnArgs& p, int b, int lane,
                                float* rowf, uint32_t cbar) {
  const size_t row = (size_t)b * p.C;
  if (lane == 0) {
    mbar_expect_tx(cbar, 8 * p.C);
    for (int t = 0; t < 2; ++t)
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
          " [%0], [%1], %2, [%3];\n" ::"r"(smem_u32(rowf + t * p.C)),
          "l"((t ? p.vnf : p.knf) + row), "r"(4 * p.C), "r"(cbar)
          : "memory");
  }
  mbar_wait(cbar, 0);
  const float4* kf = reinterpret_cast<const float4*>(rowf);
  const float4* vf = reinterpret_cast<const float4*>(rowf + p.C);
  const int nv = p.C / 4;
  float mk = 0.f, mv = 0.f;
  for (int i = lane; i < nv; i += 32) {
    const float4 k = kf[i], v = vf[i];
    mk = fmaxf(mk, fmaxf(fmaxf(fabsf(k.x), fabsf(k.y)),
                         fmaxf(fabsf(k.z), fabsf(k.w))));
    mv = fmaxf(mv, fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)),
                         fmaxf(fabsf(v.z), fabsf(v.w))));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    mk = fmaxf(mk, __shfl_xor_sync(0xffffffffu, mk, o));
    mv = fmaxf(mv, __shfl_xor_sync(0xffffffffu, mv, o));
  }
  const float ksc = fmaxf(mk, 1e-12f) / 127.0f;
  const float vsc = fmaxf(mv, 1e-12f) / 127.0f;
  const size_t at = (size_t)p.pos * p.B * p.C + row;
  char4* kc = reinterpret_cast<char4*>(static_cast<int8_t*>(p.kc) + at);
  char4* vc = reinterpret_cast<char4*>(static_cast<int8_t*>(p.vc) + at);
  for (int i = lane; i < nv; i += 32) {
    const float4 k = kf[i], v = vf[i];
    kc[i] = make_char4(code8(k.x, ksc), code8(k.y, ksc), code8(k.z, ksc),
                       code8(k.w, ksc));
    vc[i] = make_char4(code8(v.x, vsc), code8(v.y, vsc), code8(v.z, vsc),
                       code8(v.w, vsc));
  }
  if (lane == 0) {
    p.ks[(size_t)p.pos * p.B + b] = ksc;
    p.vs[(size_t)p.pos * p.B + b] = vsc;
  }
  __threadfence();  // visible before this CTA lets later launches start
  __syncwarp();
}

// One CTA: split blockIdx.x (its cluster rank) of batch row blockIdx.z's
// cache rows below pos, for heads [G blockIdx.y, G blockIdx.y + G).
// tk, tv: the caches as [T, B C], boxes {G 64, kRB}. CT: bf16 or int8_t.
template <int G, typename CT>
__global__ void __launch_bounds__(kThreads)
    decode_attn_kernel(const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const AttnArgs p) {
  constexpr bool kv8 = sizeof(CT) == 1;
  constexpr int kBox = box_bytes(G, sizeof(CT));
  constexpr int NPH = kWarps / G;  // warps a head
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 127) & ~127u;
  unsigned char* gbase = smem_raw + (base - raw);
  const int ST = p.stages, rows = p.rows;
  const int kr = blockIdx.x, ks = gridDim.x, g = blockIdx.y, b = blockIdx.z;
  float* sc = reinterpret_cast<float*>(gbase + ST * 2 * kBox);  // kv8
  float* rowf = sc + 2 * rows;  // kv8: the commit's f32 rows
  const uint32_t recv =
      base + ST * 2 * kBox + (kv8 ? 8 * rows + 8 * p.C : 0);
  const uint32_t full = recv + ks * kWarps * kRec * 4;
  const uint32_t empty = full + 8 * ST;
  const uint32_t cbar = empty + 8 * ST;  // the commit's rows
  const uint32_t rbar = cbar + 8;        // rank 0: the others' states
  const int t0 = kr * rows, t1 = min(p.pos, t0 + rows);
  const int nst = t1 > t0 ? (t1 - t0 + kRB - 1) / kRB : 0;
  const int c0 = b * p.C + g * G * kHD;  // the group's column in [B, C]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kWarps);
    }
    mbar_init(cbar, 1);
    mbar_init(rbar, 1);
    // rank 0 expects the other ranks' states as transaction bytes
    if (kr == 0 && ks > 1) mbar_expect_tx(rbar, (ks - 1) * kWarps * kRec * 4);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // rank 0's barriers are initialised, and every CTA of the cluster has
  // started, before a rank writes into rank 0 (its wait, below)
  if (ks > 1)
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  // the CTA that commits an int8 row: rank 0 of head group 0; its producer
  // warp commits and lets later launches start, its consumers do not
  const bool commits = kv8 && g == 0 && kr == 0;
  if (warp == kWarps) {
    // ------------------------------------------------ the producer warp
    auto issue = [&](int i) {
      const int s = i % ST;
      if (i >= ST) mbar_wait(empty + 8 * s, (i / ST - 1) & 1);
      const uint32_t st = base + s * 2 * kBox, bar = full + 8 * s;
      mbar_expect_tx(bar, 2 * kBox);
      tma_load_2d(&tk, st, bar, c0, t0 + i * kRB);
      tma_load_2d(&tv, st + kBox, bar, c0, t0 + i * kRB);
    };
    const int pre = min(ST, nst);
    if (lane == 0)
      for (int i = 0; i < pre; ++i) issue(i);
    if (commits) {
      gemm::griddep_wait();  // knf, vnf: launch 1's output
      commit_int8_row(p, b, lane, rowf, cbar);
      if (lane == 0) gemm::griddep_launch_dependents();
    }
    if (lane == 0)
      for (int i = pre; i < nst; ++i) issue(i);
    __syncwarp();
    if (ks > 1) gemm::cluster_wait();
    return;
  }

  // ------------------------------------------------------ the consumers
  // with int8 caches the split's scales (rows <= kMaxRows: two a thread),
  // loaded before the wait and stored after it, under the q load
  float skr[2] = {0.f, 0.f}, svr[2] = {0.f, 0.f};
  if constexpr (kv8)
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int i = threadIdx.x + 32 * kWarps * u;
      if (i < t1 - t0) {
        skr[u] = p.ks[(size_t)(t0 + i) * p.B + b];
        svr[u] = p.vs[(size_t)(t0 + i) * p.B + b];
      }
    }
  gemm::griddep_wait();  // q, k_new, v_new: launch 1's output
  if (threadIdx.x == 0 && !commits) gemm::griddep_launch_dependents();

  const int h = warp % G, ph = warp / G;
  const int sub = lane >> 3, d0 = 8 * (lane & 7);
  // rank 0's warps < G read the current position in the merge: load it
  // now, under the loop
  float2 qn = make_float2(0.f, 0.f), kn = qn, vn = qn;
  if (kr == 0 && warp < G) {
    const int col = c0 + h * kHD + 2 * lane;
    qn = gemm::ld_bf16x2(p.q + col);
    kn = gemm::ld_bf16x2(p.kn + col);
    vn = gemm::ld_bf16x2(p.vn + col);
  }
  float qv[8];
  load8(p.q + c0 + h * kHD + d0, qv);
#pragma unroll
  for (int e = 0; e < 8; ++e) qv[e] *= p.scale_log2;
  if constexpr (kv8) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int i = threadIdx.x + 32 * kWarps * u;
      if (i < t1 - t0) {
        sc[i] = skr[u];
        sc[rows + i] = svr[u];
      }
    }
    asm volatile("bar.sync 1, %0;\n" ::"n"(32 * kWarps) : "memory");
  }
  float m = -INFINITY, l = 0.f, acc[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) acc[e] = 0.f;
  // an 8-lane group takes rows slot + 4 NPH k of each box (k < RPS): its
  // RPS rows' scores together, then one update of its state
  constexpr int RPS = kRB / (4 * NPH);
  const int slot = 4 * ph + sub;
  for (int i = 0; i < nst; ++i) {
    const int s = i % ST;
    mbar_wait(full + 8 * s, (i / ST) & 1);
    const CT* kst = reinterpret_cast<const CT*>(gbase + s * 2 * kBox);
    const CT* vst = reinterpret_cast<const CT*>(gbase + s * 2 * kBox + kBox);
    const int r0 = i * kRB, nr = min(kRB, t1 - t0 - r0);
    // (the shuffles run on every lane; a row past the split is read
    // clamped to the last live one and weighs 0)
    float sv[RPS], mx = m;
#pragma unroll
    for (int k = 0; k < RPS; ++k) {
      const int jj = min(slot + 4 * NPH * k, nr - 1);
      float kf[8];
      load8(kst + jj * G * kHD + h * kHD + d0, kf);
      float a = 0.f, b2 = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        a += qv[e] * kf[e];
        b2 += qv[e + 4] * kf[e + 4];
      }
      sv[k] = a + b2;
    }
#pragma unroll
    for (int o = 1; o <= 4; o <<= 1)
#pragma unroll
      for (int k = 0; k < RPS; ++k)
        sv[k] += __shfl_xor_sync(0xffffffffu, sv[k], o);
#pragma unroll
    for (int k = 0; k < RPS; ++k) {
      const int j = slot + 4 * NPH * k;
      if constexpr (kv8) sv[k] *= sc[min(j, nr - 1) + r0];
      if (j >= nr) sv[k] = -INFINITY;
      mx = fmaxf(mx, sv[k]);
    }
    if (mx != -INFINITY) {  // a group with no live row keeps its state
      const float c = attn::ex2(m - mx);  // 0 while m = -inf
      l *= c;
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[e] *= c;
#pragma unroll
      for (int k = 0; k < RPS; ++k) {
        const int jj = min(slot + 4 * NPH * k, nr - 1);
        const float pr = attn::ex2(sv[k] - mx);  // 0 past the split
        l += pr;
        const float pv = kv8 ? pr * sc[rows + r0 + jj] : pr;
        float vf[8];
        load8(vst + jj * G * kHD + h * kHD + d0, vf);
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[e] += pv * vf[e];
      }
      m = mx;
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * s);
  }
  // the warp's four 8-lane states into one (lanes 0-7 hold it)
#pragma unroll
  for (int o = 8; o <= 16; o <<= 1) {
    const float mo = __shfl_xor_sync(0xffffffffu, m, o);
    const float lo = __shfl_xor_sync(0xffffffffu, l, o);
    float ao[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) ao[e] = __shfl_xor_sync(0xffffffffu, acc[e], o);
    merge_state(m, l, acc, mo, lo, ao);
  }
  // the state (acc[64], m, l) into record (rank, warp) of rank 0: from
  // another rank by asynchronous stores that count their bytes on rank
  // 0's barrier `rbar` (no cluster-wide barrier after them; a rank's
  // shared memory is never read by another, so it may then exit)
  if (ks > 1) gemm::cluster_wait();  // rank 0's barriers are initialised
  const uint32_t rec = recv + (kr * kWarps + warp) * kRec * 4;
  if (kr != 0) {
    if (lane < 8) {
      const uint32_t r = gemm::cluster_addr(rec, 0);
      const uint32_t bar = gemm::cluster_addr(rbar, 0);
      st_async_f4(r + 4 * d0, acc[0], acc[1], acc[2], acc[3], bar);
      st_async_f4(r + 4 * d0 + 16, acc[4], acc[5], acc[6], acc[7], bar);
      if (lane == 0) st_async_f4(r + 256, m, l, 0.f, 0.f, bar);
    }
    return;
  }
  if (lane < 8) {
    float* r = reinterpret_cast<float*>(gbase + (rec - base));
    *reinterpret_cast<float4*>(r + d0) =
        make_float4(acc[0], acc[1], acc[2], acc[3]);
    *reinterpret_cast<float4*>(r + d0 + 4) =
        make_float4(acc[4], acc[5], acc[6], acc[7]);
    if (lane == 0)
      *reinterpret_cast<float4*>(r + 64) = make_float4(m, l, 0.f, 0.f);
  }
  asm volatile("bar.sync 1, %0;\n" ::"n"(32 * kWarps) : "memory");
  if (warp >= G) return;

  // rank 0, warp h: head h's states in (rank, warp) order, then the
  // current position, then the normalisation; lane L has dims 2L, 2L + 1
  const float* recs = reinterpret_cast<const float*>(gbase + (recv - base));
  const int col = c0 + h * kHD + 2 * lane;
  float sn = qn.x * p.scale_log2 * kn.x + qn.y * p.scale_log2 * kn.y;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    sn += __shfl_xor_sync(0xffffffffu, sn, o);
  if (ks > 1) mbar_wait(rbar, 0);  // the other ranks' states have landed
  float M = sn;
  for (int r = 0; r < ks; ++r)
#pragma unroll
    for (int w = h; w < kWarps; w += G)
      M = fmaxf(M, recs[(r * kWarps + w) * kRec + 64]);
  float L = 0.f, A0 = 0.f, A1 = 0.f;
  for (int r = 0; r < ks; ++r)
#pragma unroll
    for (int w = h; w < kWarps; w += G) {
      const float* rc = recs + (r * kWarps + w) * kRec;
      const float mr = rc[64];
      const float c = mr == -INFINITY ? 0.f : attn::ex2(mr - M);
      const float2 a = *reinterpret_cast<const float2*>(rc + 2 * lane);
      L += rc[65] * c;
      A0 += a.x * c;
      A1 += a.y * c;
    }
  const float pn = attn::ex2(sn - M);
  L += pn;
  A0 += pn * vn.x;
  A1 += pn * vn.y;
  const float inv = 1.0f / L;
  *reinterpret_cast<__nv_bfloat162*>(p.out + col) =
      __floats2bfloat162_rn(A0 * inv, A1 * inv);
}

// The ring's depth for a grid of `splits` x C / (G 64) x B CTAs: the
// deepest, up to kMaxStages and the split's boxes, at which an SM still
// holds one CTA more than the grid needs of it, as the occupancy API
// counts the built kernel's registers, threads and shared memory (1 where
// none does).
template <typename Kernel>
cudaError_t ring_depth(Kernel kernel, int G, int esize, int dev, int splits,
                       int rows, int C, int B, int* stages) {
  int sms = 0;
  cudaError_t e =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const long long ctas = (long long)splits * (C / (G * kHD)) * B;
  const long long need = (ctas + sms - 1) / sms + 1;
  *stages = 1;
  for (int st = 2; st <= kMaxStages && st * kRB <= rows; ++st) {
    int per_sm = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, kThreads, attn_smem(G, esize, st, splits, rows, C));
    if (e != cudaSuccess) return e;
    if (per_sm < need) break;
    *stages = st;
  }
  return cudaSuccess;
}

template <int G, typename CT>
int launch_attn(const AttnArgs& a, int T, int splits, bool pdl,
                cudaStream_t stream) {
  constexpr int esize = sizeof(CT);
  auto kernel = decode_attn_kernel<G, CT>;
  int dev = 0;
  cudaError_t e = attn::bind_device(&dev);
  if (e != cudaSuccess) return (int)e;
  CUtensorMap tk, tv;
  const int cols = a.B * a.C;
  if (!gemm::cached_map(&tk, dev, a.kc, T, cols, G * kHD, kRB, esize,
                        false) ||
      !gemm::cached_map(&tv, dev, a.vc, T, cols, G * kHD, kRB, esize, false))
    return (int)cudaErrorInvalidValue;
  static unsigned long long smem_set = 0;  // the opt-in, once per device
  // the ring's depth, once per (device, splits, rows, C, B)
  static std::map<std::tuple<int, int, int, int, int>, int> depths;
  static std::mutex mu;
  AttnArgs p = a;
  {
    std::lock_guard<std::mutex> lock(mu);
    e = attn::allow_smem(kernel, kSmemCap, dev, smem_set);
    if (e != cudaSuccess) return (int)e;
    const auto key = std::make_tuple(dev, splits, a.rows, a.C, a.B);
    auto it = depths.find(key);
    if (it == depths.end()) {
      e = ring_depth(kernel, G, esize, dev, splits, a.rows, a.C, a.B,
                     &p.stages);
      if (e != cudaSuccess) return (int)e;
      it = depths.emplace(key, p.stages).first;
    }
    p.stages = it->second;
  }
  return attn::launch_ex(kernel, dim3(splits, a.C / (G * kHD), a.B), kThreads,
                         attn_smem(G, esize, p.stages, splits, a.rows, a.C),
                         stream, splits, pdl, tk, tv, p);
}

template <typename CT>
int launch_group(const AttnArgs& a, int T, int G, int splits, bool pdl,
                 cudaStream_t st) {
  return G == 4   ? launch_attn<4, CT>(a, T, splits, pdl, st)
         : G == 2 ? launch_attn<2, CT>(a, T, splits, pdl, st)
                  : launch_attn<1, CT>(a, T, splits, pdl, st);
}

}  // namespace dattn
}  // namespace rdmk

// Launch 1: LN1 + [q | k | v] = x @ wqkv at R = B rows. wqkv_s null: bf16
// wqkv; else int8 codes with bf16 column scales [3C]. k, v: where k_new and
// v_new go (row pos of the caches for a bf16 in-place commit, else buffers
// [B, C]); knf, vnf: the f32 rows (int8 caches) or both null. The plan
// (`gemm_plan("qkv", B, 3C, C, split_k=True)`): bm, bn, pp, tiles_per_cta,
// stages, ks. pdl: may start under the launch before it in the stream.
extern "C" int rdm_decode_proj(const void* x, const void* n1s,
                               const void* n1b, const void* wqkv,
                               const void* wqkv_s, void* q, void* k, void* v,
                               void* knf, void* vnf, int B, int C, int bm,
                               int bn, int pp, int tpc, int stages, int ks,
                               int pdl, void* stream) {
  using namespace rdmk::gemm;
  if (C % 64 || B < 1 || (knf == nullptr) != (vnf == nullptr))
    return (int)cudaErrorInvalidValue;
  DecodeArgs a{};
  a.R = B;
  a.N = 3 * C;
  a.K = C;
  a.S = 1;
  a.T = 1;
  a.ln_s = (const float*)n1s;
  a.ln_b = (const float*)n1b;
  a.ws0 = (const bf16*)wqkv_s;
  a.out = (bf16*)q;
  a.out1 = (bf16*)k;
  a.out2 = (bf16*)v;
  a.outf1 = (float*)knf;
  a.outf2 = (float*)vnf;
  const Plan pl{bm, bn, pp, tpc, stages, ks};
  const cudaStream_t st = (cudaStream_t)stream;
  if (wqkv_s == nullptr)
    return launch_decode<kQkv, bf16>(pl, x, wqkv, nullptr, a, pdl != 0, st);
  return launch_decode<kQkv, int8_t>(pl, x, wqkv, nullptr, a, pdl != 0, st);
}

// Launch 2: the attention of q over cache rows < pos and the current
// position (kn, vn), into out [B, C]. ks null: bf16 caches kc, vc [T, B,
// C]; else int8 caches with f32 scale caches ks, vs [T, B] and the f32
// rows knf, vnf [B, C] whose codes and scales it commits at row pos. The
// plan (`attn_plan`): G heads a CTA (4, 2 or 1), `splits` CTAs a cluster
// of `rows` cache rows each (a multiple of 16); the ring's depth is the
// launcher's (`ring_depth`).
extern "C" int rdm_decode_attn(const void* q, const void* kn, const void* vn,
                               void* kc, void* vc, void* ks, void* vs,
                               const void* knf, const void* vnf, void* out,
                               int pos, int T, int B, int C, int heads,
                               float scale_log2, int G, int splits, int rows,
                               int pdl, void* stream) {
  using namespace rdmk::dattn;
  const bool kv8 = ks != nullptr;
  if (heads * kHD != C || B < 1 || pos < 0 || pos >= T || rows > kMaxRows ||
      (G != 1 && G != 2 && G != 4) || heads % G || splits < 1 ||
      splits > kMaxSplits || rows < kRB || rows % kRB ||
      (long long)splits * rows < pos ||
      (splits > 1 && (long long)(splits - 1) * rows >= pos) ||
      attn_smem(G, kv8 ? 1 : 2, 1, splits, rows, C) > kSmemCap ||
      (vs == nullptr) != !kv8 || (knf == nullptr) != !kv8 ||
      (vnf == nullptr) != !kv8)
    return (int)cudaErrorInvalidValue;
  AttnArgs a{};
  a.q = (const bf16*)q;
  a.kn = (const bf16*)kn;
  a.vn = (const bf16*)vn;
  a.kc = kc;
  a.vc = vc;
  a.ks = (float*)ks;
  a.vs = (float*)vs;
  a.knf = (const float*)knf;
  a.vnf = (const float*)vnf;
  a.out = (bf16*)out;
  a.pos = pos;
  a.B = B;
  a.C = C;
  a.rows = rows;
  a.scale_log2 = scale_log2;
  const cudaStream_t st = (cudaStream_t)stream;
  return kv8 ? launch_group<int8_t>(a, T, G, splits, pdl != 0, st)
             : launch_group<bf16>(a, T, G, splits, pdl != 0, st);
}
