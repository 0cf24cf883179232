// int8 multi-head self-attention core of a SpatialTransformer block, for
// Hopper (sm_90a): integer codes made once, then s8 wgmma products over
// them, scores and output in registers.
//
// Replaces rdm_tpu/ops/block_kernel.py:193 `_packed_attn_kernel_q8` (the
// opt-in RDM_TPU_INT8_ATTN=1 core of the int8 serving mode). For q, k, v
// [B, S, C] bf16 with head h at channels [dh, dh + d), d = head_dim 32 or
// 64, per head:
//   qq, kq, vq = clip(rint(t / s_t), +-127)        (division, as the TPU)
//   sc  = (qq kq^T) * c,  c = qs ks d^-1/2 log2 e  (int32 exact, then f32)
//   p   = exp2(sc - rowmax(sc)),  den = sum(p)     (f32, over the whole row)
//   o   = ((rint(127 p) vq) * (vs / 127)) * (1 / den)
// The dynamic scales follow the TPU grid's cells, not the heads: s_t =
// max(absmax, 1e-12) / 127 over one image's 128-channel group (4 heads of
// 32 or 2 of 64; the last group of C = 576 holds 2 of 32), for q also over
// one q-block of `bq` rows (the whole S up to 512, else 512 rows or fewer),
// for k and v over the whole S. c is formed in f32 in JAX's order.
//
// Three launches, counted as one call by the wrapper; the second and third
// start by programmatic dependent launch, under the one before them, and
// wait (griddepcontrol.wait) before they read what it writes:
// 1. attn_absmax_kernel: the maxima of each 64 rows of a cell, no
//    atomics (the codes launch reduces them into the per-cell absmax).
// 2. attn_codes_kernel: every element quantized once, q and k into q8, k8
//    [B, S, C] int8 and v into v8t [B, C, S'] (S' = S rounded up to 64,
//    zero for the keys past S). 8-bit wgmma reads both operands K-major
//    only (it has no transpose bit), and for p v the K dimension is the
//    keys, so V has to lie transposed in memory. Within every 32 keys v8t
//    holds them in the order of the p fragment (key_slot): thread t of a
//    quad holds scores
//    of keys 8j + 2t, + 1 (the s32 accumulator of q k^T), where the 8-bit
//    register A fragment of p v wants four consecutive K positions 4t ..
//    4t + 3 and 16 + 4t ..; putting key 8j + 2t + e at position 4t + 2j +
//    e (j, e < 2, a half of 32) lets each thread pack its own four codes
//    into a register, with no shuffle. The int32 sums of p v over the keys
//    are exact in any order.
// 3. attn_q8_kernel<D>: one warpgroup owns 64 query rows of one (image,
//    head), as the bf16 core (csrc/attn_fwd_sm90.cuh) does: the Q codes by
//    TMA once, K and V code tiles of 64 keys by TMA into an mbarrier ring
//    that thread 0 keeps two tiles ahead, S = Q K^T as wgmma
//    m64n64k32.s32.s8.s8 (one instruction a tile at d = 32, two at 64),
//    both operands from shared memory, 32- or 64-byte swizzled. p is
//    quantized against the row's FINAL max, so an online rescale would
//    change the codes: the CTA walks the keys twice. Pass 1 is integer
//    only: c > 0 and f32 rounding is monotone, so max(float(s) c) =
//    float(max s) c; it keeps an int32 row max (keys past S: INT_MIN) and
//    does no exp2. Pass 2 recomputes each tile's S and per score does
//    float(s) (an integer add and an f32 subtract: |s| <= 127^2 d < 2^22),
//    the product by c and the subtraction of the max rounded apart as JAX
//    rounds them, one ex2, the f32 den sum and rint(127 p) (an add of
//    1.5 * 2^23), and issues P V as wgmma m64n{d}k32 with P the register A
//    fragment, into an int32 accumulator that needs no rescaling
//    (127 * 127 * S < 2^31 up to S = 133,000). The next tile's S is issued
//    before this tile's softmax and each P V runs on under the next tile's
//    softmax (two code buffers), so the tensor cores run while the CUDA
//    cores and the SFU do; pass 1 issues two tiles' S before it waits.
//
// What bounds it on the H100: 4 B S^2 C int8 operations (12.9 / 1.2 / 0.13
// GOP at the three U-Net sites at 8 images) at 1,979 TOP/s against q, k,
// v read once and o written once (8 B S C bytes); and, as for the bf16
// core, the exponentials: one ex2 a score, 16 per SM per clock.
#include <climits>

#include "block_gemm_sm90.cuh"

namespace rdmk {
namespace attn8 {

using attn::bf16;

constexpr int kGroup = 128;  // channels of a scale cell (the TPU's lanes)
constexpr int kQRows = 64;   // query rows of an attention CTA
constexpr int kKeys = 64;    // keys of a tile
constexpr int kRing = 4;     // K / V ring stages
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float cell_scale(float absmax) {
  return __fdiv_rn(fmaxf(absmax, 1e-12f), 127.0f);
}

// ------------------------------------------------- 1. the cells' absmax

// The cells' absmax, amax [B, groups, S / bq + 2] (slots 0 .. S / bq - 1
// q per q-block, then k, then v), in two steps and no atomics. A CTA of
// this launch takes 64 rows of one 128-channel group of one image, a
// thread 8 channels of 4 rows of each tensor (its twelve 16-byte loads
// issued before it reduces any), and writes its rows' maxima of q, k and
// v to part [B, groups, S' / 64, 3]. Where q-blocks are shorter than 64
// rows (they divide 64 then) it owns whole q-blocks and writes their
// slots of amax itself. The codes launch reduces the parts of a cell
// (cell_max) and writes the rest of amax.

// True where a 64-row block lies in one q-block (bq a multiple of 64, or
// the whole S).
__host__ __device__ inline bool one_q_cell(int S, int bq) {
  return bq % kKeys == 0 || bq >= S;
}

__global__ void __launch_bounds__(256)
    attn_absmax_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, float* __restrict__ part,
                       float* __restrict__ amax, int S, int C, int bq) {
  __shared__ float red[8][3];
  __shared__ float qrow[kKeys];
  gemm::griddep_launch_dependents();
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int u = tid & 15, rl = tid >> 4;  // channels 8u .., rows rl + 16 i
  const int row0 = blockIdx.x * kKeys, g = blockIdx.y, b = blockIdx.z;
  const int groups = gridDim.y, nqb = S / bq;
  const int c0 = g * kGroup + 8 * u;
  const bf16* src[3] = {q, k, v};
  uint4 x[4][3];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + rl + 16 * i;
#pragma unroll
    for (int t = 0; t < 3; ++t)
      x[i][t] = row < S && c0 < C
                    ? __ldg(reinterpret_cast<const uint4*>(
                          src[t] + ((size_t)b * S + row) * C + c0))
                    : make_uint4(0u, 0u, 0u, 0u);
  }
  float m[4][3];  // |max| of each row's 8 values, per tensor
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int t = 0; t < 3; ++t) {
      const __nv_bfloat162* h =
          reinterpret_cast<const __nv_bfloat162*>(&x[i][t]);
      float a = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(h[e]);
        a = fmaxf(a, fmaxf(fabsf(f.x), fabsf(f.y)));
      }
      m[i][t] = a;
    }
  float r[3];
#pragma unroll
  for (int t = 0; t < 3; ++t) {
    r[t] = fmaxf(fmaxf(m[0][t], m[1][t]), fmaxf(m[2][t], m[3][t]));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      r[t] = fmaxf(r[t], __shfl_xor_sync(0xffffffffu, r[t], o));
  }
  if (lane == 0)
    for (int t = 0; t < 3; ++t) red[warp][t] = r[t];
  const bool one_q = one_q_cell(S, bq);
  if (!one_q) {  // q per row (a row's 16 lanes), then per q-block
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float a = m[i][0];
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, o));
      if (u == 0) qrow[rl + 16 * i] = a;
    }
  }
  __syncthreads();
  if (tid < 3) {
    float a = 0.f;
    for (int w = 0; w < 8; ++w) a = fmaxf(a, red[w][tid]);
    part[(((size_t)b * groups + g) * gridDim.x + blockIdx.x) * 3 + tid] = a;
  }
  if (!one_q && tid < kKeys / bq && row0 + tid * bq < S) {
    float a = 0.f;
    for (int r2 = 0; r2 < bq; ++r2) a = fmaxf(a, qrow[tid * bq + r2]);
    amax[(size_t)(b * groups + g) * (nqb + 2) + row0 / bq + tid] = a;
  }
}

// The max over parts [p0, p1) of part's column t (0 q, 1 k, 2 v) of one
// (image, group), by one warp; every lane gets it.
__device__ __forceinline__ float cell_max(const float* part, int p0, int p1,
                                          int t, int lane) {
  float a = 0.f;
  for (int p = p0 + lane; p < p1; p += 32) a = fmaxf(a, part[3 * p + t]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, o));
  return a;
}

// ------------------------------------------------------- 2. the codes

// The position of key kappa (0 .. 63) of a 64-key block in v8t: within
// each 32 keys, key 8j + 2t + e (j < 4, t < 4, e < 2) goes to 4t + 2(j % 2)
// + e + 16 (j / 2), where thread t of a quad finds it in its p fragment.
__host__ __device__ constexpr int key_slot(int kappa) {
  return (kappa & 48) | ((kappa & 6) << 1) | ((kappa >> 2) & 2) | (kappa & 1);
}

// clip(rint(t / s), +-127) in the low byte, the division rounded as the
// TPU's; + 1.5 * 2^23 rounds half to even onto an integer, as rint does.
__device__ __forceinline__ uint32_t code(float t, float s) {
  const float c = fminf(fmaxf(__fdiv_rn(t, s), -127.f), 127.f);
  return __float_as_uint(__fadd_rn(c, 12582912.f));
}

// the codes of the eight bf16 at p, in order
__device__ __forceinline__ uint2 codes8(const bf16* p, float s) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
  uint32_t w[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(h[e]);
    w[e] = __byte_perm(code(f.x, s), code(f.y, s), 0x0040);
  }
  return make_uint2(gemm::lo16x2(w[0], w[1]), gemm::lo16x2(w[2], w[3]));
}

// One CTA: 64 keys (rows of q, k, v) x 32 channels of one image; a thread
// one row's 8 channels of each tensor. Rows past S (up to S') write zero
// v codes and nothing else.
__global__ void __launch_bounds__(256)
    attn_codes_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v,
                      const float* __restrict__ part, float* __restrict__ amax,
                      int8_t* __restrict__ q8, int8_t* __restrict__ k8,
                      int8_t* __restrict__ v8t, int S, int Sp, int C, int bq) {
  __shared__ __align__(16) unsigned char vt[32 * kKeys];  // [channel][slot]
  __shared__ float mx[3];  // this CTA's q cell's, k's and v's absmax
  gemm::griddep_launch_dependents();
  gemm::griddep_wait();  // the parts
  const int tid = threadIdx.x, r = tid >> 2, u = tid & 3;
  const int key0 = blockIdx.x * kKeys, c0 = blockIdx.y * 32, b = blockIdx.z;
  const int groups = (C + kGroup - 1) / kGroup, nqb = S / bq;
  const int nblk = Sp / kKeys, g = c0 / kGroup;
  float* cell = amax + (size_t)(b * groups + g) * (nqb + 2);
  if (tid < 96) {  // three warps: q (one_q), k, v; the cells written too
    const int t = tid >> 5, lane = tid & 31;
    const float* pg = part + ((size_t)b * groups + g) * nblk * 3;
    const int qb = key0 / bq;  // the rows' q-block (one_q)
    const int p0 = t ? 0 : qb * bq / kKeys;
    const int p1 = t || bq >= S ? nblk : (qb + 1) * bq / kKeys;
    if (t || one_q_cell(S, bq)) {
      const float a = cell_max(pg, p0, p1, t, lane);
      if (lane == 0) {
        mx[t] = a;
        cell[t ? nqb + t - 1 : qb] = a;  // the same value from every CTA
      }
    }
  }
  __syncthreads();
  const int row = key0 + r;
  uint2 vc = make_uint2(0u, 0u);
  if (row < S) {
    const size_t off = ((size_t)b * S + row) * C + c0 + 8 * u;
    const float qm = one_q_cell(S, bq) ? mx[0] : cell[row / bq];
    *reinterpret_cast<uint2*>(q8 + off) = codes8(q + off, cell_scale(qm));
    *reinterpret_cast<uint2*>(k8 + off) = codes8(k + off, cell_scale(mx[1]));
    vc = codes8(v + off, cell_scale(mx[2]));
  }
  const unsigned char* cb = reinterpret_cast<const unsigned char*>(&vc);
#pragma unroll
  for (int j = 0; j < 8; ++j) vt[(8 * u + j) * kKeys + key_slot(r)] = cb[j];
  __syncthreads();
  const int ch = tid >> 3, piece = tid & 7;  // 32 rows of 64 bytes
  *reinterpret_cast<uint2*>(v8t + ((size_t)b * C + c0 + ch) * Sp + key0 +
                            8 * piece) =
      *reinterpret_cast<const uint2*>(vt + ch * kKeys + 8 * piece);
}

// --------------------------------------------------- 3. the attention

// Shared memory of one CTA: Q codes | kRing x (K codes | V codes) |
// barriers, every tile on a 1 KB boundary.
template <int D>
struct Smem8 {
  static_assert(D == 32 || D == 64, "head_dim 32 or 64");
  static constexpr int kQTile = kQRows * D;  // 64 rows of D codes
  static constexpr int kKTile = kKeys * D;   // 64 keys of D codes
  static constexpr int kVTile = D * kKeys;   // D channels of 64 key slots
  static constexpr int kStage = kKTile + kVTile;
  static constexpr int kRingOff = kQTile;
  static constexpr int kBarOff = kRingOff + kRing * kStage;
  static constexpr int kBytes = kBarOff + 8 * (2 * kRing + 1) + 1024;
};

// d[N / 2] += A [64, 32] (registers: 8-bit codes, four K positions a
// register) @ B^T, B [N, 32] (shared, K-major): int8 x int8 -> int32,
// always accumulating (scale-d 1).
template <int N>
__device__ __forceinline__ void wgmma_s8_rs(int (&d)[N / 2],
                                            const uint32_t (&a)[4],
                                            uint64_t b);

template <>
__device__ __forceinline__ void wgmma_s8_rs<32>(int (&d)[16],
                                                const uint32_t (&a)[4],
                                                uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15 "
      "}, {%16, %17, %18, %19}, %20, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_s8_rs<64>(int (&d)[32],
                                                const uint32_t (&a)[4],
                                                uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// float(s) for |s| < 2^22: the bits of 1.5 * 2^23 + s, minus 1.5 * 2^23
// (an integer add and an f32 subtract, both exact, where an int -> float
// conversion runs at a quarter of their rate)
__device__ __forceinline__ float i2f(int s) {
  return __fsub_rn(__int_as_float(s + 0x4B400000), 12582912.f);
}

// The low bytes of a, b, c, d in order
__device__ __forceinline__ uint32_t bytes4(uint32_t a, uint32_t b, uint32_t c,
                                           uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040),
                     0x5410);
}

// A CTA's walk. Items 0 .. nkt - 1 are pass 1's key tiles (K alone),
// items nkt .. 2 nkt - 1 pass 2's (K and V); item u sits in ring stage
// u % kRing. This thread holds rows `row` and `row + 8` of the 64, key
// columns 8j + col + {0, 1} of every n8 block j of S (elements 4j + {0, 1}
// and 4j + {2, 3}), and the same columns of O.
template <int D>
struct Walk8 {
  using L = Smem8<D>;
  const CUtensorMap *tk, *tv;
  uint32_t qs, ring, full, empty;  // shared addresses
  int S, nkt, h, b, C, col, lane;
  float c0, c1;  // the rows' score constants
  int x0, x1;    // pass 1's running int32 row maxima
  float m0, m1;  // the rows' final maxima, scaled (log2 domain)
  float d0, d1;  // this thread's shares of the denominators
  int o[D / 2];  // sum of p codes x v codes

  // item u into its stage (thread 0)
  __device__ __forceinline__ void load(int u) {
    const int s = u % kRing, t = u < nkt ? u : u - nkt;
    const uint32_t st = ring + s * L::kStage, bar = full + 8 * s;
    attn::mbar_expect_tx(bar, L::kKTile + (u < nkt ? 0 : L::kVTile));
    attn::tma_load(tk, st, bar, 0, h, t * kKeys, b);
    if (u >= nkt)
      attn::tma_load_2d(tv, st + L::kKTile, bar, t * kKeys, b * C + h * D);
  }

  // At the start of item i thread 0 refills the stage of item i - 2 with
  // item i + 2, so item i + 1 has been in flight for an item. Items
  // 0 .. kRing - 1 were issued before the walk.
  __device__ __forceinline__ void produce(int i) {
    const int u = i + kRing - 2;
    if (threadIdx.x == 0 && u >= kRing && u < 2 * nkt) {
      attn::mbar_wait(empty + 8 * (u % kRing), (u / kRing - 1) & 1);
      load(u);
    }
    __syncwarp();
  }

  // S = Q K^T of item u, issued and committed (not waited for), once its
  // tiles have landed
  __device__ __forceinline__ void issue_qk(int (&s)[kKeys / 2], int u) {
    attn::mbar_wait(full + 8 * (u % kRing), (u / kRing) & 1);
    const uint32_t kt = ring + (u % kRing) * L::kStage;
    attn::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 32; ++kk)
      gemm::wgmma_s8<kKeys>(s, attn::sw_desc<D>(qs + kk * 32),
                            attn::sw_desc<D>(kt + kk * 32), kk > 0);
    attn::wgmma_commit();
  }

  // O += P V of item u, P the codes of its 64 keys: registers 2 jp + hh
  // hold row `row + 8 hh`'s codes of n8 blocks 2 jp and 2 jp + 1, which
  // are K positions 32 (jp / 2) + 4 t + 16 (jp % 2) ... of v8t's slots
  __device__ __forceinline__ void issue_pv(const uint32_t (&p)[kKeys / 8],
                                           int u) {
    const uint32_t vt = ring + (u % kRing) * L::kStage + L::kKTile;
    attn::wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < kKeys / 32; ++kc) {
      const uint32_t a[4] = {p[4 * kc], p[4 * kc + 1], p[4 * kc + 2],
                             p[4 * kc + 3]};
      wgmma_s8_rs<D>(o, a, attn::sw_desc<64>(vt + kc * 32));
    }
    attn::wgmma_commit();
  }

  // hand item i's stage back to the producer, one arrival per warp
  __device__ __forceinline__ void release(int i) {
    __syncwarp();
    if (lane == 0) attn::mbar_arrive(empty + 8 * (i % kRing));
    __syncwarp();
  }

  // keys of the tile at or past S: the first masked column of this
  // thread's, 64 where none is
  __device__ __forceinline__ int live_cols(int t) const {
    return min(kKeys, S - t * kKeys - col);
  }

  // the int32 row maxima of key tile t's scores (keys past S: INT_MIN)
  __device__ __forceinline__ void row_max(int (&s)[kKeys / 2], int t) {
    const int lim = live_cols(t);
    if (lim < kKeys) {
#pragma unroll
      for (int j = 0; j < kKeys / 2; ++j)
        if (8 * (j >> 2) + (j & 1) >= lim) s[j] = INT_MIN;
    }
#pragma unroll
    for (int j = 0; j < kKeys / 2; j += 4) {
      x0 = max(x0, max(s[j], s[j + 1]));
      x1 = max(x1, max(s[j + 2], s[j + 3]));
    }
  }

  // Pass 1, items i and i + 1 (both < nkt): both S issued, one wait, then
  // the int32 row maxima; no exp2, no scaling.
  __device__ __forceinline__ void step1x2(int (&sa)[kKeys / 2],
                                          int (&sb)[kKeys / 2], int i) {
    produce(i);
    produce(i + 1);
    issue_qk(sa, i);
    issue_qk(sb, i + 1);
    attn::wgmma_wait<0>();
    gemm::fence_regs_s32(sa);
    gemm::fence_regs_s32(sb);
    row_max(sa, i);
    row_max(sb, i + 1);
    release(i);
    release(i + 1);
  }

  // Pass 2, item nkt + j (its S in cur): S of the next item into nxt
  // (kNext), then per score p = exp2(float(s) c - m) (each op rounded on
  // its own, as JAX rounds them), den += p, the code rint(127 p) into p;
  // then O += P V, left in flight: the wait lets only it run on, so the
  // next item's S and the P V before this one are done, and that one's
  // codes (prev) and V tile are free.
  template <bool kNext>
  __device__ __forceinline__ void step2(int (&cur)[kKeys / 2],
                                        int (&nxt)[kKeys / 2],
                                        uint32_t (&p)[kKeys / 8],
                                        uint32_t (&prev)[kKeys / 8], int j) {
    const int i = nkt + j;
    produce(i);
    if (kNext) issue_qk(nxt, i + 1);
#pragma unroll
    for (int e = 0; e < kKeys / 2; ++e)  // s c - m, as f32 bits in place
      cur[e] = __float_as_int(__fsub_rn(
          __fmul_rn(i2f(cur[e]), (e & 2) ? c1 : c0), (e & 2) ? m1 : m0));
    const int lim = live_cols(j);
    if (lim < kKeys) {
#pragma unroll
      for (int e = 0; e < kKeys / 2; ++e)
        if (8 * (e >> 2) + (e & 1) >= lim)
          cur[e] = __float_as_int(-INFINITY);
    }
#pragma unroll
    for (int jp = 0; jp < kKeys / 16; ++jp) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        uint32_t w[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          // n8 block 2 jp + e / 2, column e % 2, row half hh
          const int idx = 8 * jp + 4 * (e >> 1) + 2 * hh + (e & 1);
          const float pe = attn::ex2(__int_as_float(cur[idx]));
          if (hh) d1 += pe; else d0 += pe;
          w[e] = __float_as_uint(
              __fadd_rn(__fmul_rn(pe, 127.f), 12582912.f));
        }
        p[2 * jp + hh] = bytes4(w[0], w[1], w[2], w[3]);
      }
    }
    issue_pv(p, i);
    attn::wgmma_wait<1>();
    attn::fence_regs(prev);
    if (kNext) gemm::fence_regs_s32(nxt);
    if (j > 0) release(i - 1);
  }
};

// One CTA: 64 query rows of one (image, head); grid (ceil(S / 64), H, B),
// one warpgroup. tq, tk: the q8, k8 codes as {D, H, S, B} (boxes of 64
// rows of one head); tv: v8t as [B C, S'] (boxes of D channels x 64 key
// slots).
template <int D>
__global__ void __launch_bounds__(128, D == 32 ? 4 : 3)
    attn_q8_kernel(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   const float* __restrict__ amax, bf16* __restrict__ out,
                   int S, int H, int bq, float scale) {
  using L = Smem8<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (attn::smem_u32(smem_raw) + 1023) & ~1023u;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  Walk8<D> w;
  w.tk = &tk;
  w.tv = &tv;
  w.qs = base;
  w.ring = base + L::kRingOff;
  w.full = base + L::kBarOff;
  w.empty = w.full + 8 * kRing;
  const uint32_t qbar = w.empty + 8 * kRing;
  const int r0 = blockIdx.x * kQRows;
  w.S = S;
  w.nkt = (S + kKeys - 1) / kKeys;
  w.h = blockIdx.y;
  w.b = blockIdx.z;
  w.C = H * D;
  w.col = 2 * (lane & 3);
  w.lane = lane;
  const int row = r0 + warp * 16 + (lane >> 2);
  gemm::griddep_wait();  // the codes and the cells' absmax
  // the cell's scales; c = ((qs ks) d^-1/2) log2 e, in f32, JAX's order
  const int groups = (w.C + kGroup - 1) / kGroup, nqb = S / bq;
  const float* cell =
      amax + (size_t)(w.b * groups + w.h * D / kGroup) * (nqb + 2);
  const float ks = cell_scale(cell[nqb]), vs = cell_scale(cell[nqb + 1]);
  auto row_c = [&](int r) {
    const float qs = cell_scale(cell[min(r, S - 1) / bq]);
    return __fmul_rn(__fmul_rn(__fmul_rn(qs, ks), scale), kLog2e);
  };
  w.c0 = row_c(row);
  w.c1 = row_c(row + 8);
  w.x0 = w.x1 = INT_MIN;
  w.d0 = w.d1 = 0.f;
#pragma unroll
  for (int i = 0; i < D / 2; ++i) w.o[i] = 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kRing; ++s) {
      attn::mbar_init(w.full + 8 * s, 1);
      attn::mbar_init(w.empty + 8 * s, 4);  // one arrival per warp
    }
    attn::mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    attn::mbar_expect_tx(qbar, L::kQTile);
    attn::tma_load(&tq, w.qs, qbar, 0, w.h, r0, w.b);
    for (int u = 0; u < min(2 * w.nkt, kRing); ++u) w.load(u);
  }
  __syncthreads();

  // Every wgmma of a loop's body is issued unconditionally, two items an
  // iteration, so the two score buffers (and pass 2's two code buffers)
  // swap roles without copies.
  int sa[kKeys / 2], sb[kKeys / 2];
  attn::mbar_wait(qbar, 0);
  // pass 1: the row maxima, two key tiles a wait
  int i = 0;
  for (; i + 1 < w.nkt; i += 2) w.step1x2(sa, sb, i);
  if (i < w.nkt) {
    w.produce(i);
    w.issue_qk(sa, i);
    attn::wgmma_wait<0>();
    gemm::fence_regs_s32(sa);
    w.row_max(sa, i);
    w.release(i);
  }
  // the rows' maxima over their quads, scaled: max(float(s) c) =
  // float(max s) c, c > 0 and rounding monotone
#pragma unroll
  for (int o2 = 1; o2 <= 2; o2 <<= 1) {
    w.x0 = max(w.x0, __shfl_xor_sync(0xffffffffu, w.x0, o2));
    w.x1 = max(w.x1, __shfl_xor_sync(0xffffffffu, w.x1, o2));
  }
  w.m0 = __fmul_rn(i2f(w.x0), w.c0);
  w.m1 = __fmul_rn(i2f(w.x1), w.c1);
  // pass 2: p, den and the int32 P V, each P V in flight over the next
  // item's softmax
  uint32_t pa[kKeys / 8], pb[kKeys / 8];
#pragma unroll
  for (int e = 0; e < kKeys / 8; ++e) pa[e] = pb[e] = 0u;
  w.issue_qk(sa, w.nkt);
  attn::wgmma_wait<0>();
  gemm::fence_regs_s32(sa);
  int j = 0;
  for (; j + 2 < w.nkt; j += 2) {
    w.template step2<true>(sa, sb, pa, pb, j);
    w.template step2<true>(sb, sa, pb, pa, j + 1);
  }
  if (j + 1 < w.nkt) {
    w.template step2<true>(sa, sb, pa, pb, j);
    w.template step2<false>(sb, sa, pb, pa, j + 1);
    attn::wgmma_wait<0>();
    attn::fence_regs(pb);
  } else {
    w.template step2<false>(sa, sb, pa, pb, j);
    attn::wgmma_wait<0>();
    attn::fence_regs(pa);
  }
  gemm::fence_regs_s32(w.o);

  // o = ((P V) (vs / 127)) (1 / den): a row's den is in four shares
  float d0 = w.d0, d1 = w.d1;
#pragma unroll
  for (int o2 = 1; o2 <= 2; o2 <<= 1) {
    d0 += __shfl_xor_sync(0xffffffffu, d0, o2);
    d1 += __shfl_xor_sync(0xffffffffu, d1, o2);
  }
  const float v127 = __fdiv_rn(vs, 127.0f);
  const float i0 = __fdiv_rn(1.0f, d0), i1 = __fdiv_rn(1.0f, d1);
  bf16* dst = out + (size_t)w.b * S * w.C + w.h * D + w.col;
#pragma unroll
  for (int jj = 0; jj < D / 8; ++jj) {
    if (row < S)
      *reinterpret_cast<uint32_t*>(dst + (size_t)row * w.C + 8 * jj) =
          attn::pack_bf16(
              __fmul_rn(__fmul_rn((float)w.o[4 * jj], v127), i0),
              __fmul_rn(__fmul_rn((float)w.o[4 * jj + 1], v127), i0));
    if (row + 8 < S)
      *reinterpret_cast<uint32_t*>(dst + (size_t)(row + 8) * w.C + 8 * jj) =
          attn::pack_bf16(
              __fmul_rn(__fmul_rn((float)w.o[4 * jj + 2], v127), i1),
              __fmul_rn(__fmul_rn((float)w.o[4 * jj + 3], v127), i1));
  }
}

// ------------------------------------------------------------------ host

template <int D>
int launch_attn8(const void* q8, const void* k8, const void* v8t,
                 const float* amax, bf16* o, int B, int S, int H, int Sp,
                 int bq, float scale, int dev, cudaStream_t stream) {
  using L = Smem8<D>;
  CUtensorMap mq, mk, mv;
  if (!gemm::cached_map_bshd(&mq, dev, q8, B, S, H, D, kKeys, 1) ||
      !gemm::cached_map_bshd(&mk, dev, k8, B, S, H, D, kKeys, 1) ||
      !gemm::cached_map(&mv, dev, v8t, B * H * D, Sp, kKeys, D, 1))
    return (int)cudaErrorInvalidValue;
  static unsigned long long smem_set = 0;
  const cudaError_t e =
      attn::allow_smem(attn_q8_kernel<D>, L::kBytes, dev, smem_set);
  if (e != cudaSuccess) return (int)e;
  return attn::launch_ex(attn_q8_kernel<D>,
                         dim3((S + kQRows - 1) / kQRows, H, B), 128,
                         L::kBytes, stream, 1, true, mq, mk, mv, amax, o, S,
                         H, bq, scale);
}

}  // namespace attn8
}  // namespace rdmk

// q, k, v, o [B, S, heads * head_dim] bf16; part [B, groups, S' / 64, 3]
// and amax [B, groups, S / bq + 2] f32, q8, k8 [B, S, C] and v8t [B, C,
// S'] int8 scratch, S' = S rounded up to 64. Returns a cudaError_t.
extern "C" int rdm_packed_attn_q8(const void* q, const void* k, const void* v,
                                  void* part, void* amax, void* q8, void* k8,
                                  void* v8t, void* o, int B, int S, int heads,
                                  int head_dim, int bq, float scale,
                                  void* stream) {
  using namespace rdmk::attn8;
  if (B < 1 || S < 1 || bq < 1 || S % bq ||
      (head_dim != 32 && head_dim != 64))
    return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t e = rdmk::attn::bind_device(&dev);
  if (e != cudaSuccess) return (int)e;
  const cudaStream_t st = (cudaStream_t)stream;
  const int C = heads * head_dim, Sp = (S + kKeys - 1) / kKeys * kKeys;
  const int groups = (C + kGroup - 1) / kGroup;
  attn_absmax_kernel<<<dim3(Sp / kKeys, groups, B), 256, 0, st>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (float*)part,
      (float*)amax, S, C, bq);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int rc = rdmk::attn::launch_ex(
      attn_codes_kernel, dim3(Sp / kKeys, C / 32, B), 256, 0, st, 1, true,
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const float*)part,
      (float*)amax, (int8_t*)q8, (int8_t*)k8, (int8_t*)v8t, S, Sp, C, bq);
  if (rc) return rc;
  return head_dim == 64
             ? launch_attn8<64>(q8, k8, v8t, (const float*)amax, (bf16*)o, B,
                                S, heads, Sp, bq, scale, dev, st)
             : launch_attn8<32>(q8, k8, v8t, (const float*)amax, (bf16*)o, B,
                                S, heads, Sp, bq, scale, dev, st);
}
