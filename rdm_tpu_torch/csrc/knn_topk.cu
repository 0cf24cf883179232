// Exact top-k dot-product search over the retrieval table: two launches.
//
// Replaces rdm_tpu/ops/knn_kernel.py:_knn_kernel (driven by
// knn_search_fused): queries q [B, D] bf16 against the L2-normalised table
// [N, D] bf16, f32-accumulated products, -> the k best (score, id) of each
// query, ordered by score descending, ties to the lower id. The TPU kernel
// walked the table in 4096-row blocks in order on one core, carrying a
// running top-k in scratch from one grid step to the next; blocks of a CUDA
// grid run in parallel and in no order, so the walk becomes a split:
//
//   1. knn_partial_kernel: one CTA per (16-query tile, table slice). The
//      query tile sits in shared memory; the slice streams through shared
//      memory in 64-row chunks, double-buffered with cp.async. Each of the
//      four warps scores 16 rows of a chunk against the 16 queries with
//      mma.sync m16n8k16 (bf16 x bf16 -> f32). A score that beats its
//      query's current k-th entry goes to a candidate buffer; one thread per
//      query then inserts the candidates into the query's sorted list of k
//      (score, id) pairs. The lists ([B, slices, k]) go to device memory.
//   2. knn_merge_kernel: one CTA per query sorts its slices x k candidates
//      by (score desc, id asc) with a bitonic sort in shared memory and
//      writes the first k, ids as int64.
//
// Order is the total order (score desc, id asc) everywhere, so neither the
// order of the candidate buffer's atomics nor the slice split changes the
// result. Rows >= N are never loaded (zero-filled) and never become
// candidates: nothing pads the table, so no id >= N can come back (the TPU
// wrapper padded N with zero rows, which scored 0 and could win).
//
// What bounds it on the H100: the bytes of one pass over the table,
// N * D * 2 (1.31 GB for 1,281,280 x 512: 0.39 ms at 3.35 TB/s); the
// products are 2 * B * N * D operations (21 GFLOP at B = 16, 0.02 ms at
// 989 TFLOP/s). Each CTA keeps two 64-row chunks (128 KB at D = 512) in
// flight. A query tile holds 16 queries, so at B > 16 the table is read
// once per tile; CTAs of the same slice are launched next to each other
// (the query tile is blockIdx.x) so that they meet in the 50 MB L2.
// Plain mma.sync and 32-bit shared loads: wgmma, TMA and fragments kept in
// registers are later work.
#include "block_common.cuh"

namespace rdmk {
namespace knn {

constexpr int kQT = 16;           // queries per CTA: one m16 tile
constexpr int kRC = 64;           // table rows per streamed chunk
constexpr int kWarpRows = 16;     // rows of a chunk each warp scores
constexpr int kPad = 8;           // bf16 of row padding: conflict-free loads
constexpr int kMaxK = 128;
constexpr int kMaxMerge = 16384;  // candidates one merge CTA sorts
constexpr int kMergeThreads = 512;
constexpr int kNoId = 0x7fffffff;
static_assert(kThreads / 32 * kWarpRows == kRC, "four warps x 16 rows");

__device__ __forceinline__ bool better(float a, int ia, float b, int ib) {
  return a > b || (a == b && ia < ib);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// c += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__host__ __device__ inline size_t partial_smem(int D, int k) {
  const size_t ld = (size_t)D + kPad;
  return (size_t)kQT * ld * 2 + (size_t)2 * kRC * ld * 2   // query tile, 2 chunks
         + (size_t)kQT * k * 8                            // lists
         + (size_t)kQT * kRC * 8 + kQT * 4;               // candidates, counts
}

// rows [r0, r0 + kRC) of the table, up to r_end, into one chunk buffer;
// rows past r_end are zero-filled
__device__ __forceinline__ void load_chunk(bf16* dst, const bf16* db, int r0,
                                           int r_end, int D, int ld) {
  const int vpr = D / 8;  // 16-byte vectors per row
  for (int i = threadIdx.x; i < kRC * vpr; i += kThreads) {
    const int r = i / vpr, v = i - r * vpr;
    const bool ok = r0 + r < r_end;
    cp_async16(dst + r * ld + v * 8,
               db + (size_t)(ok ? r0 + r : 0) * D + v * 8, ok);
  }
}

__global__ void __launch_bounds__(kThreads)
    knn_partial_kernel(const bf16* __restrict__ q, const bf16* __restrict__ db,
                       float* __restrict__ part_s, int* __restrict__ part_i,
                       int B, int N, int D, int k, int slice_rows,
                       int n_slices) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ld = D + kPad;
  bf16* qs = reinterpret_cast<bf16*>(smem);        // [kQT, ld]
  bf16* ts = qs + kQT * ld;                         // [2, kRC, ld]
  float* ls = reinterpret_cast<float*>(ts + 2 * kRC * ld);  // [kQT, k]
  int* li = reinterpret_cast<int*>(ls + kQT * k);   // [kQT, k]
  float* cs = reinterpret_cast<float*>(li + kQT * k);  // [kQT, kRC]
  int* ci = reinterpret_cast<int*>(cs + kQT * kRC);    // [kQT, kRC]
  int* cn = ci + kQT * kRC;                            // [kQT]

  const int q0 = blockIdx.x * kQT, slice = blockIdx.y;
  const int r_begin = slice * slice_rows;
  const int r_end = min(N, r_begin + slice_rows);
  const int n_chunks = (r_end - r_begin + kRC - 1) / kRC;
  const int vpr = D / 8;
  for (int i = threadIdx.x; i < kQT * vpr; i += kThreads) {
    const int r = i / vpr, v = i - r * vpr;
    const bool ok = q0 + r < B;
    cp_async16(qs + r * ld + v * 8, q + (size_t)(ok ? q0 + r : 0) * D + v * 8,
               ok);
  }
  load_chunk(ts, db, r_begin, r_end, D, ld);
  cp_async_commit();
  for (int i = threadIdx.x; i < kQT * k; i += kThreads) {
    ls[i] = -INFINITY;
    li[i] = kNoId;
  }
  if (threadIdx.x < kQT) cn[threadIdx.x] = 0;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  for (int c = 0; c < n_chunks; ++c) {
    if (c + 1 < n_chunks)
      load_chunk(ts + ((c + 1) & 1) * kRC * ld, db, r_begin + (c + 1) * kRC,
                 r_end, D, ld);
    cp_async_commit();  // an empty group on the last chunk keeps the count
    cp_async_wait<1>();  // chunk c (and the query tile) have landed
    __syncthreads();

    // scores of this warp's 16 rows (two n8 tiles) against the 16 queries
    const bf16* tb = ts + (c & 1) * kRC * ld + warp * kWarpRows * ld;
    float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    for (int kk = 0; kk < D; kk += 16) {
      const uint32_t a[4] = {ld32(qs + g * ld + kk + 2 * t),
                             ld32(qs + (g + 8) * ld + kk + 2 * t),
                             ld32(qs + g * ld + kk + 8 + 2 * t),
                             ld32(qs + (g + 8) * ld + kk + 8 + 2 * t)};
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const bf16* row = tb + (j * 8 + g) * ld + kk + 2 * t;
        mma16816(acc[j], a, ld32(row), ld32(row + 8));
      }
    }
    // acc[j][e] is query g + 8 * (e >> 1) against row j * 8 + 2t + (e & 1)
    const int row0 = r_begin + c * kRC + warp * kWarpRows;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = g + 8 * (e >> 1);
        const int row = row0 + j * 8 + 2 * t + (e & 1);
        const float s = acc[j][e];
        if (q0 + qi < B && row < r_end &&
            better(s, row, ls[qi * k + k - 1], li[qi * k + k - 1])) {
          const int p = atomicAdd(&cn[qi], 1);
          cs[qi * kRC + p] = s;
          ci[qi * kRC + p] = row;
        }
      }
    __syncthreads();
    if (threadIdx.x < kQT) {  // insertion into the sorted list of k
      const int qi = threadIdx.x;
      float* s_ = ls + qi * k;
      int* i_ = li + qi * k;
      const int n = cn[qi];
      for (int m = 0; m < n; ++m) {
        const float s = cs[qi * kRC + m];
        const int id = ci[qi * kRC + m];
        if (!better(s, id, s_[k - 1], i_[k - 1])) continue;
        int p = k - 1;
        while (p > 0 && better(s, id, s_[p - 1], i_[p - 1])) {
          s_[p] = s_[p - 1];
          i_[p] = i_[p - 1];
          --p;
        }
        s_[p] = s;
        i_[p] = id;
      }
      cn[qi] = 0;
    }
    __syncthreads();  // the lists are settled; chunk c's buffer is free
  }

  for (int i = threadIdx.x; i < kQT * k; i += kThreads) {
    const int qi = i / k, j = i - qi * k;
    if (q0 + qi >= B) continue;
    const size_t o = ((size_t)(q0 + qi) * n_slices + slice) * k + j;
    part_s[o] = ls[i];
    part_i[o] = li[i];
  }
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

}  // namespace knn
}  // namespace rdmk

// q [B, D], db [N, D] bf16 contiguous -> part_s [B, n_slices, k] f32 and
// part_i [B, n_slices, k] int32: each slice's k best (score, id), sorted;
// a slice with fewer than k rows pads its list with (-inf, INT_MAX).
// Slice s covers rows [s * slice_rows, min(N, (s + 1) * slice_rows)).
extern "C" int rdm_knn_partial(const void* q, const void* db, void* part_s,
                               void* part_i, int B, int N, int D, int k,
                               int slice_rows, int n_slices, void* stream) {
  using namespace rdmk::knn;
  if (B < 1 || N < 1 || D < 16 || D % 16 || k < 1 || k > kMaxK ||
      slice_rows < 1 || slice_rows % kRC || n_slices < 1 ||
      (long long)slice_rows * (n_slices - 1) >= N ||
      (long long)slice_rows * n_slices < N)
    return (int)cudaErrorInvalidValue;
  const size_t smem = partial_smem(D, k);
  cudaError_t err = cudaFuncSetAttribute(
      knn_partial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((B + kQT - 1) / kQT, n_slices);
  knn_partial_kernel<<<grid, rdmk::kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const rdmk::bf16*>(q), static_cast<const rdmk::bf16*>(db),
      static_cast<float*>(part_s), static_cast<int*>(part_i), B, N, D, k,
      slice_rows, n_slices);
  return (int)cudaGetLastError();
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
  cudaError_t err = cudaFuncSetAttribute(
      knn_merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
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
