// Batched KV-row commit of one RARM decode step.
//
// Replaces rdm_tpu/ops/decode_kernel.py:352 `_commit_kernel` (commit_rows
// :372): for i < n, cache_i[pos] = row_i, where every cache is a
// time-major [T, B, C] bf16 tensor and every row [B, C]; all other rows
// stay as they are. The TPU kernel issued n overlapped row DMAs into
// aliased HBM outputs; here one launch of TMA bulk copies:
// - a CTA a (pair, piece of the row): n pairs x enough pieces to put a CTA
//   on every SM (36 x 4 at B = 16, C = 768 on 132 SMs), a piece at most
//   kMaxPiece bytes. One thread copies its piece global -> shared
//   (cp.async.bulk, completing on an mbarrier) and shared -> global (a bulk
//   group, waited for before the CTA exits): the copy spends no registers
//   or instructions per byte.
// - programmatic dependent launch: the launch may start while the one
//   before it in the stream runs (the last layer's decode_post_ff launch,
//   which lets its dependents start at once), and griddepcontrol.wait,
//   before the first read of a row, waits for that whole grid to finish
//   and its writes to be visible. That is enough: the rows were written by
//   launches earlier in the stream (each layer's decode_attn projection),
//   which finished before that grid did, since every launch of the decode
//   chain waits for the one before it before it finishes; and the caches'
//   rows pos are read by no launch before this one. A commit lets the
//   launch after it start at once as well; a later commit waits on it the
//   same way.
// - the pointer table travels in the kernel's parameters (up to kMaxRows
//   pairs, 1 KB of the 4 KB limit), so the launch needs no host-to-device
//   copy; the wrapper builds it once a request (decode_kernel.RowCommit).
// What bounds it on the H100: 2 n B C * 2 bytes, every row read once and
// written once (1.77 MB at n = 36, B = 16, C = 768: 0.53 us at
// 3.35 TB/s), and one launch.
#include "attn_fwd_sm90.cuh"

namespace rdmk {

constexpr int kMaxRows = 64;
constexpr int kMaxPiece = 32768;  // bytes of a CTA's piece, its shared memory

struct CommitTable {
  const unsigned char* rows[kMaxRows];
  unsigned char* caches[kMaxRows];
};

__global__ void __launch_bounds__(32)
    commit_rows_kernel(const CommitTable table, size_t row_offset,
                       int row_bytes, int piece) {
  using namespace attn;
  extern __shared__ __align__(128) unsigned char buf[];
  __shared__ __align__(8) uint64_t bar;
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int off = blockIdx.x * piece;
  const int bytes = min(piece, row_bytes - off);
  if (threadIdx.x != 0 || bytes <= 0) return;
  const uint32_t b = smem_u32(&bar), s = smem_u32(buf);
  mbar_init(b, 1);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  // the rows are the launches before's output
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  mbar_expect_tx(b, bytes);
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(s),
      "l"(table.rows[blockIdx.y] + off), "r"(bytes), "r"(b)
      : "memory");
  mbar_wait(b, 0);
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
          table.caches[blockIdx.y] + row_offset + off),
      "r"(s), "r"(bytes)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

}  // namespace rdmk

// table: a host array of 2n device pointers, the n rows then the n
// caches; row_elems = B * C (a multiple of 8, so a row is whole 16-byte
// vectors); sms, the card's SMs; dev, the caches' device, made current
// here if it is not. Returns a cudaError_t.
extern "C" int rdm_commit_rows(const void* const* table, int n, int pos,
                               int row_elems, int sms, int dev,
                               void* stream) {
  using namespace rdmk;
  if (n < 1 || n > kMaxRows || pos < 0 || row_elems < 8 || row_elems % 8 ||
      sms < 1)
    return (int)cudaErrorInvalidValue;
  int cur = 0;
  cudaError_t e = cudaGetDevice(&cur);
  if (e == cudaSuccess && cur != dev) e = cudaSetDevice(dev);
  if (e != cudaSuccess) return (int)e;
  CommitTable t;
  for (int i = 0; i < n; ++i) {
    t.rows[i] = static_cast<const unsigned char*>(table[i]);
    t.caches[i] = static_cast<unsigned char*>(const_cast<void*>(table[n + i]));
  }
  const int row_bytes = 2 * row_elems;
  // pieces of a row: a CTA for every SM, at most kMaxPiece bytes each, a
  // multiple of 16 bytes (the bulk copies' unit)
  const int fill = (sms + n - 1) / n;
  const int fit = (row_bytes + kMaxPiece - 1) / kMaxPiece;
  const int want = fill > fit ? fill : fit;
  const int piece = ((row_bytes + want - 1) / want + 15) / 16 * 16;
  const dim3 grid((row_bytes + piece - 1) / piece, n);
  return attn::launch_ex(commit_rows_kernel, grid, 32, piece,
                         (cudaStream_t)stream, 1, true, t,
                         (size_t)pos * row_bytes, row_bytes, piece);
}
