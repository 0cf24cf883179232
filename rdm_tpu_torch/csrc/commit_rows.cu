// Batched KV-row commit of one RARM decode step.
//
// Replaces rdm_tpu/ops/decode_kernel.py:_commit_kernel (commit_rows): for
// i < n, cache_i[pos] = row_i, where every cache is a time-major [T, B, C]
// bf16 tensor and every row [B, C]; all other rows stay as they are. The TPU
// kernel issued n overlapped row DMAs into aliased HBM outputs; here one
// launch copies all n rows, blockIdx.y picking the pair.
//
// The pointer table travels in the kernel's parameter space (up to
// kMaxRows pairs, 1 KB of the 4 KB limit), so the launch needs no
// host-to-device copy of it. What bounds it on the H100: 2 * n * B * C
// bytes moved (2.7 MB for n = 36, B = 32, C = 768: ~0.8 us at 3.35 TB/s)
// plus one launch; 16-byte vector copies, coalesced.
#include <cuda_runtime.h>
#include <stdint.h>

namespace rdmk {

constexpr int kMaxRows = 64;
constexpr int kCopyThreads = 256;

struct CommitTable {
  const uint4* rows[kMaxRows];
  uint4* caches[kMaxRows];
};

__global__ void __launch_bounds__(kCopyThreads)
    commit_rows_kernel(const CommitTable table, size_t row_offset_vec,
                       int row_vecs) {
  const uint4* src = table.rows[blockIdx.y];
  uint4* dst = table.caches[blockIdx.y] + row_offset_vec;
  for (int v = blockIdx.x * kCopyThreads + threadIdx.x; v < row_vecs;
       v += gridDim.x * kCopyThreads)
    dst[v] = src[v];
}

}  // namespace rdmk

// rows, caches: host arrays of n device pointers; row_elems = B * C (a
// multiple of 8, so each row is whole 16-byte vectors).
extern "C" int rdm_commit_rows(const void* const* rows, void* const* caches,
                               int n, int pos, int row_elems, void* stream) {
  using namespace rdmk;
  if (n < 1 || n > kMaxRows || pos < 0 || row_elems % 8)
    return (int)cudaErrorInvalidValue;
  CommitTable table;
  for (int i = 0; i < n; ++i) {
    table.rows[i] = static_cast<const uint4*>(rows[i]);
    table.caches[i] = static_cast<uint4*>(caches[i]);
  }
  const int row_vecs = row_elems / 8;
  const int bx = (row_vecs + kCopyThreads - 1) / kCopyThreads;
  dim3 grid(bx, n);
  commit_rows_kernel<<<grid, kCopyThreads, 0, (cudaStream_t)stream>>>(
      table, (size_t)pos * row_vecs, row_vecs);
  return (int)cudaGetLastError();
}
