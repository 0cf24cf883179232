// Non-causal multi-head self-attention core of a SpatialTransformer block.
//
// Replaces rdm_tpu/ops/block_kernel.py:_packed_attn_kernel. For q, k, v
// [B, S, C] bf16 with head h at channels [d h, d h + d), d = head_dim 32
// or 64:
//   o[b, :, h] = softmax(q_h k_h^T * d^-1/2) v_h        (f32 scores)
// written into o [B, S, C] bf16 in the same layout. [B, S, C] with d-wide
// heads is exactly BSHD [B, S, C / d, d], so this is a launcher over the
// Hopper attention core (attn_fwd_sm90.cuh) that csrc/flash_attn_fwd.cu
// shares, with Sq = Sk = S, H = heads, D = d, non-causal, on the same
// memory: the two give bit-equal outputs. The TPU kernel's lane masks
// (several heads packed into one 128-lane group) and its multi-image grid
// are TPU artifacts and are not carried over. The core's note says what
// bounds it and what its design does about it.
#include "attn_fwd_sm90.cuh"

extern "C" int rdm_packed_attn(const void* q, const void* k, const void* v,
                               void* o, int B, int S, int heads,
                               int head_dim, float scale_log2, void* stream) {
  using namespace rdmk::attn;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (head_dim) {
    case 32: return launch_attn_fwd<32, false>(q, k, v, o, B, S, S, heads,
                                               scale_log2, s);
    case 64: return launch_attn_fwd<64, false>(q, k, v, o, B, S, S, heads,
                                               scale_log2, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
