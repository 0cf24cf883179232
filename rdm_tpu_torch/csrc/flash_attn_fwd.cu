// Flash-attention forward: o = softmax(q k^T * scale) v over BSHD bf16.
//
// Replaces rdm_tpu/ops/flash_attention.py:_attn_kernel (pallas_call at
// :100). A launcher over the Hopper attention core (attn_fwd_sm90.cuh: TMA,
// wgmma, scores and output in registers), which csrc/packed_attn.cu shares;
// the core's note says what bounds it and what its design does about it.
// q [B, Sq, H, D], k / v [B, Sk, H, D], o like q, D in {32, 64, 96, 128},
// causal or not; scale_log2 = scale * log2(e).
#include "attn_fwd_sm90.cuh"

namespace {

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Sq, int Sk, int H, int causal, float scale_log2,
           cudaStream_t s) {
  using namespace rdmk::attn;
  return causal ? launch_attn_fwd<D, true>(q, k, v, o, B, Sq, Sk, H,
                                           scale_log2, s)
                : launch_attn_fwd<D, false>(q, k, v, o, B, Sq, Sk, H,
                                            scale_log2, s);
}

}  // namespace

extern "C" int rdm_flash_fwd(const void* q, const void* k, const void* v,
                             void* o, int B, int Sq, int Sk, int H, int D,
                             int causal, float scale_log2, void* stream) {
  auto s = (cudaStream_t)stream;
  switch (D) {
    case 32: return launch<32>(q, k, v, o, B, Sq, Sk, H, causal, scale_log2,
                               s);
    case 64: return launch<64>(q, k, v, o, B, Sq, Sk, H, causal, scale_log2,
                               s);
    case 96: return launch<96>(q, k, v, o, B, Sq, Sk, H, causal, scale_log2,
                               s);
    case 128: return launch<128>(q, k, v, o, B, Sq, Sk, H, causal,
                                 scale_log2, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
