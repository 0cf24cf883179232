"""Multi-head attention over BSHD tensors: plain path and dispatch.

Counterpart of `rdm_tpu/ops/attention.py`. `dot_product_attention` takes
`impl` "auto" | "xla" | "pallas" (the JAX names): "xla" is the plain
attention below, "pallas" the flash kernels (`ops/flash_attention.py`,
differentiable), and "auto" asks `_pick_impl`.

Plain-path semantics (`_xla_attention`): scores in f32, `-1e9` masking
(finite, so a fully masked row stays NaN-free), softmax in f32,
probabilities cast back to the input dtype for the PV product. The VQ
autoencoder's single-head attention (d = 512) and the short-sequence
sites stay on it.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from rdm_tpu_torch.ops.flash_attention import flash_attention

_NEG_INF = -1e9


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, scale: Optional[float] = None,
                          causal: bool = False,
                          mask: Optional[torch.Tensor] = None,
                          impl: str = "auto") -> torch.Tensor:
    """q [B, Sq, H, D], k/v [B, Sk, H, D] -> [B, Sq, H, D] in q.dtype.

    causal: lower-triangular mask aligned to the END of the key sequence
    (query i sees keys j <= i + Sk - Sq). mask: optional bool [B, Sk],
    True = attend."""
    if impl == "auto":
        impl = _pick_impl(q, k, causal, mask, q.device)
    if impl == "pallas":
        return flash_attention(q, k, v, scale=scale, causal=causal,
                               mask=mask)
    return _xla_attention(q, k, v, scale=scale, causal=causal, mask=mask)


def _pick_impl(q, k, causal, mask, device) -> str:
    """The JAX package's gate with CUDA in place of the TPU: the flash
    kernels on a CUDA `device` when Sq, Sk >= 256, both multiples of 128,
    and d % 32 == 0 with d <= 128; the plain path otherwise, with a mask,
    or with RDM_TPU_FLASH=0 (read at each call, where the JAX package
    reads it once at import). The kernels take bf16 only: other dtypes
    (the f32 reference runs) gate out to the plain path here, while the
    kernels' wrappers raise on them. `device` is an argument so that the
    gate's decisions can be checked without a card."""
    if os.environ.get("RDM_TPU_FLASH", "1") == "0" or mask is not None:
        return "xla"
    if torch.device(device).type != "cuda" or q.dtype != torch.bfloat16:
        return "xla"
    sq, sk, d = q.shape[1], k.shape[1], q.shape[3]
    if (sq >= 256 and sk >= 256 and sq % 128 == 0 and sk % 128 == 0
            and d % 32 == 0 and d <= 128):
        return "pallas"
    return "xla"


def _xla_attention(q, k, v, *, scale, causal, mask):
    d = q.shape[-1]
    sq, sk = q.shape[1], k.shape[1]
    if scale is None:
        scale = d ** -0.5
    scores = torch.matmul(q.transpose(1, 2).float(),
                          k.transpose(1, 2).float().transpose(-1, -2))
    scores = scores * scale                                  # [B, H, Sq, Sk]
    if mask is not None:
        scores = scores.masked_fill(~mask[:, None, None, :], _NEG_INF)
    if causal:
        qi = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
        kj = torch.arange(sk, device=q.device)[None, :]
        scores = scores.masked_fill(kj > qi, _NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.matmul(probs, v.transpose(1, 2).to(q.dtype))
    return out.transpose(1, 2).to(q.dtype)
