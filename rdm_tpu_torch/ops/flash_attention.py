"""Flash attention over BSHD tensors: hand-written CUDA kernels.

Counterpart of `rdm_tpu/ops/flash_attention.py`:

  `flash_fwd` - softmax(q k^T * scale) v (csrc/flash_attn_fwd.cu;
                replaces `_attn_kernel`), a launcher over the attention
                core that `block_kernel.packed_attn` also launches
                (csrc/attn_fwd_sm90.cuh: TMA, wgmma, scores in registers)
  `flash_bwd` - its dq, dk, dv (csrc/flash_attn_bwd.cu; replaces
                `_attn_bwd_kernel`): three TMA + wgmma launches with no
                atomics, the first of them the forward core's walk

`flash_attention` is differentiable: an autograd.Function whose forward
is `flash_fwd` and which saves (q, k, v), as the JAX custom_vjp does. Its
backward is `flash_bwd` or, as `_use_kernel_bwd` decides, the eager
recompute: torch.autograd.grad through `_xla_reference`.

Each wrapper has its plain PyTorch version beside it
(`flash_attention_forward_reference`, `flash_attention_backward_reference`,
which follow the TPU kernels' arithmetic), runs it only for tensors on the
CPU, and for CUDA tensors launches its kernel or raises: bf16 q/k/v of
head_dim 32, 64, 96 or 128, contiguous. Each counts its launches in
`<name>.launches`.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import torch

from rdm_tpu_torch.ops import _build

_NEG_INF = -1e9
_LOG2E = 1.4426950408889634
HEAD_DIMS = (32, 64, 96, 128)  # the head widths the kernels are built for


def _causal_keep(sq: int, sk: int, device) -> torch.Tensor:
    """[Sq, Sk] True where query i sees key j (j <= i + Sk - Sq)."""
    qi = torch.arange(sq, device=device)[:, None] + (sk - sq)
    return torch.arange(sk, device=device)[None, :] <= qi


def _scores(q, k, scale: float, causal: bool) -> torch.Tensor:
    """[B, H, Sq, Sk] f32 q k^T * scale, masked with -1e9."""
    s = torch.matmul(q.transpose(1, 2).float(),
                     k.transpose(1, 2).float().transpose(-1, -2)) * scale
    if causal:
        s = s.masked_fill(~_causal_keep(q.shape[1], k.shape[1], q.device),
                          _NEG_INF)
    return s


def _xla_reference(q, k, v, scale: float, causal: bool) -> torch.Tensor:
    """Unfused attention with the kernels' semantics (the JAX module's
    `_xla_reference`): f32 scores and softmax, probabilities in q's type
    for the PV product. The eager backward differentiates it."""
    probs = torch.softmax(_scores(q, k, scale, causal), dim=-1).to(q.dtype)
    return torch.matmul(probs, v.transpose(1, 2).to(q.dtype)).transpose(1, 2)


def flash_attention_forward_reference(q, k, v, scale: float,
                                      causal: bool) -> torch.Tensor:
    """Plain version of `flash_fwd`, as `_attn_kernel` computes it: scores
    times scale * log2(e), the -1e9 mask, exp2 against the row max, p cast
    to v's type for the PV product (f32 sums), 1/denominator after PV."""
    s = torch.matmul(q.transpose(1, 2).float(),
                     k.transpose(1, 2).float().transpose(-1, -2)) \
        * (scale * _LOG2E)
    if causal:
        s = s.masked_fill(~_causal_keep(q.shape[1], k.shape[1], q.device),
                          _NEG_INF)
    p = torch.exp2(s - s.amax(dim=-1, keepdim=True))
    denom = p.sum(dim=-1, keepdim=True)
    out = torch.matmul(p.to(v.dtype).float(), v.transpose(1, 2).float())
    return (out * (1.0 / denom)).transpose(1, 2).to(q.dtype)


def flash_attention_backward_reference(q, k, v, do, scale: float,
                                       causal: bool
                                       ) -> Tuple[torch.Tensor, ...]:
    """Plain version of `flash_bwd`, as `_attn_bwd_kernel` computes it: P
    recomputed in f32 (exp against the row max, times 1/sum), dV = P^T dO
    and dP = dO V^T in f32, dS = P (dP - rowsum(dP P)), dQ = bf16(dS) K *
    scale, dK = bf16(dS)^T Q * scale (rounded to q's / k's type as the
    kernel rounds), dK / dV summed in f32 and returned in k's / v's type."""
    s = _scores(q, k, scale, causal)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p * (1.0 / p.sum(dim=-1, keepdim=True))
    qh, kh, vh, doh = (t.transpose(1, 2) for t in (q, k, v, do))
    do32 = doh.float()
    dv = torch.matmul(p.transpose(-1, -2), do32)
    dp = torch.matmul(do32, vh.float().transpose(-1, -2))
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    dq = torch.matmul(ds.to(k.dtype).float(), kh.float()) * scale
    dk = torch.matmul(ds.to(q.dtype).float().transpose(-1, -2),
                      qh.float()) * scale
    back = lambda t, dt: t.transpose(1, 2).to(dt)  # noqa: E731
    return back(dq, q.dtype), back(dk, k.dtype), back(dv, v.dtype)


# -------------------------------------------------------------- wrappers

def _on_cpu(*ts: torch.Tensor) -> bool:
    dev = {t.device.type for t in ts}
    if dev == {"cpu"}:
        return True
    if dev != {"cuda"}:
        raise ValueError(f"flash kernels take CPU or CUDA tensors, got {dev}")
    return False


def _check(name: str, q, kv, q_like=()) -> None:
    """Raise unless the CUDA kernel takes these: bf16 BSHD q [B, Sq, H, D],
    `kv` tensors [B, Sk, H, D] (Sk from the first), `q_like` ones q's
    shape, D in HEAD_DIMS, on one device, contiguous and 16-byte aligned,
    none requiring grad in grad mode (the kernel's output has no autograd
    graph)."""
    _build.refuse_grad(name, q, *kv, *q_like)
    b, _, h, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"{name}: the CUDA kernel takes head_dim in "
                         f"{HEAD_DIMS}, got {d}")
    kv_shape = (b, kv[0].shape[1], h, d)
    for t, shape in [(q, q.shape)] + [(t, kv_shape) for t in kv] + \
            [(t, q.shape) for t in q_like]:
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name}: the CUDA kernel takes bf16 tensors, "
                            f"got {t.dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                             f"{tuple(t.shape)}")
        if t.device != q.device:
            raise ValueError(f"{name}: tensors on {t.device} and {q.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: tensors must be contiguous and "
                             "16-byte aligned")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def flash_fwd(q, k, v, *, scale: float, causal: bool) -> torch.Tensor:
    """Forward kernel: q [B, Sq, H, D], k/v [B, Sk, H, D] -> [B, Sq, H, D]
    in q's type."""
    if _on_cpu(q, k, v):
        return flash_attention_forward_reference(q, k, v, scale, causal)
    _check("flash_fwd", q, (k, v))
    b, sq, h, d = q.shape
    o = torch.empty_like(q)
    lib = _build.load()
    with torch.cuda.device(q.device):
        rc = lib.rdm_flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                               o.data_ptr(), b, sq, k.shape[1], h, d,
                               int(causal), scale * _LOG2E, _stream(q))
    _build.check(rc, "flash_fwd")
    flash_fwd.launches += 1
    return o


flash_fwd.launches = 0


def flash_bwd(q, k, v, do, *, scale: float, causal: bool
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Backward kernel (three launches, csrc/flash_attn_bwd.cu: the rows'
    softmax statistics, dK / dV per key tile, dQ per query tile): dO [B,
    Sq, H, D] -> (dq, dk, dv) in q's, k's and v's type."""
    if _on_cpu(q, k, v, do):
        return flash_attention_backward_reference(q, k, v, do, scale, causal)
    _check("flash_bwd", q, (k, v), (do,))
    b, sq, h, d = q.shape
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    # per-row max, 1/sum and delta, Sq padded to the kernels' 64-row tiles,
    # written by the first launch for the other two
    stats = torch.empty(b * h * 3 * (-(-sq // 64) * 64), dtype=torch.float32,
                        device=q.device)
    lib = _build.load()
    with torch.cuda.device(q.device):
        rc = lib.rdm_flash_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), stats.data_ptr(),
            b, sq, k.shape[1], h, d, int(causal), scale * _LOG2E, scale,
            _stream(q))
    _build.check(rc, "flash_bwd")
    flash_bwd.launches += 1
    return dq, dk, dv


flash_bwd.launches = 0

KERNELS = (flash_fwd, flash_bwd)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0


def launch_counts() -> Dict[str, int]:
    return {fn.__name__: fn.launches for fn in KERNELS}


# ------------------------------------------------------------- autograd

def _use_kernel_bwd(head_dim: int, device) -> bool:
    """The backward kernel, or the eager recompute? RDM_TPU_FLASH_BWD
    "pallas" takes the kernel, "xla" the recompute, as in the JAX package;
    by default the kernel on CUDA at head_dim <= 32 (JAX's gate, where the
    kernel won on the TPU: the RDM's d = 32; the RARM's d = 64 took the
    recompute)."""
    mode = os.environ.get("RDM_TPU_FLASH_BWD", "")
    if mode in ("pallas", "xla"):
        return mode == "pallas"
    return torch.device(device).type == "cuda" and head_dim <= 32


class _Flash(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, scale: float, causal: bool):
        ctx.save_for_backward(q, k, v)
        ctx.scale, ctx.causal = scale, causal
        return flash_fwd(q, k, v, scale=scale, causal=causal)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        if _use_kernel_bwd(q.shape[-1], q.device):
            dq, dk, dv = flash_bwd(q, k, v, g.contiguous(), scale=ctx.scale,
                                   causal=ctx.causal)
        else:
            with torch.enable_grad():
                qkv = [t.detach().requires_grad_() for t in (q, k, v)]
                out = _xla_reference(*qkv, ctx.scale, ctx.causal)
                dq, dk, dv = torch.autograd.grad(out, qkv, g)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: Optional[float] = None, causal: bool = False,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fused attention over BSHD tensors, differentiable. Key-padding masks
    are not fused (callers with masks take the plain path,
    ops.attention)."""
    if mask is not None:
        raise NotImplementedError("flash kernel does not take padding masks")
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return _Flash.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                        float(scale), bool(causal))
