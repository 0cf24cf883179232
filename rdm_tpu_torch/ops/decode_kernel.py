"""The RARM decode step: three hand-written CUDA kernels.

Counterpart of `rdm_tpu/ops/decode_kernel.py`. One token step of one
pre-LN RARM layer (cached causal self-attention -> cross-attention to the
neighbours -> GEGLU FF, each residual; reference transformer.py:241-268)
runs as:

  1. `decode_attn`    - LN1 + the [C, 3C] q/k/v projection of the new token,
                        then its causal attention over the cache rows
                        < pos plus its own k/v (csrc/decode_qkv.cu and
                        csrc/decode_attn.cu, two launches; replaces
                        `_attn_kernel`)
  2. `decode_post_ff` - out-proj + residual, LN2 + q projection +
                        cross-attention, out-proj + residual, LN3 + GEGLU
                        FF + residual (csrc/decode_post_ff.cu, a chain of
                        five launches; replaces `_post_ff_kernel`)
  3. `commit_rows`    - writes one step's k/v rows of every layer into
                        their caches at row pos in one launch
                        (csrc/commit_rows.cu; replaces `_commit_kernel`)

Each wrapper has its plain PyTorch version beside it, `<name>_reference`.
A wrapper runs the plain version only for tensors on the CPU; for a CUDA
tensor it launches its kernel or raises (bf16 activations and weights, f32
norms and biases, head_dim 64, contiguous tensors). Each wrapper counts its
calls that launch in `<name>.launches`.

Layouts, as in the JAX package: activations x [B, C] (one token per batch
row, head h at channels [64h, 64h + 64)); KV caches TIME-MAJOR [T, B, C];
cross-attention keys and values [S, B, C]; weights [in, out]. Cache
protocol (the JAX rule): attention reads rows < pos from the cache and the
current position from the freshly projected k/v, so committing row pos
before, after or batched across layers is the same to the attention. The
port updates the caches IN PLACE: `decode_attn(commit=True)` writes row
pos of both caches itself; `commit_rows` writes deferred rows into the
given caches.

Not carried over from the TPU kernels: the head-segment SEG/SEG^T matmuls
(a per-head dot over 64 channels is plain on a GPU), the W-chunked grid and
its clamped index maps (the attention kernel bounds its read by pos
itself), and the 512 KB in-kernel-commit threshold. Open (serving slice):
the int8_weights and int8_kv modes.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Sequence

import torch

from rdm_tpu_torch.ops import _build
from rdm_tpu_torch.ops.block_kernel import (_check, _on_cpu, _p, _stream,
                                            geglu_ff_reference,
                                            ln_qkv_reference,
                                            post_cross_reference)
from rdm_tpu_torch.ops.attention import dot_product_attention

HEAD_DIM = 64        # the only head width the decode kernels take
MAX_COMMIT = 64      # rows one commit_rows launch takes (kernel parameter)


# ------------------------------------------------------------ plain math

def decode_attn_reference(x, pos: int, k_cache, v_cache, n1s, n1b, wqkv, *,
                          heads: int, head_dim: int, commit: bool = True):
    """x [B, C], caches [T, B, C] -> (attn [B, C], k_new [B, C],
    v_new [B, C]); with commit, row pos of both caches is written in
    place."""
    b, c = x.shape
    q, kn, vn = (a.contiguous() for a in ln_qkv_reference(x, n1s, n1b,
                                                          wqkv))
    if commit:
        k_cache[pos] = kn
        v_cache[pos] = vn
    shp = (b, pos + 1, heads, head_dim)
    keys = torch.cat([k_cache[:pos], kn[None]]).transpose(0, 1)
    vals = torch.cat([v_cache[:pos], vn[None]]).transpose(0, 1)
    o = dot_product_attention(q.reshape(b, 1, heads, head_dim),
                              keys.reshape(shp), vals.reshape(shp))
    return o.reshape(b, c), kn, vn


def decode_post_ff_reference(x, attn, cross_k, cross_v, wo, bo, n2s, n2b,
                             wq2, wo2, bo2, n3s, n3b, wa, wg, ba, bg, w2, b2,
                             *, heads: int, head_dim: int):
    """x, attn [B, C]; cross_k/v [S, B, C] -> x_out [B, C]."""
    xm = post_cross_reference(x[:, None], attn[:, None],
                              cross_k.transpose(0, 1),
                              cross_v.transpose(0, 1), wo, bo, n2s, n2b,
                              wq2, wo2, bo2, heads=heads, head_dim=head_dim)
    return geglu_ff_reference(xm[:, 0], n3s, n3b, wa, wg, ba, bg, w2, b2)


def commit_rows_reference(pos: int, caches: Sequence[torch.Tensor],
                          rows: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """caches[i][pos] = rows[i], in place; returns the caches."""
    for cache, row in zip(caches, rows):
        cache[pos] = row.reshape(cache.shape[1:])
    return list(caches)


# -------------------------------------------------------------- wrappers

def _check_pos(name: str, pos: int, t: int) -> None:
    if not 0 <= pos < t:
        raise ValueError(f"{name}: pos {pos} outside a cache of {t} rows")


def _check_head_dim(name: str, head_dim: int) -> None:
    if head_dim != HEAD_DIM:
        raise ValueError(f"{name}: the CUDA kernel takes head_dim "
                         f"{HEAD_DIM}, got {head_dim}")


def decode_attn(x, pos: int, k_cache, v_cache, n1s, n1b, wqkv, *,
                heads: int, head_dim: int, commit: bool = True):
    """LN1 + q/k/v projection + cached causal attention of one token:
    x [B, C], caches [T, B, C] -> (attn, k_new, v_new), each [B, C]. On
    CUDA this is two launches (projection, then attention), counted as one
    call."""
    b, c = x.shape
    t = k_cache.shape[0]
    if (k_cache.shape != (t, b, c) or v_cache.shape != k_cache.shape
            or wqkv.shape != (c, 3 * c) or heads * head_dim != c):
        raise ValueError(f"decode_attn: x {tuple(x.shape)}, caches "
                         f"{tuple(k_cache.shape)}, {tuple(v_cache.shape)}, "
                         f"wqkv {tuple(wqkv.shape)} for {heads}x{head_dim}")
    _check_pos("decode_attn", pos, t)
    if _on_cpu(x, k_cache, v_cache, wqkv):
        return decode_attn_reference(x, pos, k_cache, v_cache, n1s, n1b,
                                     wqkv, heads=heads, head_dim=head_dim,
                                     commit=commit)
    _check_head_dim("decode_attn", head_dim)
    _check("decode_attn", [(x, (b, c)), (k_cache, (t, b, c)),
                           (v_cache, (t, b, c)), (wqkv, (c, 3 * c))],
           [(n1s, (c,)), (n1b, (c,))])
    q, kn, vn, out = (torch.empty_like(x) for _ in range(4))
    scale_log2 = head_dim ** -0.5 * 1.4426950408889634
    lib = _build.load()
    with torch.cuda.device(x.device):
        st = _stream(x)
        rc = lib.rdm_decode_qkv(
            _p(x), _p(n1s), _p(n1b), _p(wqkv), _p(q), _p(kn), _p(vn),
            _p(k_cache) if commit else None,
            _p(v_cache) if commit else None, pos, b, c, st)
        _build.check(rc, "decode_qkv")
        rc = lib.rdm_decode_attn(_p(q), _p(kn), _p(vn), _p(k_cache),
                                 _p(v_cache), _p(out), pos, b, c, heads,
                                 scale_log2, st)
    _build.check(rc, "decode_attn")
    decode_attn.launches += 1
    return out, kn, vn


decode_attn.launches = 0


def decode_post_ff(x, attn, cross_k, cross_v, wo, bo, n2s, n2b, wq2, wo2,
                   bo2, n3s, n3b, wa, wg, ba, bg, w2, b2, *, heads: int,
                   head_dim: int):
    """Everything after the self-attention core: x, attn [B, C],
    cross_k/v [S, B, C] -> x_out [B, C]. On CUDA a chain of five launches,
    counted as one call."""
    b, c = x.shape
    s = cross_k.shape[0]
    f = wa.shape[1]
    if (attn.shape != x.shape or cross_k.shape != (s, b, c)
            or cross_v.shape != cross_k.shape or heads * head_dim != c
            or wa.shape != (c, f) or wg.shape != (c, f)
            or w2.shape != (f, c)):
        raise ValueError(f"decode_post_ff: x {tuple(x.shape)}, attn "
                         f"{tuple(attn.shape)}, cross_k "
                         f"{tuple(cross_k.shape)}, cross_v "
                         f"{tuple(cross_v.shape)}, wa {tuple(wa.shape)}, "
                         f"wg {tuple(wg.shape)}, w2 {tuple(w2.shape)} for "
                         f"{heads}x{head_dim}")
    args = (x, attn, cross_k, cross_v, wo, bo, n2s, n2b, wq2, wo2, bo2, n3s,
            n3b, wa, wg, ba, bg, w2, b2)
    if _on_cpu(x, attn, cross_k, cross_v, wo, wa):
        return decode_post_ff_reference(*args, heads=heads,
                                        head_dim=head_dim)
    _check_head_dim("decode_post_ff", head_dim)
    _check("decode_post_ff",
           [(x, (b, c)), (attn, (b, c)), (cross_k, (s, b, c)),
            (cross_v, (s, b, c)), (wo, (c, c)), (wq2, (c, c)),
            (wo2, (c, c)), (wa, (c, f)), (wg, (c, f)), (w2, (f, c))],
           [(bo, (c,)), (n2s, (c,)), (n2b, (c,)), (bo2, (c,)), (n3s, (c,)),
            (n3b, (c,)), (ba, (f,)), (bg, (f,)), (b2, (c,))])
    if f % 64:
        raise ValueError(f"decode_post_ff: F={f} is not a multiple of 64")
    x1, o2, xmid, out = (torch.empty_like(x) for _ in range(4))
    hidden = torch.empty((b, f), dtype=x.dtype, device=x.device)
    lib = _build.load()
    with torch.cuda.device(x.device):
        rc = lib.rdm_decode_post_ff(
            *(_p(a) for a in args), _p(x1), _p(o2), _p(xmid), _p(hidden),
            _p(out), b, c, s, f, head_dim ** -0.5, _stream(x))
    _build.check(rc, "decode_post_ff")
    decode_post_ff.launches += 1
    return out


decode_post_ff.launches = 0


def commit_rows(pos: int, caches: Sequence[torch.Tensor],
                rows: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Write rows[i] ([B, C] or [1, B, C]) into caches[i] ([T, B, C]) at row
    pos, for every i, in place and in one launch; returns the caches."""
    n = len(caches)
    if n != len(rows) or n == 0:
        raise ValueError(f"commit_rows: {n} caches, {len(rows)} rows")
    t, b, c = caches[0].shape
    _check_pos("commit_rows", pos, t)
    if any(tuple(r.shape[-2:]) != (b, c) or r.numel() != b * c
           for r in rows) or any(k.shape != (t, b, c) for k in caches):
        raise ValueError(f"commit_rows: caches "
                         f"{[tuple(k.shape) for k in caches]}, rows "
                         f"{[tuple(r.shape) for r in rows]}")
    if _on_cpu(*caches, *rows):
        return commit_rows_reference(pos, caches, rows)
    _check("commit_rows", [(k, (t, b, c)) for k in caches]
           + [(r, tuple(r.shape)) for r in rows])
    if n > MAX_COMMIT:
        raise ValueError(f"commit_rows: {n} caches, at most {MAX_COMMIT} "
                         "per launch")
    ptrs = ctypes.c_void_p * n
    lib = _build.load()
    with torch.cuda.device(caches[0].device):
        rc = lib.rdm_commit_rows(ptrs(*(_p(r) for r in rows)),
                                 ptrs(*(_p(k) for k in caches)), n, pos,
                                 b * c, _stream(caches[0]))
    _build.check(rc, "commit_rows")
    commit_rows.launches += 1
    return list(caches)


commit_rows.launches = 0

KERNELS = (decode_attn, decode_post_ff, commit_rows)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0


def launch_counts() -> Dict[str, int]:
    return {fn.__name__: fn.launches for fn in KERNELS}


# ------------------------------------------------------------ the layer

def decode_layer(x: torch.Tensor, pos: int, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, cross_k: torch.Tensor,
                 cross_v: torch.Tensor, w: Dict[str, torch.Tensor], *,
                 heads: int, head_dim: int, defer_commit: bool = False):
    """One RARM layer for one token through the decode kernels.

    x [B, C]; caches [T, B, C]; cross_k/v [S, B, C]; w one layer's dict
    from `models.rarm.extract_decode_weights` (the `pack_block_weights`
    layout of ops/block_kernel.py). Returns (x_out, k_cache,
    v_cache) with row pos of both caches written in place, or, with
    defer_commit, (x_out, k_row, v_row) with the rows [1, B, C] left for
    one `commit_rows` call over all layers (the caches are then
    untouched)."""
    attn, kn, vn = decode_attn(x, pos, k_cache, v_cache, w["n1s"], w["n1b"],
                               w["wqkv"], heads=heads, head_dim=head_dim,
                               commit=not defer_commit)
    xo = decode_post_ff(x, attn, cross_k, cross_v, w["wo"], w["bo"],
                        w["n2s"], w["n2b"], w["wq2"], w["wo2"], w["bo2"],
                        w["n3s"], w["n3b"], w["wa"], w["wg"], w["ba"],
                        w["bg"], w["w2"], w["b2"], heads=heads,
                        head_dim=head_dim)
    if defer_commit:
        return xo, kn[None], vn[None]
    return xo, k_cache, v_cache
