"""The RARM decode step: three hand-written CUDA kernels.

Counterpart of `rdm_tpu/ops/decode_kernel.py`. One token step of one
pre-LN RARM layer (cached causal self-attention -> cross-attention to the
neighbours -> GEGLU FF, each residual; reference transformer.py:241-268)
runs as:

  1. `decode_attn`    - LN1 + the [C, 3C] q/k/v projection of the new token,
                        then its causal attention over the cache rows
                        < pos plus its own k/v (csrc/decode_attn.cu, two
                        launches: a kQkv launch of the block-GEMM core,
                        K split over a cluster, then a split-KV attention
                        whose clusters merge their softmax states in rank
                        order; replaces `_attn_kernel`)
  2. `decode_post_ff` - out-proj + residual, LN2 + q projection +
                        cross-attention, out-proj + residual, LN3 + GEGLU
                        FF + residual (csrc/decode_post_ff.cu: five
                        launches of the block-GEMM core,
                        csrc/block_gemm_sm90.cuh, each splitting K over a
                        cluster where one 64-row block leaves the card
                        idle; replaces `_post_ff_kernel`)
  3. `commit_rows`    - writes one step's k/v rows of every layer into
                        their caches at row pos in one launch of TMA bulk
                        copies under programmatic dependent launch
                        (csrc/commit_rows.cu; replaces `_commit_kernel`);
                        `RowCommit` checks a request's caches and rows and
                        builds the pointer table once

Each wrapper has its plain PyTorch version beside it, `<name>_reference`.
A wrapper runs the plain version only for tensors on the CPU; for a CUDA
tensor it launches its kernel or raises (bf16 activations and weights, f32
norms and biases, head_dim 64, contiguous tensors; int8 weights and caches
in the serving options below).

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
its clamped index maps (the attention launch splits the rows below pos
over a cluster, `attn_plan`), and the 512 KB in-kernel-commit threshold.
The decode launches start under the launch before them (programmatic
dependent launch), which gives the bits of plain stream launches.

The serving options of the TPU kernels, as compiled variants of the same
kernels:

- int8_weights (`decode_layer` takes it from the weight dict: `wqkv_s`
  present, as `rarm.extract_decode_weights(int8_weights=True)` packs it):
  the seven projections are int8 codes [in, out] with a bf16 scale per
  output column, `<name>_s`; the f32 product is multiplied by the scale,
  then the bias is added (the TPU `_wdot`). The weight stream halves.
- int8_kv (`ks_cache` / `vs_cache` given): the caches hold int8 codes with
  one f32 scale per (row, batch row), [T, B, 1]. The new row is quantized
  from the f32 projection, scale = max(max|k| over all C, 1e-12) / 127;
  past rows are read as codes times their scales, the current position
  attends through the exact k_new / v_new. The cache read halves. Rows are
  committed in place by the attention launch, once per batch row; a
  deferred commit is refused (the TPU `decode_layer` asserts the same).

Each wrapper counts its launches in `launch_counts()`, under the name of
the variant it launched: `decode_attn`, `decode_attn_w8` (int8 weights),
`decode_attn_kv8` (int8 cache), `decode_attn_w8_kv8` (both),
`decode_post_ff`, `decode_post_ff_w8` and `commit_rows`.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, NamedTuple, Optional, Sequence

import torch
import torch.nn.functional as F

from rdm_tpu_torch.ops import _build
from rdm_tpu_torch.ops.block_kernel import (_LOG2E, _check,
                                            _on_cpu, _p, _stream,
                                            geglu_ff_reference, gemm_plan,
                                            layer_norm, ln_qkv_reference,
                                            post_cross_reference, sm_count)
from rdm_tpu_torch.ops.attention import dot_product_attention

HEAD_DIM = 64        # the only head width the decode kernels take
MAX_COMMIT = 64      # rows one commit_rows launch takes (kernel parameter)
# the int8_weights mode's projections, and those of decode_post_ff in the
# order of its `scales`
INT8_WEIGHTS = ("wqkv", "wo", "wq2", "wo2", "wa", "wg", "w2")
POST_FF_WEIGHTS = INT8_WEIGHTS[1:]
KERNEL_NAMES = ("decode_attn", "decode_attn_w8", "decode_attn_kv8",
                "decode_attn_w8_kv8", "decode_post_ff", "decode_post_ff_w8",
                "commit_rows")
_launches = dict.fromkeys(KERNEL_NAMES, 0)
# decode_attn's attention launch (csrc/decode_attn.cu, which refuses a
# plan outside them): cache rows of a TMA box, CTAs of a cluster splitting
# the rows below pos, and a split's rows at most
ATTN_ROWS = 16
ATTN_MAX_SPLITS = 8
ATTN_MAX_ROWS = 256


# ------------------------------------------------------------ plain math

def quantize_weight(w: torch.Tensor):
    """[in, out] weights -> (int8 codes [in, out], bf16 scales [out]): the
    rule of `rdm_tpu.models.rarm.extract_decode_weights(int8_weights=True)`,
    s = max(max|w| over the column / 127, 1e-12) in f32, codes round(w / s)
    clipped to +-127, the scale then kept in bf16."""
    wf = w.float()
    s = (wf.abs().amax(dim=0) / 127.0).clamp_min(1e-12)
    codes = torch.clamp(torch.round(wf / s), -127.0, 127.0).to(torch.int8)
    return codes, s.to(torch.bfloat16)


def quantize_rows(t: torch.Tensor):
    """f32 rows [B, C] -> (int8 codes [B, C], f32 scales [B, 1]): the int8
    KV-cache commit, scale max(max|row|, 1e-12) / 127, codes round(row /
    scale) clipped to +-127."""
    s = t.abs().amax(dim=-1, keepdim=True).clamp_min(1e-12) / 127.0
    return torch.clamp(torch.round(t / s), -127.0, 127.0).to(torch.int8), s


def _wdot(a: torch.Tensor, w: torch.Tensor, s=None) -> torch.Tensor:
    """a @ w with f32 accumulation; with int8 codes w, times their column
    scales s (the TPU `_wdot`). f32 result."""
    out = a.float() @ w.float()
    return out if s is None else out * s.float()


def decode_attn_reference(x, pos: int, k_cache, v_cache, n1s, n1b, wqkv, *,
                          heads: int, head_dim: int, commit: bool = True,
                          wqkv_s=None, ks_cache=None, vs_cache=None):
    """x [B, C], caches [T, B, C] -> (attn [B, C], k_new [B, C],
    v_new [B, C]); with commit, row pos of both caches is written in
    place. wqkv_s: int8 wqkv with these column scales. ks_cache / vs_cache
    ([T, B, 1] f32): int8 caches, row pos and its scales committed."""
    b, c = x.shape
    int8_kv = ks_cache is not None
    if wqkv_s is None and not int8_kv:
        q, kn, vn = (a.contiguous() for a in ln_qkv_reference(x, n1s, n1b,
                                                              wqkv))
    else:
        qkv = _wdot(layer_norm(x, n1s, n1b), wqkv, wqkv_s)
        knf, vnf = qkv[:, c:2 * c], qkv[:, 2 * c:]
        q, kn, vn = (a.to(x.dtype).contiguous()
                     for a in (qkv[:, :c], knf, vnf))
    if not int8_kv:
        if commit:
            k_cache[pos] = kn
            v_cache[pos] = vn
        shp = (b, pos + 1, heads, head_dim)
        keys = torch.cat([k_cache[:pos], kn[None]]).transpose(0, 1)
        vals = torch.cat([v_cache[:pos], vn[None]]).transpose(0, 1)
        o = dot_product_attention(q.reshape(b, 1, heads, head_dim),
                                  keys.reshape(shp), vals.reshape(shp))
        return o.reshape(b, c), kn, vn
    (k_cache[pos], ks_cache[pos]), (v_cache[pos], vs_cache[pos]) = (
        quantize_rows(knf), quantize_rows(vnf))
    # f32 scores: past rows as codes x their k scale, the current row exact
    hd = (heads, head_dim)
    qh = q.float().reshape(b, *hd)
    past_k = k_cache[:pos].float().reshape(pos, b, *hd)
    past_v = (v_cache[:pos].float().reshape(pos, b, *hd)
              * vs_cache[:pos, :, :, None])
    s = torch.cat([torch.einsum("bhd,tbhd->bht", qh, past_k)
                   * ks_cache[:pos, :, 0].t()[:, None],
                   (qh * kn.float().reshape(b, *hd)).sum(-1, keepdim=True)],
                  dim=-1)
    p = torch.softmax(s * head_dim ** -0.5, dim=-1)
    o = (torch.einsum("bht,tbhd->bhd", p[..., :pos], past_v)
         + p[..., pos:] * vn.float().reshape(b, *hd))
    return o.reshape(b, c).to(x.dtype), kn, vn


def _post_ff_int8(x, attn, cross_k, cross_v, wo, bo, n2s, n2b, wq2, wo2, bo2,
                  n3s, n3b, wa, wg, ba, bg, w2, b2, scales, heads, head_dim):
    """decode_post_ff's plain math with int8 weights: each projection
    `_wdot`, its f32 result plus the bias rounded to the activation dtype
    where the TPU kernel rounds it; the GEGLU value and gate stay f32 up to
    f."""
    swo, swq2, swo2, swa, swg, sw2 = scales
    b, c = x.shape
    dt = x.dtype
    s = cross_k.shape[0]
    x1 = x + (_wdot(attn, wo, swo) + bo).to(dt)
    q2 = _wdot(layer_norm(x1, n2s, n2b), wq2, swq2).to(dt)
    o = dot_product_attention(
        q2.reshape(b, 1, heads, head_dim),
        cross_k.transpose(0, 1).reshape(b, s, heads, head_dim),
        cross_v.transpose(0, 1).reshape(b, s, heads, head_dim))
    xm = x1 + (_wdot(o.reshape(b, c), wo2, swo2) + bo2).to(dt)
    h3 = layer_norm(xm, n3s, n3b)
    f = ((_wdot(h3, wa, swa) + ba) * F.gelu(_wdot(h3, wg, swg) + bg)).to(dt)
    return xm + (_wdot(f, w2, sw2) + b2).to(dt)


def decode_post_ff_reference(x, attn, cross_k, cross_v, wo, bo, n2s, n2b,
                             wq2, wo2, bo2, n3s, n3b, wa, wg, ba, bg, w2, b2,
                             *, heads: int, head_dim: int, scales=None):
    """x, attn [B, C]; cross_k/v [S, B, C] -> x_out [B, C]. scales: the
    bf16 column scales of int8 (wo, wq2, wo2, wa, wg, w2)."""
    if scales is not None:
        return _post_ff_int8(x, attn, cross_k, cross_v, wo, bo, n2s, n2b,
                             wq2, wo2, bo2, n3s, n3b, wa, wg, ba, bg, w2, b2,
                             scales, heads, head_dim)
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


# ----------------------------------------------------------------- plans

class AttnPlan(NamedTuple):
    """decode_attn's attention launch: `group` heads a CTA, `splits` CTAs
    of a cluster each taking `rows` cache rows below pos (a multiple of
    ATTN_ROWS); `ctas` of the grid (splits x heads / group x B). The
    launcher picks the ring's depth for the built kernel."""
    group: int
    splits: int
    rows: int
    ctas: int


@functools.lru_cache(maxsize=None)
def attn_plan(b: int, heads: int, pos: int, sms: int) -> AttnPlan:
    """The split-KV attention's grid on a card of `sms` SMs at batch b and
    position pos: 4 heads a CTA (2 or 1 where heads does not divide), so a
    cache row's box is 512 contiguous bytes (256 int8); as many splits of
    the rows below pos as keep 4 CTAs an SM on average, up to
    ATTN_MAX_SPLITS and one 16-row box each at least; the rows dealt out
    in whole boxes, so only the last split's last box runs past pos.
    pos = 0 reads no row: one split."""
    group = next(g for g in (4, 2, 1) if heads % g == 0)
    cells = b * (heads // group)
    splits = max(1, min(ATTN_MAX_SPLITS, -(-pos // ATTN_ROWS),
                        4 * sms // cells))
    rows = -(-max(1, -(-pos // splits)) // ATTN_ROWS) * ATTN_ROWS
    splits = max(1, -(-pos // rows))
    if rows > ATTN_MAX_ROWS:
        raise ValueError(f"decode_attn: {pos} cache rows over {splits} "
                         f"splits exceed {ATTN_MAX_ROWS} a split")
    return AttnPlan(group, splits, rows, splits * cells)


# -------------------------------------------------------------- wrappers

def _check_pos(name: str, pos: int, t: int) -> None:
    if not 0 <= pos < t:
        raise ValueError(f"{name}: pos {pos} outside a cache of {t} rows")


def _check_head_dim(name: str, head_dim: int) -> None:
    if head_dim != HEAD_DIM:
        raise ValueError(f"{name}: the CUDA kernel takes head_dim "
                         f"{HEAD_DIM}, got {head_dim}")


def _attn_variant(quantized: bool, int8_kv: bool) -> str:
    return "decode_attn" + ("_w8" if quantized else "") + (
        "_kv8" if int8_kv else "")


def decode_attn(x, pos: int, k_cache, v_cache, n1s, n1b, wqkv, *,
                heads: int, head_dim: int, commit: bool = True,
                wqkv_s=None, ks_cache=None, vs_cache=None, rows=None):
    """LN1 + q/k/v projection + cached causal attention of one token:
    x [B, C], caches [T, B, C] -> (attn, k_new, v_new), each [B, C]. On
    CUDA this is two launches (the projection, `gemm_plan("qkv",
    split_k=True)` on the block-GEMM core; the split-KV attention,
    `attn_plan`), counted as one call; with a bf16 in-place commit k_new
    and v_new are the caches' rows pos. wqkv_s ([3C] bf16): wqkv is int8.
    ks_cache / vs_cache ([T, B, 1] f32): the caches are int8, and the
    attention launch commits row pos (commit must be on). rows: with
    commit off, the two [B, C] tensors k_new and v_new are written into
    and returned as (new ones otherwise)."""
    return _decode_attn(x, pos, k_cache, v_cache, n1s, n1b, wqkv,
                        heads=heads, head_dim=head_dim, commit=commit,
                        wqkv_s=wqkv_s, ks_cache=ks_cache, vs_cache=vs_cache,
                        rows=rows, pdl=True)


def _decode_attn(x, pos, k_cache, v_cache, n1s, n1b, wqkv, *, heads,
                 head_dim, commit=True, wqkv_s=None, ks_cache=None,
                 vs_cache=None, rows=None, pdl: bool):
    """decode_attn; pdl: its launches may start under the launch before
    them (always, in the wrapper; off, the card tests' reference bits)."""
    b, c = x.shape
    t = k_cache.shape[0]
    int8_kv = ks_cache is not None
    if (k_cache.shape != (t, b, c) or v_cache.shape != k_cache.shape
            or wqkv.shape != (c, 3 * c) or heads * head_dim != c):
        raise ValueError(f"decode_attn: x {tuple(x.shape)}, caches "
                         f"{tuple(k_cache.shape)}, {tuple(v_cache.shape)}, "
                         f"wqkv {tuple(wqkv.shape)} for {heads}x{head_dim}")
    if int8_kv and (not commit or vs_cache is None):
        raise ValueError("decode_attn: an int8 cache takes both scale caches "
                         "and commits in place (commit=True)")
    if rows is not None and (commit or len(rows) != 2):
        raise ValueError("decode_attn: rows are the two outputs of a "
                         "deferred commit (commit=False)")
    _check_pos("decode_attn", pos, t)
    if _on_cpu(x, k_cache, v_cache, wqkv):
        out = decode_attn_reference(x, pos, k_cache, v_cache, n1s, n1b,
                                    wqkv, heads=heads, head_dim=head_dim,
                                    commit=commit, wqkv_s=wqkv_s,
                                    ks_cache=ks_cache, vs_cache=vs_cache)
        if rows is None:
            return out
        for row, new in zip(rows, out[1:]):
            row.copy_(new)
        return (out[0], *rows)
    _check_head_dim("decode_attn", head_dim)
    quantized = wqkv_s is not None
    caches = [(k_cache, (t, b, c)), (v_cache, (t, b, c))]
    _check("decode_attn", [(x, (b, c))]
           + ([(wqkv_s, (3 * c,))] if quantized else [(wqkv, (c, 3 * c))])
           + ([] if int8_kv else caches)
           + [(row, (b, c)) for row in rows or ()],
           [(n1s, (c,)), (n1b, (c,))]
           + ([(ks_cache, (t, b, 1)), (vs_cache, (t, b, 1))] if int8_kv
              else []),
           i8=([(wqkv, (c, 3 * c))] if quantized else [])
           + (caches if int8_kv else []))
    sms = sm_count(x.device.index)
    proj = gemm_plan("qkv", b, 3 * c, c, sms, split_k=True, w8=quantized)
    ap = attn_plan(b, heads, pos, sms)
    q, out = torch.empty_like(x), torch.empty_like(x)
    if commit and not int8_kv:
        kn, vn = k_cache[pos], v_cache[pos]
    elif rows is not None:
        kn, vn = rows
    else:
        kn, vn = torch.empty_like(x), torch.empty_like(x)
    knf, vnf = ((torch.empty((b, c), dtype=torch.float32, device=x.device)
                 for _ in range(2)) if int8_kv else (None, None))
    lib = _build.load()
    with torch.cuda.device(x.device):
        st = _stream(x)
        rc = lib.rdm_decode_proj(
            _p(x), _p(n1s), _p(n1b), _p(wqkv),
            _p(wqkv_s) if quantized else None, _p(q), _p(kn), _p(vn),
            _p(knf) if int8_kv else None, _p(vnf) if int8_kv else None, b, c,
            *proj.args, proj.ks, int(pdl), st)
        _build.check(rc, "decode_attn (projection)")
        rc = lib.rdm_decode_attn(
            _p(q), _p(kn), _p(vn), _p(k_cache), _p(v_cache),
            *((_p(ks_cache), _p(vs_cache), _p(knf), _p(vnf)) if int8_kv
              else (None,) * 4), _p(out), pos, t, b, c, heads,
            head_dim ** -0.5 * _LOG2E, ap.group, ap.splits, ap.rows,
            int(pdl), st)
    _build.check(rc, "decode_attn")
    _launches[_attn_variant(quantized, int8_kv)] += 1
    return out, kn, vn


def decode_post_ff(x, attn, cross_k, cross_v, wo, bo, n2s, n2b, wq2, wo2,
                   bo2, n3s, n3b, wa, wg, ba, bg, w2, b2, *, heads: int,
                   head_dim: int, scales=None):
    """Everything after the self-attention core: x, attn [B, C],
    cross_k/v [S, B, C] -> x_out [B, C]. On CUDA five launches of the
    block-GEMM core at R = B rows (`gemm_plan(split_k=True)` plans them),
    counted as one call. scales: the bf16 column scales of int8 (wo, wq2,
    wo2, wa, wg, w2), [C], [C], [C], [F], [F], [C]."""
    return _decode_post_ff(x, attn, cross_k, cross_v, wo, bo, n2s, n2b, wq2,
                           wo2, bo2, n3s, n3b, wa, wg, ba, bg, w2, b2,
                           heads=heads, head_dim=head_dim, scales=scales,
                           pdl=True)


def _decode_post_ff(x, attn, cross_k, cross_v, wo, bo, n2s, n2b, wq2, wo2,
                    bo2, n3s, n3b, wa, wg, ba, bg, w2, b2, *, heads,
                    head_dim, scales=None, pdl: bool):
    """decode_post_ff; pdl as `_decode_attn`'s."""
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
                                        head_dim=head_dim, scales=scales)
    _check_head_dim("decode_post_ff", head_dim)
    weights = [(wo, (c, c)), (wq2, (c, c)), (wo2, (c, c)), (wa, (c, f)),
               (wg, (c, f)), (w2, (f, c))]
    quantized = scales is not None
    _check("decode_post_ff",
           [(x, (b, c)), (attn, (b, c)), (cross_k, (s, b, c)),
            (cross_v, (s, b, c))]
           + ([(sc, (w.shape[1],)) for sc, (w, _) in zip(scales, weights)]
              if quantized else weights),
           [(bo, (c,)), (n2s, (c,)), (n2b, (c,)), (bo2, (c,)), (n3s, (c,)),
            (n3b, (c,)), (ba, (f,)), (bg, (f,)), (b2, (c,))],
           i8=weights if quantized else [])
    if f % 64:
        raise ValueError(f"decode_post_ff: F={f} is not a multiple of 64")
    sms = sm_count(x.device.index)
    plans = [gemm_plan(kind, b, n, k, sms, split_k=True, w8=quantized)
             for kind, n, k in (("residual", c, c), ("cross", c, c),
                                ("geglu", f, c), ("residual", c, f))]
    x1, o2, xmid, out = (torch.empty_like(x) for _ in range(4))
    hidden = torch.empty((b, f), dtype=x.dtype, device=x.device)
    lib = _build.load()
    with torch.cuda.device(x.device):
        rc = lib.rdm_decode_post_ff(
            *(_p(a) for a in args),
            *((_p(sc) for sc in scales) if quantized else (None,) * 6),
            _p(x1), _p(o2), _p(xmid), _p(hidden), _p(out), b, c, s, f,
            head_dim ** -0.5, *(v for pl in plans for v in (*pl.args, pl.ks)),
            int(pdl), _stream(x))
    _build.check(rc, "decode_post_ff")
    _launches["decode_post_ff_w8" if quantized else "decode_post_ff"] += 1
    return out


class RowCommit:
    """One request's batched commit: for fixed caches ([T, B, C] each) and
    rows ([B, C] or [1, B, C] each), `commit_rows`'s checks, its pointer
    table and the caches' device, made once; then each call `(pos)`
    writes rows[i] into caches[i] at row pos, in place and in one launch
    (csrc/commit_rows.cu), and returns the caches. The rows are read when
    the launch runs, so a caller may rewrite them between calls
    (`FusedDecoder` keeps its deferred rows in one buffer a request)."""

    def __init__(self, caches: Sequence[torch.Tensor],
                 rows: Sequence[torch.Tensor]):
        n = len(caches)
        if n != len(rows) or n == 0:
            raise ValueError(f"commit_rows: {n} caches, {len(rows)} rows")
        t, b, c = caches[0].shape
        if any(tuple(r.shape[-2:]) != (b, c) or r.numel() != b * c
               for r in rows) or any(k.shape != (t, b, c) for k in caches):
            raise ValueError(f"commit_rows: caches "
                             f"{[tuple(k.shape) for k in caches]}, rows "
                             f"{[tuple(r.shape) for r in rows]}")
        self.caches, self.rows, self.t = list(caches), list(rows), t
        self.cpu = _on_cpu(*caches, *rows)
        if self.cpu:
            return
        _check("commit_rows", [(k, (t, b, c)) for k in caches]
               + [(r, tuple(r.shape)) for r in rows])
        if n > MAX_COMMIT:
            raise ValueError(f"commit_rows: {n} caches, at most "
                             f"{MAX_COMMIT} per launch")
        dev = caches[0].device.index
        table = (ctypes.c_void_p * (2 * n))(*(_p(a) for a in self.rows
                                                + self.caches))
        self._launch = functools.partial(_build.load().rdm_commit_rows,
                                         table, n)
        self._size = (b * c, sm_count(dev), dev)
        raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
        self._stream = (functools.partial(raw, dev) if raw is not None
                        else lambda: torch.cuda.current_stream(
                            dev).cuda_stream)

    def __call__(self, pos: int) -> List[torch.Tensor]:
        _check_pos("commit_rows", pos, self.t)
        if self.cpu:
            return commit_rows_reference(pos, self.caches, self.rows)
        rc = self._launch(pos, *self._size, self._stream())
        if rc:
            _build.check(rc, "commit_rows")
        _launches["commit_rows"] += 1
        return self.caches


def commit_rows(pos: int, caches: Sequence[torch.Tensor],
                rows: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Write rows[i] ([B, C] or [1, B, C]) into caches[i] ([T, B, C]) at row
    pos, for every i, in place and in one launch; returns the caches. A
    caller that commits the same tensors every step builds a `RowCommit`
    once instead."""
    return RowCommit(caches, rows)(pos)


def reset_launch_counts() -> None:
    for name in _launches:
        _launches[name] = 0


def launch_counts() -> Dict[str, int]:
    return dict(_launches)


# ------------------------------------------------------------ the layer

def decode_layer(x: torch.Tensor, pos: int, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, cross_k: torch.Tensor,
                 cross_v: torch.Tensor, w: Dict[str, torch.Tensor], *,
                 heads: int, head_dim: int, defer_commit: bool = False,
                 ks_cache: Optional[torch.Tensor] = None,
                 vs_cache: Optional[torch.Tensor] = None, rows=None):
    """One RARM layer for one token through the decode kernels.

    x [B, C]; caches [T, B, C]; cross_k/v [S, B, C]; w one layer's dict
    from `models.rarm.extract_decode_weights` (the `pack_block_weights`
    layout of ops/block_kernel.py; int8 projections with `<name>_s` scales
    in the int8_weights mode). Returns (x_out, k_cache, v_cache) with row
    pos of both caches written in place, or, with defer_commit, (x_out,
    k_row, v_row) with the rows [1, B, C] left for one `commit_rows` call
    over all layers (the caches are then untouched), written into `rows`
    ([B, C] each) where given. With ks_cache /
    vs_cache (int8 caches, [T, B, 1] f32 scales) it returns (x_out,
    k_cache, v_cache, ks_cache, vs_cache), all committed in place;
    defer_commit is refused there."""
    int8_kv = ks_cache is not None
    if int8_kv and defer_commit:
        raise ValueError("decode_layer: int8_kv commits each layer's rows "
                         "itself; defer_commit (one commit_rows launch over "
                         "all layers) takes bf16 caches only")
    quantized = "wqkv_s" in w
    attn, kn, vn = decode_attn(x, pos, k_cache, v_cache, w["n1s"], w["n1b"],
                               w["wqkv"], heads=heads, head_dim=head_dim,
                               commit=not defer_commit,
                               wqkv_s=w.get("wqkv_s"), ks_cache=ks_cache,
                               vs_cache=vs_cache, rows=rows)
    xo = decode_post_ff(x, attn, cross_k, cross_v, w["wo"], w["bo"],
                        w["n2s"], w["n2b"], w["wq2"], w["wo2"], w["bo2"],
                        w["n3s"], w["n3b"], w["wa"], w["wg"], w["ba"],
                        w["bg"], w["w2"], w["b2"], heads=heads,
                        head_dim=head_dim,
                        scales=tuple(w[n + "_s"] for n in POST_FF_WEIGHTS)
                        if quantized else None)
    if defer_commit:
        return xo, kn[None], vn[None]
    if int8_kv:
        return xo, k_cache, v_cache, ks_cache, vs_cache
    return xo, k_cache, v_cache
