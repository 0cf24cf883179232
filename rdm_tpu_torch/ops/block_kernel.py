"""The fused SpatialTransformer block: four hand-written CUDA kernels.

Counterpart of `rdm_tpu/ops/block_kernel.py` on its default split path. One
pre-LN transformer block (self-attention -> cross-attention -> GEGLU FF,
each residual; reference attention.py:77-96) runs as four kernels:

  1. `ln_qkv`      - LN1 + the [C, 3C] q/k/v projection
                     (csrc/ln_qkv.cu; replaces `_ln_qkv_kernel`): one
                     launch of the block-GEMM core (kernel 3's)
  2. `packed_attn` - softmax(q k^T d^-1/2) v per head
                     (csrc/packed_attn.cu; replaces `_packed_attn_kernel`):
                     [B, S, C] read as BSHD [B, S, heads, head_dim] by the
                     attention core that `flash_fwd` also launches
                     (csrc/attn_fwd_sm90.cuh), so the two are bit-equal
  3. `post_cross`  - out-proj + residual + LN2 + cross-attention over the
                     pre-projected context + out-proj + residual
                     (csrc/post_cross.cu; replaces `_post_cross_kernel`):
                     three launches of the block-GEMM core
                     (csrc/block_gemm_sm90.cuh, TMA + wgmma)
  4. `geglu_ff`    - LN3 + GEGLU FF + residual
                     (csrc/geglu_ff_sm90.cu; replaces `_geglu_ff_kernel`):
                     two launches of the same core

With RDM_TPU_SPLIT_K3=0 (or `split_k3=False`) kernels 3 and 4 run as one,
as the JAX package's single kernel 3 does:

  9. `post_ff`     - post_cross + geglu_ff with the GEGLU hidden kept on
                     chip (csrc/post_ff.cu; replaces `_post_ff_kernel`):
                     post_cross's three launches, then one FF launch of
                     the core over a cluster of CTAs a 64-row block,
                     each holding a slice of the hidden in shared memory
                     (`ff_plan`)

The int8 serving mode (`fused_transformer_block(..., qscales=)`) runs
their int8 variants: weight and activation int8 projections with int32
accumulation, static calibrated activation scales, per-column weight
scales (`quantize_cols`):

  5. `ln_qkv_q`       (csrc/ln_qkv_q.cu; replaces `_ln_qkv_kernel_q`): one
                      s8 launch of the block-GEMM core (LN1 and the codes
                      in its prologue, q | k | v in its epilogue)
  6. `packed_attn_q8` int8 q k^T and p v with per-cell absmax scales
                      (csrc/packed_attn_q8.cu; replaces
                      `_packed_attn_kernel_q8`; only with
                      RDM_TPU_INT8_ATTN=1, else the bf16 core runs):
                      three launches (absmax, codes, an s8 wgmma
                      attention over the codes)
  7. `post_cross_q`   (csrc/post_cross_q.cu; replaces `_post_cross_kernel_q`):
                      three s8 launches of the block-GEMM core (x1, cross
                      with the f32 o quantized, xmid over those codes)
  8. `geglu_ff_q`     (csrc/geglu_ff_q.cu; replaces `_geglu_ff_kernel_q`):
                      two s8 launches (up into the int8 hidden codes,
                      down over them)

Each wrapper has its plain PyTorch version beside it, `<name>_reference`.
A wrapper runs the plain version only for tensors on the CPU; for a CUDA
tensor it launches its kernel or raises: `_check` refuses other dtypes,
devices and layouts, `kernel_refusal` the shapes the kernel does not take
(heads other than 32 or 64 wide; C off a multiple of 32, F off 32 or
post_ff's 64; a block-GEMM launch that `gemm_plan` cannot fit, the s8
code prologue past K = 1536, a `post_ff` FF launch that `ff_plan` cannot
fit). Any number of context tokens is taken.
`fused_transformer_block` asks the same of every kernel the block will
launch (`block_refusal`) and raises before the first launch. Each wrapper
counts its launches in `<name>.launches`.

Layouts: activations [rows, C] or [B, S, C] with head h at channels
[dh, dh + d), d = head_dim; weights [in, out] (x @ W) in the activation
dtype; norm scales and biases f32 [C] or [F]. `pack_block_weights` builds
that dict once from a reference-layout TransformerBlock;
`quantize_block_weights` adds the int8 weights once, [out, in] with f32
per-output scales.

Training (RDM_TPU_FUSED_BLOCK_TRAIN=1, models/layers.py):
`fused_transformer_block_ad` is an autograd.Function whose forward runs
kernels 1-4 (9 under RDM_TPU_SPLIT_K3=0) and whose backward is the
gradient of `block_reference`, the unfused block over the same weights,
recomputed from the saved inputs (the JAX package's custom_vjp over
`_xla_block_reference`). Its weights come from `pack_block_weights(...,
differentiable=True)` on every call and its context k / v from
`context_kv`, both inside the autograd graph.
"""

from __future__ import annotations

import functools
import math
import os
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from rdm_tpu_torch.ops import _build
from rdm_tpu_torch.ops.attention import dot_product_attention

HEAD_DIMS = (32, 64)  # the head widths the attention kernels take
_LOG2E = 1.4426950408889634
# The block-GEMM core (csrc/block_gemm_sm90.cuh): per launch kind, the
# tiles it may take as (rows, columns, ping-pong), the preferred first;
# ring stages, a K-step, shared memory a CTA may use. A split tile gives
# each of its rows / 64 warpgroups 64 rows; a ping-pong tile gives two
# warpgroups alternate column tiles of all its rows. The cross-attention
# epilogue is CUDA-core work per column, so that launch takes the narrow
# tile: two heads a tile and three CTAs an SM. ln_qkv's tiles were picked
# by `profile_gemm.py --tiles` at the U-Net's sites at 2, 8 and 32 images
# from five: the 128-row split tile where its grid fills the card, else
# the ping-pong one (the 128-row LayerNorm panel does not fit at C = 960).
# The s8 launches of the int8 block (the kinds ending in 8, the core's
# s8 path): "residual8" streams its A codes (post_cross_q's xmid,
# geglu_ff_q's down) and takes the bf16 residual's tiles; "resq8"
# quantizes its bf16 rows in a code prologue first (post_cross_q's x1),
# "cross8" and "geglu8" normalise and quantize them, and these take the
# 64-row tiles alone, which ran fastest at the U-Net's sites at 8 images
# (`profile_gemm.py --tiles8`; the 128-row ping-pong GEGLU tile spills).
# "qkv8" (ln_qkv_q, N = 3C) normalises and quantizes too, and takes the
# split 64 x 128 tile where the plan keeps two of its CTAs an SM, else the
# ping-pong one, whose two warpgroups share one prologue (`--tiles8 qkv8`
# at 2, 8 and 32 images: the split tile ahead at C = 384 and at 2,048
# rows of C = 576, the ping-pong one at 512 rows and at C = 960, where
# shared memory holds one CTA an SM; 64-column tiles behind both).
GEMM_TILES = {"residual": ((128, 128, 0), (64, 128, 0), (64, 64, 0)),
              "cross": ((64, 64, 0),),
              "geglu": ((128, 64, 1), (64, 64, 1)),
              "qkv": ((128, 128, 0), (64, 128, 1)),
              "residual8": ((128, 128, 0), (64, 128, 0), (64, 64, 0)),
              "resq8": ((64, 64, 0),),
              "cross8": ((64, 64, 0),),
              "geglu8": ((64, 64, 1),),
              "qkv8": ((64, 128, 0), (64, 128, 1))}
_GEMM_STAGES = 8  # csrc/block_gemm_sm90.cuh kMaxStages
_GEMM_BK = 64
_GEMM_BK8 = 128  # an s8 K-step (kBK8): 128 codes
# the kinds whose A the CTA quantizes itself (a code prologue)
_CODE_PROLOGUE = ("resq8", "cross8", "geglu8", "qkv8")
_MAX_LN_K = 1536  # kMaxLNK: a lane holds 6 vectors of 8 of a row
# consumer warps an SM that a code-prologue launch's plan keeps resident
# where one of its tiles can (the rows' loads and reductions want warps)
_PROLOGUE_WARPS = 8
# The decode chain's launches (`gemm_plan(split_k=True)`): one tile, 64
# rows (the batch, zero-filled past it) x 64 columns, split warpgroups, K
# split over a cluster of up to _MAX_KS CTAs (kMaxKS, the portable cluster
# size), each CTA two or more K-steps.
DECODE_TILE = (64, 64, 0)
_MAX_KS = 8
_SMEM_LIMIT = 232448  # a CTA's opt-in maximum
_SMEM_SM = 233472     # an SM's, each resident CTA taking 1 KB more
# post_ff's FF launch (csrc/block_gemm_sm90.cuh `block_gemm_ff_kernel`): a
# ring stage of 64 K-rows x 128 columns of bf16 weights; a 32-column unit
# of the K split's sum, 64 rows of f32; an f tile of the hidden, 64 rows x
# 64 columns of bf16; clusters of up to 16 CTAs (kMaxFFRanks; non-portable
# past 8); the least ring depth, two stages a warpgroup's ring
_FF_STAGE = 16384
_FF_UNIT = 8192
_FF_TILE = 8192
_MAX_FF_RANKS = 16
_FF_STAGES = 4


# ------------------------------------------------------------ plain math

def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """f32-statistics LayerNorm with dtype-native arithmetic — the
    numerics of rdm_tpu models.layers._RawLayerNorm."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = ((xf * xf).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0)
    inv = torch.rsqrt(var + eps)
    y = (x - mean.to(x.dtype)) * inv.to(x.dtype)
    return y * scale.to(x.dtype) + bias.to(x.dtype)


def _linear(x: torch.Tensor, w: torch.Tensor, b=None) -> torch.Tensor:
    """x @ w (+ b) in x's dtype; w is [in, out]."""
    if b is None:
        return x @ w.to(x.dtype)
    return torch.addmm(b.to(x.dtype), x, w.to(x.dtype))


def ln_qkv_reference(x2, n1s, n1b, wqkv):
    """x2 [R, C] -> (q, k, v), each [R, C]."""
    c = x2.shape[1]
    qkv = _linear(layer_norm(x2, n1s, n1b), wqkv)
    return qkv[:, :c], qkv[:, c:2 * c], qkv[:, 2 * c:]


def packed_attn_reference(q, k, v, *, heads: int, head_dim: int):
    """q/k/v [B, S, C] -> [B, S, C]: per-head softmax attention with f32
    scores (ops.attention's plain path, never the flash kernels)."""
    b, s, c = q.shape
    shp = (b, s, heads, head_dim)
    o = dot_product_attention(q.reshape(shp), k.reshape(shp),
                              v.reshape(shp), impl="xla")
    return o.reshape(b, s, c)


def post_cross_reference(x, attn, ck, cv, wo, bo, n2s, n2b, wq2, wo2, bo2,
                         *, heads: int, head_dim: int):
    """x, attn [B, S, C]; ck, cv [B, T, C] pre-projected context ->
    xmid [B, S, C] (unfused TransformerBlock attn-out + attn2 math)."""
    b, s, c = x.shape
    t = ck.shape[1]
    x1 = x + _linear(attn.reshape(b * s, c), wo, bo).reshape(b, s, c)
    q2 = _linear(layer_norm(x1, n2s, n2b).reshape(b * s, c), wq2)
    o = dot_product_attention(q2.reshape(b, s, heads, head_dim),
                              ck.reshape(b, t, heads, head_dim),
                              cv.reshape(b, t, heads, head_dim))
    return x1 + _linear(o.reshape(b * s, c), wo2, bo2).reshape(b, s, c)


def geglu_ff_reference(xm2, n3s, n3b, wa, wg, ba, bg, w2, b2):
    """xm2 [R, C] -> xm2 + GEGLU(LN3(xm2)) (exact-erf gelu)."""
    h = layer_norm(xm2, n3s, n3b)
    f = _linear(h, wa, ba) * F.gelu(_linear(h, wg, bg))
    return xm2 + _linear(f, w2, b2)


def post_ff_reference(x, attn, ck, cv, wo, bo, n2s, n2b, wq2, wo2, bo2, n3s,
                      n3b, wa, wg, ba, bg, w2, b2, *, heads: int,
                      head_dim: int):
    """x, attn [B, S, C]; ck, cv [B, T, C] -> y [B, S, C]: post_cross then
    geglu_ff."""
    b, s, c = x.shape
    xm = post_cross_reference(x, attn, ck, cv, wo, bo, n2s, n2b, wq2, wo2,
                              bo2, heads=heads, head_dim=head_dim)
    return geglu_ff_reference(xm.reshape(b * s, c), n3s, n3b, wa, wg, ba, bg,
                              w2, b2).reshape(b, s, c)


# -------------------------------------------------------------- wrappers

class GemmPlan(NamedTuple):
    """One launch of the block-GEMM core: a tile of `bm` rows and `bn`
    columns, `pp` 1 for two ping-pong warpgroups (else bm / 64 split
    ones), `tiles_per_cta` column tiles a CTA walks, `stages` of the ring,
    `smem` bytes a CTA, `ks` CTAs of a cluster splitting K (the decode
    chain's launches; 1 elsewhere). `args` are the U-Net launchers' five
    ints; the decode launcher takes `args` and `ks`."""
    bm: int
    bn: int
    pp: int
    tiles_per_cta: int
    stages: int
    smem: int
    ks: int = 1

    @property
    def args(self):
        return (self.bm, self.bn, self.pp, self.tiles_per_cta, self.stages)


def _threads(bm: int, pp: int) -> int:
    """Consumer warpgroups' threads and the producer warp of a CTA."""
    return 128 * (2 if pp else bm // 64) + 32


def gemm_smem(kind: str, bm: int, bn: int, k: int, stages: int,
              w8: bool = False, ks: int = 1,
              rows: Optional[int] = None) -> int:
    """Shared bytes of a CTA (csrc/block_gemm_sm90.cuh `smem_bytes`): the
    normalised A panel (LayerNorm kinds; K rounded up to a 64-wide K-step,
    bm rows x 2 bytes), then `stages` x (two streamed A panels of 32
    columns for "residual" + bn columns x 64 K-rows of each weight in bf16,
    and with int8 weights (w8) their int8 boxes beside), then the ring's
    and the panel's barriers, after up to 1 KB of alignment. With a K
    split over ks CTAs (`split_bytes`) a region of its own after the ring
    takes what rank 0 receives: ks - 1 f32 partial tiles of the warps
    that hold the launch's first `rows` rows (16 a warp; all bm rows by
    default). The s8 kinds (`GEMM_TILES`' "*8", `smem8_bytes`): the code
    panel (the prologue kinds; K rounded up to 128, bm rows x 1 byte),
    then `stages` x (a streamed A box of 128 codes for "residual8" + bn
    rows x 128 codes of each weight), then the ring's barriers."""
    if kind in GEMM_TILES and kind.endswith("8"):
        panel = -(-k // _GEMM_BK8) * bm * _GEMM_BK8 \
            if kind in _CODE_PROLOGUE else 0
        a_stage = bm * _GEMM_BK8 if kind == "residual8" else 0
        nw = 2 if kind == "geglu8" else 1
        return (1024 + panel + stages * (a_stage + nw * bn * _GEMM_BK8)
                + 16 * stages)
    rb = bm if rows is None else min(bm, rows)
    panel = 0 if kind == "residual" else -(-k // _GEMM_BK) * 2 * bm * 64
    a_stage = 2 * bm * 64 if kind == "residual" else 0
    nw = 2 if kind == "geglu" else 1
    stage = a_stage + nw * (bn // 32) * _GEMM_BK * 64
    if w8:
        stage += nw * bn * _GEMM_BK
    split = (ks - 1) * nw * -(-rb // 16) * 64 * bn
    return 1024 + panel + stages * stage + split + 8 * (2 * stages + 1)


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """The SMs of CUDA device `index`."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def _gemm_fits(kind: str, k: int) -> list:
    """(bm, bn, pp, the ring depths that fit) of each of the kind's tiles
    with room in shared memory for 3 or more stages (a ping-pong tile's
    two rings 2 each) at K = k; none past _MAX_LN_K for the s8 code
    prologue, whose lanes hold a row in registers."""
    if kind not in GEMM_TILES:
        raise ValueError(f"gemm_plan: kind {kind!r} not in "
                         f"{tuple(GEMM_TILES)}")
    if kind in _CODE_PROLOGUE and k > _MAX_LN_K:
        return []
    fits = []
    for bm, bn, pp in GEMM_TILES[kind]:
        depths = [st for st in range(3 + pp, _GEMM_STAGES + 1, 1 + pp)
                  if gemm_smem(kind, bm, bn, k, st) <= _SMEM_LIMIT]
        if depths:
            fits.append((bm, bn, pp, depths))
    return fits


def _gemm_refusal(kind: str, k: int) -> Optional[str]:
    """gemm_plan's refusal of a launch of `kind` at K = k, or None."""
    if _gemm_fits(kind, k):
        return None
    if kind in _CODE_PROLOGUE and k > _MAX_LN_K:
        return (f"gemm_plan: K={k} is past the {kind} launch's code "
                f"prologue (K <= {_MAX_LN_K})")
    return (f"gemm_plan: K={k} leaves no room in shared memory for the "
            f"{kind} launch")


def _per_sm(kind: str, bm: int, bn: int, pp: int, k: int, st: int,
            w8: bool = False, ks: int = 1,
            rows: Optional[int] = None) -> int:
    """CTAs of a plan resident on one SM, by shared memory and threads."""
    smem = gemm_smem(kind, bm, bn, k, st, w8, ks, rows)
    return min(_SMEM_SM // (smem + 1024), 2048 // _threads(bm, pp))


def _split_k_plan(kind: str, r: int, n: int, k: int, sms: int,
                  w8: bool) -> GemmPlan:
    """gemm_plan(split_k=True): DECODE_TILE, a CTA one column tile. KS
    > 1 only for a launch of one 64-row block (r <= 64) whose column tiles
    fill fewer than half the SMs: then the largest KS up to _MAX_KS that
    leaves each CTA two or more K-steps and the grid within one wave. The
    ring holds the CTA's K-steps, 2 to 8 stages, as deep as fits beside
    the split's region (and, for the LayerNorm kinds, the normalised
    panel of K columns). The decode launches: "residual", "cross" and
    "geglu" (decode_post_ff's chain), "qkv" (decode_attn's projection)."""
    if kind not in ("residual", "cross", "geglu", "qkv"):
        raise ValueError(f"gemm_plan: the decode launches have no {kind!r} "
                         "launch")
    bm, bn, pp = DECODE_TILE
    nkb, ntiles = -(-k // _GEMM_BK), -(-n // bn)

    def stages(ks):  # a ring no deeper than the CTA's K-steps, or None
        fit = [st for st in range(2, max(2, min(_GEMM_STAGES,
                                                -(-nkb // ks))) + 1)
               if gemm_smem(kind, bm, bn, k, st, w8, ks, r) <= _SMEM_LIMIT]
        return fit[-1] if fit else None

    if stages(1) is None:
        raise ValueError(f"gemm_plan: K={k} leaves no room in shared memory "
                         f"for the decode chain's {kind} launch")
    ks = 1
    if r <= bm and 2 * ntiles < sms:
        ks = next((x for x in range(_MAX_KS, 1, -1) if nkb // x >= 2
                   and stages(x) is not None and ntiles * x <= sms * _per_sm(
                       kind, bm, bn, pp, k, stages(x), w8, x, r)), 1)
    st = stages(ks)
    return GemmPlan(bm, bn, pp, 1, st,
                    gemm_smem(kind, bm, bn, k, st, w8, ks, r), ks)


@functools.lru_cache(maxsize=None)
def gemm_plan(kind: str, r: int, n: int, k: int, sms: int, *,
              split_k: bool = False, w8: bool = False) -> GemmPlan:
    """The tile of one launch on a card of `sms` SMs: the first of the
    kind's GEMM_TILES whose ring keeps 3 or more stages (a ping-pong
    tile's two rings 2 each) in shared memory and whose grid still gives
    every SM a CTA (for the code-prologue kinds, also with
    _PROLOGUE_WARPS consumer warps resident an SM at the plan's ring
    depth); else the last that fits. Of the ring depths that fit,
    the one that runs the grid in the fewest waves (CTAs resident per SM by
    shared memory and threads), the deeper on a tie. The LayerNorm kinds,
    whose prologue and epilogues are CUDA-core work that wants warps, take
    the ring depth that keeps the most CTAs resident, up to what the grid
    can use (the deeper on a tie), and let a CTA walk several column tiles
    of its row block, normalising its rows once: the fewest tiles a CTA
    that still fit the grid in one wave (W's traffic is the same for any
    split). split_k: the decode chain's launch (`_split_k_plan`; w8, its
    int8 weights), whose launcher takes a K split across a cluster; every
    other launch has ks = 1."""
    if split_k:
        return _split_k_plan(kind, r, n, k, sms, w8)
    fits = _gemm_fits(kind, k)
    if not fits:
        raise ValueError(_gemm_refusal(kind, k))
    for bm, bn, pp, depths in fits:
        row_blocks, ntiles = -(-r // bm), -(-n // bn)

        def per_sm(st):
            return _per_sm(kind, bm, bn, pp, k, st)

        if kind in ("residual", "residual8"):
            tpc = 1
            stages = min(reversed(depths), key=lambda st: -(
                -row_blocks * ntiles // (sms * per_sm(st))))
        else:
            need = -(-row_blocks * ntiles // sms)  # residency worth having
            stages = max(depths, key=lambda st: (min(per_sm(st), need), st))
            slots = sms * per_sm(stages)
            tpc = next((n for n in range(1, ntiles + 1)
                        if row_blocks * -(-ntiles // n) <= slots), ntiles)
            tpc = -(-ntiles // -(-ntiles // tpc))  # same CTAs, evened out
        warps = per_sm(stages) * 4 * (2 if pp else bm // 64)
        if (bm, bn, pp) == fits[-1][:3] or (
                row_blocks * ntiles >= sms
                and (kind not in _CODE_PROLOGUE or warps >= _PROLOGUE_WARPS)):
            break
    return GemmPlan(bm, bn, pp, tpc, stages,
                    gemm_smem(kind, bm, bn, k, stages))


class FFPlan(NamedTuple):
    """post_ff's FF launch: a cluster of `ranks` CTAs a 64-row block, each
    taking whole 64-column f tiles of F; `stages` of its ring;
    `round_units` 32-column units of y summed across the cluster a round
    (a multiple of ranks and of 4); `smem` bytes a CTA. `args` are the
    launcher's three ints."""
    ranks: int
    stages: int
    round_units: int
    smem: int

    @property
    def args(self):
        return (self.ranks, self.stages, self.round_units)


def _ff_panel(c: int) -> int:
    """Bytes of the 64-row LN3 panel (the core's LayerNorm panel at K = c,
    K rounded up to a 64-wide K-step)."""
    return -(-c // _GEMM_BK) * 2 * 64 * 64


def ff_smem(c: int, f: int, ranks: int, stages: int,
            round_units: int) -> int:
    """Shared bytes of an FF CTA (csrc/block_gemm_sm90.cuh
    `ff_smem_bytes`): the LN3 panel, or the round's unit slots where they
    take more (round_units x one 8 KB slot per sender rank's unit), then
    the most f tiles a rank takes, the ring and its barriers, after up to
    1 KB of alignment."""
    region0 = max(_ff_panel(c), round_units * _FF_UNIT)
    return (1024 + region0 + -(-(f // 64) // ranks) * _FF_TILE
            + stages * _FF_STAGE + 8 * (2 * stages + 1))


def _ff_fit(c: int, f: int, ranks: int):
    """(stages, round_units) of the deepest ring (an even depth, half a
    warpgroup's, _FF_STAGES at least) that fits with `ranks` CTAs a
    cluster, or None; then as many units a round (a multiple of ranks and
    4, no more than C's units need) as keep that ring: fewer rounds of
    the sum, and y tiles for both warpgroups in a round."""
    step = math.lcm(ranks, 4)
    most = -(-(c // 32) // step) * step
    for st in range(_GEMM_STAGES, _FF_STAGES - 1, -2):
        if ff_smem(c, f, ranks, st, step) <= _SMEM_LIMIT:
            ru = step
            while (ru + step <= most
                   and ff_smem(c, f, ranks, st, ru + step) <= _SMEM_LIMIT):
                ru += step
            return st, ru
    return None


def _ff_refusal(c: int, f: int) -> Optional[str]:
    """ff_plan's refusal of C = c, F = f, or None."""
    try:
        ff_plan(c, f)
    except ValueError as e:
        return str(e)
    return None


def _ff_steps(c: int, f: int, ranks: int) -> int:
    """K-steps of the busiest FF CTA: its up products (its f tiles x C's
    K-steps) and its down product (y's 128-column tiles x its f tiles),
    plus as many again as one f tile's K-steps and four for its LN3,
    ring ramp and rounds of the sum."""
    tiles, nkb = -(-(f // 64) // ranks), -(-c // _GEMM_BK)
    return tiles * nkb + -(-c // 128) * tiles + nkb + 4


@functools.lru_cache(maxsize=None)
def ff_plan(c: int, f: int, ranks: Optional[int] = None, *,
            rows: Optional[int] = None,
            capacity: Optional[tuple] = None) -> FFPlan:
    """post_ff's FF launch at C = c, F = f. Of the rank counts (2 or more
    where F has two f tiles, up to _MAX_FF_RANKS and the f tiles) whose
    LN3 panel, f slice and ring of _FF_STAGES stages or more fit a CTA's
    shared memory, the fewest; or, given the
    launch's `rows` and the card's `capacity` (clusters of 1 .. 16 FF
    CTAs it keeps resident at once, `ff_capacity`), the one that
    minimises the waves of clusters (ceil(row blocks / capacity)) times a
    CTA's K-steps (`_ff_steps`). Fewer ranks redo LN3 fewer times and
    send fewer partials, but walk more K-steps a CTA; clusters of more
    CTAs fit fewer at once (on an H100 SXM 66 of 2, 30 of 4, 15 of 8, 7
    of 9 to 16). At the U-Net's sites (F = 4C, 8 images) on an H100: 2, 6
    and 16 ranks at C = 384, 576, 960 (2, 4, 12 with no capacity).
    `ranks` forces a cluster size (the profile's sweep). Raises
    ValueError where none fits."""
    if c % 32 or f % 64 or c < 32 or f < 64:
        raise ValueError(f"ff_plan: C={c} and F={f} must be multiples of "
                         "32 and 64")
    if c > _MAX_LN_K:
        raise ValueError(f"ff_plan: C={c} is past the LayerNorm prologue "
                         f"(K <= {_MAX_LN_K})")
    ntf = f // 64
    if ranks is not None and not 1 <= ranks <= min(_MAX_FF_RANKS, ntf):
        raise ValueError(f"ff_plan: {ranks} ranks for {ntf} f tiles")
    cands = ([ranks] if ranks is not None
             else range(min(2, ntf), min(_MAX_FF_RANKS, ntf) + 1))
    fits = [(n, fit) for n in cands for fit in [_ff_fit(c, f, n)]
            if fit is not None and (capacity is None or capacity[n - 1] > 0)]
    if not fits:
        raise ValueError(
            f"ff_plan: C={c}, F={f} leaves no room in shared memory: the "
            f"LN3 panel ({_ff_panel(c)} bytes), a {_FF_STAGES}-stage ring "
            f"and an f slice of up to {_MAX_FF_RANKS} ranks pass "
            f"{_SMEM_LIMIT}")
    if rows is not None and capacity is not None:
        blocks = -(-rows // 64)
        n, fit = min(fits, key=lambda x: -(-blocks // capacity[x[0] - 1])
                     * _ff_steps(c, f, x[0]))
    else:
        n, fit = fits[0]
    return FFPlan(n, *fit, ff_smem(c, f, n, *fit))


@functools.lru_cache(maxsize=None)
def ff_capacity(index: int) -> tuple:
    """Clusters of 1 .. _MAX_FF_RANKS FF CTAs that CUDA device `index`
    keeps resident at once (cudaOccupancyMaxActiveClusters of the FF
    launch at a CTA's shared-memory maximum), for `ff_plan`."""
    lib = _build.load()
    with torch.cuda.device(index):
        caps = tuple(lib.rdm_ff_clusters(n)
                     for n in range(1, _MAX_FF_RANKS + 1))
    if min(caps) < 0:
        _build.check(-min(caps), "post_ff (cluster capacity)")
    return caps


def _on_cpu(*ts: torch.Tensor) -> bool:
    dev = {t.device.type for t in ts}
    if dev == {"cpu"}:
        return True
    if dev != {"cuda"}:
        raise ValueError(f"block kernels take CPU or CUDA tensors, got {dev}")
    return False


_KINDS = {torch.bfloat16: "bf16 activations and weights",
          torch.float32: "f32 norms, biases and scales",
          torch.int8: "int8 weights"}


def _check(name: str, bf16, f32=(), *, i8=()) -> None:
    """Raise unless the CUDA kernel takes these (tensor, shape) pairs: bf16
    activations and weights, f32 norms, biases and scales, int8 weights,
    each of its shape, on one device, contiguous and 16-byte aligned (the
    kernels move 16-byte vectors), and none requiring grad in grad mode
    (`_build.refuse_grad`)."""
    _build.refuse_grad(name, *(t for group in (bf16, f32, i8)
                               for t, _ in group))
    dev = bf16[0][0].device
    for dtype, group in ((torch.bfloat16, bf16), (torch.float32, f32),
                         (torch.int8, i8)):
        for t, shape in group:
            if t.dtype != dtype:
                raise TypeError(f"{name}: the CUDA kernel takes "
                                f"{_KINDS[dtype]}, got {t.dtype}")
            if tuple(t.shape) != tuple(shape):
                raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                                 f"got {tuple(t.shape)}")
            if t.device != dev:
                raise ValueError(f"{name}: tensors on {t.device} and {dev}")
            if not t.is_contiguous() or t.data_ptr() % 16:
                raise ValueError(f"{name}: tensors must be contiguous and "
                                 "16-byte aligned")


# ------------------------------------------------------- the shape gate

_ATTENTION = ("packed_attn", "post_cross", "post_ff", "packed_attn_q8",
              "post_cross_q")  # the kernels that split C into heads
_CONTEXT = ("post_cross", "post_ff", "post_cross_q")
_FF = ("geglu_ff", "post_ff", "geglu_ff_q")  # the kernels that take F
# the block-GEMM core's launches of a wrapper: (kind, K is C or F)
_GEMM_KINDS = {"ln_qkv": (("qkv", "C"),),
               "post_cross": (("residual", "C"), ("cross", "C")),
               "geglu_ff": (("geglu", "C"), ("residual", "F")),
               "post_ff": (("residual", "C"), ("cross", "C")),
               "post_cross_q": (("resq8", "C"), ("cross8", "C"),
                                ("residual8", "C")),
               "geglu_ff_q": (("geglu8", "C"), ("residual8", "F")),
               "ln_qkv_q": (("qkv8", "C"),)}


def _a128(n: int) -> int:
    return -(-n // 128) * 128


def _refuse(why: Optional[str]) -> None:
    if why is not None:
        raise ValueError(why)


@functools.lru_cache(maxsize=None)
def kernel_refusal(name: str, c: int, *, t: int = 1, head_dim: int = 32,
                   f: int = 0) -> Optional[str]:
    """Why the CUDA kernel `name` does not take a block of width `c`, `t`
    context tokens, heads of `head_dim` and FF width `f` (each where the
    kernel reads it), or None. The wrappers raise ValueError with it, and
    `block_refusal` asks it of every kernel a block would launch."""
    if name in _ATTENTION and head_dim not in HEAD_DIMS:
        return (f"{name}: the CUDA kernel takes head_dim in {HEAD_DIMS}, got "
                f"{head_dim}")
    if name in _CONTEXT and t < 1:
        return f"{name}: context length {t} < 1"
    if name in ("packed_attn", "packed_attn_q8"):
        return None  # any S
    fm = 64 if name == "post_ff" else 32
    for dim, v, m in (("C", c, 32), ("F", f, fm))[:2 if name in _FF else 1]:
        if v % m:
            return (f"{name}: the CUDA kernel takes {dim} as a multiple of "
                    f"{m}, got {v}")
    for kind, dim in _GEMM_KINDS.get(name, ()):
        why = _gemm_refusal(kind, c if dim == "C" else f)
        if why is not None:
            return f"{name}: {why}"
    if name == "post_ff":  # the FF launch after post_cross's three
        why = _ff_refusal(c, f)
        if why is not None:
            return f"{name}: {why}"
    return None


def block_refusal(c: int, t: int, heads: int, head_dim: int, f: int, *,
                  int8: bool, split_k3: bool) -> Optional[str]:
    """Why `fused_transformer_block` cannot run a block of width c = heads
    x head_dim, t context tokens and FF width f on the card (int8: the
    serving mode's kernels, which always split kernels 3 and 4, with
    `packed_attn_q8` under RDM_TPU_INT8_ATTN=1; else split_k3 picks the
    pair or `post_ff`): the first `kernel_refusal` of a kernel it would
    launch, or None when every one takes the shapes. The block raises
    with it on the card before its first launch."""
    if heads * head_dim != c:
        return f"block: {heads} heads of {head_dim} for C={c}"
    if int8:
        names = ("ln_qkv_q", "packed_attn_q8" if use_int8_attn_core()
                 else "packed_attn", "post_cross_q", "geglu_ff_q")
    else:
        names = ("ln_qkv", "packed_attn") + (
            ("post_cross", "geglu_ff") if split_k3 else ("post_ff",))
    for name in names:
        why = kernel_refusal(name, c, t=t, head_dim=head_dim, f=f)
        if why is not None:
            return why
    return None


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _p(t: torch.Tensor) -> int:
    return t.data_ptr()


def ln_qkv(x2, n1s, n1b, wqkv):
    """LN1 + q/k/v projection: x2 [R, C] -> (q, k, v) each [R, C]. On CUDA
    one launch of the block-GEMM core."""
    r, c = x2.shape
    if wqkv.shape != (c, 3 * c):
        raise ValueError(f"wqkv {tuple(wqkv.shape)} for C={c}")
    if _on_cpu(x2, wqkv):
        return ln_qkv_reference(x2, n1s, n1b, wqkv)
    _check("ln_qkv", [(x2, (r, c)), (wqkv, (c, 3 * c))],
           [(n1s, (c,)), (n1b, (c,))])
    _refuse(kernel_refusal("ln_qkv", c))
    q, k, v = (torch.empty_like(x2) for _ in range(3))
    plan = gemm_plan("qkv", r, 3 * c, c, sm_count(x2.device.index))
    lib = _build.load()
    with torch.cuda.device(x2.device):
        rc = lib.rdm_ln_qkv(_p(x2), _p(n1s), _p(n1b), _p(wqkv), _p(q),
                            _p(k), _p(v), r, c, *plan.args, _stream(x2))
    _build.check(rc, "ln_qkv")
    ln_qkv.launches += 1
    return q, k, v


ln_qkv.launches = 0


def packed_attn(q, k, v, *, heads: int, head_dim: int):
    """Self-attention core: q/k/v [B, S, C] -> [B, S, C]."""
    b, s, c = q.shape
    if heads * head_dim != c or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"packed_attn: q/k/v {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)} for "
                         f"{heads}x{head_dim}")
    if _on_cpu(q, k, v):
        return packed_attn_reference(q, k, v, heads=heads,
                                     head_dim=head_dim)
    _check("packed_attn", [(a, (b, s, c)) for a in (q, k, v)])
    _refuse(kernel_refusal("packed_attn", c, head_dim=head_dim))
    o = torch.empty_like(q)
    scale_log2 = head_dim ** -0.5 * _LOG2E
    lib = _build.load()
    with torch.cuda.device(q.device):
        rc = lib.rdm_packed_attn(_p(q), _p(k), _p(v), _p(o), b, s, heads,
                                 head_dim, scale_log2, _stream(q))
    _build.check(rc, "packed_attn")
    packed_attn.launches += 1
    return o


packed_attn.launches = 0


def post_cross(x, attn, ck, cv, wo, bo, n2s, n2b, wq2, wo2, bo2, *,
               heads: int, head_dim: int):
    """Out-proj + LN2 + cross-attention + out-proj: x, attn [B, S, C],
    ck, cv [B, T, C] -> xmid [B, S, C]."""
    b, s, c = x.shape
    t = ck.shape[1]
    if (attn.shape != x.shape or ck.shape != (b, t, c)
            or cv.shape != ck.shape or heads * head_dim != c):
        raise ValueError(f"post_cross: x {tuple(x.shape)}, attn "
                         f"{tuple(attn.shape)}, ck {tuple(ck.shape)}, cv "
                         f"{tuple(cv.shape)} for {heads}x{head_dim}")
    if _on_cpu(x, attn, ck, cv, wo):
        return post_cross_reference(x, attn, ck, cv, wo, bo, n2s, n2b, wq2,
                                    wo2, bo2, heads=heads,
                                    head_dim=head_dim)
    _check("post_cross",
           [(x, (b, s, c)), (attn, (b, s, c)), (ck, (b, t, c)),
            (cv, (b, t, c)), (wo, (c, c)), (wq2, (c, c)), (wo2, (c, c))],
           [(v, (c,)) for v in (bo, n2s, n2b, bo2)])
    _refuse(kernel_refusal("post_cross", c, t=t, head_dim=head_dim))
    r, sms = b * s, sm_count(x.device.index)
    x1, o, out = (torch.empty_like(x) for _ in range(3))
    lib = _build.load()
    with torch.cuda.device(x.device):
        rc = lib.rdm_post_cross(
            _p(x), _p(attn), _p(ck), _p(cv), _p(wo), _p(bo), _p(n2s),
            _p(n2b), _p(wq2), _p(wo2), _p(bo2), _p(x1), _p(o), _p(out), r,
            s, c, t, head_dim, head_dim ** -0.5,
            *gemm_plan("residual", r, c, c, sms).args,
            *gemm_plan("cross", r, c, c, sms).args, _stream(x))
    _build.check(rc, "post_cross")
    post_cross.launches += 1
    return out


post_cross.launches = 0


def geglu_ff(xm2, n3s, n3b, wa, wg, ba, bg, w2, b2):
    """LN3 + GEGLU FF + residual: xm2 [R, C] -> [R, C]. On CUDA this is
    two launches of the block-GEMM core (gated up-projection into a bf16
    [R, F] hidden, then down-projection + residual), counted as one
    call."""
    r, c = xm2.shape
    f = wa.shape[1]
    if wa.shape != (c, f) or wg.shape != (c, f) or w2.shape != (f, c):
        raise ValueError(f"geglu_ff: wa {tuple(wa.shape)}, wg "
                         f"{tuple(wg.shape)}, w2 {tuple(w2.shape)} for C={c}")
    if _on_cpu(xm2, wa):
        return geglu_ff_reference(xm2, n3s, n3b, wa, wg, ba, bg, w2, b2)
    _check("geglu_ff",
           [(xm2, (r, c)), (wa, (c, f)), (wg, (c, f)), (w2, (f, c))],
           [(n3s, (c,)), (n3b, (c,)), (ba, (f,)), (bg, (f,)), (b2, (c,))])
    _refuse(kernel_refusal("geglu_ff", c, f=f))
    hidden = torch.empty((r, f), dtype=xm2.dtype, device=xm2.device)
    y = torch.empty_like(xm2)
    sms = sm_count(xm2.device.index)
    lib = _build.load()
    with torch.cuda.device(xm2.device):
        rc = lib.rdm_geglu_ff_sm90(
            _p(xm2), _p(n3s), _p(n3b), _p(wa), _p(wg), _p(ba), _p(bg),
            _p(w2), _p(b2), _p(hidden), _p(y), r, c, f,
            *gemm_plan("geglu", r, f, c, sms).args,
            *gemm_plan("residual", r, c, f, sms).args, _stream(xm2))
    _build.check(rc, "geglu_ff")
    geglu_ff.launches += 1
    return y


geglu_ff.launches = 0


def post_ff(x, attn, ck, cv, wo, bo, n2s, n2b, wq2, wo2, bo2, n3s, n3b, wa,
            wg, ba, bg, w2, b2, *, heads: int, head_dim: int):
    """post_cross + geglu_ff with the GEGLU hidden kept on chip: x, attn
    [B, S, C], ck, cv [B, T, C] -> y [B, S, C]. On CUDA post_cross's three
    launches of the block-GEMM core, then its FF launch (`ff_plan`),
    counted as one call."""
    return _post_ff(x, attn, ck, cv, wo, bo, n2s, n2b, wq2, wo2, bo2, n3s,
                    n3b, wa, wg, ba, bg, w2, b2, heads=heads,
                    head_dim=head_dim)[0]


def _post_ff(x, attn, ck, cv, wo, bo, n2s, n2b, wq2, wo2, bo2, n3s, n3b, wa,
             wg, ba, bg, w2, b2, *, heads: int, head_dim: int):
    """post_ff's (y, xm): xm [B, S, C] is post_cross's output, which the FF
    launch reads (the plain version's on the CPU)."""
    b, s, c = x.shape
    t = ck.shape[1]
    f = wa.shape[1]
    if (attn.shape != x.shape or ck.shape != (b, t, c)
            or cv.shape != ck.shape or heads * head_dim != c
            or wa.shape != (c, f) or wg.shape != (c, f)
            or w2.shape != (f, c)):
        raise ValueError(f"post_ff: x {tuple(x.shape)}, attn "
                         f"{tuple(attn.shape)}, ck {tuple(ck.shape)}, cv "
                         f"{tuple(cv.shape)}, wa {tuple(wa.shape)}, w2 "
                         f"{tuple(w2.shape)} for {heads}x{head_dim}")
    args = (x, attn, ck, cv, wo, bo, n2s, n2b, wq2, wo2, bo2, n3s, n3b, wa,
            wg, ba, bg, w2, b2)
    if _on_cpu(x, attn, ck, cv, wo, wa):
        xm = post_cross_reference(*args[:11], heads=heads, head_dim=head_dim)
        return geglu_ff_reference(xm.reshape(b * s, c), *args[11:]).reshape(
            b, s, c), xm
    _check("post_ff",
           [(x, (b, s, c)), (attn, (b, s, c)), (ck, (b, t, c)),
            (cv, (b, t, c)), (wo, (c, c)), (wq2, (c, c)), (wo2, (c, c)),
            (wa, (c, f)), (wg, (c, f)), (w2, (f, c))],
           [(v, (c,)) for v in (bo, n2s, n2b, bo2, n3s, n3b, b2)]
           + [(ba, (f,)), (bg, (f,))])
    _refuse(kernel_refusal("post_ff", c, t=t, head_dim=head_dim, f=f))
    r, sms = b * s, sm_count(x.device.index)
    x1, o, xm, out = (torch.empty_like(x) for _ in range(4))
    lib = _build.load()
    with torch.cuda.device(x.device):
        rc = lib.rdm_post_ff(
            *(_p(a) for a in args), _p(x1), _p(o), _p(xm), _p(out), r, s, c,
            t, f, head_dim, head_dim ** -0.5,
            *gemm_plan("residual", r, c, c, sms).args,
            *gemm_plan("cross", r, c, c, sms).args,
            *ff_plan(c, f, rows=r,
                     capacity=ff_capacity(x.device.index)).args,
            _stream(x))
    _build.check(rc, "post_ff")
    post_ff.launches += 1
    return out, xm


post_ff.launches = 0


# ------------------------------------------------------------ int8 math
#
# The int8 serving variants (`block_kernel.py:81-122, 140-150, 193-259,
# 397-420, 456-497` in rdm_tpu). Weights: int8 per output column
# (`quantize_cols`), stored [out, in] for the kernels' mma B operand.
# Activations: the kernels quantize by MULTIPLYING with 1 / a, a the
# calibrated static scale absmax / 127 (no floor); round half to even,
# clip to +-127. Dequantization multiplies the int32 sum by (a * w_scale),
# the product formed first.

QSCALE_NAMES = ("a_qkv", "o_attn1", "a_attn2", "o_attn2", "a_ff", "h_ff")
_INT8_WEIGHTS = ("wqkv", "wo", "wq2", "wo2", "wa", "wg", "w2")
_Q8_BLOCK = 512  # q rows per scale cell of the int8 attention core


def quantize_cols(w: torch.Tensor):
    """[K, N] weights -> (int8 codes [K, N], f32 per-column scale [N]).
    All-zero columns get scale 1e-12 / 127 and zero codes."""
    wf = w.float()
    s = wf.abs().amax(dim=0).clamp_min(1e-12) / 127.0
    q = torch.clamp(torch.round(wf / s), -127.0, 127.0).to(torch.int8)
    return q, s


def act_scale(absmax) -> float:
    """Static activation scale absmax / 127 in f32, no floor."""
    return float(np.float32(float(absmax)) / np.float32(127.0))


def quantize_act(h: torch.Tensor, a: float) -> torch.Tensor:
    """Activations -> int8 with the static scale a: round(h * (1 / a))."""
    inv = 1.0 / torch.tensor(a, dtype=torch.float32, device=h.device)
    return torch.clamp(torch.round(h.float() * inv), -127.0,
                       127.0).to(torch.int8)


def _int_matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """int8 a [M, K] x int8 w [N, K] (out, in) -> exact int32 [M, N]."""
    return torch._int_mm(a, w.t())


def _qdot(h, w, ws, a: float) -> torch.Tensor:
    """Quantize h, int8 x int8 -> int32, dequantize: [M, N] f32."""
    y = _int_matmul(quantize_act(h, a), w).float()
    return y * (torch.tensor(a, dtype=torch.float32, device=h.device) * ws)


def ln_qkv_q_reference(x2, n1s, n1b, wqkv, ws, a: float):
    """x2 [R, C] -> (q, k, v) each [R, C]; wqkv int8 [3C, C], ws [3C]."""
    c = x2.shape[1]
    qkv = _qdot(layer_norm(x2, n1s, n1b), wqkv, ws, a).to(x2.dtype)
    return qkv[:, :c], qkv[:, c:2 * c], qkv[:, 2 * c:]


def _q8_block_rows(s: int) -> int:
    """Query rows per scale cell: the TPU grid's q-block (whole S up to
    512, else 512 halved until it divides S)."""
    bq = min(_Q8_BLOCK, s)
    while s % bq:
        bq //= 2
    return bq


def _absmax_scale(t: torch.Tensor) -> torch.Tensor:
    """Per-image max(absmax, 1e-12) / 127 over all but the batch dim."""
    return t.abs().amax(dim=tuple(range(1, t.ndim))).clamp_min(1e-12) / 127.0


def _codes(t: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """round(t / s) clipped to +-127, as f64 codes (exact in matmuls)."""
    shp = (-1,) + (1,) * (t.ndim - 1)
    return torch.clamp(torch.round(t / s.reshape(shp)), -127.0,
                       127.0).double()


def packed_attn_q8_reference(q, k, v, *, heads: int, head_dim: int):
    """q/k/v [B, S, C] -> [B, S, C]: the int8 attention core. Dynamic
    absmax scales per (image, 128-channel group, q-block of
    `_q8_block_rows`) for q and per (image, group) for k and v, as the TPU
    grid cells take them (a group is 4 heads of 32; the last one may hold
    fewer); int8 q k^T, exp2 softmax over the whole row in f32, p
    quantized as round(127 p), int8 p v, divided by the f32 denominator."""
    b, s, c = q.shape
    scale = head_dim ** -0.5
    bq = _q8_block_rows(s)
    out = torch.empty_like(q)
    for g0 in range(0, c, 128):
        g1 = min(g0 + 128, c)
        kg, vg = k[..., g0:g1].float(), v[..., g0:g1].float()
        ks, vs = _absmax_scale(kg), _absmax_scale(vg)
        kq, vq = _codes(kg, ks), _codes(vg, vs)
        for q0 in range(0, s, bq):
            qg = q[:, q0:q0 + bq, g0:g1].float()
            qs = _absmax_scale(qg)
            qq = _codes(qg, qs)
            c_s = (qs * ks * scale * _LOG2E)[:, None, None]
            c_v = (vs / 127.0)[:, None, None]
            for h0 in range(0, g1 - g0, head_dim):
                hs = slice(h0, h0 + head_dim)
                sc = (qq[..., hs] @ kq[..., hs].transpose(1, 2)).float()
                sc = sc * c_s
                p = torch.exp2(sc - sc.amax(dim=-1, keepdim=True))
                den = p.sum(dim=-1, keepdim=True)
                pq = torch.round(p * 127.0).double()
                pv = (pq @ vq[..., hs]).float() * c_v
                out[:, q0:q0 + bq, g0 + h0:g0 + h0 + head_dim] = (
                    pv * (1.0 / den)).to(q.dtype)
    return out


def _cross_attention_f32(q2, ck, cv, heads: int, head_dim: int):
    """Per-head softmax(q2 ck^T d^-1/2) cv over the T context tokens, as
    `ops.attention` computes it (f32 scores and softmax, probabilities in
    the activation dtype) but with the output kept in f32."""
    b, s, c = q2.shape
    t = ck.shape[1]
    sc = torch.einsum("bshd,bthd->bhst",
                      q2.reshape(b, s, heads, head_dim).float(),
                      ck.reshape(b, t, heads, head_dim).float())
    p = torch.softmax(sc * head_dim ** -0.5, dim=-1).to(q2.dtype).float()
    o = torch.einsum("bhst,bthd->bshd", p,
                     cv.reshape(b, t, heads, head_dim).float())
    return o.reshape(b, s, c)


def post_cross_q_reference(x, attn, ck, cv, wo, wso, bo, n2s, n2b, wq2, wsq2,
                           wo2, wso2, bo2, a_o1: float, a_a2: float,
                           a_o2: float, *, heads: int, head_dim: int):
    """The int8 `post_cross`: wo / wq2 / wo2 int8 [C, C] (out, in) with
    scales o_attn1 / a_attn2 / o_attn2; the cross-attention output is
    quantized from f32 (the bf16 kernel rounds it to bf16 first)."""
    b, s, c = x.shape
    r = b * s
    dt = x.dtype
    x1 = x + (_qdot(attn.reshape(r, c), wo, wso, a_o1) + bo).to(dt).reshape(
        b, s, c)
    q2 = _qdot(layer_norm(x1, n2s, n2b).reshape(r, c), wq2, wsq2,
               a_a2).to(dt)
    o = _cross_attention_f32(q2.reshape(b, s, c), ck, cv, heads, head_dim)
    return x1 + (_qdot(o.reshape(r, c), wo2, wso2, a_o2) + bo2).to(
        dt).reshape(b, s, c)


def geglu_ff_q_reference(xm2, n3s, n3b, wa, wsa, wg, wsg, ba, bg, w2, ws2,
                         b2, a_ff: float, h_ff: float):
    """The int8 `geglu_ff`: LN3 output quantized once (a_ff), wa / wg int8
    [F, C], the gated hidden kept f32 and quantized with h_ff, w2 int8
    [C, F]."""
    h3 = quantize_act(layer_norm(xm2, n3s, n3b), a_ff)
    a3 = torch.tensor(a_ff, dtype=torch.float32, device=xm2.device)
    av = _int_matmul(h3, wa).float() * (a3 * wsa) + ba
    gv = _int_matmul(h3, wg).float() * (a3 * wsg) + bg
    f = av * (0.5 * gv * (1.0 + torch.erf(gv * 0.7071067811865476)))
    return xm2 + (_qdot(f, w2, ws2, h_ff) + b2).to(xm2.dtype)


# --------------------------------------------------------- int8 wrappers

def ln_qkv_q(x2, n1s, n1b, wqkv, ws, a: float):
    """int8 LN1 + q/k/v projection: x2 [R, C] -> (q, k, v) each [R, C]. On
    CUDA one s8 launch of the block-GEMM core."""
    r, c = x2.shape
    if wqkv.shape != (3 * c, c) or ws.shape != (3 * c,):
        raise ValueError(f"ln_qkv_q: wqkv {tuple(wqkv.shape)}, ws "
                         f"{tuple(ws.shape)} for C={c}")
    if _on_cpu(x2, wqkv):
        return ln_qkv_q_reference(x2, n1s, n1b, wqkv, ws, a)
    _check("ln_qkv_q", [(x2, (r, c))], [(n1s, (c,)), (n1b, (c,)),
                                        (ws, (3 * c,))],
           i8=[(wqkv, (3 * c, c))])
    _refuse(kernel_refusal("ln_qkv_q", c))
    q, k, v = (torch.empty_like(x2) for _ in range(3))
    plan = gemm_plan("qkv8", r, 3 * c, c, sm_count(x2.device.index))
    lib = _build.load()
    with torch.cuda.device(x2.device):
        rc = lib.rdm_ln_qkv_q(_p(x2), _p(n1s), _p(n1b), _p(wqkv), _p(ws),
                              _p(q), _p(k), _p(v), r, c, a, *plan.args,
                              _stream(x2))
    _build.check(rc, "ln_qkv_q")
    ln_qkv_q.launches += 1
    return q, k, v


ln_qkv_q.launches = 0


def packed_attn_q8(q, k, v, *, heads: int, head_dim: int):
    """int8 self-attention core: q/k/v [B, S, C] -> [B, S, C]. On CUDA
    three launches (the per-cell absmax scales; the codes, q and k [B, S,
    C] and v transposed [B, C, S'] with S' = S rounded up to 64; the
    attention, s8 wgmma over the codes), counted as one call; the scales
    and codes live in one scratch tensor allocated here."""
    b, s, c = q.shape
    if heads * head_dim != c or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"packed_attn_q8: q/k/v {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)} for "
                         f"{heads}x{head_dim}")
    if _on_cpu(q, k, v):
        return packed_attn_q8_reference(q, k, v, heads=heads,
                                        head_dim=head_dim)
    _check("packed_attn_q8", [(a, (b, s, c)) for a in (q, k, v)])
    _refuse(kernel_refusal("packed_attn_q8", c, head_dim=head_dim))
    bq = _q8_block_rows(s)
    groups, sp = -(-c // 128), -(-s // 64) * 64
    # per (image, 128-channel group): the q, k, v maxima of each 64 rows,
    # then the f32 absmax of q per q-block, of k, of v (each region
    # 128-byte aligned); the q and k codes; v's transposed codes
    sizes = (_a128(b * groups * sp // 64 * 3 * 4),
             _a128(b * groups * (s // bq + 2) * 4), b * s * c, b * s * c,
             b * c * sp)
    scratch = torch.empty(sum(sizes), dtype=torch.int8, device=q.device)
    ptrs = _p(scratch) + np.cumsum((0,) + sizes[:-1])
    o = torch.empty_like(q)
    lib = _build.load()
    with torch.cuda.device(q.device):
        rc = lib.rdm_packed_attn_q8(_p(q), _p(k), _p(v),
                                    *(int(x) for x in ptrs), _p(o), b, s,
                                    heads, head_dim, bq, head_dim ** -0.5,
                                    _stream(q))
    _build.check(rc, "packed_attn_q8")
    packed_attn_q8.launches += 1
    return o


packed_attn_q8.launches = 0


def post_cross_q(x, attn, ck, cv, wo, wso, bo, n2s, n2b, wq2, wsq2, wo2,
                 wso2, bo2, a_o1: float, a_a2: float, a_o2: float, *,
                 heads: int, head_dim: int):
    """int8 out-proj + LN2 + cross-attention + out-proj: x, attn [B, S, C],
    ck, cv [B, T, C] -> xmid [B, S, C]. On CUDA three s8 launches of the
    block-GEMM core (x1 in bf16 and the cross-attention's codes [R, C]
    between them, scratch allocated here), counted as one call."""
    b, s, c = x.shape
    t = ck.shape[1]
    if (attn.shape != x.shape or ck.shape != (b, t, c)
            or cv.shape != ck.shape or heads * head_dim != c):
        raise ValueError(f"post_cross_q: x {tuple(x.shape)}, attn "
                         f"{tuple(attn.shape)}, ck {tuple(ck.shape)}, cv "
                         f"{tuple(cv.shape)} for {heads}x{head_dim}")
    args = (x, attn, ck, cv, wo, wso, bo, n2s, n2b, wq2, wsq2, wo2, wso2,
            bo2, a_o1, a_a2, a_o2)
    if _on_cpu(x, attn, ck, cv, wo):
        return post_cross_q_reference(*args, heads=heads, head_dim=head_dim)
    _check("post_cross_q",
           [(x, (b, s, c)), (attn, (b, s, c)), (ck, (b, t, c)),
            (cv, (b, t, c))],
           [(p, (c,)) for p in (wso, bo, n2s, n2b, wsq2, wso2, bo2)],
           i8=[(wo, (c, c)), (wq2, (c, c)), (wo2, (c, c))])
    _refuse(kernel_refusal("post_cross_q", c, t=t, head_dim=head_dim))
    r, sms = b * s, sm_count(x.device.index)
    x1, out = torch.empty_like(x), torch.empty_like(x)
    o8 = torch.empty((r, c), dtype=torch.int8, device=x.device)
    lib = _build.load()
    with torch.cuda.device(x.device):
        rc = lib.rdm_post_cross_q(
            _p(x), _p(attn), _p(ck), _p(cv), _p(wo), _p(wso), _p(bo),
            _p(n2s), _p(n2b), _p(wq2), _p(wsq2), _p(wo2), _p(wso2), _p(bo2),
            _p(x1), _p(o8), _p(out), r, s, c, t, head_dim, a_o1, a_a2,
            a_o2, head_dim ** -0.5, *gemm_plan("resq8", r, c, c, sms).args,
            *gemm_plan("cross8", r, c, c, sms).args,
            *gemm_plan("residual8", r, c, c, sms).args, _stream(x))
    _build.check(rc, "post_cross_q")
    post_cross_q.launches += 1
    return out


post_cross_q.launches = 0


def geglu_ff_q(xm2, n3s, n3b, wa, wsa, wg, wsg, ba, bg, w2, ws2, b2,
               a_ff: float, h_ff: float, hidden=None):
    """int8 LN3 + GEGLU FF + residual: xm2 [R, C] -> [R, C]. On CUDA two
    s8 launches of the block-GEMM core (gated up-projection into the int8
    hidden codes [R, F], then down-projection + residual), counted as one
    call; `hidden`, an int8 [R, F] buffer, keeps the codes for
    inspection."""
    r, c = xm2.shape
    f = wa.shape[0]
    if wa.shape != (f, c) or wg.shape != (f, c) or w2.shape != (c, f):
        raise ValueError(f"geglu_ff_q: wa {tuple(wa.shape)}, wg "
                         f"{tuple(wg.shape)}, w2 {tuple(w2.shape)} for "
                         f"C={c}")
    args = (xm2, n3s, n3b, wa, wsa, wg, wsg, ba, bg, w2, ws2, b2, a_ff, h_ff)
    if _on_cpu(xm2, wa):
        return geglu_ff_q_reference(*args)
    _check("geglu_ff_q", [(xm2, (r, c))],
           [(n3s, (c,)), (n3b, (c,)), (wsa, (f,)), (wsg, (f,)), (ba, (f,)),
            (bg, (f,)), (ws2, (c,)), (b2, (c,))],
           i8=[(wa, (f, c)), (wg, (f, c)), (w2, (c, f))])
    _refuse(kernel_refusal("geglu_ff_q", c, f=f))
    if hidden is None:
        hidden = torch.empty((r, f), dtype=torch.int8, device=xm2.device)
    _check("geglu_ff_q", [(xm2, (r, c))], i8=[(hidden, (r, f))])
    y = torch.empty_like(xm2)
    sms = sm_count(xm2.device.index)
    lib = _build.load()
    with torch.cuda.device(xm2.device):
        rc = lib.rdm_geglu_ff_q(
            _p(xm2), _p(n3s), _p(n3b), _p(wa), _p(wsa), _p(wg), _p(wsg),
            _p(ba), _p(bg), _p(w2), _p(ws2), _p(b2), _p(hidden), _p(y), r,
            c, f, a_ff, h_ff, *gemm_plan("geglu8", r, f, c, sms).args,
            *gemm_plan("residual8", r, c, f, sms).args, _stream(xm2))
    _build.check(rc, "geglu_ff_q")
    geglu_ff_q.launches += 1
    return y


geglu_ff_q.launches = 0

KERNELS = (ln_qkv, packed_attn, post_cross, geglu_ff, post_ff)
INT8_KERNELS = (ln_qkv_q, packed_attn_q8, post_cross_q, geglu_ff_q)


def reset_launch_counts() -> None:
    for fn in KERNELS + INT8_KERNELS:
        fn.launches = 0


def launch_counts() -> Dict[str, int]:
    return {fn.__name__: fn.launches for fn in KERNELS + INT8_KERNELS}


def use_split_k3() -> bool:
    """Kernels 3 and 4 as two launches (post_cross, geglu_ff), read from
    RDM_TPU_SPLIT_K3 as the JAX package reads it; default on, 0 runs
    post_ff (the JAX package's single kernel 3) instead."""
    return os.environ.get("RDM_TPU_SPLIT_K3", "1") != "0"


def use_int8_attn_core() -> bool:
    """The int8 attention core inside the int8 serving mode, read from
    RDM_TPU_INT8_ATTN as the JAX package reads it; default off."""
    return os.environ.get("RDM_TPU_INT8_ATTN", "0") == "1"


# ------------------------------------------------------------ the block

def pack_block_weights(block, dtype: torch.dtype, *,
                       differentiable: bool = False
                       ) -> Dict[str, torch.Tensor]:
    """Kernel-layout weights of a reference-layout TransformerBlock
    (models.layers): projections transposed to [in, out] and cast to
    `dtype`, q/k/v fused into one [C, 3C] matrix, the GEGLU projection
    split into its value and gate halves; norms and biases f32.

    The inference snapshot is detached. `differentiable=True` keeps the
    autograd graph from the live parameters through the transposes,
    concatenation, split and casts (the training path,
    `fused_transformer_block_ad`, packs that way on every call)."""
    a1, a2, ff = block.attn1, block.attn2, block.ff.net
    ffd = ff[2].weight.shape[1]
    w1 = ff[0].proj.weight
    live = (lambda p: p) if differentiable else (lambda p: p.detach())

    def t(w):
        return live(w).t().to(dtype).contiguous()

    def f32(p):
        return live(p).float().contiguous()

    return dict(
        n1s=f32(block.norm1.weight), n1b=f32(block.norm1.bias),
        wqkv=torch.cat([t(a1.to_q.weight), t(a1.to_k.weight),
                        t(a1.to_v.weight)], dim=1).contiguous(),
        wo=t(a1.to_out[0].weight), bo=f32(a1.to_out[0].bias),
        n2s=f32(block.norm2.weight), n2b=f32(block.norm2.bias),
        wq2=t(a2.to_q.weight), wk2=t(a2.to_k.weight),
        wv2=t(a2.to_v.weight),
        wo2=t(a2.to_out[0].weight), bo2=f32(a2.to_out[0].bias),
        n3s=f32(block.norm3.weight), n3b=f32(block.norm3.bias),
        wa=t(w1[:ffd]), wg=t(w1[ffd:]),
        ba=f32(ff[0].proj.bias[:ffd]), bg=f32(ff[0].proj.bias[ffd:]),
        w2=t(ff[2].weight), b2=f32(ff[2].bias),
    )


def quantize_block_weights(w: Dict[str, torch.Tensor]
                           ) -> Dict[str, torch.Tensor]:
    """The int8 kernels' weights, added once to a `pack_block_weights`
    dict (the JAX package quantizes inside the block and XLA hoists it out
    of the sampling scan): `<name>_q` int8 [out, in] and `<name>_s` f32
    [out] for each projection, from the packed compute-dtype weights."""
    out = dict(w)
    for name in _INT8_WEIGHTS:
        codes, scale = quantize_cols(w[name])
        out[name + "_q"] = codes.t().contiguous()
        out[name + "_s"] = scale.contiguous()
    return out


def context_kv(context: torch.Tensor, w: Dict[str, torch.Tensor]):
    """The cross-attention's k / v [B, T, C] of a context [B, T, Dc] (in
    the compute dtype): torch matmuls, as XLA kept them in JAX
    (models/layers.py FusedTransformerBlock), differentiable where the
    weights are."""
    b, t, dc = context.shape
    ctx2 = context.reshape(b * t, dc)
    return (_linear(ctx2, w["wk2"]).reshape(b, t, -1),
            _linear(ctx2, w["wv2"]).reshape(b, t, -1))


def _block_kernels(x: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
                   w: Dict[str, torch.Tensor], heads: int, head_dim: int,
                   split_k3: bool) -> torch.Tensor:
    """The bf16 block's kernel sequence over pre-projected context k / v:
    ln_qkv, packed_attn, then post_cross + geglu_ff (split_k3) or
    post_ff."""
    b, s, c = x.shape
    q, k, v = ln_qkv(x.reshape(b * s, c), w["n1s"], w["n1b"], w["wqkv"])
    attn = packed_attn(q.reshape(b, s, c), k.reshape(b, s, c),
                       v.reshape(b, s, c), heads=heads, head_dim=head_dim)
    if not split_k3:
        return post_ff(x, attn, ck, cv, w["wo"], w["bo"], w["n2s"],
                       w["n2b"], w["wq2"], w["wo2"], w["bo2"], w["n3s"],
                       w["n3b"], w["wa"], w["wg"], w["ba"], w["bg"],
                       w["w2"], w["b2"], heads=heads, head_dim=head_dim)
    xmid = post_cross(x, attn, ck, cv, w["wo"], w["bo"], w["n2s"],
                      w["n2b"], w["wq2"], w["wo2"], w["bo2"],
                      heads=heads, head_dim=head_dim)
    y = geglu_ff(xmid.reshape(b * s, c), w["n3s"], w["n3b"], w["wa"],
                 w["wg"], w["ba"], w["bg"], w["w2"], w["b2"])
    return y.reshape(b, s, c)


def fused_transformer_block(x: torch.Tensor, context: torch.Tensor,
                            w: Dict[str, torch.Tensor], *, heads: int,
                            head_dim: int, qscales=None,
                            split_k3: Optional[bool] = None) -> torch.Tensor:
    """One pre-LN transformer block through the four kernels (three with
    split_k3 off: `post_ff` for `post_cross` + `geglu_ff`; None reads
    `use_split_k3()`), for inference.

    x [B, S, C], context [B, T, Dc] (both in the compute dtype), w from
    `pack_block_weights`. The context k/v projections stay torch matmuls
    (`context_kv`).

    qscales (int8 serving): the calibrated activation absmax keyed by
    `QSCALE_NAMES`; the block then runs the four int8 kernels on the
    weights of `quantize_block_weights(w)` (the attention core stays the
    bf16 one unless `use_int8_attn_core()`; the split pair always runs, as
    in JAX).

    On the card the block first asks `block_refusal` and raises with its
    answer, before any kernel is launched."""
    b, s, c = x.shape
    if split_k3 is None:
        split_k3 = use_split_k3()
    if x.is_cuda:
        _refuse(block_refusal(c, context.shape[1], heads, head_dim,
                              w["w2"].shape[0], int8=qscales is not None,
                              split_k3=split_k3))
    ck, cv = context_kv(context, w)
    x = x.contiguous()
    if qscales is None:
        return _block_kernels(x, ck, cv, w, heads, head_dim, split_k3)
    x2 = x.reshape(b * s, c)
    a = {k: act_scale(qscales[k]) for k in QSCALE_NAMES}
    q, k, v = ln_qkv_q(x2, w["n1s"], w["n1b"], w["wqkv_q"], w["wqkv_s"],
                       a["a_qkv"])
    core = packed_attn_q8 if use_int8_attn_core() else packed_attn
    attn = core(q.reshape(b, s, c), k.reshape(b, s, c), v.reshape(b, s, c),
                heads=heads, head_dim=head_dim)
    xmid = post_cross_q(x, attn, ck, cv, w["wo_q"], w["wo_s"], w["bo"],
                        w["n2s"], w["n2b"], w["wq2_q"], w["wq2_s"],
                        w["wo2_q"], w["wo2_s"], w["bo2"], a["o_attn1"],
                        a["a_attn2"], a["o_attn2"], heads=heads,
                        head_dim=head_dim)
    y = geglu_ff_q(xmid.reshape(b * s, c), w["n3s"], w["n3b"], w["wa_q"],
                   w["wa_s"], w["wg_q"], w["wg_s"], w["ba"], w["bg"],
                   w["w2_q"], w["w2_s"], w["b2"], a["a_ff"], a["h_ff"])
    return y.reshape(b, s, c)


# ------------------------------------------------- the block in training
#
# The JAX package's `fused_transformer_block_ad` (a jax.custom_vjp): the
# forward is the block kernels, the backward the gradient of an unfused
# block over the same packed weights (`block_reference`), recomputed from
# the saved inputs alone. bf16 only on the card; no int8, no dropout.

# the packed weights the block reads (the context's wk2 / wv2 are applied
# before it, by `context_kv`)
_BLOCK_KEYS = ("n1s", "n1b", "wqkv", "wo", "bo", "n2s", "n2b", "wq2",
               "wo2", "bo2", "n3s", "n3b", "wa", "wg", "ba", "bg", "w2", "b2")


def block_reference(x: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
                    w: Dict[str, torch.Tensor], *, heads: int,
                    head_dim: int) -> torch.Tensor:
    """The unfused block over `pack_block_weights`' dict, differentiable
    in x, ck, cv and every weight: the port's `_xla_block_reference`.
    Flattened [B S, C] products in x's dtype (f32 sums), biases added in
    f32 before the cast back, f32 LayerNorm statistics, attention with
    f32 scores and softmax (the plain path: no flash kernel), the GEGLU's
    pre-activations and exact-erf gelu in f32."""
    b, s, c = x.shape
    t = ck.shape[1]
    dt = x.dtype

    def mm(a, wt, bias=None):
        y = a @ wt.to(dt)
        return y if bias is None else (y.float() + bias).to(dt)

    def attend(q, k, v, n):
        o = dot_product_attention(
            q.reshape(b, s, heads, head_dim), k.reshape(b, n, heads, head_dim),
            v.reshape(b, n, heads, head_dim), impl="xla")
        return o.reshape(b * s, c)

    x2 = x.reshape(b * s, c)
    qkv = mm(layer_norm(x2, w["n1s"], w["n1b"]), w["wqkv"])
    a1 = attend(qkv[:, :c], qkv[:, c:2 * c], qkv[:, 2 * c:], s)
    x1 = x2 + mm(a1, w["wo"], w["bo"])
    q2 = mm(layer_norm(x1, w["n2s"], w["n2b"]), w["wq2"])
    x1 = x1 + mm(attend(q2, ck, cv, t), w["wo2"], w["bo2"])
    h3 = layer_norm(x1, w["n3s"], w["n3b"])
    a = (h3 @ w["wa"].to(dt)).float() + w["ba"]
    g = (h3 @ w["wg"].to(dt)).float() + w["bg"]
    f = (a * F.gelu(g)).to(dt)
    return (x1 + mm(f, w["w2"], w["b2"])).reshape(b, s, c)


class _FusedBlockAD(torch.autograd.Function):
    """Forward: the block kernels (their plain versions on the CPU).
    Backward: torch.autograd.grad of `block_reference` from the saved
    (x, ck, cv, weights) alone, as the JAX custom_vjp recomputes."""

    @staticmethod
    def forward(ctx, x, ck, cv, heads: int, head_dim: int, split_k3: bool,
                *ws):
        ctx.save_for_backward(x, ck, cv, *ws)
        ctx.heads, ctx.head_dim = heads, head_dim
        return _block_kernels(x, ck, cv, dict(zip(_BLOCK_KEYS, ws)), heads,
                              head_dim, split_k3)

    @staticmethod
    def backward(ctx, g):
        need = ctx.needs_input_grad
        flags = need[:3] + need[6:]
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(f)
                   for t, f in zip(ctx.saved_tensors, flags)]
            y = block_reference(ins[0], ins[1], ins[2],
                                dict(zip(_BLOCK_KEYS, ins[3:])),
                                heads=ctx.heads, head_dim=ctx.head_dim)
            grads = iter(torch.autograd.grad(
                y, [t for t in ins if t.requires_grad], g))
        out = [next(grads) if f else None for f in flags]
        return (*out[:3], None, None, None, *out[3:])


def fused_transformer_block_ad(x: torch.Tensor, ck: torch.Tensor,
                               cv: torch.Tensor, w: Dict[str, torch.Tensor],
                               *, heads: int, head_dim: int
                               ) -> torch.Tensor:
    """Differentiable fused block (the training path): x [B, S, C], ck / cv
    [B, T, C] from `context_kv`, w from `pack_block_weights(...,
    differentiable=True)`. The forward is `fused_transformer_block`'s
    kernel sequence (`post_ff` under RDM_TPU_SPLIT_K3=0), the backward
    `block_reference`'s gradient. On the card `block_refusal` raises
    before the first launch."""
    b, s, c = x.shape
    split_k3 = use_split_k3()
    if x.is_cuda:
        _refuse(block_refusal(c, ck.shape[1], heads, head_dim,
                              w["w2"].shape[0], int8=False,
                              split_k3=split_k3))
    return _FusedBlockAD.apply(x.contiguous(), ck.contiguous(),
                               cv.contiguous(), heads, head_dim, split_k3,
                               *(w[k] for k in _BLOCK_KEYS))
