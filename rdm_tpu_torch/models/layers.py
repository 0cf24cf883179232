"""Neural building blocks of the RDM U-Net, in PyTorch.

Counterpart of `rdm_tpu/models/layers.py`. Modules keep the reference torch
state-dict names (`openaimodel.py` ResBlock / Upsample / Downsample,
`attention.py` CrossAttention / BasicTransformerBlock / SpatialTransformer),
so `rdm_tpu.utils.torch_convert.convert_unet` maps a port state dict onto
the JAX tree. Images are NCHW. Parameters may be stored in a lower
precision than f32 (see `pipeline.cast_params_for_inference`); every module
casts them to the activation dtype at use, and normalisations keep f32
statistics with dtype-native arithmetic, as the JAX modules do.

SpatialTransformer routes its blocks through the fused block kernels
(`ops/block_kernel.fused_transformer_block`) in eval mode whenever a
context is given, as the JAX package routes them: except while calibrating
for int8 (`ops/quant.py`), under RDM_TPU_FUSED_BLOCK=0 and for heads whose
width does not divide 128. In train mode it routes them so only with
RDM_TPU_FUSED_BLOCK_TRAIN=1 (default off, as in JAX) and dropout 0,
through `fused_transformer_block_ad` (the kernels forward, the unfused
block's gradient backward) on weights packed from the live parameters at
every call. A fused block whose shapes the kernels do not take raises on
the card before its first launch (`block_refusal`). Every other block
runs `TransformerBlock.forward`, the unfused differentiable math the
kernels are held against, whose self-attention takes the flash kernels
(`ops/attention.py`) where their gate admits it.
`Conv2d`, `CrossAttention` and `GEGLUFeedForward` record activation
absmax for that calibration, and `Conv2d` and `TransformerBlock` carry the
int8 serving state (`layers.QuantizableConv` and the "quant" collection of
the JAX package).
"""

from __future__ import annotations

import math
import os
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from rdm_tpu_torch.ops import quant
from rdm_tpu_torch.ops.attention import dot_product_attention
from rdm_tpu_torch.ops.block_kernel import (QSCALE_NAMES, context_kv,
                                            fused_transformer_block,
                                            fused_transformer_block_ad,
                                            layer_norm, pack_block_weights,
                                            quantize_block_weights,
                                            quantize_cols)


def quantize_to_int8(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Symmetric int8 by DIVISION with the f32 scale, round half to even,
    clipped to +-127 (`layers.quantize_to_int8` in rdm_tpu)."""
    return torch.clamp(torch.round(x.float() / scale), -127.0,
                       127.0).to(torch.int8)


def _conv_geometry(conv: nn.Conv2d, h: int, w: int):
    (kh, kw), (sh, sw), (ph, pw) = conv.kernel_size, conv.stride, conv.padding
    return (h + 2 * ph - kh) // sh + 1, (w + 2 * pw - kw) // sw + 1


def int8_conv2d(x: torch.Tensor, conv: "Conv2d") -> torch.Tensor:
    """conv's int8 convolution of x [B, C, H, W] (compute dtype): int32
    [B*Ho*Wo, O], rows in (b, y, x) order. im2col of the input in its own
    dtype (F.unfold does not take int8 on every device; quantization is
    elementwise and the zero padding quantizes to 0, so quantizing after
    the unfold is exact), then int8 x int8 -> int32 `torch._int_mm` (on
    CUDA it needs more than 16 rows and K, O multiples of 8)."""
    b, c, h, w = x.shape
    o = conv.out_channels
    if conv.kernel_size == (1, 1) and conv.stride == (1, 1) \
            and conv.padding == (0, 0):
        cols = x.permute(0, 2, 3, 1).reshape(-1, c)
    else:
        cols = F.unfold(x, conv.kernel_size, padding=conv.padding,
                        stride=conv.stride)                # [B, K, L]
        cols = cols.transpose(1, 2).reshape(-1, cols.shape[1])
    m, k = cols.shape
    if x.is_cuda and (m <= 16 or k % 8 or o % 8):
        raise ValueError(f"int8 conv on CUDA needs > 16 rows and K, O "
                         f"multiples of 8 (got {m} rows, K={k}, O={o})")
    xq = quantize_to_int8(cols, conv.act_scale)
    return torch._int_mm(xq, conv.qweight.reshape(o, k).t())


def int8_conv2d_reference(x: torch.Tensor, conv: "Conv2d") -> torch.Tensor:
    """Plain version of `int8_conv2d`: the quantized input convolved with
    the int8 codes in float64 (exact: every partial sum is an integer
    below 2^53), same [B*Ho*Wo, O] int32 result."""
    xq = quantize_to_int8(x, conv.act_scale).double()
    y = F.conv2d(xq, conv.qweight.double(), stride=conv.stride,
                 padding=conv.padding)
    return y.permute(0, 2, 3, 1).reshape(-1, conv.out_channels).to(
        torch.int32)


class Conv2d(nn.Conv2d):
    """nn.Conv2d whose parameters are cast to the input dtype at use, with
    the int8 serving state of `layers.QuantizableConv`.

    While calibrating (`ops.quant.calibrate()`) a quantizable conv records
    the max |x| of its input. `quantize(absmax)` gives it int8 weights
    `qweight` [O, I, kh, kw] with per-output-channel scales `kernel_scale`
    [O] f32 and the static input scale `act_scale` (f32 scalar); from then
    on it runs `int8_conv2d` and dequantizes y = acc * (act_scale *
    kernel_scale) + bias, cast to the input dtype. The three buffers ride
    in the state dict once set. `quantizable = False` marks a conv the
    JAX package builds as a plain nn.Conv (the U-Net's Downsample)."""

    quantizable = True
    _QKEYS = ("qweight", "kernel_scale", "act_scale")

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        for name in self._QKEYS:
            self.register_buffer(name, None)

    def quantize(self, absmax: torch.Tensor) -> None:
        """Per-output-channel int8 weights and the static activation scale
        from a calibrated input absmax (both floored at 1e-12)."""
        w = self.weight.detach()
        codes, self.kernel_scale = quantize_cols(w.reshape(len(w), -1).t())
        self.qweight = codes.t().reshape(w.shape).contiguous()
        self.act_scale = torch.as_tensor(
            absmax, dtype=torch.float32,
            device=w.device).clamp_min(1e-12) / 127.0

    def _load_from_state_dict(self, state_dict, prefix, *args):
        for name in self._QKEYS:
            t = state_dict.get(prefix + name)
            if t is not None:  # a slot for the base class to fill
                setattr(self, name, torch.empty_like(t))
        super()._load_from_state_dict(state_dict, prefix, *args)

    def forward(self, x):
        if self.qweight is not None:
            b, _, h, w = x.shape
            ho, wo = _conv_geometry(self, h, w)
            y = int8_conv2d(x, self).float() * (
                self.act_scale * self.kernel_scale) + self.bias.float()
            return y.to(x.dtype).reshape(b, ho, wo, -1).permute(
                0, 3, 1, 2).contiguous()
        if self.quantizable:
            quant.record(self, "act_absmax", x)
        b = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), b)


class Linear(nn.Linear):
    """nn.Linear whose parameters are cast to the input dtype at use."""

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), b)


class GroupNorm32(nn.Module):
    """GroupNorm with f32 statistics and dtype-native arithmetic
    (`_RawGroupNorm`): gcd(32, C) groups, so tiny test widths are valid."""

    def __init__(self, channels: int, eps: float = 1e-5,
                 num_groups: int = 32):
        super().__init__()
        self.num_groups = math.gcd(num_groups, channels)
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):  # x [B, C, *spatial]
        b, c = x.shape[:2]
        g = self.num_groups
        xf = x.float().reshape(b, g, -1)
        mean = xf.mean(-1)                                   # [B, g]
        var = ((xf * xf).mean(-1) - mean * mean).clamp_min(0.0)
        inv = torch.rsqrt(var + self.eps)
        mean_c = mean.repeat_interleave(c // g, dim=1)       # [B, C]
        inv_c = inv.repeat_interleave(c // g, dim=1)
        scale = inv_c * self.weight.float()
        shift = self.bias.float() - mean_c * scale
        shp = (b, c) + (1,) * (x.ndim - 2)
        return x * scale.reshape(shp).to(x.dtype) + \
            shift.reshape(shp).to(x.dtype)


class LayerNormF32(nn.Module):
    """LayerNorm over the last dim, f32 statistics, eps 1e-5."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        return layer_norm(x, self.weight, self.bias, self.eps)


class ResBlock(nn.Module):
    """Timestep-conditioned residual block (openaimodel ResBlock layout):
    norm -> silu -> conv3x3 -> + emb -> norm -> silu -> dropout -> conv3x3,
    plus a 1x1 skip projection when the width changes."""

    def __init__(self, in_channels: int, out_channels: int, emb_dim: int,
                 dropout: float = 0.0, use_scale_shift_norm: bool = False):
        super().__init__()
        self.use_scale_shift_norm = use_scale_shift_norm
        self.in_layers = nn.Sequential(
            GroupNorm32(in_channels), nn.SiLU(),
            Conv2d(in_channels, out_channels, 3, padding=1))
        self.emb_layers = nn.Sequential(
            nn.SiLU(), Linear(emb_dim, (2 if use_scale_shift_norm else 1)
                              * out_channels))
        self.out_layers = nn.Sequential(
            GroupNorm32(out_channels), nn.SiLU(), nn.Dropout(dropout),
            Conv2d(out_channels, out_channels, 3, padding=1))
        self.skip_connection = (
            Conv2d(in_channels, out_channels, 1)
            if in_channels != out_channels else nn.Identity())

    def forward(self, x, emb, skip: Optional[torch.Tensor] = None):
        # skip: the U-Net up path's skip tensor, channel-concatenated after x
        if skip is not None:
            x = torch.cat([x, skip], dim=1)
        h = self.in_layers(x)
        e = self.emb_layers(emb).to(h.dtype)[:, :, None, None]
        if self.use_scale_shift_norm:
            scale, shift = e.chunk(2, dim=1)
            h = self.out_layers[0](h) * (1 + scale) + shift
            h = self.out_layers[3](self.out_layers[2](F.silu(h)))
        else:
            h = self.out_layers(h + e)
        return self.skip_connection(x) + h


class Upsample(nn.Module):
    """Nearest 2x upsample + conv3x3."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class Downsample(nn.Module):
    """Stride-2 conv3x3 with symmetric padding 1 (torch's window alignment,
    which the JAX module reproduces with explicit padding)."""

    def __init__(self, channels: int):
        super().__init__()
        self.op = Conv2d(channels, channels, 3, stride=2, padding=1)
        self.op.quantizable = False  # a plain nn.Conv in the JAX U-Net

    def forward(self, x):
        return self.op(x)


class CrossAttention(nn.Module):
    """Multi-head attention, bias-free q/k/v, biased output projection;
    self-attention when context is None. `causal` masks keys after the
    query (RARM's attn1); the RDM blocks keep it off."""

    def __init__(self, dim: int, context_dim: int, heads: int,
                 head_dim: int, dropout: float = 0.0, causal: bool = False):
        super().__init__()
        inner = heads * head_dim
        self.heads, self.head_dim = heads, head_dim
        self.causal = causal
        self.to_q = Linear(dim, inner, bias=False)
        self.to_k = Linear(context_dim, inner, bias=False)
        self.to_v = Linear(context_dim, inner, bias=False)
        self.to_out = nn.ModuleList([Linear(inner, dim)])
        self.dropout = nn.Dropout(dropout)

    def forward(self, x, context=None):
        ctx = x if context is None else context
        b, s = x.shape[:2]
        sk = ctx.shape[1]
        h, d = self.heads, self.head_dim
        quant.record(self, "act_absmax", x)
        q = self.to_q(x).reshape(b, s, h, d)
        k = self.to_k(ctx).reshape(b, sk, h, d)
        v = self.to_v(ctx).reshape(b, sk, h, d)
        out = dot_product_attention(q, k, v, causal=self.causal)
        out = out.reshape(b, s, h * d)
        quant.record(self, "out_absmax", out)
        return self.dropout(self.to_out[0](out))


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = Linear(dim, inner * 2)

    def forward(self, x):
        a, gate = self.proj(x).chunk(2, dim=-1)
        return a * F.gelu(gate)  # exact erf


class GEGLUFeedForward(nn.Module):
    """x -> GEGLU(dim, 4 dim) -> dropout -> Linear(4 dim, dim), stored as
    `net` (the reference FeedForward layout)."""

    def __init__(self, dim: int, mult: int = 4, dropout: float = 0.0):
        super().__init__()
        self.net = nn.Sequential(GEGLU(dim, dim * mult), nn.Dropout(dropout),
                                 Linear(dim * mult, dim))

    def forward(self, x):
        quant.record(self, "act_absmax", x)
        h = self.net[0](x)
        quant.record(self, "hidden_absmax", h)
        return self.net[2](self.net[1](h))


class TransformerBlock(nn.Module):
    """Pre-LN: self-attn -> cross-attn -> GEGLU FF, each residual. With no
    context the middle attention is self-attention. This is the unfused
    math; SpatialTransformer runs the fused kernels instead.

    `qabsmax` (a [6] f32 buffer, None until `set_qabsmax` or a state dict
    that holds it) carries the calibrated activation absmax of the int8
    serving mode, in `QSCALE_NAMES` order; with it the fused route runs the
    int8 kernels."""

    def __init__(self, dim: int, context_dim: Optional[int], heads: int,
                 head_dim: int, dropout: float = 0.0):
        super().__init__()
        self.heads, self.head_dim = heads, head_dim
        self.norm1 = LayerNormF32(dim)
        self.attn1 = CrossAttention(dim, dim, heads, head_dim, dropout)
        self.norm2 = LayerNormF32(dim)
        self.attn2 = CrossAttention(dim, context_dim or dim, heads, head_dim,
                                    dropout)
        self.norm3 = LayerNormF32(dim)
        self.ff = GEGLUFeedForward(dim, dropout=dropout)
        self._packed = None  # kernel-layout weights, see pack()
        self._qscales = None  # host copy of qabsmax, see qscales()
        self.register_buffer("qabsmax", None)
        # a reload makes the snapshot stale
        self.register_load_state_dict_post_hook(
            lambda module, keys: module.unpack())

    def forward(self, x, context=None):
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))

    def set_qabsmax(self, absmax: torch.Tensor) -> None:
        """Switch the fused route to the int8 kernels with these [6]
        calibrated activation absmax."""
        self.qabsmax = absmax.float().to(self.norm1.weight.device)
        self.unpack()

    def qscales(self):
        """{QSCALE_NAMES: absmax} as host floats (read from the device
        once), or None outside the int8 mode."""
        if self.qabsmax is None:
            return None
        if self._qscales is None:
            self._qscales = dict(zip(QSCALE_NAMES, self.qabsmax.tolist()))
        return self._qscales

    def _load_from_state_dict(self, state_dict, prefix, *args):
        t = state_dict.get(prefix + "qabsmax")
        if t is not None:  # a slot for the base class to fill
            self.qabsmax = torch.empty_like(t)
        super()._load_from_state_dict(state_dict, prefix, *args)

    def _pack(self, dtype: torch.dtype):
        w = pack_block_weights(self, dtype)
        return w if self.qabsmax is None else quantize_block_weights(w)

    def pack(self, dtype: torch.dtype) -> None:
        """Snapshot the kernel-layout weights once (int8 ones too in the
        int8 mode), for inference on the parameters' device; a state-dict
        load drops the snapshot."""
        self._packed = self._pack(dtype)

    def unpack(self) -> None:
        self._packed = None
        self._qscales = None

    def fused_weights(self, x: torch.Tensor):
        """The snapshot if it fits x's dtype, device and mode, else a
        fresh packing (per call: tests and CPU use)."""
        w = self._packed
        if (w is not None and w["wqkv"].dtype == x.dtype
                and w["wqkv"].device == x.device
                and ("wqkv_q" in w) == (self.qabsmax is not None)):
            return w
        return self._pack(x.dtype)

    def forward_fused(self, x, context):
        return fused_transformer_block(
            x, context.to(x.dtype), self.fused_weights(x),
            heads=self.heads, head_dim=self.head_dim,
            qscales=self.qscales())

    def forward_fused_ad(self, x, context):
        """The training route: the block kernels forward, the unfused
        block's gradient backward (`fused_transformer_block_ad`), on
        weights packed differentiably from the live parameters at this
        call, never from the `pack()` snapshot, which an optimizer step
        makes stale. bf16 (f32 on the CPU); no int8."""
        if self.qabsmax is not None:
            raise ValueError("the int8 fused block is inference-only")
        w = pack_block_weights(self, x.dtype, differentiable=True)
        ck, cv = context_kv(context.to(x.dtype), w)
        return fused_transformer_block_ad(x, ck, cv, w, heads=self.heads,
                                          head_dim=self.head_dim)


def use_fused_block() -> bool:
    """RDM_TPU_FUSED_BLOCK=0 turns the fused blocks off: the JAX
    package's documented switch (`use_fused_spatial_block`), kept so that
    a deployment's setting means the same in both; default on."""
    return os.environ.get("RDM_TPU_FUSED_BLOCK", "1") != "0"


def fused_block_train() -> bool:
    """RDM_TPU_FUSED_BLOCK_TRAIN=1 runs the fused blocks in training
    (`TransformerBlock.forward_fused_ad`), as in the JAX package; default
    off (a measured no-go as a default on the TPU, not yet decided on the
    card)."""
    return os.environ.get("RDM_TPU_FUSED_BLOCK_TRAIN", "0") == "1"


class SpatialTransformer(nn.Module):
    """GroupNorm -> 1x1 conv -> tokens -> `depth` transformer blocks
    cross-attending to `context` -> 1x1 conv -> residual."""

    def __init__(self, channels: int, context_dim: Optional[int],
                 heads: int, head_dim: int, depth: int = 1,
                 dropout: float = 0.0):
        super().__init__()
        inner = heads * head_dim
        self.head_dim = head_dim
        self.dropout = dropout
        self.norm = GroupNorm32(channels, eps=1e-6)
        self.proj_in = Conv2d(channels, inner, 1)
        self.transformer_blocks = nn.ModuleList([
            TransformerBlock(inner, context_dim, heads, head_dim, dropout)
            for _ in range(depth)])
        self.proj_out = Conv2d(inner, channels, 1)

    def forward(self, x, context=None):
        b, c, h, w = x.shape
        x_in = x
        x = self.proj_in(self.norm(x))
        inner = x.shape[1]
        x = x.permute(0, 2, 3, 1).reshape(b, h * w, inner)
        # The JAX package's gate (rdm_tpu/models/layers.py
        # SpatialTransformer): heads whose width divides 128, never while
        # calibrating (which records the absmax the int8 kernels quantize
        # with); in training (JAX's deterministic=False) only with
        # RDM_TPU_FUSED_BLOCK_TRAIN=1 and dropout 0.
        fused = (context is not None and not quant.CALIBRATE
                 and use_fused_block() and 128 % self.head_dim == 0
                 and (not self.training
                      or (self.dropout == 0.0 and fused_block_train())))
        for blk in self.transformer_blocks:
            if not fused:
                x = blk(x, context)
            elif self.training:
                x = blk.forward_fused_ad(x, context)
            else:
                x = blk.forward_fused(x, context)
        x = x.reshape(b, h, w, inner).permute(0, 3, 1, 2)
        return self.proj_out(x) + x_in
