"""VQ first stage, in PyTorch.

Counterpart of `rdm_tpu/models/autoencoder.py` `VQModel`: the encoder
side (`encode_prequant`, which the RDM trains on, and `encode`), the whole
round trip (`forward`: reconstruction, commitment loss, indices), and the
decode side (`decode` with `force_not_quantize=False`: nearest-codebook
quantisation, the post-quant 1x1 conv and the decoder; `decode_code`,
which decodes token ids for the RARM path). Modules keep the taming names
(`encoder.down.{level}.block/attn/downsample`, `encoder.mid`,
`quant_conv`, `decoder.mid`, `decoder.up.{level}.block/attn/upsample`,
`post_quant_conv`, `quantize.embedding`), so a port state dict converts
onto the JAX tree. Images are NCHW.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from rdm_tpu_torch.config import AutoencoderConfig
from rdm_tpu_torch.models.layers import Conv2d, GroupNorm32
from rdm_tpu_torch.ops.attention import dot_product_attention

__all__ = ["AutoencoderConfig", "Decoder", "Encoder", "VQModel",
           "VectorQuantizer"]


class ResnetBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int,
                 dropout: float = 0.0):
        super().__init__()
        self.norm1 = GroupNorm32(in_channels, eps=1e-6)
        self.conv1 = Conv2d(in_channels, out_channels, 3, padding=1)
        self.norm2 = GroupNorm32(out_channels, eps=1e-6)
        self.dropout = nn.Dropout(dropout)
        self.conv2 = Conv2d(out_channels, out_channels, 3, padding=1)
        self.nin_shortcut = (Conv2d(in_channels, out_channels, 1)
                             if in_channels != out_channels else None)

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(self.dropout(F.silu(self.norm2(h))))
        if self.nin_shortcut is not None:
            x = self.nin_shortcut(x)
        return x + h


class AttnBlock(nn.Module):
    """Single-head self-attention over spatial positions (d = C)."""

    def __init__(self, channels: int):
        super().__init__()
        self.norm = GroupNorm32(channels, eps=1e-6)
        self.q = Conv2d(channels, channels, 1)
        self.k = Conv2d(channels, channels, 1)
        self.v = Conv2d(channels, channels, 1)
        self.proj_out = Conv2d(channels, channels, 1)

    def forward(self, x):
        b, c, h, w = x.shape
        hn = self.norm(x)

        def tokens(t):  # [B, C, H, W] -> [B, HW, 1, C]
            return t.reshape(b, c, h * w).transpose(1, 2)[:, :, None]

        out = dot_product_attention(tokens(self.q(hn)), tokens(self.k(hn)),
                                    tokens(self.v(hn)))
        out = out[:, :, 0].transpose(1, 2).reshape(b, c, h, w)
        return x + self.proj_out(out)


class _Upsample(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class _Downsample(nn.Module):
    """Stride-2 conv3x3 after an asymmetric (0, 1) zero pad (the taming
    first stage's window alignment, `_Downsample` in the JAX package)."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, stride=2, padding=0)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class _DownLevel(nn.Module):
    """One encoder resolution: `block`, `attn` and an optional
    `downsample` (the taming container names)."""

    def __init__(self, blocks, attns, downsample):
        super().__init__()
        self.block = nn.ModuleList(blocks)
        self.attn = nn.ModuleList(attns)
        if downsample is not None:
            self.downsample = downsample


class _Level(nn.Module):
    """One decoder resolution: `block`, `attn` and an optional
    `upsample` (the taming container names)."""

    def __init__(self, blocks, attns, upsample):
        super().__init__()
        self.block = nn.ModuleList(blocks)
        self.attn = nn.ModuleList(attns)
        if upsample is not None:
            self.upsample = upsample


class _Mid(nn.Module):
    def __init__(self, channels: int, dropout: float):
        super().__init__()
        self.block_1 = ResnetBlock(channels, channels, dropout)
        self.attn_1 = AttnBlock(channels)
        self.block_2 = ResnetBlock(channels, channels, dropout)

    def forward(self, h):
        return self.block_2(self.attn_1(self.block_1(h)))


class Encoder(nn.Module):
    """Images [B, in_channels, H, W] -> [B, z_channels (x2 with double_z),
    H / f, W / f]: conv_in, per level `num_res_blocks` ResnetBlocks (+
    attention at `attn_resolutions`) and a downsample except at the last,
    the mid block (its attention over C = ch * ch_mult[-1] channels stays
    on the plain path), norm_out, silu, conv_out."""

    def __init__(self, cfg: AutoencoderConfig):
        super().__init__()
        self.conv_in = Conv2d(cfg.in_channels, cfg.ch, 3, padding=1)
        levels, block_in, cur_res = [], cfg.ch, cfg.resolution
        for level, mult in enumerate(cfg.ch_mult):
            blocks, attns = [], []
            for _ in range(cfg.num_res_blocks):
                blocks.append(ResnetBlock(block_in, cfg.ch * mult,
                                          cfg.dropout))
                block_in = cfg.ch * mult
                if cur_res in cfg.attn_resolutions:
                    attns.append(AttnBlock(block_in))
            down = None
            if level != cfg.num_resolutions - 1:
                down = _Downsample(block_in)
                cur_res //= 2
            levels.append(_DownLevel(blocks, attns, down))
        self.down = nn.ModuleList(levels)
        self.mid = _Mid(block_in, cfg.dropout)
        self.norm_out = GroupNorm32(block_in, eps=1e-6)
        self.conv_out = Conv2d(
            block_in, 2 * cfg.z_channels if cfg.double_z else cfg.z_channels,
            3, padding=1)

    def forward(self, x):
        h = self.conv_in(x)
        for lv in self.down:
            for i, blk in enumerate(lv.block):
                h = blk(h)
                if len(lv.attn):
                    h = lv.attn[i](h)
            if hasattr(lv, "downsample"):
                h = lv.downsample(h)
        h = self.mid(h)
        return self.conv_out(F.silu(self.norm_out(h)))


class Decoder(nn.Module):
    def __init__(self, cfg: AutoencoderConfig):
        super().__init__()
        self.cfg = cfg
        block_in = cfg.ch * cfg.ch_mult[-1]
        self.conv_in = Conv2d(cfg.z_channels, block_in, 3, padding=1)
        self.mid = _Mid(block_in, cfg.dropout)
        levels = [None] * cfg.num_resolutions
        cur_res = cfg.resolution // cfg.downsample_factor
        for level in reversed(range(cfg.num_resolutions)):
            block_out = cfg.ch * cfg.ch_mult[level]
            blocks, attns = [], []
            for _ in range(cfg.num_res_blocks + 1):
                blocks.append(ResnetBlock(block_in, block_out, cfg.dropout))
                block_in = block_out
                if cur_res in cfg.attn_resolutions:
                    attns.append(AttnBlock(block_in))
            up = None
            if level != 0:
                up = _Upsample(block_in)
                cur_res *= 2
            levels[level] = _Level(blocks, attns, up)
        self.up = nn.ModuleList(levels)
        self.norm_out = GroupNorm32(block_in, eps=1e-6)
        self.conv_out = Conv2d(block_in, cfg.out_ch, 3, padding=1)

    def forward(self, z):
        h = self.mid(self.conv_in(z))
        for level in reversed(range(self.cfg.num_resolutions)):
            lv = self.up[level]
            for i, blk in enumerate(lv.block):
                h = blk(h)
                if len(lv.attn):
                    h = lv.attn[i](h)
            if level != 0:
                h = lv.upsample(h)
        return self.conv_out(F.silu(self.norm_out(h)))


class VectorQuantizer(nn.Module):
    """Nearest-codebook lookup: argmin over ||e||^2 - 2 z.e in f32 (the
    ||z||^2 term does not change the argmin)."""

    beta = 0.25  # commitment weight

    def __init__(self, n_embed: int, embed_dim: int):
        super().__init__()
        self.embedding = nn.Embedding(n_embed, embed_dim)

    def jax_init_own(self, generator: torch.Generator):
        """The JAX codebook's draw (`models/init.py`): uniform in
        [0, 2 / n_embed)."""
        w = self.embedding.weight
        w.copy_(torch.rand(w.shape, generator=generator,
                           device=generator.device).to(w.device)
                * (2.0 / w.shape[0]))
        return [w]

    def forward(self, z):
        """z [B, D, H, W] -> (z_q [B, D, H, W] f32, indices [B, H, W])."""
        b, d, h, w = z.shape
        cb = self.embedding.weight.float()
        flat = z.permute(0, 2, 3, 1).reshape(-1, d).float()
        dist = (cb * cb).sum(1)[None, :] - 2.0 * (flat @ cb.t())
        idx = dist.argmin(dim=1)
        z_q = cb[idx].reshape(b, h, w, d).permute(0, 3, 1, 2)
        return z_q, idx.reshape(b, h, w)

    def lookup(self, idx):
        """Code ids [...] -> codebook rows [..., D] (in the codebook's
        dtype)."""
        return self.embedding.weight[idx]


class VQModel(nn.Module):
    """VQGAN: encoder -> pre-quant 1x1 -> codebook -> post-quant 1x1 ->
    decoder."""

    ENCODER_KEYS = ("encoder.", "quant_conv.")

    def __init__(self, config: AutoencoderConfig,
                 dtype: torch.dtype = torch.float32, encoder: bool = True):
        """encoder=False builds the decode side alone (serving never
        encodes); its state dict is `decode_side(...)` of a full one."""
        super().__init__()
        self.config = config
        self.dtype = dtype
        if encoder:
            self.encoder = Encoder(config)
            self.quant_conv = Conv2d(config.z_channels, config.embed_dim, 1)
        self.decoder = Decoder(config)
        self.post_quant_conv = Conv2d(config.embed_dim, config.z_channels, 1)
        self.quantize = VectorQuantizer(config.n_embed, config.embed_dim)

    @classmethod
    def decode_side(cls, state_dict):
        """A VQModel state dict without the encoder side's entries."""
        return {k: v for k, v in state_dict.items()
                if not k.startswith(cls.ENCODER_KEYS)}

    def encode_prequant(self, x: torch.Tensor) -> torch.Tensor:
        """Images [B, in_channels, H, W] -> the continuous latent before
        quantisation [B, embed_dim, h, w] in the compute dtype (what LDM
        trains on)."""
        return self.quant_conv(self.encoder(x.to(self.dtype)))

    def encode(self, x: torch.Tensor):
        """Images -> (z_q [B, embed_dim, h, w] in the compute dtype with the
        straight-through gradient, the f32 commitment loss
        beta * |sg(z_q) - z|^2 + |z_q - sg(z)|^2 (means), indices
        [B, h, w]), as `VQModel.encode` of the JAX package."""
        z = self.encode_prequant(x)
        z_q, idx = self.quantize(z)
        zf = z.float()
        commit = (self.quantize.beta * ((z_q.detach() - zf) ** 2).mean()
                  + ((z_q - zf.detach()) ** 2).mean())
        return z + (z_q.to(z.dtype) - z).detach(), commit, idx

    def forward(self, x: torch.Tensor):
        """Images [B, in_channels, H, W] -> (reconstruction [B, out_ch, H,
        W] in the compute dtype, the f32 commitment loss, indices [B, h,
        w]): `encode`, then the decoder on the straight-through z_q with no
        second quantisation, as `VQModel.__call__` of the JAX package (what
        the micro gate's `train_vq` trains)."""
        z_q, commit, idx = self.encode(x)
        return self.decoder(self.post_quant_conv(z_q)), commit, idx

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """z [B, embed_dim, h, w] -> images [B, out_ch, H, W] in the
        compute dtype (force_not_quantize=False)."""
        z_q, _ = self.quantize(z)
        return self.decoder(self.post_quant_conv(z_q.to(self.dtype)))

    def decode_code(self, idx: torch.Tensor) -> torch.Tensor:
        """Token grid idx [B, h, w] -> images [B, out_ch, H, W] in the
        compute dtype: codebook rows, no quantize step (the RARM path)."""
        z_q = self.quantize.lookup(idx).permute(0, 3, 1, 2)
        return self.decoder(self.post_quant_conv(z_q.to(self.dtype)))
