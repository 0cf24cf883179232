"""ADM-style U-Net with retrieval cross-attention — the RDM denoiser.

Counterpart of `rdm_tpu/models/unet.py`, in the reference `openaimodel.py`
module layout (`time_embed`, `input_blocks`, `middle_block`,
`output_blocks`, `out`), so a port state dict converts onto the JAX tree
with `convert_unet(sd, cfg, prefix="")`. Images are NCHW.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from rdm_tpu_torch.config import UNetConfig
from rdm_tpu_torch.models.init import zero_init
from rdm_tpu_torch.models.layers import (Conv2d, Downsample, GroupNorm32,
                                         Linear, ResBlock,
                                         SpatialTransformer, Upsample)
from rdm_tpu_torch.ops.schedules import timestep_embedding

__all__ = ["UNet", "UNetConfig"]


class UNet(nn.Module):
    """eps-prediction U-Net: forward(x [B, C, H, W], t [B],
    context [B or 2B, S, Dc], y [B]) -> eps [B or 2B, C, H, W] f32.

    `dtype` is the compute dtype: inputs are cast to it, parameters are
    cast to it at use, the output is returned in f32.

    Shared-prefix CFG (rdm_tpu unet.py:103-138): when `context` has batch
    2B while x has batch B, the halves are the (cond, uncond) pair of
    classifier-free guidance over the same x and t. Every block before the
    first cross-attention is context-independent, so that prefix runs once
    at batch B and the stream is tiled to 2B where the context first
    enters; pre-divergence skip connections are tiled where they are
    consumed. `shared_cfg=None` detects the form from the batch sizes;
    True requires it; False forbids a context batch other than B.

    Encoder reuse (rdm_tpu unet.py:89-101, 181-191; "Faster Diffusion",
    arXiv 2312.09608): `return_cache=True` also returns the down path's
    skips and the middle's output, `(skips, mid)`; passing that back as
    `encoder_cache` on a later step skips the down path and middle and runs
    only the up path against them, with the current timestep embedding
    (tiled to the cache's batch under shared CFG). Approximate: the cached
    features belong to a nearby x_t.
    """

    def __init__(self, config: UNetConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        cfg = config
        self.config = cfg
        self.dtype = dtype
        ch0 = cfg.model_channels
        emb = ch0 * 4
        self.time_embed = nn.Sequential(Linear(ch0, emb), nn.SiLU(),
                                        Linear(emb, emb))
        if cfg.num_classes is not None:
            self.label_emb = nn.Embedding(cfg.num_classes, emb)

        def res(cin, cout):
            return ResBlock(cin, cout, emb, cfg.dropout,
                            cfg.use_scale_shift_norm)

        def attn(ch):
            heads, head_dim = cfg.heads_for(ch)
            return SpatialTransformer(ch, cfg.context_dim, heads, head_dim,
                                      cfg.transformer_depth, cfg.dropout)

        if cfg.resblock_updown or not cfg.conv_resample:
            raise NotImplementedError(
                "resblock_updown / conv_resample=False are not ported")

        self.input_blocks = nn.ModuleList([
            nn.ModuleList([Conv2d(cfg.in_channels, ch0, 3, padding=1)])])
        chans = [ch0]
        ch, ds = ch0, 1
        for level, mult in enumerate(cfg.channel_mult):
            for _ in range(cfg.num_res_blocks):
                layers = [res(ch, mult * ch0)]
                ch = mult * ch0
                if ds in cfg.attention_resolutions:
                    layers.append(attn(ch))
                self.input_blocks.append(nn.ModuleList(layers))
                chans.append(ch)
            if level != len(cfg.channel_mult) - 1:
                self.input_blocks.append(nn.ModuleList([Downsample(ch)]))
                chans.append(ch)
                ds *= 2
        self.middle_block = nn.ModuleList([res(ch, ch), attn(ch),
                                           res(ch, ch)])
        self.output_blocks = nn.ModuleList()
        for level, mult in reversed(list(enumerate(cfg.channel_mult))):
            for i in range(cfg.num_res_blocks + 1):
                layers = [res(ch + chans.pop(), mult * ch0)]
                ch = mult * ch0
                if ds in cfg.attention_resolutions:
                    layers.append(attn(ch))
                if level and i == cfg.num_res_blocks:
                    layers.append(Upsample(ch))
                    ds //= 2
                self.output_blocks.append(nn.ModuleList(layers))
        self.out = nn.Sequential(GroupNorm32(ch), nn.SiLU(), zero_init(
            Conv2d(ch, cfg.out_channels, 3, padding=1)))
        # (tag, fn, *args) -> fn(*args) under a remat policy; set by the
        # train step for the duration of its forward and backward
        self.remat = None

    def forward(self, x, t, context=None, y=None, *,
                shared_cfg: Optional[bool] = None, encoder_cache=None,
                return_cache: bool = False):
        cfg = self.config
        dt = self.dtype
        doubled = (context is not None and context.shape[0] > 0
                   and context.shape[0] == 2 * x.shape[0])
        if shared_cfg and not doubled:
            raise ValueError(
                "shared_cfg=True requires context batch == 2 * x batch "
                f"(got context "
                f"{None if context is None else tuple(context.shape)} "
                f"vs x {tuple(x.shape)})")
        if shared_cfg is False and context is not None \
                and context.shape[0] != x.shape[0]:
            raise ValueError(
                "shared_cfg=False: context batch must equal x batch "
                f"(got {context.shape[0]} vs {x.shape[0]})")
        shared = doubled if shared_cfg is None else bool(shared_cfg)
        tiled = not shared  # flips True once the stream is doubled

        def tile2(a):
            return torch.cat([a, a], dim=0)

        emb = self.time_embed(
            timestep_embedding(t, cfg.model_channels).to(dt))
        if cfg.num_classes is not None:
            if y is None:
                raise ValueError("class-conditional UNet requires labels")
            emb = emb + self.label_emb(y).to(dt)
        if context is not None:
            context = context.to(dt)

        if encoder_cache is not None:
            hs, h = list(encoder_cache[0]), encoder_cache[1]
            if h.shape[0] == 2 * x.shape[0] and not tiled:
                emb, tiled = tile2(emb), True
        else:
            h = x.to(dt)
            hs = []
            ds = 1
            for blocks in self.input_blocks:
                if isinstance(blocks[0], Downsample):
                    ds *= 2
                tile = not tiled and any(isinstance(layer, SpatialTransformer)
                                         for layer in blocks)
                h = self._region(ds, self._block, blocks, h, emb, context,
                                 None, tile)
                if tile:
                    emb, tiled = tile2(emb), True
                hs.append(h)
            h = self._region(ds, self._block, self.middle_block, h, emb,
                             context, None, not tiled)
            if not tiled:  # no attention in the down path at all
                emb, tiled = tile2(emb), True
        feats = (tuple(hs), h)

        ds = 2 ** (len(cfg.channel_mult) - 1)
        for blocks in self.output_blocks:
            skip = hs.pop()
            if skip.shape[0] != h.shape[0]:  # pre-divergence skip
                skip = tile2(skip)
            h = self._region(ds, self._block, blocks, h, emb, context, skip,
                             False)
            if isinstance(blocks[-1], Upsample):
                ds //= 2
        out = self._region(1, self.out, h).float()
        return (out, feats) if return_cache else out

    @staticmethod
    def _block(blocks, h, emb, context, skip, tile: bool):
        """One U-Net block: its layers over h; `skip` goes to the up
        path's ResBlock; `tile` doubles h and emb (shared-prefix CFG)
        before the block's SpatialTransformer."""
        for layer in blocks:
            if isinstance(layer, ResBlock):
                h = layer(h, emb, skip=skip)
            elif isinstance(layer, SpatialTransformer):
                if tile:
                    h, emb = torch.cat([h, h]), torch.cat([emb, emb])
                h = layer(h, context)
            else:
                h = layer(h)
        return h

    def _region(self, ds: int, fn, *args):
        """fn(*args), or, while a train step's remat policy is set
        (`self.remat`), what that policy makes of the region whose output
        is tagged blk_ds{ds}: the block outputs the JAX U-Net names with
        `checkpoint_name` (rdm_tpu/models/unet.py:173-179). Outside remat
        the call is direct and costs nothing."""
        if self.remat is None:
            return fn(*args)
        return self.remat(f"blk_ds{ds}", fn, *args)
