"""RDM — retrieval-augmented latent diffusion, in PyTorch.

Counterpart of `rdm_tpu/models/rdm.py` for the released configs'
`retro_only` routing (also `crossattn`, which routes the same way): the
retrieved CLIP neighbors [B, n*k, 512] are the U-Net's cross-attention
context. The module keeps the reference checkpoint names:
`model.diffusion_model.*` for the U-Net and `unconditional_guidance_vex`.
Learned neighbor encoders and the concat/hybrid/adm routings are not
ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from rdm_tpu_torch.config import DDIMSamplerConfig, RDMConfig
from rdm_tpu_torch.models.unet import UNet
from rdm_tpu_torch.ops.schedules import DiffusionSchedule
from rdm_tpu_torch.sampling import ddim_sample

__all__ = ["RDM", "RDMConfig", "make_denoise_feats_fn", "make_denoise_fn",
           "sample_with_neighbors"]


class _DiffusionWrapper(nn.Module):
    """Holds the U-Net under the reference name `diffusion_model`."""

    def __init__(self, unet: UNet):
        super().__init__()
        self.diffusion_model = unet


class RDM(nn.Module):
    """Denoiser + classifier-free-guidance vector."""

    _COND_KEYS = ("retro_only", "crossattn")

    def __init__(self, config: RDMConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        if config.conditioning_key not in self._COND_KEYS:
            raise ValueError(
                f"conditioning_key '{config.conditioning_key}' is not "
                f"ported (one of {self._COND_KEYS})")
        if config.nn_encoder is not None:
            raise ValueError("learned nn_encoder is not ported")
        self.config = config
        self.model = _DiffusionWrapper(UNet(config.unet, dtype))
        self.unconditional_guidance_vex = nn.Parameter(
            torch.randn(config.context_dim))

    @property
    def unet(self) -> UNet:
        return self.model.diffusion_model

    def forward(self, x, t, context, **unet_kw):
        """eps prediction; x NCHW, context [B(, 2B), S, D] or neighbors
        [B, n, k, D]. `unet_kw` (encoder_cache, return_cache) go to the
        U-Net."""
        if context is not None and context.ndim != 3:
            context = self.encode_neighbors(context)
        return self.unet(x, t, context, **unet_kw)

    def encode_neighbors(self, neighbors: torch.Tensor) -> torch.Tensor:
        """[B, S, D] passes through; [B, n, k, D] flattens to
        [B, n*k, D] (reference ddpm.py:365)."""
        if neighbors.ndim == 3:
            return neighbors
        if neighbors.ndim == 4:
            b, n, k, d = neighbors.shape
            return neighbors.reshape(b, n * k, d)
        raise ValueError(f"bad neighbor rank {neighbors.ndim} (token "
                         "sequences need a learned nn_encoder)")

    def uncond_context(self, batch: int, seq_len: int,
                       guidance_label: Optional[float] = None
                       ) -> torch.Tensor:
        """Null conditioning [B, S, D]: the guidance vector broadcast over
        the sequence; a label rescales its norm (ddpm.py:673-680)."""
        vex = self.unconditional_guidance_vex.float()
        if guidance_label is not None:
            vex = vex / torch.linalg.vector_norm(vex) * guidance_label
        return vex.expand(batch, seq_len, vex.shape[-1])


def make_denoise_fn(model: RDM):
    """(x, t, context) -> eps with the model's current weights."""

    def fn(x, t, context):
        return model(x, t, context)

    return fn


def make_denoise_feats_fn(model: RDM):
    """Encoder-reuse variant of make_denoise_fn: (x, t, context,
    cache or None) -> (eps, cache). With cache None the full U-Net runs
    and returns fresh down-path features; otherwise only the up path runs
    against the cached ones (approximate, see UNet.forward)."""

    def fn(x, t, context, cache):
        return model(x, t, context, encoder_cache=cache, return_cache=True)

    return fn


def sample_with_neighbors(model: RDM, neighbors: torch.Tensor,
                          schedule: DiffusionSchedule,
                          sampler: DDIMSamplerConfig,
                          generator: torch.Generator, *,
                          guidance_label: Optional[float] = None
                          ) -> torch.Tensor:
    """DDIM-sample latents conditioned on neighbors [B, k, D] (or
    [B, n, k, D]); returns NHWC f32 latents divided by scale_factor, the
    JAX layout. Decode with the first stage."""
    cfg = model.config
    neighbors = model.encode_neighbors(neighbors)
    b, s, _ = neighbors.shape
    uncond = None
    if sampler.guidance_scale != 1.0:
        uncond = model.uncond_context(b, s, guidance_label).to(
            neighbors.device)
    shape = (b, cfg.channels, cfg.image_size, cfg.image_size)
    feats_fn = (make_denoise_feats_fn(model) if sampler.encoder_reuse > 1
                else None)
    x, _ = ddim_sample(make_denoise_fn(model), schedule, sampler, shape,
                       neighbors, generator, uncond_context=uncond,
                       denoise_feats_fn=feats_fn)
    return x.permute(0, 2, 3, 1) / cfg.scale_factor
