"""RDM — retrieval-augmented latent diffusion, in PyTorch.

Counterpart of `rdm_tpu/models/rdm.py` for the released configs'
`retro_only` routing (also `crossattn`, which routes the same way): the
retrieved CLIP neighbors [B, n*k, 512] are the U-Net's cross-attention
context. The module keeps the reference checkpoint names:
`model.diffusion_model.*` for the U-Net, `unconditional_guidance_vex` and,
with `learn_logvar`, `logvar`. `training_loss` is the diffusion objective
the training path (`training/`) differentiates.
Learned neighbor encoders and the concat/hybrid/adm routings are not
ported yet.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from rdm_tpu_torch.config import DDIMSamplerConfig, RDMConfig
from rdm_tpu_torch.models.init import normal
from rdm_tpu_torch.models.unet import UNet
from rdm_tpu_torch.ops.schedules import DiffusionSchedule, q_sample
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
        if config.learn_logvar:  # else a constant, see logvar_table
            self.logvar = nn.Parameter(torch.full((config.timesteps,),
                                                  config.logvar_init))

    def jax_init_own(self, generator: torch.Generator):
        """The JAX draws of the RDM's own leaves (`models/init.py`): the
        guidance vector normal(1), logvar at logvar_init."""
        vex = self.unconditional_guidance_vex
        vex.copy_(normal(vex.shape, 1.0, generator).to(vex.device))
        if self.config.learn_logvar:
            self.logvar.fill_(self.config.logvar_init)
            return [vex, self.logvar]
        return [vex]

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

    def logvar_table(self, device) -> torch.Tensor:
        """The per-t log-variance [T]: the `logvar` parameter with
        learn_logvar, else the constant logvar_init (outside the state
        dict, as it is outside the JAX params)."""
        if self.config.learn_logvar:
            return self.logvar
        return torch.full((self.config.timesteps,), self.config.logvar_init,
                          device=device)

    def training_loss(self, z: torch.Tensor, neighbors: torch.Tensor,
                      generator: torch.Generator,
                      schedule: DiffusionSchedule, *,
                      t: Optional[torch.Tensor] = None,
                      noise: Optional[torch.Tensor] = None,
                      drop: Optional[torch.Tensor] = None,
                      ctx_noise: Optional[torch.Tensor] = None,
                      rows: Optional[Tuple[int, int]] = None
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """One evaluation of the diffusion training objective
        (`RDM.training_loss` of the JAX package): eps-prediction L2 with the
        per-t logvar weighting and the optional ELBO term.

        z: latents [B, C, H, W] (first-stage encoded and scaled);
        neighbors [B, n, k, D] or [B, S, D]. The draws - timesteps t, the
        noise, the classifier-free-guidance drop mask and, with
        retro_noise, the context noise - come from `generator` (on z's
        device), in that order. The keyword-only t / noise / drop /
        ctx_noise replace a draw; they are a seam for the tests, which feed
        the JAX package's draws. Under data parallelism `rows` = (start,
        global batch) says which rows of the global batch z holds: every
        draw is made at the global batch's shape and cut to those rows, so
        ranks draw what one process would for the whole batch (given draws
        are global then, and cut the same way). Returns (loss,
        {loss_simple, loss_vlb (with original_elbo_weight > 0), loss})."""
        cfg = self.config
        b, dev = z.shape[0], z.device
        start, gb = rows if rows is not None else (0, b)

        def mine(a):  # this rank's rows of a global draw
            return a if gb == b else a[start:start + b]

        context = (self.encode_neighbors(neighbors).float()
                   if neighbors is not None else None)
        if t is None:
            t = torch.randint(0, cfg.timesteps, (gb,), generator=generator,
                              device=dev)
        t = mine(t)
        if noise is None:
            noise = torch.randn((gb, *z.shape[1:]), generator=generator,
                                device=dev)
        noise = mine(noise)
        if context is not None and cfg.p_uncond > 0.0:
            if drop is None:
                drop = torch.rand(gb, generator=generator,
                                  device=dev) < cfg.p_uncond
            drop = mine(drop)
            uncond = self.uncond_context(b, context.shape[1])
            context = torch.where(drop.to(dev)[:, None, None], uncond,
                                  context)
        x_noisy = q_sample(schedule, z, t, noise)
        if cfg.retro_noise and context is not None:
            if ctx_noise is None:
                ctx_noise = torch.randn((gb, *context.shape[1:]),
                                        generator=generator, device=dev)
            context = q_sample(schedule, context, t, mine(ctx_noise))

        pred = self(x_noisy, t, context)
        target = noise if cfg.parameterization == "eps" else z
        err = (pred.float() - target.float()) ** 2
        loss_simple = err.mean(dim=(1, 2, 3))                      # [B]
        logvar_t = self.logvar_table(dev)[t]
        loss = loss_simple / torch.exp(logvar_t) + logvar_t
        loss = cfg.l_simple_weight * loss.mean()
        metrics = {"loss_simple": loss_simple.mean()}
        if cfg.original_elbo_weight > 0.0:
            lvlb = (schedule.lvlb_weights.to(dev)[t] * loss_simple).mean()
            loss = loss + cfg.original_elbo_weight * lvlb
            metrics["loss_vlb"] = lvlb
        metrics["loss"] = loss
        return loss, metrics


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
                          guidance_label: Optional[float] = None,
                          rows: Optional[Tuple[int, int]] = None,
                          return_intermediates: bool = False):
    """DDIM-sample latents conditioned on neighbors [B, k, D] (or
    [B, n, k, D]); returns NHWC f32 latents divided by scale_factor, the
    JAX layout. Decode with the first stage. `rows`: the rank's rows of a
    data-parallel request (`sampling.ddim_sample`).
    return_intermediates=True returns (latents, the pred_x0 trajectory
    [steps / log_every_t, B, H, W, C] in model scale), as the JAX function
    does for the fidelity harness (needs sampler.log_every_t != 0)."""
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
    x, interm = ddim_sample(make_denoise_fn(model), schedule, sampler,
                            shape, neighbors, generator,
                            uncond_context=uncond, denoise_feats_fn=feats_fn,
                            rows=rows)
    x = x.permute(0, 2, 3, 1) / cfg.scale_factor
    if return_intermediates:
        if interm is None:
            raise ValueError("return_intermediates needs "
                             "sampler.log_every_t != 0")
        return x, interm.permute(0, 1, 3, 4, 2)
    return x
