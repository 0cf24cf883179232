"""DDIM sampling with classifier-free guidance, in PyTorch.

Counterpart of `rdm_tpu/sampling.py` `ddim_sample`: the JAX `lax.scan`
becomes a Python loop, and noise comes from an explicit `torch.Generator`
on the sampling device. Ported: the `shared` and `double` CFG modes, eta,
temperature, `x_init`, `log_every_t` and encoder reuse
(`encoder_reuse` N > 1 with a `denoise_feats_fn`: the U-Net's down path
and middle run on step 0 and every N-th step after it, the steps between
run only the up path against the cached features). Inpainting,
`quantize_fn`, random guiding and style/content swaps are not ported yet.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import torch

from rdm_tpu_torch.config import DDIMSamplerConfig
from rdm_tpu_torch.ops.schedules import (DDIMSchedule, DiffusionSchedule,
                                         ddim_step)

__all__ = ["DDIMSamplerConfig", "ddim_sample"]

# denoiser: (x, t, context) -> eps prediction
DenoiseFn = Callable[[torch.Tensor, torch.Tensor, Optional[torch.Tensor]],
                     torch.Tensor]
# encoder-reuse denoiser: (x, t, context, cache or None) -> (eps, cache)
DenoiseFeatsFn = Callable[..., Tuple[torch.Tensor, Any]]


def ddim_sample(
    denoise_fn: DenoiseFn,
    schedule: DiffusionSchedule,
    config: DDIMSamplerConfig,
    shape: Tuple[int, ...],
    context: Optional[torch.Tensor],
    generator: torch.Generator,
    *,
    uncond_context: Optional[torch.Tensor] = None,
    x_init: Optional[torch.Tensor] = None,
    denoise_feats_fn: Optional[DenoiseFeatsFn] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Run the DDIM reverse process on the generator's device.

    shape is the latent shape in the denoiser's layout; x_init (default
    N(0, 1) from `generator`) starts the chain. Returns (x_0, the pred_x0
    of every `log_every_t`-th step stacked, or None)."""
    reuse = max(int(config.encoder_reuse), 1)
    if reuse > 1 and denoise_feats_fn is None:
        raise ValueError("encoder_reuse > 1 needs a denoise_feats_fn "
                         "(see models.rdm.make_denoise_feats_fn)")
    if config.cfg_mode not in ("double", "shared"):
        raise ValueError(f"bad cfg_mode '{config.cfg_mode}'")
    use_cfg = config.guidance_scale != 1.0
    if use_cfg and uncond_context is None:
        raise ValueError("guidance_scale != 1 requires uncond_context")
    ddim = DDIMSchedule.create(schedule, config.num_steps, eta=config.eta,
                               method=config.method)
    dev = generator.device
    x = (x_init.to(dev, torch.float32) if x_init is not None
         else torch.randn(shape, generator=generator, device=dev))
    ctx2 = (torch.cat([context, uncond_context], dim=0)
            if use_cfg and context is not None else None)

    def dn(x_, t_, c_, cache):
        # every CFG mode makes exactly one denoiser call per step, so the
        # encoder cache threads through uniformly
        if reuse == 1:
            return denoise_fn(x_, t_, c_), None
        return denoise_feats_fn(x_, t_, c_, cache)

    def eps_model(x, t, cache):
        if context is None or not use_cfg:
            return dn(x, t, context, cache)
        if config.cfg_mode == "shared":
            eps2, cache = dn(x, t, ctx2, cache)
            if eps2.shape[0] != 2 * x.shape[0]:
                raise ValueError(
                    "cfg_mode='shared' needs a denoiser that returns "
                    f"batch {2 * x.shape[0]} for a doubled context "
                    f"(got {eps2.shape[0]}); use cfg_mode='double'")
        else:
            eps2, cache = dn(torch.cat([x, x]), torch.cat([t, t]), ctx2,
                             cache)
        eps_c, eps_u = eps2.chunk(2, dim=0)
        return eps_u + config.guidance_scale * (eps_c - eps_u), cache

    noisy = config.eta != 0.0
    logged = []
    cache = None
    for step in range(ddim.num_steps):
        index = ddim.num_steps - 1 - step  # descending through the tables
        t = torch.full((shape[0],), int(ddim.timesteps[index]),
                       dtype=torch.long, device=dev)
        eps, cache = eps_model(x, t, None if step % reuse == 0 else cache)
        noise = (torch.randn(shape, generator=generator, device=dev)
                 if noisy else None)
        x, pred_x0 = ddim_step(ddim, x, eps, index, noise,
                               temperature=config.temperature)
        if config.log_every_t and step % config.log_every_t == 0:
            logged.append(pred_x0)
    return x, (torch.stack(logged) if logged else None)
