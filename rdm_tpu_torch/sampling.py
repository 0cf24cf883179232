"""DDIM sampling with classifier-free guidance, in PyTorch.

Counterpart of `rdm_tpu/sampling.py` `ddim_sample`: the JAX `lax.scan`
becomes a Python loop, and noise comes from an explicit `torch.Generator`
on the sampling device. Ported: the `shared` and `double` CFG modes, eta,
temperature, `x_init`, `log_every_t` and encoder reuse
(`encoder_reuse` N > 1 with a `denoise_feats_fn`: the U-Net's down path
and middle run on step 0 and every N-th step after it, the steps between
run only the up path against the cached features) and the inpainting
blend (`mask` / `x0`). `ddim_retro_sample` is the adaptive re-retrieval
sampler. `quantize_fn`, random guiding and style/content swaps are not
ported yet.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import torch

from rdm_tpu_torch.config import DDIMSamplerConfig
from rdm_tpu_torch.ops.schedules import (DDIMSchedule, DiffusionSchedule,
                                         ddim_step, q_sample)

__all__ = ["DDIMSamplerConfig", "ddim_retro_sample", "ddim_sample"]

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
    mask: Optional[torch.Tensor] = None,
    x0: Optional[torch.Tensor] = None,
    rows: Optional[Tuple[int, int]] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Run the DDIM reverse process on the generator's device.

    shape is the latent shape in the denoiser's layout; x_init (default
    N(0, 1) from `generator`) starts the chain. mask / x0 (the shape's
    layout, mask broadcastable) blend in x0 where mask == 1: inpainting.
    Draws from `generator`, in order: x_T (without x_init), the pre-blend
    noise, then per step the DDIM noise (eta != 0) and the blend noise.
    Under data parallelism `rows` = (start, global batch) says which rows
    of the global batch `shape` holds: every draw is made at the global
    batch's shape and cut to those rows (`randn_rows`). Returns (x_0, the pred_x0 of every `log_every_t`-th step stacked, or
    None)."""
    reuse = max(int(config.encoder_reuse), 1)
    if reuse > 1 and denoise_feats_fn is None:
        raise ValueError("encoder_reuse > 1 needs a denoise_feats_fn "
                         "(see models.rdm.make_denoise_feats_fn)")
    if config.cfg_mode not in ("double", "shared"):
        raise ValueError(f"bad cfg_mode '{config.cfg_mode}'")
    use_cfg = config.guidance_scale != 1.0
    if use_cfg and uncond_context is None:
        raise ValueError("guidance_scale != 1 requires uncond_context")
    if (mask is None) != (x0 is None):
        raise ValueError("inpainting needs both mask and x0")
    ddim = DDIMSchedule.create(schedule, config.num_steps, eta=config.eta,
                               method=config.method)
    dev = generator.device
    x = (x_init.to(dev, torch.float32) if x_init is not None
         else randn_rows(shape, generator, rows))
    ctx2 = (torch.cat([context, uncond_context], dim=0)
            if use_cfg and context is not None else None)
    if mask is not None:
        # the reference blends q_sample(x0, t) at the current timestep
        # before every step (ddim.py:187-190): pre-blend x_T at the first
        # (largest) DDIM timestep, then re-noise after each step below
        x = _blend(schedule, x, mask, x0, int(ddim.timesteps[-1]),
                   generator, rows)

    def dn(x_, t_, c_, cache):
        # every CFG mode makes exactly one denoiser call per step, so the
        # encoder cache threads through uniformly
        if reuse == 1:
            return denoise_fn(x_, t_, c_), None
        return denoise_feats_fn(x_, t_, c_, cache)

    def eps_model(x, t, cache):
        if context is None or not use_cfg:
            return dn(x, t, context, cache)
        return _guided(dn, x, t, ctx2, config, cache)

    noisy = config.eta != 0.0
    logged = []
    cache = None
    for step in range(ddim.num_steps):
        index = ddim.num_steps - 1 - step  # descending through the tables
        t = torch.full((shape[0],), int(ddim.timesteps[index]),
                       dtype=torch.long, device=dev)
        eps, cache = eps_model(x, t, None if step % reuse == 0 else cache)
        noise = randn_rows(shape, generator, rows) if noisy else None
        x, pred_x0 = ddim_step(ddim, x, eps, index, noise,
                               temperature=config.temperature)
        if mask is not None and index > 0:
            # the next step runs at DDIM index - 1: re-noise x0 to that
            # timestep (not t - 1); no blend after the final step
            x = _blend(schedule, x, mask, x0, int(ddim.timesteps[index - 1]),
                       generator, rows)
        if config.log_every_t and step % config.log_every_t == 0:
            logged.append(pred_x0)
    return x, (torch.stack(logged) if logged else None)


def _guided(dn, x, t, ctx2, config: DDIMSamplerConfig, cache=None):
    """The CFG eps through one denoiser call: `shared` passes x / t at B
    with the stacked [cond; uncond] context ctx2, `double` tiles x / t."""
    if config.cfg_mode == "shared":
        eps2, cache = dn(x, t, ctx2, cache)
        if eps2.shape[0] != 2 * x.shape[0]:
            raise ValueError(
                "cfg_mode='shared' needs a denoiser that returns "
                f"batch {2 * x.shape[0]} for a doubled context "
                f"(got {eps2.shape[0]}); use cfg_mode='double'")
    else:
        eps2, cache = dn(torch.cat([x, x]), torch.cat([t, t]), ctx2, cache)
    eps_c, eps_u = eps2.chunk(2, dim=0)
    return eps_u + config.guidance_scale * (eps_c - eps_u), cache


def randn_rows(shape: Tuple[int, ...], generator: torch.Generator,
               rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """N(0, 1) of `shape` on the generator's device; with rows = (start,
    global batch), drawn at the global batch's shape and cut to
    shape[0] rows from start."""
    if rows is None:
        return torch.randn(shape, generator=generator,
                           device=generator.device)
    start, gb = rows
    full = torch.randn((gb, *shape[1:]), generator=generator,
                       device=generator.device)
    return full[start:start + shape[0]]


def _blend(schedule: DiffusionSchedule, x: torch.Tensor, mask: torch.Tensor,
           x0: torch.Tensor, t: int, generator: torch.Generator,
           rows: Optional[Tuple[int, int]] = None
           ) -> torch.Tensor:
    """mask * q_sample(x0, t, fresh noise) + (1 - mask) * x."""
    noise = randn_rows(x.shape, generator, rows)
    tt = torch.full((x.shape[0],), t, dtype=torch.long, device=x.device)
    noised = q_sample(schedule, x0.float(), tt, noise)
    return mask * noised + (1.0 - mask) * x


def ddim_retro_sample(
    denoise_fn: DenoiseFn,
    schedule: DiffusionSchedule,
    config: DDIMSamplerConfig,
    shape: Tuple[int, ...],
    init_context: torch.Tensor,
    generator: torch.Generator,
    *,
    reembed_fn: Callable[[torch.Tensor], torch.Tensor],
    retro_every: int = 10,
    uncond_context: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """DDIM with adaptive re-retrieval (the reference's DDIMRetroSampler,
    ddim.py:270-415): after step s, where s % retro_every == 0 and s > 0,
    the context becomes `reembed_fn(pred_x0)` (latents -> context [B, S,
    D], e.g. decode -> CLIP image tower -> kNN -> neighbour gather). Draws
    x_T, then per step the DDIM noise (eta != 0), from `generator`."""
    use_cfg = config.guidance_scale != 1.0
    if use_cfg and uncond_context is None:
        raise ValueError("guidance_scale != 1 requires uncond_context")
    if config.cfg_mode not in ("double", "shared"):
        raise ValueError(f"bad cfg_mode '{config.cfg_mode}'")
    ddim = DDIMSchedule.create(schedule, config.num_steps, eta=config.eta,
                               method=config.method)
    dev = generator.device
    x = torch.randn(shape, generator=generator, device=dev)
    ctx = init_context

    def dn(x_, t_, c_, cache):
        return denoise_fn(x_, t_, c_), None

    for step in range(ddim.num_steps):
        index = ddim.num_steps - 1 - step
        t = torch.full((shape[0],), int(ddim.timesteps[index]),
                       dtype=torch.long, device=dev)
        if use_cfg:
            eps, _ = _guided(dn, x, t, torch.cat([ctx, uncond_context]),
                             config)
        else:
            eps = denoise_fn(x, t, ctx)
        noise = (torch.randn(shape, generator=generator, device=dev)
                 if config.eta != 0.0 else None)
        x, pred_x0 = ddim_step(ddim, x, eps, index, noise,
                               temperature=config.temperature)
        if step % retro_every == 0 and step > 0:
            ctx = reembed_fn(pred_x0).to(ctx.dtype)
    return x
