"""Diffusion noise schedules, DDIM tables and the DDIM update, in PyTorch.

Counterpart of `rdm_tpu/ops/schedules.py`: tables are computed in float64
on the host, exactly as there, and stored as float32 tensors; the DDIM
update runs in float32 whatever the model's compute dtype.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch


def make_beta_schedule(schedule: str, n_timestep: int,
                       linear_start: float = 1e-4, linear_end: float = 2e-2,
                       cosine_s: float = 8e-3) -> np.ndarray:
    """Beta schedule in float64; "linear" is linear in sqrt(beta) space."""
    if schedule == "linear":
        betas = np.linspace(linear_start ** 0.5, linear_end ** 0.5,
                            n_timestep, dtype=np.float64) ** 2
    elif schedule == "cosine":
        ts = np.arange(n_timestep + 1, dtype=np.float64) / n_timestep \
            + cosine_s
        alphas = np.cos(ts / (1 + cosine_s) * np.pi / 2) ** 2
        alphas = alphas / alphas[0]
        betas = np.clip(1.0 - alphas[1:] / alphas[:-1], 0.0, 0.999)
    elif schedule == "sqrt_linear":
        betas = np.linspace(linear_start, linear_end, n_timestep,
                            dtype=np.float64)
    elif schedule == "sqrt":
        betas = np.linspace(linear_start, linear_end, n_timestep,
                            dtype=np.float64) ** 0.5
    else:
        raise ValueError(f"unknown beta schedule '{schedule}'")
    return betas


def _f32(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, dtype=np.float32), device=device)


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    """Forward-process (DDPM) tables, float32 tensors of length T."""

    betas: torch.Tensor
    alphas_cumprod: torch.Tensor
    alphas_cumprod_prev: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    log_one_minus_alphas_cumprod: torch.Tensor
    sqrt_recip_alphas_cumprod: torch.Tensor
    sqrt_recipm1_alphas_cumprod: torch.Tensor
    posterior_variance: torch.Tensor
    posterior_log_variance_clipped: torch.Tensor
    posterior_mean_coef1: torch.Tensor
    posterior_mean_coef2: torch.Tensor
    num_timesteps: int = 1000
    lvlb_weights: Optional[torch.Tensor] = None

    @classmethod
    def create(cls, timesteps: int = 1000, schedule: str = "linear",
               linear_start: float = 0.0015, linear_end: float = 0.0195,
               cosine_s: float = 8e-3, v_posterior: float = 0.0,
               device=None) -> "DiffusionSchedule":
        betas = make_beta_schedule(schedule, timesteps, linear_start,
                                   linear_end, cosine_s)
        alphas = 1.0 - betas
        acp = np.cumprod(alphas, axis=0)
        acp_prev = np.append(1.0, acp[:-1])
        post_var = ((1 - v_posterior) * betas * (1.0 - acp_prev)
                    / (1.0 - acp) + v_posterior * betas)
        with np.errstate(divide="ignore"):
            lvlb = betas ** 2 / (2 * post_var * alphas * (1 - acp))
        lvlb[0] = lvlb[1]
        f = lambda a: _f32(a, device)  # noqa: E731
        return cls(
            betas=f(betas),
            alphas_cumprod=f(acp),
            alphas_cumprod_prev=f(acp_prev),
            sqrt_alphas_cumprod=f(np.sqrt(acp)),
            sqrt_one_minus_alphas_cumprod=f(np.sqrt(1.0 - acp)),
            log_one_minus_alphas_cumprod=f(np.log(1.0 - acp)),
            sqrt_recip_alphas_cumprod=f(np.sqrt(1.0 / acp)),
            sqrt_recipm1_alphas_cumprod=f(np.sqrt(1.0 / acp - 1)),
            posterior_variance=f(post_var),
            posterior_log_variance_clipped=f(
                np.log(np.maximum(post_var, 1e-20))),
            posterior_mean_coef1=f(betas * np.sqrt(acp_prev) / (1.0 - acp)),
            posterior_mean_coef2=f((1.0 - acp_prev) * np.sqrt(alphas)
                                   / (1.0 - acp)),
            num_timesteps=timesteps,
            lvlb_weights=f(lvlb),
        )


def q_sample(schedule: DiffusionSchedule, x_start: torch.Tensor,
             t: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """x_t ~ q(x_t | x_0) in one shot, in float32, cast back to x_start's
    dtype."""
    shp = (-1,) + (1,) * (x_start.ndim - 1)
    dev = x_start.device
    a = schedule.sqrt_alphas_cumprod.to(dev)[t].reshape(shp)
    s = schedule.sqrt_one_minus_alphas_cumprod.to(dev)[t].reshape(shp)
    out = a * x_start.float() + s * noise.float()
    return out.to(x_start.dtype)


def make_ddim_timesteps(num_ddim_timesteps: int, num_ddpm_timesteps: int,
                        method: str = "uniform") -> np.ndarray:
    """DDPM steps used by DDIM, ascending, with the reference's +1 shift
    (clamped for the degenerate S == T case)."""
    if method == "uniform":
        c = num_ddpm_timesteps // num_ddim_timesteps
        ts = np.asarray(list(range(0, num_ddpm_timesteps, c)))
    elif method == "quad":
        ts = (np.linspace(0, np.sqrt(num_ddpm_timesteps * 0.8),
                          num_ddim_timesteps) ** 2).astype(int)
    else:
        raise ValueError(f"unknown ddim discretization '{method}'")
    return np.minimum(ts + 1, num_ddpm_timesteps - 1)


@dataclasses.dataclass(frozen=True)
class DDIMSchedule:
    """Per-DDIM-step tables, ascending in t, length S. `timesteps` is a
    host int64 tensor (read without a device sync); the rest are float32
    on the schedule's device."""

    timesteps: torch.Tensor
    alphas: torch.Tensor
    alphas_prev: torch.Tensor
    sqrt_one_minus_alphas: torch.Tensor
    sigmas: torch.Tensor
    num_steps: int = 0

    @classmethod
    def create(cls, schedule: DiffusionSchedule, num_steps: int,
               eta: float = 0.0, method: str = "uniform") -> "DDIMSchedule":
        ts = make_ddim_timesteps(num_steps, schedule.num_timesteps, method)
        # from the f32 table, as the JAX tables are
        acp = schedule.alphas_cumprod.cpu().numpy().astype(np.float64)
        alphas = acp[ts]
        alphas_prev = np.concatenate([acp[:1], acp[ts[:-1]]])
        sigmas = eta * np.sqrt((1 - alphas_prev) / (1 - alphas)
                               * (1 - alphas / alphas_prev))
        dev = schedule.alphas_cumprod.device
        return cls(
            timesteps=torch.as_tensor(ts, dtype=torch.int64),
            alphas=_f32(alphas, dev),
            alphas_prev=_f32(alphas_prev, dev),
            sqrt_one_minus_alphas=_f32(np.sqrt(1.0 - alphas), dev),
            sigmas=_f32(sigmas, dev),
            num_steps=len(ts),
        )


def ddim_step(ddim: DDIMSchedule, x: torch.Tensor, eps: torch.Tensor,
              index: int, noise: Optional[torch.Tensor],
              temperature: float = 1.0
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One reverse DDIM update x_t -> x_{t_prev}; returns (x_prev,
    pred_x0), all in float32. `noise` may be None when sigma is 0."""
    x = x.float()
    eps = eps.float()
    dev = x.device
    a_t = ddim.alphas[index].to(dev)
    a_prev = ddim.alphas_prev[index].to(dev)
    sigma_t = ddim.sigmas[index].to(dev)
    sq1ma = ddim.sqrt_one_minus_alphas[index].to(dev)
    pred_x0 = (x - sq1ma * eps) / torch.sqrt(a_t)
    dir_xt = torch.sqrt(torch.clamp(1.0 - a_prev - sigma_t ** 2,
                                    min=0.0)) * eps
    x_prev = torch.sqrt(a_prev) * pred_x0 + dir_xt
    if noise is not None:
        x_prev = x_prev + sigma_t * temperature * noise.float()
    return x_prev, pred_x0


def timestep_embedding(t: torch.Tensor, dim: int,
                       max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal embedding [cos | sin] (ADM convention), float32."""
    half = dim // 2
    log_period = torch.log(torch.tensor(max_period, dtype=torch.float32))
    freqs = torch.exp(-log_period * torch.arange(half, dtype=torch.float32)
                      / half)
    args = t.float()[:, None] * freqs.to(t.device)[None, :]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb
