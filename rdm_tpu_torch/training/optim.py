"""Optimizer and learning-rate schedules.

Counterpart of `rdm_tpu/training/optim.py`: the ldm LambdaLinearScheduler
and LambdaWarmUpCosineScheduler, and `make_optimizer`, an AdamW with
optax's semantics (`optax.adamw` under `clip_by_global_norm` and
`MultiSteps`):

- bias-corrected moments, eps outside the square root;
- decoupled weight decay added to the Adam direction on every leaf
  (optax's default: no mask), then times -lr;
- the learning rate read at the schedule's count before its increment;
- `mu_dtype="bfloat16"` stores the first moment in bf16 (the second stays
  f32): the moment is formed in f32 from the bf16 one, as optax promotes;
- `grad_clip` scales all gradients by max_norm / global norm when that
  norm is not below max_norm;
- `accumulate_steps` > 1 averages gradients over that many calls (the
  Welford running mean of MultiSteps) and updates on the last of them;
  the other calls leave the parameters as they are.

`torch.optim.AdamW` has no bf16 first moment and keeps its own step
semantics, so the update is written here on `torch._foreach_*` lists. It
updates the parameters and the state in place (JAX returns new trees; in
place saves a copy of every leaf). `fused_update` of the JAX package, a
flat-vector layout measured no faster there, is not ported.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

Schedule = Callable[[int], float]


def lambda_linear_schedule(base_lr: float, warm_up_steps: int = 100,
                           f_start: float = 1e-6, f_max: float = 1.0,
                           f_min: float = 1.0,
                           cycle_length: float = 1e13) -> Schedule:
    """Linear warm-up f_start -> f_max over warm_up_steps, then linear
    toward f_min across the cycle (constant f_max in the released
    configs), times base_lr; in float32 as the JAX schedule computes it."""
    f32 = np.float32

    def schedule(step: int) -> float:
        step = f32(step)
        if step < warm_up_steps:
            f = f32(f_start) + f32(f_max - f_start) * (
                step / f32(max(warm_up_steps, 1)))
        else:
            frac = (step - f32(warm_up_steps)) / f32(cycle_length)
            f = f32(f_min) + f32(f_max - f_min) * (f32(1.0) - frac)
        return float(f32(base_lr) * f)

    return schedule


def lambda_warmup_cosine_schedule(base_lr: float, warm_up_steps: int,
                                  lr_max: float = 1.0, lr_min: float = 0.0,
                                  lr_start: float = 0.0,
                                  cycle_length: float = 1e12) -> Schedule:
    """Linear warm-up lr_start -> lr_max, then cosine decay toward lr_min
    over the cycle, times base_lr (float32)."""
    f32 = np.float32

    def schedule(step: int) -> float:
        step = f32(step)
        if step < warm_up_steps:
            f = f32(lr_start) + f32(lr_max - lr_start) * (
                step / f32(max(warm_up_steps, 1)))
        else:
            t = np.clip((step - f32(warm_up_steps)) / f32(cycle_length),
                        f32(0.0), f32(1.0))
            f = f32(lr_min) + f32(0.5) * f32(lr_max - lr_min) * (
                f32(1.0) + np.cos(f32(math.pi) * t))
        return float(f32(base_lr) * f)

    return schedule


SCHEDULES = {
    "lambda_linear": lambda_linear_schedule,
    "lambda_warmup_cosine": lambda_warmup_cosine_schedule,
}


@dataclasses.dataclass
class AdamWState:
    """Adam moments per parameter name, optax's counts, and the
    MultiSteps accumulator (None without accumulation)."""

    count: int
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]
    sched_count: int = 0
    mini_step: int = 0
    gradient_step: int = 0
    acc_grads: Optional[Dict[str, torch.Tensor]] = None

    def state_dict(self) -> dict:
        return dataclasses.asdict(self)

    def load_state_dict(self, sd: dict) -> None:
        """Copies sd's values into this state's tensors (their device and
        dtype) and counts."""
        for key in ("count", "sched_count", "mini_step", "gradient_step"):
            setattr(self, key, int(sd[key]))
        for key in ("mu", "nu", "acc_grads"):
            mine = getattr(self, key)
            if mine is None:
                continue
            for name, t in mine.items():
                t.copy_(sd[key][name])


def global_norm(tensors: List[torch.Tensor], *, group=None,
                sharded: Optional[List[bool]] = None) -> torch.Tensor:
    """sqrt of the sum of squares over all tensors (f32 scalar). Over an
    FSDP state's leaves, `sharded[i]` says tensor i is this rank's shard
    of a leaf cut across `group`: those squares are summed over the group,
    the whole leaves counted once, so every rank gets the whole
    gradient's norm."""
    norms = torch._foreach_norm([t.float() for t in tensors])
    if group is None:
        return torch.linalg.vector_norm(torch.stack(norms))
    sq = torch.stack(norms) ** 2
    cut = torch.tensor(sharded, device=sq.device)
    parts = torch.stack([sq[cut].sum(), sq[~cut].sum()])
    part = parts[:1].clone()
    dist.all_reduce(part, group=group)
    return torch.sqrt(part[0] + parts[1])


class AdamW:
    """optax.adamw(schedule, b1, b2, eps, weight_decay, mu_dtype) under
    clip_by_global_norm and MultiSteps, over named parameters."""

    def __init__(self, schedule: Schedule, *, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 1e-2,
                 mu_dtype: Optional[torch.dtype] = None,
                 grad_clip: Optional[float] = None,
                 accumulate_steps: int = 1):
        self.schedule = schedule
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.mu_dtype = mu_dtype
        self.grad_clip = grad_clip
        self.accumulate_steps = accumulate_steps

    def init(self, params: Dict[str, torch.Tensor]) -> AdamWState:
        zeros = lambda dt=None: {  # noqa: E731
            n: torch.zeros_like(p, dtype=dt or p.dtype)
            for n, p in params.items()}
        return AdamWState(
            count=0, mu=zeros(self.mu_dtype), nu=zeros(),
            acc_grads=zeros() if self.accumulate_steps > 1 else None)

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor],
             grads: Dict[str, torch.Tensor], state: AdamWState, *,
             group=None, sharded: Optional[List[bool]] = None) -> None:
        """One optimizer call: updates `params` and `state` in place.
        Over an FSDP state's shards, `group` / `sharded` give the clip the
        whole gradient's norm (`global_norm`)."""
        names = list(params)
        g = [grads[n].float() for n in names]
        k = self.accumulate_steps
        if k > 1:
            acc = [state.acc_grads[n] for n in names]
            # Welford running mean: acc + (g - acc) / (mini_step + 1)
            torch._foreach_add_(acc, torch._foreach_div(
                torch._foreach_sub(g, acc), float(state.mini_step + 1)))
            emit = state.mini_step == k - 1
            state.mini_step = (state.mini_step + 1) % k
            if not emit:
                return
            state.gradient_step += 1
            g = [a.clone() for a in acc]
            torch._foreach_zero_(acc)
        self._adamw([params[n] for n in names], g,
                    [state.mu[n] for n in names],
                    [state.nu[n] for n in names], state,
                    group=group, sharded=sharded)

    def _adamw(self, p: List[torch.Tensor], g: List[torch.Tensor],
               mu: List[torch.Tensor], nu: List[torch.Tensor],
               state: AdamWState, group=None,
               sharded: Optional[List[bool]] = None) -> None:
        b1, b2 = self.b1, self.b2
        if self.grad_clip:
            gn = global_norm(g, group=group, sharded=sharded)
            if not gn.item() < self.grad_clip:
                g = torch._foreach_mul(torch._foreach_div(g, gn),
                                       self.grad_clip)
        # (1 - b1) g + b1 mu, the sum in f32. Under a bf16 mu, optax's
        # weakly typed b1 * mu is a bf16 product: b1 rounded to bf16, the
        # product rounded to bf16.
        if self.mu_dtype is None:
            bmu = torch._foreach_mul(mu, b1)
        else:
            b1_lo = torch.tensor(b1).to(self.mu_dtype).item()
            bmu = [t.to(self.mu_dtype).float() for t in torch._foreach_mul(
                [t.float() for t in mu], b1_lo)]
        m32 = torch._foreach_add(torch._foreach_mul(g, 1.0 - b1), bmu)
        v = torch._foreach_add(
            torch._foreach_mul(torch._foreach_mul(g, g), 1.0 - b2),
            torch._foreach_mul(nu, b2))
        state.count += 1
        f32 = np.float32
        bc1 = float(f32(1.0) - f32(b1) ** f32(state.count))
        bc2 = float(f32(1.0) - f32(b2) ** f32(state.count))
        denom = torch._foreach_add(
            torch._foreach_sqrt(torch._foreach_div(v, bc2)), self.eps)
        u = torch._foreach_div(torch._foreach_div(m32, bc1), denom)
        if self.weight_decay:
            u = torch._foreach_add(u, torch._foreach_mul(p, self.weight_decay))
        lr = self.schedule(state.sched_count)
        state.sched_count += 1
        torch._foreach_add_(p, torch._foreach_mul(u, float(f32(-lr))))
        for dst, src in zip(mu, m32):
            dst.copy_(src)  # rounds to bf16 under mu_dtype
        for dst, src in zip(nu, v):
            dst.copy_(src)


def make_optimizer(base_lr: float, *, warm_up_steps: int = 100,
                   weight_decay: float = 1e-2, b1: float = 0.9,
                   b2: float = 0.999, grad_clip: Optional[float] = None,
                   accumulate_steps: int = 1,
                   schedule_name: str = "lambda_linear",
                   mu_dtype: Optional[str] = None) -> AdamW:
    """The JAX package's `make_optimizer` (without `fused_update`):
    mu_dtype "bfloat16" keeps the first moment in bf16."""
    schedule = SCHEDULES[schedule_name](base_lr,
                                        warm_up_steps=warm_up_steps)
    return AdamW(schedule, b1=b1, b2=b2, weight_decay=weight_decay,
                 mu_dtype=getattr(torch, mu_dtype) if mu_dtype else None,
                 grad_clip=grad_clip, accumulate_steps=accumulate_steps)
