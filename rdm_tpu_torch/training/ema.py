"""Exponential moving average of the parameters.

Counterpart of `rdm_tpu/training/ema.py` (LitEma's schedule): an f32
shadow of every parameter, updated after each optimizer call with the
warm-up decay min(decay, (1 + n) / (10 + n)), n the update count. The
shadow is a copy that never aliases the live parameters; it is updated in
place.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict

import numpy as np
import torch


@dataclasses.dataclass
class EmaState:
    params: Dict[str, torch.Tensor]  # f32 shadow per parameter name
    count: int = 0

    def state_dict(self) -> dict:
        return {"params": self.params, "count": self.count}

    def load_state_dict(self, sd: dict) -> None:
        self.count = int(sd["count"])
        for name, t in self.params.items():
            t.copy_(sd["params"][name])


def ema_init(params: Dict[str, torch.Tensor]) -> EmaState:
    return EmaState({n: p.detach().float().clone()
                     for n, p in params.items()})


@torch.no_grad()
def ema_update(state: EmaState, params: Dict[str, torch.Tensor],
               decay: float = 0.9999) -> None:
    """shadow -= (1 - d) (shadow - p), d = min(decay, (1 + n) / (10 + n))
    in f32 with n the count after this update."""
    state.count += 1
    f32 = np.float32
    d = min(f32(decay), f32(1.0 + state.count) / f32(10.0 + state.count))
    names = list(state.params)
    shadow = [state.params[n] for n in names]
    diff = torch._foreach_sub(shadow, [params[n].detach().float()
                                       for n in names])
    torch._foreach_sub_(shadow, torch._foreach_mul(diff, float(f32(1.0) - d)))


@contextlib.contextmanager
def ema_weights(model: torch.nn.Module, state: EmaState):
    """Runs the body with the model's parameters swapped for the EMA
    shadow (no copy: the parameters' storage is exchanged and restored)."""
    live = {n: p.data for n, p in model.named_parameters()}
    try:
        for n, p in model.named_parameters():
            p.data = state.params[n]
        yield model
    finally:
        for n, p in model.named_parameters():
            p.data = live[n]
