"""The RDM train state and train step.

Counterpart of `rdm_tpu/training/train_state.py` on one device. A step:
draws from a generator folded in from (seed, step) -> `RDM.training_loss`
in train mode (the U-Net's transformer blocks unfused, their S >= 256
self-attention through the flash forward and backward kernels on the
card) -> backward -> the optimizer -> the EMA, with `grad_norm` (of the
raw gradients) in the metrics.

Not ported in this slice: `remat` (the JAX step's jax.checkpoint
policies), FSDP parameter sharding and a device mesh; asking for them
raises. The RARM step waits for the RARM trainer.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from rdm_tpu_torch.models.rdm import RDM
from rdm_tpu_torch.ops.schedules import DiffusionSchedule
from rdm_tpu_torch.training.ema import EmaState, ema_init, ema_update
from rdm_tpu_torch.training.optim import AdamW, AdamWState, global_norm


@dataclasses.dataclass
class TrainState:
    """step, the model (its f32 parameters), the optimizer state, the EMA."""

    step: int
    model: RDM
    opt_state: AdamWState
    ema: EmaState

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())

    def state_dict(self) -> dict:
        return {"step": self.step, "params": self.model.state_dict(),
                "opt_state": self.opt_state.state_dict(),
                "ema": self.ema.state_dict()}

    def load_state_dict(self, sd: dict) -> None:
        """Copies a `state_dict()` (or `utils.from_jax.train_state_from_jax`
        output) into this state's tensors, keeping their devices and
        dtypes."""
        self.step = int(sd["step"])
        self.model.load_state_dict(sd["params"])
        self.opt_state.load_state_dict(sd["opt_state"])
        self.ema.load_state_dict(sd["ema"])


def init_train_state(model: RDM, tx: AdamW) -> TrainState:
    params = dict(model.named_parameters())
    return TrainState(step=0, model=model, opt_state=tx.init(params),
                      ema=ema_init(params))


def fold_in(seed: int, step: int, device) -> torch.Generator:
    """A generator on `device` seeded from (seed, step): the per-step draws
    of `jax.random.fold_in(key, step)`, so a resumed run draws what an
    uninterrupted one would."""
    s = np.random.SeedSequence([seed, step]).generate_state(2, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(s) >> 1)


def compute_grads(model: RDM, z: torch.Tensor, neighbors: torch.Tensor,
                  generator: torch.Generator, schedule: DiffusionSchedule,
                  **draws) -> Tuple[torch.Tensor, dict,
                                    Dict[str, Optional[torch.Tensor]]]:
    """(loss, metrics, {name: grad or None}) of one training-loss
    evaluation in train mode; a parameter the loss does not reach gets
    None. `draws` are `RDM.training_loss`'s test seam."""
    model.train()
    for p in model.parameters():
        p.grad = None
    loss, metrics = model.training_loss(z, neighbors, generator, schedule,
                                        **draws)
    loss.backward()
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, {
        n: p.grad for n, p in model.named_parameters()}


def make_train_step(tx: AdamW, schedule: DiffusionSchedule, *,
                    mesh=None, ema_decay: float = 0.9999,
                    remat: bool = False, remat_policy: str = "dots",
                    param_sharding: str = "replicated"
                    ) -> Callable[..., Tuple[TrainState, dict]]:
    """step(state, z [B, C, H, W], neighbors [B, n, k, D], seed, **draws)
    -> (state, metrics); `z` is the encoded, scaled latent batch. The
    state is updated in place and returned."""
    del remat_policy  # only read with remat
    if remat:
        raise NotImplementedError("remat is not ported (ROADMAP.md)")
    if param_sharding != "replicated" or mesh is not None:
        raise NotImplementedError("FSDP / mesh training is not ported "
                                  "(ROADMAP.md)")

    def train_step(state: TrainState, z, neighbors, seed: int, **draws):
        gen = fold_in(seed, state.step, z.device)
        _, metrics, grads = compute_grads(state.model, z, neighbors, gen,
                                          schedule, **draws)
        params = state.params
        grads = {n: torch.zeros_like(params[n]) if g is None else g
                 for n, g in grads.items()}
        tx.step(params, grads, state.opt_state)
        ema_update(state.ema, params, decay=ema_decay)
        state.step += 1
        metrics["grad_norm"] = global_norm(list(grads.values()))
        return state, metrics

    return train_step
