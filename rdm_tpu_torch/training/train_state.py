"""The train state and the train steps of the RDM and the RARM.

Counterpart of `rdm_tpu/training/train_state.py` on one device.

- `make_train_step` (RDM): draws from a generator folded in from (seed,
  step) -> `RDM.training_loss` in train mode -> backward -> the optimizer
  -> the EMA, with `grad_norm` (of the raw gradients) in the metrics. The
  U-Net's transformer blocks run unfused, their S >= 256 self-attention
  through the flash forward and backward kernels on the card; with
  RDM_TPU_FUSED_BLOCK_TRAIN=1 they run the fused block kernels forward
  under `ops/block_kernel.fused_transformer_block_ad` instead
  (`models/layers.SpatialTransformer`).
- `make_rarm_train_step` (RARM): the same plumbing over
  `RARM.training_loss`, with p_mask ~ U(0, p_mask_max) drawn each step
  when p_mask_max > 0; on the card every block's causal self-attention
  runs the flash kernels.

Not ported in this slice: `remat` (the JAX step's jax.checkpoint
policies), FSDP parameter sharding and a device mesh; asking for them
raises.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from rdm_tpu_torch.ops.schedules import DiffusionSchedule
from rdm_tpu_torch.training.ema import EmaState, ema_init, ema_update
from rdm_tpu_torch.training.optim import AdamW, AdamWState, global_norm


@dataclasses.dataclass
class TrainState:
    """step, the model (an RDM or a RARM, its f32 parameters), the
    optimizer state, the EMA."""

    step: int
    model: nn.Module
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


def init_train_state(model: nn.Module, tx: AdamW) -> TrainState:
    params = dict(model.named_parameters())
    return TrainState(step=0, model=model, opt_state=tx.init(params),
                      ema=ema_init(params))


def fold_in(seed: int, step: int, device) -> torch.Generator:
    """A generator on `device` seeded from (seed, step): the per-step draws
    of `jax.random.fold_in(key, step)`, so a resumed run draws what an
    uninterrupted one would."""
    s = np.random.SeedSequence([seed, step]).generate_state(2, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(s) >> 1)


def compute_grads(model: nn.Module, *args, **kwargs
                  ) -> Tuple[torch.Tensor, dict,
                             Dict[str, Optional[torch.Tensor]]]:
    """(loss, metrics, {name: grad or None}) of one
    `model.training_loss(*args, **kwargs)` evaluation in train mode; a
    parameter the loss does not reach gets None. The RDM's arguments are
    (z, neighbors, generator, schedule, **draws), the RARM's (z_indices,
    neighbors, generator=None, p_mask=None, *, mask=None); `draws` and
    `mask` are their test seams."""
    model.train()
    for p in model.parameters():
        p.grad = None
    loss, metrics = model.training_loss(*args, **kwargs)
    loss.backward()
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, {
        n: p.grad for n, p in model.named_parameters()}


# the RARM step's name for the same evaluation
compute_rarm_grads = compute_grads


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
    _refuse_unported(mesh, param_sharding)

    def train_step(state: TrainState, z, neighbors, seed: int, **draws):
        gen = fold_in(seed, state.step, z.device)
        _, metrics, grads = compute_grads(state.model, z, neighbors, gen,
                                          schedule, **draws)
        return _apply(state, grads, metrics, tx, ema_decay)

    return train_step


def _refuse_unported(mesh, param_sharding: str) -> None:
    if param_sharding != "replicated" or mesh is not None:
        raise NotImplementedError("FSDP / mesh training is not ported "
                                  "(ROADMAP.md)")


def _apply(state: TrainState, grads: Dict[str, Optional[torch.Tensor]],
           metrics: dict, tx: AdamW, ema_decay: float
           ) -> Tuple[TrainState, dict]:
    """The optimizer and the EMA over one step's gradients (zeros where
    the loss did not reach a parameter, as JAX's grads hold them), the
    step count, and `grad_norm` of the raw gradients."""
    params = state.params
    grads = {n: torch.zeros_like(params[n]) if g is None else g
             for n, g in grads.items()}
    tx.step(params, grads, state.opt_state)
    ema_update(state.ema, params, decay=ema_decay)
    state.step += 1
    metrics["grad_norm"] = global_norm(list(grads.values()))
    return state, metrics


def make_rarm_train_step(tx: AdamW, *, ema_decay: float = 0.9999,
                         p_mask_max: float = 0.0, mesh=None,
                         param_sharding: str = "replicated"
                         ) -> Callable[..., Tuple[TrainState, dict]]:
    """step(state, z_indices [B, S] int64, neighbors [B, S_ctx, D], seed,
    mask=None) -> (state, metrics), the state updated in place. The step's
    generator is folded in from (seed, step); with p_mask_max > 0 it draws
    p_mask ~ U(0, p_mask_max) first, then the mask-token draw (`mask`
    replaces the latter, as in `RARM.training_loss`)."""
    _refuse_unported(mesh, param_sharding)

    def train_step(state: TrainState, z_indices, neighbors, seed: int, *,
                   mask: Optional[torch.Tensor] = None):
        gen = fold_in(seed, state.step, z_indices.device)
        p_mask = None
        if p_mask_max > 0.0:
            p_mask = torch.rand((), generator=gen,
                                device=z_indices.device) * p_mask_max
        _, metrics, grads = compute_rarm_grads(state.model, z_indices,
                                               neighbors, gen, p_mask,
                                               mask=mask)
        return _apply(state, grads, metrics, tx, ema_decay)

    return train_step
