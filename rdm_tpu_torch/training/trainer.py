"""The RDM training loop.

Counterpart of `rdm_tpu/training/trainer.py` `RDMTrainer` (the reference's
Lightning main.py loop) on one device:

- the learning-rate scaling rule lr = accumulate x devices x batch x
  base_lr;
- `prepare_batch`: NHWC host images in [-1, 1] -> the frozen VQ first
  stage's `encode_prequant` x scale_factor -> NCHW latents, plus the
  neighbours;
- `fit`: the train step over a loader, scalar logging to
  <logdir>/metrics.jsonl and stdout with the JAX trainer's keys,
  checkpoints every ckpt_every steps (with `validate`'s EMA loss when a
  validation loader is given), on SIGUSR1, on an exception and at the
  end; `resume_or_init` continues from the newest checkpoint.

Parameters are f32 (the master weights); the U-Net and the first stage
compute in `compute_dtype` (bf16 by default). It runs on `device="cuda"`
unless asked for the CPU. Not ported yet: image logging
(`image_log_every` > 0) and TensorBoard, which need `diagnostics.py`, and
the RARM trainer; they raise.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, Dict, Iterable, Optional

import numpy as np
import torch

from rdm_tpu_torch.config import AutoencoderConfig, RDMConfig
from rdm_tpu_torch.models.autoencoder import VQModel
from rdm_tpu_torch.models.rdm import RDM
from rdm_tpu_torch.ops.schedules import DiffusionSchedule
from rdm_tpu_torch.training.checkpoint import (CheckpointManager,
                                               install_signal_checkpoint)
from rdm_tpu_torch.training.ema import ema_weights
from rdm_tpu_torch.training.optim import lambda_linear_schedule, \
    make_optimizer
from rdm_tpu_torch.training.train_state import (TrainState, fold_in,
                                                init_train_state,
                                                make_train_step)


@dataclasses.dataclass
class TrainerConfig:
    """Field-for-field mirror of the JAX package's TrainerConfig."""

    logdir: str = "logs/run"
    base_lr: float = 1e-4
    scale_lr: bool = True
    max_steps: int = 100_000
    log_every: int = 50
    ckpt_every: int = 1000
    image_log_every: int = 5000
    image_log_steps: int = 20
    accumulate_grad_batches: int = 1
    ema_decay: float = 0.9999
    warm_up_steps: int = 100
    grad_clip: Optional[float] = None
    seed: int = 0
    monitor: str = "val/loss_simple_ema"
    max_ckpts: int = 3
    use_tensorboard: bool = False
    val_every: int = 0
    val_batches: int = 8
    remat: bool = False
    remat_policy: str = "dots"
    adam_mu_dtype: Optional[str] = None
    param_sharding: str = "replicated"


class RDMTrainer:
    """`first_stage_state_dict`: the frozen VQ model's weights (port
    names). `init_state_dict`: optional RDM weights for `init_state`
    (otherwise the module's own initialisation under `seed`)."""

    def __init__(self, config: RDMConfig, trainer: TrainerConfig,
                 first_stage_config: AutoencoderConfig,
                 first_stage_state_dict: Dict[str, torch.Tensor],
                 mesh=None, batch_size: Optional[int] = None,
                 device: str = "cuda",
                 compute_dtype: torch.dtype = torch.bfloat16,
                 init_state_dict: Optional[Dict[str, torch.Tensor]] = None):
        if trainer.image_log_every > 0 or trainer.use_tensorboard:
            raise NotImplementedError(
                "image logging and TensorBoard need diagnostics.py, which "
                "is not ported: set image_log_every=0, use_tensorboard="
                "False")
        self.cfg = config
        self.tcfg = trainer
        self.device = torch.device(device)
        self.compute_dtype = compute_dtype
        self._init_sd = init_state_dict
        lr = trainer.base_lr
        if trainer.scale_lr and batch_size is not None:
            lr = trainer.accumulate_grad_batches * batch_size * trainer.base_lr
            print(f"lr scaled to {lr:.3e} = accum("
                  f"{trainer.accumulate_grad_batches}) * devices(1) * bs("
                  f"{batch_size}) * base({trainer.base_lr:.2e})")
        self.lr = lr
        self.schedule = DiffusionSchedule.create(
            config.timesteps, config.beta_schedule, config.linear_start,
            config.linear_end, device=self.device)
        self.tx = make_optimizer(
            lr, warm_up_steps=trainer.warm_up_steps,
            grad_clip=trainer.grad_clip,
            accumulate_steps=trainer.accumulate_grad_batches,
            mu_dtype=trainer.adam_mu_dtype)
        self._lr_schedule = lambda_linear_schedule(
            lr, warm_up_steps=trainer.warm_up_steps)
        self.step_fn = make_train_step(
            self.tx, self.schedule, mesh=mesh, ema_decay=trainer.ema_decay,
            remat=trainer.remat, remat_policy=trainer.remat_policy,
            param_sharding=trainer.param_sharding)
        self.first_stage = VQModel(first_stage_config, dtype=compute_dtype)
        self.first_stage.load_state_dict(first_stage_state_dict)
        self.first_stage.to(self.device).eval().requires_grad_(False)
        os.makedirs(trainer.logdir, exist_ok=True)
        self.ckpt = CheckpointManager(
            os.path.join(trainer.logdir, "checkpoints"),
            max_to_keep=trainer.max_ckpts, monitor=trainer.monitor)
        self._metrics_f = open(
            os.path.join(trainer.logdir, "metrics.jsonl"), "a")

    # ---------- state ----------

    def init_state(self) -> TrainState:
        torch.manual_seed(self.tcfg.seed)
        model = RDM(self.cfg, dtype=self.compute_dtype)
        if self._init_sd is not None:
            model.load_state_dict(self._init_sd)
        return init_train_state(model.to(self.device), self.tx)

    def resume_or_init(self) -> TrainState:
        state = self.init_state()
        latest = self.ckpt.latest_step()
        if latest is not None:
            print(f"resuming from step {latest}")
            state.load_state_dict(self.ckpt.restore(latest,
                                                    map_location=self.device))
        return state

    # ---------- batch plumbing ----------

    @torch.no_grad()
    def prepare_batch(self, batch: Dict[str, Any]):
        """{'image' [B, H, W, 3] in [-1, 1], 'nn_embeddings' [B, n, k, D]}
        (numpy or tensors) -> (latents [B, C, h, w] in the compute dtype,
        f32 neighbours on the device)."""
        x = torch.as_tensor(batch["image"], dtype=torch.float32,
                            device=self.device).permute(0, 3, 1, 2)
        z = self.first_stage.encode_prequant(x) * self.cfg.scale_factor
        nns = torch.as_tensor(batch["nn_embeddings"], dtype=torch.float32,
                              device=self.device)
        return z, nns

    # ---------- loop ----------

    @torch.no_grad()
    def validate(self, state: TrainState, val_loader,
                 max_batches: Optional[int] = None) -> Dict[str, float]:
        """EMA-weighted validation loss (the reference's monitored
        val/loss_simple_ema), with draws fixed across evaluations."""
        max_batches = max_batches or self.tcfg.val_batches
        losses = []
        with ema_weights(state.model, state.ema) as model:
            model.train()  # as the JAX loss runs, deterministic=False
            for bi, batch in enumerate(val_loader):
                if bi >= max_batches:
                    break
                z, nns = self.prepare_batch(batch)
                _, m = model.training_loss(
                    z, nns, fold_in(0, bi, self.device), self.schedule)
                losses.append(float(m["loss_simple"]))
        return {"val/loss_simple_ema":
                float(np.mean(losses)) if losses else float("nan")}

    def fit(self, loader: Iterable, state: Optional[TrainState] = None,
            max_steps: Optional[int] = None,
            val_loader: Optional[Iterable] = None) -> TrainState:
        state = state if state is not None else self.resume_or_init()
        max_steps = max_steps or self.tcfg.max_steps
        seed = self.tcfg.seed + 1
        install_signal_checkpoint(lambda: self._save(state, {}))
        t0 = time.time()
        seen = 0
        step = state.step
        try:
            while step < max_steps:
                for batch in loader:
                    if step >= max_steps:
                        break
                    z, nns = self.prepare_batch(batch)
                    state, metrics = self.step_fn(state, z, nns, seed)
                    seen += z.shape[0]
                    if step % self.tcfg.log_every == 0:
                        self._log(step, metrics, seen, time.time() - t0)
                    if step and step % self.tcfg.ckpt_every == 0:
                        metrics = dict(metrics)
                        if val_loader is not None:
                            val = self.validate(state, val_loader)
                            metrics.update(val)
                            self._log(step, val, seen, time.time() - t0)
                        self._save(state, metrics)
                    step += 1
        except BaseException:
            print("exception - saving checkpoint before exit")
            try:
                self._save(state, {})
            except Exception as save_err:
                print(f"checkpoint salvage failed: {save_err!r}")
            raise
        self._save(state, {})
        return state

    # ---------- logging / ckpt ----------

    def _log(self, step: int, metrics: Dict[str, Any], seen: int,
             elapsed: float) -> None:
        row = {k: float(v) for k, v in metrics.items()}
        row.update(step=step, samples_seen=seen, wall_s=round(elapsed, 1),
                   samples_per_sec=round(seen / max(elapsed, 1e-9), 2),
                   lr=self._lr_schedule(step))
        if self.device.type == "cuda":
            row["hbm_gb"] = round(
                torch.cuda.memory_allocated(self.device) / 2**30, 2)
        self._metrics_f.write(json.dumps(row) + "\n")
        self._metrics_f.flush()
        print(f"step {step}: " + " ".join(
            f"{k}={v:.4g}" for k, v in row.items() if k != "step"))

    def _save(self, state: TrainState, metrics: Dict[str, Any]) -> None:
        self.ckpt.save(state.step, state.state_dict(),
                       metrics={k: float(v) for k, v in metrics.items()})
