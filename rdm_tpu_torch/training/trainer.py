"""The RDM and RARM training loops.

Counterpart of `rdm_tpu/training/trainer.py` `RDMTrainer` and `RARMTrainer`
(the reference's Lightning main.py loop), on one card or, given a mesh,
one rank per card:

- the learning-rate scaling rule lr = accumulate x data ranks x batch x
  base_lr, batch the per-rank batch (the RARM trainer scales by
  accumulate as JAX does, though its optimizer never accumulates:
  ROADMAP.md §3);
- `prepare_batch`: NHWC host images in [-1, 1] -> the frozen VQ first
  stage: the RDM's `encode_prequant` x scale_factor -> NCHW latents, the
  RARM's `encode` -> code indices [B, h w]; plus the neighbours (the
  RARM's [B, n, k, D] flattened to [B, n k, D]);
- `fit`: the train step over a loader, scalar logging to
  <logdir>/metrics.jsonl and stdout with the JAX trainer's keys,
  checkpoints every ckpt_every steps (with `validate`'s EMA loss when a
  validation loader is given), on SIGUSR1, on an exception and at the
  end; `resume_or_init` continues from the newest checkpoint.

Under a mesh each rank's loader yields its own rows of the global batch
(`parallel.distributed.shard_for_host`); rank 0 alone logs and writes
checkpoints. param_sharding "fsdp" builds the model in host memory, as
the replicated path does, and puts only this rank's shards on the card
(`TrainState.shard`). A checkpoint holds whole tensors at any world size,
so a run resumes at another world size or sharding. Under a mesh SIGUSR1
saves nothing: a save gathers across ranks, and a signal stops each rank
at its own point of the loop.

The RDM's optimizer is `make_optimizer` (grad clip, accumulation and a
bf16 first moment as configured); the RARM's is `optax.adamw`'s (b2 0.95,
weight decay 1e-2) over the lambda-linear schedule, with no clip,
accumulation or mu_dtype, as the JAX RARM trainer builds it.
Parameters are f32 (the master weights); the model and the first stage
compute in `compute_dtype` (bf16 by default). Both run on `device="cuda"`
unless asked for the CPU (under a mesh: the card of this rank). Not ported yet: image logging
(`image_log_every` > 0) and TensorBoard, which need `diagnostics.py`;
they raise.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, Dict, Iterable, Optional

import numpy as np
import torch

from rdm_tpu_torch.config import AutoencoderConfig, RARMConfig, RDMConfig
from rdm_tpu_torch.models.autoencoder import VQModel
from rdm_tpu_torch.models.init import jax_init_
from rdm_tpu_torch.models.rarm import RARM
from rdm_tpu_torch.models.rdm import RDM
from rdm_tpu_torch.ops.schedules import DiffusionSchedule
from rdm_tpu_torch.parallel import mesh as pmesh
from rdm_tpu_torch.training.checkpoint import (CheckpointManager,
                                               install_signal_checkpoint)
from rdm_tpu_torch.training.ema import EmaState, ema_weights
from rdm_tpu_torch.training.optim import (AdamW, lambda_linear_schedule,
                                          make_optimizer)
from rdm_tpu_torch.training.train_state import (TrainState, fold_in,
                                                init_train_state,
                                                make_rarm_train_step,
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


class _Trainer:
    """What both trainers share: the lr scaling, the frozen VQ first
    stage, checkpoints, the metrics file, `resume_or_init`, `fit` and its
    logging. A subclass sets `tx` and `step_fn` and defines `init_state`,
    `prepare_batch` and `validate`."""

    # fsdp_spec's min_size for the FSDP state (JAX's default; a tiny model
    # needs a lower one to have leaves to cut)
    fsdp_min_size = 16384

    def __init__(self, trainer: TrainerConfig,
                 first_stage_config: AutoencoderConfig,
                 first_stage_state_dict: Dict[str, torch.Tensor],
                 mesh, batch_size: Optional[int], device: str,
                 compute_dtype: torch.dtype,
                 init_state_dict: Optional[Dict[str, torch.Tensor]]):
        if trainer.image_log_every > 0 or trainer.use_tensorboard:
            raise NotImplementedError(
                "image logging and TensorBoard need diagnostics.py, which "
                "is not ported: set image_log_every=0, use_tensorboard="
                "False")
        self.tcfg = trainer
        self.mesh = mesh
        self.n_data = pmesh.axis_size(mesh, pmesh.DATA_AXIS)
        self.device = (pmesh.mesh_device(mesh) if mesh is not None
                       else torch.device(device))
        self.lead = mesh is None or torch.distributed.get_rank() == 0
        self.fsdp = trainer.param_sharding == "fsdp"
        self.compute_dtype = compute_dtype
        self._init_sd = init_state_dict
        lr = trainer.base_lr
        if trainer.scale_lr and batch_size is not None:
            lr = (trainer.accumulate_grad_batches * self.n_data * batch_size
                  * trainer.base_lr)
            if self.lead:
                print(f"lr scaled to {lr:.3e} = accum("
                      f"{trainer.accumulate_grad_batches}) * devices("
                      f"{self.n_data}) * bs({batch_size}) * base("
                      f"{trainer.base_lr:.2e})")
        self.lr = lr
        self._lr_schedule = lambda_linear_schedule(
            lr, warm_up_steps=trainer.warm_up_steps)
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

    def _new_state(self, model: torch.nn.Module) -> TrainState:
        """The initial state of `model` (built in host memory): the given
        init_state_dict, else the JAX package's initialisers drawn from the
        trainer's seed (`models/init.jax_init_`); on the device whole, or,
        under FSDP, only this rank's shards on it. Under a replicated mesh
        the parameters are broadcast from data rank 0."""
        if self._init_sd is not None:
            model.load_state_dict(self._init_sd)
        else:
            jax_init_(model, torch.Generator().manual_seed(self.tcfg.seed))
        if self.fsdp:
            state = init_train_state(model, self.tx)
            return state.shard(self.mesh, self.fsdp_min_size,
                               device=self.device)
        state = init_train_state(model.to(self.device), self.tx)
        if self.mesh is not None:
            group = pmesh.axis_group(self.mesh, pmesh.DATA_AXIS)
            src = torch.distributed.get_global_rank(group, 0)
            for p in state.params.values():
                torch.distributed.broadcast(p.data, src, group=group)
            for n, p in state.params.items():
                state.ema.params[n].copy_(p.detach())
        return state

    def resume_or_init(self) -> TrainState:
        state = self.init_state()
        latest = self.ckpt.latest_step()
        if latest is not None:
            if self.lead:
                print(f"resuming from step {latest}")
            # a sharded state takes its slices from whole tensors read
            # into host memory
            where = "cpu" if state.layout is not None else self.device
            state.load_state_dict(self.ckpt.restore(latest,
                                                    map_location=where))
        return state

    def _images(self, batch: Dict[str, Any]) -> torch.Tensor:
        return torch.as_tensor(batch["image"], dtype=torch.float32,
                               device=self.device).permute(0, 3, 1, 2)

    def _neighbors(self, batch: Dict[str, Any]) -> torch.Tensor:
        return torch.as_tensor(batch["nn_embeddings"], dtype=torch.float32,
                               device=self.device)

    # ---------- loop ----------

    def fit(self, loader: Iterable, state: Optional[TrainState] = None,
            max_steps: Optional[int] = None,
            val_loader: Optional[Iterable] = None) -> TrainState:
        state = state if state is not None else self.resume_or_init()
        max_steps = max_steps or self.tcfg.max_steps
        seed = self.tcfg.seed + 1
        if self.mesh is None:  # a save under a mesh needs every rank
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
                    seen += z.shape[0] * self.n_data
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
            if state.layout is not None:
                # gathering the shards needs every rank, and the others
                # may be anywhere: no salvage
                print("exception - a sharded state is not salvaged")
                raise
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
        if not self.lead:
            return
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
        """Rank 0 writes whole tensors (a sharded state gathers them, every
        rank calling); the others wait for it under a mesh."""
        sd = state.state_dict()
        if self.lead:
            self.ckpt.save(state.step, sd,
                           metrics={k: float(v) for k, v in metrics.items()})
        if self.mesh is not None:
            torch.distributed.barrier()

    def _ema_model(self, state: TrainState):
        """The model under the EMA weights (whole: a sharded EMA is
        gathered onto the device for the body)."""
        ema = state.ema
        if state.layout is not None:
            ema = EmaState(state.full(ema.params, self.device), ema.count)
        return ema_weights(state.model, ema)

    def _mean(self, losses) -> float:
        """The mean of this rank's losses, over the data ranks too."""
        v = float(np.mean(losses)) if losses else float("nan")
        if self.mesh is None:
            return v
        t = torch.tensor([v], device=self.device)
        torch.distributed.all_reduce(
            t, group=pmesh.axis_group(self.mesh, pmesh.DATA_AXIS))
        return float(t) / self.n_data


class RDMTrainer(_Trainer):
    """`first_stage_state_dict`: the frozen VQ model's weights (port
    names). `init_state_dict`: optional RDM weights for `init_state`
    (otherwise the JAX package's initialisers drawn from `seed`)."""

    def __init__(self, config: RDMConfig, trainer: TrainerConfig,
                 first_stage_config: AutoencoderConfig,
                 first_stage_state_dict: Dict[str, torch.Tensor],
                 mesh=None, batch_size: Optional[int] = None,
                 device: str = "cuda",
                 compute_dtype: torch.dtype = torch.bfloat16,
                 init_state_dict: Optional[Dict[str, torch.Tensor]] = None):
        super().__init__(trainer, first_stage_config, first_stage_state_dict,
                         mesh, batch_size, device, compute_dtype,
                         init_state_dict)
        self.cfg = config
        self.schedule = DiffusionSchedule.create(
            config.timesteps, config.beta_schedule, config.linear_start,
            config.linear_end, device=self.device)
        self.tx = make_optimizer(
            self.lr, warm_up_steps=trainer.warm_up_steps,
            grad_clip=trainer.grad_clip,
            accumulate_steps=trainer.accumulate_grad_batches,
            mu_dtype=trainer.adam_mu_dtype)
        self.step_fn = make_train_step(
            self.tx, self.schedule, mesh=mesh, ema_decay=trainer.ema_decay,
            remat=trainer.remat, remat_policy=trainer.remat_policy,
            param_sharding=trainer.param_sharding)

    def init_state(self) -> TrainState:
        torch.manual_seed(self.tcfg.seed)
        return self._new_state(RDM(self.cfg, dtype=self.compute_dtype))

    @torch.no_grad()
    def prepare_batch(self, batch: Dict[str, Any]):
        """{'image' [B, H, W, 3] in [-1, 1], 'nn_embeddings' [B, n, k, D]}
        (numpy or tensors) -> (latents [B, C, h, w] in the compute dtype,
        f32 neighbours on the device)."""
        z = self.first_stage.encode_prequant(self._images(batch)) \
            * self.cfg.scale_factor
        return z, self._neighbors(batch)

    @torch.no_grad()
    def validate(self, state: TrainState, val_loader,
                 max_batches: Optional[int] = None) -> Dict[str, float]:
        """EMA-weighted validation loss (the reference's monitored
        val/loss_simple_ema), with draws fixed across evaluations."""
        max_batches = max_batches or self.tcfg.val_batches
        losses = []
        with self._ema_model(state) as model:
            model.train()  # as the JAX loss runs, deterministic=False
            for bi, batch in enumerate(val_loader):
                if bi >= max_batches:
                    break
                z, nns = self.prepare_batch(batch)
                _, m = model.training_loss(
                    z, nns, fold_in(0, bi, self.device), self.schedule)
                losses.append(float(m["loss_simple"]))
        return {"val/loss_simple_ema": self._mean(losses)}


class RARMTrainer(_Trainer):
    """The autoregressive family: images VQ-f16 encoded to code indices on
    the device, the transformer trained with teacher-forced cross-entropy
    (`make_rarm_train_step`; the reference's LatentImageRETRO with AdamW
    betas (0.9, 0.95), transformer.py:283-287). `first_stage_state_dict`
    and `init_state_dict` as for `RDMTrainer` (RARM weights)."""

    def __init__(self, config: RARMConfig, trainer: TrainerConfig,
                 first_stage_config: AutoencoderConfig,
                 first_stage_state_dict: Dict[str, torch.Tensor],
                 mesh=None, batch_size: Optional[int] = None,
                 device: str = "cuda",
                 compute_dtype: torch.dtype = torch.bfloat16,
                 init_state_dict: Optional[Dict[str, torch.Tensor]] = None):
        super().__init__(trainer, first_stage_config, first_stage_state_dict,
                         mesh, batch_size, device, compute_dtype,
                         init_state_dict)
        self.cfg = config
        self.tx = AdamW(self._lr_schedule, b1=0.9, b2=0.95,
                        weight_decay=1e-2)
        self.step_fn = make_rarm_train_step(
            self.tx, ema_decay=trainer.ema_decay,
            p_mask_max=config.p_mask_max, mesh=mesh,
            param_sharding=trainer.param_sharding)

    def init_state(self) -> TrainState:
        torch.manual_seed(self.tcfg.seed)
        return self._new_state(RARM(self.cfg, dtype=self.compute_dtype))

    @torch.no_grad()
    def prepare_batch(self, batch: Dict[str, Any]):
        """{'image' [B, H, W, 3] in [-1, 1], 'nn_embeddings' [B, n, k, D]
        or [B, S, D]} -> (code indices [B, h w] int64, f32 neighbours
        [B, n k, D] on the device)."""
        _, _, idx = self.first_stage.encode(self._images(batch))
        nns = self._neighbors(batch)
        if nns.ndim == 4:
            nns = nns.reshape(nns.shape[0], -1, nns.shape[-1])
        return idx.reshape(idx.shape[0], -1), nns

    @torch.no_grad()
    def validate(self, state: TrainState, val_loader,
                 max_batches: Optional[int] = None) -> Dict[str, float]:
        """EMA-weighted held-out CE loss (no mask-token draw, so the same
        batches give the same loss in every evaluation)."""
        max_batches = max_batches or self.tcfg.val_batches
        losses = []
        with self._ema_model(state) as model:
            for bi, batch in enumerate(val_loader):
                if bi >= max_batches:
                    break
                _, m = model.training_loss(*self.prepare_batch(batch))
                losses.append(float(m["loss"]))
        return {"val/loss_ema": self._mean(losses)}
