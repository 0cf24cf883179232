"""The train state and the train steps of the RDM and the RARM.

Counterpart of `rdm_tpu/training/train_state.py`.

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

remat (RDM step): JAX wraps the loss in `jax.checkpoint` and XLA schedules
the recompute. Eager PyTorch recomputes a checkpointed region whole when
its backward starts, so one region the size of the loss would bring every
activation back at once and save nothing. The port checkpoints each U-Net
block instead (`UNet._region`: each input block, the middle block, each
output block, the output head; non-reentrant `torch.utils.checkpoint`,
the default generator's state kept for dropout), and the policy says what
a region keeps (`remat_region`). The draws are made outside the regions,
so a recompute never draws again from the step's explicit generator.

Data parallelism (`mesh`, its `data` axis): each rank steps on its rows
of the global batch; every draw is made at the global batch's shape and
cut to the rank's rows, so n ranks step as one process on the whole
batch. param_sharding "replicated" averages the gradients over `data`
(one all-reduce a bucket, after the backward) before the optimizer;
"fsdp" keeps params, both Adam moments and the EMA as this rank's
`fsdp_spec` shards (`TrainState.shard`), gathers the whole parameters
into the model for the forward and backward, reduce-scatters the
gradients into the shards and frees the whole parameters again.
`grad_norm` and the grad clip are over the whole gradient either way.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from rdm_tpu_torch.ops.schedules import DiffusionSchedule
from rdm_tpu_torch.parallel import mesh as pmesh
from rdm_tpu_torch.training.ema import EmaState, ema_init, ema_update
from rdm_tpu_torch.training.optim import AdamW, AdamWState, global_norm

@dataclasses.dataclass
class Layout:
    """Where a sharded state's leaves lie: the data axis's group, its size
    and this rank's place on it, and per parameter the dim it is cut on
    (None: kept whole on every rank) and its whole shape."""

    group: Any
    world: int
    rank: int
    dims: Dict[str, Optional[int]]
    shapes: Dict[str, torch.Size]


@dataclasses.dataclass
class TrainState:
    """step, the model (an RDM or a RARM, its f32 parameters), the
    optimizer state, the EMA. Sharded (FSDP, `shard`): `shards` holds this
    rank's slice of every parameter, the moments and the EMA hold slices
    too, and the model's parameters are empty between steps."""

    step: int
    model: nn.Module
    opt_state: AdamWState
    ema: EmaState
    layout: Optional[Layout] = None
    shards: Optional[Dict[str, torch.Tensor]] = None

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        """What the optimizer updates: the model's parameters, or this
        rank's shards of them."""
        if self.layout is not None:
            return self.shards
        return dict(self.model.named_parameters())

    # ---------- the FSDP layout ----------

    def shard(self, mesh, min_size: int = 16384,
              device: Optional[torch.device] = None) -> "TrainState":
        """Cuts this replicated state, in place, to this rank's
        `fsdp_spec` shards over the mesh's data axis, moved to `device`
        (default: where the state lies); the model's parameters are
        emptied on that device. A state built in host memory thus never
        has a whole replica on the card."""
        if self.layout is not None:
            raise ValueError("the state is already sharded")
        n = pmesh.axis_size(mesh, pmesh.DATA_AXIS)
        r = pmesh.axis_rank(mesh, pmesh.DATA_AXIS)
        named = dict(self.model.named_parameters())
        device = device or next(iter(named.values())).device
        dims = {k: pmesh.fsdp_spec(p.shape, n, min_size)
                for k, p in named.items()}
        self.layout = Layout(pmesh.axis_group(mesh, pmesh.DATA_AXIS), n, r,
                             dims, {k: p.shape for k, p in named.items()})

        def cut(tree):
            return {k: pmesh.shard_of(t.detach(), dims[k], n, r).to(
                device, copy=True).contiguous() for k, t in tree.items()}

        self.shards = cut(named)
        st = self.opt_state
        st.mu, st.nu = cut(st.mu), cut(st.nu)
        if st.acc_grads is not None:
            st.acc_grads = cut(st.acc_grads)
        self.ema.params = cut(self.ema.params)
        self.release()
        self.model.to(device)  # the buffers and the emptied parameters
        return self

    def gather(self) -> None:
        """The whole parameters into the model from every rank's shards
        (leaves kept whole are the shards themselves)."""
        lay = self.layout
        for k, p in self.model.named_parameters():
            sh = self.shards[k]
            p.data = (sh if lay.dims[k] is None
                      else pmesh.gather_dim(sh, lay.dims[k], lay.group))

    def release(self) -> None:
        """Empties the model's parameters and gradients (sharded state)."""
        for p in self.model.parameters():
            p.data = p.data.new_empty(0)
            p.grad = None

    def full(self, tree: Dict[str, torch.Tensor], device=None
             ) -> Dict[str, torch.Tensor]:
        """The whole leaves of a parameter-shaped tree: gathered leaf by
        leaf from the shards (every rank calls it) and moved to `device`
        (default: the CPU, so no whole replica collects on the card), or
        the tree itself when the state is not sharded."""
        lay = self.layout
        if lay is None:
            return tree
        device = device or torch.device("cpu")
        return {k: pmesh.gather_dim(t, lay.dims[k], lay.group).to(device)
                for k, t in tree.items()}

    def state_dict(self) -> dict:
        """One format at any world size: whole tensors (a sharded state
        gathers them, every rank calling, onto the CPU)."""
        if self.layout is None:
            return {"step": self.step, "params": self.model.state_dict(),
                    "opt_state": self.opt_state.state_dict(),
                    "ema": self.ema.state_dict()}
        opt = self.opt_state.state_dict()
        for key in ("mu", "nu", "acc_grads"):
            if opt[key] is not None:
                opt[key] = self.full(opt[key])
        return {"step": self.step, "params": self.full(self.shards),
                "opt_state": opt,
                "ema": {"params": self.full(self.ema.params),
                        "count": self.ema.count}}

    def load_state_dict(self, sd: dict) -> None:
        """Copies a `state_dict()` (or `utils.from_jax.train_state_from_jax`
        output) into this state's tensors, keeping their devices and
        dtypes; a sharded state takes its rank's slice of each leaf."""
        self.step = int(sd["step"])
        lay = self.layout
        if lay is None:
            self.model.load_state_dict(sd["params"])
            self.opt_state.load_state_dict(sd["opt_state"])
            self.ema.load_state_dict(sd["ema"])
            return

        def mine(tree):
            return {k: pmesh.shard_of(t, lay.dims[k], lay.world, lay.rank)
                    for k, t in tree.items()}

        if sorted(sd["params"]) != sorted(self.shards):
            raise KeyError("state dict keys differ from the model's "
                           "parameters")
        for k, t in mine(sd["params"]).items():
            self.shards[k].copy_(t)
        opt = dict(sd["opt_state"])
        for key in ("mu", "nu", "acc_grads"):
            if opt.get(key) is not None:
                opt[key] = mine(opt[key])
        self.opt_state.load_state_dict(opt)
        self.ema.load_state_dict({"params": mine(sd["ema"]["params"]),
                                  "count": sd["ema"]["count"]})


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


# ---------------------------------------------------------------- remat

_aten = torch.ops.aten
# jax.checkpoint_policies.dots_saveable: every dot_general and
# conv_general_dilated output; dots_with_no_batch_dims_saveable: the
# dot_generals without batch dims (the 2-D products), and no conv
_SAVED_OPS = {
    "dots": [_aten.mm.default, _aten.addmm.default, _aten.bmm.default,
             _aten.baddbmm.default, _aten.convolution.default],
    "nothing": None,
    "dots_no_batch": [_aten.mm.default, _aten.addmm.default],
    "save_lowres": None,
}
# save_only_these_names("blk_ds2", ..., "blk_ds32"): the U-Net keeps its
# lower-resolution blocks and recomputes the full-resolution ones
LOWRES_TAGS = ("blk_ds2", "blk_ds4", "blk_ds8", "blk_ds16", "blk_ds32")


def remat_region(policy: str) -> Callable[..., Any]:
    """The runner `UNet._region` calls under `policy`: (tag, fn, *args)
    -> fn(*args) inside a checkpoint region. "dots" and "dots_no_batch"
    keep their products' outputs (selective checkpointing), "nothing"
    keeps only the region's inputs; "save_lowres" runs the regions tagged
    blk_ds2 ... blk_ds32 whole (all their activations kept) and
    checkpoints the full-resolution ones keeping nothing. Hand kernels
    called through ctypes are not aten ops, so every policy recomputes
    them, as JAX's policies recompute a pallas_call."""
    if policy not in _SAVED_OPS:
        raise ValueError(f"unknown remat_policy {policy!r}, want one of "
                         f"{sorted(_SAVED_OPS)}")
    from torch.utils.checkpoint import (checkpoint,
                                        create_selective_checkpoint_contexts)
    ops = _SAVED_OPS[policy]
    kw = ({} if ops is None else {"context_fn": functools.partial(
        create_selective_checkpoint_contexts, ops)})

    def run(tag: str, fn, *args):
        if policy == "save_lowres" and tag in LOWRES_TAGS:
            return fn(*args)
        return checkpoint(fn, *args, use_reentrant=False, **kw)

    return run


@contextlib.contextmanager
def remat_scope(model: nn.Module, region):
    """The RDM's U-Net runs its blocks through `region` (a
    `remat_region` runner, or None for no remat) for the body."""
    if region is None:
        yield
        return
    unet = model.unet
    unet.remat = region
    try:
        yield
    finally:
        unet.remat = None


# ------------------------------------------------------ data parallelism

class _Sync:
    """What a train step does across the data axis: the rank's rows of
    the global batch, the whole parameters around the backward (FSDP),
    the gradients' mean, the metrics' mean."""

    def __init__(self, mesh, param_sharding: str):
        if param_sharding not in ("replicated", "fsdp"):
            raise ValueError(f"unknown param_sharding '{param_sharding}'")
        if param_sharding == "fsdp" and mesh is None:
            raise ValueError("param_sharding='fsdp' needs a mesh "
                             "(parallel.mesh.make_mesh)")
        self.mesh = mesh
        self.fsdp = param_sharding == "fsdp"
        if mesh is not None:
            self.group = pmesh.axis_group(mesh, pmesh.DATA_AXIS)
            self.world = pmesh.axis_size(mesh, pmesh.DATA_AXIS)
            self.rank = pmesh.axis_rank(mesh, pmesh.DATA_AXIS)

    def draw_kw(self, batch: int) -> dict:
        """training_loss's `rows` under a mesh."""
        if self.mesh is None:
            return {}
        return {"rows": (self.rank * batch, self.world * batch)}

    @contextlib.contextmanager
    def whole_params(self, state: TrainState):
        if self.fsdp != (state.layout is not None):
            raise ValueError(
                "param_sharding='fsdp' takes a sharded state "
                "(parallel.mesh.shard_train_state) and 'replicated' an "
                "unsharded one")
        if not self.fsdp:
            yield
            return
        state.gather()
        try:
            yield
        finally:
            state.release()

    def grads(self, state: TrainState,
              grads: Dict[str, Optional[torch.Tensor]]
              ) -> Dict[str, torch.Tensor]:
        """The step's gradients for `state.params`: zeros where the loss
        did not reach a parameter (as JAX's grads hold them), averaged
        over the data axis, or this rank's shard of the average."""
        named = dict(state.model.named_parameters())
        grads = {n: torch.zeros_like(named[n]) if g is None else g
                 for n, g in grads.items()}
        if self.mesh is None:
            return grads
        if self.fsdp:
            dims = state.layout.dims
            return {n: pmesh.reduce_scatter_mean(g, dims[n], self.group)
                    for n, g in grads.items()}
        _all_reduce_mean(list(grads.values()), self.group)
        return grads

    def metrics(self, metrics: dict) -> dict:
        if self.mesh is None or not metrics:
            return metrics
        keys = list(metrics)
        v = torch.stack([metrics[k].float() for k in keys])
        dist.all_reduce(v, group=self.group)
        v /= self.world
        return dict(zip(keys, v.unbind()))

    def norm_kw(self, state: TrainState) -> dict:
        """global_norm's view of a sharded state's leaves."""
        if state.layout is None:
            return {}
        dims = state.layout.dims
        return {"group": self.group,
                "sharded": [dims[n] is not None for n in state.params]}


def _all_reduce_mean(tensors: List[torch.Tensor], group,
                     bucket: int = 1 << 26) -> None:
    """Each tensor replaced by its mean over `group`: one all-reduce per
    bucket of up to `bucket` elements (a tensor larger than that alone)."""
    world = dist.get_world_size(group)
    i = 0
    while i < len(tensors):
        j, n = i, 0
        while j < len(tensors) and (j == i
                                    or n + tensors[j].numel() <= bucket):
            n += tensors[j].numel()
            j += 1
        flat = torch.cat([t.reshape(-1) for t in tensors[i:j]])
        dist.all_reduce(flat, group=group)
        flat /= world
        off = 0
        for t in tensors[i:j]:
            t.copy_(flat[off:off + t.numel()].view_as(t))
            off += t.numel()
        i = j


def _apply(state: TrainState, grads: Dict[str, torch.Tensor],
           metrics: dict, tx: AdamW, ema_decay: float, sync: _Sync
           ) -> Tuple[TrainState, dict]:
    """The optimizer and the EMA over one step's gradients (already in
    `state.params`' layout), the step count, and `grad_norm` of the raw
    gradients over the whole gradient."""
    params = state.params
    norm_kw = sync.norm_kw(state)
    tx.step(params, grads, state.opt_state, **norm_kw)
    ema_update(state.ema, params, decay=ema_decay)
    state.step += 1
    metrics = sync.metrics(metrics)
    metrics["grad_norm"] = global_norm([grads[n] for n in params], **norm_kw)
    return state, metrics


def make_train_step(tx: AdamW, schedule: DiffusionSchedule, *,
                    mesh=None, ema_decay: float = 0.9999,
                    remat: bool = False, remat_policy: str = "dots",
                    param_sharding: str = "replicated",
                    fsdp_min_size: int = 16384
                    ) -> Callable[..., Tuple[TrainState, dict]]:
    """step(state, z [B, C, H, W], neighbors [B, n, k, D], seed, **draws)
    -> (state, metrics); `z` is the encoded, scaled latent batch, under a
    mesh this rank's rows of the global batch (`draws` then global). The
    state is updated in place and returned. remat_policy: "dots",
    "nothing", "dots_no_batch" or "save_lowres" (`remat_region`).
    param_sharding "fsdp" takes a state sharded by
    `parallel.mesh.shard_train_state(state, mesh, fsdp_min_size)`."""
    del fsdp_min_size  # the state's layout carries it
    region = remat_region(remat_policy) if remat else None
    sync = _Sync(mesh, param_sharding)

    def train_step(state: TrainState, z, neighbors, seed: int, **draws):
        gen = fold_in(seed, state.step, z.device)
        with sync.whole_params(state), remat_scope(state.model, region):
            _, metrics, grads = compute_grads(
                state.model, z, neighbors, gen, schedule,
                **sync.draw_kw(z.shape[0]), **draws)
            grads = sync.grads(state, grads)
        return _apply(state, grads, metrics, tx, ema_decay, sync)

    return train_step


def make_rarm_train_step(tx: AdamW, *, ema_decay: float = 0.9999,
                         p_mask_max: float = 0.0, mesh=None,
                         param_sharding: str = "replicated",
                         fsdp_min_size: int = 16384
                         ) -> Callable[..., Tuple[TrainState, dict]]:
    """step(state, z_indices [B, S] int64, neighbors [B, S_ctx, D], seed,
    mask=None) -> (state, metrics), the state updated in place. The step's
    generator is folded in from (seed, step); with p_mask_max > 0 it draws
    p_mask ~ U(0, p_mask_max) first, then the mask-token draw (`mask`
    replaces the latter, as in `RARM.training_loss`). Under a mesh the
    batch is this rank's rows and `mask` the global one, as for
    `make_train_step`."""
    del fsdp_min_size  # the state's layout carries it
    sync = _Sync(mesh, param_sharding)

    def train_step(state: TrainState, z_indices, neighbors, seed: int, *,
                   mask: Optional[torch.Tensor] = None):
        gen = fold_in(seed, state.step, z_indices.device)
        p_mask = None
        if p_mask_max > 0.0:
            p_mask = torch.rand((), generator=gen,
                                device=z_indices.device) * p_mask_max
        with sync.whole_params(state):
            _, metrics, grads = compute_rarm_grads(
                state.model, z_indices, neighbors, gen, p_mask, mask=mask,
                **sync.draw_kw(z_indices.shape[0]))
            grads = sync.grads(state, grads)
        return _apply(state, grads, metrics, tx, ema_decay, sync)

    return train_step
