"""The (data, db) device mesh and the FSDP layout.

Counterpart of `rdm_tpu/parallel/mesh.py`. One mesh of two named axes over
all ranks of the default process group
(`torch.distributed.device_mesh.init_device_mesh`):

- ``data``: data parallelism. Batches are split over it; the train step
  averages gradients over it (replicated state) or reduce-scatters them
  into the rank's shards (FSDP state).
- ``db``: the retrieval table's rows are split over it; a search is a
  per-shard top-k plus a cross-shard merge (`retrieval/engine.py`).

`fsdp_spec` is JAX's rule, copied: shard a leaf on its largest dim that
divides by the shard count, and keep leaves under `min_size` elements
whole. It returns the dim (or None) where JAX returns a PartitionSpec.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
DB_AXIS = "db"


def make_mesh(data: Optional[int] = None, db: int = 1):
    """The global (data, db) mesh over every rank of the process group
    (`distributed.initialize` first); its device type follows the
    group's backend, cuda under NCCL, cpu under gloo. data=None puts every
    rank the db axis leaves on data. Unlike a JAX mesh, which may take a
    subset of the devices, the mesh covers the whole group."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group; call "
                           "rdm_tpu_torch.parallel.distributed.initialize")
    n = dist.get_world_size()
    if data is None:
        if n % db:
            raise ValueError(f"{n} ranks not divisible by db={db}")
        data = n // db
    if data * db > n:
        raise ValueError(f"mesh ({data},{db}) needs {data * db} ranks, "
                         f"have {n}")
    if data * db != n:
        raise ValueError(f"mesh ({data},{db}) must cover all {n} ranks")
    from torch.distributed.device_mesh import init_device_mesh
    device = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device, (data, db),
                            mesh_dim_names=(DATA_AXIS, DB_AXIS))


def axis_size(mesh, axis: str) -> int:
    """Ranks along `axis` (1 without a mesh)."""
    return 1 if mesh is None else mesh.size(mesh.mesh_dim_names.index(axis))


def axis_rank(mesh, axis: str) -> int:
    """This rank's coordinate along `axis` (0 without a mesh)."""
    return 0 if mesh is None else mesh.get_local_rank(axis)


def axis_group(mesh, axis: str):
    """The process group of this rank's line along `axis`."""
    return mesh.get_group(axis)


def mesh_device(mesh) -> torch.device:
    """The device this rank's tensors live on under `mesh`."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def fsdp_spec(shape: Sequence[int], n_shards: int,
              min_size: int = 16384) -> Optional[int]:
    """The dim to shard a leaf of `shape` on over n_shards ranks: the
    largest that divides (the first of equals, as JAX's stable sort
    gives), or None to keep it whole (fewer than min_size elements, or no
    dim divides)."""
    if not shape or int(np.prod(shape)) < min_size:
        return None
    for d in sorted(range(len(shape)), key=lambda i: -shape[i]):
        if shape[d] % n_shards == 0 and shape[d] >= n_shards:
            return d
    return None


def shard_of(full: torch.Tensor, dim: Optional[int], n_shards: int,
             rank: int) -> torch.Tensor:
    """This rank's slice of `full` along `dim` (the whole tensor for
    None), a view."""
    if dim is None:
        return full
    return full.chunk(n_shards, dim=dim)[rank]


def gather_dim(shard: torch.Tensor, dim: Optional[int], group
               ) -> torch.Tensor:
    """The whole leaf from every rank's `shard` along `dim` (a new
    tensor; the shard's own clone for dim None)."""
    if dim is None:
        return shard.clone()
    world = dist.get_world_size(group)
    moved = shard.movedim(dim, 0).contiguous()
    out = torch.empty((world * moved.shape[0], *moved.shape[1:]),
                      dtype=shard.dtype, device=shard.device)
    dist.all_gather_into_tensor(out, moved, group=group)
    return out.movedim(0, dim).contiguous()


def reduce_scatter_mean(full: torch.Tensor, dim: Optional[int], group
                        ) -> torch.Tensor:
    """The mean over `group` of every rank's `full`, this rank's slice
    along `dim` of it (the whole mean for dim None)."""
    world = dist.get_world_size(group)
    if dim is None:
        out = full.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out.div_(world)
    moved = full.movedim(dim, 0).contiguous()
    out = torch.empty((moved.shape[0] // world, *moved.shape[1:]),
                      dtype=full.dtype, device=full.device)
    dist.reduce_scatter_tensor(out, moved, group=group)
    return out.div_(world).movedim(0, dim)


def shard_train_state(state, mesh, min_size: int = 16384):
    """The FSDP layout of a replicated `TrainState`, in place: params,
    both Adam moments and the EMA shadow cut to this rank's `fsdp_spec`
    shards over the data axis (`TrainState.shard`)."""
    return state.shard(mesh, min_size)
