"""Multi-process plumbing over torch.distributed.

Counterpart of `rdm_tpu/parallel/distributed.py`: one process per card,
each a rank of one default process group.

- `initialize`: the process group, NCCL for CUDA ranks and gloo for CPU
  ranks; a no-op when it already exists or when the process runs alone.
- `host_info`: (rank, world).
- `shard_for_host`: the contiguous rows of a global batch this rank feeds,
  the input pipeline's contract (every rank loads its own slice).
- `gather_from_ranks`: the global batch from every rank's slice, in rank
  order (the counterpart of `global_array_from_local`).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist


def initialize(init_method: Optional[str] = None,
               world_size: Optional[int] = None,
               rank: Optional[int] = None, backend: Optional[str] = None,
               device: str = "cuda") -> None:
    """Idempotent `init_process_group`. With no arguments it reads the
    launcher's environment (RANK / WORLD_SIZE / MASTER_ADDR, as torchrun
    sets them) and is a no-op in a process started alone. `device`
    "cuda" takes NCCL and binds the rank to card rank % count; "cpu" takes
    gloo. A CUDA rank never falls back to gloo: without a card it
    raises."""
    if dist.is_initialized():
        return
    if init_method is None and world_size is None:
        if "WORLD_SIZE" not in os.environ:
            return  # alone in a process
        init_method = "env://"
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("initialize(device='cuda'): no CUDA device")
        backend = backend or "nccl"
    elif device == "cpu":
        backend = backend or "gloo"
    else:
        raise ValueError(f"initialize: device {device!r}, want 'cuda' or "
                         "'cpu'")
    if device == "cuda" and backend != "nccl":
        raise ValueError(f"initialize: CUDA ranks take NCCL, not {backend}")
    if rank is None:
        rank = int(os.environ.get("RANK", 0))
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", 1))
    if device == "cuda":
        local = int(os.environ.get("LOCAL_RANK",
                                   rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank)


def host_info() -> Tuple[int, int]:
    """(rank, world) of this process; (0, 1) without a process group."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def shard_for_host(global_batch: int) -> Tuple[int, int]:
    """(start, size) of this rank's contiguous slice of a global batch."""
    rank, world = host_info()
    if global_batch % world:
        raise ValueError(
            f"global batch {global_batch} not divisible by {world} ranks")
    per = global_batch // world
    return rank * per, per


def gather_from_ranks(local: torch.Tensor, group=None) -> torch.Tensor:
    """The rows of every rank of `group` (default: all) concatenated in
    rank order along dim 0; every rank passes a tensor of the same shape,
    on its own device, and gets the whole batch. Without a process group,
    or in a group of one, `local` itself."""
    if not dist.is_initialized():
        return local
    world = dist.get_world_size(group)
    if world == 1:
        return local
    local = local.contiguous()
    out = torch.empty((world * local.shape[0], *local.shape[1:]),
                      dtype=local.dtype, device=local.device)
    dist.all_gather_into_tensor(out, local, group=group)
    return out
