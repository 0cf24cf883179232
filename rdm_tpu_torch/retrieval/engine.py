"""Exact k-NN retrieval over a device-resident embedding table, in PyTorch.

Counterpart of `rdm_tpu/retrieval/engine.py`: the table and the queries
are L2-normalised, scores are f32 dot products, the returned embeddings
are the UNNORMALISED rows (reference dsetbuilder.py:510), and ties go to
the lower id (the JAX engine's merge rule). The search itself is the
kernel pair of `ops/knn_kernel.py` on the card, its plain version (a
stable descending sort) on the CPU. Unlike the JAX engine, which pads the
table and clamps padding ids to N - 1, k > N raises.

Under a mesh whose `db` axis has s > 1 ranks the table's rows are split
into s shards, rank r holding rows [r N / s, (r + 1) N / s): each rank
searches its shard through the same kernel pair, adds its first row to
the ids, all-gathers the (score, id) candidates over `db` (k s per query,
never the scores) and merges them by score, ties by ascending global id,
as JAX's top_k over the shard-ordered concatenation does.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from rdm_tpu_torch.ops import knn_kernel
from rdm_tpu_torch.parallel import mesh as pmesh


def l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1,
                                        keepdim=True).clamp_min(eps)


def _search(db_norm, queries, k, impl):
    if impl is None:
        return knn_kernel.knn_topk(db_norm, queries, k)
    if impl == "reference":
        return knn_kernel.knn_search_reference(db_norm, queries, k)
    raise ValueError(f"knn_search: impl={impl!r}, want None or 'reference'")


def _db_shards(mesh, n: int) -> Tuple[int, int]:
    """(shard count, this rank's first row) of an n-row table over the
    mesh's db axis; n must divide by the count, as in JAX."""
    s = pmesh.axis_size(mesh, pmesh.DB_AXIS)
    if n % s:
        raise ValueError(f"table of {n} rows does not divide into {s} db "
                         "shards")
    return s, pmesh.axis_rank(mesh, pmesh.DB_AXIS) * (n // s)


def knn_search(db_norm: torch.Tensor, queries: torch.Tensor, k: int, *,
               impl: Optional[str] = None, mesh=None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k dot-product search of normalised queries [B, D] against the
    normalised table [N, D]: (scores [B, k] f32, ids [B, k] int64), sorted
    by descending score, ties by ascending id. impl=None launches the
    kernel pair for a CUDA table (the plain version for a CPU one);
    impl="reference" runs the plain version on any device. With a mesh
    whose db axis is larger than 1, every rank passes the whole table and
    searches its row shard of it (a view at the shard's first row), then
    the shards' candidates are merged (`knn_search_shard`)."""
    if pmesh.axis_size(mesh, pmesh.DB_AXIS) == 1:
        return _search(db_norm, queries, k, impl)
    s, start = _db_shards(mesh, db_norm.shape[0])
    shard = db_norm[start:start + db_norm.shape[0] // s]
    return knn_search_shard(shard, start, queries, k, mesh, impl=impl)


def knn_search_shard(shard: torch.Tensor, start: int, queries: torch.Tensor,
                     k: int, mesh, *, impl: Optional[str] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The db-sharded search from this rank's rows [start, start + n) of
    the table: its top-k (k <= n), ids offset by start, then the merge of
    every db rank's candidates. Every rank of the db group calls it with
    the same queries and gets the same answer."""
    scores, ids = _search(shard, queries, k, impl)
    return merge_shards(scores, ids + start, k,
                        pmesh.axis_group(mesh, pmesh.DB_AXIS))


def merge_shards(scores: torch.Tensor, ids: torch.Tensor, k: int, group
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The global top-k from every rank's [B, k] candidates: all-gathered
    in rank order (shard order, so ascending ids among equal scores), then
    a stable descending sort by score."""
    s = dist.get_world_size(group)
    b = scores.shape[0]

    def gathered(t):
        out = torch.empty((s * b, t.shape[1]), dtype=t.dtype,
                          device=t.device)
        dist.all_gather_into_tensor(out, t.contiguous(), group=group)
        return out.view(s, b, -1).transpose(0, 1).reshape(b, -1)

    return merge_candidates(gathered(scores), gathered(ids), k)


def merge_candidates(scores: torch.Tensor, ids: torch.Tensor, k: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The top-k of [B, s k] candidates laid out shard after shard: a
    stable descending sort by score, so equal scores keep the shards'
    order, which is ascending global id."""
    order = torch.sort(scores, dim=1, descending=True,
                       stable=True).indices[:, :k]
    return scores.gather(1, order), ids.gather(1, order)


def gather_unnormalized(db_norm: torch.Tensor, row_norms: torch.Tensor,
                        ids: torch.Tensor) -> torch.Tensor:
    """UNNORMALISED f32 rows by id: db_norm[id] * row_norms[id]."""
    return db_norm[ids].float() * row_norms[ids][..., None]


class RetrievalEngine:
    """Searcher bound to a data pool, holding the normalised table and the
    per-row norms on `device`; under a mesh with db ranks, only this
    rank's row shard of them (the pool's rows must divide)."""

    def __init__(self, pool, device=None, dtype: torch.dtype = torch.bfloat16,
                 mesh=None):
        self.pool = pool
        self.mesh = mesh
        s, self.start = _db_shards(mesh, pool.size)
        self.sharded = s > 1
        self.db_norm, self.row_norms = pool.device_table(
            device=device, dtype=dtype, start=self.start,
            stop=self.start + pool.size // s)

    @property
    def size(self) -> int:
        return self.pool.size

    @property
    def device(self) -> torch.device:
        return self.db_norm.device

    def _top(self, queries: torch.Tensor, k: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.sharded:
            return knn_search_shard(self.db_norm, self.start, queries, k,
                                    self.mesh)
        return knn_search(self.db_norm, queries, k)

    def neighbors(self, queries: torch.Tensor, k: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(scores, ids, unnormalised f32 embeddings [B, k, D]) of
        normalised queries [B, D]. Sharded, each rank gathers the rows it
        holds and a sum over db assembles the rest."""
        scores, nns = self._top(queries, k)
        if not self.sharded:
            return scores, nns, gather_unnormalized(self.db_norm,
                                                    self.row_norms, nns)
        local = nns - self.start
        mine = (local >= 0) & (local < self.db_norm.shape[0])
        local = local.clamp(0, self.db_norm.shape[0] - 1)
        emb = gather_unnormalized(self.db_norm, self.row_norms, local)
        emb = emb * mine[..., None]
        dist.all_reduce(emb, group=pmesh.axis_group(self.mesh,
                                                    pmesh.DB_AXIS))
        return scores, nns, emb

    def search(self, query_embeddings, k: int, *,
               gather_embeddings: bool = True) -> dict:
        """query_embeddings [B, D] unnormalised -> {'nns' [B, k],
        'scores' [B, k]} on the table's device, and with
        gather_embeddings 'embeddings' [B, k, D] f32, plus 'img_ids' /
        'patch_coords' when the pool has them."""
        q = torch.as_tensor(query_embeddings, dtype=torch.float32,
                            device=self.device)
        qn = l2_normalize(q)
        if not gather_embeddings:
            scores, nns = self._top(qn, k)
            return {"nns": nns, "scores": scores}
        scores, nns, emb = self.neighbors(qn, k)
        out = {"nns": nns, "scores": scores, "embeddings": emb}
        if self.pool.img_ids is not None or self.pool.patch_coords is not None:
            ids = nns.cpu().numpy()
            if self.pool.img_ids is not None:
                out["img_ids"] = np.asarray(self.pool.img_ids)[ids]
            if self.pool.patch_coords is not None:
                out["patch_coords"] = np.asarray(self.pool.patch_coords)[ids]
        return out
