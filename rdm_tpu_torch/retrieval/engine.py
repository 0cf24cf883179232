"""Exact k-NN retrieval over a device-resident embedding table, in PyTorch.

Counterpart of `rdm_tpu/retrieval/engine.py` on one device: the table and
the queries are L2-normalised, scores are f32 dot products, the returned
embeddings are the UNNORMALISED rows (reference dsetbuilder.py:510), and
ties go to the lower id (the JAX engine's merge rule). The search itself is
the kernel pair of `ops/knn_kernel.py` on the card, its plain version (a
stable descending sort) on the CPU. Unlike the JAX engine, which pads the
table and clamps padding ids to N - 1, k > N raises.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from rdm_tpu_torch.ops import knn_kernel


def l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1,
                                        keepdim=True).clamp_min(eps)


def knn_search(db_norm: torch.Tensor, queries: torch.Tensor, k: int, *,
               impl: Optional[str] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k dot-product search of normalised queries [B, D] against the
    normalised table [N, D]: (scores [B, k] f32, ids [B, k] int64), sorted
    by descending score, ties by ascending id. impl=None launches the
    kernel pair for a CUDA table (the plain version for a CPU one);
    impl="reference" runs the plain version on any device."""
    if impl is None:
        return knn_kernel.knn_topk(db_norm, queries, k)
    if impl == "reference":
        return knn_kernel.knn_search_reference(db_norm, queries, k)
    raise ValueError(f"knn_search: impl={impl!r}, want None or 'reference'")


def gather_unnormalized(db_norm: torch.Tensor, row_norms: torch.Tensor,
                        ids: torch.Tensor) -> torch.Tensor:
    """UNNORMALISED f32 rows by id: db_norm[id] * row_norms[id]."""
    return db_norm[ids].float() * row_norms[ids][..., None]


class RetrievalEngine:
    """Searcher bound to a data pool, holding the normalised table and the
    per-row norms on `device`."""

    def __init__(self, pool, device=None, dtype: torch.dtype = torch.bfloat16):
        self.pool = pool
        self.db_norm, self.row_norms = pool.device_table(device=device,
                                                         dtype=dtype)

    @property
    def size(self) -> int:
        return self.pool.size

    @property
    def device(self) -> torch.device:
        return self.db_norm.device

    def search(self, query_embeddings, k: int, *,
               gather_embeddings: bool = True) -> dict:
        """query_embeddings [B, D] unnormalised -> {'nns' [B, k],
        'scores' [B, k]} on the table's device, and with
        gather_embeddings 'embeddings' [B, k, D] f32, plus 'img_ids' /
        'patch_coords' when the pool has them."""
        q = torch.as_tensor(query_embeddings, dtype=torch.float32,
                            device=self.device)
        scores, nns = knn_search(self.db_norm, l2_normalize(q), k)
        out = {"nns": nns, "scores": scores}
        if not gather_embeddings:
            return out
        out["embeddings"] = gather_unnormalized(self.db_norm, self.row_norms,
                                                nns)
        if self.pool.img_ids is not None or self.pool.patch_coords is not None:
            ids = nns.cpu().numpy()
            if self.pool.img_ids is not None:
                out["img_ids"] = np.asarray(self.pool.img_ids)[ids]
            if self.pool.patch_coords is not None:
                out["patch_coords"] = np.asarray(self.pool.patch_coords)[ids]
        return out
