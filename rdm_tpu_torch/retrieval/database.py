"""Retrieval data pool and nn-memory, in PyTorch.

Counterpart of `rdm_tpu/retrieval/database.py` (which imports jax, so it is
mirrored here): the same `.npz` chunk format (`embedding [N, D]`,
optional `img_id [N]` and `patch_coords [N, 4]`, reference
dsetbuilder.py:199-259) and nn-memory pickles (`{'nn_memory', 'id_count'}`,
ddpm.py:168-176). Embeddings are a torch tensor, on the host when loaded
from disk or on any device when built from arrays. The device table needs
no padding: there are no TPU tiles to align. `DataPool.save` writes chunks
the JAX `DataPool.load` reads; `NNMemory.build_from_queries` builds a
memory by searching a query set, letting any error propagate.
"""

from __future__ import annotations

import dataclasses
import glob as globlib
import os
import pickle
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

# rows normalised per step when building the device table
_CHUNK = 262144


@dataclasses.dataclass
class DataPool:
    """Unnormalised embeddings + provenance metadata."""

    embeddings: torch.Tensor  # [N, D]
    img_ids: Optional[np.ndarray] = None  # [N]
    patch_coords: Optional[np.ndarray] = None  # [N, 4]

    def __post_init__(self):
        self.embeddings = torch.as_tensor(self.embeddings)

    @property
    def size(self) -> int:
        return self.embeddings.shape[0]

    @property
    def dim(self) -> int:
        return self.embeddings.shape[1]

    @classmethod
    def load(cls, path: str) -> "DataPool":
        """Load one npz file or a directory of npz chunks."""
        if os.path.isfile(path):
            files = [path]
        elif os.path.isdir(path):
            files = sorted(globlib.glob(os.path.join(path, "*.npz")))
            if not files:
                raise FileNotFoundError(f"no npz chunks under {path}")
        else:
            raise FileNotFoundError(path)
        embs, ids, coords = [], [], []
        for f in files:
            with np.load(f) as data:
                embs.append(np.asarray(data["embedding"]))
                if "img_id" in data:
                    ids.append(np.asarray(data["img_id"]))
                if "patch_coords" in data:
                    coords.append(np.asarray(data["patch_coords"]))
        return cls(
            embeddings=torch.from_numpy(np.concatenate(embs, axis=0)),
            img_ids=np.concatenate(ids, axis=0) if ids else None,
            patch_coords=np.concatenate(coords, axis=0) if coords else None)

    def save(self, path: str, chunk_size: int = 2_000_000) -> List[str]:
        """Compressed npz chunks of `chunk_size` rows in the reference
        format (`<rows>x<dim>-part<i:04d>.npz`, dsetbuilder.py:238-259),
        which the JAX `DataPool.load` reads; returns the file names."""
        os.makedirs(path, exist_ok=True)
        emb = self.embeddings.detach().cpu().numpy()
        written = []
        for start in range(0, self.size, chunk_size):
            end = min(start + chunk_size, self.size)
            payload: Dict[str, np.ndarray] = {"embedding": emb[start:end]}
            if self.img_ids is not None:
                payload["img_id"] = np.asarray(self.img_ids)[start:end]
            if self.patch_coords is not None:
                payload["patch_coords"] = np.asarray(
                    self.patch_coords)[start:end]
            fname = os.path.join(path, f"{end - start}x{self.dim}-part"
                                 f"{start // chunk_size:04d}.npz")
            np.savez_compressed(fname, **payload)
            written.append(fname)
        return written

    def device_table(self, device=None, dtype: torch.dtype = torch.bfloat16,
                     start: int = 0, stop: Optional[int] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(L2-normalised table [N, D] in `dtype`, f32 row norms [N]) on
        `device`, normalised in f32 chunk by chunk; rows [start, stop)
        only, for a row shard."""
        device = self.embeddings.device if device is None else device
        stop = self.size if stop is None else stop
        table = torch.empty((stop - start, self.dim), dtype=dtype,
                            device=device)
        norms = torch.empty((stop - start,), dtype=torch.float32,
                            device=device)
        for s in range(start, stop, _CHUNK):
            e = min(s + _CHUNK, stop)
            rows = self.embeddings[s:e].to(device, torch.float32)
            n = torch.linalg.vector_norm(rows, dim=1)
            norms[s - start:e - start] = n
            table[s - start:e - start] = (rows / n.clamp_min(1e-12)[:, None]
                                          ).to(dtype)
        return table, norms


@dataclasses.dataclass
class NNMemory:
    """Top-M most frequent database ids for unconditional sampling
    (reference ddpm.py:847-875 `get_qids`)."""

    ids: np.ndarray  # [M] int, by decreasing frequency
    id_count: Optional[Dict[int, int]] = None

    @classmethod
    def load(cls, path: str) -> "NNMemory":
        # unpickling runs code: load only nn-memory files this project wrote
        with open(path, "rb") as f:
            data = pickle.load(f)
        return cls(ids=np.asarray(data["nn_memory"], dtype=np.int64),
                   id_count=data.get("id_count"))

    def save(self, path: str) -> None:
        with open(path, "wb") as f:
            pickle.dump({"nn_memory": self.ids, "id_count": self.id_count}, f)

    @classmethod
    def build_from_queries(cls, engine, query_embeddings,
                           k: int = 20, batch_size: int = 256,
                           top_m: Optional[int] = None) -> "NNMemory":
        """The memory of the ids a query set retrieves from `engine` at k
        (the NNMemoryDataset job, reference base.py:43-104), searched
        `batch_size` queries at a time. Unlike the JAX package, which
        retries a failing batch and then skips it, an error propagates: a
        skipped batch would hide a failed kernel."""
        ids = [engine.search(query_embeddings[s:s + batch_size], k=k,
                             gather_embeddings=False)["nns"].cpu().numpy()
               for s in range(0, len(query_embeddings), batch_size)]
        return cls.build(np.concatenate(ids, axis=0), top_m=top_m)

    @classmethod
    def build(cls, neighbor_ids: np.ndarray, top_m: Optional[int] = None
              ) -> "NNMemory":
        """From retrieved ids [num_queries, k] (or flat): the distinct ids
        by decreasing count, with the counts (the JAX `NNMemory.build`)."""
        flat = np.asarray(neighbor_ids).reshape(-1)
        ids, counts = np.unique(flat, return_counts=True)
        order = np.argsort(-counts)
        ids, counts = ids[order], counts[order]
        if top_m is not None:
            ids, counts = ids[:top_m], counts[:top_m]
        return cls(ids=ids.astype(np.int64),
                   id_count={int(i): int(c) for i, c in zip(ids, counts)})

    def sample_qids(self, n: int, memsize=0.01, *, use_weights: bool = False,
                    rng: Optional[np.random.Generator] = None) -> np.ndarray:
        """n query ids from the top-`memsize` of the memory (a fraction in
        (0, 1] or an absolute count); use_weights samples proportionally
        to the observed neighbor frequency."""
        rng = rng or np.random.default_rng()
        if isinstance(memsize, float):
            if not 0.0 < memsize <= 1.0:
                raise ValueError("fractional memsize must be in (0,1]")
            memsize = int(memsize * len(self.ids))
        memsize = max(1, min(memsize, len(self.ids)))
        pool = self.ids[:memsize]
        p = None
        if use_weights:
            if not self.id_count:
                raise ValueError("use_weights requires id_count")
            freqs = np.asarray([self.id_count[int(i)] for i in pool],
                               dtype=np.float64)
            p = freqs / freqs.sum()
        return rng.choice(pool, size=n, p=p)
