"""Exact top-k dot-product search: one hand-written CUDA kernel pair.

Counterpart of `rdm_tpu/ops/knn_kernel.py` `_knn_kernel` /
`knn_search_fused` (csrc/knn_topk.cu, two launches: a TMA + wgmma search
that gives each stripe's top-k lists, reading the table once per group of
up to 256 queries, then one merge per query). Queries [B, D] are cast to
the table's dtype and scored against the normalised table [N, D] (the
kernel sums the products in f32, the plain version in f64 rounded to
f32); the k best come back as (scores [B, k] f32, ids [B, k] int64),
ordered by score descending, ties to the lower id.

`knn_topk` runs the plain version `knn_search_reference` only for tensors
on the CPU; for a CUDA table it launches the kernels or raises (a bf16
table, D a multiple of 16). Both refuse k > N (the JAX engine pads the
table and returns padding ids there, clamped to N - 1) and k > 128 (the
Pallas kernel's scratch width). `plan` fixes the query groups, the
cluster, the ring and the stripe split the kernel runs, and
`knn_search_reference(slice_rows=)` computes the same per-stripe top-k
followed by the merge, so the CPU tests hold the merge rule the kernel
relies on (tests/test_torch_port_knn_tiles.py also emulates its walk).
Each launch adds one to `launch_counts()["knn"]`: two per search.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional, Tuple

import torch

from rdm_tpu_torch.ops import _build

MAX_K = 128           # the Pallas kernel's scratch width
QUERY_GROUPS = (8, 16, 32, 64)  # queries a CTA holds: wgmma's N
MAX_CLUSTER = 4       # CTAs that share each table box by TMA multicast
CHUNK_ROWS = 128      # table rows of a chunk and a stage: two wgmma M tiles
CANDIDATES = 16       # candidate slots per query (kCand)
MERGE_AT = 8          # a buffer this full is merged (kMergeAt)
MIN_STAGES, MAX_STAGES = 3, 8  # ring stages of one box each
MAX_MERGE = 16384     # candidates one merge CTA sorts (kMaxMerge)
SMEM_LIMIT = 232448   # dynamic shared memory a block may use on sm_90
_SCORE_CHUNK = 65536  # table rows per f64 product of the plain version
KERNEL_NAMES = ("knn",)
_launches = dict.fromkeys(KERNEL_NAMES, 0)


def check_k(k: int, n: int) -> None:
    """Raise unless 1 <= k <= min(N, MAX_K)."""
    if not 1 <= k <= MAX_K:
        raise ValueError(f"knn: k={k}, the search takes 1 <= k <= {MAX_K}")
    if k > n:
        raise ValueError(f"knn: k={k} neighbours asked of a table of {n} "
                         "rows")


def _score(q: torch.Tensor, db: torch.Tensor) -> torch.Tensor:
    """[B, D] x [N, D] -> [B, N] f32 dot products of the db-dtype-rounded
    query against the table, summed in f64 and rounded once to f32: equal
    rows score equally wherever they sit (a BLAS f32 product may sum two
    columns in different orders), and the sums stay within an f32
    rounding of f32 ones."""
    qd = q.to(db.dtype).double()
    out = torch.empty((q.shape[0], db.shape[0]), dtype=torch.float32,
                      device=db.device)
    for s in range(0, db.shape[0], _SCORE_CHUNK):
        out[:, s:s + _SCORE_CHUNK] = qd @ db[s:s + _SCORE_CHUNK].double().t()
    return out


def _top(scores: torch.Tensor, k: int):
    """The first k of a stable descending sort: ties keep column order."""
    vals, ids = torch.sort(scores, dim=1, descending=True, stable=True)
    return vals[:, :k], ids[:, :k]


def knn_search_reference(db_norm: torch.Tensor, queries: torch.Tensor,
                         k: int, *, slice_rows: Optional[int] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version: scores of the whole table (`_score`), then a
    stable descending sort. With `slice_rows`, the top-k of each slice of that
    many rows, then a stable sort of the slices' candidates in slice order:
    the kernel's split, with the same result."""
    n = db_norm.shape[0]
    check_k(k, n)
    if slice_rows is None:
        return _top(_score(queries, db_norm), k)
    cand_s, cand_i = [], []
    for s in range(0, n, slice_rows):
        v, i = _top(_score(queries, db_norm[s:s + slice_rows]), k)
        cand_s.append(v)
        cand_i.append(i + s)
    vals, order = _top(torch.cat(cand_s, dim=1), k)
    return vals, torch.gather(torch.cat(cand_i, dim=1), 1, order)


@dataclasses.dataclass(frozen=True)
class Plan:
    """The kernel's split of one search. `groups` query groups of `cluster`
    CTAs holding `queries` queries each; each group reads the table once,
    as `n_slices` stripes of `slice_rows` rows (a multiple of CHUNK_ROWS;
    the last one ragged), one per cluster, streamed in boxes of `panel`
    columns through a ring of `stages` stages. The merge sorts
    `n_slices * k` candidates padded to `merge_pad`, a power of two."""

    queries: int
    cluster: int
    groups: int
    panel: int
    stages: int
    slice_rows: int
    n_slices: int
    merge_pad: int
    smem: int


def panel_cols(d: int) -> int:
    """Columns of a TMA box (csrc panel_cols): 64 (128-byte swizzle) when D
    allows, else 32 or 16."""
    return 64 if d % 64 == 0 else 32 if d % 32 == 0 else 16


def search_smem(nq: int, d: int, k: int, stages: int) -> int:
    """Dynamic shared memory of one knn_search CTA (csrc `layout`): the
    queries, the ring, the lists, the candidate buffers, counts and
    thresholds, the barriers and 1 KB to align the base."""
    lists = nq * d * 2 + stages * CHUNK_ROWS * panel_cols(d) * 2 \
        + nq * k * 8 + nq * CANDIDATES * 8 + nq * 12
    return -(-lists // 8) * 8 + 8 * (2 * stages + 1) + 1024


@functools.lru_cache(maxsize=256)
def plan(b: int, n: int, d: int, k: int, sm_count: int,
         cluster_slots: Optional[int] = None) -> Plan:
    """Up to 64 queries in one CTA, up to 256 in a cluster of two or four
    (every table box multicast to all of them), more in groups of 256; a
    smaller query group where the queries, the lists and MIN_STAGES
    stages do not fit the shared memory. The ring takes what is left, up
    to MAX_STAGES. One stripe per cluster the card runs at once
    (`cluster_slots`, by default sm_count // cluster), no more than the
    merge can hold at this k, and none shorter than one chunk."""
    check_k(k, n)
    if d % 16 or d < 16:
        raise ValueError(f"knn: D={d}; the kernel takes D a multiple of 16")
    nq = next(s for s in QUERY_GROUPS if s >= min(b, QUERY_GROUPS[-1]))
    while search_smem(nq, d, k, MIN_STAGES) > SMEM_LIMIT:
        if nq == QUERY_GROUPS[0]:
            raise ValueError(f"knn: D={d}, k={k}: {nq} queries and their "
                             f"lists do not fit {SMEM_LIMIT} bytes of "
                             "shared memory")
        nq //= 2
    cluster = 1
    while cluster < MAX_CLUSTER and cluster * nq < b:
        cluster *= 2
    stages = MAX_STAGES
    while search_smem(nq, d, k, stages) > SMEM_LIMIT:
        stages -= 1
    groups = -(-b // (cluster * nq))
    chunks = -(-n // CHUNK_ROWS)
    slots = sm_count // cluster if cluster_slots is None else cluster_slots
    want = max(1, min(slots // groups, MAX_MERGE // k, chunks))
    slice_rows = -(-chunks // want) * CHUNK_ROWS
    n_slices = -(-n // slice_rows)
    merge_pad = 1 << max(0, (n_slices * k - 1).bit_length())
    return Plan(nq, cluster, groups, panel_cols(d), stages, slice_rows,
                n_slices, merge_pad, search_smem(nq, d, k, stages))


@functools.lru_cache(maxsize=256)
def device_plan(b: int, n: int, d: int, k: int, index: int) -> Plan:
    """`plan` for CUDA device `index`: its SM count and, for a cluster, how
    many such clusters of the search kernel it runs at once (a cluster's
    CTAs share a GPC, so that can be less than the SM count over the
    cluster size; a stripe more than fit would wait for a second wave)."""
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    p = plan(b, n, d, k, sms)
    if p.cluster == 1:
        return p
    with torch.cuda.device(index):
        slots = _build.load().rdm_knn_cluster_slots(p.queries, d, k,
                                                    p.stages, p.cluster)
    _build.check(max(0, -slots), "knn_cluster_slots")
    return plan(b, n, d, k, sms, max(1, slots))


def knn_topk(db_norm: torch.Tensor, queries: torch.Tensor, k: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k of queries [B, D] against the normalised table [N, D]:
    (scores [B, k] f32, ids [B, k] int64), by score descending, ties to
    the lower id. Two launches on CUDA; the plain version on the CPU."""
    n, d = db_norm.shape
    b = queries.shape[0]
    if queries.ndim != 2 or queries.shape[1] != d:
        raise ValueError(f"knn: queries {tuple(queries.shape)} for a table "
                         f"{tuple(db_norm.shape)}")
    devices = {db_norm.device.type, queries.device.type}
    if devices == {"cpu"}:
        return knn_search_reference(db_norm, queries, k)
    if devices != {"cuda"} or db_norm.device != queries.device:
        raise ValueError(f"knn: table on {db_norm.device}, queries on "
                         f"{queries.device}")
    if db_norm.dtype != torch.bfloat16 or not db_norm.is_contiguous():
        raise ValueError(f"knn: the CUDA kernel takes a contiguous bf16 "
                         f"table, got {db_norm.dtype}")
    if db_norm.data_ptr() % 16:
        raise ValueError("knn: the table must be 16-byte aligned")
    _build.refuse_grad("knn", db_norm, queries)
    dev = db_norm.device
    p = device_plan(b, n, d, k, dev.index if dev.index is not None
                    else torch.cuda.current_device())
    q = queries.to(torch.bfloat16).contiguous()
    if q.data_ptr() % 16:  # TMA reads 16-byte aligned rows
        q = q.clone()
    part_s = torch.empty((b, p.n_slices, k), dtype=torch.float32,
                         device=dev)
    part_i = torch.empty((b, p.n_slices, k), dtype=torch.int32, device=dev)
    out_s = torch.empty((b, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, k), dtype=torch.int64, device=dev)
    lib = _build.load()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = lib.rdm_knn_search(q.data_ptr(), db_norm.data_ptr(),
                                part_s.data_ptr(), part_i.data_ptr(), b, n,
                                d, k, p.queries, p.cluster, p.groups,
                                p.slice_rows, p.n_slices, p.stages, stream)
        _build.check(rc, "knn_search")
        _launches["knn"] += 1
        rc = lib.rdm_knn_merge(part_s.data_ptr(), part_i.data_ptr(),
                               out_s.data_ptr(), out_i.data_ptr(), b,
                               p.n_slices * k, p.merge_pad, k, stream)
        _build.check(rc, "knn_merge")
        _launches["knn"] += 1
    return out_s, out_i


def reset_launch_counts() -> None:
    for name in _launches:
        _launches[name] = 0


def launch_counts() -> Dict[str, int]:
    return dict(_launches)
