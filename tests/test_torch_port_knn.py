"""The port's exact kNN (rdm_tpu_torch/ops/knn_kernel.py, the plain version
of csrc/knn_topk.cu) and the retrieval files around it, against the JAX
package on the CPU.

- The plain version against JAX `knn_search_fused` (the Pallas kernel in
  interpret mode) on tests/test_retrieval.py's cases, and against JAX
  `knn_search` at several (B, N, k), in f32 and bf16 tables.
- `slice_rows=` (the kernel's per-stripe top-k, then the merge) against
  the global sort, ties across slices included, and `plan`'s query
  groups, cluster, ring and split.
- A 10-row table whose top k holds negative scores against the numpy
  stable-argsort oracle: JAX's kernel returns padding ids there.
- k > N and k > 128 raise.
- `DataPool.save` / `load` both ways with JAX, `NNMemory.build_from_queries`
  against JAX's, and its errors propagating.

Tolerances: ids equal; scores within 1e-5 (f32 sums of the same products
in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from rdm_tpu.ops.knn_kernel import knn_search_fused
from rdm_tpu.retrieval import database as jdb
from rdm_tpu.retrieval import engine as jeng
from rdm_tpu_torch.ops import knn_kernel as kk
from rdm_tpu_torch.retrieval import engine as peng
from rdm_tpu_torch.retrieval.database import DataPool, NNMemory

SCORE_TOL = 1e-5


def _unit(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _oracle(db, q, k):
    """numpy stable argsort of f32 scores: (scores, ids)."""
    ref = q @ db.T
    idx = np.argsort(-ref, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(ref, idx, 1), idx


def test_plain_matches_fused_kernel_in_interpret_mode():
    rng = np.random.default_rng(7)
    db = _unit(rng, (512, 128))
    q = db[:6]
    with pltpu.force_tpu_interpret_mode():
        want_s, want_i = knn_search_fused(jnp.asarray(db), jnp.asarray(q), 5,
                                          block_n=128)
    got_s, got_i = kk.knn_search_reference(torch.from_numpy(db),
                                           torch.from_numpy(q), 5)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s),
                               atol=SCORE_TOL)


def test_plain_matches_fused_kernel_on_duplicates():
    """Duplicate rows across the Pallas kernel's 4-row blocks: ties go to
    the lower id, in the plain version's global sort and its slice merge."""
    dup = np.tile(_unit(np.random.default_rng(7), (1, 128)), (10, 1))
    with pltpu.force_tpu_interpret_mode():
        _, want_i = knn_search_fused(jnp.asarray(dup), jnp.asarray(dup[:1]),
                                     4, block_n=4)
    for slice_rows in (None, 4, 3):
        _, got_i = kk.knn_search_reference(
            torch.from_numpy(dup), torch.from_numpy(dup[:1]), 4,
            slice_rows=slice_rows)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        assert got_i[0].tolist() == [0, 1, 2, 3]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,n,k", [(1, 50, 1), (5, 300, 7), (16, 1000, 20),
                                   (3, 129, 128)])
def test_plain_matches_jax_knn_search(dtype, b, n, k):
    rng = np.random.default_rng(n + k)
    emb = rng.standard_normal((n, 128)).astype(np.float32) * 2.0
    emb[n // 2] = emb[1]  # a tie across the table
    q = rng.standard_normal((b, 128)).astype(np.float32)
    q[0] = emb[1]
    jtable = jdb.DataPool(emb).device_table(dtype=getattr(jnp, dtype))[:n]
    want_s, want_i = jeng.knn_search(jtable, jeng.l2_normalize(
        jnp.asarray(q)), k)
    table, _ = DataPool(embeddings=emb).device_table(
        dtype=getattr(torch, dtype))
    got_s, got_i = peng.knn_search(table, peng.l2_normalize(
        torch.from_numpy(q)), k)
    assert got_i.dtype == torch.int64
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s),
                               atol=SCORE_TOL)
    if k > 1:
        assert got_i[0, :2].tolist() == [1, n // 2]


@pytest.mark.parametrize("slice_rows", [64, 100, 256])
@pytest.mark.parametrize("k", [1, 4, 20])
def test_slice_merge_equals_global_sort(slice_rows, k):
    rng = np.random.default_rng(slice_rows + k)
    db = _unit(rng, (1000, 64))
    db[[3, 130, 517, 999]] = db[700]  # one duplicate in four slices
    q = _unit(rng, (9, 64))
    q[0] = db[700]
    for dtype in (torch.float32, torch.bfloat16):
        t = torch.from_numpy(db).to(dtype)
        want = kk.knn_search_reference(t, torch.from_numpy(q), k)
        got = kk.knn_search_reference(t, torch.from_numpy(q), k,
                                      slice_rows=slice_rows)
        assert torch.equal(got[1], want[1])
        assert torch.equal(got[0], want[0])
        assert got[1][0, :5].tolist() == [3, 130, 517, 700, 999][:k]


def test_small_table_with_negative_scores_against_numpy_oracle():
    """N = 10, k = 8: the top 8 holds negative scores. JAX's kernel pads
    N with zero rows that score 0 and return as ids >= N (ROADMAP §3); the
    port returns the oracle's ids."""
    rng = np.random.default_rng(0)
    db, q = _unit(rng, (10, 128)), _unit(rng, (4, 128))
    want_s, want_i = _oracle(db, q, 8)
    assert (want_s < 0).any()
    got_s, got_i = peng.knn_search(torch.from_numpy(db),
                                   torch.from_numpy(q), 8)
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    np.testing.assert_allclose(got_s.numpy(), want_s, atol=SCORE_TOL)
    _, sliced = kk.knn_search_reference(torch.from_numpy(db),
                                        torch.from_numpy(q), 8, slice_rows=4)
    np.testing.assert_array_equal(sliced.numpy(), want_i)
    with pltpu.force_tpu_interpret_mode():
        _, jax_i = knn_search_fused(jnp.asarray(db), jnp.asarray(q), 8,
                                    block_n=4)
    assert (np.asarray(jax_i) >= 10).any()  # the reference's padding ids


@pytest.mark.parametrize("k,n", [(5, 4), (129, 500), (0, 10)])
def test_k_out_of_range_raises(k, n):
    db = torch.from_numpy(_unit(np.random.default_rng(1), (n, 32)))
    q = db[:2]
    for fn in (kk.knn_search_reference, kk.knn_topk, peng.knn_search):
        with pytest.raises(ValueError, match="k="):
            fn(db, q, k)
    with pytest.raises(ValueError, match="k="):
        kk.plan(2, n, 32, k, 132)
    with pytest.raises(ValueError, match="k="):
        peng.RetrievalEngine(DataPool(db), dtype=torch.float32).search(q, k)


def test_knn_search_impl():
    db = torch.from_numpy(_unit(np.random.default_rng(2), (300, 32)))
    q = db[:3] + 0.1
    want = kk.knn_search_reference(db, q, 4)
    for impl in (None, "reference"):
        got = peng.knn_search(db, q, 4, impl=impl)
        assert torch.equal(got[1], want[1])
    with pytest.raises(ValueError, match="impl"):
        peng.knn_search(db, q, 4, impl="xla")


@pytest.mark.parametrize("b,k", [(1, 1), (4, 4), (16, 4), (32, 4),
                                 (256, 20), (16, 128), (1000, 20)])
def test_plan_splits_the_table(b, k):
    n, d, sms = 1_281_280, 512, 132
    p = kk.plan(b, n, d, k, sms)
    assert p.slice_rows % kk.CHUNK_ROWS == 0
    assert (p.n_slices - 1) * p.slice_rows < n <= p.n_slices * p.slice_rows
    assert p.n_slices * k <= p.merge_pad <= kk.MAX_MERGE
    assert p.merge_pad & (p.merge_pad - 1) == 0
    assert p.queries in kk.QUERY_GROUPS and p.cluster in (1, 2, 4)
    group = p.cluster * p.queries  # queries that share one pass
    assert (p.groups - 1) * group < b <= p.groups * group
    assert p.panel == 64
    assert kk.MIN_STAGES <= p.stages <= kk.MAX_STAGES
    assert p.smem == kk.search_smem(p.queries, d, k, p.stages) \
        <= kk.SMEM_LIMIT
    assert p.n_slices * p.cluster * p.groups <= sms  # one CTA an SM
    if b <= 256:  # the table is read once
        assert p.groups == 1
    if (b, k) in ((16, 4), (4, 4), (32, 4)):  # every SM streams a stripe
        assert p.n_slices == sms and p.cluster == 1
    if (b, k) == (256, 20):  # 4 x 64 queries, every box multicast
        assert (p.cluster, p.queries) == (4, 64)
        # a card that runs only 32 such clusters at once gets 32 stripes
        assert kk.plan(b, n, d, k, sms, 32).n_slices == 32
    if b == 1000:
        assert p.groups == 4
    if k == 128:  # the merge still fits one CTA
        assert p.n_slices * k <= kk.MAX_MERGE
    # the plain version's split at this plan gives the global result
    small = kk.plan(b, 700, 16, min(k, 20), 2)
    db = torch.from_numpy(_unit(np.random.default_rng(b), (700, 16)))
    q = torch.from_numpy(_unit(np.random.default_rng(k), (min(b, 8), 16)))
    kq = min(k, 20)
    assert torch.equal(
        kk.knn_search_reference(db, q, kq, slice_rows=small.slice_rows)[1],
        kk.knn_search_reference(db, q, kq)[1])


def test_plan_refuses_unsupported_widths():
    with pytest.raises(ValueError, match="multiple of 16"):
        kk.plan(4, 1000, 120, 4, 132)
    # 8 queries of 16384 bf16 columns are 256 KB, more than a CTA holds
    with pytest.raises(ValueError, match="shared"):
        kk.plan(4, 1000, 16384, 4, 132)


def test_engine_search_without_gather():
    emb = np.random.default_rng(3).standard_normal((200, 32)).astype(
        np.float32)
    eng = peng.RetrievalEngine(DataPool(emb, img_ids=np.arange(200) + 5),
                               dtype=torch.float32)
    q = emb[:3]
    out = eng.search(q, k=4, gather_embeddings=False)
    assert set(out) == {"nns", "scores"}
    full = eng.search(q, k=4)
    assert torch.equal(out["nns"], full["nns"])
    np.testing.assert_array_equal(full["img_ids"], full["nns"].numpy() + 5)


def test_datapool_save_round_trips_with_jax(tmp_path):
    rng = np.random.default_rng(4)
    emb = rng.standard_normal((57, 24)).astype(np.float32)
    ids = np.arange(57) * 3
    coords = rng.integers(0, 9, size=(57, 4))
    written = DataPool(emb, img_ids=ids, patch_coords=coords).save(
        str(tmp_path / "port"), chunk_size=20)
    assert [p.rsplit("/", 1)[1] for p in written] == [
        "20x24-part0000.npz", "20x24-part0001.npz", "17x24-part0002.npz"]
    want = jdb.DataPool(emb, img_ids=ids, patch_coords=coords)
    want.save(str(tmp_path / "jax"), chunk_size=20)
    for name in ("port", "jax"):
        mine = DataPool.load(str(tmp_path / name))
        theirs = jdb.DataPool.load(str(tmp_path / name))
        np.testing.assert_array_equal(mine.embeddings.numpy(),
                                      theirs.embeddings)
        np.testing.assert_array_equal(mine.img_ids, theirs.img_ids)
        np.testing.assert_array_equal(mine.patch_coords, theirs.patch_coords)
    # single chunk, no metadata, every row in order
    DataPool(emb).save(str(tmp_path / "one"))
    np.testing.assert_array_equal(
        jdb.DataPool.load(str(tmp_path / "one")).embeddings, emb)


@pytest.mark.parametrize("top_m", [None, 5])
def test_build_from_queries_matches_jax(top_m, tmp_path):
    rng = np.random.default_rng(5)
    emb = rng.standard_normal((300, 32)).astype(np.float32)
    emb[[10, 11]] = emb[200]
    queries = emb[rng.integers(0, 300, size=50)] + 0.3 * rng.standard_normal(
        (50, 32)).astype(np.float32)
    want = jdb.NNMemory.build_from_queries(
        jeng.RetrievalEngine(jdb.DataPool(emb)), queries, k=6, batch_size=16,
        top_m=top_m)
    got = NNMemory.build_from_queries(
        peng.RetrievalEngine(DataPool(emb)), queries, k=6, batch_size=16,
        top_m=top_m)
    np.testing.assert_array_equal(got.ids, want.ids)
    assert got.id_count == want.id_count
    got.save(str(tmp_path / "mem.p"))
    back = jdb.NNMemory.load(str(tmp_path / "mem.p"))
    np.testing.assert_array_equal(back.ids, want.ids)
    assert back.id_count == want.id_count


def test_build_from_queries_lets_errors_propagate():
    """JAX retries a failing batch, then skips it; the port raises."""

    class Failing:
        def search(self, *_, **__):
            raise RuntimeError("knn_partial: CUDA error")

    with pytest.raises(RuntimeError, match="knn_partial"):
        NNMemory.build_from_queries(Failing(), np.zeros((4, 8), np.float32))
