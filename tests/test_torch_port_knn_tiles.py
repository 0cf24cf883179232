"""The walk of the kNN search kernel (rdm_tpu_torch/csrc/knn_topk.cu),
emulated in plain torch on the CPU, against the plain version and the JAX
package's fused kNN kernel.

No CUDA runs here, so the kernel's arithmetic is held by its plain version
on the card (chip_smoke.py phase 17, tests/test_torch_port_cuda.py); what
the kernel adds to that arithmetic is its walk, and `_walk` repeats it:
`kk.plan`'s query groups, clusters and stripes; chunks of `kk.CHUNK_ROWS`
rows selected in order (the two consumer warpgroups take turns); each
chunk's scores tested against the query's k-th (score, id) as the last
merge left it (the latest the kernel may read it); winners into a buffer
of `kk.CANDIDATES` slots per query in an arbitrary (atomic) order, the
overflow kept for the next round of the same chunk; a buffer
`kk.MERGE_AT` full merged by counted ranks, every one after a stripe's
last chunk; then the merge launch's sort of every stripe's list. The
scores are the plain version's (`kk._score`: f64 sums of the bf16-rounded
products), so the emulation must give the plain version's ids and scores
exactly, and JAX `knn_search_fused` (interpret mode; f32 sums) its ids
with scores within 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from rdm_tpu.ops.knn_kernel import knn_search_fused
from rdm_tpu_torch.ops import knn_kernel as kk

SCORE_TOL = 1e-5
NO_ID = 2 ** 31 - 1


def _unit(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _better(a_s, a_i, b_s, b_i):
    return (a_s > b_s) | ((a_s == b_s) & (a_i < b_i))


def _merge(ls, li, xs, xi, ok):
    """The kernel's merge_query for every query at once: a list entry's new
    rank is its old one plus the accepted candidates better than it, a
    candidate's the list entries and accepted candidates better than it;
    ranks >= k drop out."""
    k = ls.shape[1]
    xs = torch.where(ok, xs, torch.full_like(xs, -torch.inf))
    xi = torch.where(ok, xi, torch.full_like(xi, NO_ID))
    beats = _better(xs[:, None, :], xi[:, None, :], ls[:, :, None],
                    li[:, :, None]) & ok[:, None, :]
    rank_l = torch.arange(k) + beats.sum(2)
    rank_x = (_better(ls[:, :, None], li[:, :, None], xs[:, None, :],
                      xi[:, None, :]).sum(1)
              + (_better(xs[:, :, None], xi[:, :, None], xs[:, None, :],
                         xi[:, None, :]) & ok[:, :, None]).sum(1))
    rank_x = torch.where(ok, rank_x, torch.full_like(rank_x, 1 << 20))
    ranks = torch.cat([rank_l, rank_x], 1)
    vals = torch.cat([ls, xs], 1)
    ids = torch.cat([li, xi], 1)
    keep = ranks < k
    assert (keep.sum(1) == k).all()  # the ranks are distinct
    new_s, new_i = torch.empty_like(ls), torch.empty_like(li)
    for q in range(ls.shape[0]):
        new_s[q, ranks[q, keep[q]]] = vals[q, keep[q]]
        new_i[q, ranks[q, keep[q]]] = ids[q, keep[q]]
    return new_s, new_i


def _walk(db, q, k, p, seed=0):
    """Both launches of the kernel at plan p: (scores [B, k], ids [B, k],
    rounds, chunks)."""
    gen = torch.Generator().manual_seed(seed)
    n, b = db.shape[0], q.shape[0]
    part_s = torch.full((b, p.n_slices, k), -torch.inf)
    part_i = torch.full((b, p.n_slices, k), NO_ID, dtype=torch.int64)
    rounds = chunks = 0
    for g in range(p.groups):
        for rank in range(p.cluster):
            q0 = (g * p.cluster + rank) * p.queries
            nqv = max(0, min(p.queries, b - q0))
            if nqv == 0:
                continue
            for s in range(p.n_slices):
                r_begin = s * p.slice_rows
                r_end = min(n, r_begin + p.slice_rows)
                ls = torch.full((nqv, k), -torch.inf)
                li = torch.full((nqv, k), NO_ID, dtype=torch.int64)
                buf_s = torch.full((nqv, kk.CANDIDATES), -torch.inf)
                buf_i = torch.full((nqv, kk.CANDIDATES), NO_ID,
                                   dtype=torch.int64)
                cnt = torch.zeros(nqv, dtype=torch.int64)
                thr = torch.full((nqv, 1), -torch.inf)
                tid = torch.full((nqv, 1), NO_ID, dtype=torch.int64)
                # the chunks in order, whichever warpgroup computes them
                for c0 in range(r_begin, r_end, kk.CHUNK_ROWS):
                    chunks += 1
                    last = c0 + kk.CHUNK_ROWS >= r_end
                    rows = torch.arange(c0, min(c0 + kk.CHUNK_ROWS, r_end))
                    sc = kk._score(q[q0:q0 + nqv], db[rows])
                    ids = rows.expand(nqv, -1)
                    todo = torch.ones_like(sc, dtype=torch.bool)
                    while True:
                        # the threshold as the last merge left it
                        todo &= _better(sc, ids, thr, tid)
                        if not (todo.any() or last):
                            break
                        if todo.any():
                            rounds += 1
                        # the atomics' order: any, so a random one; the
                        # free slots of each buffer take the first winners
                        pri = torch.rand(sc.shape, generator=gen)
                        pri[~todo] = torch.inf
                        order = torch.argsort(pri, dim=1)
                        ok = torch.gather(pri, 1, order).isfinite() & (
                            torch.arange(sc.shape[1])
                            < (kk.CANDIDATES - cnt)[:, None])
                        for qi in range(nqv):
                            take = order[qi, ok[qi]]
                            m = take.numel()
                            buf_s[qi, cnt[qi]:cnt[qi] + m] = sc[qi, take]
                            buf_i[qi, cnt[qi]:cnt[qi] + m] = ids[qi, take]
                            cnt[qi] += m
                            todo[qi, take] = False
                        full = cnt >= (1 if last else kk.MERGE_AT)
                        if full.any():
                            slot = (torch.arange(kk.CANDIDATES)
                                    < cnt[:, None]) & full[:, None]
                            ms, mi = _merge(ls, li, buf_s, buf_i, slot)
                            ls[full], li[full] = ms[full], mi[full]
                            cnt[full] = 0
                            thr = torch.where(full[:, None], ls[:, -1:], thr)
                            tid = torch.where(full[:, None], li[:, -1:], tid)
                        if not todo.any():
                            break
                part_s[q0:q0 + nqv, s] = ls
                part_i[q0:q0 + nqv, s] = li
    cand_s, cand_i = part_s.reshape(b, -1), part_i.reshape(b, -1)
    by_id = torch.argsort(cand_i, dim=1, stable=True)
    cand_s, cand_i = (torch.gather(cand_s, 1, by_id),
                      torch.gather(cand_i, 1, by_id))
    order = torch.argsort(cand_s, dim=1, descending=True, stable=True)
    out_s = torch.gather(cand_s, 1, order)[:, :k]
    out_i = torch.gather(cand_i, 1, order)[:, :k]
    assert (out_i < n).all()
    return out_s, out_i, rounds, chunks


def _fused(db, q, k, block_n):
    with pltpu.force_tpu_interpret_mode():
        s, i = knn_search_fused(jnp.asarray(db), jnp.asarray(q), k,
                                block_n=block_n)
    return np.asarray(s), np.asarray(i)


def _hold(db, q, k, sms, block_n):
    """The walk against the plain version (exactly) and JAX's fused
    kernel; returns the walk's plan, rounds and chunks."""
    tdb = torch.from_numpy(db).bfloat16()
    tq = torch.from_numpy(q)
    p = kk.plan(q.shape[0], db.shape[0], db.shape[1], k, sms)
    got_s, got_i, rounds, chunks = _walk(tdb, tq, k, p)
    want_s, want_i = kk.knn_search_reference(tdb, tq, k)
    assert torch.equal(got_i, want_i)
    assert torch.equal(got_s, want_s)
    js, ji = _fused(tdb.float().numpy().astype(jnp.bfloat16), q, k, block_n)
    np.testing.assert_array_equal(got_i.numpy(), ji)
    np.testing.assert_allclose(got_s.numpy(), js, atol=SCORE_TOL)
    return p, rounds, chunks


@pytest.mark.parametrize("b,n,d,k,sms", [
    (1, 1000, 32, 4, 4),    # B = 1, a ragged N (1000 = 7.8 chunks)
    (9, 1000, 64, 20, 4),   # B = 9: a group of 16, 7 rows zero-filled
    (300, 700, 16, 5, 8),   # past one group: two groups of 4 x 64
    (4, 300, 48, 1, 3),     # k = 1, 16-column panels
    (6, 64, 32, 64, 2),     # k = N: every row comes back
])
def test_walk_matches_plain_and_fused(b, n, d, k, sms):
    rng = np.random.default_rng(b * 1000 + n)
    db, q = _unit(rng, (n, d)), _unit(rng, (b, d))
    block_n = 64 if n == 64 else 128
    p, rounds, chunks = _hold(db, q, k, sms, block_n)
    assert rounds > chunks or k == 1  # the first chunks overflow
    if b > 256:
        assert p.cluster == kk.MAX_CLUSTER and p.groups == 2


def test_walk_on_negative_scores():
    """N = 10, k = 8: the top 8 holds negative scores; one chunk, rows
    10-63 zero-filled and masked. JAX's kernel with block_n = 10 pads
    nothing here, so it gives the real ids."""
    rng = np.random.default_rng(0)
    db, q = _unit(rng, (10, 128)), _unit(rng, (4, 128))
    p, _, _ = _hold(db, q, 8, 132, 10)
    assert p.n_slices == 1
    want = q @ db.T
    assert (np.sort(want, axis=1)[:, -8:] < 0).any()


def test_walk_returns_duplicates_across_stripes_in_id_order():
    rng = np.random.default_rng(5)
    db, q = _unit(rng, (2000, 64)), _unit(rng, (12, 64))
    p = kk.plan(12, 2000, 64, 6, 6)
    dup = [5, p.slice_rows + 3, 3 * p.slice_rows + 60, 1999]
    assert len({r // p.slice_rows for r in dup}) == 4
    db[dup] = db[dup[0]]
    q[0] = db[dup[0]]
    _hold(db, q, 6, 6, 128)
    tdb = torch.from_numpy(db).bfloat16()
    got = _walk(tdb, torch.from_numpy(q), 6, p)[1]
    assert got[0, :4].tolist() == dup


def test_walk_when_every_chunk_beats_the_threshold():
    """Rows in ascending score for query 0: every row of every chunk beats
    the k-th, so each chunk takes more than one round: the first round
    merges CANDIDATES of its CHUNK_ROWS, which leaves the k-th below the
    rest (k > CANDIDATES), and the next rounds drop those the raised k-th
    now beats."""
    rng = np.random.default_rng(9)
    db, q = _unit(rng, (640, 32)), _unit(rng, (3, 32))
    score = kk._score(torch.from_numpy(q[:1]),
                      torch.from_numpy(db).bfloat16())[0]
    db = db[np.argsort(score.numpy(), kind="stable")]
    p, rounds, chunks = _hold(db, q, 20, 1, 128)
    assert p.n_slices == 1
    assert rounds >= 2 * chunks
