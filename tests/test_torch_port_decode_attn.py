"""decode_attn's two CUDA launches (csrc/decode_attn.cu: the q/k/v
projection on the block-GEMM core, csrc/block_gemm_sm90.cuh, and the
split-KV attention), emulated on the CPU, against the port's plain version
and the JAX Pallas kernel.

No GPU runs here, so this emulates in plain torch what the two launches
add to the arithmetic of `decode_attn_reference`:

- the projection as `gemm_plan("qkv", B, 3C, C, split_k=True)` plans it:
  64-row blocks, zero past R, 64-column tiles of 64-wide K-steps, each
  rank of a column tile's cluster summing its own contiguous K-steps and
  rank 0 adding the others' f32 partial tiles in rank order; LN1 over
  whole rows (the live ones); int8 codes converted to bf16 (exact) with
  the column scale on the f32 product; each 8-column group of [B, 3C]
  routed to q, k or v in the activation dtype; k and v into row pos of
  the caches (a bf16 in-place commit), and the f32 k and v rows under
  int8_kv;
- the attention as `attn_plan` grids it: per (batch row, group of G heads)
  `splits` ranks of `rows` cache rows below pos, 16-row boxes, four
  consumer warps (a warp a head, its rows dealt out to 4 / G warps), an
  8-lane group of a warp taking its rows of a box (every fourth at G = 4)
  together into an exp2-domain online-softmax state; the four group
  states merged
  as the shuffles merge them, every warp's state merged by rank 0 in
  (rank, warp) order with the current position last, then normalised;
  int8 scales folded as the kernel folds them (the k scale on the score,
  the v scale on the probability), and the int8 row pos committed once
  per batch row from the f32 rows.

The walk is held against `decode_attn_reference` at rtol = atol = 1e-4 in
f32 and within 2e-2 x max|ref| in bf16 (chip_smoke.py's card tolerance),
for the four variants (bf16, int8 weights, int8 cache, both), at pos 0, 1,
mid and T - 1 and B = 1, 3 and 17; and against JAX's `_attn_kernel` in
Pallas interpret mode, on the inputs a spy on `pl.pallas_call` captured,
at 1e-4 in f32. The committed int8 codes equal `quantize_rows` of the
walk's own f32 rows bit for bit, and the plain version's codes but for
at most 0.1% one step apart (two f32 projections summed in another
order). The plans are checked at the RARM's width on an H100's 132 SMs.

The kernels themselves are held on the card by chip_smoke.py phases 6 and
12 and tests/test_torch_port_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rdm_tpu.ops import decode_kernel as jdk
from rdm_tpu_torch.ops import block_kernel as bk
from rdm_tpu_torch.ops import decode_kernel as dk
from test_torch_port_decode_gemm import _hold, _ks_fits
from test_torch_port_int8 import _Spy

SMS = 132  # the H100 SXM's SMs, as `bk.sm_count` reads them on the card
BK = 64    # the core's K-step
HD = 64    # the decode kernels' head width
C, T = 128, 40  # two heads; a cache of 40 rows (three 16-row boxes)
WARPS = 4  # the attention's consumer warps (csrc/decode_attn.cu kWarps)
LOG2E = 1.4426950408889634


@pytest.fixture(autouse=True)
def _one_thread():
    """The walk is many small products: torch's intra-op threads only
    contend with the other test workers for them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------- the projection

def proj_walk(x, n1s, n1b, wqkv, wqkv_s, plan):
    """launch_decode<kQkv> as `plan` runs it: the f32 accumulators of
    [B, 3C] after each column tile's rank-ordered K split and the column
    scale, and the (column tile, rank, K-steps) triples walked."""
    r, c = x.shape
    n = 3 * c
    assert (plan.bm, plan.bn, plan.pp) == bk.DECODE_TILE
    a = bk.layer_norm(x, n1s, n1b)  # every rank normalises whole rows
    nkb = c // BK
    ap = torch.zeros(-(-r // plan.bm) * plan.bm, c)
    ap[:r] = a.float()
    wf = wqkv.float()  # int8 codes: exact in bf16 and f32
    acc_all = torch.zeros(r, n)
    walked = []
    for by in range(ap.shape[0] // plan.bm):
        rows = torch.arange(by * plan.bm, (by + 1) * plan.bm)
        live = rows < r
        for t in range(n // plan.bn):
            cols = slice(t * plan.bn, (t + 1) * plan.bn)
            parts = []
            for rank in range(plan.ks):
                steps = range(rank * nkb // plan.ks,
                              (rank + 1) * nkb // plan.ks)
                part = torch.zeros(plan.bm, plan.bn)
                for kb in steps:
                    ks = slice(kb * BK, (kb + 1) * BK)
                    part += ap[rows, ks] @ wf[ks, cols]
                parts.append(part)
                walked.append((t, rank, tuple(steps)))
            acc = parts[0]
            for part in parts[1:]:  # rank 0 adds ranks 1, 2, ... in order
                acc = acc + part
            if wqkv_s is not None:
                acc = acc * wqkv_s[cols].float()
            acc_all[rows[live], cols] = acc[live]
    return acc_all, walked


def route_qkv(acc, dtype):
    """The kQkv epilogue: each 8-column group of [B, 3C] to q, k or v in
    the activation dtype."""
    r, n = acc.shape
    c = n // 3
    outs = [torch.empty(r, c, dtype=dtype) for _ in range(3)]
    for gc in range(0, n, 8):
        which = gc // c
        outs[which][:, gc - which * c:gc - which * c + 8] = \
            acc[:, gc:gc + 8].to(dtype)
    return outs


# -------------------------------------------------------- the attention

def _merge(a, b):
    """Two exp2-domain states (m, l, acc) merged as the kernel merges them:
    a state with no rows (m = -inf) weighs 0."""
    (m, l, acc), (mo, lo, ao) = a, b
    big = torch.maximum(m, mo)
    ca = torch.where(m == -torch.inf, 0.0, torch.exp2(m - big))
    cb = torch.where(mo == -torch.inf, 0.0, torch.exp2(mo - big))
    return (big, l * ca + lo * cb,
            acc * ca[..., None] + ao * cb[..., None])


def attn_walk(q, kn, vn, kc, vc, pos, heads, plan, ks=None, vs=None):
    """The attention launch's arithmetic for every (batch row, head) at
    once: per rank, per warp phase and 8-lane group, the rows that group
    takes in the kernel's order; the group states merged by the warp's
    shuffles; the warps' states by rank 0 in (rank, warp) order, the
    current position last. f32 throughout; returns out in q's dtype."""
    b, c = q.shape
    g_heads = plan.group
    nph = WARPS // g_heads
    scale_log2 = HD ** -0.5 * LOG2E
    qs = q.float().reshape(b, heads, HD) * scale_log2
    kcf = kc.float().reshape(-1, b, heads, HD)
    vcf = vc.float().reshape(-1, b, heads, HD)
    empty = (torch.full((b, heads), -torch.inf), torch.zeros(b, heads),
             torch.zeros(b, heads, HD))
    rps = dk.ATTN_ROWS // (4 * nph)  # a group's rows of a box
    records = []  # (rank, phase) order: warp w = phase G + h of rank r
    for rank in range(plan.splits):
        t0, t1 = rank * plan.rows, min(pos, (rank + 1) * plan.rows)
        nst = -(-(t1 - t0) // dk.ATTN_ROWS) if t1 > t0 else 0
        for ph in range(nph):
            subs = []
            for sub in range(4):
                m, l, acc = empty
                for i in range(nst):
                    r0 = i * dk.ATTN_ROWS
                    nr = min(dk.ATTN_ROWS, t1 - t0 - r0)
                    rows = [t0 + r0 + 4 * ph + sub + 4 * nph * k
                            for k in range(rps)
                            if 4 * ph + sub + 4 * nph * k < nr]
                    if not rows:  # no live row: the state stays
                        continue
                    sc = [(qs * kcf[t]).sum(-1) for t in rows]
                    pv = [torch.ones(b, 1)] * len(rows)
                    if ks is not None:
                        sc = [s * ks[t].float()[:, None]
                              for s, t in zip(sc, rows)]
                        pv = [vs[t].float()[:, None] for t in rows]
                    mx = m
                    for s in sc:
                        mx = torch.maximum(mx, s)
                    corr = torch.exp2(m - mx)
                    l, acc = l * corr, acc * corr[..., None]
                    for s, w, t in zip(sc, pv, rows):
                        p = torch.exp2(s - mx)
                        l = l + p
                        acc = acc + (p * w)[..., None] * vcf[t]
                    m = mx
                subs.append((m, l, acc))
            s01, s23 = _merge(subs[0], subs[1]), _merge(subs[2], subs[3])
            records.append(_merge(s01, s23))
    sn = (qs * kn.float().reshape(b, heads, HD)).sum(-1)
    big = sn
    for m, _, _ in records:
        big = torch.maximum(big, m)
    den, num = torch.zeros(b, heads), torch.zeros(b, heads, HD)
    for m, l, acc in records:
        corr = torch.where(m == -torch.inf, 0.0, torch.exp2(m - big))
        den = den + l * corr
        num = num + acc * corr[..., None]
    pn = torch.exp2(sn - big)
    den = den + pn
    num = num + pn[..., None] * vn.float().reshape(b, heads, HD)
    return (num * (1.0 / den)[..., None]).reshape(b, c).to(q.dtype)


def decode_attn_walk(x, pos, kc, vc, n1s, n1b, wqkv, *, heads, commit=True,
                     wqkv_s=None, ks_cache=None, vs_cache=None, ks=None):
    """decode_attn as the CUDA wrapper runs it: the projection launch
    (commit into row pos of bf16 caches, or fresh k_new / v_new; f32 rows
    under int8_kv), then the attention launch, which commits an int8 row.
    ks forces the projection's K split. Returns (attn, k_new, v_new) and
    the projection's f32 accumulators and walk."""
    b, c = x.shape
    int8_kv = ks_cache is not None
    plan = bk.gemm_plan("qkv", b, 3 * c, c, SMS, split_k=True,
                        w8=wqkv_s is not None)
    if ks is not None:
        plan = plan._replace(ks=min(ks, c // BK))
    acc, walked = proj_walk(x, n1s, n1b, wqkv, wqkv_s, plan)
    q, kn, vn = route_qkv(acc, x.dtype)
    if commit and not int8_kv:
        kc[pos], vc[pos] = kn, vn
        kn, vn = kc[pos], vc[pos]
    ap = dk.attn_plan(b, heads, pos, SMS)
    out = attn_walk(q, kn, vn, kc, vc, pos, heads, ap,
                    ks_cache[..., 0] if int8_kv else None,
                    vs_cache[..., 0] if int8_kv else None)
    if int8_kv:  # after the cache read: the launch reads rows < pos only
        for cache, scales, f in ((kc, ks_cache, acc[:, c:2 * c]),
                                 (vc, vs_cache, acc[:, 2 * c:])):
            sc = f.abs().amax(-1, keepdim=True).clamp_min(1e-12) / 127.0
            cache[pos] = torch.clamp(torch.round(f / sc), -127,
                                     127).to(torch.int8)
            scales[pos] = sc
    return (out, kn, vn), acc, walked


# ----------------------------------------------------------------- inputs

def _inputs(b, dtype, seed, w8=False, kv8=False):
    """Seeded decode_attn arguments at C = 128 (two heads), T = 40: x [B,
    C], caches [T, B, C] (int8 codes with [T, B, 1] f32 scales for kv8),
    LN1 scale and bias f32, wqkv [C, 3C] in the activation dtype (int8
    codes and bf16 column scales for w8)."""
    rng = np.random.default_rng(seed)

    def rn(*shape, scale=1.0, loc=0.0):
        return torch.from_numpy(
            (loc + scale * rng.standard_normal(shape)).astype(np.float32))

    x = rn(b, C).to(dtype)
    n1s, n1b = rn(C, scale=0.1, loc=1.0), rn(C, scale=0.1)
    wqkv, wqkv_s = rn(C, 3 * C, scale=C ** -0.5), None
    if w8:
        wqkv, wqkv_s = dk.quantize_weight(wqkv)
    else:
        wqkv = wqkv.to(dtype)
    kv = {}
    if kv8:
        caches = []
        for _ in range(2):
            codes, sc = dk.quantize_rows(rn(T * b, C))
            caches += [codes.reshape(T, b, C), sc.reshape(T, b, 1)]
        kc, ksc, vc, vsc = caches
        kv = dict(ks_cache=ksc, vs_cache=vsc)
    else:
        kc, vc = rn(T, b, C).to(dtype), rn(T, b, C).to(dtype)
    return x, kc, vc, n1s, n1b, wqkv, wqkv_s, kv


def _codes_close(got, want, share=1e-3):
    diff = (got.int() - want.int()).abs()
    assert diff.max() <= 1, diff.max()
    assert (diff > 0).float().mean() <= share


VARIANTS = {"bf16": (False, False), "w8": (True, False),
            "kv8": (False, True), "w8_kv8": (True, True)}


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,pos", [(1, 0), (3, 1), (17, 20), (3, T - 1),
                                   (17, T - 1), (1, 33)])
def test_walk_matches_plain(b, pos, dtype, variant):
    """Both launches at B rows, the plans' splits, against the plain
    version: attn, k_new and v_new, and every cache row (row pos
    committed, the others untouched)."""
    w8, kv8 = VARIANTS[variant]
    x, kc, vc, n1s, n1b, wqkv, wqkv_s, kv = _inputs(
        b, dtype, seed=100 * b + pos + 7 * w8 + 3 * kv8, w8=w8, kv8=kv8)
    heads = C // HD
    mine = [a.clone() for a in (kc, vc, *kv.values())]
    ref = [a.clone() for a in (kc, vc, *kv.values())]

    def scales(cs):
        return dict(ks_cache=cs[2], vs_cache=cs[3]) if kv8 else {}

    got, acc, _ = decode_attn_walk(x, pos, mine[0], mine[1], n1s, n1b, wqkv,
                                   heads=heads, wqkv_s=wqkv_s,
                                   **scales(mine))
    want = dk.decode_attn_reference(x, pos, ref[0], ref[1], n1s, n1b, wqkv,
                                    heads=heads, head_dim=HD,
                                    wqkv_s=wqkv_s, **scales(ref))
    for g, w in zip(got, want):
        assert g.shape == (b, C) and g.dtype == dtype
        _hold(g, w, dtype)
    keep = torch.arange(T) != pos
    for m, r, old in zip(mine, ref, (kc, vc, *kv.values())):
        assert torch.equal(m[keep], old[keep])
    if kv8:
        for i, f in ((0, acc[:, C:2 * C]), (1, acc[:, 2 * C:])):
            codes, sc = dk.quantize_rows(f)  # bit for bit on its own rows
            assert torch.equal(mine[i][pos], codes)
            assert torch.equal(mine[2 + i][pos], sc)
            _codes_close(mine[i][pos], ref[i][pos])
            np.testing.assert_allclose(mine[2 + i][pos].numpy(),
                                       ref[2 + i][pos].numpy(), rtol=1e-5)
    else:
        assert torch.equal(mine[0][pos], got[1])
        assert torch.equal(mine[1][pos], got[2])


@pytest.mark.parametrize("variant", ["bf16", "w8"])
def test_deferred_commit_leaves_the_caches(variant):
    """commit=False: k_new and v_new come back in buffers of their own,
    equal to the in-place commit's, and the caches are untouched."""
    w8 = VARIANTS[variant][0]
    x, kc, vc, n1s, n1b, wqkv, wqkv_s, _ = _inputs(3, torch.bfloat16, 5,
                                                   w8=w8)
    kw = dict(heads=C // HD, wqkv_s=wqkv_s)
    caches = (kc.clone(), vc.clone())
    deferred, _, _ = decode_attn_walk(x, 9, *caches, n1s, n1b, wqkv,
                                      commit=False, **kw)
    assert torch.equal(caches[0], kc) and torch.equal(caches[1], vc)
    inplace, _, _ = decode_attn_walk(x, 9, kc.clone(), vc.clone(), n1s, n1b,
                                     wqkv, **kw)
    for a, b in zip(deferred, inplace):
        assert torch.equal(a, b)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_k_split_and_the_splits_change_only_the_order_of_sums(variant):
    """In f32, a forced K split of the projection (KS = 2: one K-step a
    rank at C = 128) and the attention's splits agree with KS = 1 to f32
    rounding; a walk repeated is bit-equal. Every K-step of a column tile
    is walked once, in contiguous slices in rank order."""
    w8, kv8 = VARIANTS[variant]
    x, kc, vc, n1s, n1b, wqkv, wqkv_s, kv = _inputs(17, torch.float32, 11,
                                                    w8=w8, kv8=kv8)
    outs = []
    for ks in (1, 2, 2):
        cs = [a.clone() for a in (kc, vc, *kv.values())]
        extra = dict(ks_cache=cs[2], vs_cache=cs[3]) if kv8 else {}
        got, _, walked = decode_attn_walk(x, T - 1, cs[0], cs[1], n1s, n1b,
                                          wqkv, heads=C // HD,
                                          wqkv_s=wqkv_s, ks=ks, **extra)
        outs.append(got[0])
        per_tile = {}
        for t, rank, steps in walked:
            per_tile.setdefault(t, []).append((rank, steps))
        for slices in per_tile.values():
            assert [r for r, _ in slices] == list(range(ks))
            assert sum((list(st) for _, st in slices), []) == list(
                range(C // BK))
    np.testing.assert_allclose(outs[1].numpy(), outs[0].numpy(), rtol=1e-5,
                               atol=1e-5)
    assert torch.equal(outs[1], outs[2])


def test_attention_splits_and_warps_cover_each_row_once():
    """The attention walk's row order: at B = 3, T - 1 rows over the
    plan's splits, every row below pos is taken by exactly one 8-lane
    group of one warp of one rank, for G = 2 (two heads: two warps a head)
    and G = 1 (three heads: four warps a head)."""
    for heads, want_group in ((2, 2), (3, 1)):
        for pos in (1, 17, T - 1):
            plan = dk.attn_plan(3, heads, pos, SMS)
            assert plan.group == want_group
            nph = WARPS // plan.group
            seen = []
            for rank in range(plan.splits):
                t0, t1 = rank * plan.rows, min(pos, (rank + 1) * plan.rows)
                assert t1 > t0  # no split is empty
                for ph in range(nph):
                    for sub in range(4):
                        for i in range(-(-(t1 - t0) // dk.ATTN_ROWS)):
                            r0 = i * dk.ATTN_ROWS
                            nr = min(dk.ATTN_ROWS, t1 - t0 - r0)
                            js = [4 * ph + sub + 4 * nph * k for k in range(
                                dk.ATTN_ROWS // (4 * nph))]
                            seen += [t0 + r0 + j for j in js if j < nr]
            assert sorted(seen) == list(range(pos))


# ---------------------------------------------------------------- JAX

def _jax_attn(monkeypatch, b, pos, w8, kv8, seed):
    """JAX decode_layer in f32 through Pallas's interpreter with a spy on
    `pl.pallas_call`: (the inputs `_attn_kernel` got, its outputs)."""
    rng = np.random.default_rng(seed)

    def rn(*shape, scale=1.0, loc=0.0):
        return (loc + scale * rng.standard_normal(shape)).astype(np.float32)

    f = 4 * C
    w = {name: rn(k, n, scale=k ** -0.5) for name, k, n in (
        ("wqkv", C, 3 * C), ("wo", C, C), ("wq2", C, C), ("wo2", C, C),
        ("wff_a", C, f), ("wff_g", C, f), ("wff2", f, C))}
    w.update({name: rn(1, n, scale=0.1) for name, n in (
        ("n1b", C), ("bo", C), ("n2b", C), ("bo2", C), ("n3b", C),
        ("bff_a", f), ("bff_g", f), ("bff2", C))})
    w.update({name: rn(1, C, scale=0.1, loc=1.0)
              for name in ("n1s", "n2s", "n3s")})
    jw = {k: jnp.asarray(v) for k, v in w.items()}
    if w8:  # JAX's decode_layer takes all seven projections int8
        for name in ("wqkv", "wo", "wq2", "wo2", "wff_a", "wff_g", "wff2"):
            codes, sc = dk.quantize_weight(torch.from_numpy(w[name]))
            jw[name] = jnp.asarray(codes.numpy())
            jw[name + "_s"] = jnp.asarray(
                sc.float().numpy()[None]).astype(jnp.bfloat16)
    x = rn(b, C)
    kv = {}
    if kv8:
        caches = []
        for _ in range(2):
            codes, sc = dk.quantize_rows(torch.from_numpy(rn(T * b, C)))
            caches += [jnp.asarray(codes.numpy().reshape(T, b, C)),
                       jnp.asarray(sc.numpy().reshape(T, b, 1))]
        kc, ksc, vc, vsc = caches
        kv = dict(ks_cache=ksc, vs_cache=vsc)
    else:
        kc, vc = jnp.asarray(rn(T, b, C)), jnp.asarray(rn(T, b, C))
    ck, cv = rn(4, b, C), rn(4, b, C)
    seg, segt = jdk.head_segment_matrices(C // HD, HD, jnp.float32)
    spy = _Spy(jdk.pl)
    monkeypatch.setattr(jdk, "pl", spy)
    jdk.decode_layer(jnp.asarray(x), jnp.int32(pos), kc, vc,
                     jnp.asarray(ck), jnp.asarray(cv), seg, segt, jw,
                     heads=C // HD, head_dim=HD, window=T, interpret=True,
                     **kv)
    return spy.calls["_attn_kernel"]


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("b,pos", [(3, 0), (3, 21), (17, T - 1)])
def test_walk_matches_jax_kernel(monkeypatch, variant, b, pos):
    """The walk on the inputs JAX's `_attn_kernel` got in Pallas interpret
    mode (f32; int8 codes with bf16 scales for the weights; int8 caches
    with f32 scales), against its attention output and its committed row
    pos. JAX keeps the LN1 scale and bias as [1, C] rows and passes the
    head segment matrices the port does not use."""
    w8, kv8 = VARIANTS[variant]
    args, outs = _jax_attn(monkeypatch, b, pos, w8, kv8,
                           seed=60 + 10 * b + pos + 2 * w8 + kv8)

    def tt(a):
        a = np.asarray(a)
        if a.dtype == np.int8:
            return torch.from_numpy(a.copy())
        return torch.from_numpy(a.astype(np.float32))

    x, kc, vc = tt(args[1]), tt(args[2]), tt(args[3])
    rest = args[4:]
    kv = {}
    if kv8:
        kv = dict(ks_cache=tt(rest[0]), vs_cache=tt(rest[1]))
        rest = rest[2:]
    n1s, n1b, wqkv = tt(rest[2])[0], tt(rest[3])[0], tt(rest[4])
    wqkv_s = tt(rest[5])[0].bfloat16() if w8 else None
    got, _, _ = decode_attn_walk(x, pos, kc, vc, n1s, n1b, wqkv,
                                 heads=C // HD, wqkv_s=wqkv_s, **kv)
    _hold(got[0], tt(outs[0]), torch.float32)

    def row(a):  # an aliased cache comes back whole, else the [1, B, C] row
        a = tt(a)
        return a[0] if a.shape[0] == 1 else a[pos]

    if kv8:
        _codes_close(kc[pos], row(outs[1]))
        _codes_close(vc[pos], row(outs[2]))
        for mine, theirs in ((kv["ks_cache"], outs[3]),
                             (kv["vs_cache"], outs[4])):
            np.testing.assert_allclose(mine[pos].numpy(),
                                       row(theirs).numpy(), rtol=1e-5)
    else:
        _hold(kc[pos], row(outs[1]), torch.float32)
        _hold(vc[pos], row(outs[2]), torch.float32)


# ---------------------------------------------------------------- plans

@pytest.mark.parametrize("w8", [False, True])
@pytest.mark.parametrize("b", [16, 32, 64])
def test_projection_plans_at_the_rarm_width(b, w8):
    """The projection's plan at C = 768 (N = 2304, K = 768, 36 column
    tiles) on 132 SMs: the decode tile, the largest K split (KS 3: a
    grid of 108 CTAs, one an SM beside the 96 KB LayerNorm panel) that the
    K-split rule allows, a ring of 2 to 8 stages, all of it within a CTA's
    shared memory."""
    c = 768
    p = bk.gemm_plan("qkv", b, 3 * c, c, SMS, split_k=True, w8=w8)
    assert (p.bm, p.bn, p.pp) == bk.DECODE_TILE and p.tiles_per_cta == 1
    assert p.ks == 3 and 2 <= p.stages <= 8
    assert p.smem == bk.gemm_smem("qkv", 64, 64, c, p.stages, w8, p.ks, b)
    assert p.smem <= bk._SMEM_LIMIT
    assert _ks_fits("qkv", 3 * c, c, b, p.ks, w8)
    assert not any(_ks_fits("qkv", 3 * c, c, b, x, w8)
                   for x in range(p.ks + 1, 9))


@pytest.mark.parametrize("int8_kv", [False, True])
@pytest.mark.parametrize("b", [16, 32, 64])
@pytest.mark.parametrize("pos", [0, 1, 63, 200, 255])
def test_attention_plans_at_the_rarm_width(b, pos, int8_kv):
    """The attention's plan at 12 heads of 64 on 132 SMs: four heads a
    CTA; the splits cover rows [0, pos) in whole 16-row boxes with no
    empty split, at most 4 CTAs an SM on average; at B = 16 and pos >= 63,
    132 or more CTAs on the cache stream; a box row of the cache (G heads
    of 64 bf16 or int8 elements) a multiple of TMA's 16 bytes. The ring's
    depth is the launcher's, from the built kernel's occupancy."""
    p = dk.attn_plan(b, 12, pos, SMS)
    assert p.group == 4 and p.ctas == p.splits * 3 * b
    assert 1 <= p.splits <= dk.ATTN_MAX_SPLITS
    assert p.splits == 1 or p.ctas <= 4 * SMS
    assert p.rows % dk.ATTN_ROWS == 0
    assert dk.ATTN_ROWS <= p.rows <= dk.ATTN_MAX_ROWS
    assert p.splits * p.rows >= pos and (p.splits - 1) * p.rows < max(pos, 1)
    box_row = p.group * HD * (1 if int8_kv else 2)
    assert box_row % 16 == 0 and box_row >= 16
    if b == 16 and pos >= 63:
        assert p.ctas >= SMS
    if pos == 0:
        assert p.splits == 1
