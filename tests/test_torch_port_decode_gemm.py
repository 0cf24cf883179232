"""The RARM decode chain on the block-GEMM core (csrc/decode_post_ff.cu
over csrc/block_gemm_sm90.cuh), emulated on the CPU, against the port's
plain version and the JAX Pallas kernel.

No GPU runs here, so this emulates in plain torch what the five CUDA
launches of `decode_post_ff` add to its arithmetic: the launches at R = B
rows (x1, then q2 with the cross-attention, then xm, then f, then out),
each as `gemm_plan(split_k=True)` plans it (one 64-row block per 64 rows,
zero past R, 64-column tiles, 64-wide K-steps); each launch's K split,
rank r of a cluster of KS summing its own contiguous K-steps into an f32
partial tile and rank 0 adding the others' to its own in rank order; the
LayerNorm of launches 2 and 4 over whole rows feeding one K-slice; the
cross epilogue reading the time-major context [S, B, C] through its
(image, token) strides (C, B C); int8 codes converted to bf16 (exact)
with the column scale on the f32 product before the bias; and the bf16
round trips of x1, o2, xm and f through device memory. The emulation is
held against `decode_post_ff_reference` at rtol = atol = 1e-4 in f32 (as
tests/test_torch_port_rarm.py holds the decode layer) and within 2e-2 x
max|ref| in bf16, the card tolerance of chip_smoke.py; and against JAX's
`_post_ff_kernel` in Pallas interpret mode, on the inputs a spy on
`pl.pallas_call` captured, at 1e-4 in f32, for bf16 and int8 weights.
The plans are checked at the RARM's width on an H100's 132 SMs.

The kernels themselves are held on the card by chip_smoke.py phases 7
and 12 and tests/test_torch_port_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rdm_tpu.ops import decode_kernel as jdk
from rdm_tpu_torch.ops import block_kernel as bk
from rdm_tpu_torch.ops import decode_kernel as dk
from test_torch_port_int8 import _Spy

TOL = 1e-4
CARD_TOL = 2e-2
SMS = 132  # the H100 SXM's SMs, as `bk.sm_count` reads them on the card
BK = 64    # the core's K-step
HD = 64    # the decode kernels' head width
C, F = 128, 512  # two heads


@pytest.fixture(autouse=True)
def _one_thread():
    """The walk is many small products: torch's intra-op threads only
    contend with the other test workers for them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _round(t: torch.Tensor, dtype) -> torch.Tensor:
    return t.to(dtype).float()


def _context(flat, img, t, cols, strides):
    """ck or cv [S, B, C] read as the cross epilogue reads it: element
    (image, token, column) at image * C + token * B C + column."""
    img_stride, tok_stride = strides
    idx = (img[:, None, None] * img_stride
           + torch.arange(t)[None, :, None] * tok_stride
           + torch.arange(cols.start, cols.stop)[None, None, :])
    return flat[idx].float()


def _epilogue(kind, acc, rows, cols, dtype, *, res, bias0, bias1, ctx,
              scale):
    """One tile's epilogue on its f32 accumulators [64, 64] (one per
    weight, already scaled), for the tile's global rows (clamped to R - 1
    past R, whose outputs are dropped) and columns."""
    if kind == "residual":
        return res[rows, cols].float() + _round(acc[0] + bias0[cols], dtype)
    if kind == "geglu":
        a = acc[0] + bias0[cols].float()
        g = acc[1] + bias1[cols].float()
        return a * (0.5 * g * (1.0 + torch.erf(g * 0.7071067811865476)))
    ck, cv, s, strides = ctx
    out = torch.zeros(len(rows), cols.stop - cols.start)
    for h0 in range(0, out.shape[1], HD):  # a head per 64 columns
        hc = slice(cols.start + h0, cols.start + h0 + HD)
        q = _round(acc[0][:, h0:h0 + HD], dtype)
        k = _context(ck, rows, s, hc, strides)  # one query row per image
        v = _context(cv, rows, s, hc, strides)
        sc = torch.einsum("rd,rtd->rt", q, k) * scale
        e = torch.exp(sc - sc.amax(dim=1, keepdim=True))
        p = _round(e * (1.0 / e.sum(dim=1, keepdim=True)), dtype)
        out[:, h0:h0 + HD] = torch.einsum("rt,rtd->rd", p, v)
    return out


def _launch(kind, a, w, plan, dtype, *, ln=None, scales=(None, None),
            res=None, bias0=None, bias1=None, ctx=None, scale=1.0):
    """One decode launch of the core, cluster by cluster as `plan` runs
    it: out = epilogue(A @ W) in `dtype`, A = bf16(LN(a)) over whole rows
    for the LayerNorm kinds (only the live rows; the rest stay 0). Each
    rank of a column tile's cluster sums its K-steps; rank 0 adds the
    others' partial tiles in rank order. Returns the output and the
    (column tile, rank, K-steps) triples walked."""
    r, k = a.shape
    n = w[0].shape[1]
    bm, bn = plan.bm, plan.bn
    assert (bm, bn, plan.pp) == bk.DECODE_TILE and plan.tiles_per_cta == 1
    assert k % BK == 0 and n % bn == 0
    if ln is not None:
        a = bk.layer_norm(a, *ln)  # each rank normalises the whole rows
    nkb = k // BK
    ap = torch.zeros(-(-r // bm) * bm, k)
    ap[:r] = a.float()
    wf = [wi.float() for wi in w]  # int8 codes: exact in bf16 and f32
    out = torch.zeros(r, n)
    walked = []
    for by in range(ap.shape[0] // bm):
        rows = torch.arange(by * bm, (by + 1) * bm)
        live = rows < r
        for t in range(n // bn):
            cols = slice(t * bn, (t + 1) * bn)
            parts = []
            for rank in range(plan.ks):
                steps = range(rank * nkb // plan.ks,
                              (rank + 1) * nkb // plan.ks)
                part = [torch.zeros(bm, bn) for _ in wf]
                for kb in steps:
                    ks = slice(kb * BK, (kb + 1) * BK)
                    for p, wi in zip(part, wf):
                        p += ap[rows, ks] @ wi[ks, cols]
                parts.append(part)
                walked.append((t, rank, tuple(steps)))
            acc = parts[0]
            for part in parts[1:]:  # rank 0 adds ranks 1, 2, ... in order
                acc = [x + y for x, y in zip(acc, part)]
            acc = [x if sc is None else x * sc[cols].float()
                   for x, sc in zip(acc, scales)]
            val = _epilogue(kind, acc, rows.clamp(max=r - 1), cols, dtype,
                            res=res, bias0=bias0, bias1=bias1, ctx=ctx,
                            scale=scale)
            out[rows[live], cols] = val[live]
    return out.to(dtype), walked


def decode_walk(x, attn, ck, cv, wo, bo, n2s, n2b, wq2, wo2, bo2, n3s, n3b,
                wa, wg, ba, bg, w2, b2, *, scales=None, ks=None, sms=SMS):
    """decode_post_ff as the CUDA wrapper runs it: five launches, x1, o2,
    xm and f kept in the activation dtype between them. ks forces every
    launch's K split (at most its K-steps). Returns (out, (x1, o2, xm, f),
    each launch's walk)."""
    b, c = x.shape
    f_dim, s, dt = wa.shape[1], ck.shape[0], x.dtype
    sc = scales or (None,) * 6

    def plan(kind, n, k):
        p = bk.gemm_plan(kind, b, n, k, sms, split_k=True,
                         w8=scales is not None)
        return p if ks is None else p._replace(ks=min(ks, k // BK))

    ctx = (ck.reshape(-1), cv.reshape(-1), s, (c, b * c))
    x1, w1 = _launch("residual", attn, [wo], plan("residual", c, c), dt,
                     scales=sc[:1], res=x, bias0=bo)
    o2, w2_ = _launch("cross", x1, [wq2], plan("cross", c, c), dt,
                      ln=(n2s, n2b), scales=sc[1:2], ctx=ctx,
                      scale=HD ** -0.5)
    xm, w3 = _launch("residual", o2, [wo2], plan("residual", c, c), dt,
                     scales=sc[2:3], res=x1, bias0=bo2)
    f, w4 = _launch("geglu", xm, [wa, wg], plan("geglu", f_dim, c), dt,
                    ln=(n3s, n3b), scales=sc[3:5], bias0=ba, bias1=bg)
    out, w5 = _launch("residual", f, [w2], plan("residual", c, f_dim), dt,
                      scales=sc[5:], res=xm, bias0=b2)
    return out, (x1, o2, xm, f), (w1, w2_, w3, w4, w5)


def _inputs(b, s, dtype, seed, w8=False):
    """Seeded decode_post_ff arguments at C = 128, F = 512: x, attn [B, C],
    ck, cv [S, B, C], weights [in, out] in the activation dtype (int8
    codes with w8) fan-in scaled, f32 norms near 1 and biases; and the
    column scales (w8) or None."""
    rng = np.random.default_rng(seed)

    def rn(*shape, scale=1.0, loc=0.0):
        return torch.from_numpy(
            (loc + scale * rng.standard_normal(shape)).astype(np.float32))

    acts = [rn(b, C), rn(b, C), rn(s, b, C), rn(s, b, C)]
    ws = {name: rn(k, n, scale=k ** -0.5) for name, k, n in (
        ("wo", C, C), ("wq2", C, C), ("wo2", C, C), ("wa", C, F),
        ("wg", C, F), ("w2", F, C))}
    vec = {name: rn(n, scale=0.1) for name, n in (
        ("bo", C), ("bo2", C), ("ba", F), ("bg", F), ("b2", C), ("n2b", C),
        ("n3b", C))}
    vec.update(n2s=rn(C, scale=0.1, loc=1.0), n3s=rn(C, scale=0.1, loc=1.0))
    scales = None
    if w8:
        q = {n: dk.quantize_weight(ws[n]) for n in ws}
        ws = {n: q[n][0] for n in ws}
        scales = tuple(q[n][1] for n in dk.POST_FF_WEIGHTS)
    else:
        ws = {n: v.to(dtype) for n, v in ws.items()}
    ff = [a.to(dtype) for a in acts] + [
        ws.get(n, vec.get(n)) for n in (
            "wo", "bo", "n2s", "n2b", "wq2", "wo2", "bo2", "n3s", "n3b",
            "wa", "wg", "ba", "bg", "w2", "b2")]
    return ff, scales


def _hold(got, want, dtype):
    if dtype == torch.float32:
        np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                                   rtol=TOL, atol=TOL)
    else:
        got, want = got.float(), want.float()
        rel = ((got - want).abs().max() / want.abs().max()).item()
        assert rel <= CARD_TOL, rel


@pytest.mark.parametrize("w8", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,ks", [(1, 1, None), (3, 4, None),
                                    (16, 20, None), (3, 20, 2),
                                    (16, 1, 2), (1, 4, 8)])
def test_walk_matches_plain(b, s, ks, dtype, w8):
    """The five launches at B rows with the plans' K splits (at C = 128
    two K-steps leave launches 1-4 at KS = 1 and launch 5 at KS = 4) or a
    forced one (KS = 2 in every launch; 8 where K allows), S = 1, 4 and 20
    context rows, against the plain version."""
    ff, scales = _inputs(b, s, dtype, seed=10 * b + s, w8=w8)
    out, _, walks = decode_walk(*ff, scales=scales, ks=ks)
    want = dk.decode_post_ff_reference(*ff, heads=C // HD, head_dim=HD,
                                       scales=scales)
    assert out.shape == (b, C) and out.dtype == dtype
    _hold(out, want, dtype)
    for walk, k in zip(walks, (C, C, C, C, F)):
        # every column tile's K-steps once, split into contiguous slices
        per_tile = {}
        for t, rank, steps in walk:
            per_tile.setdefault(t, []).append((rank, steps))
        for slices in per_tile.values():
            assert [r for r, _ in slices] == list(range(len(slices)))
            assert sum((list(st) for _, st in slices), []) == list(
                range(k // BK))


def test_rank_order_sum_is_the_only_change():
    """In f32 the K split changes only the order of the sums: KS = 1, 2 and
    the plans' agree to f32 rounding, and a walk repeated is bit-equal."""
    ff, _ = _inputs(16, 4, torch.float32, seed=3)
    outs = [decode_walk(*ff, ks=ks)[0] for ks in (1, 2, None, None)]
    for o in outs[1:]:
        np.testing.assert_allclose(o.numpy(), outs[0].numpy(), rtol=1e-5,
                                   atol=1e-5)
    assert torch.equal(outs[2], outs[3])


def test_round_trips_are_where_the_chain_rounds():
    """In bf16, x1, o2, xm and f leave one launch and enter the next as
    bf16: x1 equals bf16(x + bf16(attn @ wo + bo)), and the walk's out is
    its fifth launch run again on its f and xm."""
    b = 16
    ff, _ = _inputs(b, 4, torch.bfloat16, seed=5)
    out, (x1, o2, xm, f), _ = decode_walk(*ff)
    assert {t.dtype for t in (x1, o2, xm, f)} == {torch.bfloat16}
    x, attn, wo, bo = ff[0], ff[1], ff[4], ff[5]
    want_x1 = (x.float() + (attn.float() @ wo.float() + bo).bfloat16()
               .float()).bfloat16()
    _hold(x1, want_x1, torch.bfloat16)
    plan = bk.gemm_plan("residual", b, C, F, SMS, split_k=True)
    again, _ = _launch("residual", f, [ff[17]], plan, torch.bfloat16,
                       res=xm, bias0=ff[18])
    assert torch.equal(again, out)


def _jax_post_ff(monkeypatch, b, s, w8, seed):
    """JAX decode_layer in f32 through Pallas's interpreter with a spy on
    `pl.pallas_call`: (the inputs `_post_ff_kernel` got, its output)."""
    rng = np.random.default_rng(seed)

    def rn(*shape, scale=1.0, loc=0.0):
        return (loc + scale * rng.standard_normal(shape)).astype(np.float32)

    t = 8
    w = {name: rn(k, n, scale=k ** -0.5) for name, k, n in (
        ("wqkv", C, 3 * C), ("wo", C, C), ("wq2", C, C), ("wo2", C, C),
        ("wff_a", C, F), ("wff_g", C, F), ("wff2", F, C))}
    w.update({name: rn(1, n, scale=0.1) for name, n in (
        ("n1b", C), ("bo", C), ("n2b", C), ("bo2", C), ("n3b", C),
        ("bff_a", F), ("bff_g", F), ("bff2", C))})
    w.update({name: rn(1, C, scale=0.1, loc=1.0)
              for name in ("n1s", "n2s", "n3s")})
    jw = {k: jnp.asarray(v) for k, v in w.items()}
    if w8:
        for name in ("wqkv", "wo", "wq2", "wo2", "wff_a", "wff_g", "wff2"):
            codes, sc = dk.quantize_weight(torch.from_numpy(w[name]))
            jw[name] = jnp.asarray(codes.numpy())
            jw[name + "_s"] = jnp.asarray(
                sc.float().numpy()[None]).astype(jnp.bfloat16)
    x = rn(b, C)
    kc, vc = rn(t, b, C), rn(t, b, C)
    ck, cv = rn(s, b, C), rn(s, b, C)
    seg, segt = jdk.head_segment_matrices(C // HD, HD, jnp.float32)
    spy = _Spy(jdk.pl)
    monkeypatch.setattr(jdk, "pl", spy)
    jdk.decode_layer(jnp.asarray(x), jnp.int32(3), jnp.asarray(kc),
                     jnp.asarray(vc), jnp.asarray(ck), jnp.asarray(cv), seg,
                     segt, jw, heads=C // HD, head_dim=HD, window=t,
                     interpret=True)
    return spy.calls["_post_ff_kernel"]


@pytest.mark.parametrize("w8", [False, True])
def test_walk_matches_jax_kernel(monkeypatch, w8):
    """The walk on the inputs JAX's `_post_ff_kernel` got in Pallas
    interpret mode (f32; int8 codes with bf16 scales for w8), against its
    output. JAX keeps biases and scales as [1, n] rows and passes the head
    segment matrices the port does not use."""
    b, s = 3, 4
    args, out = _jax_post_ff(monkeypatch, b, s, w8, seed=40 + w8)

    def tt(a):
        a = np.asarray(a)
        if a.dtype == np.int8:
            return torch.from_numpy(a.copy())
        return torch.from_numpy(a.astype(np.float32))

    ff = [tt(a) for a in args[:4]] + [
        tt(a)[0] if np.asarray(a).ndim == 2 and np.asarray(a).shape[0] == 1
        else tt(a) for a in args[6:21]]
    scales = tuple(tt(a)[0].bfloat16() for a in args[21:27]) if w8 else None
    got, _, _ = decode_walk(*ff, scales=scales)
    _hold(got, tt(out), torch.float32)


def _ks_fits(kind, n, k, b, ks, w8):
    """The K-split rule's conditions for KS = ks: two or more K-steps a
    CTA and the grid (column tiles x ks) within one wave of `SMS` at the
    shared memory that KS and its ring take."""
    nkb, ntiles = k // 64, n // 64
    fit = [d for d in range(2, max(2, min(8, -(-nkb // ks))) + 1)
           if bk.gemm_smem(kind, 64, 64, k, d, w8, ks, b) <= bk._SMEM_LIMIT]
    return bool(fit) and nkb // ks >= 2 and ntiles * ks <= SMS * bk._per_sm(
        kind, 64, 64, 0, k, fit[-1], w8, ks, b)


@pytest.mark.parametrize("w8", [False, True])
@pytest.mark.parametrize("b", [1, 16, 32, 33, 65])
def test_plans_at_the_rarm_width(b, w8):
    """The decode chain's plans at C = 768, F = 3072 on 132 SMs: a launch
    of one 64-row block whose column tiles fill fewer than half the SMs
    splits K over the largest cluster (up to 8) that leaves each CTA two or
    more K-steps and the grid in one wave (x1 / xm and q2: 12 tiles over
    12 K-steps, KS 6; out: 12 tiles over K = 3072, KS 8; f: 48 tiles, as
    far as its shared memory lets it); B = 65 (two row blocks) splits
    nothing. Every plan fits shared memory."""
    c, f = 768, 3072
    want_ks = {"x1": 6, "cross": 6, "down": 8} if b <= 64 else \
        dict.fromkeys(("x1", "cross", "up", "down"), 1)
    for name, kind, n, k in (("x1", "residual", c, c),
                             ("cross", "cross", c, c), ("up", "geglu", f, c),
                             ("down", "residual", c, f)):
        p = bk.gemm_plan(kind, b, n, k, SMS, split_k=True, w8=w8)
        assert (p.bm, p.bn, p.pp) == bk.DECODE_TILE and p.tiles_per_cta == 1
        if name in want_ks:
            assert p.ks == want_ks[name], (name, p)
        assert p.smem == bk.gemm_smem(kind, 64, 64, k, p.stages, w8, p.ks, b)
        assert p.smem <= bk._SMEM_LIMIT and 2 <= p.stages <= 8
        if b <= 64:  # the largest KS the rule allows, and more than 1
            assert p.ks > 1 and 2 * (n // 64) < SMS
            assert _ks_fits(kind, n, k, b, p.ks, w8)
            assert not any(_ks_fits(kind, n, k, b, x, w8)
                           for x in range(p.ks + 1, 9))
    with pytest.raises(ValueError, match="decode launches have no"):
        bk.gemm_plan("post_ff", 16, c, c, SMS, split_k=True)
