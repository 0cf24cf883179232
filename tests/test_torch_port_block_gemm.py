"""The block-GEMM core's walk (csrc/block_gemm_sm90.cuh), emulated on the
CPU, against the port's plain versions and the JAX Pallas kernels.

No GPU runs here, so this emulates in plain torch what the CUDA launches
add to the arithmetic of `ln_qkv` (one launch), `post_cross` (three) and
`geglu_ff` (two): the decomposition into launches; each launch's tile schedule from
`gemm_plan` (row blocks of 64 or 128 rows, 64- or 128-column tiles,
column tiles walked by a CTA, K in 64-wide steps zero-filled past K,
ragged row and column edges masked; a ping-pong tile changes only which
warpgroup runs a column tile, not its arithmetic); the LayerNorm
prologue; the row -> image map of the cross-attention epilogue inside a
tile (a 64-row tile spans images at S = 16 and 40); the q | k | v split of
the qkv epilogue (a 128-column tile straddles two of them); and the bf16
round trips of x1, o and f through device memory. The weights stay in
`pack_block_weights`' [in, out] layout (no packed copy). The emulation
is held against the plain versions
(`ln_qkv_reference`, `post_cross_reference`, `geglu_ff_reference`) at
rtol = atol = 1e-4 in f32, as tests/test_torch_port_block.py holds them,
and within 2e-2 x max|ref| in bf16, the card tolerance of chip_smoke.py;
and against JAX's `_ln_qkv_kernel`, `_post_cross_kernel` and
`_geglu_ff_kernel` in Pallas interpret mode on the inputs a spy on
`pl.pallas_call` captured, at 1e-4.

The kernels themselves are held on the card by chip_smoke.py phase 3 and
tests/test_torch_port_cuda.py.
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rdm_tpu.models.layers import FusedTransformerBlock
from rdm_tpu.ops import block_kernel as jbk
from rdm_tpu_torch.ops import block_kernel as bk
from test_torch_port_block import HD, _setup
from test_torch_port_int8 import _Spy

TOL = 1e-4
CARD_TOL = 2e-2
SMS = 132  # the H100 SXM's SMs, as `bk.sm_count` reads them on the card
BK = 64  # the core's K-step


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


def _epilogue(kind, acc, rows, n0, n, dtype, *, res, bias0, bias1, ck, cv,
              s, scale):
    """One tile's epilogue on its f32 accumulators [BM, BN] (one per
    weight), for the tile's global rows (clamped to R - 1 past R, whose
    outputs are dropped) and columns n0 .. n0 + BN; columns past N are
    computed on zeros and dropped."""
    bn = acc[0].shape[1]
    cols = slice(n0, min(n, n0 + bn))
    width = cols.stop - n0
    if kind == "residual":
        y = _round(acc[0][:, :width] + bias0[cols].float(), dtype)
        return res[rows, cols].float() + y
    if kind == "qkv":  # rounded once, as the whole [R, 3C] product
        return acc[0][:, :width]
    if kind == "geglu":
        a = acc[0][:, :width] + bias0[cols].float()
        g = acc[1][:, :width] + bias1[cols].float()
        return a * (0.5 * g * (1.0 + torch.erf(g * 0.7071067811865476)))
    out = torch.zeros(len(rows), width)
    img = rows // s  # a row's image: a tile may span several
    for h0 in range(0, width, HD):
        q = _round(acc[0][:, h0:h0 + HD], dtype)
        hc = slice(n0 + h0, n0 + h0 + HD)
        k, v = ck[img, :, hc].float(), cv[img, :, hc].float()
        sc = torch.einsum("rd,rtd->rt", q, k) * scale
        e = torch.exp(sc - sc.amax(dim=1, keepdim=True))
        p = _round(e * (1.0 / e.sum(dim=1, keepdim=True)), dtype)
        out[:, h0:h0 + HD] = torch.einsum("rt,rtd->rd", p, v)
    return out


def _launch(kind, a, w, plan, dtype, *, ln=None, res=None, bias0=None,
            bias1=None, ck=None, cv=None, s=1, scale=1.0):
    """One launch of the core, tile by tile as `plan` schedules it: out =
    epilogue(A @ W) in `dtype`, A = bf16(LN(a)) for the LayerNorm kinds.
    Returns the output and the (row block, column tile) pairs visited."""
    r, k = a.shape
    n = w[0].shape[1]
    bm, bn = plan.bm, plan.bn
    if ln is not None:
        a = bk.layer_norm(a, *ln)  # what the prologue leaves in the panel
    kp = -(-k // BK) * BK  # K-steps of 64, zero past K
    ap = torch.zeros(-(-r // bm) * bm, kp)
    ap[:r, :k] = a.float()
    ntiles = -(-n // bn)
    out = torch.zeros(r, n)
    seen = []
    for by in range(ap.shape[0] // bm):
        rows = torch.arange(by * bm, (by + 1) * bm)
        live = rows < r
        for bx in range(-(-ntiles // plan.tiles_per_cta)):
            for t in range(bx * plan.tiles_per_cta,
                           min(ntiles, (bx + 1) * plan.tiles_per_cta)):
                n0 = t * bn
                acc = []
                for wi in w:
                    wt = torch.zeros(kp, bn)
                    wt[:k, :min(bn, n - n0)] = wi[:, n0:n0 + bn].float()
                    part = torch.zeros(bm, bn)
                    for k0 in range(0, kp, BK):  # the ring's K-steps
                        part += ap[rows, k0:k0 + BK] @ wt[k0:k0 + BK]
                    acc.append(part)
                val = _epilogue(kind, acc, rows.clamp(max=r - 1), n0, n,
                                dtype, res=res, bias0=bias0, bias1=bias1,
                                ck=ck, cv=cv, s=s, scale=scale)
                out[rows[live], n0:n0 + val.shape[1]] = val[live]
                seen.append((by, t))
    return out.to(dtype), seen


def post_cross_walk(x, attn, ck, cv, wo, bo, n2s, n2b, wq2, wo2, bo2, *,
                    heads, plans=None):
    """post_cross as the CUDA wrapper runs it: x1, then o, then xmid, each
    kept in the activation dtype between launches; returns (xmid, x1, o,
    the tiles each launch visited)."""
    b, s, c = x.shape
    r, dt = b * s, x.dtype
    res_plan = plans[0] if plans else bk.gemm_plan("residual", r, c, c, SMS)
    cross_plan = plans[1] if plans else bk.gemm_plan("cross", r, c, c, SMS)
    x2 = x.reshape(r, c)
    x1, s1 = _launch("residual", attn.reshape(r, c), [wo], res_plan, dt,
                     res=x2, bias0=bo)
    o, s2 = _launch("cross", x1, [wq2], cross_plan, dt, ln=(n2s, n2b),
                    ck=ck, cv=cv, s=s, scale=HD ** -0.5)
    xm, s3 = _launch("residual", o, [wo2], res_plan, dt, res=x1, bias0=bo2)
    return xm.reshape(b, s, c), x1, o, (s1, s2, s3)


def ln_qkv_walk(x2, n1s, n1b, wqkv, plan=None):
    """ln_qkv as the CUDA wrapper runs it: one launch over [R, 3C], each
    column of which lands in q, k or v; returns (q, k, v, tiles)."""
    r, c = x2.shape
    plan = plan or bk.gemm_plan("qkv", r, 3 * c, c, SMS)
    out, seen = _launch("qkv", x2, [wqkv], plan, x2.dtype, ln=(n1s, n1b))
    return out[:, :c], out[:, c:2 * c], out[:, 2 * c:], seen


def geglu_ff_walk(xm2, n3s, n3b, wa, wg, ba, bg, w2, b2, plans=None):
    """geglu_ff as the CUDA wrapper runs it: f = GEGLU(LN3(xm)) in the
    activation dtype, then y = xm + f @ w2 + b2; returns (y, f, tiles)."""
    r, c = xm2.shape
    f_dim, dt = wa.shape[1], xm2.dtype
    up_plan = plans[0] if plans else bk.gemm_plan("geglu", r, f_dim, c, SMS)
    down_plan = (plans[1] if plans
                 else bk.gemm_plan("residual", r, c, f_dim, SMS))
    f, s1 = _launch("geglu", xm2, [wa, wg], up_plan, dt, ln=(n3s, n3b),
                    bias0=ba, bias1=bg)
    y, s2 = _launch("residual", f, [w2], down_plan, dt, res=xm2, bias0=b2)
    return y, f, (s1, s2)


def _inputs(heads, b, s, t, dtype, seed):
    """Seeded weights in `pack_block_weights`' layout ([in, out] in the
    activation dtype, fan-in scaled; f32 norms near 1 and biases) and the
    post_cross inputs x, attn, ck, cv (ln_qkv's weight and norm drawn
    last)."""
    c = heads * HD
    rng = np.random.default_rng(seed)

    def rn(*shape, scale=1.0, loc=0.0):
        return torch.from_numpy(
            (loc + scale * rng.standard_normal(shape)).astype(np.float32))

    w = {name: rn(k, n, scale=k ** -0.5).to(dtype) for name, k, n in (
        ("wo", c, c), ("wq2", c, c), ("wo2", c, c), ("wa", c, 4 * c),
        ("wg", c, 4 * c), ("w2", 4 * c, c))}
    w.update({name: rn(n, scale=0.1) for name, n in (
        ("bo", c), ("bo2", c), ("ba", 4 * c), ("bg", 4 * c), ("b2", c),
        ("n2b", c), ("n3b", c))})
    w.update(n2s=rn(c, scale=0.1, loc=1.0), n3s=rn(c, scale=0.1, loc=1.0))
    acts = [rn(*shape).to(dtype)
            for shape in ((b, s, c), (b, s, c), (b, t, c), (b, t, c))]
    w.update(wqkv=rn(c, 3 * c, scale=c ** -0.5).to(dtype),
             n1s=rn(c, scale=0.1, loc=1.0), n1b=rn(c, scale=0.1))
    return w, acts


def _hold(got, want, dtype):
    if dtype == torch.float32:
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=TOL,
                                   atol=TOL)
    else:
        got, want = got.float(), want.float()
        rel = ((got - want).abs().max() / want.abs().max()).item()
        assert rel <= CARD_TOL, rel


# C = 96 / 192: a 64- or 128-column tile with a ragged column edge; R = 80
# / 120 / 48: ragged row blocks; S = 16 / 40: tiles spanning images
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("heads,b,s,t", [(3, 2, 40, 3), (6, 3, 40, 16),
                                         (3, 3, 16, 1), (6, 5, 16, 4)])
def test_walk_matches_plain(heads, b, s, t, dtype):
    w, (x, attn, ck, cv) = _inputs(heads, b, s, t, dtype, seed=heads + s)
    pc = (x, attn, ck, cv, w["wo"], w["bo"], w["n2s"], w["n2b"], w["wq2"],
          w["wo2"], w["bo2"])
    xm, _, _, _ = post_cross_walk(*pc, heads=heads)
    want = bk.post_cross_reference(*pc, heads=heads, head_dim=HD)
    _hold(xm, want, dtype)
    ff = (want.reshape(b * s, -1), w["n3s"], w["n3b"], w["wa"], w["wg"],
          w["ba"], w["bg"], w["w2"], w["b2"])
    y, _, _ = geglu_ff_walk(*ff)
    _hold(y, bk.geglu_ff_reference(*ff), dtype)


# C = 96: a ragged 128-column tile; 672: K % 64 = 32 (the FFHQ site) and
# tiles straddling q | k and k | v; R = 1, 80, 200: ragged row blocks
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,r", [(96, 80), (96, 1), (192, 200), (672, 80)])
def test_qkv_walk_matches_plain(c, r, dtype):
    w, (x, _, _, _) = _inputs(c // HD, 1, r, 1, dtype, seed=c + r)
    args = (x.reshape(r, c), w["n1s"], w["n1b"], w["wqkv"])
    q, k, v, _ = ln_qkv_walk(*args)
    for got, want in zip((q, k, v), bk.ln_qkv_reference(*args)):
        assert got.shape == (r, c)
        _hold(got, want, dtype)


@pytest.mark.parametrize("tile", bk.GEMM_TILES["qkv"])
@pytest.mark.parametrize("tpc", [1, 2])
def test_qkv_tiles_cover_the_output(tile, tpc):
    """Each tile the qkv launch is built for, a CTA walking one or two
    column tiles: every (row block, column tile) pair once, the plain
    version's q, k and v (f32, C = 96 at R = 200)."""
    c, r = 96, 200
    w, (x, _, _, _) = _inputs(c // HD, 1, r, 1, torch.float32, seed=4)
    args = (x.reshape(r, c), w["n1s"], w["n1b"], w["wqkv"])
    plan = bk.GemmPlan(*tile, tpc, 3, 0)
    *qkv, seen = ln_qkv_walk(*args, plan=plan)
    for got, want in zip(qkv, bk.ln_qkv_reference(*args)):
        _hold(got, want, torch.float32)
    assert sorted(seen) == [(i, j) for i in range(-(-r // tile[0]))
                            for j in range(-(-3 * c // tile[1]))]


@pytest.mark.parametrize("tile", [(128, 128, 0), (64, 128, 0), (64, 64, 0),
                                  (128, 64, 1), (64, 64, 1)])
@pytest.mark.parametrize("tpc", [1, 2])
def test_every_tile_covers_the_output(tile, tpc):
    """Each tile the kernels are built for (rows, columns, ping-pong), a
    CTA walking one or two column tiles: every (row block, column tile)
    pair once, the plain versions' result (f32, C = 192 at R = 200 rows,
    three images of 40 rows past a 128-row block)."""
    heads, b, s, t = 6, 5, 40, 3
    w, (x, attn, ck, cv) = _inputs(heads, b, s, t, torch.float32, seed=9)
    c, r = heads * HD, b * s
    plan = bk.GemmPlan(*tile, tpc, 3, 0)
    pc = (x, attn, ck, cv, w["wo"], w["bo"], w["n2s"], w["n2b"], w["wq2"],
          w["wo2"], w["bo2"])
    xm, _, _, seen = post_cross_walk(*pc, heads=heads, plans=(plan, plan))
    want = bk.post_cross_reference(*pc, heads=heads, head_dim=HD)
    _hold(xm, want, torch.float32)
    row_blocks = -(-r // tile[0])
    for walked, n in zip(seen, (c, c, c)):
        assert sorted(walked) == [(i, j) for i in range(row_blocks)
                                  for j in range(-(-n // tile[1]))]
    ff = (want.reshape(r, c), w["n3s"], w["n3b"], w["wa"], w["wg"], w["ba"],
          w["bg"], w["w2"], w["b2"])
    y, _, seen = geglu_ff_walk(*ff, plans=(plan, plan))
    _hold(y, bk.geglu_ff_reference(*ff), torch.float32)
    assert len(seen[0]) == row_blocks * -(-4 * c // tile[1])


def test_round_trips_are_where_the_block_rounds():
    """In bf16, x1, o and f leave one launch and enter the next as bf16:
    x1 equals bf16(x + bf16(attn @ wo + bo)) of the plain math, and the
    walk's xmid is the third launch run on the second's o."""
    heads, b, s, t = 3, 2, 40, 3
    w, (x, attn, ck, cv) = _inputs(heads, b, s, t, torch.bfloat16, seed=5)
    pc = (x, attn, ck, cv, w["wo"], w["bo"], w["n2s"], w["n2b"], w["wq2"],
          w["wo2"], w["bo2"])
    xm, x1, o, _ = post_cross_walk(*pc, heads=heads)
    r, c = b * s, heads * HD
    assert x1.dtype == o.dtype == xm.dtype == torch.bfloat16
    mm = attn.reshape(r, c).float() @ w["wo"].float() + w["bo"]
    want_x1 = (x.reshape(r, c).float() + mm.bfloat16().float()).bfloat16()
    _hold(x1, want_x1, torch.bfloat16)
    plan = bk.gemm_plan("residual", r, c, c, SMS)
    again, _ = _launch("residual", o, [w["wo2"]], plan, torch.bfloat16,
                       res=x1, bias0=w["bo2"])
    assert torch.equal(again.reshape(xm.shape), xm)


@pytest.mark.parametrize("heads,b,s", [(3, 2, 40), (6, 2, 16)])
def test_walk_matches_jax_kernels(monkeypatch, heads, b, s):
    """The walk on the inputs JAX's `_post_cross_kernel` and
    `_geglu_ff_kernel` got in Pallas interpret mode (f32), against their
    outputs. The JAX kernels pad C to 128 lanes; the port's layout drops
    the padding."""
    monkeypatch.setenv("RDM_TPU_PARTITION_KERNELS", "0")
    monkeypatch.setenv("RDM_TPU_SPLIT_K3", "1")
    t = 3
    _, params, _, w, x, ctx = _setup(heads, b, s, t, 40, seed=heads + 20)
    spy = _Spy(jbk.pl)
    monkeypatch.setattr(jbk, "pl", spy)
    fused = FusedTransformerBlock(heads=heads, head_dim=HD, interpret=True)
    fused.apply(copy.deepcopy(params), jnp.asarray(x), jnp.asarray(ctx))
    c = heads * HD

    def tt(a):
        return torch.from_numpy(np.array(a, np.float32))

    args, out = spy.calls["_post_cross_kernel"]
    ctx_t = torch.from_numpy(ctx)
    ck = (ctx_t @ w["wk2"]).reshape(b, -1, c)
    cv = (ctx_t @ w["wv2"]).reshape(b, -1, c)
    xm, _, _, _ = post_cross_walk(
        tt(args[0]), tt(args[1][..., :c]), ck, cv, tt(args[6][:c]),
        tt(args[7][0]), tt(args[8][0]), tt(args[9][0]), tt(args[10]),
        tt(args[11]), tt(args[12][0]), heads=heads)
    _hold(xm, tt(out), torch.float32)

    args, out = spy.calls["_geglu_ff_kernel"]
    y, _, _ = geglu_ff_walk(tt(args[0]), tt(args[1][0]), tt(args[2][0]),
                            tt(args[3]), tt(args[4]), tt(args[5][0]),
                            tt(args[6][0]), tt(args[7]), tt(args[8][0]))
    _hold(y, tt(out), torch.float32)

    # the qkv launch: JAX's Wqkv and q, k, v carry C padded to cp lanes
    args, out = spy.calls["_ln_qkv_kernel"]
    cp = out[0].shape[1]
    wqkv = tt(args[3])
    wqkv = torch.cat([wqkv[:, i * cp:i * cp + c] for i in range(3)], dim=1)
    *qkv, _ = ln_qkv_walk(tt(args[0]), tt(args[1][0]), tt(args[2][0]), wqkv)
    for got, want in zip(qkv, out):
        _hold(got, tt(want)[:, :c], torch.float32)


def test_plans_at_the_unet_sites():
    """The plans of the ImageNet U-Net's sites at 2, 8 and 32 images (2:
    a batch-1 forward under shared CFG): each fits shared memory, the
    LayerNorm kinds' grids fit one wave, post_cross's launches at the
    C = 960 site run 100+ CTAs at 8 images, ln_qkv takes the 128-row tile
    where it fills the card and the 64-row ping-pong one at C = 960, and
    every tile a plan names is built for its kind."""
    for c, s in ((384, 1024), (576, 256), (960, 64)):
        for images in (2, 8, 32):
            r, f = images * s, 4 * c
            for kind, n, k in (("residual", c, c), ("cross", c, c),
                               ("geglu", f, c), ("residual", c, f),
                               ("qkv", 3 * c, c)):
                p = bk.gemm_plan(kind, r, n, k, SMS)
                # no K split at any U-Net site (R >= 128), even where the
                # launcher takes one
                assert p.ks == 1 and (kind == "qkv" or bk.gemm_plan(
                    kind, r, n, k, SMS, split_k=True).ks == 1)
                assert (p.bm, p.bn, p.pp) in bk.GEMM_TILES[kind]
                assert p.smem == bk.gemm_smem(kind, p.bm, p.bn, k, p.stages)
                assert p.smem <= bk._SMEM_LIMIT and 2 <= p.stages <= 8
                assert not p.pp or p.stages % 2 == 0  # two rings
                ntiles = -(-n // p.bn)
                ctas = -(-r // p.bm) * -(-ntiles // p.tiles_per_cta)
                if kind == "residual":
                    assert p.tiles_per_cta == 1
                per_sm = min(bk._SMEM_SM // (p.smem + 1024),
                             2048 // bk._threads(p.bm, p.pp))
                if kind != "residual" and p.tiles_per_cta < ntiles:
                    assert ctas <= SMS * per_sm  # one wave
                if c == 960 and images == 8 and kind in ("residual",
                                                          "cross"):
                    assert ctas >= 100
    assert bk.gemm_plan("cross", 8192, 384, 384, SMS).bn == 64
    assert bk.gemm_plan("qkv", 8192, 1152, 384, SMS)[:3] == (128, 128, 0)
    assert bk.gemm_plan("qkv", 512, 2880, 960, SMS)[:3] == (64, 128, 1)


def test_plan_refuses_what_does_not_fit():
    with pytest.raises(ValueError, match="shared memory"):
        bk.gemm_plan("geglu", 512, 8192, 2048, SMS)
    with pytest.raises(ValueError, match="kind"):
        bk.gemm_plan("post_ff", 512, 384, 384, SMS)
    with pytest.raises(ValueError, match="shared memory"):
        bk.gemm_plan("qkv", 512, 3 * 1312, 1312, SMS)  # the LN panel
    with pytest.raises(ValueError, match="shared memory"):
        bk.gemm_plan("cross", 512, 1664, 1664, SMS)  # the LN panel
