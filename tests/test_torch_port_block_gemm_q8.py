"""The block-GEMM core's s8 launches (csrc/block_gemm_sm90.cuh, the int8
block's `ln_qkv_q`, `post_cross_q` and `geglu_ff_q`), emulated on the CPU,
against the port's plain versions and the JAX Pallas kernels.

No GPU runs here, so this emulates in plain torch what the six s8
launches add to the arithmetic of `ln_qkv_q` (one qkv8 launch),
`post_cross_q` (x1, cross, xmid) and `geglu_ff_q` (up, down): each
launch's A codes (quantized from its bf16 rows by the code prologue,
LayerNormed first for qkv, cross and up, or the codes the launch before
wrote); the tile schedule of `gemm_plan`'s s8 kinds (row blocks of 64 or
128 rows, 64- or 128-column tiles, column tiles a CTA walks, K in steps of
128 codes zero past K, ragged row and column edges masked); int32 tile
sums, dequantized in f32 as acc * (a * ws[n]); the epilogues (q | k | v,
each 8-column group of [R, 3C] to one of the three; residual; the
per-head cross-attention with the row -> image map inside a tile, its f32
output quantized; the GEGLU with its f32 hidden quantized); and the round
trips between launches (x1 in the activation dtype, the o and hidden
codes in int8). Held:

- each launch's int32 sums, tile by tile, EQUAL `_int_matmul` of its A
  codes and weight;
- the outputs against `ln_qkv_q_reference` / `post_cross_q_reference` /
  `geglu_ff_q_reference` by tests/test_torch_port_int8.py's `_close_int8`
  rule (1e-3 x max|ref| on all but 0.1% of the elements, 2e-2 x max|ref|
  on every one: a code on a rounding edge of the two f32 computations
  lands one step apart), in f32 and in bf16 (2e-2 x max|ref| is
  chip_smoke.py's card tolerance);
- the same against JAX's `_ln_qkv_kernel_q` / `_post_cross_kernel_q` /
  `_geglu_ff_kernel_q` in Pallas interpret mode, on the inputs a spy on
  `pl.pallas_call` captured (`test_torch_port_int8._Spy`);
- the plans at the U-Net sites at 2, 8 and 32 images, and the int8
  block's shape gate over C = 32 .. 4096.

The kernels themselves are held on the card by chip_smoke.py phase 9 and
tests/test_torch_port_cuda.py.
"""

import numpy as np
import pytest
import torch

from rdm_tpu_torch.ops import block_kernel as bk
from test_torch_port_block import HD
from test_torch_port_int8 import _close_int8, _cols, _jax_int8_block, _t

CARD_TOL = 2e-2
SMS = 132  # the H100 SXM's SMs, as `bk.sm_count` reads them on the card
BK8 = 128  # the s8 K-step (kBK8)
S8_KINDS = ("resq8", "cross8", "residual8", "geglu8", "qkv8")


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


def _epilogue(kind, f, rows, n0, n, dtype, *, res, bias0, bias1, ck, cv, s,
              scale, a_out):
    """One tile's epilogue on its dequantized f32 fragments [BM, BN] (one
    per weight), for the tile's global rows (clamped to R - 1 past R,
    whose outputs are dropped) and columns n0 .. n0 + BN; columns past N
    are computed on scale-0 zeros and dropped. Code outputs come back as
    f32 codes."""
    bn = f[0].shape[1]
    cols = slice(n0, min(n, n0 + bn))
    width = cols.stop - n0
    if kind in ("resq8", "residual8"):
        y = _round(f[0][:, :width] + bias0[cols].float(), dtype)
        return _round(res[rows, cols].float() + y, dtype)
    if kind == "qkv8":  # routed to q, k, v by `_qkv_split`
        return _round(f[0][:, :width], dtype)
    if kind == "geglu8":
        av = f[0][:, :width] + bias0[cols].float()
        gv = f[1][:, :width] + bias1[cols].float()
        h = av * (0.5 * gv * (1.0 + torch.erf(gv * 0.7071067811865476)))
        return bk.quantize_act(h, a_out).float()
    out = torch.zeros(len(rows), width)
    img = rows // s  # a row's image: a tile may span several
    for h0 in range(0, width, HD):
        q = _round(f[0][:, h0:h0 + HD], dtype)
        hc = slice(n0 + h0, n0 + h0 + HD)
        k, v = ck[img, :, hc].float(), cv[img, :, hc].float()
        sc = torch.einsum("rd,rtd->rt", q, k) * scale
        e = torch.exp(sc - sc.amax(dim=1, keepdim=True))
        p = _round(e * (1.0 / e.sum(dim=1, keepdim=True)), dtype)
        out[:, h0:h0 + HD] = torch.einsum("rt,rtd->rd", p, v)
    return bk.quantize_act(out, a_out).float()  # the f32 o, quantized


def _launch8(kind, codes, w8, ws, a, plan, dtype, *, res=None, bias0=None,
             bias1=None, ck=None, cv=None, s=1, scale=1.0, a_out=None):
    """One s8 launch, tile by tile as `plan` schedules it: out =
    epilogue(dequant(codes @ W8^T)) with codes int8 [R, K] and each W8
    int8 [N, K]. Returns the output (the activation dtype, or int8 codes
    for cross8 / geglu8), each weight's int32 sums [R, N] as the tiles
    left them, and the (row block, column tile) pairs visited."""
    r, k = codes.shape
    n = w8[0].shape[0]
    bm, bn = plan.bm, plan.bn
    kp = -(-k // BK8) * BK8  # K-steps of 128 codes, zero past K
    ap = torch.zeros(-(-r // bm) * bm, kp, dtype=torch.float64)
    ap[:r, :k] = codes.double()
    ntiles = -(-n // bn)
    wp, sp = [], []
    for w, sc in zip(w8, ws):  # rows past N zero (TMA), scale 0 past N
        wz = torch.zeros(ntiles * bn, kp, dtype=torch.float64)
        wz[:n, :k] = w.double()
        wp.append(wz)
        sz = torch.zeros(ntiles * bn)
        sz[:n] = torch.tensor(a, dtype=torch.float32) * sc
        sp.append(sz)
    codes_out = kind in ("cross8", "geglu8")
    out = torch.zeros(r, n)
    sums = [torch.zeros(r, n, dtype=torch.int64) for _ in w8]
    seen = []
    for by in range(ap.shape[0] // bm):
        rows = torch.arange(by * bm, (by + 1) * bm)
        live = rows < r
        for bx in range(-(-ntiles // plan.tiles_per_cta)):
            for t in range(bx * plan.tiles_per_cta,
                           min(ntiles, (bx + 1) * plan.tiles_per_cta)):
                n0 = t * bn
                width = min(bn, n - n0)
                f = []
                for wi in range(len(wp)):
                    acc = torch.zeros(bm, bn, dtype=torch.float64)
                    for k0 in range(0, kp, BK8):  # the ring's K-steps
                        acc += (ap[rows, k0:k0 + BK8]
                                @ wp[wi][n0:n0 + bn, k0:k0 + BK8].T)
                    sums[wi][rows[live], n0:n0 + width] = \
                        acc[live, :width].long()
                    f.append(acc.float() * sp[wi][n0:n0 + bn])
                val = _epilogue(kind, f, rows.clamp(max=r - 1), n0, n,
                                dtype, res=res, bias0=bias0, bias1=bias1,
                                ck=ck, cv=cv, s=s, scale=scale, a_out=a_out)
                out[rows[live], n0:n0 + width] = val[live]
                seen.append((by, t))
    out = out.to(torch.int8) if codes_out else out.to(dtype)
    return out, sums, seen


def _qkv_split(out, c):
    """The kQkv epilogue's routing of [R, 3C]: each 8-column group (one
    16-byte store) to q, k or v by its first column; none straddles two
    (C % 32 == 0)."""
    parts = [torch.empty_like(out[:, :c]) for _ in range(3)]
    for g0 in range(0, 3 * c, 8):
        which = g0 // c
        assert (g0 + 7) // c == which
        parts[which][:, g0 - which * c:g0 - which * c + 8] = out[:, g0:g0 + 8]
    return tuple(parts)


def ln_qkv_q_walk(x2, n1s, n1b, wqkv, ws, a, *, plan=None):
    """ln_qkv_q as the CUDA wrapper runs it: one qkv8 launch over the code
    prologue's LN1 codes; returns ((q, k, v), [(A codes, weight, int32
    sums)], the tiles it visited)."""
    r, c = x2.shape
    plan = plan or bk.gemm_plan("qkv8", r, 3 * c, c, SMS)
    h = bk.quantize_act(bk.layer_norm(x2, n1s, n1b), a)
    out, s1, t1 = _launch8("qkv8", h, [wqkv], [ws], a, plan, x2.dtype)
    return _qkv_split(out, c), [(h, wqkv, s1[0])], (t1,)


def post_cross_q_walk(x, attn, ck, cv, wo, wso, bo, n2s, n2b, wq2, wsq2, wo2,
                      wso2, bo2, a_o1, a_a2, a_o2, *, plans=None):
    """post_cross_q as the CUDA wrapper runs it: x1 in the activation dtype,
    then the o codes, then xmid; returns (xmid, x1, o8, [(A codes, weight,
    int32 sums) of each launch], the tiles each launch visited)."""
    b, s, c = x.shape
    r, dt = b * s, x.dtype
    plans = plans or [bk.gemm_plan(kind, r, c, c, SMS)
                      for kind in ("resq8", "cross8", "residual8")]
    x2 = x.reshape(r, c)
    a1 = bk.quantize_act(attn.reshape(r, c), a_o1)  # the code prologue
    x1, s1, t1 = _launch8("resq8", a1, [wo], [wso], a_o1, plans[0], dt,
                          res=x2, bias0=bo)
    a2 = bk.quantize_act(bk.layer_norm(x1, n2s, n2b), a_a2)
    o8, s2, t2 = _launch8("cross8", a2, [wq2], [wsq2], a_a2, plans[1], dt,
                          ck=ck, cv=cv, s=s, scale=HD ** -0.5, a_out=a_o2)
    xm, s3, t3 = _launch8("residual8", o8, [wo2], [wso2], a_o2, plans[2], dt,
                          res=x1, bias0=bo2)
    sums = [(a1, wo, s1[0]), (a2, wq2, s2[0]), (o8, wo2, s3[0])]
    return xm.reshape(b, s, c), x1, o8, sums, (t1, t2, t3)


def geglu_ff_q_walk(xm2, n3s, n3b, wa, wsa, wg, wsg, ba, bg, w2, ws2, b2,
                    a_ff, h_ff, *, plans=None):
    """geglu_ff_q as the CUDA wrapper runs it: the hidden codes [R, F],
    then y; returns (y, hidden codes, [(A codes, weight, int32 sums)],
    tiles)."""
    r, c = xm2.shape
    f_dim, dt = wa.shape[0], xm2.dtype
    plans = plans or [bk.gemm_plan("geglu8", r, f_dim, c, SMS),
                      bk.gemm_plan("residual8", r, c, f_dim, SMS)]
    h3 = bk.quantize_act(bk.layer_norm(xm2, n3s, n3b), a_ff)
    hq, s1, t1 = _launch8("geglu8", h3, [wa, wg], [wsa, wsg], a_ff,
                          plans[0], dt, bias0=ba, bias1=bg, a_out=h_ff)
    y, s2, t2 = _launch8("residual8", hq, [w2], [ws2], h_ff, plans[1], dt,
                         res=xm2, bias0=b2)
    sums = [(h3, wa, s1[0]), (h3, wg, s1[1]), (hq, w2, s2[0])]
    return y, hq, sums, (t1, t2)


def _inputs(heads, b, s, t, dtype, seed):
    """Seeded int8 weights in `quantize_block_weights`' layout ([out, in]
    codes, f32 scales), f32 norms and biases, the activations x, attn,
    ck, cv, xm (the activation dtype) and absmax-calibrated scales of each
    quantized activation along the plain block."""
    c = heads * HD
    rng = np.random.default_rng(seed)

    def rn(*shape, scale=1.0, loc=0.0):
        return torch.from_numpy(
            (loc + scale * rng.standard_normal(shape)).astype(np.float32))

    w = {name: rn(k, n, scale=k ** -0.5) for name, k, n in (
        ("wo", c, c), ("wq2", c, c), ("wo2", c, c), ("wa", c, 4 * c),
        ("wg", c, 4 * c), ("w2", 4 * c, c))}
    q = {}
    for name in ("wo", "wq2", "wo2", "wa", "wg", "w2"):
        codes, scale = bk.quantize_cols(w[name])
        q[name], q[name + "_s"] = codes.t().contiguous(), scale
    q.update({name: rn(n, scale=0.1) for name, n in (
        ("bo", c), ("bo2", c), ("ba", 4 * c), ("bg", 4 * c), ("b2", c),
        ("n2b", c), ("n3b", c))})
    q.update(n2s=rn(c, scale=0.1, loc=1.0), n3s=rn(c, scale=0.1, loc=1.0))
    x, attn, ck, cv, xm = (rn(*shape).to(dtype) for shape in (
        (b, s, c), (b, s, c), (b, t, c), (b, t, c), (b * s, c)))
    r = b * s
    x1 = x + bk._linear(attn.reshape(r, c), w["wo"].to(dtype),
                        q["bo"]).reshape(b, s, c)
    h2 = bk.layer_norm(x1, q["n2s"], q["n2b"])
    o = bk._cross_attention_f32(
        bk._linear(h2.reshape(r, c), w["wq2"].to(dtype)).reshape(b, s, c),
        ck, cv, heads, HD)
    h3 = bk.layer_norm(xm, q["n3s"], q["n3b"])
    hid = (bk._linear(h3, w["wa"].to(dtype), q["ba"]).float()
           * torch.nn.functional.gelu(
               bk._linear(h3, w["wg"].to(dtype), q["bg"]).float()))
    scales = [bk.act_scale(m.float().abs().max().item())
              for m in (attn, h2, o, h3, hid)]
    return q, (x, attn, ck, cv, xm), scales


def _qkv_args(heads, r, dtype, seed):
    """ln_qkv_q's arguments: seeded x [R, C] (the activation dtype), f32
    LN1 scale and bias, wqkv quantized to int8 [3C, C] codes and f32
    scales, and a_qkv calibrated on the LN1 output."""
    c = heads * HD
    rng = np.random.default_rng(seed)

    def rn(*shape, scale=1.0, loc=0.0):
        return torch.from_numpy(
            (loc + scale * rng.standard_normal(shape)).astype(np.float32))

    codes, ws = bk.quantize_cols(rn(c, 3 * c, scale=c ** -0.5))
    x2 = rn(r, c).to(dtype)
    n1s, n1b = rn(c, scale=0.1, loc=1.0), rn(c, scale=0.1)
    a = bk.act_scale(bk.layer_norm(x2, n1s, n1b).float().abs().max().item())
    return x2, n1s, n1b, codes.t().contiguous(), ws, a


def _pc_args(q, acts, scales):
    x, attn, ck, cv, _ = acts
    return (x, attn, ck, cv, q["wo"], q["wo_s"], q["bo"], q["n2s"], q["n2b"],
            q["wq2"], q["wq2_s"], q["wo2"], q["wo2_s"], q["bo2"], *scales[:3])


def _ff_args(q, acts, scales):
    return (acts[4], q["n3s"], q["n3b"], q["wa"], q["wa_s"], q["wg"],
            q["wg_s"], q["ba"], q["bg"], q["w2"], q["w2_s"], q["b2"],
            *scales[3:])


def _hold(got, want, dtype):
    if dtype == torch.float32:
        _close_int8(got, want.detach().numpy())
    else:
        got, want = got.float(), want.float()
        rel = ((got - want).abs().max() / want.abs().max()).item()
        assert rel <= CARD_TOL, rel


def _sums_exact(sums):
    for codes, w, acc in sums:
        assert torch.equal(acc, bk._int_matmul(codes, w).long())


# C = 96 / 192: ragged 64- and 128-column tiles; 672: K % 128 = 32 (the
# FFHQ site's C, K % 64 = 32 too); R = 80 / 120 / 48: ragged row blocks;
# S = 16 / 40: tiles spanning images; T = 16, 20: one and two chunks
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("heads,b,s,t", [(3, 2, 40, 3), (6, 3, 40, 16),
                                         (3, 3, 16, 1), (21, 1, 48, 20)])
def test_s8_walk_matches_plain(heads, b, s, t, dtype):
    q, acts, scales = _inputs(heads, b, s, t, dtype, seed=heads + s)
    pc = _pc_args(q, acts, scales)
    xm, x1, o8, sums, _ = post_cross_q_walk(*pc)
    _sums_exact(sums)
    _hold(xm, bk.post_cross_q_reference(*pc, heads=heads, head_dim=HD),
          dtype)
    ff = _ff_args(q, acts, scales)
    y, hq, sums, _ = geglu_ff_q_walk(*ff)
    _sums_exact(sums)
    _hold(y, bk.geglu_ff_q_reference(*ff), dtype)


# C = 96: 3C = 288, ragged 64- and 128-column tiles; 672: K % 128 = 32;
# R = 80 / 130 / 48 / 200: ragged 64-row blocks
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("heads,r", [(3, 80), (12, 130), (21, 48), (6, 200)])
def test_qkv8_walk_matches_plain(heads, r, dtype):
    args = _qkv_args(heads, r, dtype, seed=heads + r)
    got, sums, _ = ln_qkv_q_walk(*args)
    _sums_exact(sums)
    want = bk.ln_qkv_q_reference(*args)
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.shape == (r, heads * HD)
        _hold(g, w, dtype)
    if dtype == torch.bfloat16:  # q, k, v are the plain f32 values rounded
        c = heads * HD
        acc = sums[0][2][:, :].float() * (torch.tensor(args[5]) * args[4])
        for i, g in enumerate(got):
            assert torch.equal(g, acc[:, i * c:(i + 1) * c].to(dtype))


def test_round_trips_are_where_the_block_rounds():
    """In bf16: x1 leaves the first launch as bf16(x + bf16(dequant + bo))
    of the plain math; the o and hidden codes are the plain f32 values
    quantized (a value on a rounding edge one code apart, at most 0.5%
    of them); xmid and y are the last launches run on those codes."""
    heads, b, s, t = 3, 2, 40, 3
    dt = torch.bfloat16
    q, acts, scales = _inputs(heads, b, s, t, dt, seed=5)
    pc = _pc_args(q, acts, scales)
    xm, x1, o8, _, _ = post_cross_q_walk(*pc)
    x, attn, ck, cv, xm2 = acts
    r, c = b * s, heads * HD
    assert x1.dtype == xm.dtype == dt and o8.dtype == torch.int8
    a1 = scales[0]
    want_x1 = (x.reshape(r, c) + (bk._qdot(attn.reshape(r, c), q["wo"],
                                           q["wo_s"], a1)
                                  + q["bo"]).to(dt))
    assert torch.equal(x1, want_x1)
    q2 = bk._qdot(bk.layer_norm(x1, q["n2s"], q["n2b"]), q["wq2"],
                  q["wq2_s"], scales[1]).to(dt)
    o = bk._cross_attention_f32(q2.reshape(b, s, c), ck, cv, heads, HD)
    step = (o8.int() - bk.quantize_act(o.reshape(r, c), scales[2]).int())
    assert step.abs().max() <= 1 and (step != 0).float().mean() <= 5e-3
    plan = bk.gemm_plan("residual8", r, c, c, SMS)
    again, _, _ = _launch8("residual8", o8, [q["wo2"]], [q["wo2_s"]],
                           scales[2], plan, dt, res=x1, bias0=q["bo2"])
    assert torch.equal(again.reshape(xm.shape), xm)

    ff = _ff_args(q, acts, scales)
    y, hq, _, _ = geglu_ff_q_walk(*ff)
    assert hq.dtype == torch.int8 and hq.shape == (r, 4 * c)
    h3 = bk.quantize_act(bk.layer_norm(xm2, q["n3s"], q["n3b"]), scales[3])
    a3 = torch.tensor(scales[3], dtype=torch.float32)
    av = bk._int_matmul(h3, q["wa"]).float() * (a3 * q["wa_s"]) + q["ba"]
    gv = bk._int_matmul(h3, q["wg"]).float() * (a3 * q["wg_s"]) + q["bg"]
    f = av * (0.5 * gv * (1.0 + torch.erf(gv * 0.7071067811865476)))
    step = hq.int() - bk.quantize_act(f, scales[4]).int()
    assert step.abs().max() <= 1 and (step != 0).float().mean() <= 5e-3


@pytest.mark.parametrize("kind", S8_KINDS)
@pytest.mark.parametrize("tpc", [1, 2])
def test_every_s8_tile_covers_the_output(kind, tpc):
    """Each tile an s8 launch kind is built for, a CTA walking one or two
    column tiles: every (row block, column tile) pair once, the int32 sums
    exact, the plain version's output (f32, C = 192 at R = 200 rows:
    five images of 40 rows past a 128-row block)."""
    heads, b, s, t = 6, 5, 40, 3
    q, acts, scales = _inputs(heads, b, s, t, torch.float32, seed=9)
    c, r = heads * HD, b * s
    for tile in bk.GEMM_TILES[kind]:
        plan = bk.GemmPlan(*tile, tpc, 4, 0)
        pc = _pc_args(q, acts, scales)
        ff = _ff_args(q, acts, scales)
        if kind == "geglu8":
            default = bk.gemm_plan("residual8", r, c, 4 * c, SMS)
            y, _, sums, seen = geglu_ff_q_walk(*ff, plans=[plan, default])
            _hold(y, bk.geglu_ff_q_reference(*ff), torch.float32)
            n = 4 * c
        elif kind == "qkv8":
            qa = _qkv_args(heads, r, torch.float32, seed=9)
            got, sums, seen = ln_qkv_q_walk(*qa, plan=plan)
            for g, w in zip(got, bk.ln_qkv_q_reference(*qa)):
                _hold(g, w, torch.float32)
            n = 3 * c
        else:
            plans = [bk.gemm_plan(k, r, c, c, SMS)
                     for k in ("resq8", "cross8", "residual8")]
            i = ("resq8", "cross8", "residual8").index(kind)
            plans[i] = plan
            xm, _, _, sums, seen = post_cross_q_walk(*pc, plans=plans)
            _hold(xm, bk.post_cross_q_reference(*pc, heads=heads,
                                                head_dim=HD), torch.float32)
            seen = (seen[i],)
            n = c
        _sums_exact(sums)
        assert sorted(seen[0]) == [(i, j) for i in range(-(-r // tile[0]))
                                   for j in range(-(-n // tile[1]))]


@pytest.mark.parametrize("heads,b,s", [(4, 2, 16), (6, 2, 16)])
def test_s8_walk_matches_jax_kernels(monkeypatch, heads, b, s):
    """The walk on the inputs JAX's `_post_cross_kernel_q` and
    `_geglu_ff_kernel_q` got in Pallas interpret mode (f32, the JAX block
    on its own calibration), against their outputs. The JAX kernels pad C
    to 128 lanes; the port's layout drops the padding."""
    blk, w, x, ctx, absmax, calls, want = _jax_int8_block(
        monkeypatch, heads, b, s, seed=heads + 40)
    c = heads * HD
    args, out = calls["_post_cross_kernel_q"]
    ctx_t = torch.from_numpy(ctx)
    ck = (ctx_t @ w["wk2"]).reshape(b, -1, c)
    cv = (ctx_t @ w["wv2"]).reshape(b, -1, c)
    xm, _, _, sums, _ = post_cross_q_walk(
        _t(args[0]), _t(args[1][..., :c]), ck, cv,
        _t(args[6][:c].T), _t(args[7][0]), _t(args[9][0]), _t(args[10][0]),
        _t(args[11][0]), _t(args[12].T), _t(args[13][0]), _t(args[15].T),
        _t(args[16][0]), _t(args[18][0]), float(args[8][0, 0]),
        float(args[14][0, 0]), float(args[17][0, 0]))
    _sums_exact(sums)
    _close_int8(xm, np.asarray(out, np.float32))

    args, out = calls["_geglu_ff_kernel_q"]
    y, _, sums, _ = geglu_ff_q_walk(
        _t(args[0]), _t(args[1][0]), _t(args[2][0]), _t(args[3].T),
        _t(args[4][0]), _t(args[5].T), _t(args[6][0]), _t(args[7][0]),
        _t(args[8][0]), _t(args[9].T), _t(args[10][0]), _t(args[13][0]),
        float(args[11][0, 0]), float(args[12][0, 0]))
    _sums_exact(sums)
    _close_int8(y, np.asarray(out, np.float32))

    args, out = calls["_ln_qkv_kernel_q"]
    cp = -(-c // 128) * 128
    wqkv, ws = _cols(args[3], args[4], c, cp, 3)
    got, sums, _ = ln_qkv_q_walk(_t(args[0]), _t(args[1][0]),
                                 _t(args[2][0]), wqkv, ws,
                                 float(args[5][0, 0]))
    _sums_exact(sums)
    for g, o in zip(got, out):
        _close_int8(g, np.asarray(o, np.float32)[:, :c])


def test_s8_plans_at_the_unet_sites():
    """The s8 plans of the ImageNet U-Net's sites at 2, 8 and 32 images:
    each fits shared memory with its own layout (the code panel of the
    prologue kinds, the streamed A box of residual8), names a tile its
    kind is built for, runs the prologue kinds' grids in one wave, and
    gives post_cross_q's and ln_qkv_q's launches at the C = 960 site
    (R = 512) 100+ consumer warpgroups at 8 images, where the first
    versions ran 16 CTAs of four warps."""
    for c, s in ((384, 1024), (576, 256), (960, 64)):
        for images in (2, 8, 32):
            r, f = images * s, 4 * c
            for kind, n, k in (("resq8", c, c), ("cross8", c, c),
                               ("residual8", c, c), ("geglu8", f, c),
                               ("residual8", c, f), ("qkv8", 3 * c, c)):
                p = bk.gemm_plan(kind, r, n, k, SMS)
                assert (p.bm, p.bn, p.pp) in bk.GEMM_TILES[kind]
                assert p.ks == 1
                panel = (-(-k // BK8) * p.bm * BK8
                         if kind != "residual8" else 0)
                stage = ((p.bm * BK8 if kind == "residual8" else 0)
                         + (2 if kind == "geglu8" else 1) * p.bn * BK8)
                assert p.smem == 1024 + panel + p.stages * (stage + 16)
                assert p.smem == bk.gemm_smem(kind, p.bm, p.bn, k, p.stages)
                assert p.smem <= bk._SMEM_LIMIT and 3 <= p.stages <= 8
                assert not p.pp or p.stages % 2 == 0  # two rings
                ntiles = -(-n // p.bn)
                ctas = -(-r // p.bm) * -(-ntiles // p.tiles_per_cta)
                if kind == "residual8":
                    assert p.tiles_per_cta == 1
                per_sm = min(bk._SMEM_SM // (p.smem + 1024),
                             2048 // bk._threads(p.bm, p.pp))
                if kind != "residual8" and p.tiles_per_cta < ntiles:
                    assert ctas <= SMS * per_sm  # one wave
                if c == 960 and images == 8 and kind != "geglu8":
                    assert ctas * (2 if p.pp else p.bm // 64) >= 100


def _smem_fits(kind, k):
    """Whether any tile of an s8 launch kind fits shared memory at K = k
    with the fewest stages a plan takes (3 split, 4 ping-pong), from the
    layout in csrc/block_gemm_sm90.cuh `smem8_bytes`, written out here."""
    for bm, bn, pp in bk.GEMM_TILES[kind]:
        panel = -(-k // BK8) * bm * BK8 if kind != "residual8" else 0
        stage = ((bm * BK8 if kind == "residual8" else 0)
                 + (2 if kind == "geglu8" else 1) * bn * BK8)
        st = 4 if pp else 3
        if 1024 + panel + st * (stage + 16) <= 232448:
            return True
    return False


@pytest.mark.parametrize("head_dim", [32, 64])
def test_int8_gate_refuses_where_a_launch_cannot_run(head_dim):
    """The int8 block over C = 32 .. 4096 (F = 4C, T = 4, the bf16
    attention core): refused exactly where one of its launches cannot run
    (the s8 code prologue past K = 1536, `ln_qkv_q`'s qkv8 launch
    included, a launch's shared memory), so it takes every width up to
    1536, past the first versions' 1312; a width that is not a multiple
    of the head refuses on that."""
    for c in range(32, 4097, 32):
        got = bk.block_refusal(c, 4, max(1, c // head_dim), head_dim, 4 * c,
                               int8=True, split_k3=True)
        if c % head_dim:
            assert got is not None and "heads of" in got, (c, got)
            continue
        runs = (c <= 1536 and all(_smem_fits(k, c) for k in
                                  ("resq8", "cross8", "geglu8", "qkv8"))
                and _smem_fits("residual8", 4 * c))
        assert (got is None) == runs, (c, got)
        if c <= 1312:  # every width the first versions ran
            assert got is None, (c, got)
    assert bk.kernel_refusal("ln_qkv_q", 1536) is None
    assert "code prologue" in bk.kernel_refusal("ln_qkv_q", 1568)
    assert "code prologue" in bk.kernel_refusal("post_cross_q", 1568)
    assert "code prologue" in bk.kernel_refusal("geglu_ff_q", 1568, f=6272)
    assert bk.kernel_refusal("geglu_ff_q", 1536, f=6144) is None
