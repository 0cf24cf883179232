"""The port's post-attention half of the SpatialTransformer block in one
call (`ops/block_kernel.post_ff`, the JAX `_post_ff_kernel` that
`fused_transformer_block` runs under RDM_TPU_SPLIT_K3=0) against the JAX
package, on the CPU, and its FF launch emulated (below).

Inputs and weights come from the numpy-seeded setup of
tests/test_torch_port_block.py. The JAX block runs its kernels in Pallas
interpret mode, as tests/test_block_kernel.py:29-38 runs them. Tolerance:
1e-3 x max|ref| (the golden tests' rule, tests/test_torch_convert.py), f32
on both sides; the plain versions of the single kernel and of the split
pair agree to 1e-6 x max|ref| (the same arithmetic).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rdm_tpu.models.layers import FusedTransformerBlock
from rdm_tpu_torch.ops import block_kernel as bk
from test_torch_port_block import HD, SHAPES, _setup


def _close(got, want, rel=1e-3):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want,
                               atol=rel * float(np.abs(want).max()), rtol=0)


def _jax_single_kernel(monkeypatch, heads, params, x, ctx):
    monkeypatch.setenv("RDM_TPU_SPLIT_K3", "0")
    monkeypatch.setenv("RDM_TPU_PARTITION_KERNELS", "0")
    fused = FusedTransformerBlock(heads=heads, head_dim=HD, interpret=True)
    return fused.apply(params, jnp.asarray(x), jnp.asarray(ctx))


class _Spy:
    """Counts the calls of a block_kernel wrapper it stands in for."""

    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *args, **kw):
        self.calls += 1
        return self.fn(*args, **kw)


@pytest.mark.parametrize("shape", SHAPES)
def test_block_with_single_kernel_matches_jax(monkeypatch, shape):
    """fused_transformer_block(split_k3=False), and the block's fused route
    with RDM_TPU_SPLIT_K3=0, against JAX's with RDM_TPU_SPLIT_K3=0; both go
    through post_ff and neither through the split pair."""
    heads = shape[0]
    ref, params, blk, w, x, ctx = _setup(*shape, seed=5)
    want = _jax_single_kernel(monkeypatch, heads, params, x, ctx)
    spies = {n: _Spy(getattr(bk, n)) for n in ("post_ff", "post_cross",
                                               "geglu_ff")}
    for n, spy in spies.items():
        monkeypatch.setattr(bk, n, spy)
    xt, ct = torch.from_numpy(x), torch.from_numpy(ctx)
    with torch.no_grad():
        got = bk.fused_transformer_block(xt, ct, w, heads=heads, head_dim=HD,
                                         split_k3=False)
        _close(got, want)
        _close(blk.forward_fused(xt, ct), want)  # reads RDM_TPU_SPLIT_K3
    assert {n: s.calls for n, s in spies.items()} == {
        "post_ff": 2, "post_cross": 0, "geglu_ff": 0}


@pytest.mark.parametrize("shape", SHAPES)
def test_post_ff_reference_is_the_split_pair(shape):
    """post_ff's plain version (what the wrapper runs on the CPU) is
    post_cross's followed by geglu_ff's."""
    heads, b, s, t = shape[:4]
    c = heads * HD
    _, _, _, w, x, _ = _setup(*shape, seed=6)
    rng = np.random.default_rng(7)
    attn, ck, cv = (torch.from_numpy(rng.standard_normal(sh).astype(
        np.float32)) for sh in ((b, s, c), (b, t, c), (b, t, c)))
    xt = torch.from_numpy(x)
    pc = (xt, attn, ck, cv, w["wo"], w["bo"], w["n2s"], w["n2b"], w["wq2"],
          w["wo2"], w["bo2"])
    ff = (w["n3s"], w["n3b"], w["wa"], w["wg"], w["ba"], w["bg"], w["w2"],
          w["b2"])
    split = bk.geglu_ff_reference(
        bk.post_cross_reference(*pc, heads=heads, head_dim=HD).reshape(
            b * s, c), *ff).reshape(b, s, c)
    bk.reset_launch_counts()
    for fn in (bk.post_ff_reference, bk.post_ff):  # the wrapper, on CPU
        _close(fn(*pc, *ff, heads=heads, head_dim=HD), split, 1e-6)
    assert set(bk.launch_counts().values()) == {0}


def test_int8_mode_keeps_the_split_pair(monkeypatch):
    """With qscales the split pair runs whatever split_k3 says, as in JAX
    (`fused_transformer_block`: qscales forces `_split_post_ff`)."""
    ref, params, blk, w, x, ctx = _setup(*SHAPES[0], seed=8)
    spy = _Spy(bk.post_ff)
    monkeypatch.setattr(bk, "post_ff", spy)
    qscales = dict.fromkeys(bk.QSCALE_NAMES, 4.0)
    with torch.no_grad():
        bk.fused_transformer_block(
            torch.from_numpy(x), torch.from_numpy(ctx),
            bk.quantize_block_weights(w), heads=SHAPES[0][0], head_dim=HD,
            qscales=qscales, split_k3=False)
    assert spy.calls == 0


@pytest.mark.parametrize("value,split", [(None, True), ("1", True),
                                         ("0", False), ("2", True)])
def test_split_k3_reads_the_environment(monkeypatch, value, split):
    if value is None:
        monkeypatch.delenv("RDM_TPU_SPLIT_K3", raising=False)
    else:
        monkeypatch.setenv("RDM_TPU_SPLIT_K3", value)
    assert bk.use_split_k3() is split


def test_post_ff_checks_shapes():
    x = torch.zeros((1, 8, 64))
    ctx = torch.zeros((1, 4, 64))
    w, n = torch.zeros((64, 64)), torch.ones(64)
    wf, nf = torch.zeros((64, 256)), torch.ones(256)
    with pytest.raises(ValueError, match="post_ff"):
        bk.post_ff(x, x, ctx, ctx, w, n, n, n, w, w, n, n, n, wf, wf, nf, nf,
                   wf, n, heads=2, head_dim=HD)  # w2 not [F, C]


# ------------------------------------------------- post_ff's FF launch
#
# No GPU runs here, so `ff_walk` emulates in plain torch what post_ff's
# fourth launch (csrc/block_gemm_sm90.cuh `block_gemm_ff_kernel`) adds to
# the arithmetic of geglu_ff: per 64-row block (zero past R), a cluster of
# `ff_plan`'s ranks; rank r normalises the block's rows (LN3 over whole
# rows) and takes the whole 64-column f tiles [r NT / n, (r + 1) NT / n)
# of F; per f tile the value and gate products in f32, the GEGLU, f
# rounded to the activation dtype; the rank's partial y = f_r @ w2[F_r]
# in f32; each 32-column unit of y summed across the ranks in rank order
# by its owner (unit u at rank u mod n, round by round); y = xm +
# round(sum + b2). Held against the plain versions and JAX's
# `_post_ff_kernel` (through its block in interpret mode) in f32, within
# 2e-2 x max|ref| in bf16, and the plans at the U-Net's sites.

SMS = 132  # the H100 SXM's SMs
UNIT = 32  # columns of a unit of the K split's sum


def _round(t, dtype):
    return t.to(dtype).float()


def ff_walk(xm2, n3s, n3b, wa, wg, ba, bg, w2, b2, plan):
    """The FF launch as `plan` runs it: y [R, C] in xm2's dtype, and the
    walk: (row block, rank, its f tiles) and, a round at a time, (round,
    owner, units)."""
    r, c = xm2.shape
    f, dt = wa.shape[1], xm2.dtype
    n, ntf = plan.ranks, f // 64
    rp = -(-r // 64) * 64
    xp = torch.zeros(rp, c, dtype=dt)
    xp[:r] = xm2
    h3 = bk.layer_norm(xp, n3s, n3b).float()  # every rank, whole rows
    y = torch.zeros(rp, c)
    walked, rounds = [], []
    for u0 in range(0, c // UNIT, plan.round_units):
        u1 = min(c // UNIT, u0 + plan.round_units)
        rounds += [(u0 // plan.round_units, o, list(range(u0 + o, u1, n)))
                   for o in range(n)]
    for by in range(rp // 64):
        rows = slice(by * 64, (by + 1) * 64)
        parts = []
        for rank in range(n):
            tiles = range(rank * ntf // n, (rank + 1) * ntf // n)
            walked.append((by, rank, tuple(tiles)))
            fr = []
            for ft in tiles:
                cols = slice(ft * 64, (ft + 1) * 64)
                a = h3[rows] @ wa[:, cols].float() + ba[cols].float()
                g = h3[rows] @ wg[:, cols].float() + bg[cols].float()
                fr.append(_round(
                    a * (0.5 * g * (1.0 + torch.erf(g * 0.7071067811865476))),
                    dt))
            ks = slice(tiles[0] * 64, (tiles[-1] + 1) * 64)
            parts.append(torch.cat(fr, dim=1) @ w2[ks].float())
        for _, owner, units in rounds:  # each owner, in rank order
            for u in units:
                cols = slice(u * UNIT, (u + 1) * UNIT)
                acc = parts[0][:, cols]
                for part in parts[1:]:
                    acc = acc + part[:, cols]
                y[rows, cols] = xp[rows, cols].float() + _round(
                    acc + b2[cols].float(), dt)
    return y[:r].to(dt), walked, rounds


def _ff_inputs(r, c, dtype, seed):
    """geglu_ff's arguments at R = r, C = c, F = 4c: xm2 [R, C], weights
    [in, out] fan-in scaled, f32 norms near 1 and biases."""
    rng = np.random.default_rng(seed)

    def rn(*shape, scale=1.0, loc=0.0):
        return torch.from_numpy(
            (loc + scale * rng.standard_normal(shape)).astype(np.float32))

    f = 4 * c
    return (rn(r, c).to(dtype), rn(c, scale=0.1, loc=1.0), rn(c, scale=0.1),
            rn(c, f, scale=c ** -0.5).to(dtype),
            rn(c, f, scale=c ** -0.5).to(dtype), rn(f, scale=0.1),
            rn(f, scale=0.1), rn(f, c, scale=f ** -0.5).to(dtype),
            rn(c, scale=0.1))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("r,c", [(80, 64), (64, 96), (130, 96)])
def test_ff_walk_matches_plain(r, c, dtype):
    """The FF launch's walk at R = 80 and 130 (a ragged last row block)
    and 64, C = 64 and 96 (a 32-column unit past the last 64), against
    geglu_ff's plain version; every f tile in exactly one rank, in order,
    and every unit of y summed by its owner u mod n once."""
    ff = _ff_inputs(r, c, dtype, seed=r + c)
    plan = bk.ff_plan(c, 4 * c)
    got, walked, rounds = ff_walk(*ff, plan)
    want = bk.geglu_ff_reference(*ff)
    if dtype == torch.float32:
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                                   atol=1e-4)
    else:
        rel = ((got.float() - want.float()).abs().max()
               / want.float().abs().max()).item()
        assert rel <= 2e-2, rel
    for by in range(-(-r // 64)):
        tiles = [t for b_, _, ts in walked if b_ == by for t in ts]
        assert tiles == list(range(4 * c // 64))
    units = sorted(u for _, o, us in rounds for u in us)
    assert units == list(range(c // UNIT))
    assert all(u % plan.ranks == o for _, o, us in rounds for u in us)


def test_ff_rank_order_sum_is_the_only_change():
    """In f32 the split of F over the ranks changes only the order of the
    sums: 1, 2, 3 and 6 ranks agree to f32 rounding, and a walk repeated
    is bit-equal."""
    ff = _ff_inputs(80, 96, torch.float32, seed=3)
    outs = [ff_walk(*ff, bk.ff_plan(96, 384, ranks))[0]
            for ranks in (1, 2, 3, 6)]
    for o in outs[1:]:
        np.testing.assert_allclose(o.numpy(), outs[0].numpy(), rtol=1e-5,
                                   atol=1e-5)
    assert torch.equal(ff_walk(*ff, bk.ff_plan(96, 384))[0],
                       ff_walk(*ff, bk.ff_plan(96, 384))[0])


def test_block_with_the_ff_walk_matches_jax(monkeypatch):
    """fused_transformer_block(split_k3=False) with post_ff run as the card
    runs it (post_cross, then the FF launch's walk) against JAX's block
    under RDM_TPU_SPLIT_K3=0 in interpret mode (its `_post_ff_kernel`),
    in f32 at C = 96, within 1e-3 x max|ref|."""
    heads = SHAPES[1][0]
    _, params, _, w, x, ctx = _setup(*SHAPES[1], seed=9)
    want = _jax_single_kernel(monkeypatch, heads, params, x, ctx)
    calls = []

    def post_ff(x_, attn, ck, cv, wo, bo, n2s, n2b, wq2, wo2, bo2, *ff,
                heads, head_dim):
        b, s, c = x_.shape
        xm = bk.post_cross_reference(x_, attn, ck, cv, wo, bo, n2s, n2b,
                                     wq2, wo2, bo2, heads=heads,
                                     head_dim=head_dim)
        plan = bk.ff_plan(c, ff[2].shape[1])
        calls.append(plan)
        return ff_walk(xm.reshape(b * s, c), *ff, plan)[0].reshape(b, s, c)

    monkeypatch.setattr(bk, "post_ff", post_ff)
    with torch.no_grad():
        got = bk.fused_transformer_block(
            torch.from_numpy(x), torch.from_numpy(ctx), w, heads=heads,
            head_dim=HD, split_k3=False)
    assert calls and calls[0].ranks == 2
    _close(got, want)


# clusters of 1 .. 16 FF CTAs an H100 SXM (132 SMs) keeps resident at once,
# as `bk.ff_capacity` read it there (cudaOccupancyMaxActiveClusters)
H100_CAPACITY = (132, 66, 39, 30, 22, 17, 15, 15, 9, 7, 7, 7, 7, 7, 7, 7)


def test_ff_plan_at_the_unet_sites():
    """The FF launch's plan at the ImageNet U-Net's sites (F = 4C, 8
    images): with no capacity the fewest ranks that leave 4 stages (2, 4,
    12); with an H100's cluster capacity the fewest waves of clusters
    times a CTA's K-steps (2, 6, 16 ranks: 2 waves of 256, 192 and 128
    CTAs, where 4 and 12 ranks ran 2 waves of a few clusters), a ring of
    4 stages (2 a warpgroup); every CTA
    within a CTA's shared memory; at most three rounds of the K split's
    sum."""
    for (c, s, _), fewest, ranks, stages in zip(
            ((384, 1024, 12), (576, 256, 18), (960, 64, 30)), (2, 4, 12),
            (2, 6, 16), (4, 4, 4)):
        assert bk.ff_plan(c, 4 * c).ranks == fewest
        p = bk.ff_plan(c, 4 * c, rows=8 * s, capacity=H100_CAPACITY)
        assert (p.ranks, p.stages) == (ranks, stages), (c, p)
        blocks = 8 * s // 64
        assert -(-blocks // H100_CAPACITY[p.ranks - 1]) == 2
        assert p.smem == bk.ff_smem(c, 4 * c, *p.args) <= 232448
        assert p.round_units % p.ranks == 0 and p.round_units % 4 == 0
        assert -(-(c // 32) // p.round_units) <= 3  # rounds of the sum


def test_ff_plan_refuses_what_does_not_fit():
    """Past C = 1,024 the LN3 panel, a four-stage ring (two stages a
    warpgroup) and an f slice of 16 ranks pass a CTA's shared memory;
    past C = 1,536 the LayerNorm prologue's K; C off 32 or F off 64; and
    more ranks than f tiles."""
    assert bk.ff_plan(1024, 4096)[:2] == (16, 4)
    with pytest.raises(ValueError, match="shared memory"):
        bk.ff_plan(1056, 4224)
    with pytest.raises(ValueError, match="LayerNorm"):
        bk.ff_plan(1568, 6272)
    with pytest.raises(ValueError, match="multiples"):
        bk.ff_plan(96, 352)
    with pytest.raises(ValueError, match="ranks"):
        bk.ff_plan(96, 384, 7)
