"""rdm_tpu_torch's CUDA kernels (the SpatialTransformer block kernels, their
int8 variants, the RARM decode kernels, the flash-attention forward and
backward and the kNN pair) against their plain PyTorch versions, on the card, with the grad
guard, the training route through the flash kernels, the fused block's
training path (`fused_transformer_block_ad` at the C = 384 site against
`block_reference` in f32) and a RARM train step at full width.

This file imports no JAX, so it also runs on a GPU machine without JAX:

    python -m pytest --noconftest -q tests/test_torch_port_cuda.py

Every test is marked `cuda` and skips where torch.cuda is unavailable.
Shapes include the ragged cases the main path never gives the kernels (S
not a multiple of the 64-key tile, R not a multiple of the 32-row tile,
C = 96 not a multiple of the 64-column tile, 16 context tokens; for the
block-GEMM core (post_cross, geglu_ff) C = 96 and 960 at R = 80 / 48 / 80 /
80 / 80 rows and at 32 images of 64 rows, T = 1 and 16; for ln_qkv on the
same core C = 96 and 672 at R = 1, 80 and 8192, each of its tiles forced
alone; post_cross, post_ff and packed_attn at T = 17 to 40 and 64-wide
heads; SpatialTransformer through the kernels at T = 20 and 40, head_dim
64 and int8 at C = 672 against its unfused blocks in f32 on the CPU; for
the decode kernels B = 3, C = 192 (3 heads of 64), pos 0 and T - 1, 1 and 16
context rows, also in the int8_weights / int8_kv variants, and
decode_post_ff at C = 768 at B = 1 to 65 and 1, 4 and 20 context rows in
both weight modes, in a CUDA graph and from a new thread; for the int8
kernels R = 80 rows, a half-filled last 128-channel scale group, two
512-row q scale cells and C = 672 at T = 20, post_cross_q's and
geglu_ff_q's s8 launches bit-equal over two calls and a CUDA graph, and
the int8 gate one step past C = 1,536; for post_ff R = 80 rows, 16
context tokens and C = 992 and 1,024 (past the first version's 960: its
FF launch over clusters of 16 CTAs, non-portable); for the kNN N not a multiple of the 64-row chunk,
B = 17 and 40 over two and three 16-query tiles, k = 1 and 128,
duplicate rows in different slices).
Tolerance: max|err| <= 2e-2 x max|ref| in bf16, as chip_smoke.py sets it
(kernel and plain version round to bf16 at different points); the int8
cache commit as chip_smoke.py phase 12 holds it; the kNN as phase 17
holds it (scores within 1e-5, ids equal but where the plain scores of two
neighbouring ranks lie within 2e-6).
"""

import copy
import threading

import pytest
import torch

from rdm_tpu_torch.config import RARMConfig
from rdm_tpu_torch.models import rarm
from rdm_tpu_torch.models.layers import TransformerBlock
from rdm_tpu_torch.ops import block_kernel as bk
from rdm_tpu_torch.ops import decode_kernel as dk
from rdm_tpu_torch.ops import flash_attention as fa
from rdm_tpu_torch.ops import knn_kernel as kk

TOL = 2e-2
HD = 32


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


def _block(heads: int, dc: int, seed: int,
           head_dim: int = HD) -> TransformerBlock:
    """A block with every parameter drawn from a seed (fan-in scaled
    weights, norm scales near 1), on the card in f32."""
    torch.manual_seed(seed)
    blk = TransformerBlock(heads * head_dim, dc, heads, head_dim)
    with torch.no_grad():
        for name, p in blk.named_parameters():
            if p.ndim >= 2:
                p.normal_(0.0, p.shape[1] ** -0.5)
            elif name.endswith("weight"):
                p.normal_(1.0, 0.1)
            else:
                p.normal_(0.0, 0.1)
    return blk.cuda()


def _rel_err(got, want) -> float:
    got, want = got.float(), want.float()
    return ((got - want).abs().max() / want.abs().max()).item()


@pytest.mark.cuda
@pytest.mark.parametrize("heads,s,t", [(12, 64, 4), (18, 32, 4), (3, 40, 3),
                                       (30, 16, 16)])
def test_block_kernels_match_plain(cuda, heads, s, t):
    dc = 48
    blk = _block(heads, dc, seed=heads)
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((2, s, heads * HD), generator=g, device="cuda").bfloat16()
    ctx = torch.randn((2, t, dc), generator=g, device="cuda").bfloat16()
    w = bk.pack_block_weights(blk, torch.bfloat16)
    bk.reset_launch_counts()
    got = bk.fused_transformer_block(x, ctx, w, heads=heads, head_dim=HD)
    torch.cuda.synchronize()
    assert bk.launch_counts() == {
        "ln_qkv": 1, "packed_attn": 1, "post_cross": 1, "geglu_ff": 1,
        "post_ff": 0, "ln_qkv_q": 0, "packed_attn_q8": 0, "post_cross_q": 0,
        "geglu_ff_q": 0}
    with torch.no_grad():
        want = blk(x, ctx)  # the unfused block, plain bf16 PyTorch
    assert torch.isfinite(got).all()
    assert _rel_err(got, want) <= TOL


@pytest.mark.cuda
def test_each_kernel_matches_its_reference(cuda):
    heads, b, s, t = 3, 2, 40, 4
    c = heads * HD
    blk = _block(heads, c, seed=7)
    w = bk.pack_block_weights(blk, torch.bfloat16)
    g = torch.Generator(device="cuda").manual_seed(1)

    def rn(*shape):
        return torch.randn(shape, generator=g, device="cuda").bfloat16()

    x, attn, ck, cv = rn(b, s, c), rn(b, s, c), rn(b, t, c), rn(b, t, c)
    x2 = x.reshape(b * s, c)
    pairs = [
        (bk.ln_qkv(x2, w["n1s"], w["n1b"], w["wqkv"]),
         bk.ln_qkv_reference(x2, w["n1s"], w["n1b"], w["wqkv"])),
        (bk.packed_attn(x, attn, x, heads=heads, head_dim=HD),
         bk.packed_attn_reference(x, attn, x, heads=heads, head_dim=HD)),
    ]
    pc = (x, attn, ck, cv, w["wo"], w["bo"], w["n2s"], w["n2b"], w["wq2"],
          w["wo2"], w["bo2"])
    pairs.append((bk.post_cross(*pc, heads=heads, head_dim=HD),
                  bk.post_cross_reference(*pc, heads=heads, head_dim=HD)))
    ff = (x2, w["n3s"], w["n3b"], w["wa"], w["wg"], w["ba"], w["bg"],
          w["w2"], w["b2"])
    pairs.append((bk.geglu_ff(*ff), bk.geglu_ff_reference(*ff)))
    for got, want in pairs:
        got = torch.cat([a.reshape(-1) for a in got]) \
            if isinstance(got, tuple) else got
        want = torch.cat([a.reshape(-1) for a in want]) \
            if isinstance(want, tuple) else want
        assert _rel_err(got, want) <= TOL


@pytest.mark.cuda
def test_wrappers_raise_instead_of_falling_back(cuda):
    c = 64
    x = torch.randn((32, c), device="cuda")
    n = torch.ones(c, device="cuda")
    w = torch.randn((c, 3 * c), device="cuda")
    with pytest.raises(TypeError, match="bf16"):
        bk.ln_qkv(x, n, n, w)  # f32 activations
    q = torch.randn((1, 16, 128), device="cuda").bfloat16()
    with pytest.raises(ValueError, match="head_dim"):
        bk.packed_attn(q, q, q, heads=8, head_dim=16)
    ctx = torch.randn((1, 0, c), device="cuda").bfloat16()
    xb = torch.randn((1, 16, c), device="cuda").bfloat16()
    wb = torch.randn((c, c), device="cuda").bfloat16()
    with pytest.raises(ValueError, match="context length"):
        bk.post_cross(xb, xb, ctx, ctx, wb, n, n, n, wb, wb, n, heads=2,
                      head_dim=HD)
    with pytest.raises(ValueError, match="expected shape"):
        bk.post_cross(xb, xb, ctx[:, :4], ctx[:, :4].contiguous(), wb,
                      n[:32], n, n, wb, wb, n, heads=2, head_dim=HD)


@pytest.mark.cuda
@pytest.mark.parametrize("heads,b,s,t", [(12, 2, 64, 4), (4, 2, 40, 16),
                                         (30, 1, 64, 4), (32, 1, 64, 4),
                                         (31, 2, 40, 4)])
def test_post_ff_matches_plain(cuda, heads, b, s, t, monkeypatch):
    """post_ff (post_cross's three launches, then its FF launch) against
    its plain version, and the block's route with RDM_TPU_SPLIT_K3=0
    against the split pair's, at C up to 1,024."""
    c = heads * HD
    blk = _block(heads, c, seed=heads + 1)
    w = bk.pack_block_weights(blk, torch.bfloat16)
    g = torch.Generator(device="cuda").manual_seed(2)
    rn = lambda *shape: torch.randn(shape, generator=g,  # noqa: E731
                                    device="cuda").bfloat16()
    x, attn, ck, cv = rn(b, s, c), rn(b, s, c) * 0.5, rn(b, t, c), \
        rn(b, t, c)
    args = (x, attn, ck, cv) + tuple(w[n] for n in (
        "wo", "bo", "n2s", "n2b", "wq2", "wo2", "bo2", "n3s", "n3b", "wa",
        "wg", "ba", "bg", "w2", "b2"))
    bk.reset_launch_counts()
    got = bk.post_ff(*args, heads=heads, head_dim=HD)
    torch.cuda.synchronize()
    assert bk.launch_counts()["post_ff"] == 1
    want = bk.post_ff_reference(*args, heads=heads, head_dim=HD)
    assert torch.isfinite(got).all()
    assert _rel_err(got, want) <= TOL
    ctx = rn(b, t, c)
    monkeypatch.setenv("RDM_TPU_SPLIT_K3", "0")
    bk.reset_launch_counts()
    single = bk.fused_transformer_block(x, ctx, w, heads=heads, head_dim=HD)
    counts = bk.launch_counts()
    assert (counts["post_ff"], counts["post_cross"], counts["geglu_ff"]) == \
        (1, 0, 0)
    split = bk.fused_transformer_block(x, ctx, w, heads=heads, head_dim=HD,
                                       split_k3=True)
    assert _rel_err(single, split) <= TOL


# ------------------------------------------------- the block-GEMM core

def _gemm_inputs(c: int, b: int, s: int, t: int, seed: int):
    """post_cross and geglu_ff arguments at C = c, b images of s rows, t
    context tokens: seeded bf16 weights [in, out], f32 norms and biases."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rn(*shape, scale=1.0, loc=0.0):
        return loc + scale * torch.randn(shape, generator=g, device="cuda")

    w = lambda k, n: rn(k, n, scale=k ** -0.5).bfloat16()  # noqa: E731
    x, attn = rn(b, s, c).bfloat16(), rn(b, s, c).bfloat16()
    ck, cv = rn(b, t, c).bfloat16(), rn(b, t, c).bfloat16()
    norm = lambda: rn(c, scale=0.1, loc=1.0)  # noqa: E731
    bias = lambda n: rn(n, scale=0.1)  # noqa: E731
    pc = (x, attn, ck, cv, w(c, c), bias(c), norm(), bias(c), w(c, c),
          w(c, c), bias(c))
    ff = (norm(), bias(c), w(c, 4 * c), w(c, 4 * c), bias(4 * c),
          bias(4 * c), w(4 * c, c), bias(c))
    return pc, ff


@pytest.mark.cuda
@pytest.mark.parametrize("c,b,s,t", [(96, 2, 40, 1), (96, 3, 16, 16),
                                     (960, 2, 40, 16), (960, 5, 16, 1),
                                     (192, 1, 80, 4), (960, 32, 64, 4)])
def test_block_gemm_kernels_match_plain(cuda, c, b, s, t):
    """post_cross (three launches of the block-GEMM core) and geglu_ff
    (two) against their plain versions: R = b s not a multiple of the 64-
    or 128-row tile, tiles spanning images (S = 16, 40), C = 96 (a ragged
    column tile) and 960, T = 1 and 16, and the C = 960 site at 32 images;
    one count per wrapper call, and two calls equal bit for bit (no
    atomics)."""
    pc, ff = _gemm_inputs(c, b, s, t, seed=c + s + t)
    heads = c // HD
    bk.reset_launch_counts()
    got = bk.post_cross(*pc, heads=heads, head_dim=HD)
    xm2 = got.reshape(b * s, c)
    y = bk.geglu_ff(xm2, *ff)
    torch.cuda.synchronize()
    counts = bk.launch_counts()
    assert (counts["post_cross"], counts["geglu_ff"]) == (1, 1)
    assert sum(counts.values()) == 2
    want = bk.post_cross_reference(*pc, heads=heads, head_dim=HD)
    assert torch.isfinite(got).all() and torch.isfinite(y).all()
    assert _rel_err(got, want) <= TOL
    assert _rel_err(y, bk.geglu_ff_reference(xm2, *ff)) <= TOL
    assert torch.equal(bk.post_cross(*pc, heads=heads, head_dim=HD), got)
    assert torch.equal(bk.geglu_ff(xm2, *ff), y)


@pytest.mark.cuda
@pytest.mark.parametrize("heads,b,s,t", [(12, 2, 64, 4), (4, 2, 40, 16),
                                         (30, 1, 64, 4), (31, 2, 64, 4),
                                         (32, 3, 40, 16)])
def test_post_ff_matches_split_pair(cuda, heads, b, s, t):
    """post_ff against geglu_ff(post_cross) on the same inputs, at C up to
    1,024 (992 and 1,024 past the first version's limit): its xm is
    post_cross's to the bit (the same launcher and plans), y within TOL
    (the FF launch sums f's slices across its cluster in rank order), and
    two calls bit-equal (no atomics)."""
    c = heads * HD
    pc, ff = _gemm_inputs(c, b, s, t, seed=heads)
    single, xm = bk._post_ff(*pc, *ff, heads=heads, head_dim=HD)
    xm_pair = bk.post_cross(*pc, heads=heads, head_dim=HD)
    pair = bk.geglu_ff(xm_pair.reshape(b * s, c), *ff)
    again = bk.post_ff(*pc, *ff, heads=heads, head_dim=HD)
    torch.cuda.synchronize()
    assert torch.equal(xm, xm_pair)
    assert torch.isfinite(single).all()
    assert _rel_err(single, pair.reshape(b, s, c)) <= TOL
    assert torch.equal(single, again)


@pytest.mark.cuda
def test_block_gemm_wrappers_refuse(cuda):
    """geglu_ff's checks on the card (post_cross's context length and
    shapes: test_wrappers_raise_instead_of_falling_back), and no launch
    counted for a refused call."""
    pc, ff = _gemm_inputs(64, 1, 16, 4, seed=0)
    x2 = pc[0].reshape(16, 64)
    bk.reset_launch_counts()
    with pytest.raises(TypeError, match="bf16"):
        bk.geglu_ff(x2.float(), *ff)
    with pytest.raises(ValueError, match="contiguous"):
        bk.geglu_ff(x2.t().contiguous().t(), *ff)
    with pytest.raises(ValueError, match="expected shape"):
        bk.geglu_ff(x2, ff[0][:32], *ff[1:])
    with pytest.raises(ValueError, match="head_dim"):
        bk.post_cross(*pc, heads=4, head_dim=16)
    assert sum(bk.launch_counts().values()) == 0


def _ln_qkv_inputs(c: int, r: int, seed: int):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((r, c), generator=g, device="cuda").bfloat16()
    n1s = 1.0 + 0.1 * torch.randn(c, generator=g, device="cuda")
    n1b = 0.1 * torch.randn(c, generator=g, device="cuda")
    w = (torch.randn((c, 3 * c), generator=g, device="cuda")
         * c ** -0.5).bfloat16()
    return x, n1s, n1b, w


def _hold_ln_qkv(got, want, r: int, c: int) -> None:
    for a, b in zip(got, want):
        assert a.shape == (r, c) and a.is_contiguous()
        assert torch.isfinite(a).all()
        assert _rel_err(a, b) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("c,r", [(96, 1), (96, 80), (96, 8192), (672, 1),
                                 (672, 80), (672, 8192), (384, 8192),
                                 (960, 512)])
def test_ln_qkv_matches_plain(cuda, c, r):
    """ln_qkv (one launch of the block-GEMM core's kQkv) against its plain
    version: R = 1 and 80 (ragged row tiles) and 8192; C = 96 (a ragged
    column tile), 672 (the FFHQ site: K % 64 = 32, tiles straddling q | k
    and k | v) and the U-Net sites 384 and 960; one count a call, and two
    calls equal bit for bit."""
    args = _ln_qkv_inputs(c, r, seed=c + r)
    bk.reset_launch_counts()
    got = bk.ln_qkv(*args)
    torch.cuda.synchronize()
    assert bk.launch_counts()["ln_qkv"] == 1
    assert sum(bk.launch_counts().values()) == 1
    _hold_ln_qkv(got, bk.ln_qkv_reference(*args), r, c)
    again = bk.ln_qkv(*args)
    assert all(torch.equal(a, b) for a, b in zip(again, got))


@pytest.mark.cuda
@pytest.mark.parametrize("tile", bk.GEMM_TILES["qkv"])
@pytest.mark.parametrize("c,r", [(96, 80), (672, 200), (960, 512)])
def test_ln_qkv_every_tile(cuda, tile, c, r):
    """Each tile the kQkv launch is built for, forced alone, against the
    plain version (a tile that does not fit C is refused)."""
    args = _ln_qkv_inputs(c, r, seed=r)
    tiles = bk.GEMM_TILES["qkv"]
    try:
        bk.GEMM_TILES["qkv"] = (tile,)
        bk.gemm_plan.cache_clear()
        bk.kernel_refusal.cache_clear()
        if bk.kernel_refusal("ln_qkv", c) is not None:
            with pytest.raises(ValueError, match="shared memory"):
                bk.ln_qkv(*args)
            return
        got = bk.ln_qkv(*args)
        torch.cuda.synchronize()
    finally:
        bk.GEMM_TILES["qkv"] = tiles
        bk.gemm_plan.cache_clear()
        bk.kernel_refusal.cache_clear()
    _hold_ln_qkv(got, bk.ln_qkv_reference(*args), r, c)


@pytest.mark.cuda
@pytest.mark.parametrize("c,hd,b,s,t", [
    (96, 32, 2, 40, 20), (384, 32, 1, 64, 33), (256, 64, 2, 40, 4),
    (640, 64, 1, 80, 40), (672, 32, 2, 40, 17)])
def test_cross_kernels_take_long_contexts_and_wide_heads(cuda, c, hd, b, s,
                                                         t):
    """post_cross (the core's kCross / kCross64 epilogue), post_ff and
    packed_attn against their plain versions past one 16-token context
    chunk (T = 17, 20, 33, 40) and at 64-wide heads; C = 672 gives post_ff
    a half-filled last 64-column tile. One count per call."""
    pc, ff = _gemm_inputs(c, b, s, t, seed=c + t)
    heads = c // hd
    bk.reset_launch_counts()
    got = bk.post_cross(*pc, heads=heads, head_dim=hd)
    single = bk.post_ff(*pc, *ff, heads=heads, head_dim=hd)
    o = bk.packed_attn(pc[0], pc[1], pc[0], heads=heads, head_dim=hd)
    torch.cuda.synchronize()
    counts = bk.launch_counts()
    assert (counts["post_cross"], counts["post_ff"],
            counts["packed_attn"]) == (1, 1, 1)
    for out, want in (
            (got, bk.post_cross_reference(*pc, heads=heads, head_dim=hd)),
            (single, bk.post_ff_reference(*pc, *ff, heads=heads,
                                          head_dim=hd)),
            (o, bk.packed_attn_reference(pc[0], pc[1], pc[0], heads=heads,
                                         head_dim=hd))):
        assert torch.isfinite(out).all()
        assert _rel_err(out, want) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("c,head_dim,t,int8", [
    (384, 32, 20, False), (256, 64, 4, False), (672, 32, 4, True),
    (384, 32, 4, False), (256, 64, 40, True), (672, 32, 20, False)])
def test_spatial_transformer_gate_on_card(cuda, c, head_dim, t, int8,
                                          monkeypatch):
    """A SpatialTransformer in eval mode on the card runs its block through
    the kernels wherever the JAX package fuses it (heads dividing 128):
    past one 16-token context chunk (T = 20, 40), at 64-wide heads and in
    int8 at C = 672 (K % 64 = 32), one launch of each kernel of its mode;
    its output is finite and within the smoke's forward tolerance
    (relative L2: FORWARD_TOL 3e-2, INT8_FORWARD_TOL 8e-2 in int8) of the
    same module's unfused blocks in f32 on the CPU. Under
    RDM_TPU_FUSED_BLOCK=0 it launches none."""
    from rdm_tpu_torch.models.layers import SpatialTransformer
    from rdm_tpu_torch.ops import quant

    heads = c // head_dim
    ref = _seed_params(SpatialTransformer(c, 48, heads, head_dim), seed=c)
    g = torch.Generator().manual_seed(t)
    x = torch.randn((2, c, 16, 16), generator=g)
    ctx = torch.randn((2, t, 48), generator=g)
    with torch.no_grad():
        want = ref.train()(x, ctx)  # the unfused blocks, f32, CPU
    st = copy.deepcopy(ref).cuda().bfloat16().eval()
    xb, cb = x.cuda().bfloat16(), ctx.cuda().bfloat16()
    blk = st.transformer_blocks[0]
    if int8:
        with quant.calibrate(), torch.no_grad():
            st(xb, cb)
        rec = quant.collect_absmax(blk)
        blk.set_qabsmax(torch.stack([rec[m][k] for m, k in (
            ("attn1", "act_absmax"), ("attn1", "out_absmax"),
            ("attn2", "act_absmax"), ("attn2", "out_absmax"),
            ("ff", "act_absmax"), ("ff", "hidden_absmax"))]))
    bk.reset_launch_counts()
    with torch.no_grad():
        got = st(xb, cb)
    torch.cuda.synchronize()
    names = (("ln_qkv_q", "packed_attn", "post_cross_q", "geglu_ff_q")
             if int8 else ("ln_qkv", "packed_attn", "post_cross",
                           "geglu_ff"))
    assert {n: k for n, k in bk.launch_counts().items() if k} == \
        dict.fromkeys(names, 1)
    assert torch.isfinite(got).all()
    rel = ((got.float().cpu() - want).norm() / want.norm()).item()
    assert rel <= (8e-2 if int8 else 3e-2), rel
    monkeypatch.setenv("RDM_TPU_FUSED_BLOCK", "0")
    bk.reset_launch_counts()
    with torch.no_grad():
        st(xb, cb)
    assert sum(bk.launch_counts().values()) == 0


# ---------------------------------------------------------- int8 kernels

def _int8_block(heads: int, b: int, s: int, t: int, seed: int,
                head_dim: int = HD):
    """A seeded block on the card with its int8 weights and the absmax of a
    calibration forward of the unfused bf16 block on (x, ctx)."""
    from rdm_tpu_torch.ops import quant

    blk = _block(heads, 48, seed=seed, head_dim=head_dim)
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((b, s, heads * head_dim), generator=g,
                    device="cuda").bfloat16()
    ctx = torch.randn((b, t, 48), generator=g, device="cuda").bfloat16()
    blk = blk.bfloat16()
    with quant.calibrate(), torch.no_grad():
        blk(x, ctx)
    rec = quant.collect_absmax(blk)
    absmax = torch.stack([rec[m][k] for m, k in (
        ("attn1", "act_absmax"), ("attn1", "out_absmax"),
        ("attn2", "act_absmax"), ("attn2", "out_absmax"),
        ("ff", "act_absmax"), ("ff", "hidden_absmax"))])
    for p in blk.parameters():  # norms and biases f32, as the pipeline
        if p.ndim == 1:
            p.data = p.data.float()
    w = bk.quantize_block_weights(bk.pack_block_weights(blk, torch.bfloat16))
    a = {k: bk.act_scale(v) for k, v in zip(bk.QSCALE_NAMES, absmax.tolist())}
    return blk, w, a, absmax, x, ctx


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["ln_qkv_q", "packed_attn_q8",
                                    "post_cross_q", "geglu_ff_q"])
@pytest.mark.parametrize("heads,b,s,t,hd", [
    (4, 2, 40, 4, 32), (6, 3, 64, 16, 32), (12, 2, 1024, 4, 32),
    (21, 2, 40, 20, 32), (5, 1, 1000, 4, 32), (2, 2, 40, 4, 64),
    (3, 3, 100, 16, 64), (6, 2, 1024, 4, 64), (15, 1, 1000, 4, 64)])
def test_int8_kernels_match_plain(cuda, kernel, heads, b, s, t, hd):
    """Each int8 kernel against its plain version on the same int8 weights
    and scales: ragged rows (R = 80), a half-filled last 128-channel group
    (6 heads of 32, 3 of 64), 16 and 20 context tokens, two 512-row q
    scale cells (S = 1024), 125 cells of 8 rows (S = 1000: a 64-row tile
    over eight of them, a ragged last key tile), S = 100, C = 672 (21
    heads: K % 64 = 32, the FFHQ RDM's site); heads of 32 and 64."""
    blk, w, a, _, x, ctx = _int8_block(heads, b, s, t, seed=heads + s,
                                       head_dim=hd)
    c = heads * hd
    g = torch.Generator(device="cuda").manual_seed(s)
    rn = lambda *shape: torch.randn(shape, generator=g,  # noqa: E731
                                    device="cuda").bfloat16()
    attn, ck, cv = rn(b, s, c) * 0.5, rn(b, t, c), rn(b, t, c)
    x2 = x.reshape(b * s, c)
    if kernel == "ln_qkv_q":
        args = (x2, w["n1s"], w["n1b"], w["wqkv_q"], w["wqkv_s"], a["a_qkv"])
        kw = {}
    elif kernel == "packed_attn_q8":
        args, kw = (x, attn, rn(b, s, c)), dict(heads=heads, head_dim=hd)
    elif kernel == "post_cross_q":
        args = (x, attn, ck, cv, w["wo_q"], w["wo_s"], w["bo"], w["n2s"],
                w["n2b"], w["wq2_q"], w["wq2_s"], w["wo2_q"], w["wo2_s"],
                w["bo2"], a["o_attn1"], a["a_attn2"], a["o_attn2"])
        kw = dict(heads=heads, head_dim=hd)
    else:
        args = (x2, w["n3s"], w["n3b"], w["wa_q"], w["wa_s"], w["wg_q"],
                w["wg_s"], w["ba"], w["bg"], w["w2_q"], w["w2_s"], w["b2"],
                a["a_ff"], a["h_ff"])
        kw = {}
    fn = getattr(bk, kernel)
    bk.reset_launch_counts()
    got = fn(*args, **kw)
    torch.cuda.synchronize()
    assert bk.launch_counts()[kernel] == 1
    want = getattr(bk, kernel + "_reference")(*args, **kw)
    got = torch.cat([o.reshape(-1) for o in got]) \
        if isinstance(got, tuple) else got
    want = torch.cat([o.reshape(-1) for o in want]) \
        if isinstance(want, tuple) else want
    assert torch.isfinite(got).all()
    assert _rel_err(got, want) <= TOL


@pytest.mark.cuda
def test_int8_block_routes_through_int8_kernels(cuda, monkeypatch):
    blk, _, _, absmax, x, ctx = _int8_block(6, 2, 64, 4, seed=3)
    blk.set_qabsmax(absmax)
    blk.pack(torch.bfloat16)
    for attn8 in ("0", "1"):
        monkeypatch.setenv("RDM_TPU_INT8_ATTN", attn8)
        bk.reset_launch_counts()
        with torch.no_grad():
            got = blk.forward_fused(x, ctx)
        torch.cuda.synchronize()
        counts = bk.launch_counts()
        assert counts == {"ln_qkv": 0, "packed_attn": int(attn8 == "0"),
                          "post_cross": 0, "geglu_ff": 0, "post_ff": 0,
                          "ln_qkv_q": 1,
                          "packed_attn_q8": int(attn8 == "1"),
                          "post_cross_q": 1, "geglu_ff_q": 1}
        w = blk.fused_weights(x)
        with torch.no_grad():
            want = bk.fused_transformer_block(  # plain versions, bf16
                x.cpu(), ctx.cpu(),
                {k: v.cpu() if torch.is_tensor(v) else v
                 for k, v in w.items()}, heads=6, head_dim=HD,
                qscales=blk.qscales())
        assert torch.isfinite(got).all()
        err = _rel_err(got.cpu(), want)
        assert err <= TOL, (attn8, err)


def _int8_pair_args(heads: int, b: int, s: int, t: int, seed: int):
    """post_cross_q's and geglu_ff_q's arguments on one seeded int8 block."""
    _, w, a, _, x, _ = _int8_block(heads, b, s, t, seed=seed)
    c = heads * HD
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    rn = lambda *shape: torch.randn(shape, generator=g,  # noqa: E731
                                    device="cuda").bfloat16()
    pc = (x, rn(b, s, c) * 0.5, rn(b, t, c), rn(b, t, c), w["wo_q"],
          w["wo_s"], w["bo"], w["n2s"], w["n2b"], w["wq2_q"], w["wq2_s"],
          w["wo2_q"], w["wo2_s"], w["bo2"], a["o_attn1"], a["a_attn2"],
          a["o_attn2"])
    ff = (x.reshape(b * s, c), w["n3s"], w["n3b"], w["wa_q"], w["wa_s"],
          w["wg_q"], w["wg_s"], w["ba"], w["bg"], w["w2_q"], w["w2_s"],
          w["b2"], a["a_ff"], a["h_ff"])
    return pc, ff


@pytest.mark.cuda
@pytest.mark.parametrize("heads,b,s,t", [(12, 8, 256, 4), (30, 8, 64, 4),
                                         (21, 2, 40, 20)])
def test_int8_s8_launches_bit_equal_in_graphs(cuda, heads, b, s, t):
    """post_cross_q's three s8 launches and geglu_ff_q's two (the U-Net's
    C = 384 tiles at 8 images of 256 rows, the C = 960 site, C = 672 at
    T = 20): a second call, and a CUDA graph of a call replayed, equal
    the first call bit for bit, the hidden codes too (int32 sums, no
    atomics)."""
    pc, ff = _int8_pair_args(heads, b, s, t, seed=heads + t)
    kw = dict(heads=heads, head_dim=HD)
    hidden = torch.empty((b * s, 4 * heads * HD), dtype=torch.int8,
                         device="cuda")
    xm = bk.post_cross_q(*pc, **kw)
    y = bk.geglu_ff_q(*ff, hidden=hidden)
    codes = hidden.clone()
    assert torch.equal(bk.post_cross_q(*pc, **kw), xm)
    assert torch.equal(bk.geglu_ff_q(*ff, hidden=hidden), y)
    assert torch.equal(hidden, codes)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture
        bk.post_cross_q(*pc, **kw)
        bk.geglu_ff_q(*ff, hidden=hidden)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        g_xm = bk.post_cross_q(*pc, **kw)
        g_y = bk.geglu_ff_q(*ff, hidden=hidden)
    hidden.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(g_xm, xm) and torch.equal(g_y, y)
    assert torch.equal(hidden, codes)


@pytest.mark.cuda
@pytest.mark.parametrize("attn8", ["0", "1"])
@pytest.mark.parametrize("head_dim", [32, 64])
def test_int8_gate_refuses_before_the_first_launch(cuda, head_dim, attn8,
                                                   monkeypatch):
    """An int8 block one step past the gate's limit (C = 1536 + head_dim:
    the s8 code prologue takes K <= 1536) raises on the card before its
    first launch, every count 0; at C = 1536, the widest it takes, it runs
    through the four int8 kernels (the int8 attention core under
    RDM_TPU_INT8_ATTN=1) and agrees with its plain versions. A block of
    16-wide heads (which the JAX package fuses: 16 divides 128) raises on
    its head width before the first launch."""
    monkeypatch.setenv("RDM_TPU_INT8_ATTN", attn8)
    core = "packed_attn_q8" if attn8 == "1" else "packed_attn"
    qscales = {k: 4.0 for k in bk.QSCALE_NAMES}
    blk = TransformerBlock(256, 48, 16, 16)
    w = bk.quantize_block_weights(bk.pack_block_weights(blk, torch.bfloat16))
    bk.reset_launch_counts()
    with pytest.raises(ValueError, match="head_dim"):
        bk.fused_transformer_block(
            torch.randn((1, 64, 256), device="cuda").bfloat16(),
            torch.randn((1, 4, 48), device="cuda").bfloat16(),
            {k: v.cuda() for k, v in w.items()}, heads=16, head_dim=16,
            qscales=qscales)
    assert sum(bk.launch_counts().values()) == 0
    for c, runs in ((1536 + head_dim, False), (1536, True)):
        heads = c // head_dim
        torch.manual_seed(c)
        blk = TransformerBlock(c, 48, heads, head_dim)
        w = bk.quantize_block_weights(bk.pack_block_weights(blk,
                                                            torch.bfloat16))
        w = {k: v.cuda() for k, v in w.items()}
        x = torch.randn((1, 64, c), device="cuda").bfloat16()
        ctx = torch.randn((1, 4, 48), device="cuda").bfloat16()
        bk.reset_launch_counts()
        if not runs:
            with pytest.raises(ValueError, match="code prologue"):
                bk.fused_transformer_block(x, ctx, w, heads=heads,
                                           head_dim=head_dim,
                                           qscales=qscales)
            assert sum(bk.launch_counts().values()) == 0
            continue
        with torch.no_grad():
            got = bk.fused_transformer_block(x, ctx, w, heads=heads,
                                             head_dim=head_dim,
                                             qscales=qscales)
            torch.cuda.synchronize()
            counts = bk.launch_counts()
            want = bk.fused_transformer_block(
                x.cpu(), ctx.cpu(), {k: v.cpu() for k, v in w.items()},
                heads=heads, head_dim=head_dim, qscales=qscales)
        assert (counts["ln_qkv_q"], counts[core], counts["post_cross_q"],
                counts["geglu_ff_q"]) == (1, 1, 1, 1)
        assert torch.isfinite(got).all()
        assert _rel_err(got.cpu(), want) <= TOL


# ------------------------------------------------------- RARM decode kernels

DHD = 64  # the decode kernels' head width


def _seed_params(module: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Every parameter from a seed: fan-in scaled weights, norm scales near
    1, other 1-D leaves small."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if p.ndim >= 2:
                fan_in = p[0].numel()
                p.copy_(torch.randn(p.shape, generator=g) / fan_in ** 0.5)
            elif name.endswith("weight"):
                p.copy_(1.0 + 0.1 * torch.randn(p.shape, generator=g))
            else:
                p.copy_(0.1 * torch.randn(p.shape, generator=g))
    return module


# decode_attn's cases at the RARM width (12 heads, T = 256): B = 1 to 65
# (65: two 64-row blocks of the projection, no K split), pos 0, 1 and T - 1
RARM_ATTN_CASES = [(1, 12, 256, 0, 4), (16, 12, 256, 1, 4),
                   (17, 12, 256, 255, 4), (32, 12, 256, 255, 4),
                   (64, 12, 256, 200, 4), (65, 12, 256, 255, 4)]


@pytest.mark.cuda
@pytest.mark.parametrize("commit", [True, False])
@pytest.mark.parametrize("b,heads,t,pos,s", [
    (3, 3, 64, 0, 1), (3, 3, 64, 63, 16), (16, 12, 256, 63, 4),
    (32, 12, 256, 200, 4), (40, 3, 32, 17, 4)] + RARM_ATTN_CASES)
def test_decode_kernels_match_plain(cuda, b, heads, t, pos, s, commit):
    """decode_attn (both commits), decode_post_ff and commit_rows against
    their plain versions; with commit, row pos of the caches holds k_new /
    v_new exactly, without it the caches are untouched; every other row
    is untouched either way."""
    c = heads * DHD
    blk = _seed_params(rarm._Block(c, 24, heads, DHD), seed=b + pos)
    w = bk.pack_block_weights(blk.cuda(), torch.bfloat16)
    g = torch.Generator(device="cuda").manual_seed(pos)

    def rn(*shape):
        return torch.randn(shape, generator=g, device="cuda").bfloat16()

    x, kc, vc, ck, cv = rn(b, c), rn(t, b, c), rn(t, b, c), rn(s, b, c), \
        rn(s, b, c)
    hd = dict(heads=heads, head_dim=DHD)
    dk.reset_launch_counts()
    caches = (kc.clone(), vc.clone())
    got = dk.decode_attn(x, pos, *caches, w["n1s"], w["n1b"], w["wqkv"],
                         commit=commit, **hd)
    torch.cuda.synchronize()
    want = dk.decode_attn_reference(x, pos, kc.clone(), vc.clone(),
                                    w["n1s"], w["n1b"], w["wqkv"],
                                    commit=commit, **hd)
    for a, r in zip(got, want):
        assert torch.isfinite(a).all() and _rel_err(a, r) <= TOL
    # row pos holds the new k/v exactly (commit) or its old values, every
    # other row is untouched
    for cache, old, new in zip(caches, (kc, vc), got[1:]):
        assert torch.equal(cache[pos], new if commit else old[pos])
        keep = torch.arange(t, device="cuda") != pos
        assert torch.equal(cache[keep], old[keep])
    ff = (x, got[0], ck, cv, w["wo"], w["bo"], w["n2s"], w["n2b"], w["wq2"],
          w["wo2"], w["bo2"], w["n3s"], w["n3b"], w["wa"], w["wg"], w["ba"],
          w["bg"], w["w2"], w["b2"])
    out = dk.decode_post_ff(*ff, **hd)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    assert _rel_err(out, dk.decode_post_ff_reference(*ff, **hd)) <= TOL
    rows = [rn(1, b, c) for _ in range(4)]
    mine = [rn(t, b, c) for _ in range(4)]
    plain = [m.clone() for m in mine]
    dk.commit_rows(pos, mine, rows)
    dk.commit_rows_reference(pos, plain, rows)
    for m, p in zip(mine, plain):
        assert torch.equal(m, p)
    assert dk.launch_counts() == dict(
        dict.fromkeys(dk.KERNEL_NAMES, 0), decode_attn=1, decode_post_ff=1,
        commit_rows=1)


@pytest.mark.cuda
@pytest.mark.parametrize("b,c,t", [(16, 768, 256), (32, 768, 256),
                                   (3, 192, 64), (1, 64, 8)])
def test_row_commit_per_request(cuda, b, c, t):
    """RowCommit (the step's commit: checks and pointer table once, one
    launch of TMA bulk copies a call) over one row buffer rewritten before
    each call, at pos 0, T - 1 and between, against the plain version bit
    for bit, every other row untouched; one count a call; and in a CUDA
    graph."""
    g = torch.Generator(device="cuda").manual_seed(b + t)

    def rn(*shape):
        return torch.randn(shape, generator=g, device="cuda").bfloat16()

    n = 36 if c == 768 else 4
    mine = [rn(t, b, c) for _ in range(n)]
    plain = [m.clone() for m in mine]
    buf = torch.empty((n, b, c), device="cuda", dtype=torch.bfloat16)
    commit = dk.RowCommit(mine, list(buf))
    dk.reset_launch_counts()
    for pos in (0, t - 1, t // 2):
        buf.copy_(rn(n, b, c))
        commit(pos)
        dk.commit_rows_reference(pos, plain, list(buf))
    torch.cuda.synchronize()
    assert all(torch.equal(m, p) for m, p in zip(mine, plain))
    assert dk.launch_counts()["commit_rows"] == 3
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        commit(1)
    buf.copy_(rn(n, b, c))
    graph.replay()
    dk.commit_rows_reference(1, plain, list(buf))
    torch.cuda.synchronize()
    assert all(torch.equal(m, p) for m, p in zip(mine, plain))


@pytest.mark.cuda
@pytest.mark.parametrize("guidance", [1.0, 2.0])
def test_batched_commit_matches_inplace(cuda, guidance):
    """Deferring every layer's k/v rows to one commit_rows launch per step
    gives the tokens of the in-place commit, and the kernel path agrees
    with the eager sampler on the card."""
    cfg = RARMConfig(vocab_size=40, out_vocab=38, heads=3, head_dim=DHD,
                     depth=2, context_dim=24, seq_len=16, sos_token=39,
                     mask_token=38, code_side=4)
    model = _seed_params(rarm.RARM(cfg), seed=3).cuda().eval()
    ctx = torch.randn((3, 4, 24), generator=torch.Generator(
        device="cuda").manual_seed(4), device="cuda")
    weights = rarm.extract_decode_weights(model, torch.bfloat16)
    toks = {}
    for batched in (False, True):
        dk.reset_launch_counts()
        toks[batched] = rarm.sample_tokens_fused(
            model, ctx, torch.Generator(device="cuda").manual_seed(5),
            top_k=1, guidance_scale=guidance, batched_commit=batched,
            weights=weights)
        counts = dk.launch_counts()
        assert counts["decode_attn"] == counts["decode_post_ff"] == \
            cfg.depth * cfg.seq_len
        assert counts["commit_rows"] == (cfg.seq_len if batched else 0)
    assert torch.equal(toks[False], toks[True])
    assert int(toks[True].min()) >= 0
    assert int(toks[True].max()) < cfg.out_vocab


@pytest.mark.cuda
def test_decode_wrappers_raise_instead_of_falling_back(cuda):
    b, heads = 2, 3
    c = heads * DHD
    n = torch.ones(c, device="cuda")
    x = torch.randn((b, c), device="cuda")
    cache = torch.zeros((8, b, c), device="cuda")
    w = torch.randn((c, 3 * c), device="cuda")
    with pytest.raises(TypeError, match="bf16"):
        dk.decode_attn(x, 1, cache, cache, n, n, w, heads=heads,
                       head_dim=DHD)  # f32 activations
    xb, cb, wb = x.bfloat16(), cache.bfloat16(), w.bfloat16()
    with pytest.raises(ValueError, match="head_dim"):
        dk.decode_attn(xb, 1, cb, cb, n, n, wb, heads=6, head_dim=32)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        dk.decode_attn(xb, 1, cb.cpu(), cb, n, n, wb, heads=heads,
                       head_dim=DHD)
    with pytest.raises(TypeError, match="bf16"):
        dk.commit_rows(1, [cache], [x])
    with pytest.raises(ValueError, match="expected shape"):
        ck = torch.zeros((4, b, c), device="cuda").bfloat16()
        wc = torch.zeros((c, c), device="cuda").bfloat16()
        wf = torch.zeros((c, 4 * c), device="cuda").bfloat16()
        dk.decode_post_ff(xb, xb, ck, ck, wc, n, n, n, wc, wc, n, n, n, wf,
                          wf, n, torch.zeros(4 * c, device="cuda"),
                          wf.t().contiguous(), n[:8], heads=heads,
                          head_dim=DHD)


@pytest.mark.cuda
@pytest.mark.parametrize("commit", [True, False])
@pytest.mark.parametrize("mode", ["w8", "kv8", "w8_kv8"])
@pytest.mark.parametrize("b,heads,t,pos,s", [
    (3, 3, 64, 0, 1), (3, 3, 64, 63, 16), (16, 12, 256, 200, 4)]
    + RARM_ATTN_CASES)
def test_decode_int8_variants_match_plain(cuda, mode, b, heads, t, pos, s,
                                          commit):
    """decode_attn with int8 weights / an int8 cache / both, and
    decode_post_ff with int8 weights, against their plain versions; the
    int8 commit's codes within one step on at most 0.1%, its scales within
    1e-5 relative, the other rows untouched. Without commit, int8 weights
    leave the caches untouched and an int8 cache is refused."""
    c = heads * DHD
    blk = _seed_params(rarm._Block(c, 24, heads, DHD), seed=b + pos + 7)
    w = bk.pack_block_weights(blk.cuda(), torch.bfloat16)
    if "w8" in mode:
        for name in dk.INT8_WEIGHTS:
            w[name], w[name + "_s"] = dk.quantize_weight(w[name])
    g = torch.Generator(device="cuda").manual_seed(pos + 1)

    def rn(*shape):
        return torch.randn(shape, generator=g, device="cuda").bfloat16()

    x, ck, cv = rn(b, c), rn(s, b, c), rn(s, b, c)
    kv = {}
    if "kv8" in mode:
        caches = []
        for _ in range(2):
            codes, sc = dk.quantize_rows(rn(t * b, c).float())
            caches += [codes.reshape(t, b, c), sc.reshape(t, b, 1)]
        kc, ks, vc, vs = caches
        kv = dict(ks_cache=ks, vs_cache=vs)
    else:
        kc, vc = rn(t, b, c), rn(t, b, c)
    mine = {k: v.clone() for k, v in dict(kc=kc, vc=vc, **kv).items()}
    ref = {k: v.clone() for k, v in mine.items()}
    hd = dict(heads=heads, head_dim=DHD, wqkv_s=w.get("wqkv_s"))
    dk.reset_launch_counts()

    def attn(fn, cs):
        return fn(x, pos, cs["kc"], cs["vc"], w["n1s"], w["n1b"], w["wqkv"],
                  ks_cache=cs.get("ks_cache"), vs_cache=cs.get("vs_cache"),
                  commit=commit, **hd)

    if "kv8" in mode and not commit:
        with pytest.raises(ValueError, match="commits in place"):
            attn(dk.decode_attn, mine)
        return
    got = attn(dk.decode_attn, mine)
    torch.cuda.synchronize()
    want = attn(dk.decode_attn_reference, ref)
    for a, r in zip(got, want):
        assert torch.isfinite(a).all() and _rel_err(a, r) <= TOL
    keep = torch.arange(t, device="cuda") != pos
    for k in mine:
        old = dict(kc=kc, vc=vc, **kv)[k]
        assert torch.equal(mine[k][keep], old[keep])
    if "kv8" in mode:
        diff = torch.cat([(mine[k][pos].int() - ref[k][pos].int()).abs()
                          .flatten() for k in ("kc", "vc")])
        assert diff.max() <= 1 and (diff > 0).float().mean() <= 1e-3
        for k in ("ks_cache", "vs_cache"):
            assert ((mine[k][pos] - ref[k][pos]).abs()
                    / ref[k][pos]).max() <= 1e-5
    elif commit:
        assert torch.equal(mine["kc"][pos], got[1])
        assert torch.equal(mine["vc"][pos], got[2])
    else:
        assert torch.equal(mine["kc"][pos], kc[pos])
        assert torch.equal(mine["vc"][pos], vc[pos])
    scales = tuple(w[n + "_s"] for n in dk.POST_FF_WEIGHTS) \
        if "w8" in mode else None
    ff = (x, got[0], ck, cv, w["wo"], w["bo"], w["n2s"], w["n2b"], w["wq2"],
          w["wo2"], w["bo2"], w["n3s"], w["n3b"], w["wa"], w["wg"], w["ba"],
          w["bg"], w["w2"], w["b2"])
    out = dk.decode_post_ff(*ff, heads=heads, head_dim=DHD, scales=scales)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    assert _rel_err(out, dk.decode_post_ff_reference(
        *ff, heads=heads, head_dim=DHD, scales=scales)) <= TOL
    want_counts = dict.fromkeys(dk.KERNEL_NAMES, 0)
    want_counts["decode_attn_" + mode] = 1
    want_counts["decode_post_ff_w8" if "w8" in mode else "decode_post_ff"] = 1
    assert dk.launch_counts() == want_counts


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["bf16", "w8", "kv8", "w8_kv8"])
@pytest.mark.parametrize("b,pos", [(16, 0), (16, 200), (32, 255), (65, 63)])
def test_decode_attn_bit_equal_in_graphs_and_without_pdl(cuda, mode, b, pos):
    """decode_attn's two launches at the RARM width (12 heads of 64, T =
    256), per variant: a second call, the replay of a CUDA graph of one
    call and the same launches with programmatic dependent launch off
    (plain stream launches) give the first call's attn, k_new, v_new and
    cache rows bit for bit (rank-ordered sums, no atomics; PDL moves only
    when a launch starts)."""
    heads, t, c = 12, 256, 768
    blk = _seed_params(rarm._Block(c, 24, heads, DHD), seed=b + pos + 3)
    w = bk.pack_block_weights(blk.cuda(), torch.bfloat16)
    if "w8" in mode:
        w["wqkv"], w["wqkv_s"] = dk.quantize_weight(w["wqkv"])
    g = torch.Generator(device="cuda").manual_seed(pos + 11)
    x = torch.randn((b, c), generator=g, device="cuda").bfloat16()
    if "kv8" in mode:
        caches = []
        for _ in range(2):
            codes, sc = dk.quantize_rows(torch.randn(
                (t * b, c), generator=g, device="cuda"))
            caches += [codes.reshape(t, b, c), sc.reshape(t, b, 1)]
        kc, ks, vc, vs = caches
    else:
        kc, vc = (torch.randn((t, b, c), generator=g,
                              device="cuda").bfloat16() for _ in range(2))
        ks = vs = None

    def call(pdl=True):
        out = dk._decode_attn(x, pos, kc, vc, w["n1s"], w["n1b"], w["wqkv"],
                              heads=heads, head_dim=DHD, commit=True,
                              wqkv_s=w.get("wqkv_s"), ks_cache=ks,
                              vs_cache=vs, pdl=pdl)
        return [a.clone() for a in out] + [
            a[pos].clone() for a in (kc, vc, ks, vs) if a is not None]

    first = call()
    torch.cuda.synchronize()
    assert all(torch.isfinite(a.float()).all() for a in first)
    for a, b_ in zip(call(), first):
        assert torch.equal(a, b_)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = call()
    graph.replay()
    torch.cuda.synchronize()
    for a, b_ in zip(captured, first):
        assert torch.equal(a, b_)
    for a, b_ in zip(call(pdl=False), first):
        assert torch.equal(a, b_)


@pytest.mark.cuda
@pytest.mark.parametrize("b,pos", [(16, 0), (17, 200), (32, 255)])
def test_int8_commit_equals_quantize_rows_of_its_rows(cuda, b, pos):
    """decode_attn's two launches called bare: the attention launch's int8
    commit of row pos is `quantize_rows`'s rule on the projection's own f32
    k and v rows, bit for bit: scale = max(max|row|, 1e-12) / 127 as the
    correctly rounded f32 quotient (as on the CPU; torch on the card
    multiplies by the reciprocal of a Python scalar divisor instead, so the
    expected scale is divided in f64 and rounded once to f32, which gives
    the same f32), codes rint(row / scale) clipped to +-127."""
    from rdm_tpu_torch.ops import _build

    heads, t, c = 12, 256, 768
    blk = _seed_params(rarm._Block(c, 24, heads, DHD), seed=b + pos + 5)
    w = bk.pack_block_weights(blk.cuda(), torch.bfloat16)
    g = torch.Generator(device="cuda").manual_seed(pos + 13)
    x = torch.randn((b, c), generator=g, device="cuda").bfloat16()
    caches = []
    for _ in range(2):
        codes, sc = dk.quantize_rows(torch.randn((t * b, c), generator=g,
                                                 device="cuda"))
        caches += [codes.reshape(t, b, c), sc.reshape(t, b, 1)]
    kc, ks, vc, vs = caches
    q, kn, vn, out = (torch.empty_like(x) for _ in range(4))
    knf, vnf = (torch.empty((b, c), device="cuda") for _ in range(2))
    sms = bk.sm_count(x.device.index)
    proj = bk.gemm_plan("qkv", b, 3 * c, c, sms, split_k=True)
    ap = dk.attn_plan(b, heads, pos, sms)
    lib = _build.load()
    st = torch.cuda.current_stream().cuda_stream
    p = [a.data_ptr() for a in (x, w["n1s"], w["n1b"], w["wqkv"])]
    assert lib.rdm_decode_proj(*p, None, q.data_ptr(), kn.data_ptr(),
                               vn.data_ptr(), knf.data_ptr(), vnf.data_ptr(),
                               b, c, *proj.args, proj.ks, 1, st) == 0
    assert lib.rdm_decode_attn(
        *(a.data_ptr() for a in (q, kn, vn, kc, vc, ks, vs, knf, vnf, out)),
        pos, t, b, c, heads, DHD ** -0.5 * 1.4426950408889634, ap.group,
        ap.splits, ap.rows, 1, st) == 0
    torch.cuda.synchronize()
    for cache, scales, f in ((kc, ks, knf), (vc, vs, vnf)):
        sc = (f.abs().amax(dim=-1, keepdim=True).clamp_min(1e-12).double()
              / 127.0).float()
        codes = torch.clamp(torch.round(f / sc), -127, 127).to(torch.int8)
        assert torch.equal(scales[pos], sc)
        assert torch.equal(cache[pos], codes)


@pytest.mark.cuda
@pytest.mark.parametrize("opts", [dict(int8_weights=True),
                                  dict(int8_kv=True),
                                  dict(int8_weights=True, int8_kv=True),
                                  dict(approx_top_k=True)])
def test_serving_modes_sample_on_card(cuda, opts):
    """A tiny RARM samples through each mode's kernels: every step's launch
    in the mode's variants, tokens in range."""
    cfg = RARMConfig(vocab_size=40, out_vocab=38, heads=3, head_dim=DHD,
                     depth=2, context_dim=24, seq_len=16, sos_token=39,
                     mask_token=38, code_side=4)
    model = _seed_params(rarm.RARM(cfg), seed=5).cuda().eval()
    ctx = torch.randn((3, 4, 24), generator=torch.Generator(
        device="cuda").manual_seed(6), device="cuda")
    q8, kv8 = opts.get("int8_weights", False), opts.get("int8_kv", False)
    weights = rarm.extract_decode_weights(model, torch.bfloat16,
                                          int8_weights=q8)
    dk.reset_launch_counts()
    toks = rarm.sample_tokens_fused(
        model, ctx, torch.Generator(device="cuda").manual_seed(7), top_k=5,
        guidance_scale=2.0, weights=weights, **opts)
    n = cfg.depth * cfg.seq_len
    want = dict.fromkeys(dk.KERNEL_NAMES, 0)
    want["decode_attn" + ("_w8" if q8 else "") + ("_kv8" if kv8 else "")] = n
    want["decode_post_ff_w8" if q8 else "decode_post_ff"] = n
    assert dk.launch_counts() == want
    assert toks.shape == (3, cfg.seq_len)
    assert 0 <= int(toks.min()) and int(toks.max()) < cfg.out_vocab


def _post_ff_inputs(b: int, s: int, w8: bool, seed: int):
    """decode_post_ff's arguments at the RARM's width (C = 768, 12 heads of
    64, F = 3072), seeded on the card, and the int8 column scales (w8) or
    None."""
    c, f = 768, 3072
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rn(*shape, scale=1.0, loc=0.0):
        return loc + scale * torch.randn(shape, generator=g, device="cuda")

    ws = {n: rn(k, m, scale=k ** -0.5).bfloat16() for n, k, m in (
        ("wo", c, c), ("wq2", c, c), ("wo2", c, c), ("wa", c, f),
        ("wg", c, f), ("w2", f, c))}
    scales = None
    if w8:
        q = {n: dk.quantize_weight(ws[n]) for n in ws}
        ws = {n: q[n][0] for n in ws}
        scales = tuple(q[n][1] for n in dk.POST_FF_WEIGHTS)
    vec = {n: rn(m, scale=0.1) for n, m in (
        ("bo", c), ("n2b", c), ("bo2", c), ("n3b", c), ("ba", f), ("bg", f),
        ("b2", c))}
    vec.update(n2s=rn(c, scale=0.1, loc=1.0), n3s=rn(c, scale=0.1, loc=1.0))
    acts = [rn(b, c).bfloat16(), rn(b, c).bfloat16(),
            rn(s, b, c).bfloat16(), rn(s, b, c).bfloat16()]
    return acts + [ws.get(n, vec.get(n)) for n in (
        "wo", "bo", "n2s", "n2b", "wq2", "wo2", "bo2", "n3s", "n3b", "wa",
        "wg", "ba", "bg", "w2", "b2")], scales


@pytest.mark.cuda
@pytest.mark.parametrize("w8", [False, True])
@pytest.mark.parametrize("s", [1, 4, 20])
@pytest.mark.parametrize("b", [1, 3, 16, 32, 33, 65])
def test_decode_post_ff_on_the_core(cuda, b, s, w8):
    """decode_post_ff's five launches of the block-GEMM core at the RARM's
    width, bf16 and int8 weights: B = 1 to 65 (one and two 64-row blocks;
    the K split over clusters up to B = 64, none past it), S = 1, 4 and 20
    context rows, against the plain version; one count a call, in the
    mode's name; two calls equal bit for bit (rank-ordered sums, no
    atomics)."""
    ff, scales = _post_ff_inputs(b, s, w8, seed=100 * b + s + w8)
    kw = dict(heads=12, head_dim=DHD, scales=scales)
    dk.reset_launch_counts()
    got = dk.decode_post_ff(*ff, **kw)
    again = dk.decode_post_ff(*ff, **kw)
    torch.cuda.synchronize()
    want = dict.fromkeys(dk.KERNEL_NAMES, 0)
    want["decode_post_ff_w8" if w8 else "decode_post_ff"] = 2
    assert dk.launch_counts() == want
    assert torch.isfinite(got).all()
    assert _rel_err(got, dk.decode_post_ff_reference(*ff, **kw)) <= TOL
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("w8", [False, True])
def test_decode_post_ff_in_a_graph_and_a_new_thread(cuda, w8):
    """The chain's launches (clusters, programmatic dependent launch)
    captured in a CUDA graph replay bit-equal to eager, and a call from a
    fresh thread (no current context until the launcher binds one) gives
    the main thread's output bit for bit."""
    ff, scales = _post_ff_inputs(16, 4, w8, seed=7)

    def fn():
        return dk.decode_post_ff(*ff, heads=12, head_dim=DHD, scales=scales)

    eager = fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, eager)
    got = []

    def worker():
        try:
            got.append(fn())
            torch.cuda.synchronize()
        except Exception as e:  # re-raised on the test's thread below
            got.append(e)

    t = threading.Thread(target=worker)
    t.start()
    t.join()
    if isinstance(got[0], Exception):
        raise got[0]
    assert torch.equal(got[0], eager)


# ------------------------------------------------- flash attention, training

@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,sk,h,d,causal", [
    (2, 100, 70, 3, 32, False), (2, 100, 130, 3, 32, True),
    (2, 130, 100, 2, 64, True), (1, 64, 64, 2, 96, False),
    (1, 200, 200, 2, 128, True), (2, 256, 256, 4, 32, False),
    (1, 64, 64, 30, 32, False), (2, 1000, 1000, 3, 32, True),
    (2, 100, 300, 2, 64, True), (1, 300, 100, 2, 96, True),
    (2, 200, 1000, 2, 32, False), (2, 1000, 200, 2, 64, True),
    (1, 70, 130, 2, 128, False), (1, 130, 70, 2, 96, True),
    (1, 200, 1000, 2, 128, True)])
def test_flash_kernels_match_plain(cuda, b, sq, sk, h, d, causal):
    """The flash forward and backward kernels against their plain versions
    (ragged tiles, Sq != Sk both ways, every head_dim the kernels are built
    for, the backward's 32-wide query tiles at head_dim 96 and 128; the
    forward core's one-warpgroup CTA at Sq = 64, ragged multi-tile causal
    cases, causal Sk > Sq with skipped key and query tiles, and rows with
    no visible key at Sk < Sq). The backward has no atomics: a second call
    gives bit-equal dq, dk and dv."""
    g = torch.Generator(device="cuda").manual_seed(sq + sk + d)
    q, do = (torch.randn(b, sq, h, d, generator=g, device="cuda").bfloat16()
             for _ in range(2))
    k, v = (torch.randn(b, sk, h, d, generator=g, device="cuda").bfloat16()
            for _ in range(2))
    sc = d ** -0.5
    fa.reset_launch_counts()
    o = fa.flash_fwd(q, k, v, scale=sc, causal=causal)
    grads = fa.flash_bwd(q, k, v, do, scale=sc, causal=causal)
    torch.cuda.synchronize()
    assert fa.launch_counts() == {"flash_fwd": 1, "flash_bwd": 1}
    assert _rel_err(o, fa.flash_attention_forward_reference(
        q, k, v, sc, causal)) <= TOL
    for got, want in zip(grads, fa.flash_attention_backward_reference(
            q, k, v, do, sc, causal)):
        assert torch.isfinite(got).all()
        assert _rel_err(got, want) <= TOL
    again = fa.flash_bwd(q, k, v, do, scale=sc, causal=causal)
    assert all(torch.equal(a, x) for a, x in zip(grads, again))


@pytest.mark.cuda
@pytest.mark.parametrize("s", [256, 64])
@pytest.mark.parametrize("heads", [12, 18, 30])
def test_packed_attn_equals_flash_fwd(cuda, heads, s):
    """packed_attn and flash_fwd run one attention core: on the same memory
    ([B, S, C] read as BSHD [B, S, heads, 32]) their outputs are equal bit
    for bit."""
    g = torch.Generator(device="cuda").manual_seed(heads + s)
    q, k, v = (torch.randn(2, s, heads * HD, generator=g,
                           device="cuda").bfloat16() for _ in range(3))
    bk.reset_launch_counts()
    fa.reset_launch_counts()
    got = bk.packed_attn(q, k, v, heads=heads, head_dim=HD)
    shp = (2, s, heads, HD)
    want = fa.flash_fwd(q.view(shp), k.view(shp), v.view(shp),
                        scale=HD ** -0.5, causal=False)
    torch.cuda.synchronize()
    assert bk.launch_counts()["packed_attn"] == 1
    assert fa.launch_counts()["flash_fwd"] == 1
    assert torch.equal(got, want.view(2, s, heads * HD))


@pytest.mark.cuda
def test_attention_kernels_launch_from_a_new_thread(cuda):
    """A thread whose first CUDA work is one of the TMA kernels (an
    autograd worker, say) has no current context until the launcher binds
    one, and the tensor-map encoder needs it: flash_fwd, flash_bwd and
    packed_attn on a fresh thread give the main thread's outputs bit for
    bit."""
    g = torch.Generator(device="cuda").manual_seed(9)
    q, k, v, do = (torch.randn(2, 128, 2, HD, generator=g,
                               device="cuda").bfloat16() for _ in range(4))
    sc = HD ** -0.5

    def run():
        packed = bk.packed_attn(*(t.view(2, 128, 2 * HD) for t in (q, k, v)),
                                heads=2, head_dim=HD)
        return (fa.flash_fwd(q, k, v, scale=sc, causal=False),
                *fa.flash_bwd(q, k, v, do, scale=sc, causal=False), packed)

    got = []

    def worker():
        try:
            got.append(run())
            torch.cuda.synchronize()
        except Exception as e:  # re-raised on the test's thread below
            got.append(e)

    t = threading.Thread(target=worker)
    t.start()
    t.join()
    if isinstance(got[0], Exception):
        raise got[0]
    for a, b in zip(got[0], run()):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("bwd", ["pallas", "xla"])
def test_flash_attention_gradients_on_card(cuda, bwd, monkeypatch):
    """flash_attention's autograd on CUDA bf16 (the backward kernel, or the
    eager recompute) against autograd through the plain `_xla_reference`."""
    monkeypatch.setenv("RDM_TPU_FLASH_BWD", bwd)
    g = torch.Generator(device="cuda").manual_seed(3)
    q, k, v, do = (torch.randn(2, 256, 3, 32, generator=g,
                               device="cuda").bfloat16() for _ in range(4))
    fa.reset_launch_counts()
    qkv = [t.clone().requires_grad_() for t in (q, k, v)]
    got = torch.autograd.grad(fa.flash_attention(*qkv), qkv, do)
    assert fa.launch_counts() == {"flash_fwd": 1,
                                  "flash_bwd": int(bwd == "pallas")}
    ref = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(fa._xla_reference(*ref, 32 ** -0.5, False),
                               ref, do)
    for a, w in zip(got, want):
        assert _rel_err(a, w) <= TOL


@pytest.mark.cuda
def test_kernels_refuse_inputs_that_require_grad(cuda):
    """The grad guard: a ctypes-bound kernel raises on an input that
    requires grad in grad mode, and runs under no_grad."""
    blk = _block(2, 64, seed=1)
    x = torch.randn((1, 16, 64), device="cuda").bfloat16().requires_grad_()
    ctx = torch.randn((1, 4, 64), device="cuda").bfloat16()
    n = torch.ones(64, device="cuda")
    w = torch.randn((64, 192), device="cuda").bfloat16()
    with pytest.raises(RuntimeError, match="requires grad"):
        bk.ln_qkv(x.reshape(16, 64), n, n, w)
    q = torch.randn((1, 256, 2, 32), device="cuda").bfloat16()
    with pytest.raises(RuntimeError, match="requires grad"):
        fa.flash_fwd(q.requires_grad_(), q, q, scale=1.0, causal=False)
    with pytest.raises(RuntimeError, match="requires grad"):
        blk.eval().forward_fused(x, ctx)  # eval mode, grad on: no silent loss
    with torch.no_grad():
        assert torch.isfinite(blk.forward_fused(x, ctx)).all()


@pytest.mark.cuda
def test_spatial_transformer_trains_through_flash_kernels(cuda):
    """Train mode on the card: the unfused blocks, their S = 256 self-
    attention through the flash forward and backward kernels, no block
    kernel, a gradient for every parameter."""
    from rdm_tpu_torch.models.layers import SpatialTransformer

    torch.manual_seed(0)
    st = SpatialTransformer(64, 16, heads=2, head_dim=32).cuda().train()
    x = torch.randn(2, 64, 16, 16, device="cuda").bfloat16()
    ctx = torch.randn(2, 4, 16, device="cuda").bfloat16()
    fa.reset_launch_counts()
    bk.reset_launch_counts()
    st(x, ctx).float().square().mean().backward()
    assert fa.launch_counts() == {"flash_fwd": 1, "flash_bwd": 1}
    assert not any(bk.launch_counts().values())
    assert all(p.grad is not None and torch.isfinite(p.grad).all()
               for p in st.parameters())


def _rel_l2(got, want) -> float:
    return ((got.float() - want.float()).norm() / want.float().norm()).item()


@pytest.mark.cuda
def test_fused_block_ad_backward_at_the_c384_site(cuda, monkeypatch):
    """fused_transformer_block_ad at the U-Net's C = 384 site (S = 1024, 12
    heads of 32, k = 4 context rows, 2 images), bf16 on the card: one
    launch of each block kernel and no flash launch; its value and the
    gradients of x, ck, cv and every packed weight against autograd through
    `block_reference` in f32 on the card (relative L2 within 2e-2, as
    chip_smoke.py's TRAIN_GRAD_TOL)."""
    monkeypatch.delenv("RDM_TPU_SPLIT_K3", raising=False)
    heads, s, t, c = 12, 1024, 4, 384
    blk = _block(heads, 512, seed=7)
    g = torch.Generator(device="cuda").manual_seed(8)
    x = torch.randn(2, s, c, generator=g, device="cuda")
    ctx = torch.randn(2, t, 512, generator=g, device="cuda")
    dy = torch.randn(2, s, c, generator=g, device="cuda")
    grads = {}
    for dt in (torch.bfloat16, torch.float32):
        w = bk.pack_block_weights(blk, dt, differentiable=True)
        ins = [x.to(dt).requires_grad_(), ctx.to(dt).requires_grad_()]
        ck, cv = bk.context_kv(ins[1], w)
        ck.retain_grad()
        cv.retain_grad()
        blk.zero_grad(set_to_none=True)
        bk.reset_launch_counts()
        fa.reset_launch_counts()
        if dt == torch.bfloat16:
            y = bk.fused_transformer_block_ad(ins[0], ck, cv, w, heads=heads,
                                              head_dim=HD)
            counts = {**bk.launch_counts(), **fa.launch_counts()}
            want = dict.fromkeys(counts, 0)
            want.update(ln_qkv=1, packed_attn=1, post_cross=1, geglu_ff=1)
            assert counts == want
        else:
            y = bk.block_reference(ins[0], ck, cv, w, heads=heads,
                                   head_dim=HD)
        y.backward(dy.to(dt))
        assert not any(fa.launch_counts().values())
        grads[dt] = {"y": y.detach(), "x": ins[0].grad,
                     "context": ins[1].grad, "ck": ck.grad, "cv": cv.grad,
                     **{n: p.grad.clone()
                        for n, p in blk.named_parameters()}}
    for n, want in grads[torch.float32].items():
        got = grads[torch.bfloat16][n]
        assert torch.isfinite(got).all(), n
        assert _rel_l2(got, want) <= 2e-2, n


@pytest.mark.cuda
def test_rarm_train_step_on_card(cuda):
    """One make_rarm_train_step step of a depth-2 RARM at full width (C =
    768, 12 heads of 64, S = 256, the full vocabulary) at batch 2 on the
    card: 2 flash_fwd launches (one a block) and 2 flash_bwd where the
    d = 64 backward is the kernel by default, no other kernel; every
    parameter updated; its gradients against the CUDA f32 plain path
    (RDM_TPU_FLASH=0) within relative L2 2e-2."""
    import dataclasses
    import os

    from rdm_tpu_torch.training.optim import AdamW, lambda_linear_schedule
    from rdm_tpu_torch.training.train_state import (compute_rarm_grads,
                                                    init_train_state,
                                                    make_rarm_train_step)

    cfg = dataclasses.replace(RARMConfig.imagenet_dogs(), depth=2)
    torch.manual_seed(0)
    model = rarm.RARM(cfg, dtype=torch.bfloat16).cuda()
    g = torch.Generator(device="cuda").manual_seed(1)
    z = torch.randint(0, cfg.out_vocab, (2, cfg.seq_len), generator=g,
                      device="cuda")
    nns = torch.randn(2, 4, cfg.context_dim, generator=g, device="cuda")
    per_block = int(fa._use_kernel_bwd(cfg.head_dim, "cuda"))
    grads = {}
    for path in ("bf16", "f32"):
        if path == "f32":
            os.environ["RDM_TPU_FLASH"] = "0"
            model.dtype = torch.float32
        fa.reset_launch_counts()
        bk.reset_launch_counts()
        dk.reset_launch_counts()
        try:
            _, _, gr = compute_rarm_grads(model, z, nns)
        finally:
            os.environ.pop("RDM_TPU_FLASH", None)
            model.dtype = torch.bfloat16
        counts = {**fa.launch_counts(), **bk.launch_counts(),
                  **dk.launch_counts()}
        want = dict.fromkeys(counts, 0)
        if path == "bf16":
            want.update(flash_fwd=2, flash_bwd=2 * per_block)
        assert counts == want, path
        grads[path] = torch.cat([gr[n].float().reshape(-1)
                                 for n, _ in model.named_parameters()])
    assert torch.isfinite(grads["bf16"]).all()
    rel = _rel_l2(grads["bf16"], grads["f32"])
    assert rel <= 2e-2, rel
    tx = AdamW(lambda_linear_schedule(1e-4, warm_up_steps=0), b2=0.95)
    state = init_train_state(model, tx)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    fa.reset_launch_counts()
    state, met = make_rarm_train_step(tx, p_mask_max=0.25)(state, z, nns, 0)
    assert fa.launch_counts() == {"flash_fwd": 2,
                                  "flash_bwd": 2 * per_block}
    assert state.step == 1 and torch.isfinite(met["loss"])
    assert torch.isfinite(met["grad_norm"])
    unmoved = [n for n, p in model.named_parameters()
             if torch.equal(p, before[n])]
    assert not unmoved, unmoved


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,d,k", [(1, 64, 16, 1), (17, 5000, 128, 7),
                                     (3, 777, 512, 128), (40, 20000, 64, 20),
                                     (129, 50000, 512, 20),
                                     (256, 50000, 512, 20),
                                     (300, 50000, 512, 20)])
def test_knn_kernel_matches_plain(cuda, b, n, d, k):
    """B = 129 takes a cluster of four CTAs of 64 queries, the third
    holding one query and the fourth none; 256 one full cluster; 300 two
    query groups."""
    g = torch.Generator(device="cuda").manual_seed(n)
    db = torch.nn.functional.normalize(
        torch.randn(n, d, generator=g, device="cuda"), dim=1).bfloat16()
    dup = [0, n // 3, n // 2, n - 1]  # one row in (up to) four stripes
    if n >= 50000:
        p = kk.device_plan(b, n, d, k, 0)
        assert len({r // p.slice_rows for r in dup}) == 4
    db[dup] = db[n // 2].clone()
    q = torch.nn.functional.normalize(
        torch.randn(b, d, generator=g, device="cuda"), dim=1)
    q[0] = db[n // 2].float()
    kk.reset_launch_counts()
    s, i = kk.knn_topk(db, q, k)
    torch.cuda.synchronize()
    assert kk.launch_counts() == {"knn": 2}
    assert s.shape == i.shape == (b, k) and i.dtype == torch.int64
    assert ((i >= 0) & (i < n)).all()
    # the whole ranking (f64 sums, stable sort), so that a near tie at the
    # last rank shows even at k = 128, the most the plain version takes
    ps, pi = torch.sort((q.bfloat16().double() @ db.double().t()).float(),
                        dim=1, descending=True, stable=True)
    assert torch.equal(kk.knn_search_reference(db, q, k)[1], pi[:, :k])
    assert (s - ps[:, :k]).abs().max().item() <= 1e-5
    near = torch.zeros_like(ps, dtype=torch.bool)
    pair = (ps[:, :-1] - ps[:, 1:]).abs() <= 2e-6
    near[:, :-1] |= pair
    near[:, 1:] |= pair
    assert not ((i != pi[:, :k]) & ~near[:, :k]).any()
    assert i[0, :min(k, 4)].tolist() == dup[:min(k, 4)]


@pytest.mark.cuda
def test_knn_wrapper_raises_instead_of_falling_back(cuda):
    db = torch.randn(300, 64, device="cuda")
    q = torch.randn(2, 64, device="cuda")
    with pytest.raises(ValueError, match="bf16"):
        kk.knn_topk(db, q, 4)  # an f32 table
    with pytest.raises(ValueError, match="queries on"):
        kk.knn_topk(db.bfloat16(), q.cpu(), 4)
    with pytest.raises(ValueError, match="k="):
        kk.knn_topk(db.bfloat16(), q, 301)
    with pytest.raises(ValueError, match="multiple of 16"):
        kk.knn_topk(db[:, :40].contiguous().bfloat16(), q[:, :40], 4)
