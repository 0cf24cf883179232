"""The fused block's shape gate: `block_kernel.block_refusal` and the route
SpatialTransformer takes.

SpatialTransformer runs its blocks fused wherever the JAX package does: in
eval mode with a context, not calibrating, RDM_TPU_FUSED_BLOCK not 0 and
heads whose width divides 128; every other block runs the unfused
TransformerBlock. The kernels take every shape of those blocks that a
released configuration gives them (any number of context tokens, heads 32
or 64 wide, C a multiple of 32 in every mode); what they do not take,
`block_refusal` names, and the block raises with it on the card before
its first launch. The predicate is held against the rules the kernels
refuse by, against every U-Net site of the ImageNet and FFHQ RDMs in
every mode, and the route by a spy on `fused_transformer_block`. A
SpatialTransformer at T = 20 (past one 16-token chunk) is held against
JAX's (f32, weights carried by `from_jax`) at the golden tolerance of
tests/test_torch_convert.py. The kernels at these shapes are held on the
card by tests/test_torch_port_cuda.py and chip_smoke.py phase 3.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rdm_tpu.models.layers import SpatialTransformer as JSpatialTransformer
from rdm_tpu_torch import config as pc
from rdm_tpu_torch.models import layers
from rdm_tpu_torch.ops import block_kernel as bk
from rdm_tpu_torch.utils import from_jax
from test_torch_port_unet import seeded_params

CASES = list(itertools.product((32, 64), (4, 16, 17, 20),
                               (96, 384, 672, 960, 1536), (False, True),
                               (True, False)))


def _reasons(c, t, head_dim, int8, split_k3):
    """The refusals the kernels a block launches make at these shapes
    (the first that applies is the one returned): heads that do not tile
    C, and in bf16 at C = 1536 ln_qkv's plan (its LayerNorm panel). The
    int8 block takes C up to 1536 (the s8 code prologue's K), every case
    here; tests/test_torch_port_block_gemm_q8.py walks its gate over
    C = 32 .. 4096."""
    why = []
    if c % head_dim:
        why.append("heads of")
    if c == 1536 and not int8:
        why.append("shared memory")
    return why


@pytest.mark.parametrize("head_dim,t,c,int8,split_k3", CASES)
def test_block_refusal(head_dim, t, c, int8, split_k3):
    heads = max(1, c // head_dim)
    got = bk.block_refusal(c, t, heads, head_dim, 4 * c, int8=int8,
                           split_k3=split_k3)
    why = _reasons(c, t, head_dim, int8, split_k3)
    if not why:
        assert got is None
    else:
        assert got is not None and any(w in got for w in why), (got, why)


def test_post_ff_gate_mirrors_its_launcher():
    """Under RDM_TPU_SPLIT_K3=0 the gate refuses a block where post_ff's
    launchers would: post_cross's plans and the FF launch's (`ff_plan`:
    the LN3 panel, an f slice and a ring of four stages in a CTA's shared
    memory, over up to 16 ranks), so the block raises before ln_qkv's
    launch: C up to 1,024 runs (every RDM site, and C = 992 and 1,024,
    which the first version's shared memory refused), 1,056 and wider
    refuse."""
    for c in range(32, 2049, 32):
        got = bk.block_refusal(c, 4, c // 32, 32, 4 * c, int8=False,
                               split_k3=False)
        if c <= 1024:
            assert got is None, (c, got)
        else:
            assert got is not None and "shared memory" in got, (c, got)
    assert bk.kernel_refusal("post_ff", 1024, f=4096) is None
    assert bk.kernel_refusal("post_ff", 1056, f=4224).startswith(
        "post_ff: ff_plan: C=1056, F=4224 leaves no room in shared memory")


def _sites(cfg: pc.UNetConfig):
    """C of each level of the U-Net that holds a SpatialTransformer."""
    return sorted({cfg.model_channels * m
                   for level, m in enumerate(cfg.channel_mult)
                   if 2 ** level in cfg.attention_resolutions})


def test_every_rdm_site_runs_fused(monkeypatch):
    """Every site of the ImageNet and FFHQ RDMs, in every mode (bf16 split
    and unsplit, int8 with either attention core), takes the fused
    kernels, at k = 4 neighbours and at 20 and 40; so do 64-wide heads at
    the same sites (int8 with either attention core)."""
    imagenet = _sites(pc.UNetConfig.imagenet_rdm())
    ffhq = _sites(pc.UNetConfig.ffhq_rdm())
    assert imagenet == [384, 576, 960] and ffhq == [448, 672, 896]
    for attn8 in ("0", "1"):
        monkeypatch.setenv("RDM_TPU_INT8_ATTN", attn8)
        for c, t, int8, split in itertools.product(
                imagenet + ffhq, (4, 20, 40), (False, True), (True, False)):
            assert bk.block_refusal(c, t, c // 32, 32, 4 * c, int8=int8,
                                    split_k3=split) is None, (c, t, int8)
    for attn8 in ("0", "1"):
        monkeypatch.setenv("RDM_TPU_INT8_ATTN", attn8)
        for c, int8, split in itertools.product((384, 576, 896, 960),
                                                (False, True), (True, False)):
            assert bk.block_refusal(c, 4, c // 64, 64, 4 * c, int8=int8,
                                    split_k3=split) is None, (c, int8)


def test_wrappers_refuse_with_the_gate_message(monkeypatch):
    """Each kernel's refusal is one function's answer: what block_refusal
    returns is the message of the kernel that refuses."""
    assert bk.kernel_refusal("post_cross", 384, t=20) is None
    assert bk.kernel_refusal("post_cross", 384, t=0) == (
        "post_cross: context length 0 < 1")
    assert bk.block_refusal(384, 0, 12, 32, 1536, int8=False,
                            split_k3=True) == bk.kernel_refusal(
        "post_cross", 384, t=0)
    assert bk.kernel_refusal("ln_qkv_q", 672) is None
    assert bk.kernel_refusal("ln_qkv_q", 680) == (
        "ln_qkv_q: the CUDA kernel takes C as a multiple of 32, got 680")
    assert bk.kernel_refusal("post_ff", 672, f=2720) == (
        "post_ff: the CUDA kernel takes F as a multiple of 64, got 2720")
    assert bk.kernel_refusal("post_cross", 256, head_dim=16) == (
        "post_cross: the CUDA kernel takes head_dim in (32, 64), got 16")
    monkeypatch.setenv("RDM_TPU_INT8_ATTN", "1")
    assert bk.block_refusal(256, 4, 4, 64, 1024, int8=True,
                            split_k3=True) is None
    assert bk.block_refusal(256, 4, 16, 16, 1024, int8=True,
                            split_k3=True) == (
        "packed_attn_q8: the CUDA kernel takes head_dim in (32, 64), got 16")
    for hd in (8, 16, 48, 128):
        assert "head_dim" in bk.kernel_refusal("packed_attn_q8", 256,
                                               head_dim=hd)
    assert "shared memory" in bk.kernel_refusal("ln_qkv", 1568)
    for name in ("ln_qkv", "packed_attn", "post_cross", "geglu_ff",
                 "post_ff", "ln_qkv_q", "post_cross_q", "geglu_ff_q"):
        assert bk.kernel_refusal(name, 960, t=40, head_dim=64,
                                 f=3840) is None


def _spy(monkeypatch):
    calls = []
    real = layers.fused_transformer_block

    def spy(*args, **kw):
        calls.append(args[0].shape)
        return real(*args, **kw)

    monkeypatch.setattr(layers, "fused_transformer_block", spy)
    return calls


def test_spatial_transformer_routes_refused_blocks_unfused(monkeypatch):
    """On the spy: T = 4 and T = 20 run fused (on the CPU the wrappers' plain
    versions, as close to the unfused blocks as the fused-block tests
    hold them); RDM_TPU_FUSED_BLOCK=0 and 48-wide heads (which do not
    divide 128), the blocks the JAX package does not fuse either, run the
    unfused blocks, with their outputs."""
    torch.manual_seed(0)
    st = layers.SpatialTransformer(64, 16, heads=2, head_dim=32).eval()
    wide = layers.SpatialTransformer(96, 16, heads=2, head_dim=48).eval()
    x, x3 = torch.randn(2, 64, 4, 4), torch.randn(2, 96, 4, 4)
    ctx = torch.randn(2, 20, 16)
    calls = _spy(monkeypatch)
    with torch.no_grad():
        st(x, torch.randn(2, 4, 16))
        assert len(calls) == 1
        got = st(x, ctx)
        assert len(calls) == 2
        monkeypatch.setenv("RDM_TPU_FUSED_BLOCK", "0")
        off = st(x, ctx)
        assert len(calls) == 2
        monkeypatch.delenv("RDM_TPU_FUSED_BLOCK")
        got3 = wide(x3, ctx)
        assert len(calls) == 2
        want = st.train()(x, ctx)  # the unfused route in train mode
        want3 = wide.train()(x3, ctx)
    torch.testing.assert_close(off, want, rtol=0, atol=0)
    torch.testing.assert_close(got3, want3, rtol=0, atol=0)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_spatial_transformer_t20_matches_jax():
    """A SpatialTransformer at T = 20 (the port's fused route, its
    wrappers' plain versions on the CPU; JAX off a TPU runs its unfused
    blocks) against JAX's, f32, same weights."""
    heads, hd, b, hw, t, dc = 2, 32, 2, 4, 20, 16
    c = heads * hd
    rng = np.random.default_rng(7)
    x = rng.standard_normal((b, hw, hw, c)).astype(np.float32)
    ctx = rng.standard_normal((b, t, dc)).astype(np.float32)
    jst = JSpatialTransformer(heads=heads, head_dim=hd)
    params = seeded_params(jax.eval_shape(jst.init, jax.random.PRNGKey(0),
                                          jnp.asarray(x), jnp.asarray(ctx)),
                           7)
    want = np.asarray(jax.jit(jst.apply)(params, jnp.asarray(x),
                                         jnp.asarray(ctx)))
    inv = from_jax._Inverse({"st": params["params"]})
    from_jax._spatial_transformer(inv, "st", "st", 1)
    st = layers.SpatialTransformer(c, dc, heads, hd).eval()
    st.load_state_dict({k[len("st."):]: v for k, v in inv.sd.items()})
    with torch.no_grad():
        got = st(torch.from_numpy(x).permute(0, 3, 1, 2),
                 torch.from_numpy(ctx)).permute(0, 2, 3, 1).numpy()
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, atol=1e-3 * scale, rtol=1e-3)
