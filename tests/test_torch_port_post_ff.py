"""The port's single post-attention kernel of the SpatialTransformer block
(`ops/block_kernel.post_ff`, the JAX `_post_ff_kernel` that
`fused_transformer_block` runs under RDM_TPU_SPLIT_K3=0) against the JAX
package, on the CPU.

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
