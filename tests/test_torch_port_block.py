"""rdm_tpu_torch.ops.block_kernel against the JAX block.

Each kernel's plain PyTorch version (`<name>_reference`, what the wrappers
run on CPU tensors) is held against the same stage computed in JAX on the
same numpy-seeded inputs and weights, in f32, at two shapes — one with C =
heads * 32 not a multiple of 128. The chained block is held against the
JAX unfused TransformerBlock and against `fused_transformer_block` run in
Pallas interpret mode (as tests/test_block_kernel.py runs it). Tolerance:
rtol = atol = 1e-4 (f32 on both sides; sums in different orders).

The CUDA kernels themselves are held against these plain versions on the
card by tests/test_torch_port_cuda.py and chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rdm_tpu.models.layers import (FusedTransformerBlock, GEGLUFeedForward,
                                   LayerNormF32, TransformerBlock)
from rdm_tpu.ops.attention import dot_product_attention as j_attention
from rdm_tpu.ops.decode_kernel import _layer_norm as j_layer_norm
from rdm_tpu_torch.models import layers as port_layers
from rdm_tpu_torch.ops import _build
from rdm_tpu_torch.ops import block_kernel as bk
from rdm_tpu_torch.utils import from_jax
from test_torch_port_unet import seeded_params

TOL = 1e-4
# (heads, b, s, context tokens, context width); C = 96 is not a multiple
# of 128, so the JAX kernels pad it to 128 lanes and the port must not care
SHAPES = [(4, 2, 16, 4, 48), (3, 2, 8, 3, 40)]
HD = 32


def _setup(heads, b, s, t, dc, seed=0):
    c = heads * HD
    rng = np.random.default_rng(seed + 100)
    x = rng.standard_normal((b, s, c)).astype(np.float32)
    ctx = rng.standard_normal((b, t, dc)).astype(np.float32)
    ref = TransformerBlock(heads=heads, head_dim=HD)
    params = seeded_params(ref.init(jax.random.PRNGKey(seed),
                                    jnp.asarray(x), jnp.asarray(ctx)), seed)
    inv = from_jax._Inverse(params["params"])
    from_jax._transformer_block(inv, "", "")
    blk = port_layers.TransformerBlock(c, dc, heads, HD)
    blk.load_state_dict(inv.sd)
    w = bk.pack_block_weights(blk, torch.float32)
    return ref, params, blk, w, x, ctx


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol)


def _jw(w):
    return {k: jnp.asarray(v.numpy()) for k, v in w.items()}


@pytest.mark.parametrize("shape", SHAPES)
def test_ln_qkv_reference_matches_jax(shape):
    _, _, _, w, x, _ = _setup(*shape)
    b, s, c = x.shape
    x2 = x.reshape(b * s, c)
    jw = _jw(w)
    h = j_layer_norm(jnp.asarray(x2), jw["n1s"][None], jw["n1b"][None])
    want = jnp.dot(h, jw["wqkv"])
    for fn in (bk.ln_qkv_reference, bk.ln_qkv):  # the wrapper, on CPU
        got = fn(torch.from_numpy(x2), w["n1s"], w["n1b"], w["wqkv"])
        _close(torch.cat(got, dim=1), want)


@pytest.mark.parametrize("shape", SHAPES)
def test_packed_attn_reference_matches_jax(shape):
    heads, b, s = shape[:3]
    c = heads * HD
    rng = np.random.default_rng(1)
    q, k, v = (rng.standard_normal((b, s, c)).astype(np.float32)
               for _ in range(3))
    want = j_attention(*(jnp.asarray(a).reshape(b, s, heads, HD)
                         for a in (q, k, v)), impl="xla").reshape(b, s, c)
    for fn in (bk.packed_attn_reference, bk.packed_attn):
        got = fn(*(torch.from_numpy(a) for a in (q, k, v)), heads=heads,
                 head_dim=HD)
        _close(got, want)


@pytest.mark.parametrize("shape", SHAPES)
def test_post_cross_reference_matches_jax(shape):
    heads, b, s, t = shape[:4]
    _, _, _, w, x, _ = _setup(*shape)
    c = heads * HD
    rng = np.random.default_rng(2)
    attn = rng.standard_normal((b, s, c)).astype(np.float32)
    ck, cv = (rng.standard_normal((b, t, c)).astype(np.float32)
              for _ in range(2))
    jw = _jw(w)
    x1 = jnp.asarray(x) + jnp.asarray(attn) @ jw["wo"] + jw["bo"]
    q2 = j_layer_norm(x1, jw["n2s"], jw["n2b"]) @ jw["wq2"]
    o = j_attention(q2.reshape(b, s, heads, HD),
                    jnp.asarray(ck).reshape(b, t, heads, HD),
                    jnp.asarray(cv).reshape(b, t, heads, HD), impl="xla")
    want = x1 + o.reshape(b, s, c) @ jw["wo2"] + jw["bo2"]
    args = [torch.from_numpy(a) for a in (x, attn, ck, cv)]
    for fn in (bk.post_cross_reference, bk.post_cross):
        got = fn(*args, w["wo"], w["bo"], w["n2s"], w["n2b"], w["wq2"],
                 w["wo2"], w["bo2"], heads=heads, head_dim=HD)
        _close(got, want)


@pytest.mark.parametrize("shape", SHAPES)
def test_geglu_ff_reference_matches_jax(shape):
    _, params, _, w, x, _ = _setup(*shape)
    b, s, c = x.shape
    p = params["params"]
    xm = jnp.asarray(x.reshape(b * s, c))
    h = LayerNormF32().apply({"params": p["norm3"]}, xm)
    want = xm + GEGLUFeedForward().apply({"params": p["ff"]}, h)
    args = [w[k] for k in ("n3s", "n3b", "wa", "wg", "ba", "bg", "w2", "b2")]
    for fn in (bk.geglu_ff_reference, bk.geglu_ff):
        _close(fn(torch.from_numpy(x.reshape(b * s, c)), *args), want)


@pytest.mark.parametrize("shape", SHAPES)
def test_block_matches_jax_unfused_and_interpret(shape):
    heads = shape[0]
    ref, params, blk, w, x, ctx = _setup(*shape, seed=3)
    want = ref.apply(params, jnp.asarray(x), jnp.asarray(ctx))
    fused = FusedTransformerBlock(heads=heads, head_dim=HD, interpret=True)
    want_kernels = fused.apply(params, jnp.asarray(x), jnp.asarray(ctx))
    xt, ct = torch.from_numpy(x), torch.from_numpy(ctx)
    got = bk.fused_transformer_block(xt, ct, w, heads=heads, head_dim=HD)
    _close(got, want)
    _close(got, want_kernels)
    # the port's unfused block and its fused route agree with JAX too
    with torch.no_grad():
        _close(blk(xt, ct), want)
        _close(blk.forward_fused(xt, ct), want)


def test_cpu_wrappers_count_no_launches():
    bk.reset_launch_counts()
    _, _, _, w, x, ctx = _setup(*SHAPES[0])
    bk.fused_transformer_block(torch.from_numpy(x), torch.from_numpy(ctx),
                               w, heads=SHAPES[0][0], head_dim=HD)
    assert bk.launch_counts() == {
        "ln_qkv": 0, "packed_attn": 0, "post_cross": 0, "geglu_ff": 0,
        "post_ff": 0, "ln_qkv_q": 0, "packed_attn_q8": 0,
        "post_cross_q": 0, "geglu_ff_q": 0}


def test_wrappers_reject_other_devices():
    x = torch.empty((4, 64), device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        bk.ln_qkv(x, torch.empty(64, device="meta"),
                  torch.empty(64, device="meta"),
                  torch.empty((64, 192), device="meta"))


@pytest.mark.parametrize("n,rows", [(1152, 8192), (1728, 2048), (2880, 512),
                                    (1536, 8192), (3840, 512), (96, 3)])
def test_tile_plan_covers_every_tile(n, rows):
    """ln_qkv_q's plan (`gemm_plan("qkv8")`, N = 3C, K = C): the column
    tiles its CTAs walk cover every tile once, evened out, the grid runs
    in one wave, and walking fewer tiles a CTA would not."""
    sms = 132
    plan = bk.gemm_plan("qkv8", rows, n, n // 3, sms)
    ntiles = -(-n // plan.bn)
    tpc = plan.tiles_per_cta
    assert 1 <= tpc <= ntiles
    chunks = -(-ntiles // tpc)
    assert (chunks - 1) * tpc < ntiles <= chunks * tpc
    ctas = chunks * -(-rows // plan.bm)
    slots = sms * bk._per_sm("qkv8", plan.bm, plan.bn, plan.pp, n // 3,
                             plan.stages)
    assert ctas <= slots or tpc == ntiles
    if tpc > 1:
        assert -(-ntiles // (tpc - 1)) * -(-rows // plan.bm) > slots


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "CUDA_HOME_DEFAULT", tmp_path)
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()


def test_failed_build_raises(monkeypatch, tmp_path):
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: no compiler here' >&2\nexit 2\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(_build, "find_nvcc", lambda: str(fake))
    with pytest.raises(RuntimeError, match="nvcc failed"):
        _build.build()
    assert not list((tmp_path / "build").rglob("*.so"))


def test_source_digest_tracks_flags(monkeypatch):
    d = _build.source_digest()
    assert d == _build.source_digest() and len(d) == 16
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ["-G"])
    assert _build.source_digest() != d


@pytest.mark.parametrize("case,error,match", [
    ("f32 activation", TypeError, "bf16 activations"),
    ("bf16 bias", TypeError, "f32 norms"),
    ("short bias", ValueError, "expected shape"),
    ("misaligned", ValueError, "16-byte aligned"),
    ("strided", ValueError, "contiguous"),
    ("head_dim 48", ValueError, "head_dim"),
])
def test_kernel_input_checks(case, error, match):
    """The checks a wrapper makes before handing pointers to a kernel:
    `_check`'s dtypes, shapes and layouts, then `kernel_refusal`'s shapes
    (here those of the int8 attention core, which takes heads 32 and 64
    wide)."""
    bf = torch.bfloat16
    x = torch.zeros((32, 64), dtype=bf)
    bias = torch.zeros(64)
    head_dim = HD
    if case == "f32 activation":
        x = x.float()
    elif case == "bf16 bias":
        bias = bias.to(bf)
    elif case == "short bias":
        bias = bias[:63]
    elif case == "misaligned":
        x = torch.zeros(32 * 64 + 1, dtype=bf)[1:].view(32, 64)
    elif case == "strided":
        x = torch.zeros((64, 32), dtype=bf).t()
    else:
        head_dim = 48
    with pytest.raises(error, match=match):
        bk._check("k", [(x, (32, 64))], [(bias, (64,))])
        bk._refuse(bk.kernel_refusal("packed_attn_q8", 64, head_dim=head_dim))
    bk._check("k", [(torch.zeros((32, 64), dtype=bf), (32, 64))],
              [(torch.zeros(64), (64,))])
    assert bk.kernel_refusal("packed_attn_q8", 64, head_dim=HD) is None
    assert bk.kernel_refusal("packed_attn_q8", 64, head_dim=64) is None
