"""The port's RARM serving modes against the JAX package at tiny sizes:
int8_weights (the decode projections int8 with bf16 column scales),
int8_kv (int8 KV caches with f32 per-(row, batch row) scales) and
approx_top_k.

Inputs come from numpy seeds; weights are the JAX trees of
tests/test_torch_port_rarm.py, so both sides run on the same numbers in f32
and the JAX decode kernels run in Pallas interpret mode. Tolerances: int8
codes and bf16 scales of the weights equal; decode-layer outputs within
1e-3 x max|ref| (the golden tests' rule, tests/test_torch_convert.py); the
committed int8 cache row's codes equal but for at most 0.1% one step apart
(two f32 projections summed in another order can put a value on the other
side of a rounding edge, as tests/test_torch_port_int8.py allows) and its
scales within 4 f32 ulp (a scale is its row's absmax / 127, so it carries
that absmax's last-bit difference: with int8 weights the projection is a
sum of C f32 products that XLA and torch add in different orders, measured
2 ulp apart at these sizes); greedy (top_k = 1) tokens equal, and pipeline
pixels within one uint8 level.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rdm_tpu.models import rarm as jrarm
from rdm_tpu.models.autoencoder import AutoencoderConfig as JAEConfig
from rdm_tpu.ops import decode_kernel as jdk
from rdm_tpu.pipeline import RARMPipeline as JRARMPipeline
from rdm_tpu.retrieval import database as jdb
from rdm_tpu_torch.models import rarm
from rdm_tpu_torch.ops import decode_kernel as dk
from rdm_tpu_torch.pipeline import RARMPipeline
from rdm_tpu_torch.retrieval.database import DataPool
from test_torch_port_rarm import AE_KW, PIPE, _models, _neighbors, _vq

# the port's weight names -> the JAX extract_decode_weights names
JAX_NAMES = {"wqkv": "wqkv", "wo": "wo", "wq2": "wq2", "wo2": "wo2",
             "wa": "wff_a", "wg": "wff_g", "w2": "wff2"}
MODES = {"int8_weights": dict(int8_weights=True),
         "int8_kv": dict(int8_kv=True),
         "both": dict(int8_weights=True, int8_kv=True),
         "approx_top_k": dict(approx_top_k=True)}


_shared_models = functools.lru_cache(maxsize=None)(_models)  # read-only use


def _close(got, want, rel=1e-3):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want,
                               atol=rel * float(np.abs(want).max()), rtol=0)


def _codes_close(got, want, share=1e-3):
    diff = np.abs(np.asarray(got, np.int32) - np.asarray(want, np.int32))
    assert diff.max() <= 1, diff.max()
    assert (diff > 0).mean() <= share, (diff > 0).mean()


def test_int8_weights_match_jax():
    """Codes and bf16 scales of every layer's seven projections equal JAX
    extract_decode_weights(int8_weights=True); the rest as packed."""
    _, params, cfg, model = _models(seed=30)
    want = jrarm.extract_decode_weights(params, cfg, jnp.float32,
                                        int8_weights=True)
    got = rarm.extract_decode_weights(model, torch.float32,
                                      int8_weights=True)
    plain = rarm.extract_decode_weights(model, torch.float32)
    for g, w, p in zip(got, want, plain):
        for name, jname in JAX_NAMES.items():
            assert g[name].dtype == torch.int8
            assert g[name + "_s"].dtype == torch.bfloat16
            np.testing.assert_array_equal(g[name].numpy(),
                                          np.asarray(w[jname]))
            np.testing.assert_array_equal(
                g[name + "_s"].float().numpy(),
                np.asarray(w[jname + "_s"].astype(jnp.float32))[0])
        for name in p:
            if name not in JAX_NAMES:
                np.testing.assert_array_equal(g[name].numpy(),
                                              p[name].numpy())


@pytest.mark.parametrize("mode", ["int8_weights", "int8_kv", "both"])
@pytest.mark.parametrize("where", ["first", "mid", "last"])
def test_decode_layer_int8_matches_jax(mode, where):
    """decode_layer's plain versions in each int8 mode against the JAX
    decode_layer run through Pallas's interpreter: x_out, and with int8_kv
    the committed codes and scales (the other rows random and untouched)."""
    jm, params, cfg, model = _shared_models(seed=31)
    t, c, s, b = cfg.seq_len, cfg.inner_dim, 3, 3
    pos = {"first": 0, "mid": t // 2 - 1, "last": t - 1}[where]
    int8_w, int8_kv = mode != "int8_kv", mode != "int8_weights"
    rng = np.random.default_rng(32 + pos)
    x = rng.standard_normal((b, c)).astype(np.float32)
    if int8_kv:
        kc, vc = (rng.integers(-127, 128, (t, b, c)).astype(np.int8)
                  for _ in range(2))
        ks, vs = (rng.uniform(0.005, 0.02, (t, b, 1)).astype(np.float32)
                  for _ in range(2))
    else:
        kc, vc = (rng.standard_normal((t, b, c)).astype(np.float32)
                  for _ in range(2))
    ck, cv = (rng.standard_normal((s, b, c)).astype(np.float32)
              for _ in range(2))
    d = 1
    jw = jrarm.extract_decode_weights(params, cfg, jnp.float32,
                                      int8_weights=int8_w)[d]
    seg, segt = jdk.head_segment_matrices(cfg.heads, cfg.head_dim,
                                          jnp.float32)
    kv = dict(ks_cache=jnp.asarray(ks), vs_cache=jnp.asarray(vs)) \
        if int8_kv else {}
    want = jdk.decode_layer(
        jnp.asarray(x), jnp.int32(pos), jnp.asarray(kc), jnp.asarray(vc),
        jnp.asarray(ck), jnp.asarray(cv), seg, segt, jw, heads=cfg.heads,
        head_dim=cfg.head_dim, window=t, interpret=True, **kv)
    w = rarm.extract_decode_weights(model, torch.float32,
                                    int8_weights=int8_w)[d]
    mine = [torch.from_numpy(a.copy()) for a in
            ((kc, vc, ks, vs) if int8_kv else (kc, vc))]
    with torch.no_grad():
        got = dk.decode_layer(
            torch.from_numpy(x), pos, mine[0], mine[1], torch.from_numpy(ck),
            torch.from_numpy(cv), w, heads=cfg.heads, head_dim=cfg.head_dim,
            **(dict(ks_cache=mine[2], vs_cache=mine[3]) if int8_kv else {}))
    assert len(got) == len(want) == (5 if int8_kv else 3)
    assert all(g is m for g, m in zip(got[1:], mine))  # in place
    _close(got[0].numpy(), want[0])
    if not int8_kv:
        for g, r in zip(got[1:], want[1:]):
            _close(g.numpy(), r, 1e-4)
        return
    keep = np.arange(t) != pos
    for g, r, old in zip(got[1:3], want[1:3], (kc, vc)):
        np.testing.assert_array_equal(g.numpy()[keep], old[keep])
        _codes_close(g.numpy()[pos], np.asarray(r)[pos])
    for g, r, old in zip(got[3:], want[3:], (ks, vs)):
        np.testing.assert_array_equal(g.numpy()[keep], old[keep])
        np.testing.assert_array_max_ulp(g.numpy()[pos], np.asarray(r)[pos],
                                        maxulp=4)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("guidance", [1.0, 2.0])
def test_greedy_tokens_match_jax(mode, guidance):
    """Greedy tokens of the kernel-path sampler (and, for approx_top_k, the
    eager one) in each serving mode equal JAX sample_tokens_fused's in
    interpret mode (the modes of tests/test_rarm.py:225-281)."""
    jm, params, cfg, model = _shared_models(seed=33)
    ctx = _neighbors(2, 3, cfg.context_dim, 34)
    want = np.asarray(jrarm.sample_tokens_fused(
        jm, params, jnp.asarray(ctx), jax.random.PRNGKey(0), top_k=1,
        guidance_scale=guidance, interpret=True, **MODES[mode]))
    samplers = [rarm.sample_tokens_fused]
    if mode == "approx_top_k":
        samplers.append(rarm.sample_tokens)
    for sampler in samplers:
        got = sampler(model, torch.from_numpy(ctx),
                      torch.Generator().manual_seed(1), top_k=1,
                      guidance_scale=guidance, **MODES[mode])
        np.testing.assert_array_equal(got.numpy(), want)


def test_approx_top_k_is_the_exact_top_k():
    logits = torch.from_numpy(np.random.default_rng(35).standard_normal(
        (4, 300)).astype(np.float32))
    want = np.asarray(jrarm.top_k_filter(jnp.asarray(logits.numpy()), 17,
                                         approx=True))
    for approx in (False, True):
        np.testing.assert_array_equal(
            rarm.top_k_filter(logits, 17, approx=approx).numpy(), want)


def test_int8_kv_refuses_a_deferred_commit():
    _, _, cfg, model = _models(seed=36)
    ctx = torch.zeros((1, 3, cfg.context_dim))
    with pytest.raises(ValueError, match="batched_commit"):
        rarm.sample_tokens_fused(model, ctx, torch.Generator(), int8_kv=True,
                                 batched_commit=True)
    w = rarm.extract_decode_weights(model, torch.float32)[0]
    t, c = cfg.seq_len, cfg.inner_dim
    x, cache = torch.zeros((1, c)), torch.zeros((t, 1, c), dtype=torch.int8)
    scales = torch.ones((t, 1, 1))
    with pytest.raises(ValueError, match="defer_commit"):
        dk.decode_layer(x, 0, cache, cache.clone(), x[None], x[None], w,
                        heads=cfg.heads, head_dim=cfg.head_dim,
                        defer_commit=True, ks_cache=scales,
                        vs_cache=scales.clone())
    with pytest.raises(ValueError, match="int8_weights=True"):
        rarm.sample_tokens_fused(model, ctx, torch.Generator(),
                                 int8_weights=True,
                                 weights=[w] * cfg.depth)


def test_cpu_int8_paths_count_no_launches():
    _, _, cfg, model = _models(seed=37)
    ctx = torch.from_numpy(_neighbors(2, 3, cfg.context_dim, 38))
    dk.reset_launch_counts()
    rarm.sample_tokens_fused(model, ctx, torch.Generator().manual_seed(0),
                             top_k=5, int8_weights=True, int8_kv=True)
    assert dk.launch_counts() == dict.fromkeys(dk.KERNEL_NAMES, 0)


@pytest.mark.parametrize("mode", list(MODES))
def test_pipeline_int8_matches_jax_greedy(mode, monkeypatch):
    """A tiny RARMPipeline in each serving mode against the JAX pipeline:
    greedy images within one uint8 level; the int8 decode weights are
    packed once, at the first int8_weights request. The JAX pipeline takes
    its int8 modes only on the fused decode path, which it picks on a TPU:
    here it is picked for it, with the kernels in interpret mode."""
    monkeypatch.setattr(jrarm, "use_fused_decode_default", lambda: True)
    monkeypatch.setattr(jrarm, "sample_tokens_fused", functools.partial(
        jrarm.sample_tokens_fused, interpret=True))
    jm, params, cfg, model = _models(PIPE, seed=39)
    jvq, vq_params, ae, vq_sd = _vq(seed=40)
    emb = np.random.default_rng(41).standard_normal((200, 24)).astype(
        np.float32)
    q = np.random.default_rng(42).standard_normal((2, 24)).astype(np.float32)
    jpipe = JRARMPipeline(jrarm.RARMConfig(**PIPE), params, JAEConfig(**AE_KW),
                          vq_params, pool=jdb.DataPool(emb),
                          dtype=jnp.float32)
    pipe = RARMPipeline(cfg, model.state_dict(), ae, vq_sd,
                        pool=DataPool(emb), dtype=torch.float32,
                        device="cpu")
    kw = dict(top_k=1, guidance_scale=2.0, seed=3, **MODES[mode])
    want = jpipe.sample_with_query(q, **kw)["query_samples"]
    got = pipe.sample_with_query(q, **kw)["query_samples"]
    assert got.shape == (2, 8, 8, 3) and got.dtype == np.uint8
    assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1
    int8_w = pipe.serving_decode_weights(True)
    assert "wqkv_s" in int8_w[0] and "wqkv_s" not in pipe.decode_weights[0]
    assert pipe.serving_decode_weights(True) is int8_w
