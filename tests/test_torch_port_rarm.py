"""The port's RARM path against the JAX package at tiny sizes: the model
and its weight layout, the decode kernels' plain versions, the samplers,
decode_code and the RARMPipeline.

Inputs come from numpy seeds; weights are JAX trees made by
`seeded_params` and converted with `rarm_state_dict_from_jax`, so both
sides run on the same numbers in f32. Tolerances: logits within
1e-3 x max(1, |ref|) (the golden tests' rule, tests/test_torch_convert.py);
decode-layer outputs and caches within 1e-4 x max(1, |ref|) (one layer of
f32 arithmetic in another order); greedy (top_k = 1) tokens equal — the
two frameworks' random generators differ, so only greedy tokens can be
compared across them; pixels within one uint8 level (truncation can flip a
level where the float pixels differ in the last bits).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rdm_tpu.models import rarm as jrarm
from rdm_tpu.models.autoencoder import AutoencoderConfig as JAEConfig
from rdm_tpu.models.autoencoder import VQModel as JVQModel
from rdm_tpu.ops import decode_kernel as jdk
from rdm_tpu.pipeline import RARMPipeline as JRARMPipeline
from rdm_tpu.retrieval import database as jdb
from rdm_tpu.utils.torch_convert import convert_rarm_transformer
from rdm_tpu_torch import config as pc
from rdm_tpu_torch.models import rarm
from rdm_tpu_torch.models.autoencoder import VQModel
from rdm_tpu_torch.ops import decode_kernel as dk
from rdm_tpu_torch.pipeline import RARMPipeline
from rdm_tpu_torch.retrieval.database import DataPool
from rdm_tpu_torch.utils.from_jax import (rarm_state_dict_from_jax,
                                          vq_state_dict_from_jax)
from test_torch_port_unet import seeded_params

TINY = dict(vocab_size=40, out_vocab=38, heads=2, head_dim=8, depth=2,
            context_dim=12, seq_len=8, sos_token=39, mask_token=38,
            code_side=2)
# a 4x4 token grid decoded by a VQ with attention at its 4x4 level
PIPE = dict(vocab_size=18, out_vocab=16, heads=2, head_dim=8, depth=2,
            context_dim=24, seq_len=16, sos_token=17, mask_token=16,
            code_side=4)
AE_KW = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(4,),
             resolution=8, z_channels=3, embed_dim=3, n_embed=16)


def _close(got, want, rel):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want,
                               atol=rel * max(1.0, float(np.abs(want).max())))


def _models(kw=TINY, seed=0):
    """(JAX model, JAX params, port config, port RARM in f32) on the same
    seeded weights."""
    jcfg, cfg = jrarm.RARMConfig(**kw), pc.RARMConfig(**kw)
    jm = jrarm.RARM(jcfg)
    params = seeded_params(jax.eval_shape(
        jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32),
        jnp.zeros((1, 3, kw["context_dim"]))), seed)
    model = rarm.RARM(cfg).eval()
    model.load_state_dict(rarm_state_dict_from_jax(params, cfg))
    return jm, params, cfg, model


def _neighbors(b, s, d, seed):
    return np.random.default_rng(seed).standard_normal((b, s, d)).astype(
        np.float32)


def test_reference_torch_layout_loads_strictly():
    """The port's RARM takes the RetrievalPatchTransformer state dict of
    the torch oracle (tests/test_torch_convert.py TRarm) as it is and
    computes its logits."""
    from test_torch_convert import TRarm

    torch.manual_seed(4)
    oracle = TRarm().eval()
    cfg = pc.RARMConfig(vocab_size=24, out_vocab=20, heads=2, head_dim=16,
                        depth=2, context_dim=8, seq_len=6, sos_token=23,
                        mask_token=22, code_side=2)
    port = rarm.RARM(cfg).eval()
    port.load_state_dict(oracle.state_dict())  # strict: the same names
    toks = torch.tensor([[23, 3, 7, 1, 19, 2], [23, 0, 5, 5, 11, 8]])
    ctx = torch.randn((2, 3, 8), generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        _close(port(toks, ctx).numpy(), oracle(toks, ctx).numpy(), 1e-5)


def test_weights_round_trip():
    """convert_rarm_transformer(port state dict under `transformer.`) is the
    JAX tree, and rarm_state_dict_from_jax gives the state dict back."""
    _, params, cfg, model = _models(seed=1)
    sd = {f"transformer.{k}": v.numpy()
          for k, v in model.state_dict().items()}
    back = convert_rarm_transformer(sd, cfg.depth)
    jax.tree_util.tree_map(np.testing.assert_array_equal, back["params"],
                           jax.tree_util.tree_map(np.asarray,
                                                  params["params"]))
    again = rarm_state_dict_from_jax(back, cfg)
    assert again.keys() == model.state_dict().keys()
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(again[k].numpy(), v.numpy())


def test_teacher_forced_logits_match_jax():
    jm, params, cfg, model = _models(seed=2)
    rng = np.random.default_rng(3)
    toks = np.concatenate([np.full((2, 1), cfg.sos_token),
                           rng.integers(0, cfg.out_vocab, (2, 7))], axis=1)
    ctx = _neighbors(2, 3, cfg.context_dim, 4)
    want = jm.apply(params, jnp.asarray(toks, jnp.int32), jnp.asarray(ctx))
    with torch.no_grad():
        got = model(torch.from_numpy(toks), torch.from_numpy(ctx))
    _close(got.numpy(), want, 1e-3)


def test_eager_decode_step_matches_teacher_forced():
    """The eager KV-cached decode_step reproduces the teacher-forced
    logits position by position (the JAX KV-cache contract)."""
    _, _, cfg, model = _models(seed=5)
    rng = np.random.default_rng(6)
    toks = torch.from_numpy(np.concatenate(
        [np.full((3, 1), cfg.sos_token),
         rng.integers(0, cfg.out_vocab, (3, 7))], axis=1))
    ctx = torch.from_numpy(_neighbors(3, 3, cfg.context_dim, 7))
    with torch.no_grad():
        want = model(toks, ctx)
        cache = model.init_cache(3, ctx)
        steps = [model.decode_step(toks[:, p], p, cache)[0]
                 for p in range(toks.shape[1])]
        dec = rarm.FusedDecoder(model, ctx)
        fused = [dec.step(toks[:, p], p) for p in range(toks.shape[1])]
    _close(torch.stack(steps, 1).numpy(), want.numpy(), 1e-5)
    _close(torch.stack(fused, 1).numpy(), want.numpy(), 1e-5)


@pytest.mark.parametrize("b", [2, 3])
@pytest.mark.parametrize("where", ["first", "mid", "last"])
def test_decode_layer_matches_jax(b, where):
    """decode_layer (and each of its two wrappers) against the JAX
    decode_layer run through Pallas's interpreter: x_out and both caches,
    the caches holding random rows at and past pos."""
    jm, params, cfg, model = _models(seed=8)
    t, c, s = cfg.seq_len, cfg.inner_dim, 3
    pos = {"first": 0, "mid": t // 2 - 1, "last": t - 1}[where]
    rng = np.random.default_rng(9 + b)
    x = rng.standard_normal((b, c)).astype(np.float32)
    kc, vc = (rng.standard_normal((t, b, c)).astype(np.float32)
              for _ in range(2))
    ck, cv = (rng.standard_normal((s, b, c)).astype(np.float32)
              for _ in range(2))
    d = 1
    jw = jrarm.extract_decode_weights(params, cfg, jnp.float32)[d]
    seg, segt = jdk.head_segment_matrices(cfg.heads, cfg.head_dim,
                                          jnp.float32)
    want = jdk.decode_layer(
        jnp.asarray(x), jnp.int32(pos), jnp.asarray(kc), jnp.asarray(vc),
        jnp.asarray(ck), jnp.asarray(cv), seg, segt, jw, heads=cfg.heads,
        head_dim=cfg.head_dim, window=t, interpret=True)
    w = rarm.extract_decode_weights(model, torch.float32)[d]
    tx, tkc, tvc, tck, tcv = map(torch.from_numpy, (x, kc, vc, ck, cv))
    hd = dict(heads=cfg.heads, head_dim=cfg.head_dim)
    with torch.no_grad():
        xo, ko, vo = dk.decode_layer(tx, pos, tkc.clone(), tvc.clone(), tck,
                                     tcv, w, **hd)
        attn, kn, vn = dk.decode_attn(tx, pos, tkc.clone(), tvc.clone(),
                                      w["n1s"], w["n1b"], w["wqkv"],
                                      commit=False, **hd)
        xo2 = dk.decode_post_ff(tx, attn, tck, tcv, w["wo"], w["bo"],
                                w["n2s"], w["n2b"], w["wq2"], w["wo2"],
                                w["bo2"], w["n3s"], w["n3b"], w["wa"],
                                w["wg"], w["ba"], w["bg"], w["w2"], w["b2"],
                                **hd)
    for got, ref in zip((xo, ko, vo), want):
        _close(got.numpy(), ref, 1e-4)
    _close(kn.numpy(), want[1][pos], 1e-4)
    _close(vn.numpy(), want[2][pos], 1e-4)
    _close(xo2.numpy(), want[0], 1e-4)


def test_commit_rows_matches_jax():
    rng = np.random.default_rng(12)
    caches = [rng.standard_normal((6, 3, 16)).astype(np.float32)
              for _ in range(4)]
    rows = [rng.standard_normal((1, 3, 16)).astype(np.float32)
            for _ in range(4)]
    want = jdk.commit_rows(jnp.int32(4), [jnp.asarray(a) for a in caches],
                           [jnp.asarray(r) for r in rows], interpret=True)
    mine = [torch.from_numpy(a.copy()) for a in caches]
    got = dk.commit_rows(4, mine, [torch.from_numpy(r) for r in rows])
    for g, m, w in zip(got, mine, want):
        assert g is m  # in place
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("guidance", [1.0, 2.0])
def test_greedy_tokens_match_jax(guidance):
    jm, params, cfg, model = _models(seed=13)
    ctx = _neighbors(2, 3, cfg.context_dim, 14)
    want = np.asarray(jrarm.sample_tokens_fused(
        jm, params, jnp.asarray(ctx), jax.random.PRNGKey(0), top_k=1,
        guidance_scale=guidance, interpret=True))
    tctx = torch.from_numpy(ctx)
    for sampler in (rarm.sample_tokens, rarm.sample_tokens_fused):
        got = sampler(model, tctx, torch.Generator().manual_seed(1),
                      top_k=1, guidance_scale=guidance)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("guidance", [1.0, 2.0])
def test_port_samplers_agree(guidance):
    """The eager and kernel-path samplers draw the same tokens from one
    seeded generator at top_k = 10, in place and with the batched
    commit."""
    _, _, cfg, model = _models(seed=15)
    ctx = torch.from_numpy(_neighbors(3, 3, cfg.context_dim, 16))
    kw = dict(top_k=10, guidance_scale=guidance)
    want = rarm.sample_tokens(model, ctx, torch.Generator().manual_seed(2),
                              **kw)
    assert want.shape == (3, cfg.seq_len)
    assert int(want.min()) >= 0 and int(want.max()) < cfg.out_vocab
    dk.reset_launch_counts()
    for batched in (False, True):
        got = rarm.sample_tokens_fused(
            model, ctx, torch.Generator().manual_seed(2),
            batched_commit=batched, **kw)
        np.testing.assert_array_equal(got.numpy(), want.numpy())
    # CPU tensors take the plain versions, and nothing counts as a launch
    assert set(dk.launch_counts().values()) == {0}


def test_unported_modes_raise():
    """Every serving mode is ported; the one combination the JAX package
    refuses, an int8 KV cache with a deferred (batched) commit, raises in
    both (JAX decode_layer asserts; the port raises ValueError)."""
    _, params, cfg, model = _models(seed=17)
    ctx = torch.zeros((1, 3, cfg.context_dim))
    gen = torch.Generator()
    with pytest.raises(ValueError, match="batched_commit"):
        rarm.sample_tokens_fused(model, ctx, gen, int8_kv=True,
                                 batched_commit=True)
    t, c = cfg.seq_len, cfg.inner_dim
    codes, scales, x = np.zeros((t, 1, c), np.int8), np.ones((t, 1, 1),
                                                             np.float32), \
        np.zeros((1, c), np.float32)
    seg, segt = jdk.head_segment_matrices(cfg.heads, cfg.head_dim,
                                          jnp.float32)
    jw = jrarm.extract_decode_weights(params, cfg, jnp.float32)[0]
    with pytest.raises(AssertionError, match="int8_kv"):
        jdk.decode_layer(jnp.asarray(x), jnp.int32(0), jnp.asarray(codes),
                         jnp.asarray(codes), jnp.asarray(x[None]),
                         jnp.asarray(x[None]), seg, segt, jw,
                         heads=cfg.heads, head_dim=cfg.head_dim, window=t,
                         ks_cache=jnp.asarray(scales),
                         vs_cache=jnp.asarray(scales), defer_commit=True,
                         interpret=True)
    w = rarm.extract_decode_weights(model, torch.float32)[0]
    with pytest.raises(ValueError, match="int8_kv"):
        dk.decode_layer(torch.from_numpy(x), 0, torch.from_numpy(codes),
                        torch.from_numpy(codes.copy()),
                        torch.from_numpy(x[None]), torch.from_numpy(x[None]),
                        w, heads=cfg.heads, head_dim=cfg.head_dim,
                        defer_commit=True, ks_cache=torch.from_numpy(scales),
                        vs_cache=torch.from_numpy(scales.copy()))


def test_wrappers_check_shapes():
    x = torch.zeros((2, 16))
    cache = torch.zeros((4, 2, 16))
    n = torch.ones(16)
    with pytest.raises(ValueError, match="wqkv"):
        dk.decode_attn(x, 0, cache, cache, n, n, torch.zeros((16, 16)),
                       heads=2, head_dim=8)
    with pytest.raises(ValueError, match="pos 4 outside"):
        dk.decode_attn(x, 4, cache, cache, n, n, torch.zeros((16, 48)),
                       heads=2, head_dim=8)
    with pytest.raises(ValueError, match="rows"):
        dk.commit_rows(0, [cache], [torch.zeros((2, 8))])


def _vq(seed):
    jae, ae = JAEConfig(**AE_KW), pc.AutoencoderConfig(**AE_KW)
    jvq = JVQModel(jae)
    idx = jnp.zeros((1, 4, 4), jnp.int32)
    vq_params = seeded_params(jax.eval_shape(
        lambda r: jvq.init(r, idx, method=JVQModel.decode_code),
        jax.random.PRNGKey(1)), seed)
    return jvq, vq_params, ae, vq_state_dict_from_jax(vq_params, ae)


def test_decode_code_matches_jax():
    jvq, vq_params, ae, vq_sd = _vq(seed=18)
    idx = np.random.default_rng(19).integers(0, 16, (2, 4, 4))
    want = jvq.apply(vq_params, jnp.asarray(idx, jnp.int32),
                     method=JVQModel.decode_code)
    vq = VQModel(ae, encoder=False).eval()  # a decode-side tree
    vq.load_state_dict(vq_sd)
    with torch.no_grad():
        got = vq.decode_code(torch.from_numpy(idx))
    assert got.shape == (2, 3, 8, 8)
    _close(got.permute(0, 2, 3, 1).numpy(), want, 1e-4)


@pytest.mark.parametrize("kind", ["query", "only_query", "unconditional",
                                  "sample_unconditional"])
def test_pipeline_matches_jax_greedy(kind):
    jm, params, cfg, model = _models(PIPE, seed=20)
    jvq, vq_params, ae, vq_sd = _vq(seed=21)
    emb = np.random.default_rng(22).standard_normal((300, 24)).astype(
        np.float32)
    q = np.random.default_rng(23).standard_normal((2, 24)).astype(np.float32)
    jpipe = JRARMPipeline(jrarm.RARMConfig(**PIPE), params, JAEConfig(**AE_KW),
                          vq_params, pool=jdb.DataPool(emb),
                          dtype=jnp.float32)
    pipe = RARMPipeline(cfg, model.state_dict(), ae, vq_sd,
                        pool=DataPool(emb), dtype=torch.float32,
                        device="cpu")
    kw = dict(top_k=1, guidance_scale=2.0 if kind == "query" else 1.0,
              seed=3)
    if kind == "sample_unconditional":
        qids = np.asarray([5, 77])
        want = jpipe.sample_unconditional(2, qids=qids, **kw)
        got = pipe.sample_unconditional(2, qids=qids, **kw)
        key = "samples_with_sampled_nns"
    else:
        flags = {kind: True} if kind != "query" else {}
        want = jpipe.sample_with_query(q, **flags, **kw)
        got = pipe.sample_with_query(q, return_tokens=True, **flags, **kw)
        key = "query_samples"
        assert got["tokens"].shape == (2, PIPE["seq_len"])
    images = got[key]
    assert images.shape == (2, 8, 8, 3) and images.dtype == np.uint8
    diff = np.abs(images.astype(np.int32) - want[key].astype(np.int32))
    assert diff.max() <= 1


def test_row_commit_per_request_matches_jax():
    """The per-request commit (`RowCommit`: checks and pointer table once,
    a launch a step on the card; the plain version here) over one row
    buffer rewritten each step, as FusedDecoder keeps it, against JAX's
    `commit_rows` step by step; the caches updated in place."""
    rng = np.random.default_rng(19)
    caches = [rng.standard_normal((6, 3, 16)).astype(np.float32)
              for _ in range(4)]
    mine = [torch.from_numpy(a.copy()) for a in caches]
    buf = torch.zeros((4, 3, 16))
    commit = dk.RowCommit(mine, list(buf))
    want = [jnp.asarray(a) for a in caches]
    for pos in (0, 4, 5, 2):
        rows = rng.standard_normal((4, 1, 3, 16)).astype(np.float32)
        buf.copy_(torch.from_numpy(rows[:, 0]))
        got = commit(pos)
        want = jdk.commit_rows(jnp.int32(pos), want,
                               [jnp.asarray(r) for r in rows],
                               interpret=True)
        for g, m, w in zip(got, mine, want):
            assert g is m
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    with pytest.raises(ValueError, match="pos 6 outside"):
        commit(6)
