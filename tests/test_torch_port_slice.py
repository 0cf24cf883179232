"""The port's main path against the JAX package, end to end at a tiny size:
exact kNN -> neighbors -> uncond_context -> DDIM with shared-prefix CFG ->
VQ decode, and the RDMPipeline that chains them.

Inputs come from numpy seeds; the port's torch.Generator draws x_T and the
same array goes to the JAX sampler as `x_init`. Tolerances: kNN ids equal
and scores within 1e-5; latents and pixels within 2e-3 x max(1, |ref|), as
tests/test_torch_convert.py:914 holds the golden pixel chain (f32 on both
sides, five DDIM steps of error growth).
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rdm_tpu.models.autoencoder import AutoencoderConfig as JAEConfig
from rdm_tpu.models.autoencoder import VQModel as JVQModel
from rdm_tpu.models.rdm import RDM as JRDM
from rdm_tpu.models.rdm import RDMConfig as JRDMConfig
from rdm_tpu.models.unet import UNetConfig as JUNetConfig
from rdm_tpu.ops.schedules import DiffusionSchedule as JSchedule
from rdm_tpu.pipeline import to_uint8 as j_to_uint8
from rdm_tpu.retrieval import database as jdb
from rdm_tpu.retrieval import engine as jeng
from rdm_tpu.sampling import DDIMSamplerConfig as JSampler
from rdm_tpu.sampling import ddim_sample as j_ddim_sample
from rdm_tpu.utils.torch_convert import convert_autoencoder
from rdm_tpu_torch import config as pc
from rdm_tpu_torch.models.autoencoder import VQModel
from rdm_tpu_torch.models.rdm import RDM, make_denoise_fn
from rdm_tpu_torch.ops.schedules import DiffusionSchedule
from rdm_tpu_torch.pipeline import RDMPipeline
from rdm_tpu_torch.retrieval import engine as peng
from rdm_tpu_torch.retrieval.database import DataPool, NNMemory
from rdm_tpu_torch.sampling import ddim_sample
from rdm_tpu_torch.utils import from_jax
from rdm_tpu_torch.utils.from_jax import (rdm_state_dict_from_jax,
                                          vq_state_dict_from_jax)
from test_torch_port_unet import seeded_params

UNET = dict(in_channels=3, out_channels=3, model_channels=32,
            num_res_blocks=1, attention_resolutions=(2,), channel_mult=(1, 2),
            num_head_channels=32, context_dim=24)
RDM_KW = dict(image_size=8, channels=3, timesteps=50, context_dim=24, k_nn=4)
AE_KW = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,),
             resolution=16, z_channels=3, embed_dim=3, n_embed=16)
STEPS, GUIDANCE, LABEL = 5, 2.0, 1.5


def _table(n=600, d=24, seed=0):
    """Random embeddings with exact duplicates, so ties must resolve to
    the lower id."""
    rng = np.random.default_rng(seed)
    emb = rng.standard_normal((n, d)).astype(np.float32) * 3.0
    emb[[40, 41, 300]] = emb[7]          # 7, 40, 41, 300 tie
    emb[500] = 2.0 * emb[123]            # same direction: equal scores
    return emb


def _close(got, want, rel=2e-3):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want,
                               atol=rel * max(1.0, float(np.abs(want).max())))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_knn_matches_jax_with_ties(dtype):
    emb = _table()
    queries = np.concatenate([emb[[7, 123, 9]],
                              np.random.default_rng(1).standard_normal(
                                  (3, 24)).astype(np.float32)])
    jpool = jdb.DataPool(embeddings=emb)
    jtable = jpool.device_table(dtype=getattr(jnp, dtype))[:emb.shape[0]]
    want_s, want_i = jeng.knn_search(jtable, jeng.l2_normalize(
        jnp.asarray(queries)), 8)
    table, norms = DataPool(embeddings=emb).device_table(
        dtype=getattr(torch, dtype))
    got_s, got_i = peng.knn_search(table, peng.l2_normalize(
        torch.from_numpy(queries)), 8)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), atol=1e-5)
    assert list(got_i[0, :4]) == [7, 40, 41, 300]
    assert list(got_i[1, :2]) == [123, 500]
    np.testing.assert_allclose(norms.numpy(), np.linalg.norm(emb, axis=1),
                               rtol=1e-6)


def test_engine_search_matches_jax():
    emb = _table(seed=2)
    q = np.random.default_rng(3).standard_normal((4, 24)).astype(np.float32)
    img_ids = np.arange(emb.shape[0]) * 10
    want = jeng.RetrievalEngine(jdb.DataPool(emb, img_ids=img_ids)).search(
        jnp.asarray(q), k=4)
    got = peng.RetrievalEngine(DataPool(emb, img_ids=img_ids)).search(q, k=4)
    np.testing.assert_array_equal(got["nns"].numpy(), np.asarray(want["nns"]))
    np.testing.assert_allclose(got["scores"].numpy(),
                               np.asarray(want["scores"]), atol=1e-5)
    np.testing.assert_allclose(got["embeddings"].numpy(),
                               np.asarray(want["embeddings"]), atol=1e-5)
    np.testing.assert_array_equal(got["img_ids"], want["img_ids"])


def test_pool_and_memory_files_load(tmp_path):
    emb = _table(seed=4)[:50]
    coords = np.random.default_rng(5).integers(0, 9, size=(50, 4))
    jdb.DataPool(emb, img_ids=np.arange(50), patch_coords=coords).save(
        str(tmp_path / "db"), chunk_size=25)
    pool = DataPool.load(str(tmp_path / "db"))
    np.testing.assert_array_equal(pool.embeddings.numpy(), emb)
    np.testing.assert_array_equal(pool.img_ids, np.arange(50))
    np.testing.assert_array_equal(pool.patch_coords, coords)
    # chunks are read in file-name order, as the JAX loader reads them
    jdb.DataPool(emb).save(str(tmp_path / "db2"), chunk_size=20)
    np.testing.assert_array_equal(
        DataPool.load(str(tmp_path / "db2")).embeddings.numpy(),
        jdb.DataPool.load(str(tmp_path / "db2")).embeddings)
    mem = jdb.NNMemory.build(np.random.default_rng(6).integers(0, 50, (40, 4)))
    mem.save(str(tmp_path / "mem.p"))
    mine = NNMemory.load(str(tmp_path / "mem.p"))
    with open(tmp_path / "mem.p", "rb") as f:
        assert pickle.load(f)["id_count"] == mine.id_count
    for memsize, weights in ((0.5, False), (7, True)):
        np.testing.assert_array_equal(
            mine.sample_qids(9, memsize, use_weights=weights,
                             rng=np.random.default_rng(8)),
            mem.sample_qids(9, memsize, use_weights=weights,
                            rng=np.random.default_rng(8)))


def _models(seed=0):
    jcfg = JRDMConfig(unet=JUNetConfig(**UNET), **RDM_KW)
    jm = JRDM(jcfg)
    params = seeded_params(jax.eval_shape(
        jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 3)),
        jnp.zeros((1,), jnp.int32), jnp.zeros((1, 4, 24))), seed)
    jae = JAEConfig(**AE_KW)
    jvq = JVQModel(jae)
    vq_params = seeded_params(jax.eval_shape(
        jvq.init, jax.random.PRNGKey(1), jnp.zeros((1, 16, 16, 3))), seed + 1)
    cfg = pc.RDMConfig(unet=pc.UNetConfig(**UNET), **RDM_KW)
    ae = pc.AutoencoderConfig(**AE_KW)
    return (jm, params, jvq, vq_params), (cfg, rdm_state_dict_from_jax(
        params, cfg), ae, vq_state_dict_from_jax(vq_params, ae))


def _jax_chain(jm, params, jvq, vq_params, neighbors, x_t, label=LABEL):
    """neighbors -> uncond_context -> DDIM (shared CFG) -> VQ decode."""
    b, s, _ = neighbors.shape
    uncond = jm.apply(params, b, s, label, method=JRDM.uncond_context)
    z, _ = j_ddim_sample(
        lambda x, t, c: jm.apply(params, x, t, c),
        JSchedule.create(50, "linear", 0.0015, 0.0195),
        JSampler(num_steps=STEPS, guidance_scale=GUIDANCE, cfg_mode="shared"),
        (b, 8, 8, 3), jnp.asarray(neighbors), jax.random.PRNGKey(0),
        uncond_context=uncond, x_init=jnp.asarray(x_t.transpose(0, 2, 3, 1)))
    px = jvq.apply(vq_params, z, force_not_quantize=False,
                   method=JVQModel.decode)
    return np.asarray(z), np.asarray(px)


def test_retrieval_ddim_decode_chain_matches_jax():
    (jm, params, jvq, vq_params), (cfg, sd, ae, vq_sd) = _models()
    emb = _table(seed=9)
    q = np.random.default_rng(10).standard_normal((2, 24)).astype(np.float32)
    found = peng.RetrievalEngine(DataPool(emb), dtype=torch.float32).search(
        q, k=4)
    want_found = jeng.RetrievalEngine(jdb.DataPool(emb),
                                      dtype=jnp.float32).search(
        jnp.asarray(q), k=4)
    np.testing.assert_array_equal(found["nns"].numpy(),
                                  np.asarray(want_found["nns"]))
    neighbors = found["embeddings"]
    model = RDM(cfg).eval()
    model.load_state_dict(sd)
    vq = VQModel(ae).eval()
    vq.load_state_dict(vq_sd)
    gen = torch.Generator().manual_seed(0)
    x_t = torch.randn((2, 3, 8, 8), generator=gen)
    with torch.no_grad():
        uncond = model.uncond_context(2, 4, LABEL)
        z, _ = ddim_sample(
            make_denoise_fn(model),
            DiffusionSchedule.create(50, "linear", 0.0015, 0.0195),
            pc.DDIMSamplerConfig(num_steps=STEPS, guidance_scale=GUIDANCE,
                                 cfg_mode="shared"),
            (2, 3, 8, 8), neighbors, gen, uncond_context=uncond,
            x_init=x_t)
        px = vq.decode(z)
    want_z, want_px = _jax_chain(jm, params, jvq, vq_params,
                                 neighbors.numpy(), x_t.numpy())
    _close(z.permute(0, 2, 3, 1).numpy(), want_z)
    _close(px.permute(0, 2, 3, 1).numpy(), want_px)


@pytest.mark.parametrize("request_kind", ["query", "unconditional"])
def test_pipeline_matches_jax_chain(request_kind):
    (jm, params, jvq, vq_params), (cfg, sd, ae, vq_sd) = _models(seed=11)
    emb = _table(seed=12)
    pipe = RDMPipeline(cfg, sd, ae, vq_sd, pool=DataPool(emb),
                       dtype=torch.float32, device="cpu")
    seed = 3
    if request_kind == "query":
        q = np.random.default_rng(13).standard_normal((2, 24)).astype(
            np.float32)
        images = pipe.sample_with_query(q, steps=STEPS,
                                        guidance_scale=GUIDANCE,
                                        seed=seed)["query_samples"]
        r_emb = np.asarray(jeng.RetrievalEngine(jdb.DataPool(emb)).search(
            jnp.asarray(q), k=4)["embeddings"])
        neighbors = np.concatenate([q[:, None], r_emb[:, :3]], axis=1)
    else:
        qids = np.asarray([5, 77])
        out = pipe.sample_unconditional(2, steps=STEPS,
                                        guidance_scale=GUIDANCE, qids=qids,
                                        seed=seed, return_nns=True)
        images = out["samples_with_sampled_nns"]
        found = jeng.RetrievalEngine(jdb.DataPool(emb)).search(
            jnp.asarray(emb[qids]), k=4)
        np.testing.assert_array_equal(out["nn_ids"], np.asarray(found["nns"]))
        neighbors = np.asarray(found["embeddings"])
    assert images.shape == (2, 16, 16, 3) and images.dtype == np.uint8
    # the pipeline's generator draws x_T first; the JAX chain gets it as
    # x_init, with the CFG null context scaled to norm 0.0 as in serving
    x_t = torch.randn((2, 3, 8, 8), generator=torch.Generator().manual_seed(
        seed)).numpy()
    _, want_px = _jax_chain(jm, params, jvq, vq_params, neighbors, x_t,
                            label=0.0)
    want = j_to_uint8(want_px).astype(np.int32)
    # uint8 truncation may flip a level where the pixels differ by less
    # than the 2e-3 float tolerance
    assert np.abs(images.astype(np.int32) - want).max() <= 1


def test_vq_weights_round_trip():
    """convert_autoencoder(port decode-side state dict) gives back the JAX
    decoder, post_quant_conv and codebook leaf for leaf (the encoder keys
    the converter also needs are carried by the same inverse walk)."""
    (_, _, _, vq_params), (_, _, ae, vq_sd) = _models(seed=14)
    p = vq_params["params"]
    inv = from_jax._Inverse(p)
    from_jax._ae_trunk(inv, ae, "encoder")
    inv.conv("quant_conv", "quant_conv")
    port = VQModel(ae)
    port.load_state_dict(vq_sd)  # strict: exactly the decode-side keys
    sd = {k: v.numpy() for k, v in {**port.state_dict(), **inv.sd}.items()}
    back = convert_autoencoder(sd, JAEConfig(**AE_KW))["params"]
    for key in ("decoder", "post_quant_conv", "quantize"):
        jax.tree_util.tree_map(np.testing.assert_array_equal, back[key],
                               jax.tree_util.tree_map(np.asarray, p[key]))


def test_vq_decoder_loads_the_reference_torch_layout():
    """The port's VQModel takes the taming decode-side state dict as it is
    (the torch oracle of tests/test_torch_convert.py) and decodes what the
    oracle decodes."""
    import dataclasses

    from test_torch_convert import AE_CFG, TVQ

    torch.manual_seed(2)
    oracle = TVQ(AE_CFG).eval()
    keep = ("decoder.", "post_quant_conv.", "quantize.")
    sd = {k: v for k, v in oracle.state_dict().items() if k.startswith(keep)}
    port = VQModel(pc.AutoencoderConfig(**dataclasses.asdict(AE_CFG)),
                   encoder=False).eval()
    port.load_state_dict(sd)  # strict: the same names
    z = torch.randn((2, AE_CFG.embed_dim, 8, 8),
                    generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        cb = oracle.quantize.embedding.weight
        flat = z.permute(0, 2, 3, 1).reshape(-1, AE_CFG.embed_dim)
        idx = ((cb * cb).sum(1)[None] - 2 * flat @ cb.t()).argmin(1)
        z_q = cb[idx].reshape(2, 8, 8, -1).permute(0, 3, 1, 2)
        want = oracle.decoder(oracle.post_quant_conv(z_q))
        _close(port.decode(z).numpy(), want.numpy())
