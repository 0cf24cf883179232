"""The CLIP-queried paths of the port against the JAX package on the CPU:
the DDIM inpainting blend and the adaptive re-retrieval sampler, and tiny
RDM / RARM pipelines with CLIP (captions, inpainting, re-retrieval).

The JAX samplers draw from `jax.random`; the tests replay JAX's draws
(same keys, same splits) into the port's `torch.randn` calls, in the
port's order, so both sides run on the same noise. Pipelines run in f32
on both sides (`device="cpu"` for the port). Tolerances: latents within
2e-3 x max(1, |ref|) and uint8 pixels within one level, as
tests/test_torch_port_slice.py holds the main path; embeddings within
1e-3 x their scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rdm_tpu.models import clip as jclip
from rdm_tpu.models.autoencoder import AutoencoderConfig as JAEConfig
from rdm_tpu.models.rarm import RARMConfig as JRARMConfig
from rdm_tpu.models.rdm import RDM as JRDM
from rdm_tpu.models.rdm import RDMConfig as JRDMConfig
from rdm_tpu.models.unet import UNetConfig as JUNetConfig
from rdm_tpu.ops.schedules import DiffusionSchedule as JSchedule
from rdm_tpu.pipeline import RARMPipeline as JRARMPipeline
from rdm_tpu.pipeline import RDMPipeline as JRDMPipeline
from rdm_tpu.retrieval import database as jdb
from rdm_tpu.retrieval import engine as jeng
from rdm_tpu.sampling import DDIMSamplerConfig as JSampler
from rdm_tpu.sampling import ddim_retro_sample as j_retro_sample
from rdm_tpu.sampling import ddim_sample as j_ddim_sample
from rdm_tpu_torch import config as pc
from rdm_tpu_torch.models.rdm import RDM, make_denoise_fn
from rdm_tpu_torch.ops.schedules import DiffusionSchedule
from rdm_tpu_torch.pipeline import RARMPipeline, RDMPipeline
from rdm_tpu_torch.retrieval.database import DataPool
from rdm_tpu_torch.sampling import ddim_retro_sample, ddim_sample
from rdm_tpu_torch.utils.from_jax import clip_state_dict_from_jax
from test_torch_port_clip import CAPTIONS, _clip
from test_torch_port_rarm import AE_KW as RARM_AE_KW
from test_torch_port_rarm import PIPE as RARM_KW
from test_torch_port_rarm import _models as _rarm_models
from test_torch_port_rarm import _vq as _rarm_vq
from test_torch_port_slice import (AE_KW, GUIDANCE, RDM_KW, STEPS, UNET,
                                   _close, _models, _table)

SCHED = dict(timesteps=50, schedule="linear", linear_start=0.0015,
             linear_end=0.0195)
CAPTION = "a red car parked by the sea"


def _jax_draws(seed, shape, *, blends=0):
    """JAX ddim_sample's normal draws from PRNGKey(seed), NHWC -> NCHW, in
    the port's order: x_T, then with `blends` the pre-blend noise and the
    blend noise of the first `blends` steps (the last step blends none)."""
    rng, init_rng = jax.random.split(jax.random.PRNGKey(seed))
    draws = [jax.random.normal(init_rng, shape, jnp.float32)]
    if blends:
        rng, brng = jax.random.split(rng)
        draws.append(jax.random.normal(brng, shape, jnp.float32))
        for _ in range(blends):
            rng, _, mrng = jax.random.split(rng, 3)
            draws.append(jax.random.normal(mrng, shape, jnp.float32))
    return [torch.from_numpy(np.array(d)).permute(0, 3, 1, 2).contiguous()
            for d in draws]


def _feed(monkeypatch, draws):
    """Every torch.randn call that takes a generator returns the next of
    `draws` (shapes checked); returns the queue, empty once all are used."""
    real, queue = torch.randn, list(draws)

    def randn(*shape, generator=None, **kw):
        if generator is None:
            return real(*shape, **kw)
        want = queue.pop(0)
        assert tuple(want.shape) == tuple(shape[0])
        return want.to(kw.get("device", "cpu"))

    monkeypatch.setattr(torch, "randn", randn)
    return queue


def _mask(b):
    m = np.zeros((b, 8, 8, 1), np.float32)
    m[:, :, :4] = 1.0  # keep the left half
    return m


def test_ddim_mask_blend_matches_jax(monkeypatch):
    (jm, params, _, _), (cfg, sd, _, _) = _models(seed=30)
    b, shape = 2, (2, 8, 8, 3)
    rng = np.random.default_rng(31)
    neighbors = rng.standard_normal((b, 4, 24)).astype(np.float32)
    x0 = rng.standard_normal(shape).astype(np.float32)
    mask = _mask(b)
    want, _ = j_ddim_sample(
        lambda x, t, c: jm.apply(params, x, t, c), JSchedule.create(
            50, "linear", 0.0015, 0.0195),
        JSampler(num_steps=STEPS, guidance_scale=GUIDANCE, cfg_mode="shared"),
        shape, jnp.asarray(neighbors), jax.random.PRNGKey(5),
        uncond_context=jm.apply(params, b, 4, 0.0,
                                method=JRDM.uncond_context),
        mask=jnp.broadcast_to(mask, shape), x0=jnp.asarray(x0))
    model = RDM(cfg).eval()
    model.load_state_dict(sd)
    sampler = pc.DDIMSamplerConfig(num_steps=STEPS, guidance_scale=GUIDANCE,
                                   cfg_mode="shared")
    schedule = DiffusionSchedule.create(**SCHED)
    m = torch.from_numpy(mask).permute(0, 3, 1, 2)
    z0 = torch.from_numpy(x0).permute(0, 3, 1, 2)
    with pytest.raises(ValueError, match="both mask and x0"):
        ddim_sample(make_denoise_fn(model), schedule,
                    pc.DDIMSamplerConfig(num_steps=STEPS), (b, 3, 8, 8),
                    None, torch.Generator(), mask=m)
    queue = _feed(monkeypatch, _jax_draws(5, shape, blends=STEPS - 1))
    with torch.no_grad():
        got, _ = ddim_sample(
            make_denoise_fn(model), schedule, sampler, (b, 3, 8, 8),
            torch.from_numpy(neighbors), torch.Generator().manual_seed(0),
            uncond_context=model.uncond_context(b, 4, 0.0), mask=m, x0=z0)
    assert not queue
    _close(got.permute(0, 2, 3, 1).numpy(), want)


@pytest.mark.parametrize("cfg_mode", ["shared", "double"])
def test_ddim_retro_matches_jax(cfg_mode, monkeypatch):
    """12 steps, re-retrieval every 5: the context is replaced after steps
    5 and 10, from that step's pred_x0."""
    (jm, params, _, _), (cfg, sd, _, _) = _models(seed=32)
    b, shape, steps = 2, (2, 8, 8, 3), 12
    rng = np.random.default_rng(33)
    init = rng.standard_normal((b, 4, 24)).astype(np.float32)
    w = rng.standard_normal((3, 4 * 24)).astype(np.float32)

    def j_reembed(pred_x0):
        return jnp.tanh(pred_x0.mean(axis=(1, 2)) @ w).reshape(b, 4, 24) * 3

    calls = []

    def reembed(pred_x0):
        calls.append(pred_x0.shape)
        return torch.tanh(pred_x0.mean(dim=(2, 3)) @ torch.from_numpy(w)
                          ).reshape(b, 4, 24) * 3

    sampler = dict(num_steps=steps, guidance_scale=GUIDANCE,
                   cfg_mode=cfg_mode)
    want = j_retro_sample(
        lambda x, t, c: jm.apply(params, x, t, c), JSchedule.create(
            50, "linear", 0.0015, 0.0195), JSampler(**sampler), shape,
        jnp.asarray(init), jax.random.PRNGKey(6), reembed_fn=j_reembed,
        retro_every=5, uncond_context=jm.apply(
            params, b, 4, 0.0, method=JRDM.uncond_context))
    model = RDM(cfg).eval()
    model.load_state_dict(sd)
    queue = _feed(monkeypatch, _jax_draws(6, shape))
    with torch.no_grad():
        got = ddim_retro_sample(
            make_denoise_fn(model), DiffusionSchedule.create(**SCHED),
            pc.DDIMSamplerConfig(**sampler), (b, 3, 8, 8),
            torch.from_numpy(init), torch.Generator().manual_seed(0),
            reembed_fn=reembed, retro_every=5,
            uncond_context=model.uncond_context(b, 4, 0.0))
    assert not queue and calls == [(b, 3, 8, 8)] * 2
    _close(got.permute(0, 2, 3, 1).numpy(), want)


def _pipelines(seed, clip=True, pool=True):
    """(JAX RDMPipeline, port RDMPipeline) in f32 on the same seeded RDM,
    VQ, CLIP (its text tower takes the tokenizer's ids) and table."""
    (_, params, _, vq_params), (cfg, sd, ae, vq_sd) = _models(seed=seed)
    _, cvars, ccfg, _ = _clip(CAPTIONS, seed + 1)
    emb = _table(seed=seed + 2)
    jpipe = JRDMPipeline(
        JRDMConfig(unet=JUNetConfig(**UNET), **RDM_KW), params,
        JAEConfig(**AE_KW), vq_params,
        pool=jdb.DataPool(emb) if pool else None,
        clip_params=cvars if clip else None,
        clip_config=jclip.ClipConfig(**CAPTIONS), dtype=jnp.float32)
    pipe = RDMPipeline(
        cfg, sd, ae, vq_sd, pool=DataPool(emb) if pool else None,
        clip_params=clip_state_dict_from_jax(cvars, ccfg) if clip else None,
        clip_config=ccfg, dtype=torch.float32, device="cpu")
    return jpipe, pipe


def _same_images(got, want):
    assert got.shape == want.shape and got.dtype == np.uint8
    # uint8 truncation may flip a level where the pixels differ by less
    # than the float tolerance
    assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1


def test_caption_requests_match_jax(monkeypatch):
    jpipe, pipe = _pipelines(seed=40)
    want_q = jpipe.embed_caption(CAPTION, 2)
    got_q = pipe.embed_caption(CAPTION, 2)
    assert got_q.shape == (2, 24) and got_q.device.type == "cpu"
    np.testing.assert_allclose(got_q.numpy(), want_q,
                               atol=1e-3 * np.abs(want_q).max())
    kw = dict(steps=STEPS, guidance_scale=GUIDANCE, seed=3)
    want = jpipe.sample_with_caption(CAPTION, 2, **kw)["query_samples"]
    queue = _feed(monkeypatch, _jax_draws(3, (2, 8, 8, 3)))
    got = pipe.sample_with_caption(CAPTION, 2, **kw)["query_samples"]
    assert not queue
    _same_images(got, want)


@pytest.mark.parametrize("retrieve", [True, False])
def test_sample_inpaint_matches_jax(retrieve, monkeypatch):
    """With neighbors=None both retrieve by the images' own CLIP embedding;
    otherwise by the given neighbours. The port binds its VQ encoder at
    the first inpaint request."""
    jpipe, pipe = _pipelines(seed=50)
    rng = np.random.default_rng(51)
    images = rng.uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    neighbors = (None if retrieve else
                 rng.standard_normal((2, 4, 24)).astype(np.float32))
    kw = dict(steps=STEPS, guidance_scale=GUIDANCE, seed=4)
    want = jpipe.sample_inpaint(images, _mask(2), neighbors,
                                **kw)["inpaint_samples"]
    assert pipe._encoder is None
    queue = _feed(monkeypatch, _jax_draws(4, (2, 8, 8, 3),
                                          blends=STEPS - 1))
    got = pipe.sample_inpaint(images, _mask(2), neighbors,
                              **kw)["inpaint_samples"]
    assert not queue and pipe._encoder is not None
    _same_images(got, want)


def test_sample_retro_adaptive_matches_jax(monkeypatch):
    jpipe, pipe = _pipelines(seed=60)
    kw = dict(steps=12, retro_every=5, guidance_scale=GUIDANCE, seed=7)
    want = jpipe.sample_retro_adaptive(2, **kw)["retro_adaptive_samples"]
    queue = _feed(monkeypatch, _jax_draws(7, (2, 8, 8, 3)))
    searches = []
    real = pipe.clip.encode_image
    monkeypatch.setattr(pipe.clip, "encode_image",
                        lambda x: searches.append(x.shape) or real(x))
    got = pipe.sample_retro_adaptive(2, **kw)["retro_adaptive_samples"]
    assert not queue and searches == [(2, 3, 224, 224)] * 2
    _same_images(got, want)


def test_rarm_embed_caption_matches_jax():
    _, params, cfg, model = _rarm_models(RARM_KW, seed=70)
    _, vq_params, ae, vq_sd = _rarm_vq(seed=71)
    _, cvars, ccfg, _ = _clip(CAPTIONS, 72)
    jpipe = JRARMPipeline(JRARMConfig(**RARM_KW), params,
                          JAEConfig(**RARM_AE_KW), vq_params,
                          clip_params=cvars,
                          clip_config=jclip.ClipConfig(**CAPTIONS),
                          dtype=jnp.float32)
    csd = clip_state_dict_from_jax(cvars, ccfg)
    pipe = RARMPipeline(cfg, model.state_dict(), ae, vq_sd, clip_params=csd,
                        clip_config=ccfg, dtype=torch.float32, device="cpu")
    want = jpipe.embed_caption(CAPTION, 3)
    got = pipe.embed_caption(CAPTION, 3)
    np.testing.assert_allclose(got.numpy(), want,
                               atol=1e-3 * np.abs(want).max())
    (_, _, _, _), (rcfg, rsd, rae, rvq) = _models(seed=73)
    rdm = RDMPipeline(rcfg, rsd, rae, rvq, clip_params=csd, clip_config=ccfg,
                      dtype=torch.float32, device="cpu")
    assert torch.equal(rdm.embed_caption(CAPTION, 3), got)


def _message(fn):
    with pytest.raises(ValueError) as err:
        fn()
    return str(err.value)


def test_raises_as_jax_without_clip_or_database():
    no_clip = _pipelines(seed=80, clip=False)
    no_pool = _pipelines(seed=80, pool=False)
    images = np.zeros((1, 16, 16, 3), np.float32)
    calls = [
        (no_clip, lambda p: p.embed_caption(CAPTION, 1)),
        (no_clip, lambda p: p.sample_with_caption(CAPTION, 1, steps=2)),
        (no_clip, lambda p: p.sample_inpaint(images, _mask(1), steps=2)),
        (no_clip, lambda p: p.sample_retro_adaptive(1, steps=2)),
        (no_pool, lambda p: p.sample_inpaint(images, _mask(1), steps=2)),
        (no_pool, lambda p: p.sample_retro_adaptive(1, steps=2)),
    ]
    for (jpipe, pipe), call in calls:
        assert _message(lambda: call(pipe)) == _message(lambda: call(jpipe))
    _, params, cfg, model = _rarm_models(RARM_KW, seed=81)
    _, vq_params, ae, vq_sd = _rarm_vq(seed=82)
    jrarm = JRARMPipeline(JRARMConfig(**RARM_KW), params,
                          JAEConfig(**RARM_AE_KW), vq_params,
                          dtype=jnp.float32)
    rarm = RARMPipeline(cfg, model.state_dict(), ae, vq_sd,
                        dtype=torch.float32, device="cpu")
    assert (_message(lambda: rarm.embed_caption(CAPTION, 1))
            == _message(lambda: jrarm.embed_caption(CAPTION, 1)))


def test_more_neighbours_than_rows_raises():
    """k > N: the port raises where the JAX engine returns padding ids
    clamped to N - 1 (ROADMAP §3)."""
    emb = _table(seed=90)[:3]
    q = np.random.default_rng(91).standard_normal((2, 24)).astype(
        np.float32)
    found = jeng.RetrievalEngine(jdb.DataPool(emb)).search(jnp.asarray(q),
                                                          k=4)
    assert np.asarray(found["nns"]).max() == 2
    (_, _, _, _), (cfg, sd, ae, vq_sd) = _models(seed=92)
    pipe = RDMPipeline(cfg, sd, ae, vq_sd, pool=DataPool(emb),
                       dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="k=4"):
        pipe.sample_with_query(q, k_nn=4, steps=2)
