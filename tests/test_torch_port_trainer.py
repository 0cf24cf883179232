"""rdm_tpu_torch VQ encoder and RDMTrainer, on the CPU.

- The VQ encoder side against the JAX `VQModel` at a tiny
  `AutoencoderConfig` with attention in the encoder, on weights carried by
  `utils.from_jax.vq_state_dict_from_jax`: `encode_prequant` (f32: atol
  1e-4 x max|ref|, rtol 1e-4), `encode`'s indices (equal), its commitment
  loss (rtol 1e-4).
- `RDMTrainer.fit` for four steps on `device="cpu"`: the metrics.jsonl
  keys of the JAX trainer, a checkpoint mid-way and at the end, the
  monitored validation metric in best_steps.json, a second trainer that
  resumes equal to the first one's final state and continues.
- SpatialTransformer's routes: the fused kernels only in eval mode, the
  unfused blocks in train mode, RDM_TPU_FUSED_BLOCK_TRAIN=1 refused.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rdm_tpu.models.autoencoder import AutoencoderConfig as JAEConfig
from rdm_tpu.models.autoencoder import VQModel as JVQModel
from rdm_tpu_torch import config as pc
from rdm_tpu_torch.models import layers
from rdm_tpu_torch.models.autoencoder import VQModel
from rdm_tpu_torch.training.trainer import RDMTrainer, TrainerConfig
from rdm_tpu_torch.utils.from_jax import vq_state_dict_from_jax
from tests.test_torch_port_unet import seeded_params

AE = dict(ch=8, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,),
          resolution=16, z_channels=4, embed_dim=4, n_embed=16)


def _vq_pair():
    jm = JVQModel(JAEConfig(**AE))
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 16, 16, 3)))
    params = seeded_params(shapes, 3)
    cfg = pc.AutoencoderConfig(**AE)
    port = VQModel(cfg).eval()
    port.load_state_dict(vq_state_dict_from_jax(params, cfg))
    return jm, params, port


def test_vq_encoder_matches_jax():
    jm, params, port = _vq_pair()
    x = np.random.default_rng(4).uniform(-1, 1, (2, 16, 16, 3)).astype(
        np.float32)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    want = np.asarray(jm.apply(params, jnp.asarray(x),
                               method=JVQModel.encode_prequant))
    with torch.no_grad():
        got = port.encode_prequant(xt).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())
    jz, jcommit, jidx = jm.apply(params, jnp.asarray(x),
                                 method=JVQModel.encode)
    z, commit, idx = port.encode(xt)
    assert torch.equal(idx, torch.from_numpy(np.array(jidx)).long())
    np.testing.assert_allclose(z.detach().permute(0, 2, 3, 1).numpy(),
                               np.asarray(jz), rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())
    np.testing.assert_allclose(commit.item(), float(jcommit), rtol=1e-4)


def test_vq_encode_straight_through_gradient():
    _, _, port = _vq_pair()
    x = torch.rand(1, 3, 16, 16, requires_grad=True)
    z, commit, _ = port.encode(x)
    (z.sum() + commit).backward()
    assert x.grad is not None and torch.isfinite(x.grad).all()
    assert x.grad.abs().sum() > 0


# --------------------------------------------------------------- trainer

def _trainer(tmp_path, max_steps, name="run"):
    unet = pc.UNetConfig(in_channels=4, out_channels=4, model_channels=8,
                         num_res_blocks=1, attention_resolutions=(1,),
                         channel_mult=(1,), num_head_channels=4,
                         context_dim=16)
    cfg = pc.RDMConfig(unet=unet, image_size=4, channels=4, timesteps=20,
                       context_dim=16, k_nn=2, p_uncond=0.5)
    fs = pc.AutoencoderConfig(ch=8, ch_mult=(1, 2, 4), num_res_blocks=1,
                              resolution=16, z_channels=4, embed_dim=4,
                              n_embed=16)
    torch.manual_seed(0)
    fs_sd = VQModel(fs).state_dict()
    tcfg = TrainerConfig(logdir=str(tmp_path / name), base_lr=1e-3,
                         max_steps=max_steps, log_every=1, ckpt_every=2,
                         image_log_every=0, warm_up_steps=1, max_ckpts=2)
    return RDMTrainer(cfg, tcfg, fs, fs_sd, batch_size=2, device="cpu"), tcfg


def _loader(n=3, seed=0):
    rng = np.random.default_rng(seed)
    return [{"image": rng.uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32),
             "nn_embeddings": rng.standard_normal((2, 1, 2, 16)).astype(
                 np.float32)} for _ in range(n)]


def test_fit_checkpoint_resume_validate(tmp_path):
    trainer, tcfg = _trainer(tmp_path, max_steps=4)
    loader = _loader()
    state = trainer.fit(loader, val_loader=_loader(1, seed=9))
    assert state.step == 4
    rows = [json.loads(line) for line in
            open(os.path.join(tcfg.logdir, "metrics.jsonl"))]
    train_rows = [r for r in rows if "loss" in r]
    assert [r["step"] for r in train_rows] == [0, 1, 2, 3]
    # the JAX trainer's keys (no hbm_gb off the card)
    assert sorted(train_rows[0]) == sorted(
        ["loss", "loss_simple", "grad_norm", "step", "samples_seen",
         "wall_s", "samples_per_sec", "lr"])
    assert all(np.isfinite(r["loss"]) for r in train_rows)
    val_rows = [r for r in rows if "val/loss_simple_ema" in r]
    assert len(val_rows) == 1 and np.isfinite(
        val_rows[0]["val/loss_simple_ema"])
    # loop step 2 saved state step 3; the end saved 4
    assert trainer.ckpt.steps() == [3, 4]
    best = json.load(open(os.path.join(tcfg.logdir, "checkpoints",
                                       "best_steps.json")))
    assert list(best) == ["3"] and trainer.ckpt.best_step() == 3

    again, _ = _trainer(tmp_path, max_steps=6)
    resumed = again.resume_or_init()
    assert resumed.step == 4
    want, got = state.state_dict(), resumed.state_dict()
    for key in want["params"]:
        assert torch.equal(got["params"][key], want["params"][key]), key
    for part in ("mu", "nu"):
        for key, t in want["opt_state"][part].items():
            assert torch.equal(got["opt_state"][part][key], t), key
    for key, t in want["ema"]["params"].items():
        assert torch.equal(got["ema"]["params"][key], t), key
    assert got["opt_state"]["count"] == want["opt_state"]["count"] == 4
    assert got["ema"]["count"] == 4
    final = again.fit(loader, state=resumed)
    assert final.step == 6 and again.ckpt.latest_step() == 6


def test_validate_uses_ema_weights_and_fixed_draws(tmp_path):
    trainer, _ = _trainer(tmp_path, max_steps=2)
    state = trainer.fit(_loader(2))
    val = _loader(1, seed=5)
    a = trainer.validate(state, val)
    assert a == trainer.validate(state, val)  # fixed draws
    live = {n: p.detach().clone() for n, p in
            state.model.named_parameters()}
    with torch.no_grad():  # moving the live weights leaves it unchanged
        for p in state.model.parameters():
            p.add_(1.0)
    assert a == trainer.validate(state, val)
    with torch.no_grad():
        for n, p in state.model.named_parameters():
            p.copy_(live[n])


def test_unported_options_raise(tmp_path):
    cfg = pc.RDMConfig()
    fs = pc.AutoencoderConfig()
    with pytest.raises(NotImplementedError, match="diagnostics"):
        RDMTrainer(cfg, TrainerConfig(logdir=str(tmp_path)), fs, {},
                   device="cpu")


# ---------------------------------------------- SpatialTransformer routes

def test_spatial_transformer_routes(monkeypatch):
    st = layers.SpatialTransformer(32, 8, heads=1, head_dim=32)
    x, ctx = torch.randn(1, 32, 4, 4), torch.randn(1, 2, 8)
    calls = []
    monkeypatch.setattr(layers.TransformerBlock, "forward_fused",
                        lambda self, x, c: calls.append("fused") or x)
    st.eval()
    st(x, ctx)
    assert calls == ["fused"]
    st.train()
    y = st(x, ctx)  # unfused, differentiable
    assert calls == ["fused"] and y.requires_grad
    monkeypatch.setenv("RDM_TPU_FUSED_BLOCK_TRAIN", "1")
    with pytest.raises(NotImplementedError, match="fused_transformer_block_ad"):
        st(x, ctx)
    st.eval()
    st(x, ctx)  # the variable only concerns training
    assert calls == ["fused", "fused"]
