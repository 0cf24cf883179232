"""RARM training in the port against the JAX package, on the CPU.

A tiny RARM (tests/test_trainer.py:123-125's config at depth 2), weights
carried from a seeded JAX tree by `rarm_state_dict_from_jax`, f32 on both
sides:

- `RARM.training_loss` against JAX's, with no mask-token augmentation and
  with JAX's bernoulli mask injected (`mask=`): loss and ppl within 1e-4
  relative.
- One step's gradients (`compute_rarm_grads`) against jax.grad of the same
  loss: each leaf within atol 1e-3 x the largest |g| of the tree, rtol
  1e-3 (tests/test_torch_convert.py's scale rule).
- Three `make_rarm_train_step` steps (p_mask_max 0.25, JAX's draws
  injected) from one JAX `TrainState` carried over by
  `train_state_from_jax`: loss and grad_norm per step within 1e-4
  relative; params, EMA, mu and nu within 1e-3 x each tree's largest
  value (Adam turns a near-zero gradient's rounding noise into a step of
  up to lr, so the rule is the tree's scale, not each element's).
- `RARMTrainer` on `device="cpu"` over a tiny VQ: `fit` for four steps
  with a checkpoint and validation mid-way, metrics.jsonl, resume equal
  to the saved state, `validate` on the EMA weights with fixed draws, and
  the options the JAX trainer lacks or the port does not have raising.
- (`-m slow`, ~2 min) at depth 18 and S = 256, the distance of a bf16
  step's gradients from an f32 step's, the port's within 30% of JAX's.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rdm_tpu.models import rarm as jrarm
from rdm_tpu.training.optim import lambda_linear_schedule as j_schedule
from rdm_tpu.training.train_state import init_train_state as j_init
from rdm_tpu.training.train_state import make_rarm_train_step as j_step
from rdm_tpu_torch import config as pc
from rdm_tpu_torch.models.autoencoder import VQModel
from rdm_tpu_torch.models.rarm import RARM
from rdm_tpu_torch.training.optim import AdamW, lambda_linear_schedule
from rdm_tpu_torch.training.train_state import (compute_rarm_grads,
                                                init_train_state,
                                                make_rarm_train_step)
from rdm_tpu_torch.training.trainer import RARMTrainer, TrainerConfig
from rdm_tpu_torch.utils.from_jax import (rarm_state_dict_from_jax,
                                          train_state_from_jax)
from test_torch_port_unet import seeded_params

TINY = dict(vocab_size=18, out_vocab=16, heads=2, head_dim=8, depth=2,
            context_dim=16, seq_len=64, sos_token=17, mask_token=16,
            code_side=8)
B, S_CTX = 2, 4
LR, P_MASK_MAX = 1e-3, 0.25


def _models(seed=0):
    jcfg, cfg = jrarm.RARMConfig(**TINY), pc.RARMConfig(**TINY)
    jm = jrarm.RARM(jcfg)
    params = seeded_params(jax.eval_shape(
        jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32),
        jnp.zeros((1, S_CTX, TINY["context_dim"]))), seed)
    model = RARM(cfg)
    model.load_state_dict(rarm_state_dict_from_jax(params, cfg))
    return jm, params, cfg, model


def _batch(seed):
    rng = np.random.default_rng(seed)
    z = rng.integers(0, TINY["out_vocab"], (B, TINY["seq_len"]))
    nns = rng.standard_normal((B, S_CTX, TINY["context_dim"]))
    return z.astype(np.int32), nns.astype(np.float32)


def _jax_mask(rng, p_mask):
    return np.array(jax.random.bernoulli(
        rng, p_mask, (B, S_CTX, TINY["context_dim"])))


def _port(z, nns):
    return torch.from_numpy(z).long(), torch.from_numpy(nns)


@pytest.mark.parametrize("p_mask", [None, 0.3])
def test_training_loss_matches_jax(p_mask):
    jm, params, _, model = _models()
    z, nns = _batch(1)
    rng = jax.random.PRNGKey(5)
    jloss, jmet = jm.apply(params, jnp.asarray(z), jnp.asarray(nns), rng,
                           p_mask, method=jrarm.RARM.training_loss)
    mask = None
    if p_mask is not None:
        mask = torch.from_numpy(_jax_mask(rng, p_mask))
        assert mask.any() and not mask.all()
    with torch.no_grad():
        loss, met = model.training_loss(*_port(z, nns), mask=mask)
    assert sorted(met) == sorted(jmet) == ["loss", "ppl"]
    for k in met:
        np.testing.assert_allclose(met[k].item(), float(jmet[k]),
                                   rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-4)


def _assert_tree(port: dict, want: dict, rel: float, what: str):
    assert sorted(port) == sorted(want), what
    scale = max(w.float().abs().max().item() for w in want.values())
    for n, w in want.items():
        got = port[n]
        got = torch.zeros_like(w) if got is None else got
        torch.testing.assert_close(got.float(), w.float(), rtol=rel,
                                   atol=rel * scale,
                                   msg=lambda m: f"{what} {n}: {m}")


def test_train_step_gradients_match_jax():
    jm, params, cfg, model = _models()
    z, nns = _batch(2)
    rng = jax.random.PRNGKey(7)

    def loss_fn(p):
        return jm.apply(p, jnp.asarray(z), jnp.asarray(nns), rng, 0.2,
                        method=jrarm.RARM.training_loss)

    (jloss, _), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params)
    loss, _, grads = compute_rarm_grads(
        model, *_port(z, nns), mask=torch.from_numpy(_jax_mask(rng, 0.2)))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4)
    assert all(g is not None for g in grads.values())
    _assert_tree(grads, rarm_state_dict_from_jax(jgrads, cfg), 1e-3, "grad")


def _carried():
    jm, params, cfg, _ = _models()
    jtx = optax.adamw(j_schedule(LR, warm_up_steps=2), b1=0.9, b2=0.95,
                      weight_decay=1e-2)
    jstate = j_init(params, jtx)
    tx = AdamW(lambda_linear_schedule(LR, warm_up_steps=2), b1=0.9, b2=0.95,
               weight_decay=1e-2)
    state = init_train_state(RARM(cfg), tx)
    state.load_state_dict(train_state_from_jax(jstate, cfg))
    return jm, cfg, jtx, jstate, tx, state


def test_three_rarm_train_steps_match_jax():
    jm, cfg, jtx, jstate, tx, state = _carried()
    assert torch.equal(state.model.proj_in.weight,
                       state.ema.params["proj_in.weight"])
    jstep = j_step(jm, jtx, ema_decay=0.99, p_mask_max=P_MASK_MAX)
    step = make_rarm_train_step(tx, ema_decay=0.99, p_mask_max=P_MASK_MAX)
    key = jax.random.PRNGKey(3)
    n = 3
    for i in range(n):
        z, nns = _batch(10 + i)
        # the JAX step's draws: rng = fold_in(key, step); p_mask from
        # fold_in(rng, 2), the mask from fold_in(rng, 3)
        rng = jax.random.fold_in(key, i)
        p_mask = jax.random.uniform(jax.random.fold_in(rng, 2),
                                    maxval=P_MASK_MAX)
        mask = _jax_mask(jax.random.fold_in(rng, 3), p_mask)
        jstate, jmet = jstep(jstate, jnp.asarray(z), jnp.asarray(nns), key)
        state, met = step(state, *_port(z, nns), 0,
                          mask=torch.from_numpy(mask))
        for k in ("loss", "ppl", "grad_norm"):
            np.testing.assert_allclose(float(met[k]), float(jmet[k]),
                                       rtol=1e-4, err_msg=f"{k} step {i}")
    assert state.step == int(jstate.step) == n
    want = train_state_from_jax(jstate, cfg)
    got = state.state_dict()
    assert got["opt_state"]["count"] == want["opt_state"]["count"] == n
    assert got["ema"]["count"] == want["ema"]["count"] == n
    for what, mine, ref in [
            ("params", got["params"], want["params"]),
            ("ema", got["ema"]["params"], want["ema"]["params"]),
            ("mu", got["opt_state"]["mu"], want["opt_state"]["mu"]),
            ("nu", got["opt_state"]["nu"], want["opt_state"]["nu"])]:
        _assert_tree(mine, ref, 1e-3, what)


def test_rarm_step_draws_p_mask_only_when_asked():
    _, _, _, _, tx, state = _carried()
    z, nns = _port(*_batch(4))
    seen = []
    real = state.model.training_loss
    state.model.training_loss = lambda *a, **k: seen.append(a[3]) or real(
        *a, **k)
    make_rarm_train_step(tx, ema_decay=0.99)(state, z, nns, 0)
    make_rarm_train_step(tx, ema_decay=0.99, p_mask_max=P_MASK_MAX)(
        state, z, nns, 0)
    assert seen[0] is None and 0.0 <= float(seen[1]) < P_MASK_MAX
    with pytest.raises(ValueError, match="'fsdp' needs a mesh"):
        make_rarm_train_step(tx, param_sharding="fsdp")


# --------------------------------------------------------------- trainer

AE = dict(ch=8, ch_mult=(1, 2, 4), num_res_blocks=1, resolution=16,
          z_channels=4, embed_dim=4, n_embed=16)
# a 16 x 16 image -> a 4 x 4 grid of codes of the 16-entry codebook
TRAINER_RARM = dict(TINY, seq_len=16, code_side=4)


def _trainer(tmp_path, max_steps, name="run", **tkw):
    fs = pc.AutoencoderConfig(**AE)
    torch.manual_seed(0)
    fs_sd = VQModel(fs).state_dict()
    tcfg = TrainerConfig(**{**dict(
        logdir=str(tmp_path / name), base_lr=1e-3, max_steps=max_steps,
        log_every=1, ckpt_every=2, image_log_every=0, warm_up_steps=1,
        max_ckpts=2, monitor="val/loss_ema"), **tkw})
    cfg = pc.RARMConfig(**dict(TRAINER_RARM, p_mask_max=P_MASK_MAX))
    return RARMTrainer(cfg, tcfg, fs, fs_sd, batch_size=2,
                       device="cpu"), tcfg


def _loader(n=3, seed=0):
    rng = np.random.default_rng(seed)
    return [{"image": rng.uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32),
             "nn_embeddings": rng.standard_normal((2, 1, 4, 16)).astype(
                 np.float32)} for _ in range(n)]


def test_rarm_trainer_fit_checkpoint_resume_validate(tmp_path):
    trainer, tcfg = _trainer(tmp_path, max_steps=4)
    assert trainer.lr == pytest.approx(2e-3)  # accum 1 x 1 device x bs 2
    z, nns = trainer.prepare_batch(_loader(1)[0])
    assert z.shape == (2, 16) and z.dtype == torch.int64
    assert int(z.max()) < AE["n_embed"] and nns.shape == (2, 4, 16)
    loader = _loader()
    state = trainer.fit(loader, val_loader=_loader(1, seed=9))
    assert state.step == 4
    rows = [json.loads(line) for line in
            open(os.path.join(tcfg.logdir, "metrics.jsonl"))]
    train_rows = [r for r in rows if "loss" in r]
    assert [r["step"] for r in train_rows] == [0, 1, 2, 3]
    assert sorted(train_rows[0]) == sorted(
        ["loss", "ppl", "grad_norm", "step", "samples_seen", "wall_s",
         "samples_per_sec", "lr"])
    assert all(np.isfinite(r["loss"]) for r in train_rows)
    val_rows = [r for r in rows if "val/loss_ema" in r]
    assert len(val_rows) == 1 and np.isfinite(val_rows[0]["val/loss_ema"])
    assert trainer.ckpt.steps() == [3, 4] and trainer.ckpt.best_step() == 3
    assert all(p.grad is not None for p in state.model.parameters())

    again, _ = _trainer(tmp_path, max_steps=6)
    resumed = again.resume_or_init()
    want, got = state.state_dict(), resumed.state_dict()
    assert got["step"] == 4 and got["ema"]["count"] == 4
    assert got["opt_state"]["count"] == want["opt_state"]["count"] == 4
    for part, a, b in [("params", want["params"], got["params"]),
                       ("ema", want["ema"]["params"], got["ema"]["params"]),
                       ("mu", want["opt_state"]["mu"],
                        got["opt_state"]["mu"]),
                       ("nu", want["opt_state"]["nu"],
                        got["opt_state"]["nu"])]:
        for key, t in a.items():
            assert torch.equal(b[key], t), f"{part} {key}"
    final = again.fit(loader, state=resumed)
    assert final.step == 6 and again.ckpt.latest_step() == 6

    val = _loader(1, seed=5)
    a = again.validate(final, val)
    assert list(a) == ["val/loss_ema"] and a == again.validate(final, val)
    with torch.no_grad():  # the live weights do not enter it
        for p in final.model.parameters():
            p.add_(1.0)
    assert a == again.validate(final, val)


def test_rarm_trainer_salvages_a_checkpoint_on_error(tmp_path):
    trainer, _ = _trainer(tmp_path, max_steps=10)

    def broken():
        yield from _loader(2)
        raise KeyboardInterrupt

    with pytest.raises(KeyboardInterrupt):
        trainer.fit(broken())
    assert trainer.ckpt.latest_step() == 2


def test_rarm_trainer_unported_options_raise(tmp_path):
    with pytest.raises(NotImplementedError, match="diagnostics"):
        _trainer(tmp_path, 1, image_log_every=5)
    with pytest.raises(ValueError, match="'fsdp' needs a mesh"):
        _trainer(tmp_path, 1, param_sharding="fsdp")


@pytest.mark.slow
def test_bf16_gradient_error_tracks_jax():
    """The bf16 training path's distance from the f32 one, port and JAX
    alike, at depth 18 and S = 256 (C = 128, the full vocabulary): the
    relative L2 of all gradients between a bf16 and an f32 step on the
    same weights and batch. The residual stream rounds to bf16 in every
    layer, so neither is small; the port's must sit within 30% of JAX's.
    (~2 min on the CPU, so out of tier-1; it sets the scale of
    chip_smoke.py's RARM_TRAIN_GRAD_TOL.)"""
    kw = dict(heads=2, head_dim=64, depth=18, context_dim=64)
    jcfg, cfg = jrarm.RARMConfig(**kw), pc.RARMConfig(**kw)
    params = seeded_params(jax.eval_shape(
        jrarm.RARM(jcfg).init, jax.random.PRNGKey(0),
        jnp.zeros((1, 4), jnp.int32), jnp.zeros((1, S_CTX, 64))), 12)
    rng = np.random.default_rng(3)
    z = rng.integers(0, cfg.out_vocab, (B, cfg.seq_len)).astype(np.int32)
    nns = rng.standard_normal((B, S_CTX, 64)).astype(np.float32)
    jax_g, port_g = {}, {}
    for jdt, dt in ((jnp.float32, torch.float32),
                    (jnp.bfloat16, torch.bfloat16)):
        jm = jrarm.RARM(jcfg, dtype=jdt)
        g = jax.jit(jax.grad(lambda p: jm.apply(
            p, jnp.asarray(z), jnp.asarray(nns), None, None,
            method=jrarm.RARM.training_loss)[0]))(params)
        jax_g[dt] = np.concatenate([np.asarray(x, np.float32).ravel()
                                    for x in jax.tree.leaves(g)])
        model = RARM(cfg, dtype=dt)
        model.load_state_dict(rarm_state_dict_from_jax(params, cfg))
        _, _, g = compute_rarm_grads(model, *_port(z, nns))
        port_g[dt] = torch.cat([t.float().reshape(-1) for t in g.values()])
    j = np.linalg.norm(jax_g[torch.bfloat16] - jax_g[torch.float32]) \
        / np.linalg.norm(jax_g[torch.float32])
    p = ((port_g[torch.bfloat16] - port_g[torch.float32]).norm()
         / port_g[torch.float32].norm()).item()
    assert 1e-3 < j < 5e-2 and abs(p - j) <= 0.3 * j, (p, j)
