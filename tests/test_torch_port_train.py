"""rdm_tpu_torch training pieces against the JAX package, on the CPU.

- AdamW and the two schedules against optax / `rdm_tpu.training.optim`
  (mu_dtype None and bf16, grad_clip, accumulate 2): five steps on
  identical numpy gradients; f32 on both sides, rtol 2e-6 (the same ops,
  a few f32 roundings apart; a bf16 first moment one bf16 rounding, see
  the test).
- The EMA against `ema_update` (rtol 1e-6).
- `RDM.training_loss` against the JAX `RDM.training_loss` on the JAX
  draws (p_uncond > 0, learn_logvar, original_elbo_weight > 0,
  retro_noise), f32: rtol 1e-5.
- One `make_train_step` step's gradients against JAX's at
  tests/test_training.py:21's tiny config (remat off), from one state
  carried across by `utils.from_jax.train_state_from_jax`, and three
  steps' parameters, moments, EMA and metrics.

Tolerances of the train-step checks: the gradients are f32 sums in
another order (atol 1e-5 x the largest |g| of any leaf). Adam divides each moment by
the root of its own square, so a gradient element near zero, whose
rounding noise is of its own size, turns into a step of up to +-lr in
either direction: after n steps a parameter may sit up to 2 n lr from
JAX's. The three-step check therefore holds every element within 2 n lr
and all but 1% of those whose first gradient is above 1e-3 of the
largest within 1e-5; the time embedding's gradients, ~1e-8 at this size,
are all noise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rdm_tpu.models.rdm import RDM as JRDM
from rdm_tpu.models.rdm import RDMConfig as JRDMConfig
from rdm_tpu.models.unet import UNetConfig as JUNetConfig
from rdm_tpu.ops.schedules import DiffusionSchedule as JSchedule
from rdm_tpu.training import ema as jema
from rdm_tpu.training import optim as joptim
from rdm_tpu.training.train_state import init_train_state as j_init
from rdm_tpu.training.train_state import make_train_step as j_make_step
from rdm_tpu_torch import config as pc
from rdm_tpu_torch.models.rdm import RDM
from rdm_tpu_torch.ops.schedules import DiffusionSchedule
from rdm_tpu_torch.training import ema, optim
from rdm_tpu_torch.training.train_state import (compute_grads,
                                                init_train_state,
                                                make_train_step)
from rdm_tpu_torch.utils.from_jax import (rdm_state_dict_from_jax,
                                          train_state_from_jax)
from tests.test_torch_port_unet import seeded_params

# ------------------------------------------------------------- optimizer

SHAPES = {"a": (3, 4), "b": (5,), "c": (2, 2, 3)}


def _grads(step: int, scale: float = 1.0):
    rng = np.random.default_rng(100 + step)
    return {n: (scale * rng.standard_normal(s)).astype(np.float32)
            for n, s in SHAPES.items()}


@pytest.mark.parametrize("name", ["lambda_linear", "lambda_warmup_cosine"])
def test_schedules_match(name):
    kw = {"warm_up_steps": 10}
    if name == "lambda_warmup_cosine":
        kw["cycle_length"] = 50
    mine = optim.SCHEDULES[name](3e-4, **kw)
    ref = joptim.SCHEDULES[name](3e-4, **kw)
    for step in (0, 1, 5, 9, 10, 11, 40, 60, 10_000):
        np.testing.assert_allclose(mine(step), float(ref(jnp.int32(step))),
                                   rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("opts", [
    {}, {"mu_dtype": "bfloat16"}, {"grad_clip": 0.5},
    {"accumulate_steps": 2}, {"accumulate_steps": 2, "grad_clip": 10.0,
                              "mu_dtype": "bfloat16"}])
def test_adamw_matches_optax(opts):
    rng = np.random.default_rng(0)
    p0 = {n: rng.standard_normal(s).astype(np.float32)
          for n, s in SHAPES.items()}
    jtx = joptim.make_optimizer(1e-2, warm_up_steps=2, **opts)
    jp = {n: jnp.asarray(v) for n, v in p0.items()}
    jst = jtx.init(jp)
    tx = optim.make_optimizer(1e-2, warm_up_steps=2, **opts)
    tp = {n: torch.from_numpy(v.copy()) for n, v in p0.items()}
    st = tx.init(tp)
    # A bf16 first moment may land one bf16 rounding (2^-8 relative) from
    # optax's: eager optax rounds b1 * mu to bf16, while XLA fuses that
    # product in f32 inside MultiSteps' compiled cond. Each step then
    # moves a parameter by up to lr x 2^-8 more or less.
    bf16 = opts.get("mu_dtype") == "bfloat16"
    atol, mu_rtol = (5 * 1e-2 * 2 ** -8, 2 ** -7) if bf16 else (1e-7, 1e-5)
    for step in range(5):
        g = _grads(step)
        upd, jst = jtx.update({n: jnp.asarray(v) for n, v in g.items()},
                              jst, jp)
        jp = optax.apply_updates(jp, upd)
        tx.step(tp, {n: torch.from_numpy(v) for n, v in g.items()}, st)
        for n in SHAPES:
            np.testing.assert_allclose(tp[n].numpy(), np.asarray(jp[n]),
                                       rtol=2e-6, atol=atol, err_msg=n)
    adam = [s for s in jax.tree.leaves(
        jst, is_leaf=lambda x: type(x).__name__ == "ScaleByAdamState")
        if type(s).__name__ == "ScaleByAdamState"][0]
    assert st.count == int(adam.count)
    for n in SHAPES:
        assert st.mu[n].dtype == (torch.bfloat16 if opts.get("mu_dtype")
                                  else torch.float32)
        want = np.asarray(adam.mu[n], np.float32)
        np.testing.assert_allclose(st.mu[n].float().numpy(), want,
                                   rtol=mu_rtol,
                                   atol=mu_rtol * np.abs(want).max())
        np.testing.assert_allclose(st.nu[n].numpy(), np.asarray(adam.nu[n]),
                                   rtol=2e-6, atol=1e-9)


def test_ema_matches():
    rng = np.random.default_rng(1)
    p = {n: rng.standard_normal(s).astype(np.float32)
         for n, s in SHAPES.items()}
    jst = jema.ema_init({n: jnp.asarray(v) for n, v in p.items()})
    st = ema.ema_init({n: torch.from_numpy(v) for n, v in p.items()})
    for n in SHAPES:  # a copy, never the live tensor
        assert st.params[n].data_ptr() != 0
    for step in range(4):
        new = _grads(step)
        jst = jema.ema_update(jst, {n: jnp.asarray(v)
                                    for n, v in new.items()}, decay=0.99)
        ema.ema_update(st, {n: torch.from_numpy(v) for n, v in new.items()},
                       decay=0.99)
    assert st.count == int(jst.count)
    for n in SHAPES:
        np.testing.assert_allclose(st.params[n].numpy(),
                                   np.asarray(jst.params[n]), rtol=1e-6,
                                   atol=1e-7)


def test_ema_shadow_never_aliases():
    w = torch.nn.Parameter(torch.ones(3))
    st = ema.ema_init({"w": w})
    with torch.no_grad():
        w.add_(1.0)
    assert torch.equal(st.params["w"], torch.ones(3))


# ------------------------------------------------------------------ loss

def _configs(**kw):
    unet = dict(in_channels=2, out_channels=2, model_channels=8,
                num_res_blocks=1, attention_resolutions=(1,),
                channel_mult=(1,), num_head_channels=4, context_dim=8)
    rdm = dict(image_size=4, channels=2, timesteps=20, context_dim=8,
               k_nn=2, **kw)
    return (JRDMConfig(unet=JUNetConfig(**unet), **rdm),
            pc.RDMConfig(unet=pc.UNetConfig(**unet), **rdm))


def _jax_model(jcfg, seed=0):
    jm = JRDM(jcfg)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((2, 4, 4, 2)), jnp.asarray([0, 1]),
                            jnp.zeros((2, 2, 8)))
    return jm, seeded_params(shapes, seed)


def _jax_draws(jcfg, rng, b, ctx_len):
    """The draws JAX `RDM.training_loss` makes from rng, port layout."""
    t_rng, noise_rng, drop_rng, retro_rng = jax.random.split(rng, 4)
    t = jax.random.randint(t_rng, (b,), 0, jcfg.timesteps)
    noise = jax.random.normal(noise_rng, (b, 4, 4, 2), dtype=jnp.float32)
    d = {"t": torch.from_numpy(np.array(t)).long(),
         "noise": torch.from_numpy(np.array(noise)).permute(0, 3, 1, 2)}
    if jcfg.p_uncond > 0:
        d["drop"] = torch.from_numpy(np.asarray(
            jax.random.bernoulli(drop_rng, jcfg.p_uncond, (b,))))
    if jcfg.retro_noise:
        d["ctx_noise"] = torch.from_numpy(np.asarray(jax.random.normal(
            retro_rng, (b, ctx_len, jcfg.context_dim), dtype=jnp.float32)))
    return d


def _batch(b=4, seed=2):
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((b, 4, 4, 2)).astype(np.float32)
    nns = rng.standard_normal((b, 1, 2, 8)).astype(np.float32)
    return z, nns


def _port_schedule(cfg):
    return DiffusionSchedule.create(cfg.timesteps, cfg.beta_schedule,
                                    cfg.linear_start, cfg.linear_end)


def _jax_schedule(cfg):
    return JSchedule.create(cfg.timesteps, cfg.beta_schedule,
                            cfg.linear_start, cfg.linear_end)


def test_training_loss_matches_jax():
    jcfg, cfg = _configs(p_uncond=0.5, learn_logvar=True, logvar_init=0.1,
                         original_elbo_weight=0.2, retro_noise=True)
    jm, params = _jax_model(jcfg)
    z, nns = _batch()
    rng = jax.random.PRNGKey(7)
    jschedule = _jax_schedule(jcfg)
    jloss, jmet = jax.jit(lambda p: jm.apply(
        p, jnp.asarray(z), jnp.asarray(nns), rng, jschedule,
        method=JRDM.training_loss,
        rngs={"dropout": jax.random.PRNGKey(1)}))(params)
    model = RDM(cfg)
    model.load_state_dict(rdm_state_dict_from_jax(params, cfg))
    assert model.logvar.requires_grad
    draws = _jax_draws(jcfg, rng, 4, 2)
    assert draws["drop"].any() and not draws["drop"].all()
    loss, met = model.train().training_loss(
        torch.from_numpy(z).permute(0, 3, 1, 2), torch.from_numpy(nns),
        torch.Generator(), _port_schedule(cfg), **draws)
    assert sorted(met) == sorted(jmet) == ["loss", "loss_simple", "loss_vlb"]
    for k in met:
        np.testing.assert_allclose(met[k].item(), float(jmet[k]), rtol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)


def test_logvar_is_a_constant_without_learn_logvar():
    _, cfg = _configs(logvar_init=0.3)
    model = RDM(cfg)
    assert "logvar" not in dict(model.named_parameters())
    assert "logvar" not in model.state_dict()
    assert torch.all(model.logvar_table("cpu") == 0.3)


# ------------------------------------------------------------ train step

def _carried_state(mu_dtype=None):
    """JAX and port train states from one seeded JAX state (the tiny
    config of tests/test_training.py:21; lr 1e-3, 2 warm-up steps)."""
    jcfg, cfg = _configs()
    jm, params = _jax_model(jcfg)
    jtx = joptim.make_optimizer(1e-3, warm_up_steps=2, mu_dtype=mu_dtype)
    jstate = j_init(params, jtx)
    tx = optim.make_optimizer(1e-3, warm_up_steps=2, mu_dtype=mu_dtype)
    state = init_train_state(RDM(cfg), tx)
    state.load_state_dict(train_state_from_jax(jstate, cfg))
    return jcfg, cfg, jm, jtx, jstate, tx, state


def _assert_tree_close(port: dict, jtree, cfg, atol_rel=1e-5, what=""):
    """atol: atol_rel x the largest |value| over the whole tree (leaves
    whose values are all near zero, as the time embedding's gradients,
    are held on the tree's scale, not their own)."""
    want = rdm_state_dict_from_jax(jtree, cfg)
    assert sorted(port) == sorted(want), what
    scale = max(w.abs().max().item() for w in want.values())
    for n, w in want.items():
        got = port[n]
        got = torch.zeros_like(w) if got is None else got.float()
        torch.testing.assert_close(
            got, w, rtol=1e-4, atol=atol_rel * scale,
            msg=lambda m: f"{what} {n}: {m}")


def test_train_state_carries_over():
    jcfg, cfg, jm, jtx, jstate, tx, state = _carried_state("bfloat16")
    sd = state.state_dict()
    assert sd["step"] == 0 and sd["ema"]["count"] == 0
    _assert_tree_close(dict(state.model.named_parameters()), jstate.params,
                       cfg, 0, "params")
    assert all(t.dtype == torch.bfloat16 for t in state.opt_state.mu.values())
    for n, p in state.model.named_parameters():  # EMA copies, not aliases
        assert state.ema.params[n].data_ptr() != p.data_ptr()


def test_train_step_gradients_match_jax():
    jcfg, cfg, jm, jtx, jstate, tx, state = _carried_state()
    schedule, jschedule = _port_schedule(cfg), _jax_schedule(jcfg)
    z, nns = _batch()
    rng = jax.random.fold_in(jax.random.PRNGKey(3), 0)  # step 0

    def loss_fn(p):
        return jm.apply(p, jnp.asarray(z), jnp.asarray(nns), rng, jschedule,
                        deterministic=False, method=JRDM.training_loss,
                        rngs={"dropout": jax.random.fold_in(rng, 1)})

    (jloss, _), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jstate.params)
    loss, _, grads = compute_grads(
        state.model, torch.from_numpy(z).permute(0, 3, 1, 2),
        torch.from_numpy(nns), torch.Generator(), schedule,
        **_jax_draws(jcfg, rng, 4, 2))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    _assert_tree_close(grads, jgrads, cfg, 1e-5, "grad")


def test_three_train_steps_match_jax():
    jcfg, cfg, jm, jtx, jstate, tx, state = _carried_state()
    schedule, jschedule = _port_schedule(cfg), _jax_schedule(jcfg)
    jstep = j_make_step(jm, jtx, jschedule, remat=False)
    step = make_train_step(tx, schedule)
    key = jax.random.PRNGKey(3)
    lr, n = 1e-3, 3
    for i in range(n):
        z, nns = _batch(seed=10 + i)
        jstate, jmet = jstep(jstate, jnp.asarray(z), jnp.asarray(nns), key)
        state, met = step(state, torch.from_numpy(z).permute(0, 3, 1, 2),
                          torch.from_numpy(nns), 0,
                          **_jax_draws(jcfg, jax.random.fold_in(key, i), 4,
                                       2))
        if i == 0:  # the first step's gradients, left on the parameters
            g0 = torch.cat([
                (torch.zeros_like(p) if p.grad is None else p.grad)
                .reshape(-1) for _, p in sorted(
                    state.model.named_parameters())])
        for k in ("loss", "loss_simple", "grad_norm"):
            np.testing.assert_allclose(float(met[k]), float(jmet[k]),
                                       rtol=1e-4, err_msg=k)
    assert state.step == int(jstate.step) == n
    assert state.ema.count == int(jstate.ema.count) == n
    want = train_state_from_jax(jstate, cfg)
    got = state.state_dict()
    for what, mine, ref in [
            ("params", got["params"], want["params"]),
            ("ema", got["ema"]["params"], want["ema"]["params"]),
            ("mu", got["opt_state"]["mu"], want["opt_state"]["mu"]),
            ("nu", got["opt_state"]["nu"], want["opt_state"]["nu"])]:
        assert sorted(mine) == sorted(ref)
        a = torch.cat([mine[k].float().reshape(-1) for k in sorted(ref)])
        b = torch.cat([ref[k].float().reshape(-1) for k in sorted(ref)])
        if what in ("params", "ema"):
            # sign flips of near-zero gradients: at most 2 n lr apart; the
            # elements whose gradient is well above rounding noise agree
            assert (a - b).abs().max().item() <= 2 * n * lr, what
            big = g0.abs() > 1e-3 * g0.abs().max()
            off = ((a - b).abs() > 1e-5) & big
            assert off.float().sum().item() <= 0.01 * big.sum().item(), what
        else:
            scale = b.abs().max().item()
            assert ((a - b).abs() > 1e-4 * scale).float().mean().item() \
                <= 0.01, what
    assert got["opt_state"]["count"] == want["opt_state"]["count"] == n
