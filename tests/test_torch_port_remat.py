"""remat in the port's RDM train step, against no remat and against JAX.

A tiny RDM with a full-resolution (ds 1) and a half-resolution (ds 2)
level, attention at the second, f32 on the CPU:

- Each of the four policies ("dots", "nothing", "dots_no_batch",
  "save_lowres") gives the no-remat step's loss and every gradient
  (rtol 1e-6), with the step's own draws (p_uncond and retro_noise on, so
  a recompute that drew again from the step's generator would show).
- "save_lowres" against JAX's `make_train_step(remat=True,
  remat_policy="save_lowres")` from one state carried by
  `train_state_from_jax`, JAX's draws injected: loss within 1e-5 relative
  at each of two steps, params after them within 1e-5 relative L2. The lr
  is 1e-5 there: Adam turns a near-zero gradient's rounding noise into a
  step of up to lr either way (tests/test_torch_port_train.py), which at
  1e-3 alone puts the trees 5e-5 apart, remat or not.
- What a forward keeps for its backward: the bytes of every storage made
  during the forward and still alive after it (a dispatch mode holding
  weak references), in the order none > dots > dots_no_batch >= nothing,
  and "save_lowres" between nothing and none, checkpointing exactly the
  blocks tagged blk_ds1 and running the ds >= 2 ones whole.
"""

import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from rdm_tpu.models.rdm import RDM as JRDM
from rdm_tpu.training import optim as joptim
from rdm_tpu.training.train_state import init_train_state as j_init
from rdm_tpu.training.train_state import make_train_step as j_step
from rdm_tpu_torch import config as pc
from rdm_tpu_torch.models.rdm import RDM
from rdm_tpu_torch.training import optim
from rdm_tpu_torch.training import train_state as ts
from rdm_tpu_torch.utils.from_jax import (rdm_state_dict_from_jax,
                                          train_state_from_jax)
from test_torch_port_train import (JRDMConfig, JUNetConfig, _jax_schedule,
                                   _port_schedule)
from test_torch_port_unet import seeded_params

UNET = dict(in_channels=2, out_channels=2, model_channels=8,
            num_res_blocks=1, attention_resolutions=(2,),
            channel_mult=(1, 2), num_head_channels=4, context_dim=8)
RDM_KW = dict(image_size=8, channels=2, timesteps=20, context_dim=8, k_nn=2)
POLICIES = ["dots", "nothing", "dots_no_batch", "save_lowres"]
B = 4


def _models(**kw):
    jcfg = JRDMConfig(unet=JUNetConfig(**UNET), **RDM_KW, **kw)
    cfg = pc.RDMConfig(unet=pc.UNetConfig(**UNET), **RDM_KW, **kw)
    jm = JRDM(jcfg)
    params = seeded_params(jax.eval_shape(
        jm.init, jax.random.PRNGKey(0), jnp.zeros((2, 8, 8, 2)),
        jnp.asarray([0, 1]), jnp.zeros((2, 2, 8))), 0)
    return jcfg, cfg, jm, params


def _batch(seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, 8, 8, 2)).astype(np.float32),
            rng.standard_normal((B, 1, 2, 8)).astype(np.float32))


def _port(z, nns):
    return torch.from_numpy(z).permute(0, 3, 1, 2), torch.from_numpy(nns)


def _tx(lr=1e-3):
    return optim.make_optimizer(lr, warm_up_steps=2)


def _state(cfg, params):
    model = RDM(cfg)
    model.load_state_dict(rdm_state_dict_from_jax(params, cfg))
    return ts.init_train_state(model, _tx())


def _step_grads(policy):
    """(loss, {name: grad}) of one step (policy None: no remat) with the
    step's own draws."""
    _, cfg, _, params = _models(p_uncond=0.5, retro_noise=True)
    state = _state(cfg, params)
    step = ts.make_train_step(_tx(), _port_schedule(cfg),
                              remat=policy is not None,
                              remat_policy=policy or "dots")
    _, m = step(state, *_port(*_batch(1)), 5)
    assert state.model.unet.remat is None  # unset after the step
    return float(m["loss"]), {n: p.grad.clone()
                              for n, p in state.model.named_parameters()
                              if p.grad is not None}


@pytest.fixture(scope="module")
def no_remat():
    return _step_grads(None)


@pytest.mark.parametrize("policy", POLICIES)
def test_each_policy_gives_the_no_remat_gradients(policy, no_remat):
    (l0, g0), (l1, g1) = no_remat, _step_grads(policy)
    np.testing.assert_allclose(l1, l0, rtol=1e-6)
    assert sorted(g1) == sorted(g0) and len(g0) > 20
    for n in g0:
        torch.testing.assert_close(g1[n], g0[n], rtol=1e-6, atol=0,
                                   msg=lambda m: f"{policy} {n}: {m}")


def _jax_draws(jcfg, rng):
    t_rng, noise_rng, _, _ = jax.random.split(rng, 4)
    t = jax.random.randint(t_rng, (B,), 0, jcfg.timesteps)
    noise = jax.random.normal(noise_rng, (B, 8, 8, 2), dtype=jnp.float32)
    return {"t": torch.from_numpy(np.array(t)).long(),
            "noise": torch.from_numpy(np.array(noise)).permute(0, 3, 1, 2)}


def test_save_lowres_matches_jax():
    jcfg, cfg, jm, params = _models()
    jtx = joptim.make_optimizer(1e-5, warm_up_steps=2)
    jstate = j_init(params, jtx)
    jstep = j_step(jm, jtx, _jax_schedule(jcfg), remat=True,
                   remat_policy="save_lowres")
    tx = _tx(1e-5)
    state = ts.init_train_state(RDM(cfg), tx)
    state.load_state_dict(train_state_from_jax(jstate, cfg))
    step = ts.make_train_step(tx, _port_schedule(cfg), remat=True,
                              remat_policy="save_lowres")
    key = jax.random.PRNGKey(3)
    for i in range(2):
        z, nns = _batch(10 + i)
        jstate, jm_ = jstep(jstate, jnp.asarray(z), jnp.asarray(nns), key)
        state, m = step(state, *_port(z, nns), 0,
                        **_jax_draws(jcfg, jax.random.fold_in(key, i)))
        np.testing.assert_allclose(float(m["loss"]), float(jm_["loss"]),
                                   rtol=1e-5)
    want = train_state_from_jax(jstate, cfg)["params"]
    got = state.state_dict()["params"]
    num = sum(float((got[k] - want[k]).pow(2).sum()) for k in want)
    den = sum(float(want[k].pow(2).sum()) for k in want)
    assert (num / den) ** 0.5 < 1e-5


class _Kept(TorchDispatchMode):
    """Weak references to the storage of every op output; `bytes()`
    sums those still alive."""

    def __init__(self):
        super().__init__()
        self.refs = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                st = t.untyped_storage()
                self.refs.append((weakref.ref(st), st.nbytes()))
        return out

    def bytes(self) -> int:
        gc.collect()
        alive = {}
        for ref, n in self.refs:
            st = ref()
            if st is not None:
                alive[st.data_ptr()] = n
        return sum(alive.values())


def _kept_bytes(cfg, params, policy, tags=None):
    """Bytes a forward keeps for its backward under `policy` (None: no
    remat); `tags` collects (tag, checkpointed) per region."""
    state = _state(cfg, params)
    model = state.model.train()
    z, nns = _port(*_batch(2))
    region = None
    if policy is not None:
        inner = ts.remat_region(policy)

        def region(tag, fn, *args):
            if tags is not None:
                tags.append((tag, policy != "save_lowres"
                             or tag not in ts.LOWRES_TAGS))
            return inner(tag, fn, *args)

    gen = torch.Generator().manual_seed(0)
    with ts.remat_scope(model, region):
        mode = _Kept()
        with mode:
            loss, _ = model.training_loss(z, nns, gen, _port_schedule(cfg))
        kept = mode.bytes()  # while the graph, and what it saved, lives
    del loss
    return kept


def test_policies_keep_less_in_order():
    _, cfg, _, params = _models()
    tags = []
    kept = {p: _kept_bytes(cfg, params, p,
                           tags if p == "save_lowres" else None)
            for p in [None] + POLICIES}
    assert kept[None] > kept["dots"] > kept["dots_no_batch"] \
        >= kept["nothing"] > 0
    assert kept["nothing"] < kept["save_lowres"] < kept[None]
    assert {t for t, _ in tags} == {"blk_ds1", "blk_ds2"}
    assert all(ck == (t == "blk_ds1") for t, ck in tags)


def test_unknown_policy_raises():
    with pytest.raises(ValueError, match="unknown remat_policy"):
        ts.make_train_step(optim.make_optimizer(1e-3), None, remat=True,
                           remat_policy="everything")
