"""The port's from-scratch init against the JAX package's `init`, leaf by
leaf, at the micro quality gate's widths (rdm_tpu/eval/micro_gate.py).

The port's paths that start from scratch are the trainers' `init_state`
(the RDM and the RARM) and the micro gate's `train_vq` (the VQ model),
all through `models/init.jax_init_`. JAX's leaves come from `Module.init`
and are carried into the port's names by `utils/from_jax`. For every
leaf: where JAX's is all zeros the port's is exactly zero, where it is all
ones exactly one; a drawn leaf of at least 256 elements has a standard
deviation within 10% of JAX's (each side's over three seeded inits, so a
256-element leaf's sampling noise, ~4% a draw, stays well inside it);
the VQ codebook lies in [0, 2 / n_embed). A port built with PyTorch's
default initialisers fails all of these.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rdm_tpu.models.autoencoder import AutoencoderConfig as JAEConfig
from rdm_tpu.models.autoencoder import VQModel as JVQModel
from rdm_tpu.models.rarm import RARM as JRARM
from rdm_tpu.models.rarm import RARMConfig as JRARMConfig
from rdm_tpu.models.rdm import RDM as JRDM
from rdm_tpu.models.rdm import RDMConfig as JRDMConfig
from rdm_tpu.models.unet import UNetConfig as JUNetConfig
from rdm_tpu_torch import config as pc
from rdm_tpu_torch.models.autoencoder import VQModel
from rdm_tpu_torch.training.trainer import (RARMTrainer, RDMTrainer,
                                            TrainerConfig)
from rdm_tpu_torch.utils.from_jax import (rarm_state_dict_from_jax,
                                          rdm_state_dict_from_jax,
                                          vq_state_dict_from_jax)

@pytest.fixture(autouse=True)
def _one_thread():
    """Tiny models: one intra-op thread, so that the suite's workers do
    not oversubscribe the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# the micro gate's widths (rdm_tpu/eval/micro_gate.py:174-197, :285-299)
CTX = 48
AE = dict(ch=16, ch_mult=(1, 2), num_res_blocks=1, z_channels=3,
          embed_dim=3, n_embed=128, resolution=16, in_channels=3, out_ch=3)
UNET = dict(in_channels=3, out_channels=3, model_channels=32,
            num_res_blocks=1, attention_resolutions=(2,),
            channel_mult=(1, 2), num_head_channels=8, context_dim=CTX)
RDM_KW = dict(image_size=8, channels=3, timesteps=100, context_dim=CTX,
              k_nn=3, p_uncond=0.1)
RARM_KW = dict(vocab_size=130, out_vocab=128, heads=4, head_dim=16,
               depth=3, context_dim=CTX, seq_len=64, sos_token=129,
               mask_token=128, code_side=8, p_mask_max=0.1)
SEEDS = (0, 1, 2)
STD_TOL = 0.10
MIN_DRAWN = 256


# each JAX init is traced and compiled once, then drawn at every seed
@functools.lru_cache(maxsize=None)
def _jax_init(kind):
    if kind == "rdm":
        init = JRDM(JRDMConfig(unet=JUNetConfig(**UNET), **RDM_KW)).init
        args = (jnp.zeros((1, 8, 8, 3)), jnp.zeros((1,), jnp.int32),
                jnp.zeros((1, 3, CTX)))
    elif kind == "vq":
        init = JVQModel(JAEConfig(**AE)).init
        args = (jnp.zeros((1, 16, 16, 3)),)
    else:
        init = JRARM(JRARMConfig(**RARM_KW)).init
        args = (jnp.zeros((1, 4), jnp.int32), jnp.zeros((1, 3, CTX)))
    init = jax.jit(init)
    return lambda seed: init(jax.random.PRNGKey(seed), *args)


def _trainer_init(kind, seed, tmp_path):
    ae = pc.AutoencoderConfig(**AE)
    fs_sd = VQModel(ae).state_dict()
    tcfg = TrainerConfig(logdir=str(tmp_path / f"{kind}{seed}"),
                         image_log_every=0, seed=seed)
    if kind == "rdm":
        cfg = pc.RDMConfig(unet=pc.UNetConfig(**UNET), **RDM_KW)
        tr = RDMTrainer(cfg, tcfg, ae, fs_sd, device="cpu")
    else:
        tr = RARMTrainer(pc.RARMConfig(**RARM_KW), tcfg, ae, fs_sd,
                         device="cpu")
    return {k: v.detach().clone() for k, v in
            tr.init_state().model.state_dict().items()}


def _vq_init(seed):
    from rdm_tpu_torch.models.init import jax_init_  # the micro gate's draw

    vq = VQModel(pc.AutoencoderConfig(**AE))
    jax_init_(vq, torch.Generator().manual_seed(seed))
    return vq.state_dict()


def _inits(kind, tmp_path):
    """([port state dict per seed], [JAX leaves in port names per seed])."""
    jax_init = _jax_init(kind)
    if kind == "rdm":
        cfg = pc.RDMConfig(unet=pc.UNetConfig(**UNET), **RDM_KW)
        want = [rdm_state_dict_from_jax(jax_init(s), cfg) for s in SEEDS]
        got = [_trainer_init("rdm", s, tmp_path) for s in SEEDS]
    elif kind == "rarm":
        cfg = pc.RARMConfig(**RARM_KW)
        want = [rarm_state_dict_from_jax(jax_init(s), cfg) for s in SEEDS]
        got = [_trainer_init("rarm", s, tmp_path) for s in SEEDS]
    else:
        ae = pc.AutoencoderConfig(**AE)
        want = [vq_state_dict_from_jax(jax_init(s), ae) for s in SEEDS]
        got = [_vq_init(s) for s in SEEDS]
    return got, want


@pytest.mark.parametrize("kind", ["rdm", "vq", "rarm"])
def test_from_scratch_init_matches_jax_leaf_by_leaf(kind, tmp_path):
    got, want = _inits(kind, tmp_path)
    assert sorted(got[0]) == sorted(want[0])
    drawn = 0
    for name, w0 in want[0].items():
        w = np.stack([x[name].numpy() for x in want])
        g = np.stack([x[name].float().numpy() for x in got])
        assert g.shape == w.shape, name
        if np.all(w == 0.0):
            assert np.all(g == 0.0), f"{name}: JAX zero-inits it"
        elif np.all(w == 1.0):
            assert np.all(g == 1.0), f"{name}: JAX inits it at one"
        elif w0.numel() >= MIN_DRAWN:
            drawn += 1
            rel = abs(g.std() / w.std() - 1.0)
            assert rel < STD_TOL, (name, float(g.std()), float(w.std()))
    assert drawn > 0
    if kind == "vq":
        n_embed = AE["n_embed"]
        for sd in got:
            cb = sd["quantize.embedding.weight"]
            assert float(cb.min()) >= 0.0
            assert float(cb.max()) < 2.0 / n_embed


def test_zero_heads_in_the_trainers_state(tmp_path):
    """The residual heads JAX zero-inits start at zero in the port's
    trainer state (PyTorch's default initialisers draw them nonzero)."""
    sd = _trainer_init("rdm", 0, tmp_path)
    heads = [k for k in sd if k.endswith(("out_layers.3.weight",
                                          "proj_out.weight"))
             or k == "model.diffusion_model.out.2.weight"]
    assert len(heads) >= 5
    for k in heads:
        assert float(sd[k].abs().max()) == 0.0, k
