"""Model directories in the port against the JAX package, on the CPU.

- The YAML loaders (`rdm_tpu_torch/config.py`): on every config under
  configs/rdm/ and configs/rarm/, with and without dotlist overrides, the
  port's dataclasses equal JAX's (`rdm_tpu/config.py`).
- npz: `RDMPipeline.from_model_dir` / `RARMPipeline.from_model_dir` on a
  directory this test writes with JAX's `save_params_npz`, against JAX's
  `from_model_dir` on the same directory: the U-Net's eps, the RARM's
  logits and the VQ decode within the golden tolerance, 1e-3 x the output
  scale (f32 both sides).
- ckpt: a `model.ckpt` carrying `model_ema.*` (LitEma names) loads the EMA
  weights into the RDM, the first stage from `first_stage_model.*`, the
  RARM from `transformer.*`.
- `random_init` builds each pipeline from the JAX initialisers (zero eps
  head, the codebook in [0, 2 / n_embed)).
- `_load_clip_weights` on an OpenAI-style torch file and on an npz.
- None of the new modules imports jax, and PyYAML loads only where a
  file or a value is parsed.
"""

import dataclasses
import glob
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rdm_tpu import config as jconf
from rdm_tpu import pipeline as jpipe
from rdm_tpu.models.autoencoder import VQModel as JVQModel
from rdm_tpu.models.rarm import RARM as JRARM
from rdm_tpu.models.rdm import RDM as JRDM
from rdm_tpu.utils.params_io import save_params_npz
from rdm_tpu_torch import config as pconf
from rdm_tpu_torch import pipeline as ppipe
from rdm_tpu_torch.models.autoencoder import VQModel
from rdm_tpu_torch.models.rarm import RARM
from rdm_tpu_torch.models.rdm import RDM
from rdm_tpu_torch.utils import params_io
from test_torch_port_unet import seeded_params

@pytest.fixture(autouse=True)
def _one_thread():
    """Tiny models: one intra-op thread, so that the suite's workers do
    not oversubscribe the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(REPO, "configs", "rdm", "*.yaml"))
                 + glob.glob(os.path.join(REPO, "configs", "rarm",
                                          "*.yaml")))
DOTLISTS = ([], ["model.params.k_nn=8", "model.params.unet_config.params."
                 "channel_mult=[1,2]", "model.params.transformer_config."
                 "params.depth=3", "model.params.first_stage_config.params."
                 "n_embed=512", "lightning.trainer.max_steps=10"])
TOL = 1e-3  # x output scale (tests/test_torch_convert.py:786-789)

FIRST_STAGE = """
    first_stage_config:
      params:
        embed_dim: 3
        n_embed: 32
        ddconfig:
          z_channels: 3
          resolution: 16
          in_channels: 3
          out_ch: 3
          ch: 8
          ch_mult: [1, 2]
          num_res_blocks: 1
          attn_resolutions: []
"""
RDM_YAML = """
model:
  target: rdm.models.diffusion.ddpm.MinimalRETRODiffusion
  params:
    k_nn: 3
    timesteps: 50
    image_size: 8
    channels: 3
    unet_config:
      params:
        in_channels: 3
        out_channels: 3
        model_channels: 16
        attention_resolutions: [2]
        num_res_blocks: 1
        channel_mult: [1, 2]
        num_head_channels: 8
        context_dim: 24
""" + FIRST_STAGE
RARM_YAML = """
model:
  target: rdm.models.autoregression.transformer.LatentImageRETRO
  params:
    sos_token: 33
    mask_token: 32
    transformer_config:
      params:
        in_channels: 34
        out_channels: 32
        n_heads: 2
        d_head: 8
        depth: 2
        context_dim: 24
        sequence_length: 64
""" + FIRST_STAGE


@pytest.mark.parametrize("dotlist", [0, 1])
@pytest.mark.parametrize("path", CONFIGS,
                         ids=[os.path.basename(os.path.dirname(p)) + "/"
                              + os.path.basename(p) for p in CONFIGS])
def test_yaml_configs_match_jax(path, dotlist):
    dl = DOTLISTS[dotlist]
    want = jconf.load_config([path], dl)
    got = pconf.load_config([path], dl)
    assert got == want
    assert (dataclasses.asdict(pconf.model_config_from_yaml(got))
            == dataclasses.asdict(jconf.model_config_from_yaml(want)))
    assert (dataclasses.asdict(pconf.first_stage_config_from_yaml(got))
            == dataclasses.asdict(jconf.first_stage_config_from_yaml(want)))


def test_yaml_helpers_match_jax():
    a = {"a": {"b": 1, "c": {"d": 2}}, "e": 3}
    b = {"a": {"c": {"d": 5, "f": [1]}}, "g": "x"}
    assert pconf.deep_merge(a, b) == jconf.deep_merge(a, b)
    for s in ("1", "1.5e-4", "[1, 2]", "true", "null", "name", "{a: 1}"):
        assert pconf._parse_value(s) == jconf._parse_value(s)
    with pytest.raises(ValueError, match="key=value"):
        pconf.apply_dotlist({}, ["nokey"])
    with pytest.raises(ValueError, match="unknown model target"):
        pconf.model_config_from_yaml({"model": {"target": "x.Y"}})


def _write_dir(tmp_path, name, yaml):
    d = tmp_path / name
    d.mkdir()
    (d / "config.yaml").write_text(textwrap.dedent(yaml))
    cfg = jconf.load_config([str(d / "config.yaml")])
    return d, jconf.model_config_from_yaml(cfg), \
        jconf.first_stage_config_from_yaml(cfg)


def _jax_vq_tree(fs_cfg, seed):
    return seeded_params(jax.eval_shape(
        JVQModel(fs_cfg).init, jax.random.PRNGKey(0),
        jnp.zeros((1, 16, 16, 3))), seed)


def _close(got, want):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want,
                               atol=TOL * float(np.abs(want).max()))


def _decode_both(jp, pp, seed=3):
    """The VQ decode of latents (RDM) or of a code grid (RARM)."""
    rng = np.random.default_rng(seed)
    if isinstance(jp, jpipe.RDMPipeline):
        z = rng.standard_normal((2, 8, 8, 3)).astype(np.float32)
        want = jp._decode(jp.first_stage_params, jnp.asarray(z))
        with torch.no_grad():
            got = pp.first_stage.decode(torch.as_tensor(z).permute(0, 3, 1,
                                                                   2))
    else:
        idx = rng.integers(0, 32, (2, 8, 8))
        want = jp._decode_code(jp.first_stage_params, jnp.asarray(idx))
        with torch.no_grad():
            got = pp.first_stage.decode_code(torch.as_tensor(idx))
    _close(got.permute(0, 2, 3, 1).numpy(), want)


def test_rdm_from_npz_matches_jax(tmp_path):
    d, cfg, fs_cfg = _write_dir(tmp_path, "rdm", RDM_YAML)
    params = seeded_params(jax.eval_shape(
        JRDM(cfg).init, jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 3)),
        jnp.zeros((1,), jnp.int32), jnp.zeros((1, 3, 24))), 1)
    save_params_npz(str(d / "params.npz"), params)
    save_params_npz(str(d / "first_stage_params.npz"), _jax_vq_tree(fs_cfg,
                                                                    2))
    jp = jpipe.RDMPipeline.from_model_dir(str(d), dtype=jnp.float32)
    pp = ppipe.RDMPipeline.from_model_dir(str(d), dtype=torch.float32,
                                          device="cpu")
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 8, 8, 3)).astype(np.float32)
    t = np.asarray([3, 41])
    ctx = rng.standard_normal((2, 3, 24)).astype(np.float32)
    want = jp.model.apply(jp.params, jnp.asarray(x), jnp.asarray(t),
                          jnp.asarray(ctx))
    with torch.no_grad():
        got = pp.model(torch.as_tensor(x).permute(0, 3, 1, 2),
                       torch.as_tensor(t), torch.as_tensor(ctx))
    _close(got.permute(0, 2, 3, 1).numpy(), want)
    _decode_both(jp, pp)


def test_rarm_from_npz_matches_jax(tmp_path):
    d, cfg, fs_cfg = _write_dir(tmp_path, "rarm", RARM_YAML)
    params = seeded_params(jax.eval_shape(
        JRARM(cfg).init, jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32),
        jnp.zeros((1, 3, 24))), 5)
    save_params_npz(str(d / "params.npz"), params)
    save_params_npz(str(d / "first_stage_params.npz"), _jax_vq_tree(fs_cfg,
                                                                    6))
    jp = jpipe.RARMPipeline.from_model_dir(str(d), dtype=jnp.float32)
    pp = ppipe.RARMPipeline.from_model_dir(str(d), dtype=torch.float32,
                                           device="cpu")
    rng = np.random.default_rng(7)
    toks = rng.integers(0, 34, (2, 64))
    ctx = rng.standard_normal((2, 3, 24)).astype(np.float32)
    want = jp.model.apply(jp.params, jnp.asarray(toks), jnp.asarray(ctx))
    with torch.no_grad():
        got = pp.model(torch.as_tensor(toks), torch.as_tensor(ctx))
    _close(got.numpy(), want)
    _decode_both(jp, pp)


def _perturbed(sd, delta):
    return {k: v + delta if v.is_floating_point() else v
            for k, v in sd.items()}


def test_rdm_ckpt_loads_the_ema_weights(tmp_path):
    d, _, _ = _write_dir(tmp_path, "rdm", RDM_YAML)
    cfg = pconf.model_config_from_yaml(pconf.load_yaml(
        str(d / "config.yaml")))
    fs_cfg = pconf.first_stage_config_from_yaml(pconf.load_yaml(
        str(d / "config.yaml")))
    torch.manual_seed(0)
    live = RDM(cfg).state_dict()
    ema = _perturbed(live, 0.5)
    fs = VQModel(fs_cfg).state_dict()
    sd = {k: v for k, v in live.items()}
    # LitEma: the model's weights under model_ema. with the dots removed
    sd.update({"model_ema." + k[len("model."):].replace(".", ""): v
               for k, v in ema.items() if k.startswith("model.")})
    sd["model_ema.num_updates"] = torch.tensor(7)
    sd["model_ema.decay"] = torch.tensor(0.9999)
    sd.update({"first_stage_model." + k: v for k, v in fs.items()})
    sd["betas"] = torch.zeros(50)  # a reference buffer the port drops
    torch.save({"state_dict": sd, "global_step": 7}, d / "model.ckpt")
    pp = ppipe.RDMPipeline.from_model_dir(str(d), dtype=torch.float32,
                                          device="cpu")
    got = pp.model.state_dict()
    for k, v in ema.items():
        # the guidance vector is not under model., so it has no EMA copy
        want = v if k.startswith("model.") else live[k]
        assert torch.equal(got[k], want), k
    for k, v in VQModel.decode_side(fs).items():
        assert torch.equal(pp.first_stage.state_dict()[k], v), k
    # without use_ema the live weights
    rdm_sd, fs_sd = params_io.rdm_state_dicts(
        params_io.load_torch_state_dict(str(d / "model.ckpt")), cfg, fs_cfg)
    assert all(torch.equal(rdm_sd[k], v) for k, v in live.items())
    assert sorted(fs_sd) == sorted(fs)
    with pytest.raises(KeyError, match="RDM"):
        params_io.rdm_state_dicts({"betas": torch.zeros(2)}, cfg, fs_cfg)


def test_rarm_ckpt_loads(tmp_path):
    d, _, _ = _write_dir(tmp_path, "rarm", RARM_YAML)
    y = pconf.load_yaml(str(d / "config.yaml"))
    cfg = pconf.model_config_from_yaml(y)
    fs_cfg = pconf.first_stage_config_from_yaml(y)
    torch.manual_seed(1)
    model = RARM(cfg).state_dict()
    fs = VQModel(fs_cfg, encoder=False).state_dict()
    sd = {"transformer." + k: v for k, v in model.items()}
    sd.update({"first_stage_model." + k: v for k, v in fs.items()})
    torch.save(sd, d / "model.ckpt")  # a bare state dict
    pp = ppipe.RARMPipeline.from_model_dir(str(d), dtype=torch.float32,
                                           device="cpu")
    got = pp.model.state_dict()
    assert all(torch.equal(got[k], v) for k, v in model.items())
    got = pp.first_stage.state_dict()
    assert all(torch.equal(got[k], v) for k, v in fs.items())


@pytest.mark.parametrize("kind", ["rdm", "rarm"])
def test_random_init_builds_the_jax_init(kind, tmp_path):
    yaml = RDM_YAML if kind == "rdm" else RARM_YAML
    d, _, _ = _write_dir(tmp_path, kind, yaml)
    cls = ppipe.RDMPipeline if kind == "rdm" else ppipe.RARMPipeline
    # a params.npz is there, but random_init wins
    (d / "params.npz").write_bytes(b"not read")
    (d / "first_stage_params.npz").write_bytes(b"not read")
    a = cls.from_model_dir(str(d), random_init=True, dtype=torch.float32,
                           device="cpu")
    b = cls.from_model_dir(str(d), random_init=True, seed=1,
                           dtype=torch.float32, device="cpu")
    cb = a.first_stage.quantize.embedding.weight.detach()
    assert 0.0 <= float(cb.min()) and float(cb.max()) < 2.0 / 32
    sa, sb = a.model.state_dict(), b.model.state_dict()
    if kind == "rdm":
        head = "model.diffusion_model.out.2.weight"
        assert float(sa[head].abs().max()) == 0.0
        out = a.sample_with_query(
            np.random.default_rng(0).standard_normal((2, 24)),
            only_query=True, steps=2, guidance_scale=1.0)["query_samples"]
        assert out.shape == (2, 16, 16, 3) and out.dtype == np.uint8
        key = "model.diffusion_model.time_embed.0.weight"
    else:
        key = "proj_in.weight"
        out = a.sample_with_query(
            np.random.default_rng(0).standard_normal((2, 24)),
            only_query=True, top_k=4)["query_samples"]
        assert out.shape == (2, 16, 16, 3)
    assert not torch.equal(sa[key], sb[key])  # the seed draws them


def test_load_clip_weights(tmp_path, monkeypatch):
    from rdm_tpu_torch.models.clip import CLIP

    assert ppipe._load_clip_weights(None) == (None, None)
    assert ppipe._load_clip_weights(str(tmp_path / "none.pt")) == (None,
                                                                   None)
    kw = dict(embed_dim=24, image_resolution=32, vision_width=64,
              vision_layers=2, vision_patch_size=8, context_length=16,
              vocab_size=120, transformer_width=64, transformer_layers=2,
              head_dim=64)  # OpenAI's head width, which a state dict implies
    torch.manual_seed(0)
    sd = CLIP(pconf.ClipConfig(**kw)).state_dict()
    torch.save(sd, tmp_path / "clip.pt")
    got, cfg = ppipe._load_clip_weights(str(tmp_path / "clip.pt"))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        pconf.ClipConfig(**kw))
    assert all(torch.equal(got[k], v) for k, v in sd.items())
    # an npz: a converted JAX tree, read as ViT-B/32
    np.savez(tmp_path / "clip.npz", **{"visual|proj": np.ones((2, 2))})
    seen = {}
    monkeypatch.setattr(ppipe, "clip_state_dict_from_jax",
                        lambda tree, c: seen.update(tree=tree, cfg=c) or {})
    _, cfg = ppipe._load_clip_weights(str(tmp_path / "clip.npz"))
    assert cfg == pconf.ClipConfig.vit_b32() == seen["cfg"]
    np.testing.assert_array_equal(seen["tree"]["visual"]["proj"],
                                  np.ones((2, 2)))


def test_load_params_npz_matches_jax(tmp_path):
    tree = {"params": {"a": {"kernel": np.arange(6.0).reshape(2, 3)},
                       "b/c": {"bias": np.ones(3, np.float32)}}}
    save_params_npz(str(tmp_path / "p.npz"), tree)
    from rdm_tpu.utils.params_io import load_params_npz as jload
    got = params_io.load_params_npz(str(tmp_path / "p.npz"))
    want = jload(str(tmp_path / "p.npz"))
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)


NEW_MODULES = ["rdm_tpu_torch.eval", "rdm_tpu_torch.eval.metrics",
               "rdm_tpu_torch.eval.fidelity", "rdm_tpu_torch.eval.micro_gate",
               "rdm_tpu_torch.models.init", "rdm_tpu_torch.utils.params_io",
               "rdm_tpu_torch.scripts.micro_quality_gate",
               "rdm_tpu_torch.scripts.quality_eval"]


def test_new_modules_import_neither_jax_nor_yaml():
    code = ("import sys\n"
            f"for m in {NEW_MODULES!r}:\n"
            "    __import__(m)\n"
            "from rdm_tpu_torch import config as c\n"
            "c.rdm_config_from_model_config({'params': {}})\n"
            "c.model_config_from_yaml({'model': {'target': 'x.RARM'}})\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'flax',\n"
            "                                    'rdm_tpu', 'yaml'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    env.pop("JAX_PLATFORMS", None)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
