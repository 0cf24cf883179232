"""The port's CLIP (rdm_tpu_torch/models/clip.py), tokenizer, retrievers
and CLIP weight loading against the JAX package on the CPU.

- The tokenizer equals JAX `tokenize` (which splits with the `regex`
  package) on captions with No / Nl numbers, Arabic-Indic digits,
  combining accents, CJK, emoji and mojibake, and its split equals the
  `regex` pattern's on every assigned code point.
- Tiny ViT and ModifiedResNet CLIPs on `clip_state_dict_from_jax` weights
  against the JAX towers, f32: atol 1e-3 x output scale, the golden tests'
  tolerance (tests/test_torch_convert.py).
- `preprocess` (jax.image.resize's antialiased Keys bicubic, a = -0.5) at
  256 -> 224 and 64 -> 224 within 1e-5 x output scale.
- The port's `state_dict()` through JAX `convert_clip` /
  `convert_clip_resnet_visual` reproduces the port.
- `load_clip_state_dict` on a `torch.save`d dict and a TorchScript archive
  written by the test.
- The retrievers against JAX's, f32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import regex
import torch
import unicodedata

from rdm_tpu.models import clip as jclip
from rdm_tpu.models import retrievers as jret
from rdm_tpu.models.autoencoder import AutoencoderConfig as JAEConfig
from rdm_tpu.models.autoencoder import VQModel as JVQModel
from rdm_tpu.utils import tokenizer as jtok
from rdm_tpu.utils.torch_convert import (convert_clip,
                                         convert_clip_resnet_visual)
from rdm_tpu_torch import config as pc
from rdm_tpu_torch.models import clip as pclip
from rdm_tpu_torch.models import retrievers as pret
from rdm_tpu_torch.utils import tokenizer as ptok
from rdm_tpu_torch.utils.from_jax import (clip_state_dict_from_jax,
                                          vq_state_dict_from_jax)
from test_torch_port_unet import seeded_params

TOL = 1e-3          # x output scale, f32 towers
PRE_TOL = 1e-5      # x output scale, preprocess
CORPUS = [
    "a photograph of a dog",
    "E=mc² with ½ cup at Ⅻ o'clock",
    "٣ cats and ٤٥ dogs",
    "café naïve résumé, é and ö",
    "東京タワーの夜景 and 北京",
    "🐶🐱 emoji!!! 👍🏽",
    "Ã©tÃ© mojibake â€” fixed",
    "I'm here, you'll see; they've said we'd",
    "<|endoftext|> hi <|startoftext|>",
    "tabs\tand\x1cseparatorsͅhere",
    "  spaces   and\nnewlines  &amp; &lt;html&gt;",
    "ſtart 'S 'LL",
    "a long caption " * 30,
]
VIT = dict(embed_dim=24, image_resolution=32, vision_width=64,
           vision_layers=2, vision_patch_size=8, context_length=16,
           vocab_size=120, transformer_width=64, transformer_layers=2,
           head_dim=32)
RN = dict(VIT, vision_width=16, resnet_layers=(1, 2))
# the pipelines' CLIP: a text tower that takes the tokenizer's ids, and the
# 224-pixel input the JAX pipelines' `preprocess` resizes to
CAPTIONS = dict(VIT, vocab_size=49408, context_length=77,
                image_resolution=224, vision_patch_size=32)


def _close(got, want, tol=TOL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want,
                               atol=tol * float(np.abs(want).max()))


def test_tokenizer_matches_jax():
    want = jtok.tokenize(CORPUS)
    got = ptok.tokenize(CORPUS)
    assert got.dtype == np.int32 and got.shape == (len(CORPUS), 77)
    np.testing.assert_array_equal(got, want)
    tok = ptok.default_tokenizer()
    assert tok.decode(tok.encode("a photograph of a dog")).strip() == \
        "a photograph of a dog"
    for mod in (jtok, ptok):
        with pytest.raises(ValueError, match="too long"):
            mod.tokenize(CORPUS[-1], truncate=False)


@pytest.mark.parametrize("context", ["a{}b", "1{}!"])
def test_split_matches_regex_on_every_code_point(context):
    """Every code point both Unicode databases assign, between a letter
    and a letter (or a digit and a symbol)."""
    chars = [chr(c) for c in range(0x110000)
             if not 0xD800 <= c <= 0xDFFF
             and unicodedata.category(chr(c)) != "Cn"]
    text = "".join(context.format(c) for c in chars)
    want = regex.findall(jtok.default_tokenizer().pat, text)
    assert ptok.pretokenize(text) == want


def _clip(kw, seed):
    """(JAX CLIP, JAX variables, port config, port CLIP f32) on the same
    seeded weights; BatchNorm variances kept positive."""
    jcfg, cfg = jclip.ClipConfig(**kw), pc.ClipConfig(**kw)
    jm = jclip.CLIP(jcfg)
    res = kw["image_resolution"]
    variables = seeded_params(jax.eval_shape(
        lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, res, res, 3)),
                        jnp.zeros((1, kw["context_length"]), jnp.int32))),
        seed)
    if "batch_stats" in variables:
        variables = dict(variables, batch_stats=jax.tree.map(
            lambda v: np.abs(np.asarray(v)) + 0.5, variables["batch_stats"]))
    model = pclip.CLIP(cfg).eval()
    model.load_state_dict(clip_state_dict_from_jax(variables, cfg))
    return jm, variables, cfg, model


def _inputs(kw, seed):
    rng = np.random.default_rng(seed)
    res, ctx = kw["image_resolution"], kw["context_length"]
    img = rng.standard_normal((2, res, res, 3)).astype(np.float32)
    toks = np.zeros((2, ctx), np.int32)
    toks[0, :5] = [118, 3, 7, 9, 119]
    toks[1, :3] = [118, 5, 119]
    return img, toks


@pytest.mark.parametrize("kind", ["vit", "resnet"])
def test_towers_match_jax(kind):
    kw = VIT if kind == "vit" else RN
    jm, variables, cfg, model = _clip(kw, seed=1)
    img, toks = _inputs(kw, seed=2)
    want_img = jm.apply(variables, jnp.asarray(img),
                        method=jclip.CLIP.encode_image)
    want_txt = jm.apply(variables, jnp.asarray(toks),
                        method=jclip.CLIP.encode_text)
    want_logits = jm.apply(variables, jnp.asarray(img), jnp.asarray(toks))
    with torch.no_grad():
        x = torch.from_numpy(img).permute(0, 3, 1, 2)
        t = torch.from_numpy(toks).long()
        got_img, got_txt = model.encode_image(x), model.encode_text(t)
        got_logits = model(x, t)
    assert got_img.shape == (2, 24) and got_img.dtype == torch.float32
    _close(got_img.numpy(), want_img)
    _close(got_txt.numpy(), want_txt)
    _close(got_logits.numpy(), want_logits)


@pytest.mark.parametrize("size", [256, 64])
def test_preprocess_matches_jax(size):
    x = np.random.default_rng(size).uniform(-1.1, 1.1, (2, size, size, 3)
                                            ).astype(np.float32)
    want = jclip.preprocess(jnp.asarray(x))
    got = pclip.preprocess(torch.from_numpy(x))
    assert got.shape == (2, 224, 224, 3)
    _close(got.numpy(), want, PRE_TOL)
    unit = (x + 1.0) / 2.0
    _close(pclip.preprocess(torch.from_numpy(unit), 32, "unit").numpy(),
           jclip.preprocess(jnp.asarray(unit), 32, "unit"), PRE_TOL)
    with pytest.raises(ValueError):
        pclip.preprocess(torch.from_numpy(x), input_range="0_255")


@pytest.mark.parametrize("kind", ["vit", "resnet"])
def test_port_state_dict_through_convert_clip(kind):
    """A port CLIP with its own random init -> state_dict() -> the JAX
    converters (`convert_clip` for the ViT CLIP, whose text tower both
    kinds share; `convert_clip_resnet_visual` for the RN50 tower) -> the
    JAX modules give the port's embeddings."""
    kw = VIT if kind == "vit" else RN
    torch.manual_seed(3)
    model = pclip.CLIP(pc.ClipConfig(**kw)).eval()
    with torch.no_grad():
        for name, buf in model.named_buffers():
            if name.endswith("running_var"):
                buf.uniform_(0.5, 1.5)
            elif name.endswith("running_mean"):
                buf.normal_(0.0, 0.1)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    img, toks = _inputs(kw, seed=4)
    with torch.no_grad():
        got_img = model.encode_image(torch.from_numpy(img).permute(0, 3, 1, 2))
        got_txt = model.encode_text(torch.from_numpy(toks).long())
    if kind == "vit":
        jcfg = jclip.ClipConfig(**kw)
        variables, _ = convert_clip(sd, jcfg)
        jm = jclip.CLIP(jcfg)
        _close(got_txt.numpy(), jm.apply(variables, jnp.asarray(toks),
                                         method=jclip.CLIP.encode_text))
        want_img = jm.apply(variables, jnp.asarray(img),
                            method=jclip.CLIP.encode_image)
    else:
        variables = convert_clip_resnet_visual(sd, layers=kw["resnet_layers"])
        jm = jclip.ModifiedResNet(layers=kw["resnet_layers"],
                                  width=kw["vision_width"],
                                  heads=kw["vision_width"] // 2,
                                  out_dim=kw["embed_dim"])
        want_img = jm.apply(variables, jnp.asarray(img))
    _close(got_img.numpy(), want_img)


def test_load_clip_state_dict(tmp_path):
    _, _, cfg, model = _clip(VIT, seed=6)
    sd = model.state_dict()
    half = {k: v.half() for k, v in sd.items()}
    half.update(input_resolution=torch.tensor(32), context_length=torch.tensor(
        16), vocab_size=torch.tensor(120))
    torch.save(half, tmp_path / "plain.pt")
    torch.save({"state_dict": sd}, tmp_path / "wrapped.pt")
    img, toks = _inputs(VIT, seed=7)
    x = torch.from_numpy(img).permute(0, 3, 1, 2)
    torch.jit.trace(model, (x, torch.from_numpy(toks).long()),
                    check_trace=False).save(str(tmp_path / "scripted.pt"))
    for name in ("plain.pt", "wrapped.pt", "scripted.pt"):
        loaded = pclip.load_clip_state_dict(str(tmp_path / name))
        assert set(loaded) == set(sd)
        assert all(v.dtype == sd[k].dtype for k, v in loaded.items())
        tol = 1e-3 if name == "plain.pt" else 0.0
        for k, v in loaded.items():
            torch.testing.assert_close(v, sd[k], atol=tol * (
                1 + sd[k].abs().max().item()), rtol=0)
    assert pclip.clip_config_from_state_dict(loaded) == pc.ClipConfig(
        **{k: v for k, v in VIT.items() if k != "head_dim"}, head_dim=64)


def test_retrievers_match_jax():
    jm, variables, cfg, model = _clip(CAPTIONS, seed=8)
    jcfg = jclip.ClipConfig(**CAPTIONS)
    images = np.random.default_rng(9).uniform(-1, 1, (2, 40, 40, 3)).astype(
        np.float32)
    sd = clip_state_dict_from_jax(variables, cfg)
    got = pret.ClipImageRetriever(sd, cfg, dtype=torch.float32,
                                  device="cpu")(images)
    want = jret.ClipImageRetriever(variables, jcfg, dtype=jnp.float32)(images)
    _close(got.numpy(), want)
    caps = ["a dog", "two cats on a mat"]
    got = pret.ClipTextRetriever(sd, cfg, dtype=torch.float32,
                                 device="cpu")(caps)
    want = jret.ClipTextRetriever(variables, jcfg, dtype=jnp.float32)(caps)
    _close(got.numpy(), want)
    ae_kw = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1,
                 attn_resolutions=(8,), resolution=16, z_channels=3,
                 embed_dim=3, n_embed=16)
    jvq = JVQModel(JAEConfig(**ae_kw))
    vq_params = seeded_params(jax.eval_shape(
        jvq.init, jax.random.PRNGKey(1), jnp.zeros((1, 16, 16, 3))), 10)
    ae = pc.AutoencoderConfig(**ae_kw)
    got = pret.VQGANRetriever(ae, vq_state_dict_from_jax(vq_params, ae),
                              size=16, device="cpu")(images)
    want = jret.VQGANRetriever(jvq, vq_params, size=16)(images)
    assert got.shape == (2, 8 * 8 * 3)
    _close(got.numpy(), want)
