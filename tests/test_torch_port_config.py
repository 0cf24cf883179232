"""rdm_tpu_torch: config mirrors, jax-free imports, chip_smoke's refusal.

The port mirrors the JAX package's config dataclasses field for field
(they live in flax modules, so the port cannot import them); these tests
hold the fields, defaults, constructors and derived values equal. The port
must never import jax (nor `regex`, which the machine with the card
lacks), and `chip_smoke.py` must fail without a GPU.
"""

import dataclasses
import os
import shutil
import subprocess
import sys

import pytest

from rdm_tpu.models.autoencoder import AutoencoderConfig as JAutoencoder
from rdm_tpu.models.clip import ClipConfig as JClip
from rdm_tpu.models.rarm import RARMConfig as JRARM
from rdm_tpu.models.rdm import RDMConfig as JRDM
from rdm_tpu.models.unet import UNetConfig as JUNet
from rdm_tpu.sampling import DDIMSamplerConfig as JDDIM
from rdm_tpu.training.trainer import TrainerConfig as JTrainer
from rdm_tpu_torch import config as port
from rdm_tpu_torch.training.trainer import TrainerConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PAIRS = {
    "unet": (port.UNetConfig, JUNet),
    "rdm": (port.RDMConfig, JRDM),
    "autoencoder": (port.AutoencoderConfig, JAutoencoder),
    "rarm": (port.RARMConfig, JRARM),
    "ddim": (port.DDIMSamplerConfig, JDDIM),
    "trainer": (TrainerConfig, JTrainer),
    "clip": (port.ClipConfig, JClip),
}

PORT_MODULES = [
    "rdm_tpu_torch", "rdm_tpu_torch.config", "rdm_tpu_torch.sampling",
    "rdm_tpu_torch.pipeline", "rdm_tpu_torch.ops.schedules",
    "rdm_tpu_torch.ops.attention", "rdm_tpu_torch.ops.block_kernel",
    "rdm_tpu_torch.ops._build", "rdm_tpu_torch.models.layers",
    "rdm_tpu_torch.models.unet", "rdm_tpu_torch.models.rdm",
    "rdm_tpu_torch.models.autoencoder", "rdm_tpu_torch.models.rarm",
    "rdm_tpu_torch.ops.decode_kernel", "rdm_tpu_torch.retrieval.engine",
    "rdm_tpu_torch.retrieval.database", "rdm_tpu_torch.utils.from_jax",
    "rdm_tpu_torch.ops.flash_attention", "rdm_tpu_torch.training.optim",
    "rdm_tpu_torch.training.ema", "rdm_tpu_torch.training.train_state",
    "rdm_tpu_torch.training.checkpoint", "rdm_tpu_torch.training.trainer",
    "rdm_tpu_torch.ops.knn_kernel", "rdm_tpu_torch.models.clip",
    "rdm_tpu_torch.models.retrievers", "rdm_tpu_torch.utils.tokenizer",
]


def _env_without_gpu():
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    env.pop("JAX_PLATFORMS", None)
    return env


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_fields_and_defaults_match(name):
    mine, ref = PAIRS[name]
    assert ([f.name for f in dataclasses.fields(mine)]
            == [f.name for f in dataclasses.fields(ref)])
    assert dataclasses.asdict(mine()) == dataclasses.asdict(ref())


@pytest.mark.parametrize("name,ctor", [
    ("unet", "imagenet_rdm"), ("unet", "ffhq_rdm"), ("rdm", "imagenet"),
    ("rdm", "ffhq"), ("autoencoder", "vq_f4"), ("autoencoder", "vq_f16"),
    ("autoencoder", "kl_f8"), ("rarm", "imagenet_dogs"), ("clip", "vit_b32")])
def test_named_configs_match(name, ctor):
    mine, ref = PAIRS[name]
    assert (dataclasses.asdict(getattr(mine, ctor)())
            == dataclasses.asdict(getattr(ref, ctor)()))


def test_derived_values_match():
    for kw in ({}, {"num_head_channels": -1, "num_heads": 8}):
        mine, ref = port.UNetConfig(**kw), JUNet(**kw)
        for ch in (192, 384, 576, 960):
            assert mine.heads_for(ch) == ref.heads_for(ch)
    for ctor in ("vq_f4", "vq_f16", "kl_f8"):
        mine = getattr(port.AutoencoderConfig, ctor)()
        ref = getattr(JAutoencoder, ctor)()
        assert mine.num_resolutions == ref.num_resolutions
        assert mine.downsample_factor == ref.downsample_factor
    assert port.RARMConfig().inner_dim == JRARM().inner_dim
    for kw in ({}, {"vision_width": 64, "transformer_width": 128,
                    "head_dim": 32, "resnet_layers": (3, 4, 6, 3)}):
        mine, ref = port.ClipConfig(**kw), JClip(**kw)
        assert mine.vision_heads == ref.vision_heads
        assert mine.transformer_heads == ref.transformer_heads


def test_port_never_imports_jax():
    code = ("import sys\n"
            f"for m in {PORT_MODULES!r}:\n"
            "    __import__(m)\n"
            "from rdm_tpu_torch.utils.tokenizer import tokenize\n"
            "tokenize(['a caption, ½ of Ⅻ'])\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'flax',\n"
            "                                    'rdm_tpu', 'regex'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env=_env_without_gpu(), capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_gpu(where, tmp_path):
    if where == "repo":
        cwd, env = REPO, _env_without_gpu()
    else:  # a directory holding chip_smoke.py and nothing else
        shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
        cwd, env = str(tmp_path), dict(_env_without_gpu(), PYTHONPATH="")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
