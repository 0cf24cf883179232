"""Configuration dataclasses of the port.

Field-for-field mirrors of the JAX package's `UNetConfig`
(rdm_tpu/models/unet.py), `RDMConfig` (models/rdm.py), `AutoencoderConfig`
(models/autoencoder.py), `RARMConfig` (models/rarm.py), `ClipConfig`
(models/clip.py) and `DDIMSamplerConfig` (sampling.py). Those live
in modules that import flax, so they are mirrored here rather than
imported; a test holds the fields and defaults equal. Below them, the YAML
loaders of `rdm_tpu/config.py`, which translate released and repo
configs into these dataclasses.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 3
    out_channels: int = 3
    model_channels: int = 192
    num_res_blocks: int = 2
    attention_resolutions: Tuple[int, ...] = (2, 4, 8)  # ds values
    channel_mult: Tuple[int, ...] = (1, 2, 3, 5)
    num_heads: int = -1
    num_head_channels: int = 32
    transformer_depth: int = 1
    context_dim: Optional[int] = 512
    dropout: float = 0.0
    use_scale_shift_norm: bool = False
    resblock_updown: bool = False
    num_classes: Optional[int] = None
    conv_resample: bool = True

    @classmethod
    def imagenet_rdm(cls) -> "UNetConfig":
        return cls()

    @classmethod
    def ffhq_rdm(cls) -> "UNetConfig":
        return cls(model_channels=224, channel_mult=(1, 2, 3, 4))

    def heads_for(self, ch: int) -> Tuple[int, int]:
        """(num_heads, head_dim) for a channel count."""
        if self.num_head_channels == -1:
            return self.num_heads, ch // self.num_heads
        return ch // self.num_head_channels, self.num_head_channels


@dataclasses.dataclass(frozen=True)
class RDMConfig:
    unet: UNetConfig = dataclasses.field(
        default_factory=UNetConfig.imagenet_rdm)
    image_size: int = 64  # latent spatial size
    channels: int = 3  # latent channels
    timesteps: int = 1000
    beta_schedule: str = "linear"
    linear_start: float = 0.0015
    linear_end: float = 0.0195
    k_nn: int = 4
    n_patches_per_side: int = 1
    context_dim: int = 512
    conditioning_key: str = "retro_only"
    nn_encoder: Optional[str] = None
    nn_encoder_depth: int = 2
    nn_encoder_heads: int = 8
    nn_encoder_head_dim: int = 64
    p_uncond: float = 0.0
    scale_factor: float = 1.0
    parameterization: str = "eps"
    learn_logvar: bool = False
    logvar_init: float = 0.0
    l_simple_weight: float = 1.0
    original_elbo_weight: float = 0.0
    retro_noise: bool = False

    @classmethod
    def imagenet(cls) -> "RDMConfig":
        return cls()

    @classmethod
    def ffhq(cls) -> "RDMConfig":
        return cls(unet=UNetConfig.ffhq_rdm())


@dataclasses.dataclass(frozen=True)
class AutoencoderConfig:
    ch: int = 128
    ch_mult: Tuple[int, ...] = (1, 2, 4)
    num_res_blocks: int = 2
    attn_resolutions: Tuple[int, ...] = ()
    in_channels: int = 3
    out_ch: int = 3
    z_channels: int = 3
    resolution: int = 256
    double_z: bool = False
    dropout: float = 0.0
    embed_dim: int = 3
    n_embed: int = 8192  # 0 => KL model

    @classmethod
    def vq_f4(cls) -> "AutoencoderConfig":
        return cls()

    @classmethod
    def vq_f16(cls) -> "AutoencoderConfig":
        return cls(ch_mult=(1, 1, 2, 2, 4), attn_resolutions=(16,),
                   z_channels=256, embed_dim=256, n_embed=16384)

    @classmethod
    def kl_f8(cls) -> "AutoencoderConfig":
        return cls(ch_mult=(1, 2, 4, 4), z_channels=4, embed_dim=4,
                   double_z=True, n_embed=0)

    @property
    def num_resolutions(self) -> int:
        return len(self.ch_mult)

    @property
    def downsample_factor(self) -> int:
        return 2 ** (self.num_resolutions - 1)


@dataclasses.dataclass(frozen=True)
class RARMConfig:
    vocab_size: int = 16386  # input vocab incl. mask + sos
    out_vocab: int = 16384
    heads: int = 12
    head_dim: int = 64
    depth: int = 18
    context_dim: int = 512
    seq_len: int = 256  # image token count (16x16 VQ-f16 grid)
    sos_token: int = 16385
    mask_token: int = 16384
    code_side: int = 16
    p_mask_max: float = 0.0

    @property
    def inner_dim(self) -> int:
        return self.heads * self.head_dim

    @classmethod
    def imagenet_dogs(cls) -> "RARMConfig":
        return cls()


@dataclasses.dataclass(frozen=True)
class ClipConfig:
    embed_dim: int = 512
    # vision
    image_resolution: int = 224
    vision_width: int = 768
    vision_layers: int = 12
    vision_patch_size: int = 32
    # text
    context_length: int = 77
    vocab_size: int = 49408
    transformer_width: int = 512
    transformer_layers: int = 12
    head_dim: int = 64  # OpenAI convention: heads = width / 64
    # the RN50-style tower in place of the ViT: the stage depths
    resnet_layers: Optional[Tuple[int, ...]] = None  # e.g. (3, 4, 6, 3)

    @property
    def vision_heads(self) -> int:
        return self.vision_width // self.head_dim

    @property
    def transformer_heads(self) -> int:
        return self.transformer_width // self.head_dim

    @classmethod
    def vit_b32(cls) -> "ClipConfig":
        return cls()


@dataclasses.dataclass(frozen=True)
class DDIMSamplerConfig:
    num_steps: int = 100
    eta: float = 0.0
    method: str = "uniform"
    temperature: float = 1.0
    guidance_scale: float = 1.0  # 1.0 => no CFG branch
    log_every_t: int = 0  # 0 => no intermediates
    # "double": x/t/context tiled to 2B through one denoiser call;
    # "shared": x/t at B with the stacked [cond; uncond] context at 2B
    # (the U-Net runs its context-free prefix once)
    cfg_mode: str = "double"
    # encoder reuse: the U-Net down path + middle rerun only every N-th
    # step (1 = exact sampling; > 1 approximate)
    encoder_reuse: int = 1


# ---------------------------------------------------------------------------
# reference YAML configs (the JAX package's rdm_tpu/config.py:31-198)
# ---------------------------------------------------------------------------
# Released `config.yaml` files and the repo's configs/ load into the
# dataclasses above: multiple YAMLs merged left to right, then
# `key.path=value` dotlist overrides (reference main.py:777-779). PyYAML
# is imported where a file or a value is parsed, so nothing that builds
# its configs in memory needs it.

def load_yaml(path: str) -> Dict[str, Any]:
    import yaml

    with open(path) as f:
        return yaml.safe_load(f) or {}


def deep_merge(base: Dict[str, Any], override: Dict[str, Any]
               ) -> Dict[str, Any]:
    out = dict(base)
    for k, v in override.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def _parse_value(s: str) -> Any:
    import yaml

    return yaml.safe_load(s)


def apply_dotlist(cfg: Dict[str, Any], dotlist: Sequence[str]
                  ) -> Dict[str, Any]:
    """`a.b.c=value` overrides, values parsed as YAML scalars."""
    cfg = dict(cfg)
    for item in dotlist:
        if "=" not in item:
            raise ValueError(f"dotlist item {item!r} is not key=value")
        key, value = item.split("=", 1)
        node = cfg
        parts = key.split(".")
        for p in parts[:-1]:
            nxt = node.get(p)
            if not isinstance(nxt, dict):
                nxt = {}
            node[p] = dict(nxt)
            node = node[p]
        node[parts[-1]] = _parse_value(value)
    return cfg


def load_config(bases: Sequence[str], dotlist: Sequence[str] = ()
                ) -> Dict[str, Any]:
    cfg: Dict[str, Any] = {}
    for b in bases:
        cfg = deep_merge(cfg, load_yaml(b))
    return apply_dotlist(cfg, dotlist)


def unet_config_from_params(p: Dict[str, Any]) -> UNetConfig:
    """Reference unet_config params (models/rdm/imagenet/config.yaml:36-59)
    -> UNetConfig."""
    return UNetConfig(
        in_channels=p.get("in_channels", 3),
        out_channels=p.get("out_channels", 3),
        model_channels=p.get("model_channels", 192),
        num_res_blocks=p.get("num_res_blocks", 2),
        attention_resolutions=tuple(p.get("attention_resolutions",
                                          (2, 4, 8))),
        channel_mult=tuple(p.get("channel_mult", (1, 2, 3, 5))),
        num_heads=p.get("num_heads", -1),
        num_head_channels=p.get("num_head_channels", -1),
        transformer_depth=p.get("transformer_depth", 1),
        context_dim=p.get("context_dim"),
        dropout=p.get("dropout", 0.0),
        use_scale_shift_norm=p.get("use_scale_shift_norm", False),
        resblock_updown=p.get("resblock_updown", False),
        num_classes=p.get("num_classes"),
        conv_resample=p.get("conv_resample", True),
    )


def autoencoder_config_from_params(p: Dict[str, Any]) -> AutoencoderConfig:
    """A first_stage_config params block (embed_dim / n_embed + ddconfig)
    -> AutoencoderConfig."""
    dd = p.get("ddconfig", {})
    return AutoencoderConfig(
        ch=dd.get("ch", 128),
        ch_mult=tuple(dd.get("ch_mult", (1, 2, 4))),
        num_res_blocks=dd.get("num_res_blocks", 2),
        attn_resolutions=tuple(dd.get("attn_resolutions", ())),
        in_channels=dd.get("in_channels", 3),
        out_ch=dd.get("out_ch", 3),
        z_channels=dd.get("z_channels", 3),
        resolution=dd.get("resolution", 256),
        double_z=dd.get("double_z", False),
        dropout=dd.get("dropout", 0.0),
        embed_dim=p.get("embed_dim", 3),
        n_embed=p.get("n_embed", 0),
    )


def rdm_config_from_model_config(model_cfg: Dict[str, Any]) -> RDMConfig:
    """A reference RDM model config (target MinimalRETRODiffusion) ->
    RDMConfig."""
    p = model_cfg.get("params", model_cfg)
    unet = unet_config_from_params(p.get("unet_config", {}).get("params",
                                                                {}))
    return RDMConfig(
        unet=unet,
        image_size=p.get("image_size", 64),
        channels=p.get("channels", 3),
        timesteps=p.get("timesteps", 1000),
        beta_schedule=p.get("beta_schedule", "linear"),
        linear_start=p.get("linear_start", 0.0015),
        linear_end=p.get("linear_end", 0.0195),
        k_nn=p.get("k_nn", 4),
        n_patches_per_side=p.get("n_patches_per_side", 1),
        context_dim=unet.context_dim or 512,
        p_uncond=p.get("p_uncond", 0.0),
        scale_factor=p.get("scale_factor", 1.0),
        parameterization=p.get("parameterization", "eps"),
        learn_logvar=p.get("learn_logvar", False),
        logvar_init=p.get("logvar_init", 0.0),
        l_simple_weight=p.get("l_simple_weight", 1.0),
        original_elbo_weight=p.get("original_elbo_weight", 0.0),
        retro_noise=p.get("retro_noise", False),
    )


def rarm_config_from_model_config(model_cfg: Dict[str, Any]) -> RARMConfig:
    """A reference RARM model config (target LatentImageRETRO +
    transformer_config RetrievalPatchTransformer) -> RARMConfig."""
    p = model_cfg.get("params", model_cfg)
    t = p.get("transformer_config", {}).get("params", {})
    seq_len = t.get("sequence_length", 256)
    return RARMConfig(
        vocab_size=t.get("in_channels", 16386),
        out_vocab=t.get("out_channels", 16384),
        heads=t.get("n_heads", 12),
        head_dim=t.get("d_head", 64),
        depth=t.get("depth", 18),
        context_dim=t.get("context_dim", 512),
        seq_len=seq_len,
        sos_token=p.get("sos_token", 16385),
        mask_token=p.get("mask_token", 16384),
        code_side=int(round(seq_len ** 0.5)),  # a square token grid
        p_mask_max=p.get("p_mask_max", 0.0),
    )


# target path -> translator: the reference's import paths and the JAX
# package's, as configs name them
MODEL_TRANSLATORS: Dict[str, Callable[[Dict[str, Any]], Any]] = {
    "rdm.models.diffusion.ddpm.MinimalRETRODiffusion":
        rdm_config_from_model_config,
    "rdm_tpu.models.rdm.RDM": rdm_config_from_model_config,
    "rdm.models.autoregression.transformer.LatentImageRETRO":
        rarm_config_from_model_config,
    "rdm_tpu.models.rarm.RARM": rarm_config_from_model_config,
}


def model_config_from_yaml(cfg: Dict[str, Any]) -> Any:
    """cfg: the whole merged YAML (with a `model:` block) or the model
    block itself -> RDMConfig or RARMConfig."""
    model_cfg = cfg.get("model", cfg)
    target = model_cfg.get("target", "")
    for key, translate in MODEL_TRANSLATORS.items():
        if target == key or target.endswith(key.split(".")[-1]):
            return translate(model_cfg)
    raise ValueError(f"unknown model target {target!r}")


def first_stage_config_from_yaml(cfg: Dict[str, Any]) -> AutoencoderConfig:
    model_cfg = cfg.get("model", cfg)
    p = model_cfg.get("params", model_cfg)
    fs = p.get("first_stage_config", {})
    return autoencoder_config_from_params(fs.get("params", {}))
