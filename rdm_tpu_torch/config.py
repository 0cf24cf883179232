"""Configuration dataclasses of the port.

Field-for-field mirrors of the JAX package's `UNetConfig`
(rdm_tpu/models/unet.py), `RDMConfig` (models/rdm.py), `AutoencoderConfig`
(models/autoencoder.py), `RARMConfig` (models/rarm.py), `ClipConfig`
(models/clip.py) and `DDIMSamplerConfig` (sampling.py). Those live
in modules that import flax, so they are mirrored here rather than
imported; a test holds the fields and defaults equal.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


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
