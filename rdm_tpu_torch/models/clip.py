"""CLIP image and text towers, in PyTorch: the retrieval embedder.

Counterpart of `rdm_tpu/models/clip.py`: the ViT-B/32 image tower, the
RN50-style `ModifiedResNet` image tower and the text tower share one
512-d space, which is what lets a caption query a table of image
embeddings. The modules keep OpenAI's torch state-dict names
(`visual.transformer.resblocks.{i}.attn.in_proj_weight`, `visual.layer1.0.
downsample.0.weight`, `ln_final.weight`, ...), so a released checkpoint
(`load_clip_state_dict`) loads straight in and
`rdm_tpu/utils/torch_convert.py` `convert_clip` maps a port state dict
onto the JAX tree.

Numerics follow the JAX modules: matmuls and convolutions in the model's
`dtype`, LayerNorm statistics in f32 with dtype-native arithmetic,
BatchNorm (eval, running statistics) in f32, embeddings returned in f32
and unnormalised. The sequences are 77 text tokens and 50 image tokens,
below the flash-attention gate, so attention is the plain path.
`CLIP.encode_image` takes NCHW images (OpenAI's layout); `preprocess`
keeps the JAX package's NHWC.
"""

from __future__ import annotations

import collections
import functools
import zipfile
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from rdm_tpu_torch.config import ClipConfig
from rdm_tpu_torch.models.layers import Conv2d, LayerNormF32, Linear
from rdm_tpu_torch.ops.attention import dot_product_attention

__all__ = ["CLIP", "ClipConfig", "load_clip_state_dict", "preprocess"]

# CLIP preprocessing constants (OpenAI released values)
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class QuickGELU(nn.Module):
    def forward(self, x):
        return quick_gelu(x)


class MultiheadAttention(nn.Module):
    """torch.nn.MultiheadAttention's parameters (packed biased q/k/v
    `in_proj_weight` [3d, d], `out_proj`) over batch-first [B, S, d]."""

    def __init__(self, d: int, heads: int, causal: bool = False):
        super().__init__()
        self.heads, self.causal = heads, causal
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d, d))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d))
        self.out_proj = Linear(d, d)
        nn.init.xavier_uniform_(self.in_proj_weight)

    def forward(self, x):
        b, s, d = x.shape
        qkv = F.linear(x, self.in_proj_weight.to(x.dtype),
                       self.in_proj_bias.to(x.dtype))
        q, k, v = (t.reshape(b, s, self.heads, d // self.heads)
                   for t in qkv.chunk(3, dim=-1))
        out = dot_product_attention(q, k, v, causal=self.causal)
        return self.out_proj(out.reshape(b, s, d))


class ResidualAttentionBlock(nn.Module):
    def __init__(self, d: int, heads: int, causal: bool = False):
        super().__init__()
        self.attn = MultiheadAttention(d, heads, causal)
        self.ln_1 = LayerNormF32(d)
        self.mlp = nn.Sequential(collections.OrderedDict([
            ("c_fc", Linear(d, 4 * d)), ("gelu", QuickGELU()),
            ("c_proj", Linear(4 * d, d))]))
        self.ln_2 = LayerNormF32(d)

    def forward(self, x):
        x = x + self.attn(self.ln_1(x))
        return x + self.mlp(self.ln_2(x))


class Transformer(nn.Module):
    def __init__(self, width: int, layers: int, heads: int,
                 causal: bool = False):
        super().__init__()
        self.resblocks = nn.ModuleList(
            [ResidualAttentionBlock(width, heads, causal)
             for _ in range(layers)])

    def forward(self, x):
        for blk in self.resblocks:
            x = blk(x)
        return x


class VisionTransformer(nn.Module):
    """Patchify conv -> [CLS] + patches + positions -> ln_pre -> blocks ->
    ln_post of [CLS] -> projection."""

    def __init__(self, cfg: ClipConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        p, w = cfg.vision_patch_size, cfg.vision_width
        grid = cfg.image_resolution // p
        self.conv1 = Conv2d(3, w, p, stride=p, bias=False)
        self.class_embedding = nn.Parameter(0.02 * torch.randn(w))
        self.positional_embedding = nn.Parameter(
            0.01 * torch.randn(grid * grid + 1, w))
        self.ln_pre = LayerNormF32(w)
        self.transformer = Transformer(w, cfg.vision_layers, cfg.vision_heads)
        self.ln_post = LayerNormF32(w)
        self.proj = nn.Parameter(0.02 * torch.randn(w, cfg.embed_dim))

    def forward(self, x):
        """x [B, 3, R, R] preprocessed -> [B, embed_dim] f32."""
        x = self.conv1(x.to(self.dtype))
        b, w = x.shape[:2]
        x = x.reshape(b, w, -1).permute(0, 2, 1)
        cls = self.class_embedding.to(x.dtype).expand(b, 1, w)
        x = torch.cat([cls, x], dim=1) + self.positional_embedding.to(x.dtype)
        x = self.transformer(self.ln_pre(x))
        x = self.ln_post(x[:, 0])
        return (x @ self.proj.to(x.dtype)).float()


class BatchNorm2d(nn.BatchNorm2d):
    """Eval-mode BatchNorm on running statistics, in f32 (flax BatchNorm
    with use_running_average and dtype f32)."""

    def forward(self, x):
        return F.batch_norm(x.float(), self.running_mean, self.running_var,
                            self.weight.float(), self.bias.float(), False,
                            0.0, self.eps)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 -> avg-pool (stride > 1) -> 1x1 (4x), with an avg-pool +
    1x1 shortcut when the stride or the width changes (anti-aliased)."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        out = planes * self.expansion
        self.conv1 = Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = BatchNorm2d(planes)
        self.avgpool = nn.AvgPool2d(stride) if stride > 1 else nn.Identity()
        self.conv3 = Conv2d(planes, out, 1, bias=False)
        self.bn3 = BatchNorm2d(out)
        self.downsample = None
        if stride > 1 or inplanes != out:
            self.downsample = nn.Sequential(collections.OrderedDict([
                ("-1", nn.AvgPool2d(stride)),
                ("0", Conv2d(inplanes, out, 1, bias=False)),
                ("1", BatchNorm2d(out))]))

    def forward(self, x):
        dt = self.dtype
        h = F.relu(self.bn1(self.conv1(x.to(dt))))
        h = F.relu(self.bn2(self.conv2(h.to(dt))))
        h = self.bn3(self.conv3(self.avgpool(h).to(dt)))
        if self.downsample is not None:
            pool, conv, bn = self.downsample
            x = bn(conv(pool(x).to(dt)))
        return F.relu(h + x)


class AttentionPool2d(nn.Module):
    """Attention pooling with the mean token as the one query."""

    def __init__(self, spacial_dim: int, embed_dim: int, heads: int,
                 output_dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.heads, self.dtype = heads, dtype
        self.positional_embedding = nn.Parameter(
            torch.randn(spacial_dim ** 2 + 1, embed_dim) / embed_dim ** 0.5)
        self.k_proj = Linear(embed_dim, embed_dim)
        self.q_proj = Linear(embed_dim, embed_dim)
        self.v_proj = Linear(embed_dim, embed_dim)
        self.c_proj = Linear(embed_dim, output_dim)

    def forward(self, x):
        b, c = x.shape[:2]
        tokens = x.flatten(2).permute(0, 2, 1)
        tokens = torch.cat([tokens.mean(1, keepdim=True), tokens], dim=1)
        tokens = (tokens + self.positional_embedding.to(tokens.dtype)
                  ).to(self.dtype)
        hd = c // self.heads
        q = self.q_proj(tokens[:, :1]).reshape(b, 1, self.heads, hd)
        k = self.k_proj(tokens).reshape(b, -1, self.heads, hd)
        v = self.v_proj(tokens).reshape(b, -1, self.heads, hd)
        out = dot_product_attention(q, k, v).reshape(b, c)
        return self.c_proj(out).float()


class ModifiedResNet(nn.Module):
    """CLIP's RN50-style image tower: a three-conv stem with avg-pool, four
    bottleneck stages, attention pooling. The stride-2 stem conv pads
    (1, 1), as torch does (the JAX module pads explicitly)."""

    def __init__(self, layers: Tuple[int, ...], output_dim: int, heads: int,
                 input_resolution: int = 224, width: int = 64,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv1 = Conv2d(3, width // 2, 3, stride=2, padding=1,
                            bias=False)
        self.bn1 = BatchNorm2d(width // 2)
        self.conv2 = Conv2d(width // 2, width // 2, 3, padding=1, bias=False)
        self.bn2 = BatchNorm2d(width // 2)
        self.conv3 = Conv2d(width // 2, width, 3, padding=1, bias=False)
        self.bn3 = BatchNorm2d(width)
        self.avgpool = nn.AvgPool2d(2)
        inplanes, planes = width, width
        for stage, blocks in enumerate(layers):
            stride = 1 if stage == 0 else 2
            mods = []
            for blk in range(blocks):
                mods.append(Bottleneck(inplanes, planes,
                                       stride if blk == 0 else 1, dtype))
                inplanes = planes * Bottleneck.expansion
            setattr(self, f"layer{stage + 1}", nn.Sequential(*mods))
            planes *= 2
        self.n_stages = len(layers)
        # OpenAI's four stages: width * 32 channels at resolution / 32
        down = 4 * 2 ** (len(layers) - 1)
        self.attnpool = AttentionPool2d(input_resolution // down, inplanes,
                                        heads, output_dim, dtype)

    def forward(self, x):
        """x [B, 3, R, R] preprocessed -> [B, output_dim] f32."""
        dt = self.dtype
        x = F.relu(self.bn1(self.conv1(x.to(dt))))
        x = F.relu(self.bn2(self.conv2(x.to(dt))))
        x = F.relu(self.bn3(self.conv3(x.to(dt))))
        x = self.avgpool(x)
        for stage in range(self.n_stages):
            x = getattr(self, f"layer{stage + 1}")(x)
        return self.attnpool(x)


class CLIP(nn.Module):
    """Both towers and the logit scale. encode_image / encode_text return
    unnormalised embeddings; retrieval normalises queries itself."""

    def __init__(self, config: ClipConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        cfg = self.config = config
        self.dtype = dtype
        if cfg.resnet_layers is not None:
            self.visual = ModifiedResNet(
                cfg.resnet_layers, cfg.embed_dim, cfg.vision_width // 2,
                cfg.image_resolution, cfg.vision_width, dtype)
        else:
            self.visual = VisionTransformer(cfg, dtype)
        tw = cfg.transformer_width
        self.token_embedding = nn.Embedding(cfg.vocab_size, tw)
        self.positional_embedding = nn.Parameter(
            0.01 * torch.randn(cfg.context_length, tw))
        self.transformer = Transformer(tw, cfg.transformer_layers,
                                       cfg.transformer_heads, causal=True)
        self.ln_final = LayerNormF32(tw)
        self.text_projection = nn.Parameter(
            0.02 * torch.randn(tw, cfg.embed_dim))
        self.logit_scale = nn.Parameter(torch.tensor(float(np.log(1 / 0.07))))

    def encode_image(self, images: torch.Tensor) -> torch.Tensor:
        """Preprocessed images [B, 3, R, R] -> [B, embed_dim] f32."""
        return self.visual(images)

    def encode_text(self, tokens: torch.Tensor) -> torch.Tensor:
        """Token ids [B, L] -> [B, embed_dim] f32, read at the EOT token
        (the highest id of each row)."""
        x = self.token_embedding(tokens).to(self.dtype)
        x = x + self.positional_embedding[:x.shape[1]].to(x.dtype)
        x = self.ln_final(self.transformer(x))
        x = x[torch.arange(x.shape[0], device=x.device), tokens.argmax(-1)]
        return (x @ self.text_projection.to(x.dtype)).float()

    def forward(self, images, tokens):
        img = F.normalize(self.encode_image(images), dim=-1)
        txt = F.normalize(self.encode_text(tokens), dim=-1)
        return self.logit_scale.exp() * img @ txt.t()


# ------------------------------------------------------------ preprocess

def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """The Keys cubic kernel with a = -0.5 (jax.image's 'bicubic')."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out).astype(np.float32)


@functools.lru_cache(maxsize=None)
def resize_weights(n_in: int, n_out: int) -> torch.Tensor:
    """[n_in, n_out] f32 weights of jax.image.resize(..., 'bicubic') along
    one axis (`scale_and_translate` with antialias), computed in f32 in
    its order: the kernel widened by the downsampling factor, columns
    normalised, samples outside the input zeroed."""
    f32 = np.float32
    inv_scale = f32(1.0 / (n_out / n_in))
    kernel_scale = max(inv_scale, f32(1.0))
    sample = (np.arange(n_out, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None]
               ) / kernel_scale
    w = _keys_cubic(x)
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(f32).eps,
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.from_numpy(np.where(inside[None, :], w, f32(0.0))
                            .astype(f32))


def resize_bicubic(x: torch.Tensor, size: int) -> torch.Tensor:
    """f32 NHWC images -> [B, size, size, C], as jax.image.resize(...,
    'bicubic'): one product per axis with `resize_weights`."""
    _, h, w, _ = x.shape
    if h != size:
        x = torch.einsum("bhwc,hH->bHwc", x,
                         resize_weights(h, size).to(x.device))
    if w != size:
        x = torch.einsum("bhwc,wW->bhWc", x,
                         resize_weights(w, size).to(x.device))
    return x


def preprocess(images: torch.Tensor, resolution: int = 224,
               input_range: str = "minus1_1") -> torch.Tensor:
    """Bicubic resize (jax.image.resize's, as two separable f32 products)
    and CLIP normalisation, NHWC in and out, f32.

    input_range: "minus1_1" ([-1, 1], the framework's image range) or
    "unit" ([0, 1])."""
    x = images.float()
    if input_range == "minus1_1":
        x = x * 0.5 + 0.5
    elif input_range != "unit":
        raise ValueError(input_range)
    x = resize_bicubic(x, resolution).clamp(0.0, 1.0)
    mean = torch.tensor(CLIP_MEAN, device=x.device)
    std = torch.tensor(CLIP_STD, device=x.device)
    return (x - mean) / std


# ------------------------------------------------------------ loading

_META_KEYS = ("input_resolution", "context_length", "vocab_size")


def load_clip_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A CLIP state dict in OpenAI's names, f32, from a TorchScript archive
    (the released `ViT-B-32.pt`) or a `torch.save`d dict (optionally
    under 'state_dict'); the archives' non-weight entries are dropped."""
    with zipfile.ZipFile(path) as zf:
        scripted = any(n.endswith("constants.pkl") for n in zf.namelist())
    if scripted:
        sd = torch.jit.load(path, map_location="cpu").state_dict()
    else:
        sd = torch.load(path, map_location="cpu", weights_only=True)
        sd = sd.get("state_dict", sd)
    return {k: (v.float() if v.is_floating_point() else v)
            for k, v in sd.items() if k not in _META_KEYS}


def clip_config_from_state_dict(sd) -> ClipConfig:
    """The ViT CLIP architecture of an OpenAI state dict (the JAX
    package's `clip_config_from_state_dict`)."""
    conv = sd["visual.conv1.weight"]
    vision_layers = len({k.split(".")[3] for k in sd
                         if k.startswith("visual.transformer.resblocks.")})
    grid = int(round((sd["visual.positional_embedding"].shape[0] - 1) ** 0.5))
    return ClipConfig(
        embed_dim=sd["text_projection"].shape[1],
        image_resolution=grid * conv.shape[-1],
        vision_width=conv.shape[0], vision_layers=vision_layers,
        vision_patch_size=conv.shape[-1],
        context_length=sd["positional_embedding"].shape[0],
        vocab_size=sd["token_embedding.weight"].shape[0],
        transformer_width=sd["ln_final.weight"].shape[0],
        transformer_layers=len({k.split(".")[2] for k in sd
                                if k.startswith("transformer.resblocks.")}))


def encode_captions(model: CLIP, captions, device: Optional[torch.device]
                    = None) -> torch.Tensor:
    """Captions -> CLIP text embeddings [B, embed_dim] f32 on the model's
    device (tokenize -> text tower)."""
    from rdm_tpu_torch.utils.tokenizer import tokenize

    dev = device or model.positional_embedding.device
    toks = torch.from_numpy(tokenize(list(captions),
                                     model.config.context_length)).to(dev)
    with torch.inference_mode():
        return model.encode_text(toks.long())
