"""Frozen query / database embedders, in PyTorch.

Counterpart of `rdm_tpu/models/retrievers.py`:

- `ClipImageRetriever`: [-1, 1] NHWC images of any size -> bicubic resize
  to the CLIP resolution -> CLIP normalisation -> image tower -> 512-d.
- `ClipTextRetriever`: captions -> BPE tokens -> text tower -> 512-d (the
  query side of text-to-image).
- `VQGANRetriever`: images -> bicubic resize to `size` -> the VQ encoder's
  pre-quantisation latent, flattened (retrieval in latent space).

Each takes a state dict in the reference names and binds its module on
`device` in `dtype`; a call returns f32 embeddings on that device.
`VAERetriever` waits for the port's `AutoencoderKL`.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional, Sequence

import torch

from rdm_tpu_torch.config import AutoencoderConfig, ClipConfig
from rdm_tpu_torch.models.autoencoder import VQModel
from rdm_tpu_torch.models.clip import (CLIP, encode_captions, preprocess,
                                       resize_bicubic)


def _bind(module: torch.nn.Module, params: Mapping[str, Any], device,
          dtype: torch.dtype) -> torch.nn.Module:
    """The module, built on meta, bound to params, on device, >= 2-D
    parameters cast to dtype once."""
    module.load_state_dict(params, assign=True)
    module = module.to(device).eval()
    with torch.no_grad():
        for p in module.parameters():
            if p.ndim >= 2:
                p.data = p.data.to(dtype)
    return module


def bind_clip(params: Mapping[str, Any], config: Optional[ClipConfig] = None,
              device="cuda", dtype: torch.dtype = torch.bfloat16) -> CLIP:
    """A CLIP model bound to a state dict (`load_clip_state_dict`,
    `from_jax.clip_state_dict_from_jax`) on `device`, computing in
    `dtype`."""
    with torch.device("meta"):
        model = CLIP(config or ClipConfig.vit_b32(), dtype=dtype)
    return _bind(model, params, device, dtype)


def embed_images(model: CLIP, images: torch.Tensor) -> torch.Tensor:
    """[-1, 1] images NHWC -> CLIP image embeddings [B, embed_dim] f32."""
    x = preprocess(images, resolution=model.config.image_resolution)
    with torch.inference_mode():
        return model.encode_image(x.permute(0, 3, 1, 2))


class ClipImageRetriever:
    """images float [-1, 1] NHWC (any size) -> CLIP image embeddings."""

    def __init__(self, clip_params, config: Optional[ClipConfig] = None,
                 dtype: torch.dtype = torch.bfloat16, device="cuda"):
        self.model = bind_clip(clip_params, config, device, dtype)
        self.config = self.model.config
        self.device = torch.device(device)

    @property
    def embed_dim(self) -> int:
        return self.config.embed_dim

    def __call__(self, images) -> torch.Tensor:
        return embed_images(self.model, torch.as_tensor(
            images, dtype=torch.float32, device=self.device))


class ClipTextRetriever:
    """captions -> CLIP text embeddings (the query side of text-to-image)."""

    def __init__(self, clip_params, config: Optional[ClipConfig] = None,
                 dtype: torch.dtype = torch.bfloat16, device="cuda"):
        self.model = bind_clip(clip_params, config, device, dtype)
        self.config = self.model.config

    @property
    def embed_dim(self) -> int:
        return self.config.embed_dim

    def __call__(self, captions: Sequence[str]) -> torch.Tensor:
        return encode_captions(self.model, captions)


class VQGANRetriever:
    """images -> flattened VQ pre-quantisation latent (reference
    retrievers.py:18-40: resize to `size`, encode, flatten, here in the
    JAX package's NHWC order)."""

    def __init__(self, config: AutoencoderConfig, params, size: int = 256,
                 dtype: torch.dtype = torch.float32, device="cuda"):
        with torch.device("meta"):
            vq = VQModel(config, dtype=dtype)
        self.vq = _bind(vq, params, device, dtype)
        self.size = size
        self.device = torch.device(device)

    def __call__(self, images) -> torch.Tensor:
        x = torch.as_tensor(images, dtype=torch.float32, device=self.device)
        b = x.shape[0]
        x = resize_bicubic(x, self.size)
        with torch.inference_mode():
            z = self.vq.encode_prequant(x.permute(0, 3, 1, 2))
        return z.permute(0, 2, 3, 1).reshape(b, -1).float()
