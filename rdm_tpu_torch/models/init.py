"""The JAX package's initialisers, for a model trained from scratch.

The port's modules are built with PyTorch's default initialisers: cheap
on the meta device, and replaced by loaded weights wherever a pipeline or
a trainer binds them. A model that starts from scratch (`RDMTrainer` /
`RARMTrainer.init_state`, `from_model_dir(random_init=True)`, the micro
gates' random-init baselines) takes `jax_init_`, which draws what the JAX
package's `init` draws, leaf by leaf, from an explicit generator:

- Dense / Conv kernels (`nn.Linear`, `nn.Conv1d`, `nn.Conv2d`): flax's
  `lecun_normal`, a normal truncated at two standard deviations and
  scaled to variance 1 / fan_in; biases zero;
- the residual heads the JAX package zero-inits (marked by `zero_init`:
  the ResBlock's conv2, the SpatialTransformer's proj_out, the U-Net's
  eps head; `rdm_tpu/models/layers.py:422`, `:841-845`,
  `rdm_tpu/models/unet.py:262`): zero, bias too;
- norm scales one, norm biases zero;
- embeddings: `nn.Embed`'s default, normal with std 1 / sqrt(features);
- what a module draws itself (its `jax_init_own(generator)`, which returns
  the parameters it drew): the VQ codebook uniform in [0, 2 / n_embed),
  the RDM's guidance vector normal(1), the RARM's positional table
  normal(inner^-0.5).
"""

from __future__ import annotations

import math
from typing import List

import torch
from torch import nn

__all__ = ["jax_init_", "lecun_normal", "normal", "zero_init"]

# the standard deviation of a unit normal truncated to [-2, 2]: flax's
# truncated lecun_normal divides its scale by it
_TRUNC_STD = 0.87962566103423978
_PHI_M2 = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))  # P(N(0, 1) < -2)


def zero_init(module: nn.Module) -> nn.Module:
    """Mark a Linear / Conv the JAX package initialises at zero."""
    module.zero_init = True
    return module


def lecun_normal(shape, generator: torch.Generator) -> torch.Tensor:
    """flax `lecun_normal` for a PyTorch weight [out, in, *kernel]: a normal
    of std sqrt(1 / fan_in) / 0.8796 truncated at two of its standard
    deviations (inverse CDF of a uniform draw from `generator`)."""
    fan_in = math.prod(shape[1:])
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    u = torch.rand(shape, generator=generator, device=generator.device)
    u = u * (1.0 - 2.0 * _PHI_M2) + _PHI_M2
    z = torch.erfinv(2.0 * u - 1.0) * math.sqrt(2.0)
    return z.clamp_(-2.0, 2.0) * std


def normal(shape, std: float, generator: torch.Generator) -> torch.Tensor:
    return torch.randn(shape, generator=generator,
                       device=generator.device) * std


def _put(p: torch.Tensor, v: torch.Tensor) -> None:
    p.copy_(v.to(p.device, p.dtype))


@torch.no_grad()
def jax_init_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Redraw every parameter of `model` as the JAX package's `init` does
    (module docstring), in place, from `generator`. Returns `model`."""
    own: set = set()
    for m in model.modules():
        hook = getattr(m, "jax_init_own", None)
        if hook is not None:
            own.update(id(p) for p in hook(generator))
    for m in model.modules():
        params: List[nn.Parameter] = list(m.parameters(recurse=False))
        if not params or all(id(p) in own for p in params):
            continue
        if isinstance(m, (nn.Linear, nn.Conv1d, nn.Conv2d)):
            if getattr(m, "zero_init", False):
                m.weight.zero_()
            else:
                _put(m.weight, lecun_normal(tuple(m.weight.shape),
                                            generator))
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.Embedding):
            _put(m.weight, normal(tuple(m.weight.shape),
                                  m.weight.shape[1] ** -0.5, generator))
        elif hasattr(m, "weight") and hasattr(m, "bias") \
                and m.weight.ndim == 1:  # GroupNorm32, LayerNormF32
            m.weight.fill_(1.0)
            m.bias.zero_()
        else:
            raise TypeError(f"no JAX initialiser for {type(m).__name__}")
    return model
