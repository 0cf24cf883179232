"""rdm_tpu_torch — the PyTorch/CUDA port of rdm_tpu for NVIDIA Hopper.

The JAX package `rdm_tpu` is the reference each part of the port is held
against; this package imports torch and never jax. The module layout
mirrors `rdm_tpu/`. The hand-written CUDA kernels live in `csrc/` and are
built at first use by `ops/_build.py`.
"""

from rdm_tpu_torch.config import (AutoencoderConfig, DDIMSamplerConfig,
                                  RARMConfig, RDMConfig, UNetConfig)

__all__ = ["AutoencoderConfig", "DDIMSamplerConfig", "RARMConfig",
           "RDMConfig", "UNetConfig"]
