"""One attention core serves two TPU kernels: the port's `packed_attn` and
`flash_fwd` against the JAX `_packed_attn_kernel`, on the CPU.

On the card both wrappers launch the same Hopper core
(`rdm_tpu_torch/csrc/attn_fwd_sm90.cuh`), `packed_attn` reading its
[B, S, C] memory as BSHD [B, S, C / 32, 32]. This file pins the premise
that this is one function: the Pallas `_packed_attn_kernel` runs through a
`pl.pallas_call(..., interpret=True)` built here, over [1, S, 128] blocks
(4 heads of 32 in the 128 lanes, one image per cell, as the JAX wrapper's
row-tiled grid gives them), and both port wrappers on the CPU (their plain
versions) are held against it on the same numpy-seeded f32 inputs, at
S = 64, 100 (not a multiple of any tile) and 256, B = 2. Tolerance atol
2e-5, rtol 1e-4, as in tests/test_torch_port_flash.py: f32 sums in another
order over up to 256 keys.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from rdm_tpu.ops import block_kernel as jbk
from rdm_tpu_torch.ops import block_kernel as bk
from rdm_tpu_torch.ops import flash_attention as fa

ATOL, RTOL = 2e-5, 1e-4
B, HEADS, HD = 2, 4, 32


def _pallas_packed_attn(q, k, v) -> np.ndarray:
    """The TPU kernel in interpret mode: grid (image, 128-lane group), each
    cell the whole [S, 128] of its image and group."""
    b, s, c = q.shape
    spec = pl.BlockSpec((1, s, 128), lambda bi, gi: (bi, 0, gi))
    out = pl.pallas_call(
        functools.partial(jbk._packed_attn_kernel, head_dim=HD,
                          scale=float(HD) ** -0.5),
        grid=(b, c // 128), in_specs=[spec, spec, spec], out_specs=spec,
        out_shape=jax.ShapeDtypeStruct((b, s, c), jnp.float32),
        interpret=True)(*(jnp.asarray(a) for a in (q, k, v)))
    return np.asarray(out)


def _packed(q, k, v):
    return bk.packed_attn(q, k, v, heads=HEADS, head_dim=HD)


def _flash(q, k, v):
    b, s, c = q.shape
    shp = (b, s, c // HD, HD)
    o = fa.flash_fwd(q.view(shp), k.view(shp), v.view(shp),
                     scale=HD ** -0.5, causal=False)
    return o.reshape(b, s, c)


@pytest.mark.parametrize("entry", [_packed, _flash],
                         ids=["packed_attn", "flash_fwd"])
@pytest.mark.parametrize("s", [64, 100, 256])
def test_attention_core_matches_pallas_packed_attn(entry, s):
    rng = np.random.default_rng(s)
    q, k, v = (rng.standard_normal((B, s, HEADS * HD)).astype(np.float32)
               for _ in range(3))
    want = _pallas_packed_attn(q, k, v)
    got = entry(*(torch.from_numpy(a) for a in (q, k, v)))
    assert got.dtype == torch.float32 and got.shape == (B, s, HEADS * HD)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)
