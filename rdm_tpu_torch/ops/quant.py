"""Post-training int8 quantization of the RDM serving path, in PyTorch.

Counterpart of `rdm_tpu/ops/quant.py`. Recipe:

- weights: symmetric per-output-channel int8, quantized once from the
  serving weights (scales in f32, floor 1e-12);
- activations: symmetric per-tensor int8 with a STATIC scale
  (absmax / 127, floor 1e-12 for the convs) calibrated on a real sampling
  trajectory;
- dequantization on the conv output: y = conv_int8(x_q, w_q) * (a_s *
  w_s[o]) + bias.

Calibration runs the model inside `calibrate()`: every quantizable
`models.layers.Conv2d` records the max |x| of its input, every
`CrossAttention` its input and output, every `GEGLUFeedForward` its input
and gated hidden activation, and every `SpatialTransformer` runs its
unfused blocks (the fused kernels neither record nor need calibrating
against themselves). The records live on the modules; `collect_absmax`
gathers them into a flat tree keyed by module name,
{"input_blocks.1.0.in_layers.2": {"act_absmax": t}, ...}, the port's form
of the JAX "intermediates" tree.

`quantize_conv_tree` then gives every calibrated conv its int8 serving
state and every TransformerBlock its activation scales, in place. The
exclusions are modules, not names: the U-Net's conv_in / out conv and the
VQ decoder's conv_in / conv_out / post_quant_conv (`unet_exclude`,
`decoder_exclude`) stay in the compute dtype, as the JAX leaf names
`("conv_in", "out_conv")` and `("conv_in", "conv_out", "post_quant_conv")`
keep them.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterable, Optional

import numpy as np
import torch
from torch import nn

# Read by the modules at run time: while True they record activation
# max-abs and SpatialTransformer runs its unfused blocks.
CALIBRATE = False

Absmax = Dict[str, Dict[str, torch.Tensor]]


@contextlib.contextmanager
def calibrate():
    """Record activation max-abs in every forward run inside this block."""
    global CALIBRATE
    prev = CALIBRATE
    CALIBRATE = True
    try:
        yield
    finally:
        CALIBRATE = prev


def record(module: nn.Module, name: str, t: torch.Tensor) -> None:
    """Running max of |t| under `module._absmax[name]` (f32 scalar), while
    calibrating; a no-op otherwise."""
    if not CALIBRATE:
        return
    m = t.detach().float().abs().max()
    rec = module.__dict__.setdefault("_absmax", {})
    rec[name] = m if name not in rec else torch.maximum(rec[name], m)


def collect_absmax(model: nn.Module, clear: bool = True) -> Absmax:
    """{module name: {record name: f32 scalar}} of every record under
    `model` (names relative to it); `clear` empties the records."""
    out = {}
    for name, mod in model.named_modules():
        rec = mod.__dict__.get("_absmax")
        if rec:
            out[name] = dict(rec)
            if clear:
                rec.clear()
    return out


def merge_absmax(a: Optional[Absmax], b: Optional[Absmax]) -> Absmax:
    """Elementwise max of two calibration trees of the same structure."""
    if a is None:
        return b
    if b is None:
        return a
    return {m: {k: torch.maximum(v, b[m][k]) for k, v in rec.items()}
            for m, rec in a.items()}


def unet_exclude(unet: nn.Module) -> tuple:
    """The U-Net convs kept in the compute dtype: conv_in and the eps head
    (together <0.5% of the FLOPs; the head sets pred_x0 directly)."""
    return unet.input_blocks[0][0], unet.out[2]


def decoder_exclude(vq: nn.Module) -> tuple:
    """The VQ decoder convs kept in the compute dtype."""
    return vq.decoder.conv_in, vq.decoder.conv_out, vq.post_quant_conv


def quantize_conv_tree(model: nn.Module, calib: Absmax, *,
                       exclude: Iterable[nn.Module] = ()) -> nn.Module:
    """Give `model` its int8 serving state in place, from a calibration
    tree of `collect_absmax(model)`'s form: every quantizable conv with a
    recorded `act_absmax` that is not in `exclude` gets int8 weights and
    scales (`Conv2d.quantize`); every transformer block whose attn1, attn2
    and ff records are all present gets its six activation absmax
    (`TransformerBlock.set_qabsmax`). Returns `model`."""
    if not calib:
        raise ValueError("calibration tree is empty: run the forward "
                         "inside quant.calibrate() and collect_absmax()")
    skip = {id(m) for m in exclude}
    for name, mod in model.named_modules():
        pre = f"{name}." if name else ""
        if hasattr(mod, "quantize") and id(mod) not in skip \
                and "act_absmax" in calib.get(name, {}):
            mod.quantize(calib[name]["act_absmax"])
        elif hasattr(mod, "set_qabsmax"):
            recs = [calib.get(pre + sub, {}).get(k) for sub, k in (
                ("attn1", "act_absmax"), ("attn1", "out_absmax"),
                ("attn2", "act_absmax"), ("attn2", "out_absmax"),
                ("ff", "act_absmax"), ("ff", "hidden_absmax"))]
            if all(r is not None for r in recs):
                mod.set_qabsmax(torch.stack([r.float() for r in recs]))
    return model


def num_quantized(model: nn.Module) -> int:
    """Count the convs that run int8."""
    return sum(1 for m in model.modules()
               if getattr(m, "qweight", None) is not None)


def ddim_trajectory_absmax(forward, z: torch.Tensor, schedule,
                           num_steps: int, context: Optional[torch.Tensor],
                           model: nn.Module, generator: torch.Generator,
                           n_points: int = 8) -> Absmax:
    """Calibrate activation max-abs over a DDIM trajectory.

    forward(x, t, context) runs `model`'s forward. `z` is a batch of final
    latents in MODEL scale (the sampler's x_0); the calibration inputs are
    q_sample(z, t) at `n_points` timesteps spread over the DDIM ladder —
    the forward-diffusion marginal the eps-model was trained on — with
    noise from `generator`. `context` must be in the exact serving form
    (e.g. the shared-prefix CFG (cond, uncond) stack) so every conv sees
    its serving batch shape."""
    from rdm_tpu_torch.ops.schedules import DDIMSchedule, q_sample

    ddim = DDIMSchedule.create(schedule, num_steps)
    steps = ddim.timesteps.numpy()
    pick = np.unique(np.linspace(0, len(steps) - 1,
                                 min(n_points, len(steps))).astype(int))
    collect_absmax(model)  # drop any stale record
    absmax = None
    with calibrate(), torch.no_grad():
        for idx in pick:
            t = torch.full((z.shape[0],), int(steps[idx]), dtype=torch.long,
                           device=z.device)
            noise = torch.randn(z.shape, generator=generator,
                                device=generator.device).to(z.device)
            forward(q_sample(schedule, z, t, noise), t, context)
            absmax = merge_absmax(absmax, collect_absmax(model))
    return absmax
