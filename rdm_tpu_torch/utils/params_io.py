"""Parameter files a model directory holds, read into the port's state
dicts.

- `load_params_npz`: a JAX parameter tree flattened into one npz (path
  keys joined by "|", as `rdm_tpu/utils/params_io.py` writes it), back to
  the nested dict `utils/from_jax` converts.
- `load_torch_state_dict`: a `.ckpt` / `.pt` (a Lightning checkpoint's
  "state_dict", or a bare state dict).
- `rdm_state_dicts` / `rarm_state_dicts`: a released checkpoint's state
  dict split into the model's and the first stage's, in the port's names
  (which are the reference's). With `use_ema` the RDM takes the
  `model_ema.*` weights: LitEma stores each under its parameter's name
  with the dots removed, so they are matched by that stripped name (the
  JAX package's `convert_rdm`, rdm_tpu/utils/torch_convert.py:433-460).
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, Tuple

import numpy as np
import torch

_SEP = "|"  # flax parameter names may hold "/"
_EMA = "model_ema."
_FIRST_STAGE = "first_stage_model."


def load_params_npz(path: str) -> Dict[str, Any]:
    """The nested parameter tree of an npz written by the JAX package's
    `save_params_npz`."""
    tree: Dict[str, Any] = {}
    with np.load(path) as data:
        for key in data.files:
            node = tree
            parts = key.split(_SEP)
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = data[key]
    return tree


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """The state dict of a torch checkpoint file, on the CPU."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("state_dict", ckpt) if isinstance(ckpt, dict) else ckpt
    return {k: (v if isinstance(v, torch.Tensor) else torch.as_tensor(v))
            for k, v in sd.items()}


def swap_in_ema(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """`sd` with every `model.*` weight that has a `model_ema.*` copy
    replaced by that copy (LitEma's names: the parameter's name under
    `model.` with its dots removed)."""
    out = dict(sd)
    flat_to_orig = {k[len("model."):].replace(".", ""): k
                    for k in sd if k.startswith("model.")}
    for k, v in sd.items():
        if not k.startswith(_EMA) or k in (_EMA + "num_updates",
                                           _EMA + "decay"):
            continue
        orig = flat_to_orig.get(k[len(_EMA):])
        if orig is not None:
            out[orig] = v
    return out


def _pick(sd: Dict[str, torch.Tensor], keys: Iterable[str], prefix: str,
          what: str) -> Dict[str, torch.Tensor]:
    missing = [k for k in keys if prefix + k not in sd]
    if missing:
        raise KeyError(f"{what}: the checkpoint lacks {len(missing)} "
                       f"weights, e.g. {prefix + missing[0]!r}")
    return {k: sd[prefix + k].float() if sd[prefix + k].is_floating_point()
            else sd[prefix + k] for k in keys}


def _keys(module_cls, *args, **kwargs) -> list:
    with torch.device("meta"):  # names only
        return list(module_cls(*args, **kwargs).state_dict())


def first_stage_state_dict(sd: Dict[str, torch.Tensor], fs_config
                           ) -> Dict[str, torch.Tensor]:
    """The `first_stage_model.*` weights of a checkpoint as a VQModel
    state dict (the encoder side where the checkpoint has it)."""
    from rdm_tpu_torch.models.autoencoder import VQModel

    keys = _keys(VQModel, fs_config)
    if not any(k.startswith(_FIRST_STAGE + "encoder.") for k in sd):
        keys = list(VQModel.decode_side(dict.fromkeys(keys)))
    return _pick(sd, keys, _FIRST_STAGE, "first stage")


def rdm_state_dicts(sd: Dict[str, torch.Tensor], config, fs_config, *,
                    use_ema: bool = False
                    ) -> Tuple[Dict[str, torch.Tensor],
                               Dict[str, torch.Tensor]]:
    """A released RDM checkpoint -> (RDM state dict, VQModel state dict)."""
    from rdm_tpu_torch.models.rdm import RDM

    if use_ema:
        sd = swap_in_ema(sd)
    return (_pick(sd, _keys(RDM, config), "", "RDM"),
            first_stage_state_dict(sd, fs_config))


def rarm_state_dicts(sd: Dict[str, torch.Tensor], config, fs_config
                     ) -> Tuple[Dict[str, torch.Tensor],
                                Dict[str, torch.Tensor]]:
    """A released RARM checkpoint (the RetrievalPatchTransformer under
    `transformer.`) -> (RARM state dict, VQModel state dict)."""
    from rdm_tpu_torch.models.rarm import RARM

    return (_pick(sd, _keys(RARM, config), "transformer.", "RARM"),
            first_stage_state_dict(sd, fs_config))
