"""JAX parameter trees -> port state dicts in the reference torch names.

The inverses of `rdm_tpu/utils/torch_convert.py`: `unet_state_dict_from_jax`
undoes `convert_unet`, `vq_state_dict_from_jax` undoes `convert_autoencoder`
(encoder, quant_conv, decoder, post_quant_conv, codebook),
`rdm_state_dict_from_jax` adds `unconditional_guidance_vex` (and `logvar`),
`rarm_state_dict_from_jax` undoes `convert_rarm_transformer`,
`clip_state_dict_from_jax` undoes `convert_clip` (and, for the RN50 tower,
`convert_clip_resnet_visual`, batch statistics into the running buffers), and
`train_state_from_jax` carries a whole JAX train state (params, Adam
moments, counts, EMA). With them both implementations run on the same
weights. Inputs are nested dicts of array
likes (numpy or jax arrays), with or without the top-level "params" key.

Layout rules (inverse of the converter's):
  flax conv kernel [kh, kw, I, O]  ->  torch Conv2d weight [O, I, kh, kw]
  int8 conv kernel (an int8 serving tree of rdm_tpu.ops.quant)
                                   ->  qweight [O, I, kh, kw] int8 with
                                       kernel_scale [O] and act_scale; the
                                       weight is the dequantized kernel
  "quant" collection (calibrated absmax at <block>/attn1, attn2, ff)
                                   ->  TransformerBlock qabsmax [6]
  flax Dense kernel [I, O]         ->  torch Linear weight [O, I]
  <norm>/GroupNorm_0|LayerNorm_0/{scale, bias}  ->  <norm>.{weight, bias}
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from rdm_tpu_torch.config import (AutoencoderConfig, ClipConfig, RARMConfig,
                                  RDMConfig, UNetConfig)


def _tree(params: Mapping[str, Any]) -> Mapping[str, Any]:
    return params["params"] if "params" in params else params


class _Inverse:
    """Collects flax-path -> torch-key assignments."""

    def __init__(self, tree: Mapping[str, Any], prefix: str = "",
                 quant: Optional[Mapping[str, Any]] = None):
        self.tree = tree
        self.prefix = prefix
        self.quant = quant or {}
        self.sd: Dict[str, torch.Tensor] = {}
        # (flax module path, port module name) of every conv and every
        # block attention / feed-forward: the keys of both calibration
        # trees
        self.names: List[Tuple[str, str]] = []

    def raw(self, path: str, tree=None) -> np.ndarray:
        node = self.tree if tree is None else tree
        for p in path.split("/"):
            node = node[p]
        return np.asarray(node)

    def get(self, path: str) -> np.ndarray:
        return self.raw(path).astype(np.float32)

    def has(self, path: str, tree=None) -> bool:
        node = self.tree if tree is None else tree
        for p in path.split("/"):
            if not isinstance(node, Mapping) or p not in node:
                return False
            node = node[p]
        return True

    def put(self, tkey: str, value: np.ndarray) -> None:
        self.sd[self.prefix + tkey] = torch.from_numpy(
            np.ascontiguousarray(value))

    def copy(self, fpath: str, tkey: str) -> None:
        self.put(tkey, self.get(fpath))

    def conv(self, fmod: str, tmod: str) -> None:
        self.names.append((fmod, tmod))
        kern = self.raw(f"{fmod}/kernel")
        if kern.dtype == np.int8:
            ws = self.get(f"{fmod}/kernel_scale")
            self.put(f"{tmod}.qweight", np.transpose(kern, (3, 2, 0, 1)))
            self.put(f"{tmod}.kernel_scale", ws)
            self.put(f"{tmod}.act_scale", self.get(f"{fmod}/act_scale"))
            kern = kern.astype(np.float32) * ws
        self.put(f"{tmod}.weight",
                 np.transpose(kern.astype(np.float32), (3, 2, 0, 1)))
        if self.has(f"{fmod}/bias"):
            self.copy(f"{fmod}/bias", f"{tmod}.bias")

    def linear(self, fmod: str, tmod: str) -> None:
        self.put(f"{tmod}.weight", np.transpose(self.get(f"{fmod}/kernel")))
        if self.has(f"{fmod}/bias"):
            self.copy(f"{fmod}/bias", f"{tmod}.bias")

    def norm(self, fmod: str, tmod: str, kind: str) -> None:
        self.copy(f"{fmod}/{kind}/scale", f"{tmod}.weight")
        self.copy(f"{fmod}/{kind}/bias", f"{tmod}.bias")


# ------------------------------------------------------------------ U-Net

def _adm_resblock(m: _Inverse, fmod: str, tmod: str) -> None:
    m.norm(f"{fmod}/norm1", f"{tmod}.in_layers.0", "GroupNorm_0")
    m.conv(f"{fmod}/conv1", f"{tmod}.in_layers.2")
    m.linear(f"{fmod}/emb_proj", f"{tmod}.emb_layers.1")
    m.norm(f"{fmod}/norm2", f"{tmod}.out_layers.0", "GroupNorm_0")
    m.conv(f"{fmod}/conv2", f"{tmod}.out_layers.3")
    if m.has(f"{fmod}/skip/kernel"):
        m.conv(f"{fmod}/skip", f"{tmod}.skip_connection")


def _transformer_block(m: _Inverse, fb: str, tb: str) -> None:
    """TransformerBlock params at flax path fb -> torch prefix tb ('' for
    a bare block)."""
    pre = f"{fb}/" if fb else ""
    dot = f"{tb}." if tb else ""
    for n in (1, 2, 3):
        m.norm(f"{pre}norm{n}", f"{dot}norm{n}", "LayerNorm_0")
    for a in ("attn1", "attn2"):
        for p in ("to_q", "to_k", "to_v"):
            m.linear(f"{pre}{a}/{p}", f"{dot}{a}.{p}")
        m.linear(f"{pre}{a}/to_out", f"{dot}{a}.to_out.0")
    m.linear(f"{pre}ff/proj_in", f"{dot}ff.net.0.proj")
    m.linear(f"{pre}ff/proj_out", f"{dot}ff.net.2")
    m.names += [(f"{pre}{a}", f"{dot}{a}") for a in ("attn1", "attn2", "ff")]
    recs = [f"{pre}{mod}/{name}" for mod, name in (
        ("attn1", "act_absmax"), ("attn1", "out_absmax"),
        ("attn2", "act_absmax"), ("attn2", "out_absmax"),
        ("ff", "act_absmax"), ("ff", "hidden_absmax"))]
    if all(m.has(r, m.quant) for r in recs):
        m.put(f"{dot}qabsmax", np.stack(
            [m.raw(r, m.quant).astype(np.float32) for r in recs]))


def _spatial_transformer(m: _Inverse, fmod: str, tmod: str,
                         depth: int) -> None:
    m.norm(f"{fmod}/norm", f"{tmod}.norm", "GroupNorm_0")
    m.conv(f"{fmod}/proj_in", f"{tmod}.proj_in")
    for d in range(depth):
        _transformer_block(m, f"{fmod}/block_{d}",
                           f"{tmod}.transformer_blocks.{d}")
    m.conv(f"{fmod}/proj_out", f"{tmod}.proj_out")


def _unet(m: _Inverse, cfg: UNetConfig) -> None:
    """Walks the block enumeration of convert_unet in the same order."""
    m.linear("time_dense1", "time_embed.0")
    m.linear("time_dense2", "time_embed.2")
    if m.has("label_emb/embedding"):
        m.copy("label_emb/embedding", "label_emb.weight")
    m.conv("conv_in", "input_blocks.0.0")
    tn, ds = 1, 1
    for level in range(len(cfg.channel_mult)):
        for i in range(cfg.num_res_blocks):
            _adm_resblock(m, f"down_{level}_{i}_res", f"input_blocks.{tn}.0")
            if ds in cfg.attention_resolutions:
                _spatial_transformer(m, f"down_{level}_{i}_attn",
                                     f"input_blocks.{tn}.1",
                                     cfg.transformer_depth)
            tn += 1
        if level != len(cfg.channel_mult) - 1:
            m.conv(f"down_{level}_down/conv", f"input_blocks.{tn}.0.op")
            tn += 1
            ds *= 2
    _adm_resblock(m, "mid_res1", "middle_block.0")
    _spatial_transformer(m, "mid_attn", "middle_block.1",
                         cfg.transformer_depth)
    _adm_resblock(m, "mid_res2", "middle_block.2")
    tn = 0
    for level in reversed(range(len(cfg.channel_mult))):
        for i in range(cfg.num_res_blocks + 1):
            _adm_resblock(m, f"up_{level}_{i}_res", f"output_blocks.{tn}.0")
            sub = 1
            if ds in cfg.attention_resolutions:
                _spatial_transformer(m, f"up_{level}_{i}_attn",
                                     f"output_blocks.{tn}.{sub}",
                                     cfg.transformer_depth)
                sub += 1
            if level and i == cfg.num_res_blocks:
                m.conv(f"up_{level}_up/conv", f"output_blocks.{tn}.{sub}.conv")
                ds //= 2
            tn += 1
    m.norm("out_norm", "out.0", "GroupNorm_0")
    m.conv("out_conv", "out.2")


def unet_state_dict_from_jax(params: Mapping[str, Any], cfg: UNetConfig,
                             prefix: str = "",
                             quant: Optional[Mapping[str, Any]] = None
                             ) -> Dict[str, torch.Tensor]:
    """rdm_tpu UNet params -> port `UNet` state dict (inverse of
    convert_unet(sd, cfg, prefix=prefix)). An int8 serving tree carries
    over with its scales; `quant` (default: the variables' own "quant"
    collection) gives the transformer blocks their absmax."""
    if quant is None and "params" in params:
        quant = params.get("quant")
    m = _Inverse(_tree(params), prefix, quant)
    _unet(m, cfg)
    return m.sd


def rdm_state_dict_from_jax(params: Mapping[str, Any], cfg: RDMConfig
                            ) -> Dict[str, torch.Tensor]:
    """rdm_tpu RDM params -> port `RDM` state dict
    (`model.diffusion_model.*` + `unconditional_guidance_vex`)."""
    tree = _tree(params)
    quant = params.get("quant", {}).get("unet") if "params" in params \
        else None
    sd = unet_state_dict_from_jax(tree["unet"], cfg.unet,
                                  prefix="model.diffusion_model.",
                                  quant=quant)
    for name in ("unconditional_guidance_vex", "logvar"):
        if name in tree:  # logvar only with learn_logvar
            sd[name] = torch.from_numpy(np.asarray(tree[name],
                                                   dtype=np.float32).copy())
    return sd


# ------------------------------------------------------------------- RARM

def rarm_state_dict_from_jax(params: Mapping[str, Any], cfg: RARMConfig,
                             prefix: str = "") -> Dict[str, torch.Tensor]:
    """rdm_tpu RARM params -> port `RARM` state dict (inverse of
    convert_rarm_transformer(sd, cfg.depth, prefix=prefix)): the
    positional table back to [inner, seq], the head back to a k=1 Conv1d
    weight [out_vocab, inner, 1]."""
    m = _Inverse(_tree(params), prefix)
    m.copy("token_emb/embedding", "proj_in.weight")
    m.put("positional_encoding",
          np.transpose(m.get("positional_encoding")))
    for d in range(cfg.depth):
        _transformer_block(m, f"block_{d}", f"transformer_blocks.{d}")
    m.put("proj_out.weight",
          np.transpose(m.get("proj_out/kernel"))[:, :, None])
    m.copy("proj_out/bias", "proj_out.bias")
    return m.sd


# ------------------------------------------------------------ first stage

def _resnet_block(m: _Inverse, fmod: str, tmod: str) -> None:
    m.norm(f"{fmod}/norm1", f"{tmod}.norm1", "GroupNorm_0")
    m.conv(f"{fmod}/conv1", f"{tmod}.conv1")
    m.norm(f"{fmod}/norm2", f"{tmod}.norm2", "GroupNorm_0")
    m.conv(f"{fmod}/conv2", f"{tmod}.conv2")
    if m.has(f"{fmod}/nin_shortcut/kernel"):
        m.conv(f"{fmod}/nin_shortcut", f"{tmod}.nin_shortcut")


def _ae_attn(m: _Inverse, fmod: str, tmod: str) -> None:
    m.norm(f"{fmod}/norm", f"{tmod}.norm", "GroupNorm_0")
    for p in ("q", "k", "v", "proj_out"):
        m.conv(f"{fmod}/{p}", f"{tmod}.{p}")


def _ae_trunk(m: _Inverse, cfg: AutoencoderConfig, side: str) -> None:
    """One side ('encoder' or 'decoder') of the taming trunk, in the
    enumeration order of convert_autoencoder."""
    m.conv(f"{side}/conv_in", f"{side}.conv_in")
    if side == "encoder":
        cur_res = cfg.resolution
        for L in range(cfg.num_resolutions):
            for i in range(cfg.num_res_blocks):
                _resnet_block(m, f"{side}/down_{L}_block_{i}",
                              f"{side}.down.{L}.block.{i}")
                if cur_res in cfg.attn_resolutions:
                    _ae_attn(m, f"{side}/down_{L}_attn_{i}",
                             f"{side}.down.{L}.attn.{i}")
            if L != cfg.num_resolutions - 1:
                m.conv(f"{side}/down_{L}_downsample/conv",
                       f"{side}.down.{L}.downsample.conv")
                cur_res //= 2
    else:
        cur_res = cfg.resolution // cfg.downsample_factor
        for L in reversed(range(cfg.num_resolutions)):
            for i in range(cfg.num_res_blocks + 1):
                _resnet_block(m, f"{side}/up_{L}_block_{i}",
                              f"{side}.up.{L}.block.{i}")
                if cur_res in cfg.attn_resolutions:
                    _ae_attn(m, f"{side}/up_{L}_attn_{i}",
                             f"{side}.up.{L}.attn.{i}")
            if L != 0:
                m.conv(f"{side}/up_{L}_upsample/conv",
                       f"{side}.up.{L}.upsample.conv")
                cur_res *= 2
    for blk in ("block_1", "block_2"):
        _resnet_block(m, f"{side}/mid_{blk}", f"{side}.mid.{blk}")
    _ae_attn(m, f"{side}/mid_attn_1", f"{side}.mid.attn_1")
    m.norm(f"{side}/norm_out", f"{side}.norm_out", "GroupNorm_0")
    m.conv(f"{side}/conv_out", f"{side}.conv_out")


def vq_state_dict_from_jax(params: Mapping[str, Any], cfg: AutoencoderConfig
                           ) -> Dict[str, torch.Tensor]:
    """rdm_tpu VQModel params -> port `VQModel` state dict: encoder and
    quant_conv (where the tree has them: a tree initialised through the
    decode side alone does not), decoder, post_quant_conv and codebook."""
    m = _Inverse(_tree(params))
    if m.has("encoder"):
        _ae_trunk(m, cfg, "encoder")
        m.conv("quant_conv", "quant_conv")
    _ae_trunk(m, cfg, "decoder")
    m.conv("post_quant_conv", "post_quant_conv")
    m.copy("quantize/embedding", "quantize.embedding.weight")
    return m.sd


# ------------------------------------------------------------ CLIP

def _clip_block(m: _Inverse, fb: str, tb: str) -> None:
    """ResidualAttentionBlock: the packed in_proj Dense becomes
    nn.MultiheadAttention's in_proj_weight / in_proj_bias."""
    m.norm(f"{fb}/ln_1", f"{tb}.ln_1", "LayerNorm_0")
    m.norm(f"{fb}/ln_2", f"{tb}.ln_2", "LayerNorm_0")
    m.put(f"{tb}.attn.in_proj_weight",
          np.transpose(m.get(f"{fb}/attn/in_proj/kernel")))
    m.copy(f"{fb}/attn/in_proj/bias", f"{tb}.attn.in_proj_bias")
    m.linear(f"{fb}/attn/out_proj", f"{tb}.attn.out_proj")
    m.linear(f"{fb}/mlp_fc", f"{tb}.mlp.c_fc")
    m.linear(f"{fb}/mlp_proj", f"{tb}.mlp.c_proj")


def _clip_bn(m: _Inverse, stats: _Inverse, fmod: str, tmod: str) -> None:
    """flax BatchNorm params + batch_stats -> BatchNorm2d weight, bias and
    running statistics."""
    m.copy(f"{fmod}/scale", f"{tmod}.weight")
    m.copy(f"{fmod}/bias", f"{tmod}.bias")
    m.put(f"{tmod}.running_mean", stats.get(f"{fmod}/mean"))
    m.put(f"{tmod}.running_var", stats.get(f"{fmod}/var"))
    m.sd[f"{tmod}.num_batches_tracked"] = torch.tensor(0)


def clip_state_dict_from_jax(variables: Mapping[str, Any], cfg: ClipConfig
                             ) -> Dict[str, torch.Tensor]:
    """rdm_tpu CLIP variables ({'params'} and, for the ModifiedResNet
    tower, {'batch_stats'}) -> port `CLIP` state dict in OpenAI's names:
    the inverse of `convert_clip` and `convert_clip_resnet_visual`."""
    m = _Inverse(_tree(variables))
    if cfg.resnet_layers is None:
        m.conv("visual/conv1", "visual.conv1")
        m.copy("visual/class_embedding", "visual.class_embedding")
        m.copy("visual/positional_embedding", "visual.positional_embedding")
        m.norm("visual/ln_pre", "visual.ln_pre", "LayerNorm_0")
        for i in range(cfg.vision_layers):
            _clip_block(m, f"visual/block_{i}",
                        f"visual.transformer.resblocks.{i}")
        m.norm("visual/ln_post", "visual.ln_post", "LayerNorm_0")
        m.copy("visual/proj", "visual.proj")
    else:
        stats = _Inverse(variables["batch_stats"])
        for i in (1, 2, 3):
            m.conv(f"visual/conv{i}", f"visual.conv{i}")
            _clip_bn(m, stats, f"visual/bn{i}", f"visual.bn{i}")
        for stage, blocks in enumerate(cfg.resnet_layers):
            for blk in range(blocks):
                f = f"visual/layer{stage + 1}_{blk}"
                t = f"visual.layer{stage + 1}.{blk}"
                for c in (1, 2, 3):
                    m.conv(f"{f}/conv{c}", f"{t}.conv{c}")
                    _clip_bn(m, stats, f"{f}/bn{c}", f"{t}.bn{c}")
                if m.has(f"{f}/downsample_conv"):
                    m.conv(f"{f}/downsample_conv", f"{t}.downsample.0")
                    _clip_bn(m, stats, f"{f}/downsample_bn",
                             f"{t}.downsample.1")
        m.copy("visual/attnpool/positional_embedding",
               "visual.attnpool.positional_embedding")
        for p in ("q_proj", "k_proj", "v_proj", "c_proj"):
            m.linear(f"visual/attnpool/{p}", f"visual.attnpool.{p}")
    m.copy("text/token_embedding/embedding", "token_embedding.weight")
    m.copy("text/positional_embedding", "positional_embedding")
    for i in range(cfg.transformer_layers):
        _clip_block(m, f"text/block_{i}", f"transformer.resblocks.{i}")
    m.norm("text/ln_final", "ln_final", "LayerNorm_0")
    m.copy("text/text_projection", "text_projection")
    m.copy("logit_scale", "logit_scale")
    return m.sd


# ------------------------------------------------------------ train state

def _find_states(node, name: str) -> List[Any]:
    """Every optax state of class `name` inside an optimizer state."""
    if type(node).__name__ == name:
        return [node]
    if isinstance(node, (tuple, list)):
        return [s for child in node for s in _find_states(child, name)]
    return []


def train_state_from_jax(state: Any, cfg: RDMConfig) -> Dict[str, Any]:
    """A JAX `TrainState` of `rdm_tpu.training` (optimizer from its
    `make_optimizer`: AdamW, optionally under clip_by_global_norm and
    MultiSteps) -> the port's `TrainState.load_state_dict` input: step,
    params, the Adam moments mu / nu (each leaf in its own dtype), the
    counts, the MultiSteps accumulator and the EMA shadow and count. Every
    parameter-shaped tree goes through `rdm_state_dict_from_jax`, so the
    moments take the same key mapping and transposes as the params."""

    def sd(tree, dtype=None):
        out = rdm_state_dict_from_jax(tree, cfg)
        return out if dtype is None else {k: v.to(dtype)
                                          for k, v in out.items()}

    opt = state.opt_state
    multi = _find_states(opt, "MultiStepsState")
    inner = multi[0].inner_opt_state if multi else opt
    adam = _find_states(inner, "ScaleByAdamState")
    sched = _find_states(inner, "ScaleByScheduleState")
    if len(adam) != 1 or len(sched) != 1:
        raise ValueError("expected one ScaleByAdamState and one "
                         "ScaleByScheduleState in the optimizer state")
    adam, sched = adam[0], sched[0]
    mu_dtype = torch.bfloat16 if str(np.asarray(
        next(iter(_leaves(adam.mu)))).dtype) == "bfloat16" else None
    opt_sd = {"count": int(np.asarray(adam.count)), "mu": sd(adam.mu,
                                                           mu_dtype),
              "nu": sd(adam.nu), "sched_count": int(np.asarray(sched.count)),
              "mini_step": 0, "gradient_step": 0, "acc_grads": None}
    if multi:
        opt_sd.update(mini_step=int(np.asarray(multi[0].mini_step)),
                      gradient_step=int(np.asarray(multi[0].gradient_step)),
                      acc_grads=sd(multi[0].acc_grads))
    return {"step": int(np.asarray(state.step)), "params": sd(state.params),
            "opt_state": opt_sd,
            "ema": {"params": sd(state.ema.params),
                    "count": int(np.asarray(state.ema.count))}}


def _leaves(tree):
    if isinstance(tree, Mapping):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree
