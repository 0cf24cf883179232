"""RARM — retrieval-augmented autoregressive transformer over VQ tokens, in
PyTorch.

Counterpart of `rdm_tpu/models/rarm.py` (the decoder trunk, its KV-cached
decoding and sampling). Modules keep the reference RetrievalPatchTransformer
names (`proj_in` Embedding, `positional_encoding` [inner, seq],
`transformer_blocks.{d}.{norm1,attn1,norm2,attn2,norm3,ff}`, `proj_out`
Conv1d k=1), so `rdm_tpu.utils.torch_convert.convert_rarm_transformer` maps
a port state dict (under a `transformer.` prefix) onto the JAX tree, and
released checkpoints load as they are.

Two decoding paths, as in JAX:

- `sample_tokens`: the eager cached loop over `RARM.decode_step`, plain
  PyTorch; the oracle of the kernel path.
- `sample_tokens_fused`: the same loop through the decode kernels
  (`ops/decode_kernel.decode_layer`), with every layer's kernel-layout
  weights packed once (`extract_decode_weights`). On CPU tensors the
  kernels' plain versions run.

The serving modes of the kernel path, as in JAX: `int8_weights` (every
projection of the decode kernels int8 with bf16 column scales, quantized
once by `extract_decode_weights`), `int8_kv` (int8 KV caches with f32
per-(row, batch row) scales) and `approx_top_k` (see `top_k_filter`).

The JAX package's growing-window stages (`window_chunk`) are a TPU
static-shape device: a scan over a fixed cache window per stage. Here each
step attends to exactly the rows it needs (the eager loop slices the cache
to pos + 1, the attention kernel bounds its read by pos), so they are not
carried over.

`training_loss` is the teacher-forced cross-entropy the RARM trainer
(`training/trainer.RARMTrainer`) differentiates: in bf16 on the card the
causal self-attention of every block takes the flash kernels
(`ops/attention._pick_impl`: S = 256, d = 64), the cross-attention over the
k neighbours the plain path.
"""

from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from rdm_tpu_torch.config import RARMConfig
from rdm_tpu_torch.models.layers import (CrossAttention, GEGLUFeedForward,
                                         LayerNormF32)
from rdm_tpu_torch.ops.attention import dot_product_attention
from rdm_tpu_torch.ops.block_kernel import pack_block_weights
from rdm_tpu_torch.ops.decode_kernel import (INT8_WEIGHTS, RowCommit,
                                             decode_layer, quantize_weight)

__all__ = ["RARM", "RARMConfig", "DecodeCache", "FusedDecoder",
           "extract_decode_weights", "sample_tokens", "sample_tokens_fused",
           "top_k_filter"]

class _Block(nn.Module):
    """Pre-LN: causal self-attn -> cross-attn to the neighbours -> GEGLU
    FF, each residual. Not a `layers.TransformerBlock`: the RDM pipeline
    packs those for its block kernels, which RARM does not use."""

    def __init__(self, dim: int, context_dim: int, heads: int,
                 head_dim: int):
        super().__init__()
        self.norm1 = LayerNormF32(dim)
        self.attn1 = CrossAttention(dim, dim, heads, head_dim, causal=True)
        self.norm2 = LayerNormF32(dim)
        self.attn2 = CrossAttention(dim, context_dim, heads, head_dim)
        self.norm3 = LayerNormF32(dim)
        self.ff = GEGLUFeedForward(dim)

    def forward(self, x, context):
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


class DecodeCache(NamedTuple):
    """Per-layer caches of the eager decode loop, in the JAX eager layout:
    self-attention K/V [B, T, H, D], updated in place by `decode_step`;
    cross-attention K/V [B, S, H, D], projected once."""

    self_k: List[torch.Tensor]
    self_v: List[torch.Tensor]
    cross_k: List[torch.Tensor]
    cross_v: List[torch.Tensor]


class RARM(nn.Module):
    """The decoder-only retrieval transformer. `dtype` is the compute
    dtype: parameters are cast to it at use, logits come back f32."""

    def __init__(self, config: RARMConfig,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.config = config
        self.dtype = dtype
        inner = config.inner_dim
        self.proj_in = nn.Embedding(config.vocab_size, inner)
        # the reference's [inner, seq_len] table: the decode sequence is
        # [SOS, t0 .. t_{S-2}], exactly seq_len positions
        self.positional_encoding = nn.Parameter(
            torch.randn(inner, config.seq_len) * inner ** -0.5)
        self.transformer_blocks = nn.ModuleList([
            _Block(inner, config.context_dim, config.heads, config.head_dim)
            for _ in range(config.depth)])
        self.proj_out = nn.Conv1d(inner, config.out_vocab, 1)

    def _embed(self, tokens: torch.Tensor, pos_offset: int = 0):
        x = F.embedding(tokens, self.proj_in.weight).to(self.dtype)
        pos = self.positional_encoding[
            :, pos_offset:pos_offset + tokens.shape[1]].t()
        return x + pos.to(x.dtype)

    def head(self, x: torch.Tensor) -> torch.Tensor:
        """[..., C] -> f32 logits [..., out_vocab] (the k=1 Conv1d)."""
        w = self.proj_out.weight[:, :, 0]
        return F.linear(x, w.to(x.dtype),
                        self.proj_out.bias.to(x.dtype)).float()

    def forward(self, tokens: torch.Tensor, context: torch.Tensor):
        """Teacher-forced: tokens [B, S] (SOS-prefixed, shifted), context
        [B, S_ctx, context_dim] -> logits [B, S, out_vocab] f32."""
        x = self._embed(tokens)
        context = context.to(self.dtype)
        for blk in self.transformer_blocks:
            x = blk(x, context)
        return self.head(x)

    # ---------- KV-cached decoding ----------

    def init_cache(self, batch: int, context: torch.Tensor) -> DecodeCache:
        cfg = self.config
        ctx = context.to(self.dtype)
        b, s = ctx.shape[:2]
        shp = (b, s, cfg.heads, cfg.head_dim)
        cross_k = [blk.attn2.to_k(ctx).reshape(shp)
                   for blk in self.transformer_blocks]
        cross_v = [blk.attn2.to_v(ctx).reshape(shp)
                   for blk in self.transformer_blocks]

        def zeros():
            return torch.zeros((batch, cfg.seq_len, cfg.heads, cfg.head_dim),
                               dtype=self.dtype, device=ctx.device)

        return DecodeCache([zeros() for _ in range(cfg.depth)],
                           [zeros() for _ in range(cfg.depth)],
                           cross_k, cross_v)

    def decode_step(self, token: torch.Tensor, pos: int,
                    cache: DecodeCache):
        """token [B], pos -> (logits [B, out_vocab] f32, cache); row pos of
        every self-attention cache is written in place."""
        cfg = self.config
        h, d = cfg.heads, cfg.head_dim
        x = self._embed(token[:, None], pos)          # [B, 1, C]
        b = x.shape[0]
        for i, blk in enumerate(self.transformer_blocks):
            a1, a2 = blk.attn1, blk.attn2
            hn = blk.norm1(x)
            q = a1.to_q(hn).reshape(b, 1, h, d)
            cache.self_k[i][:, pos] = a1.to_k(hn).reshape(b, h, d)
            cache.self_v[i][:, pos] = a1.to_v(hn).reshape(b, h, d)
            o = dot_product_attention(q, cache.self_k[i][:, :pos + 1],
                                      cache.self_v[i][:, :pos + 1])
            x = x + a1.to_out[0](o.reshape(b, 1, h * d))
            q2 = a2.to_q(blk.norm2(x)).reshape(b, 1, h, d)
            o2 = dot_product_attention(q2, cache.cross_k[i],
                                       cache.cross_v[i])
            x = x + a2.to_out[0](o2.reshape(b, 1, h * d))
            x = x + blk.ff(blk.norm3(x))
        return self.head(x[:, 0]), cache

    # ---------- training ----------

    def training_loss(self, z_indices: torch.Tensor, neighbors: torch.Tensor,
                      generator: Optional[torch.Generator] = None,
                      p_mask=None, *, mask: Optional[torch.Tensor] = None):
        """z_indices [B, S] ground-truth codes, neighbors [B, S_ctx, D] ->
        (loss, {"loss", "ppl"}): the mean NLL of the codes under the
        teacher-forced input [SOS, z_0 .. z_{S-2}], log-softmax in f32
        (`RARM.training_loss` of the JAX package).

        With p_mask (a float or a scalar tensor) each neighbour element is
        replaced by the scalar `mask_token` with probability p_mask, the
        draw from `generator` (on the neighbours' device); `mask` (bool,
        the neighbours' shape) replaces that draw: a seam for the tests,
        which feed the JAX package's draw."""
        cfg = self.config
        r = neighbors
        if mask is None and p_mask is not None:
            mask = torch.rand(r.shape, generator=generator,
                              device=r.device) < p_mask
        if mask is not None:
            r = r.masked_fill(mask, float(cfg.mask_token))
        sos = torch.full((z_indices.shape[0], 1), cfg.sos_token,
                         dtype=z_indices.dtype, device=z_indices.device)
        inp = torch.cat([sos, z_indices[:, :-1]], dim=1)
        logits = self(inp, r)
        loss = F.cross_entropy(logits.flatten(0, 1), z_indices.flatten())
        return loss, {"loss": loss, "ppl": torch.exp(loss)}


# ---------------------------------------------------------------- sampling

def top_k_filter(logits: torch.Tensor, k: int,
                 approx: bool = False) -> torch.Tensor:
    """Keep the top-k logits, set the rest to -inf (reference top_k_logits
    semantics; ties with the k-th value are kept).

    approx=True is the JAX package's `jax.lax.approx_max_k` threshold. XLA
    gives that op its approximate form only on a TPU; on other backends it
    is the exact top-k (on the CPU with jax 0.9.0, approx_max_k(x, 256)
    equals top_k on a seeded [32, 16384] f32 draw). So the port, which runs
    on no TPU, computes the exact top-k either way."""
    del approx  # the exact answer, as XLA gives it off the TPU
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return logits.masked_fill(logits < kth, float("-inf"))


def _sample_next(logits: torch.Tensor, generator: torch.Generator, *,
                 use_cfg: bool, guidance_scale: float, temperature: float,
                 top_k: int, approx_top_k: bool = False) -> torch.Tensor:
    """CFG combine -> temperature -> top-k -> categorical draw; shared by
    both decoding paths. logits [B or 2B, V] f32 -> tokens [B] int64."""
    if use_cfg:
        lc, lu = logits.chunk(2, dim=0)
        logits = lu + guidance_scale * (lc - lu)
    logits = logits / temperature
    if top_k:
        logits = top_k_filter(logits, top_k, approx=approx_top_k)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def _guided_context(neighbors: torch.Tensor, guidance_scale: float):
    """The [cond; uncond] context under CFG (null context: zeros), else
    the neighbors."""
    if guidance_scale == 1.0:
        return neighbors
    return torch.cat([neighbors, torch.zeros_like(neighbors)], dim=0)


def _sample_loop(step: Callable[[torch.Tensor, int], torch.Tensor],
                 cfg: RARMConfig, batch: int, device: torch.device,
                 generator: torch.Generator, steps: Optional[int],
                 temperature: float, top_k: int, guidance_scale: float,
                 approx_top_k: bool) -> torch.Tensor:
    """The decode loop both samplers share: `step(tokens, pos)` gives the
    logits of one position ([B or 2B] under CFG); returns [B, steps]."""
    steps = steps or cfg.seq_len
    top_k = min(top_k, cfg.out_vocab) if top_k else top_k
    use_cfg = guidance_scale != 1.0
    token = torch.full((batch,), cfg.sos_token, dtype=torch.long,
                       device=device)
    out = []
    for pos in range(steps):
        tok_in = torch.cat([token, token]) if use_cfg else token
        token = _sample_next(step(tok_in, pos), generator, use_cfg=use_cfg,
                             guidance_scale=guidance_scale,
                             temperature=temperature, top_k=top_k,
                             approx_top_k=approx_top_k)
        out.append(token)
    return torch.stack(out, dim=1)


@torch.no_grad()
def sample_tokens(model: RARM, neighbors: torch.Tensor,
                  generator: torch.Generator, *, steps: Optional[int] = None,
                  temperature: float = 1.0, top_k: int = 256,
                  guidance_scale: float = 1.0,
                  approx_top_k: bool = False) -> torch.Tensor:
    """KV-cached autoregressive sampling through the eager `decode_step`.
    neighbors [B, S_ctx, D] -> tokens [B, steps] int64."""
    ctx = _guided_context(neighbors, guidance_scale)
    cache = model.init_cache(ctx.shape[0], ctx)
    return _sample_loop(
        lambda tok, pos: model.decode_step(tok, pos, cache)[0],
        model.config, neighbors.shape[0], neighbors.device, generator, steps,
        temperature, top_k, guidance_scale, approx_top_k)


def extract_decode_weights(model: RARM, dtype: torch.dtype = torch.bfloat16,
                           int8_weights: bool = False
                           ) -> List[Dict[str, torch.Tensor]]:
    """Per-layer kernel-layout weights for `decode_layer`, packed once:
    projections [in, out] in `dtype` (q/k/v fused into [C, 3C], the GEGLU
    projection split into value and gate halves, the cross-attention k/v
    projections kept for the once-per-request context K/V), norms and
    biases f32 (`ops.block_kernel.pack_block_weights`).

    int8_weights=True stores the seven decode projections (`INT8_WEIGHTS`)
    as int8 codes [in, out] with bf16 column scales `<name>_s`
    (`decode_kernel.quantize_weight`), quantized from the model's own
    parameters before any cast, as the JAX package does; the cross-attention
    k/v projections stay in `dtype`."""
    if not int8_weights:
        return [pack_block_weights(blk, dtype)
                for blk in model.transformer_blocks]
    layers = []
    for blk in model.transformer_blocks:
        w = pack_block_weights(blk, blk.attn1.to_q.weight.dtype)
        for name in INT8_WEIGHTS:
            w[name], w[name + "_s"] = quantize_weight(w[name])
        w["wk2"], w["wv2"] = w["wk2"].to(dtype), w["wv2"].to(dtype)
        layers.append(w)
    return layers


class FusedDecoder:
    """One request's decode state on the kernel path: the cross-attention
    K/V (computed once, [S, B, C]), the time-major [T, B, C] KV caches of
    every layer, and the embedding and head tables in the compute dtype.
    `step(tokens, pos)` runs one position through all layers and returns
    f32 logits; the caches advance in place.

    batched_commit defers each step's k/v rows and writes them for all
    layers in one `commit_rows` launch (the JAX RARM_BATCHED_COMMIT=1
    path), instead of each layer's attention launch writing its own: the
    layers' attention launches write the rows into one [2, depth, B, C]
    buffer kept for the request, and a `RowCommit` built once over it and
    the caches launches the commit each step.
    int8_kv keeps int8 caches with f32 scale caches [T, B, 1] (ones until
    a row is written, as in JAX); it commits per layer, so it refuses
    batched_commit as the JAX package does. The weights' `wqkv_s` selects
    the int8_weights mode."""

    def __init__(self, model: RARM, context: torch.Tensor,
                 weights: Optional[List[Dict[str, torch.Tensor]]] = None, *,
                 batched_commit: bool = False, int8_kv: bool = False):
        cfg = model.config
        if int8_kv and batched_commit:
            raise ValueError("int8_kv commits each layer's rows itself; it "
                             "does not take batched_commit")
        self.cfg = cfg
        self.layers = (weights if weights is not None
                       else extract_decode_weights(model, model.dtype))
        dtype = self.layers[0]["wk2"].dtype  # the compute dtype
        self.batched_commit = batched_commit
        ctx = context.to(dtype)
        bb, c = ctx.shape[0], cfg.inner_dim
        self.emb = model.proj_in.weight.to(dtype)
        self.posenc = model.positional_encoding.to(dtype)      # [C, T]
        self.head_w = model.proj_out.weight[:, :, 0].t().to(dtype)
        self.head_b = model.proj_out.bias.to(dtype)
        self.cross = [((ctx @ w["wk2"]).transpose(0, 1).contiguous(),
                       (ctx @ w["wv2"]).transpose(0, 1).contiguous())
                      for w in self.layers]
        cache_dtype = torch.int8 if int8_kv else dtype
        self.k_caches = [torch.zeros((cfg.seq_len, bb, c), dtype=cache_dtype,
                                     device=ctx.device)
                         for _ in range(cfg.depth)]
        self.v_caches = [torch.zeros_like(k) for k in self.k_caches]
        self.ks_caches = self.vs_caches = [None] * cfg.depth
        self.rows = [None] * cfg.depth
        if batched_commit:
            buf = torch.empty((2, cfg.depth, bb, c), dtype=dtype,
                              device=ctx.device)
            self.rows = list(zip(buf[0], buf[1]))
            self.commit = RowCommit(self.k_caches + self.v_caches,
                                    list(buf[0]) + list(buf[1]))
        if int8_kv:
            self.ks_caches = [torch.ones((cfg.seq_len, bb, 1),
                                         device=ctx.device)
                              for _ in range(cfg.depth)]
            self.vs_caches = [torch.ones_like(k) for k in self.ks_caches]

    def step(self, tokens: torch.Tensor, pos: int) -> torch.Tensor:
        """tokens [B] at position pos -> logits [B, out_vocab] f32."""
        cfg = self.cfg
        x = self.emb[tokens] + self.posenc[:, pos]
        for d, w in enumerate(self.layers):
            x = decode_layer(
                x, pos, self.k_caches[d], self.v_caches[d], *self.cross[d],
                w, heads=cfg.heads, head_dim=cfg.head_dim,
                defer_commit=self.batched_commit,
                ks_cache=self.ks_caches[d], vs_cache=self.vs_caches[d],
                rows=self.rows[d])[0]
        if self.batched_commit:
            self.commit(pos)
        return torch.addmm(self.head_b, x, self.head_w).float()


@torch.no_grad()
def sample_tokens_fused(model: RARM, neighbors: torch.Tensor,
                        generator: torch.Generator, *,
                        steps: Optional[int] = None,
                        temperature: float = 1.0, top_k: int = 256,
                        guidance_scale: float = 1.0,
                        approx_top_k: bool = False,
                        int8_weights: bool = False, int8_kv: bool = False,
                        batched_commit: bool = False,
                        weights: Optional[List[Dict[str, torch.Tensor]]]
                        = None) -> torch.Tensor:
    """`sample_tokens` through the decode kernels: two kernel calls per
    layer per step (`decode_attn`, `decode_post_ff`), plus one
    `commit_rows` per step with batched_commit.
    The embedding gather, the head projection, top-k and the draw stay
    plain torch, as XLA did them in JAX. `weights` (from
    `extract_decode_weights`, int8 ones with int8_weights) skips the
    per-call packing. Same sampling semantics as `sample_tokens`; numerics
    differ by rounding order, and by the quantization in the int8 modes.
    int8_kv refuses batched_commit (see `FusedDecoder`)."""
    if weights is None:
        weights = extract_decode_weights(model, model.dtype,
                                         int8_weights=int8_weights)
    elif ("wqkv_s" in weights[0]) != int8_weights:
        raise ValueError(f"int8_weights={int8_weights} with weights packed "
                         f"{'with' if 'wqkv_s' in weights[0] else 'without'}"
                         " int8 projections")
    dec = FusedDecoder(model, _guided_context(neighbors, guidance_scale),
                       weights, batched_commit=batched_commit,
                       int8_kv=int8_kv)
    return _sample_loop(dec.step, model.config, neighbors.shape[0],
                        neighbors.device, generator, steps, temperature,
                        top_k, guidance_scale, approx_top_k)
