"""A self-contained train -> sample -> evaluate quality gate.

Counterpart of `rdm_tpu/eval/micro_gate.py`. The reference's acceptance
gate is FID / precision / recall of released checkpoints against ImageNet,
which needs weights and data the repo does not hold; this gate certifies
the same loop with none:

1. a procedural dataset: coloured geometric shapes (circle / square /
   triangle, a distinct palette, a random pose);
2. a tiny VQ-f2 first stage trained from scratch (`train_vq`:
   reconstruction + commitment loss, the straight-through codebook of
   `VQModel.forward`);
3. a tiny RDM trained on its latents through `RDMTrainer`, conditioned on
   the dataset's own nearest neighbours in a pixel embedding (the stand-in
   for CLIP retrieval); `run_gate_rarm` trains a tiny RARM on the code
   grid through `RARMTrainer` instead;
4. sampling through `RDMPipeline` (retrieval -> DDIM -> VQ decode) or
   `RARMPipeline` (retrieval -> KV-cached decoding -> decode_code);
5. FID and improved precision / recall (`eval/metrics.py`) over
   pixel-statistics features.

The gate: FID(trained) far below FID(random init), the random-init model
being the trainer's step 0 (`models/init.jax_init_`, the JAX package's
initialisers). On the card the pipelines run the kernels: the RDM's
SpatialTransformer blocks (C = 64 at ds 2), the RARM's decode kernels and
the kNN kernel over the 256-image pool. Those kernels take heads 32 or 64
wide, so on the card the gates run the JAX widths split as 2 heads of 32
(`num_head_channels=32`) and 1 head of 64 (`heads=1, head_dim=64`): every
parameter shape is the same (the projections are C x C), only the split
of the attention differs; the defaults are JAX's 8-wide and 4 x 16 heads.
"""

from __future__ import annotations

import os
import tempfile
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

# --------------------------------------------------------------------------
# procedural dataset
# --------------------------------------------------------------------------

_PALETTE = np.asarray([
    [0.9, 0.15, 0.15], [0.15, 0.75, 0.2], [0.2, 0.3, 0.95],
    [0.95, 0.8, 0.1], [0.7, 0.2, 0.85], [0.1, 0.8, 0.8],
], np.float32)


def make_shapes(n: int, size: int = 32, seed: int = 0) -> np.ndarray:
    """n coloured-shape images in [-1, 1], [n, size, size, 3]: a filled
    circle, square or triangle in a palette colour on a dim grey
    background, at a random centre and scale."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    imgs = np.full((n, size, size, 3), 0.15, np.float32)
    for i in range(n):
        kind = rng.integers(0, 3)
        color = _PALETTE[rng.integers(0, len(_PALETTE))]
        cx, cy = rng.uniform(size * 0.3, size * 0.7, 2)
        r = rng.uniform(size * 0.15, size * 0.3)
        if kind == 0:
            mask = (xx - cx) ** 2 + (yy - cy) ** 2 <= r * r
        elif kind == 1:
            mask = (np.abs(xx - cx) <= r) & (np.abs(yy - cy) <= r)
        else:
            mask = ((np.abs(xx - cx) <= (yy - cy + r) / 2)
                    & (yy - cy <= r) & (yy - cy >= -r))
        imgs[i][mask] = color
    return imgs * 2.0 - 1.0


def pixel_embed(images: np.ndarray, pool: int = 4) -> np.ndarray:
    """The retrieval embedder: pool x pool mean-pooled pixels,
    L2-normalised, so that similar shapes land near each other."""
    x = np.asarray(images, np.float32)
    b, h, w, c = x.shape
    f = x.reshape(b, pool, h // pool, pool, w // pool, c).mean((2, 4))
    f = f.reshape(b, -1)
    return f / np.maximum(np.linalg.norm(f, axis=1, keepdims=True), 1e-8)


def pixel_stat_features(images: np.ndarray) -> np.ndarray:
    """The FID / P-R features: 2 x 2 pooled pixels, a 4 x 4 local-std
    texture map and per-channel moments, from uint8 [0, 255] or float
    [-1, 1] images. The local std separates contiguous shapes from the
    codebook confetti a random-init model decodes to."""
    x = np.asarray(images, np.float32)
    if x.dtype == np.float32 and x.max() > 2.0:
        x = x / 127.5 - 1.0
    b, h, w, c = x.shape
    pooled = x.reshape(b, 2, h // 2, 2, w // 2, c).mean((2, 4))
    local_std = x.reshape(b, h // 4, 4, w // 4, 4, c).std((2, 4))
    return np.concatenate(
        [pooled.reshape(b, -1), local_std.reshape(b, -1),
         x.mean((1, 2)), x.std((1, 2))], axis=1)


def _vq_config(size: int):
    from rdm_tpu_torch.config import AutoencoderConfig

    return AutoencoderConfig(ch=16, ch_mult=(1, 2), num_res_blocks=1,
                             z_channels=3, embed_dim=3, n_embed=128,
                             resolution=size, in_channels=3, out_ch=3)


# --------------------------------------------------------------------------
# stage 1: the VQ first stage from scratch
# --------------------------------------------------------------------------

def vq_train_step(vq, opt: torch.optim.Optimizer,
                  x: torch.Tensor) -> torch.Tensor:
    """One step of `train_vq` on images x [B, 3, H, W]: the reconstruction
    MSE plus the commitment loss, backward, an optimizer step. Returns the
    reconstruction loss (detached), taken before the step as JAX's
    `train_vq` reports it."""
    rec, commit, _ = vq(x)
    loss = ((rec.float() - x) ** 2).mean()
    opt.zero_grad(set_to_none=True)
    (loss + commit).backward()
    opt.step()
    return loss.detach()


def adam(params, lr: float) -> torch.optim.Adam:
    """optax.adam(lr): the same rule and defaults."""
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)


def train_vq(images: np.ndarray, fs_cfg, *, steps: int = 400,
             batch: int = 32, lr: float = 2e-3, seed: int = 0,
             device="cuda", init_state_dict=None,
             losses: Optional[List[float]] = None
             ) -> Tuple[Dict[str, torch.Tensor], float]:
    """Train the tiny VQ autoencoder in f32 (reconstruction MSE +
    commitment loss) with Adam at `lr`, on batches of `batch` images drawn
    by np.random.default_rng(seed), as the JAX function draws them. Starts
    from `init_state_dict`, else the JAX initialisers from `seed`.
    `losses` collects each step's reconstruction loss. Returns (state dict
    on the CPU, the last step's reconstruction loss)."""
    from rdm_tpu_torch.models.autoencoder import VQModel
    from rdm_tpu_torch.models.init import jax_init_

    vq = VQModel(fs_cfg)
    if init_state_dict is not None:
        vq.load_state_dict(init_state_dict)
    else:
        jax_init_(vq, torch.Generator().manual_seed(seed))
    vq.to(device).train()
    opt = adam(vq.parameters(), lr)
    data = torch.as_tensor(np.asarray(images, np.float32),
                           device=device).permute(0, 3, 1, 2)
    rng = np.random.default_rng(seed)
    rec_loss = None
    for _ in range(steps):
        idx = torch.as_tensor(rng.integers(0, len(images), batch),
                              device=device)
        rec_loss = vq_train_step(vq, opt, data[idx])
        if losses is not None:
            losses.append(float(rec_loss))
    sd = {k: v.detach().cpu() for k, v in vq.state_dict().items()}
    return sd, float(rec_loss)


# --------------------------------------------------------------------------
# stage 2: the model through the trainer; 3-4: sample, evaluate
# --------------------------------------------------------------------------

def _neighbor_table(emb: np.ndarray, k: int) -> np.ndarray:
    """k nearest neighbours per row (self excluded), [n, k] int."""
    sims = emb @ emb.T
    np.fill_diagonal(sims, -np.inf)
    return np.argsort(-sims, axis=1)[:, :k]


def _fit(trainer, loader) -> Tuple[Dict[str, torch.Tensor],
                                   Dict[str, torch.Tensor]]:
    """(step 0's weights, the EMA weights after `fit`), on the CPU."""
    state = trainer.init_state()
    start = {k: v.detach().cpu().clone()
             for k, v in state.model.state_dict().items()}
    state = trainer.fit(loader, state=state)
    ema = {k: v.detach().cpu().clone() for k, v in state.ema.params.items()}
    return start, ema


def _report(images, samples_trained, samples_random, device) -> Dict:
    from rdm_tpu_torch.eval.metrics import evaluate_features

    real = pixel_stat_features(images)
    res_t = evaluate_features(real, pixel_stat_features(samples_trained),
                              device=device)
    res_r = evaluate_features(real, pixel_stat_features(samples_random),
                              device=device)
    return {
        "fid_trained": round(res_t["fid"], 4),
        "fid_random_init": round(res_r["fid"], 4),
        "precision_trained": round(res_t["precision"], 4),
        "precision_random": round(res_r["precision"], 4),
        "recall_trained": round(res_t["recall"], 4),
        "recall_random": round(res_r["recall"], 4),
        "fid_ratio": round(res_t["fid"] / max(res_r["fid"], 1e-9), 4),
    }


def _trainer_config(logdir: str, lr: float, steps: int, seed: int):
    from rdm_tpu_torch.training.trainer import TrainerConfig

    return TrainerConfig(logdir=logdir, base_lr=lr, scale_lr=False,
                         max_steps=steps, log_every=300,
                         ckpt_every=10 ** 9, image_log_every=0,
                         warm_up_steps=50, ema_decay=0.995, seed=seed)


def run_gate(*, n_images: int = 256, size: int = 16, k_nn: int = 3,
             vq_steps: int = 300, rdm_steps: int = 3000,
             train_batch: int = 32, sample_n: int = 128,
             ddim_steps: int = 20, guidance: float = 1.0,
             seed: int = 0, logdir: Optional[str] = None,
             num_head_channels: int = 8, device="cuda") -> Dict:
    """The RDM gate (module docstring); returns the report dict."""
    from rdm_tpu_torch.config import RDMConfig, UNetConfig
    from rdm_tpu_torch.pipeline import RDMPipeline
    from rdm_tpu_torch.retrieval.database import DataPool
    from rdm_tpu_torch.training.trainer import RDMTrainer

    logdir = logdir or tempfile.mkdtemp(prefix="micro_gate_")
    images = make_shapes(n_images, size=size, seed=seed)
    emb = pixel_embed(images)
    ctx_dim = emb.shape[1]

    fs_cfg = _vq_config(size)
    fs_sd, rec_loss = train_vq(images, fs_cfg, steps=vq_steps, seed=seed,
                               device=device)

    lat = size // fs_cfg.downsample_factor
    unet = UNetConfig(in_channels=3, out_channels=3, model_channels=32,
                      num_res_blocks=1, attention_resolutions=(2,),
                      channel_mult=(1, 2),
                      num_head_channels=num_head_channels,
                      context_dim=ctx_dim)
    cfg = RDMConfig(unet=unet, image_size=lat, channels=3, timesteps=100,
                    context_dim=ctx_dim, k_nn=k_nn,
                    p_uncond=0.1 if guidance != 1.0 else 0.0)
    nn_idx = _neighbor_table(emb, k_nn)
    rng = np.random.default_rng(seed + 1)

    def loader():
        while True:
            idx = rng.integers(0, n_images, train_batch)
            yield {"image": images[idx],
                   "nn_embeddings": emb[nn_idx[idx]][:, None]}

    trainer = RDMTrainer(cfg, _trainer_config(os.path.join(logdir, "rdm"),
                                              3e-4, rdm_steps, seed),
                         fs_cfg, fs_sd, batch_size=train_batch,
                         device=device)
    start, ema = _fit(trainer, loader())
    pool = DataPool(embeddings=emb.astype(np.float32))

    def sample_with(sd):
        pipe = RDMPipeline(cfg, sd, fs_cfg, fs_sd, pool=pool, device=device)
        bs = min(64, sample_n)
        out = [pipe.sample_unconditional(
            bs, steps=ddim_steps, guidance_scale=guidance,
            seed=seed + 7 + i)["samples_with_sampled_nns"]
            for i in range(0, sample_n, bs)]
        return np.concatenate(out)[:sample_n]

    report = {
        "n_train_images": n_images, "vq_steps": vq_steps,
        "rdm_steps": rdm_steps, "sample_n": sample_n,
        "ddim_steps": ddim_steps, "guidance": guidance,
        "vq_recon_mse": round(rec_loss, 5),
    }
    report.update(_report(images, sample_with(ema), sample_with(start),
                          device))
    # the split the attention ran (C = 64 at ds 2)
    report.update(logdir=logdir, num_head_channels=num_head_channels,
                  heads=unet.heads_for(32 * 2)[0], device=str(device))
    return report


def run_gate_rarm(*, n_images: int = 256, size: int = 16, k_nn: int = 3,
                  vq_steps: int = 300, rarm_steps: int = 3000,
                  train_batch: int = 32, sample_n: int = 128,
                  top_k: int = 32, temperature: float = 1.0,
                  guidance: float = 1.0, seed: int = 0,
                  logdir: Optional[str] = None, heads: int = 4,
                  head_dim: int = 16, device="cuda") -> Dict:
    """The autoregressive gate: shapes -> VQ codes -> a RARM through
    `RARMTrainer` -> `RARMPipeline` sampling -> FID / P-R, with
    `run_gate`'s pass criterion."""
    from rdm_tpu_torch.config import RARMConfig
    from rdm_tpu_torch.pipeline import RARMPipeline
    from rdm_tpu_torch.retrieval.database import DataPool
    from rdm_tpu_torch.training.trainer import RARMTrainer

    logdir = logdir or tempfile.mkdtemp(prefix="micro_gate_rarm_")
    images = make_shapes(n_images, size=size, seed=seed)
    emb = pixel_embed(images)
    ctx_dim = emb.shape[1]

    fs_cfg = _vq_config(size)
    n_embed = fs_cfg.n_embed
    fs_sd, rec_loss = train_vq(images, fs_cfg, steps=vq_steps, seed=seed,
                               device=device)

    side = size // fs_cfg.downsample_factor
    cfg = RARMConfig(vocab_size=n_embed + 2, out_vocab=n_embed,
                     heads=heads, head_dim=head_dim, depth=3,
                     context_dim=ctx_dim, seq_len=side * side,
                     sos_token=n_embed + 1, mask_token=n_embed,
                     code_side=side, p_mask_max=0.1)
    nn_idx = _neighbor_table(emb, k_nn)
    rng = np.random.default_rng(seed + 1)

    def loader():
        while True:
            idx = rng.integers(0, n_images, train_batch)
            yield {"image": images[idx],
                   "nn_embeddings": emb[nn_idx[idx]]}

    trainer = RARMTrainer(cfg, _trainer_config(os.path.join(logdir, "rarm"),
                                               1e-3, rarm_steps, seed),
                          fs_cfg, fs_sd, batch_size=train_batch,
                          device=device)
    start, ema = _fit(trainer, loader())
    pool = DataPool(embeddings=emb.astype(np.float32))

    def sample_with(sd):
        pipe = RARMPipeline(cfg, sd, fs_cfg, fs_sd, pool=pool, device=device)
        bs = min(64, sample_n)
        out = [pipe.sample_unconditional(
            bs, k_nn=k_nn, top_k=top_k, temperature=temperature,
            guidance_scale=guidance,
            seed=seed + 7 + i)["samples_with_sampled_nns"]
            for i in range(0, sample_n, bs)]
        return np.concatenate(out)[:sample_n]

    report = {
        "model": "rarm",
        "n_train_images": n_images, "vq_steps": vq_steps,
        "rarm_steps": rarm_steps, "sample_n": sample_n,
        "top_k": top_k, "guidance": guidance,
        "vq_recon_mse": round(rec_loss, 5),
    }
    report.update(_report(images, sample_with(ema), sample_with(start),
                          device))
    report.update(logdir=logdir, heads=heads, head_dim=head_dim,
                  device=str(device))
    return report
