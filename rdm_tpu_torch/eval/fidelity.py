"""Sample fidelity of the approximate serving modes against the exact
sampler.

Counterpart of `rdm_tpu/eval/fidelity.py`, the harness behind
`scripts/quality_eval.py` (the port's `rdm_tpu_torch.scripts.quality_eval`)
and chip_smoke.py's quality phase: what `int8_weights` and
`encoder_reuse` N cost in sample quality, measured against the exact run
on the same seed and noise (`RDMPipeline.fidelity_run`):

- per-step pred_x0 cosine similarity (agreement along the trajectory);
- final-latent and final-image PSNR (agreement in values);
- with a CLIP model, the image-image CLIP similarity (perceptual
  agreement).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def psnr(a: np.ndarray, b: np.ndarray, data_range: float) -> float:
    """Peak signal-to-noise ratio in dB over the given dynamic range."""
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    mse = float(np.mean(np.square(a - b)))
    if mse == 0.0:
        return float("inf")
    return float(10.0 * np.log10(data_range ** 2 / mse))


def cosine(a: np.ndarray, b: np.ndarray) -> float:
    a = np.asarray(a, np.float32).ravel()
    b = np.asarray(b, np.float32).ravel()
    denom = np.linalg.norm(a) * np.linalg.norm(b)
    return float(a @ b / denom) if denom else 0.0


def per_step_cosine(traj_a: np.ndarray, traj_b: np.ndarray) -> np.ndarray:
    """Per-step cosine similarity of two pred_x0 trajectories
    [steps, B, ...] (`fidelity_run`'s "traj")."""
    steps = min(len(traj_a), len(traj_b))
    return np.asarray([cosine(traj_a[i], traj_b[i])
                       for i in range(steps)], np.float32)


def clip_similarity(clip, imgs_a: np.ndarray, imgs_b: np.ndarray) -> float:
    """Mean CLIP image-image cosine between two uint8 image batches, through
    the port's CLIP (`models/retrievers.bind_clip`) on its device."""
    from rdm_tpu_torch.models.retrievers import embed_images

    dev = next(clip.parameters()).device

    def embed(imgs):
        x = torch.as_tensor(np.asarray(imgs), device=dev).float()
        e = embed_images(clip, x / 127.5 - 1.0).float()
        return (e / e.norm(dim=-1, keepdim=True)).cpu().numpy()

    ea, eb = embed(imgs_a), embed(imgs_b)
    return float(np.mean(np.sum(ea * eb, axis=-1)))


def compare_runs(exact: Dict[str, np.ndarray], variant: Dict[str, np.ndarray],
                 clip=None) -> Dict[str, Any]:
    """The fidelity record of one approximate mode against the exact run.

    Each run: {"z": final latents, "images": uint8 pixels, "traj": pred_x0
    trajectory or None}. Latent PSNR takes the exact run's observed range,
    image PSNR 255."""
    out: Dict[str, Any] = {}
    z_e = np.asarray(exact["z"], np.float32)
    z_v = np.asarray(variant["z"], np.float32)
    z_range = float(z_e.max() - z_e.min()) or 1.0
    out["latent_psnr_db"] = round(psnr(z_e, z_v, z_range), 2)
    out["latent_cosine"] = round(cosine(z_e, z_v), 6)
    out["image_psnr_db"] = round(
        psnr(exact["images"], variant["images"], 255.0), 2)
    if exact.get("traj") is not None and variant.get("traj") is not None:
        sc = per_step_cosine(exact["traj"], variant["traj"])
        out["pred_x0_cosine_per_step"] = [round(float(c), 4) for c in sc]
        out["pred_x0_cosine_min"] = round(float(sc.min()), 4)
        out["pred_x0_cosine_final"] = round(float(sc[-1]), 4)
    if clip is not None:
        out["clip_similarity"] = round(clip_similarity(
            clip, exact["images"], variant["images"]), 4)
    return out
