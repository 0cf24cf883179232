"""Generative-quality metrics: FID and improved precision / recall.

Counterpart of `rdm_tpu/eval/metrics.py`:

- `frechet_distance`: the Fréchet distance between feature Gaussians, FID
  when the features are Inception pool3, "CLIP-FID" when they are CLIP
  image embeddings; the matrix square root by eigendecomposition of the
  symmetrised product, in float64 numpy, as the JAX package computes it.
- `precision_recall`: improved P / R (Kynkäänniemi et al. 2019). A point's
  manifold radius is its distance to its k-th nearest neighbour within its
  own set; precision is the share of generated points inside some real
  point's radius, recall the reverse. The pairwise work is blocked f32
  distance products and `torch.topk` on the device (the JAX package leaves
  the same work to XLA), with TF32 off: a point at the radius counts
  (`<=`), so the products keep f32's rounding.

Features come from any embedder callable (`features_from_images`), e.g.
the port's CLIP image tower or the micro gate's pixel statistics.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Iterable, Tuple

import numpy as np
import torch

_PR_BLOCK = 2048


def gaussian_stats(features: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(mean [D], covariance [D, D]) in float64."""
    f = np.asarray(features, dtype=np.float64)
    mu = f.mean(axis=0)
    cov = np.cov(f, rowvar=False)
    return mu, np.atleast_2d(cov)


def _sqrtm_psd(mat: np.ndarray) -> np.ndarray:
    """Symmetric PSD matrix square root via eigendecomposition."""
    vals, vecs = np.linalg.eigh((mat + mat.T) / 2.0)
    vals = np.clip(vals, 0.0, None)
    return (vecs * np.sqrt(vals)) @ vecs.T


def frechet_distance(mu1: np.ndarray, cov1: np.ndarray,
                     mu2: np.ndarray, cov2: np.ndarray) -> float:
    """||mu1 - mu2||^2 + tr(C1 + C2 - 2 (C1^1/2 C2 C1^1/2)^1/2), the
    symmetrised form (equal to tr sqrtm(C1 C2)) so the inner product stays
    PSD under rounding."""
    diff = mu1 - mu2
    c1h = _sqrtm_psd(cov1)
    inner = _sqrtm_psd(c1h @ cov2 @ c1h)
    return float(diff @ diff + np.trace(cov1) + np.trace(cov2)
                 - 2.0 * np.trace(inner))


def fid_from_features(real: np.ndarray, generated: np.ndarray) -> float:
    return frechet_distance(*gaussian_stats(real),
                            *gaussian_stats(generated))


@contextlib.contextmanager
def _f32_products():
    """Matmuls in f32, not TF32, inside the block."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _sq_dist(a: torch.Tensor, f: torch.Tensor, sq: torch.Tensor
             ) -> torch.Tensor:
    """||a_i||^2 + ||f_j||^2 - 2 a_i . f_j  [rows of a, rows of f]."""
    return (a * a).sum(1)[:, None] + sq[None, :] - 2.0 * (a @ f.t())


def _block_kth_nn(fb: torch.Tensor, start: int, f: torch.Tensor,
                  sq: torch.Tensor, k: int) -> torch.Tensor:
    """Squared distance to the k-th nearest neighbour (self excluded) of
    each row of fb, rows start.. of f."""
    d = _sq_dist(fb, f, sq).clamp_min_(0.0)
    rows = torch.arange(fb.shape[0], device=f.device)
    d[rows, start + rows] = float("inf")
    return torch.topk(d, k, dim=1, largest=False).values[:, k - 1]


def _block_any_within(gb: torch.Tensor, f: torch.Tensor, sq: torch.Tensor,
                      radii: torch.Tensor) -> torch.Tensor:
    """For each row of gb: is it within some f point's radius?"""
    d = _sq_dist(gb, f, sq).clamp_min_(0.0)
    return (d <= radii[None, :]).any(dim=1)


def _on(x: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def _manifold_radii(feats: np.ndarray, nhood_size: int,
                    block: int = _PR_BLOCK, device="cuda") -> np.ndarray:
    """Squared distance to the k-th (self excluded) nearest neighbour of
    every point, in [block, N] distance products on `device`."""
    f = _on(feats, device)
    sq = (f * f).sum(1)
    with torch.no_grad(), _f32_products():
        out = [_block_kth_nn(f[s:s + block], s, f, sq, nhood_size)
               for s in range(0, len(f), block)]
    return torch.cat(out).cpu().numpy()


def _frac_within(points: np.ndarray, manifold: np.ndarray,
                 radii: np.ndarray, block: int, device) -> float:
    f = _on(manifold, device)
    sq = (f * f).sum(1)
    r = _on(radii, device)
    g = _on(points, device)
    with torch.no_grad(), _f32_products():
        hits = torch.cat([_block_any_within(g[s:s + block], f, sq, r)
                          for s in range(0, len(g), block)])
    return float(hits.double().mean())


def precision_recall(real: np.ndarray, generated: np.ndarray,
                     nhood_size: int = 3, block: int = _PR_BLOCK,
                     device="cuda") -> Tuple[float, float]:
    """Improved precision / recall over feature sets (Kynkäänniemi 2019):
    precision, the share of generated samples inside at least one real
    sample's k-NN hypersphere; recall, the reverse. The pairwise work runs
    on `device` in row blocks."""
    radii_real = _manifold_radii(real, nhood_size, block, device)
    radii_gen = _manifold_radii(generated, nhood_size, block, device)
    precision = _frac_within(generated, real, radii_real, block, device)
    recall = _frac_within(real, generated, radii_gen, block, device)
    return precision, recall


def evaluate_features(real: np.ndarray, generated: np.ndarray,
                      nhood_size: int = 3, device="cuda") -> dict:
    p, r = precision_recall(real, generated, nhood_size, device=device)
    return {"fid": fid_from_features(real, generated),
            "precision": p, "recall": r,
            "n_real": int(len(real)), "n_generated": int(len(generated))}


def features_from_images(images: Iterable[np.ndarray],
                         embedder: Callable,
                         batch_size: int = 64) -> np.ndarray:
    """Stream images through an embedder in batches.

    images: an iterable of HWC arrays (uint8 [0, 255] or float [-1, 1]);
    embedder: [B, H, W, 3] float [-1, 1] -> [B, D] (numpy or a tensor).
    """
    def embed(buf):
        e = embedder(np.stack(buf))
        if isinstance(e, torch.Tensor):
            e = e.float().cpu().numpy()
        return np.asarray(e)

    feats, buf = [], []
    for img in images:
        arr = np.asarray(img)
        if arr.dtype == np.uint8:
            arr = arr.astype(np.float32) / 127.5 - 1.0
        buf.append(arr)
        if len(buf) == batch_size:
            feats.append(embed(buf))
            buf = []
    if buf:
        feats.append(embed(buf))
    return np.concatenate(feats, axis=0)
