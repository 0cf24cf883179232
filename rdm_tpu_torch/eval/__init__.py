from rdm_tpu_torch.eval.metrics import (
    frechet_distance,
    gaussian_stats,
    precision_recall,
)

__all__ = ["frechet_distance", "gaussian_stats", "precision_recall"]
