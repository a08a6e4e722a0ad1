"""Completion metrics: chamfer (cd_p / cd_t), F-score and EMD (port of
``mvp_benchmark_tpu/metrics/completion.py``).

- ``calc_cd``: reference ``completion/model_utils.py:67-77``. NOTE the
  argument order quirk: the reference calls ``cham_loss(gt, output)``, so
  dist1 is gt->output and dist2 is output->gt; cd_p/cd_t are symmetric, but
  fscore's (precision, recall) order depends on it.
- ``fscore``: reference ``utils/metrics/CD/fscore.py:3-16``: threshold on
  SQUARED distances (default 1e-4), NaN -> 0.
- ``calc_emd``: reference ``completion/model_utils.py:80-85``: sqrt of the
  auction's squared assignment distances, averaged over points.
"""

from __future__ import annotations

from typing import Tuple

import torch

from mvp_benchmark_tpu_torch.ops import chamfer_distance, emd_auction


def fscore(
    dist1: torch.Tensor, dist2: torch.Tensor, threshold: float = 1e-4
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """F-score at a squared-distance threshold. dist1/dist2: (B, N)."""
    precision_1 = (dist1 < threshold).to(torch.float32).mean(dim=1)
    precision_2 = (dist2 < threshold).to(torch.float32).mean(dim=1)
    denom = precision_1 + precision_2
    f = 2.0 * precision_1 * precision_2 / denom
    f = torch.where(denom == 0.0, torch.zeros_like(f), f)
    return f, precision_1, precision_2


def calc_cd(output: torch.Tensor, gt: torch.Tensor, calc_f1: bool = False):
    """Chamfer metrics. output/gt: (B, N, 3).

    Returns (cd_p, cd_t) or (cd_p, cd_t, f1), each (B,).
    """
    dist1, dist2, _, _ = chamfer_distance(gt, output)
    cd_p = (torch.sqrt(dist1).mean(dim=1) + torch.sqrt(dist2).mean(dim=1)) / 2.0
    cd_t = dist1.mean(dim=1) + dist2.mean(dim=1)
    if calc_f1:
        f1, _, _ = fscore(dist1, dist2)
        return cd_p, cd_t, f1
    return cd_p, cd_t


def calc_emd(output: torch.Tensor, gt: torch.Tensor, eps: float = 0.005,
             iterations: int = 50) -> torch.Tensor:
    """Auction EMD metric: sqrt(squared assignment distance) averaged. (B,).
    output and gt need as many points (``ops.emd_auction`` raises
    ValueError otherwise, as the JAX package does)."""
    dist, _ = emd_auction(output, gt, eps, iterations)
    return torch.sqrt(dist).mean(dim=1)
