"""Model utilities shared by the completion models (port of
``mvp_benchmark_tpu/models/common.py``, the part ECG's eval reaches).

Ported: ``edge_preserve_sampling`` (reference completion/model_utils.py:88-110).
``EFExpansion``, ``get_uniform_loss``, ``get_repulsion_loss``,
``symmetric_sample`` and ``gen_grid`` come with later slices.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from mvp_benchmark_tpu_torch import ops


def edge_preserve_sampling(
    features: torch.Tensor, points: torch.Tensor, num_samples: int,
    k: int = 10, knn_idx: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """FPS + kNN max-pooled neighbourhood features (common.py:21-53).

    features: (B, N, C), points: (B, N, 3) ->
      (net (B, M, 2C), p_idx (B, M), pn_idx (B, M, pk), sampled points (B, M, 3))

    knn_idx: optional precomputed SELF-kNN of ``points`` (B, N, k') with
    k' >= pk. The sampled centres are a subset of ``points``, and the kNN
    ranks on exact distances with ties to the lower index whatever the row,
    so the first pk entries of a centre's self-kNN row ARE its pk-NN list;
    passing it replaces the (M, N) kNN with a row gather.
    """
    N = points.shape[1]
    p_idx = ops.furthest_point_sample(points, num_samples)
    point_output = ops.gather_points(points, p_idx)

    pk = min(k, N)
    if knn_idx is not None and knn_idx.shape[-1] >= pk:
        rows = torch.arange(points.shape[0], device=points.device)[:, None]
        pn_idx = knn_idx[rows, p_idx.long(), :pk]
    else:
        _, pn_idx = ops.knn_points(point_output, points, pk)
    neighbor = ops.group_max(features, pn_idx)
    center = ops.gather_points(features, p_idx)
    net = torch.cat([center, neighbor], dim=-1)
    return net, p_idx, pn_idx, point_output
