"""Model utilities shared by the completion models (port of
``mvp_benchmark_tpu/models/common.py``, the part ECG reaches).

Ported: ``edge_preserve_sampling`` (reference completion/model_utils.py:88-110)
and ``get_uniform_loss`` (:201-227). ``EFExpansion``, ``get_repulsion_loss``,
``symmetric_sample`` and ``gen_grid`` come with later slices.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

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
    else:       # indices only: detached, so no distance is recomputed
        _, pn_idx = ops.knn_points(point_output.detach(), points.detach(), pk)
    neighbor = ops.group_max(features, pn_idx)
    center = ops.gather_points(features, p_idx)
    net = torch.cat([center, neighbor], dim=-1)
    return net, p_idx, pn_idx, point_output


def get_uniform_loss(
    pcd: torch.Tensor,
    percentages: Sequence[float] = (0.004, 0.006, 0.008, 0.010, 0.012),
    radius: float = 1.0,
) -> torch.Tensor:
    """Surface-uniformity loss (common.py:85-119). pcd: (B, N, 3) -> scalar.

    One FPS of ``int(N * 0.05)`` centres serves every percentage p (the
    reference repeats the same deterministic FPS inside the loop). Per p:
    ``nsample = int(N * p)`` points in the ball of radius sqrt(p * radius)
    around each centre (p with nsample < 2 is skipped: a disk of fewer
    than two points has no spacing to score), the distance from each of
    them to its nearest other point of the disk, ``sqrt(|d| + 1e-8)``,
    squared deviation from the expected spacing over that spacing, weighted
    by ``(p * 100)^2``; the sum is divided by the number of percentages. The
    gradient reaches pcd through the grouped points and the kNN distances."""
    B, N, _ = pcd.shape
    npoint = int(N * 0.05)
    loss = 0.0
    fixed = pcd.detach()
    new_xyz = ops.gather_points(fixed, ops.furthest_point_sample(fixed, npoint))
    for p in percentages:
        nsample = int(N * p)
        if nsample < 2:
            continue
        r = math.sqrt(p * radius)
        disk_area = math.pi * radius ** 2 * p / nsample
        idx = ops.ball_query(0.0, r, nsample, fixed, new_xyz)
        expect_len = math.sqrt(disk_area)

        grouped = ops.grouping_operation(pcd, idx).reshape(-1, nsample, 3)
        var, _ = ops.knn_points(grouped, grouped, 2)
        uniform_dis = torch.sqrt(torch.abs(var[:, :, 1:]) + 1e-8)
        uniform_dis = torch.mean(uniform_dis, dim=-1)
        uniform_dis = (uniform_dis - expect_len) ** 2 / (expect_len + 1e-8)
        loss = loss + torch.mean(uniform_dis) * math.pow(p * 100, 2)
    return loss / len(percentages)
