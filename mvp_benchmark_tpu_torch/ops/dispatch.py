"""Device dispatch for ops that have a CUDA kernel (port of
``mvp_benchmark_tpu/ops/dispatch.py``).

The tensor's device decides: a CUDA tensor launches the kernel in
``kernels`` (and raises if it cannot), a CPU tensor takes the plain version
in ``ref``. There is no fallback from one to the other, and no shape guard
routes a CUDA tensor to ``ref``: the kernels take any shape within their
stated limits and raise beyond them.
"""

from __future__ import annotations

import torch

from mvp_benchmark_tpu_torch.ops import kernels, ref


def _route(*xs: torch.Tensor) -> str:
    devices = {x.device for x in xs}
    if len(devices) != 1:
        raise ValueError(f"inputs on several devices: {sorted(map(str, devices))}")
    kind = xs[0].device.type
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"no kernel or plain version for device {kind!r}")
    return kind


def chamfer_distance(a: torch.Tensor, b: torch.Tensor):
    """Bidirectional squared chamfer distance (see ref.chamfer_distance)."""
    if _route(a, b) == "cuda":
        return kernels.chamfer_distance(a, b)
    return ref.chamfer_distance(a, b)


def _knn(query: torch.Tensor, points: torch.Tensor, k: int):
    if _route(query, points) == "cuda":
        return kernels.knn(query.contiguous(), points.contiguous(), k)
    return ref.knn(query, points, k)


def knn_points(query: torch.Tensor, points: torch.Tensor, k: int):
    """kNN of query in points -> (negative squared distances, idx), nearest
    first (see ref.knn_points). The distances are the kernel's exact ones,
    not differentiable; the training slice recomputes them from idx."""
    d, idx = _knn(query, points, k)
    return -d, idx


def knn_indices(points: torch.Tensor, k: int) -> torch.Tensor:
    """Self-kNN (see ref.knn_indices)."""
    return _knn(points, points, k)[1]


def three_nn(target: torch.Tensor, source: torch.Tensor):
    """Top-3 NN -> (sqrt distances, idx) (see ref.three_nn)."""
    d, idx = _knn(target, source, 3)
    return torch.sqrt(d), idx


def three_nn_upsampling(target_points: torch.Tensor, source_points: torch.Tensor):
    """Indices + inverse-distance weights (see ref.three_nn_upsampling). The
    kNN is the kernel on the card; the clamp and normalisation stay plain
    torch, as they stayed XLA on the TPU (``dispatch.py:201-209``)."""
    dist, idx = three_nn(target_points, source_points)
    return idx, ref.upsampling_weights(dist)


def furthest_point_sample(xyz: torch.Tensor, num_samples: int) -> torch.Tensor:
    """Greedy FPS (see ref.furthest_point_sample)."""
    if _route(xyz) == "cuda":
        return kernels.furthest_point_sample(xyz.contiguous(), num_samples)
    return ref.furthest_point_sample(xyz, num_samples)


def gather_points(features: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Row gather by (B, M) or (B, M, K) index (see ref.gather_points)."""
    if _route(features, idx) == "cuda":
        return kernels.GatherRowsFunction.apply(
            features.contiguous(), idx.to(torch.int32).contiguous())
    return ref.gather_points(features, idx)


def grouping_operation(features: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Group rows by (B, M, K) index -> (B, M, K, C) (see
    ref.grouping_operation)."""
    return gather_points(features, idx)


def group_max(features: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Max over gathered neighbours, (B, N, C) x (B, M, k) -> (B, M, C) (see
    ref.group_max, whose argmax slot the kernel also computes for the
    backward)."""
    if _route(features, idx) == "cuda":
        return kernels.GroupMaxFunction.apply(
            features.contiguous(), idx.to(torch.int32).contiguous())
    return ref.group_max(features, idx)[0]


def three_interpolate(features: torch.Tensor, idx: torch.Tensor,
                      weight: torch.Tensor) -> torch.Tensor:
    """Weighted 3-NN interpolation (see ref.three_interpolate)."""
    if _route(features, idx, weight) == "cuda":
        return kernels.ThreeInterpolateFunction.apply(
            features.contiguous(), idx.to(torch.int32).contiguous(),
            weight.contiguous())
    return ref.three_interpolate(features, idx, weight)


def sa_attention(proj: torch.Tensor, x1: torch.Tensor, idx: torch.Tensor,
                 W1: torch.Tensor, W2: torch.Tensor, b2: torch.Tensor,
                 rel: int, mid: int, share: int) -> torch.Tensor:
    """VRCNet's SA block, idx (B, N, k) as the kNN gives it -> (B, N, mid)
    (see ref.sa_attention)."""
    if _route(proj, x1, idx, W1, W2, b2) == "cuda":
        return kernels.SAAttentionFunction.apply(
            proj.contiguous(), x1.contiguous(), idx.to(torch.int32).contiguous(),
            W1.contiguous(), W2.contiguous(), b2.contiguous(), rel, mid, share)
    return ref.sa_attention(proj, x1, idx, W1, W2, b2, rel, mid, share)
