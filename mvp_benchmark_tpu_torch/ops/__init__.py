"""Geometry op library (port of ``mvp_benchmark_tpu.ops``).

Public API (channels-last), ported so far. Each op takes its CUDA kernel for
CUDA tensors and its plain PyTorch version for CPU tensors (``dispatch``);
``ref`` holds the plain versions.

- ``chamfer_distance`` (``chamfer_distance_ref`` is the plain version);
- ``knn_points``, ``knn_indices``, ``three_nn``, ``three_nn_upsampling``;
- ``furthest_point_sample``;
- ``gather_points``, ``grouping_operation``, ``group_max``,
  ``three_interpolate``;
- ``sa_attention`` (VRCNet's SA block).
"""

from mvp_benchmark_tpu_torch.ops.dispatch import (
    chamfer_distance, furthest_point_sample, gather_points, group_max,
    grouping_operation, knn_indices, knn_points, sa_attention, three_interpolate,
    three_nn, three_nn_upsampling)
from mvp_benchmark_tpu_torch.ops.ref import chamfer_distance as chamfer_distance_ref

__all__ = ["chamfer_distance", "chamfer_distance_ref", "furthest_point_sample",
           "gather_points", "group_max", "grouping_operation", "knn_indices",
           "knn_points", "sa_attention", "three_interpolate", "three_nn",
           "three_nn_upsampling"]
