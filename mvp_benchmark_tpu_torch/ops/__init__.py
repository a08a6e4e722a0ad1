"""Geometry op library (port of ``mvp_benchmark_tpu.ops``).

Public API (channels-last), ported so far. Each op takes its CUDA kernel for
CUDA tensors and its plain PyTorch version for CPU tensors (``dispatch``);
``ref`` holds the plain versions.

- ``chamfer_distance`` (``chamfer_distance_ref`` is the plain version);
- ``knn_points``, ``knn_indices``, ``three_nn``, ``three_nn_upsampling``;
- ``furthest_point_sample``;
- ``gather_points``, ``grouping_operation``, ``group_max``,
  ``three_interpolate``;
- ``sa_attention`` (VRCNet's SA block);
- ``ball_query`` (ECG's uniform loss) and ``emd_auction`` (the EMD metric);
- ``attention``, ``attention_bnhd``, ``edge_mlp_eval`` and
  ``edge_mlp_train`` (DCP's transformer, svd head and DGCNN edge chain);
- ``gnn_propagate`` and ``sim_mlp`` (IDAM's GNN edge block and similarity
  MLP, eval and train) and ``square_distance`` (the expansion, IDAM's
  ground-truth matches).
"""

from mvp_benchmark_tpu_torch.ops.dispatch import (
    attention, attention_bnhd, ball_query, chamfer_distance, edge_mlp_eval,
    edge_mlp_train, emd_auction, furthest_point_sample, gather_points, group_max,
    gnn_propagate, grouping_operation, knn_indices, knn_points, sa_attention,
    sim_mlp, three_interpolate, three_nn, three_nn_upsampling)
from mvp_benchmark_tpu_torch.ops.ref import chamfer_distance as chamfer_distance_ref
from mvp_benchmark_tpu_torch.ops.ref import square_distance

__all__ = ["attention", "attention_bnhd", "ball_query", "chamfer_distance",
           "chamfer_distance_ref", "edge_mlp_eval", "edge_mlp_train", "emd_auction", "furthest_point_sample", "gather_points",
           "gnn_propagate", "group_max", "grouping_operation", "knn_indices",
           "knn_points", "sa_attention", "sim_mlp", "square_distance", "three_interpolate", "three_nn", "three_nn_upsampling"]
