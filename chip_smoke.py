#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``mvp_benchmark_tpu_torch``) on one
NVIDIA card -- the quickest proof that the port still starts on the GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0):

1. needs ``torch.cuda.is_available()``; prints the card's name and power limit;
2. builds the CUDA kernels from ``mvp_benchmark_tpu_torch/ops/csrc`` with nvcc;
3. holds each kernel against its plain PyTorch version on the card, at the
   shapes of the main paths plus ragged and duplicate-point cases: indices
   equal, distances and values bitwise equal (0 ulp); kNN also on points
   with exact copies across its candidate tiles, run twice, bitwise equal
   (and at every path shape in phase 6); the SA block, which
   sums in another order, within |kernel - plain| <= 1e-5 + 1e-4 |plain|;
   group_max's forward (``GROUP_MAX_FWD_CASES``: staged and direct, the
   max and its slot bitwise the plain version on CPU copies, run twice; an
   out-of-range index and NaN rows); the five backward kernels, gathers
   over reverse lists of their indices (``reverse_list.cu``, each list
   bitwise ``ref.reverse_list``'s; a scatter_add_rows of a small cloud
   lists in shared memory, packed a warp a cloud or by row range, every
   form checked, and bitwise against the plain version run on CPU copies;
   three_interpolate's under both forms of its plan at ``TI_BWD_CASES``,
   bitwise the plain version on CPU copies and run twice), at a
   VRCNet train step's shapes plus ragged, collision and tie cases within
   the same bar (the SA block's weight gradients, sums over every point,
   against max|plain|) and two runs of each bitwise equal; the chamfer
   forward also at the VRCNet train step's four shapes, ragged sizes and
   ties, two runs bitwise equal; the ball query at ECG's uniform-loss shapes plus ragged and
   edge cases, and the auction EMD at the val metric's (32, 2048, eps 0.004,
   3000 iterations) on uniform clouds and in a price war (a blob of
   bidders), each also on clusters of every size whose shared memory fits
   and run twice, at
   an iteration count that ends in the forced round
   and at an n that is not a multiple of 1024: indices and assignments
   equal; its launch plan and the cost of a cluster barrier printed; DCP's kernels at its shapes: the attention forwards (bf16
   normwise, fp32 within the SA bar, also at ragged shapes that cut a
   128-query and a 128-key tile, their row max and row sum there against a
   plain recomputation, two runs bitwise equal) and the edge chain's eval
   pass, and for training the attention backwards (bf16
   normwise, fp32 within the SA bar, also at ragged shapes that cut a
   tile) and the chain's stat, final and backward passes against autograd
   of its plain version (normwise), two runs of the attention backwards
   and of the chain's passes bitwise equal; IDAM's edge block (its
   product on the tensor cores, within a stated bar) and similarity MLP
   (bitwise) at its shapes plus ragged and tie cases, and for training
   their stat passes (normwise; the edge block's also bitwise against the
   plain version in its summation order), train final passes (the edge block's
   within its bar, its saved slots equal but at near ties, the flips
   counted; the similarity MLP's bitwise; given the kernels' statistics),
   the graph's reverse list (bitwise) and backward passes (normwise
   against ``ref``'s written-out backward, given the kernels' slots), two
   runs of every IDAM launch bitwise equal;
4. drives each main path through the functions ``completion/test_torch.py``
   and ``completion/train_torch.py`` call, with seeded weights, on the
   synthetic splits, each with the launch counts zeroed just before and read
   just after and equal to the ones derived from the code: the val pass
   (cd_p, cd_t, f1) and test pass (52 predictions) of full-width PCN
   (``completion/cfgs/pcn.yaml``), ECG (``ecg.yaml``) and VRCNet
   (``vrcnet.yaml``); PCN's val pass with ``eval_emd: True`` (emd too);
   then ``engine.train_completion`` of PCN, VRCNet and ECG for one epoch of
   ``TRAIN_STEPS`` steps at batch 32 x 2048 points, with its val pass and
   checkpoints; the val pass (RotE, transE, MSE, RMSE, recall) and test
   pass (32 poses) of full-width DCP (``registration/cfgs/dcp.yaml``), the
   functions ``registration/test_torch.py`` calls; and
   ``engine.train_registration`` of DCP (what ``registration/train_torch.py``
   runs) for the synthetic train split's two steps, its val pass and
   checkpoints; the val pass and test pass of full-width IDAM
   (``registration/cfgs/idam.yaml``: 32 pairs x 2048 points, M 341, 3
   iterations), and ``engine.train_registration`` of IDAM for the train
   split's two steps, its val pass and checkpoints (``IDAM_PER_STEP``);
5. checks the results: finite, of the expected shape, metrics equal to the
   ones recomputed with the plain chamfer on the card (rtol 1e-6), a val
   batch equal to the same model run on the CPU (PCN outputs atol 1e-5 /
   rtol 1e-4; ECG's and VRCNet's coarse output likewise and their fine
   output as a cloud, see ``check_batch_on_cpu_as_cloud``), cd_p/cd_t/f1
   of clouds near gt equal to the CPU's (rtol 1e-6); the train paths' loss
   and every gradient finite, their checkpoint reloading to the same val
   metrics, and one train step on two full-width clouds equal to the CPU's
   (``check_pcn_step_on_cpu``, ``check_vrcnet_step_on_cpu``,
   ``check_ecg_step_on_cpu``); the emd of the EMD val pass equal to the one
   the plain auction gives on the same predictions (rtol 1e-6); DCP's val
   metrics equal to the ones recomputed from its test-branch poses of the
   val clouds, its poses rigid, and a val batch cut to two full-width
   clouds equal to the CPU's (``check_dcp_batch_on_cpu``); DCP's train
   losses and gradients finite, its checkpoint reloading to the same val
   metrics, and a train step on two full-width pairs against the CPU in
   stages: its chain statistics against fp64, the CPU step given them
   against the card's, a witness with the plain chain on the card through
   both, and the free CPU step (``check_dcp_step_on_cpu``); IDAM's val
   metrics recomputed from its
   poses as DCP's, and a val batch cut to two pairs against the CPU, its
   selection flips counted (``check_idam_batch_on_cpu``); IDAM's train
   losses and gradients finite, its checkpoint reloading to the same val
   metrics, and a train step on two full-width pairs against the CPU with
   the same kept points, its gt-match and correspondence flips counted,
   then held with the card's selections on both (``check_idam_step_on_cpu``);
   full-width PCN, VRCNet and ECG train steps run twice from one seed,
   the parameters after them bitwise equal
   (``check_completion_steps_rerun_bitwise``);
6. times the val and test passes per batch, the train steps (ms and
   points/s; DCP's and IDAM's in pairs/s), and each kernel against its plain version (and a single
   PyTorch call computing the same function, where one exists) at a
   main-path shape, beside the least time the card could take
   (``bound_ms``); kNN and FPS also at every shape the driven paths launch
   them with (``probe_knn_fps``: VRCNet at 32 and 64 clouds, ECG, DCP's
   k 20, IDAM's k 12), each held bitwise against its plain version and run
   twice, with kNN's issue floor under its rounding rule and FPS's time a
   step; the SA block's forward at each of VRCNet's four levels at 32 and
   64 clouds (held to its bar, run twice), its backward at each level with
   the device time of each of its passes; scatter_add_rows at ECG's five
   train-step shapes and VRCNet's (``probe_scatter_sa``: bitwise against
   the plain version on CPU copies, run twice, beside ``torch.index_add``
   and the bound); group_max's forward and three_interpolate's backward
   at the VRCNet and ECG steps' six shapes each (``probe_backwards``:
   bitwise, run twice, device time beside the bound, every form of their
   plans); IDAM's Propagate block at its path
   shape, each launch by device time beside its bound
   (``probe_propagate``).

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""

import contextlib
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from mvp_benchmark_tpu_torch.metrics import (calc_cd, fscore, rmse_loss,
                                             rotation_error,
                                             rotation_geodesic_error,
                                             translation_error)
from mvp_benchmark_tpu_torch.models.dcp import SHIFT_INVARIANT as DCP_SHIFT_INVARIANT
from mvp_benchmark_tpu_torch.ops import kernels, ref
from mvp_benchmark_tpu_torch import (probe_backwards, probe_emd_chamfer, probe_knn_fps,
                                     probe_propagate, probe_scatter_sa)
from mvp_benchmark_tpu_torch.data.mvp import BatchSpec, MVPCompletionDataset
from mvp_benchmark_tpu_torch.train import engine, submission
from mvp_benchmark_tpu_torch.train.meters import AverageValueMeter
from mvp_benchmark_tpu_torch.train.config import load_config
from mvp_benchmark_tpu_torch.train.optim import build_optimizer

ROOT = os.path.dirname(os.path.abspath(__file__))
PCN_CFG = os.path.join(ROOT, "completion", "cfgs", "pcn.yaml")
DCP_CFG = os.path.join(ROOT, "registration", "cfgs", "dcp.yaml")
IDAM_CFG = os.path.join(ROOT, "registration", "cfgs", "idam.yaml")
REG_DATA_DIR = os.path.join(ROOT, "registration", "data")   # its test_torch.py's
ECG_CFG = os.path.join(ROOT, "completion", "cfgs", "ecg.yaml")
VRCNET_CFG = os.path.join(ROOT, "completion", "cfgs", "vrcnet.yaml")
DATA_DIR = os.path.join(ROOT, "completion", "data")   # test_torch.py's default

# H100 SXM peaks (NVIDIA's data sheet, at the 700 W limit): fp32 outside the
# tensor cores, bf16 dense on the tensor cores, and device memory.
PEAK_FP32 = 67e12
PEAK_BF16 = 989e12
PEAK_BYTES = 3.35e12
# fp32 instructions issued per second (one FMA counts 2 operations at the
# 67 TFLOP/s peak): the floor of a kernel whose operations are separately
# rounded adds, multiplies and subtracts (kNN under its rounding rule).
ISSUE_FP32 = PEAK_FP32 / 2
# TF32 dense on the tensor cores: the svd head's forward and backward run
# their fp32 products as 3xTF32 there (three TF32 products each).
PEAK_TF32 = 495e12

_PK = "mvp_benchmark_tpu/ops/pallas_kernels.py"
_CSRC = "mvp_benchmark_tpu_torch/ops/csrc"
KERNELS = {   # launch-count key -> the kernel's identity in the kernels line
    "chamfer": {"name": "chamfer_forward", "source": f"{_CSRC}/chamfer.cu",
                "replaces": f"{_PK}:133"},
    "knn": {"name": "knn", "source": f"{_CSRC}/knn.cu",
            "replaces": f"{_PK}:714"},
    "fps": {"name": "furthest_point_sample", "source": f"{_CSRC}/fps.cu",
            "replaces": f"{_PK}:498"},
    "gather": {"name": "gather_rows", "source": f"{_CSRC}/gather.cu",
               "replaces": f"{_PK}:1712"},
    "group_max": {"name": "group_max_forward", "source": f"{_CSRC}/gather.cu",
                  "replaces": f"{_PK}:887",
                  "globals": ["group_max_staged_kernel", "group_max_direct_kernel"]},
    "three_interpolate": {"name": "three_interpolate_forward",
                          "source": f"{_CSRC}/gather.cu",
                          "replaces": f"{_PK}:1050"},
    "sa_attention": {"name": "sa_attention_forward",
                     "source": f"{_CSRC}/sa_attention.cu",
                     "replaces": f"{_PK}:1354"},
}
# The SA backward first builds the reverse list of its index
# (reverse_list.cu's reverse_list_kernel), then runs its gather, and so do
# scatter_add_rows and three_interpolate's backward for a large cloud
# (``kernels.scatter_plan``, ``three_interpolate_backward_plan``); for a
# small cloud these two, and the chamfer backward and group_max's always,
# list their index in shared memory in one launch instead. "globals" names
# the __global__ kernels a call can launch (group_max's forward: staged or
# direct, by ``kernels.group_max_forward_plan``).
_LIST = "reverse_list.cu:reverse_list_kernel"
BACKWARD_KERNELS = {
    "chamfer_backward": {"name": "chamfer_backward",
                         "source": f"{_CSRC}/chamfer.cu",
                         "replaces": f"{_PK}:333",
                         "globals": ["chamfer_backward_kernel"]},
    "scatter_add_rows": {"name": "scatter_add_rows",
                         "source": f"{_CSRC}/gather.cu",
                         "replaces": f"{_PK}:1613",
                         "globals": [_LIST, "scatter_add_rows_kernel",
                                     "scatter_add_rows_local_kernel",
                                     "scatter_add_rows_packed_kernel"]},
    "group_max_backward": {"name": "group_max_backward",
                           "source": f"{_CSRC}/gather.cu",
                           "replaces": f"{_PK}:928",
                           "globals": ["group_max_backward_kernel"]},
    "three_interpolate_backward": {"name": "three_interpolate_backward",
                                   "source": f"{_CSRC}/gather.cu",
                                   "replaces": f"{_PK}:1086",
                                   "globals": [_LIST, "three_interpolate_backward_kernel",
                                               "three_interpolate_backward_local_kernel",
                                               "three_interpolate_dweight_kernel"]},
    "sa_attention_backward": {"name": "sa_attention_backward",
                              "source": f"{_CSRC}/sa_attention.cu",
                              "replaces": f"{_PK}:1417",
                              "globals": ["sa_backward_points_kernel",
                                          "sa_backward_sum_kernel", _LIST,
                                          "sa_backward_rows_kernel"]},
}
KERNELS.update(BACKWARD_KERNELS)
KERNELS.update({
    "ball_query": {"name": "ball_query", "source": f"{_CSRC}/ball_query.cu",
                   "replaces": f"{_PK}:1525"},
    "emd": {"name": "emd_assignment", "source": f"{_CSRC}/emd.cu",
            "replaces": f"{_PK}:2122"},
    "attention": {"name": "attention", "source": f"{_CSRC}/attention.cu",
                  "replaces": f"{_PK}:2449"},
    "attention_bnhd": {"name": "attention_bnhd", "source": f"{_CSRC}/attention.cu",
                       "replaces": f"{_PK}:2637"},
    "edge_mlp": {"name": "edge_mlp_eval", "source": f"{_CSRC}/edge_mlp.cu",
                 "replaces": f"{_PK}:3025"},
    "attention_backward": {"name": "attention_backward",
                           "source": f"{_CSRC}/attention_backward.cu",
                           "replaces": f"{_PK}:2502"},
    "attention_bnhd_backward": {"name": "attention_bnhd_backward",
                                "source": f"{_CSRC}/attention_backward.cu",
                                "replaces": f"{_PK}:2663"},
    "edge_mlp_stat": {"name": "edge_mlp_stat", "source": f"{_CSRC}/edge_mlp.cu",
                      "replaces": f"{_PK}:3009"},
    "edge_mlp_backward": {"name": "edge_mlp_backward",
                          "source": f"{_CSRC}/edge_mlp.cu",
                          "replaces": f"{_PK}:3043"},
    # gnn_propagate_eval runs the edge build (:4370) and gnn_edge_eval
    # (:4242); the kernel fuses the two
    "gnn_propagate": {"name": "gnn_propagate_eval",
                      "source": f"{_CSRC}/gnn_propagate.cu",
                      "replaces": f"{_PK}:4466"},
    "sim_mlp": {"name": "sim_mlp_eval", "source": f"{_CSRC}/sim_mlp.cu",
                "replaces": f"{_PK}:3727"},
    # IDAM's train passes: the edge block's batch statistics (XLA reduces
    # over the edge tensor before the final pass, :4163-4166), its backward
    # (:4430 and :4444); the similarity MLP's stat passes and backward passes
    "gnn_propagate_stat": {"name": "gnn_propagate_stat",
                           "source": f"{_CSRC}/gnn_propagate.cu",
                           "replaces": f"{_PK}:4160"},
    "gnn_propagate_backward": {"name": "gnn_propagate_backward",
                               "source": f"{_CSRC}/gnn_propagate.cu",
                               "replaces": f"{_PK}:4420"},
    # the reverse list of the GNN's graph, built once a graph and step for
    # the backwards' gathers (the TPU's scatter, _gp_bwd2_kernel :4324, needs
    # none)
    "gnn_propagate_list": {"name": "gnn_propagate_list",
                           "source": f"{_CSRC}/reverse_list.cu",
                           "replaces": f"{_PK}:4324"},
    "sim_mlp_stat": {"name": "sim_mlp_stat", "source": f"{_CSRC}/sim_mlp.cu",
                     "replaces": f"{_PK}:3741"},
    "sim_mlp_backward": {"name": "sim_mlp_backward", "source": f"{_CSRC}/sim_mlp.cu",
                         "replaces": f"{_PK}:3806"},
})

# ECG's kernel launches per forward pass, read off models/ecg.py and
# models/common.py: kNN 4 DenseConv self-kNN + 3 edge_preserve_sampling
# knn_points + 3 three_nn; FPS 3 edge_preserve_sampling + 1 on the 3072
# predicted points; gather 2 per edge_preserve_sampling + 4 DenseEdge
# neighbour gathers + 1 after the final FPS; group_max 3; three_interpolate 3.
# calc_cd adds one chamfer launch per val batch.
ECG_PER_BATCH = {"knn": 10, "fps": 4, "gather": 11, "group_max": 3,
                 "three_interpolate": 3}
# VRCNet's, read off models/vrcnet.py and models/common.py at
# completion/cfgs/vrcnet.yaml (knn_list 16, pk 10, layers 1,1,1,1, 3072
# encoder points, num_fps = num_coarse = num_points): kNN 4 self-kNN of the
# pyramid levels + 3 three_nn (edge_preserve_sampling reuses the k 16 self-kNN
# rows, so it launches no kNN); FPS 3 edge_preserve_sampling + 1 of the 3072
# predicted points to 2048; gather 2 per edge_preserve_sampling + 2 after that
# FPS; group_max 3; three_interpolate 3; sa_attention one per SK-SA level (one
# SA branch, one layer each). No score top-k or folding: 2048 points leave the
# FPS, as many as num_coarse and num_points.
VRCNET_PER_BATCH = {"knn": 7, "fps": 4, "gather": 8, "group_max": 3,
                    "three_interpolate": 3, "sa_attention": 4}
# Launches per train step (engine.make_train_step: forward in train mode,
# total.mean() backward). PCN: calc_cd of out1 and of out2, each one chamfer
# forward and, in the backward, one chamfer_backward for the prediction side
# alone (calc_cd(pred, gt) differentiates the second cloud of
# chamfer_distance(gt, pred)). VRCNet: the dual path doubles the batch and
# runs the eval forward once (VRCNET_PER_BATCH; y = gt, since num_input ==
# 2048 == |gt|, so no FPS of gt), plus four calc_cd (coarse_raw,
# coarse_high, coarse, fine): chamfer 4. Its backward runs a kernel for each
# node on a differentiable path to the loss: chamfer_backward 4;
# sa_attention_backward 4; group_max_backward 3 (edge_preserve_sampling's
# neighbour max-pool); three_interpolate_backward 3 (the decoder's
# upsamplings, d_features only: three_nn's distances carry no gradient);
# scatter_add_rows 4, the backward of the gathers whose output reaches the
# loss -- edge_preserve_sampling's centre features, 3, and coarse_high at the
# FPS indices, 1. The other 4 gathers launch no backward: the sampled xyz
# feed only FPS, kNN and three_nn, and the gathered coarse features only the
# score top-k and folding, which this config does not reach. Then one val
# pass: per batch the eval counts plus one chamfer.
PCN_PER_STEP = {"chamfer": 2, "chamfer_backward": 2}
VRCNET_PER_STEP = dict(VRCNET_PER_BATCH, chamfer=4, chamfer_backward=4,
                       sa_attention_backward=4, group_max_backward=3,
                       three_interpolate_backward=3, scatter_add_rows=4)
# ECG (train_losses in models/ecg.py): the forward of ECG_PER_BATCH, two
# calc_cd (chamfer 2, chamfer_backward 2) and get_uniform_loss of out1 (1024
# points: 51 centres, nsample 4/6/8/10/12) and of out2 (2048: 102 centres,
# 8-24). Each uniform loss: FPS 1 and a gather of the centres, then per
# percentage a ball_query, the grouping gather, the kNN (k 2) of the
# grouped points and the gather that recomputes its distances for autograd
# (dispatch.knn_points): ball_query 10, knn 10, gather 2 + 20, fps 2. The
# backward: scatter_add_rows 20 for the uniform losses' two gathers per
# percentage, 8 for the model's gathers whose output reaches the loss
# (edge_preserve_sampling's centre features 3, the four DenseEdge
# neighbour gathers, the fine points after the last FPS); group_max_backward
# 3, three_interpolate_backward 3. The sampled xyz gathers feed only FPS,
# kNN and three_nn, and edge_preserve_sampling's kNN is taken on detached
# points, so neither launches more.
ECG_PER_STEP = dict(ECG_PER_BATCH, knn=20, fps=6, gather=33, ball_query=10,
                    chamfer=2, chamfer_backward=2, scatter_add_rows=28,
                    group_max_backward=3, three_interpolate_backward=3)
# DCP's, read off models/dcp.py at registration/cfgs/dcp.yaml (1 block, 4
# heads): DGCNN runs once on src and once on tgt, each a self-kNN (k 20), a
# gather of the neighbours and one edge chain; the transformer runs twice
# (src -> tgt and tgt -> src), each an encoder self-attention and a decoder
# self- and cross-attention; the svd head one fp32 attention.
DCP_PER_BATCH = {"knn": 2, "gather": 2, "edge_mlp": 2, "attention_bnhd": 6,
                 "attention": 1}
# A DCP train step (engine.make_registration_train_step, prefix "train"):
# the forward's kNN and gathers as in eval (the clouds need no gradient, so
# no scatter), the edge chain in train mode on src and on tgt, each four
# stat passes and the final pass, and the backward: the chain's five passes
# a call (ten), each of the six bnhd attentions' backward, and the svd
# head's (src and tgt embeddings; the target cloud asks for no dV). Each
# attention backward call counts one, though it launches the dQ kernel and
# the dK/dV kernel.
DCP_PER_STEP = {"knn": 2, "gather": 2, "edge_mlp_stat": 8, "edge_mlp": 2,
                "edge_mlp_backward": 10, "attention_bnhd": 6,
                "attention_bnhd_backward": 6, "attention": 1,
                "attention_backward": 1}
# IDAM's, read off models/idam.py at registration/cfgs/idam.yaml (emb 64,
# 3 iterations): the GNN runs once on tgt and once on src, each a self-kNN
# (k 12) and five Propagate edge blocks; each iteration one similarity MLP.
# The top-k, the kept points' takes and the correspondences are plain
# indexing (no gather kernel), as in JAX.
IDAM_PER_BATCH = {"knn": 2, "gnn_propagate": 10, "sim_mlp": 3}
# An IDAM train step (engine.make_registration_train_step, prefix "train"):
# the forward's two self-kNN as in eval, and the reverse list of each of
# the two graphs (the GNN's train forward builds it once for its five
# layers); each of the ten Propagate edge blocks in train mode, a stat pass
# and the final pass, and in the backward its two passes (pass 1: dy, S, dW,
# db; the d_p gather over the graph's list; every layer's p needs its
# gradient); each of the three similarity MLPs two stat passes and the
# final pass, and three backward passes. The gt matches, the sampled kept
# points, the takes and the correspondences are plain torch.
IDAM_PER_STEP = {"knn": 2, "gnn_propagate_list": 2, "gnn_propagate_stat": 10,
                 "gnn_propagate": 10, "gnn_propagate_backward": 20, "sim_mlp_stat": 6,
                 "sim_mlp": 3, "sim_mlp_backward": 9}
TRAIN_STEPS = 3       # max_steps_per_epoch of each driven train path
# The SA block's tolerance against its plain version on the card:
# |kernel - plain| <= SA_ATOL + SA_RTOL |plain| (another summation order).
SA_ATOL, SA_RTOL = 1e-5, 1e-4
# bf16 kernels against their plain versions, normwise |kernel - plain| /
# |plain|: the attention's online softmax rounds p to bf16 before dividing by
# the row sum, the plain version after (3.1e-3 measured on an H100); the edge
# chain sums in another order, and an activation may round to the other bf16
# neighbour (1.4e-5 measured, at (3, 1001, k 7)).
ATTN_BF16_NORM, EDGE_MLP_NORM = 1e-2, 1e-4
# DCP on the card against the CPU, two full-width clouds, the same weights:
# the bf16 transformer's products round differently in cuBLAS and on the CPU.
# Each output's bar is 6-10x its gap measured on an H100 (loss 1.8e-5, RotE
# 0.028 degrees, transE 3.3e-4, RMSE 2.4e-4, MSE 8.1e-4, T_12 6.8e-4).
DCP_CPU_ATOL = {"loss": 2e-4, "RotE": 0.25, "transE": 3e-3, "RMSE": 2.5e-3,
                "MSE": 5e-3, "T_12": 5e-3}
# DCP's train kernels against their plain versions on the card. The bf16
# attention backward normwise (its p and ds round to bf16 as the plain
# version's do; 1.7e-4 measured on an H100); the fp32 one within SA_ATOL +
# SA_RTOL |plain| (3xTF32 on the tensor cores, in another order than the
# plain version's fp32 products: max |diff| 3.9e-7 measured on an H100 at
# DCP's shape). Two runs of each bitwise equal (no atomics). The train
# chain's forward normwise, its max-pools EDGE_TRAIN_NORM (the kernel folds
# the batch statistics into a scale and shift, the plain version does not:
# an activation may round to the other bf16 neighbour; 2.3e-4 measured) and
# its statistics EDGE_STAT_NORM (5.3e-7 measured at (32, 2048, k 20), 2.5e-6
# at (3, 1001, k 7), where the layers below hand on more of their flips);
# its gradients normwise
# EDGE_GRAD_NORM against autograd of the plain version, which rounds the
# carried cotangent to bf16 where the kernel rounds dh (1.6e-2 measured for
# d_a1, <= 1.2e-2 for the others), at the JAX test's own bar for its
# 4-layer kernel against its reference, and against ref.edge_mlp_backward,
# which rounds where the kernel does (1.8e-3 measured at every shape).
ATTN_BF16_BWD_NORM = 1e-3
EDGE_TRAIN_NORM, EDGE_STAT_NORM, EDGE_GRAD_NORM = 1e-3, 1e-5, 2e-2
# A DCP train step on two full-width pairs, card against CPU
# (check_dcp_step_on_cpu), in stages. (a) The card step's edge-chain
# statistics, both calls and every layer's mean and variance, normwise
# against the chain in fp64 on the same edges and weights, each layer with
# the fp64 statistics of the layers below folded (ref.edge_mlp_stats_given
# in fp64, finding them as it goes), at EDGE_STAT_NORM (measured on an H100
# 80GB HBM3 at 700 W over ten seeds: the wgmma stat passes 1.56e-6 at most,
# the plain chain on the card 1.71e-6).
# (b) The CPU step again with the card's statistics substituted by value
# (the gradient still through its own, ref.edge_mlp_train's ``given``),
# held to DCP_STEP_BARS: the loss absolute, the gradients' cosine outside
# the edge chain, the running statistics absolute, the edge chain's leaves
# by cosine and normwise against each leaf's own norm (bars that a zero or
# sign-flipped gradient fails), each but the loss 6-30x the free run's gap
# on an H100 with the first design's stat passes (1 - 2.1e-5; 7.7e-7; 1 -
# 3.3e-6, 2.6e-3). (c) A witness, the plain chain on the card
# (plain_dcp_chain), through (a) and (b) at the same bars. (d) The free
# run, the CPU with its own statistics, printed for both and held to the
# same bars. The loss is a step function of the bf16 roundings of the
# chain and of the bf16 transformer, so a right implementation's loss gap
# is about constant in absolute terms, and no smaller given the card's
# statistics than free: over ten seeds of the weights and the batch
# (probe_forward_mlps.py --dcp-loss and --dcp-stages, the same card)
# stages (b) and (d) of the kernels and of the witness lay within 4.8e-5
# absolute of the CPU's loss, at losses of 0.036-0.32; at this check's
# batch (seed 1, whose loss is 4-9x smaller than the other seeds') that is
# 1.3e-3 relative, the witness's stage (b) read -9.4e-4, and the card's
# own loss moves by 3.6e-4 relative when the chain's first BatchNorm scale
# moves by 1e-6. Hence one absolute loss bar for every stage and variant,
# about twice those gaps; the loss does not tell one summation order of
# the statistics from another, stage (a) does.
DCP_STEP_BARS = {"loss": 1e-4, "cosine": 0.9998, "stats": 1e-5,
                 "chain_cosine": 0.9999, "chain_normwise": 2e-2}
# IDAM's similarity kernel runs its two 32 x 32 products on the tensor
# cores, which sum the channels in another order than the plain version's
# channel order; where that could change a bf16 rounding of h1 or a relu mask
# of BatchNorm 2 the kernel sums the element again in channel order
# (sim_mlp.cu's kMargin16), so every bf16 value and mask equals the plain
# version's and bf16(wmax) is equal; simr and wmax differ by the fp32
# summation order only: within SIM_FINAL_ATOL + SIM_FINAL_RTOL |plain|
# (check_sim_final), about 4x the largest gap measured on an H100 80GB HBM3
# at 700 W (6.0e-7 at (32, 341); 9.4e-7 on a one-pair batch's logits of
# ~15), and a saved j other than the plain version's only where the plain
# version's h1 at that j lies within twice that bar of its max. The
# edge block's final pass runs its product on the tensor cores, which sum
# the 64 channels in another order (x1 and W are bf16, so every product is
# exact and only the sums differ): its outputs
# within GNN_FINAL_ATOL + GNN_FINAL_RTOL |plain| of the plain version's
# (check_propagate_final), about 4x the largest gap measured on an H100
# 80GB HBM3 at 700 W (9.5e-7 over the 4.2 M outputs at (32, 2048, k 12, C
# 64), 2.4e-7 to 4.8e-7 at the other shapes), and a saved slot other than
# the plain version's only where the plain version's two largest
# candidates lie within twice that bar of each other (no slot flipped at
# any shape there). IDAM on the card against the CPU, two full-width
# pairs, the same weights: the GNN rounds its gather table to bf16, so the
# one-ulp differences of cuBLAS's and the CPU's projection products move
# some table entries to the other bf16 neighbour, 2^-8 of their value, and
# the embeddings are held normwise (IDAM_EMB_NORM, the CPU test's bar against
# JAX, tests/test_torch_idam.py). The kept points and the correspondences
# may then flip where scores or similarities nearly tie (with seeded weights
# and the initial running statistics the significance scores are nearly
# flat, so near-ties are many): the flips are counted; with the card's kept
# points handed to the CPU too, a pair's pose and metrics are held to
# IDAM_CPU_ATOL where no correspondence flipped: the bars of the CPU test
# against JAX, whose T_12 moved 2.2e-4 by bf16 roundings of the similarity
# MLP's activations (measured card vs CPU on an H100: T_12 1.9e-6, RotE
# 2.3e-5 degrees, transE 1.6e-6, RMSE 4.2e-7, MSE 2.0e-6).
IDAM_EMB_NORM = 2e-2
GNN_FINAL_ATOL, GNN_FINAL_RTOL = 4e-6, 4e-6
SIM_FINAL_ATOL, SIM_FINAL_RTOL = 2e-6, 2e-6
# IDAM's train kernels against their plain versions on the card, normwise:
# the stat passes sum per-block partials (another order), the backward
# passes sum in other orders too, and a cotangent near a bf16 boundary may
# round to the other neighbour (dx1, dh1, da).
# Measured on an H100 80GB HBM3 at 700 W: stat passes 6.3e-7 at most
# since the forward runs on the tensor cores (1.4e-6 before), backward
# passes 1.3e-5 (the tensor-core backward, whose bf16 roundings and relu
# masks equal the plain version's: see sim_mlp.cu's kMargin16).
IDAM_STAT_NORM = 1e-5
IDAM_GRAD_NORM = 2e-4
# The similarity backward's dwxyz, dW2 and dW3 are bf16 roundings of fp32
# sums over every pair (ops/ref.py's rounding rule), which the kernel and
# the plain version take in other orders: an element whose two sums fall
# on either side of a rounding boundary lands one bf16 ulp apart, and one
# such element of a 32 x 32 gradient can weigh 2e-4 normwise (dW3 at (2,
# 64, ties) read 2.06e-4 on an H100 80GB HBM3 at 700 W with the tensor-core
# forward's statistics). They are held elementwise (check_bf16_sums): equal,
# or one ulp apart in at most SIM_BF16_FLIPS of their elements (3 of 1024
# at most measured there), and normwise within SIM_BF16_NORM, about 1.5x
# that one flip's 2.06e-4.
SIM_BF16_GRADS = ("dwxyz", "dW2", "dW3")
SIM_BF16_FLIPS, SIM_BF16_NORM = 0.01, 3e-4
# An IDAM train step on two full-width pairs, card against CPU
# (check_idam_step_on_cpu), the same weights and kept source points, and
# the card's gt matches and correspondences handed to the CPU: the loss
# relative, every gradient leaf by cosine and normwise against its own
# norm, the shift-invariant leaves against the whole gradient's norm, the
# running statistics relative to each one's largest magnitude. Measured on
# an H100 80GB HBM3 at 700 W: 1.9e-4; cosine >= 0.983 and normwise <= 0.186
# (weight_fcs.2's first Dense); 3.9e-4; 4.3e-3; since the edge block's
# final pass sums on the tensor cores, 2.9e-4; cosine >= 0.956 and
# normwise <= 0.304 (sim1_bias2); 3.4e-4; 5.8e-3; and the same since the
# similarity MLP's forward runs on the tensor cores too, while the witness
# (plain_idam_forwards: both forwards plain, in the CPU's order) reads
# cosine >= 0.989 and normwise <= 0.149 (sim1_bias2): what the two tensor
# cores' summation orders cost. The card's own gradient moves by up to 0.23
# normwise a leaf when the first edge block's BatchNorm scale moves by
# 1e-6: with activations rounded to bf16 the gradient is a step function
# at the scale of the two devices' one-ulp differences, so the leaves are
# held at about twice the first measured gaps, not at the kernels' bars.
IDAM_STEP_BARS = {"loss": 1e-3, "cosine": 0.95, "normwise": 0.4, "shift": 5e-3,
                  "stats": 2e-2}
IDAM_CPU_ATOL = {"RotE": 0.05, "transE": 1e-3, "RMSE": 1e-3, "MSE": 1e-3,
                 "T_12": 1e-3}


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def card_line(query="name,power.limit") -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def uniform(seed, shape, device):
    rng = np.random.default_rng([seed, *shape])
    return torch.from_numpy(rng.random(shape, dtype=np.float64)
                            .astype(np.float32)).to(device)


def indices(seed, high, shape, device):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, high, shape, generator=g, dtype=torch.int32).to(device)


def clouds(seed, B, N, M, device):
    rng = np.random.default_rng(seed)
    a = rng.random((B, N, 3), dtype=np.float64).astype(np.float32)
    b = rng.random((B, M, 3), dtype=np.float64).astype(np.float32)
    return torch.from_numpy(a).to(device), torch.from_numpy(b).to(device)


def duplicate_clouds(device):
    """Exact ties, within a shared-memory tile and across tiles."""
    a, b = clouds(9, 4, 2048, 2048, device)
    b[:, 1024:] = b[:, :1024]         # b[j + 1024] == b[j]: across tiles
    b[:, 10:20] = b[:, 0:10]          # within a tile
    a[:, :512] = b[:, 100:612]        # exact hits on duplicated b points
    a[:, 1500:1600] = a[:, 0:100]
    return a, b


def duplicate_ragged_clouds(device):
    """Exact ties at ragged sizes, b the larger cloud (the chamfer forward's
    rows): b's copies across its 256-row blocks and warps, a's across a
    32-column step and past its first 2048 columns, and exact hits."""
    a, b = clouds(10, 3, 2100, 2300, device)
    b[:, 2048:2300] = b[:, 0:252]     # rows in the first and the ninth block
    b[:, 40:45] = b[:, 33:38]         # within a warp's rows and across warps
    a[:, 1000:1100] = a[:, 0:100]     # columns ties
    a[:, 2050:2100] = a[:, 5:55]
    a[:, 1500:1600] = b[:, 2200:2300]   # exact hits on duplicated b points
    return a, b


def check_equal(name, got, want):
    """Indices equal and float values bitwise equal (0 ulp apart); returns
    the largest absolute difference of the float outputs."""
    max_abs = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        check(g.shape == w.shape and g.dtype == w.dtype,
              f"{name} output {i}: {g.shape}/{g.dtype} vs {w.shape}/{w.dtype}")
        if g.dtype == torch.float32:
            max_abs = max(max_abs, float((g - w).abs().max()))
            g, w = g.view(torch.int32), w.view(torch.int32)
        bad = int((g != w).sum())
        check(bad == 0, f"{name} output {i}: {bad} of {g.numel()} differ")
    print(f"kernel == plain: {name}: indices equal, values 0 ulp apart")
    return max_abs


def check_equal_nan(name, got, want):
    """Float outputs NaN at the same places and bitwise equal elsewhere (the
    kernels' NaN and the CPU's differ in their bits); returns the largest
    absolute difference where both are numbers."""
    max_abs = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        check(g.shape == w.shape and g.dtype == w.dtype == torch.float32,
              f"{name} output {i}: {g.shape}/{g.dtype} vs {w.shape}/{w.dtype}")
        nan = torch.isnan(w)
        check(bool((torch.isnan(g) == nan).all()), f"{name} output {i}: NaN elsewhere")
        g, w = g[~nan], w[~nan]
        if g.numel():
            max_abs = max(max_abs, float((g - w).abs().max()))
        bad = int((g.view(torch.int32) != w.view(torch.int32)).sum())
        check(bad == 0, f"{name} output {i}: {bad} of {g.numel()} differ")
    print(f"kernel == plain: {name}: NaN at the same places ({int(nan.sum())} in the "
          f"last output), values 0 ulp apart elsewhere")
    return max_abs


def check_close(name, got, want, normwise=False):
    """|got - want| <= SA_ATOL + SA_RTOL |want| everywhere, or with
    ``normwise`` <= SA_ATOL + SA_RTOL max|want|; returns the largest absolute
    difference. ``normwise`` is for a gradient summed over every point of
    the batch (the SA block's dW1, dW2, db2: 49 k to 197 k terms an entry in
    the train step), whose entries that cancel to near 0 keep the rounding
    of the whole sum."""
    check(got.shape == want.shape and got.dtype == want.dtype,
          f"{name}: {got.shape}/{got.dtype} vs {want.shape}/{want.dtype}")
    diff = (got - want).abs()
    scale = want.abs().max() if normwise else want.abs()
    bad = int((~(diff <= SA_ATOL + SA_RTOL * scale)).sum())
    max_abs = float(diff.max())
    check(bad == 0, f"{name}: {bad} of {got.numel()} outside the tolerance, "
          f"max |diff| {max_abs!r}")
    print(f"kernel ~ plain: {name}: max |diff| {max_abs!r} within "
          f"{SA_ATOL} + {SA_RTOL} {'max|plain|' if normwise else '|plain|'}")
    return max_abs


def sa_inputs(seed, B, N, k, rel, mid, device, share=8):
    """The SA block's inputs: unit-scale proj and x1 in [-0.5, 0.5), weights
    at torch's init scale (the model's), neighbour indices uniform."""
    ms = mid // share
    proj = uniform(seed, (B, N, rel + mid), device) - 0.5
    x1 = uniform(seed + 1, (B, N, rel), device) - 0.5
    idx = indices(seed + 2, N, (B, N, k), device)
    b1, b2 = ((1 + k) * rel) ** -0.5, ms ** -0.5
    W1 = (uniform(seed + 3, ((1 + k) * rel, ms), device) * 2 - 1) * b1
    W2 = (uniform(seed + 4, (ms, k * ms), device) * 2 - 1) * b2
    bias = (uniform(seed + 5, (k * ms,), device) * 2 - 1) * b2
    return proj, x1, idx, W1, W2, bias


def compare_kernels_with_plain(device):
    """Phase 3. Returns {launch-count key: max |kernel - plain|}."""
    err = {k: 0.0 for k in KERNELS}

    cases = {
        "random_32x2048x2048": clouds(0, 32, 2048, 2048, device),
        "random_2x96x50": clouds(1, 2, 96, 50, device),
        "duplicates_4x2048x2048": duplicate_clouds(device),
        # the VRCNet train step's four calc_cd: predictions against gt2
        "vrcnet_coarse_raw_64x1024x2048": clouds(40, 64, 1024, 2048, device),
        "vrcnet_coarse_high_64x3072x2048": clouds(41, 64, 3072, 2048, device),
        "vrcnet_coarse_64x2048x2048": clouds(42, 64, 2048, 2048, device),
        "vrcnet_fine_64x2048x2048": clouds(43, 64, 2048, 2048, device),
        # ragged: no multiple of 8 rows a lane, 32 columns a step, 256 rows a
        # block or 2048 columns a tile; two column tiles
        "ragged_3x1001x2049": clouds(44, 3, 1001, 2049, device),
        "ragged_2x2050x777": clouds(45, 2, 2050, 777, device),
        "ragged_2x3000x2100": clouds(46, 2, 3000, 2100, device),
        "duplicates_ragged_3x2100x2300": duplicate_ragged_clouds(device),
    }
    for name, (a, b) in cases.items():
        got = kernels.chamfer_forward(a, b)
        err["chamfer"] = max(err["chamfer"], check_equal(
            f"chamfer {name}", got, ref.chamfer_distance(a, b)))
        if name.startswith(("random_32", "vrcnet_coarse_high", "duplicates_ragged")):
            check_rerun_bitwise(f"chamfer {name}", got, kernels.chamfer_forward(a, b))

    x1 = uniform(1, (32, 3072, 3), device)          # ECG's encoder points
    x2 = x1[:, :1024].contiguous()
    f1 = uniform(2, (32, 3072, 24), device)         # DenseConv 1's features
    dup = uniform(3, (4, 3072, 3), device)
    dup[:, 1536:] = dup[:, :1536]
    dup[:, 7] = dup[:, 3000]
    knn_cases = {
        "self_32x3072x3072_C24_k16": (f1, f1, 16),
        "feature_32x1024x1024_C48_k16": (uniform(4, (32, 1024, 48), device),) * 2 + (16,),
        "knn_points_32x1024x3072_C3_k16": (x2, x1, 16),
        "three_nn_32x3072x1024_C3_k3": (x1, x2, 3),
        "duplicates_4x3072x3072_C3_k16": (dup, dup, 16),
        "ragged_2x96x200_C3_k16": (uniform(5, (2, 96, 3), device),
                                   uniform(6, (2, 200, 3), device), 16),
    }
    for name, (q, p, k) in knn_cases.items():
        err["knn"] = max(err["knn"], check_equal(
            f"knn {name}", kernels.knn(q, p, k), ref.knn(q, p, k)))

    for name, (x, s) in {"32x3072->2048": (x1, 2048), "32x3072->1024": (x1, 1024),
                         "duplicates_4x3072->2048": (dup, 2048),
                         "ragged_3x200->24": (uniform(7, (3, 200, 3), device), 24)}.items():
        got = kernels.furthest_point_sample(x, s)
        want = ref.furthest_point_sample(x, s)
        err["fps"] = max(err["fps"], check_equal(f"fps {name}", [got], [want]))

    t120 = uniform(8, (32, 3072, 120), device)
    t24 = uniform(9, (32, 3072, 24), device)
    p_idx = indices(10, 3072, (32, 1024), device)
    edge_idx = indices(11, 3072, (32, 3072, 16), device)
    gather_cases = {
        "points_32x3072x3_by_1024": (x1, p_idx),
        "features_32x3072x120_by_1024": (t120, p_idx),
        "dense_edge_32x3072x24_by_3072x16": (t24, edge_idx),
    }
    for name, (f, idx) in gather_cases.items():
        err["gather"] = max(err["gather"], check_equal(
            f"gather_rows {name}", [kernels.gather_rows(f, idx)],
            [ref.gather_points(f, idx)]))

    for (n, c, m) in ((3072, 120, 1024), (1024, 360, 256), (256, 840, 64)):
        f = uniform(12 + n, (32, n, c), device)
        idx = indices(13 + n, n, (32, m, 16), device)
        err["group_max"] = max(err["group_max"], check_equal(
            f"group_max {n}x{c}->{m}", kernels.group_max_forward(f, idx),
            ref.group_max(f, idx)))
    err["group_max"] = max(err["group_max"], check_group_max_forward(device))

    for (ms, c, n) in ((64, 1024, 256), (256, 768, 1024), (1024, 512, 3072)):
        f = uniform(14 + ms, (32, ms, c), device) - 0.5
        src = uniform(15 + ms, (32, ms, 3), device)
        tgt = uniform(16 + ms, (32, n, 3), device)
        idx, w = ref.three_nn_upsampling(tgt, src)
        err["three_interpolate"] = max(err["three_interpolate"], check_equal(
            f"three_interpolate {ms}x{c}->{n}",
            [kernels.three_interpolate_forward(f, idx, w)],
            [ref.three_interpolate(f, idx, w)]))

    # VRCNet's four SK-SA levels at full width, then ragged N and k 8/32.
    for (B, n, k, rel, mid) in ((32, 3072, 16, 4, 16), (32, 1536, 16, 8, 32),
                                (32, 768, 16, 16, 64), (32, 384, 16, 32, 128),
                                (3, 97, 8, 4, 16), (2, 1001, 8, 32, 128),
                                (2, 333, 32, 16, 64)):
        args = sa_inputs(30 + n, B, n, k, rel, mid, device)
        name = f"sa_attention ({B}, {n}, k {k}, rel {rel}, mid {mid})"
        got = kernels.sa_attention_forward(*args, rel, mid, 8)
        check_rerun_bitwise(name, [got], [kernels.sa_attention_forward(*args, rel, mid, 8)])
        err["sa_attention"] = max(err["sa_attention"], check_close(
            name, got, ref.sa_attention(*args, rel, mid, 8)))
    torch.cuda.synchronize()
    return err


# group_max's forward at the VRCNet and ECG train steps' shapes (B, n, c, m,
# k), then k 255, an odd C, k 17 (no unrolled k) and a table too tall to
# stage (the direct form)
GROUP_MAX_FWD_CASES = {
    "vrcnet_level1_64x3072x64_by_1536x10": (64, 3072, 64, 1536, 10),
    "vrcnet_level2_64x1536x128_by_768x10": (64, 1536, 128, 768, 10),
    "vrcnet_level3_64x768x256_by_384x10": (64, 768, 256, 384, 10),
    "ecg_32x256x840_by_64x16": (32, 256, 840, 64, 16),
    "ecg_32x1024x360_by_256x16": (32, 1024, 360, 256, 16),
    "ecg_32x3072x120_by_1024x16": (32, 3072, 120, 1024, 16),
    "k255_2x300x24_by_100x255": (2, 300, 24, 100, 255),
    "odd_c_3x97x5_by_41x7": (3, 97, 5, 41, 7),
    "k17_2x500x12_by_200x17": (2, 500, 12, 200, 17),
    "tall_2x20000x24_by_500x10": (2, 20000, 24, 500, 10)}


def check_group_max_forward(device):
    """group_max's forward (``kernels.group_max_forward_plan``) at
    ``GROUP_MAX_FWD_CASES`` on relu'd features (ties) with a neighbour
    twice, the max and the slot bitwise the plain version on CPU copies
    and run twice; then an index outside [0, n) and a NaN row: NaN and slot
    255 in the bad index's row, the NaN kept at j = 0 and passed over
    later. Returns max |kernel - plain|."""
    err = 0.0
    for name, (B, n, c, m, k) in GROUP_MAX_FWD_CASES.items():
        f = torch.relu(uniform(17 + n, (B, n, c), device) - 0.5)
        idx = indices(18 + n, n, (B, m, k), device)
        idx[:, :, k - 1] = idx[:, :, 0]
        got = kernels.group_max_forward(f, idx)
        check_rerun_bitwise(f"group_max {name}", got, kernels.group_max_forward(f, idx))
        err = max(err, check_equal(f"group_max {name} against the plain version on the CPU",
                                   [x.cpu() for x in got], ref.group_max(f.cpu(), idx.cpu())))
    f = uniform(19, (2, 50, 16), device)
    f[0, 5] = float("nan")
    idx = indices(20, 50, (2, 30, 10), device)
    idx[0, 3, 0], idx[0, 4, 1], idx[1, 7, 4] = 5, 5, 50 + 3
    out, slot = kernels.group_max_forward(f, idx)
    ok = idx.cpu().clone()
    ok[1, 7, 4] = 0
    want, want_slot = ref.group_max(f.cpu(), ok)
    want[1, 7], want_slot[1, 7] = float("nan"), 255
    check_equal_nan("group_max out of range and NaN against the plain version on the CPU",
                    [out.cpu()], [want])
    check_equal("group_max out of range and NaN: slots", [slot.cpu()], [want_slot])
    return err


# three_interpolate's backward (B, Ms, N, C, need_w): the VRCNet step's three,
# ECG's three, a ragged shape, every target on row 0, and a cloud of more
# than one chunk of kernels.TI_BWD_CHUNK entries
TI_BWD_CASES = {
    "level4to3_64x384x512_to_768": (64, 384, 768, 512, False),
    "level3to2_64x768x256_to_1536": (64, 768, 1536, 256, False),
    "level2to1_64x1536x128_to_3072": (64, 1536, 3072, 128, True),
    "ecg_32x64x1024_to_256": (32, 64, 256, 1024, False),
    "ecg_32x256x768_to_1024": (32, 256, 1024, 768, False),
    "ecg_32x1024x512_to_3072": (32, 1024, 3072, 512, False),
    "ragged_2x37x5_to_101": (2, 37, 101, 5, True),
    "collisions_2x64x16_to_512_all_row_0": (2, 64, 512, 16, True),
    "chunks_2x2000x64_to_6000": (2, 2000, 6000, 64, False)}


def ti_backward_forms(ms, c, n):
    """{form: plan} of ``kernels.three_interpolate_backward_plan`` that a
    three_interpolate backward call is checked under: the plan's own and
    the other form (the list in device memory, or the one-launch form's
    default plan)."""
    vectors = c // 8 if c % 8 == 0 else c
    plan = kernels.three_interpolate_backward_plan(ms, c, n, vectors)
    if not plan[0]:
        return {"list (the plan's)": plan,
                "one launch": kernels.three_interpolate_backward_local_plan(ms, c, n, vectors)}
    return {"one launch (the plan's)": plan, "list": (0, 0, 0)}


def check_three_interpolate_backward(device, err):
    """three_interpolate's backward at ``TI_BWD_CASES`` under both forms
    (``ti_backward_forms``): d_features bitwise the plain version on CPU
    copies and run twice, d_weight within the bar of the plain version on
    the card and run twice; the plan's own form also within the bar of the
    plain version on the card, with its index's reverse list checked; then
    an index outside [0, Ms): NaN at row 0 of its cloud under both forms."""
    plan_fn = kernels.three_interpolate_backward_plan
    for name, (B, ms, n, c, need_w) in TI_BWD_CASES.items():
        f = cotangent(50 + n, (B, ms, c), device)
        src = uniform(51 + n, (B, ms, 3), device)
        idx, w = ref.three_nn_upsampling(uniform(52 + n, (B, n, 3), device), src)
        if name.startswith("collisions"):
            idx = torch.zeros_like(idx)
        g = cotangent(53 + n, (B, n, c), device,
                      positive=name.startswith("collisions"))
        on_cpu = ref.three_interpolate_backward(g.cpu(), idx.cpu(), w.cpu(), f.cpu(), need_w)
        for form, plan in ti_backward_forms(ms, c, n).items():
            kernels.three_interpolate_backward_plan = lambda *a, plan=plan: plan
            try:
                got = kernels.three_interpolate_backward(g, idx, w, f, need_w)
                check_rerun_bitwise(f"three_interpolate_backward {name} ({form})",
                                    [x for x in got if x is not None],
                                    [x for x in kernels.three_interpolate_backward(
                                        g, idx, w, f, need_w) if x is not None])
            finally:
                kernels.three_interpolate_backward_plan = plan_fn
            check((got[1] is None) == (not need_w), f"three_interpolate_backward {name}")
            check_equal(f"three_interpolate_backward {name} ({form}) d_features against "
                        "the plain version on the CPU", [got[0].cpu()], [on_cpu[0]])
            if not form.endswith("(the plan's)"):
                continue
            check_list(f"three_interpolate {name}", idx, ms)
            want = ref.three_interpolate_backward(g, idx, w, f, need_w)
            for part, gt_, wt in zip(("d_features", "d_weight"), got, want):
                if wt is not None:
                    err["three_interpolate_backward"] = max(
                        err["three_interpolate_backward"], check_close(
                            f"three_interpolate_backward {name} {part}", gt_, wt))
    B, ms, n, c = 2, 50, 200, 24
    f = cotangent(54, (B, ms, c), device)
    idx, w = ref.three_nn_upsampling(uniform(55, (B, n, 3), device),
                                     uniform(56, (B, ms, 3), device))
    g = cotangent(57, (B, n, c), device)
    ok = idx.cpu().clone()
    idx[0, 7, 1], idx[1, 150, 2] = ms + 3, -1
    ok[0, 7, 1] = ok[1, 150, 2] = 0
    want, _ = ref.three_interpolate_backward(g.cpu(), ok, w.cpu(), f.cpu(), False)
    want[:, 0] = float("nan")
    for form, plan in ti_backward_forms(ms, c, n).items():
        kernels.three_interpolate_backward_plan = lambda *a, plan=plan: plan
        try:
            got, _ = kernels.three_interpolate_backward(g, idx, w, f, False)
        finally:
            kernels.three_interpolate_backward_plan = plan_fn
        check_equal_nan(f"three_interpolate_backward out of range ({form}) against the "
                        "plain version on the CPU", [got.cpu()], [want])


def compare_knn_across_tiles(device):
    """kNN (64, 3072^2, C 3, k 16), VRCNet's first self-kNN of a step, on
    points with five exact copies on both sides of every candidate tile's
    boundary: bitwise against its plain version and run twice. Returns
    max |kernel - plain|."""
    tile = kernels.knn_tile_points(3, 3072)
    p = uniform(600, (64, 3072, 3), device)
    for j in range(tile, 3072, tile):
        p[:, j:j + 5] = p[:, j - 5:j]
    first = kernels.knn(p, p, 16)
    err = check_equal(f"knn 64x3072x3072_C3_k16 with copies across the "
                      f"{tile}-point tiles", first, ref.knn(p, p, 16))
    check_rerun_bitwise("knn 64x3072x3072_C3_k16 across tiles", first,
                        kernels.knn(p, p, 16))
    return err


def cotangent(seed, shape, device, positive=False):
    """Unit-scale cotangents in [-1, 1), or in [0, 1) where a collision case
    sums thousands of them into one row: there the bar relative to |plain|
    holds a lost or doubled term, not the rounding of a sum that cancels to
    near 0."""
    u = uniform(seed, shape, device)
    return u if positive else u * 2 - 1


def check_list(name, idx, num_rows):
    """reverse_list.cu's list of an index, bitwise ``ref.reverse_list``'s
    (a stable sort: every row's entries ascending), and equal in a second
    run."""
    got = kernels.reverse_list(idx, num_rows)
    again = kernels.reverse_list(idx, num_rows)
    check_equal(f"reverse_list {name}", got, ref.reverse_list(idx, num_rows))
    check_rerun_bitwise(f"reverse_list {name}", got, again)


def compare_backward_kernels_with_plain(device):
    """Phase 3b: the five backward kernels against their plain versions, at
    the VRCNet train step's shapes (the dual path doubles the batch to 64),
    a ragged shape and heavy index collisions, within
    |kernel - plain| <= SA_ATOL + SA_RTOL |plain| (the plain versions
    scatter with the card's atomic ``index_add_``), each run twice and the
    two bitwise equal; their reverse lists bitwise equal to the plain
    list. Returns {launch-count key: max |kernel - plain|}."""
    err = dict.fromkeys(BACKWARD_KERNELS, 0.0)

    gt, pred = clouds(40, 64, 2048, 3072, device)
    collapsed = clouds(41, 4, 2048, 1024, device)[1]
    collapsed[:, :1000] = collapsed[:, :1]          # 1000 copies of one point
    cases = {   # name: (a, b, need_a, need_b); calc_cd(pred, gt) needs db
        "calc_cd_64x2048_vs_3072": (gt, pred, False, True),
        "calc_cd_64x2048_vs_2048": (gt, pred[:, :2048].contiguous(), False, True),
        "calc_cd_64x2048_vs_1024": (gt, pred[:, :1024].contiguous(), False, True),
        "ragged_2x96x50_both": clouds(42, 2, 96, 50, device) + (True, True),
        "collapsed_4x2048_vs_1024_both": (clouds(41, 4, 2048, 1024, device)[0],
                                          collapsed, True, True),
        "chunks_2x5000x300_db": clouds(39, 2, 5000, 300, device) + (False, True),
    }
    for name, (a, b, need_a, need_b) in cases.items():
        d1, d2, i1, i2 = ref.chamfer_distance(a, b)
        g1 = cotangent(43, tuple(d1.shape), device, name.startswith("collapsed"))
        g2 = cotangent(44, tuple(d2.shape), device, name.startswith("collapsed"))
        got = kernels.chamfer_backward(a, b, i1, g1, i2, g2, need_a, need_b)
        check_rerun_bitwise(f"chamfer_backward {name}", [x for x in got if x is not None],
                            [x for x in kernels.chamfer_backward(a, b, i1, g1, i2, g2,
                                                                 need_a, need_b)
                             if x is not None])
        if name.startswith("collapsed"):             # da's list of i2: 1000 on one row
            longest = int(torch.bincount(i2[0].long(), minlength=a.shape[1]).max())
            check(longest >= 1000, f"chamfer_backward {name}: longest list {longest}")
        want = ref.chamfer_backward(a, b, i1, g1, i2, g2, need_a, need_b)
        on_cpu = ref.chamfer_backward(*(x.cpu() for x in (a, b, i1, g1, i2, g2)),
                                      need_a, need_b)
        for side, g, w, c in zip("ab", got, want, on_cpu):
            check((g is None) == (w is None), f"chamfer_backward {name} d{side}")
            if g is not None:
                err["chamfer_backward"] = max(err["chamfer_backward"], check_close(
                    f"chamfer_backward {name} d{side}", g, w))
                check_equal(f"chamfer_backward {name} d{side} against the plain version "
                            "on the CPU", [g.cpu()], [c])
    # argmins outside the other cloud: a point's own term NaN; listed under
    # point 0, whose sum turns NaN
    a, b = clouds(42, 2, 96, 50, device)
    _, _, i1, i2 = ref.chamfer_distance(a, b)
    g1, g2 = cotangent(43, (2, 96), device), cotangent(44, (2, 50), device)
    i1[0, 5], i2[1, 7] = 50 + 3, -2
    got = kernels.chamfer_backward(a, b, i1, g1, i2, g2)
    check_rerun_bitwise("chamfer_backward out of range", [x.view(torch.int32) for x in got],
                        [x.view(torch.int32)
                         for x in kernels.chamfer_backward(a, b, i1, g1, i2, g2)])
    ok = [x.cpu().clone() for x in (a, b, i1, g1, i2, g2)]
    ok[2][0, 5], ok[3][0, 5], ok[4][1, 7], ok[5][1, 7] = 0, 0, 0, 0
    da, db = ref.chamfer_backward(*ok)
    da[0, 5], da[1, 0], db[0, 0], db[1, 7] = (float("nan"),) * 4
    check_equal_nan("chamfer_backward out of range against the plain version on the CPU",
                    [x.cpu() for x in got], [da, db])

    for name, (B, n, m, c, k, local) in {   # local: a one-launch form
            "center_64x3072x64_by_1536": (64, 3072, 1536, 64, None, True),
            "center_64x768x256_by_384": (64, 768, 384, 256, None, True),
            "coarse_64x3072x3_by_2048": (64, 3072, 2048, 3, None, True),
            "ragged_3x97x5_by_41x7": (3, 97, 41, 5, 7, True),
            "uniform_knn_3264x24x3_by_24x2": (3264, 24, 24, 3, 2, True),
            "uniform_knn_1632x4x3_by_4x2": (1632, 4, 4, 3, 2, True),
            "packed_limit_5x1024x1_by_256": (5, 1024, 256, 1, None, True),
            "past_packed_5x1024x1_by_257": (5, 1024, 257, 1, None, True),
            "collisions_9x24x3_by_48_all_to_row_5": (9, 24, 48, 3, None, True),
            "dense_edge_32x3072x24_by_3072x16": (32, 3072, 3072, 24, 16, False),
            "collisions_4x2048x24_all_to_row_5": (4, 2048, 2048, 24, None, True),
            "collisions_2x4096x8_by_4096x4_all_to_row_5": (2, 4096, 4096, 8, 4, False)}.items():
        shape = (B, m) if k is None else (B, m, k)
        check(bool(kernels.scatter_plan(m * (k or 1), n, c // 4 if c % 4 == 0 else c)[0])
              == local, f"scatter_add_rows {name}: the plan's form")
        idx = indices(45 + n, n, shape, device)
        if name.startswith("collisions"):
            idx.fill_(5)
        g = cotangent(46 + n, shape + (c,), device,
                      positive=name.startswith("collisions"))
        got = kernels.scatter_add_rows(g, idx, n)
        check_rerun_bitwise(f"scatter_add_rows {name}", [got],
                            [kernels.scatter_add_rows(g, idx, n)])
        check_equal(f"scatter_add_rows {name} against the plain version on the CPU",
                    [got.cpu()], [ref.scatter_add_rows(g.cpu(), idx.cpu(), n)])
        check_list(f"scatter {name}", idx, n)
        err["scatter_add_rows"] = max(err["scatter_add_rows"], check_close(
            f"scatter_add_rows {name}", got, ref.scatter_add_rows(g, idx, n)))

    for name, (B, n, c, m, k) in {
            "level1_64x3072x64_by_1536x10": (64, 3072, 64, 1536, 10),
            "level2_64x1536x128_by_768x10": (64, 1536, 128, 768, 10),
            "level3_64x768x256_by_384x10": (64, 768, 256, 384, 10),
            "ragged_ties_3x97x6_by_41x7": (3, 97, 6, 41, 7),
            "pile_4x3072x64_by_1536x10_1000_on_row_7": (4, 3072, 64, 1536, 10),
            "chunks_1x4000x8_by_2100x10": (1, 4000, 8, 2100, 10)}.items():
        # relu'd features: half are 0, so most maxima over zeros tie
        f = torch.relu(uniform(47 + n, (B, n, c), device) - 0.5)
        idx = indices(48 + n, n, (B, m, k), device)
        idx[:, :, k - 1] = idx[:, :, 0]              # a row twice: exact ties
        if name.startswith("pile"):
            idx[:, :100] = 7                         # 1000 entries on one row
        _, slot = kernels.group_max_forward(f, idx)
        g = cotangent(49 + n, (B, m, c), device)
        got = kernels.group_max_backward(g, idx, slot, n)
        check_rerun_bitwise(f"group_max_backward {name}", [got],
                            [kernels.group_max_backward(g, idx, slot, n)])
        err["group_max_backward"] = max(err["group_max_backward"], check_close(
            f"group_max_backward {name}", got, ref.group_max_backward(g, idx, slot, n)))
        check_equal(f"group_max_backward {name} against the plain version on the CPU",
                    [got.cpu()], [ref.group_max_backward(g.cpu(), idx.cpu(), slot.cpu(), n)])
    # an index outside [0, n): NaN in row 0 where its slot names it; a slot
    # outside [0, k): NaN in row 0 of its channel
    f = torch.relu(uniform(47, (2, 50, 16), device) - 0.5)
    idx = indices(48, 50, (2, 20, 4), device)
    _, slot = kernels.group_max_forward(f, idx)
    g = cotangent(49, (2, 20, 16), device)
    idx[0, 3, 2], slot[1, 4, 7] = 50 + 5, 9
    got = kernels.group_max_backward(g, idx, slot, 50)
    check_rerun_bitwise("group_max_backward out of range", [got.view(torch.int32)],
                        [kernels.group_max_backward(g, idx, slot, 50).view(torch.int32)])
    ok_idx, ok_slot, ok_g = idx.cpu().clone(), slot.cpu().clone(), g.cpu().clone()
    named = ok_slot[0, 3] == 2                       # the channels the bad edge takes
    ok_idx[0, 3, 2] = 0
    ok_g[0, 3][named] = 0
    ok_slot[1, 4, 7], ok_g[1, 4, 7] = 0, 0
    want = ref.group_max_backward(ok_g, ok_idx, ok_slot, 50)
    want[0, 0][named] = float("nan")
    want[1, 0, 7] = float("nan")
    check_equal_nan("group_max_backward out of range against the plain version on the CPU",
                    [got.cpu()], [want])

    check_three_interpolate_backward(device, err)

    for (B, n, k, rel, mid) in ((64, 3072, 16, 4, 16), (64, 1536, 16, 8, 32),
                                (64, 768, 16, 16, 64), (64, 384, 16, 32, 128),
                                (3, 97, 8, 4, 16), (2, 333, 32, 16, 64),
                                (2, 100, 32, 32, 128), (2, 64, 16, 8, 32)):
        args = sa_inputs(60 + n, B, n, k, rel, mid, device)
        if B == 2 and n == 64:                        # every neighbour is row 3
            args[2].fill_(3)
        g = cotangent(61 + n, (B, n, mid), device)
        got = kernels.sa_attention_backward(g, *args, rel, mid, 8)
        check_rerun_bitwise(f"sa_attention_backward ({B}, {n}, k {k}, rel {rel})", got,
                            kernels.sa_attention_backward(g, *args, rel, mid, 8))
        check_list(f"sa_attention ({B}, {n}, k {k})", args[2], n)
        want = ref.sa_attention_backward(g, *args, rel, mid, 8)
        for part, gt_, wt in zip(("d_proj", "d_x1", "dW1", "dW2", "db2"), got, want):
            err["sa_attention_backward"] = max(
                err["sa_attention_backward"], check_close(
                    f"sa_attention_backward ({B}, {n}, k {k}, rel {rel}, "
                    f"mid {mid}) {part}", gt_, wt,
                    normwise=part in ("dW1", "dW2", "db2")))
    torch.cuda.synchronize()
    return err


def compare_geometry_kernels_with_plain(device):
    """Phase 3c: the ball query at ECG's uniform-loss shapes (out2: 2048
    points, 102 centres, nsample 8-24; out1: 1024 points, 51 centres, 4-12)
    plus ragged shapes, duplicates and the edge cases (a centre with no hit,
    nsample above N, min_r > 0), indices equal; the auction EMD at the val
    metric's shape on uniform clouds and in a price war (a blob of bidders
    against uniform targets, as random-weight predictions bid), both also on
    clusters of every size whose shared memory fits and run twice, at an
    iteration count
    that ends in the forced round and at n = 1000, assignments equal. Returns ({key: 0.0}, (xyz1, xyz2, eps,
    iters, bids per round)) of the full-size EMD case, whose rounds the
    timing phase's bound counts."""
    for (B, n, m, lo, nsamples) in ((32, 2048, 102, 0.0, (8, 12, 16, 20, 24)),
                                    (32, 1024, 51, 0.0, (4, 6, 8, 10, 12)),
                                    (3, 777, 41, 0.05, (1, 7, 128)),
                                    (2, 50, 9, 0.0, (64,))):
        xyz = uniform(70 + n, (B, n, 3), device)
        xyz[:, 1::7] = xyz[:, ::7][:, :xyz[:, 1::7].shape[1]]   # duplicates
        centers = xyz[:, :m].clone()
        centers[:, -1] = 5.0                                   # no hit
        for ns in nsamples:
            r = float(np.sqrt(ns / n))      # the uniform loss's sqrt(p)
            check_equal(f"ball_query ({B}, {n}, {m}, nsample {ns}, r {lo}..{r:.4f})",
                        [kernels.ball_query(lo, r, ns, xyz, centers)],
                        [ref.ball_query(lo, r, ns, xyz, centers)])

    bad = kernels.emd_sqrt_mismatches(device)
    check(bad == 0, f"emd_assignment's square root differs from __fsqrt_rn at {bad} floats")
    print("kernel == plain: emd_assignment's square root: __fsqrt_rn's bits at every "
          "float from 2^-100 to FLT_MAX")
    cases = {   # name: (B, n, eps, iters)
        "val_32x2048_eps0.004_3000": (32, 2048, 0.004, 3000),
        "forced_round_32x2048_eps0.004_20": (32, 2048, 0.004, 20),
        "n1000_4x1000_eps0.01_300": (4, 1000, 0.01, 300),
        "price_war_32x2048_eps0.004_3000": (32, 2048, 0.004, 3000),
    }
    full = None
    for name, (B, n, eps, iters) in cases.items():
        if name.startswith("price_war"):    # a blob against uniform targets
            a, b = probe_emd_chamfer.price_war_clouds(device, B, n, 90)
        else:
            a, b = uniform(80 + n, (B, n, 3), device), uniform(81 + n, (B, n, 3), device)
        bids = []
        got = kernels.emd_assignment(a, b, eps, iters)
        want = ref.emd_assignment(a, b, eps, iters, bids)
        check_equal(f"emd_assignment {name} ({len(bids)} rounds, {sum(bids)} "
                    f"bidder-rounds, the last {bids[-1]} bidders)", [got], [want])
        if name.startswith("forced"):
            check(len(bids) == iters and bids[-1] > 0,
                  f"emd {name}: no forced round ({len(bids)} rounds, {bids[-1:]})")
        if name.startswith(("val", "price_war")):
            check_rerun_bitwise(f"emd_assignment {name}", [got],
                                [kernels.emd_assignment(a, b, eps, iters)])
            for C in range(1, kernels.EMD_MAX_CLUSTER + 1):   # every size that fits
                if kernels.emd_shared_bytes(n, C) <= kernels.EMD_SMEM:
                    check_equal(f"emd_assignment {name} on clusters of {C}",
                                [kernels._emd_launch(a, b, eps, iters, C)], [want])
        if full is None:
            full = (a, b, eps, iters, bids)
    torch.cuda.synchronize()
    return {"ball_query": 0.0, "emd": 0.0}, full


def print_emd_plan(device, card):
    """The auction's launch plan at the val batch (32, 2048): C CTAs a cloud,
    lanes a bidder, the clusters resident, and the cost of a cluster
    barrier (CUDA events over 20000 of them) and of a round's barriers."""
    plan = probe_emd_chamfer.emd_plan(device, 32, 2048)
    print(f"emd plan (32, 2048): C {plan['C']} CTAs a cloud, {plan['targets_a_cta']} "
          f"targets a CTA, {plan['shared_bytes']} bytes of shared memory, lanes a "
          f"bidder {plan['lanes_a_bidder']}; clusters resident by C "
          f"{plan['resident_clusters']}; a cluster barrier by C {plan['barrier_ms']} ms, "
          f"{plan['barriers_a_round']} a round: {plan['barrier_ms_a_round']!r} ms a round "
          f"on {card}")
    return plan


def check_bf16_sums(name, got, want):
    """Two bf16 roundings of fp32 sums over every pair taken in different
    orders (the similarity backward's dwxyz, dW2 and dW3, which
    ``ref.sim_mlp_backward`` rounds as JAX's CPU autodiff does): each
    element equal, or one bf16 ulp apart where the two sums fall on either
    side of a rounding boundary, in at most SIM_BF16_FLIPS of the elements
    (the rule of ``tests/test_torch_cuda.py::
    test_sim_mlp_backward_ragged_tiles_match_plain_and_rerun_bitwise``), and
    the whole normwise within SIM_BF16_NORM. Prints the flips; returns max
    |kernel - plain|."""
    check(got.shape == want.shape and got.dtype == want.dtype,
          f"{name}: {got.shape}/{got.dtype} vs {want.shape}/{want.dtype}")
    diff = (got.double() - want.double()).abs()
    flips = int((diff > 0).sum())
    far = int((diff > want.double().abs() * 2.0 ** -7).sum())
    norm = float(want.double().norm())
    rel = float(diff.norm()) / norm if norm > 0 else float(diff.max())
    print(f"kernel ~ plain: {name}: {flips} of {got.numel()} one bf16 ulp apart, the rest "
          f"equal; normwise {rel!r} (bar {SIM_BF16_NORM}), max |diff| {float(diff.max())!r}")
    check(far == 0, f"{name}: {far} elements more than one bf16 ulp apart")
    check(flips <= max(1, SIM_BF16_FLIPS * got.numel()),
          f"{name}: {flips} elements one ulp apart")
    check(rel <= SIM_BF16_NORM, f"{name}: normwise {rel!r} > {SIM_BF16_NORM}")
    return float(diff.max())


def check_normwise(name, got, want, bar):
    """|got - want| / |want| <= bar over the whole tensor; returns the
    largest absolute difference."""
    check(got.shape == want.shape and got.dtype == want.dtype,
          f"{name}: {got.shape}/{got.dtype} vs {want.shape}/{want.dtype}")
    g, w = got.double(), want.double()
    gap, norm = float((g - w).norm()), float(w.norm())
    # a plain value of exactly zero (a one-pair batch's BatchNorm) asks for 0
    rel = gap / norm if norm > 0 else (0.0 if gap == 0 else float("inf"))
    max_abs = float((g - w).abs().max())
    check(rel <= bar, f"{name}: normwise {rel!r} above {bar}")
    print(f"kernel ~ plain: {name}: normwise {rel!r} (bar {bar}), max |diff| "
          f"{max_abs!r}")
    return max_abs


def dcp_attention_inputs(seed, B, N, M, H, device):
    """bf16 q/k/v (B, N|M, H, 128) as DCP's heads lie: views of fused
    projection rows (B, N, 3 H 128), unit normal."""
    g = torch.Generator(device=device).manual_seed(seed)
    d = H * 128
    y = torch.randn(B, N, 3 * d, device=device, generator=g).to(torch.bfloat16)
    ym = torch.randn(B, M, 3 * d, device=device, generator=g).to(torch.bfloat16)
    return (y[..., :d].reshape(B, N, H, 128), ym[..., d:2 * d].reshape(B, M, H, 128),
            ym[..., 2 * d:].reshape(B, M, H, 128))


def dcp_edge_inputs(seed, B, N, K, device):
    """The edge chain's inputs: a1 [x_j | x_i] bf16 of uniform clouds and
    their kNN, weights at torch's init scale, BatchNorm parameters and
    running statistics near their initial values."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.rand(B, N, 3, device=device, generator=g)
    nb = ref.gather_points(x, ref.knn_indices(x, K))
    a1 = torch.cat([nb, x[:, :, None].expand_as(nb)], -1).to(torch.bfloat16)
    chs, cins = (64, 64, 128, 256), (6, 64, 64, 128)
    Ws = [(torch.rand(ci, c, device=device, generator=g) * 2 - 1) * ci ** -0.5
          for ci, c in zip(cins, chs)]
    params = [[1 + 0.1 * torch.randn(c, device=device, generator=g) for c in chs],
              [0.1 * torch.randn(c, device=device, generator=g) for c in chs],
              [0.1 * torch.randn(c, device=device, generator=g) for c in chs],
              [0.5 + torch.rand(c, device=device, generator=g) for c in chs]]
    return a1, Ws, params


def check_row_stats(name, m, l, q, k, scale):
    """An attention forward's row max and row sum against a plain
    recomputation from q and k in fp32, within SA_ATOL + SA_RTOL |plain|:
    (B, Nq, D) inputs give (B, Nq) stats, (B, N, H, D) heads (B, H, Nq)."""
    if q.dim() == 4:
        q, k = q.transpose(1, 2), k.transpose(1, 2)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    want_m = s.amax(-1)
    check_close(f"{name} row max", m, want_m)
    check_close(f"{name} row sum", l, torch.exp(s - want_m[..., None]).sum(-1))


def compare_dcp_kernels_with_plain(device):
    """Phase 3d: DCP's three kernels at its path's shapes (B 32, N = M =
    2048: the transformer's (32, 2048, 4, 128) bf16 heads, the svd head's
    (32, 2048, 512) fp32 embeddings with the 3-wide target cloud, the edge
    chain's (32, 2048, 20, 6) edges) plus ragged ones, the attention
    forwards' cutting a 128-query and a 128-key tile, the chain's a round of
    16 points and its k slots, their row max and row sum held against a
    plain recomputation there, and two runs of each forward bitwise equal.
    Returns {key: max |kernel - plain|}."""
    err = {"attention": 0.0, "attention_bnhd": 0.0, "edge_mlp": 0.0}
    for (B, N, M, H) in ((32, 2048, 2048, 4), (2, 1000, 777, 3), (1, 129, 65, 1),
                         (1, 5, 3, 1)):
        q, k, v = dcp_attention_inputs(100 + N, B, N, M, H, device)
        name = f"attention_bnhd ({B}, {N} x {M}, H {H}, dk 128) bf16"
        got = kernels.attention_bnhd_forward(q, k, v, 128 ** -0.5, stats=True)
        err["attention_bnhd"] = max(err["attention_bnhd"], check_normwise(
            name, got[0], ref.attention_bnhd(q, k, v, 128 ** -0.5), ATTN_BF16_NORM))
        if B < 32:
            check_row_stats(name, *got[1:], q, k, 128 ** -0.5)
        check_rerun_bitwise(name, got,
                            kernels.attention_bnhd_forward(q, k, v, 128 ** -0.5, stats=True))
        del q, k, v, got
    for (B, N, M, D) in ((32, 2048, 2048, 512), (3, 1000, 777, 512), (1, 129, 65, 512),
                         (1, 5, 3, 64)):
        g = torch.Generator(device=device).manual_seed(200 + N)
        q = torch.randn(B, N, D, device=device, generator=g)
        k = torch.randn(B, M, D, device=device, generator=g)
        v = torch.rand(B, M, 3, device=device, generator=g)
        name = f"attention ({B}, {N} x {M}, D {D}, Dv 3) fp32"
        got = kernels.attention_forward(q, k, v, D ** -0.5, stats=True)
        err["attention"] = max(err["attention"], check_close(
            name, got[0], ref.attention(q, k, v, D ** -0.5)))
        if B < 32:
            check_row_stats(name, *got[1:], q, k, D ** -0.5)
        check_rerun_bitwise(name, got, kernels.attention_forward(q, k, v, D ** -0.5,
                                                                 stats=True))
        del q, k, v, got
    for (B, N, K) in ((32, 2048, 20), (3, 1001, 7), (2, 37, 20), (2, 5, 1)):
        a1, Ws, params = dcp_edge_inputs(300 + N, B, N, K, device)
        got = kernels.edge_mlp_forward(a1, Ws, *params)
        for i, (gl, wl) in enumerate(zip(got, ref.edge_mlp_eval(a1, Ws, *params))):
            err["edge_mlp"] = max(err["edge_mlp"], check_normwise(
                f"edge_mlp ({B}, {N}, k {K}) layer {i}", gl, wl, EDGE_MLP_NORM))
        check_rerun_bitwise(f"edge_mlp ({B}, {N}, k {K})", got,
                            kernels.edge_mlp_forward(a1, Ws, *params))
    torch.cuda.synchronize()
    return err


def _attention_stats_inputs(seed, B, N, M, device, bnhd):
    """Inputs of one attention backward: q, k, v, the kernel forward's
    output and row stats, and a unit-normal cotangent of the output."""
    if bnhd:
        q, k, v = dcp_attention_inputs(seed, B, N, M, 4 if B == 32 else 3, device)
        o, m, l = kernels.attention_bnhd_forward(q, k, v, 128 ** -0.5, stats=True)
        scale = 128 ** -0.5
    else:
        g = torch.Generator(device=device).manual_seed(seed)
        q = torch.randn(B, N, 512, device=device, generator=g)
        k = torch.randn(B, M, 512, device=device, generator=g)
        v = torch.rand(B, M, 3, device=device, generator=g)
        scale = 512 ** -0.5
        o, m, l = kernels.attention_forward(q, k, v, scale, stats=True)
    g = torch.Generator(device=device).manual_seed(seed + 1)
    d_out = torch.randn(o.shape, device=device, generator=g).to(o.dtype)
    return q, k, v, o, m, l, d_out, scale


def edge_train_inputs(seed, B, N, K, device):
    """dcp_edge_inputs without the running statistics, and unit-normal
    cotangents of the four max-pools."""
    a1, Ws, params = dcp_edge_inputs(seed, B, N, K, device)
    g = torch.Generator(device=device).manual_seed(seed + 1)
    gxs = [torch.randn(B, N, c, device=device, generator=g)
           for c in kernels.EDGE_MLP_CHANNELS[1:]]
    return a1, Ws, params[0], params[1], gxs


def check_rerun_bitwise(name, first, second):
    """Two runs of a kernel on the same inputs give bitwise-equal outputs."""
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(first, second))
    check(same, f"{name}: two runs differ")
    print(f"kernel run twice: {name}: bitwise equal")


def _ptxas_resources(pattern):
    """{the groups of ``pattern``: {"regs", "spill"}} of every kernel whose
    mangled name matches it, from ptxas's lines in the build log."""
    entry, seen = "", {}
    for ln in kernels.BUILD_LOG.splitlines():
        if "Compiling entry" in ln:
            entry = ln
            continue
        found = re.search(pattern, entry)
        if found is None:
            continue
        rec = seen.setdefault(found.groups(), {})
        if "spill stores" in ln:
            rec["spill"] = re.search(r"(\d+) bytes spill stores", ln).group(1)
        if "Used" in ln:
            rec["regs"] = re.search(r"Used (\d+) registers", ln).group(1)
    return seen


def print_backward_resources():
    """One line a pass of the two redesigned training backwards
    (``edge_mlp_backward_kernel<level>``, ``sim_mlp_backward_kernel<pass>``):
    registers and spilled bytes from ptxas, dynamic shared memory a block
    from the library."""
    lib = kernels.load()
    seen = _ptxas_resources(r"(edge_mlp_backward_kernel|sim_mlp_backward_kernel)ILi(n?)(\d+)EE")
    for (name, neg, num), rec in sorted(seen.items()):
        arg = int(num) * (-1 if neg else 1)
        smem = (lib.edge_mlp_backward_smem(arg) if name.startswith("edge")
                else lib.sim_mlp_backward_smem())
        print(f"resources: {name}<{arg}>: {rec.get('regs')} registers, {rec.get('spill')} "
              f"bytes spill stores, {smem} bytes dynamic shared memory a block")


def print_propagate_resources(k=12):
    """One line each of gnn_propagate.cu's redesigned kernels (the final pass
    with and without slots, the backward's pass 1 and gather): registers and
    spilled bytes from ptxas; pass 1's dynamic shared memory a block at k
    (W^T, and a tile of 16 points' cotangents, slots, C sorted routes, k
    rows of bf16 dx1 and k x1 rows of 2 C + 16 bytes: ``Pass1Smem`` in the
    source)."""
    seen = _ptxas_resources(
        r"(gnn_propagate_(?:backward_|gather_)?kernel)ILi(\d+)E(?:Lb(\d)E)?")
    for (name, C, slots), rec in sorted(seen.items(), key=str):
        C = int(C)
        smem = (4 * (C * C + 16 * C) + 8 * 16 * C + 16 * k * (2 * C + 2 * C + 16) + 16 * C
                if name == "gnn_propagate_backward_kernel" else 0)
        print(f"resources: {name}<{C}{'' if slots is None else ', slots ' + slots}>: "
              f"{rec.get('regs')} registers, {rec.get('spill')} bytes spill stores, "
              f"{smem} bytes dynamic shared memory a block (k {k})")


def compare_dcp_train_kernels_with_plain(device):
    """Phase 3e: the backward kernels of DCP's attentions and the edge
    chain's train passes at a train step's shapes (the transformer's (32,
    2048, 4, 128) bf16 heads, the svd head's (32, 2048, 512) fp32
    embeddings, the chain's (32, 2048, 20, 6) edges) plus ragged ones (the
    attention backwards at (2|3, 1000 x 777) and (1, 129 x 65), cutting a
    tile; the chain's passes at B N k edges no multiple of its 64-edge
    tile, k 20, 7 and 1, down to 10 edges), against
    ``ref.attention_backward``, ``ref.edge_mlp_backward``, the stat passes
    against ``ref.edge_mlp_stats_given`` (the layers below folded with the
    kernel's statistics) and, at the two larger shapes, the plain train
    forward and autograd of it; and two runs
    of the attention backwards and of the chain's stat, train final and
    backward passes bitwise equal. Returns {key: max |kernel - plain|}."""
    err = dict.fromkeys(("attention_bnhd_backward", "attention_backward",
                         "edge_mlp_stat", "edge_mlp_backward"), 0.0)
    for (B, N, M) in ((32, 2048, 2048), (2, 1000, 777), (1, 129, 65)):
        *x, d_out, scale = _attention_stats_inputs(500 + N, B, N, M, device, True)
        got = kernels.attention_bnhd_backward(*x, d_out, scale)
        for name, g, w in zip(("dq", "dk", "dv"), got,
                              ref.attention_backward(*x, d_out, scale)):
            err["attention_bnhd_backward"] = max(err["attention_bnhd_backward"],
                                                 check_normwise(
                f"attention_bnhd_backward {name} ({B}, {N} x {M}) bf16", g, w,
                ATTN_BF16_BWD_NORM))
        check_rerun_bitwise(f"attention_bnhd_backward ({B}, {N} x {M}) bf16", got,
                            kernels.attention_bnhd_backward(*x, d_out, scale))
        del x, got
    for (B, N, M) in ((32, 2048, 2048), (3, 1000, 777), (1, 129, 65)):
        *x, d_out, scale = _attention_stats_inputs(600 + N, B, N, M, device, False)
        got = kernels.attention_backward(*x, d_out, scale)
        for name, g, w in zip(("dq", "dk", "dv"), got,
                              ref.attention_backward(*x, d_out, scale)):
            err["attention_backward"] = max(err["attention_backward"], check_close(
                f"attention_backward {name} ({B}, {N} x {M}, D 512, Dv 3) fp32", g, w))
        check_rerun_bitwise(f"attention_backward ({B}, {N} x {M}, D 512, Dv 3) fp32",
                            got, kernels.attention_backward(*x, d_out, scale))
        del x, got
    for (B, N, K) in ((32, 2048, 20), (3, 1001, 7), (2, 37, 20), (1, 21, 20), (2, 5, 1)):
        a1, Ws, gammas, betas, gxs = edge_train_inputs(700 + N, B, N, K, device)
        xs, stats, slots = kernels.edge_mlp_train_forward(a1, Ws, gammas, betas)
        leaves = [x.clone().requires_grad_() for x in (a1, *Ws, *gammas, *betas)]
        want_xs, want_stats = ref.edge_mlp_train(leaves[0], leaves[1:5], leaves[5:9],
                                                 leaves[9:])
        main = (B, N) in ((32, 2048), (3, 1001))
        for i, (g, w) in enumerate(zip(xs, want_xs) if main else ()):
            check_normwise(f"edge_mlp train ({B}, {N}, k {K}) layer {i}", g, w.detach(),
                           EDGE_TRAIN_NORM)
        for i, (g, w) in enumerate(zip(stats, want_stats) if main else ()):
            err["edge_mlp_stat"] = max(err["edge_mlp_stat"], check_normwise(
                f"edge_mlp_stat ({B}, {N}, k {K}) layer {i}", g, w, EDGE_STAT_NORM))
        for i, (g, w) in enumerate(zip(stats, ref.edge_mlp_stats_given(a1, Ws, gammas, betas,
                                                                       stats))):
            err["edge_mlp_stat"] = max(err["edge_mlp_stat"], check_normwise(
                f"edge_mlp_stat ({B}, {N}, k {K}) layer {i}, the layers below given the "
                "kernel's statistics", g, w, EDGE_STAT_NORM))
        d_a1, dWs, dgs, dbs = kernels.edge_mlp_train_backward(
            a1, Ws, gammas, betas, stats, slots, gxs, need_a1=True)
        names = ["d_a1"] + [f"{n}{i}" for n in ("dW", "dgamma", "dbeta") for i in range(4)]
        got = (d_a1, *dWs, *dgs, *dbs)
        # against the plain backward that rounds where the kernel does, at
        # every shape; against autodiff of the plain forward, which rounds
        # elsewhere (a gap that grows as the edges grow fewer), at the
        # path's shape and one of DCP's k with a ragged last tile
        d, *rest = ref.edge_mlp_backward(a1, Ws, gammas, betas, stats, slots, gxs)
        for name, g, w in zip(names, got, (d, *[x for grp in rest for x in grp])):
            err["edge_mlp_backward"] = max(err["edge_mlp_backward"], check_normwise(
                f"edge_mlp_backward {name} ({B}, {N}, k {K}) against ref.edge_mlp_backward",
                g.float(), w.float(), EDGE_GRAD_NORM))
        if main:
            want = torch.autograd.grad(want_xs, leaves, gxs)
            for name, g, w in zip(names, got, want):
                err["edge_mlp_backward"] = max(err["edge_mlp_backward"], check_normwise(
                    f"edge_mlp_backward {name} ({B}, {N}, k {K})", g.float(), w.float(),
                    EDGE_GRAD_NORM))
            del want
        again = kernels.edge_mlp_train_forward(a1, Ws, gammas, betas)
        check_rerun_bitwise(f"edge_mlp_stat and the train final pass ({B}, {N}, k {K}): "
                            "the four statistics, the max-pools and the slots",
                            (*stats, *xs, slots), (*again[1], *again[0], again[2]))
        del again
        check_rerun_bitwise(
            f"edge_mlp_backward ({B}, {N}, k {K}), five passes", got,
            [x for grp in kernels.edge_mlp_train_backward(
                a1, Ws, gammas, betas, stats, slots, gxs, need_a1=True)
             for x in (grp if isinstance(grp, tuple) else (grp,))])
        del leaves, want_xs, d, rest
    torch.cuda.synchronize()
    return err


def idam_propagate_inputs(seed, B, N, k, C, device, dup=False):
    """The Propagate edge block's inputs: a unit-normal projection p, the
    self-kNN of a uniform cloud (``dup``: the second half of each row's
    neighbours repeats the first, so the max over them ties), W and b at
    torch's init scale, BatchNorm parameters and running statistics near
    their initial values."""
    g = torch.Generator(device=device).manual_seed(seed)
    idx = ref.knn_indices(torch.rand(B, N, 3, device=device, generator=g), k)
    if dup:
        idx[:, :, k - k // 2:] = idx[:, :, :k // 2]
    p = torch.randn(B, N, C, device=device, generator=g)
    u = lambda *s: (torch.rand(*s, device=device, generator=g) * 2 - 1) * C ** -0.5
    vec = lambda sd, mu: mu + sd * torch.randn(C, device=device, generator=g)
    return (p, idx, u(C, C), u(C), vec(0.1, 1.0), vec(0.1, 0.0), vec(0.1, 0.0),
            0.5 + torch.rand(C, device=device, generator=g))


def idam_sim_inputs(seed, B, M, device, emb=64, ties=False):
    """The similarity kernel's inputs (``ref.sim_mlp_core``'s arguments):
    the projections of unit-normal embeddings, uniform positions (``ties``:
    the second quarter of the targets repeats the first, embeddings too, so
    the max over j ties), weights at torch's init scale, BatchNorm
    parameters and running statistics near their initial values."""
    C = kernels.SIM_MLP_C
    g = torch.Generator(device=device).manual_seed(seed)
    src, tgt = (torch.rand(B, M, 3, device=device, generator=g) for _ in range(2))
    semb, temb = (torch.randn(B, M, emb, device=device, generator=g) for _ in range(2))
    if ties:
        h = M // 4
        tgt[:, h:2 * h], temb[:, h:2 * h] = tgt[:, :h], temb[:, :h]
    u = lambda *s: (torch.rand(*s, device=device, generator=g) * 2 - 1) * s[0] ** -0.5
    vec = lambda sd, mu: mu + sd * torch.randn(C, device=device, generator=g)
    Wcat = u(2 * emb + 4, C)
    sp, tp = ref.sim_projections(semb, temb, Wcat)
    return (sp, tp, src, tgt, *ref.sim_mlp_split(Wcat, emb), u(C, C),
            u(C), u(C, C), u(C, 1), vec(0.1, 1.0), vec(0.1, 0.0),
            vec(0.1, 1.0), vec(0.1, 0.0), vec(0.1, 0.0),
            0.5 + torch.rand(C, device=device, generator=g), vec(0.1, 0.0),
            0.5 + torch.rand(C, device=device, generator=g))


def check_propagate_final(name, got, cand, slot=None):
    """The edge block's final pass against the plain version's candidates
    ``cand`` (B, N, k, C) (``ref.gnn_propagate_candidates``): every output
    within GNN_FINAL_ATOL + GNN_FINAL_RTOL |plain| of the plain max; where
    ``slot`` is given, each slot the plain version's first maximal one
    except where its two largest candidates lie within the sum of their
    bars (each candidate within its bar of the kernel's). Prints the largest
    gap and the flips; returns (max |kernel - plain|, flips)."""
    want, want_slot = ref._first_max(cand, 2)
    diff = (got.double() - want.double()).abs()
    tol = GNN_FINAL_ATOL + GNN_FINAL_RTOL * want.double().abs()
    over = int((diff > tol).sum())
    max_abs = float(diff.max())
    rel = float((diff / want.double().abs().clamp(min=1e-3)).max())
    flips = 0
    if slot is not None:
        flipped = slot.long() != want_slot
        flips = int(flipped.sum())
        if cand.shape[2] > 1:
            top = cand.topk(2, dim=2).values.double()
            first, second = top[:, :, 0], top[:, :, 1]
            room = 2 * GNN_FINAL_ATOL + GNN_FINAL_RTOL * (first.abs() + second.abs())
            far = int((flipped & (first - second > room)).sum())
        else:
            far = flips
        check(far == 0, f"{name}: {far} slots differ where the plain version's two "
              "largest candidates lie apart by more than the bar")
    print(f"kernel ~ plain: {name}: max |diff| {max_abs!r}, max |diff| / max(|plain|, "
          f"1e-3) {rel!r}, {over} of {got.numel()} outside {GNN_FINAL_ATOL} + "
          f"{GNN_FINAL_RTOL} |plain|" + (f"; {flips} slots flipped, each at a near tie"
                                          if slot is not None else ""))
    check(over == 0, f"{name}: {over} outputs outside the bar")
    return max_abs, flips


def check_sim_final(name, got, want, h1=None):
    """The similarity MLP's final pass, got (simr, wmax[, argj]), against the
    plain version's ``want`` (``ref.sim_mlp_core``, ``ref.sim_mlp_slots``):
    simr and wmax within SIM_FINAL_ATOL + SIM_FINAL_RTOL |plain|, and
    bf16(wmax) equal (the kernel makes every bf16 rounding of h1 the plain
    version's, and bf16 is monotone, so the rounded maxima agree); where
    the plain version's candidates ``h1`` (B, M, M, C) (``ref.sim_h1``) are
    given, each saved j the plain version's first maximal one except where
    the plain candidate at the kernel's j lies within the sum of the two
    bars of the plain max. Prints the largest gaps and the flips; returns
    max |kernel - plain|."""
    worst = 0.0
    for what, g, w in zip(("simr", "wmax"), got[:2], want[:2]):
        diff = (g.double() - w.double()).abs()
        over = int((diff > SIM_FINAL_ATOL + SIM_FINAL_RTOL * w.double().abs()).sum())
        rel = float((diff / w.double().abs().clamp(min=1e-3)).max())
        worst = max(worst, float(diff.max()))
        print(f"kernel ~ plain: {name} {what}: max |diff| {float(diff.max())!r}, max |diff| / "
              f"max(|plain|, 1e-3) {rel!r}, {over} of {g.numel()} outside "
              f"{SIM_FINAL_ATOL} + {SIM_FINAL_RTOL} |plain|")
        check(over == 0, f"{name} {what}: {over} outputs outside the bar")
    check(torch.equal(got[1].to(torch.bfloat16), want[1].to(torch.bfloat16)),
          f"{name}: bf16(wmax) differs from the plain version's")
    if h1 is not None:
        flipped = got[2] != want[2]
        first = h1.amax(dim=2).double()
        mine = h1.gather(2, got[2].long().clamp(0, h1.shape[2] - 1)[:, :, None]
                         ).squeeze(2).double()
        room = 2 * SIM_FINAL_ATOL + SIM_FINAL_RTOL * (first.abs() + mine.abs())
        flips = int(flipped.sum())
        far = int((flipped & ((first - mine > room) | (got[2] < 0)
                              | (got[2] >= h1.shape[2]))).sum())
        print(f"kernel ~ plain: {name} argj: {flips} of {got[2].numel()} differ, each at a "
              f"near tie")
        check(far == 0, f"{name}: {far} saved j differ where the plain candidate there lies "
              "below the plain max by more than the bar")
    return worst


def compare_idam_kernels_with_plain(device):
    """Phase 3f: IDAM's two kernels at its path's shapes (the edge block's
    (32, 2048, k 12, C 64); the similarity MLP's (32, 341, emb 64, C 32))
    plus ragged ones (N 1001 and 37, C 32, k 5; M 37 and 1) and ties
    (repeated neighbours; repeated target points), against ``ref`` on the
    card: the edge block within its bar (``check_propagate_final``), the
    similarity MLP within its (``check_sim_final``); each run twice,
    bitwise equal.
    Returns {key: max |kernel - plain|}."""
    err = {"gnn_propagate": 0.0, "sim_mlp": 0.0}
    for (B, N, k, C, dup) in ((32, 2048, 12, 64, False), (3, 1001, 12, 32, False),
                              (2, 37, 5, 64, False), (2, 300, 12, 64, True)):
        what = f"({B}, {N}, k {k}, C {C}{', ties' if dup else ''})"
        x = idam_propagate_inputs(1000 + N, B, N, k, C, device, dup)
        got = kernels.gnn_propagate_forward(*x)
        err["gnn_propagate"] = max(err["gnn_propagate"], check_propagate_final(
            f"gnn_propagate {what}", got, ref.gnn_propagate_candidates(*x))[0])
        check_rerun_bitwise(f"gnn_propagate {what}", [got],
                            [kernels.gnn_propagate_forward(*x)])
    for (B, M, ties) in ((32, 341, False), (3, 37, False), (2, 64, True), (1, 1, False)):
        x = idam_sim_inputs(2000 + M, B, M, device, ties=ties)
        what = f"sim_mlp ({B}, {M}, C 32{', ties' if ties else ''})"
        got = kernels.sim_mlp_forward(*x)
        err["sim_mlp"] = max(err["sim_mlp"], check_sim_final(what, got, ref.sim_mlp_core(*x)))
        check_rerun_bitwise(what, got, kernels.sim_mlp_forward(*x))
    torch.cuda.synchronize()
    return err


def compare_idam_train_kernels_with_plain(device):
    """Phase 3g: IDAM's train kernels at its train step's shapes (the edge
    block's (32, 2048, k 12, C 64), the similarity MLP's (32, 341, C 32))
    plus ragged ones (N 1001 C 32, N 37 k 5; M 37 and 1) and ties (repeated
    neighbours; repeated target points), against ``ref`` on the card: the
    stat passes normwise (IDAM_STAT_NORM), the edge block's also bitwise
    against the plain version in its order
    (``ref.gnn_propagate_stats_ordered``); the train final passes given the
    kernels' statistics within their bars and their slots by the slot rule
    (``check_propagate_final``, ``check_sim_final``, flips counted); the
    graph's reverse list bitwise ``ref.reverse_list``'s; the
    backward passes against ``ref.*_backward`` given the same statistics
    and the kernels' own slots normwise (IDAM_GRAD_NORM), the edge block's
    with the shared list and with one it builds itself; two runs of the
    stat, final and backward passes and of the list bitwise equal. Returns
    {key: max |kernel - plain|}."""
    err = dict.fromkeys(("gnn_propagate_stat", "gnn_propagate_backward",
                         "gnn_propagate_list", "sim_mlp", "sim_mlp_stat",
                         "sim_mlp_backward"), 0.0)
    for (B, N, k, C, dup) in ((32, 2048, 12, 64, False), (3, 1001, 12, 32, False),
                              (2, 37, 5, 64, False), (2, 300, 12, 64, True)):
        what = f"({B}, {N}, k {k}, C {C}{', ties' if dup else ''})"
        p, idx, W, b, gamma, beta, _, _ = idam_propagate_inputs(3000 + N, B, N, k, C,
                                                                device, dup)
        dx = torch.randn(p.shape, device=device,
                         generator=torch.Generator(device=device).manual_seed(N))
        x, stats, slot = kernels.gnn_propagate_train_forward(p, idx, W, b, gamma, beta)
        err["gnn_propagate_stat"] = max(err["gnn_propagate_stat"], check_normwise(
            f"gnn_propagate_stat {what}", stats, ref.gnn_propagate_stats(p, idx),
            IDAM_STAT_NORM))
        blocks = kernels._max_blocks(device)
        check_equal(f"gnn_propagate_stat {what}: its partials and statistics against the "
                    f"plain version in its order (ref.gnn_propagate_stats_ordered, {blocks} "
                    "blocks)", (kernels.gnn_propagate_stat_partials(p, idx), stats),
                    (ref.gnn_propagate_partials_ordered(p, idx, blocks),
                     ref.gnn_propagate_stats_ordered(p, idx, blocks)))
        check_propagate_final(f"gnn_propagate train final pass {what}", x,
                              ref.gnn_propagate_candidates(p, idx, W, b, gamma, beta,
                                                           stats[0], stats[1]), slot)
        lst = kernels.gnn_propagate_list(idx, N)
        check_equal(f"gnn_propagate_list {what}", lst, ref.reverse_list(idx, N))
        got = kernels.gnn_propagate_train_backward(p, idx, W, gamma, beta, stats, slot, dx,
                                                   lst=lst)
        want = ref.gnn_propagate_backward(p, idx, W, gamma, beta, stats, slot, dx)
        for name, g, w in zip(("d_p", "dW", "db", "dgamma", "dbeta"), got, want):
            err["gnn_propagate_backward"] = max(err["gnn_propagate_backward"], check_normwise(
                f"gnn_propagate_backward {name} {what}", g, w, IDAM_GRAD_NORM))
        again = (kernels.gnn_propagate_batch_stats(p, idx),
                 *kernels.gnn_propagate_train_forward(p, idx, W, b, gamma, beta),
                 *kernels.gnn_propagate_list(idx, N),
                 *kernels.gnn_propagate_train_backward(p, idx, W, gamma, beta, stats, slot,
                                                       dx))
        check_rerun_bitwise(f"gnn_propagate {what}: the stat pass, the train final pass "
                            "(x, stats, slots), the list and the backward (its own list)",
                            (stats, x, stats, slot, *lst, *got), again)
        del got, want, again
    for (B, M, ties) in ((32, 341, False), (3, 37, False), (2, 64, True), (1, 1, False)):
        what = f"({B}, {M}, C 32{', ties' if ties else ''})"
        x = idam_sim_inputs(4000 + M, B, M, device, ties=ties)[:14]
        g = torch.Generator(device=device).manual_seed(M)
        dsimr = torch.randn((B, M, M), device=device, generator=g)
        dwmax = torch.randn((B, M, kernels.SIM_MLP_C), device=device, generator=g)
        simr, wmax, st1, st2, argj = kernels.sim_mlp_train_forward(*x)
        for name, gs, ws in zip(("st1", "st2"), (st1, st2),
                                ref.sim_mlp_batch_stats(*x[:9], *x[10:12])):
            err["sim_mlp_stat"] = max(err["sim_mlp_stat"], check_normwise(
                f"sim_mlp_stat {name} {what}", gs, ws, IDAM_STAT_NORM))
        err["sim_mlp"] = max(err["sim_mlp"], check_sim_final(
            f"sim_mlp train final pass {what}", (simr, wmax, argj),
            ref.sim_mlp_slots(*x, st1, st2), ref.sim_h1(*x[:8], *x[10:12], st1)))
        check_rerun_bitwise(f"sim_mlp train forward {what}: the two stat passes and the "
                            "final pass (simr, wmax, st1, st2, argj)",
                            (simr, wmax, st1, st2, argj), kernels.sim_mlp_train_forward(*x))
        got = kernels.sim_mlp_train_backward(*x, st1, st2, argj, dsimr, dwmax)
        want = ref.sim_mlp_backward(*x, st1, st2, argj, dsimr, dwmax)
        names = ("dsp", "dtp", "dw0", "dwxyz", "dW2", "db2", "dW3", "dW4", "dg1", "dbe1",
                 "dg2", "dbe2")
        for name, gg, ww in zip(names, got, want):
            check_one = check_bf16_sums if name in SIM_BF16_GRADS else (
                lambda n, a, b: check_normwise(n, a, b, IDAM_GRAD_NORM))
            err["sim_mlp_backward"] = max(err["sim_mlp_backward"], check_one(
                f"sim_mlp_backward {name} {what}", gg, ww))
        check_rerun_bitwise(f"sim_mlp_stat {what}", (st1, st2),
                            kernels.sim_mlp_batch_stats(*x))
        check_rerun_bitwise(f"sim_mlp_backward {what}, three passes", got,
                            kernels.sim_mlp_train_backward(*x, st1, st2, argj, dsimr, dwmax))
        del got, want
    torch.cuda.synchronize()
    return err


def _idam_on(cfg, device, batch, kept=None):
    """IDAM's val outputs, T_12, embeddings (tgt, src) and selections on
    ``device``, on the host: the kept points (src_idx, tgt_idx) and each
    iteration's correspondences as indices of the whole target cloud
    (tgt_idx[corr_idx]). ``kept``: src_idx and tgt_idx to use instead of the
    model's own top-k."""
    from mvp_benchmark_tpu_torch.models import idam

    model = engine.build_model(cfg, device)
    step = engine.make_registration_eval_step(model, device)
    taken, take, top_k = [], idam._batch_take, idam._top_k_indices
    forced = list(kept or [])
    idam._batch_take = lambda x, i: (taken.append(i.cpu()), take(x, i))[1]
    if kept is not None:
        idam._top_k_indices = lambda score, k: forced.pop(0).to(score.device)
    try:
        val = [o.cpu() for o in step(batch, "val")]
        forced = list(kept or [])
        T = step(batch, "test").cpu()
    finally:
        idam._batch_take, idam._top_k_indices = take, top_k
    with torch.inference_mode():
        embs = [model.gnn(torch.from_numpy(batch[k]).to(device)).cpu()
                for k in ("tgt", "src")]
    src_idx, tgt_idx = taken[0], taken[2]
    corr = [torch.gather(tgt_idx, 1, c) for c in taken[4:4 + int(cfg.num_iters)]]
    return val, T, embs, [src_idx, tgt_idx], corr


def _corr_flips(got_kept, got_corr, want_kept, want_corr, b):
    """Correspondences that differ per iteration, over the source points
    both runs kept, by the target point (of the whole cloud) each picks."""
    g = {int(s): i for i, s in enumerate(got_kept[0][b])}
    w = {int(s): i for i, s in enumerate(want_kept[0][b])}
    common = sorted(set(g) & set(w))
    return [sum(int(gc[b, g[s]] != wc[b, w[s]]) for s in common)
            for gc, wc in zip(got_corr, want_corr)]


def check_idam_batch_on_cpu(cfg, device, first, clouds_cut=2):
    """One full-width val batch cut to two pairs, on the card and on the
    CPU (plain versions throughout), the same seeded weights. The GNN
    embeddings are held normwise within IDAM_EMB_NORM. Run free, the kept
    points flipped (of 341 a cloud) and the correspondences flipped (over
    the source points both kept) are counted and printed. Then the CPU runs
    again with the card's kept points: its correspondence flips are counted,
    and each pair with none is held to IDAM_CPU_ATOL (T_12 and metrics)."""
    batch = {k: (v[:clouds_cut] if isinstance(v, np.ndarray) and v.ndim else v)
             for k, v in first.items()}
    cpu = torch.device("cpu")
    got, got_T, got_emb, got_kept, got_corr = _idam_on(cfg, device, batch)
    _, want_T, want_emb, want_kept, want_corr = _idam_on(cfg, cpu, batch)
    emb_gap = [float((g - w).double().norm() / w.double().norm())
               for g, w in zip(got_emb, want_emb)]
    kept = [[len(set(g[b].tolist()) - set(w[b].tolist())) for g, w in
             zip(got_kept, want_kept)] for b in range(clouds_cut)]
    corr = [_corr_flips(got_kept, got_corr, want_kept, want_corr, b)
            for b in range(clouds_cut)]
    M = got_kept[0].shape[1]
    print(f"IDAM card vs CPU on {clouds_cut} pairs of {batch['src'].shape[1]} points: "
          f"embeddings (tgt, src) "
          f"normwise {emb_gap!r} (bar {IDAM_EMB_NORM}); run free: kept points "
          f"flipped per pair (src, tgt; of {M}) {kept}, correspondences flipped per "
          f"pair and iteration {corr}, T_12 max |diff| "
          f"{float((got_T - want_T).abs().max())!r}")
    check(max(emb_gap) <= IDAM_EMB_NORM, f"IDAM card vs CPU: embeddings {emb_gap}")
    want, want_T, _, _, want_corr = _idam_on(cfg, cpu, batch, kept=got_kept)
    corr = [_corr_flips(got_kept, got_corr, got_kept, want_corr, b)
            for b in range(clouds_cut)]
    held = [b for b in range(clouds_cut) if not any(corr[b])]
    diffs = {}
    for b in held:
        for name, g, w in zip(("RotE", "transE", "RMSE", "MSE", "T_12"),
                              (got[1], got[2], got[3], got[4], got_T),
                              (want[1], want[2], want[3], want[4], want_T)):
            diffs[name] = max(diffs.get(name, 0.0), float((g[b] - w[b]).abs().max()))
    print(f"IDAM card vs CPU with the card's kept points on both: correspondences "
          f"flipped per pair and iteration {corr}; pairs held {held}: max |diff| "
          f"{diffs} (bars {IDAM_CPU_ATOL}); RotE card {got[1].tolist()!r}, CPU "
          f"{want[1].tolist()!r}")
    for name, d in diffs.items():
        check(d <= IDAM_CPU_ATOL[name], f"IDAM card vs CPU: {name} {d} > "
              f"{IDAM_CPU_ATOL[name]}")


def _reg_batches(cfg):
    spec = BatchSpec(int(cfg.batch_size))
    return (engine.registration_dataset(cfg, "val", REG_DATA_DIR).steps_per_epoch(spec),
            engine.registration_dataset(cfg, "test", REG_DATA_DIR).steps_per_epoch(spec))


def drive_registration_path(name, cfg, device, per_batch):
    """Phase 4 for a registration model: the val pass and the test poses, as
    registration/test_torch.py runs them, counts zeroed just before and read
    just after, equal to ``per_batch`` (DCP_PER_BATCH, IDAM_PER_BATCH) in
    every val and test batch."""
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    val = engine.run_registration_val(cfg, REG_DATA_DIR, device)
    poses = submission.predict_registration_test(cfg, REG_DATA_DIR, device)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = kernels.launch_counts()
    expected = dict.fromkeys(KERNELS, 0)
    expected.update({k: v * sum(_reg_batches(cfg)) for k, v in per_batch.items()})
    print(f"{name} main path launches ({seconds!r} s with the first calls' "
          f"allocations): {launches}")
    check(launches == expected, f"{name}: launches {launches}, expected {expected}")
    return val, poses, launches


def check_registration_results(name, cfg, device, val, poses):
    """The five metrics finite; the poses finite and rigid; the val metrics
    equal to the ones recomputed on the card with the metrics module from
    the test-branch poses of the val clouds (rtol 1e-6: the kernels are
    deterministic, so the poses are the val pass's)."""
    check(sorted(val) == sorted(engine.REG_METRICS), f"{name} val metrics {sorted(val)}")
    check(all(np.isfinite(v) for v in val.values()), f"{name} val metrics {val}")
    n = len(engine.registration_dataset(cfg, "test", REG_DATA_DIR))
    check(poses.shape == (n, 4, 4) and bool(np.isfinite(poses).all()),
          f"{name} test poses {poses.shape}")
    R = torch.from_numpy(poses[:, :3, :3]).double()
    rigid = float((R @ R.transpose(1, 2) - torch.eye(3, dtype=torch.float64)).abs().max())
    det = float((torch.linalg.det(R) - 1).abs().max())
    check(rigid < 1e-4 and det < 1e-4 and (poses[:, 3] == [0, 0, 0, 1]).all(),
          f"{name} poses not rigid: |R R^T - I| {rigid}, |det - 1| {det}")

    step = engine.make_registration_eval_step(engine.build_model(cfg, device), device)
    dataset = engine.registration_dataset(cfg, "val", REG_DATA_DIR)
    sums, total, first = dict.fromkeys(val, 0.0), 0, None
    for batch in dataset.batches(BatchSpec(int(cfg.batch_size))):
        c = int(batch["count"])
        with torch.inference_mode():
            T12 = step(batch, "test")
            Tg = torch.from_numpy(batch["transform"]).to(device)
            src = torch.from_numpy(batch["src"]).to(device)
            rmse = rmse_loss(src, T12, Tg)
            per = {"RotE": rotation_error(T12[:, :3, :3], Tg[:, :3, :3]),
                   "transE": translation_error(T12[:, :3, 3], Tg[:, :3, 3]),
                   "MSE": rotation_geodesic_error(T12[:, :3, :3], Tg[:, :3, :3])
                   + translation_error(T12[:, :3, 3], Tg[:, :3, 3]),
                   "RMSE": rmse, "recall": (rmse < 0.1).float()}
        for m in sums:
            sums[m] += float(per[m][:c].mean()) * c
        total += c
        if first is None:
            first = batch
    for m, v in val.items():
        want = sums[m] / total
        check(abs(v - want) <= 1e-6 * abs(want),
              f"{name} {m}: val pass {v!r} vs recomputed from the poses {want!r}")
    print(f"{name} val metrics == recomputed from the test-branch poses (rtol 1e-6): "
          + ", ".join(f"{m} {v!r}" for m, v in val.items())
          + f"; {n} test poses rigid (|R R^T - I| {rigid!r})")
    return step, first


def check_dcp_batch_on_cpu(cfg, step, first, clouds_cut=2):
    """One full-width val batch cut to two clouds, on the card and on the
    CPU (plain versions throughout), the same seeded weights: each output
    within its bar in DCP_CPU_ATOL (RotE in degrees)."""
    cpu = torch.device("cpu")
    batch = {k: (v[:clouds_cut] if isinstance(v, np.ndarray) and v.ndim else v)
             for k, v in first.items()}
    want_step = engine.make_registration_eval_step(engine.build_model(cfg, cpu), cpu)
    got = [o.cpu() for o in step(batch, "val")] + [step(batch, "test").cpu()]
    want = list(want_step(batch, "val")) + [want_step(batch, "test")]
    diffs = {}
    for name, g, w in zip(("loss", "RotE", "transE", "RMSE", "MSE", "T_12"),
                          got, want):
        diffs[name] = float((g - w).abs().max())
        check(diffs[name] <= DCP_CPU_ATOL[name],
              f"DCP card vs CPU: {name} {diffs[name]} > {DCP_CPU_ATOL[name]}")
    print(f"DCP card vs CPU on {clouds_cut} full-width clouds: max |diff| {diffs} "
          f"(bars {DCP_CPU_ATOL}); "
          f"RotE card {got[1].tolist()!r}, CPU {want[1].tolist()!r}")


def time_registration_passes(name, cfg, device, card, repeats=3):
    """ms per val and test batch of a registration model (host clock,
    batching and copies included), after a warm-up pass."""
    model = engine.build_model(cfg, device)
    step = engine.make_registration_eval_step(model, device)
    spec = BatchSpec(int(cfg.batch_size))
    val_ds = engine.registration_dataset(cfg, "val", REG_DATA_DIR)
    test_ds = engine.registration_dataset(cfg, "test", REG_DATA_DIR)
    meters = {m: AverageValueMeter() for m in engine.REG_METRICS}
    split_meters = engine.registration_split_meters(cfg)
    out = {}
    for split, ds, run in (
            ("val", val_ds, lambda: engine.val_registration(step, val_ds, spec,
                                                            meters, split_meters)),
            ("test", test_ds, lambda: engine.predict_registration(step, test_ds, spec))):
        run()
        torch.cuda.synchronize()
        each = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            each.append((time.perf_counter() - t0) * 1e3 / ds.steps_per_epoch(spec))
        out[split] = sum(each) / repeats
        print(f"{name} {split} pass: {out[split]!r} ms/batch (passes {each!r}; batch "
              f"{spec.batch_size}, {int(cfg.num_points)} points) on {card}")
    return out


def check_registration_train_result(name, cfg_path, device, res, log_dir, var):
    """Finite step losses and gradients, running statistics moved (``var``
    of the model, a running variance that starts at 1); the epoch
    checkpoint on disk and a best_* for every metric whose val value beat
    its initial best (``engine._record_best``: recall must beat 0, so a
    val pass that registers no pair writes no best_recall), and
    network.pkl loaded back through the eval path gives the run's val
    metrics (rtol 1e-6)."""
    losses = res["history"]["step_losses"][-1]
    check(losses and all(np.isfinite(losses)), f"{name} train losses {losses}")
    model = res["model"]
    bad = [n for n, p in model.named_parameters()
           if p.grad is None or not bool(torch.isfinite(p.grad).all())]
    check(not bad, f"{name}: parameters without a finite gradient: {bad}")
    moved = float((var(model) - 1).abs().max())
    check(moved > 0, f"{name}: the running statistics did not move")
    names = sorted(os.listdir(log_dir))
    val = res["history"]["val"][-1]
    beat = [m for m in engine.REG_METRICS
            if (val[m] > 0.0 if m in engine.HIGHER_IS_BETTER else val[m] < math.inf)]
    check({"network.pkl", *(f"best_{m}_network.pkl" for m in beat)}
          <= set(names), f"{name} checkpoints {names}, val {val}")
    again = engine.run_registration_val(
        load_config(cfg_path, load_model=os.path.join(log_dir, "network.pkl")),
        REG_DATA_DIR, device)
    for m, v in val.items():
        check(abs(again[m] - v) <= 1e-6 * abs(v),
              f"{name} {m}: reloaded checkpoint {again[m]!r}, run {v!r}")
    print(f"{name} train: step losses {losses!r}, every gradient finite, running "
          f"statistics moved; val {val}; network.pkl reloads to the same val "
          f"metrics (rtol 1e-6); checkpoints {names}")


def _dcp_train_batch(cfg, clouds_cut, seed=1):
    batch = next(engine.registration_dataset(cfg, "train", REG_DATA_DIR).batches(
        BatchSpec(int(cfg.batch_size), shuffle=True, seed=seed)))
    return {k: (v[:clouds_cut] if isinstance(v, np.ndarray) and v.ndim else v)
            for k, v in batch.items()}


def _dcp_step_on(cfg, device, batch, gamma_scale=1.0, seed=1):
    """One train step from the weights seeded ``seed`` (the edge chain's
    first BatchNorm scale times ``gamma_scale``) on ``device`` -> (loss,
    {name: gradient}, {name: running statistic}), on the host."""
    model = engine.build_model(cfg, device, seed=seed, for_training=True)
    with torch.no_grad():
        model.emb_nn.fused_scale0.mul_(gamma_scale)
    step = engine.make_registration_train_step(
        model, build_optimizer(cfg, model.parameters()), device)
    loss = float(step(batch)["total_loss"])
    return (loss, {n: p.grad.detach().double().cpu() for n, p in model.named_parameters()},
            {n: b.detach().cpu() for n, b in model.named_buffers()})


@contextlib.contextmanager
def plain_dcp_chain():
    """On the card, DGCNN's train-mode edge chain by its plain version
    (``ref.edge_mlp_train``, differentiated by autograd) in place of the
    kernels."""
    from mvp_benchmark_tpu_torch import ops

    saved = ops.edge_mlp_train
    ops.edge_mlp_train = ref.edge_mlp_train
    try:
        yield
    finally:
        ops.edge_mlp_train = saved


def chain_stat_gaps(calls):
    """Stage (a) of the DCP step check: for each recorded
    ``ops.edge_mlp_train`` call (``record_dcp_chain``), each layer's
    [mean, variance] normwise against the chain in fp64 on its inputs, each
    layer's fp64 statistics folded into the layer above
    (``ref.edge_mlp_stats_given``)."""
    gaps = []
    for a1, Ws, gammas, betas, stats in calls:
        truth = ref.edge_mlp_stats_given(a1, Ws, gammas, betas, dtype=torch.float64)
        gaps.append([[float((st[i].double() - t[i]).norm() / t[i].norm()) for i in (0, 1)]
                     for st, t in zip(stats, truth)])
    return gaps


@contextlib.contextmanager
def record_dcp_chain(calls):
    """Each ``ops.edge_mlp_train`` call, whichever runs it, appended to
    ``calls`` as (a1, Ws, gammas, betas, the statistics it returned),
    detached copies (the optimizer's step updates the weights in place)."""
    from mvp_benchmark_tpu_torch import ops

    inner = ops.edge_mlp_train

    def record(a1, Ws, gammas, betas):
        xs, stats = inner(a1, Ws, gammas, betas)
        d = lambda ts: [x.detach().clone() for x in ts]
        calls.append((a1.detach().clone(), d(Ws), d(gammas), d(betas), d(stats)))
        return xs, stats

    ops.edge_mlp_train = record
    try:
        yield
    finally:
        ops.edge_mlp_train = inner


@contextlib.contextmanager
def dcp_chain_given_stats(given):
    """DGCNN's train-mode edge chain by ``ref.edge_mlp_train`` with the
    statistics of ``given`` (a list of four (2, ch) a call, taken in call
    order) substituted by value, the gradient still through the batch's
    own."""
    from mvp_benchmark_tpu_torch import ops

    saved, queue = ops.edge_mlp_train, list(given)
    ops.edge_mlp_train = lambda a1, Ws, gammas, betas: ref.edge_mlp_train(
        a1, Ws, gammas, betas, given=queue.pop(0))
    try:
        yield
    finally:
        ops.edge_mlp_train = saved


def dcp_step_gaps(card, cpu, moved=None):
    """A DCP train step's readings, (loss, {name: gradient}, {name: running
    statistic}) on the card against the same on the CPU: the loss's
    absolute and relative gaps, the worst cosine outside the edge chain,
    each chain leaf's (cosine, normwise, the card's own move under the
    1e-6 change in ``moved``'s gradients, share of the whole gradient's
    norm), the shift-invariant biases against the whole norm
    (``DCP_SHIFT_INVARIANT``, exactly 0) and the running statistics' max
    |diff|."""
    (loss, g_card, st_card), (want, g_cpu, st_cpu) = card, cpu
    total = float(torch.sqrt(sum((g * g).sum() for g in g_cpu.values())))
    cos, chain, shift = {}, {}, {}
    for name, w in g_cpu.items():
        g = g_card[name]
        c = float((g.flatten() @ w.flatten()) / (g.norm() * w.norm()))
        if name.endswith(DCP_SHIFT_INVARIANT):
            shift[name] = float((g - w).norm()) / total
        elif ".fused_" in name:
            norm = float(w.norm())
            chain[name] = (c, float((g - w).norm()) / norm,
                           None if moved is None else float((moved[name] - g).norm()) / norm,
                           norm / total)
        else:
            cos[name] = c
    worst = min(cos, key=cos.get)
    return {"loss": loss, "cpu_loss": want, "abs": loss - want, "rel": (loss - want) / want,
            "cosine": (worst, cos[worst]), "chain": chain, "shift": max(shift.values()),
            "stats": max(float((st_card[n] - w).abs().max()) for n, w in st_cpu.items())}


def dcp_step_failures(r):
    """The bars of DCP_STEP_BARS that a ``dcp_step_gaps`` reading fails."""
    bad = []
    if abs(r["abs"]) > DCP_STEP_BARS["loss"]:
        bad.append(f"loss {r['loss']!r} CPU {r['cpu_loss']!r}")
    if r["cosine"][1] < DCP_STEP_BARS["cosine"]:
        bad.append(f"{r['cosine'][0]} cosine {r['cosine'][1]!r}")
    bad += [f"edge chain {n}: cosine {c!r}, normwise {gap!r}"
            for n, (c, gap, _, _) in r["chain"].items()
            if c < DCP_STEP_BARS["chain_cosine"] or gap > DCP_STEP_BARS["chain_normwise"]]
    if r["shift"] > 1e-5:
        bad.append(f"shift-invariant biases {r['shift']!r}")
    if r["stats"] > DCP_STEP_BARS["stats"]:
        bad.append(f"running statistics {r['stats']!r}")
    return bad


def dcp_step_stages(cfg, device, batch, free, chain=contextlib.nullcontext, moved=None,
                    seed=1):
    """Stages (a), (b) and (d) of the DCP step check for one way of running
    the chain on ``device`` (``chain``: a context that swaps
    ``ops.edge_mlp_train``): the step there, its chain statistics against
    fp64 (``chain_stat_gaps``), the CPU's step given them
    (``dcp_chain_given_stats``) and the free CPU step ``free`` (the CPU
    with its own statistics), each by ``dcp_step_gaps`` -> {"stat_gaps",
    "given", "free"}. ``seed``: the weights' (``_dcp_step_on``)."""
    calls = []
    with chain(), record_dcp_chain(calls):
        card = _dcp_step_on(cfg, device, batch, seed=seed)
    with dcp_chain_given_stats([c[4] for c in calls]):
        given = _dcp_step_on(cfg, torch.device("cpu"), batch, seed=seed)
    return {"stat_gaps": chain_stat_gaps(calls), "given": dcp_step_gaps(card, given, moved),
            "free": dcp_step_gaps(card, free, moved)}


def check_dcp_step_on_cpu(cfg, device, clouds_cut=2):
    """One DCP train step on two full-width pairs, card against CPU, the same
    seeded weights, in stages (bars: DCP_STEP_BARS' comment). (a) The card
    step's edge-chain statistics, each ``ops.edge_mlp_train`` call and
    layer, normwise against the chain in fp64 (EDGE_STAT_NORM). (b) The CPU
    step with the card's statistics substituted by value, against the
    card's: the loss, the updated running statistics, and every gradient
    leaf: the key projections' biases (``DCP_SHIFT_INVARIANT``, exactly 0)
    to 1e-5 of the whole gradient's norm, the edge chain's by cosine and
    normwise against the leaf's norm, every other by cosine. (c) A witness,
    the plain edge chain on the card (``plain_dcp_chain``), through the same
    stages and bars. (d) The free CPU step (its own statistics) against
    both, at the same bars. For each chain leaf it
    prints its share of the whole gradient and the card's own move when the
    chain's first BatchNorm scale moves by 1e-6: the bf16 roundings of the
    chain's activations make the gradient a step function at that scale."""
    batch = _dcp_train_batch(cfg, clouds_cut)
    loss_moved, g_moved, _ = _dcp_step_on(cfg, device, batch, 1 + 1e-6)
    free = _dcp_step_on(cfg, torch.device("cpu"), batch)
    witness = "witness (the plain chain on the card)"
    runs = {"kernels": dcp_step_stages(cfg, device, batch, free, moved=g_moved),
            witness: dcp_step_stages(cfg, device, batch, free, plain_dcp_chain)}
    print(f"DCP train step on {clouds_cut} full-width pairs, card against CPU; the card's "
          f"loss under the 1e-6 change {loss_moved!r}, relative to the CPU's "
          f"{(loss_moved - free[0]) / free[0]!r}")
    failed = []
    for label, r in runs.items():
        worst = max(g for call in r["stat_gaps"] for layer in call for g in layer)
        print(f"DCP step {label}: (a) the chain's statistics against fp64, [mean, var] a "
              f"layer of each call: {r['stat_gaps']!r}, worst {worst!r} (bar "
              f"{EDGE_STAT_NORM})")
        for stage, rr in (("(b) given the card's statistics", r["given"]),
                          ("(d) free", r["free"])):
            chain = rr["chain"].values()
            print(f"DCP step {label}: {stage}: loss {rr['loss']!r} / CPU {rr['cpu_loss']!r}, "
                  f"{rr['abs']!r} absolute, {rr['rel']!r} relative; gradient cosine >= "
                  f"{rr['cosine'][1]!r} ({rr['cosine'][0]}); edge chain cosine >= "
                  f"{min(c for c, _, _, _ in chain)!r}, normwise <= "
                  f"{max(g for _, g, _, _ in chain)!r}; shift-invariant biases "
                  f"{rr['shift']!r} of the gradient; running statistics max |diff| "
                  f"{rr['stats']!r}")
        if worst > EDGE_STAT_NORM:
            failed.append(f"{label} (a): statistics {worst!r} against fp64")
        failed += [f"{label} (b): {b}" for b in dcp_step_failures(r["given"])]
        failed += [f"{label} (d): {b}" for b in dcp_step_failures(r["free"])]
    print(f"DCP step bars: {DCP_STEP_BARS}, the loss absolute")
    w_chain = runs[witness]["given"]["chain"]
    for name, (c, gap, own, share) in runs["kernels"]["given"]["chain"].items():
        print(f"DCP step edge chain {name}: cosine {c!r}, normwise {gap!r} (witness "
              f"{w_chain[name][0]!r}, {w_chain[name][1]!r}); card's own move under the 1e-6 "
              f"change {own!r}; {share!r} of the whole gradient's norm")
    check(not failed, f"DCP step: {failed}")


def _idam_step_on(cfg, device, batch, src_idx, forced=None, gamma_scale=1.0):
    """One IDAM train step's forward and backward from the seeded weights
    (the first edge block's BatchNorm scale times ``gamma_scale``) on
    ``device``, keeping the source points ``src_idx`` -> (loss, {name:
    gradient}, {name: running statistic}, what it selected: the gt matches
    (min_idx, match labels) and each iteration's correspondences), on the
    host. ``forced``: the selections of another run, used instead of this
    run's own."""
    from mvp_benchmark_tpu_torch.models import idam

    model = engine.build_model(cfg, device, seed=1, for_training=True).train()
    with torch.no_grad():
        model.gnn.props[0].edge_scale.mul_(gamma_scale)
    gt_matches, corr = idam._gt_matches, idam._correspondences
    seen = {"gt": None, "corr": []}
    queue = list(forced["corr"]) if forced else []

    def gt(src, tgt, T):
        out = ([x.to(src.device) for x in forced["gt"]] if forced
               else gt_matches(src, tgt, T))
        seen["gt"] = [x.cpu() for x in out]
        return out

    def correspondences(sim):
        c = queue.pop(0).to(sim.device) if forced else corr(sim)
        seen["corr"].append(c.cpu())
        return c

    idam._gt_matches, idam._correspondences = gt, correspondences
    try:
        t = lambda k: torch.from_numpy(batch[k]).to(device)
        loss = model(t("src"), t("tgt"), t("transform"), prefix="train",
                     src_idx=src_idx)[0]
        loss.mean().backward()
    finally:
        idam._gt_matches, idam._correspondences = gt_matches, corr
    return (float(loss.detach()), {n: p.grad.detach().double().cpu()
                                   for n, p in model.named_parameters()},
            {n: b.detach().cpu() for n, b in model.named_buffers()}, seen)


@contextlib.contextmanager
def plain_idam_forwards():
    """On the card, the train forward passes of IDAM's similarity MLP and
    Propagate block replaced by their plain versions
    (``ref.sim_mlp_batch_stats`` and ``ref.sim_mlp_slots``;
    ``ref.gnn_propagate_stats`` and ``ref.gnn_propagate_slots``); their
    backwards stay the kernels, fed the plain versions' statistics and
    saved slots."""
    def sim(*x):
        st1, st2 = ref.sim_mlp_batch_stats(*x[:9], *x[10:12])
        simr, wmax, argj = ref.sim_mlp_slots(*x, st1, st2)
        return simr, wmax, st1, st2, argj.contiguous()

    def propagate(p, idx, W, b, gamma, beta):
        stats = ref.gnn_propagate_stats(p, idx)
        x, slot = ref.gnn_propagate_slots(p, idx, W, b, gamma, beta, stats[0], stats[1])
        return x.contiguous(), stats, slot.contiguous()

    saved = kernels.sim_mlp_train_forward, kernels.gnn_propagate_train_forward
    kernels.sim_mlp_train_forward, kernels.gnn_propagate_train_forward = sim, propagate
    try:
        yield
    finally:
        kernels.sim_mlp_train_forward, kernels.gnn_propagate_train_forward = saved


def check_idam_step_on_cpu(cfg, device, clouds_cut=2):
    """One IDAM train step on two full-width pairs of the train split, card
    against CPU, the same seeded weights and the same kept source points
    (drawn by ``idam.sample_src_idx`` from the CPU's gt matches). Run free,
    the gt-match flips (the expansion's products differ in cuBLAS and on
    the CPU) and the correspondence flips per iteration are counted. Then
    the CPU runs again with the card's gt matches and correspondences, and
    is held to IDAM_STEP_BARS: the loss (relative), the updated running
    statistics (relative to each one's largest magnitude), the
    shift-invariant leaves (``idam.SHIFT_INVARIANT``, rounding noise)
    against the whole gradient's norm, every other leaf by cosine and
    normwise against its own norm. For each leaf it prints the card's own
    move when the first edge block's BatchNorm scale moves by 1e-6: the
    bf16 roundings of the activations make the gradient a step function at
    that scale, which is what bounds the agreement. A witness runs the same
    step on the card with the plain train forwards of the similarity MLP and
    the Propagate block (``plain_idam_forwards``), printed beside the
    kernels' step and held to the same bars: a right implementation that
    sums in the CPU's order meets them."""
    from mvp_benchmark_tpu_torch.models import idam

    batch = _dcp_train_batch(cfg, clouds_cut)
    cpu = torch.device("cpu")
    t = lambda k: torch.from_numpy(batch[k])
    _, match = idam._gt_matches(t("src"), t("tgt"), t("transform"))
    src_idx = idam.sample_src_idx(match, batch["src"].shape[1] // 6,
                                  torch.Generator().manual_seed(1))
    loss, g_card, st_card, sel = _idam_step_on(cfg, device, batch, src_idx)
    _, _, _, sel_cpu = _idam_step_on(cfg, cpu, batch, src_idx)
    gt_flips = [int((g != w).sum()) for g, w in zip(sel["gt"], sel_cpu["gt"])]
    corr_flips = [[int((g[b] != w[b]).sum()) for g, w in zip(sel["corr"], sel_cpu["corr"])]
                  for b in range(clouds_cut)]
    _, g_moved, _, _ = _idam_step_on(cfg, device, batch, src_idx, forced=sel,
                                     gamma_scale=1 + 1e-6)
    with plain_idam_forwards():
        loss_w, g_witness, st_witness, _ = _idam_step_on(cfg, device, batch, src_idx,
                                                         forced=sel)
    want, g_cpu, st_cpu, _ = _idam_step_on(cfg, cpu, batch, src_idx, forced=sel)
    total = float(torch.sqrt(sum((g * g).sum() for g in g_cpu.values())))

    def gaps(grads, stats):
        """Each leaf's (cosine, normwise, the card's own move, share of the
        norm) against the CPU's, the shift-invariant leaves' gaps, and the
        running statistics' largest relative gap."""
        rows, shift = {}, {}
        for name, w in g_cpu.items():
            g = grads[name]
            if name.endswith(idam.SHIFT_INVARIANT):
                shift[name] = float((g - w).norm()) / total
                continue
            norm = float(w.norm())
            rows[name] = (float((g.flatten() @ w.flatten()) / (g.norm() * w.norm())),
                          float((g - w).norm()) / norm,
                          float((g_moved[name] - g).norm()) / norm, norm / total)
        stat_gap = max(float((stats[n] - w).abs().max() / w.abs().max().clamp_min(1e-12))
                       for n, w in st_cpu.items())
        return rows, shift, stat_gap

    rows, shift, stat_gap = gaps(g_card, st_card)
    worst_cos = min(rows, key=lambda n: rows[n][0])
    worst_norm = max(rows, key=lambda n: rows[n][1])
    w_rows, w_shift, w_stat = gaps(g_witness, st_witness)
    w_cos = min(w_rows, key=lambda n: w_rows[n][0])
    w_norm = max(w_rows, key=lambda n: w_rows[n][1])
    M = src_idx.shape[1]
    print(f"IDAM train step card vs CPU on {clouds_cut} pairs of {batch['src'].shape[1]} "
          f"points, the same {M} kept source points a pair: run free, gt matches "
          f"flipped (min_idx, labels of {batch['src'].shape[1]} a pair) {gt_flips}, "
          f"correspondences flipped per pair and iteration {corr_flips}; with the "
          f"card's selections on the CPU: loss {loss!r} / {want!r}, gradient cosine "
          f">= {rows[worst_cos][0]!r} ({worst_cos}), normwise <= "
          f"{rows[worst_norm][1]!r} ({worst_norm}), shift-invariant leaves <= "
          f"{max(shift.values())!r} of the whole norm, running statistics relative "
          f"{stat_gap!r} (bars {IDAM_STEP_BARS})")
    print(f"IDAM step witness, the similarity MLP's and the Propagate block's train "
          f"forward passes plain on the card (their backwards the kernels): loss "
          f"{loss_w!r}, gradient cosine >= {w_rows[w_cos][0]!r} ({w_cos}), normwise <= "
          f"{w_rows[w_norm][1]!r} ({w_norm}), shift-invariant leaves <= "
          f"{max(w_shift.values())!r}, running statistics relative {w_stat!r}")
    for name, (c, gap, moved, share) in rows.items():
        print(f"IDAM step {name}: cosine {c!r}, normwise {gap!r} (witness "
              f"{w_rows[name][0]!r}, {w_rows[name][1]!r}); card's own move under the 1e-6 "
              f"change {moved!r}; {share!r} of the whole gradient's norm")
    check(abs(loss_w - want) <= IDAM_STEP_BARS["loss"] * abs(want),
          f"IDAM step witness loss {loss_w!r} CPU {want!r}")
    check(w_rows[w_cos][0] >= IDAM_STEP_BARS["cosine"], f"IDAM step witness {w_cos}: cosine")
    check(w_rows[w_norm][1] <= IDAM_STEP_BARS["normwise"],
          f"IDAM step witness {w_norm}: normwise")
    check(max(w_shift.values()) <= IDAM_STEP_BARS["shift"], f"IDAM step witness shift: {w_shift}")
    check(w_stat <= IDAM_STEP_BARS["stats"], f"IDAM step witness running statistics {w_stat!r}")
    check(abs(loss - want) <= IDAM_STEP_BARS["loss"] * abs(want),
          f"IDAM step loss card {loss!r} CPU {want!r}")
    check(rows[worst_cos][0] >= IDAM_STEP_BARS["cosine"], f"IDAM step {worst_cos}: cosine")
    check(rows[worst_norm][1] <= IDAM_STEP_BARS["normwise"],
          f"IDAM step {worst_norm}: normwise")
    check(max(shift.values()) <= IDAM_STEP_BARS["shift"], f"IDAM step shift: {shift}")
    check(stat_gap <= IDAM_STEP_BARS["stats"], f"IDAM step running statistics {stat_gap!r}")


def drive_slice(cfg, device):
    """The main path, as test_torch.py runs it: --val, then the test pass."""
    val = engine.run_completion_val(cfg, DATA_DIR, device)
    preds = submission.predict_completion_test(cfg, DATA_DIR, device)
    torch.cuda.synchronize()
    return val, preds


def drive_path(name, cfg, device, expected):
    """Phase 4 for one path: counts zeroed just before, read just after, and
    equal to ``expected`` ({key: count}, derived from the model's code)."""
    kernels.reset_launch_counts()
    val, preds = drive_slice(cfg, device)
    launches = kernels.launch_counts()
    print(f"{name} main path launches: {launches}")
    check(launches == expected,
          f"{name}: launches {launches}, expected {expected}")
    return val, preds, launches


def _batches(cfg):
    spec = BatchSpec(int(cfg.batch_size))
    n = int(cfg.num_points)
    return (MVPCompletionDataset("val", DATA_DIR, n).steps_per_epoch(spec),
            MVPCompletionDataset("test", DATA_DIR, n).steps_per_epoch(spec))


def expected_counts(cfg, per_batch):
    """``per_batch`` launches in every val and test batch, plus one chamfer
    launch per val batch (calc_cd); 0 for every other kernel."""
    val_b, test_b = _batches(cfg)
    counts = dict.fromkeys(KERNELS, 0)
    counts.update({k: v * (val_b + test_b) for k, v in per_batch.items()})
    counts["chamfer"] = val_b
    return counts


def check_metrics(name, cfg, device, val, preds):
    """Finite results of the expected shape, and the val metrics equal to the
    ones recomputed with the plain chamfer on the card."""
    n = int(cfg.num_points)
    check(sorted(val) == ["cd_p", "cd_t", "f1"], f"{name} val metrics {sorted(val)}")
    check(all(np.isfinite(v) for v in val.values()), f"{name} val metrics {val}")
    check(preds.shape == (52, n, 3), f"{name} test predictions {preds.shape}")
    check(bool(np.isfinite(preds).all()), f"{name}: non-finite test predictions")

    model = engine.build_model(cfg, device)
    step = engine.make_eval_step(model, device)
    dataset = MVPCompletionDataset("val", DATA_DIR, n)
    sums, total, first = {m: 0.0 for m in val}, 0, None
    for batch in dataset.batches(BatchSpec(int(cfg.batch_size))):
        count = int(batch["count"])
        out2 = step(batch, prefix="test")["result"]
        with torch.inference_mode():
            gt = torch.as_tensor(batch["gt"]).to(device)
            d1, d2, _, _ = ref.chamfer_distance(gt, out2)
            per = {"cd_p": (d1.sqrt().mean(1) + d2.sqrt().mean(1)) / 2.0,
                   "cd_t": d1.mean(1) + d2.mean(1),
                   "f1": fscore(d1, d2)[0]}
        for m in sums:
            sums[m] += float(per[m][:count].mean().cpu()) * count
        total += count
        if first is None:
            first = batch
    for m, v in val.items():
        want = sums[m] / total
        check(abs(v - want) <= 1e-6 * abs(want),
              f"{name} {m}: kernel path {v!r} vs plain chamfer {want!r}")
    print(f"{name} val metrics == plain-chamfer metrics (rtol 1e-6): "
          + ", ".join(f"{m} {v!r}" for m, v in val.items()))
    return step, first


def check_pcn_batch_on_cpu(cfg, step, first):
    """One full-width PCN val batch on the CPU, plain versions throughout."""
    cpu = torch.device("cpu")
    got = step(first, prefix="val")
    want = engine.make_eval_step(engine.build_model(cfg, cpu), cpu)(first, "val")
    for k in ("out1", "out2"):
        torch.testing.assert_close(got[k].cpu(), want[k], rtol=1e-4, atol=1e-5)
    for k in ("cd_p", "cd_t"):
        torch.testing.assert_close(got[k].cpu(), want[k], rtol=1e-4, atol=0)
    print("PCN card == CPU on a full-width val batch: out1/out2 (atol 1e-5, "
          "rtol 1e-4), cd_p/cd_t (rtol 1e-4)")


# ECG's and VRCNet's fine output on the card against the CPU, as clouds: at
# most this share of the points of either cloud may lie further than a tenth
# of the cloud's mean spacing from every point of the other
# (check_batch_on_cpu_as_cloud).
MOVED_SHARE = 0.02


def check_batch_on_cpu_as_cloud(name, cfg, step, first, clouds_cut=2):
    """One full-width val batch, cut to ``clouds_cut`` clouds, on the card
    and on the CPU (plain versions throughout, the same latent noise).

    out1 (the coarse head: plain matmuls, no kNN) is held at PCN's bar. out2
    comes through selections over activations that cuBLAS and the CPU round
    differently in the last bits: ECG's feature-space kNN of four DenseConv
    blocks and FPS of the 3072 predicted points, VRCNet's FPS of its 3072
    predicted points and the 3-D kNN of the coarse head's GEMM outputs. A
    near tie can then take another neighbour or another sample, which moves a
    point by up to the cloud's spacing, legitimately. So out2 is held as a
    cloud: at most 2% of the points of either cloud may lie further than a
    tenth of the cloud's mean nearest-neighbour spacing from every point of
    the other. A point that took another neighbour set counts as moved; fp32
    rounding of the coordinates (~1e-7 relative) does not."""
    cpu = torch.device("cpu")
    batch = {k: (v[:clouds_cut] if isinstance(v, np.ndarray) and v.ndim else v)
             for k, v in first.items()}
    got = step(batch, prefix="val")
    want = engine.make_eval_step(engine.build_model(cfg, cpu), cpu)(batch, "val")
    torch.testing.assert_close(got["out1"].cpu(), want["out1"], rtol=1e-4, atol=1e-5)
    spacing = float(ref.knn(want["out2"], want["out2"], 2)[0][..., 1].sqrt().mean())
    near = 0.1 * spacing
    d1, d2, _, _ = ref.chamfer_distance(got["out2"].cpu(), want["out2"])
    moved = max(float((d1.sqrt() > near).float().mean()),
                float((d2.sqrt() > near).float().mean()))
    cd_t = (d1.mean(1) + d2.mean(1)).tolist()
    print(f"{name} card vs CPU on {clouds_cut} full-width clouds: out1 equal "
          f"(atol 1e-5, rtol 1e-4); out2 share of points further than "
          f"{near!r} from the other cloud {moved!r} (bar {MOVED_SHARE}), "
          f"cd_t(card, cpu) per cloud {cd_t!r}, mean spacing {spacing!r}, "
          f"max |out2 diff| "
          f"{float((got['out2'].cpu() - want['out2']).abs().max())!r}")
    check(moved <= MOVED_SHARE,
          f"{name} out2 card vs CPU: {moved} of the points moved")


def drive_emd_val(name, cfg, device):
    """The val pass with ``eval_emd: True`` (one auction a batch, eps 0.004,
    3000 iterations), counts zeroed just before and read just after: per val
    batch one chamfer and one emd_assignment. Its emd equals the plain
    auction's on the same predictions (rtol 1e-6: the assignments are
    equal, the rest is the same arithmetic); then each batch's kernel
    assignment is held bitwise against the plain auction's and timed, with
    its rounds, bidder-rounds and slowest cloud (the plain auction's
    counts, which the equal assignment shares) and the bounds of the batch
    and of the slowest cloud on its C SMs."""
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    val = engine.run_completion_val(cfg, DATA_DIR, device)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = kernels.launch_counts()
    val_b = _batches(cfg)[0]
    expected = dict.fromkeys(KERNELS, 0)
    expected.update(chamfer=val_b, emd=val_b)
    print(f"{name} val pass with eval_emd ({seconds!r} s) launches: {launches}")
    check(launches == expected, f"{name} eval_emd: launches {launches}, "
          f"expected {expected}")
    check(sorted(val) == ["cd_p", "cd_t", "emd", "f1"]
          and all(np.isfinite(v) for v in val.values()), f"{name} val {val}")

    step = engine.make_eval_step(engine.build_model(cfg, device), device)
    total, count = 0.0, 0
    for i, batch in enumerate(MVPCompletionDataset("val", DATA_DIR, int(
            cfg.num_points)).batches(BatchSpec(int(cfg.batch_size)))):
        out2 = step(batch, prefix="test")["result"]
        with torch.inference_mode():
            gt = torch.as_tensor(batch["gt"]).to(device)
            bids = []
            stats = torch.zeros((out2.shape[0], 2), dtype=torch.int64, device=device)
            want = ref.emd_assignment(out2, gt, 0.004, 3000, bids, stats)
            dist = ref.emd_distance(out2, gt, want)
            emd = dist.sqrt().mean(1)
            check_equal(f"{name} val batch {i} with eval_emd: emd_assignment",
                        [kernels.emd_assignment(out2, gt, 0.004, 3000)], [want])
            ms = time_cuda(lambda: kernels.emd_assignment(out2, gt, 0.004, 3000), 1, 0)
        n = gt.shape[1]
        C = kernels.emd_cluster_size(out2.shape[0], n, device)
        stats = stats.cpu()
        slow = int(stats[:, 1].argmax())
        ops = sum(bids) * n * 13
        slow_ops = int(stats[slow, 1]) * n * 13
        print(f"{name} val batch {i} with eval_emd: the auction ran {len(bids)} rounds, "
              f"{sum(bids)} bidder-rounds (the first {bids[:3]}, the last "
              f"{bids[-3:]}); the slowest cloud {slow}: {int(stats[slow, 1])} "
              f"bidder-rounds in {int(stats[slow, 0])} rounds; emd_assignment {ms!r} ms "
              f"on clusters of {C}, operation bound {ops / PEAK_FP32 * 1e3!r} ms (13 a "
              f"pair, as geometry_timing_cases), the slowest cloud's on its {C} SMs "
              f"{slow_ops / (PEAK_FP32 * C / 132) * 1e3!r} ms")
        c = int(batch["count"])
        total += float(emd[:c].mean().cpu()) * c
        count += c
    want = total / count
    check(abs(val["emd"] - want) <= 1e-6 * abs(want),
          f"{name} emd: kernel path {val['emd']!r} vs plain auction {want!r}")
    print(f"{name} val with eval_emd: {val}; emd == the plain auction's on the "
          f"same predictions (rtol 1e-6)")
    return launches


def check_f1_near(device, first):
    """Random weights put every prediction far from gt (f1 = 0), so the F1
    threshold is checked on clouds near gt: kernel on the card against the
    plain version on the CPU (distances are correctly rounded on both)."""
    gt = torch.as_tensor(first["gt"])
    rng = np.random.default_rng(4)
    near = gt[:, rng.permutation(gt.shape[1])] + torch.from_numpy(
        rng.normal(0.0, 0.012, tuple(gt.shape)).astype(np.float32))
    got = calc_cd(near.to(device), gt.to(device), calc_f1=True)
    want = calc_cd(near, gt, calc_f1=True)
    check(0.05 < float(want[2].min()) and float(want[2].max()) < 0.95,
          f"f1 check not in its range: {want[2]}")
    for g, w in zip(got, want):
        torch.testing.assert_close(g.cpu(), w, rtol=1e-6, atol=0)
    print(f"calc_cd on near clouds, card == CPU (rtol 1e-6): mean f1 "
          f"{float(want[2].mean())!r}")


def drive_train_path(name, train, steps, val_batches, per_step, per_val_batch):
    """Phase 4 for a train path: ``train()`` (``engine.train_completion`` or
    ``engine.train_registration``: one epoch of ``steps`` steps and its val
    pass of ``val_batches`` batches), counts zeroed just before and read
    just after, equal to ``per_step`` per step plus ``per_val_batch`` per
    val batch."""
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res = train()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = kernels.launch_counts()
    expected = dict.fromkeys(KERNELS, 0)
    for counts, times in ((per_step, steps), (per_val_batch, val_batches)):
        for k, v in counts.items():
            expected[k] += v * times
    print(f"{name} train path ({steps} steps + val pass, {seconds!r} s "
          f"with the first step's allocations) launches: {launches}")
    check(launches == expected, f"{name} train: launches {launches}, "
          f"expected {expected}")
    return res, launches


def check_train_result(name, cfg_path, device, res, log_dir):
    """Finite train loss and gradients; the epoch checkpoint, loaded back
    through the eval path, gives the val metrics of the run's val pass."""
    loss = res["history"]["train_loss"][-1]
    check(np.isfinite(loss), f"{name} train loss {loss}")
    bad = [n for n, p in res["model"].named_parameters()
           if p.grad is None or not bool(torch.isfinite(p.grad).all())]
    check(not bad, f"{name}: parameters without a finite gradient: {bad}")
    val = res["history"]["val"][-1]
    check(all(np.isfinite(v) for v in val.values()), f"{name} val {val}")
    names = sorted(os.listdir(log_dir))
    check({"network.pkl", "best_cd_p_network.pkl", "best_cd_t_network.pkl"}
          <= set(names), f"{name} checkpoints {names}")
    again = engine.run_completion_val(
        load_config(cfg_path, nepoch=1,
                    load_model=os.path.join(log_dir, "network.pkl")),
        DATA_DIR, device)
    for m, v in val.items():
        check(abs(again[m] - v) <= 1e-6 * abs(v),
              f"{name} {m}: reloaded checkpoint {again[m]!r}, run {v!r}")
    print(f"{name} train: loss {loss!r}, every gradient finite, val {val}; "
          f"network.pkl reloads to the same val metrics (rtol 1e-6); "
          f"checkpoints {names}")


def _train_batch(cfg, clouds_cut):
    n = int(cfg.num_points)
    batch = next(MVPCompletionDataset("train", DATA_DIR, n).batches(
        BatchSpec(int(cfg.batch_size), shuffle=True, seed=1)))
    return {k: (v[:clouds_cut] if isinstance(v, np.ndarray) and v.ndim else v)
            for k, v in batch.items()}


def _step_on(cfg, device, batch, fn):
    """Seeded weights on ``device``, ``fn(model, x, gt)`` -> dict of loss
    tensors (with "total") backward; returns (losses, flat gradient)."""
    model = engine.build_model(cfg, device, seed=1, for_training=True).train()
    x = torch.as_tensor(batch["inputs"]).to(device)
    gt = torch.as_tensor(batch["gt"]).to(device)
    losses = fn(model, x, gt)
    losses["total"].backward()
    grads = [p.grad.detach().cpu() for p in model.parameters()]
    return ({k: v.detach().cpu() for k, v in losses.items()}, grads)


def check_pcn_step_on_cpu(cfg, device, clouds_cut=2):
    """One PCN train step on a cut batch at full width, card against CPU:
    the total loss and every gradient within atol 1e-5 / rtol 1e-4."""
    batch = _train_batch(cfg, clouds_cut)

    def fn(model, x, gt):
        _, loss2, total = model(x, gt, prefix="train", alpha=0.5)
        return {"loss2": loss2, "total": total}

    got, g_card = _step_on(cfg, device, batch, fn)
    want, g_cpu = _step_on(cfg, torch.device("cpu"), batch, fn)
    for k in got:
        torch.testing.assert_close(got[k], want[k], rtol=1e-4, atol=1e-5)
    worst = 0.0
    for g, w in zip(g_card, g_cpu):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5)
        worst = max(worst, float((g - w).abs().max()))
    print(f"PCN train step card vs CPU on {clouds_cut} full-width clouds: "
          f"total {float(got['total'])!r} / {float(want['total'])!r}, every "
          f"gradient within atol 1e-5 / rtol 1e-4 (max |diff| {worst!r})")


# VRCNet's train step on the card against the CPU, as a cloud: the total
# loss and the whole gradient may differ by this much (relative norm) and
# the gradients' cosine must reach VRC_COSINE (check_vrcnet_step_on_cpu).
# Measured on an H100: totals equal, norms 1.9e-7 apart, cosine 1 - 2e-11;
# the bars keep room for a selection that rounds the other way.
VRC_NORM, VRC_COSINE = 1e-3, 0.9999


def check_vrcnet_step_on_cpu(cfg, device, clouds_cut=2):
    """One VRCNet train step on a cut batch at full width, card against CPU,
    the same weights and noise. loss1 (coarse_raw against gt, before any
    selection) and the KL terms within atol 1e-5 / rtol 1e-4. The losses
    after coarse_raw pass through kNN and FPS of activations that cuBLAS and
    the CPU round differently (as in eval, check_batch_on_cpu_as_cloud), so
    the total loss and the gradient, as one vector, are held as a cloud: the
    total within VRC_NORM relative, the gradients' norms within VRC_NORM of
    each other and their cosine at least VRC_COSINE."""
    batch = _train_batch(cfg, clouds_cut)
    noise = {}          # drawn on the CPU at the first call, used by both

    def fn(model, x, gt):
        if not noise:
            noise.update(model.draw_noise(clouds_cut,
                                          torch.Generator().manual_seed(1)))
        t = model.train_losses(x, gt, 0.5,
                               {k: v.to(x.device) for k, v in noise.items()})
        return {k: t[k] for k in ("loss1", "dl_rec", "dl_g", "total")}

    got, g_card = _step_on(cfg, device, batch, fn)
    want, g_cpu = _step_on(cfg, torch.device("cpu"), batch, fn)
    for k in ("loss1", "dl_rec", "dl_g"):
        torch.testing.assert_close(got[k], want[k], rtol=1e-4, atol=1e-5)
    gc, gw = torch.cat([g.reshape(-1) for g in g_card]), torch.cat(
        [g.reshape(-1) for g in g_cpu])
    cosine = float(torch.dot(gc.double(), gw.double())
                   / (gc.double().norm() * gw.double().norm()))
    norm_rel = float(abs(gc.norm() - gw.norm()) / gw.norm())
    total_rel = float(abs(got["total"] - want["total"]) / abs(want["total"]))
    print(f"VRCNet train step card vs CPU on {clouds_cut} full-width clouds: "
          f"loss1, dl_rec, dl_g within atol 1e-5 / rtol 1e-4 (max |loss1 "
          f"diff| {float((got['loss1'] - want['loss1']).abs().max())!r}); "
          f"total {float(got['total'])!r} / {float(want['total'])!r} "
          f"(relative {total_rel!r}); gradient cosine {cosine!r}, norms "
          f"{float(gc.norm())!r} / {float(gw.norm())!r} (relative "
          f"{norm_rel!r}); bars {VRC_NORM} and {VRC_COSINE}")
    check(total_rel <= VRC_NORM, f"VRCNet total loss card vs CPU: {total_rel}")
    check(norm_rel <= VRC_NORM and cosine >= VRC_COSINE,
          f"VRCNet gradient card vs CPU: cosine {cosine}, norms {norm_rel}")


def check_ecg_step_on_cpu(cfg, device, clouds_cut=2):
    """One ECG train step on a cut batch at full width, card against CPU:
    loss1 and uniform1 (the coarse output, before any selection over
    activations) and loss2 (chamfer, blind to the order of the points)
    within atol 1e-5 / rtol 1e-4; the total within rtol 1e-4; the gradient
    as one vector: norms within VRC_NORM, cosine at least VRC_COSINE (the
    fine output passes through kNN and FPS of activations that cuBLAS and
    the CPU round differently, as in ``check_batch_on_cpu_as_cloud``)."""
    batch = _train_batch(cfg, clouds_cut)

    def fn(model, x, gt):
        t = model.train_losses(x, gt, 0.5)
        return {k: t[k] for k in ("loss1", "loss2", "uniform1", "uniform2", "total")}

    got, g_card = _step_on(cfg, device, batch, fn)
    want, g_cpu = _step_on(cfg, torch.device("cpu"), batch, fn)
    gc, gw = torch.cat([g.reshape(-1) for g in g_card]), torch.cat(
        [g.reshape(-1) for g in g_cpu])
    cosine = float(torch.dot(gc.double(), gw.double())
                   / (gc.double().norm() * gw.double().norm()))
    norm_rel = float(abs(gc.norm() - gw.norm()) / gw.norm())
    print(f"ECG train step card vs CPU on {clouds_cut} full-width clouds: "
          + ", ".join(f"{k} {got[k].tolist()!r} / {want[k].tolist()!r}" for k in got)
          + f"; gradient cosine {cosine!r}, norms {float(gc.norm())!r} / "
          f"{float(gw.norm())!r} (relative {norm_rel!r})")
    for k in ("loss1", "uniform1", "loss2"):
        torch.testing.assert_close(got[k], want[k], rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(got["total"], want["total"], rtol=1e-4, atol=0)
    check(norm_rel <= VRC_NORM and cosine >= VRC_COSINE,
          f"ECG gradient card vs CPU: cosine {cosine}, norms {norm_rel}")


def check_completion_steps_rerun_bitwise(device):
    """Full-width PCN, VRCNet and ECG train steps (batch 32 x 2048 points,
    ``engine.make_train_step``, as ``completion_step``) run twice from the
    same seed, batch and noise, without ``torch.use_deterministic_algorithms``
    (as the engine runs them): the parameters after the step bitwise equal,
    since every kernel on these steps sums in a fixed order."""
    for name, path in (("PCN", PCN_CFG), ("VRCNet", VRCNET_CFG), ("ECG", ECG_CFG)):
        cfg = load_config(path)
        params = []
        for _ in range(2):
            run, _ = completion_step(cfg, device)
            run()
            torch.cuda.synchronize()
            params.append([p.detach().clone() for p in run.model.parameters()])
        diff = sum(int((a != b).sum()) for a, b in zip(*params))
        total = sum(a.numel() for a in params[0])
        print(f"{name} train step run twice from one seed: parameters after the "
              f"step bitwise equal ({diff} of {total} differ)")
        check(diff == 0, f"{name}: two train steps from one seed differ in {diff} values")


def completion_step(cfg, device):
    """One train step from the seeded weights as ``engine.train_completion``
    runs it (``engine.make_train_step``, the step's noise drawn on the host)
    -> (a call that runs it, points a step)."""
    model = engine.build_model(cfg, device, seed=1, for_training=True)
    step = engine.make_train_step(model.train(), build_optimizer(
        cfg, model.parameters()), device)
    batch = _train_batch(cfg, int(cfg.batch_size))
    gen = torch.Generator().manual_seed(1)
    bs = int(cfg.batch_size)

    def run():
        return step(batch, 0.5, engine.draw_noise(model, bs, gen))

    run.model = model
    return run, bs * int(cfg.num_points)


def registration_step(cfg, device):
    """One registration train step from the seeded weights
    (``engine.make_registration_train_step``; IDAM's kept points drawn from
    its generator) -> (a call, pairs a step)."""
    model = engine.build_model(cfg, device, seed=1, for_training=True)
    step = engine.make_registration_train_step(
        model, build_optimizer(cfg, model.parameters()), device)
    batch = _dcp_train_batch(cfg, int(cfg.batch_size))
    return (lambda: step(batch)), int(cfg.batch_size)


def time_train_steps(name, cfg, card, run, per_step, unit, steps=5):
    """ms per train step of ``run`` over ``steps`` steps after two warm-up
    steps, host clock; ``unit``/s = ``per_step`` per step time; the peak of
    allocated device memory over the timed steps."""
    for _ in range(2):
        run()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(steps):
        run()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / steps
    rate = per_step / (ms / 1e3)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"{name} train step: {ms!r} ms, {rate!r} {unit}/s (batch {int(cfg.batch_size)} "
          f"x {int(cfg.num_points)} points, host clock over {steps} steps), peak "
          f"allocated {peak!r} GiB on {card}")
    return {"ms_per_step": ms, f"{unit}_per_s": rate, "peak_gib": peak}


def time_passes(name, cfg, device, card, repeats=3):
    n = int(cfg.num_points)
    model = engine.build_model(cfg, device)
    step = engine.make_eval_step(model, device)
    spec = BatchSpec(int(cfg.batch_size))
    val_ds = MVPCompletionDataset("val", DATA_DIR, n)
    test_ds = MVPCompletionDataset("test", DATA_DIR, n)
    meters = {m: AverageValueMeter() for m in engine.completion_metrics(cfg)}
    out = {}
    for split, ds, run in (
            ("val", val_ds, lambda: engine.val_completion(step, val_ds, spec, meters)),
            ("test", test_ds, lambda: engine.predict_completion(step, test_ds, spec))):
        run()                                            # warm-up
        torch.cuda.synchronize()
        each = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            each.append((time.perf_counter() - t0) * 1e3 / ds.steps_per_epoch(spec))
        out[split] = sum(each) / repeats
        print(f"{name} {split} pass: {out[split]!r} ms/batch (passes {each!r}; "
              f"batch {spec.batch_size}, {n} points, host batching + copy "
              f"included) on {card}")
    return out


def time_cuda(fn, iters, warmup=2) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _iters(fn, budget_ms=150.0):
    """(launches, warm-up launches) of a timing window: about ``budget_ms``
    of work, 3 to 50 launches after 2 warm-ups; one launch and no warm-up
    for a call longer than the budget (the plain auction, seconds a call),
    which this probe call warms up."""
    once = time_cuda(fn, 1, warmup=0)
    if once > budget_ms:
        return 1, 0
    return int(min(50, max(3, budget_ms / max(once, 1e-3)))), 2


def bound(nbytes, ops, peak=PEAK_FP32):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the peak rate of their type (fp32 unless given)."""
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, ops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def timing_cases(device):
    """{key: (shape label, kernel fn, plain fn, library fn or None, bytes,
    operations)} at one main-path shape per kernel."""
    B = 32
    a, b = clouds(2, B, 2048, 2048, device)
    f24 = uniform(20, (B, 3072, 24), device)
    x1 = uniform(21, (B, 3072, 3), device)
    t24 = uniform(22, (B, 3072, 24), device)
    edge_idx = indices(23, 3072, (B, 3072, 16), device)
    edge_idx64 = edge_idx.reshape(B, -1, 1).long().expand(-1, -1, 24)
    gm_shape = (64, 1536, 128, 768, 10)                # VRCNet's level 2: staged
    gm_f = uniform(24, gm_shape[:3], device)
    gm_idx = indices(25, gm_shape[1], (gm_shape[0], *gm_shape[3:]), device)
    sa = sa_inputs(29, B, 3072, 16, 4, 16, device)     # VRCNet level 1
    t512 = uniform(26, (B, 1024, 512), device)
    ti_idx, ti_w = ref.three_nn_upsampling(uniform(27, (B, 3072, 3), device),
                                           uniform(28, (B, 1024, 3), device))
    N, M, S = 2048, 2048, 2048
    return {
        # operations: each distance once (8) and a compare a direction
        "chamfer": ("(32, 2048, 2048)",
                    lambda: kernels.chamfer_forward(a, b),
                    lambda: ref.chamfer_distance(a, b), None,
                    B * (N + M) * 12 + B * (N + M) * 8,
                    B * N * M * 10),
        "knn": ("(32, 3072 x 3072, C 24, k 16)",
                lambda: kernels.knn(f24, f24, 16),
                lambda: ref.knn(f24, f24, 16), None,
                *knn_work(B, 3072, 3072, 24, 16, True)),
        "fps": ("(32, 3072 -> 2048)",
                lambda: kernels.furthest_point_sample(x1, S),
                lambda: ref.furthest_point_sample(x1, S), None,
                *fps_work(B, 3072, S)),
        "gather": ("(32, 3072 x 24) by (32, 3072 x 16)",
                   lambda: kernels.gather_rows(t24, edge_idx),
                   lambda: ref.grouping_operation(t24, edge_idx),
                   lambda: torch.gather(t24, 1, edge_idx64),
                   B * 3072 * 24 * 4 + B * 3072 * 16 * 4 + B * 3072 * 16 * 24 * 4,
                   0),
        "group_max": ("(64, 1536 x 128) by (64, 768 x 10)",
                      lambda: kernels.group_max_forward(gm_f, gm_idx),
                      lambda: ref.group_max(gm_f, gm_idx), None,
                      probe_backwards.group_max_forward_bytes(*gm_shape),
                      gm_shape[0] * gm_shape[3] * gm_shape[2] * (gm_shape[4] - 1)),
        "three_interpolate": ("(32, 1024 x 512) -> 3072",
                              lambda: kernels.three_interpolate_forward(t512, ti_idx, ti_w),
                              lambda: ref.three_interpolate(t512, ti_idx, ti_w), None,
                              B * 1024 * 512 * 4 + B * 3072 * 3 * 8 + B * 3072 * 512 * 4,
                              B * 3072 * 512 * 5),
        "sa_attention": ("(32, 3072, rel 4, mid 16, k 16)",
                         lambda: kernels.sa_attention_forward(*sa, 4, 16, 8),
                         lambda: ref.sa_attention(*sa, 4, 16, 8), None,
                         *probe_scatter_sa.sa_forward_work(B, 3072, 16, 4, 16)),
    }


# VRCNet's four SA levels in its train step (batch 64 after the dual path):
# (N, k, rel, mid), share 8, level i on 3072 / 2^i points at the widths of
# the kernel's i-th instantiation.
SA_LEVELS = tuple((3072 >> i, 16, rel, mid) for i, (rel, mid, _) in enumerate(kernels.SA_LEVELS))


def sa_backward_work(B, n, k, rel, mid, share=8):
    """(bytes, operations) of the SA block's backward: proj, x1, idx and
    d_out read once, d_proj and d_x1 written once (the weights are at most
    70 KB); its forward recomputed, then d_w, d_proj, db2, dW2, d_u, dW1 and
    d_cat, 2 operations a multiply-add."""
    ms = mid // share
    in_w, kms = (1 + k) * rel, k * ms
    nbytes = B * n * (2 * (rel + mid) + 2 * rel + k + mid) * 4
    ops = B * n * (2 * in_w * ms + 2 * ms * kms + kms             # forward
                   + 2 * k * mid + k * mid + kms + 2 * ms * kms   # d_w .. dW2
                   + 2 * kms * ms + 2 * in_w * ms + 2 * in_w * ms)
    return nbytes, ops


def time_sa_backward_at_path_shapes(device, card):
    """The SA block's backward at each of VRCNet's four levels in its train
    step: kernel and plain times (CUDA events, in the order plain, kernel,
    kernel, plain), the device time of each pass under torch.profiler
    (``probe_knn_fps.device_ms``: pass 1, the partials' sum, the reverse
    list and pass 2), and the bound (``sa_backward_work``). Prints one JSON
    line."""
    out = []
    for i, (n, k, rel, mid) in enumerate(SA_LEVELS):
        B = 64
        args = sa_inputs(70 + i, B, n, k, rel, mid, device)
        g = cotangent(71 + i, (B, n, mid), device)
        kern = lambda: kernels.sa_attention_backward(g, *args, rel, mid, 8)
        plain = lambda: ref.sa_attention_backward(g, *args, rel, mid, 8)
        its = {"kernel": _iters(kern), "plain": _iters(plain)}
        runs = {"kernel": [], "plain": []}
        for which, fn in (("plain", plain), ("kernel", kern), ("kernel", kern),
                          ("plain", plain)):
            runs[which].append(time_cuda(fn, *its[which]))
        passes = {name: probe_knn_fps.device_ms(kern, names=(name,))
                  for name in ("sa_backward_points", "sa_backward_sum",
                               "reverse_list", "sa_backward_rows")}
        bound_ms, bound_by = bound(*sa_backward_work(B, n, k, rel, mid))
        out.append({"B": B, "N": n, "k": k, "rel": rel, "mid": mid,
                    "ms": runs["kernel"], "plain_ms": runs["plain"],
                    "device_ms": passes, "bound_ms": bound_ms, "bound_by": bound_by})
    print(f"sa_backward_path_shapes on {card}: {json.dumps(out)}")
    return out


def time_sa_forward_at_path_shapes(device, card):
    """The SA block's forward at each of VRCNet's four levels in a val batch
    (batch 32) and a train step (64) (``probe_scatter_sa.probe_sa_forward``):
    held to its bar and run twice bitwise, kernel and plain times (CUDA
    events, in the order plain, kernel, kernel, plain), device time under
    torch.profiler, the bound (``probe_scatter_sa.sa_forward_work``) and the
    plan (``kernels.sa_forward_plan``: warps, grid, shared bytes). Prints
    one JSON line."""
    out = probe_scatter_sa.probe_sa_forward(device)
    print(f"sa_forward_path_shapes on {card}: {json.dumps(out)}")
    return out


def time_propagate_at_path_shape(device, card):
    """IDAM's Propagate block at its path shape (32, 2048, k 12, C 64), each
    wrapper call by CUDA events and each launch by its device time under
    torch.profiler, beside each launch's bound (``probe_propagate.probe``:
    the final pass in eval and in train with the stat pass, the backward's
    pass 1 and gather given the graph's list, pass 1 alone, the list).
    Prints one JSON line."""
    out = probe_propagate.probe(device)
    print(f"propagate_path_shape on {card}: {json.dumps(out)}")
    return out


def time_gather_at_step_shapes(device, card):
    """group_max's forward and three_interpolate's backward at the VRCNet
    and ECG train steps' six shapes each, on seeded uniform inputs
    (``probe_backwards.probe_uniform``): bitwise the plain version on CPU
    copies and run twice, device time under torch.profiler (the list and
    the gather apart) beside the bound; every form of each plan (staged and
    direct, one launch and the list) runs at one of them. Prints one JSON
    line."""
    out = probe_backwards.probe_uniform(
        device, ("group_max_forward", "three_interpolate_backward"))
    print(f"gather_step_shapes on {card}: {json.dumps(out)}")
    return out


def time_scatter_at_ecg_shapes(device, card):
    """scatter_add_rows at the shapes of ECG's train step (the uniform
    losses' kNN and grouping gathers, out2's largest; a sampled centres'
    gather; the last FPS's gather; DenseEdge's neighbour gather at level 1,
    the list form) and VRCNet's centre gather (``probe_scatter_sa``): each
    bitwise against the plain version on CPU copies and run twice, event
    and device times beside ``torch.index_add``'s (events in the order
    library, kernel, kernel, library), the bound and the plan (rows, warps,
    clouds a block). Prints one JSON line."""
    out = probe_scatter_sa.probe_scatter(device)
    print(f"scatter_path_shapes on {card}: {json.dumps(out)}")
    return out


def backward_timing_cases(device):
    """timing_cases of the five backwards, at a VRCNet train step's shape
    each (batch 64 after the dual path). Bytes: each input read once, each
    output written once; operations: fp32 adds and multiplies the function
    needs (the SA block's: its forward recomputed, then d_w, d_proj, db2,
    dW2, d_u, dW1 and d_cat, 2 per multiply-add)."""
    B = 64
    gt, pred = clouds(5, B, 2048, 3072, device)
    _, _, i1, i2 = kernels.chamfer_forward(gt, pred)
    g1 = cotangent(6, (B, 2048), device)
    g2 = cotangent(7, (B, 3072), device)
    n1, m1, c1 = 3072, 1536, 64                     # level 1 -> 2, 64 channels
    sc_g = cotangent(8, (B, m1, c1), device)
    sc_idx = indices(9, n1, (B, m1), device)
    sc_flat = (sc_idx.long() + torch.arange(B, device=device)[:, None] * n1).reshape(-1)
    sc_zero = torch.zeros(B * n1, c1, device=device)
    gm_f = torch.relu(uniform(10, (B, n1, c1), device) - 0.5)
    gm_idx = indices(11, n1, (B, m1, 10), device)
    _, gm_slot = kernels.group_max_forward(gm_f, gm_idx)
    ti_f = cotangent(12, (B, 1536, 128), device)     # level 2 -> 1
    ti_idx, ti_w = ref.three_nn_upsampling(uniform(13, (B, 3072, 3), device),
                                           uniform(14, (B, 1536, 3), device))
    ti_g = cotangent(15, (B, 3072, 128), device)
    n, k, rel, mid = SA_LEVELS[0]                    # SA level 1
    sa = sa_inputs(16, B, n, k, rel, mid, device)
    sa_g = cotangent(17, (B, n, mid), device)
    return {
        "chamfer_backward": (
            "(64, 2048 gt vs 3072 predicted), db",
            lambda: kernels.chamfer_backward(gt, pred, i1, g1, i2, g2, False, True),
            lambda: ref.chamfer_backward(gt, pred, i1, g1, i2, g2, False, True),
            None,
            B * (2048 + 3072) * (12 + 8) + B * 3072 * 12,
            B * (2048 + 3072) * 7),
        "scatter_add_rows": (
            "(64, 1536 x 64) into (64, 3072 x 64)",
            lambda: kernels.scatter_add_rows(sc_g, sc_idx, n1),
            lambda: ref.scatter_add_rows(sc_g, sc_idx, n1),
            lambda: torch.index_add(sc_zero, 0, sc_flat, sc_g.reshape(-1, c1)),
            B * m1 * (c1 + 1) * 4 + B * n1 * c1 * 4,
            B * m1 * c1),
        "group_max_backward": (
            "(64, 1536 x 64) by (64, 1536 x 10) into (64, 3072 x 64)",
            lambda: kernels.group_max_backward(sc_g, gm_idx, gm_slot, n1),
            lambda: ref.group_max_backward(sc_g, gm_idx, gm_slot, n1),
            None,
            B * m1 * (c1 * (4 + 1) + 10 * 4) + B * n1 * c1 * 4,
            B * m1 * c1),
        "three_interpolate_backward": (
            "(64, 3072 x 128) into (64, 1536 x 128), d_features",
            lambda: kernels.three_interpolate_backward(ti_g, ti_idx, ti_w, ti_f, False),
            lambda: ref.three_interpolate_backward(ti_g, ti_idx, ti_w, ti_f, False),
            None,
            B * 3072 * (128 + 6) * 4 + B * 1536 * 128 * 4,
            B * 3072 * 3 * 128 * 2),
        "sa_attention_backward": (
            "(64, 3072, rel 4, mid 16, k 16)",
            lambda: kernels.sa_attention_backward(sa_g, *sa, rel, mid, 8),
            lambda: ref.sa_attention_backward(sa_g, *sa, rel, mid, 8),
            None,
            *sa_backward_work(B, n, k, rel, mid)),
    }


def geometry_timing_cases(device, emd_case):
    """timing_cases of the ball query at the uniform loss's largest shape
    and of the auction at the val metric's (the inputs, and the bidders of
    each round counted by the plain version, from the check phase).
    Operations are counted over what these inputs need: the ball query's
    pairs up to each centre's ``nsample``-th hit (11 a pair: 3
    subtractions, 3 multiplies, 2 adds, 3 compares), the auction's bidders
    of every round times n targets (13 a pair: 3 + 3 + 2 for d, the sqrt,
    2 subtractions for the benefit and 2 compares for the top-2)."""
    B, n, m, ns = 32, 2048, 102, 24
    xyz = uniform(90, (B, n, 3), device)
    centers = xyz[:, :m].contiguous()
    r = float(np.sqrt(0.012))
    with torch.no_grad():
        d = ref._sqdist(centers, xyz)
        hit = (d == 0) | (d < ref.squared_radius(r))
        scanned = torch.clamp((hit.cumsum(-1) < ns).sum(-1) + 1, max=n)
    a, b, eps, iters, bids = emd_case
    bn = a.shape[0] * a.shape[1]
    return {
        "ball_query": (f"(32, 2048) points, 102 centres, nsample {ns}, r sqrt(0.012)",
                       lambda: kernels.ball_query(0.0, r, ns, xyz, centers),
                       lambda: ref.ball_query(0.0, r, ns, xyz, centers), None,
                       B * (n + m) * 12 + B * m * ns * 4,
                       int(scanned.sum()) * 11),
        "emd": (f"(32, 2048), eps {eps}, {iters} iterations ({len(bids)} rounds, "
                f"{sum(bids)} bidder-rounds)",
                lambda: kernels.emd_assignment(a, b, eps, iters),
                lambda: ref.emd_assignment(a, b, eps, iters), None,
                bn * (12 + 12 + 4),
                sum(bids) * a.shape[1] * 13),
    }


def dcp_timing_cases(device):
    """timing_cases of DCP's kernels at its path's shapes, with the peak of
    their operations' type: bf16 tensor cores for the multi-head attention
    and the edge chain (bf16 operands, fp32 sums); the svd head's scores as
    3xTF32, three TF32 products at the TF32 peak, its 3-wide product counted
    in TF32-peak equivalents (times 495 / 67), its bound on fp32 cores in
    the label.
    Bytes: q, k, v read and the output written once (the edge chain: a1,
    the bf16 weights and the four fp32 max-pools). Operations: 2 per
    multiply-add of the two attention products (softmax not counted), of the
    chain's four layers over every edge (BatchNorm and relu not counted).
    The library calls: ``scaled_dot_product_attention`` on the same
    tensors; none computes the edge chain."""
    B, N, H, dk, D, K = 32, 2048, 4, 128, 512, 20
    q, k, v = dcp_attention_inputs(400, B, N, N, H, device)
    qs, ks, vs = (x.transpose(1, 2) for x in (q, k, v))
    g = torch.Generator(device=device).manual_seed(401)
    sq = torch.randn(B, N, D, device=device, generator=g)
    sk = torch.randn(B, N, D, device=device, generator=g)
    sv = torch.rand(B, N, 3, device=device, generator=g)
    a1, Ws, params = dcp_edge_inputs(402, B, N, K, device)
    chain = sum(a * b for a, b in zip((6, 64, 64, 128), (64, 64, 128, 256)))
    svd_ops = 2 * B * N * N * (D + 3)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return {
        "attention_bnhd": (f"({B}, {N} x {N}, H {H}, dk {dk}) bf16, heads in place",
                           lambda: kernels.attention_bnhd_forward(q, k, v, dk ** -0.5),
                           lambda: ref.attention_bnhd(q, k, v, dk ** -0.5),
                           lambda: sdpa(qs, ks, vs),
                           4 * B * N * H * dk * 2, 4 * B * H * N * N * dk, PEAK_BF16),
        "attention": (f"({B}, {N} x {N}, D {D}, Dv 3) fp32; 3xTF32, bound at the "
                      f"TF32 peak (on fp32 cores {svd_ops / PEAK_FP32 * 1e3!r} ms)",
                      lambda: kernels.attention_forward(sq, sk, sv, D ** -0.5),
                      lambda: ref.attention(sq, sk, sv, D ** -0.5),
                      lambda: sdpa(sq, sk, sv),
                      (2 * B * N * D + 2 * B * N * 3) * 4,
                      3 * 2 * B * N * N * D + 2 * B * N * N * 3 * PEAK_TF32 / PEAK_FP32,
                      PEAK_TF32),
        "edge_mlp": (f"({B}, {N}, k {K}, 6) -> 64/64/128/256",
                     lambda: kernels.edge_mlp_forward(a1, Ws, *params),
                     lambda: ref.edge_mlp_eval(a1, Ws, *params), None,
                     B * N * K * 6 * 2 + chain * 2 + B * N * 512 * 4,
                     2 * B * N * K * chain, PEAK_BF16),
    }


def dcp_train_timing_cases(device):
    """timing_cases of DCP's train kernels at a train step's shapes. Bytes:
    each input read once, each output written once. Operations, 2 per
    multiply-add, the least the function needs: the attention backwards
    rebuild the scores once and form dP, dQ, dK (and dV for the heads; the
    svd head's 3-wide dP and no dV), though the heads' kernels form the
    scores and dP twice; the svd head's three D-wide products as 3xTF32,
    three TF32 products each, at the TF32 peak (its 3-wide dP counted in
    TF32-peak equivalents, times 495 / 67), its bound on fp32 cores in the
    label; the stat passes recompute layers 0..l for layer l; the chain's
    backward recomputes the forward once, forms every dW and pushes the
    cotangent down to layer 0 (the kernel recomputes the chain in each of
    its five passes). The library calls: the backward of
    ``scaled_dot_product_attention`` on the same tensors
    (``torch.autograd.grad`` on its output); none computes the chain."""
    B, N, H, dk, D, K = 32, 2048, 4, 128, 512, 20
    sdpa = torch.nn.functional.scaled_dot_product_attention
    *hx, h_do, h_scale = _attention_stats_inputs(800, B, N, N, device, True)
    hq, hk, hv = (x.transpose(1, 2).detach().requires_grad_() for x in hx[:3])
    h_out = sdpa(hq, hk, hv)
    h_dot = h_do.transpose(1, 2)
    *fx, f_do, f_scale = _attention_stats_inputs(801, B, N, N, device, False)
    fq, fk = (x.detach().requires_grad_() for x in fx[:2])
    try:
        f_out = sdpa(fq, fk, fx[2])
        f_lib = lambda: torch.autograd.grad(f_out, (fq, fk), f_do, retain_graph=True)
    except RuntimeError as e:
        print(f"attention_backward: scaled_dot_product_attention refuses the svd "
              f"head's shapes: {e}")
        f_lib = None
    a1, Ws, gammas, betas, gxs = edge_train_inputs(802, B, N, K, device)
    ws = [w.to(torch.bfloat16).contiguous() for w in Ws]
    _, stats, slots = kernels.edge_mlp_train_forward(a1, Ws, gammas, betas)
    leaves = [x.clone().requires_grad_() for x in (*Ws, *gammas, *betas)]
    plain_xs, _ = ref.edge_mlp_train(a1, leaves[:4], leaves[4:8], leaves[8:])
    E = B * N * K
    c = [a * b for a, b in zip(kernels.EDGE_MLP_CHANNELS[:-1],
                               kernels.EDGE_MLP_CHANNELS[1:])]
    chain, w_bytes = sum(c), sum(c) * 2
    heads = B * N * H * dk * 2
    svd_ops = 2 * B * N * N * (3 * D + 3)
    return {
        "attention_bnhd_backward": (
            f"({B}, {N} x {N}, H {H}, dk {dk}) bf16, heads in place",
            lambda: kernels.attention_bnhd_backward(*hx, h_do, h_scale),
            lambda: ref.attention_backward(*hx, h_do, h_scale),
            lambda: torch.autograd.grad(h_out, (hq, hk, hv), h_dot, retain_graph=True),
            8 * heads + 2 * B * H * N * 4, 5 * 2 * B * H * N * N * dk, PEAK_BF16),
        "attention_backward": (
            f"({B}, {N} x {N}, D {D}, Dv 3) fp32, dq and dk; 3xTF32, bound at the "
            f"TF32 peak (on fp32 cores {svd_ops / PEAK_FP32 * 1e3!r} ms)",
            lambda: kernels.attention_backward(*fx, f_do, f_scale, need=(True, True, False)),
            lambda: ref.attention_backward(*fx, f_do, f_scale),
            f_lib,
            (4 * B * N * D + 3 * B * N * 3 + 2 * B * N) * 4,
            3 * 2 * B * N * N * 3 * D + 2 * B * N * N * 3 * PEAK_TF32 / PEAK_FP32,
            PEAK_TF32),
        "edge_mlp_stat": (
            f"({B}, {N}, k {K}, 6) -> 64/64/128/256, four passes",
            lambda: kernels.edge_mlp_batch_stats(a1, ws, gammas, betas),
            lambda: ref.edge_mlp_train(a1, Ws, gammas, betas),
            None,
            E * 6 * 2 + w_bytes + 2 * 512 * 4,
            2 * E * sum(sum(c[:i + 1]) for i in range(4)), PEAK_BF16),
        "edge_mlp_backward": (
            f"({B}, {N}, k {K}, 6) -> 64/64/128/256, five passes",
            lambda: kernels.edge_mlp_train_backward(a1, Ws, gammas, betas, stats,
                                                    slots, gxs),
            lambda: torch.autograd.grad(plain_xs, leaves, gxs, retain_graph=True),
            None,
            E * 6 * 2 + B * N * 512 * (4 + 1) + w_bytes + (chain + 2 * 512) * 4,
            2 * E * (2 * chain + sum(c[1:])), PEAK_BF16),
    }


def idam_timing_cases(device):
    """timing_cases of IDAM's kernels at its path's shapes. Bytes: each
    input read once (the edge block's p, idx and parameters; the similarity
    kernel's projections, positions and parameters), each output written
    once (the (B, N, C) max-pool; the (B, M, M) logits and (B, M, C) wmax).
    Operations, 2 per multiply-add: the bf16-input products (W of every
    edge; Wxyz, W2 and W3 of every pair) at the bf16 peak, and the fp32
    operations at the fp32 peak (the edge: its subtraction, the BatchNorm's
    four, the bias; a pair: 13 for the distance and direction, 15 a channel
    for h0, the two BatchNorms, b2 and the W4 logit; relu and max not
    counted), counted as bf16-peak operations (times 989 / 67) so that one
    peak bounds their sum."""
    B, N, k, C = 32, 2048, 12, 64
    M, SC = N // 6, kernels.SIM_MLP_C
    pa = idam_propagate_inputs(900, B, N, k, C, device)
    sa = idam_sim_inputs(901, B, M, device)
    E, P = B * N * k, B * M * M
    f32 = PEAK_BF16 / PEAK_FP32
    return {
        "gnn_propagate": (f"({B}, {N}, k {k}, C {C})",
                          lambda: kernels.gnn_propagate_forward(*pa),
                          lambda: ref.gnn_propagate_eval(*pa), None,
                          2 * B * N * C * 4 + E * 4 + (C * C + 5 * C) * 4,
                          2 * E * C * C + 6 * E * C * f32, PEAK_BF16),
        "sim_mlp": (f"({B}, {M} x {M}, emb 64, C {SC})",
                    lambda: kernels.sim_mlp_forward(*sa),
                    lambda: ref.sim_mlp_core(*sa), None,
                    (2 * B * M * (SC + 3) + P + B * M * SC + 2496) * 4,
                    2 * P * (3 * SC + 2 * SC * SC) + P * (13 + 15 * SC) * f32,
                    PEAK_BF16),
    }


def idam_train_timing_cases(device):
    """timing_cases of IDAM's train kernels at its train step's shapes.
    Bytes: each input read once, each output written once (the edge block's
    stat pass reads p and idx; its backward p, idx, the cotangent and the
    slots, and writes d_p; the graph's reverse list reads idx and writes
    order and off; the similarity MLP's stat passes read the
    projections and positions; its backward those, the cotangents of simr
    and wmax and argj, and writes dsp and dtp). Operations, 2 per
    multiply-add, the least the function needs on this data: the edge
    block's stat pass builds the edges (a subtraction) and sums e and e^2;
    its backward recomputes the edges and BatchNorm, and forms dW and dx1
    from the one routed slot a channel (C^2 each a point) and da; the
    similarity MLP's stat passes recompute h0, then h0 to h2; its backward
    recomputes the chain to x2 and forms dh1, dx1, dW3 and dW2 (C^2 each a
    pair). Products with two bf16 inputs at the bf16 peak; those with an fp32
    cotangent (JAX's rounding rule, ops/ref.py) and the other fp32
    operations at the fp32 peak, counted as bf16-peak operations (times 989
    / 67) so that one peak bounds their sum. No library call computes
    them."""
    B, N, k, C = 32, 2048, 12, 64
    M, SC = N // 6, kernels.SIM_MLP_C
    p, idx, W, b, gamma, beta, _, _ = idam_propagate_inputs(910, B, N, k, C, device)
    dx = torch.randn(p.shape, device=device,
                     generator=torch.Generator(device=device).manual_seed(911))
    _, stats, slot = kernels.gnn_propagate_train_forward(p, idx, W, b, gamma, beta)
    lst = kernels.gnn_propagate_list(idx, N)
    xs = idam_sim_inputs(912, B, M, device)[:14]
    g = torch.Generator(device=device).manual_seed(913)
    dsimr = torch.randn((B, M, M), device=device, generator=g)
    dwmax = torch.randn((B, M, SC), device=device, generator=g)
    _, _, st1, st2, argj = kernels.sim_mlp_train_forward(*xs)
    E, P, f32 = B * N * k, B * M * M, PEAK_BF16 / PEAK_FP32
    pts = B * N * C * 4
    sim_in = (2 * B * M * (SC + 3) + 2496) * 4
    return {
        "gnn_propagate_stat": (
            f"({B}, {N}, k {k}, C {C})",
            lambda: kernels.gnn_propagate_batch_stats(p, idx),
            lambda: ref.gnn_propagate_stats(p, idx), None,
            pts + E * 4, 4 * E * C * f32, PEAK_BF16),
        "gnn_propagate_backward": (
            f"({B}, {N}, k {k}, C {C}), pass 1 and the gather, given the list",
            lambda: kernels.gnn_propagate_train_backward(p, idx, W, gamma, beta, stats,
                                                         slot, dx, lst=lst),
            lambda: ref.gnn_propagate_backward(p, idx, W, gamma, beta, stats, slot, dx),
            None, 3 * pts + E * 4 + B * N * C + (C * C + 4 * C) * 4,
            (4 * B * N * C * C + 14 * E * C) * f32, PEAK_BF16),
        # idx read once, order and off written once
        "gnn_propagate_list": (
            f"({B}, {N} x {k}) into {N} rows",
            lambda: kernels.gnn_propagate_list(idx, N),
            lambda: ref.reverse_list(idx, N), None,
            E * 4 * 2 + (B * N + 1) * 4, 0),
        "sim_mlp_stat": (
            f"({B}, {M} x {M}, C {SC}), two passes",
            lambda: kernels.sim_mlp_batch_stats(*xs),
            lambda: ref.sim_mlp_batch_stats(*xs[:9], *xs[10:12]), None,
            sim_in, 2 * P * (3 * SC) * 2 + 2 * P * 2 * SC * SC
            + P * (13 + 15 * SC) * 2 * f32 + P * 6 * SC * f32, PEAK_BF16),
        "sim_mlp_backward": (
            f"({B}, {M} x {M}, C {SC}), three passes",
            lambda: kernels.sim_mlp_train_backward(*xs, st1, st2, argj, dsimr, dwmax),
            lambda: ref.sim_mlp_backward(*xs, st1, st2, argj, dsimr, dwmax), None,
            sim_in + (P + 2 * B * M * SC) * 4 + 2 * B * M * SC * 4,
            2 * P * (3 * SC + 2 * SC * SC) + (2 * P * 4 * SC * SC
                                              + P * (13 + 30 * SC)) * f32, PEAK_BF16),
    }


def knn_work(B, M, N, C, k, self_):
    """(bytes, operations) kNN must move and do: the points read once, the
    queries too unless they are the points, (distance, index) written once
    a result; 3 C operations a pair (C subtracts, C multiplies, C - 1 adds
    and the compare with the k-th distance)."""
    k = min(k, N)
    nbytes = (B * N * C + (0 if self_ else B * M * C) + 2 * B * M * k) * 4
    return nbytes, B * M * N * 3 * C


def fps_work(B, N, S):
    """(bytes, operations) of FPS: the cloud read once and the indices
    written once; 10 operations a point and step (3 subtracts, 3
    multiplies, 2 adds, the min and the compare of the argmax)."""
    return B * N * 12 + B * S * 4, B * (S - 1) * N * 10


def time_knn_fps_at_path_shapes(device, card):
    """kNN and FPS at every shape the driven paths launch them with
    (``probe_knn_fps``'s ``probe_knn`` and ``probe_fps``: each output bitwise
    against its plain version and a second run; kernel and plain timed with
    CUDA events, the kernels' device time under torch.profiler, FPS's time a
    step), with the bound (``bound`` of ``knn_work`` / ``fps_work``) and
    kNN's issue floor under its rounding rule (3 fp32 instructions a channel
    and pair, at ``ISSUE_FP32``). Prints one JSON line."""
    out = {"knn": probe_knn_fps.probe_knn(device, plain=True),
           "fps": probe_knn_fps.probe_fps(device, plain=True)}
    for row in out["knn"]:
        work = knn_work(row["B"], row["M"], row["N"], row["C"], row["k"], row["self"])
        row["bound_ms"], row["bound_by"] = bound(*work)
        row["issue_floor_ms"] = work[1] / ISSUE_FP32 * 1e3
    for row in out["fps"]:
        row["bound_ms"], row["bound_by"] = bound(*fps_work(row["B"], row["N"], row["S"]))
    print(f"knn_fps_path_shapes on {card}: {json.dumps(out)}")
    return out


def time_kernels(device, card, emd_case):
    """Each kernel against its plain version and the library call where
    there is one, in the order plain, library, kernel, kernel, library,
    plain (CUDA events, ``_iters``'s window each), each the mean of its two
    windows; the card's clocks, power and temperature before and after."""
    clocks = "clocks.sm,clocks.mem,power.draw,temperature.gpu"
    print(f"time_kernels: clocks before {card_line(clocks)}")
    out = {}
    cases = {**timing_cases(device), **backward_timing_cases(device),
             **geometry_timing_cases(device, emd_case), **dcp_timing_cases(device),
             **dcp_train_timing_cases(device), **idam_timing_cases(device),
             **idam_train_timing_cases(device)}
    for key, (shape, kern, plain, lib, nbytes, ops, *peak) in cases.items():
        fns = {"plain": plain, "library": lib, "kernel": kern}
        its = {which: _iters(fn) for which, fn in fns.items() if fn}
        runs = {which: [] for which in its}
        for which in ("plain", "library", "kernel", "kernel", "library", "plain"):
            if which in its:
                runs[which].append(time_cuda(fns[which], *its[which]))
        lib_ms = sum(runs["library"]) / 2 if lib else None
        bound_ms, bound_by = bound(nbytes, ops, *peak)
        out[key] = {"ms": sum(runs["kernel"]) / 2, "plain_ms": sum(runs["plain"]) / 2,
                    "library_ms": lib_ms, "bound_ms": bound_ms, "bound_by": bound_by}
        print(f"{KERNELS[key]['name']} {shape}: kernel {runs['kernel']!r} ms, "
              f"plain {runs['plain']!r} ms, library call {runs.get('library')!r} ms "
              f"(plain, library, kernel, kernel, library, plain), "
              f"bound {bound_ms!r} ms ({bound_by}) on {card}")
    print(f"time_kernels: clocks after {card_line(clocks)}")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this smoke run needs one "
              "NVIDIA card", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    print(card)

    kernels.load()
    ptxas = [ln for ln in kernels.BUILD_LOG.splitlines()
             if "registers" in ln or "Compiling entry" in ln or "spill" in ln]
    print(f"kernel build: {kernels.BUILD_SECONDS!r} s (nvcc, sm_90a, one per "
          f"source in parallel) on {card}")
    for ln in ptxas:
        print(f"  {ln.strip()}")
    print_backward_resources()
    print_propagate_resources()

    max_abs = compare_kernels_with_plain(device)
    max_abs["knn"] = max(max_abs["knn"], compare_knn_across_tiles(device))
    max_abs.update(compare_backward_kernels_with_plain(device))
    geometry_err, emd_case = compare_geometry_kernels_with_plain(device)
    max_abs.update(geometry_err)
    print_emd_plan(device, card)
    max_abs.update(compare_dcp_kernels_with_plain(device))
    max_abs.update(compare_dcp_train_kernels_with_plain(device))
    for err in (compare_idam_kernels_with_plain(device),
                compare_idam_train_kernels_with_plain(device)):
        max_abs.update({k: max(v, max_abs.get(k, 0.0)) for k, v in err.items()})

    paths = {}           # path -> its launch counts
    pcn = load_config(PCN_CFG)
    val, preds, paths["PCN eval"] = drive_path("PCN", pcn, device,
                                               expected_counts(pcn, {}))
    step, first = check_metrics("PCN", pcn, device, val, preds)
    check_pcn_batch_on_cpu(pcn, step, first)
    check_f1_near(device, first)

    ecg = load_config(ECG_CFG)
    val, preds, paths["ECG eval"] = drive_path(
        "ECG", ecg, device, expected_counts(ecg, ECG_PER_BATCH))
    step, first = check_metrics("ECG", ecg, device, val, preds)
    check_batch_on_cpu_as_cloud("ECG", ecg, step, first)

    vrc = load_config(VRCNET_CFG)
    val, preds, paths["VRCNet eval"] = drive_path(
        "VRCNet", vrc, device, expected_counts(vrc, VRCNET_PER_BATCH))
    step, first = check_metrics("VRCNet", vrc, device, val, preds)
    check_batch_on_cpu_as_cloud("VRCNet", vrc, step, first)
    pcn_emd = load_config(PCN_CFG, eval_emd=True)
    paths["PCN eval_emd"] = drive_emd_val("PCN", pcn_emd, device)
    dcp = load_config(DCP_CFG)
    val, poses, paths["DCP eval"] = drive_registration_path("DCP", dcp, device,
                                                            DCP_PER_BATCH)
    step, first = check_registration_results("DCP", dcp, device, val, poses)
    check_dcp_batch_on_cpu(dcp, step, first)
    idam_cfg = load_config(IDAM_CFG)
    val, poses, paths["IDAM eval"] = drive_registration_path("IDAM", idam_cfg, device,
                                                             IDAM_PER_BATCH)
    _, first = check_registration_results("IDAM", idam_cfg, device, val, poses)
    check_idam_batch_on_cpu(idam_cfg, device, first)
    # before the train paths, as the eval-only runs of earlier versions
    time_passes("PCN", pcn, device, card)
    time_passes("ECG", ecg, device, card)
    time_passes("VRCNet", vrc, device, card)
    time_passes("PCN with eval_emd", pcn_emd, device, card, repeats=2)
    time_registration_passes("DCP", dcp, device, card)
    time_registration_passes("IDAM", idam_cfg, device, card)

    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    for name, path, per_step, per_val in (
            ("PCN", PCN_CFG, PCN_PER_STEP, {}),
            ("VRCNet", VRCNET_CFG, VRCNET_PER_STEP, VRCNET_PER_BATCH),
            ("ECG", ECG_CFG, ECG_PER_STEP, ECG_PER_BATCH)):
        cfg = load_config(path, nepoch=1)
        with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as log_dir:
            res, paths[f"{name} train"] = drive_train_path(
                name, lambda: engine.train_completion(
                    cfg, log_dir, DATA_DIR, max_steps_per_epoch=TRAIN_STEPS,
                    device=device),
                TRAIN_STEPS, _batches(cfg)[0], per_step,
                {**per_val, "chamfer": per_val.get("chamfer", 0) + 1})
            check_train_result(name, path, device, res, log_dir)
        del res
    dcp_train = load_config(DCP_CFG, nepoch=1)
    # the synthetic train split's 64 pairs: two steps of 32
    steps = min(TRAIN_STEPS, engine.registration_dataset(
        dcp_train, "train", REG_DATA_DIR).steps_per_epoch(
            BatchSpec(int(dcp_train.batch_size))))
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as log_dir:
        res, paths["DCP train"] = drive_train_path(
            "DCP", lambda: engine.train_registration(
                dcp_train, log_dir, REG_DATA_DIR, max_steps_per_epoch=steps,
                device=device),
            steps, _reg_batches(dcp_train)[0], DCP_PER_STEP, DCP_PER_BATCH)
        check_registration_train_result("DCP", DCP_CFG, device, res, log_dir,
                                        lambda m: m.emb_nn.fused_var3)
    del res
    idam_train = load_config(IDAM_CFG, nepoch=1)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as log_dir:
        res, paths["IDAM train"] = drive_train_path(
            "IDAM", lambda: engine.train_registration(
                idam_train, log_dir, REG_DATA_DIR, max_steps_per_epoch=steps,
                device=device),
            steps, _reg_batches(idam_train)[0], IDAM_PER_STEP, IDAM_PER_BATCH)
        check_registration_train_result("IDAM", IDAM_CFG, device, res, log_dir,
                                        lambda m: m.sim0_var2)
    del res
    # each train step against the CPU is read even when one before it fails;
    # a failure fails the run at its end
    failed = []
    for check_step, path in ((check_pcn_step_on_cpu, PCN_CFG),
                             (check_vrcnet_step_on_cpu, VRCNET_CFG),
                             (check_ecg_step_on_cpu, ECG_CFG),
                             (check_dcp_step_on_cpu, DCP_CFG),
                             (check_idam_step_on_cpu, IDAM_CFG)):
        try:
            check_step(load_config(path), device)
        except SmokeFailure as e:
            print(f"chip_smoke: FAILED: {e}")
            failed.append(str(e))
    check_completion_steps_rerun_bitwise(device)

    for name, cfg in (("PCN", pcn), ("VRCNet", vrc), ("ECG", ecg)):
        time_train_steps(name, cfg, card, *completion_step(cfg, device), "points")
    time_train_steps("DCP", dcp, card, *registration_step(dcp, device), "pairs", steps=3)
    time_train_steps("IDAM", idam_cfg, card, *registration_step(idam_cfg, device), "pairs",
                     steps=3)
    times = time_kernels(device, card, emd_case)
    time_knn_fps_at_path_shapes(device, card)
    time_sa_forward_at_path_shapes(device, card)
    time_sa_backward_at_path_shapes(device, card)
    time_scatter_at_ecg_shapes(device, card)
    time_gather_at_step_shapes(device, card)
    time_propagate_at_path_shape(device, card)

    launches = {k: sum(counts[k] for counts in paths.values()) for k in KERNELS}
    check(all(launches.values()), f"a kernel no driven path launched: {launches}")
    print(f"chip_smoke: {time.perf_counter() - t_start!r} s on {card}")
    print(json.dumps({"kernels": [
        dict(KERNELS[k], route="cuda",
             launches=launches[k],
             max_abs_err=max_abs[k], **times[k])
        for k in KERNELS]}))
    if failed:
        print(f"chip_smoke: {len(failed)} check(s) failed: {failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
