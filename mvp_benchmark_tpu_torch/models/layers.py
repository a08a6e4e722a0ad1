"""Shared building blocks for the ported models (port of
``mvp_benchmark_tpu/models/layers.py``, the subset PCN, ECG and VRCNet
use).

Layout: point features are channels-last, (B, N, C), as in the JAX package, so
the reference's 1x1 Conv1d stacks are Linear layers over the last axis.
Weights are stored torch-style, ``weight (out, in)``; the flax kernels they
are transplanted from are (in, out) (``models/transplant.py``).

Initialisation is torch's default for Linear/Conv: weight and bias both
U(-1/sqrt(fan_in), 1/sqrt(fan_in)), drawn from an explicit
``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from mvp_benchmark_tpu_torch import ops

# ---------------------------------------------------------------------------
# Activation-dtype policy (layers.py:41-65 of the JAX package)
# ---------------------------------------------------------------------------
#
# Parameters always stay fp32. Under a bfloat16 policy the Dense layers would
# compute and return bf16 activations, with coordinate heads pinned to fp32
# by ``dtype=torch.float32``. Every eval config runs fp32, its default; the
# bf16 mode (set only by the JAX package's train-step bench) comes with the
# training slice.

_COMPUTE_DTYPE = torch.float32


def set_compute_dtype(dtype: torch.dtype) -> None:
    global _COMPUTE_DTYPE
    _COMPUTE_DTYPE = dtype


def compute_dtype() -> torch.dtype:
    return _COMPUTE_DTYPE


def _uniform_(t: torch.Tensor, fan_in: int,
              generator: Optional[torch.Generator]) -> None:
    bound = 1.0 / math.sqrt(fan_in)
    with torch.no_grad():
        t.uniform_(-bound, bound, generator=generator)


class TorchDense(nn.Module):
    """Linear over the last axis == Conv1d(kernel=1) on channels-last input.

    ``dtype=None`` follows the activation policy; coordinate heads pass
    ``torch.float32``. The bias is added after the matmul, at the output
    dtype (JAX ``TorchDense``).
    """

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.empty(out_features)) if bias else None
        _uniform_(self.weight, in_features, generator)
        if self.bias is not None:
            _uniform_(self.bias, in_features, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype or compute_dtype()
        y = F.linear(x.to(dt), self.weight.to(dt))
        if self.bias is not None:
            y = y + self.bias.to(dt)
        return y


class MultiDense(nn.Module):
    """Several Dense heads over one input as one concatenated GEMM; returns
    the concatenated (..., sum(out_features)) output for the caller to slice
    (JAX ``MultiDense``, ``layers.py:121-170``).

    Head i keeps its own ``weight{i}`` (out_i, in) and ``bias{i}``, each
    initialised as a TorchDense of the same widths, as the flax module keeps
    ``kernel{i}``/``bias{i}``.
    """

    def __init__(self, in_features: int, out_features: Sequence[int],
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.heads = len(out_features)
        for i, f in enumerate(out_features):
            w = nn.Parameter(torch.empty(int(f), in_features))
            _uniform_(w, in_features, generator)
            setattr(self, f"weight{i}", w)
        for i, f in enumerate(out_features):
            b = nn.Parameter(torch.empty(int(f)))
            _uniform_(b, in_features, generator)
            setattr(self, f"bias{i}", b)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = compute_dtype()
        w = torch.cat([getattr(self, f"weight{i}") for i in range(self.heads)])
        b = torch.cat([getattr(self, f"bias{i}") for i in range(self.heads)])
        return F.linear(x.to(dt), w.to(dt)) + b.to(dt)


class DenseCat(nn.Module):
    """Linear over a virtual concat: ``cat(xs, -1) @ W.T == sum_i xs[i] @ W_i.T``.

    One weight of shape (out, sum(in_features)), sliced per input in order;
    the parts are summed in fp32 and the bias is added once, in fp32.
    Inputs may have broadcastable leading shapes, so a per-cloud global
    feature (B, 1, C) is multiplied once instead of once per point.
    """

    def __init__(self, in_features: Sequence[int], out_features: int,
                 bias: bool = True, dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.in_features = tuple(int(c) for c in in_features)
        self.dtype = dtype
        total = sum(self.in_features)
        self.weight = nn.Parameter(torch.empty(out_features, total))
        self.bias = nn.Parameter(torch.empty(out_features)) if bias else None
        _uniform_(self.weight, total, generator)
        if self.bias is not None:
            _uniform_(self.bias, total, generator)

    def forward(self, *xs: torch.Tensor) -> torch.Tensor:
        if tuple(x.shape[-1] for x in xs) != self.in_features:
            raise ValueError(f"DenseCat expects widths {self.in_features}, got "
                             f"{tuple(x.shape[-1] for x in xs)}")
        dt = self.dtype or compute_dtype()
        y = None
        off = 0
        for x, c in zip(xs, self.in_features):
            w = self.weight[:, off:off + c]
            off += c
            part = F.linear(x.to(dt), w.to(dt)).to(torch.float32)
            y = part if y is None else y + part
        if self.bias is not None:
            y = y + self.bias
        return y.to(dt)


_EDGE_MODES = ("center_neighbor", "neighbor_center", "center_minus")


class DenseEdge(nn.Module):
    """Linear over virtual DGCNN edge features, never materialising them.

    Computes ``cat(parts, -1) @ W.T`` for the edge layouts ``[x_i, x_j]``
    (``center_neighbor``), ``[x_j, x_i]`` (``neighbor_center``) and
    ``[x_i, x_j - x_i]`` (``center_minus``) by projecting the N points with
    the centre and neighbour halves of the weight first and gathering only
    the projected rows: Linear(gather(x)) == gather(Linear(x)). One weight
    (out, 2C) and one bias, as a TorchDense on the concatenated edge
    features (JAX ``DenseEdge``, ``layers.py:219-274``).

    x: (B, N, C), idx: (B, N, k) -> (B, N, k, out).
    """

    def __init__(self, in_features: int, out_features: int,
                 mode: str = "center_minus", bias: bool = True,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if mode not in _EDGE_MODES:
            raise ValueError(f"unknown mode {mode!r}")
        self.in_features = int(in_features)
        self.mode = mode
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_features, 2 * in_features))
        self.bias = nn.Parameter(torch.empty(out_features)) if bias else None
        _uniform_(self.weight, 2 * in_features, generator)
        if self.bias is not None:
            _uniform_(self.bias, 2 * in_features, generator)

    def forward(self, x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        dt = self.dtype or compute_dtype()
        C = self.in_features
        wa, wb = self.weight[:, :C], self.weight[:, C:]
        if self.mode == "center_neighbor":
            w_center, w_neigh = wa, wb
        elif self.mode == "neighbor_center":
            w_center, w_neigh = wb, wa
        else:
            w_center, w_neigh = wa - wb, wb
        xd = x.to(dt)
        center = F.linear(xd, w_center.to(dt))
        neigh = F.linear(xd, w_neigh.to(dt))
        y = center[:, :, None, :] + ops.grouping_operation(neigh, idx)
        if self.bias is not None:
            y = y + self.bias
        return y.to(dt)


def gen_grid_up(up_ratio: int, grid_size: float = 0.2,
                device: Optional[torch.device] = None) -> torch.Tensor:
    """2D folding grid, (up_ratio, 2) -- reference model_utils.py:140-153."""
    sqrted = int(math.sqrt(up_ratio)) + 1
    num_x, num_y = 1, up_ratio
    for i in reversed(range(1, sqrted + 1)):
        if up_ratio % i == 0:
            num_x = i
            num_y = up_ratio // i
            break
    grid_x = torch.linspace(-grid_size, grid_size, num_x, device=device)
    grid_y = torch.linspace(-grid_size, grid_size, num_y, device=device)
    x, y = torch.meshgrid(grid_x, grid_y, indexing="ij")
    return torch.stack([x, y], dim=-1).reshape(-1, 2)
