"""IDAM registration model (port of ``mvp_benchmark_tpu/models/idam.py``),
eval: the val and test branches.

Reference: ``registration/models/idam.py`` -- GNN edge-conv embedding on a
fixed 12-NN graph (:115-149), significance scores, hard point elimination to
N/6 by top-k (:245-248), 3 iterations of distance-augmented similarity-matrix
convolution + hybrid point elimination + weighted SVD (:267-342).

On the card the path runs hand-written kernels: the GNN's self-kNN (k 12, on
tgt and then src), its five Propagate edge blocks on each cloud
(``ops.gnn_propagate``: the edge build, BatchNorm, relu, Dense and the max
over the neighbours in one kernel) and the similarity MLP of each iteration
(``ops.sim_mlp``). ``_batch_take`` is a plain index, as in JAX. Selections
follow JAX's: ``lax.top_k`` by a stable descending sort (ties to the lower
index), ``jnp.argmax``'s first maximum, ``torch.median``'s lower middle.

The train branch (``prefix="train"``: batch statistics, the sampled
elimination and the auxiliary losses) and the FPFH descriptor are not
ported yet: both raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from mvp_benchmark_tpu_torch import metrics, ops
from mvp_benchmark_tpu_torch.models import layers

KNN_K = 12
SIM_CHANNELS = 32
GNN_WIDTHS = (64, 64, 64, 64)       # then emb_dims

TRAIN_NOT_PORTED = (
    "IDAM's train branch is not yet ported to mvp_benchmark_tpu_torch: its "
    "kernels (sim_mlp's stat and backward passes, the Propagate block's "
    "batch statistics and backward) are the next slice's; the val and test "
    "branches run")


def _param(shape, fan_in: int, generator: Optional[torch.Generator]) -> nn.Parameter:
    p = nn.Parameter(torch.empty(shape))
    layers._uniform_(p, fan_in, generator)
    return p


class ConvBlock(nn.Module):
    """Dense (no bias) -> BatchNorm -> relu for every width but the last, then
    a Dense with bias, over the last axis (JAX ``ConvBlock``, reference
    idam.py:73-112). Flax names its children TorchDense_i and BatchNorm_i."""

    def __init__(self, in_features: int, channels: Sequence[int],
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        chs = tuple(int(c) for c in channels)
        ins = (int(in_features),) + chs[:-1]
        self.denses = nn.ModuleList(
            layers.TorchDense(i, c, bias=n == len(chs) - 1, generator=generator)
            for n, (i, c) in enumerate(zip(ins, chs)))
        self.bns = nn.ModuleList(layers.BatchNorm(c) for c in chs[:-1])

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        for dense, bn in zip(self.denses, self.bns):
            x = torch.relu(bn(dense(x), train))
        return self.denses[-1](x)


class Propagate(nn.Module):
    """Edge conv on a fixed neighbour graph (JAX ``Propagate``, reference
    idam.py:115-128): ``p = Dense(x)`` on the N points, then the fused edge
    block ``max_k Dense(relu(BN(p_j - p_i)))`` (``ops.gnn_propagate``), then
    ``ConvBlock((emb,))``. The edge block's parameters keep the flax names
    and orientation: ``edge_W`` (in, out), ``edge_b``, ``edge_scale``,
    ``edge_bias``, and its running statistics ``edge_mean``/``edge_var`` as
    buffers."""

    def __init__(self, in_features: int, emb_dims: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g, e = generator, emb_dims
        self.fc = layers.TorchDense(in_features, e, bias=False, generator=g)
        self.edge_W = _param((e, e), e, g)
        self.edge_b = _param((e,), e, g)
        self.edge_scale = nn.Parameter(torch.ones(e))
        self.edge_bias = nn.Parameter(torch.zeros(e))
        self.register_buffer("edge_mean", torch.zeros(e))
        self.register_buffer("edge_var", torch.ones(e))
        self.conv = ConvBlock(e, (e,), generator=g)

    def forward(self, x: torch.Tensor, idx: torch.Tensor,
                train: bool = False) -> torch.Tensor:
        h, _ = ops.gnn_propagate(self.fc(x), idx, self.edge_W, self.edge_b,
                                 self.edge_scale, self.edge_bias, self.edge_mean,
                                 self.edge_var, train)
        return self.conv(h, train)


class GNN(nn.Module):
    """Five Propagate layers on the self-12-NN graph, (B, N, 3) -> (B, N, emb)
    (JAX ``GNN``, reference idam.py:131-149)."""

    def __init__(self, emb_dims: int = 64, generator: Optional[torch.Generator] = None):
        super().__init__()
        widths = GNN_WIDTHS + (int(emb_dims),)
        ins = (3,) + widths[:-1]
        self.props = nn.ModuleList(Propagate(i, w, generator)
                                   for i, w in zip(ins, widths))

    def forward(self, pts: torch.Tensor, train: bool = False) -> torch.Tensor:
        idx = ops.knn_indices(pts, KNN_K)
        x = pts
        for prop in self.props:
            x = prop(x, idx, train)
        return x


def weighted_svd(src: torch.Tensor, src_corr: torch.Tensor, weights: torch.Tensor):
    """Weighted Kabsch head (JAX ``weighted_svd``, reference idam.py:152-188):
    src/src_corr (B, M, 3), weights (B, M) normalised -> R (B, 3, 3), t
    (B, 3), in fp32."""
    src_centered = src - src.mean(dim=1, keepdim=True)
    corr_centered = src_corr - src_corr.mean(dim=1, keepdim=True)
    H = torch.einsum("bmc,bmd->bcd", src_centered * weights[..., None], corr_centered)
    R = layers.symmetric_svd_rotation(H)
    t = (-torch.einsum("bij,bj->bi", R, torch.sum(weights[..., None] * src, dim=1))
         + torch.sum(weights[..., None] * src_corr, dim=1))
    return R, t


def _batch_take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, N, ...), idx (B, M) -> (B, M, ...), a plain index."""
    rows = torch.arange(x.shape[0], device=x.device)[:, None]
    return x[rows, idx.long()]


def _median_lower(x: torch.Tensor) -> torch.Tensor:
    """torch.median's lower middle order statistic over the last axis,
    keepdim (JAX ``_median_lower``)."""
    n = x.shape[-1]
    return torch.sort(x, dim=-1).values[..., (n - 1) // 2:(n - 1) // 2 + 1]


def _top_k_indices(score: torch.Tensor, k: int) -> torch.Tensor:
    """``lax.top_k``'s indices: the k largest, ties to the lower index (a
    stable descending sort; ``torch.topk`` promises no tie order)."""
    return torch.sort(score, dim=-1, descending=True, stable=True).indices[..., :k]


def build(args=None, generator: Optional[torch.Generator] = None) -> "Model":
    """Registry factory (JAX ``build``): emb_dims = descriptor_size (64
    unless set), num_iters (3 unless set); ``use_fpfh`` raises."""
    if args is not None and getattr(args, "use_fpfh", False):
        raise NotImplementedError(
            "IDAM with use_fpfh is not yet ported to mvp_benchmark_tpu_torch "
            "(the FPFH descriptor, models/fpfh.py of the JAX package)")
    emb = int(getattr(args, "descriptor_size", None) or 64)
    iters = int(getattr(args, "num_iters", None) or 3)
    return Model(emb_dims=emb, num_iters=iters, generator=generator)


class Model(nn.Module):
    """IDAM: forward(src, tgt, T_gt, prefix) like the JAX Model.

    prefix "test" (or T_gt None) returns T_12 (B, 4, 4); "val" returns
    (loss, r_err, t_err, rmse, mse) with a zero loss (the auxiliary losses
    are the train branch's); "train" raises. One GNN serves tgt and src.
    The similarity MLPs' parameters and running statistics keep the flax
    names at the model's root: ``sim{i}_Wcat`` (2 emb + 4, 32), ``sim{i}_W2``,
    ``sim{i}_b2``, ``sim{i}_W3``, ``sim{i}_W4`` (32, 1), ``sim{i}_b4``,
    ``sim{i}_scale1/bias1/scale2/bias2`` and the buffers
    ``sim{i}_mean1/var1/mean2/var2``."""

    def __init__(self, emb_dims: int = 64, num_iters: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g, e, C = generator, int(emb_dims), SIM_CHANNELS
        self.emb_dims, self.num_iters = e, int(num_iters)
        self.gnn = GNN(e, g)
        self.significance_fc = ConvBlock(e, (64, 32, 1), g)
        self.weight_fcs = nn.ModuleList(ConvBlock(C, (32, 1), g)
                                        for _ in range(self.num_iters))
        for i in range(self.num_iters):
            for name, shape, fan_in in (("Wcat", (2 * e + 4, C), 2 * e + 4),
                                        ("W2", (C, C), C), ("b2", (C,), C),
                                        ("W3", (C, C), C), ("W4", (C, 1), C),
                                        ("b4", (1,), C)):
                setattr(self, f"sim{i}_{name}", _param(shape, fan_in, g))
            for n in ("1", "2"):
                setattr(self, f"sim{i}_scale{n}", nn.Parameter(torch.ones(C)))
                setattr(self, f"sim{i}_bias{n}", nn.Parameter(torch.zeros(C)))
                self.register_buffer(f"sim{i}_mean{n}", torch.zeros(C))
                self.register_buffer(f"sim{i}_var{n}", torch.ones(C))

    def _sim(self, i: int):
        names = ("Wcat", "W2", "b2", "W3", "W4", "b4", "scale1", "bias1", "scale2",
                 "bias2", "mean1", "var1", "mean2", "var2")
        return tuple(getattr(self, f"sim{i}_{n}") for n in names)

    def forward(self, src: torch.Tensor, tgt: torch.Tensor,
                T_gt: Optional[torch.Tensor] = None, prefix: str = "train"):
        if prefix == "train":
            raise NotImplementedError(TRAIN_NOT_PORTED)
        B, N, _ = src.shape
        pts = src
        tgt_embedding = self.gnn(tgt)
        src_embedding = self.gnn(src)
        src_sig_score = self.significance_fc(src_embedding).squeeze(-1)
        tgt_sig_score = self.significance_fc(tgt_embedding).squeeze(-1)

        M = N // 6
        src_idx = _top_k_indices(src_sig_score, M)
        tgt_idx = _top_k_indices(tgt_sig_score, M)
        src = _batch_take(src, src_idx)
        src_embedding = _batch_take(src_embedding, src_idx)
        tgt = _batch_take(tgt, tgt_idx)
        tgt_embedding = _batch_take(tgt_embedding, tgt_idx)

        R = torch.eye(3, dtype=torch.float32, device=src.device).expand(B, 3, 3)
        t = torch.zeros((B, 3), dtype=torch.float32, device=src.device)
        for i in range(self.num_iters):
            sim, wmax, _ = ops.sim_mlp(src, tgt, src_embedding, tgt_embedding,
                                       *self._sim(i), False)
            weights = torch.sigmoid(self.weight_fcs[i](wmax).squeeze(-1))
            corr_idx = torch.argmax(sim, dim=-1)
            src_corr = _batch_take(tgt, corr_idx)
            weights = weights * (weights >= _median_lower(weights)).to(torch.float32)
            weights = weights / (weights.sum(-1, keepdim=True) + 1e-8)
            rotation_ab, translation_ab = weighted_svd(src, src_corr, weights)
            src = (torch.einsum("bij,bnj->bni", rotation_ab, src)
                   + translation_ab[:, None, :])
            R = torch.matmul(rotation_ab, R)
            t = torch.einsum("bij,bj->bi", rotation_ab, t) + translation_ab

        T = metrics.rt_to_transformation(R, t[..., None])
        if T_gt is None:
            return T
        R_gt, t_gt = T_gt[:, :3, :3], T_gt[:, :3, 3]
        mse = (metrics.rotation_geodesic_error(R, R_gt)
               + metrics.translation_error(t, t_gt))
        r_err = metrics.rotation_error(R, R_gt)
        t_err = metrics.translation_error(t, t_gt)
        rmse = metrics.rmse_loss(pts, T, T_gt)
        loss = torch.zeros((), dtype=torch.float32, device=src.device)
        return loss, r_err, t_err, rmse, mse
