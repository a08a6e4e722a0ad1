"""IDAM registration model (port of ``mvp_benchmark_tpu/models/idam.py``):
the train, val and test branches.

Reference: ``registration/models/idam.py`` -- GNN edge-conv embedding on a
fixed 12-NN graph (:115-149), significance scores, hard point elimination to
N/6 (train: sampled by ground-truth-match probability, :19-25, :238-243;
eval: top-k, :245-248), 3 iterations of distance-augmented similarity-matrix
convolution + hybrid point elimination + weighted SVD (:267-342), auxiliary
negative-entropy / match / weight losses (:300-327).

On the card the path runs hand-written kernels: the GNN's self-kNN (k 12, on
tgt and then src), its five Propagate edge blocks on each cloud
(``ops.gnn_propagate``: the edge build, BatchNorm, relu, Dense and the max
over the neighbours in one kernel; in train its stat pass and backward
passes too) and the similarity MLP of each iteration (``ops.sim_mlp``; in
train its two stat passes and three backward passes). ``_batch_take`` is a
plain index, as in JAX. Selections follow JAX's: ``lax.top_k`` by a stable
descending sort (ties to the lower index), ``jnp.argmax``'s and
``jnp.argmin``'s first extremum, ``torch.median``'s lower middle.

The train branch samples the kept source points as JAX's
``jax.random.choice(replace=False, p=...)`` does, by the Gumbel top-k trick,
from an explicit ``torch.Generator`` on the CPU (``sample_src_idx``), or
takes them as ``src_idx``; the global RNG is never drawn from. The FPFH
descriptor (``use_fpfh``) is not ported: it raises ``NotImplementedError``.
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

MATCH_RADIUS = 0.05      # a source point matches when its gt pose lands this near
# Parameters whose train-mode gradient is zero in exact arithmetic: each adds
# a per-channel constant that what follows removes -- an edge block's bias and
# its ConvBlock's bias (the next Propagate's edge difference p_j - p_i; after
# the last one, the train-mode BatchNorms that the embeddings meet first), a
# similarity MLP's b2 (BatchNorm 2, and through wmax the weight ConvBlock's
# BatchNorm) and b4 (a shift of every logit, which the softmax and the
# argmax ignore but for the clip). Their computed gradients are rounding
# noise (the bf16 gather table), so the parity checks hold them against the
# whole gradient's norm.
SHIFT_INVARIANT = (".edge_b", ".conv.denses.0.bias", "_b2", "_b4")


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
        h, stats = ops.gnn_propagate(self.fc(x), idx, self.edge_W, self.edge_b,
                                     self.edge_scale, self.edge_bias, self.edge_mean,
                                     self.edge_var, train)
        if train:
            layers.update_running_stats(self.edge_mean, self.edge_var, stats[0], stats[1])
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


def _correspondences(sim: torch.Tensor) -> torch.Tensor:
    """Each kept source point's target, ``jnp.argmax``'s first maximum of
    its row of sim."""
    return torch.argmax(sim, dim=-1)


def _top_k_indices(score: torch.Tensor, k: int) -> torch.Tensor:
    """``lax.top_k``'s indices: the k largest, ties to the lower index (a
    stable descending sort; ``torch.topk`` promises no tie order)."""
    return torch.sort(score, dim=-1, descending=True, stable=True).indices[..., :k]


def _gt_matches(src: torch.Tensor, tgt: torch.Tensor, T_gt: torch.Tensor):
    """Each source point's nearest target point under the gt pose, by
    ``ops.square_distance`` (the expansion, as JAX's), and whether it lies
    within ``MATCH_RADIUS`` -> (min_idx (B, N), match (B, N) float)."""
    src_gt = torch.einsum("bij,bnj->bni", T_gt[:, :3, :3], src) + T_gt[:, None, :3, 3]
    d2, min_idx = ops.square_distance(src_gt, tgt).min(dim=-1)
    return min_idx, (torch.sqrt(d2) < MATCH_RADIUS).to(torch.float32)


def sample_src_idx(match_labels: torch.Tensor, num: int,
                   generator: torch.Generator) -> torch.Tensor:
    """The train branch's kept source points (JAX ``Model``'s ``sample``,
    reference idam.py:238-243): per cloud ``num // 2`` indices drawn without
    replacement with probabilities proportional to ``match + 1e-5`` and the
    rest with ``1 + 2e-5 - (match + 1e-5)``, concatenated (the two draws may
    share an index, as JAX's do). Each draw is ``jax.random.choice``'s Gumbel
    top-k: the k largest of ``log p + g``, g standard Gumbel from uniforms
    drawn on the CPU from ``generator`` (two (B, N) draws a call), so a card
    run and a CPU run take the same points. match_labels (B, N) float ->
    (B, num) int64, each draw in descending order of its key."""
    B, N = match_labels.shape
    n_pos = num // 2
    indicator = match_labels.to(torch.float32) + 1e-5
    pos_probs = indicator / indicator.sum(-1, keepdim=True)
    neg = 1.0 + 2e-5 - indicator
    neg_probs = neg / neg.sum(-1, keepdim=True)
    u = torch.rand((2, B, N), generator=generator).to(match_labels.device)
    gumbel = -torch.log(-torch.log(u))
    return torch.cat([_top_k_indices(gumbel[0] + torch.log(pos_probs), n_pos),
                      _top_k_indices(gumbel[1] + torch.log(neg_probs), num - n_pos)],
                     dim=1)


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
    are the train branch's); "train" returns them with the loss, the
    BatchNorms on batch statistics, which move the running ones (``0.9 ra +
    0.1 batch``, the biased variance). The train branch keeps the source
    points ``src_idx`` (B, N // 6) if given, else draws them from
    ``generator`` (``sample_src_idx``). One GNN serves tgt and src.
    The similarity MLPs' parameters and running statistics keep the flax
    names at the model's root: ``sim{i}_Wcat`` (2 emb + 4, 32), ``sim{i}_W2``,
    ``sim{i}_b2``, ``sim{i}_W3``, ``sim{i}_W4`` (32, 1), ``sim{i}_b4``,
    ``sim{i}_scale1/bias1/scale2/bias2`` and the buffers
    ``sim{i}_mean1/var1/mean2/var2``."""

    # engine.make_registration_train_step hands the train branch a generator
    samples_in_train = True

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
                T_gt: Optional[torch.Tensor] = None, prefix: str = "train",
                src_idx: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        train = prefix == "train"
        if train and T_gt is None:
            raise ValueError("IDAM's train branch needs T_gt")
        B, N, _ = src.shape
        pts = src
        tgt_embedding = self.gnn(tgt, train)
        src_embedding = self.gnn(src, train)
        src_sig_score = self.significance_fc(src_embedding, train).squeeze(-1)
        tgt_sig_score = self.significance_fc(tgt_embedding, train).squeeze(-1)

        M = N // 6
        if train:
            min_idx, match_full = _gt_matches(src, tgt, T_gt)
            if src_idx is None:
                if generator is None:
                    raise ValueError("IDAM's train branch draws its kept points from "
                                     "a torch.Generator: pass generator or src_idx")
                src_idx = sample_src_idx(match_full, M, generator)
            src_idx = src_idx.to(src.device).long()
            tgt_idx = torch.gather(min_idx, 1, src_idx)
            match_labels = torch.gather(match_full, 1, src_idx)
            src_sig_score = torch.gather(src_sig_score, 1, src_idx)
            tgt_sig_score = torch.gather(tgt_sig_score, 1, tgt_idx)
        else:
            src_idx = _top_k_indices(src_sig_score, M)
            tgt_idx = _top_k_indices(tgt_sig_score, M)
        src = _batch_take(src, src_idx)
        src_embedding = _batch_take(src_embedding, src_idx)
        tgt = _batch_take(tgt, tgt_idx)
        tgt_embedding = _batch_take(tgt_embedding, tgt_idx)

        R = torch.eye(3, dtype=torch.float32, device=src.device).expand(B, 3, 3)
        t = torch.zeros((B, 3), dtype=torch.float32, device=src.device)
        loss = torch.zeros((), dtype=torch.float32, device=src.device)
        eye = torch.arange(M, device=src.device)
        for i in range(self.num_iters):
            sim, wmax, stats = ops.sim_mlp(src, tgt, src_embedding, tgt_embedding,
                                           *self._sim(i), train)
            weights = self.weight_fcs[i](wmax, train).squeeze(-1)
            corr_idx = _correspondences(sim)
            if train:
                (st1, st2) = stats
                layers.update_running_stats(getattr(self, f"sim{i}_mean1"),
                                            getattr(self, f"sim{i}_var1"), st1[0], st1[1])
                layers.update_running_stats(getattr(self, f"sim{i}_mean2"),
                                            getattr(self, f"sim{i}_var2"), st2[0], st2[1])
                loss = loss + self._losses(i, sim, weights, corr_idx, eye, match_labels,
                                           src_sig_score, tgt_sig_score)
            src_corr = _batch_take(tgt, corr_idx)
            with torch.no_grad():       # JAX stops the pose's gradient
                weights = torch.sigmoid(weights)
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
        return loss, r_err, t_err, rmse, mse

    @staticmethod
    def _losses(i, sim, weights, corr_idx, eye, match_labels, src_sig_score,
                tgt_sig_score):
        """Iteration i's auxiliary losses (JAX ``Model``, reference
        idam.py:300-327): at i 0 the significance scores against the
        negative entropies of sim's rows and columns (targets without
        gradient); the match loss, -log of the matched pairs' row softmax
        over the matches; the weight loss, binary cross-entropy with logits
        of the weights against "the correspondence is the matched point"."""
        loss = torch.zeros((), dtype=torch.float32, device=sim.device)
        if i == 0:
            with torch.no_grad():
                p_src = torch.softmax(sim, dim=-1)
                p_tgt = torch.softmax(sim, dim=-2)
                src_neg_ent = torch.sum(p_src * torch.log(p_src), dim=-1)
                tgt_neg_ent = torch.sum(p_tgt * torch.log(p_tgt), dim=-2)
            loss = (torch.mean((src_sig_score - src_neg_ent) ** 2)
                    + torch.mean((tgt_sig_score - tgt_neg_ent) ** 2))
        diag = torch.diagonal(torch.softmax(sim, dim=-1), dim1=1, dim2=2)
        loss = loss + torch.sum(-torch.log(diag) * match_labels) / torch.sum(match_labels)
        labels = (corr_idx == eye[None, :]).to(torch.float32)
        return loss + torch.mean(torch.relu(weights) - weights * labels
                                 + torch.log1p(torch.exp(-torch.abs(weights))))
