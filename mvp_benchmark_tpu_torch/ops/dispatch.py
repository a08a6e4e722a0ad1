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
    first (see ref.knn_points). On the card the distances are the kernel's,
    with no graph; where autograd needs them they are recomputed from the
    neighbours gathered at idx, as ``pallas_kernels.knn_points`` does
    (``:771-787``): the gather kernel, whose backward is scatter_add_rows,
    then ``sum_c (q_c - p_c)^2`` with each operation rounded on its own,
    bitwise the kernel's distance. A caller that wants only idx passes
    detached tensors and launches the kNN alone."""
    if _route(query, points) == "cpu":
        return ref.knn_points(query, points, k)
    d, idx = kernels.knn(query.detach().contiguous(), points.detach().contiguous(), k)
    if torch.is_grad_enabled() and (query.requires_grad or points.requires_grad):
        diff = query[:, :, None, :] - gather_points(points, idx)   # (B, M, k, C)
        sq = diff * diff
        d = sq[..., 0]
        for c in range(1, sq.shape[-1]):
            d = d + sq[..., c]
    return -d, idx


def knn_indices(points: torch.Tensor, k: int) -> torch.Tensor:
    """Self-kNN (see ref.knn_indices)."""
    return _knn(points, points, k)[1]


def three_nn(target: torch.Tensor, source: torch.Tensor):
    """Top-3 NN -> (sqrt distances, idx), neither differentiable (see
    ref.three_nn)."""
    if _route(target, source) == "cuda":
        d, idx = kernels.knn(target.contiguous(), source.contiguous(), 3)
        return torch.sqrt(d), idx
    return ref.three_nn(target, source)


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


def ball_query(min_radius: float, max_radius: float, nsample: int,
               xyz: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """Fixed-size radius neighbourhoods, first-hit fill -> (B, M, nsample)
    int32, no gradient (see ref.ball_query)."""
    if _route(xyz, centers) == "cuda":
        return kernels.ball_query(min_radius, max_radius, nsample,
                                  xyz.detach().contiguous(),
                                  centers.detach().contiguous())
    return ref.ball_query(min_radius, max_radius, nsample, xyz, centers)


def emd_auction(xyz1: torch.Tensor, xyz2: torch.Tensor, eps: float = 0.005,
                iters: int = 50):
    """Auction EMD -> (dist (B, n), assignment (B, n) int32), the gradient to
    xyz1 only (see ref.emd_auction). On the card the assignment is the
    auction kernel's; the distances are plain torch on either device."""
    if _route(xyz1, xyz2) == "cpu":
        return ref.emd_auction(xyz1, xyz2, eps, iters)
    ref.emd_validate(xyz1, xyz2)
    assignment = kernels.emd_assignment(xyz1.detach().contiguous(),
                                        xyz2.detach().contiguous(), eps, iters)
    return ref.emd_distance(xyz1, xyz2, assignment), assignment


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              scale: float) -> torch.Tensor:
    """softmax(q k^T * scale) v, q (B, Nq, D), k (B, M, D), v (B, M, Dv)
    (see ref.attention). On the card: bf16 with D = Dv = 128, or fp32 with
    D % 32 == 0 and Dv = 3 (the svd head), the backward with D = 512; the
    backward kernels run for the inputs that need a gradient (see
    ref.attention_backward)."""
    if _route(q, k, v) == "cuda":
        return kernels.AttentionFunction.apply(q.contiguous(), k.contiguous(),
                                               v.contiguous(), float(scale))
    return ref.attention(q, k, v, scale)


def attention_bnhd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   scale: float) -> torch.Tensor:
    """Attention per head over (B, N, H, dk), read in place on the card: the
    heads may be slices of a wider fused projection row (see
    ref.attention_bnhd)."""
    if _route(q, k, v) == "cuda":
        return kernels.AttentionBnhdFunction.apply(q, k, v, float(scale))
    return ref.attention_bnhd(q, k, v, scale)


def edge_mlp_eval(a1: torch.Tensor, Ws, gammas, betas, means, variances):
    """DGCNN's per-edge chain with running statistics, a1 (B, N, k, 6) ->
    the four per-layer max-pools over k (see ref.edge_mlp_eval). No
    gradient: eval runs under ``torch.inference_mode``."""
    if _route(a1, *Ws, *gammas, *betas, *means, *variances) == "cuda":
        return kernels.edge_mlp_forward(a1.contiguous(), Ws, gammas, betas, means,
                                        variances)
    return ref.edge_mlp_eval(a1, Ws, gammas, betas, means, variances)


def edge_mlp_train(a1: torch.Tensor, Ws, gammas, betas):
    """DGCNN's per-edge chain with batch statistics, a1 (B, N, k, 6) ->
    (the four max-pools over k, the four (2, ch) [mean, biased variance]),
    differentiable in a1, Ws, gammas and betas (see ref.edge_mlp_train). On
    the card: the stat, final and backward passes of the kernel."""
    params = (*Ws, *gammas, *betas)
    if _route(a1, *params) == "cuda":
        out = kernels.EdgeMlpTrainFunction.apply(a1.contiguous(), *params)
        return tuple(out[:4]), tuple(out[4:])
    return ref.edge_mlp_train(a1, Ws, gammas, betas)


def gnn_propagate(p: torch.Tensor, idx: torch.Tensor, W, b, gamma, beta, mean, var,
                  train: bool, lst=None):
    """IDAM's Propagate edge block (reference idam.py:115-128; JAX
    ``dispatch.gnn_propagate``), p (B, N, C) projected features and idx
    (B, N, k) neighbours -> (x (B, N, C), stats): in eval with the running
    statistics (see ref.gnn_propagate_eval) and stats None, under
    ``torch.inference_mode``; in train with the batch statistics, stats the
    (2, C) [mean, biased var] of the edges, differentiable in p, W, b, gamma
    and beta (see ref.gnn_propagate_train; on the card the stat, final and
    backward passes of the kernel). ``lst``, the reverse list of idx from
    ``gnn_propagate_list`` (None on the CPU), is handed to the card's
    backward, so that the layers sharing one graph share one list; the CPU
    path ignores it."""
    if train:
        if _route(p, idx, W, b, gamma, beta) == "cuda":
            order, off = (None, None) if lst is None else lst
            return kernels.GnnPropagateTrainFunction.apply(
                p.contiguous(), idx.to(torch.int32).contiguous(), W, b, gamma, beta,
                order, off)
        return ref.gnn_propagate_train(p, idx, W, b, gamma, beta)
    if _route(p, idx, W, b, gamma, beta, mean, var) == "cuda":
        return kernels.gnn_propagate_forward(
            p.contiguous(), idx.to(torch.int32).contiguous(), W, b, gamma, beta, mean,
            var), None
    return ref.gnn_propagate_eval(p, idx, W, b, gamma, beta, mean, var), None


def gnn_propagate_list(idx: torch.Tensor, num_points: int):
    """The reverse list of IDAM's neighbour graph idx (B, N, k) for the
    backwards of the Propagate layers that share it (``gnn_propagate``'s
    ``lst``): on the card ``kernels.gnn_propagate_list``, built once a
    graph and step; None on the CPU, whose backward needs no list."""
    if _route(idx) == "cuda":
        return kernels.gnn_propagate_list(idx.to(torch.int32).contiguous(), num_points)
    return None


def sim_mlp(src, tgt, semb, temb, Wcat, W2, b2, W3, W4, b4, g1, be1, g2, be2,
            mean1, var1, mean2, var2, train: bool):
    """IDAM's similarity-matrix MLP (reference idam.py:267-279; JAX
    ``dispatch.sim_mlp``) -> (sim (B, M, M), wmax (B, M, C), stats): in eval
    with the running statistics (see ref.sim_mlp_eval) and stats None; in
    train with the batch statistics, stats (st1, st2) the two (2, C) [mean,
    biased var], differentiable in the embeddings and parameters, not in the
    positions (see ref.sim_mlp_train). On the card the per-point projections
    are a plain product and the pairwise chain the kernel (the stat, final
    and backward passes in train); the bias and clip are plain torch on
    either device."""
    args = (src, tgt, semb, temb, Wcat, W2, b2, W3, W4, b4, g1, be1, g2, be2)
    stats = (mean1, var1, mean2, var2)
    if _route(*args, *(() if train else stats)) == "cpu":
        if train:
            return ref.sim_mlp_train(*args)
        return (*ref.sim_mlp_eval(*args, *stats), None)
    sp, tp = ref.sim_projections(semb, temb, Wcat)
    w0, wxyz = ref.sim_mlp_split(Wcat, semb.shape[-1])
    pos = (src.detach().to(torch.float32).contiguous(),
           tgt.detach().to(torch.float32).contiguous())
    if train:
        simr, wmax, st1, st2 = kernels.SimMlpTrainFunction.apply(
            sp.contiguous(), tp.contiguous(), *pos, w0, wxyz, W2, b2, W3, W4, g1, be1,
            g2, be2)
        return ref.sim_logits(simr, b4), wmax, (st1, st2)
    simr, wmax = kernels.sim_mlp_forward(sp, tp, *pos, w0, wxyz, W2, b2, W3, W4, g1,
                                         be1, g2, be2, *stats)
    return ref.sim_logits(simr, b4), wmax, None
