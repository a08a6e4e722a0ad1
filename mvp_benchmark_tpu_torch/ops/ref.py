"""Plain PyTorch versions of the geometry ops (port of ``ops/jnp_ref.py``).

Each function here is the numerical contract of the CUDA kernel that
replaces it on the card (``ops/kernels.py``): the CPU path runs it, the CPU
tests hold it against the JAX package, and ``chip_smoke.py`` holds the kernel
against it on the card.

Arithmetic shared by every distance here: exact per-coordinate differences,
``d = d + diff_c * diff_c`` summed in channel order, each operation rounded
on its own -- the arithmetic of the reference CUDA ops and of ``csrc/*.cu``.
Unlike ``jnp_ref.square_distance`` nothing uses the |a|^2+|b|^2-2a.b
expansion, whose rounding moves near-tie neighbours and leaves self
distances that are not 0.
"""

from __future__ import annotations

from typing import Tuple

import torch

# Largest (B, M-chunk, N) distance matrix built at once, in elements: 1 GB of
# fp32 per intermediate (the kNN queries are chunked to stay under it).
_MAX_PAIRS = 1 << 28


def _sqdist(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """(B, M, C) x (B, N, C) -> (B, M, N) squared distances, exact
    per-coordinate differences summed in channel order."""
    d = None
    for c in range(q.shape[-1]):
        diff = q[:, :, None, c] - p[:, None, :, c]
        sq = diff * diff
        d = sq if d is None else d + sq
    return d


def chamfer_distance(
    a: torch.Tensor, b: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Bidirectional squared chamfer distance.

    a: (B, N, 3), b: (B, M, 3) float32 ->
      dist1 (B, N): min_j |a_i - b_j|^2, dist2 (B, M): min_i |b_j - a_i|^2,
      idx1 (B, N) int32 argmin over b, idx2 (B, M) int32 argmin over a.
    Ties go to the lower index.

    Distances are ``((dx*dx + dy*dy) + dz*dz)``, each operation rounded on
    its own: the arithmetic of the Pallas kernel (``pallas_kernels.py:100-103``),
    of the reference CUDA op and of ``csrc/chamfer.cu``. Materializes the
    (B, N, M) matrix; the kernel never does.
    """
    d = _sqdist(a, b)
    dist1, idx1 = torch.min(d, dim=2)
    dist2, idx2 = torch.min(d, dim=1)
    return dist1, dist2, idx1.to(torch.int32), idx2.to(torch.int32)


# ---------------------------------------------------------------------------
# kNN family
# ---------------------------------------------------------------------------


def knn(query: torch.Tensor, points: torch.Tensor,
        k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k nearest of each query row among ``points``, nearest first.

    query: (B, M, C), points: (B, N, C) float32 ->
      dist (B, M, k) exact squared distances, idx (B, M, k) int32,
    with k clamped to N. Selection is a stable ascending sort of the exact
    distances, so ties go to the lower index (``torch.topk``'s tie order on
    CUDA is unspecified). The contract of ``csrc/knn.cu``.
    """
    B, M, _ = query.shape
    N = points.shape[1]
    k = min(int(k), N)
    step = max(1, _MAX_PAIRS // max(1, B * N))
    dists, idxs = [], []
    for m0 in range(0, M, step):
        d = _sqdist(query[:, m0:m0 + step], points)
        d, i = torch.sort(d, dim=-1, stable=True)
        dists.append(d[..., :k])
        idxs.append(i[..., :k])
    return torch.cat(dists, 1), torch.cat(idxs, 1).to(torch.int32)


def knn_indices(points: torch.Tensor, k: int) -> torch.Tensor:
    """Self-kNN (self included), (B, N, C) -> idx (B, N, k) int32, nearest
    first (jnp_ref.knn_indices)."""
    return knn(points, points, k)[1]


def knn_points(query: torch.Tensor, points: torch.Tensor,
               k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, M, C) queries in (B, N, C) points -> (NEGATIVE squared distances,
    idx), both (B, M, k), nearest first (jnp_ref.knn_points's sign
    convention)."""
    d, idx = knn(query, points, k)
    return -d, idx


def knn_query(k: int, xyz: torch.Tensor, center_xyz: torch.Tensor) -> torch.Tensor:
    """The mm3d_pn2 ``knn`` layout: idx (B, k, M) of the k nearest points of
    ``xyz`` for each center (jnp_ref.knn_query)."""
    return knn(center_xyz, xyz, k)[1].transpose(1, 2)


def three_nn(target: torch.Tensor,
             source: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Three nearest source points of every target point -> (EUCLIDEAN
    distances (B, N, 3) ascending, idx (B, N, 3) int32) (jnp_ref.three_nn)."""
    d, idx = knn(target, source, 3)
    return torch.sqrt(d), idx


def upsampling_weights(dist: torch.Tensor) -> torch.Tensor:
    """Normalised inverse distances, with distances clamped at 1e-10
    (reference completion/model_utils.py:286-293)."""
    inv = 1.0 / torch.clamp(dist, min=1e-10)
    return inv / torch.sum(inv, dim=2, keepdim=True)


def three_nn_upsampling(target_points: torch.Tensor, source_points: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Indices + inverse-distance weights for 3-NN feature upsampling
    (jnp_ref.three_nn_upsampling)."""
    dist, idx = three_nn(target_points, source_points)
    return idx, upsampling_weights(dist)


# ---------------------------------------------------------------------------
# Gathers
# ---------------------------------------------------------------------------


def gather_points(features: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Row gather: (B, N, C) x (B, ...) int -> (B, ..., C), out[b, m] =
    features[b, idx[b, m]]. Serves both gather_points (B, M) and
    grouping_operation (B, M, K). The contract of ``gather_rows`` in
    ``csrc/gather.cu``."""
    B = features.shape[0]
    flat = idx.reshape(B, -1).long()
    rows = torch.arange(B, device=features.device)[:, None]
    return features[rows, flat].reshape(*idx.shape, features.shape[-1])


def grouping_operation(features: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, N, C) x (B, M, K) -> (B, M, K, C) (jnp_ref.grouping_operation)."""
    return gather_points(features, idx)


def group_max(features: torch.Tensor,
              idx: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Max over gathered neighbours with its argmax slot.

    features (B, N, C), idx (B, M, k) -> out (B, M, C) =
    max_j features[idx[:, :, j]], slot (B, M, C) int32 = the lowest j that
    reaches the max (a loop over j with a strict ``>``, as
    ``_group_max_fwd_kernel``, ``pallas_kernels.py:808-827``). The contract
    of ``group_max_forward`` in ``csrc/gather.cu``.
    """
    acc = slot = None
    for j in range(idx.shape[-1]):
        g = gather_points(features, idx[..., j])
        if acc is None:
            acc = g
            slot = torch.zeros(g.shape, dtype=torch.int32, device=g.device)
        else:
            better = g > acc
            slot = slot.masked_fill(better, j)
            acc = torch.where(better, g, acc)
    return acc, slot


def three_interpolate(features: torch.Tensor, idx: torch.Tensor,
                      weight: torch.Tensor) -> torch.Tensor:
    """Weighted 3-point interpolation: features (B, M, C), idx/weight
    (B, N, 3) -> (B, N, C), summed as ``((f0*w0 + f1*w1) + f2*w2)``
    (jnp_ref.three_interpolate; the contract of ``three_interpolate_forward``
    in ``csrc/gather.cu``)."""
    out = None
    for l in range(idx.shape[-1]):
        term = gather_points(features, idx[..., l]) * weight[..., l, None]
        out = term if out is None else out + term
    return out


# ---------------------------------------------------------------------------
# VRCNet SA block
# ---------------------------------------------------------------------------


def sa_attention(proj: torch.Tensor, x1: torch.Tensor, idx: torch.Tensor,
                 W1: torch.Tensor, W2: torch.Tensor, b2: torch.Tensor,
                 rel: int, mid: int, share: int) -> torch.Tensor:
    """The SA block between VRCNet's projection and output Denses.

    proj (B, N, rel+mid), x1 (B, N, rel), idx (B, N, k) int, W1
    ((1+k)*rel, ms), W2 (ms, k*ms), b2 (k*ms,) with ms = mid // share ->
    (B, N, mid), per point:

      w_in = relu([x1, proj[idx_0, :rel], ..., proj[idx_{k-1}, :rel]])
      w    = relu(w_in @ W1) @ W2 + b2, viewed as (k, ms)
      out[c] = sum_j w[j, c % ms] * proj[idx_j, rel + c]

    (the XLA fallback of ``models/vrcnet.py:100-108``; channel c takes
    ``w[:, c % ms]``, the ``jnp.tile(w, share)`` layout). W1 and W2 keep the
    flax (in, out) orientation. The contract of ``csrc/sa_attention.cu``,
    which sums in another order, so the two agree to a tolerance, not
    bitwise.
    """
    B, N, k = idx.shape
    ms = mid // share
    pn = gather_points(proj, idx)                        # (B, N, k, rel+mid)
    x2 = pn[..., :rel].reshape(B, N, k * rel)
    w_in = torch.relu(torch.cat([x1, x2], dim=-1))
    u = torch.relu(w_in @ W1)
    w = (u @ W2 + b2).reshape(B, N, k, ms).repeat(1, 1, 1, share)
    return torch.sum(w * pn[..., rel:], dim=2)


# ---------------------------------------------------------------------------
# Furthest point sampling
# ---------------------------------------------------------------------------


def furthest_point_sample(xyz: torch.Tensor, num_samples: int) -> torch.Tensor:
    """Greedy furthest point sampling, (B, N, 3) -> idx (B, num_samples) int32.

    The first index is 0; a running min-distance buffer (initialised to
    1e10) is updated against the last selected point with
    ``((dx*dx + dy*dy) + dz*dz)``, and the next index is its argmax, the
    first maximum on ties (jnp_ref.furthest_point_sample; the contract of
    ``csrc/fps.cu``).
    """
    B, N, _ = xyz.shape
    rows = torch.arange(B, device=xyz.device)
    out = torch.zeros((B, num_samples), dtype=torch.int32, device=xyz.device)
    dists = torch.full((B, N), 1e10, dtype=torch.float32, device=xyz.device)
    last = torch.zeros(B, dtype=torch.long, device=xyz.device)
    for i in range(1, num_samples):
        diff = xyz - xyz[rows, last][:, None, :]
        d = diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]
        d = d + diff[..., 2] * diff[..., 2]
        dists = torch.minimum(dists, d)
        last = torch.argmax(dists, dim=1)
        out[:, i] = last.to(torch.int32)
    return out
