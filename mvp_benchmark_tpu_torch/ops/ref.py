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
distances that are not 0 -- but ``square_distance``, which is that
expansion, for IDAM's ground-truth matches, where the JAX model uses it.
"""

from __future__ import annotations

import warnings
from typing import List, Optional, Tuple

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


def chamfer_backward(a: torch.Tensor, b: torch.Tensor, i1: torch.Tensor,
                     g1: torch.Tensor, i2: torch.Tensor, g2: torch.Tensor,
                     need_a: bool = True, need_b: bool = True):
    """Gradients of ``chamfer_distance(a, b)``'s (dist1, dist2) given their
    cotangents g1 (B, N) and g2 (B, M) -> (da or None, db or None), the XLA
    form of ``pallas_kernels.py:442-450``:

      da = 2 g1 (a - b[i1]) - scatter_{i2}(2 g2 (b - a[i2]))
      db = 2 g2 (b - a[i2]) - scatter_{i1}(2 g1 (a - b[i1]))

    Each term is ``(2 g) * (p - q)``, each operation rounded on its own; the
    sums of the scatter are taken in index order, on the CPU here and by
    ``chamfer_backward`` in ``csrc/chamfer.cu`` (over ``reverse_list``)."""
    diff1 = 2.0 * g1[..., None] * (a - gather_points(b, i1))
    diff2 = 2.0 * g2[..., None] * (b - gather_points(a, i2))
    da = diff1 - scatter_add_rows(diff2, i2, a.shape[1]) if need_a else None
    db = diff2 - scatter_add_rows(diff1, i1, b.shape[1]) if need_b else None
    return da, db


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
    distances (B, N, 3) ascending, idx (B, N, 3) int32) (jnp_ref.three_nn).

    Neither output carries a gradient, as in ``jnp_ref.three_nn`` and the
    reference CUDA op: an upsampling from an FPS subset always meets zero
    distances, where sqrt's derivative is infinite."""
    d, idx = knn(target.detach(), source.detach(), 3)
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


def square_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., N, D) x (..., M, D) -> (..., N, M) squared distances by the
    expansion ``|a|^2 + |b|^2 - 2 a.b``, clamped at 0
    (``jnp_ref.square_distance``): IDAM's train branch finds its
    ground-truth matches with it. A plain product on either device."""
    a2 = (a * a).sum(dim=-1, keepdim=True)
    b2 = (b * b).sum(dim=-1, keepdim=True)
    inner = torch.einsum("...nd,...md->...nm", a, b)
    return torch.clamp(a2 + b2.transpose(-1, -2) - 2.0 * inner, min=0.0)


def _check_range(idx: torch.Tensor, n: int) -> None:
    if idx.numel() and (int(idx.min()) < 0 or int(idx.max()) >= n):
        raise IndexError(f"index outside [0, {n}): "
                         f"[{int(idx.min())}, {int(idx.max())}]")


def scatter_add_rows(g: torch.Tensor, idx: torch.Tensor,
                     num_rows: int) -> torch.Tensor:
    """The backward of ``gather_points``: g (B, ..., C) fp32 with idx
    (B, ...) in [0, num_rows) -> out (B, num_rows, C),
    ``out[b, idx[b, m]] += g[b, m]`` (``pallas_kernels.scatter_add_rows``
    at fp32). An index out of range raises. The contract of
    ``scatter_add_rows`` in ``csrc/gather.cu``, which sums each row in
    ascending m over ``reverse_list``, as ``index_add_`` does on the CPU."""
    B, C = g.shape[0], g.shape[-1]
    _check_range(idx, num_rows)
    flat = idx.reshape(B, -1).long()
    flat = flat + torch.arange(B, device=g.device)[:, None] * num_rows
    out = torch.zeros((B * num_rows, C), dtype=torch.float32, device=g.device)
    out.index_add_(0, flat.reshape(-1), g.reshape(-1, C).to(torch.float32))
    return out.reshape(B, num_rows, C)


def reverse_list(idx: torch.Tensor, num_rows: int):
    """The reverse list of an index: idx (B, M[, k]) int -> (order (B E),
    off (B num_rows + 1)) int32, E = M k entries a cloud, with
    ``order[off[b num_rows + r]:off[b num_rows + r + 1]]`` the entries
    ``b E + e`` of the flattened index that name row r of cloud b,
    ascending (a stable sort by int32 key ``b num_rows + row``). An entry
    outside [0, num_rows) is listed under row 0 of its cloud. Index
    bookkeeping, not arithmetic: the gathers that replace the completion
    backwards' scatters walk it, and ``csrc/reverse_list.cu`` builds the
    same list on the card."""
    B = idx.shape[0]
    rows = idx.reshape(B, -1).long()
    if B * num_rows >= 2 ** 31 or rows.numel() >= 2 ** 31:
        raise ValueError(f"{B} x {num_rows} rows or {rows.numel()} entries exceed int32")
    rows = torch.where((rows >= 0) & (rows < num_rows), rows, 0)
    keys = (rows + torch.arange(B, device=idx.device)[:, None] * num_rows).to(torch.int32)
    sorted_keys, order = torch.sort(keys.reshape(-1), stable=True)
    bounds = torch.arange(B * num_rows + 1, dtype=torch.int32, device=idx.device)
    off = torch.searchsorted(sorted_keys, bounds, out_int32=True)
    return order.to(torch.int32), off


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


def group_max_backward(g: torch.Tensor, idx: torch.Tensor, slot: torch.Tensor,
                       num_rows: int) -> torch.Tensor:
    """The backward of ``group_max``: g (B, M, C), idx (B, M, k), slot
    (B, M, C) -> d_features (B, num_rows, C) with
    ``d_features[b, idx[b, m, slot[b, m, c]], c] += g[b, m, c]``: the whole
    gradient goes to the lowest slot reaching the max, as
    ``_group_max_bwd_kernel`` (``pallas_kernels.py:830``) routes it. The
    contract of ``group_max_backward`` in ``csrc/gather.cu``."""
    B, M, C = g.shape
    _check_range(slot, idx.shape[-1])
    src = torch.gather(idx.long(), 2, slot.long())             # (B, M, C)
    _check_range(src, num_rows)
    flat = src * C + torch.arange(C, device=g.device)
    out = torch.zeros((B, num_rows * C), dtype=torch.float32, device=g.device)
    out.scatter_add_(1, flat.reshape(B, M * C), g.reshape(B, M * C))
    return out.reshape(B, num_rows, C)


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


def three_interpolate_backward(g: torch.Tensor, idx: torch.Tensor,
                               weight: torch.Tensor, features: torch.Tensor,
                               need_w: bool = True):
    """The backward of ``three_interpolate`` for g (B, N, C) ->
    (d_features (B, Ms, C), d_weight (B, N, 3) or None), as
    ``_ti_bwd_kernel`` (``pallas_kernels.py:993``) computes them at fp32:

      d_features[idx[n, j]] += w[n, j] * g[n]     (a scatter)
      d_weight[n, j] = <g[n], features[idx[n, j]]>

    The contract of ``three_interpolate_backward`` in ``csrc/gather.cu``."""
    terms = g[:, :, None, :] * weight[..., None]              # (B, N, 3, C)
    d_features = scatter_add_rows(terms, idx, features.shape[1])
    d_weight = None
    if need_w:
        d_weight = torch.sum(gather_points(features, idx) * g[:, :, None, :], -1)
    return d_features, d_weight


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


def sa_attention_backward(g: torch.Tensor, proj: torch.Tensor, x1: torch.Tensor,
                          idx: torch.Tensor, W1: torch.Tensor, W2: torch.Tensor,
                          b2: torch.Tensor, rel: int, mid: int, share: int):
    """The backward of ``sa_attention`` for g (B, N, mid) -> (d_proj, d_x1,
    dW1, dW2, db2), the semantics of ``_sa_bwd_kernel``
    (``pallas_kernels.py:1241-1319``) at fp32. Per point, with the forward
    recomputed (w_in, u, w as in ``sa_attention``; q = c % ms):

      d_w[j, q] = sum_{c % ms = q} g[c] proj[idx_j, rel + c]
      d_proj[idx_j, rel + c] += w[j, q] g[c]
      db2 += d_w, dW2 += u^T d_w
      d_u = (d_w W2^T) * [u > 0], dW1 += w_in^T d_u
      d_cat = (d_u W1^T) * [cat > 0]
      d_x1 = d_cat[:rel], d_proj[idx_j, :rel] += d_cat[rel + j rel : ...]

    The contract of ``sa_attention_backward`` in ``csrc/sa_attention.cu``,
    which sums in another order (d_proj a gather over ``reverse_list``)."""
    B, N, k = idx.shape
    ms = mid // share
    pn = gather_points(proj, idx)                        # (B, N, k, rel+mid)
    cat = torch.cat([x1, pn[..., :rel].reshape(B, N, k * rel)], dim=-1)
    w_in = torch.relu(cat)
    u_pre = w_in @ W1
    u = torch.relu(u_pre)
    w = (u @ W2 + b2).reshape(B, N, k, ms)
    # channel c = s * ms + q of mid takes w[:, q]: fold the share groups
    d_w = (g[:, :, None, :] * pn[..., rel:]).reshape(B, N, k, share, ms).sum(3)
    d_mid = w.repeat(1, 1, 1, share) * g[:, :, None, :]     # (B, N, k, mid)
    d_w = d_w.reshape(B, N, k * ms)
    db2 = d_w.sum((0, 1))
    dW2 = u.reshape(-1, ms).T @ d_w.reshape(-1, k * ms)
    d_u = (d_w @ W2.T) * (u_pre > 0)
    dW1 = w_in.reshape(-1, (1 + k) * rel).T @ d_u.reshape(-1, ms)
    d_cat = (d_u @ W1.T) * (cat > 0)
    d_rel = d_cat[..., rel:].reshape(B, N, k, rel)
    d_proj = scatter_add_rows(torch.cat([d_rel, d_mid], dim=-1), idx, N)
    return d_proj, d_cat[..., :rel].contiguous(), dW1, dW2, db2


# ---------------------------------------------------------------------------
# Attention (DCP's transformer and svd head)
# ---------------------------------------------------------------------------


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              scale: float) -> torch.Tensor:
    """softmax(q k^T * scale) v over (B, Nq, D) queries, (B, M, D) keys and
    (B, M, Dv) values (Dv may differ from D) -> (B, Nq, Dv) in q's dtype.

    bf16 inputs: the arithmetic of ``_attn_math_fwd``
    (``pallas_kernels.py:2235-2249``): bf16 operands, fp32 scores, an exact
    fp32 softmax (row max, exp, row sum, divide), p rounded to bf16 before
    P.V, fp32 accumulation, one rounding of the output to bf16. fp32 inputs:
    fp32 throughout (the TPU kernel would round them to bf16; the port keeps
    its fp32 paths fp32, as its gathers and SA block do). The contract of
    ``csrc/attention.cu``, whose online softmax normalises at the end and so
    rounds p elsewhere: the two agree to a tolerance, not bitwise.
    """
    out_dtype = q.dtype
    bf16 = q.dtype == torch.bfloat16
    B, Nq, _ = q.shape
    M = k.shape[1]
    step = max(1, _MAX_PAIRS // max(1, Nq * M))
    outs = []
    for b0 in range(0, B, step):
        qb, kb, vb = (x[b0:b0 + step].to(torch.float32) for x in (q, k, v))
        s = torch.matmul(qb, kb.transpose(1, 2)) * scale
        e = torch.exp(s - s.amax(dim=-1, keepdim=True))
        p = e / e.sum(dim=-1, keepdim=True)
        if bf16:
            p = p.to(torch.bfloat16).to(torch.float32)
        outs.append(torch.matmul(p, vb).to(out_dtype))
    return torch.cat(outs, 0)


def attention_bnhd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   scale: float) -> torch.Tensor:
    """``attention`` per head over the projection-native layout: q
    (B, Nq, H, dk), k/v (B, M, H, dk) -> (B, Nq, H, dk), the semantics of
    ``fused_attention_bnhd`` (``pallas_kernels.py:2610``). The kernel reads
    the heads in place; this plain version moves them to the batch axis."""
    B, Nq, H, dk = q.shape
    M, dv = k.shape[1], v.shape[-1]

    def heads(x, n, d):
        return x.permute(0, 2, 1, 3).reshape(B * H, n, d)

    out = attention(heads(q, Nq, dk), heads(k, M, dk), heads(v, M, dv), scale)
    return out.reshape(B, H, Nq, dv).permute(0, 2, 1, 3).contiguous()


def attention_partials(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       scale: float, tile: int = 128):
    """Pass (a) of the svd head's forward kernel (``csrc/attention.cu``),
    fp32: for each tile of ``tile`` keys (the last one ragged), each query's
    max of the scaled scores s = q k^T * scale, sum of exp(s - max) and
    exp(s - max) . v. q (B, Nq, D), k (B, M, D), v (B, M, Dv) -> (m, l) of
    (B, T, Nq) and pv (B, T, Nq, Dv), T = ceil(M / tile).
    ``attention_combine`` of them gives ``attention`` and its row stats."""
    f32 = torch.float32
    qf = q.to(f32)
    ms, ls, pvs = [], [], []
    for j0 in range(0, k.shape[1], tile):
        s = torch.matmul(qf, k[:, j0:j0 + tile].to(f32).transpose(1, 2)) * scale
        m = s.amax(-1)
        e = torch.exp(s - m[..., None])
        ms.append(m)
        ls.append(e.sum(-1))
        pvs.append(torch.matmul(e, v[:, j0:j0 + tile].to(f32)))
    return torch.stack(ms, 1), torch.stack(ls, 1), torch.stack(pvs, 1)


def attention_combine(m: torch.Tensor, l: torch.Tensor, pv: torch.Tensor):
    """Pass (b) of the svd head's forward kernel: ``attention_partials``
    merged in key-tile order -> (out (B, Nq, Dv), row max (B, Nq), row sum
    (B, Nq)): row max = max_t m_t, w_t = exp(m_t - row max), row sum =
    sum_t l_t w_t, out = (sum_t pv_t w_t) / row sum."""
    row_max = m.amax(1)
    w = torch.exp(m - row_max[:, None])
    row_sum, o = l[:, 0] * w[:, 0], pv[:, 0] * w[:, 0, :, None]
    for t in range(1, m.shape[1]):
        row_sum = row_sum + l[:, t] * w[:, t]
        o = o + pv[:, t] * w[:, t, :, None]
    return o / row_sum[..., None], row_max, row_sum


def _heads(x: torch.Tensor) -> torch.Tensor:
    """(B, N, H, D) -> (B H, N, D)."""
    B, N, H, D = x.shape
    return x.permute(0, 2, 1, 3).reshape(B * H, N, D)


def _attention_p_ds(qb, kb, vb, ob, gb, row_max, row_sum, scale, bf16):
    """p and ds of a batch chunk, fp32 operands: p = exp(q k^T scale -
    row_max) / row_sum, ds = (p (d_out v^T - delta)) scale with delta =
    rowsum(d_out o); ds rounded to bf16 for bf16 inputs."""
    delta = (gb * ob).sum(dim=-1, keepdim=True)
    s = torch.matmul(qb, kb.transpose(1, 2)) * scale
    p = torch.exp(s - row_max[:, :, None]) / row_sum[:, :, None]
    dp = torch.matmul(gb, vb.transpose(1, 2))
    ds = (p * (dp - delta)) * scale
    if bf16:
        ds = ds.to(torch.bfloat16).to(torch.float32)
    return p, ds


def attention_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       o: torch.Tensor, row_max: torch.Tensor,
                       row_sum: torch.Tensor, d_out: torch.Tensor, scale: float):
    """Gradients (dq, dk, dv) of ``attention`` given its output ``o``, the
    softmax's final row max and row sum that the forward kernel saves, and
    the output's cotangent ``d_out``: the split backward of
    ``_attn_bwd_split`` (``pallas_kernels.py:2502``) step by step. Takes the
    (B, N, D) layout with row stats (B, Nq), or the heads layout (B, N, H, D)
    with row stats (B, H, Nq).

      delta = rowsum(d_out * o)                 fp32
      p     = exp(q k^T * scale - row_max) / row_sum
      dp    = d_out v^T
      ds    = (p * (dp - delta)) * scale        (``attention_backward_ds``)
      dq = ds k,  dk = ds^T q,  dv = p^T d_out

    bf16 inputs: bf16 operands and fp32 sums, p and ds rounded to bf16
    before their products (``_attn_bwd_dq_kernel`` :2308,
    ``_attn_bwd_dkv_kernel`` :2331), each gradient rounded once to its
    input's dtype. fp32 inputs: fp32 throughout, as the port's forward. The
    contract of ``csrc/attention_backward.cu``, which sums in another order:
    the two agree to a tolerance."""
    if q.dim() == 4:
        B, Nq, H, D = q.shape
        grads = attention_backward(_heads(q), _heads(k), _heads(v), _heads(o),
                                   row_max.reshape(B * H, Nq),
                                   row_sum.reshape(B * H, Nq), _heads(d_out), scale)
        return tuple(g.reshape(B, H, g.shape[1], g.shape[2]).permute(0, 2, 1, 3)
                     .contiguous() for g in grads)
    bf16 = q.dtype == torch.bfloat16
    f32 = torch.float32
    B, Nq, _ = q.shape
    M = k.shape[1]
    step = max(1, _MAX_PAIRS // max(1, Nq * M))
    dqs, dks, dvs = [], [], []
    for b0 in range(0, B, step):
        qb, kb, vb, ob, gb = (x[b0:b0 + step].to(f32) for x in (q, k, v, o, d_out))
        p, ds = _attention_p_ds(qb, kb, vb, ob, gb, row_max[b0:b0 + step],
                                row_sum[b0:b0 + step], scale, bf16)
        if bf16:
            p = p.to(torch.bfloat16).to(f32)
        dqs.append(torch.matmul(ds, kb).to(q.dtype))
        dks.append(torch.matmul(ds.transpose(1, 2), qb).to(k.dtype))
        dvs.append(torch.matmul(p.transpose(1, 2), gb).to(v.dtype))
    return torch.cat(dqs, 0), torch.cat(dks, 0), torch.cat(dvs, 0)


def attention_backward_ds(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          o: torch.Tensor, row_max: torch.Tensor,
                          row_sum: torch.Tensor, d_out: torch.Tensor, scale: float,
                          dv_block: Optional[int] = None):
    """Pass (a) of the svd head's backward kernel (``csrc/attention_backward.cu``):
    ds of ``attention_backward``, (B, Nq, M) fp32 (bf16-rounded values for
    bf16 inputs), and with ``dv_block`` also dv's partials over blocks of
    ``dv_block`` queries, (B, ceil(Nq / dv_block), M, Dv) fp32: p^T d_out
    over each block (p rounded to bf16 for bf16 inputs). dq = ds k, dk =
    ds^T q (``torch.matmul``, the plain version of pass (b)), and the
    partials summed over the blocks in order give ``attention_backward``'s
    gradients. The heads layout (B, N, H, D) gives ds (B, H, Nq, M) and
    partials (B, H, nb, M, Dv)."""
    if q.dim() == 4:
        B, Nq, H, D = q.shape
        res = attention_backward_ds(_heads(q), _heads(k), _heads(v), _heads(o),
                                    row_max.reshape(B * H, Nq),
                                    row_sum.reshape(B * H, Nq), _heads(d_out), scale,
                                    dv_block)
        if dv_block is None:
            return res.reshape(B, H, *res.shape[1:])
        return tuple(x.reshape(B, H, *x.shape[1:]) for x in res)
    bf16 = q.dtype == torch.bfloat16
    f32 = torch.float32
    B, Nq, _ = q.shape
    M = k.shape[1]
    step = max(1, _MAX_PAIRS // max(1, Nq * M))
    dss, parts = [], []
    for b0 in range(0, B, step):
        qb, kb, vb, ob, gb = (x[b0:b0 + step].to(f32) for x in (q, k, v, o, d_out))
        p, ds = _attention_p_ds(qb, kb, vb, ob, gb, row_max[b0:b0 + step],
                                row_sum[b0:b0 + step], scale, bf16)
        dss.append(ds)
        if dv_block is not None:
            if bf16:
                p = p.to(torch.bfloat16).to(f32)
            parts.append(torch.stack(
                [torch.matmul(p[:, i:i + dv_block].transpose(1, 2), gb[:, i:i + dv_block])
                 for i in range(0, Nq, dv_block)], 1))
    ds = torch.cat(dss, 0)
    return ds if dv_block is None else (ds, torch.cat(parts, 0))


# ---------------------------------------------------------------------------
# DGCNN's fused edge chain
# ---------------------------------------------------------------------------

EDGE_MLP_EPS = 1e-5


def bn_scale_shift(gammas, betas, means, variances):
    """Per-layer eval BatchNorm folded to one multiply-add per element:
    scale = gamma * rsqrt(var + eps), shift = beta - mean * scale, in fp32
    (``_em_bn_fast``, ``pallas_kernels.py:2759-2769``). Computed once per call
    and handed to both the kernel and ``edge_mlp_eval``, so the two share
    them bitwise. Returns ((scale, shift), ...) per layer."""
    out = []
    for g, b, m, var in zip(gammas, betas, means, variances):
        sc = g.to(torch.float32) * torch.rsqrt(var.to(torch.float32) + EDGE_MLP_EPS)
        out.append((sc, b.to(torch.float32) - m.to(torch.float32) * sc))
    return tuple(out)


def edge_mlp_eval(a1: torch.Tensor, Ws, gammas, betas, means, variances):
    """DGCNN's per-edge chain in eval mode, a1 (B, N, k, C1) edge features
    [x_j | x_i] -> the max over k of every layer's activations, one
    (B, N, ch_l) fp32 tensor a layer.

    Per layer: h = bf16(a) @ bf16(W) with fp32 accumulation, then
    relu(h * scale + shift) with the running-stat BatchNorm folded by
    ``bn_scale_shift``, then the max over k. That is
    ``edge_mlp_reference(train=False)`` (``pallas_kernels.py:3163-3193``) up
    to the folding's one reassociation rounding, which the TPU's own
    forward-only passes also take. The TPU kernel reads a slot-major
    (B, k, N, 8) tensor padded to 8 lanes; the port's a1 is (B, N, k, 6) as
    its gather gives it. The contract of ``csrc/edge_mlp.cu``, which sums the
    products in another order: the two agree to a tolerance.
    """
    ss = bn_scale_shift(gammas, betas, means, variances)
    a = a1
    xs = []
    for W, (sc, sh) in zip(Ws, ss):
        h = torch.matmul(a.to(torch.bfloat16).to(torch.float32),
                         W.to(torch.bfloat16).to(torch.float32))
        a = torch.relu(h * sc + sh)
        xs.append(a.amax(dim=2))
    return tuple(xs)


def edge_mlp_train(a1: torch.Tensor, Ws, gammas, betas, given=None):
    """DGCNN's per-edge chain in train mode, a1 (B, N, k, C1) -> (xs, stats):
    the max over k of every layer's activations, (B, N, ch_l) fp32, and the
    layers' batch statistics, (2, ch_l) [mean, biased variance], detached.
    ``given``: a (2, ch_l) [mean, variance] a layer to use by value instead
    of the batch's (``(stat - stat.detach()) + given``: exactly given's
    value, the gradient still flowing through the batch's own), and
    returned as its statistics.

    ``edge_mlp_reference(train=True)`` (``pallas_kernels.py:3163-3193``):
    bf16-rounded matmul inputs and fp32 sums; per layer the mean and
    ``max(E[h^2] - E[h]^2, 0)`` over all B N k edges (one pass, as JAX's);
    ``(h - mu) rsqrt(var + eps) gamma + beta``, relu, and the max over k.
    Differentiable by autograd, the gradient flowing through mu and var as
    JAX's does. ``torch.max`` routes a tied max's gradient to the first
    maximal slot, as the kernel does (the TPU kernel routes it to every tied
    slot, JAX's CPU autodiff splits it; relu's zero ties carry no gradient).
    The contract of the train passes of ``csrc/edge_mlp.cu``, which fold
    the BatchNorm to one scale and shift a channel and sum in another order:
    the two agree to a tolerance."""
    f32 = torch.float32
    a = a1
    xs, stats = [], []
    for W, g, b in zip(Ws, gammas, betas):
        h = torch.matmul(a.to(torch.bfloat16).to(f32), W.to(torch.bfloat16).to(f32))
        mu = h.mean(dim=(0, 1, 2))
        var = torch.clamp((h * h).mean(dim=(0, 1, 2)) - mu * mu, min=0.0)
        if given is not None:
            st = given[len(stats)].to(mu)
            mu = (mu - mu.detach()) + st[0]
            var = (var - var.detach()) + st[1]
        stats.append(torch.stack([mu, var]).detach())
        a = torch.relu((h - mu) * torch.rsqrt(var + EDGE_MLP_EPS) * g.to(f32)
                       + b.to(f32))
        xs.append(a.max(dim=2).values)
    return tuple(xs), tuple(stats)


def edge_mlp_slots(a1: torch.Tensor, Ws, gammas, betas, stats):
    """The chain with the batch statistics ``stats`` ((2, ch) [mean, var] a
    layer) folded by ``bn_scale_shift`` -> (xs, slots): the four max-pools
    (B, N, ch_l) fp32 and each one's first argmax slot, (B, N, 512) uint8.
    The contract of the train final pass of ``csrc/edge_mlp.cu``."""
    ss = bn_scale_shift(gammas, betas, [s[0] for s in stats], [s[1] for s in stats])
    a = a1
    xs, slots = [], []
    for W, (sc, sh) in zip(Ws, ss):
        h = torch.matmul(_bf16(a), _bf16(W))
        a = torch.relu(h * sc + sh)
        x, j = _first_max(a, 2)
        xs.append(x)
        slots.append(j.to(torch.uint8))
    return tuple(xs), torch.cat(slots, dim=-1)


def edge_mlp_stats_given(a1: torch.Tensor, Ws, gammas, betas, stats=None,
                         dtype=torch.float32):
    """Each layer's (2, ch_l) [mean, biased variance] of h over the edges,
    the activations rounded to bf16 before each product and the chain run
    in ``dtype``, the layers below folded by ``bn_scale_shift`` with the
    statistics ``stats`` ((2, ch) a layer; the last unused): what the stat
    pass of each layer in ``csrc/edge_mlp.cu`` computes given the
    statistics found before it, which it sums in another order. With
    ``stats`` None each layer's own statistics are folded into the layer
    above, found as the chain goes (in fp64: the DCP step check's truth)."""
    bf = torch.bfloat16
    a, out = a1, []
    for layer, (W, g, b) in enumerate(zip(Ws, gammas, betas)):
        h = torch.matmul(a.to(bf).to(dtype), W.to(bf).to(dtype))
        out.append(_batch_stats(h))
        m, v = (stats if stats is not None else out)[layer]
        (sc, sh), = bn_scale_shift([g], [b], [m], [v])
        a = torch.relu(h * sc + sh)
    return tuple(out)


def edge_mlp_backward(a1: torch.Tensor, Ws, gammas, betas, stats, slots, gxs):
    """The chain's backward in train mode from the forward's batch
    statistics and saved argmax slots and the max-pools' cotangents gxs ->
    (d_a1 (B, N, k, 6) fp32, dWs, dgammas, dbetas), as the TPU's five
    top-down passes compute it (``_em_bwd_kernel``,
    ``pallas_kernels.py:2858``): the chain recomputed with the folded
    BatchNorm (``edge_mlp_slots``); from the top, each max-pool's cotangent
    routed to its saved slot and added to the cotangent d carried from
    above; dy = that where the activation is positive; S = [sum dy, sum dy
    hhat] over the B N k edges; dh = gamma rsqrt(var + eps) ((dy - S0 / E) -
    hhat S1 / E); dW = bf16(a)^T bf16(dh) and d = bf16(dh) bf16(W)^T, fp32
    sums; dgamma = S1, dbeta = S0, d_a1 the last d. Autodiff of
    ``edge_mlp_train`` rounds the carried cotangent where the forward casts
    to bf16 instead of dh, and folds nothing: the two agree to a tolerance
    that grows as the batch of edges shrinks. The contract of the backward
    passes of ``csrc/edge_mlp.cu``."""
    f32 = torch.float32
    B, N, k, _ = a1.shape
    E = float(B * N * k)
    means, variances = [s[0] for s in stats], [s[1] for s in stats]
    a, ins, hs, pre = _bf16(a1), [], [], []
    for W, (sc, sh) in zip(Ws, bn_scale_shift(gammas, betas, means, variances)):
        ins.append(a)
        h = torch.matmul(a, _bf16(W))
        hs.append(h)
        pre.append(h * sc + sh)
        a = _bf16(torch.relu(pre[-1]))
    chs = [W.shape[1] for W in Ws]
    d, dWs, dgs, dbs = None, [None] * len(Ws), [None] * len(Ws), [None] * len(Ws)
    for l in range(len(Ws) - 1, -1, -1):
        off, ch = sum(chs[:l]), chs[l]
        route = torch.zeros((B, N, k, ch), dtype=f32, device=a1.device).scatter_(
            2, slots[..., off:off + ch].long()[:, :, None, :],
            gxs[l].to(f32)[:, :, None, :])
        dy = torch.where(pre[l] > 0, route if d is None else d + route, 0.0)
        rstd = torch.rsqrt(variances[l].to(f32) + EDGE_MLP_EPS)
        hhat = (hs[l] - means[l].to(f32)) * rstd
        S0, S1 = dy.sum(dim=(0, 1, 2)), (dy * hhat).sum(dim=(0, 1, 2))
        dh = _bf16((gammas[l].to(f32) * rstd) * ((dy - S0 / E) - hhat * (S1 / E)))
        dWs[l] = ins[l].reshape(-1, ins[l].shape[-1]).t() @ dh.reshape(-1, ch)
        d = dh @ _bf16(Ws[l]).t()
        dgs[l], dbs[l] = S1, S0
    return d, tuple(dWs), tuple(dgs), tuple(dbs)


# ---------------------------------------------------------------------------
# IDAM: the GNN's Propagate edge block and the similarity-matrix MLP
# ---------------------------------------------------------------------------
#
# Eval mode, running statistics. Arithmetic shared with csrc/gnn_propagate.cu
# and csrc/sim_mlp.cu: bf16-rounded product inputs summed in fp32 in channel
# order (``_bf16_dot``; the product of two bf16 values is exact in fp32, so
# the kernels' fma rounds as the add here does); BatchNorm in ``_em_bn``'s
# order (``pallas_kernels.py:2749``), ``((h - mean) * inv) * gamma + beta``
# with ``inv = bn_inv(var)``; every other operation a PyTorch operation of
# its own, so rounded on its own. The kernels then equal these functions
# bitwise on the card, given the same ``inv`` (torch.rsqrt on the card).


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def bn_inv(var: torch.Tensor) -> torch.Tensor:
    """rsqrt(var + 1e-5) in fp32, once per call for the kernel and its plain
    version alike."""
    return torch.rsqrt(var.to(torch.float32) + EDGE_MLP_EPS)


def _bn_relu(h, mean, inv, gamma, beta):
    return torch.relu((h - mean.to(torch.float32)) * inv * gamma.to(torch.float32)
                      + beta.to(torch.float32))


def _bf16_dot(x: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """bf16(x) @ bf16(W) over the last axis, summed in fp32 in channel order:
    (..., K) x (K, D) -> (..., D)."""
    x, W = _bf16(x), _bf16(W)
    acc = x[..., 0:1] * W[0]
    for c in range(1, W.shape[0]):
        acc = acc + x[..., c:c + 1] * W[c]
    return acc


def gnn_propagate_eval(p: torch.Tensor, idx: torch.Tensor, W: torch.Tensor,
                       b: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                       mean: torch.Tensor, var: torch.Tensor) -> torch.Tensor:
    """IDAM's Propagate edge block in eval mode, p (B, N, C) projected point
    features and idx (B, N, k) neighbours -> (B, N, C) fp32:
    ``gnn_propagate_reference(train=False)`` (``pallas_kernels.py:4472`` and
    ``gnn_edge_reference`` :4259). The edge ``bf16(p)[idx] - p_center`` is
    stored bf16, as the TPU's edge-build kernel stores it; then
    ``relu(((e - mean) * inv) * gamma + beta)``, ``bf16(x1) @ bf16(W) + b``
    and the max over the k neighbours. The contract of
    ``csrc/gnn_propagate.cu``."""
    return gnn_propagate_slots(p, idx, W, b, gamma, beta, mean, var)[0]


def sim_projections(semb: torch.Tensor, temb: torch.Tensor, Wcat: torch.Tensor):
    """The per-point halves of the similarity MLP's first layer, sp =
    bf16(semb) @ bf16(Wcat[:emb]) and tp likewise with Wcat[emb:2 emb], fp32
    (``_sm_prep``, ``pallas_kernels.py:3880-3897``). A plain product on
    either device, outside the kernel, as the TPU leaves it to XLA."""
    emb = semb.shape[-1]
    sp = torch.matmul(_bf16(semb), _bf16(Wcat[:emb]))
    tp = torch.matmul(_bf16(temb), _bf16(Wcat[emb:2 * emb]))
    return sp, tp


def _sim_geometry(src: torch.Tensor, tgt: torch.Tensor):
    """(dist (B, M, M, 1), bf16(diff / (dist + 1e-8)) (B, M, M, 3)) of every
    pair, as ``sim_h0`` computes them."""
    f32 = torch.float32
    diff = src.to(f32)[:, :, None, :] - tgt.to(f32)[:, None, :, :]
    d2 = diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]
    dist = torch.sqrt(d2 + diff[..., 2] * diff[..., 2])[..., None]
    return dist, _bf16(diff / (dist + 1e-8))


def sim_h0(sp, tp, src, tgt, w0, wxyz) -> torch.Tensor:
    """The first layer over every pair, (B, M, M, C): ``(sp_i + tp_j) +
    (dist * w0 + bf16(diff / (dist + 1e-8)) @ bf16(wxyz))``."""
    dist, ndiff = _sim_geometry(src, tgt)
    dproj = dist * w0.to(torch.float32) + _bf16_dot(ndiff, wxyz)
    return (sp[:, :, None, :] + tp[:, None, :, :]) + dproj


def sim_mlp_core(sp, tp, src, tgt, w0, wxyz, W2, b2, W3, W4, g1, be1, g2, be2,
                 mean1, var1, mean2, var2):
    """The similarity MLP over every (i, j) pair from the projections sp, tp
    (B, M, C) and positions src, tgt (B, M, 3) -> (simr (B, M, M) pre-bias
    logits, wmax (B, M, C) max over j of the middle Dense), fp32. The
    contract of ``csrc/sim_mlp.cu``; see ``sim_mlp_eval``. Materialises the
    (B, M, M, C) intermediates."""
    return sim_mlp_slots(sp, tp, src, tgt, w0, wxyz, W2, b2, W3, W4, g1, be1, g2, be2,
                         (mean1, var1), (mean2, var2))[:2]


def sim_logits(simr: torch.Tensor, b4: torch.Tensor) -> torch.Tensor:
    """clip(simr + b4, -20, 20), the similarity logits."""
    return torch.clamp(simr + b4.reshape(()).to(torch.float32), -20.0, 20.0)


def sim_mlp_split(Wcat: torch.Tensor, emb: int):
    """(w0, Wxyz) of the first layer's weight: the rows of the distance and
    of the direction, (C,) and (3, C)."""
    return Wcat[2 * emb], Wcat[2 * emb + 1:2 * emb + 4]


def sim_mlp_eval(src, tgt, semb, temb, Wcat, W2, b2, W3, W4, b4, g1, be1, g2, be2,
                 mean1, var1, mean2, var2):
    """IDAM's similarity-matrix MLP in eval mode -> (sim (B, M, M) clipped
    logits, wmax (B, M, C)): ``sim_mlp_reference(train=False)``
    (``pallas_kernels.py:3961``). Per pair, ``h0 = sp_i + tp_j + dist * w0
    + bf16(diff / (dist + 1e-8)) @ bf16(Wxyz)``, BatchNorm 1 and relu,
    ``h1 = bf16(x1) @ bf16(W2) + b2`` (wmax its max over j), ``h2 =
    bf16(h1) @ bf16(W3)``, BatchNorm 2 and relu, ``simr = sum_c x2 W4`` in
    fp32, ``sim = clip(simr + b4, -20, 20)``."""
    sp, tp = sim_projections(semb, temb, Wcat)
    w0, wxyz = sim_mlp_split(Wcat, semb.shape[-1])
    simr, wmax = sim_mlp_core(sp, tp, src, tgt, w0, wxyz, W2, b2, W3, W4, g1, be1,
                              g2, be2, mean1, var1, mean2, var2)
    return sim_logits(simr, b4), wmax


# ---------------------------------------------------------------------------
# IDAM in train mode: batch statistics and the backward
# ---------------------------------------------------------------------------
#
# Forward: the eval arithmetic above with the batch's statistics, one pass
# each, biased: ``mean = sum / E``, ``var = max(sum_sq / E - mean^2, 0)``
# over the E edges or pairs (``_gnn_edge_forward``, ``pallas_kernels.py:
# 4160-4166``; ``_sim_mlp_forward`` :3741-3770), detached. The max over the
# neighbours (the edge block) and over j (wmax) also gives the first maximal
# slot, which routes the max's cotangent (torch.max's rule; the TPU kernels
# route it to every tied slot by float equality, JAX's CPU autodiff splits
# it evenly).
#
# Backward, written out (``*_backward``) and shared with the kernels: the
# gradient flows through the batch mean and variance, BatchNorm's
# ``dh = gamma inv (dy - S0 / E - hhat S1 / E)`` with ``S = [sum dy, sum dy
# hhat]`` (``_em_bnbwd`` :2847; dgamma = S1, dbeta = S0). Where bf16 rounds:
# as JAX's CPU autodiff of ``gnn_propagate_reference`` and
# ``sim_mlp_reference`` rounds (jax.grad of ``dot(bf16(x), bf16(W),
# preferred_element_type=f32)`` gives the bf16 roundings of the fp32 sums
# ``dy W^T`` and ``x^T dy``): the cotangent of every bf16 product input
# (dx1, the cotangent of bf16(h1), of the stored bf16 edge, of the bf16
# gather table) and every product weight's gradient (W, W2, W3, Wxyz) are
# the bf16 roundings of their fp32 sums; the cotangents those products get
# and every other sum stay fp32. (The TPU kernels instead round dy_h to bf16
# before the products and keep dW in fp32, :4072-4080.) The kernels sum in
# other orders, so they agree with these functions to a tolerance, and a
# value that lies near a bf16 boundary may round the other way.


def _batch_stats(h: torch.Tensor) -> torch.Tensor:
    """(2, C) [mean, max(E[h^2] - mean^2, 0)] over every axis but the last."""
    dims = tuple(range(h.dim() - 1))
    mean = h.mean(dim=dims)
    return torch.stack([mean, torch.clamp((h * h).mean(dim=dims) - mean * mean, min=0.0)])


def _first_max(h: torch.Tensor, dim: int):
    """(max, index of the first maximal entry) along ``dim``, by definition
    (the least index that holds the max), whatever the device."""
    top = h.amax(dim=dim, keepdim=True)
    shape = [1] * h.dim()
    shape[dim] = h.shape[dim]
    pos = torch.arange(h.shape[dim], device=h.device).reshape(shape)
    first = torch.where(h == top, pos, h.shape[dim]).amin(dim=dim)
    return top.squeeze(dim), first


def _bn_backward(dy, hhat, inv, gamma, E: float):
    """BatchNorm's backward in train mode -> (dh, S0, S1)."""
    f32 = torch.float32
    dims = tuple(range(dy.dim() - 1))
    S0, S1 = dy.sum(dim=dims), (dy * hhat).sum(dim=dims)
    dh = (gamma.to(f32) * inv) * ((dy - S0 / E) - hhat * (S1 / E))
    return dh, S0, S1


def gnn_edges(p: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The Propagate block's edges ``bf16(bf16(p)[idx] - p_center)``, (B, N,
    k, C) as fp32 values."""
    p = p.to(torch.float32)
    return _bf16(grouping_operation(_bf16(p), idx) - p[:, :, None, :])


def gnn_propagate_stats(p: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The (2, C) batch statistics [mean, biased var] of the bf16 edges over
    the B N k edges. The contract of ``gnn_propagate_stat`` in
    ``csrc/gnn_propagate.cu``, which sums per-block partials."""
    return _batch_stats(gnn_edges(p, idx))


def stats_from_sums(sums: torch.Tensor, count: float) -> torch.Tensor:
    """(2, C) [mean, max(sumsq / count - mean^2, 0)] from sums (2, C) =
    [sum x, sum x^2] over ``count`` values, as the stat-pass wrappers form
    them from the kernels' partial sums (``_gnn_edge_forward``,
    ``pallas_kernels.py:4163-4166``)."""
    mu = sums[0] / count
    return torch.stack([mu, torch.clamp(sums[1] / count - mu * mu, min=0.0)])


# the threads of a block of csrc/gnn_propagate.cu's stat pass
GNN_STAT_THREADS = 256


def gnn_propagate_partials_ordered(p: torch.Tensor, idx: torch.Tensor,
                                   blocks: int) -> torch.Tensor:
    """The per-block partial sums of ``gnn_propagate_stat`` in
    ``csrc/gnn_propagate.cu``, in its order -> (blocks, 2, C) [sum e, sum
    e^2]. Lane q of block b (L = 256 / C lanes a block) takes points b L +
    q + m blocks L, m = 0, 1, ...; each channel of a lane sums its points'
    edges in that order, a point's slots in order, s1 = s1 + e and s2 =
    fma(e, e, s2) in fp32; a block adds its lanes in order q = 0, 1, ....
    e is bf16-valued, so e^2 is exact in fp64 and s2 + e^2 summed in fp64
    and rounded once to fp32 is the fma's single rounding, where e^2
    underflows fp32 too. A neighbour index outside [0, N) gives a NaN
    edge."""
    f32, f64 = torch.float32, torch.float64
    B, N, C = p.shape
    k = idx.shape[2]
    lanes, points = GNN_STAT_THREADS // C, B * N
    units = blocks * lanes
    M = -(-points // units)
    valid = (idx >= 0) & (idx < N)
    e = gnn_edges(p, torch.where(valid, idx, 0))
    e = torch.where(valid[..., None], e, float("nan")).reshape(points, k, C)
    # point m units + u of unit u = b L + q; the points past the end add 0
    e = torch.cat([e, e.new_zeros((M * units - points, k, C))]).reshape(M, units, k, C)
    s1 = torch.zeros((units, C), dtype=f32, device=p.device)
    s2 = torch.zeros((units, C), dtype=f32, device=p.device)
    for m in range(M):
        for s in range(k):
            x = e[m, :, s]
            s1 = s1 + x
            s2 = (s2.to(f64) + x.to(f64) * x.to(f64)).to(f32)
    s1, s2 = s1.reshape(blocks, lanes, C), s2.reshape(blocks, lanes, C)
    a, b = s1[:, 0], s2[:, 0]
    for q in range(1, lanes):
        a, b = a + s1[:, q], b + s2[:, q]
    return torch.stack([a, b], dim=1)


def gnn_propagate_stats_ordered(p: torch.Tensor, idx: torch.Tensor,
                                blocks: int) -> torch.Tensor:
    """``gnn_propagate_stats`` summed in the order of the stat pass in
    ``csrc/gnn_propagate.cu`` with ``blocks`` blocks
    (``gnn_propagate_partials_ordered``), its partials added and turned into
    [mean, biased var] as its wrapper does: on the same device, the
    kernel's statistics bitwise."""
    part = gnn_propagate_partials_ordered(p, idx, blocks)
    return stats_from_sums(part.sum(0), float(idx.numel()))


def gnn_propagate_slots(p, idx, W, b, gamma, beta, mean, var):
    """The edge block with the statistics mean, var -> (x (B, N, C), the
    first maximal neighbour slot of every output (B, N, C) uint8). The
    contract of the final pass of ``csrc/gnn_propagate.cu``: with the
    running statistics (``gnn_propagate_eval``) or the batch's."""
    return gnn_edge_slots(gnn_edges(p, idx), W, b, gamma, beta, mean, var)


def gnn_edge_candidates(edge, W, b, gamma, beta, mean, var):
    """The candidates of the edge block's max over k, ``h = bf16(x1) @
    bf16(W) + b`` of every edge (B, N, k, C), on given bf16-valued edges
    with given statistics."""
    x1 = _bn_relu(edge, mean, bn_inv(var), gamma, beta)
    return _bf16_dot(x1, W) + b.to(torch.float32)


def gnn_propagate_candidates(p, idx, W, b, gamma, beta, mean, var):
    """``gnn_edge_candidates`` of the edges of p and idx: the (B, N, k, C)
    values whose max over k and first maximal slot ``gnn_propagate_slots``
    returns."""
    return gnn_edge_candidates(gnn_edges(p, idx), W, b, gamma, beta, mean, var)


def gnn_edge_slots(edge, W, b, gamma, beta, mean, var):
    """The edge block on given bf16-valued edges (B, N, k, C) with given
    statistics -> (x (B, N, C), the first maximal slot (B, N, C) uint8)."""
    x, slot = _first_max(gnn_edge_candidates(edge, W, b, gamma, beta, mean, var), 2)
    return x, slot.to(torch.uint8)


def gnn_edge_backward(edge, W, gamma, beta, stats, slot, dx):
    """The edge block's backward in train mode on the bf16-valued edges
    (B, N, k, C), its batch statistics and slots and the cotangent dx
    (B, N, C) -> (da, dW, db, dgamma, dbeta), fp32 (see the rounding rule
    above):

        dh  = dx at the saved slot, 0 elsewhere          (B, N, k, C)
        db  = sum dh,   dW = bf16(sum x1^T dh),   dx1 = bf16(dh W^T)
        dy  = dx1 where BatchNorm's output > 0
        da  = bf16(BatchNorm's backward of dy)           the edges' cotangent.

    ``_ge_bwd1_kernel`` (``pallas_kernels.py:4057``) and the da of
    ``_ge_bwd2_kernel`` :4103 / ``_gp_bwd2_kernel`` :4324."""
    f32 = torch.float32
    B, N, k, C = edge.shape
    inv = bn_inv(stats[1])
    hhat = (edge - stats[0]) * inv
    y = hhat * gamma.to(f32) + beta.to(f32)
    x1 = _bf16(torch.relu(y))
    dh = torch.zeros((B, N, k, C), dtype=f32, device=edge.device).scatter_(
        2, slot.long()[:, :, None, :], dx.to(f32)[:, :, None, :])
    dW = _bf16(x1.reshape(-1, C).t() @ dh.reshape(-1, C))
    dy = torch.where(y > 0, _bf16(dh @ _bf16(W).t()), 0.0)
    da, S0, S1 = _bn_backward(dy, hhat, inv, gamma, float(B * N * k))
    return _bf16(da), dW, dh.sum(dim=(0, 1, 2)), S1, S0


def gnn_propagate_backward(p, idx, W, gamma, beta, stats, slot, dx):
    """The Propagate block's backward in train mode: the forward's inputs,
    its batch statistics and slots, and the cotangent dx (B, N, C) ->
    (d_p, dW, db, dgamma, dbeta), fp32: ``gnn_edge_backward`` on the edges,
    then ``d_p = bf16(sum of da over the edges whose neighbour is the
    point) - sum over k of da at the point as the centre`` (the bf16 gather
    table's cotangent rounds; the centre's does not). The contract of the
    backward passes of ``csrc/gnn_propagate.cu`` (``_ge_bwd1_kernel``
    :4057, ``_gp_bwd2_kernel`` :4324)."""
    B, N, k = idx.shape
    C = p.shape[-1]
    da, dW, db, dgamma, dbeta = gnn_edge_backward(gnn_edges(p, idx), W, gamma, beta,
                                                  stats, slot, dx)
    d_p = _bf16(scatter_add_rows(da.reshape(B, N * k, C), idx.reshape(B, N * k), N))
    return d_p - da.sum(dim=2), dW, db, dgamma, dbeta


# The backward in the kernels' two stages (csrc/gnn_propagate.cu): pass 1
# leaves dy, S, dW and db; the gather recomputes da from dy and S. Together
# they equal ``gnn_propagate_backward`` bitwise on the CPU.


def gnn_propagate_backward_dy(p, idx, W, gamma, beta, stats, slot, dx):
    """Pass 1 of the Propagate block's backward -> (dy (B, N, k, C), S (2,
    C) [sum dy, sum dy hhat], dW, db), fp32: ``dy = bf16(dh W^T)`` where
    BatchNorm's output > 0, else 0 (bf16-valued, so the kernel stores it as
    bf16 without loss). The contract of ``gnn_propagate_backward_kernel``,
    which sums S, dW and db in another order."""
    f32 = torch.float32
    edge = gnn_edges(p, idx)
    B, N, k, C = edge.shape
    inv = bn_inv(stats[1])
    hhat = (edge - stats[0]) * inv
    y = hhat * gamma.to(f32) + beta.to(f32)
    dh = torch.zeros((B, N, k, C), dtype=f32, device=edge.device).scatter_(
        2, slot.long()[:, :, None, :], dx.to(f32)[:, :, None, :])
    dW = _bf16(_bf16(torch.relu(y)).reshape(-1, C).t() @ dh.reshape(-1, C))
    dy = torch.where(y > 0, _bf16(dh @ _bf16(W).t()), 0.0)
    dims = (0, 1, 2)
    S = torch.stack([dy.sum(dim=dims), (dy * hhat).sum(dim=dims)])
    return dy, S, dW, dh.sum(dim=dims)


def gnn_propagate_gather(p, idx, gamma, stats, dy, S, lst=None):
    """The gather of the Propagate block's backward -> d_p (B, N, C) fp32:
    ``da = bf16(gamma inv ((dy - S0 / E) - hhat S1 / E))`` of every edge,
    then ``bf16(sum of da over the edges whose neighbour is the point, in
    ascending edge order) - sum over k of da at the point as the centre``.
    ``lst``, the reverse list ``reverse_list(idx, N)`` when given, names
    each point's incoming edges. The contract of
    ``gnn_propagate_gather_kernel``, which recomputes da and never stores
    it."""
    f32 = torch.float32
    B, N, k = idx.shape
    C = p.shape[-1]
    inv = bn_inv(stats[1])
    hhat = (gnn_edges(p, idx) - stats[0]) * inv
    E = float(B * N * k)
    da = _bf16((gamma.to(f32) * inv) * ((dy - S[0] / E) - hhat * (S[1] / E)))
    if lst is None:
        d_in = scatter_add_rows(da.reshape(B, N * k, C), idx.reshape(B, N * k), N)
    else:
        order, off = lst
        rows = torch.repeat_interleave(torch.arange(B * N, device=p.device),
                                       (off[1:] - off[:-1]).long())
        d_in = torch.zeros((B * N, C), dtype=f32, device=p.device).index_add_(
            0, rows, da.reshape(-1, C)[order.long()]).reshape(B, N, C)
    return _bf16(d_in) - da.sum(dim=2)


class _GnnPropagateTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, p, idx, W, b, gamma, beta):
        stats = gnn_propagate_stats(p, idx)
        x, slot = gnn_propagate_slots(p, idx, W, b, gamma, beta, stats[0], stats[1])
        ctx.save_for_backward(p, idx, W, gamma, beta, stats, slot)
        ctx.mark_non_differentiable(stats)
        return x, stats

    @staticmethod
    def backward(ctx, dx, _):
        p, idx, W, gamma, beta, stats, slot = ctx.saved_tensors
        d_p, dW, db, dgamma, dbeta = gnn_propagate_backward(p, idx, W, gamma, beta,
                                                            stats, slot, dx)
        return d_p, None, dW, db, dgamma, dbeta


def gnn_propagate_train(p: torch.Tensor, idx: torch.Tensor, W: torch.Tensor,
                        b: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor):
    """IDAM's Propagate edge block in train mode -> (x (B, N, C), stats (2, C)
    [mean, biased var] of the bf16 edges, detached):
    ``gnn_propagate_reference(train=True)`` (``pallas_kernels.py:4472``),
    differentiable in p, W, b, gamma and beta by ``gnn_propagate_backward``.
    """
    return _GnnPropagateTrain.apply(p.to(torch.float32), idx, W, b, gamma, beta)


def sim_mlp_batch_stats(sp, tp, src, tgt, w0, wxyz, W2, b2, W3, g1, be1):
    """The similarity MLP's two (2, C) batch statistics [mean, biased var]
    over the B M M pairs: of h0, then of h2 with BatchNorm 1 on the first.
    The contract of the two stat passes of ``csrc/sim_mlp.cu``
    (``_sm_stat_kernel`` :3439, levels 0 and 1)."""
    h0 = sim_h0(sp, tp, src, tgt, w0, wxyz)
    st1 = _batch_stats(h0)
    x1 = _bn_relu(h0, st1[0], bn_inv(st1[1]), g1, be1)
    return st1, _batch_stats(_bf16_dot(_bf16_dot(x1, W2) + b2.to(torch.float32), W3))


def sim_h1(sp, tp, src, tgt, w0, wxyz, W2, b2, g1, be1, st1):
    """h1 = bf16(x1) @ bf16(W2) + b2 of every pair (B, M, M, C), x1 the relu
    of BatchNorm 1 of h0 on the statistics st1 ([mean, var]): the
    candidates of wmax's max over j."""
    x1 = _bn_relu(sim_h0(sp, tp, src, tgt, w0, wxyz), st1[0], bn_inv(st1[1]), g1, be1)
    return _bf16_dot(x1, W2) + b2.to(torch.float32)


def sim_mlp_slots(sp, tp, src, tgt, w0, wxyz, W2, b2, W3, W4, g1, be1, g2, be2,
                  st1, st2):
    """The pairwise chain with the BatchNorms' statistics st1, st2 ([mean,
    var] each) -> (simr, wmax, the first j of each wmax (B, M, C) int32).
    The contract of the final passes of ``csrc/sim_mlp.cu``: with the
    running statistics (``sim_mlp_core``) or the batch's."""
    f32 = torch.float32
    h1 = sim_h1(sp, tp, src, tgt, w0, wxyz, W2, b2, g1, be1, st1)
    x2 = _bn_relu(_bf16_dot(h1, W3), st2[0], bn_inv(st2[1]), g2, be2)
    w4 = W4.reshape(-1).to(f32)
    simr = x2[..., 0] * w4[0]
    for c in range(1, w4.shape[0]):
        simr = simr + x2[..., c] * w4[c]
    wmax, argj = _first_max(h1, 2)
    return simr, wmax, argj.to(torch.int32)


def split_bf16x3(x: torch.Tensor):
    """fp32 x as three bf16 terms (hi, mid, lo), each the round to nearest
    of what the ones before leave: hi + mid carries x's top 16 significant
    bits and lo the rest, so (hi + mid) + lo == x in fp32 (for x clear of
    the bottom of the exponent range). A product of x with bf16 weights as
    the three bf16 products summed in fp32 is x's fp32 product to fp32
    rounding: how ``csrc/sim_mlp.cu``'s backward puts its fp32 cotangents on
    the tensor cores."""
    x = x.to(torch.float32)
    hi = x.to(torch.bfloat16)
    r = x - hi.to(torch.float32)
    mid = r.to(torch.bfloat16)
    return hi, mid, (r - mid.to(torch.float32)).to(torch.bfloat16)


def sim_mlp_backward(sp, tp, src, tgt, w0, wxyz, W2, b2, W3, W4, g1, be1, g2, be2,
                     st1, st2, argj, dsimr, dwmax):
    """The similarity MLP's backward in train mode, from the cotangents of
    simr (B, M, M) and wmax (B, M, C) -> (dsp, dtp, dw0, dwxyz, dW2, db2,
    dW3, dW4, dg1, dbe1, dg2, dbe2), fp32 (see the rounding rule above):

        dy2 = dsimr W4 where BatchNorm 2's output > 0;  dW4 = sum x2 dsimr
        dh2 = BatchNorm 2's backward (S2 = [sum dy2, sum dy2 hhat2])
        dh1 = bf16(dh2 W3^T) + dwmax at the saved j;  dW3 = bf16(sum bf16(h1)^T dh2)
        dy1 = bf16(dh1 W2^T) where BatchNorm 1's output > 0
        db2 = sum dh1;  dW2 = bf16(sum x1^T dh1)
        dh0 = BatchNorm 1's backward (S1);  dsp = sum_j dh0, dtp = sum_i dh0,
        dw0 = sum dist dh0,  dwxyz = bf16(sum bf16(diff / (dist + 1e-8))^T dh0).

    Positions get no gradient (``_sm_prep`` :3904-3907). The contract of
    the three backward passes of ``csrc/sim_mlp.cu`` (``_sm_bwd1/2/3_kernel``
    :3497/:3537/:3575)."""
    f32 = torch.float32
    B, M, C = sp.shape
    E = float(B * M * M)
    dist, ndiff = _sim_geometry(src, tgt)
    h0 = sim_h0(sp, tp, src, tgt, w0, wxyz)
    inv1, inv2 = bn_inv(st1[1]), bn_inv(st2[1])
    hhat1 = (h0 - st1[0]) * inv1
    y1 = hhat1 * g1.to(f32) + be1.to(f32)
    x1 = _bf16(torch.relu(y1))
    h1b = _bf16(_bf16_dot(x1, W2) + b2.to(f32))
    hhat2 = (_bf16_dot(h1b, W3) - st2[0]) * inv2
    y2 = hhat2 * g2.to(f32) + be2.to(f32)
    x2 = torch.relu(y2)
    ds = dsimr.to(f32)[..., None]
    dy2 = torch.where(y2 > 0, ds * W4.reshape(-1).to(f32), 0.0)
    dW4 = (x2 * ds).sum(dim=(0, 1, 2)).reshape(C, 1)
    dh2, S2_0, S2_1 = _bn_backward(dy2, hhat2, inv2, g2, E)
    route = torch.zeros((B, M, M, C), dtype=f32, device=sp.device).scatter_(
        2, argj.long()[:, :, None, :], dwmax.to(f32)[:, :, None, :])
    dh1 = _bf16(dh2 @ _bf16(W3).t()) + route
    dW3 = _bf16(h1b.reshape(-1, C).t() @ dh2.reshape(-1, C))
    dW2 = _bf16(x1.reshape(-1, C).t() @ dh1.reshape(-1, C))
    dy1 = torch.where(y1 > 0, _bf16(dh1 @ _bf16(W2).t()), 0.0)
    dh0, S1_0, S1_1 = _bn_backward(dy1, hhat1, inv1, g1, E)
    dwxyz = _bf16(ndiff.reshape(-1, 3).t() @ dh0.reshape(-1, C))
    return (dh0.sum(dim=2), dh0.sum(dim=1), (dist * dh0).sum(dim=(0, 1, 2)), dwxyz,
            dW2, dh1.sum(dim=(0, 1, 2)), dW3, dW4, S1_1, S1_0, S2_1, S2_0)


class _SimMlpCoreTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, sp, tp, src, tgt, w0, wxyz, W2, b2, W3, W4, g1, be1, g2, be2):
        st1, st2 = sim_mlp_batch_stats(sp, tp, src, tgt, w0, wxyz, W2, b2, W3, g1, be1)
        simr, wmax, argj = sim_mlp_slots(sp, tp, src, tgt, w0, wxyz, W2, b2, W3, W4,
                                         g1, be1, g2, be2, st1, st2)
        ctx.save_for_backward(sp, tp, src, tgt, w0, wxyz, W2, b2, W3, W4, g1, be1, g2,
                              be2, st1, st2, argj)
        ctx.mark_non_differentiable(st1, st2)
        return simr, wmax, st1, st2

    @staticmethod
    def backward(ctx, dsimr, dwmax, _1, _2):
        (sp, tp, src, tgt, w0, wxyz, W2, b2, W3, W4, g1, be1, g2, be2, st1, st2,
         argj) = ctx.saved_tensors
        (dsp, dtp, dw0, dwxyz, dW2, db2, dW3, dW4, dg1, dbe1, dg2,
         dbe2) = sim_mlp_backward(sp, tp, src, tgt, w0, wxyz, W2, b2, W3, W4, g1, be1,
                                  g2, be2, st1, st2, argj, dsimr, dwmax)
        return (dsp, dtp, None, None, dw0, dwxyz, dW2, db2, dW3, dW4, dg1, dbe1, dg2,
                dbe2)


def sim_mlp_train(src, tgt, semb, temb, Wcat, W2, b2, W3, W4, b4, g1, be1, g2, be2):
    """IDAM's similarity-matrix MLP in train mode -> (sim (B, M, M), wmax
    (B, M, C), (st1, st2) detached batch statistics):
    ``sim_mlp_reference(train=True)`` (``pallas_kernels.py:3961``). The
    projections and the bias and clip are plain autograd (``sim_projections``,
    ``sim_logits``); the pairwise chain is differentiable by
    ``sim_mlp_backward``; positions get no gradient."""
    sp, tp = sim_projections(semb, temb, Wcat)
    w0, wxyz = sim_mlp_split(Wcat, semb.shape[-1])
    simr, wmax, st1, st2 = _SimMlpCoreTrain.apply(
        sp, tp, src.detach().to(torch.float32), tgt.detach().to(torch.float32), w0,
        wxyz, W2, b2, W3, W4, g1, be1, g2, be2)
    return sim_logits(simr, b4), wmax, (st1, st2)


# ---------------------------------------------------------------------------
# Ball query
# ---------------------------------------------------------------------------


def squared_radius(r: float) -> float:
    """A radius as the ball test compares it: squared in double precision,
    then rounded to float32, as JAX's weak typing turns ``max_r * max_r``
    into the float32 operand of ``d < r2`` (``pallas_kernels.py:1510``)."""
    return torch.tensor(float(r) * float(r), dtype=torch.float32).item()


def ball_query(min_radius: float, max_radius: float, nsample: int,
               xyz: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """Fixed-size radius neighbourhoods with first-hit fill.

    xyz (B, N, 3) database, centers (B, M, 3) -> idx (B, M, nsample) int32,
    no gradient. A point is a hit iff ``d == 0`` or ``min_r^2 <= d <
    max_r^2`` for its exact squared distance d (``_sqdist``; the radii as
    ``squared_radius`` rounds them); hits fill the slots in ascending index
    order, unfilled slots repeat the first hit, and a center with no hit
    gets a row of zeros (``_ball_query_kernel``, ``pallas_kernels.py:1491``;
    the reference CUDA op ``ball_query_cuda.cu:12-54``). The contract of
    ``csrc/ball_query.cu``.
    """
    B, N, _ = xyz.shape
    lo = squared_radius(min_radius)
    hi = squared_radius(max_radius)
    with torch.no_grad():
        d = _sqdist(centers, xyz)                                  # (B, M, N)
        valid = (d == 0) | ((d >= lo) & (d < hi))
        iota = torch.arange(N, device=xyz.device)
        key = torch.where(valid, iota, N)
        slots = torch.sort(key, dim=-1).values[..., :nsample]
        if nsample > N:
            slots = torch.cat([slots, slots.new_full(
                (*slots.shape[:2], nsample - N), N)], dim=-1)
        hit = slots < N
        first = torch.where(hit[..., :1], slots[..., :1], 0)
        return torch.where(hit, slots, first).to(torch.int32)


# ---------------------------------------------------------------------------
# Auction EMD
# ---------------------------------------------------------------------------


def emd_validate(xyz1: torch.Tensor, xyz2: torch.Tensor) -> None:
    """The shape checks of ``jnp_ref.emd_validate`` (the reference launcher's
    asserts, ``emd_cuda.cu:236-249``): n != m raises; a batch above 512 and
    n % 1024 != 0 only warn, since the auction is right at any size."""
    B, n, _ = xyz1.shape
    m = xyz2.shape[1]
    if n != m:
        raise ValueError(f"EMD requires n == m, got {n} vs {m} "
                         "(emd_cuda.cu:239)")
    if B > 512:
        warnings.warn(
            f"EMD protocol expects batch <= 512 (emd_cuda.cu:247); got "
            f"B={B}. The auction still runs correctly.", stacklevel=2)
    if n % 1024 != 0:
        warnings.warn(
            f"EMD protocol expects n % 1024 == 0 (emd_cuda.cu:243); got "
            f"n={n}. The auction still runs correctly.", stacklevel=2)


def emd_top2(v: torch.Tensor) -> Tuple[float, int, float]:
    """(best, best_j, second) of one bidder's finite benefit row v (m,), as
    ``emd_assignment`` takes them: best_j the lowest index among equal
    maxima, second the largest value over the other targets (-inf when
    there is none)."""
    best_j = int(torch.argmax(v))
    rest = v.clone()
    rest[best_j] = -torch.inf
    return float(v[best_j]), best_j, float(rest.max())


def _emd_merge(t: Tuple[float, int, float], o: Tuple[float, int, float]):
    """emd.cu's merge of the top-2 o of another set of targets into t."""
    (b, j, s), (ob, oj, os) = t, o
    if ob > b or (ob == b and oj < j):
        return ob, oj, max(os, b)
    return b, j, max(s, ob)


def emd_split_top2(v: torch.Tensor, C: int, g: int,
                   lanes: int = 32) -> Tuple[float, int, float]:
    """emd.cu's top-2 of a benefit row v (m,), in its order: the targets
    split over C CTAs (CTA r takes [r nt, (r + 1) nt), nt = ceil(m / C)),
    each CTA's over g groups of ``lanes`` lanes (g warps, or with ``lanes``
    under 32 one group of a warp; lane l of group w takes the local targets
    w lanes + l, step lanes g, ascending, strict >), each group's lanes
    merged by the xor butterfly, then the g groups in order, then the C
    CTAs in rank order, every merge by emd.cu's rule. Equal to ``emd_top2``
    for every C, g and lanes: the merge is a function of the set."""
    vals = [float(x) for x in v.tolist()]
    m = len(vals)
    nt = -(-m // C)
    empty = (-float("inf"), 0x7fffffff, -float("inf"))
    ctas = []
    for r in range(C):
        t0, tn = r * nt, max(0, min(nt, m - r * nt))
        warps = []
        for w in range(g):
            tops = []
            for lane in range(lanes):
                b, j, s = empty
                for jl in range(w * lanes + lane, tn, lanes * g):
                    x = vals[t0 + jl]
                    if x > b:
                        b, j, s = x, t0 + jl, b
                    elif x > s:
                        s = x
                tops.append((b, j, s))
            off = 1
            while off < lanes:
                tops = [_emd_merge(tops[lane], tops[lane ^ off]) for lane in range(lanes)]
                off *= 2
            warps.append(tops[0])
        top = warps[0]
        for w in warps[1:]:
            top = _emd_merge(top, w)
        ctas.append(top)
    top = ctas[0]
    for t in ctas[1:]:
        top = _emd_merge(top, t)
    return top[0], top[1], top[2]


def emd_assignment(xyz1: torch.Tensor, xyz2: torch.Tensor, eps: float,
                   iters: int, bids: Optional[List[int]] = None,
                   counts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The auction assignment of ``_emd_kernel`` (``pallas_kernels.py:1986``):
    xyz1 (B, n, 3) bidders, xyz2 (B, n, 3) targets -> (B, n) int32.

    Benefit ``(3 - sqrt(d)) - price`` with d the exact squared distance
    (``_sqdist``; not ``jnp_ref``'s |a|^2+|b|^2-2a.b). Each round, every
    unassigned bidder takes ``best`` and ``best_i`` (the lowest index among
    equal maxima) and ``second``, the maximum over the other targets (a tie
    gives best - second = 0), and bids ``(best - second) + eps``. Per target
    the largest bid wins, and among equal bids the highest bidder index
    (``:2073-2079``); the target's price rises by the bid, its previous owner
    is evicted and the winner assigned. Rounds run while ``it < iters - 1``
    and a bidder is unassigned; then one forced round gives each leftover
    bidder its ``best_i`` (``:2108-2119``). Runs on CPU or CUDA tensors (one
    host sync a round); the contract of ``csrc/emd.cu``. ``bids``, if given,
    gets the number of bidders of every round, the forced one included;
    ``counts``, if given, a (B, 2) int64 tensor on xyz1's device, gets added
    each cloud's rounds (those in which it had a bidder) and bidder-rounds."""
    B, n, _ = xyz1.shape
    m = xyz2.shape[1]
    dev = xyz1.device
    with torch.no_grad():
        base = 3.0 - torch.sqrt(_sqdist(xyz1, xyz2))            # (B, n, m)
        eps32 = torch.tensor(eps, dtype=torch.float32, device=dev)
        price = torch.zeros(B * m, dtype=torch.float32, device=dev)
        assign = torch.full((B, n), -1, dtype=torch.long, device=dev)
        owner = torch.full((B * m,), -1, dtype=torch.long, device=dev)

        def bid(b, i):
            """best_i and bid_inc of the bidders (b, i)."""
            if bids is not None:
                bids.append(int(b.numel()))
            if counts is not None:
                per_cloud = torch.bincount(b, minlength=B)
                counts[:, 0] += per_cloud > 0
                counts[:, 1] += per_cloud
            benefit = base[b, i] - price.view(B, m)[b]              # (U, m)
            best_i = torch.argmax(benefit, dim=1)
            best = benefit.gather(1, best_i[:, None])[:, 0]
            second = benefit.scatter(1, best_i[:, None], -torch.inf).amax(1)
            return best_i, (best - second) + eps32

        for _ in range(iters - 1):
            b, i = torch.nonzero(assign < 0, as_tuple=True)
            if b.numel() == 0:
                break
            best_i, inc = bid(b, i)
            t = b * m + best_i                                      # flat target
            max_inc = torch.full((B * m,), -torch.inf, device=dev).scatter_reduce(
                0, t, inc, "amax")
            tie = inc == max_inc[t]
            winner = torch.full((B * m,), -1, dtype=torch.long, device=dev
                                ).scatter_reduce(0, t, torch.where(tie, i, -1), "amax")
            won = torch.nonzero(winner >= 0)[:, 0]
            price[won] = price[won] + max_inc[won]
            old = owner[won]
            evicted = old >= 0
            assign[won[evicted] // m, old[evicted]] = -1
            assign[won // m, winner[won]] = won % m
            owner[won] = winner[won]
        b, i = torch.nonzero(assign < 0, as_tuple=True)
        if b.numel():                                       # the forced round
            assign[b, i] = bid(b, i)[0]
        return assign.to(torch.int32)


def emd_distance(xyz1: torch.Tensor, xyz2: torch.Tensor,
                 assignment: torch.Tensor) -> torch.Tensor:
    """(B, n) squared distance of each xyz1 point to its assigned xyz2 point,
    ``sum((xyz1 - xyz2[assignment])^2)``; autograd gives xyz1 the gradient
    ``2 g (xyz1 - matched)`` and xyz2 none (``pallas_kernels.py:2199-2204``;
    JAX returns zeros for it)."""
    rows = torch.arange(xyz1.shape[0], device=xyz1.device)[:, None]
    matched = xyz2.detach()[rows, assignment.long()]
    return torch.sum((xyz1 - matched) ** 2, dim=-1)


def emd_auction(xyz1: torch.Tensor, xyz2: torch.Tensor, eps: float = 0.005,
                iters: int = 50) -> Tuple[torch.Tensor, torch.Tensor]:
    """Auction EMD (``pallas_kernels.emd_auction``): (dist (B, n) squared L2
    to the assigned xyz2 point, assignment (B, n) int32)."""
    emd_validate(xyz1, xyz2)
    assignment = emd_assignment(xyz1, xyz2, eps, iters)
    return emd_distance(xyz1, xyz2, assignment), assignment


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
