"""Seeded numpy point clouds for the port's tests (numpy only, so the tests
that run on the card can import it without jax)."""

import numpy as np

from tests.util_np import pairwise_sqdist


def clouds(seed, B, N, M):
    rng = np.random.default_rng(seed)
    a = rng.random((B, N, 3), dtype=np.float64).astype(np.float32)
    b = rng.random((B, M, 3), dtype=np.float64).astype(np.float32)
    return a, b


def min_gap(a, b):
    """Smallest float64 gap between the best and second-best squared
    distance over all rows and columns (the near-tie margin)."""
    gaps = []
    for k in range(a.shape[0]):
        P = pairwise_sqdist(a[k], b[k])
        for D in (P, P.T):
            s = np.sort(D, axis=1)
            gaps.append((s[:, 1] - s[:, 0]).min())
    return min(gaps)


def clouds_without_near_ties(B, N, M, margin=1e-6):
    """Deterministic clouds whose argmins no fp32 rounding can flip: fp32
    distance error at unit scale is ~1e-7, far below the margin."""
    for seed in range(100):
        a, b = clouds(seed, B, N, M)
        if min_gap(a, b) > margin:
            return a, b
    raise AssertionError("no seed gave clouds without near ties")


def knn_margin(q, p, k):
    """Smallest float64 gap between consecutive distances among the k+1
    nearest, over all query rows: the near-tie margin of a nearest-first
    kNN (k >= N: among all N)."""
    gaps = []
    for b in range(q.shape[0]):
        s = np.sort(pairwise_sqdist(q[b], p[b]), axis=1)[:, :k + 1]
        if s.shape[1] > 1:
            gaps.append(np.diff(s, axis=1).min())
    return min(gaps) if gaps else np.inf


def knn_inputs_with_margin(B, M, N, C, k):
    """Deterministic (query, points) in [0, 1)^C whose k nearest, in order,
    no fp32 rounding can reorder. The margin, 4e-6 * C, exceeds 8 ulp of the
    largest |q|^2 + |p|^2 (<= 2C): the error bound of jnp_ref's
    |q|^2+|p|^2-2q.p expansion, itself far above the error of exact
    per-coordinate differences."""
    margin = 4e-6 * C
    for seed in range(200):
        rng = np.random.default_rng([seed, C])
        q = rng.random((B, M, C), dtype=np.float64).astype(np.float32)
        p = rng.random((B, N, C), dtype=np.float64).astype(np.float32)
        if knn_margin(q, p, k) > margin:
            return q, p
    raise AssertionError("no seed gave kNN inputs without near ties")


def clouds_with_duplicates(B=2, N=64, M=40):
    """b holds repeated points, and a holds copies of some b points, so
    many distances tie exactly."""
    a, b = clouds(5, B, N, M)
    b[:, 20:30] = b[:, 0:10]          # b[j + 20] == b[j]
    b[:, 35] = b[:, 3]
    a[:, 0:10] = b[:, 0:10]           # exact hits on a duplicated b point
    a[:, 40:45] = a[:, 10:15]         # a[i + 30] == a[i]
    return a, b


ULP = 2.0 ** -23                       # fp32 relative spacing


def grid_points(rng, n):
    """n distinct points with coordinates k/32 in [-4, 4): squares and sums of
    three need at most 17 bits, so the |a|^2+|b|^2-2a.b expansion of the JAX
    package's CPU path is exact on them."""
    cells = rng.choice(256 ** 3, n, replace=False)
    ijk = np.stack([cells // 65536, (cells // 256) % 256, cells % 256], -1)
    return ((ijk - 128) / 32.0).astype(np.float32)


def fps_sequences_agree(points_port, points_jax, s):
    """Float64 FPS on the torch and on the JAX points picks the same sequence,
    and at every step, on each side, the largest and second largest
    min-distance are further apart than twice its fp32 error (8 ulp)."""
    for b in range(points_port.shape[0]):
        seqs = []
        for pts in (points_port[b], points_jax[b]):
            p = pts.astype(np.float64)
            md = np.full(len(p), 1e10)
            last, seq = 0, []
            for _ in range(1, s):
                md = np.minimum(md, np.sum((p - p[last]) ** 2, -1))
                top2 = np.sort(md)[-2:]
                if not top2[1] - top2[0] > 16 * ULP * top2[1]:
                    return False
                last = int(np.argmax(md))
                seq.append(last)
            seqs.append(seq)
        if seqs[0] != seqs[1]:
            return False
    return True
