"""The launch plan of the port's auction EMD (``ops/kernels.py``
``emd_plan``, ``emd_partition``, ``emd_shared_bytes``) and the plain mirror
of its split top-2 (``ops/ref.py`` ``emd_split_top2``), on the CPU.

- ``emd_plan``: a cluster of C <= 8 CTAs a cloud, B C within the SMs, at
  least 32 targets a CTA, the shared memory within the opt-in limit at
  every n up to ``EMD_MAX_N``, C = 3 at the val batch's B 32 on 132 SMs
  (4 would not fit the shared memory), and fewer where the card keeps
  fewer clusters resident.
- ``emd_partition``: every target scanned (and every bidder's output
  written) by exactly one CTA, for n not divisible by C.
- ``emd_split_top2``: the top-2 as ``csrc/emd.cu`` takes it (split over C
  CTAs, g groups a bidder of 32, 16, 4 or 1 lanes, merged in its order)
  equals the whole-row top-2 of ``ref.emd_assignment`` on random rows,
  ties across slice boundaries, rows all equal and rows with -inf entries,
  at C g of 1, 2, 3, 4 and 8.
- ``ref.emd_assignment``'s per-cloud counts (rounds and bidder-rounds,
  which chip_smoke and the probe report) are each cloud's own auction's.
- ``EMD_MAX_ABS``, the largest coordinate the kernel's wrapper takes,
  keeps every squared distance finite, and twice it does not.
"""

import numpy as np
import pytest
import torch

from mvp_benchmark_tpu_torch.ops import kernels, ref

SMS = 132                       # an H100 SXM
SIZES = (1, 7, 777, 1000, 2048, 6144)


@pytest.mark.parametrize("n", SIZES)
def test_emd_plan_within_the_card(n):
    for B in (1, 2, 16, 17, 32, 33, 44, 64, 66, 67, 131, 132, 133, 512):
        C = kernels.emd_plan(B, n, SMS)
        assert 1 <= C <= kernels.EMD_MAX_CLUSTER
        assert C == 1 or B * C <= SMS
        assert C == 1 or n >= C * kernels.EMD_MIN_TARGETS
        assert n <= kernels.EMD_MAX_N
        assert kernels.emd_shared_bytes(n, C) <= kernels.EMD_SMEM <= kernels.MAX_SMEM


def test_emd_plan_at_the_paths_batches():
    # the val batch: 4 a cloud would fit the SMs, but not the shared memory
    assert kernels.emd_plan(32, 2048, SMS) == 3
    assert [kernels.emd_plan(B, 2048, SMS) for B in (16, 33, 66, 67)] == [3, 3, 2, 1]
    assert [kernels.emd_plan(B, 512, SMS) for B in (16, 33, 66, 67)] == [8, 4, 2, 1]
    assert kernels.emd_plan(32, 2048, SMS, resident=lambda c: {3: 30, 2: 40}.get(c, 0)) == 2
    assert kernels.emd_plan(32, 2048, SMS, resident=lambda c: 0) == 1
    assert kernels.emd_plan(2, 7, SMS) == 1                # under 32 targets a CTA
    assert kernels.emd_plan(1, kernels.EMD_MAX_N, SMS) == 1
    assert kernels.emd_shared_bytes(2048, 3) <= kernels.EMD_SMEM < kernels.emd_shared_bytes(2048, 4)
    assert kernels.emd_shared_bytes(kernels.EMD_MAX_N, 1) <= kernels.EMD_SMEM
    assert kernels.emd_shared_bytes(kernels.EMD_MAX_N + 512, 1) > kernels.EMD_SMEM


@pytest.mark.parametrize("n", SIZES)
def test_emd_partition_owns_every_point_once(n):
    for C in range(1, kernels.EMD_MAX_CLUSTER + 1):
        if C > 1 and n < C * kernels.EMD_MIN_TARGETS:
            continue
        parts = kernels.emd_partition(n, C)
        assert len(parts) == C
        owned = np.zeros(n, dtype=np.int64)
        for start, stop in parts:
            assert 0 <= start <= stop <= n
            owned[start:stop] += 1
            assert C == 1 or stop > start           # no CTA without targets
        assert (owned == 1).all()


SPLITS = [(1, 1), (2, 1), (1, 2), (3, 1), (1, 3), (4, 1), (2, 2), (8, 1), (4, 2),
          (1, 8)]
LANES = (32, 16, 4, 1)              # lanes a group: a warp, or G < 32 of one


def _rows(m):
    rng = np.random.default_rng(m)
    rand = rng.standard_normal(m).astype(np.float32)
    coarse = np.round(rng.random(m) * 4).astype(np.float32)   # many ties
    boundary = rng.standard_normal(m).astype(np.float32)
    top = float(boundary.max()) + 1.0
    for j in (m // 4 - 1, m // 4, m // 2 - 1, m // 2, 3 * m // 4, m - 1):
        boundary[max(j, 0)] = top                 # the max on slice edges
    with_inf = rng.standard_normal(m).astype(np.float32)
    with_inf[rng.random(m) < 0.5] = -np.inf
    with_inf[m // 3] = 0.25
    return {"random": rand, "ties": coarse, "boundary_ties": boundary,
            "all_equal": np.full(m, 1.5, np.float32), "minus_inf": with_inf}


@pytest.mark.parametrize("m", [1, 2, 63, 777, 1000])
def test_emd_split_top2_equals_whole_row(m):
    for name, row in _rows(m).items():
        v = torch.from_numpy(row)
        want = ref.emd_top2(v)
        for C, g in SPLITS:
            if C > m:
                continue
            for lanes in LANES:
                assert ref.emd_split_top2(v, C, g, lanes) == want, (name, m, C, g, lanes)


def test_emd_top2_is_the_plain_auctions_bid():
    """With one iteration the plain auction is its forced round alone, at
    prices 0: every bidder takes the best_j of ``emd_top2`` (and of the
    split mirror) over its benefit row."""
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.random((1, 64, 3), dtype=np.float64).astype(np.float32))
    b = torch.from_numpy(rng.random((1, 64, 3), dtype=np.float64).astype(np.float32))
    a[0, 40:] = a[0, :24]                              # equal rows too
    benefit = 3.0 - torch.sqrt(ref._sqdist(a, b))[0]
    forced = ref.emd_assignment(a, b, 0.01, 1)[0]
    for i in range(64):
        top = ref.emd_top2(benefit[i])
        assert top[1] == int(forced[i])
        assert ref.emd_split_top2(benefit[i], 2, 1) == top


@pytest.mark.parametrize("iters", [300, 4])
def test_plain_auction_counts_each_cloud(iters):
    """Each cloud's counts equal its rounds and bidder-rounds run alone
    (converged, and cut by the forced round at 4 iterations); the batch's
    rounds are its slowest cloud's."""
    rng = np.random.default_rng(5)
    a = torch.from_numpy(rng.random((3, 96, 3), dtype=np.float64).astype(np.float32))
    b = torch.from_numpy(rng.random((3, 96, 3), dtype=np.float64).astype(np.float32))
    a[1] = a[1] * 0.05                                 # a blob: more rounds
    bids = []
    counts = torch.zeros((3, 2), dtype=torch.int64)
    got = ref.emd_assignment(a, b, 0.01, iters, bids, counts)
    for k in range(3):
        alone = []
        torch.testing.assert_close(ref.emd_assignment(a[k:k + 1], b[k:k + 1], 0.01,
                                                      iters, alone)[0], got[k])
        assert counts[k].tolist() == [len(alone), sum(alone)]
    assert int(counts[:, 0].max()) == len(bids) and int(counts[:, 1].sum()) == sum(bids)


def test_emd_max_abs_keeps_squared_distances_finite():
    """Two points at opposite corners of the cube of side 2 ``EMD_MAX_ABS``
    are at a finite squared distance (the largest the kernel meets); twice
    as far out it overflows to inf, where the kernel's square root is not
    IEEE's."""
    for m, finite in ((kernels.EMD_MAX_ABS, True), (2 * kernels.EMD_MAX_ABS, False)):
        p = torch.full((1, 1, 3), m, dtype=torch.float32)
        d = ref._sqdist(p, -p)
        assert bool(torch.isfinite(d).all()) == finite, (m, d)
