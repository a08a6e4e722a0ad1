"""The one-launch backwards of ``chamfer_backward`` (``csrc/chamfer.cu``)
and ``group_max_backward`` (``csrc/gather.cu``), on the CPU: their launch
plans, and their order of work mirrored in numpy.

Both list their index in shared memory (``csrc/local_list.cuh``): a block
takes a range of rows of one cloud and a chunk of the cloud's entries at a
time; each warp holds a contiguous segment of the chunk, so each row's list
is its entries in ascending order. The plans are checked by the kernels'
own index arithmetic at every call of the PCN, VRCNet and ECG train steps
and at their limits: each (cloud, row) written by one block, each chunk's
entries held by one lane each, the shared memory within what a block may
opt in to. The mirrors walk each block's chunks and lists as the kernels
do, adding in float32, and equal ``ref.chamfer_backward`` /
``ref.group_max_backward`` bitwise, a later chunk added to what the
earlier ones left (the kernels hold the same on the card,
``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

from mvp_benchmark_tpu_torch.ops import kernels, ref

# (B, n rows, c, m points, k): the VRCNet step's three, ECG's three
GROUP_MAX_STEP_SHAPES = [(64, 3072, 64, 1536, 10), (64, 1536, 128, 768, 10),
                         (64, 768, 256, 384, 10), (32, 256, 840, 64, 16),
                         (32, 1024, 360, 256, 16), (32, 3072, 120, 1024, 16)]
# (B, points of p, points of q): the VRCNet, PCN and ECG steps' db
CHAMFER_STEP_SHAPES = [(64, 1024, 2048), (64, 3072, 2048), (64, 2048, 2048),
                       (32, 2048, 2048), (32, 1024, 2048)]


def _list_ints(warps, m):
    return warps * m + m + 1 + warps


def _segments(length, warps):
    """[first, end) of each warp's entries in a chunk of ``length``, and the
    entries a lane holds, as local_list.cuh splits them."""
    steps = -(-length // (32 * warps))
    return [(min(length, w * 32 * steps), min(length, (w + 1) * 32 * steps))
            for w in range(warps)], steps


def _check_cover(B, n, rows, entries, chunk, warps):
    ranges = -(-n // rows)
    assert B * ranges < 2 ** 31
    covered = sorted(r for rng in range(ranges) for r in range(rng * rows, min(n, rng * rows + rows)))
    assert covered == list(range(n))                  # every row of a cloud once
    chunks = [(e0, min(entries, e0 + chunk)) for e0 in range(0, max(entries, 1), chunk)]
    assert chunks[0][0] == 0 and chunks[-1][1] == entries
    for e0, e1 in chunks:
        segs, _ = _segments(e1 - e0, warps)
        got = [e for lo, hi in segs for e in range(lo, hi)]
        assert got == list(range(e1 - e0))            # each entry held once, in order


@pytest.mark.parametrize("B,n,c,m,k", GROUP_MAX_STEP_SHAPES + [
    (2, 97, 6, 41, 7), (1, 4000, 8, 2100, 10), (3, 1, 4, 5, 3), (1, 50, 2048, 30, 4),
    (1, 30, 8, 20000, 10), (70000, 24, 8, 24, 2)])
def test_group_max_backward_plan_covers_rows_and_entries(B, n, c, m, k):
    vectors = c // 8 if c % 8 == 0 else c
    rows, chunk, lanes = kernels.group_max_backward_plan(n, c, m, k, vectors)
    assert 1 <= rows <= n
    assert vectors <= lanes < 2 * vectors
    assert lanes >= 32 or 32 % lanes == 0             # a row inside one warp
    assert B * -(-n // rows) < 2 ** 31
    assert 1 <= chunk <= kernels.GROUP_MAX_BWD_CHUNK
    assert kernels.group_max_backward_smem(rows, chunk, c) \
        == 4 * (_list_ints(kernels.GROUP_MAX_BWD_WARPS, rows) + chunk + c) <= kernels.MAX_SMEM
    if B < 1000 and m * k < 50000:
        _check_cover(B, n, rows, m * k, chunk, kernels.GROUP_MAX_BWD_WARPS)
    if m * k <= kernels.GROUP_MAX_BWD_CHUNK:
        assert chunk == max(1, m * k)                 # one chunk: d written once


def test_group_max_backward_plan_at_the_vrcnet_and_ecg_steps():
    """One chunk a cloud at every level, 8 channels a thread and about
    eight output vectors a thread: six blocks a cloud at VRCNet's levels,
    two blocks an SM at every shape; ECG's 15 vectors a row on 16 threads."""
    got = [kernels.group_max_backward_plan(n, c, m, k, c // 8)
           for _, n, c, m, k in GROUP_MAX_STEP_SHAPES]
    assert got == [(512, 15360, 8), (256, 7680, 16), (128, 3840, 32), (39, 1024, 105),
                   (91, 4096, 45), (256, 16384, 16)]
    for (rows, chunk, _), (_, n, c, m, k) in zip(got, GROUP_MAX_STEP_SHAPES):
        assert 2 * kernels.group_max_backward_smem(rows, chunk, c) <= kernels.SM_SMEM


@pytest.mark.parametrize("B,np_,nq", CHAMFER_STEP_SHAPES + [
    (2, 96, 50), (1, 1, 1), (2, 300, 5000), (1, 5000, 300), (70000, 8, 8)])
def test_chamfer_backward_plan_covers_points_and_entries(B, np_, nq):
    rows, chunk = kernels.chamfer_backward_plan(np_, nq)
    assert 1 <= rows <= kernels.CHAMFER_BWD_ROWS         # a thread a point
    assert 1 <= chunk <= kernels.CHAMFER_BWD_CHUNK
    assert chunk <= kernels.CHAMFER_BWD_ROWS * kernels.LIST_STEPS  # keys held in registers
    smem = 16 * (-(-_list_ints(kernels.CHAMFER_BWD_ROWS // 32, rows) // 4) + chunk)
    assert smem <= kernels.MAX_SMEM
    if B < 1000:
        _check_cover(B, np_, rows, nq, chunk, kernels.CHAMFER_BWD_ROWS // 32)
    if nq <= kernels.CHAMFER_BWD_CHUNK:
        assert chunk == nq


def _block_lists(rows_of, e0, e1, r0, m):
    """Each row's list of a block's chunk: its entries ascending."""
    es = np.arange(e0, e1)
    sel = es[(rows_of[es] >= r0) & (rows_of[es] < r0 + m)]
    return {q: sel[rows_of[sel] == r0 + q] for q in range(m)}


def _group_max_mirror(g, idx, slot, n, plan):
    """gather.cu's group_max_backward_kernel in numpy, float32 adds in its
    order: each block's chunks ascending, each row's list ascending."""
    rows, chunk = plan[:2]
    B, M, C = g.shape
    k = idx.shape[2]
    E = M * k
    d = np.empty((B, n, C), np.float32)
    for b in range(B):
        flat = idx[b].reshape(-1).astype(np.int64)
        bad = (flat < 0) | (flat >= n)
        rows_of = np.where(bad, 0, flat)
        bad_channel = (slot[b] >= k).any(axis=0)
        for r0 in range(0, n, rows):
            m = min(n, r0 + rows) - r0
            acc = np.zeros((m, C), np.float32)
            for e0 in range(0, max(E, 1), chunk):
                for q, lst in _block_lists(rows_of, e0, min(E, e0 + chunk), r0, m).items():
                    for e in lst:
                        pt, j = divmod(int(e), k)
                        hit = slot[b, pt] == j
                        term = np.full(C, np.nan, np.float32) if bad[e] else g[b, pt]
                        acc[q, hit] = acc[q, hit] + term[hit]
            if r0 == 0:
                acc[0, bad_channel] = np.nan
            d[b, r0:r0 + m] = acc
    return d


def _chamfer_mirror(p, q, ip, gp, iq, gq, plan):
    """chamfer.cu's chamfer_backward_kernel for one side in numpy."""
    rows, chunk = plan
    B, NP, _ = p.shape
    NQ = q.shape[1]
    two = np.float32(2)
    dp = np.empty_like(p)
    for b in range(B):
        v = iq[b].astype(np.int64)
        bad = (v < 0) | (v >= NP)
        rows_of = np.where(bad, 0, v)
        for r0 in range(0, NP, rows):
            m = min(NP, r0 + rows) - r0
            s = np.zeros((m, 3), np.float32)
            for e0 in range(0, max(NQ, 1), chunk):
                for i, lst in _block_lists(rows_of, e0, min(NQ, e0 + chunk), r0, m).items():
                    for e in lst:
                        term = (two * gq[b, e]) * (q[b, e] - p[b, r0 + i])
                        s[i] = s[i] + (np.full(3, np.nan, np.float32) if bad[e] else term)
            for i in range(m):
                j = int(ip[b, r0 + i])
                own = ((two * gp[b, r0 + i]) * (p[b, r0 + i] - q[b, j]) if 0 <= j < NQ
                       else np.full(3, np.nan, np.float32))
                dp[b, r0 + i] = own - s[i]
    return dp


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


@pytest.mark.parametrize("plan", [None, (7, 40, 1), (64, 1, 1)])
def test_group_max_mirror_equals_the_plain_backward(plan):
    """The kernel's order, with one chunk or several (a later chunk adding
    to the rows the earlier ones stored), and row ranges that split the
    rows unevenly, equals ``ref.group_max_backward`` bitwise."""
    rng = np.random.default_rng(11)
    B, n, C, M, k = 2, 30, 8, 20, 5
    f = np.round(rng.random((B, n, C)) * 4).astype(np.float32)   # ties
    idx = rng.integers(0, n, (B, M, k)).astype(np.int32)
    idx[:, :4] = 3                                              # a long list
    g = rng.standard_normal((B, M, C)).astype(np.float32)
    _, slot = ref.group_max(torch.from_numpy(f), torch.from_numpy(idx))
    want = ref.group_max_backward(torch.from_numpy(g), torch.from_numpy(idx), slot, n)
    plan = plan or kernels.group_max_backward_plan(n, C, M, k, C // 8)
    got = _group_max_mirror(g, idx, slot.numpy(), n, plan)
    np.testing.assert_array_equal(_bits(got), _bits(want.numpy()))


def test_group_max_mirror_out_of_range_index_and_slot():
    """An index outside [0, n) adds NaN to row 0 where its slot names it; a
    slot outside [0, k) routes nothing and sets NaN in row 0 of its
    channel; everything else as the plain backward of the valid part."""
    rng = np.random.default_rng(12)
    B, n, C, M, k = 1, 9, 4, 6, 3
    idx = rng.integers(1, n, (B, M, k)).astype(np.int32)
    slot = rng.integers(0, k, (B, M, C)).astype(np.uint8)
    g = rng.standard_normal((B, M, C)).astype(np.float32)
    idx[0, 2, 1] = n + 4
    slot[0, 2, :] = [1, 0, 1, 2]                 # channels 0 and 2 take the bad edge
    slot[0, 4, 3] = 200                          # channel 3 outside [0, k)
    got = _group_max_mirror(g, idx, slot, n, (4, 5, 4))
    ok_idx, ok_slot, ok_g = idx.copy(), slot.copy(), g.copy()
    ok_idx[0, 2, 1] = 0
    ok_g[0, 2, [0, 2]] = 0                       # zeros add nothing to a sum
    ok_slot[0, 4, 3], ok_g[0, 4, 3] = 0, 0
    want = ref.group_max_backward(*map(torch.from_numpy, (ok_g, ok_idx, ok_slot)), n).numpy()
    want[0, 0, [0, 2, 3]] = np.nan
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("plan", [None, (5, 3), (16, 1)])
def test_chamfer_mirror_equals_the_plain_backward(plan):
    """The kernel's order for db of ``chamfer_distance(gt, pred)``, a
    collapsed prediction (one point the argmin of most of gt) included,
    with one chunk of iq or several, equals ``ref.chamfer_backward``
    bitwise."""
    rng = np.random.default_rng(13)
    gt = rng.random((2, 40, 3)).astype(np.float32)
    pred = rng.random((2, 23, 3)).astype(np.float32)
    pred[0, :10] = pred[0, :1] + 0.5
    a, b = torch.from_numpy(gt), torch.from_numpy(pred)
    d1, d2, i1, i2 = ref.chamfer_distance(a, b)
    g1 = torch.from_numpy(rng.standard_normal(d1.shape).astype(np.float32))
    g2 = torch.from_numpy(rng.standard_normal(d2.shape).astype(np.float32))
    _, want = ref.chamfer_backward(a, b, i1, g1, i2, g2, False, True)
    plan = plan or kernels.chamfer_backward_plan(23, 40)
    got = _chamfer_mirror(pred, gt, i2.numpy(), g2.numpy(), i1.numpy(), g1.numpy(), plan)
    np.testing.assert_array_equal(_bits(got), _bits(want.numpy()))


def test_chamfer_mirror_out_of_range_indices():
    """An argmin outside the other cloud makes a point's own term NaN; one
    outside p is listed under point 0, whose sum turns NaN."""
    rng = np.random.default_rng(14)
    p = rng.random((1, 6, 3)).astype(np.float32)
    q = rng.random((1, 5, 3)).astype(np.float32)
    ip = rng.integers(0, 5, (1, 6)).astype(np.int32)
    iq = rng.integers(1, 6, (1, 5)).astype(np.int32)
    gp = rng.standard_normal((1, 6)).astype(np.float32)
    gq = rng.standard_normal((1, 5)).astype(np.float32)
    ip[0, 4], iq[0, 2] = 7, -1
    got = _chamfer_mirror(p, q, ip, gp, iq, gq, (4, 2))
    assert np.isnan(got[0, 0]).all() and np.isnan(got[0, 4]).all()
    fine = [1, 2, 3, 5]
    ok_ip, ok_iq, ok_gq = ip.copy(), iq.copy(), gq.copy()
    ok_ip[0, 4], ok_iq[0, 2], ok_gq[0, 2] = 0, 0, 0
    _, want = ref.chamfer_backward(*map(torch.from_numpy, (q, p, ok_iq, ok_gq, ok_ip, gp)),
                                   False, True)
    np.testing.assert_array_equal(_bits(got[0, fine]), _bits(want.numpy()[0, fine]))
