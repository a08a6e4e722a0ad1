"""The one-launch backwards of ``chamfer_backward`` (``csrc/chamfer.cu``),
``group_max_backward`` and ``three_interpolate_backward``
(``csrc/gather.cu``), and group_max's forward, on the CPU: their launch
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
``ref.group_max_backward`` / ``ref.three_interpolate_backward`` bitwise, a
later chunk added to what the earlier ones left (the kernels hold the same
on the card, ``tests/test_torch_cuda.py``, ``chip_smoke.py``). group_max's
forward stages a slice of the table where its plan says so and compares in
ascending j: the plan covers every channel once, and the order of
compares, mirrored, equals ``ref.group_max``.
"""

import numpy as np
import pytest
import torch

from mvp_benchmark_tpu_torch.ops import kernels, ref

# (B, n rows, c, m points, k): the VRCNet step's three, ECG's three
GROUP_MAX_STEP_SHAPES = [(64, 3072, 64, 1536, 10), (64, 1536, 128, 768, 10),
                         (64, 768, 256, 384, 10), (32, 256, 840, 64, 16),
                         (32, 1024, 360, 256, 16), (32, 3072, 120, 1024, 16)]
# (B, Ms rows, c, N targets): three_interpolate's backward in the VRCNet
# step's three calls and ECG's three
TI_STEP_SHAPES = [(64, 384, 512, 768), (64, 768, 256, 1536), (64, 1536, 128, 3072),
                  (32, 64, 1024, 256), (32, 256, 768, 1024), (32, 1024, 512, 3072)]
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


@pytest.mark.parametrize("B,ms,c,n", TI_STEP_SHAPES + [
    (2, 37, 5, 101), (2, 64, 16, 512), (1, 4000, 8, 7000), (3, 1, 4, 5),
    (1, 50, 2048, 30), (70000, 24, 8, 24), (2, 100, 16, 341), (2, 100, 16, 342)])
def test_three_interpolate_backward_plan_covers_rows_and_entries(B, ms, c, n):
    """The one-launch form at every shape: each (cloud, row) of d_f written
    by one block, each chunk's entries held by one lane each, the shared
    memory within ``MAX_SMEM``; a cloud of at most ``TI_BWD_CHUNK`` entries
    in one chunk; rows inside one warp. The plan takes it for clouds of at
    most ``TI_BWD_LOCAL_ENTRIES`` entries, else the list form."""
    vectors = c // 8 if c % 8 == 0 else c
    rows, chunk, lanes = kernels.three_interpolate_backward_local_plan(ms, c, n, vectors)
    assert kernels.three_interpolate_backward_plan(ms, c, n, vectors) == (
        (rows, chunk, lanes) if 3 * n <= kernels.TI_BWD_LOCAL_ENTRIES else (0, 0, 0))
    assert 1 <= rows <= ms
    assert vectors <= lanes < 2 * vectors
    assert lanes >= 32 or 32 % lanes == 0
    assert B * -(-ms // rows) < 2 ** 31
    assert 1 <= chunk <= kernels.TI_BWD_CHUNK
    assert kernels.three_interpolate_backward_smem(rows, chunk) \
        == 4 * (_list_ints(kernels.TI_BWD_WARPS, rows) + chunk) <= kernels.MAX_SMEM
    if B < 1000 and 3 * n < 50000:
        _check_cover(B, ms, rows, 3 * n, chunk, kernels.TI_BWD_WARPS)
    if 3 * n <= kernels.TI_BWD_CHUNK:
        assert chunk == 3 * n                         # one chunk: d_f written once


def _ti_mirror(g, idx, w, ms, plan):
    """gather.cu's three_interpolate_backward_local_kernel in numpy, float32
    products and adds in its order: each block's chunks ascending, each
    row's list ascending, an out-of-range entry adding NaN to row 0."""
    rows, chunk = plan[:2]
    B, N, C = g.shape
    E = 3 * N
    d = np.empty((B, ms, C), np.float32)
    for b in range(B):
        flat = idx[b].reshape(-1).astype(np.int64)
        bad = (flat < 0) | (flat >= ms)
        rows_of = np.where(bad, 0, flat)
        wf = w[b].reshape(-1)
        for r0 in range(0, ms, rows):
            m = min(ms, r0 + rows) - r0
            acc = np.zeros((m, C), np.float32)
            for e0 in range(0, max(E, 1), chunk):
                for q, lst in _block_lists(rows_of, e0, min(E, e0 + chunk), r0, m).items():
                    for e in lst:
                        term = (np.full(C, np.nan, np.float32) if bad[e]
                                else g[b, e // 3] * wf[e])
                        acc[q] = acc[q] + term
            d[b, r0:r0 + m] = acc
    return d


def _ti_inputs(seed, B, ms, c, n):
    rng = np.random.default_rng(seed)
    idx, w = ref.three_nn_upsampling(torch.from_numpy(rng.random((B, n, 3), np.float32)),
                                     torch.from_numpy(rng.random((B, ms, 3), np.float32)))
    g = rng.standard_normal((B, n, c)).astype(np.float32)
    return g, idx.numpy(), w.numpy()


@pytest.mark.parametrize("plan", [None, (7, 40, 1), (64, 5, 1)])
@pytest.mark.parametrize("case", ["three_nn", "whole_cloud_to_row_0"])
def test_three_interpolate_mirror_equals_the_plain_backward(plan, case):
    """The kernel's order, with one chunk or several (a later chunk adding
    to the rows the earlier ones stored), row ranges that split the rows
    unevenly, and a cloud whose every entry names row 0, equals
    ``ref.three_interpolate_backward`` bitwise."""
    B, ms, c, n = 2, 30, 8, 60
    g, idx, w = _ti_inputs(21, B, ms, c, n)
    if case == "whole_cloud_to_row_0":
        idx[1] = 0
    f = np.zeros((B, ms, c), np.float32)
    want, _ = ref.three_interpolate_backward(*map(torch.from_numpy, (g, idx, w, f)), False)
    plan = plan or kernels.three_interpolate_backward_local_plan(ms, c, n, c // 8)
    got = _ti_mirror(g, idx, w, ms, plan)
    np.testing.assert_array_equal(_bits(got), _bits(want.numpy()))


def test_three_interpolate_mirror_out_of_range_index():
    """An index outside [0, ms) is listed under row 0, which turns NaN; the
    other rows are the plain backward of the valid entries."""
    B, ms, c, n = 2, 20, 4, 40
    g, idx, w = _ti_inputs(22, B, ms, c, n)
    idx[0, 5, 2], idx[1, 9, 0] = ms + 1, -3
    got = _ti_mirror(g, idx, w, ms, (6, 50, 4))
    ok_idx, ok_g = idx.copy(), g.copy()
    ok_idx[0, 5, 2] = ok_idx[1, 9, 0] = 0
    f = np.zeros((B, ms, c), np.float32)
    want, _ = ref.three_interpolate_backward(*map(torch.from_numpy, (ok_g, ok_idx, w, f)),
                                             False)
    want = want.numpy()
    want[:, 0] = np.nan
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("B,n,c,m,k", GROUP_MAX_STEP_SHAPES + [
    (2, 300, 24, 100, 1), (2, 300, 24, 100, 17), (2, 300, 8, 40, 255),
    (3, 97, 5, 41, 7), (2, 50, 1, 30, 255), (2, 40, 2048, 5, 16),
    (2, 20000, 24, 500, 10), (1, 70000, 5, 30, 255)])
@pytest.mark.parametrize("kk", [None, 1, 10, 16, 17, 255])
def test_group_max_forward_plan(B, n, c, m, k, kk):
    """At the VRCNet and ECG steps' shapes, and with k 1 / 10 / 16 / 17 /
    255: staged where the widest slice that fits in
    ``GROUP_MAX_STAGE_SMEM`` (8 channels a step, 4 or 1 where C is not a
    multiple of 8) holds the row, or ``GROUP_MAX_STAGE_MIN`` channels in at
    most ``GROUP_MAX_STAGE_SLICES`` slices: every channel in one slice, the
    grid within int32, the loop over j unrolled at k 10 and 16 only; else
    direct."""
    k = kk or k
    vec = 4 if c % 4 == 0 else 1
    step = 8 if c % 8 == 0 else vec
    widest = min(c, kernels.GROUP_MAX_STAGE_SMEM // (4 * n) // step * step)
    got_vec, cs, unroll = kernels.group_max_forward_plan(n, c, k, vec)
    assert got_vec == vec
    staged = widest == c or (widest >= kernels.GROUP_MAX_STAGE_MIN and
                             -(-c // widest) <= kernels.GROUP_MAX_STAGE_SLICES)
    if not staged:
        assert (cs, unroll) == (0, 0)
        return
    assert cs == widest and cs % vec == 0
    assert 4 * n * cs <= kernels.GROUP_MAX_STAGE_SMEM
    slices = -(-c // cs)
    assert (slices - 1) * cs < c <= slices * cs       # every channel, no empty slice
    assert B * slices < 2 ** 31
    assert unroll == (k if k in (10, 16) else 0)


def test_group_max_forward_plan_at_the_vrcnet_and_ecg_steps():
    """VRCNet's levels 2 and 3 and ECG's smallest table are staged in 8
    slices of 16, 32 and 112 channels; the two tables of 3072 rows (slices
    of 8 channels) and ECG's of 1024 rows by 360 (15 slices) are direct."""
    got = [kernels.group_max_forward_plan(n, c, k, 4) for _, n, c, _, k in
           GROUP_MAX_STEP_SHAPES]
    assert got == [(4, 0, 0), (4, 16, 10), (4, 32, 10), (4, 112, 16), (4, 0, 0), (4, 0, 0)]


def _group_max_forward_mirror(f, idx):
    """gather.cu's group_max kernels for one thread's channels, in numpy:
    a chain of compares in ascending j with a strict ``>`` (unrolled for k
    or not, the kernels compare in this order), an out-of-range index
    read as row 0 and setting NaN and slot 255 in its row."""
    B, M, k = idx.shape
    n, C = f.shape[1:]
    out = np.zeros((B, M, C), np.float32)
    slot = np.zeros((B, M, C), np.uint8)
    for b in range(B):
        for r in range(M):
            acc, sl = np.zeros(C, np.float32), np.zeros(C, np.uint8)
            bad = False
            for j in range(k):
                src = int(idx[b, r, j])
                bad |= not 0 <= src < n
                v = f[b, src if 0 <= src < n else 0]
                take = np.ones(C, bool) if j == 0 else v > acc
                acc, sl = np.where(take, v, acc), np.where(take, j, sl).astype(np.uint8)
            out[b, r], slot[b, r] = (np.nan, 255) if bad else (acc, sl)
    return out, slot


@pytest.mark.parametrize("k", [1, 10, 17])
def test_group_max_forward_mirror_equals_the_plain_version(k):
    """The chain of compares gives ``ref.group_max`` bitwise, ties (relu'd
    features, a neighbour twice) and a NaN row at j = 0 and later
    included; an out-of-range index sets NaN and slot 255 in its row."""
    rng = np.random.default_rng(23)
    B, n, C, M = 2, 40, 6, 12
    f = np.maximum(rng.random((B, n, C), np.float32) - 0.5, 0).astype(np.float32)
    f[0, 5] = np.nan
    idx = rng.integers(0, n, (B, M, k)).astype(np.int32)
    idx[:, :, k - 1] = idx[:, :, 0]
    idx[0, 3, 0] = 5
    if k > 1:
        idx[0, 4, 1] = 5
    got, got_slot = _group_max_forward_mirror(f, idx)
    want, want_slot = ref.group_max(torch.from_numpy(f), torch.from_numpy(idx))
    np.testing.assert_array_equal(_bits(got), _bits(want.numpy()))
    np.testing.assert_array_equal(got_slot, want_slot.numpy())
    idx[1, 2, k // 2] = n + 3
    got, got_slot = _group_max_forward_mirror(f, idx)
    assert np.isnan(got[1, 2]).all() and (got_slot[1, 2] == 255).all()
