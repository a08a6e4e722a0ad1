"""The reverse lists behind the completion backwards' gathers, and the
launch plans of the local scatter and the SA backward, on the CPU.

``ref.reverse_list`` is the plain version of ``csrc/reverse_list.cu``
(held bitwise against it on the card, ``tests/test_torch_cuda.py``): every
row's entries in ascending order, a stable sort of the index. Here it is
held against numpy's stable argsort, and a gather that walks it in order
against the scatter it replaces. The plans are host functions of the shape:
``kernels.reverse_list_plan`` and ``kernels.sa_backward_plan`` against the
shared memory a block may opt in to, ``kernels.scatter_plan`` against the
local kernel's fixed tables.
"""

import numpy as np
import pytest
import torch

from mvp_benchmark_tpu_torch.ops import kernels, ref


def _numpy_list(rows, num_rows):
    """(order, off) of rows (B, E) in [0, num_rows) by a stable argsort."""
    B = rows.shape[0]
    keys = (rows + np.arange(B)[:, None] * num_rows).reshape(-1)
    order = np.argsort(keys, kind="stable")
    off = np.searchsorted(keys[order], np.arange(B * num_rows + 1), side="left")
    return order, off


def _index(seed, high, shape):
    return np.random.default_rng(seed).integers(0, high, shape).astype(np.int32)


@pytest.mark.parametrize("shape,num_rows,case", [
    ((3, 41, 7), 97, "random"), ((2, 100), 64, "random"), ((1, 5, 3), 1000, "random"),
    ((4, 33, 5), 50, "unpointed_row"), ((2, 64, 16), 64, "one_row"),
    ((5, 1), 3, "random")])
def test_reverse_list_equals_a_stable_argsort(shape, num_rows, case):
    """Ragged B, M and k, a (B, M) index, a row nobody points at, and every
    index equal to one row."""
    idx = _index(1, num_rows, shape)
    if case == "unpointed_row":
        idx[idx == 7] = 8
    elif case == "one_row":
        idx[:] = 3
    order, off = ref.reverse_list(torch.from_numpy(idx), num_rows)
    assert order.dtype == off.dtype == torch.int32
    want_order, want_off = _numpy_list(idx.reshape(shape[0], -1), num_rows)
    np.testing.assert_array_equal(order.numpy(), want_order)
    np.testing.assert_array_equal(off.numpy(), want_off)
    if case == "unpointed_row":
        assert all(off[b * num_rows + 8] == off[b * num_rows + 7] for b in range(shape[0]))
    if case == "one_row":
        E = idx[0].size
        assert [int(off[b * num_rows + 4] - off[b * num_rows + 3])
                for b in range(shape[0])] == [E] * shape[0]


def test_reverse_list_lists_an_index_out_of_range_under_row_0():
    idx = _index(2, 20, (2, 10, 3))
    idx[0, 4, 1], idx[1, 9, 2] = -1, 20
    order, off = ref.reverse_list(torch.from_numpy(idx), 20)
    rows = idx.reshape(2, -1).copy()
    rows[(rows < 0) | (rows >= 20)] = 0
    want_order, want_off = _numpy_list(rows, 20)
    np.testing.assert_array_equal(order.numpy(), want_order)
    np.testing.assert_array_equal(off.numpy(), want_off)
    assert 4 * 3 + 1 in order[off[0]:off[1]].tolist()
    assert 30 + 9 * 3 + 2 in order[off[20]:off[21]].tolist()


@pytest.mark.parametrize("shape,num_rows,channels", [((3, 41, 7), 97, 5),
                                                     ((2, 300), 20, 3)])
def test_gather_over_the_list_equals_the_scatter_bitwise(shape, num_rows, channels):
    """Walking each row's list in order and adding in float32 from 0 is the
    scatter-add of ``ref.scatter_add_rows`` (``index_add_`` on the CPU),
    bit for bit: the order the completion backwards' gathers sum in."""
    idx = _index(5, num_rows, shape)
    g = np.random.default_rng(6).standard_normal((*shape, channels)).astype(np.float32)
    order, off = ref.reverse_list(torch.from_numpy(idx), num_rows)
    flat = g.reshape(-1, channels)
    out = np.zeros((shape[0] * num_rows, channels), np.float32)
    for r in range(shape[0] * num_rows):
        for e in order[off[r]:off[r + 1]].tolist():
            out[r] = out[r] + flat[e]
    want = ref.scatter_add_rows(torch.from_numpy(g), torch.from_numpy(idx), num_rows)
    np.testing.assert_array_equal(out.reshape(shape[0], num_rows, channels), want.numpy())


@pytest.mark.parametrize("entries,num_rows,plan", [
    (2448, 2048, (5, 1)), (2048, 3072, (4, 1)), (9216, 1536, (18, 1)),
    (49152, 3072, (32, 2)), (49152, 1536, (32, 1)), (1, 1, (1, 1)),
    (300, 70000, (1, 2)), (6144, 70000, (12, 15))])
def test_reverse_list_plan_fits_its_counts_in_shared_memory(entries, num_rows, plan):
    """A warp a 512 entries (at most 32), and the fewest blocks a cloud
    whose rows' counts, one a warp and row, fit in the shared memory a block
    may opt in to: ECG's uniform-loss scatter, the chamfer list, VRCNet's
    three_interpolate and SA level 1 (two blocks a cloud), and 70000 rows."""
    assert kernels.reverse_list_plan(entries, num_rows) == plan
    warps, blocks = plan
    budget = kernels.MAX_SMEM - 1024
    assert 4 * warps * -(-num_rows // blocks) <= budget
    assert blocks == 1 or 4 * warps * -(-num_rows // (blocks - 1)) > budget


# VRCNet's four SA levels in its train step (batch 64): (N, k, rel, mid),
# level i on 3072 / 2^i points at the kernel's i-th widths
_LEVELS = [(3072 >> i, 16, rel, mid) for i, (rel, mid, _) in enumerate(kernels.SA_LEVELS)]


@pytest.mark.parametrize("n,k,rel,mid", _LEVELS + [(384, 32, 32, 128), (97, 8, 4, 16)])
def test_sa_backward_plan_fits_shared_memory(n, k, rel, mid):
    """At every level, and at k 32 on level 4: the tile fits in MAX_SMEM,
    the next larger warp count of SA_BWD_WARPS would not, and the grid has
    at least one block and at most one a tile."""
    warps, grid, smem = kernels.sa_backward_plan(64, n, k, rel, mid, 8, 132)
    rel_lanes = 32 // rel
    assert warps in kernels.SA_BWD_WARPS
    assert smem == kernels._sa_bwd_smem(rel, mid // 8, k, warps * rel_lanes) <= kernels.MAX_SMEM
    bigger = [w for w in kernels.SA_BWD_WARPS if w > warps]
    if bigger:
        assert kernels._sa_bwd_smem(rel, mid // 8, k, min(bigger) * rel_lanes) > kernels.MAX_SMEM
    assert 1 <= grid <= -(-64 * n // (warps * rel_lanes))


def test_sa_backward_plan_at_the_train_step_levels():
    """16 warps at all four levels at k 16, two blocks an SM at levels 1-2
    (registers), one at 3-4 (level 4: 159 KB); k 32 at level 4 drops to 4
    warps (231 KB)."""
    plans = [kernels.sa_backward_plan(64, n, k, rel, mid, 8, 132) for n, k, rel, mid in _LEVELS]
    assert [p[0] for p in plans] == [16, 16, 16, 16]
    assert [p[1] for p in plans] == [264, 264, 132, 132]
    assert kernels.sa_backward_plan(64, 384, 32, 32, 128, 8, 132)[:2] == (4, 132)
    assert kernels.sa_backward_plan(64, 384, 32, 32, 128, 8, 132)[2] == 230928


@pytest.mark.parametrize("entries,num_rows,vectors,plan", [
    (48, 24, 3, (24, 1)), (2448, 2048, 3, (256, 3)), (1024, 3072, 30, (68, 8)),
    (2048, 3072, 3, (256, 3)), (1536, 3072, 16, (128, 8)), (8192, 300, 1, (256, 8)),
    (8193, 3072, 6, (0, 0)), (49152, 3072, 6, (0, 0)), (0, 5, 1, (5, 1))])
def test_scatter_plan_picks_the_local_form_for_small_clouds(entries, num_rows, vectors,
                                                            plan):
    """ECG's uniform-loss kNN and grouping gathers, a sampled centres'
    gather, the last FPS's gather and VRCNet's centre gather take the local
    form; past 8192 entries a cloud (DenseEdge's neighbour gather) the list
    and the gather. A block lists at most 256 rows with at most 8 warps."""
    got = kernels.scatter_plan(entries, num_rows, vectors)
    assert got == plan
    rows, warps = got
    if rows:
        assert entries <= kernels.SCATTER_LOCAL_ENTRIES
        assert 1 <= rows <= min(num_rows, kernels.SCATTER_LOCAL_ROWS)
        assert 1 <= warps <= kernels.SCATTER_LOCAL_WARPS
