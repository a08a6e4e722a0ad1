"""Chamfer forward of the torch port against the JAX package.

The port's plain version (``ops/ref.py``) is held against the Pallas kernel
in interpret mode (as ``test_pallas_kernels.py`` runs it) and against the
float64 oracle; the CUDA kernel is held against the plain version on the
card in ``test_torch_cuda.py`` and ``chip_smoke.py``.
All inputs come from numpy with a seed and are fp32.
"""

import numpy as np
import pytest
import torch

from mvp_benchmark_tpu.ops import pallas_kernels
from mvp_benchmark_tpu_torch.ops import dispatch, kernels, ref
from tests.util_clouds import (clouds, clouds_with_duplicates,
                                clouds_without_near_ties)
from tests.util_np import chamfer_np

SHAPES = [(2, 128, 96), (2, 96, 50)]


def port_ref(a, b):
    d1, d2, i1, i2 = ref.chamfer_distance(torch.from_numpy(a), torch.from_numpy(b))
    return d1.numpy(), d2.numpy(), i1.numpy(), i2.numpy()


def assert_index_reproduces(a, b, dist, idx):
    for k in range(a.shape[0]):
        sel = b[k][idx[k]]
        np.testing.assert_allclose(np.sum((a[k] - sel) ** 2, -1), dist[k],
                                   rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("shape", SHAPES)
def test_ref_matches_pallas_interpret(shape):
    a, b = clouds(0, *shape)
    d1, d2, i1, i2 = port_ref(a, b)
    p1, p2, j1, j2 = (np.asarray(t) for t in pallas_kernels.chamfer_distance(a, b))
    np.testing.assert_allclose(d1, p1, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(d2, p2, rtol=1e-5, atol=1e-7)
    assert i1.dtype == np.int32 and i2.dtype == np.int32
    assert d1.shape == shape[:2] and d2.shape == (shape[0], shape[2])
    assert_index_reproduces(a, b, p1, i1)
    assert_index_reproduces(b, a, p2, i2)


@pytest.mark.parametrize("shape", SHAPES)
def test_ref_matches_float64_oracle(shape):
    a, b = clouds_without_near_ties(*shape)
    d1, d2, i1, i2 = port_ref(a, b)
    o1, o2, k1, k2 = chamfer_np(a, b)
    # BASELINE.md's bar for the chamfer op: dist MSE < 1e-8.
    assert np.mean((d1 - o1) ** 2) < 1e-8
    assert np.mean((d2 - o2) ** 2) < 1e-8
    np.testing.assert_array_equal(i1, k1)
    np.testing.assert_array_equal(i2, k2)


def test_ties_go_to_lower_index():
    a, b = clouds_with_duplicates()
    d1, d2, i1, i2 = port_ref(a, b)
    o1, o2, k1, k2 = chamfer_np(a, b)      # numpy argmin: first minimum
    np.testing.assert_array_equal(i1, k1)
    np.testing.assert_array_equal(i2, k2)
    assert (i1[:, 0:10] == np.arange(10)).all()     # not the copies at 20..29
    assert (d1[:, 0:10] == 0.0).all()
    p1, p2, j1, j2 = (np.asarray(t) for t in pallas_kernels.chamfer_distance(a, b))
    np.testing.assert_array_equal(i1, j1)
    np.testing.assert_array_equal(i2, j2)


def test_cpu_dispatch_takes_plain_version(monkeypatch):
    def no_kernel(*args):
        raise AssertionError("CPU tensors must not reach ops/kernels.py")

    monkeypatch.setattr(kernels, "chamfer_distance", no_kernel)
    monkeypatch.setattr(kernels, "chamfer_forward", no_kernel)
    before = kernels.CHAMFER_LAUNCHES
    a, b = clouds(1, 2, 32, 24)
    out = dispatch.chamfer_distance(torch.from_numpy(a), torch.from_numpy(b))
    for x, y in zip(out, port_ref(a, b)):
        np.testing.assert_array_equal(x.numpy(), y)
    assert kernels.CHAMFER_LAUNCHES == before


def test_kernel_wrapper_rejects_cpu_tensors():
    a, b = (torch.from_numpy(x) for x in clouds(1, 2, 32, 24))
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.chamfer_forward(a, b)


def test_autograd_function_forward_and_backward(monkeypatch):
    """The autograd wrapper around the kernels: forward returns the
    launcher's outputs, indices are not differentiable, and the backward
    launches ``chamfer_backward`` for the clouds that need a gradient (here
    the plain versions stand in for the launchers)."""
    calls = []

    def backward(*args):
        calls.append(args[6:])
        return ref.chamfer_backward(*args)

    monkeypatch.setattr(kernels, "chamfer_forward", ref.chamfer_distance)
    monkeypatch.setattr(kernels, "chamfer_backward", backward)
    a, b = (torch.from_numpy(x) for x in clouds(2, 2, 32, 24))
    with torch.inference_mode():
        out = kernels.chamfer_distance(a, b)
    for x, y in zip(out, ref.chamfer_distance(a, b)):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    a.requires_grad_(True)
    d1, d2, i1, i2 = kernels.chamfer_distance(a, b)
    assert not i1.requires_grad and not i2.requires_grad
    (d1.sum() + 2 * d2.sum()).backward()
    assert calls == [(True, False)]
    want = ref.chamfer_backward(a.detach(), b, i1, torch.ones_like(d1), i2,
                                torch.full_like(d2, 2.0))[0]
    torch.testing.assert_close(a.grad, want, rtol=0, atol=0)


@pytest.mark.parametrize("shape", [(2, 256, 128), (2, 128, 256)])
def test_backward_matches_the_gated_off_masked_reduction_kernel(shape):
    """PERF.md row 3: ``_chamfer_bwd_dir`` (``pallas_kernels.py:222``, gated
    off by ``CHAMFER_BWD_PALLAS``) computes the chamfer gradient as masked
    reductions; ``ref.chamfer_backward``, the contract of row 2's kernel,
    computes the same function (rtol 1e-5, atol 1e-6: sums in another
    order)."""
    a, b = clouds_without_near_ties(*shape)
    d1, d2, i1, i2 = ref.chamfer_distance(torch.from_numpy(a), torch.from_numpy(b))
    rng = np.random.default_rng(7)
    g1 = rng.random(tuple(d1.shape), dtype=np.float64).astype(np.float32)
    g2 = rng.random(tuple(d2.shape), dtype=np.float64).astype(np.float32)
    i1n, i2n = i1.numpy(), i2.numpy()
    want_a = np.asarray(pallas_kernels._chamfer_bwd_dir(a, b, i1n, g1, i2n, g2))
    want_b = np.asarray(pallas_kernels._chamfer_bwd_dir(b, a, i2n, g2, i1n, g1))
    da, db = ref.chamfer_backward(torch.from_numpy(a), torch.from_numpy(b), i1,
                                  torch.from_numpy(g1), i2, torch.from_numpy(g2))
    np.testing.assert_allclose(da.numpy(), want_a, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(db.numpy(), want_b, rtol=1e-5, atol=1e-6)


def test_part_entries_cover_every_row_block_and_column():
    """The forward's scratch: a column partial for every block of 256 rows
    of the larger cloud and every point of the smaller."""
    assert kernels.chamfer_part_entries(32, 2048, 2048) == 32 * 8 * 2048
    assert kernels.chamfer_part_entries(64, 1024, 2048) == 64 * 8 * 1024
    assert kernels.chamfer_part_entries(64, 3072, 2048) == 64 * 12 * 2048
    assert kernels.chamfer_part_entries(3, 1001, 2049) == 3 * 9 * 1001
