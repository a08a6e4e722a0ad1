"""kNN of the torch port (``ref.knn`` and the ops on it) against the JAX
package, on the CPU.

The port's plain version is the contract of ``csrc/knn.cu`` (held against it
on the card in ``test_torch_cuda.py`` and ``chip_smoke.py``). Here it is held
against ``jnp_ref``, against the Pallas kernel in interpret mode at an
unaligned N (where ``_knn_kernel`` takes its exact argmin sweeps,
``pallas_kernels.py:686-692``; C <= 8 only) and against the float64 oracle
``util_np.knn_np``. Inputs are seeded numpy, fp32.

Tolerances: indices equal, on inputs whose k nearest are separated by a
margin (``util_clouds.knn_inputs_with_margin``) that covers fp32 rounding and
``jnp_ref``'s |a|^2+|b|^2-2a.b expansion; distances rtol 1e-5 / atol 1e-7
against the exact computations (Pallas interpret, float64 oracle), and the
3-NN upsampling weights rtol 1e-6 against the float64 oracle. Against
``jnp_ref`` the distances carry its expansion's absolute error (a few ulp of
|a|^2 + |b|^2), which the test bounds by that: 8 ulp of the two norms.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvp_benchmark_tpu.ops import jnp_ref, pallas_kernels
from mvp_benchmark_tpu_torch import probe_knn_fps
from mvp_benchmark_tpu_torch.ops import dispatch, kernels, ref
from tests.util_clouds import knn_inputs_with_margin
from tests.util_np import knn_np

CASES = [  # (B, M, N, C, k)
    (2, 64, 96, 3, 16),
    (2, 40, 200, 3, 3),
    (2, 32, 96, 24, 16),
    (2, 24, 80, 48, 16),
]


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _expansion_bound(q, p):
    """Absolute error bound of jnp_ref.square_distance: 8 ulp of the larger
    |q|^2 + |p|^2 of each pair."""
    n2 = np.sum(q.astype(np.float64) ** 2, -1)[..., None] + \
        np.sum(p.astype(np.float64) ** 2, -1)[:, None, :]
    return 8 * np.spacing(n2.max().astype(np.float32))


@pytest.mark.parametrize("B,M,N,C,k", CASES)
def test_ref_matches_float64_oracle(B, M, N, C, k):
    q, p = knn_inputs_with_margin(B, M, N, C, k)
    d, idx = (x.numpy() for x in ref.knn(*_t(q, p), k))
    od, oidx = knn_np(q, p, k)
    assert idx.dtype == np.int32 and idx.shape == (B, M, k)
    np.testing.assert_array_equal(idx, oidx)
    np.testing.assert_allclose(d, od, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("B,M,N,C,k", CASES)
def test_ref_matches_jnp_ref(B, M, N, C, k):
    q, p = knn_inputs_with_margin(B, M, N, C, k)
    negd, idx = (x.numpy() for x in ref.knn_points(*_t(q, p), k))
    jnegd, jidx = (np.asarray(x) for x in jnp_ref.knn_points(q, p, k))
    np.testing.assert_array_equal(idx, jidx)
    np.testing.assert_allclose(negd, jnegd, rtol=0, atol=_expansion_bound(q, p))
    np.testing.assert_array_equal(ref.knn_indices(*_t(p), k).numpy(),
                                  np.asarray(jnp_ref.knn_indices(p, k)))
    np.testing.assert_array_equal(
        ref.knn_query(k, *_t(p, q)).numpy(),
        np.asarray(jnp_ref.knn_query(k, p, q)))


@pytest.mark.parametrize("B,M,N,C,k", [c for c in CASES if c[3] <= 8])
def test_ref_matches_pallas_interpret_at_unaligned_n(B, M, N, C, k):
    assert N % 128 != 0          # the kernel's exact argmin sweeps
    q, p = knn_inputs_with_margin(B, M, N, C, k)
    d, idx = (x.numpy() for x in ref.knn(*_t(q, p), k))
    pd, pidx = (np.asarray(x) for x in pallas_kernels.knn_pallas(
        jnp.asarray(q), jnp.asarray(p), k, exact_dist=True))
    np.testing.assert_array_equal(idx, pidx)
    np.testing.assert_allclose(d, pd, rtol=1e-5, atol=1e-7)


def test_three_nn_matches_jnp_ref_and_oracle():
    q, p = knn_inputs_with_margin(2, 96, 50, 3, 3)
    dist, idx = (x.numpy() for x in ref.three_nn(*_t(q, p)))
    jdist, jidx = (np.asarray(x) for x in jnp_ref.three_nn(q, p))
    np.testing.assert_array_equal(idx, jidx)
    od, oidx = knn_np(q, p, 3)
    np.testing.assert_array_equal(idx, oidx)
    np.testing.assert_allclose(dist, np.sqrt(od), rtol=1e-5, atol=1e-7)

    got_idx, w = (x.numpy() for x in ref.three_nn_upsampling(*_t(q, p)))
    np.testing.assert_array_equal(got_idx, jidx)
    inv = 1.0 / np.maximum(np.sqrt(od), 1e-10)
    np.testing.assert_allclose(w, inv / inv.sum(2, keepdims=True), rtol=1e-6)


def test_three_nn_upsampling_from_a_subset():
    """Upsampling from an FPS subset: every source point is also a target, at
    exact distance 0, so its weight is 1 up to the 1e-10 clamp."""
    q, _ = knn_inputs_with_margin(2, 120, 40, 3, 3)
    src = q[:, ::3].copy()
    idx, w = (x.numpy() for x in ref.three_nn_upsampling(*_t(q, src)))
    hit = np.arange(0, 120, 3)
    np.testing.assert_array_equal(idx[:, hit, 0], np.broadcast_to(np.arange(40), (2, 40)))
    assert (w[:, hit, 0] > 1 - 1e-6).all()
    np.testing.assert_allclose(w.sum(-1), 1.0, rtol=1e-6)


def test_duplicated_points_go_to_the_lower_index():
    rng = np.random.default_rng(7)
    p = rng.random((2, 96, 3), dtype=np.float64).astype(np.float32)
    p[:, 40:50] = p[:, 0:10]            # exact copies at higher indices
    p[:, 60] = p[:, 5]
    q = np.concatenate([p[:, :12], rng.random((2, 20, 3)).astype(np.float32)], 1)
    d, idx = (x.numpy() for x in ref.knn(*_t(q, p), 16))
    od, oidx = knn_np(q, p, 16)
    np.testing.assert_array_equal(idx, oidx)
    assert (idx[:, :10, 0] == np.arange(10)).all()
    assert (idx[:, :10, 1] == np.arange(40, 50)).all()
    assert (idx[:, 5, 2] == 60).all()
    assert (d[:, :10, :2] == 0).all()
    pd, pidx = (np.asarray(x) for x in pallas_kernels.knn_pallas(
        jnp.asarray(q), jnp.asarray(p), 16, exact_dist=True))
    np.testing.assert_array_equal(idx, pidx)


def test_k_larger_than_n_is_clamped():
    q, p = knn_inputs_with_margin(2, 20, 12, 3, 11)
    d, idx = ref.knn(*_t(q, p), 20)
    assert tuple(idx.shape) == tuple(d.shape) == (2, 20, 12)
    np.testing.assert_array_equal(np.sort(idx.numpy(), -1),
                                  np.broadcast_to(np.arange(12), (2, 20, 12)))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jnp_ref.knn_points(q, p, 20)[1]))


def test_chunked_queries_equal_one_pass(monkeypatch):
    q, p = knn_inputs_with_margin(2, 64, 96, 3, 16)
    whole = ref.knn(*_t(q, p), 16)
    monkeypatch.setattr(ref, "_MAX_PAIRS", 2 * 96 * 5)     # 5 queries a chunk
    for a, b in zip(ref.knn(*_t(q, p), 16), whole):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_cpu_dispatch_takes_plain_version(monkeypatch):
    def no_kernel(*args):
        raise AssertionError("CPU tensors must not reach ops/kernels.py")

    monkeypatch.setattr(kernels, "knn", no_kernel)
    before = kernels.KNN_LAUNCHES
    q, p = _t(*knn_inputs_with_margin(2, 32, 48, 3, 16))
    for got, want in ((dispatch.knn_points(q, p, 16), ref.knn_points(q, p, 16)),
                      (dispatch.three_nn(q, p), ref.three_nn(q, p)),
                      (dispatch.three_nn_upsampling(q, p),
                       ref.three_nn_upsampling(q, p)),
                      ((dispatch.knn_indices(p, 16),), (ref.knn_indices(p, 16),))):
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert kernels.KNN_LAUNCHES == before


def test_kernel_wrapper_rejects_cpu_tensors():
    q, p = _t(*knn_inputs_with_margin(1, 8, 16, 3, 4))
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.knn(q, p, 4)


@pytest.mark.parametrize("shape", probe_knn_fps.KNN_SHAPES,
                         ids=[s[0] for s in probe_knn_fps.KNN_SHAPES])
def test_knn_plan_at_path_shapes(shape):
    """knn.cu's launch plan at every shape the driven paths launch: an
    instantiated row count, within the grid and shared-memory limits, the
    same plan for the same shape."""
    _, B, M, N, C, k = shape
    plan = kernels.knn_plan(B, M, N, C, k)
    _check_plan(B, M, N, C, k, *plan)
    assert kernels.knn_plan(B, M, N, C, k) == plan


def _check_plan(B, M, N, C, k, queued, R):
    """A plan knn.cu takes: the direct kernel with one row a thread, or
    (k > 3) the queue kernel at an instantiated row count, within the grid
    and shared-memory limits."""
    assert B <= 65535
    if queued == 0:
        assert R == 1
        return
    assert queued == 1 and min(k, N) > 3
    assert R in kernels.knn_rows_allowed(C, min(k, N))
    assert -(-M // (kernels.KNN_THREADS * R)) < 2 ** 31
    assert kernels.knn_smem_bytes(C, R, N) <= kernels.MAX_SMEM


@pytest.mark.parametrize("C,k", [(3, 1), (3, 16), (3, 32), (24, 16), (48, 32),
                                 (5, 10), (6144, 2), (6144, 20)])
def test_knn_plan_limits_over_sizes(C, k):
    for B in (1, 2, 64, 3264, 65535):
        for M in (1, 24, 127, 128, 3072, 20000):
            for N in (1, 2, 31, 64, 65, 129, 384, 3072, 50000):
                _check_plan(B, M, N, C, k, *kernels.knn_plan(B, M, N, C, min(k, N)))


@pytest.mark.parametrize("C", [3, 7, 24, 48])
def test_knn_plan_takes_two_rows_only_at_c24(C):
    """Two query rows a thread only at C = 24, where one 16-byte load feeds
    two rows' products, and only on a grid that keeps ~3 blocks an SM."""
    rows = {kernels.knn_plan(B, M, 3072, C, 16)[1]
            for B in (1, 32, 64) for M in (128, 1024, 3072)}
    assert rows == ({1, 2} if C == 24 else {1})
    assert kernels.knn_plan(1, 3072, 3072, C, 16) == (1, 1)


@pytest.mark.parametrize("C,N", [(3, 3072), (3, 100), (24, 3072), (48, 1024),
                                 (7, 65), (6144, 3072)])
def test_knn_tile_points(C, N):
    """A candidate tile of the queue kernel holds a multiple of 4 points,
    at most 8 KB of them (C = 3 as float4) unless 4 points exceed it, and
    no more than N points need."""
    pts = kernels.knn_tile_points(C, N)
    width = 4 if C == 3 else C
    assert pts % 4 == 0 and pts >= 4
    assert pts * width * 4 <= kernels.KNN_TILE_BYTES or pts == 4
    assert pts <= -(-N // 4) * 4
