"""The port's ball query (``ops/ref.py``, the plain version of
``csrc/ball_query.cu``) against the JAX package, on the CPU.

- Against ``pallas_kernels.ball_query`` in interpret mode (the TPU kernel's
  arithmetic: exact per-coordinate differences): indices equal, at
  (min_r, max_r) (0, 0.2) and (0.05, 0.25) and at the uniform loss's radii
  and nsamples, on clouds with the centres drawn from the cloud (so the
  ``d == 0`` path triggers).
- Against ``jnp_ref.ball_query`` on a k/32 grid, where its |a|^2+|b|^2-2a.b
  expansion is exact: indices equal.
- Edge cases against a numpy loop: a centre with no hit gives zeros;
  duplicates count at min_r > 0 through ``d == 0``; unfilled slots repeat
  the first hit; nsample > N.
- The CPU route of ``ops.ball_query`` is the plain version, with no graph.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvp_benchmark_tpu.ops import jnp_ref, pallas_kernels
from mvp_benchmark_tpu_torch import ops
from mvp_benchmark_tpu_torch.ops import ref
from tests.util_clouds import grid_points

T = torch.from_numpy


def _np_ball_query(lo, hi, nsample, xyz, centers):
    """The reference op's loop (ball_query_cuda.cu:12-54) in float64 on the
    float32 distances, radii squared as float32."""
    lo2, hi2 = np.float32(lo * lo), np.float32(hi * hi)
    B, M = centers.shape[:2]
    out = np.zeros((B, M, nsample), np.int32)
    for b in range(B):
        for m in range(M):
            diff = (centers[b, m] - xyz[b]).astype(np.float32)
            d = (diff[:, 0] * diff[:, 0] + diff[:, 1] * diff[:, 1]) + diff[:, 2] * diff[:, 2]
            cnt = 0
            for j in range(xyz.shape[1]):
                if d[j] == 0 or (lo2 <= d[j] < hi2):
                    if cnt == 0:
                        out[b, m, :] = j
                    out[b, m, cnt] = j
                    cnt += 1
                    if cnt == nsample:
                        break
    return out


def _cloud(seed, B, N):
    rng = np.random.default_rng(seed)
    return rng.random((B, N, 3), dtype=np.float64).astype(np.float32)


@pytest.mark.parametrize("radii,nsample", [((0.0, 0.2), 12), ((0.05, 0.25), 12),
                                           ((0.0, math.sqrt(0.004)), 8),
                                           ((0.0, math.sqrt(0.012)), 24)])
def test_ball_query_equals_pallas_kernel_interpret(radii, nsample):
    xyz = _cloud(1, 2, 256)
    centers = xyz[:, :64]
    want = np.asarray(pallas_kernels.ball_query(*radii, nsample, jnp.asarray(xyz),
                                                jnp.asarray(centers)))
    got = ref.ball_query(*radii, nsample, T(xyz), T(centers)).numpy()
    assert got.dtype == np.int32 and got.shape == (2, 64, nsample)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("p", [0.004, 0.006, 0.008, 0.010, 0.012])
def test_ball_query_at_the_uniform_loss_radii_equals_pallas(p):
    """A unit sphere of 1024 points with 51 FPS-like centres, the uniform
    loss's r = sqrt(p) and nsample = int(1024 p): r^2 need not equal p in
    float32, and both sides square r the same way."""
    rng = np.random.default_rng(2)
    v = rng.standard_normal((2, 1024, 3))
    xyz = (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)
    centers = xyz[:, ::20][:, :51]
    r, nsample = math.sqrt(p), int(1024 * p)
    want = np.asarray(pallas_kernels.ball_query(0.0, r, nsample, jnp.asarray(xyz),
                                                jnp.asarray(centers)))
    got = ref.ball_query(0.0, r, nsample, T(xyz), T(centers)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[..., 1] != got[..., 0]).any()          # some centres have 2+ hits


def test_ball_query_equals_jnp_ref_on_a_grid():
    rng = np.random.default_rng(3)
    xyz = grid_points(rng, 2 * 300).reshape(2, 300, 3) / 8.0     # k/256 in [-0.5, 0.5)
    centers = xyz[:, 100:140]
    for lo, hi, ns in ((0.0, 0.2, 16), (0.05, 0.25, 8), (0.0, 0.1, 40)):
        want = np.asarray(jnp_ref.ball_query(lo, hi, ns, jnp.asarray(xyz),
                                             jnp.asarray(centers)))
        got = ref.ball_query(lo, hi, ns, T(xyz), T(centers)).numpy()
        np.testing.assert_array_equal(got, want)


def test_ball_query_edge_cases():
    xyz = _cloud(4, 2, 40)
    xyz[:, 10] = xyz[:, 3]                    # a duplicate of point 3
    centers = np.concatenate([xyz[:, 3:4], np.full((2, 1, 3), 9.0, np.float32),
                              xyz[:, 20:22]], axis=1)
    for lo, hi, ns in ((0.05, 0.3, 6), (0.0, 0.3, 50), (0.0, 0.01, 5)):
        got = ref.ball_query(lo, hi, ns, T(xyz), T(centers)).numpy()
        np.testing.assert_array_equal(got, _np_ball_query(lo, hi, ns, xyz, centers))
    got = ref.ball_query(0.05, 0.3, 6, T(xyz), T(centers)).numpy()
    # at min_r > 0 a centre's own point and its duplicate count through d == 0
    assert got[0, 0, 0] == 3 and got[0, 0, 1] == 10
    np.testing.assert_array_equal(got[:, 1], 0)        # no hit: zeros
    # nsample > N: every hit, then the first hit repeated
    got = ref.ball_query(0.0, 10.0, 45, T(xyz), T(centers)).numpy()
    np.testing.assert_array_equal(got[0, 0], list(range(40)) + [0] * 5)


def test_cpu_route_is_the_plain_version_without_a_graph():
    xyz = T(_cloud(5, 2, 64)).requires_grad_()
    got = ops.ball_query(0.0, 0.3, 8, xyz, xyz[:, :10])
    assert not got.requires_grad and got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), ref.ball_query(0.0, 0.3, 8, xyz.detach(), xyz.detach()[:, :10]).numpy())


def test_squared_radius_rounds_the_double_square_to_float32():
    for r in (math.sqrt(0.004), 0.2, 0.25, 1 / 3):
        assert ref.squared_radius(r) == float(np.float32(r * r))
