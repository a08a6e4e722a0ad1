"""The plain backwards of the torch port (``ops/ref.py``) against autograd and
the JAX package, on the CPU.

Each of ``chamfer_backward``, ``scatter_add_rows``, ``group_max_backward``,
``three_interpolate_backward`` and ``sa_attention_backward`` is the contract
of a CUDA kernel (held against it on the card in ``test_torch_cuda.py`` and
``chip_smoke.py``). Here each is held:
- against ``torch.autograd.grad`` of its plain forward: rtol 1e-5, atol 1e-6
  (the same terms, summed in another order);
- against ``jax.vjp`` of the JAX package's function on the CPU at fp32:
  atol 1e-5, rtol 1e-4;
- where the semantics live only in a Pallas body (the chamfer MXU backward,
  the ``group_max`` slot routing under ties, the three_interpolate and SA
  backwards), against that body in interpret mode: equal where the inputs
  make its bf16 one-hot products exact, else at the bar of
  ``tests/test_pallas_kernels.py``.
The JAX CPU path's ``jnp.max`` splits the gradient of tied maxima between
the tied slots, where the TPU kernel and the port give it all to the lowest
slot; ``test_group_max_backward_ties`` holds what both keep, the sum.

And the repair of ``ref.three_nn``: its distances carry no gradient, as
``jnp_ref.three_nn``'s do not, so an upsampling from an FPS subset (which
meets zero distances) gives no NaN.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvp_benchmark_tpu.ops import jnp_ref, pallas_kernels
from mvp_benchmark_tpu_torch.ops import dispatch, ref
from tests.util_clouds import clouds_without_near_ties

AUTOGRAD_TOL = dict(rtol=1e-5, atol=1e-6)
JAX_TOL = dict(rtol=1e-4, atol=1e-5)
T = torch.from_numpy


def _eighths(rng, shape, lo=-8, hi=8):
    """Values k/8 with small k: exact in bf16, and every sum of a few
    hundred products of them is exact in fp32, whatever the order."""
    return (rng.integers(lo, hi, shape) / 8.0).astype(np.float32)


# ---------------------------------------------------------------------------
# the repair: three_nn carries no gradient
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("route", ["ref", "dispatch"])
def test_three_nn_upsampling_from_an_fps_subset_has_no_coordinate_gradient(route):
    """64 points, a 16-point FPS subset as the source: every target point of
    the subset is at distance 0 from itself. Before the repair the
    coordinate gradient held NaN (sqrt'(0) = inf times the clamp's 0)."""
    ops = ref if route == "ref" else dispatch
    rng = np.random.default_rng(0)
    pts = T(rng.random((1, 64, 3), dtype=np.float64).astype(np.float32))
    pts.requires_grad_(True)
    src = ref.gather_points(pts, ref.furthest_point_sample(pts.detach(), 16))
    feats = T(rng.standard_normal((1, 16, 4)).astype(np.float32)).requires_grad_(True)
    idx, w = ops.three_nn_upsampling(pts, src)
    out = ops.three_interpolate(feats, idx, w)
    g_pts, g_feats = torch.autograd.grad(out.sum(), [pts, feats], allow_unused=True)
    assert g_pts is None
    assert not w.requires_grad
    assert torch.isfinite(g_feats).all() and g_feats.abs().sum() > 0


def test_three_nn_distances_match_jnp_ref_and_stop_gradient():
    rng = np.random.default_rng(1)
    t = rng.random((2, 40, 3), dtype=np.float64).astype(np.float32)
    s = t[:, :12]
    d, idx = ref.three_nn(T(t).requires_grad_(True), T(s))
    jd, jidx = jnp_ref.three_nn(jnp.asarray(t), jnp.asarray(s))
    assert d.grad_fn is None
    np.testing.assert_array_equal(idx.numpy()[:, 12:], np.asarray(jidx)[:, 12:])
    np.testing.assert_allclose(d.numpy()[:, 12:], np.asarray(jd)[:, 12:],
                               rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# chamfer
# ---------------------------------------------------------------------------


def _chamfer_case(B=2, N=64, M=48):
    a, b = clouds_without_near_ties(B, N, M)
    rng = np.random.default_rng(2)
    g1 = rng.standard_normal((B, N)).astype(np.float32)
    g2 = rng.standard_normal((B, M)).astype(np.float32)
    return a, b, g1, g2


def test_chamfer_backward_matches_autograd():
    a, b, g1, g2 = _chamfer_case()
    at, bt = T(a).requires_grad_(True), T(b).requires_grad_(True)
    d1, d2, i1, i2 = ref.chamfer_distance(at, bt)
    want = torch.autograd.grad((d1 * T(g1)).sum() + (d2 * T(g2)).sum(), [at, bt])
    got = ref.chamfer_backward(T(a), T(b), i1, T(g1), i2, T(g2))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **AUTOGRAD_TOL)
    da, db = ref.chamfer_backward(T(a), T(b), i1, T(g1), i2, T(g2),
                                  need_a=False, need_b=True)
    assert da is None
    torch.testing.assert_close(db, got[1], rtol=0, atol=0)


def test_chamfer_backward_matches_jax_vjp():
    a, b, g1, g2 = _chamfer_case()
    i1, i2 = (x.numpy() for x in ref.chamfer_distance(T(a), T(b))[2:])
    _, vjp = jax.vjp(lambda x, y: jnp_ref.chamfer_distance(x, y)[:2],
                     jnp.asarray(a), jnp.asarray(b))
    want = vjp((jnp.asarray(g1), jnp.asarray(g2)))
    got = ref.chamfer_backward(T(a), T(b), T(i1), T(g1), T(i2), T(g2))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **JAX_TOL)


def test_chamfer_backward_matches_pallas_mxu_interpret():
    """``_chamfer_grad_mxu`` (the TPU default backward, hi+lo bf16 table) in
    interpret mode, both sides, at the bar of
    ``test_pallas_kernels.py::test_chamfer_grad_mxu_matches_xla`` (rtol
    1e-3, atol 5e-5): it forms ``a s0 - t`` from bf16 hi+lo sums, which
    cancel, so not even bf16 inputs make it exact."""
    a, b, g1, g2 = _chamfer_case(B=2, N=256, M=128)
    _, _, i1, i2 = ref.chamfer_distance(T(a), T(b))
    da, db = ref.chamfer_backward(T(a), T(b), i1, T(g1), i2, T(g2))
    j = [jnp.asarray(x) for x in (a, b, i1.numpy(), g1, i2.numpy(), g2)]
    p_da = pallas_kernels._chamfer_grad_mxu(j[0], j[1], j[2], j[3], j[4], j[5])
    p_db = pallas_kernels._chamfer_grad_mxu(j[1], j[0], j[4], j[5], j[2], j[3])
    np.testing.assert_allclose(da.numpy(), np.asarray(p_da), rtol=1e-3, atol=5e-5)
    np.testing.assert_allclose(db.numpy(), np.asarray(p_db), rtol=1e-3, atol=5e-5)


# ---------------------------------------------------------------------------
# scatter_add_rows (the row gather's backward)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("idx_shape", [(2, 30), (2, 30, 5)])
def test_scatter_add_rows_matches_autograd_and_jax_vjp(idx_shape):
    rng = np.random.default_rng(3)
    f = rng.standard_normal((2, 50, 12)).astype(np.float32)
    idx = rng.integers(0, 50, idx_shape).astype(np.int32)
    g = rng.standard_normal(idx_shape + (12,)).astype(np.float32)
    got = ref.scatter_add_rows(T(g), T(idx), 50)
    ft = T(f).requires_grad_(True)
    want, = torch.autograd.grad((ref.gather_points(ft, T(idx)) * T(g)).sum(), [ft])
    torch.testing.assert_close(got, want, **AUTOGRAD_TOL)
    _, vjp = jax.vjp(lambda x: jnp_ref.grouping_operation(x, jnp.asarray(idx))
                     if len(idx_shape) == 3 else jnp_ref.gather_points(x, jnp.asarray(idx)),
                     jnp.asarray(f))
    np.testing.assert_allclose(got.numpy(), np.asarray(vjp(jnp.asarray(g))[0]),
                               **JAX_TOL)


def test_scatter_add_rows_matches_pallas_interpret():
    """``pallas_kernels.scatter_add_rows`` (exact hi+lo) in interpret mode:
    equal where every row receives at most one bf16 value; at
    test_pallas_kernels.py's bar (rtol 1e-5, atol 1e-5) with collisions."""
    rng = np.random.default_rng(4)
    g = _eighths(rng, (2, 60, 12))
    idx = np.stack([rng.permutation(96)[:60] for _ in range(2)]).astype(np.int32)
    got = ref.scatter_add_rows(T(g), T(idx), 96).numpy()
    want = pallas_kernels.scatter_add_rows(jnp.asarray(g), jnp.asarray(idx), 96)
    np.testing.assert_array_equal(got, np.asarray(want))
    g = rng.random((2, 330, 12), dtype=np.float64).astype(np.float32)
    idx = rng.integers(0, 96, (2, 330)).astype(np.int32)
    got = ref.scatter_add_rows(T(g), T(idx), 96).numpy()
    want = pallas_kernels.scatter_add_rows(jnp.asarray(g), jnp.asarray(idx), 96)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)


def test_scatter_add_rows_raises_on_an_index_out_of_range():
    g = torch.ones(2, 3, 4)
    for bad in (5, -1):
        idx = torch.tensor([[0, 1, 2], [0, bad, 1]], dtype=torch.int32)
        with pytest.raises(IndexError, match="outside"):
            ref.scatter_add_rows(g, idx, 5)


# ---------------------------------------------------------------------------
# group_max
# ---------------------------------------------------------------------------


def _group_case(ties):
    rng = np.random.default_rng(5)
    if ties:
        f = _eighths(rng, (2, 64, 16), 0, 4)          # many equal values
        f[:, :, 3] = 0.0                              # a channel that ties everywhere
        idx = rng.integers(0, 64, (2, 48, 8)).astype(np.int32)
        idx[:, :, 5] = idx[:, :, 1]                   # a row twice
    else:
        f = rng.standard_normal((2, 64, 16)).astype(np.float32)
        idx = np.stack([np.stack([rng.choice(64, 8, replace=False) for _ in range(48)])
                        for _ in range(2)]).astype(np.int32)
    g = _eighths(rng, (2, 48, 16))
    return f, idx, g


def test_group_max_backward_matches_autograd():
    for ties in (False, True):
        f, idx, g = _group_case(ties)
        ft = T(f).requires_grad_(True)
        out, slot = ref.group_max(ft, T(idx))
        want, = torch.autograd.grad((out * T(g)).sum(), [ft])
        got = ref.group_max_backward(T(g), T(idx), slot, 64)
        torch.testing.assert_close(got, want, **AUTOGRAD_TOL)


def test_group_max_backward_matches_jax_vjp_without_ties():
    f, idx, g = _group_case(ties=False)
    _, slot = ref.group_max(T(f), T(idx))
    got = ref.group_max_backward(T(g), T(idx), slot, 64)
    _, vjp = jax.vjp(lambda x: jnp.max(jnp_ref.grouping_operation(
        x, jnp.asarray(idx)), axis=2), jnp.asarray(f))
    np.testing.assert_allclose(got.numpy(), np.asarray(vjp(jnp.asarray(g))[0]),
                               **JAX_TOL)


def test_group_max_backward_ties():
    """Under ties the port routes each (m, c) to the lowest slot, as the
    Pallas kernel does (equal, in interpret mode: values in k/8 make its
    bf16 products and f32 sums exact); ``jnp.max`` splits it between the
    tied slots. Both keep the sum over rows of each (cloud, channel)."""
    f, idx, g = _group_case(ties=True)
    _, slot = ref.group_max(T(f), T(idx))
    got = ref.group_max_backward(T(g), T(idx), slot, 64).numpy()
    _, p_vjp = jax.vjp(lambda x: pallas_kernels.group_max(x, jnp.asarray(idx)),
                       jnp.asarray(f))
    np.testing.assert_array_equal(got, np.asarray(p_vjp(jnp.asarray(g))[0]))
    _, j_vjp = jax.vjp(lambda x: jnp.max(jnp_ref.grouping_operation(
        x, jnp.asarray(idx)), axis=2), jnp.asarray(f))
    split = np.asarray(j_vjp(jnp.asarray(g))[0])
    assert not np.allclose(got, split)               # the ties do differ
    np.testing.assert_allclose(got.sum(1), split.sum(1), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got.sum(1), g.sum(1), rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# three_interpolate
# ---------------------------------------------------------------------------


def _interp_case(rng, values):
    B, Ms, N, C = 2, 40, 256, 16
    f = values(rng, (B, Ms, C))
    idx = np.stack([np.stack([rng.choice(Ms, 3, replace=False) for _ in range(N)])
                    for _ in range(B)]).astype(np.int32)
    w = values(rng, (B, N, 3))
    g = values(rng, (B, N, C))
    return f, idx, w, g


def test_three_interpolate_backward_matches_autograd_and_jax_vjp():
    rng = np.random.default_rng(6)
    f, idx, w, g = _interp_case(
        rng, lambda r, s: r.standard_normal(s).astype(np.float32))
    got = ref.three_interpolate_backward(T(g), T(idx), T(w), T(f))
    ft, wt = T(f).requires_grad_(True), T(w).requires_grad_(True)
    want = torch.autograd.grad(
        (ref.three_interpolate(ft, T(idx), wt) * T(g)).sum(), [ft, wt])
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, **AUTOGRAD_TOL)
    _, vjp = jax.vjp(lambda x, y: jnp_ref.three_interpolate(x, jnp.asarray(idx), y),
                     jnp.asarray(f), jnp.asarray(w))
    for a, b in zip(got, vjp(jnp.asarray(g))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **JAX_TOL)
    d_f, d_w = ref.three_interpolate_backward(T(g), T(idx), T(w), T(f), need_w=False)
    assert d_w is None
    torch.testing.assert_close(d_f, got[0], rtol=0, atol=0)


def test_three_interpolate_backward_equals_pallas_interpret():
    """``three_interpolate_fused``'s backward (``_ti_bwd_kernel``) in
    interpret mode, on values in k/8 with three distinct indices a row, so
    its bf16 one-hot products and f32 sums are exact: equal."""
    f, idx, w, g = _interp_case(np.random.default_rng(7), _eighths)
    got = ref.three_interpolate_backward(T(g), T(idx), T(w), T(f))
    _, vjp = jax.vjp(lambda x, y: pallas_kernels.three_interpolate_fused(
        x, jnp.asarray(idx), y), jnp.asarray(f), jnp.asarray(w))
    for a, b in zip(got, vjp(jnp.asarray(g))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# ---------------------------------------------------------------------------
# SA block
# ---------------------------------------------------------------------------

SHARE = 8


def _sa_case(B, N, k, rel, mid, seed=0):
    """Unit-scale proj/x1 in [-0.5, 0.5), weights at torch's init scale, as
    tests/test_torch_sa_attention.py draws them."""
    rng = np.random.default_rng([seed, N, k, rel])
    ms = mid // SHARE
    b1, b2 = 1 / np.sqrt((1 + k) * rel), 1 / np.sqrt(ms)
    f32 = lambda a: np.asarray(a, np.float32)
    proj = f32(rng.random((B, N, rel + mid)) - 0.5)
    x1 = f32(rng.random((B, N, rel)) - 0.5)
    idx = rng.integers(0, N, (B, N, k)).astype(np.int32)
    W1 = f32(rng.uniform(-b1, b1, ((1 + k) * rel, ms)))
    W2 = f32(rng.uniform(-b2, b2, (ms, k * ms)))
    bias = f32(rng.uniform(-b2, b2, (k * ms,)))
    g = f32(rng.standard_normal((B, N, mid)))
    return (proj, x1, idx, W1, W2, bias), g


def _xla_block(idx, rel, mid):
    """The fallback of ``models/vrcnet.py:100-108`` at fp32 ('highest'), a
    function of (proj, x1, W1, W2, b2)."""
    B, N, k = idx.shape
    ms = mid // SHARE

    def block(proj, x1, W1, W2, b2):
        pn = jnp_ref.grouping_operation(proj, jnp.asarray(idx))
        x2 = pn[..., :rel].reshape(B, N, k * rel)
        w = jnp.maximum(jnp.concatenate([x1, x2], axis=-1), 0.0)
        u = jnp.maximum(jnp.dot(w, W1, precision="highest"), 0.0)
        w = jnp.dot(u, W2, precision="highest") + b2
        w = jnp.tile(w.reshape(B, N, k, ms), (1, 1, 1, SHARE))
        return jnp.sum(w * pn[..., rel:], axis=2)

    return block


@pytest.mark.parametrize("rel,mid,k", [(4, 16, 8), (8, 32, 16), (16, 64, 8),
                                       (32, 128, 16)])
def test_sa_attention_backward_matches_autograd_and_jax_vjp(rel, mid, k):
    args, g = _sa_case(2, 37, k, rel, mid)        # 37: no tile divides it
    got = ref.sa_attention_backward(T(g), *map(T, args), rel, mid, SHARE)
    proj, x1, idx, W1, W2, b2 = args
    leaves = [T(a).requires_grad_(True) for a in (proj, x1, W1, W2, b2)]
    out = ref.sa_attention(leaves[0], leaves[1], T(idx), *leaves[2:], rel, mid, SHARE)
    want = torch.autograd.grad((out * T(g)).sum(), leaves)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, **AUTOGRAD_TOL)
    _, vjp = jax.vjp(_xla_block(idx, rel, mid),
                     *(jnp.asarray(a) for a in (proj, x1, W1, W2, b2)))
    for a, b, name in zip(got, vjp(jnp.asarray(g)), ("d_proj", "d_x1", "dW1",
                                                     "dW2", "db2")):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name, **JAX_TOL)


def test_sa_attention_backward_matches_pallas_interpret():
    """``pallas_kernels.sa_attention``'s backward (``_sa_bwd_kernel``) in
    interpret mode, at test_pallas_kernels.py's bar: it rounds the stashed
    gathers, W1, W2 and the products' inputs to bf16, so 99.5% of entries
    within 2e-2 of the largest."""
    rel, mid, k = 4, 16, 8
    args, g = _sa_case(2, 256, k, rel, mid, seed=1)
    proj, x1, idx, W1, W2, b2 = args
    got = ref.sa_attention_backward(T(g), *map(T, args), rel, mid, SHARE)
    _, vjp = jax.vjp(lambda p, x, a, b, c: pallas_kernels.sa_attention(
        p, x, jnp.swapaxes(jnp.asarray(idx), 1, 2), a, b, c, rel, mid, SHARE),
        *(jnp.asarray(a) for a in (proj, x1, W1, W2, b2)))
    for a, b, name in zip(got, vjp(jnp.asarray(g)), ("d_proj", "d_x1", "dW1",
                                                     "dW2", "db2")):
        a, b = a.numpy(), np.asarray(b)
        scale = max(np.abs(b).max(), 1.0)
        close = np.abs(a - b) / scale < 2e-2
        assert close.mean() > 0.995, (name, close.mean())
