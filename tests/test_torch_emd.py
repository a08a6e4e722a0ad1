"""The port's auction EMD (``ops/ref.py``, the plain version of
``csrc/emd.cu``) against the JAX package, on the CPU.

- Against ``pallas_kernels.emd_auction`` in interpret mode (the TPU kernel:
  exact per-coordinate distances, the same tie rules): on k/256 grid
  clouds, where every distance is exact whatever the rounding and many
  tie, assignments equal and dist equal (rtol 1e-6), at (2, 256), eps 0.02,
  50 iterations, and with 3 iterations, which ends in the forced round. On
  random clouds, a match rate above 0.98: in one of ~16 runs under CPU
  load, the XLA executable of the interpret kernel gave 7 of 512
  assignments that differ (ROADMAP Queue 3), as one bid that rounds the
  other way changes every later round of its cloud.
- Against ``jnp_ref.emd_auction``, which ranks bids on the |a|^2+|b|^2-2a.b
  expansion: the JAX test's own bar (``tests/test_ops_emd.py:136-156``),
  match rate > 0.98 and dist within rtol 1e-5 where the assignments agree;
  on a k/256 grid, where the expansion is exact, assignments equal.
- Equal clouds give the identity; the gradient equals ``jax.grad`` of the
  TPU kernel's (2 g (xyz1 - matched) to xyz1, none to xyz2) within rtol
  1e-6; ``calc_emd`` equals the JAX package's on the grid (rtol 1e-6);
  ``emd_validate`` raises and warns as JAX's does.
- Through the models, with PCN's coarse head set to emit grid points (its
  kernel zeroed, its bias the coordinates) and the folding head to add 0,
  so that both packages' auctions see exact distances: the val branch with
  ``eval_emd`` (eps 0.004, 3000 iterations, every prediction twice, so
  the tie rules decide) gives the JAX package's emd (rtol 1e-6) and its
  cd_p, cd_t and f1 (rtol 1e-4); the EMD train loss where n == m
  (num_coarse = num_points = 256) gives JAX's ``value_and_grad`` (total
  rtol 1e-5, gradients rtol 1e-4 / atol 1e-5).
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvp_benchmark_tpu.metrics import completion as jmetrics
from mvp_benchmark_tpu.models import pcn as jpcn
from mvp_benchmark_tpu.ops import jnp_ref, pallas_kernels
from mvp_benchmark_tpu_torch import ops
from mvp_benchmark_tpu_torch.metrics import calc_emd
from mvp_benchmark_tpu_torch.models import pcn as tpcn
from mvp_benchmark_tpu_torch.models.transplant import load_flax_params
from mvp_benchmark_tpu_torch.ops import ref
from tests.test_torch_train import _assert_grads_match
from tests.util_clouds import grid_points

T = torch.from_numpy
pytestmark = pytest.mark.filterwarnings("ignore:EMD protocol expects")


def _clouds(seed, B=2, n=256):
    rng = np.random.default_rng(seed)
    return (rng.random((B, n, 3), dtype=np.float64).astype(np.float32),
            rng.random((B, n, 3), dtype=np.float64).astype(np.float32))


def _grid_clouds(seed, B=2, n=256):
    pts = grid_points(np.random.default_rng(seed), 2 * B * n) / 8.0
    return pts[:B * n].reshape(B, n, 3), pts[B * n:].reshape(B, n, 3)


@pytest.mark.parametrize("iters", [50, 3])
def test_emd_equals_pallas_kernel_interpret(iters):
    x1, x2 = _grid_clouds(0)
    d_k, a_k = pallas_kernels.emd_auction(jnp.asarray(x1), jnp.asarray(x2), 0.02, iters)
    bids = []
    a = ref.emd_assignment(T(x1), T(x2), 0.02, iters, bids)
    d, a2 = ref.emd_auction(T(x1), T(x2), 0.02, iters)
    assert a.dtype == torch.int32 and a.shape == (2, 256)
    np.testing.assert_array_equal(a.numpy(), np.asarray(a_k))
    np.testing.assert_array_equal(a2.numpy(), a.numpy())
    np.testing.assert_allclose(d.numpy(), np.asarray(d_k), rtol=1e-6, atol=0)
    if iters == 3:                      # 2 rounds leave bidders to the forced one
        assert len(bids) == 3 and bids[-1] > 0
        assert len(set(a[0].tolist())) < 256        # which may share targets


def test_emd_against_pallas_kernel_interpret_on_random_clouds():
    x1, x2 = _clouds(0)
    d_k, a_k = pallas_kernels.emd_auction(jnp.asarray(x1), jnp.asarray(x2), 0.02, 50)
    d, a = ref.emd_auction(T(x1), T(x2), 0.02, 50)
    same = a.numpy() == np.asarray(a_k)
    assert same.mean() > 0.98, same.mean()
    np.testing.assert_allclose(d.numpy()[same], np.asarray(d_k)[same], rtol=1e-6,
                               atol=0)


def test_emd_against_jnp_ref_at_the_jax_tests_bar():
    x1, x2 = _clouds(1)
    d_r, a_r = jnp_ref.emd_auction(jnp.asarray(x1), jnp.asarray(x2), 0.02, 50)
    d, a = ref.emd_auction(T(x1), T(x2), 0.02, 50)
    same = a.numpy() == np.asarray(a_r)
    assert same.mean() > 0.98, same.mean()
    np.testing.assert_allclose(d.numpy()[same], np.asarray(d_r)[same], rtol=1e-5,
                               atol=1e-6)


def test_emd_equals_jnp_ref_on_a_grid():
    x1, x2 = _grid_clouds(2)
    _, a_r = jnp_ref.emd_auction(jnp.asarray(x1), jnp.asarray(x2), 0.01, 200)
    a = ref.emd_assignment(T(x1), T(x2), 0.01, 200)
    np.testing.assert_array_equal(a.numpy(), np.asarray(a_r))


def test_equal_clouds_give_the_identity():
    x1, _ = _clouds(3, 3, 300)
    d, a = ops.emd_auction(T(x1), T(x1), 0.005, 50)
    np.testing.assert_array_equal(a.numpy(), np.broadcast_to(np.arange(300), (3, 300)))
    np.testing.assert_array_equal(d.numpy(), 0.0)


def test_gradient_equals_jax_grad():
    x1, x2 = _clouds(4)
    w = np.random.default_rng(5).random((2, 256)).astype(np.float32)
    g1, g2 = jax.grad(lambda a, b: jnp.sum(
        pallas_kernels.emd_auction(a, b, 0.02, 30)[0] * w), argnums=(0, 1))(
            jnp.asarray(x1), jnp.asarray(x2))
    a, b = T(x1).requires_grad_(), T(x2).requires_grad_()
    torch.sum(ops.emd_auction(a, b, 0.02, 30)[0] * T(w)).backward()
    np.testing.assert_allclose(a.grad.numpy(), np.asarray(g1), rtol=1e-6, atol=0)
    assert b.grad is None and not np.asarray(g2).any()


def test_calc_emd_equals_jax_on_a_grid():
    x1, x2 = _grid_clouds(6)
    want = np.asarray(jmetrics.calc_emd(jnp.asarray(x1), jnp.asarray(x2), 0.004, 300))
    got = calc_emd(T(x1), T(x2), 0.004, 300).numpy()
    assert got.shape == (2,) and (got > 0).all()
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_emd_validate_raises_and_warns_as_jax():
    x1 = np.zeros((2, 64, 3), np.float32)
    for fn, conv in ((jnp_ref.emd_validate, jnp.asarray), (ref.emd_validate, T)):
        with pytest.raises(ValueError, match="n == m, got 64 vs 32"):
            fn(conv(x1), conv(np.zeros((2, 32, 3), np.float32)))
        with pytest.warns(UserWarning, match="batch <= 512"):
            fn(conv(np.zeros((513, 1024, 3), np.float32)),
               conv(np.zeros((513, 1024, 3), np.float32)))
        with pytest.warns(UserWarning, match="n % 1024 == 0"):
            fn(conv(x1), conv(x1))
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            fn(conv(np.zeros((2, 1024, 3), np.float32)),
               conv(np.zeros((2, 1024, 3), np.float32)))
    with pytest.raises(ValueError, match="n == m"):
        ops.emd_auction(T(x1), T(x1[:, :32]))


def _pcn_on_a_grid(num_points, num_coarse, prefix, loss="cd", eval_emd=False):
    """(JAX model, its parameters with the grid heads, the port with them,
    partial clouds, gt): PCN whose coarse head emits grid points and whose
    folding head adds 0, and a gt of other grid points."""
    jm = jpcn.Model(num_points=num_points, num_coarse=num_coarse, train_loss=loss,
                    eval_emd=eval_emd)
    x = np.random.default_rng(10).random((2, num_points, 3)).astype(np.float32)
    params = jax.tree.map(np.array, jax.jit(lambda k, x: jm.init(
        k, x, x, prefix=prefix))(jax.random.PRNGKey(1), x))["params"]
    pts = grid_points(np.random.default_rng(11), num_coarse + 2 * num_points) / 8.0
    dec = params["PCNDecoder_0"]
    dec["TorchDense_2"]["kernel"][:] = 0.0
    dec["TorchDense_2"]["bias"][:] = pts[:num_coarse].reshape(-1)
    dec["TorchDense_4"]["kernel"][:] = 0.0
    dec["TorchDense_4"]["bias"][:] = 0.0
    tm = load_flax_params(tpcn.Model(num_points, num_coarse, train_loss=loss,
                                     eval_emd=eval_emd), {"params": params},
                          for_training=True)
    return jm, params, tm, x, pts[num_coarse:].reshape(2, num_points, 3)


def test_pcn_val_branch_with_eval_emd_matches_jax():
    jm, params, tm, x, gt = _pcn_on_a_grid(256, 128, "val", eval_emd=True)
    want = jax.jit(lambda p, x, gt: jm.apply({"params": p}, x, gt, prefix="val"))(
        params, x, gt)
    with torch.inference_mode():
        got = tm.eval()(T(x), T(gt), prefix="val")
    assert (got["emd"].numpy() > 0).all()
    np.testing.assert_allclose(got["emd"].numpy(), np.asarray(want["emd"]), rtol=1e-6)
    for k in ("cd_p", "cd_t", "f1"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-4)


def test_pcn_emd_train_loss_where_n_equals_m_matches_jax_value_and_grad():
    jm, params, tm, x, gt = _pcn_on_a_grid(256, 256, "train", loss="emd")
    loss, grads = jax.jit(jax.value_and_grad(lambda p: jm.apply(
        {"params": p}, x, gt, prefix="train", alpha=0.5)[2]))(params)
    _, loss2, total = tm.train()(T(x), T(gt), prefix="train", alpha=0.5)
    total.backward()
    np.testing.assert_allclose(float(total.detach()), float(loss), rtol=1e-5)
    _assert_grads_match(tm, grads)
