"""ECG's train branch and the uniform loss of the torch port against the JAX
package, on the CPU.

- ``get_uniform_loss``: value and gradient against ``jax.value_and_grad``
  of the JAX function at N = 512 and 1024, batch 2 (at N = 128 every
  nsample is below 2 and the loss is 0), value rtol 1e-4, gradient rtol
  1e-4 / atol 1e-7 and cosine >= 0.9999.
- One ECG train step (``cfgs/ecg.yaml``'s structure at num_points 512, batch
  2, alpha 0.5): the total within rtol 1e-4 and every parameter's gradient
  within rtol 1e-4 / atol 1e-5 (the bars of ``test_torch_train.py``) of
  ``jax.value_and_grad`` of the JAX step, with the JAX parameters
  transplanted.
- ``loss: emd`` at n != m (the coarse output has fewer points than gt)
  raises the JAX package's ValueError, for ECG and PCN.

How the two sides see the same selections. JAX's CPU path ranks with the
|a|^2+|b|^2-2a.b expansion; the port ranks on exact differences. Inside
``get_uniform_loss`` the JAX side is handed exact semantics: while it runs,
``ops.ball_query`` and ``ops.knn_points`` are the TPU kernels
(``pallas_kernels.ball_query``, ``pallas_kernels.knn_points``) in interpret
mode, whose arithmetic the port shares; the JAX files are unchanged. The
rest of the step is set up as ``test_torch_ecg.py`` does it: partial clouds
and the coarse head's output on a k/32 grid, where the expansion is exact,
and seeds tried in order until the four feature-space kNNs, the final FPS,
the chamfer argmins of both losses and the uniform loss's FPS, ball
boundaries and nearest neighbours over the predicted points all have a
margin on both sides. The fine head's kernel is scaled by ``FINE_SCALE``
on both sides, so that the predicted cloud has the protocol's unit scale.
"""

import contextlib
import math

import jax
import numpy as np
import pytest
import torch

from mvp_benchmark_tpu import ops as jops
from mvp_benchmark_tpu.models import common as jcommon
from mvp_benchmark_tpu.models import ecg as jecg
from mvp_benchmark_tpu.models import pcn as jpcn
from mvp_benchmark_tpu.ops import pallas_kernels
from mvp_benchmark_tpu.train.config import Config as JConfig
from mvp_benchmark_tpu_torch.models import common
from mvp_benchmark_tpu_torch.models import ecg as tecg
from mvp_benchmark_tpu_torch.models import pcn as tpcn
from mvp_benchmark_tpu_torch.models.transplant import load_flax_params
from mvp_benchmark_tpu_torch.ops import ref
from tests.test_torch_ecg import STAGES, _knn_sets_agree, _np_tree, _with_grid_coarse
from tests.test_torch_train import _argmins_have_margin, _assert_grads_match, _near
from tests.util_clouds import fps_sequences_agree, grid_points

T = torch.from_numpy
NUM_POINTS, NUM_COARSE, B, K = 512, 256, 2, 16
HIERARCHY = (256, 64, 16)
PERCENTAGES = (0.004, 0.006, 0.008, 0.010, 0.012)
# a ball boundary or a kNN rank closer than this (relative) could round the
# other way between the two sides' fp32 outputs
MARGIN = 1e-5
# the fine head's kernel is scaled by this, so that the predicted cloud
# spreads to about unit size as the protocol's clouds do (random weights
# give a blob of spread 0.03, where nearly every point lies near some
# ball's boundary)
FINE_SCALE = 10.0


@contextlib.contextmanager
def _exact_jax_uniform_loss():
    """JAX's get_uniform_loss with the TPU kernels' exact ball query and
    kNN distances (interpret mode) while it runs (and is traced)."""
    real = jcommon.get_uniform_loss

    def exact(pcd, *args, **kwargs):
        with pytest.MonkeyPatch.context() as m:
            m.setattr(jops, "ball_query", pallas_kernels.ball_query)
            m.setattr(jops, "knn_points", pallas_kernels.knn_points)
            return real(pcd, *args, **kwargs)

    with pytest.MonkeyPatch.context() as m:
        m.setattr(jcommon, "get_uniform_loss", exact)
        yield


def _sphere(seed, n):
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((B, n, 3))
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    return (0.5 * v + 0.01 * rng.standard_normal((B, n, 3))).astype(np.float32)


@pytest.mark.parametrize("n", [512, 1024])
def test_uniform_loss_matches_jax_value_and_grad(n):
    pcd = _sphere(n, n)
    with _exact_jax_uniform_loss():
        want, g_want = jax.jit(jax.value_and_grad(
            lambda p: jcommon.get_uniform_loss(p)))(pcd)
    x = T(pcd).requires_grad_()
    got = common.get_uniform_loss(x)
    got.backward()
    assert float(want) > 0
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-4)
    g, gw = x.grad.numpy().astype(np.float64), np.asarray(g_want, np.float64)
    np.testing.assert_allclose(g, gw, rtol=1e-4, atol=1e-7)
    assert (g * gw).sum() / np.linalg.norm(g) / np.linalg.norm(gw) >= 0.9999


def test_uniform_loss_skips_percentages_below_two_points():
    """At N = 128 every nsample is 0 or 1: the loss is 0, as in JAX."""
    pcd = _sphere(0, 128)
    assert float(common.get_uniform_loss(T(pcd))) == 0.0
    assert float(jcommon.get_uniform_loss(pcd)) == 0.0


def _fps64(p, s):
    md, last, seq = np.full(len(p), 1e10), 0, [0]
    for _ in range(1, s):
        md = np.minimum(md, np.sum((p - p[last]) ** 2, -1))
        last = int(np.argmax(md))
        seq.append(last)
    return seq


def _uniform_selections_have_margin(port, jax_pts):
    """The uniform loss's selections over the predicted points: its FPS
    agrees with a margin on both sides (``fps_sequences_agree``); on the
    port's points no squared distance from a centre lies within MARGIN
    (relative) of a ball's squared radius, and in every ball's point set
    each point's nearest other point is further than MARGIN from the next,
    or the two are copies of one point (the fill repeats the first hit)."""
    n = port.shape[1]
    npoint = int(n * 0.05)
    if not fps_sequences_agree(port, jax_pts, npoint):
        return False
    for b in range(port.shape[0]):
        p = port[b].astype(np.float64)
        centers = p[_fps64(p, npoint)]
        d = ((centers[:, None] - p[None]) ** 2).sum(-1)
        for pct in PERCENTAGES:
            nsample = int(n * pct)
            if nsample < 2:
                continue
            r2 = ref.squared_radius(math.sqrt(pct))
            if (np.abs(d - r2) <= MARGIN * r2).any():
                return False
            for row in d:
                hits = np.flatnonzero((row == 0) | (row < r2))[:nsample]
                if len(hits) == 0:
                    continue
                slots = np.concatenate([hits, np.full(nsample - len(hits), hits[0])])
                g = port[b][slots].astype(np.float64)
                dd = ((g[:, None] - g[None]) ** 2).sum(-1)
                order = np.argsort(dd, axis=1, kind="stable")
                s = np.take_along_axis(dd, order, 1)
                if nsample < 3:
                    continue
                same = (g[order[:, 1]] == g[order[:, 2]]).all(-1)
                if not (same | (s[:, 2] - s[:, 1] > MARGIN * s[:, 2])).all():
                    return False
    return True


@pytest.fixture(scope="module")
def ecg_step_case():
    """(torch model, JAX loss and gradients, seed) for the first seed whose
    selections all have their margins."""
    cfg = dict(num_points=NUM_POINTS, loss="cd", eval_emd=False)
    jm = jecg.build(JConfig(cfg))
    x0 = np.zeros((B, NUM_POINTS, 3), np.float32)
    variables = _np_tree(jax.jit(lambda k, x: jm.init(k, x, x, prefix="train"))(
        jax.random.PRNGKey(4), x0))

    def jloss(params, x, gt):
        out, state = jm.apply({"params": params}, x, gt, prefix="train", alpha=0.5,
                              capture_intermediates=True)
        inter = state["intermediates"]["ECGDecoder_0"]
        ef = inter["EFEncoder_0"]
        acts = {name: jax.nn.relu(ef[dense]["__call__"][0]) for name, dense in STAGES}
        acts["fine"] = inter["TorchDense_4"]["__call__"][0]
        return out[2], (out[0], acts)

    with _exact_jax_uniform_loss():
        jstep = jax.jit(jax.value_and_grad(jloss, has_aux=True))
        for seed in range(20):
            rng = np.random.default_rng(seed)
            pts = grid_points(rng, NUM_COARSE + B * NUM_POINTS)
            coarse = pts[:NUM_COARSE]
            x = pts[NUM_COARSE:].reshape(B, NUM_POINTS, 3)
            v = _with_grid_coarse(variables, coarse)
            v["params"]["ECGDecoder_0"]["TorchDense_4"]["kernel"] *= FINE_SCALE
            tm = load_flax_params(tecg.Model(NUM_POINTS, NUM_COARSE, NUM_POINTS,
                                             HIERARCHY), v, for_training=True).train()
            with torch.no_grad():                   # gt near the fine output
                gt = _near(rng, tm.decoder(tm.encoder(T(x)), T(x))[1].numpy())
            got, acts = _port_step(tm, x, gt)
            out1 = np.broadcast_to(coarse, (B, NUM_COARSE, 3))
            out2_port = got["out2"].detach().numpy()
            if not (_argmins_have_margin(gt, out1)
                    and _argmins_have_margin(gt, out2_port)):
                continue                           # the JAX step is not needed
            (loss, (out2, want)), grads = jstep(v["params"], x, gt)
            if (all(_knn_sets_agree(acts[n], np.asarray(want[n]), K) for n, _ in STAGES)
                    and fps_sequences_agree(acts["fine"], np.asarray(want["fine"]),
                                            NUM_POINTS)
                    and _uniform_selections_have_margin(out2_port, np.asarray(out2))):
                return tm, got, float(loss), grads, seed
    raise AssertionError("no seed gave ECG train inputs whose selections have a margin")


def _port_step(tm, x, gt):
    """The port's train losses forward and backward, with the inputs of the
    four DenseConv blocks and the fine points before the final FPS."""
    caught = {}
    mods = {name: getattr(tm.decoder.ef, name) for name, _ in STAGES}
    mods["fine"] = tm.decoder.fc5
    hooks = [m.register_forward_hook(lambda m, a, o, n=n: caught.__setitem__(
        n, (a[0] if n != "fine" else o).detach().numpy())) for n, m in mods.items()]
    try:
        tm.zero_grad(set_to_none=True)
        t = tm.train_losses(T(x), T(gt), alpha=0.5)
        t["total"].backward()
    finally:
        for h in hooks:
            h.remove()
    return t, caught


def test_ecg_train_step_matches_jax_value_and_grad(ecg_step_case):
    tm, got, loss, grads, _ = ecg_step_case
    assert float(got["uniform1"].detach()) > 0 and float(got["uniform2"].detach()) > 0
    np.testing.assert_allclose(float(got["total"].detach()), loss, rtol=1e-4)
    _assert_grads_match(tm, grads)


def test_ecg_train_branch_returns_out2_loss2_total(ecg_step_case):
    tm, got, _, _, _ = ecg_step_case
    x = T(grid_points(np.random.default_rng(7), B * NUM_POINTS).reshape(B, NUM_POINTS, 3))
    out2, loss2, total = tm(x, x, prefix="train", alpha=0.5)
    t = tm.train_losses(x, x, alpha=0.5)
    assert out2.shape == (B, NUM_POINTS, 3) and loss2.shape == (B,)
    torch.testing.assert_close(total, t["total"], rtol=0, atol=0)
    want = (t["loss1"].mean() + 0.1 * t["uniform1"]
            + (t["loss2"].mean() + 0.1 * t["uniform2"]) * 0.5)
    torch.testing.assert_close(total, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("name", ["ecg", "pcn"])
def test_emd_loss_at_n_not_m_raises_as_jax(name):
    """The coarse output (256 points) against gt (512): calc_emd(out1, gt)
    raises the JAX package's ValueError on both sides."""
    x = np.random.default_rng(8).random((B, NUM_POINTS, 3)).astype(np.float32)
    if name == "ecg":
        jm = jecg.build(JConfig(num_points=NUM_POINTS, loss="emd", eval_emd=False))
        tm = tecg.Model(NUM_POINTS, NUM_COARSE, NUM_POINTS, HIERARCHY, train_loss="emd")
    else:
        jm = jpcn.Model(num_points=NUM_POINTS, num_coarse=NUM_COARSE, train_loss="emd")
        tm = tpcn.Model(NUM_POINTS, NUM_COARSE, train_loss="emd")
    with pytest.raises(ValueError, match="EMD requires n == m") as want:
        jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), x, x, prefix="train"))
    with pytest.raises(ValueError, match="EMD requires n == m") as got:
        tm(T(x), T(x), prefix="train")
    assert str(got.value) == str(want.value)
