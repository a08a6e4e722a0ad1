"""The ECG slice of the torch port against the JAX package, on the CPU.

JAX ECG parameters (``ecg.build`` at num_points 256: hierarchy 128/32/8,
384 encoder points, batch 2) are transplanted into the torch model; both get
the same numpy inputs. Tolerances are PCN's:
- out1/out2/result: atol 1e-5, rtol 1e-4 (fp32 matmuls summed in another
  order);
- cd_p, cd_t: rtol 1e-4; f1: atol 2/num_points (the JAX CPU chamfer uses the
  |a|^2+|b|^2-2a.b expansion, which can move a point on the threshold).

How the inputs avoid near ties. The JAX CPU path ranks neighbours with the
expansion (``jnp_ref.square_distance``); the port ranks on exact
differences. On arbitrary points the expansion leaves self distances of up
to ~1e-6 where the exact value is 0 (about 11% of the self pairs at unit
scale), which moves the 3-NN upsampling weights by ~1%. So every point the
3-D ops see lies on a grid where the expansion is exact: the partial cloud
has coordinates k/32 in [-4, 4), and the coarse head is set to emit a fixed
grid cloud (its kernel zeroed, its bias those coordinates; the head's real
weights are checked on out1 by ``test_coarse_head_matches_jax``). The 3-D
kNN, 3-NN and FPS then agree exactly, ties included (both sides take the
lower index). What stays is the feature-space kNN of the four DenseConv
blocks and the final FPS over the predicted points, which see activations.
For those the fixture takes the port's activations through forward hooks
and JAX's through ``capture_intermediates``, and asserts that each side's
selection, taken exactly in float64, has a margin larger than twice that
side's fp32 error (the expansion's bound for JAX), and that the two exact
selections are equal; it tries the next seed if not.
"""

import jax
import numpy as np
import pytest
import torch

from mvp_benchmark_tpu.models import ecg as jecg
from mvp_benchmark_tpu.train.config import Config as JConfig
from mvp_benchmark_tpu_torch.models import common, get_model, layers
from mvp_benchmark_tpu_torch.models import ecg as tecg
from mvp_benchmark_tpu_torch.models.transplant import load_flax_params
from mvp_benchmark_tpu_torch.ops import ref
from mvp_benchmark_tpu_torch.train.config import Config
from tests.util_clouds import ULP, fps_sequences_agree, grid_points
from tests.util_np import pairwise_sqdist

NUM_POINTS, NUM_COARSE, B, K = 256, 128, 2, 16
OUT_TOL = dict(rtol=1e-4, atol=1e-5)
F1_ATOL = 2.0 / NUM_POINTS
STAGES = [("conv1", "TorchDense_0"), ("conv2", "TorchDense_1"),
          ("conv3", "TorchDense_2"), ("conv4", "TorchDense_3")]


def _np_tree(tree):
    return jax.tree.map(lambda a: np.array(a), tree)


def _with_grid_coarse(variables, coarse):
    v = _np_tree(variables)
    head = v["params"]["ECGDecoder_0"]["TorchDense_2"]
    head["kernel"][:] = 0.0
    head["bias"][:] = coarse.reshape(-1)
    return v


def _knn_sets_agree(x_port, x_jax, k):
    """The k-NN sets of every row, taken exactly (float64) on the torch and
    on the JAX activations, are equal, and on each side the k-th and
    (k+1)-th neighbour are further apart than twice that side's fp32 error:
    (C + 2) ulp of the distance for exact differences (the port), 8 ulp of
    |q|^2 + |p|^2 for the expansion (JAX). Then both fp32 selections equal
    the float64 ones, so each other."""
    n, c = x_port.shape[1], x_port.shape[2]
    if n <= k:
        return True                   # every point is a neighbour
    for b in range(x_port.shape[0]):
        sets = []
        for x, expansion in ((x_port[b], False), (x_jax[b], True)):
            d = pairwise_sqdist(x, x)
            order = np.argsort(d, axis=1, kind="stable")
            s = np.take_along_axis(d, order, axis=1)
            if expansion:
                n2 = np.sum(x.astype(np.float64) ** 2, -1)
                far = np.maximum(n2[order[:, k - 1]], n2[order[:, k]])
                err = 8 * ULP * (n2 + far)
            else:
                err = (c + 2) * ULP * s[:, k]
            if not (s[:, k] - s[:, k - 1] > 2 * err).all():
                return False
            sets.append(np.sort(order[:, :k], axis=1))
        if not np.array_equal(*sets):
            return False
    return True


def _port_activations(tm, x):
    caught = {}
    mods = {name: getattr(tm.decoder.ef, name) for name, _ in STAGES}
    mods["fine"] = tm.decoder.fc5
    hooks = [m.register_forward_hook(
        lambda m, a, o, n=n: caught.__setitem__(n, (a[0] if n != "fine" else o).numpy()))
        for n, m in mods.items()]
    try:
        with torch.inference_mode():
            tm(torch.from_numpy(x), None, prefix="test")
    finally:
        for h in hooks:
            h.remove()
    return caught


def _jax_activations(apply_capture, variables, x):
    """(test-branch result, DenseConv inputs and pre-FPS points) of JAX."""
    res, state = apply_capture(variables, x)
    inter = state["intermediates"]["ECGDecoder_0"]
    ef = inter["EFEncoder_0"]
    out = {name: np.maximum(np.asarray(ef[dense]["__call__"][0]), 0.0)
           for name, dense in STAGES}
    out["fine"] = np.asarray(inter["TorchDense_4"]["__call__"][0])
    return np.asarray(res["result"]), out


@pytest.fixture(scope="module")
def jax_model():
    jm = jecg.build(JConfig(num_points=NUM_POINTS, loss="cd", eval_emd=False))
    x = np.zeros((B, NUM_POINTS, 3), np.float32)
    init = jax.jit(lambda key, x: jm.init(key, x, None, prefix="test"))
    return jm, _np_tree(init(jax.random.PRNGKey(3), x))


@pytest.fixture(scope="module")
def case(jax_model):
    """(JAX model, grid variables, torch model, partial clouds, gt, seed):
    the first seed whose feature kNN and final FPS have their margins."""
    jm, variables = jax_model
    apply_capture = jax.jit(lambda v, x: jm.apply(
        v, x, None, prefix="test", capture_intermediates=True))
    for seed in range(20):
        rng = np.random.default_rng(seed)
        pts = grid_points(rng, NUM_COARSE + B * NUM_POINTS)
        coarse, x = pts[:NUM_COARSE], pts[NUM_COARSE:].reshape(B, NUM_POINTS, 3)
        v = _with_grid_coarse(variables, coarse)
        tm = tecg.Model(NUM_POINTS, NUM_COARSE, NUM_POINTS, (128, 32, 8)).eval()
        load_flax_params(tm, v)
        got = _port_activations(tm, x)
        pred, want = _jax_activations(apply_capture, v, x)
        if all(_knn_sets_agree(got[n], want[n], K) for n, _ in STAGES) and \
                fps_sequences_agree(got["fine"], want["fine"], NUM_POINTS):
            noise = rng.normal(0.0, 0.012, pred.shape).astype(np.float32)
            gt = (pred[:, rng.permutation(NUM_POINTS)] + noise).astype(np.float32)
            return jm, v, tm, x, gt, seed
    raise AssertionError("no seed gave ECG inputs whose kNN and FPS have a margin")


def test_val_branch_matches_jax(case):
    jm, v, tm, x, gt, _ = case
    want = jax.jit(lambda v, x, gt: jm.apply(v, x, gt, prefix="val"))(v, x, gt)
    with torch.inference_mode():
        got = tm(torch.from_numpy(x), torch.from_numpy(gt), prefix="val")
    for k in ("out1", "out2"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), **OUT_TOL)
    for k in ("cd_p", "cd_t"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-4)
    f1 = got["f1"].numpy()
    assert ((f1 > 0.05) & (f1 < 0.95)).all(), f1
    np.testing.assert_allclose(f1, np.asarray(want["f1"]), rtol=0, atol=F1_ATOL)
    np.testing.assert_array_equal(got["emd"].numpy(), np.zeros(B, np.float32))


def test_test_branch_matches_jax(case):
    jm, v, tm, x, _, _ = case
    want = np.asarray(jax.jit(lambda v, x: jm.apply(v, x, None, prefix="test"))(
        v, x)["result"])
    with torch.inference_mode():
        got = tm(torch.from_numpy(x), None, prefix="test")["result"].numpy()
    assert got.shape == (B, NUM_POINTS, 3)
    np.testing.assert_allclose(got, want, **OUT_TOL)


def test_coarse_head_matches_jax(jax_model):
    """The unmodified decoder head on arbitrary points: out1 depends on the
    PCN encoder and the three dense layers only."""
    jm, variables = jax_model
    tm = tecg.Model(NUM_POINTS, NUM_COARSE, NUM_POINTS, (128, 32, 8)).eval()
    load_flax_params(tm, variables)
    rng = np.random.default_rng(11)
    x = rng.random((B, NUM_POINTS, 3), dtype=np.float64).astype(np.float32)
    want = jax.jit(lambda v, x: jm.apply(v, x, None, prefix="test",
                                         capture_intermediates=True))(variables, x)
    want = want[1]["intermediates"]["ECGDecoder_0"]["TorchDense_2"]["__call__"][0]
    want = np.asarray(want).reshape(B, NUM_COARSE, 3)
    with torch.inference_mode():
        got = tm(torch.from_numpy(x), torch.from_numpy(x), prefix="val")["out1"]
    np.testing.assert_allclose(got.numpy(), want, **OUT_TOL)


@pytest.mark.parametrize("mode", ["center_neighbor", "neighbor_center",
                                  "center_minus"])
def test_dense_edge_matches_jax(mode):
    from mvp_benchmark_tpu.models import layers as jlayers

    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 30, 6)).astype(np.float32)
    idx = rng.integers(0, 30, (2, 30, 5)).astype(np.int32)
    jl = jlayers.DenseEdge(8, mode=mode)
    params = _np_tree(jl.init(jax.random.PRNGKey(0), x, idx))
    want = np.asarray(jl.apply(params, x, idx))
    tl = layers.DenseEdge(6, 8, mode=mode)
    with torch.no_grad():
        tl.weight.copy_(torch.from_numpy(params["params"]["kernel"].T.copy()))
        tl.bias.copy_(torch.from_numpy(params["params"]["bias"]))
        got = tl(torch.from_numpy(x), torch.from_numpy(idx)).numpy()
    assert got.shape == (2, 30, 5, 8)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="unknown mode"):
        layers.DenseEdge(6, 8, mode="minus_center")


@pytest.mark.parametrize("reuse", [False, True])
def test_edge_preserve_sampling_matches_jax(reuse):
    """On grid points (exact distances on both sides), with the self-kNN row
    reuse of common.py:42-45 and without it."""
    from mvp_benchmark_tpu.models import common as jcommon
    from mvp_benchmark_tpu.ops import jnp_ref

    rng = np.random.default_rng(6)
    pts = grid_points(rng, 2 * 96).reshape(2, 96, 3)
    feats = rng.standard_normal((2, 96, 10)).astype(np.float32)
    jk = jnp_ref.knn_indices(pts, 16) if reuse else None
    tk = ref.knn_indices(torch.from_numpy(pts), 16) if reuse else None
    want = [np.asarray(a) for a in jcommon.edge_preserve_sampling(
        feats, pts, 24, 10, knn_idx=jk)]
    got = [a.numpy() for a in common.edge_preserve_sampling(
        torch.from_numpy(feats), torch.from_numpy(pts), 24, 10, knn_idx=tk)]
    for g, w, name in zip(got, want, ("net", "p_idx", "pn_idx", "points")):
        assert g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)


def test_full_width_parameter_count():
    cfg = Config(model_name="ecg", num_points=2048, loss="cd", eval_emd=False)
    model = get_model("ecg", cfg, generator=torch.Generator().manual_seed(0))
    assert sum(p.numel() for p in model.parameters()) == 14_195_987
    assert model.decoder.ef.hierarchy == (1024, 256, 64)
    assert tuple(model.decoder.ef.up4.weight.shape) == (1024, 2824)


def test_transplant_fills_every_parameter_and_rejects_a_tree_that_does_not_fit(
        jax_model):
    _, variables = jax_model
    tm = tecg.Model(NUM_POINTS, NUM_COARSE, NUM_POINTS, (128, 32, 8))
    load_flax_params(tm, variables)
    edge = variables["params"]["ECGDecoder_0"]["EFEncoder_0"]["DenseConv_2"]["DenseEdge_0"]
    np.testing.assert_array_equal(tm.decoder.ef.conv3.edge.weight.detach().numpy(),
                                  edge["kernel"].T)
    params = _np_tree(variables)["params"]
    del params["ECGDecoder_0"]["EFEncoder_0"]["DenseConv_1"]["DenseCat_1"]
    with pytest.raises(ValueError, match="missing"):
        load_flax_params(tm, {"params": params})


def test_train_branch_and_ef_expansion_are_not_ported(case):
    """The train branch runs (its parity with JAX is in
    test_torch_ecg_train.py); EFExpansion, which the protocol config never
    reaches, still raises."""
    _, _, tm, x, gt, _ = case
    out2, loss2, total = tm(torch.from_numpy(x), torch.from_numpy(gt),
                            prefix="train", alpha=0.5)
    assert out2.shape == (B, NUM_POINTS, 3) and loss2.shape == (B,)
    assert total.requires_grad and bool(torch.isfinite(total))
    with pytest.raises(NotImplementedError, match="EFExpansion"):
        tecg.Model(num_points=4096, num_coarse=512, num_input=1024)
