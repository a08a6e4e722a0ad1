"""The registration path shared by DCP, DeepGMR and IDAM in the torch port,
against the JAX package, on the CPU: metrics, augmentation, the dataset,
and the layers DCP adds (BatchNorm with running statistics,
UnbiasedLayerNorm, symmetric_svd_rotation, MultiDense's dtype).

Bars: metrics and pose math atol 1e-5 / rtol 1e-5 (fp32, summed in another
order; angles from acos near its clamp are avoided); the dataset and the
augmentation bitwise (the same numpy draws); layers atol 1e-5 / rtol 1e-5,
and bitwise for bf16 outputs of a bf16 product (one rounding of the same
fp32 sum, up to its summation order: at most one bf16 step).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvp_benchmark_tpu.data import augment as jaugment
from mvp_benchmark_tpu.data.mvp import MVPRegistrationDataset as JDataset
from mvp_benchmark_tpu.metrics import registration as jmetrics
from mvp_benchmark_tpu.models import layers as jlayers
from mvp_benchmark_tpu_torch.data import augment
from mvp_benchmark_tpu_torch.data.mvp import BatchSpec, MVPRegistrationDataset
from mvp_benchmark_tpu_torch.metrics import registration as metrics
from mvp_benchmark_tpu_torch.models import PORTED_MODELS, get_model, layers
from mvp_benchmark_tpu_torch.train.config import Config

TOL = dict(rtol=1e-5, atol=1e-5)
T = torch.from_numpy


def _poses(seed, B=6, max_angle=np.pi / 2):
    rng = np.random.default_rng(seed)
    return np.stack([augment.random_pose(max_angle, 0.5, rng)
                     for _ in range(B)]).astype(np.float32)


def test_metrics_match_jax():
    rng = np.random.default_rng(0)
    T1, T2 = _poses(1), _poses(2)
    pts = rng.random((6, 50, 3), dtype=np.float64).astype(np.float32)
    quat = rng.standard_normal((6, 4)).astype(np.float32)
    quat /= np.linalg.norm(quat, axis=1, keepdims=True)
    trans = rng.standard_normal((6, 3)).astype(np.float32)
    cases = [
        ("quat2mat", (quat,)),
        ("transform_point_cloud", (np.swapaxes(pts, 1, 2).copy(), quat, trans)),
        ("transform_point_cloud", (np.swapaxes(pts, 1, 2).copy(), T1[:, :3, :3], trans)),
        ("rt_to_transformation", (T1[:, :3, :3], T1[:, :3, 3:])),
        ("rotation_error", (T1[:, :3, :3], T2[:, :3, :3])),
        ("translation_error", (T1[:, :3, 3], T2[:, :3, 3])),
        ("rmse_loss", (pts, T1, T2)),
        ("rotation_geodesic_error", (T1[:, :3, :3], T2[:, :3, :3])),
    ]
    for name, args in cases:
        want = np.asarray(getattr(jmetrics, name)(*map(jnp.asarray, args)))
        got = getattr(metrics, name)(*map(T, args)).numpy()
        np.testing.assert_allclose(got, want, err_msg=name, **TOL)


def test_augmentation_draws_equal_jax():
    src = np.random.default_rng(3).random((64, 3)).astype(np.float32)
    a, b = np.random.default_rng(4), np.random.default_rng(4)
    for want, got in zip(jaugment.augment_pair(src, src[::-1], 0.7, 0.5, a),
                         augment.augment_pair(src, src[::-1], 0.7, 0.5, b)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(augment.jitter_pcd(src, np.random.default_rng(5)),
                                  jaugment.jitter_pcd(src, np.random.default_rng(5)))


@pytest.mark.parametrize("prefix", ["val", "test", "train"])
def test_dataset_batches_equal_jax(tmp_path, prefix):
    """The synthetic splits, batch by batch (the JAX train split through its
    numpy augmentation, the port's only one), with a padded last batch."""
    kw = dict(max_angle=45.0, max_trans=0.5, data_dir=str(tmp_path),
              num_points=64, seed=3)
    jd = JDataset(prefix, use_native=False, **kw)
    td = MVPRegistrationDataset(prefix, **kw)
    spec = BatchSpec(5, shuffle=prefix == "train", seed=1)
    assert len(td) == len(jd) and td.steps_per_epoch(spec) == jd.steps_per_epoch(spec)
    for jb, tb in zip(jd.batches(spec), td.batches(spec)):
        assert sorted(jb) == sorted(tb)
        for key in jb:
            np.testing.assert_array_equal(tb[key], jb[key], err_msg=key)


def test_dataset_category_filter_equals_jax(tmp_path):
    kw = dict(data_dir=str(tmp_path), num_points=32, category=3)
    jd, td = JDataset("val", **kw), MVPRegistrationDataset("val", **kw)
    assert len(td) == len(jd) == 2
    np.testing.assert_array_equal(td.transforms, jd.transforms)
    np.testing.assert_array_equal(td.rot_level, jd.rot_level)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def test_batch_norm_eval_matches_jax_with_running_statistics():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 30, 16)).astype(np.float32)
    jl = jlayers.BatchNorm()
    v = jax.tree.map(np.array, jl.init(jax.random.PRNGKey(0), x, False))
    stats = v["batch_stats"]["BatchNorm_0"]
    stats["mean"] = rng.standard_normal(16).astype(np.float32)
    stats["var"] = (0.2 + rng.random(16)).astype(np.float32)
    p = v["params"]["BatchNorm_0"]
    p["scale"] = rng.standard_normal(16).astype(np.float32)
    p["bias"] = rng.standard_normal(16).astype(np.float32)
    want = np.asarray(jl.apply(v, x, False))
    tl = layers.BatchNorm(16)
    with torch.no_grad():
        tl.weight.copy_(T(p["scale"]))
        tl.bias.copy_(T(p["bias"]))
        tl.mean.copy_(T(stats["mean"]))
        tl.var.copy_(T(stats["var"]))
    fp32 = tl(T(x)).detach()
    np.testing.assert_allclose(fp32.numpy(), want, **TOL)
    layers.set_compute_dtype(torch.bfloat16)
    try:   # the output follows the activation policy, the statistics fp32
        got = tl(T(x)).detach()
    finally:
        layers.set_compute_dtype(torch.float32)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got, fp32.to(torch.bfloat16), rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_unbiased_layer_norm_matches_jax(dtype):
    rng = np.random.default_rng(7)
    x = (3.0 + rng.standard_normal((2, 20, 32))).astype(np.float32)
    jdt = None if dtype is None else jnp.bfloat16
    tdt = None if dtype is None else torch.bfloat16
    jl = jlayers.UnbiasedLayerNorm(dtype=jdt)
    v = {"params": {"scale": rng.standard_normal(32).astype(np.float32),
                    "bias": rng.standard_normal(32).astype(np.float32)}}
    want = np.asarray(jl.apply(v, x).astype(jnp.float32))
    tl = layers.UnbiasedLayerNorm(32, dtype=tdt)
    with torch.no_grad():
        tl.weight.copy_(T(v["params"]["scale"]))
        tl.bias.copy_(T(v["params"]["bias"]))
    got = tl(T(x)).detach()
    assert got.dtype == (tdt or torch.float32)
    if dtype is None:
        np.testing.assert_allclose(got.numpy(), want, **TOL)
    else:   # one bf16 step at most
        got = got.float().numpy()
        assert (np.abs(got - want) <= 2.0 ** -7 * np.abs(want)).all()


def test_symmetric_svd_rotation_matches_jax_with_reflections():
    rng = np.random.default_rng(8)
    H = rng.standard_normal((16, 3, 3)).astype(np.float32)
    want = np.asarray(jlayers.symmetric_svd_rotation(jnp.asarray(H)))
    got = layers.symmetric_svd_rotation(T(H)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(np.linalg.det(got), 1.0, atol=1e-5)
    U, _, Vt = np.linalg.svd(H)
    assert (np.linalg.det(Vt.transpose(0, 2, 1) @ U.transpose(0, 2, 1)) < 0).any()


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_multi_dense_honours_dtype_as_jax(dtype):
    """The repair: MultiDense computes and returns ``dtype`` (the JAX module's
    field), not the global policy alone."""
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 10, 24)).astype(np.float32)
    jdt = None if dtype is None else jnp.bfloat16
    tdt = None if dtype is None else torch.bfloat16
    jl = jlayers.MultiDense((8, 16), dtype=jdt)
    v = _np_tree(jl.init(jax.random.PRNGKey(1), x))
    want = np.asarray(jl.apply(v, x).astype(jnp.float32))
    tl = layers.MultiDense(24, (8, 16), dtype=tdt)
    with torch.no_grad():
        for i in range(2):
            getattr(tl, f"weight{i}").copy_(T(v["params"][f"kernel{i}"].T.copy()))
            getattr(tl, f"bias{i}").copy_(T(v["params"][f"bias{i}"]))
    got = tl(T(x)).detach()
    assert got.dtype == (tdt or torch.float32)
    got = got.float().numpy()
    if dtype is None:
        np.testing.assert_allclose(got, want, **TOL)
    else:
        assert (np.abs(got - want) <= 2.0 ** -7 * np.abs(want)).all()


def test_dcp_is_ported_at_the_jax_parameter_count():
    assert "dcp" in PORTED_MODELS
    model = get_model("dcp", Config(model_name="dcp"),
                      generator=torch.Generator().manual_seed(0))
    assert sum(p.numel() for p in model.parameters()) == 5_568_896
    assert sum(b.numel() for b in model.buffers()) == 2 * (512 + 512)


def test_batch_norm_train_matches_flax_over_two_calls():
    """Train mode: batch statistics (fp32, flax's biased fast variance), the
    output and its gradients, and the running statistics after two calls
    (``0.9 ra + 0.1 batch`` twice, DCP's src then tgt), against flax's
    ``nn.BatchNorm`` with mutable ``batch_stats``: atol 1e-5 / rtol 1e-5
    (1e-7 relative measured)."""
    rng = np.random.default_rng(10)
    xs = [(3 * rng.standard_normal((2, 40, 16)) + 1).astype(np.float32) for _ in range(2)]
    cot = rng.standard_normal((2, 40, 16)).astype(np.float32)
    jl = jlayers.BatchNorm()
    v = jax.tree.map(np.array, jl.init(jax.random.PRNGKey(0), xs[0], False))
    p = v["params"]["BatchNorm_0"]
    p["scale"] = (1 + 0.1 * rng.standard_normal(16)).astype(np.float32)
    p["bias"] = (0.1 * rng.standard_normal(16)).astype(np.float32)
    stats = v["batch_stats"]
    tl = layers.BatchNorm(16)
    with torch.no_grad():
        tl.weight.copy_(T(p["scale"]))
        tl.bias.copy_(T(p["bias"]))
    for x in xs:
        def loss(x, params):
            y, new = jl.apply({"params": params, "batch_stats": stats}, x, True,
                              mutable=["batch_stats"])
            return jnp.sum(y * cot), (y, new)
        (_, (want, new)), (gx, gp) = jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True)(x, v["params"])
        stats = new["batch_stats"]
        xt = T(x).requires_grad_()
        tl.weight.grad = tl.bias.grad = None
        got = tl(xt, train=True)
        (got * T(cot)).sum().backward()
        np.testing.assert_allclose(got.detach().numpy(), want, **TOL)
        np.testing.assert_allclose(xt.grad.numpy(), gx, **TOL)
        np.testing.assert_allclose(tl.weight.grad.numpy(), gp["BatchNorm_0"]["scale"], **TOL)
        np.testing.assert_allclose(tl.bias.grad.numpy(), gp["BatchNorm_0"]["bias"], **TOL)
    np.testing.assert_allclose(tl.mean.numpy(), stats["BatchNorm_0"]["mean"], **TOL)
    np.testing.assert_allclose(tl.var.numpy(), stats["BatchNorm_0"]["var"], **TOL)
    assert not np.allclose(tl.var.numpy(), 1.0)


def test_plateau_scheduler_equals_jax():
    """The learning rates of an RMSE sequence with plateaus, cuts and the
    floor, step by step, equal the JAX package's."""
    from mvp_benchmark_tpu.train import optim as joptim
    from mvp_benchmark_tpu_torch.train import optim as toptim
    rng = np.random.default_rng(11)
    metrics = np.concatenate([np.linspace(1, 0.5, 5), 0.6 + rng.random(40) * 0.1,
                              [0.4], 0.5 + rng.random(60) * 0.1])
    j, t = joptim.PlateauScheduler(1e-3, 0.5, 1e-4), toptim.PlateauScheduler(1e-3, 0.5, 1e-4)
    got = [t.step(float(m)) for m in metrics]
    want = [j.step(float(m)) for m in metrics]
    assert got == want
    assert min(got) == 1e-4 and len(set(got)) > 2
