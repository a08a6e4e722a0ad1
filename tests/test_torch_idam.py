"""IDAM's eval branches in the torch port against the JAX package, on the CPU.

JAX IDAM (``idam.Model``: emb 64, 3 iterations, IDAM's protocol widths) on
2 clouds of 192 grid points (M = 32 kept), its parameters transplanted into
the torch model with their ``batch_stats``. The running statistics are
realistic and random: one JAX train-mode forward from zero statistics gives
each BatchNorm's batch statistics (flax moves them by 0.1 of the batch's),
the variances are then scaled by U(0.75, 1.25) and rounded to 4^k - 1e-5, so
that rsqrt(var + 1e-5) is a power of two in both frameworks (XLA's and
PyTorch's CPU rsqrt differ in the last bit for ~30% of inputs); the
BatchNorm scales and biases are random. The clouds are grid points and tgt
is src under a grid-preserving pose, so both kNNs are exact and equal
(``tests/test_torch_dcp.py``). JAX runs op by op (``jax.disable_jit()``):
jitted, XLA:CPU contracts BatchNorm's ``hhat * gamma + beta`` into an FMA,
which moves the bf16 rounding of some activations.

Why the comparison is staged: the Propagate block rounds its gather table to
bf16 (``bf16(p)[idx] - p_center``, as the TPU kernel does), so a one-ulp
difference in a projection p -- the two frameworks sum their matrix
products in different orders -- can move bf16(p_j) by 2^-8 |p_j|, far more
than that relative to the small edge p_j - p_i. Over five layers that
grows; measured here: the GNN embeddings of tgt and src 2.0e-3 and 2.6e-3
apart normwise (bar 2e-2), which moves the significance scores by more than the gaps between
some of them, so the kept points and then the pose may differ end to end.
Hence:
- each layer's edge block on JAX's own projection p and kNN: within
  1e-5 + 1e-5 |x| (measured 2.4e-7 at most);
- the GNN end to end: normwise 2e-2 (measured 2.6e-3, the reason above);
- everything after the GNN, on JAX's embeddings (the port's GNN handed
  them): src_idx, tgt_idx and every iteration's corr_idx equal; r_err,
  t_err, rmse and mse within BASELINE's 1e-4 (rtol and atol; measured
  7.4e-5 relative for r_err, 0.0122 of 166 degrees, the others <= 2.1e-5);
  T_12 within atol 1e-3 (measured 2.2e-4): the similarity MLP rounds x1 and
  h1 to bf16, so the one-ulp differences of the two frameworks' projection
  products (sp, tp) move a few activations to the other bf16 neighbour --
  JAX's own kernel and reference are 4.1e-4 apart in sim for that reason --
  which reaches the weights and then the three poses.

Plus: the transplant covers every leaf (87,943 parameters, 1,408 running
statistics) and round-trips; the train branch runs (its parity with JAX:
test_torch_idam_train.py) and ``use_fpfh`` raises; the
launch counts of a protocol batch (full width, one pair of 2048 points),
computed as ``tests/test_torch_dcp.py`` computes DCP's.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvp_benchmark_tpu.models import idam as jidam
from mvp_benchmark_tpu_torch.models import idam as tidam
from mvp_benchmark_tpu_torch.models.transplant import load_flax_params, to_flax_params
from mvp_benchmark_tpu_torch.train.config import Config
from tests.util_clouds import grid_points

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, N = 2, 192
NAMES = ("loss", "r_err", "t_err", "rmse", "mse")


def _inputs():
    rng = np.random.default_rng(0)
    src = grid_points(rng, B * N).reshape(B, N, 3)
    R = np.array([[0, -1, 0], [1, 0, 0], [0, 0, 1]], np.float32)
    t = np.array([3, -5, 7], np.float32) / 32
    tgt = (src @ R.T + t).astype(np.float32)[:, rng.permutation(N)]
    T = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    T[:, :3, :3], T[:, :3, 3] = R, t
    return src, tgt, T


def _random_bn_params(params, rng, in_bn=False):
    """BatchNorm scales 1 + 0.1 N(0, 1) and biases 0.1 N(0, 1): the
    ConvBlocks' BatchNorms, the edge blocks' and the similarity MLPs'."""
    for k, x in params.items():
        if isinstance(x, dict):
            _random_bn_params(x, rng, in_bn or k.startswith("BatchNorm"))
        elif (in_bn and k == "scale") or k == "edge_scale" or "_scale" in k:
            params[k] = (1 + 0.1 * rng.standard_normal(x.shape)).astype(np.float32)
        elif (in_bn and k == "bias") or k == "edge_bias" or "_bias" in k:
            params[k] = (0.1 * rng.standard_normal(x.shape)).astype(np.float32)


def _realistic(mean, var, rng):
    """A BatchNorm's running statistics from its input's batch statistics:
    the mean kept, the variance times U(0.75, 1.25) rounded to 4^k - 1e-5
    (so that rsqrt(var + 1e-5) is exact in both frameworks)."""
    eps = np.float32(1e-5)
    v = var.double().numpy() * (0.75 + 0.5 * rng.random(var.shape))
    p4 = (4.0 ** np.round(np.log(v + 1e-5) / np.log(4.0))).astype(np.float32)
    out = (p4 - eps).astype(np.float32)
    assert np.array_equal(out + eps, p4)
    return mean.float(), torch.from_numpy(out)


def _stats(h):
    dims = tuple(range(h.dim() - 1))
    mean = h.mean(dim=dims)
    return mean, torch.clamp((h * h).mean(dim=dims) - mean * mean, min=0.0)


def _calibrate(tm, src, tgt, rng):
    """Set every running statistic of the port's model from what its layer
    sees in one eval forward on (src, tgt), layer by layer in forward order
    (``_realistic``), as a trained model's would be: the ConvBlocks'
    BatchNorms by a hook on their input, the edge blocks' from the bf16 edge
    tensor, the similarity MLPs' from h0 and h2 (``ops.ref`` pieces)."""
    from mvp_benchmark_tpu_torch import ops
    from mvp_benchmark_tpu_torch.models import layers
    from mvp_benchmark_tpu_torch.ops import ref

    def set_(mean, var, h):
        m, v = _realistic(*_stats(h), rng)
        mean.copy_(m)
        var.copy_(v)

    def propagate(p, idx, W, b, gamma, beta, mean, var, train):
        edge = (ref.grouping_operation(ref._bf16(p), idx) - p[:, :, None, :])
        set_(mean, var, edge.to(torch.bfloat16).float())
        return ref.gnn_propagate_eval(p, idx, W, b, gamma, beta, mean, var), None

    def sim_mlp(src, tgt, semb, temb, Wcat, W2, b2, W3, W4, b4, g1, be1, g2, be2,
                mean1, var1, mean2, var2, train):
        sp, tp = ref.sim_projections(semb, temb, Wcat)
        h0 = ref.sim_h0(sp, tp, src, tgt, *ref.sim_mlp_split(Wcat, semb.shape[-1]))
        set_(mean1, var1, h0)
        x1 = ref._bn_relu(h0, mean1, ref.bn_inv(var1), g1, be1)
        set_(mean2, var2, ref._bf16_dot(ref._bf16_dot(x1, W2) + b2, W3))
        return (*ref.sim_mlp_eval(src, tgt, semb, temb, Wcat, W2, b2, W3, W4, b4,
                                  g1, be1, g2, be2, mean1, var1, mean2, var2), None)

    hooks = [m.register_forward_pre_hook(lambda m, args: set_(m.mean, m.var, args[0]))
             for m in tm.modules() if isinstance(m, layers.BatchNorm)]
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(ops, "gnn_propagate", propagate)
        mp.setattr(ops, "sim_mlp", sim_mlp)
        with torch.inference_mode():
            tm(torch.from_numpy(src), torch.from_numpy(tgt), None, prefix="test")
    finally:
        mp.undo()
        for h in hooks:
            h.remove()


@pytest.fixture(scope="module")
def pair():
    src, tgt, T = _inputs()
    jm = jidam.Model(emb_dims=64, num_iters=3)
    v = jax.tree.map(np.array, jax.jit(
        lambda k, s, g: jm.init(k, s, g, None, prefix="test"))(
            jax.random.PRNGKey(0), src, tgt))
    rng = np.random.default_rng(1)
    _random_bn_params(v["params"], rng)
    tm = load_flax_params(tidam.Model(64, 3).eval(), v)
    _calibrate(tm, src, tgt, rng)
    v["batch_stats"] = to_flax_params(tm)["batch_stats"]
    return jm, v, tm, (src, tgt, T)


def _recording(module, monkeypatch):
    """Record every index handed to ``module._batch_take``: src_idx twice,
    tgt_idx twice, then each iteration's corr_idx."""
    seen = []
    take = module._batch_take

    def record(x, idx):
        seen.append(np.asarray(idx).astype(np.int64))
        return take(x, idx)

    monkeypatch.setattr(module, "_batch_take", record)
    return seen


@pytest.fixture(scope="module")
def jax_run(pair):
    """JAX op by op: the val outputs with the GNN's and the Propagate layers'
    intermediates, the taken indices, and the test branch's T_12."""
    jm, v, _, (src, tgt, T) = pair
    mp = pytest.MonkeyPatch()
    try:
        seen = _recording(jidam, mp)
        with jax.disable_jit():
            out, state = jm.apply(v, src, tgt, T, prefix="val",
                                  capture_intermediates=True, mutable=["intermediates"])
            idx = [x for x in seen]
            T12 = jm.apply(v, src, tgt, None, prefix="test")
    finally:
        mp.undo()
    return ([np.asarray(o) for o in out], state["intermediates"], idx,
            np.asarray(T12))


def test_edge_blocks_and_layers_match_jax_given_its_inputs(pair, jax_run):
    """Each Propagate layer of the GNN on tgt: the port's projection, edge
    block and ConvBlock on JAX's input to that layer and JAX's kNN."""
    jm, v, tm, (src, tgt, _) = pair
    _, inter, _, _ = jax_run
    from mvp_benchmark_tpu.ops import jnp_ref
    from mvp_benchmark_tpu_torch import ops

    idx = torch.from_numpy(np.array(jnp_ref.knn_indices(jnp.asarray(tgt), 12)))
    assert torch.equal(idx, ops.knn_indices(torch.from_numpy(tgt), 12).long())
    x = tgt
    with torch.inference_mode():
        for i, prop in enumerate(tm.gnn.props):
            jp = inter["GNN_0"][f"Propagate_{i}"]
            p = np.array(jp["TorchDense_0"]["__call__"][0])
            np.testing.assert_allclose(prop.fc(torch.from_numpy(x)).numpy(), p,
                                       rtol=1e-5, atol=1e-5)
            h, stats = ops.gnn_propagate(torch.from_numpy(p), idx, prop.edge_W,
                                         prop.edge_b, prop.edge_scale, prop.edge_bias,
                                         prop.edge_mean, prop.edge_var, False)
            assert stats is None
            want = np.array(jp["__call__"][0])
            np.testing.assert_allclose(prop.conv(h).numpy(), want, rtol=1e-5,
                                       atol=1e-5, err_msg=f"Propagate_{i}")
            x = want


def test_gnn_end_to_end_within_the_bf16_table_bar(pair, jax_run):
    _, _, tm, (src, tgt, _) = pair
    _, inter, _, _ = jax_run
    with torch.inference_mode():
        for got, cloud in zip((tm.gnn(torch.from_numpy(tgt)), tm.gnn(torch.from_numpy(src))),
                              inter["GNN_0"]["__call__"]):
            w = np.asarray(cloud, np.float64)
            rel = np.linalg.norm(got.numpy() - w) / np.linalg.norm(w)
            assert rel <= 2e-2, rel


def _port_on_jax_embeddings(pair, jax_run, monkeypatch):
    """The port's val and test branches with its GNN handing back JAX's
    embeddings (tgt, then src, per forward) -> (val outputs, T_12, taken
    indices of the val branch)."""
    _, _, tm, (src, tgt, T) = pair
    _, inter, _, _ = jax_run
    embs = [torch.from_numpy(np.array(e)) for e in inter["GNN_0"]["__call__"]]
    calls = []

    def gnn(pts, train=False):
        calls.append(pts)
        return embs[(len(calls) - 1) % 2]

    monkeypatch.setattr(tm.gnn, "forward", gnn)
    seen = _recording(tidam, monkeypatch)
    t = torch.from_numpy
    with torch.inference_mode():
        out = [o.numpy() for o in tm(t(src), t(tgt), t(T), prefix="val")]
        taken = list(seen)
        T12 = tm(t(src), t(tgt), None, prefix="test").numpy()
    assert torch.equal(calls[0], t(tgt)) and torch.equal(calls[1], t(src))
    return out, T12, taken


def test_val_and_test_branches_match_jax_given_its_embeddings(pair, jax_run,
                                                              monkeypatch):
    want, _, want_idx, want_T = jax_run
    got, got_T, got_idx = _port_on_jax_embeddings(pair, jax_run, monkeypatch)
    assert len(got_idx) == len(want_idx) == 4 + 3
    for n, (g, w) in enumerate(zip(got_idx, want_idx)):
        what = ("src_idx", "src_idx", "tgt_idx", "tgt_idx", "corr_idx 0",
                "corr_idx 1", "corr_idx 2")[n]
        np.testing.assert_array_equal(g, w, err_msg=what)
    assert got_T.shape == (B, 4, 4)
    np.testing.assert_allclose(got_T, want_T, rtol=0, atol=1e-3)
    np.testing.assert_array_equal(got_T[:, 3], np.tile([0, 0, 0, 1], (B, 1)))
    for name, g, w in zip(NAMES, got, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4, err_msg=name)


def test_transplant_covers_every_leaf_and_round_trips(pair):
    _, v, tm, _ = pair
    assert sum(p.numel() for p in tm.parameters()) == 87943
    assert sum(b.numel() for b in tm.buffers()) == 1408
    tree = to_flax_params(tm)
    for coll in ("params", "batch_stats"):
        want = dict(jax.tree_util.tree_flatten_with_path(v[coll])[0])
        got = dict(jax.tree_util.tree_flatten_with_path(tree[coll])[0])
        assert sorted(map(str, got)) == sorted(map(str, want))
        for path, w in want.items():
            np.testing.assert_array_equal(got[path], w, err_msg=str(path))
    stats = jax.tree.map(np.array, v["batch_stats"])
    del stats["sim2_var1"]
    with pytest.raises(ValueError, match="sim2_var1"):
        load_flax_params(tidam.Model(64, 3), {"params": v["params"], "batch_stats": stats})
    params = jax.tree.map(np.array, v["params"])
    del params["GNN_0"]["Propagate_3"]["edge_W"]
    with pytest.raises(ValueError, match="edge_W"):
        load_flax_params(tidam.Model(64, 3), {"params": params,
                                              "batch_stats": v["batch_stats"]})


def test_train_branch_train_path_and_fpfh_raise(pair, tmp_path):
    """The train branch and the train path run (this test once checked that
    they raised; their parity with JAX is in test_torch_idam_train.py, the
    whole train loop in test_torch_import_registration.py): the train branch
    without kept points or a generator raises, with a generator it returns
    five finite outputs and moves the running statistics;
    ``engine.build_model(for_training=True)`` builds IDAM and its train step
    runs; ``use_fpfh`` still raises."""
    import copy

    from mvp_benchmark_tpu_torch.train import engine
    from mvp_benchmark_tpu_torch.train.config import load_config
    from mvp_benchmark_tpu_torch.train.optim import build_optimizer

    _, _, tm, (src, tgt, T) = pair
    tm = copy.deepcopy(tm).train()
    t = torch.from_numpy
    with pytest.raises(ValueError, match="generator or src_idx"):
        tm(t(src), t(tgt), t(T), prefix="train")
    before = tm.sim0_var1.clone()
    out = tm(t(src), t(tgt), t(T), prefix="train", generator=torch.Generator().manual_seed(0))
    assert len(out) == 5 and all(bool(torch.isfinite(o).all()) for o in out)
    assert not torch.equal(before, tm.sim0_var1)
    cfg = load_config(os.path.join(ROOT, "registration", "cfgs", "idam_smoke.yaml"))
    cpu = torch.device("cpu")
    model = engine.build_model(cfg, cpu, for_training=True).train()
    batch = next(engine.registration_dataset(cfg, "train", str(tmp_path)).batches(
        engine.BatchSpec(int(cfg.batch_size))))
    dev = engine.make_registration_train_step(
        model, build_optimizer(cfg, model.parameters()), cpu)(batch)
    assert all(bool(torch.isfinite(v)) for v in dev.values())
    with pytest.raises(NotImplementedError, match="use_fpfh"):
        tidam.build(Config(model_name="idam", use_fpfh=True))
    m = tidam.build(Config(model_name="idam", descriptor_size=32, num_iters=2))
    assert m.emb_dims == 32 and len(m.weight_fcs) == 2


@pytest.mark.parametrize("prefix", ["val", "test"])
def test_protocol_batch_launches_what_chip_smoke_derives(monkeypatch, prefix):
    """One batch of ``cfgs/idam.yaml`` (full width, one pair of 2048 points),
    every tensor routed as a CUDA tensor would be and each kernel launcher
    replaced by a counting stand-in around its plain version: the launches
    equal ``chip_smoke.IDAM_PER_BATCH``."""
    import chip_smoke
    from mvp_benchmark_tpu_torch.ops import dispatch, kernels, ref
    from mvp_benchmark_tpu_torch.train import engine
    from mvp_benchmark_tpu_torch.train.config import load_config

    counts = {}

    def counted(key, fn):
        def launch(*a, **kw):
            counts[key] = counts.get(key, 0) + 1
            return fn(*a, **kw)
        return launch

    for launcher, key, fn in (("knn", "knn", ref.knn),
                              ("gnn_propagate_forward", "gnn_propagate",
                               ref.gnn_propagate_eval),
                              ("sim_mlp_forward", "sim_mlp", ref.sim_mlp_core)):
        monkeypatch.setattr(kernels, launcher, counted(key, fn))
    monkeypatch.setattr(dispatch, "_route", lambda *xs: "cuda")
    cfg = load_config(chip_smoke.IDAM_CFG, batch_size=1)
    cpu = torch.device("cpu")
    batch = next(engine.registration_dataset(cfg, "val", os.path.join(ROOT, "nodata"))
                 .batches(engine.BatchSpec(1)))
    out = engine.make_registration_eval_step(engine.build_model(cfg, cpu), cpu)(
        batch, prefix)
    assert counts == chip_smoke.IDAM_PER_BATCH
    assert all(bool(torch.isfinite(o).all()) for o in
               (out if isinstance(out, tuple) else (out,)))
