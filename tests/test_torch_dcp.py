"""DCP's eval branches in the torch port against the JAX package, on the CPU.

JAX DCP parameters (``dcp.Model`` at the ``dcp_smoke.yaml`` size: 2 clouds of
128 points) are transplanted into the torch model with their ``batch_stats``,
which are set to random running statistics (and the edge chain's BatchNorm
parameters to random values) so that the running-stat path is really
compared. Both get the same numpy inputs.

The clouds are grid points (coordinates k/32), and tgt is src under a pose
that keeps them on the grid (a quarter turn about z and a shift by grid
steps): the JAX CPU kNN ranks by the |a|^2+|b|^2-2a.b expansion, the port
by exact differences, and on the grid both are exact, so the k = 20
neighbour sets are equal, ties going to the lower index on both sides.

Two comparisons:
- the transformer in fp32 (``TRANSFORMER_BF16``/``TRANSFORMER_RESID_BF16``
  set False on both sides): every attention fp32, the svd head fp32 on both
  sides. Bars of BASELINE.md: T_12 atol 1e-4, metrics 1e-4.
- the transformer in bf16, the default: the JAX CPU path keeps bf16 scores
  and a bf16 softmax (``layers.attention``) where the port follows the TPU
  kernel (fp32 scores, exact fp32 softmax). Measured here: T_12 within
  4.6e-4, the metrics within 5e-4 relative; bars T_12 atol 2e-3 and the
  metrics rtol 2e-3 / atol 2e-3.

The train branch's parity is in test_torch_dcp_train.py; the launch counts
of a protocol train step are here, beside the eval branches'.
"""

import contextlib
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from mvp_benchmark_tpu.models import dcp as jdcp
from mvp_benchmark_tpu_torch.models import dcp as tdcp
from mvp_benchmark_tpu_torch.models import pcn as tpcn
from mvp_benchmark_tpu_torch.models.transplant import load_flax_params, to_flax_params
from tests.test_torch_attention import _row_stats
from tests.util_clouds import grid_points

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, N = 2, 128
CHS = (64, 64, 128, 256)
NAMES = ("loss", "r_err", "t_err", "rmse", "rt_mse")


def _inputs():
    rng = np.random.default_rng(0)
    src = grid_points(rng, B * N).reshape(B, N, 3)
    R = np.array([[0, -1, 0], [1, 0, 0], [0, 0, 1]], np.float32)
    t = np.array([3, -5, 7], np.float32) / 32
    tgt = (src @ R.T + t).astype(np.float32)[:, rng.permutation(N)]
    T = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    T[:, :3, :3], T[:, :3, 3] = R, t
    return src, tgt, T


def _random_stats(v, rng):
    dg, st = v["params"]["DGCNN_0"], v["batch_stats"]["DGCNN_0"]
    for i, ch in enumerate(CHS):
        st[f"fused_mean{i}"] = (0.1 * rng.standard_normal(ch)).astype(np.float32)
        st[f"fused_var{i}"] = (0.5 + rng.random(ch)).astype(np.float32)
        dg[f"fused_scale{i}"] = (1 + 0.1 * rng.standard_normal(ch)).astype(np.float32)
        dg[f"fused_bias{i}"] = (0.1 * rng.standard_normal(ch)).astype(np.float32)
    bn = st["BatchNorm_0"]["BatchNorm_0"]
    bn["mean"] = (0.1 * rng.standard_normal(512)).astype(np.float32)
    bn["var"] = (0.5 + rng.random(512)).astype(np.float32)
    return v


@pytest.fixture(scope="module")
def pair():
    src, tgt, T = _inputs()
    jm = jdcp.Model()
    v = jax.jit(lambda k, s, g: jm.init(k, s, g, None, prefix="test"))(
        jax.random.PRNGKey(0), src, tgt)
    v = _random_stats(jax.tree.map(np.array, v), np.random.default_rng(1))
    tm = load_flax_params(tdcp.Model().eval(), v)
    return jm, v, tm, (src, tgt, T)


@contextlib.contextmanager
def _transformer_flags(on):
    saved = [(m, m.TRANSFORMER_BF16, m.TRANSFORMER_RESID_BF16) for m in (jdcp, tdcp)]
    try:
        for m in (jdcp, tdcp):
            m.TRANSFORMER_BF16 = m.TRANSFORMER_RESID_BF16 = on
        yield
    finally:
        for m, a, b in saved:
            m.TRANSFORMER_BF16, m.TRANSFORMER_RESID_BF16 = a, b


def _both(pair):
    """(JAX val outputs, JAX T_12, port val outputs, port T_12), numpy."""
    jm, v, tm, (src, tgt, T) = pair
    want = jax.jit(lambda v, s, g, T: jm.apply(v, s, g, T, prefix="val"))(v, src, tgt, T)
    want_T = jax.jit(lambda v, s, g: jm.apply(v, s, g, None, prefix="test"))(v, src, tgt)
    t = torch.from_numpy
    with torch.inference_mode():
        got = tm(t(src), t(tgt), t(T), prefix="val")
        got_T = tm(t(src), t(tgt), None, prefix="test")
    return ([np.asarray(w) for w in want], np.asarray(want_T),
            [g.numpy() for g in got], got_T.numpy())


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32_transformer",
                                                     "bf16_transformer"])
def test_val_and_test_branches_match_jax(pair, bf16):
    with _transformer_flags(bf16):
        want, want_T, got, got_T = _both(pair)
    tol = 2e-3 if bf16 else 1e-4
    assert got_T.shape == (B, 4, 4)
    np.testing.assert_allclose(got_T, want_T, rtol=0, atol=tol)
    np.testing.assert_array_equal(got_T[:, 3], np.tile([0, 0, 0, 1], (B, 1)))
    for name, g, w in zip(NAMES, got, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol, err_msg=name)
    # the val branch's pose is the test branch's
    np.testing.assert_allclose(got[1], np.degrees(np.arccos(np.clip(
        (np.einsum("bij,bij->b", got_T[:, :3, :3], _inputs()[2][:, :3, :3]) - 1) / 2,
        -1, 1))), rtol=1e-4, atol=1e-3)


def test_transplant_round_trips_batch_stats(pair):
    jm, v, tm, (src, tgt, _) = pair
    tree = to_flax_params(tm)
    assert sorted(tree) == ["batch_stats", "params"]
    for coll in ("params", "batch_stats"):
        want = dict(jax.tree_util.tree_flatten_with_path(v[coll])[0])
        got = dict(jax.tree_util.tree_flatten_with_path(tree[coll])[0])
        assert sorted(map(str, got)) == sorted(map(str, want))
        for path, w in want.items():
            np.testing.assert_array_equal(got[path], w, err_msg=str(path))
    back = load_flax_params(tdcp.Model(), tree)
    for (n, p), (_, q) in zip(tm.state_dict().items(), back.state_dict().items()):
        torch.testing.assert_close(p, q, rtol=0, atol=0, msg=n)
    with _transformer_flags(False):
        want_T = np.asarray(jm.apply(tree, src, tgt, None, prefix="test"))
        with torch.inference_mode():
            got_T = back.eval()(torch.from_numpy(src), torch.from_numpy(tgt),
                                None, prefix="test").numpy()
    np.testing.assert_allclose(got_T, want_T, rtol=0, atol=1e-4)


def test_transplant_refuses_missing_or_homeless_batch_stats(pair):
    _, v, _, _ = pair
    with pytest.raises(ValueError, match="batch_stats"):
        load_flax_params(tdcp.Model(), {"params": v["params"]})
    stats = jax.tree.map(np.array, v["batch_stats"])
    del stats["DGCNN_0"]["fused_var3"]
    with pytest.raises(ValueError, match="fused_var3"):
        load_flax_params(tdcp.Model(), {"params": v["params"], "batch_stats": stats})
    pcn = tpcn.Model(256, 64)
    tree = to_flax_params(pcn)
    assert sorted(tree) == ["params"]
    with pytest.raises(ValueError, match="no torch home"):
        load_flax_params(pcn, {**tree, "batch_stats": {"BatchNorm_0": {
            "mean": np.zeros(3, np.float32)}}})


@pytest.mark.parametrize("prefix", ["val", "test", "train"])
def test_protocol_batch_launches_what_chip_smoke_derives(monkeypatch, prefix):
    """One batch of ``cfgs/dcp.yaml`` (full width, one cloud of 2048
    points), every tensor routed as a CUDA tensor would be and each kernel
    launcher replaced by a counting stand-in around its plain version: the
    launches equal ``chip_smoke.DCP_PER_BATCH`` in the val and test
    branches, and ``chip_smoke.DCP_PER_STEP`` in a train step
    (``engine.make_registration_train_step``). The train chain's stand-ins
    count what its wrappers launch: four stat passes and the final pass a
    forward, five passes a backward."""
    import chip_smoke
    from mvp_benchmark_tpu_torch.ops import dispatch, kernels, ref
    from mvp_benchmark_tpu_torch.train import engine
    from mvp_benchmark_tpu_torch.train.config import load_config
    from mvp_benchmark_tpu_torch.train.optim import build_optimizer

    counts = {}

    def count(key, n=1):
        counts[key] = counts.get(key, 0) + n

    def counted(key, fn):
        def launch(*a, **kw):
            count(key)
            return fn(*a, **kw)
        return launch

    def attention_fwd(key, plain):
        def launch(q, k, v, scale, stats=False):
            count(key)
            out = plain(q, k, v, scale)
            return (out, *_row_stats(q, k, scale)) if stats else out
        return launch

    def attention_bwd(key):
        def launch(q, k, v, o, m, l, d_out, scale, need=(True, True, True)):
            count(key)
            grads = ref.attention_backward(q, k, v, o, m, l, d_out, scale)
            return tuple(g if n else None for g, n in zip(grads, need))
        return launch

    def edge_train_fwd(a1, Ws, gammas, betas):
        count("edge_mlp_stat", 4)
        count("edge_mlp")
        xs, stats = ref.edge_mlp_train(a1, Ws, gammas, betas)
        return xs, stats, torch.zeros((*a1.shape[:2], 512), dtype=torch.uint8)

    def edge_train_bwd(a1, Ws, gammas, betas, stats, slots, gxs, need_a1=False):
        count("edge_mlp_backward", 5)
        with torch.enable_grad():
            leaves = [x.detach().requires_grad_() for x in (*Ws, *gammas, *betas)]
            xs, _ = ref.edge_mlp_train(a1, leaves[:4], leaves[4:8], leaves[8:])
            grads = torch.autograd.grad(xs, leaves, gxs)
        return None, grads[:4], grads[4:8], grads[8:]

    for launcher, fn in (
            ("knn", counted("knn", ref.knn)),
            ("gather_rows", counted("gather", ref.gather_points)),
            ("edge_mlp_forward", counted("edge_mlp", ref.edge_mlp_eval)),
            ("attention_forward", attention_fwd("attention", ref.attention)),
            ("attention_bnhd_forward", attention_fwd("attention_bnhd", ref.attention_bnhd)),
            ("attention_backward", attention_bwd("attention_backward")),
            ("attention_bnhd_backward", attention_bwd("attention_bnhd_backward")),
            ("edge_mlp_train_forward", edge_train_fwd),
            ("edge_mlp_train_backward", edge_train_bwd)):
        monkeypatch.setattr(kernels, launcher, fn)
    monkeypatch.setattr(dispatch, "_route", lambda *xs: "cuda")
    cfg = load_config(chip_smoke.DCP_CFG, batch_size=1)
    cpu = torch.device("cpu")
    split = "train" if prefix == "train" else "val"
    batch = next(engine.registration_dataset(cfg, split, os.path.join(ROOT, "nodata"))
                 .batches(engine.BatchSpec(1)))
    if prefix == "train":
        model = engine.build_model(cfg, cpu, for_training=True)
        out = engine.make_registration_train_step(
            model, build_optimizer(cfg, model.parameters()), cpu)(batch)
        assert counts == chip_smoke.DCP_PER_STEP
        out = tuple(out.values())
        assert all(p.grad is not None and bool(torch.isfinite(p.grad).all())
                   for p in model.parameters())
    else:
        step = engine.make_registration_eval_step(engine.build_model(cfg, cpu), cpu)
        out = step(batch, prefix)
        assert counts == chip_smoke.DCP_PER_BATCH
    assert all(bool(torch.isfinite(o).all()) for o in
               (out if isinstance(out, tuple) else (out,)))


def test_cli_val_runs_on_cpu_without_jax_and_never_falls_back(tmp_path):
    """``registration/test_torch.py -c cfgs/dcp_smoke.yaml --val --device
    cpu`` with jax, flax, optax, yaml and h5py blocked: the five metrics and
    the 2x2 rot/match split in the log; ``--device cuda`` without a card
    raises instead of moving to the CPU."""
    cfg = os.path.join(ROOT, "registration", "cfgs", "dcp_smoke.yaml")
    text = open(cfg).read().replace("work_dir: log/", f"work_dir: {tmp_path}/")
    (tmp_path / "cfg.yaml").write_text(text)
    code = ("import sys, torch\n"
            "for m in ('jax', 'flax', 'optax', 'yaml', 'h5py'): sys.modules[m] = None\n"
            f"sys.path.insert(0, {os.path.join(ROOT, 'registration')!r})\n"
            "import test_torch\n"
            f"args = ['-c', {str(tmp_path / 'cfg.yaml')!r}, '--val', "
            f"'--data-dir', {str(tmp_path / 'nodata')!r}]\n"
            "test_torch.main(args + ['--device', 'cpu'])\n"
            "if not torch.cuda.is_available():\n"
            "    try:\n"
            "        test_torch.main(args + ['--device', 'cuda'])\n"
            "    except RuntimeError as e:\n"
            "        print('refused:', e)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    log = open(tmp_path / "dcp_mvp_smoke_torch_val" / "test_torch.log").read()
    for m in ("RotE", "transE", "MSE", "RMSE", "recall"):
        assert f"curr_{m}: " in log
    assert "[rot_level 1, match_level 1]" in log
    if not torch.cuda.is_available():
        assert "refused: device 'cuda' requested, but CUDA is not available" in out.stdout
