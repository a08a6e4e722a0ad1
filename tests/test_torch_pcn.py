"""The PCN slice of the torch port against the JAX package, on the CPU.

JAX PCN parameters are transplanted into the torch model; both get the same
numpy inputs. Tolerances:
- out1/out2/result: atol 1e-5, rtol 1e-4 (fp32 matmuls summed in another
  order);
- cd_p, cd_t: rtol 1e-4, the repo's metric bar;
- f1: atol 2/num_points. The JAX CPU path takes its chamfer through
  ``jnp_ref``'s |a|^2+|b|^2-2a.b expansion, which can move a point that sits
  on the 1e-4 threshold.
"""

import os
import zipfile

import h5py
import jax
import numpy as np
import optax
import pytest
import torch

from mvp_benchmark_tpu.data import mvp as jmvp
from mvp_benchmark_tpu.metrics import completion as jmetrics
from mvp_benchmark_tpu.models import pcn as jpcn
from mvp_benchmark_tpu.train import checkpoint as jckpt
from mvp_benchmark_tpu.train import engine as jengine
from mvp_benchmark_tpu.train import submission as jsubmission
from mvp_benchmark_tpu.train.config import Config as JConfig
from mvp_benchmark_tpu_torch.data import mvp as tmvp
from mvp_benchmark_tpu_torch.metrics import calc_emd
from mvp_benchmark_tpu_torch.models import get_model, layers
from mvp_benchmark_tpu_torch.models import pcn as tpcn
from mvp_benchmark_tpu_torch.models.transplant import load_flax_params
from mvp_benchmark_tpu_torch.train import checkpoint as tckpt
from mvp_benchmark_tpu_torch.train import engine as tengine
from mvp_benchmark_tpu_torch.train import submission as tsubmission
from mvp_benchmark_tpu_torch.train.config import Config
from tests.util_clouds import grid_points

NUM_POINTS, NUM_COARSE, B = 256, 128, 2
OUT_TOL = dict(rtol=1e-4, atol=1e-5)
F1_ATOL = 2.0 / NUM_POINTS
CPU = torch.device("cpu")


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def pair():
    """(JAX model, numpy variables, torch model with them transplanted)."""
    jm = jpcn.Model(num_points=NUM_POINTS, num_coarse=NUM_COARSE)
    x = np.zeros((B, NUM_POINTS, 3), np.float32)
    variables = _np_tree(jm.init(jax.random.PRNGKey(3), x, None, prefix="test"))
    tm = tpcn.Model(NUM_POINTS, NUM_COARSE).eval()
    load_flax_params(tm, variables)
    return jm, variables, tm


@pytest.fixture(scope="module")
def inputs(pair):
    """Partial clouds, and gt near the JAX prediction so F1 is neither 0
    nor 1 and the threshold is exercised."""
    jm, variables, _ = pair
    rng = np.random.default_rng(11)
    x = rng.random((B, NUM_POINTS, 3), dtype=np.float64).astype(np.float32)
    pred = np.asarray(jm.apply(variables, x, None, prefix="test")["result"])
    noise = rng.normal(0.0, 0.012, pred.shape).astype(np.float32)
    gt = pred[:, rng.permutation(NUM_POINTS)] + noise
    return x, gt.astype(np.float32)


def test_val_branch_matches_jax(pair, inputs):
    jm, variables, tm = pair
    x, gt = inputs
    want = jm.apply(variables, x, gt, prefix="val")
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


def test_test_branch_matches_jax(pair, inputs):
    jm, variables, tm = pair
    x, _ = inputs
    want = np.asarray(jm.apply(variables, x, None, prefix="test")["result"])
    with torch.inference_mode():
        got = tm(torch.from_numpy(x), None, prefix="test")["result"].numpy()
    assert got.shape == (B, NUM_POINTS, 3)
    np.testing.assert_allclose(got, want, **OUT_TOL)


def test_full_width_parameter_count():
    cfg = Config(model_name="pcn", num_points=2048, loss="cd", eval_emd=False)
    model = get_model("pcn", cfg, generator=torch.Generator().manual_seed(0))
    assert sum(p.numel() for p in model.parameters()) == 6_861_059
    assert tuple(model.decoder.fold1.weight.shape) == (512, 1029)


def test_seeded_init_is_reproducible():
    cfg = Config(model_name="pcn", num_points=64, num_coarse=32)
    m1, m2, m3 = (get_model("pcn", cfg, generator=torch.Generator().manual_seed(s))
                  for s in (5, 5, 6))
    for (n, p1), p2, p3 in zip(m1.named_parameters(), m2.parameters(),
                               m3.parameters()):
        assert torch.equal(p1, p2), n
        assert not torch.equal(p1, p3), n
    # torch's default Linear init: weight and bias in +-1/sqrt(fan_in)
    for layer in (m for m in m1.modules() if hasattr(m, "weight")):
        bound = 1.0 / np.sqrt(layer.weight.shape[1])
        assert float(layer.weight.detach().abs().max()) <= bound
        assert float(layer.bias.detach().abs().max()) <= bound


def test_densecat_equals_dense_over_concat():
    g = torch.Generator().manual_seed(0)
    dc = layers.DenseCat((2, 3, 8), 5, generator=g)
    dense = layers.TorchDense(13, 5, generator=g)
    with torch.no_grad():
        dense.weight.copy_(dc.weight)
        dense.bias.copy_(dc.bias)
    rng = np.random.default_rng(0)
    xs = [torch.from_numpy(rng.random(s, dtype=np.float32))
          for s in ((4, 6, 2), (4, 6, 3), (4, 1, 8))]
    cat = torch.cat([xs[0], xs[1], xs[2].expand(4, 6, 8)], dim=-1)
    torch.testing.assert_close(dc(*xs), dense(cat), rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="widths"):
        dc(xs[1], xs[0], xs[2])


@pytest.mark.parametrize("up_ratio", [1, 2, 4, 6, 8])
def test_gen_grid_up_matches_jax(up_ratio):
    from mvp_benchmark_tpu.models import layers as jlayers

    np.testing.assert_allclose(layers.gen_grid_up(up_ratio, 0.05).numpy(),
                               np.asarray(jlayers.gen_grid_up(up_ratio, 0.05)),
                               rtol=1e-6, atol=1e-7)


def test_transplant_rejects_a_tree_that_does_not_fit(pair):
    _, variables, _ = pair
    tm = tpcn.Model(NUM_POINTS, NUM_COARSE)
    params = {k: dict(v) for k, v in variables["params"].items()}
    del params["PCNDecoder_0"]["TorchDense_4"]
    with pytest.raises(ValueError, match="missing"):
        load_flax_params(tm, {"params": params})
    wrong = tpcn.Model(NUM_POINTS * 2, NUM_COARSE * 2)
    with pytest.raises(ValueError, match="does not fit"):
        load_flax_params(wrong, variables)


@pytest.mark.parametrize("name", ["dcp", "deepgmr", "idam"])
def test_unported_models_raise(name):
    """DeepGMR is not ported; IDAM's eval is and its train branch raises
    (its parity with JAX is in test_torch_idam.py); DCP is, eval and train:
    its train branch returns the val branch's five outputs (its parity with
    JAX is in test_torch_dcp.py)."""
    if name == "idam":
        g = torch.Generator().manual_seed(0)
        model = get_model(name, Config(model_name=name), generator=g)
        x, y = torch.rand(1, 32, 3, generator=g), torch.rand(1, 32, 3, generator=g)
        with pytest.raises(NotImplementedError, match="not yet ported"):
            model(x, y, torch.eye(4)[None], prefix="train")
        return
    if name == "dcp":
        g = torch.Generator().manual_seed(0)
        model = get_model(name, Config(model_name=name), generator=g)
        x, y = torch.rand(1, 32, 3, generator=g), torch.rand(1, 32, 3, generator=g)
        out = model(x, y, torch.eye(4)[None], prefix="train")
        assert len(out) == 5 and all(o.shape == (1,) or o.dim() == 0 for o in out)
        assert all(bool(torch.isfinite(o).all()) for o in out)
        return
    with pytest.raises(NotImplementedError, match="not yet ported"):
        get_model(name, Config(model_name=name))


def test_train_branch_and_emd_are_not_ported(pair, inputs):
    """The train branch is ported (its parity with JAX is in
    test_torch_train.py); the EMD loss raises the JAX package's ValueError
    at n != m (the 128 coarse points against 256 gt points), and calc_emd
    gives the JAX package's value (rtol 1e-6) on grid clouds, where both
    auctions see exact distances (the JAX CPU path ranks on the
    |a|^2+|b|^2-2a.b expansion; see test_torch_emd.py)."""
    jm, variables, tm = pair
    x, gt = (torch.from_numpy(a) for a in inputs)
    out2, loss2, total = tm(x, gt, prefix="train", alpha=0.5)
    want = jm.apply(variables, inputs[0], inputs[1], prefix="train", alpha=0.5)
    np.testing.assert_allclose(loss2.detach().numpy(), np.asarray(want[1]), rtol=1e-4)
    np.testing.assert_allclose(float(total.detach()), float(want[2]), rtol=1e-4)
    emd_model = tpcn.Model(NUM_POINTS, NUM_COARSE, train_loss="emd")
    jemd = jpcn.Model(num_points=NUM_POINTS, num_coarse=NUM_COARSE, train_loss="emd")
    with pytest.raises(ValueError, match="EMD requires n == m") as jerr:
        jax.eval_shape(lambda: jemd.apply(variables, inputs[0], inputs[1],
                                          prefix="train"))
    with pytest.raises(ValueError, match="EMD requires n == m") as err:
        emd_model(x, gt, prefix="train")
    assert str(err.value) == str(jerr.value)
    pts = grid_points(np.random.default_rng(12), 2 * B * NUM_POINTS) / 8.0
    a, b = pts.reshape(2, B, NUM_POINTS, 3)
    np.testing.assert_allclose(
        calc_emd(torch.from_numpy(a), torch.from_numpy(b), 0.004, 500).numpy(),
        np.asarray(jmetrics.calc_emd(a, b, 0.004, 500)), rtol=1e-6)


@pytest.mark.parametrize("prefix,spec", [
    ("val", jmvp.BatchSpec(32)),
    ("test", jmvp.BatchSpec(32)),
    ("train", jmvp.BatchSpec(64, shuffle=True, seed=3, num_shards=2, shard_id=1)),
])
def test_synthetic_batches_are_bit_equal(tmp_path, prefix, spec):
    jds = jmvp.MVPCompletionDataset(prefix, str(tmp_path), NUM_POINTS)
    tds = tmvp.MVPCompletionDataset(prefix, str(tmp_path), NUM_POINTS)
    tspec = tmvp.BatchSpec(**vars(spec))
    assert tds.steps_per_epoch(tspec) == jds.steps_per_epoch(spec)
    jb, tb = list(jds.batches(spec, epoch=2)), list(tds.batches(tspec, epoch=2))
    assert len(jb) == len(tb)
    for a, b in zip(jb, tb):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
            assert a[k].dtype == b[k].dtype


def _write_jax_checkpoint(path, variables):
    opt_state = optax.adam(1e-4).init(variables["params"])
    jckpt.save_model(str(path), variables, opt_state)


def test_checkpoint_reads_without_optax_classes(tmp_path, pair):
    _, variables, _ = pair
    path = tmp_path / "network.pkl"
    _write_jax_checkpoint(path, variables)
    payload = tckpt.load_model(str(path))
    got = payload["net_state_dict"]["params"]["PCNDecoder_0"]["DenseCat_0"]
    np.testing.assert_array_equal(
        got["kernel"], variables["params"]["PCNDecoder_0"]["DenseCat_0"]["kernel"])
    adam_state = payload["opt_state"][0]     # optax ScaleByAdamState
    assert isinstance(adam_state, tckpt.OpaqueObject)
    assert adam_state.qualname.startswith("optax.")


def _cfg(config_cls, ckpt_path):
    return config_cls(model_name="pcn", batch_size=32, num_points=NUM_POINTS,
                      num_coarse=NUM_COARSE, loss="cd", eval_emd=False,
                      lr=1e-4, load_model=str(ckpt_path))


def test_completion_test_pass_and_submission_match_jax(tmp_path, pair):
    _, variables, _ = pair
    ckpt_path = tmp_path / "network.pkl"
    _write_jax_checkpoint(ckpt_path, variables)
    data_dir = str(tmp_path / "nodata")
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    jdir.mkdir()
    tdir.mkdir()
    jzip, jres = jsubmission.run_completion_test(
        _cfg(JConfig, ckpt_path), str(jdir), data_dir)
    tzip, tres = tsubmission.run_completion_test(
        _cfg(Config, ckpt_path), str(tdir), data_dir, CPU)
    assert tres.shape == jres.shape == (52, NUM_POINTS, 3)
    np.testing.assert_allclose(tres, jres, **OUT_TOL)
    for d, z in ((jdir, jzip), (tdir, tzip)):
        with h5py.File(d / "results.h5", "r") as f:
            assert list(f.keys()) == ["results"]
            assert f["results"].shape == (52, NUM_POINTS, 3)
        with zipfile.ZipFile(z) as zf:
            assert zf.namelist() == ["results.h5"]
    assert os.path.basename(tzip) == os.path.basename(jzip) == "submission.zip"


def test_val_pass_matches_jax(tmp_path, pair):
    """The port's val pass (2 batches, the second padded with count 20)
    against the JAX eval step averaged the same way."""
    jm, variables, _ = pair
    ckpt_path = tmp_path / "network.pkl"
    _write_jax_checkpoint(ckpt_path, variables)
    data_dir = str(tmp_path / "nodata")
    got = tengine.run_completion_val(_cfg(Config, ckpt_path), data_dir, CPU)

    step = jengine.make_eval_step(jm, "completion")
    ds = jmvp.MVPCompletionDataset("val", data_dir, NUM_POINTS)
    sums, total, counts = {m: 0.0 for m in got}, 0, []
    for batch in ds.batches(jmvp.BatchSpec(32)):
        count = int(batch["count"])
        counts.append(count)
        res = step(variables["params"], {}, batch, prefix="val")
        for m in sums:
            sums[m] += float(np.asarray(res[m])[:count].mean()) * count
        total += count
    assert counts == [32, 20]
    for m in ("cd_p", "cd_t"):
        np.testing.assert_allclose(got[m], sums[m] / total, rtol=1e-4)
    np.testing.assert_allclose(got["f1"], sums["f1"] / total, rtol=0, atol=F1_ATOL)


def test_cuda_request_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tengine.resolve_device("cuda")
    assert tengine.resolve_device("cpu") == CPU
