"""DCP's train branch in the torch port against the JAX package, on the CPU.

The same parameters and running statistics on both sides (the JAX model's,
transplanted; the edge chain's BatchNorm parameters and the running
statistics random, as in test_torch_dcp.py), the same batches:

- one train step (forward with batch statistics, loss.mean() backward,
  Adam): the loss and the four metrics, every gradient leaf, the updated
  ``batch_stats`` (the double update, src then tgt) and the Adam step;
- three steps of ``engine.train_registration`` against the JAX train step
  on the same batches, at the config's lr, and the checkpoints it writes
  loaded by the JAX package;
- ``registration/train_torch.py`` on the CPU without jax, flax, optax, yaml
  or h5py, and refusing ``--device cuda`` without a card.

The JAX side runs op by op: jitted on XLA:CPU, its edge chain's gradient is
not the one its arithmetic defines (``_jax_train_step``).

The clouds are test_torch_dcp.py's grid clouds, stretched along the axes so
that the svd head's covariance has well separated singular values (its
backward divides by their differences).
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mvp_benchmark_tpu.models import dcp as jdcp
from mvp_benchmark_tpu_torch.models import dcp as tdcp
from mvp_benchmark_tpu_torch.models.transplant import load_flax_params, to_flax_params
from tests.test_torch_dcp import N, ROOT, _inputs, _random_stats, _transformer_flags


def _train_inputs():
    """_inputs' grid clouds stretched to (1, 1/2, 1/4) along the axes (still
    exact in bf16 and under the kNN's expansion) so that the svd head's 3x3
    covariance has well separated singular values, and tgt rebuilt from
    them."""
    src, _, T = _inputs()
    src = src * np.array([1.0, 0.5, 0.25], np.float32)
    tgt = (src @ T[0, :3, :3].T + T[0, :3, 3]).astype(np.float32)
    return src, tgt[:, np.random.default_rng(2).permutation(N)], T


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(x, np.float64)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _jax_train_step(jm, v, batch, op_by_op=True):
    """(loss, aux (loss, r_err, t_err, rmse, rt_mse), grads, new batch_stats)
    of the JAX model's train branch, op by op unless ``op_by_op`` is False.

    Op by op because XLA:CPU's compiled gradient of the edge chain
    (``edge_mlp_reference`` under ``jax.jit``) is not the one its arithmetic
    defines: at the chain's last layer it drops the relu's cotangent at a
    tenth of the edges that the max over k routes one to (3329 of 32768 in
    a 3-layer chain; ``jnp.where(x > 0, x, 0)`` in place of the relu keeps
    them). On this test's inputs the jitted chain leaves come out at cosine
    0.69-0.98 with the op-by-op ones, and a 1e-6 change of the chain's first
    BatchNorm scale moves them to cosine 0.59-0.98 with themselves. Op by
    op, the chain alone equals a float64 autograd of the same arithmetic
    (cosine 0.99999), and that change moves the model's chain leaves by
    cosine < 4e-5 (``python -m tests.dcp_chain_gradients`` prints these
    readings)."""
    src, tgt, T = batch

    def loss_fn(p):
        out, new = jm.apply({"params": p, "batch_stats": v["batch_stats"]}, src, tgt,
                            T, prefix="train", mutable=["batch_stats"])
        return jnp.mean(out[0]), (out, new["batch_stats"])

    step = jax.value_and_grad(loss_fn, has_aux=True)
    if op_by_op:
        with jax.disable_jit():
            (loss, (out, stats)), grads = step(v["params"])
    else:
        (loss, (out, stats)), grads = jax.jit(step)(v["params"])
    return float(loss), [np.asarray(o) for o in out], grads, stats


def _port_layout(tree, v):
    """{torch name: array} of a flax ``params`` tree (gradients or
    parameters) of DCP, through the transplant."""
    m = load_flax_params(tdcp.Model(), {"params": tree, "batch_stats": v["batch_stats"]})
    return {n: p.detach().double().numpy() for n, p in m.named_parameters()}


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32_transformer",
                                                     "bf16_transformer"])
def test_train_step_matches_jax(monkeypatch, bf16):
    """One train step (forward with batch statistics, loss.mean() backward,
    Adam at lr 1e-3) of the port and of the JAX package (op by op, see
    _jax_train_step) from the same parameters and running statistics, on the
    same batch.

    Every gradient leaf by cosine and normwise: >= 0.9999 and <= 1e-2 with
    the transformer in fp32 (0.999976 and 7.0e-3 measured, both on the edge
    chain's fused_bias0; the chain's leaves hold 0.4-55% of the whole
    gradient's norm), >= 0.998 and <= 6e-2 in bf16 (0.99917 and 4.1e-2);
    the key projections' biases (``tdcp.SHIFT_INVARIANT``, exactly 0) to
    1e-5 of the whole gradient's norm. The loss to 1e-4 relative (1.5e-6
    measured; bf16 2e-4, 3.0e-5), the updated batch_stats (the double
    update) to atol 1e-5 (4.2e-6), and the Adam step: to optax's on the
    port's own gradient (an ulp of the parameter and 1e-5 of the step: the
    two round the bias corrections elsewhere), and to JAX's whole step.
    Adam's first step is lr sign(g), so an element whose gradient is near 0
    may step the other way on the two sides: the share of elements more
    than lr/2 from JAX's, outside the shift-invariant biases, is held to
    1e-3 (4.1e-4 measured) and 1e-2 in bf16 (5.7e-3)."""
    from mvp_benchmark_tpu.train import optim as joptim
    from mvp_benchmark_tpu.train.config import load_config as jload
    from mvp_benchmark_tpu_torch.models import layers as tlayers
    from mvp_benchmark_tpu_torch.models.transplant import to_flax_grads
    from mvp_benchmark_tpu_torch.train import engine
    from mvp_benchmark_tpu_torch.train.config import load_config
    from mvp_benchmark_tpu_torch.train.optim import build_optimizer

    src, tgt, T = batch = _train_inputs()
    jm = jdcp.Model()
    v = jax.jit(lambda k, s, g: jm.init(k, s, g, None, prefix="test"))(
        jax.random.PRNGKey(0), src, tgt)
    v = _random_stats(jax.tree.map(np.array, v), np.random.default_rng(1))
    cfg_path = os.path.join(ROOT, "registration", "cfgs", "dcp_smoke.yaml")
    Hs = []
    svd = tlayers.symmetric_svd_rotation
    monkeypatch.setattr(tlayers, "symmetric_svd_rotation",
                        lambda H: (Hs.append(H.detach().clone()), svd(H))[1])
    with _transformer_flags(bf16):
        loss, out, grads, stats = _jax_train_step(jm, v, batch)
        tm = load_flax_params(tdcp.Model(), v)
        opt = build_optimizer(load_config(cfg_path), tm.parameters())
        dev = engine.make_registration_train_step(tm, opt, torch.device("cpu"))(
            {"src": src, "tgt": tgt, "transform": T})
    # the SVD's backward divides by differences of singular values: well apart
    s = torch.linalg.svdvals(Hs[0])
    assert float(((s[:, :2] - s[:, 1:]) / s[:, :1]).min()) > 0.1, s

    got = [float(dev[k]) for k in ("total_loss", "r_err", "t_err", "rmse", "mse")]
    rtol = 2e-4 if bf16 else 1e-4
    assert abs(got[0] - loss) <= rtol * abs(loss)
    for g, w in zip(got[1:], out[1:]):
        assert abs(g - float(np.mean(w))) <= (2e-2 if bf16 else 1e-3) + rtol * abs(np.mean(w))

    assert sorted(_leaves(to_flax_grads(tm)["params"])) == sorted(_leaves(grads))
    gj = _port_layout(grads, v)
    total = np.sqrt(sum(float(np.sum(w * w)) for w in gj.values()))
    cos_bar, norm_bar = (0.998, 6e-2) if bf16 else (0.9999, 1e-2)
    shift = [n for n in gj if n.endswith(tdcp.SHIFT_INVARIANT)]
    assert len(shift) == 3
    for name, p in tm.named_parameters():
        g, w = p.grad.double().numpy().ravel(), gj[name].ravel()
        gap = np.linalg.norm(g - w)
        if name in shift:
            assert gap <= 1e-5 * total, name
            continue
        cos = g @ w / (np.linalg.norm(g) * np.linalg.norm(w))
        assert cos >= cos_bar and gap <= norm_bar * np.linalg.norm(w), (name, cos, gap)

    st = _leaves(to_flax_params(tm)["batch_stats"])
    for name, w in _leaves(stats).items():
        np.testing.assert_allclose(st[name], w, rtol=1e-5, atol=1e-5, err_msg=name)

    tx = joptim.build_optimizer(jload(cfg_path))
    stepped = {n: p.detach().double().numpy() for n, p in tm.named_parameters()}

    def adam(g):
        updates, _ = tx.update(g, tx.init(v["params"]), v["params"])
        return _port_layout(optax.apply_updates(v["params"], updates), v)

    for name, w in adam(to_flax_grads(tm)["params"]).items():
        np.testing.assert_allclose(stepped[name], w, rtol=2.4e-7, atol=1e-8, err_msg=name)
    far = n = 0
    for name, w in adam(grads).items():
        if name not in shift:
            far += int((np.abs(stepped[name] - w) > 0.5e-3).sum())
            n += w.size
    assert far <= (1e-2 if bf16 else 1e-3) * n, (far, n)


def _smoke_cfg(tmp_path, **overrides):
    from mvp_benchmark_tpu_torch.train.config import load_config
    return load_config(os.path.join(ROOT, "registration", "cfgs", "dcp_smoke.yaml"),
                       work_dir=str(tmp_path), **overrides)


def test_train_registration_follows_jax_and_its_checkpoints_load(tmp_path):
    """Three steps of ``engine.train_registration`` (dcp_smoke.yaml: batch 4
    x 128 points, Adam at 1e-3) against the JAX package's train step, op by
    op (see _jax_train_step), fed the same batches from the same initial
    parameters: the first step's loss within rtol 1e-3 (6.1e-4 measured)
    and the curve within 2e-2 (6.4e-3 measured at step 3): the train
    split's synthetic clouds are not on a grid, and JAX's CPU kNN ranks
    near-tied neighbours by the |a|^2+|b|^2-2a.b expansion, the port by
    exact differences. (The jitted JAX step is 12% away by step 3: its edge
    chain's gradient is not JAX's, see _jax_train_step.) Then the
    checkpoints: ``network.pkl`` and the five ``best_*`` load in the JAX
    package (``load_model``, flax layout, both collections) and give the
    port's test poses (atol 1e-4, the transformer in fp32 on both sides),
    and load back into the port bitwise."""
    from mvp_benchmark_tpu.train import checkpoint as jckpt
    from mvp_benchmark_tpu.train import engine as jengine
    from mvp_benchmark_tpu.train import optim as joptim
    from mvp_benchmark_tpu.train.config import load_config as jload
    from mvp_benchmark_tpu_torch.data.mvp import BatchSpec, MVPRegistrationDataset
    from mvp_benchmark_tpu_torch.train import engine

    cfg = _smoke_cfg(tmp_path, nepoch=1)
    data = str(tmp_path / "nodata")
    cpu = torch.device("cpu")
    init = to_flax_params(engine.build_model(cfg, cpu, seed=1, for_training=True))
    with _transformer_flags(False):
        res = engine.train_registration(cfg, str(tmp_path), data, max_steps_per_epoch=3,
                                        device=cpu)
        got = res["history"]["step_losses"][0]

        jm = jdcp.Model()
        tx = joptim.build_optimizer(jload(os.path.join(ROOT, "registration", "cfgs",
                                                       "dcp_smoke.yaml")))
        step = jengine.make_train_step(jm, tx, "registration")
        params, stats = init["params"], init["batch_stats"]
        opt_state = tx.init(params)
        ds = MVPRegistrationDataset("train", max_angle=45.0, max_trans=0.5,
                                    data_dir=data, num_points=128, seed=1)
        want = []
        for batch in list(ds.batches(BatchSpec(4, shuffle=True, seed=1), 0))[:3]:
            with jax.disable_jit():
                params, stats, opt_state, aux = step(
                    params, stats, opt_state,
                    {k: jnp.asarray(batch[k]) for k in ("src", "tgt", "transform")},
                    jnp.asarray(1.0), jax.random.PRNGKey(0))
            want.append(float(aux["total_loss"]))
        np.testing.assert_allclose(got[0], want[0], rtol=1e-3)
        np.testing.assert_allclose(got, want, rtol=2e-2)

        names = sorted(os.listdir(tmp_path))
        assert {"network.pkl", *(f"best_{m}_network.pkl" for m in
                                 ("RotE", "transE", "MSE", "RMSE", "recall"))} <= set(names)
        src, tgt, _ = _train_inputs()
        with torch.inference_mode():
            want_T = res["model"].eval()(torch.from_numpy(src), torch.from_numpy(tgt),
                                         None, prefix="test").numpy()
        tree = jckpt.load_model(str(tmp_path / "network.pkl"))["net_state_dict"]
        assert sorted(tree) == ["batch_stats", "params"]
        got_T = np.asarray(jm.apply(tree, src, tgt, None, prefix="test"))
        np.testing.assert_allclose(got_T, want_T, rtol=0, atol=1e-4)
    back = load_flax_params(tdcp.Model(), tree)
    for (n, p), (_, q) in zip(res["model"].state_dict().items(), back.state_dict().items()):
        torch.testing.assert_close(p, q, rtol=0, atol=0, msg=n)


def test_train_cli_runs_on_cpu_without_jax_and_never_falls_back(tmp_path):
    """``registration/train_torch.py -c cfgs/dcp_smoke.yaml --device cpu``
    (one epoch, at batch 16: 4 steps) with jax, flax, optax, yaml and h5py
    blocked:
    the step and val lines in train.log and the checkpoints on disk;
    ``--device cuda`` without a card raises instead of moving to the CPU."""
    cfg = os.path.join(ROOT, "registration", "cfgs", "dcp_smoke.yaml")
    text = open(cfg).read().replace("work_dir: log/", f"work_dir: {tmp_path}/")
    text = text.replace("nepoch: 2", "nepoch: 1").replace("batch_size: 4", "batch_size: 16")
    (tmp_path / "cfg.yaml").write_text(text)
    code = ("import sys, torch\n"
            "for m in ('jax', 'flax', 'optax', 'yaml', 'h5py'): sys.modules[m] = None\n"
            f"sys.path.insert(0, {os.path.join(ROOT, 'registration')!r})\n"
            "import train_torch\n"
            f"args = ['-c', {str(tmp_path / 'cfg.yaml')!r}, "
            f"'--data-dir', {str(tmp_path / 'nodata')!r}]\n"
            "print('log_dir', train_torch.main(args + ['--device', 'cpu']))\n"
            "if not torch.cuda.is_available():\n"
            "    try:\n"
            "        train_torch.main(args + ['--device', 'cuda'])\n"
            "    except RuntimeError as e:\n"
            "        print('refused:', e)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    log_dir = [ln for ln in out.stdout.splitlines() if ln.startswith("log_dir")][0].split()[1]
    log = open(os.path.join(log_dir, "train.log")).read()
    assert "train [0: 3] total_loss: " in log and "best_recall: " in log
    assert {"network.pkl", "best_RMSE_network.pkl"} <= set(os.listdir(log_dir))
    if not torch.cuda.is_available():
        assert "refused: device 'cuda' requested, but CUDA is not available" in out.stdout
