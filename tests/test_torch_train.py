"""The training slice of the torch port against the JAX package, on the CPU.

- One train step of PCN (``cfgs/pcn_smoke.yaml``'s shape at 128 points,
  batch 2): the JAX model is initialised with prefix ``train``, its
  parameters are transplanted into the port, and the step's ``total`` and
  every parameter's gradient are held against ``jax.value_and_grad`` of the
  JAX step's loss at atol 1e-5, rtol 1e-4. VRCNet's step is held the same
  way in ``test_torch_vrcnet_train.py``, with the helpers below.
- The selections: the chamfer argmins of the losses are checked for a
  margin on each seed, and the next seed is tried if one lacks it.
- Three Adam steps of PCN from the same parameters agree in loss; the three
  optimizers fed the same gradients give the same parameters; ``epoch_lr``
  and ``alpha_for_epoch`` equal the JAX functions over epochs 0-100; the
  inverse transplant round-trips and the JAX model applied to it gives the
  port's output; ``completion/train_torch.py`` trains one epoch on the CPU
  without jax and writes its checkpoints.
- A protocol train step of PCN, VRCNet and ECG launches the kernels
  ``chip_smoke.py`` derives for it, counted on the CPU through stand-ins
  for the launchers.
"""

import copy
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mvp_benchmark_tpu.models import pcn as jpcn
from mvp_benchmark_tpu.train import engine as jengine
from mvp_benchmark_tpu.train import optim as joptim
from mvp_benchmark_tpu.train.config import Config as JConfig
from mvp_benchmark_tpu_torch.models import pcn as tpcn
from mvp_benchmark_tpu_torch.models.transplant import load_flax_params, to_flax_params
from mvp_benchmark_tpu_torch.train import checkpoint as tckpt
from mvp_benchmark_tpu_torch.train import engine as tengine
from mvp_benchmark_tpu_torch.train import optim as toptim
from mvp_benchmark_tpu_torch.train.config import Config, load_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFGS = os.path.join(ROOT, "completion", "cfgs")
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
B = 2
T = torch.from_numpy


def _argmins_have_margin(ref_cloud, out):
    """Every chamfer row of (ref_cloud, out), both ways, has its nearest
    squared distance (float64) further from its second than 16 ulp of
    |p|^2 + |q|^2 for the row's point and either candidate: the rounding of
    ``jnp_ref.square_distance``'s |a|^2+|b|^2-2a.b, through which the JAX
    CPU path picks its argmins, is below that (and the two sides' outputs
    differ far less)."""
    for p, q in ((ref_cloud, out), (out, ref_cloud)):
        for k in range(p.shape[0]):
            a, b = p[k].astype(np.float64), q[k].astype(np.float64)
            d = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
            order = np.argsort(d, axis=1)[:, :2]
            first, second = np.take_along_axis(d, order, 1).T
            nb = (b ** 2).sum(-1)[order].max(1)
            if not (second - first > 16 * 2.0 ** -23 * ((a ** 2).sum(-1) + nb)).all():
                return False
    return True


def _near(rng, cloud):
    """A gt near ``cloud`` (B, N, 3): its points shuffled and moved by
    about the cloud's spread (nearer, the argmin gaps shrink with the
    distances; further, the expansion's rounding grows with |gt|^2)."""
    spread = cloud.std(axis=1, keepdims=True)
    return (cloud[:, rng.permutation(cloud.shape[1])]
            + spread * rng.standard_normal(cloud.shape)).astype(np.float32)


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _port_grads(model):
    """The port's gradients in the flax layout (None -> 0, as JAX's zeros
    for parameters that reach the loss only through a selection)."""
    g = copy.deepcopy(model)
    with torch.no_grad():
        for p, q in zip(g.parameters(), model.parameters()):
            p.copy_(torch.zeros_like(q) if q.grad is None else q.grad)
    return to_flax_params(g)["params"]


def _assert_grads_match(port_model, jax_grads):
    got = _port_grads(port_model)
    jax_grads = jax.tree.map(np.asarray, jax_grads)
    assert sorted(p for p, _ in _leaves(got)) == sorted(p for p, _ in _leaves(jax_grads))
    for path, want in _leaves(jax_grads):
        np.testing.assert_allclose(_at(got, path), want, err_msg="/".join(path),
                                   **GRAD_TOL)


# ---------------------------------------------------------------------------
# PCN
# ---------------------------------------------------------------------------

PCN_POINTS, PCN_COARSE = 128, 64


@pytest.fixture(scope="module")
def pcn_pair():
    jm = jpcn.Model(num_points=PCN_POINTS, num_coarse=PCN_COARSE)
    x = np.zeros((B, PCN_POINTS, 3), np.float32)
    variables = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(3), x, x,
                                                 prefix="train"))
    return jm, variables


def _pcn_port(variables):
    return load_flax_params(tpcn.Model(PCN_POINTS, PCN_COARSE), variables,
                            for_training=True)


def _pcn_outputs(tm, x):
    with torch.no_grad():
        return [o.numpy() for o in tm.decoder(tm.encoder(T(x)))]


def _pcn_margins_ok(tm, x, gt):
    return all(_argmins_have_margin(gt, o) for o in _pcn_outputs(tm, x))


def _margins_hold_over_steps(tm, x, gt, cfg, steps):
    """The margins at each of ``steps`` train steps of a copy of the port."""
    tm = copy.deepcopy(tm)
    step = tengine.make_train_step(tm.train(), toptim.build_optimizer(
        Config(cfg), tm.parameters()), torch.device("cpu"))
    for _ in range(steps):
        if not _pcn_margins_ok(tm, x, gt):
            return False
        step({"inputs": x, "gt": gt}, 0.5)
    return True


def _pcn_inputs(tm, cfg=None, steps=1):
    """The first seed's clouds whose chamfer argmins have a margin at each of
    ``steps`` train steps of the port (one: at the given parameters)."""
    for seed in range(20):
        rng = np.random.default_rng(seed)
        x = rng.random((B, PCN_POINTS, 3), dtype=np.float64).astype(np.float32)
        gt = _near(rng, _pcn_outputs(tm, x)[1])
        if _pcn_margins_ok(tm, x, gt) and (
                steps == 1 or _margins_hold_over_steps(tm, x, gt, cfg, steps)):
            return x, gt
    raise AssertionError("no seed gave PCN clouds whose chamfer argmins have a margin")


def test_pcn_train_step_matches_jax_value_and_grad(pcn_pair):
    jm, variables = pcn_pair
    tm = _pcn_port(variables)
    x, gt = _pcn_inputs(tm)
    loss, grads = jax.value_and_grad(lambda p: jm.apply(
        {"params": p}, x, gt, prefix="train", alpha=0.5)[2])(variables["params"])
    _, loss2, total = tm.train()(T(x), T(gt), prefix="train", alpha=0.5)
    total.backward()
    np.testing.assert_allclose(float(total.detach()), float(loss), rtol=1e-5)
    _assert_grads_match(tm, grads)


def test_pcn_three_adam_steps_agree_in_loss(pcn_pair):
    """The port's train step and optimizer against the JAX package's
    (``engine.make_train_step``, ``optim.build_optimizer``) from the same
    parameters on the same batches, at the protocol's lr 1e-4: the loss of
    each of three steps within rtol 1e-4, and every chamfer argmin with a
    margin at each step. (Adam's first updates are lr * sign(g), so a
    gradient entry near 0 whose sign the two sides round differently moves
    its parameter by 2 lr: the steps after the first agree less tightly
    than the first.)"""
    jm, variables = pcn_pair
    cfg = dict(lr=1e-4, optimizer="Adam", betas="0.9, 0.999", weight_decay=0)
    tm = _pcn_port(variables)
    x, gt = _pcn_inputs(tm, cfg, steps=3)
    tx = joptim.build_optimizer(JConfig(cfg))
    jstep = jengine.make_train_step(jm, tx, "completion")
    params, opt_state = variables["params"], tx.init(variables["params"])
    optimizer = toptim.build_optimizer(Config(cfg), tm.parameters())
    tstep = tengine.make_train_step(tm.train(), optimizer, torch.device("cpu"))
    batch = {"inputs": x, "gt": gt}
    for step in range(3):
        assert _pcn_margins_ok(tm, x, gt), step
        params, _, opt_state, aux = jstep(params, {}, opt_state, batch,
                                          jnp.asarray(0.5), jax.random.PRNGKey(0))
        got = tstep(batch, 0.5)
        np.testing.assert_allclose(float(got["total_loss"]), float(aux["total_loss"]),
                                   rtol=1e-4)
        np.testing.assert_allclose(float(got["fine_loss"]), float(aux["fine_loss"]),
                                   rtol=1e-4)


@pytest.mark.parametrize("cfg", [
    dict(optimizer="Adam", betas="0.9, 0.999", weight_decay=0),
    dict(optimizer="Adam", betas="0.8, 0.99", weight_decay=0.01),
    dict(optimizer="Adagrad", initial_accum_val=0.1),
], ids=["adam", "adamw", "adagrad"])
def test_optimizers_give_the_same_updates_as_optax(cfg):
    """The same gradients into the port's and the JAX package's optimizer:
    the parameters after each of three updates within rtol 1e-5 (Adagrad:
    optax adds its eps 1e-7 under the root, torch 1e-10 after it), with the
    learning rate changed between updates by ``set_learning_rate``."""
    rng = np.random.default_rng(8)
    params = {"w": rng.standard_normal((5, 4)).astype(np.float32),
              "b": rng.standard_normal(4).astype(np.float32)}
    tx = joptim.build_optimizer(JConfig(cfg, lr=1e-3))
    state = tx.init(params)
    tparams = [torch.nn.Parameter(T(params[k].copy())) for k in ("w", "b")]
    opt = toptim.build_optimizer(Config(cfg, lr=1e-3), tparams)
    jp = params
    for step, lr in enumerate((1e-3, 1e-3, 5e-4)):
        state = joptim.set_learning_rate(state, lr)
        toptim.set_learning_rate(opt, lr)
        grads = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in params.items()}
        updates, state = tx.update(grads, state, jp)
        jp = optax.apply_updates(jp, updates)
        for p, k in zip(tparams, ("w", "b")):
            p.grad = T(grads[k])
        opt.step()
        for p, k in zip(tparams, ("w", "b")):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]),
                                       rtol=1e-5, atol=1e-7, err_msg=f"{k} {step}")


@pytest.mark.parametrize("name", ["pcn.yaml", "vrcnet.yaml", "steps"])
def test_schedules_equal_jax(name):
    if name == "steps":
        raw = dict(lr=1e-3, lr_decay=True, lr_step_decay_epochs="10, 30",
                   lr_step_decay_rates="0.5, 0.1", lr_clip=1e-5,
                   varying_constant="1", varying_constant_epochs="")
    else:
        raw = dict(load_config(os.path.join(CFGS, name)))
    for epoch in range(101):
        assert toptim.epoch_lr(Config(raw), epoch) == joptim.epoch_lr(JConfig(raw), epoch)
        assert (toptim.alpha_for_epoch(Config(raw), epoch)
                == joptim.alpha_for_epoch(JConfig(raw), epoch))


def test_inverse_transplant_round_trips_and_jax_applies_it(pcn_pair):
    jm, _ = pcn_pair
    tm = tpcn.Model(PCN_POINTS, PCN_COARSE, generator=torch.Generator().manual_seed(4))
    tree = to_flax_params(tm)
    back = load_flax_params(tpcn.Model(PCN_POINTS, PCN_COARSE), tree, for_training=True)
    for p, q in zip(tm.parameters(), back.parameters()):
        torch.testing.assert_close(p, q, rtol=0, atol=0)
    x = np.random.default_rng(9).random((B, PCN_POINTS, 3)).astype(np.float32)
    want = np.asarray(jm.apply(tree, x, None, prefix="test")["result"])
    with torch.inference_mode():
        got = tm(T(x), None, prefix="test")["result"].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_checkpoint_loads_in_both_packages(tmp_path, pcn_pair):
    jm, _ = pcn_pair
    tm = tpcn.Model(PCN_POINTS, PCN_COARSE, generator=torch.Generator().manual_seed(5))
    opt = toptim.build_optimizer(Config(lr=1e-3), tm.parameters())
    tm(T(np.ones((B, PCN_POINTS, 3), np.float32)), T(np.zeros((B, PCN_POINTS, 3), np.float32)),
       prefix="train")[2].backward()
    opt.step()
    path = str(tmp_path / "network.pkl")
    tckpt.save_model(path, tm, opt)
    with open(path, "rb") as f:
        payload = pickle.load(f)                     # as the JAX package reads it
    state = payload["torch_optimizer_state"]
    assert all(isinstance(v, np.ndarray) for s in state["state"].values() for v in s.values())
    x = np.random.default_rng(10).random((B, PCN_POINTS, 3)).astype(np.float32)
    want = np.asarray(jm.apply(payload["net_state_dict"], x, None, prefix="test")["result"])
    back = load_flax_params(tpcn.Model(PCN_POINTS, PCN_COARSE),
                            tckpt.load_model(path)["net_state_dict"])
    with torch.inference_mode():
        np.testing.assert_allclose(back(T(x), None, prefix="test")["result"].numpy(),
                                   want, rtol=1e-4, atol=1e-5)


def test_nan_guard_aborts_after_five_non_finite_losses():
    guard = tengine.NanGuard()
    for _ in range(4):
        guard.check(float("nan"), "here")
    guard.check(1.0, "here")
    for _ in range(4):
        guard.check(float("inf"), "here")
    with pytest.raises(FloatingPointError, match="5 consecutive"):
        guard.check(float("nan"), "here")


def test_train_cli_runs_one_epoch_without_jax(tmp_path):
    """``completion/train_torch.py -c <pcn_smoke, one epoch> --device cpu``
    with jax, flax and optax blocked: the loss is finite and network.pkl
    and the best checkpoints are written."""
    cfg = load_config(os.path.join(CFGS, "pcn_smoke.yaml"))
    text = open(os.path.join(CFGS, "pcn_smoke.yaml")).read()
    text = text.replace(f"nepoch: {cfg.nepoch}", "nepoch: 1")
    text = text.replace(f"batch_size: {cfg.batch_size}", "batch_size: 26")   # 10 steps
    text = text.replace("work_dir: log/", f"work_dir: {tmp_path}/")
    (tmp_path / "cfg.yaml").write_text(text)
    code = ("import sys\n"
            "for m in ('jax', 'flax', 'optax'): sys.modules[m] = None\n"
            f"sys.path.insert(0, {os.path.join(ROOT, 'completion')!r})\n"
            "import train_torch\n"
            f"print(train_torch.main(['-c', {str(tmp_path / 'cfg.yaml')!r}, "
            f"'--device', 'cpu', '--data-dir', {str(tmp_path / 'nodata')!r}]))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    log_dir = out.stdout.strip().splitlines()[-1]
    # best_f1 only where f1 rose above 0, as in the JAX package
    assert {"network.pkl", "best_cd_p_network.pkl", "best_cd_t_network.pkl",
            "train.log"} <= set(os.listdir(log_dir))
    assert "total_loss" in open(os.path.join(log_dir, "train.log")).read()


# ---------------------------------------------------------------------------
# The launch counts chip_smoke.py derives for a protocol train step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["pcn", "vrcnet", "ecg"])
def test_protocol_train_step_launches_what_chip_smoke_derives(monkeypatch, name):
    """One train step at ``cfgs/{pcn,vrcnet,ecg}.yaml`` (full width, two
    clouds), with every tensor routed as a CUDA tensor would be and each
    kernel launcher replaced by a counting stand-in around its plain
    version: the launches equal ``chip_smoke.PCN_PER_STEP`` /
    ``VRCNET_PER_STEP`` / ``ECG_PER_STEP``, and every parameter's gradient
    is finite."""
    import chip_smoke
    from mvp_benchmark_tpu_torch.data.mvp import BatchSpec, MVPCompletionDataset
    from mvp_benchmark_tpu_torch.ops import dispatch, kernels, ref

    counts = {}

    def counted(key, fn, n=lambda *a, **kw: 1):
        def launch(*a, **kw):
            counts[key] = counts.get(key, 0) + n(*a, **kw)
            return fn(*a, **kw)
        return launch

    def sa_backward(g, *a, need=(True,) * 5):
        return tuple(o if w else None
                     for o, w in zip(ref.sa_attention_backward(g, *a), need))

    stand_ins = {   # launcher -> (launch-count key, plain version)
        "chamfer_forward": ("chamfer", ref.chamfer_distance),
        # the kernel's outputs carry no graph
        "knn": ("knn", lambda q, p, k: ref.knn(q.detach(), p.detach(), k)),
        "furthest_point_sample": ("fps", ref.furthest_point_sample),
        "gather_rows": ("gather", ref.gather_points),
        "group_max_forward": ("group_max", ref.group_max),
        "three_interpolate_forward": ("three_interpolate", ref.three_interpolate),
        "sa_attention_forward": ("sa_attention", ref.sa_attention),
        "scatter_add_rows": ("scatter_add_rows", ref.scatter_add_rows),
        "group_max_backward": ("group_max_backward", ref.group_max_backward),
        "three_interpolate_backward": ("three_interpolate_backward",
                                       ref.three_interpolate_backward),
        "sa_attention_backward": ("sa_attention_backward", sa_backward),
        "ball_query": ("ball_query", ref.ball_query),
        "emd_assignment": ("emd", ref.emd_assignment),
    }
    for launcher, (key, fn) in stand_ins.items():
        monkeypatch.setattr(kernels, launcher, counted(key, fn))
    monkeypatch.setattr(kernels, "chamfer_backward", counted(
        "chamfer_backward", ref.chamfer_backward,
        lambda *a: int(a[6]) + int(a[7])))          # one launch per side
    monkeypatch.setattr(dispatch, "_route", lambda *xs: "cuda")

    path = {"pcn": chip_smoke.PCN_CFG, "vrcnet": chip_smoke.VRCNET_CFG,
            "ecg": chip_smoke.ECG_CFG}[name]
    cfg = load_config(path, batch_size=2)
    model = tengine.build_model(cfg, torch.device("cpu"), seed=1, for_training=True)
    step = tengine.make_train_step(model.train(), toptim.build_optimizer(
        cfg, model.parameters()), torch.device("cpu"))
    batch = next(MVPCompletionDataset("train", os.path.join(ROOT, "nodata"), 2048)
                 .batches(BatchSpec(2, shuffle=True, seed=1)))
    step(batch, 0.5, tengine.draw_noise(model, 2, torch.Generator().manual_seed(1)))
    want = {"pcn": chip_smoke.PCN_PER_STEP, "vrcnet": chip_smoke.VRCNET_PER_STEP,
            "ecg": chip_smoke.ECG_PER_STEP}[name]
    assert counts == want
    for n, p in model.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), n
