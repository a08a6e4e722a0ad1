"""The VRCNet slice of the torch port against the JAX package, on the CPU.

Two small configs of JAX ``vrcnet.build`` (256 points, 128 coarse_raw,
batch 2, layers 1,1,1,1, points_label and local_folding on):
- ``protocol``: knn 16, pk 10, num_fps = num_coarse = num_points, the shape
  of ``cfgs/vrcnet.yaml``: FPS of the 384 predicted points to 256, then
  neither the score top-k nor folding;
- ``smoke``: knn 8, pk 6, num_coarse 128 < num_fps 192 < num_points, the
  shape of ``cfgs/vrcnet_smoke.yaml``: FPS, the score top-k and Folding.

The JAX parameters (drawn with numpy at torch's init scale) are transplanted
into the torch model; both get the same numpy inputs and the same latent
noise: the torch model takes ``eps``, and the JAX side replaces
``jax.random.normal`` by a function returning it while its apply is traced.
Tolerances are PCN's and ECG's: out1/out2/result atol 1e-5, rtol 1e-4; cd_p,
cd_t rtol 1e-4; f1 atol 2/num_points.

How the inputs avoid near ties (as in ``test_torch_ecg.py``): the JAX CPU
path ranks neighbours with the |a|^2+|b|^2-2a.b expansion, so every point the
3-D kNN, 3-NN and FPS of the encoder see lies on a k/32 grid where the
expansion is exact: the partial clouds, and the coarse head set to emit a
fixed grid cloud (kernel zeroed, bias the coordinates; the head's real
weights, and the latent path before it, are checked on out1 by
``test_coarse_head_matches_jax``). What sees activations is the FPS over
``coarse_high`` and the score top-k. The fixture asserts that the float64
FPS on each side's ``coarse_high`` agrees with a margin, and that both
sides' score orders agree with consecutive gaps wider than twice the
largest difference between the two sides' scores; it tries the next seed if
not.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvp_benchmark_tpu.models import vrcnet as jvrc
from mvp_benchmark_tpu.train.config import Config as JConfig
from mvp_benchmark_tpu_torch.models import get_model, layers
from mvp_benchmark_tpu_torch.models import vrcnet as tvrc
from mvp_benchmark_tpu_torch.models.transplant import load_flax_params
from mvp_benchmark_tpu_torch.train import engine
from mvp_benchmark_tpu_torch.train.config import Config, load_config
from tests.util_clouds import fps_sequences_agree, grid_points

NUM_POINTS, NUM_COARSE_RAW, B, SIZE_Z = 256, 128, 2, 128
OUT_TOL = dict(rtol=1e-4, atol=1e-5)
F1_ATOL = 2.0 / NUM_POINTS
BASE = dict(num_points=NUM_POINTS, layers="1, 1, 1, 1", points_label=True,
            local_folding=True, num_coarse_raw=NUM_COARSE_RAW, loss="cd",
            eval_emd=False, distribution_loss="KLD")
CONFIGS = {
    "protocol": dict(BASE, knn_list="16", pk=10, num_fps=256, num_coarse=256),
    "smoke": dict(BASE, knn_list="8", pk=6, num_fps=192, num_coarse=128),
}
DEC = "MSAPSKNDecoder_0"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _np_tree(tree):
    return jax.tree.map(lambda a: np.array(a), tree)


def _init_params(shapes, rng):
    """numpy parameters at torch's init scale, U(+-1/sqrt(fan_in)), for the
    shape tree of a flax init: a bias takes its kernel's fan-in."""
    out = {}
    for key, leaf in shapes.items():
        if isinstance(leaf, dict):
            out[key] = _init_params(leaf, rng)
            continue
        if len(leaf.shape) == 2:
            fan_in = leaf.shape[0]
        else:
            partner = {"bias": "kernel", "w_mlp2_bias": "w_mlp2"}.get(
                key, key.replace("bias", "kernel"))
            fan_in = shapes[partner].shape[0]
        bound = 1.0 / np.sqrt(fan_in)
        out[key] = rng.uniform(-bound, bound, leaf.shape).astype(np.float32)
    return out


def _jax_apply(jm, prefix, capture=False):
    """A freshly traced, jitted apply whose latent noise is the argument eps:
    ``jax.random.normal`` returns it while the apply is traced."""

    def fn(v, x, gt, eps):
        real = jax.random.normal

        def normal(key, shape, dtype=jnp.float32):
            assert tuple(shape) == eps.shape, (shape, eps.shape)
            return eps.astype(dtype)

        jax.random.normal = normal
        try:
            return jm.apply(v, x, gt, prefix=prefix, capture_intermediates=capture,
                            rngs={"sample": jax.random.PRNGKey(0)})
        finally:
            jax.random.normal = real

    return jax.jit(fn)


def _with_grid_coarse(variables, coarse):
    v = _np_tree(variables)
    head = v["params"][DEC]["TorchDense_2"]
    head["kernel"][:] = 0.0
    head["bias"][:] = coarse.reshape(-1)
    return v


def _port_activations(tm, x, eps):
    caught = {}
    dec = tm.decoder
    mods = {"coarse_high": dec.fc5}
    if dec.top_k:
        mods["scores"] = dec.score3
    hooks = [m.register_forward_hook(
        lambda m, a, o, n=n: caught.__setitem__(n, o.numpy()))
        for n, m in mods.items()]
    try:
        with torch.inference_mode():
            res = tm(torch.from_numpy(x), None, prefix="test",
                     eps=torch.from_numpy(eps))
    finally:
        for h in hooks:
            h.remove()
    return res["result"].numpy(), caught


def _jax_activations(apply_capture, v, x, eps, top_k):
    res, state = apply_capture(v, x, None, eps)
    inter = state["intermediates"][DEC]
    out = {"coarse_high": np.asarray(inter["TorchDense_4"]["__call__"][0])}
    if top_k:
        out["scores"] = np.asarray(inter["TorchDense_7"]["__call__"][0])
    return np.asarray(res["result"]), out


def _top_k_orders_agree(s_port, s_jax, n):
    """The n best scores of every cloud come in the same order on both sides
    (descending), and on each side consecutive scores among the n + 1 best
    are further apart than twice the largest difference between the sides."""
    s_port, s_jax = s_port[..., 0], s_jax[..., 0]
    tol = 2 * float(np.abs(s_port - s_jax).max())
    for b in range(s_port.shape[0]):
        orders = [np.argsort(-s[b], kind="stable") for s in (s_port, s_jax)]
        if not np.array_equal(orders[0][:n + 1], orders[1][:n + 1]):
            return False
        for s in (s_port, s_jax):
            top = s[b][orders[0][:n + 1]]
            if not (top[:-1] - top[1:] > tol).all():
                return False
    return True


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def jax_model(request):
    cfg = CONFIGS[request.param]
    jm = jvrc.build(JConfig(cfg))
    x = np.zeros((B, NUM_POINTS, 3), np.float32)
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)},
        x, None, prefix="test"))
    params = _init_params(shapes["params"], np.random.default_rng(3))
    # one traced test apply per config, shared by the fixtures and tests
    return request.param, jm, {"params": params}, _jax_apply(jm, "test", capture=True)


def _port_model(name, variables=None):
    tm = tvrc.build(Config(CONFIGS[name])).eval()
    if variables is not None:
        load_flax_params(tm, variables)
    return tm


@pytest.fixture(scope="module")
def case(jax_model):
    """(name, JAX model, grid variables, torch model, partial clouds, gt, eps,
    JAX test result): the first seed whose FPS and top-k have their
    margins."""
    name, jm, variables, apply_capture = jax_model
    cfg = CONFIGS[name]
    n_total = NUM_COARSE_RAW + NUM_POINTS
    for seed in range(20):
        rng = np.random.default_rng(seed)
        pts = grid_points(rng, NUM_COARSE_RAW + B * NUM_POINTS)
        coarse = pts[:NUM_COARSE_RAW]
        x = pts[NUM_COARSE_RAW:].reshape(B, NUM_POINTS, 3)
        eps = rng.standard_normal((B, SIZE_Z)).astype(np.float32)
        v = _with_grid_coarse(variables, coarse)
        tm = _port_model(name, v)
        _, got = _port_activations(tm, x, eps)
        pred, want = _jax_activations(apply_capture, v, x, eps, tm.decoder.top_k)
        ok = n_total <= cfg["num_fps"] or fps_sequences_agree(
            got["coarse_high"], want["coarse_high"], cfg["num_fps"])
        if ok and tm.decoder.top_k:
            ok = _top_k_orders_agree(got["scores"], want["scores"], cfg["num_coarse"])
        if ok:
            noise = rng.normal(0.0, 0.012, pred.shape).astype(np.float32)
            gt = (pred[:, rng.permutation(NUM_POINTS)] + noise).astype(np.float32)
            return name, jm, v, tm, x, gt, eps, pred
    raise AssertionError(f"no seed gave {name} inputs whose FPS and top-k "
                         "have a margin")


def test_val_branch_matches_jax(case):
    _, jm, v, tm, x, gt, eps, _ = case
    want = _jax_apply(jm, "val")(v, x, gt, eps)
    with torch.inference_mode():
        got = tm(torch.from_numpy(x), torch.from_numpy(gt), prefix="val",
                 eps=torch.from_numpy(eps))
    for k in ("out1", "out2"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), **OUT_TOL)
    for k in ("cd_p", "cd_t"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-4)
    f1 = got["f1"].numpy()
    assert ((f1 > 0.05) & (f1 < 0.95)).all(), f1
    np.testing.assert_allclose(f1, np.asarray(want["f1"]), rtol=0, atol=F1_ATOL)
    np.testing.assert_array_equal(got["emd"].numpy(), np.zeros(B, np.float32))


def test_test_branch_matches_jax(case):
    _, _, _, tm, x, _, eps, want = case
    with torch.inference_mode():
        got = tm(torch.from_numpy(x), None, prefix="test",
                 eps=torch.from_numpy(eps))["result"].numpy()
    assert got.shape == (B, NUM_POINTS, 3)
    np.testing.assert_allclose(got, want, **OUT_TOL)


def test_coarse_head_matches_jax(jax_model):
    """The unmodified coarse head on arbitrary points: out1 depends on the
    PCN encoder, the posterior net, the latent noise, the generator and the
    decoder's three dense layers only."""
    name, _, variables, apply_capture = jax_model
    tm = _port_model(name, variables)
    rng = np.random.default_rng(11)
    x = rng.random((B, NUM_POINTS, 3), dtype=np.float64).astype(np.float32)
    eps = rng.standard_normal((B, SIZE_Z)).astype(np.float32)
    _, state = apply_capture(variables, x, None, eps)
    want = state["intermediates"][DEC]["TorchDense_2"]["__call__"][0]
    want = np.asarray(want).reshape(B, NUM_COARSE_RAW, 3)
    with torch.inference_mode():
        got = tm(torch.from_numpy(x), torch.from_numpy(x), prefix="val",
                 eps=torch.from_numpy(eps))["out1"]
    np.testing.assert_allclose(got.numpy(), want, **OUT_TOL)
    with torch.inference_mode():
        other = tm(torch.from_numpy(x), torch.from_numpy(x), prefix="val",
                   eps=torch.from_numpy(eps + 1.0))["out1"]
    assert not torch.allclose(other, got)         # eps reaches the output


def test_transplant_fills_every_parameter_and_rejects_a_tree_that_does_not_fit(
        jax_model):
    name, _, variables, _ = jax_model
    tm = _port_model(name, variables)
    sa = variables["params"][DEC]["SASKNResEncoder_0"]["SKNResUnit_3"][
        "SKSAModule_0"]["SAModule_0"]
    branch = tm.decoder.encoder.units[3].blocks[0].branches[0]
    np.testing.assert_array_equal(branch.w_mlp1.detach().numpy(), sa["w_mlp1"])
    np.testing.assert_array_equal(branch.proj.weight2.detach().numpy(),
                                  sa["MultiDense_0"]["kernel2"].T)
    # a checkpoint written by training also holds the prior net, which the
    # eval branches never run
    prior = {f"TorchDense_{i}": {"kernel": np.zeros((1024, 1024), np.float32),
                                 "bias": np.zeros(1024, np.float32)}
             for i in range(3)}
    load_flax_params(tm, {"params": {**variables["params"],
                                     "LinearResBlock_2": prior}})
    params = _np_tree(variables)["params"]
    del params[DEC]["SASKNResEncoder_0"]["SKNResUnit_1"]["SKSAModule_0"][
        "SAModule_0"]["w_mlp2_bias"]
    with pytest.raises(ValueError, match="w_mlp2_bias"):
        load_flax_params(tm, {"params": params})
    params = _np_tree(variables)["params"]
    del params[DEC]["TorchDense_3"]
    with pytest.raises(ValueError, match="missing"):
        load_flax_params(tm, {"params": params})
    params = _np_tree(variables)["params"]
    params[DEC]["TorchDense_99"] = params[DEC]["TorchDense_0"]
    with pytest.raises(ValueError, match="unknown"):
        load_flax_params(tm, {"params": params})
    params = _np_tree(variables)["params"]
    sa = params[DEC]["SASKNResEncoder_0"]["SKNResUnit_0"]["SKSAModule_0"]["SAModule_0"]
    sa["w_mlp1"] = sa["w_mlp1"].T
    with pytest.raises(ValueError, match="does not fit"):
        load_flax_params(tm, {"params": params})


def test_full_width_parameter_count():
    """cfgs/vrcnet.yaml: 15,350,355 parameters in 124 tensors, the JAX
    model's eval tree (one torch parameter per flax leaf)."""
    cfg = load_config(os.path.join(ROOT, "completion", "cfgs", "vrcnet.yaml"))
    model = get_model("vrcnet", cfg, generator=torch.Generator().manual_seed(0))
    params = list(model.parameters())
    assert sum(p.numel() for p in params) == 15_350_355
    assert len(params) == 124
    assert model.decoder.encoder.pts_num == (3072, 1536, 768, 384)
    assert not model.decoder.top_k and not model.decoder.step_ratio


def test_train_branch_eps_and_ef_expansion(case):
    name, _, _, tm, x, gt, eps, _ = case
    with pytest.raises(NotImplementedError, match="training slice"):
        tm(torch.from_numpy(x), torch.from_numpy(gt), prefix="train")
    with pytest.raises(ValueError, match="pass eps"):
        tm(torch.from_numpy(x), None, prefix="test")
    with pytest.raises(NotImplementedError, match="EFExpansion"):
        tvrc.build(Config(CONFIGS[name], num_points=4096))
    with pytest.raises(NotImplementedError, match="EFExpansion"):
        tvrc.build(Config(CONFIGS["smoke"], local_folding=False))


def test_eval_step_draws_the_same_noise_every_batch(case):
    _, _, _, tm, x, _, _, _ = case
    a, b = engine.latent_noise(tm, B), engine.latent_noise(tm, B)
    assert a.shape == (B, SIZE_Z)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(
        a, torch.randn((B, SIZE_Z), generator=torch.Generator().manual_seed(0)),
        rtol=0, atol=0)
    step = engine.make_eval_step(tm, torch.device("cpu"))
    got = step({"inputs": x}, prefix="test")["result"]
    with torch.inference_mode():
        want = tm(torch.from_numpy(x), None, prefix="test", eps=a)["result"]
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert engine.latent_noise(torch.nn.Linear(2, 2), B) is None


def test_multi_dense_matches_jax():
    from mvp_benchmark_tpu.models import layers as jlayers

    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 30, 12)).astype(np.float32)
    jl = jlayers.MultiDense((4, 4, 16))
    params = _np_tree(jl.init(jax.random.PRNGKey(0), x))["params"]
    want = np.asarray(jl.apply({"params": params}, x))
    tl = layers.MultiDense(12, (4, 4, 16))
    with torch.no_grad():
        for i in range(3):
            getattr(tl, f"weight{i}").copy_(torch.from_numpy(params[f"kernel{i}"].T.copy()))
            getattr(tl, f"bias{i}").copy_(torch.from_numpy(params[f"bias{i}"]))
        got = tl(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 30, 24)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_sksa_module_with_two_branches_matches_jax():
    """Two SA branches (k 8 and 16), the selective-kernel softmax over them:
    the JAX default knn_list has two entries, the configs here one."""
    rng = np.random.default_rng(5)
    N, C = 40, 64
    x = rng.standard_normal((2, N, C)).astype(np.float32)
    idxs = [rng.integers(0, N, (2, N, k)).astype(np.int32) for k in (8, 16)]
    jm = jvrc.SKSAModule(4, 16, C, 8, (8, 16))
    params = _np_tree(jax.jit(jm.init)(jax.random.PRNGKey(1), x, idxs))["params"]
    want = np.asarray(jax.jit(jm.apply)({"params": params}, x, idxs))
    tm = tvrc.SKSAModule(4, 16, C, 8, (8, 16))

    def dense(mod, p, name=""):
        mod.weight.copy_(torch.from_numpy(p[f"kernel{name}"].T.copy()))
        mod.bias.copy_(torch.from_numpy(p[f"bias{name}"]))

    with torch.no_grad():
        dense(tm.fc_z, params["TorchDense_0"])
        for i, sa in enumerate(tm.branches):
            p = params[f"SAModule_{i}"]
            for j in range(3):
                getattr(sa.proj, f"weight{j}").copy_(
                    torch.from_numpy(p["MultiDense_0"][f"kernel{j}"].T.copy()))
                getattr(sa.proj, f"bias{j}").copy_(
                    torch.from_numpy(p["MultiDense_0"][f"bias{j}"]))
            for k in ("w_mlp1", "w_mlp2", "w_mlp2_bias"):
                getattr(sa, k).copy_(torch.from_numpy(p[k]))
            dense(sa.out, p["TorchDense_0"])
            dense(tm.fcs[i], params[f"TorchDense_{i + 1}"])
        got = tm(torch.from_numpy(x), [torch.from_numpy(i) for i in idxs]).numpy()
    np.testing.assert_allclose(got, want, **OUT_TOL)
