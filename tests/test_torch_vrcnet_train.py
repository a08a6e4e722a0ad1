"""VRCNet's train step against the JAX package, on the CPU.

One train step of VRCNet (``cfgs/vrcnet_smoke.yaml``'s shape: 128 points,
64 coarse_raw, knn 8, pk 6, FPS, the score top-k and folding, batch 2): the
JAX model is initialised with prefix ``train``, its parameters are
transplanted into the port, and the step's ``total`` and every parameter's
gradient are held against ``jax.value_and_grad`` of the JAX step's loss at
atol 1e-5, rtol 1e-4, with the KLD and with the MMD distribution loss.
VRCNet's noise (z_q, z_p, the two dropout keep-masks, and MMD's four
normals) is drawn by the port's ``draw_noise`` and handed to JAX by
replacing ``jax.random.normal`` and ``jax.random.bernoulli`` while its step
is traced. The selections: as in ``test_torch_vrcnet.py``, the partial
clouds and the coarse head's output lie on a k/32 grid, where the JAX CPU
path's |a|^2+|b|^2-2a.b expansion ranks exactly; the FPS of
``coarse_high``, the score top-k and every chamfer argmin of the losses
are checked for a margin on each seed, and the next seed is tried if one
lacks it. The step's helpers are ``test_torch_train.py``'s, whose PCN step
is held the same way; this file of its own keeps the two long parity runs
in separate workers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvp_benchmark_tpu.models import vrcnet as jvrc
from mvp_benchmark_tpu.train.config import Config as JConfig
from mvp_benchmark_tpu_torch.models import vrcnet as tvrc
from mvp_benchmark_tpu_torch.models.transplant import load_flax_params
from mvp_benchmark_tpu_torch.train.config import Config
from tests.test_torch_train import B, T, _argmins_have_margin, _assert_grads_match, _near
from tests.test_torch_vrcnet import _init_params, _top_k_orders_agree
from tests.util_clouds import fps_sequences_agree, grid_points

VRC = dict(num_points=128, layers="1, 1, 1, 1", points_label=True,
           local_folding=True, num_coarse_raw=64, loss="cd", eval_emd=False,
           distribution_loss="KLD", knn_list="8", pk=6, num_fps=128,
           num_coarse=64)
DEC = "MSAPSKNDecoder_0"


def _jax_step(jm, names):
    """A jitted (loss, grads, captured activations) of the JAX train step
    whose noise is the argument ``noise``: ``jax.random.normal`` and
    ``jax.random.bernoulli`` return its arrays in the order of ``names``
    (the port's ``noise_shapes``, the order the model draws them) while the
    step is traced. (Not in the dict's order: jit hands a dict over with its
    keys sorted, which would swap z_p and z_q.)"""

    def fn(params, x, gt, alpha, noise):
        normals = [noise[k] for k in names if not k.startswith("keep")]
        keeps = [noise[k] for k in names if k.startswith("keep")]
        real = jax.random.normal, jax.random.bernoulli

        def normal(key, shape, dtype=jnp.float32):
            z = normals.pop(0)
            assert tuple(shape) == z.shape, (shape, z.shape)
            return z.astype(dtype)

        def bernoulli(key, p=0.5, shape=None):
            k = keeps.pop(0)
            assert tuple(shape) == k.shape, (shape, k.shape)
            return k

        def loss(p):
            out, state = jm.apply({"params": p}, x, gt, prefix="train", alpha=alpha,
                                  rngs={"sample": jax.random.PRNGKey(0),
                                        "dropout": jax.random.PRNGKey(1)},
                                  capture_intermediates=True)
            inter = state["intermediates"][DEC]
            return out[2], {"coarse_high": inter["TorchDense_4"]["__call__"][0],
                            "scores": inter["TorchDense_7"]["__call__"][0]}

        jax.random.normal, jax.random.bernoulli = normal, bernoulli
        try:
            return jax.value_and_grad(loss, has_aux=True)(params)
        finally:
            jax.random.normal, jax.random.bernoulli = real
            assert not normals and not keeps

    return jax.jit(fn)


@pytest.fixture(scope="module", params=["KLD", "MMD"])
def vrc_jax(request):
    """The JAX model, its train-shaped parameters and jitted step, and the
    config, for each distribution loss (MMD draws four normals more)."""
    cfg = dict(VRC, distribution_loss=request.param)
    jm = jvrc.build(JConfig(cfg))
    x = np.zeros((B, VRC["num_points"], 3), np.float32)
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1),
         "dropout": jax.random.PRNGKey(2)}, x, x, prefix="train"))
    params = _init_params(shapes["params"], np.random.default_rng(3))
    names = list(tvrc.build(Config(cfg)).noise_shapes(B))
    return jm, params, _jax_step(jm, names), cfg


def _port_run(tm, x, gt, noise, monkeypatch):
    """The port's train step forward + backward, with the activations the
    selections see: coarse_high, the scores, and each calc_cd's inputs."""
    caught, cd_inputs = {}, []
    real_cd = tvrc.calc_cd

    def calc_cd(output, ref_cloud):
        cd_inputs.append((output.detach().numpy(), ref_cloud.numpy()))
        return real_cd(output, ref_cloud)

    monkeypatch.setattr(tvrc, "calc_cd", calc_cd)
    hooks = [m.register_forward_hook(lambda m, a, o, n=n: caught.__setitem__(
        n, o.detach().numpy())) for n, m in (("coarse_high", tm.decoder.fc5),
                                             ("scores", tm.decoder.score3))]
    try:
        tm.zero_grad(set_to_none=True)
        _, _, total = tm.train()(T(x), T(gt), prefix="train", alpha=0.5, noise=noise)
        total.backward()
    finally:
        for h in hooks:
            h.remove()
        monkeypatch.setattr(tvrc, "calc_cd", real_cd)
    return total, caught, cd_inputs


def test_vrcnet_train_step_matches_jax_value_and_grad(vrc_jax, monkeypatch):
    jm, params, jstep, cfg = vrc_jax
    n, ncr = VRC["num_points"], VRC["num_coarse_raw"]
    for seed in range(20):
        rng = np.random.default_rng(seed)
        pts = grid_points(rng, ncr + B * n)
        head = params[DEC]["TorchDense_2"]
        p = jax.tree.map(np.copy, params)
        p[DEC]["TorchDense_2"] = {"kernel": np.zeros_like(head["kernel"]),
                                  "bias": pts[:ncr].reshape(-1)}
        x = pts[ncr:].reshape(B, n, 3)
        tm = load_flax_params(tvrc.build(Config(cfg)), {"params": p}, for_training=True)
        noise = tm.draw_noise(B, torch.Generator().manual_seed(seed))
        # gt near the first half's prediction, which depends on x alone
        _, _, cd_inputs = _port_run(tm, x, x, noise, monkeypatch)
        gt = _near(rng, cd_inputs[-1][0][:B])
        total, got, cd_inputs = _port_run(tm, x, gt, noise, monkeypatch)
        (loss, want), grads = jstep(p, x, gt, 0.5,
                                    {k: jnp.asarray(v.numpy()) for k, v in noise.items()})
        ok = (fps_sequences_agree(got["coarse_high"], np.asarray(want["coarse_high"]),
                                  VRC["num_fps"])
              and _top_k_orders_agree(got["scores"], np.asarray(want["scores"]),
                                      VRC["num_coarse"])
              and all(_argmins_have_margin(r, o) for o, r in cd_inputs))
        if ok:
            break
    else:
        raise AssertionError("no seed gave VRCNet inputs whose selections have a margin")
    assert len(cd_inputs) == 4
    np.testing.assert_allclose(float(total.detach()), float(loss), rtol=1e-5)
    _assert_grads_match(tm, grads)
