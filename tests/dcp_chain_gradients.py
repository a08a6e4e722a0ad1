"""Readings behind the DCP train-step parity tests: why their JAX reference
runs op by op.

    JAX_PLATFORMS=cpu python -m tests.dcp_chain_gradients

1. On ``test_torch_dcp_train.py``'s inputs (grid clouds, the dcp_smoke size,
   the transformer in fp32), for each leaf of DGCNN's edge chain
   (``fused_*``): its share of the whole gradient's norm; the cosine of
   JAX's jitted gradient with JAX's op-by-op one; the cosine of each with
   itself after the chain's first BatchNorm scale moves by 1e-6; the port's
   cosine and normwise gap with the op-by-op one.
2. The edge chain alone (3 layers, ``edge_mlp_reference``'s arithmetic in
   fp32, random inputs of ``test_torch_edge_mlp.py``), jitted and op by op:
   the cosine of each gradient with a float64 autograd of the same chain
   in torch, and, in the jitted program, the edges whose relu input is > 0
   and whose relu output has a cotangent, but whose relu input has none.
   ``jnp.where(x > 0, x, 0)`` in place of the relu is the control.
3. Three steps of the port's ``engine.train_registration`` (dcp_smoke.yaml,
   Adam at 1e-3) against the JAX train step fed the same batches, jitted
   and op by op: each step's loss gap, relative.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import torch
from jax import lax

from mvp_benchmark_tpu.models import dcp as jdcp
from mvp_benchmark_tpu_torch.models import dcp as tdcp
from mvp_benchmark_tpu_torch.models.transplant import load_flax_params, to_flax_grads
from mvp_benchmark_tpu_torch.train import engine
from mvp_benchmark_tpu_torch.train.config import load_config
from mvp_benchmark_tpu_torch.train.optim import build_optimizer
from tests.test_torch_dcp import ROOT, _random_stats, _transformer_flags
from tests.test_torch_dcp_train import _jax_train_step, _leaves, _train_inputs
from tests.test_torch_edge_mlp import _train_case


def _cos(a, b):
    a, b = np.ravel(a).astype(np.float64), np.ravel(b).astype(np.float64)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def model_readings():
    batch = src, tgt, T = _train_inputs()
    jm = jdcp.Model()
    v = jax.jit(lambda k, s, g: jm.init(k, s, g, None, prefix="test"))(
        jax.random.PRNGKey(0), src, tgt)
    v = _random_stats(jax.tree.map(np.array, v), np.random.default_rng(1))
    vp = jax.tree.map(np.array, v)
    vp["params"]["DGCNN_0"]["fused_scale0"] *= np.float32(1 + 1e-6)
    with _transformer_flags(False):
        jit, jit_p = (_leaves(_jax_train_step(jm, x, batch, op_by_op=False)[2])
                      for x in (v, vp))
        eager, eager_p = (_leaves(_jax_train_step(jm, x, batch)[2]) for x in (v, vp))
        tm = load_flax_params(tdcp.Model(), v)
        cfg = load_config(os.path.join(ROOT, "registration", "cfgs", "dcp_smoke.yaml"))
        engine.make_registration_train_step(
            tm, build_optimizer(cfg, tm.parameters()), torch.device("cpu"))(
                {"src": src, "tgt": tgt, "transform": T})
    port = _leaves(to_flax_grads(tm)["params"])
    total = np.sqrt(sum(float(np.sum(w * w)) for w in eager.values()))
    print(f"{'leaf':14s} {'share':>8s} {'jit~eager':>10s} {'jit~jit+':>9s} "
          f"{'eager~eager+':>13s} {'port~eager':>11s} {'normwise':>9s}")
    for name, w in eager.items():
        if "fused_" not in name:
            continue
        print(f"{name.split('[')[-1][1:-2]:14s} {np.linalg.norm(w) / total:8.2e} "
              f"{_cos(jit[name], w):10.5f} {_cos(jit_p[name], jit[name]):9.5f} "
              f"{_cos(eager_p[name], w):13.6f} {_cos(port[name], w):11.6f} "
              f"{np.linalg.norm(port[name] - w) / np.linalg.norm(w):9.2e}")


def _chain(Ws, a1, gxs, relu, taps=None):
    a, total = a1, 0.0
    for l, W in enumerate(Ws):
        h = jnp.einsum("bknc,cd->bknd", a.astype(jnp.bfloat16), W.astype(jnp.bfloat16),
                       preferred_element_type=jnp.float32)
        mu = h.mean((0, 1, 2))
        var = jnp.maximum((h * h).mean((0, 1, 2)) - mu * mu, 0.0)
        x = (h - mu) * lax.rsqrt(var + 1e-5)
        if taps is not None:
            x = taps(x, 2 * l)
        a = relu(x)
        if taps is not None:
            a = taps(a, 2 * l + 1)
        total = total + jnp.sum(jnp.max(a, axis=1) * gxs[l])
    return total


def _torch_chain_grads(Ws, a1, gxs):
    """float64 autograd of _chain's arithmetic (the same bf16 roundings)."""
    Wt = [torch.tensor(W, dtype=torch.float64, requires_grad=True) for W in Ws]
    a, total = torch.from_numpy(a1).double(), 0.0
    for W, gx in zip(Wt, gxs):
        h = a.to(torch.bfloat16).double() @ W.to(torch.bfloat16).double()
        mu = h.mean((0, 1, 2))
        var = torch.clamp((h * h).mean((0, 1, 2)) - mu * mu, min=0)
        a = torch.relu((h - mu) * torch.rsqrt(var + 1e-5))
        total = total + (a.max(1).values * torch.from_numpy(gx).double()).sum()
    total.backward()
    return [W.grad.numpy() for W in Wt]


def chain_readings(layers=3, K=20):
    a1, Ws, _, _, _ = _train_case(10 * layers + K, layers, K, B=2, N=128)
    rng = np.random.default_rng(0)
    a1 = np.transpose(a1, (0, 2, 1, 3))                     # (B, k, N, 6)
    gxs = [rng.standard_normal((a1.shape[0], a1.shape[2], W.shape[1])).astype(np.float32)
           for W in Ws]
    want = _torch_chain_grads(Ws, a1, gxs)
    relus = {"jnp.maximum(x, 0)": lambda x: jnp.maximum(x, 0.0),
             "jax.nn.relu(x)": jax.nn.relu,
             "jnp.where(x > 0, x, 0)": lambda x: jnp.where(x > 0, x, 0.0)}
    for label, relu in relus.items():
        for mode in ("jit", "op by op"):
            grad = jax.grad(lambda W: _chain(W, a1, gxs, relu))
            got = jax.jit(grad)(Ws) if mode == "jit" else grad(Ws)
            cos = [round(_cos(g, w), 5) for g, w in zip(got, want)]
            print(f"chain alone, {label:22s} {mode:8s}: cosine with float64 autograd, "
                  f"dW per layer {cos}")

    store = {}

    @jax.custom_vjp
    def tap(x, tag):
        return x

    def tap_bwd(tag, g):
        jax.debug.callback(lambda t, g: store.__setitem__(int(t), np.asarray(g)), tag, g)
        return g, None

    tap.defvjp(lambda x, tag: (x, tag), tap_bwd)
    jax.block_until_ready(jax.jit(jax.grad(lambda W: _chain(
        W, a1, gxs, lambda x: jnp.maximum(x, 0.0),
        lambda x, t: tap(x, jnp.int32(t)))))(Ws))
    x = jnp.asarray(a1)
    for l, W in enumerate(Ws):
        h = np.asarray(jnp.einsum("bknc,cd->bknd", x.astype(jnp.bfloat16),
                                  jnp.asarray(W).astype(jnp.bfloat16),
                                  preferred_element_type=jnp.float32), np.float64)
        mu = h.mean((0, 1, 2))
        pre = (h - mu) / np.sqrt(np.maximum((h * h).mean((0, 1, 2)) - mu * mu, 0) + 1e-5)
        x = jnp.asarray(np.maximum(pre, 0), jnp.float32)
        routed = store[2 * l + 1] != 0
        dropped = int(((pre > 0) & routed & (store[2 * l] == 0)).sum())
        print(f"jitted chain, layer {l}: {dropped} of {int(routed.sum())} edges with a "
              f"cotangent above the relu and input > 0 have none below it")


def loop_readings(steps=3):
    import tempfile

    from mvp_benchmark_tpu.train import engine as jengine
    from mvp_benchmark_tpu.train import optim as joptim
    from mvp_benchmark_tpu.train.config import load_config as jload
    from mvp_benchmark_tpu_torch.data.mvp import BatchSpec, MVPRegistrationDataset
    from mvp_benchmark_tpu_torch.models.transplant import to_flax_params

    cfg_path = os.path.join(ROOT, "registration", "cfgs", "dcp_smoke.yaml")
    with tempfile.TemporaryDirectory() as tmp, _transformer_flags(False):
        cfg = load_config(cfg_path, work_dir=tmp, nepoch=1)
        cpu = torch.device("cpu")
        init = to_flax_params(engine.build_model(cfg, cpu, seed=1, for_training=True))
        got = engine.train_registration(cfg, tmp, os.path.join(tmp, "nodata"),
                                        max_steps_per_epoch=steps,
                                        device=cpu)["history"]["step_losses"][0]
        tx = joptim.build_optimizer(jload(cfg_path))
        step = jengine.make_train_step(jdcp.Model(), tx, "registration")
        for mode in ("jit", "op by op"):
            params = jax.tree.map(np.array, init["params"])
            stats = jax.tree.map(np.array, init["batch_stats"])
            opt_state = tx.init(params)
            ds = MVPRegistrationDataset("train", max_angle=45.0, max_trans=0.5,
                                        data_dir=os.path.join(tmp, "nodata"),
                                        num_points=128, seed=1)
            want = []
            for batch in list(ds.batches(BatchSpec(4, shuffle=True, seed=1), 0))[:steps]:
                args = (params, stats, opt_state,
                        {k: jnp.asarray(batch[k]) for k in ("src", "tgt", "transform")},
                        jnp.asarray(1.0), jax.random.PRNGKey(0))
                if mode == "jit":
                    params, stats, opt_state, aux = step(*args)
                else:
                    with jax.disable_jit():
                        params, stats, opt_state, aux = step(*args)
                want.append(float(aux["total_loss"]))
            gaps = [f"{abs(g - w) / abs(w):.2e}" for g, w in zip(got, want)]
            print(f"train loop at lr 1e-3, port against JAX {mode}: loss gap per step {gaps}")


if __name__ == "__main__":
    model_readings()
    chain_readings()
    loop_readings()
