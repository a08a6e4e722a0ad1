"""DGCNN's fused edge chain in the torch port (``ref.edge_mlp_eval``) against
the JAX package, on the CPU.

The Pallas eval pass (``pallas_kernels.edge_mlp_eval``, interpret mode) reads
a slot-major (B, k, N, 8) edge tensor with W0 zero-padded to 8 rows; the
port reads (B, N, k, 6). Both round every matmul input to bf16 and
accumulate in fp32. The port folds the BatchNorm into one scale and shift a
channel (``ref.bn_scale_shift``, the TPU's ``_em_bn_fast``), one
reassociation rounding away from the kernel's ``(h - mu) rsqrt(var + eps)
gamma + beta``; an activation that lands on the other side of a bf16 rounding
carries that into the next layer. Bars: normwise 1e-4 per layer and
elementwise rtol 2e-2 / atol 2e-3 (``test_pallas_kernels.py``'s own bar for
the kernel against its golden).
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvp_benchmark_tpu.ops import pallas_kernels
from mvp_benchmark_tpu_torch.ops import dispatch, kernels, ref

CHS, CINS = (64, 64, 128, 256), (6, 64, 64, 128)


def _case(seed, B=2, N=64, K=20):
    rng = np.random.default_rng(seed)
    a1 = rng.random((B, N, K, 6), dtype=np.float64).astype(np.float32)
    Ws = [((rng.random((ci, c)) * 2 - 1) / np.sqrt(ci)).astype(np.float32)
          for ci, c in zip(CINS, CHS)]
    gammas = [(1 + 0.1 * rng.standard_normal(c)).astype(np.float32) for c in CHS]
    betas = [(0.1 * rng.standard_normal(c)).astype(np.float32) for c in CHS]
    means = [(0.1 * rng.standard_normal(c)).astype(np.float32) for c in CHS]
    variances = [(0.5 + rng.random(c)).astype(np.float32) for c in CHS]
    return a1, Ws, gammas, betas, means, variances


def _port(a1, *params):
    t = [[torch.from_numpy(x) for x in p] for p in params]
    xs = ref.edge_mlp_eval(torch.from_numpy(a1).to(torch.bfloat16), *t)
    return [x.numpy() for x in xs]


def _jax_args(a1, Ws, gammas, betas, means, variances):
    a1j = np.pad(np.transpose(a1, (0, 2, 1, 3)), ((0, 0),) * 3 + ((0, 2),))
    Ws = [np.pad(Ws[0], ((0, 2), (0, 0)))] + list(Ws[1:])
    j = lambda xs: tuple(jnp.asarray(x) for x in xs)
    return (jnp.asarray(a1j).astype(jnp.bfloat16), j(Ws), j(gammas), j(betas),
            j(means), j(variances))


def _assert_close(got, want):
    assert got.shape == want.shape
    err = np.linalg.norm((got - want).astype(np.float64)) / np.linalg.norm(want)
    assert err < 1e-4, err
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-3)


@pytest.mark.parametrize("seed", [0, 1])
def test_matches_pallas_eval_pass_in_interpret_mode(seed):
    case = _case(seed)
    want = pallas_kernels.edge_mlp_eval(*_jax_args(*case))
    for got, w in zip(_port(*case), want):
        _assert_close(got, np.asarray(w))


def test_matches_the_jax_reference_chain():
    case = _case(2, N=40, K=7)
    want = pallas_kernels.edge_mlp_reference(*_jax_args(*case), train=False)
    for got, w in zip(_port(*case), want):
        _assert_close(got, np.asarray(w))


def test_scale_and_shift_fold_the_running_statistics():
    _, _, gammas, betas, means, variances = _case(3)
    t = lambda xs: [torch.from_numpy(x) for x in xs]
    for (sc, sh), g, b, m, v in zip(ref.bn_scale_shift(*map(t, (gammas, betas, means,
                                                                 variances))),
                                    gammas, betas, means, variances):
        want = g / np.sqrt(v.astype(np.float64) + 1e-5)
        np.testing.assert_allclose(sc.numpy(), want, rtol=1e-6)
        np.testing.assert_allclose(sh.numpy(), b - m * want, rtol=1e-5, atol=1e-7)


def test_cpu_tensors_take_the_plain_version_and_the_kernel_refuses_them():
    a1, *params = _case(4, N=16, K=5)
    t = [[torch.from_numpy(x) for x in p] for p in params]
    a1t = torch.from_numpy(a1).to(torch.bfloat16)
    before = kernels.EDGE_MLP_LAUNCHES
    got = dispatch.edge_mlp_eval(a1t, *t)
    for g, w in zip(got, ref.edge_mlp_eval(a1t, *t)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert kernels.EDGE_MLP_LAUNCHES == before
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.edge_mlp_forward(a1t, *t)
    ctx = types.SimpleNamespace(kernel="edge_mlp")
    with pytest.raises(NotImplementedError, match="slice 7"):
        kernels.EdgeMlpEvalFunction.backward(ctx, None, None, None, None)
