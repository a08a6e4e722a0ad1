"""DGCNN's fused edge chain in the torch port (``ref.edge_mlp_eval`` and
``ref.edge_mlp_train``) against the JAX package, on the CPU.

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

Train mode (``ref.edge_mlp_train`` under autograd): xs, batch statistics and
every gradient (W, gamma, beta, a1) against ``pallas_kernels.edge_mlp_train``
(interpret mode: its stat passes, final pass and custom backward passes) and
against autodiff of ``edge_mlp_reference(train=True)``, at 1 and 4 layers,
k 1 and k > 1, on random inputs (no ties but relu's zeros). The three round
to bf16 at other places in the backward: the Pallas passes round dh and a
before their products, autodiff rounds the carried cotangent where the
forward cast to bf16, and the batch statistics, summed in other orders, move
an activation to the other side of a bf16 rounding now and then. Bars: xs
normwise 1e-3 (3.1e-4 measured), statistics 1e-4 (1.4e-5), gradients
normwise 1e-2 against the Pallas passes (5.9e-3 measured) and 2e-2 against
autodiff of the reference (1.76e-2 measured, at 4 layers and k 20; the JAX
test holds its kernel to that reference at 1.5e-2 / 2e-2,
``test_pallas_kernels.py:506-553``). JAX's gradients are taken op by op
(``jax.value_and_grad`` outside ``jax.jit``); see
``test_torch_dcp_train._jax_train_step`` for why.
"""

import jax
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
    before = (kernels.EDGE_MLP_LAUNCHES, kernels.EDGE_MLP_STAT_LAUNCHES)
    got = dispatch.edge_mlp_eval(a1t, *t)
    for g, w in zip(got, ref.edge_mlp_eval(a1t, *t)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    xs, stats = dispatch.edge_mlp_train(a1t, *t[:3])
    want_xs, want_stats = ref.edge_mlp_train(a1t, *t[:3])
    for g, w in zip((*xs, *stats), (*want_xs, *want_stats)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert (kernels.EDGE_MLP_LAUNCHES, kernels.EDGE_MLP_STAT_LAUNCHES) == before
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.edge_mlp_forward(a1t, *t)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.edge_mlp_train_forward(a1t, *t[:3])


def _train_case(seed, layers, K, B=2, N=64):
    rng = np.random.default_rng(seed)
    a1 = rng.random((B, N, K, 6), dtype=np.float64).astype(np.float32)
    chs, cins = CHS[:layers], CINS[:layers]
    Ws = [((rng.random((ci, c)) * 2 - 1) / np.sqrt(ci)).astype(np.float32)
          for ci, c in zip(cins, chs)]
    gammas = [(1 + 0.1 * rng.standard_normal(c)).astype(np.float32) for c in chs]
    betas = [(0.1 * rng.standard_normal(c)).astype(np.float32) for c in chs]
    gxs = [rng.standard_normal((B, N, c)).astype(np.float32) for c in chs]
    return a1, Ws, gammas, betas, gxs


def _normwise(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _jax_train(fn, a1, Ws, gammas, betas, gxs):
    """(xs, stats, d_a1 (B, N, k, 6), dWs, dgammas, dbetas) of ``fn`` on the
    slot-major padded layout, the loss sum(xs . gxs)."""
    a1j = jnp.asarray(np.pad(np.transpose(a1, (0, 2, 1, 3)),
                             ((0, 0),) * 3 + ((0, 2),))).astype(jnp.bfloat16)
    Wj = (jnp.asarray(np.pad(Ws[0], ((0, 2), (0, 0)))),) + tuple(map(jnp.asarray, Ws[1:]))

    def loss(a, W, g, b):
        xs, stats = fn(a, W, g, b)
        return sum(jnp.sum(x * y) for x, y in zip(xs, gxs)), (xs, stats)

    (_, (xs, stats)), (da, dW, dg, db) = jax.value_and_grad(
        loss, argnums=(0, 1, 2, 3), has_aux=True)(
            a1j, Wj, tuple(map(jnp.asarray, gammas)), tuple(map(jnp.asarray, betas)))
    da = np.transpose(np.asarray(da.astype(jnp.float32)), (0, 2, 1, 3))[..., :6]
    dW = [np.asarray(dW[0])[:6]] + [np.asarray(w) for w in dW[1:]]
    return xs, stats, da, dW, dg, db


@pytest.mark.parametrize("layers,K", [(1, 1), (1, 7), (4, 1), (4, 20)])
@pytest.mark.parametrize("against", ["pallas_interpret", "reference"])
def test_train_matches_jax(layers, K, against):
    a1, Ws, gammas, betas, gxs = _train_case(10 * layers + K, layers, K)
    fn = (pallas_kernels.edge_mlp_train if against == "pallas_interpret" else
          lambda *a: pallas_kernels.edge_mlp_reference(*a, train=True))
    xs, stats, da, dW, dg, db = _jax_train(fn, a1, Ws, gammas, betas, gxs)

    leaf = lambda x: torch.from_numpy(x).requires_grad_()
    a1t = torch.from_numpy(a1).to(torch.bfloat16).requires_grad_()
    Wt, gt, bt = ([leaf(x) for x in xs_] for xs_ in (Ws, gammas, betas))
    got_xs, got_stats = ref.edge_mlp_train(a1t, Wt, gt, bt)
    assert all(not s.requires_grad for s in got_stats)
    sum((x * torch.from_numpy(g)).sum() for x, g in zip(got_xs, gxs)).backward()
    for g, w in zip(got_xs, xs):
        assert g.shape == w.shape and _normwise(g.detach(), w) < 1e-3
    for g, w in zip(got_stats, stats):
        assert g.shape == w.shape and _normwise(g, w) < 1e-4
    bar = 1e-2 if against == "pallas_interpret" else 2e-2
    pairs = [(a1t.grad.float(), da)] + [(p.grad, w) for p, w in zip(
        [*Wt, *gt, *bt], [*dW, *dg, *db])]
    for i, (g, w) in enumerate(pairs):
        assert tuple(g.shape) == np.shape(w), i
        assert _normwise(g, w) < bar, (i, _normwise(g, w))


def test_train_max_routes_a_tie_to_the_first_slot():
    """Two identical edges of every point: torch.max (and the kernel) routes
    the max-pool's gradient to the first of them only, so the two edges'
    gradients differ by it; the TPU kernel (every tied slot) and JAX's
    autodiff (split evenly) would give them equal gradients. Both still
    receive the statistics' share."""
    a1, Ws, gammas, betas, _ = _train_case(5, 1, 3, B=1, N=4)
    a1[0, :, 2] = a1[0, :, 0]
    a1t = torch.from_numpy(a1).to(torch.bfloat16).requires_grad_()
    (x,), _ = ref.edge_mlp_train(a1t, [torch.from_numpy(Ws[0])],
                                 [torch.from_numpy(gammas[0])], [torch.from_numpy(betas[0])])
    x.sum().backward()
    g = a1t.grad.float()
    assert float((g[0, :, 0] - g[0, :, 2]).abs().max()) > 1e-3


def _plain_backward(a1, Ws, gammas, betas, gxs):
    """``ref.edge_mlp_backward`` from ``ref.edge_mlp_train``'s statistics and
    ``ref.edge_mlp_slots``' argmax slots, the CUDA backward's contract:
    [d_a1, *dWs, *dgammas, *dbetas]."""
    T = lambda xs: [torch.from_numpy(x) for x in xs]
    a1t = torch.from_numpy(a1).to(torch.bfloat16)
    _, stats = ref.edge_mlp_train(a1t, T(Ws), T(gammas), T(betas))
    _, slots = ref.edge_mlp_slots(a1t, T(Ws), T(gammas), T(betas), stats)
    d, dWs, dgs, dbs = ref.edge_mlp_backward(a1t, T(Ws), T(gammas), T(betas), stats, slots,
                                             T(gxs))
    return [d, *dWs, *dgs, *dbs]


def test_slots_are_the_first_argmax_of_the_folded_chain():
    """``ref.edge_mlp_slots``: the chain with the batch statistics folded
    (the train final pass's form) agrees with ``edge_mlp_train``'s max-pools
    at the forward's bar, and each saved slot holds its max-pool's value, the
    first such slot."""
    a1, Ws, gammas, betas, _ = _train_case(3, 4, 7)
    T = lambda xs: [torch.from_numpy(x) for x in xs]
    a1t = torch.from_numpy(a1).to(torch.bfloat16)
    want_xs, stats = ref.edge_mlp_train(a1t, T(Ws), T(gammas), T(betas))
    xs, slots = ref.edge_mlp_slots(a1t, T(Ws), T(gammas), T(betas), stats)
    assert slots.dtype == torch.uint8 and slots.shape == (2, 64, sum(CHS))
    for x, w in zip(xs, want_xs):
        assert _normwise(x, w) < 1e-3
    ss = ref.bn_scale_shift(T(gammas), T(betas), [s[0] for s in stats], [s[1] for s in stats])
    a, off = a1t, 0
    for W, (sc, sh), x in zip(T(Ws), ss, xs):
        a = torch.relu(torch.matmul(ref._bf16(a), ref._bf16(W)) * sc + sh)
        j = slots[..., off:off + W.shape[1]].long()
        assert torch.equal(a.gather(2, j[:, :, None]).squeeze(2), x)
        first = (a == x[:, :, None]).float().argmax(dim=2)
        assert torch.equal(first, j)
        off += W.shape[1]


@pytest.mark.parametrize("layers,K", [(1, 7), (4, 1), (4, 20)])
def test_backward_from_slots_matches_the_pallas_passes(layers, K):
    """``ref.edge_mlp_backward`` rounds where the TPU's backward passes do
    (dh and a to bf16 before their products): against
    ``pallas_kernels.edge_mlp_train``'s custom backward in interpret mode
    within 1e-2 normwise (3.6e-3 measured at 4 layers, k 20), and against
    autodiff of ``ref.edge_mlp_train``, which rounds elsewhere, within
    2e-2 (6.0e-3 measured)."""
    a1, Ws, gammas, betas, gxs = _train_case(10 * layers + K, layers, K)
    *_, da, dW, dg, db = _jax_train(pallas_kernels.edge_mlp_train, a1, Ws, gammas, betas, gxs)
    got = _plain_backward(a1, Ws, gammas, betas, gxs)
    for i, (g, w) in enumerate(zip(got, [da, *dW, *dg, *db])):
        assert tuple(g.shape) == np.shape(w), i
        assert _normwise(g, w) < 1e-2, (i, _normwise(g, w))
    leaf = lambda x: torch.from_numpy(x).requires_grad_()
    a1t = torch.from_numpy(a1).to(torch.bfloat16).requires_grad_()
    Wt, gt, bt = ([leaf(x) for x in xs_] for xs_ in (Ws, gammas, betas))
    xs, _ = ref.edge_mlp_train(a1t, Wt, gt, bt)
    sum((x * torch.from_numpy(g)).sum() for x, g in zip(xs, gxs)).backward()
    auto = [a1t.grad.float()] + [p.grad for p in (*Wt, *gt, *bt)]
    for i, (g, w) in enumerate(zip(got, auto)):
        assert _normwise(g, w) < 2e-2, (i, _normwise(g, w))
