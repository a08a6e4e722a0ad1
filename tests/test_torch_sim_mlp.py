"""IDAM's similarity-matrix MLP: the port's plain version against the JAX
package, on the CPU.

``ref.sim_mlp_eval`` (the CPU path; with ``ref.sim_mlp_core`` the contract
of ``csrc/sim_mlp.cu``) against JAX's ``sim_mlp_reference`` (train=False)
and ``sim_mlp_eval`` in Pallas interpret mode, on the same numpy inputs at
the JAX test's size (B 2, M 37: ragged against every tile, emb 16, C 32),
and at M 16 with duplicate target points, so that the max over j ties.

Bars, normwise |port - JAX| / |JAX|: 5e-4 for sim and wmax. Measured at
M 37: sim 8.2e-5 against the reference (8.3e-5 against the interpret
kernel), wmax 1.8e-5. The activations x1 and h1 are rounded to bf16 before
the next product; the two frameworks sum the projections and products in
other orders (and XLA contracts BatchNorm's multiply-add into an FMA), so a
few activations land on the other bf16 neighbour: 1 of the 2738 sim values
lies outside JAX's own elementwise bar for its kernel (1e-3 + 1e-3 |x|,
``tests/test_pallas_kernels.py``), whose kernel and reference are 1.2e-5
apart normwise here for the same reason.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvp_benchmark_tpu.ops import pallas_kernels as pk
from mvp_benchmark_tpu_torch.ops import dispatch, ref

BAR = 5e-4


def _inputs(seed, B=2, M=37, emb=16, C=32, ties=False):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    src, tgt = f(B, M, 3), f(B, M, 3)
    semb, temb = f(B, M, emb), f(B, M, emb)
    if ties:
        h = M // 2
        tgt[:, h:2 * h], temb[:, h:2 * h] = tgt[:, :h], temb[:, :h]
    params = (f(2 * emb + 4, C) * 0.2, f(C, C) * 0.2, f(C) * 0.1, f(C, C) * 0.2,
              f(C, 1) * 0.2, f(1) * 0.1, 1 + f(C) * 0.05, f(C) * 0.05,
              1 + f(C) * 0.05, f(C) * 0.05)
    var = lambda: (1 + 0.2 * np.abs(f(C))).astype(np.float32)
    stats = (0.1 * f(C), var(), 0.1 * f(C), var())
    return (src, tgt, semb, temb, *params, *stats)


def _normwise(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.mark.parametrize("M,ties", [(37, False), (16, True)], ids=["ragged", "ties"])
def test_plain_version_matches_jax_reference_and_interpret_kernel(M, ties):
    args = _inputs(M, M=M, ties=ties)
    sim, wmax, stats = dispatch.sim_mlp(*map(torch.from_numpy, args), train=False)
    assert stats is None
    assert sim.shape == (2, M, M) and wmax.shape == (2, M, 32)
    assert sim.dtype == wmax.dtype == torch.float32
    assert float(sim.abs().max()) <= 20.0
    jargs = list(map(jnp.asarray, args))
    for name, (s, w) in (("reference", pk.sim_mlp_reference(*jargs, train=False)),
                         ("interpret", pk.sim_mlp_eval(*jargs))):
        assert _normwise(sim.numpy(), s) <= BAR, name
        assert _normwise(wmax.numpy(), w) <= BAR, name
    if ties:
        # duplicate targets: their columns of sim are bitwise equal
        h = M // 2
        np.testing.assert_array_equal(sim[:, :, h:2 * h].numpy(), sim[:, :, :h].numpy())


def test_core_is_the_kernel_contract():
    """sim_mlp_eval == clip(sim_mlp_core(projections) + b4): the split the
    card takes (projections plain, the pairwise chain the kernel)."""
    (src, tgt, semb, temb, Wcat, W2, b2, W3, W4, b4, g1, be1, g2, be2,
     m1, v1, m2, v2) = map(torch.from_numpy, _inputs(5))
    sim, wmax = ref.sim_mlp_eval(src, tgt, semb, temb, Wcat, W2, b2, W3, W4, b4,
                                 g1, be1, g2, be2, m1, v1, m2, v2)
    sp, tp = ref.sim_projections(semb, temb, Wcat)
    simr, wmax2 = ref.sim_mlp_core(sp, tp, src, tgt, *ref.sim_mlp_split(Wcat, 16),
                                   W2, b2, W3, W4, g1, be1, g2, be2, m1, v1, m2, v2)
    assert torch.equal(sim, ref.sim_logits(simr, b4)) and torch.equal(wmax, wmax2)


def test_train_mode_on_cpu_is_the_plain_version():
    """On CPU tensors train mode is ``ref.sim_mlp_train``: (sim, wmax, (st1,
    st2)) with the batch statistics detached and no gradient to the
    positions (its parity with JAX: tests/test_torch_idam_train.py)."""
    args = list(map(torch.from_numpy, _inputs(6, M=8)))
    args[2].requires_grad_()
    args[0].requires_grad_()
    sim, wmax, (st1, st2) = dispatch.sim_mlp(*args, train=True)
    want = ref.sim_mlp_train(*args[:14])
    assert torch.equal(sim, want[0]) and torch.equal(wmax, want[1])
    assert torch.equal(st1, want[2][0]) and torch.equal(st2, want[2][1])
    assert st1.shape == st2.shape == (2, 32) and not st1.requires_grad
    g_src, g_semb = torch.autograd.grad(sim.sum() + wmax.sum(), (args[0], args[2]),
                                        allow_unused=True)
    assert g_src is None and bool(torch.isfinite(g_semb).all())


@pytest.mark.parametrize("scale", [1e-20, 1e-3, 1.0, 1e4, 1e30])
def test_split_bf16x3_reconstructs_fp32_bitwise(scale):
    """``ref.split_bf16x3``, the kernel backward's three bf16 terms of an fp32
    cotangent: each term is a bf16 value, (hi + mid) + lo rebuilds x bitwise
    in fp32, and a product with a bf16 weight taken as the three terms' bf16
    products summed in fp64 is x's exact product."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy((rng.standard_normal(4096) * scale).astype(np.float32))
    hi, mid, lo = ref.split_bf16x3(x)
    assert hi.dtype == mid.dtype == lo.dtype == torch.bfloat16
    assert torch.equal((hi.float() + mid.float()) + lo.float(), x)
    assert float(mid.float().abs().max()) <= float(hi.float().abs().max()) * 2 ** -8
    w = torch.from_numpy(rng.uniform(-1, 1, 4096).astype(np.float32)).to(torch.bfloat16)
    w = w.double()
    assert torch.equal((hi.double() * w + mid.double() * w) + lo.double() * w,
                       x.double() * w)
