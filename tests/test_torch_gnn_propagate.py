"""IDAM's Propagate edge block: the port's plain version against the JAX
package, on the CPU.

``ref.gnn_propagate_eval`` (the CPU path, and the contract of
``csrc/gnn_propagate.cu``) against JAX's ``gnn_propagate_reference``
(train=False) and against ``gnn_propagate_eval`` in Pallas interpret mode
(the edge-build kernel, then the gnn_edge eval kernel), on the same numpy
inputs: the JAX test's size (B 2, N 48, k 5, C 16) and IDAM's widths (k 12,
C 64 and the smoke config's 32). The edges are rounded to bf16 on both
sides and the products take bf16 inputs. Against the reference, run op by
op, only the order of the fp32 sums differs: 1e-5 + 1e-5 |x| elementwise
(measured 9.5e-7 at most). The interpret kernel is jitted, and XLA:CPU
contracts its BatchNorm's ``hhat * gamma + beta`` into an FMA, so an
activation may round to the other bf16 neighbour before the product:
normwise 5e-4 (measured 8.7e-5 at C 64, where 14 of 8192 outputs moved, by
1.3e-2 at most; 3.1e-9 and 9.6e-9 at the other sizes). JAX's own bar for
its kernel against its reference is 1e-3 elementwise.

Plus: the edge is stored bf16 (the result is JAX's unfused gnn_edge chain on
the bf16-rounded edge tensor, and not the one on the fp32 edge); a
duplicated neighbour (a tie of the max) gives the value the row gives
without it, bitwise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvp_benchmark_tpu.ops import jnp_ref, pallas_kernels as pk
from mvp_benchmark_tpu_torch.ops import dispatch


def _inputs(seed, B, N, k, C):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    p = f(B, N, C)
    idx = np.argsort(rng.random((B, N, N)), axis=-1)[:, :, :k].astype(np.int32)
    W, b = f(C, C) * 0.3, f(C) * 0.1
    gamma, beta = 1 + f(C) * 0.05, f(C) * 0.05
    mean, var = 0.1 * f(C), (1 + 0.2 * np.abs(f(C))).astype(np.float32)
    return p, idx, W, b, gamma, beta, mean, var


def _port(args):
    x, stats = dispatch.gnn_propagate(*map(torch.from_numpy, args), train=False)
    assert stats is None
    return x.numpy()


@pytest.mark.parametrize("B,N,k,C", [(2, 48, 5, 16), (2, 64, 12, 64), (3, 40, 12, 32)])
def test_plain_version_matches_jax_reference_and_interpret_kernel(B, N, k, C):
    args = _inputs(B * N + k, B, N, k, C)
    got = _port(args)
    jargs = list(map(jnp.asarray, args))
    want = np.asarray(pk.gnn_propagate_reference(*jargs, train=False))
    interp = np.asarray(pk.gnn_propagate_eval(*jargs))
    assert got.shape == want.shape == (B, N, C) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    gap = np.linalg.norm(got - interp) / np.linalg.norm(interp.astype(np.float64))
    assert gap <= 5e-4, gap


def test_edge_is_stored_bf16():
    p, idx, W, b, gamma, beta, mean, var = _inputs(7, 2, 48, 5, 16)
    got = _port((p, idx, W, b, gamma, beta, mean, var))
    pb = jnp.asarray(p).astype(jnp.bfloat16).astype(jnp.float32)
    edge = jnp.swapaxes(jnp_ref.grouping_operation(pb, jnp.asarray(idx))
                        - jnp.asarray(p)[:, :, None, :], 1, 2)
    rest = tuple(map(jnp.asarray, (W, b, gamma, beta, mean, var)))
    on_bf16 = np.asarray(pk.gnn_edge_reference(edge.astype(jnp.bfloat16), *rest,
                                               train=False))
    on_fp32 = np.asarray(pk.gnn_edge_reference(edge, *rest, train=False))
    np.testing.assert_allclose(got, on_bf16, rtol=1e-5, atol=1e-5)
    assert np.abs(got - on_fp32).max() > 100 * np.abs(got - on_bf16).max()


def test_duplicate_neighbour_ties_give_the_same_value():
    p, idx, *rest = _inputs(8, 2, 48, 5, 16)
    dup = np.concatenate([idx, idx[:, :, :2]], axis=-1)       # two tied slots a row
    np.testing.assert_array_equal(_port((p, dup, *rest)), _port((p, idx, *rest)))


def test_train_mode_on_cpu_is_the_plain_train_version():
    """On a CPU tensor train mode is ``ref.gnn_propagate_train``, the batch
    statistics returned detached (its parity with JAX:
    tests/test_torch_idam_train.py)."""
    from mvp_benchmark_tpu_torch.ops import ref

    p, idx, W, b, gamma, beta, _, _ = map(torch.from_numpy, _inputs(9, 1, 16, 4, 16))
    p.requires_grad_()
    x, stats = dispatch.gnn_propagate(p, idx, W, b, gamma, beta, None, None, train=True)
    want_x, want_stats = ref.gnn_propagate_train(p, idx, W, b, gamma, beta)
    assert torch.equal(x, want_x) and torch.equal(stats, want_stats)
    assert stats.shape == (2, 16) and not stats.requires_grad
    assert torch.equal(stats, ref.gnn_propagate_stats(p.detach(), idx))
    (g,) = torch.autograd.grad(x.sum(), p)
    assert bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0


def _kernel_order_partials(p, idx, blocks):
    """The stat pass's per-block partials by its definition, one scalar at
    a time in numpy fp32: lane q of block b takes points b L + q + m blocks
    L, each channel summed over them and their slots in order (s2 by fma:
    fp64 then one rounding), the lanes added in order."""
    B, N, C = p.shape
    k, L, pts = idx.shape[2], 256 // C, B * N
    pb = p.astype(np.float32)
    bf = lambda x: torch.tensor(np.float32(x)).to(torch.bfloat16).float().numpy()
    out = np.zeros((blocks, 2, C), np.float32)
    for b in range(blocks):
        red = np.zeros((2, L, C), np.float32)
        for q in range(L):
            pt = np.arange(b * L + q, pts, blocks * L)
            for c in range(C):
                s1 = s2 = np.float32(0)
                for i in pt:
                    row, centre = i // N * N, pb.reshape(pts, C)[i, c]
                    for j in idx.reshape(pts, k)[i]:
                        e = (bf(bf(pb.reshape(pts, C)[row + j, c]) - centre) if 0 <= j < N
                             else np.float32("nan"))
                        s1 = np.float32(s1 + e)
                        s2 = np.float32(np.float64(s2) + np.float64(e) * np.float64(e))
                red[0, q, c], red[1, q, c] = s1, s2
        for kind in (0, 1):
            acc = red[kind, 0]
            for q in range(1, L):
                acc = (acc + red[kind, q]).astype(np.float32)
            out[b, kind] = acc
    return out


@pytest.mark.parametrize("B,N,k,C,blocks", [(1, 9, 3, 32, 2), (2, 13, 4, 64, 3),
                                            (1, 40, 5, 64, 264)])
def test_ordered_stat_partials_follow_the_kernel_order(B, N, k, C, blocks):
    """``ref.gnn_propagate_partials_ordered`` (vectorised over blocks, lanes
    and channels) against the stat pass's order written out scalar by
    scalar: bitwise, and NaN where a neighbour index lies outside [0, N)."""
    from mvp_benchmark_tpu_torch.ops import ref

    p, idx = _inputs(B * N + k, B, N, k, C)[:2]
    idx[0, 1, k - 1] = N
    got = ref.gnn_propagate_partials_ordered(torch.from_numpy(p), torch.from_numpy(idx),
                                             blocks).numpy()
    want = _kernel_order_partials(p, idx, blocks)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got).any()
    np.testing.assert_array_equal(np.nan_to_num(got).view(np.int32),
                                  np.nan_to_num(want).view(np.int32))


@pytest.mark.parametrize("B,N,k,C,blocks", [(2, 64, 12, 64, 264), (3, 40, 12, 32, 7),
                                            (2, 48, 5, 64, 1)])
def test_ordered_stats_match_plain_and_jax(B, N, k, C, blocks):
    """The kernel-ordered statistics within ``chip_smoke.IDAM_STAT_NORM``
    normwise of ``ref.gnn_propagate_stats`` and of JAX's
    ``gnn_propagate_train`` statistics (``_gnn_edge_forward``, XLA's
    reduction over the edge tensor in interpret mode)."""
    import chip_smoke
    from mvp_benchmark_tpu_torch.ops import ref

    args = _inputs(B * N + k, B, N, k, C)
    p, idx = map(torch.from_numpy, args[:2])
    got = ref.gnn_propagate_stats_ordered(p, idx, blocks).double()
    _, jst = pk.gnn_propagate_train(*map(jnp.asarray, args[:6]))
    for want in (ref.gnn_propagate_stats(p, idx).double(),
                 torch.from_numpy(np.array(jst)).double()):
        for i in (0, 1):
            gap = float((got[i] - want[i]).norm() / want[i].norm())
            assert gap <= chip_smoke.IDAM_STAT_NORM, (i, gap)
