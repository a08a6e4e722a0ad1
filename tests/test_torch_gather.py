"""Gathers of the torch port (``gather_points``, ``grouping_operation``,
``group_max``, ``three_interpolate``) against the JAX package, on the CPU.

The plain versions are the contracts of the three kernels in
``csrc/gather.cu`` (held against them on the card in ``test_torch_cuda.py``
and ``chip_smoke.py``). Tolerances:
- gathers and group_max values: bitwise against ``jnp_ref`` (copies and
  compares, no arithmetic);
- group_max slots: equal to the Pallas kernel's in interpret mode, with
  features rounded to bf16 values so that its bf16 one-hot product is exact;
- three_interpolate: rtol 1e-6 against ``jnp_ref`` and against
  ``three_interpolate_fused`` in interpret mode (bf16-representable features
  and weights, three distinct indices per row, so its bf16 one-hot product
  is exact); the sums may be taken in another order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvp_benchmark_tpu.ops import jnp_ref, pallas_kernels
from mvp_benchmark_tpu_torch.ops import dispatch, kernels, ref


def _bf16_values(x):
    """Round float32 values to the nearest bf16 value, kept as float32."""
    return np.array(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))


def _table(seed, B, N, C):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((B, N, C)).astype(np.float32)


@pytest.mark.parametrize("C", [3, 24, 120])
def test_gather_points_and_grouping_equal_jnp_ref(C):
    rng = np.random.default_rng(C)
    f = _table(0, 2, 50, C)
    idx2 = rng.integers(0, 50, (2, 30)).astype(np.int32)
    idx3 = rng.integers(0, 50, (2, 30, 16)).astype(np.int32)
    got = ref.gather_points(torch.from_numpy(f), torch.from_numpy(idx2)).numpy()
    assert got.shape == (2, 30, C)
    np.testing.assert_array_equal(got, np.asarray(jnp_ref.gather_points(f, idx2)))
    got = ref.grouping_operation(torch.from_numpy(f), torch.from_numpy(idx3)).numpy()
    assert got.shape == (2, 30, 16, C)
    np.testing.assert_array_equal(got, np.asarray(jnp_ref.grouping_operation(f, idx3)))


def _group_inputs():
    rng = np.random.default_rng(3)
    f = _bf16_values(rng.random((2, 64, 16), dtype=np.float64).astype(np.float32))
    idx = rng.integers(0, 64, (2, 48, 8)).astype(np.int32)
    idx[:, :, 5] = idx[:, :, 1]         # the same row twice: ties at j 1 and 5
    f[:, 10] = f[:, 11]                 # equal rows at different indices
    idx[:, 0, :2] = [10, 11]
    f[:, :, 3] = 0.5                    # a channel that ties everywhere
    return f, idx


def test_group_max_values_equal_jnp_ref():
    f, idx = _group_inputs()
    out, slot = (x.numpy() for x in ref.group_max(torch.from_numpy(f),
                                                  torch.from_numpy(idx)))
    want = np.asarray(jnp.max(jnp_ref.grouping_operation(f, idx), axis=2))
    np.testing.assert_array_equal(out, want)
    assert slot.dtype == np.int32 and slot.shape == out.shape
    # the slot names a neighbour that reaches the max, the lowest such j
    g = np.asarray(jnp_ref.grouping_operation(f, idx))
    hit = g == out[:, :, None, :]
    np.testing.assert_array_equal(slot, hit.argmax(axis=2))
    assert (slot[:, :, 3] == 0).all()


def test_group_max_slots_equal_pallas_interpret():
    f, idx = _group_inputs()
    out, slot = (x.numpy() for x in ref.group_max(torch.from_numpy(f),
                                                  torch.from_numpy(idx)))
    p_out, (_, _, p_slot) = pallas_kernels._group_max_forward(
        jnp.asarray(f), jnp.asarray(idx))
    np.testing.assert_array_equal(out, np.asarray(p_out))
    np.testing.assert_array_equal(slot, np.asarray(p_slot))


def _interp_inputs(B=2, M=40, C=16, N=256):
    rng = np.random.default_rng(5)
    f = _bf16_values(rng.standard_normal((B, M, C)).astype(np.float32))
    idx = np.stack([np.stack([rng.choice(M, 3, replace=False) for _ in range(N)])
                    for _ in range(B)]).astype(np.int32)
    w = rng.random((B, N, 3), dtype=np.float64).astype(np.float32)
    w = _bf16_values(w / w.sum(-1, keepdims=True))
    return f, idx, w


def test_three_interpolate_matches_jnp_ref_and_pallas_interpret():
    f, idx, w = _interp_inputs()
    got = ref.three_interpolate(*map(torch.from_numpy, (f, idx, w))).numpy()
    assert got.shape == (2, 256, 16)
    np.testing.assert_allclose(got, np.asarray(jnp_ref.three_interpolate(f, idx, w)),
                               rtol=1e-6, atol=0)
    fused = pallas_kernels.three_interpolate_fused(
        jnp.asarray(f), jnp.asarray(idx), jnp.asarray(w))
    np.testing.assert_allclose(got, np.asarray(fused), rtol=1e-6, atol=0)


def test_three_interpolate_sum_order():
    """((f0*w0 + f1*w1) + f2*w2), each operation rounded on its own: the
    arithmetic csrc/gather.cu repeats."""
    f, idx, w = _interp_inputs(B=1, M=8, C=4, N=6)
    got = ref.three_interpolate(*map(torch.from_numpy, (f, idx, w))).numpy()
    g = [np.take_along_axis(f, idx[..., l, None], axis=1) for l in range(3)]
    want = (g[0] * w[..., 0, None] + g[1] * w[..., 1, None]) + g[2] * w[..., 2, None]
    np.testing.assert_array_equal(got, want.astype(np.float32))


def test_cpu_dispatch_takes_plain_version(monkeypatch):
    def no_kernel(*args):
        raise AssertionError("CPU tensors must not reach ops/kernels.py")

    for name in ("gather_rows", "group_max_forward", "three_interpolate_forward"):
        monkeypatch.setattr(kernels, name, no_kernel)
    counts = kernels.launch_counts()
    f, idx = map(torch.from_numpy, _group_inputs())
    torch.testing.assert_close(dispatch.grouping_operation(f, idx),
                               ref.grouping_operation(f, idx), rtol=0, atol=0)
    torch.testing.assert_close(dispatch.gather_points(f, idx[..., 0]),
                               ref.gather_points(f, idx[..., 0]), rtol=0, atol=0)
    torch.testing.assert_close(dispatch.group_max(f, idx),
                               ref.group_max(f, idx)[0], rtol=0, atol=0)
    f, idx, w = map(torch.from_numpy, _interp_inputs())
    torch.testing.assert_close(dispatch.three_interpolate(f, idx, w),
                               ref.three_interpolate(f, idx, w), rtol=0, atol=0)
    assert kernels.launch_counts() == counts


def test_kernel_wrappers_reject_cpu_tensors():
    f, idx = map(torch.from_numpy, _group_inputs())
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.gather_rows(f, idx)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.group_max_forward(f, idx)
    f, idx, w = map(torch.from_numpy, _interp_inputs())
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.three_interpolate_forward(f, idx, w)


@pytest.mark.parametrize("fn,args,tpu", [
    (kernels.GatherRowsFunction, 2, "scatter_add_rows"),
    (kernels.GroupMaxFunction, 2, "_group_max_bwd_rule"),
    (kernels.ThreeInterpolateFunction, 3, "_ti_bwd_rule"),
])
def test_autograd_functions_name_the_backward_they_wait_for(monkeypatch, fn,
                                                            args, tpu):
    """Forward returns the launcher's output and the backward launches the
    port of the TPU backward ``tpu`` (here the plain versions stand in for
    the launchers), for the inputs that need a gradient: the gradients equal
    autograd's through the plain forward."""
    launcher = {"scatter_add_rows": "scatter_add_rows",
                "_group_max_bwd_rule": "group_max_backward",
                "_ti_bwd_rule": "three_interpolate_backward"}[tpu]
    calls = []

    def stand_in(*a, **kw):
        calls.append(launcher)
        return getattr(ref, launcher)(*a, **kw)

    monkeypatch.setattr(kernels, "gather_rows", ref.gather_points)
    monkeypatch.setattr(kernels, "group_max_forward", ref.group_max)
    monkeypatch.setattr(kernels, "three_interpolate_forward", ref.three_interpolate)
    monkeypatch.setattr(kernels, launcher, stand_in)
    f, idx, w = map(torch.from_numpy, _interp_inputs())
    f.requires_grad_(True)
    w.requires_grad_(args == 3)
    inputs = [f, idx, w][:args]
    out = fn.apply(*inputs)
    g = torch.linspace(-1, 1, out.numel()).reshape(out.shape)
    got = torch.autograd.grad((out * g).sum(), [x for x in inputs if x.requires_grad])
    assert calls == [launcher]
    plain = {"scatter_add_rows": ref.gather_points,
             "group_max_backward": lambda *a: ref.group_max(*a)[0],
             "three_interpolate_backward": ref.three_interpolate}[launcher]
    fp, wp = f.detach().requires_grad_(True), w.detach().requires_grad_(args == 3)
    want = torch.autograd.grad((plain(*[fp, idx, wp][:args]) * g).sum(),
                               [x for x in (fp, wp)[:args - 1] if x.requires_grad])
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("c1", [4, 16])
def test_gather_then_split_equals_grouping_split(c1):
    """PERF.md row 12: ``grouping_split`` (``pallas_kernels.py:1838``, no
    model calls it) gathers rows and splits the channels at c1 in one
    kernel; row 11's gather followed by a slice computes the same, bitwise
    on bf16-valued features (its one-hot product rounds the table to bf16)."""
    rng = np.random.default_rng(c1)
    f = _bf16_values(_table(3, 2, 70, c1 + 20))
    idx = rng.integers(0, 70, (2, 33, 5)).astype(np.int32)
    want = pallas_kernels.grouping_split(jnp.asarray(f), jnp.asarray(idx), c1)
    got = ref.gather_points(torch.from_numpy(f), torch.from_numpy(idx))
    for g, w in zip((got[..., :c1], got[..., c1:]), want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w, np.float32))
