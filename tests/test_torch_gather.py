"""Gathers of the torch port (``gather_points``, ``grouping_operation``,
``group_max``, ``three_interpolate``) against the JAX package, on the CPU.

The plain versions are the contracts of the three kernels in
``csrc/gather.cu`` (held against them on the card in ``test_torch_cuda.py``
and ``chip_smoke.py``). Tolerances:
- gathers and group_max values: bitwise against ``jnp_ref`` (copies and
  compares, no arithmetic);
- group_max slots: equal to the Pallas kernel's in interpret mode, with
  features rounded to bf16 values so that its bf16 one-hot product is exact
  (the port's slot a byte, the kernel's int32); the backward they route
  equal too, with cotangents in k/8;
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
    assert slot.dtype == np.uint8 and slot.shape == out.shape
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


def test_group_max_byte_slot_and_backward_equal_pallas_interpret():
    """The port saves group_max's slot in a byte, the Pallas kernel in
    int32: at a few hundred points, on the same inputs, the slots' values
    are equal, and the backward the byte slot routes equals
    ``_group_max_bwd_rule``'s (cotangents in k/8 keep its bf16 one-hot
    products and f32 sums exact)."""
    rng = np.random.default_rng(21)
    B, N, C, M, k = 2, 320, 16, 256, 10
    f = _bf16_values(rng.random((B, N, C), dtype=np.float64).astype(np.float32))
    f[:, :, 3] = 0.5                    # a channel that ties everywhere
    idx = rng.integers(0, N, (B, M, k)).astype(np.int32)
    g = (rng.integers(-16, 16, (B, M, C)) / 8).astype(np.float32)
    out, slot = ref.group_max(torch.from_numpy(f), torch.from_numpy(idx))
    p_out, res = pallas_kernels._group_max_forward(jnp.asarray(f), jnp.asarray(idx))
    assert slot.dtype == torch.uint8 and np.asarray(res[2]).dtype == np.int32
    np.testing.assert_array_equal(out.numpy(), np.asarray(p_out))
    np.testing.assert_array_equal(slot.numpy().astype(np.int32), np.asarray(res[2]))
    got = ref.group_max_backward(torch.from_numpy(g), torch.from_numpy(idx), slot, N)
    want, _ = pallas_kernels._group_max_bwd_rule(res, jnp.asarray(g))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


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


# Every scatter_add_rows of ECG's and VRCNet's train steps: (B, entries a
# cloud, rows, C). ECG: the uniform losses' kNN gathers (51 or 102 centres a
# cloud of 32, nsample 4-12 of out1, 8-24 of out2, k 2) and grouping
# gathers, the sampled centres' gathers, DenseEdge's two smaller neighbour
# gathers (its two larger take the list form, below), the last FPS's
# gather; VRCNet: its centres' gathers and coarse_high's.
_SCATTER_PATH_SHAPES = (
    [(32 * 51, 2 * ns, ns, 3) for ns in (4, 6, 8, 10, 12)]
    + [(32 * 102, 2 * ns, ns, 3) for ns in (8, 12, 16, 20, 24)]
    + [(32, 51 * ns, 1024, 3) for ns in (4, 6, 8, 10, 12)]
    + [(32, 102 * ns, 2048, 3) for ns in (8, 12, 16, 20, 24)]
    + [(32, 1024, 3072, 120), (32, 256, 1024, 360), (32, 64, 256, 840)]
    + [(32, 16 * n, n, 48) for n in (256, 64)]
    + [(32, 2048, 3072, 3)]
    + [(64, 1536, 3072, 64), (64, 768, 1536, 128), (64, 384, 768, 256), (64, 2048, 3072, 3)]
    + [(70000, 8, 4, 3), (3, 257, 1024, 1), (2, 256, 1024, 1), (2, 8192, 300, 1)])


def _scatter_shared_bytes(entries, n, vectors):
    """The shared memory a block of gather.cu's one-launch forms takes under
    ``kernels.scatter_plan``: packed, (n + entries) ints a cloud; by row
    range, (warps + 1) rows + 1 + warps + entries ints; 0 for the list
    form."""
    rows, warps, clouds = kernels.scatter_plan(entries, n, vectors)
    if clouds > 1:
        return 4 * clouds * (n + entries)
    return 4 * ((warps + 1) * rows + 1 + warps + entries) if rows else 0


def _scatter_cover(B, entries, n, vectors):
    """{(cloud, row): times} over the blocks (and the packed form's warps)
    of gather.cu's one-launch forms under ``kernels.scatter_plan``, by the
    kernels' own index arithmetic; and the entries a thread holds."""
    rows, warps, clouds = kernels.scatter_plan(entries, n, vectors)
    seen = {}
    if clouds > 1:
        for block in range(-(-B // clouds)):
            for w in range(clouds):
                b = block * clouds + w
                if b < B:
                    seen[b] = seen.get(b, 0) + 1
        return {(b, r): t for b, t in seen.items() for r in range(n)}, -(-entries // 32)
    ranges = -(-n // rows)
    for block in range(B * ranges):
        b, rng = divmod(block, ranges)
        for r in range(rng * rows, min(n, rng * rows + rows)):
            seen[(b, r)] = seen.get((b, r), 0) + 1
    return seen, -(-entries // (32 * warps))


@pytest.mark.parametrize("B,entries,n,c", _SCATTER_PATH_SHAPES)
def test_scatter_plan_covers_each_cloud_and_row_once(B, entries, n, c):
    """Plan arithmetic only (no kernel): at every scatter of the two train
    steps, and at the packed form's limits and past 65535 clouds, the
    one-launch forms write each (cloud, row) exactly once, a thread holds
    at most 16 entries (the packed form's lanes 8), the list fits in its
    block's shared memory and the grid in int32."""
    vectors = c // 4 if c % 4 == 0 else c
    rows, warps, clouds = kernels.scatter_plan(entries, n, vectors)
    assert rows
    if B > 50000:
        seen = {(b, r): 1 for b in range(B) for r in range(n)} if clouds > 1 else {}
        assert clouds > 1 and -(-B // clouds) < 2 ** 31
    else:
        seen, per_thread = _scatter_cover(B, entries, n, vectors)
        assert set(seen) == {(b, r) for b in range(B) for r in range(n)}
        assert set(seen.values()) == {1}
        assert per_thread <= (kernels.SCATTER_PACK_ENTRIES // 32 if clouds > 1 else 16)
    assert 0 < _scatter_shared_bytes(entries, n, vectors) <= kernels.MAX_SMEM


def test_scatter_plan_list_form_past_8192_entries():
    """DenseEdge's two largest neighbour gathers (3072 x 16 and 1024 x 16
    entries a cloud) build the reverse list and gather: no shared list."""
    for entries, n, c in ((49152, 3072, 24), (16384, 1024, 48)):
        assert kernels.scatter_plan(entries, n, c // 4) == (0, 0, 0)
        assert _scatter_shared_bytes(entries, n, c // 4) == 0
