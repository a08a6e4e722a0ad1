"""VRCNet's SA block in the torch port (``ops.sa_attention``) against the JAX
package, on the CPU.

``ref.sa_attention`` is the contract of ``csrc/sa_attention.cu`` (held
against it on the card, to a tolerance, in ``test_torch_cuda.py`` and
``chip_smoke.py``). Here it is held:
- against the XLA block of ``tests/test_pallas_kernels.py:257-265`` (the
  fallback of ``models/vrcnet.py:100-108``) at fp32, atol 1e-5 / rtol 1e-4
  (matmuls summed in another order), at VRCNet's four (rel, mid) levels,
  k 8 and 16, and a ragged point count;
- against the Pallas kernel ``pallas_kernels.sa_attention`` in interpret
  mode at that test's own bar (2e-2: the kernel rounds its gathers and W1,
  W2 to bf16), which pins the ``c % ms`` tile layout and the slot order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvp_benchmark_tpu.ops import jnp_ref, pallas_kernels
from mvp_benchmark_tpu_torch.ops import dispatch, kernels, ref

LEVELS = [(4, 16), (8, 32), (16, 64), (32, 128)]
SHARE = 8


def _inputs(B, N, k, rel, mid, seed=0):
    """Unit-scale proj/x1 in [-0.5, 0.5), weights at torch's init scale."""
    rng = np.random.default_rng([seed, N, k, rel])
    ms = mid // SHARE
    proj = rng.random((B, N, rel + mid), dtype=np.float64) - 0.5
    x1 = rng.random((B, N, rel), dtype=np.float64) - 0.5
    idx = rng.integers(0, N, (B, N, k)).astype(np.int32)
    b1, b2 = 1 / np.sqrt((1 + k) * rel), 1 / np.sqrt(ms)
    W1 = rng.uniform(-b1, b1, ((1 + k) * rel, ms))
    W2 = rng.uniform(-b2, b2, (ms, k * ms))
    bias = rng.uniform(-b2, b2, (k * ms,))
    f32 = lambda a: a.astype(np.float32)
    return f32(proj), f32(x1), idx, f32(W1), f32(W2), f32(bias)


def _xla_block(proj, x1, idx, W1, W2, b2, rel, mid):
    """tests/test_pallas_kernels.py:257-265, at fp32 ('highest')."""
    B, N, k = idx.shape
    ms = mid // SHARE
    pn = jnp_ref.grouping_operation(proj, idx)
    x2 = pn[..., :rel].reshape(B, N, k * rel)
    x3 = pn[..., rel:]
    w = jnp.maximum(jnp.concatenate([x1, x2], axis=-1), 0.0)
    u = jnp.maximum(jnp.dot(w, W1, precision="highest"), 0.0)
    w = jnp.dot(u, W2, precision="highest") + b2
    w = jnp.tile(w.reshape(B, N, k, ms), (1, 1, 1, SHARE))
    return np.asarray(jnp.sum(w * x3, axis=2))


def _ref(args, rel, mid):
    return ref.sa_attention(*map(torch.from_numpy, args), rel, mid, SHARE).numpy()


@pytest.mark.parametrize("k", [8, 16])
@pytest.mark.parametrize("rel,mid", LEVELS)
def test_plain_version_matches_xla_block(rel, mid, k):
    args = _inputs(2, 37, k, rel, mid)          # 37: no tile divides it
    got = _ref(args, rel, mid)
    assert got.shape == (2, 37, mid) and got.dtype == np.float32
    np.testing.assert_allclose(got, _xla_block(*args, rel, mid), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("rel,mid", [(4, 16), (8, 32)])
def test_plain_version_matches_pallas_interpret(rel, mid):
    args = _inputs(2, 256, 8, rel, mid, seed=1)
    proj, x1, idx, W1, W2, b2 = args
    want = pallas_kernels.sa_attention(
        jnp.asarray(proj), jnp.asarray(x1), jnp.swapaxes(jnp.asarray(idx), 1, 2),
        jnp.asarray(W1), jnp.asarray(W2), jnp.asarray(b2), rel, mid, SHARE)
    np.testing.assert_allclose(_ref(args, rel, mid), np.asarray(want),
                               rtol=2e-2, atol=2e-2)


def test_tile_layout_and_slot_order():
    """out[c] = sum_j w[j, c % ms] * proj[idx_j, rel + c], written out with
    loops in float64 on one point."""
    rel, mid, k = 4, 16, 3
    ms = mid // SHARE
    proj, x1, idx, W1, W2, b2 = _inputs(1, 9, k, rel, mid, seed=2)
    got = _ref((proj, x1, idx, W1, W2, b2), rel, mid)[0, 5]
    p = proj[0].astype(np.float64)
    w_in = np.maximum(np.concatenate([x1[0, 5]] + [p[j, :rel] for j in idx[0, 5]]), 0)
    w = (np.maximum(w_in @ W1, 0) @ W2 + b2).reshape(k, ms)
    want = [sum(w[j, c % ms] * p[idx[0, 5, j], rel + c] for j in range(k))
            for c in range(mid)]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_cpu_dispatch_takes_plain_version(monkeypatch):
    def no_kernel(*args):
        raise AssertionError("CPU tensors must not reach ops/kernels.py")

    monkeypatch.setattr(kernels, "sa_attention_forward", no_kernel)
    counts = kernels.launch_counts()
    args = [torch.from_numpy(a) for a in _inputs(2, 20, 8, 8, 32)]
    torch.testing.assert_close(dispatch.sa_attention(*args, 8, 32, SHARE),
                               ref.sa_attention(*args, 8, 32, SHARE),
                               rtol=0, atol=0)
    assert kernels.launch_counts() == counts
    assert counts["sa_attention"] == kernels.SA_ATTENTION_LAUNCHES


def test_kernel_wrapper_rejects_cpu_tensors():
    args = [torch.from_numpy(a) for a in _inputs(2, 20, 8, 8, 32)]
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.sa_attention_forward(*args, 8, 32, SHARE)


def test_autograd_function_names_the_backward_it_waits_for(monkeypatch):
    """Forward returns the launcher's output (here the plain version stands in
    for it); the backward is not ported yet."""
    monkeypatch.setattr(kernels, "sa_attention_forward", ref.sa_attention)
    args = [torch.from_numpy(a) for a in _inputs(2, 20, 8, 4, 16)]
    args[0].requires_grad_(True)
    out = kernels.SAAttentionFunction.apply(*args, 4, 16, SHARE)
    with pytest.raises(NotImplementedError, match="_sa_bwd"):
        out.sum().backward()
