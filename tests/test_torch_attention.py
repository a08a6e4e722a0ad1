"""The attention plain versions of the torch port (``ref.attention``,
``ref.attention_bnhd``) against the JAX package, on the CPU.

Both layouts and both dtypes, at the shapes of ``test_pallas_kernels.py``
(B 2, Nq 256, M 128; the bnhd layout with H 2, dk 128; the svd head's D 512
with the 3-wide value, which the Pallas kernel takes zero-padded to 128
lanes). The Pallas kernels run in interpret mode.

- bf16: the port follows ``_attn_math_fwd`` (bf16 operands, fp32 scores and
  softmax, p rounded to bf16, fp32 accumulation, one rounding to bf16). XLA's
  and torch's exp and sums may differ in the last fp32 bit and move a bf16
  rounding of p or of the output by one step, so the bar is one bf16 step
  (2^-7 of the value at most): |port - pallas| <= 2^-7 |pallas| elementwise,
  and 1e-4 normwise.
- fp32: the port stays fp32 throughout, where the Pallas kernel rounds q, k,
  v and p to bf16. So it is held tightly (atol 1e-5, rtol 1e-4) against the
  JAX package's fp32 CPU path (``layers.attention``), and against the
  Pallas kernel at the bf16 bar of its roundings (normwise 1e-2).

The CUDA kernel is held against these plain versions on the card
(``test_torch_cuda.py``, ``chip_smoke.py``).
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvp_benchmark_tpu.models import layers as jlayers
from mvp_benchmark_tpu.ops import pallas_kernels
from mvp_benchmark_tpu_torch.models import layers
from mvp_benchmark_tpu_torch.ops import dispatch, kernels, ref

B, NQ, M = 2, 256, 128


def _inputs(layout, seed=0):
    rng = np.random.default_rng(seed)
    if layout == "bnhd":
        q = rng.standard_normal((B, NQ, 2, 128)).astype(np.float32)
        k = rng.standard_normal((B, M, 2, 128)).astype(np.float32)
        v = rng.standard_normal((B, M, 2, 128)).astype(np.float32)
    else:
        q = rng.standard_normal((B, NQ, 512)).astype(np.float32)
        k = rng.standard_normal((B, M, 512)).astype(np.float32)
        v = rng.random((B, M, 3), dtype=np.float64).astype(np.float32)
    return q, k, v, 1.0 / np.sqrt(q.shape[-1])


def _pallas(layout, q, k, v, scale, dtype):
    cast = lambda x: jnp.asarray(x).astype(dtype)
    if layout == "bnhd":
        out = pallas_kernels.fused_attention_bnhd(cast(q), cast(k), cast(v), scale)
        return np.asarray(out.astype(jnp.float32))
    vp = np.pad(v, ((0, 0), (0, 0), (0, 125)))
    out = pallas_kernels.fused_attention(cast(q), cast(k), cast(vp), scale)
    return np.asarray(out.astype(jnp.float32))[..., :3]


def _port(layout, q, k, v, scale, dtype):
    fn = ref.attention_bnhd if layout == "bnhd" else ref.attention
    t = lambda x: torch.from_numpy(x).to(dtype)
    out = fn(t(q), t(k), t(v), scale)
    assert out.dtype == dtype
    return out.to(torch.float32).numpy()


def _normwise(got, want):
    return float(np.linalg.norm((got - want).astype(np.float64))
                 / np.linalg.norm(want.astype(np.float64)))


@pytest.mark.parametrize("layout", ["bnhd", "bnd_svd_head"])
def test_bf16_matches_pallas_interpret(layout):
    q, k, v, scale = _inputs(layout)
    want = _pallas(layout, q, k, v, scale, jnp.bfloat16)
    got = _port(layout, q, k, v, scale, torch.bfloat16)
    assert got.shape == want.shape
    assert (np.abs(got - want) <= 2.0 ** -7 * np.abs(want)).all()
    assert _normwise(got, want) < 1e-4


@pytest.mark.parametrize("layout", ["bnhd", "bnd_svd_head"])
def test_fp32_matches_pallas_interpret_at_its_bf16_roundings(layout):
    q, k, v, scale = _inputs(layout, seed=1)
    want = _pallas(layout, q, k, v, scale, jnp.float32)
    got = _port(layout, q, k, v, scale, torch.float32)
    assert _normwise(got, want) < 1e-2


@pytest.mark.parametrize("layout", ["bnhd", "bnd_svd_head"])
def test_fp32_matches_the_jax_cpu_path(layout):
    """The JAX package's fp32 attention (``layers.attention``, the path its
    CPU backend takes for fp32 operands) over (..., N, d)."""
    q, k, v, scale = _inputs(layout, seed=2)
    if layout == "bnhd":
        t = lambda x: jnp.swapaxes(jnp.asarray(x), 1, 2)
        want = np.asarray(jnp.swapaxes(jlayers.attention(t(q), t(k), t(v))[0], 1, 2))
        got = layers.mha_attention_bnhd(*map(torch.from_numpy, (q, k, v))).numpy()
    else:
        want = np.asarray(jlayers.attention(q, k, v)[0])
        got = layers.attention(*map(torch.from_numpy, (q, k, v))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_mha_attention_folds_heads_into_the_batch():
    q, k, v, _ = _inputs("bnhd", seed=3)
    t = lambda x: torch.from_numpy(x)
    got = layers.mha_attention(*(t(x).permute(0, 2, 1, 3) for x in (q, k, v)))
    want = layers.mha_attention_bnhd(t(q), t(k), t(v)).permute(0, 2, 1, 3)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_cpu_tensors_take_the_plain_version_and_the_kernels_refuse_them():
    q, k, v, scale = _inputs("bnhd", seed=4)
    t = lambda x: torch.from_numpy(x).to(torch.bfloat16)
    before = (kernels.ATTENTION_LAUNCHES, kernels.ATTENTION_BNHD_LAUNCHES)
    got = dispatch.attention_bnhd(t(q), t(k), t(v), scale)
    torch.testing.assert_close(got, ref.attention_bnhd(t(q), t(k), t(v), scale),
                               rtol=0, atol=0)
    assert (kernels.ATTENTION_LAUNCHES, kernels.ATTENTION_BNHD_LAUNCHES) == before
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.attention_bnhd_forward(t(q), t(k), t(v), scale)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.attention_forward(t(q[:, :, 0]), t(k[:, :, 0]), t(v[:, :, 0]), scale)


def test_backward_raises_until_the_training_slice():
    ctx = types.SimpleNamespace(kernel="attention_bnhd")
    with pytest.raises(NotImplementedError, match="slice 7"):
        kernels.AttentionBnhdFunction.backward(ctx, None)
