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

Gradients: the fp32 ones of ``ref.attention``/``attention_bnhd`` under
autograd against JAX's autodiff of its dense fp32 paths (``layers.attention``
and ``svd_head``'s einsum form, ``dcp.py:306-314``) within 1e-5 + 1e-4 |x|;
``ref.attention_backward`` (the split backward's arithmetic, the CUDA
backward's contract) against autograd of the plain forward, fp32 within the
same bar and bf16 normwise 1e-2 (it rounds p and ds where the forward's
autograd does not: 3.4e-3 measured); and both dtypes against the Pallas
backwards in interpret mode, normwise 1e-2 (they round every operand to
bf16): ``fused_attention_bnhd``'s at the bnhd shape and ``fused_attention``'s
split backward at B 2, Nq 256, M 128, D 512 with v zero-padded to 128 lanes.

The CUDA kernels are held against these plain versions on the card
(``test_torch_cuda.py``, ``chip_smoke.py``).
"""

import jax
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


def _row_stats(q, k, scale):
    """The forward's final row max and row sum, fp32, over (B, N, D) or
    (B, N, H, D) (then (B, H, Nq))."""
    if q.dim() == 4:
        q, k = q.transpose(1, 2), k.transpose(1, 2)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    m = s.amax(-1)
    return m, torch.exp(s - m[..., None]).sum(-1)


def _cotangent(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert (np.abs(got - want) <= 1e-5 + 1e-4 * np.abs(want)).all(), \
        float(np.abs(got - want).max())


@pytest.mark.parametrize("layout", ["bnhd", "bnd_svd_head"])
def test_fp32_gradients_match_the_jax_cpu_path(layout):
    q, k, v, scale = _inputs(layout, seed=5)
    g = _cotangent(q.shape[:-1] + (v.shape[-1],), 6)
    if layout == "bnhd":
        sw = lambda x: jnp.swapaxes(x, 1, 2)
        dense = lambda q, k, v: sw(jlayers.attention(sw(q), sw(k), sw(v))[0])
        port = layers.mha_attention_bnhd
    else:
        def dense(q, k, v):   # svd_head's fp32 form (dcp.py:306-314)
            s = jnp.einsum("bnd,bmd->bnm", q, k,
                           preferred_element_type=jnp.float32) / np.sqrt(q.shape[-1])
            return jnp.einsum("bnm,bmc->bnc", jax.nn.softmax(s, axis=2), v,
                              preferred_element_type=jnp.float32)
        port = layers.attention
    _, vjp = jax.vjp(dense, q, k, v)
    want = vjp(jnp.asarray(g))
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    port(qt, kt, vt).backward(torch.from_numpy(g))
    for x, w in zip((qt, kt, vt), want):
        _close(x.grad, w)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["bnhd", "bnd_svd_head"])
def test_backward_plain_equals_autograd_of_the_forward(layout, dtype):
    dt = getattr(torch, dtype)
    q, k, v, scale = (torch.from_numpy(x).to(dt) if isinstance(x, np.ndarray) else x
                      for x in _inputs(layout, seed=7))
    fwd = ref.attention_bnhd if layout == "bnhd" else ref.attention
    xs = [x.clone().requires_grad_() for x in (q, k, v)]
    o = fwd(*xs, scale)
    g = torch.from_numpy(_cotangent(tuple(o.shape), 8)).to(dt)
    want = torch.autograd.grad(o, xs, g)
    got = ref.attention_backward(q, k, v, o.detach(), *_row_stats(q, k, scale), g, scale)
    for a, w in zip(got, want):
        assert a.dtype == w.dtype == dt and a.shape == w.shape
        if dt == torch.float32:
            _close(a, w)
        else:
            assert _normwise(a.float().numpy(), w.float().numpy()) < 1e-2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["bnhd", "bnd_svd_head"])
def test_backward_matches_pallas_interpret(layout, dtype):
    """bnhd: ``fused_attention_bnhd``'s backward (B 2, Nq 256, M 128, H 2,
    dk 128); the svd head: ``fused_attention``'s split backward (D 512, v
    zero-padded to 128 lanes), both in interpret mode."""
    q, k, v, scale = _inputs(layout, seed=9)
    g = _cotangent(q.shape[:-1] + (v.shape[-1],), 10)
    jdt = getattr(jnp, dtype)
    cast = lambda x: jnp.asarray(x).astype(jdt)
    if layout == "bnhd":
        _, vjp = jax.vjp(lambda q, k, v: pallas_kernels.fused_attention_bnhd(q, k, v, scale),
                         cast(q), cast(k), cast(v))
        want = vjp(cast(g))
    else:
        pad = ((0, 0), (0, 0), (0, 125))
        _, vjp = jax.vjp(lambda q, k, v: pallas_kernels.fused_attention(q, k, v, scale),
                         cast(q), cast(k), cast(np.pad(v, pad)))
        want = vjp(cast(np.pad(g, pad)))
        want = (want[0], want[1], want[2][..., :3])
    dt = getattr(torch, dtype)
    qt, kt, vt, gt = (torch.from_numpy(x).to(dt) for x in (q, k, v, g))
    o = (ref.attention_bnhd if layout == "bnhd" else ref.attention)(qt, kt, vt, scale)
    got = ref.attention_backward(qt, kt, vt, o, *_row_stats(qt, kt, scale), gt, scale)
    for a, w in zip(got, want):
        w = np.asarray(w.astype(jnp.float32))
        assert a.shape == w.shape
        assert _normwise(a.float().numpy(), w) < 1e-2
