"""Furthest point sampling of the torch port (``ref.furthest_point_sample``)
against the JAX package, on the CPU.

The plain version is the contract of ``csrc/fps.cu`` (held against it on the
card in ``test_torch_cuda.py`` and ``chip_smoke.py``). Here it is held
against ``jnp_ref``, the Pallas kernel in interpret mode (as
``test_pallas_kernels.py`` runs it) and the oracle ``util_np.fps_np``.
Indices must be exactly equal (BASELINE.md's bar for FPS). Inputs are seeded
numpy, fp32; the duplicate case makes the min-distance buffer tie exactly
(zeros), where every version must take the lowest index.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvp_benchmark_tpu.ops import jnp_ref, pallas_kernels
from mvp_benchmark_tpu_torch import probe_knn_fps
from mvp_benchmark_tpu_torch.ops import dispatch, kernels, ref
from tests.util_np import fps_np


def _cloud(seed, B, N):
    rng = np.random.default_rng(seed)
    return rng.random((B, N, 3), dtype=np.float64).astype(np.float32)


def _duplicates():
    x = _cloud(4, 2, 64)
    x[:, 32:] = x[:, :32]            # every point twice
    x[:, 5] = x[:, 40]
    return x


def _port(x, s):
    return ref.furthest_point_sample(torch.from_numpy(x), s).numpy()


@pytest.mark.parametrize("case", ["3x160->24", "2x200->200", "1x96->1",
                                  "duplicates->64"])
def test_ref_matches_jnp_ref_pallas_and_oracle(case):
    name, s = case.split("->")
    s = int(s)
    x = _duplicates() if name == "duplicates" else _cloud(
        0, *map(int, name.split("x")))
    got = _port(x, s)
    assert got.dtype == np.int32 and got.shape == (x.shape[0], s)
    assert (got[:, 0] == 0).all()
    np.testing.assert_array_equal(got, np.asarray(jnp_ref.furthest_point_sample(x, s)))
    np.testing.assert_array_equal(
        got, np.asarray(pallas_kernels.furthest_point_sample(jnp.asarray(x), s)))
    np.testing.assert_array_equal(got, fps_np(x, s))


def test_duplicates_take_the_lowest_index():
    x = _duplicates()
    got = _port(x, 64)
    # The cloud holds 32 distinct positions. Once one point of each is chosen
    # the whole buffer is 0, and a first-maximum argmax takes index 0.
    for b in range(2):
        assert len(set(got[b, :32].tolist())) == 32
    assert (got[:, 32:] == 0).all()


def test_all_points_selected_once_when_s_equals_n():
    x = _cloud(2, 2, 200)
    got = _port(x, 200)
    for b in range(2):
        assert sorted(got[b].tolist()) == list(range(200))


def test_cpu_dispatch_takes_plain_version(monkeypatch):
    def no_kernel(*args):
        raise AssertionError("CPU tensors must not reach ops/kernels.py")

    monkeypatch.setattr(kernels, "furthest_point_sample", no_kernel)
    x = torch.from_numpy(_cloud(1, 2, 50))
    before = kernels.FPS_LAUNCHES
    torch.testing.assert_close(dispatch.furthest_point_sample(x, 20),
                               ref.furthest_point_sample(x, 20), rtol=0, atol=0)
    assert kernels.FPS_LAUNCHES == before


def test_kernel_wrapper_rejects_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.furthest_point_sample(torch.from_numpy(_cloud(1, 1, 16)), 4)


@pytest.mark.parametrize("shape", probe_knn_fps.FPS_SHAPES,
                         ids=[s[0] for s in probe_knn_fps.FPS_SHAPES])
def test_fps_plan_at_path_shapes(shape):
    """fps.cu's launch plan at every shape the driven paths launch: an
    instantiated PER within its register bound on the threads, the points
    covered, the staged cloud within shared memory, the same plan for the
    same shape."""
    _, B, N, S = shape
    threads, per = kernels.fps_plan(B, N, S)
    assert per in kernels.FPS_PERS and threads % 32 == 0
    assert 32 <= threads <= kernels.fps_max_threads(per)
    assert threads * per >= N
    assert kernels.fps_smem_bytes(N) <= kernels.MAX_SMEM
    assert kernels.fps_plan(B, N, S) == (threads, per)


def test_fps_plan_limits_over_sizes():
    for N in (1, 2, 31, 32, 33, 100, 1000, 4097, 8192, 8193, 12288, 12289,
              16383, 16384):
        threads, per = kernels.fps_plan(4, N, 8)
        assert per in kernels.FPS_PERS and threads % 32 == 0
        assert threads <= kernels.fps_max_threads(per)
        assert threads * per >= N
        assert kernels.fps_smem_bytes(N) <= kernels.MAX_SMEM
    with pytest.raises(ValueError, match="limit"):
        kernels.fps_plan(1, kernels.FPS_MAX_N + 1, 4)
