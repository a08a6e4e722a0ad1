"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA card: it carries the ``cuda`` marker and
skips with a reason elsewhere. The module imports neither jax nor anything
that does, so on the card's machine (no jax) it runs as

    python -m pytest tests/test_torch_cuda.py --noconftest -q

(``--noconftest``: ``tests/conftest.py`` sets up jax for the other tests).
"""

import pytest
import torch

import numpy as np

from mvp_benchmark_tpu_torch.metrics import calc_cd
from mvp_benchmark_tpu_torch.ops import dispatch, kernels, ref
from tests.util_clouds import clouds, clouds_with_duplicates

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: a CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _on(device, *arrays):
    return [torch.from_numpy(x).to(device) for x in arrays]


@pytest.mark.parametrize("case", ["2x128x96", "2x96x50", "3x1x2049",
                                  "duplicates"])
def test_chamfer_kernel_equals_plain_version(cuda, case):
    if case == "duplicates":
        a, b = _on(cuda, *clouds_with_duplicates())
    else:
        a, b = _on(cuda, *clouds(3, *map(int, case.split("x"))))
    before = kernels.CHAMFER_LAUNCHES
    got = dispatch.chamfer_distance(a, b)
    torch.cuda.synchronize()
    assert kernels.CHAMFER_LAUNCHES == before + 1
    for g, w in zip(got, ref.chamfer_distance(a, b)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)   # bitwise


def test_calc_cd_on_card_equals_cpu(cuda):
    a, b = clouds(4, 4, 512, 512)
    near = a + 0.01 * b
    got = calc_cd(*_on(cuda, near, a), calc_f1=True)
    want = calc_cd(*_on(torch.device("cpu"), near, a), calc_f1=True)
    for g, w in zip(got, want):
        torch.testing.assert_close(g.cpu(), w, rtol=1e-6, atol=0)


def test_chamfer_wrapper_rejects_bad_inputs(cuda):
    a, b = _on(cuda, *clouds(5, 2, 64, 48))
    with pytest.raises(TypeError, match="float32"):
        kernels.chamfer_forward(a.double(), b)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.chamfer_forward(a.transpose(0, 1).contiguous().transpose(0, 1), b)
    with pytest.raises(ValueError, match="batch mismatch"):
        kernels.chamfer_forward(a, b[:1].contiguous())
    with pytest.raises(ValueError, match=r"\(B, N, 3\)"):
        kernels.chamfer_forward(a[..., :2].contiguous(), b)
    with pytest.raises(ValueError, match="several devices"):
        dispatch.chamfer_distance(a, b.cpu())


def _rand(device, *shape, seed=0):
    rng = np.random.default_rng([seed, *shape])
    return torch.from_numpy(rng.random(shape, dtype=np.float64).astype(np.float32)).to(device)


def _bitwise(got, want):
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.parametrize("B,M,N,C,k", [
    (2, 96, 200, 3, 16), (2, 64, 96, 24, 16), (2, 40, 80, 48, 16),
    (2, 70, 300, 3, 3), (2, 33, 129, 5, 10), (1, 50, 60, 24, 20),
    (2, 30, 12, 3, 16), (1, 20, 40, 200, 2)])
def test_knn_kernel_equals_plain_version(cuda, B, M, N, C, k):
    q, p = _rand(cuda, B, M, C, seed=1), _rand(cuda, B, N, C, seed=2)
    before = kernels.KNN_LAUNCHES
    got = kernels.knn(q, p, k)
    torch.cuda.synchronize()
    assert kernels.KNN_LAUNCHES == before + 1
    _bitwise(got, ref.knn(q, p, k))


def test_knn_kernel_ties_go_to_the_lower_index(cuda):
    p = _rand(cuda, 2, 3000, 3, seed=3)
    p[:, 2500:2600] = p[:, 0:100]       # copies in another shared tile
    p[:, 10:20] = p[:, 30:40]           # and in the same one
    q = torch.cat([p[:, :200], _rand(cuda, 2, 50, 3, seed=4)], 1)
    got = kernels.knn(q.contiguous(), p, 16)
    _bitwise(got, ref.knn(q, p, 16))
    # rows 40..99: self, then the copy in the far tile
    assert (got[1][:, 40:100, 1] == torch.arange(2540, 2600, device=cuda)).all()
    # rows 10..19 now hold points 30..39: the lower copy comes first
    assert (got[1][:, 10:20, 0] == torch.arange(10, 20, device=cuda)).all()
    assert (got[1][:, 10:20, 1] == torch.arange(30, 40, device=cuda)).all()


@pytest.mark.parametrize("B,N,S", [(3, 160, 24), (2, 3072, 256), (2, 5000, 40),
                                   (4, 64, 64), (2, 1, 3)])
def test_fps_kernel_equals_plain_version(cuda, B, N, S):
    x = _rand(cuda, B, N, 3, seed=5)
    before = kernels.FPS_LAUNCHES
    got = kernels.furthest_point_sample(x, S)
    torch.cuda.synchronize()
    assert kernels.FPS_LAUNCHES == before + 1
    _bitwise([got], [ref.furthest_point_sample(x, S)])


def test_fps_kernel_duplicates(cuda):
    x = _rand(cuda, 2, 1100, 3, seed=6)
    x[:, 550:] = x[:, :550]
    _bitwise([kernels.furthest_point_sample(x, 600)],
             [ref.furthest_point_sample(x, 600)])


@pytest.mark.parametrize("C", [3, 24, 120, 360])
def test_gather_kernels_equal_plain_versions(cuda, C):
    f = _rand(cuda, 2, 300, C, seed=7)
    g = torch.Generator().manual_seed(C)
    idx2 = torch.randint(0, 300, (2, 100), generator=g, dtype=torch.int32).to(cuda)
    idx3 = torch.randint(0, 300, (2, 100, 16), generator=g, dtype=torch.int32).to(cuda)
    w = _rand(cuda, 2, 100, 3, seed=8)
    counts = kernels.launch_counts()
    _bitwise([kernels.gather_rows(f, idx2)], [ref.gather_points(f, idx2)])
    _bitwise([kernels.gather_rows(f, idx3)], [ref.grouping_operation(f, idx3)])
    _bitwise(kernels.group_max_forward(f, idx3), ref.group_max(f, idx3))
    _bitwise([kernels.three_interpolate_forward(f, idx3[..., :3].contiguous(), w)],
             [ref.three_interpolate(f, idx3[..., :3], w)])
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    assert after["gather"] == counts["gather"] + 2
    assert after["group_max"] == counts["group_max"] + 1
    assert after["three_interpolate"] == counts["three_interpolate"] + 1


def test_gather_kernels_on_unaligned_tables(cuda):
    """A table that starts 4 bytes into its storage takes the scalar path."""
    f = torch.empty(2 * 50 * 24 + 1, device=cuda)[1:].view(2, 50, 24)
    f.copy_(_rand(cuda, 2, 50, 24, seed=9))
    idx = torch.randint(0, 50, (2, 30, 4), dtype=torch.int32,
                        generator=torch.Generator().manual_seed(0)).to(cuda)
    _bitwise([kernels.gather_rows(f, idx)], [ref.gather_points(f, idx)])
    _bitwise(kernels.group_max_forward(f, idx), ref.group_max(f, idx))


def test_group_max_kernel_ties_take_the_lowest_slot(cuda):
    f = torch.zeros(1, 10, 8, device=cuda)
    f[0, 3] = 1.0
    idx = torch.tensor([[[0, 3, 5, 3], [1, 2, 4, 6]]], dtype=torch.int32, device=cuda)
    out, slot = kernels.group_max_forward(f, idx)
    _bitwise((out, slot), ref.group_max(f, idx))
    assert (slot[0, 0] == 1).all() and (slot[0, 1] == 0).all()


def test_new_wrappers_reject_bad_inputs(cuda):
    q = _rand(cuda, 2, 16, 3)
    with pytest.raises(TypeError, match="float32"):
        kernels.knn(q.double(), q, 4)
    with pytest.raises(ValueError, match="channel mismatch"):
        kernels.knn(q, _rand(cuda, 2, 16, 4), 4)
    with pytest.raises(ValueError, match="limit 32"):
        kernels.knn(_rand(cuda, 1, 8, 3), _rand(cuda, 1, 64, 3), 33)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.knn(q.transpose(0, 1).contiguous().transpose(0, 1), q, 4)
    with pytest.raises(ValueError, match="limit 16384"):
        kernels.furthest_point_sample(_rand(cuda, 1, 16385, 3), 4)
    idx = torch.zeros(2, 5, 3, dtype=torch.int64, device=cuda)
    with pytest.raises(TypeError, match="int32"):
        kernels.gather_rows(q, idx)
    with pytest.raises(ValueError, match="batch mismatch"):
        kernels.group_max_forward(q, idx[:1].int())
    with pytest.raises(ValueError, match=r"\(B, N, 3\)"):
        kernels.three_interpolate_forward(q, idx.int(), _rand(cuda, 2, 5, 2))
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.gather_rows(q, idx.int().cpu())
    with pytest.raises(ValueError, match="several devices"):
        dispatch.three_interpolate(q, idx.int(), _rand(cuda, 2, 5, 3).cpu())


def test_out_of_range_indices_give_nan_not_a_fault(cuda):
    f = _rand(cuda, 1, 10, 8)
    idx = torch.tensor([[[0, 10, 2], [1, 2, -1]]], dtype=torch.int32, device=cuda)
    out, slot = kernels.group_max_forward(f, idx)
    g = kernels.gather_rows(f, idx)
    torch.cuda.synchronize()
    assert torch.isnan(out).all() and (slot == -1).all()
    assert torch.isnan(g[0, 0, 1]).all() and torch.isfinite(g[0, 0, 0]).all()


def test_ecg_on_card_equals_cpu(cuda):
    """A small ECG val batch through every kernel: out1 as PCN's bar; out2
    through the kNN and FPS of activations that cuBLAS and the CPU round
    differently, so its points are held as a cloud, with chip_smoke.py's bar
    (check_ecg_batch_on_cpu): at most 2% of either cloud's points further
    than a tenth of the mean spacing from the other."""
    from mvp_benchmark_tpu_torch.models import get_model
    from mvp_benchmark_tpu_torch.train.config import Config

    cfg = Config(model_name="ecg", num_points=256, loss="cd", eval_emd=False)
    model = get_model("ecg", cfg, generator=torch.Generator().manual_seed(0)).eval()
    x, gt = (_rand(torch.device("cpu"), 2, 256, 3, seed=s) for s in (10, 11))
    with torch.inference_mode():
        want = model(x, gt, prefix="val")
    model.to(cuda)
    kernels.reset_launch_counts()
    with torch.inference_mode():
        got = model(x.to(cuda), gt.to(cuda), prefix="val")
        torch.cuda.synchronize()
    assert kernels.launch_counts() == {"chamfer": 1, "knn": 10, "fps": 4,
                                       "gather": 11, "group_max": 3,
                                       "three_interpolate": 3, "sa_attention": 0}
    torch.testing.assert_close(got["out1"].cpu(), want["out1"], rtol=1e-4, atol=1e-5)
    spacing = float(ref.knn(want["out2"], want["out2"], 2)[0][..., 1].sqrt().mean())
    d1, d2, _, _ = ref.chamfer_distance(got["out2"].cpu(), want["out2"])
    for d in (d1, d2):
        assert float((d.sqrt() > 0.1 * spacing).float().mean()) <= 0.02


def _sa_inputs(device, B, N, k, rel, mid, share=8, seed=0):
    """Unit-scale proj/x1 in [-0.5, 0.5), weights at torch's init scale."""
    ms = mid // share
    proj = _rand(device, B, N, rel + mid, seed=seed) - 0.5
    x1 = _rand(device, B, N, rel, seed=seed + 1) - 0.5
    idx = torch.randint(0, N, (B, N, k), dtype=torch.int32,
                        generator=torch.Generator().manual_seed(seed)).to(device)
    b1, b2 = ((1 + k) * rel) ** -0.5, ms ** -0.5
    W1 = (_rand(device, (1 + k) * rel, ms, seed=seed + 2) * 2 - 1) * b1
    W2 = (_rand(device, ms, k * ms, seed=seed + 3) * 2 - 1) * b2
    bias = (_rand(device, k * ms, seed=seed + 4) * 2 - 1) * b2
    return proj, x1, idx, W1, W2, bias


def _within_sa_tolerance(got, want):
    """|kernel - plain| <= 1e-5 + 1e-4 |plain| (the kernel sums in another
    order than the plain version's matmuls)."""
    assert got.shape == want.shape and got.dtype == want.dtype
    assert bool(((got - want).abs() <= 1e-5 + 1e-4 * want.abs()).all()), \
        float((got - want).abs().max())


@pytest.mark.parametrize("B,N,k,rel,mid", [
    (2, 3072, 16, 4, 16), (2, 1536, 16, 8, 32), (2, 768, 16, 16, 64),
    (2, 384, 16, 32, 128), (3, 97, 8, 4, 16), (1, 50, 32, 32, 128),
    (2, 33, 1, 16, 64)])
def test_sa_attention_kernel_matches_plain_version(cuda, B, N, k, rel, mid):
    args = _sa_inputs(cuda, B, N, k, rel, mid)
    before = kernels.SA_ATTENTION_LAUNCHES
    got = kernels.sa_attention_forward(*args, rel, mid, 8)
    torch.cuda.synchronize()
    assert kernels.SA_ATTENTION_LAUNCHES == before + 1
    _within_sa_tolerance(got, ref.sa_attention(*args, rel, mid, 8))


def test_sa_attention_wrapper_rejects_bad_inputs(cuda):
    proj, x1, idx, W1, W2, b2 = _sa_inputs(cuda, 2, 40, 8, 8, 32)
    with pytest.raises(ValueError, match="built for"):
        kernels.sa_attention_forward(proj, x1, idx, W1, W2, b2, 8, 32, 4)
    with pytest.raises(ValueError, match="limits"):
        big = torch.zeros(2, 40, 33, dtype=torch.int32, device=cuda)
        kernels.sa_attention_forward(proj, x1, big, W1, W2, b2, 8, 32, 8)
    with pytest.raises(ValueError, match="W2 must be"):
        kernels.sa_attention_forward(proj, x1, idx, W1, W2[:, :8].contiguous(),
                                     b2, 8, 32, 8)
    with pytest.raises(TypeError, match="int32"):
        kernels.sa_attention_forward(proj, x1, idx.long(), W1, W2, b2, 8, 32, 8)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.sa_attention_forward(proj, x1, idx, W1.cpu(), W2, b2, 8, 32, 8)
    with pytest.raises(ValueError, match="several devices"):
        dispatch.sa_attention(proj, x1, idx, W1.cpu(), W2, b2, 8, 32, 8)


def test_sa_attention_out_of_range_index_gives_nan(cuda):
    proj, x1, idx, W1, W2, b2 = _sa_inputs(cuda, 1, 20, 8, 4, 16)
    idx[0, 3, 5] = 20
    idx[0, 7, 0] = -1
    out = kernels.sa_attention_forward(proj, x1, idx, W1, W2, b2, 4, 16, 8)
    torch.cuda.synchronize()
    assert torch.isnan(out[0, 3]).all() and torch.isnan(out[0, 7]).all()
    assert torch.isfinite(out[0, :3]).all()


def test_vrcnet_on_card_equals_cpu(cuda):
    """A small VRCNet val batch (the smoke config's shape: FPS, score top-k,
    folding) through every kernel, with the same latent noise: out1 at PCN's
    bar; out2 held as a cloud with chip_smoke.py's bar, since its points pass
    through the FPS and top-k of activations that cuBLAS and the CPU round
    differently."""
    from mvp_benchmark_tpu_torch.models import get_model
    from mvp_benchmark_tpu_torch.train import engine
    from mvp_benchmark_tpu_torch.train.config import Config

    cfg = Config(model_name="vrcnet", num_points=128, loss="cd", eval_emd=False,
                 layers="1, 1, 1, 1", knn_list="8", pk=6, points_label=True,
                 local_folding=True, num_coarse_raw=64, num_fps=128,
                 num_coarse=64)
    model = get_model("vrcnet", cfg, generator=torch.Generator().manual_seed(0)).eval()
    x, gt = (_rand(torch.device("cpu"), 2, 128, 3, seed=s) for s in (12, 13))
    eps = engine.latent_noise(model, 2)
    with torch.inference_mode():
        want = model(x, gt, prefix="val", eps=eps)
    model.to(cuda)
    kernels.reset_launch_counts()
    with torch.inference_mode():
        got = model(x.to(cuda), gt.to(cuda), prefix="val", eps=eps.to(cuda))
        torch.cuda.synchronize()
    assert kernels.launch_counts() == {"chamfer": 1, "knn": 7, "fps": 4,
                                       "gather": 10, "group_max": 3,
                                       "three_interpolate": 3, "sa_attention": 4}
    torch.testing.assert_close(got["out1"].cpu(), want["out1"], rtol=1e-4, atol=1e-5)
    spacing = float(ref.knn(want["out2"], want["out2"], 2)[0][..., 1].sqrt().mean())
    d1, d2, _, _ = ref.chamfer_distance(got["out2"].cpu(), want["out2"])
    for d in (d1, d2):
        assert float((d.sqrt() > 0.1 * spacing).float().mean()) <= 0.02
