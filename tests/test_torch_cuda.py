"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA card: it carries the ``cuda`` marker and
skips with a reason elsewhere. The module imports neither jax nor anything
that does, so on the card's machine (no jax) it runs as

    python -m pytest tests/test_torch_cuda.py --noconftest -q

(``--noconftest``: ``tests/conftest.py`` sets up jax for the other tests).
"""

import math

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
                                  "duplicates", "64x1024x2048", "64x3072x2048",
                                  "3x1001x2049", "2x2050x777", "2x3000x2100",
                                  "duplicates_2x2100x2300"])
def test_chamfer_kernel_equals_plain_version(cuda, case):
    """dist and idx bitwise: small and ragged shapes (no multiple of 8 rows
    a lane, 32 columns a step, 256 rows a block, two 2048-column tiles),
    the VRCNet step's shapes, and exact ties in both clouds, run twice."""
    if case == "duplicates":
        a, b = _on(cuda, *clouds_with_duplicates())
    elif case.startswith("duplicates_"):
        a, b = _on(cuda, *clouds_with_duplicates(*map(int, case[11:].split("x"))))
    else:
        a, b = _on(cuda, *clouds(3, *map(int, case.split("x"))))
    before = kernels.CHAMFER_LAUNCHES
    got = dispatch.chamfer_distance(a, b)
    torch.cuda.synchronize()
    assert kernels.CHAMFER_LAUNCHES == before + 1
    for g, w in zip(got, ref.chamfer_distance(a, b)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)   # bitwise
    _bitwise(kernels.chamfer_forward(a, b), kernels.chamfer_forward(a, b))


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


def _bitwise_nan(got, want):
    """NaN at the same places (a kernel's NaN and the CPU's differ in their
    bits), bitwise equal elsewhere."""
    assert got.shape == want.shape and got.dtype == want.dtype == torch.float32
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    _bitwise([got[~nan].view(torch.int32)], [want[~nan].view(torch.int32)])


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


@pytest.mark.parametrize("B,M,N,C,k", [
    (64, 384, 384, 3, 16), (64, 768, 384, 3, 3), (32, 256, 1024, 3, 16),
    (32, 64, 64, 48, 16), (32, 2048, 2048, 3, 20), (32, 2048, 2048, 3, 12),
    (3264, 24, 24, 3, 2)])
def test_knn_kernel_at_path_shapes_twice(cuda, B, M, N, C, k):
    """Path shapes of either kernel and of short scans, and DCP's and IDAM's
    k: equal to the plain version, and two runs bitwise equal."""
    p = _rand(cuda, B, N, C, seed=8)
    q = p if M == N else _rand(cuda, B, M, C, seed=9)
    first = kernels.knn(q, p, k)
    _bitwise(first, ref.knn(q, p, k))
    _bitwise(kernels.knn(q, p, k), first)


@pytest.mark.parametrize("B,M,N,C,k", [(2, 300, 1500, 3, 16), (2, 130, 700, 3, 3),
                                       (2, 90, 400, 24, 16), (1, 64, 200, 48, 16),
                                       (2, 70, 300, 3, 20), (1, 40, 90, 7, 5)])
def test_knn_every_plan_equals_plain_version(cuda, B, M, N, C, k):
    """Every launch plan knn.cu takes (the direct kernel, the queue kernel at
    each row count), on points with exact copies on both sides of each
    candidate tile's boundary."""
    from mvp_benchmark_tpu_torch.probe_knn_fps import knn_plans
    p = _rand(cuda, B, N, C, seed=10)
    tile = kernels.knn_tile_points(C, N)
    for j in range(tile, N, tile):
        p[:, j:j + 3] = p[:, j - 3:j]
    q = torch.cat([p[:, :M // 2], _rand(cuda, B, M - M // 2, C, seed=11)], 1)
    want = ref.knn(q, p, k)
    for plan in knn_plans(B, M, N, C, k):
        _bitwise(kernels._knn_launch(q, p, min(k, N), plan), want)


@pytest.mark.parametrize("B,N,S", [(64, 3072, 2048), (32, 1024, 51), (5, 700, 300)])
def test_fps_every_plan_equals_plain_version(cuda, B, N, S):
    """Every (threads, points a thread) fps.cu takes, with each
    point duplicated at a distant index, and two runs of the planned launch
    bitwise equal."""
    from mvp_benchmark_tpu_torch.probe_knn_fps import fps_plans
    x = _rand(cuda, B, N, 3, seed=12)
    x[:, N // 2:2 * (N // 2)] = x[:, :N // 2]
    want = ref.furthest_point_sample(x, S)
    for plan in fps_plans(N):
        _bitwise([kernels._fps_launch(x, S, plan)], [want])
    first = kernels.furthest_point_sample(x, S)
    _bitwise([kernels.furthest_point_sample(x, S)], [first])


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
    assert torch.isnan(out).all() and (slot == 255).all()
    assert torch.isnan(g[0, 0, 1]).all() and torch.isfinite(g[0, 0, 0]).all()


_NO_LAUNCHES = dict.fromkeys(kernels.launch_counts(), 0)


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
    assert kernels.launch_counts() == dict(_NO_LAUNCHES, chamfer=1, knn=10, fps=4,
                                           gather=11, group_max=3,
                                           three_interpolate=3)
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
    assert kernels.launch_counts() == dict(_NO_LAUNCHES, chamfer=1, knn=7, fps=4,
                                           gather=10, group_max=3,
                                           three_interpolate=3, sa_attention=4)
    torch.testing.assert_close(got["out1"].cpu(), want["out1"], rtol=1e-4, atol=1e-5)
    spacing = float(ref.knn(want["out2"], want["out2"], 2)[0][..., 1].sqrt().mean())
    d1, d2, _, _ = ref.chamfer_distance(got["out2"].cpu(), want["out2"])
    for d in (d1, d2):
        assert float((d.sqrt() > 0.1 * spacing).float().mean()) <= 0.02


# ---------------------------------------------------------------------------
# Backward kernels: each a gather over the reverse list of its index in a
# fixed order, with no float atomics, so two runs are bitwise equal. Their
# plain versions scatter with the card's atomic index_add_, whose order
# changes from run to run, so each kernel is held within 1e-5 + 1e-4 |plain|
# of them (the SA block's weight gradients, sums over every point, within
# 1e-5 + 1e-4 max|plain|); scatter_add_rows also bitwise against its plain
# version run on CPU copies, which adds in ascending order as it does.
# ---------------------------------------------------------------------------


def _close(got, want, normwise=False):
    assert got.shape == want.shape and got.dtype == want.dtype
    scale = want.abs().max() if normwise else want.abs()
    diff = (got - want).abs()
    assert bool((diff <= 1e-5 + 1e-4 * scale).all()), float(diff.max())


def _cot(device, *shape, seed=0, positive=False):
    """Cotangents in [-1, 1), or [0, 1) where thousands add into one row."""
    u = _rand(device, *shape, seed=seed)
    return u if positive else u * 2 - 1


@pytest.mark.parametrize("case", ["2x2048x3072_db", "2x128x96_both", "collapsed",
                                  "chunks_2x5000x300_db"])
def test_chamfer_backward_kernel_matches_plain_version(cuda, case):
    """The last case lists gt's 5000 argmins in two chunks."""
    B, N, M = {"2x2048x3072_db": (2, 2048, 3072), "2x128x96_both": (2, 128, 96),
               "collapsed": (2, 1024, 700), "chunks_2x5000x300_db": (2, 5000, 300)}[case]
    a, b = _on(cuda, *clouds(6, B, N, M))
    if case == "collapsed":              # 600 predicted points on one spot
        b[:, :600] = b[:, :1]
    need_a = not case.endswith("_db")
    d1, d2, i1, i2 = kernels.chamfer_forward(a, b)
    g1 = _cot(cuda, *d1.shape, seed=1, positive=case == "collapsed")
    g2 = _cot(cuda, *d2.shape, seed=2, positive=case == "collapsed")
    before = kernels.CHAMFER_BWD_LAUNCHES
    got = kernels.chamfer_backward(a, b, i1, g1, i2, g2, need_a, True)
    torch.cuda.synchronize()
    assert kernels.CHAMFER_BWD_LAUNCHES == before + 1 + need_a
    want = ref.chamfer_backward(a, b, i1, g1, i2, g2, need_a, True)
    assert (got[0] is None) == (not need_a)
    for g, w in zip(got, want):
        if w is not None:
            _close(g, w)
    cpu = ref.chamfer_backward(*(x.cpu() for x in (a, b, i1, g1, i2, g2)), need_a, True)
    _bitwise([g for g in got if g is not None], [w.to(cuda) for w in cpu if w is not None])


@pytest.mark.parametrize("case", ["2x3072x64_by_1536", "3x97x5_by_41x7",
                                  "collisions", "list_form_2x3072x24_by_3072x16",
                                  "list_form_collisions"])
def test_scatter_add_rows_kernel_matches_plain_version(cuda, case):
    """Both forms of ``kernels.scatter_plan``: the local one (clouds of at
    most 8192 entries) and the list and gather."""
    shapes = {"2x3072x64_by_1536": (2, 3072, 64, (2, 1536)),
              "3x97x5_by_41x7": (3, 97, 5, (3, 41, 7)),
              "collisions": (2, 2048, 24, (2, 2048)),
              "list_form_2x3072x24_by_3072x16": (2, 3072, 24, (2, 3072, 16)),
              "list_form_collisions": (2, 4096, 8, (2, 4096, 4))}
    B, n, c, idx_shape = shapes[case]
    idx = torch.randint(0, n, idx_shape, dtype=torch.int32,
                        generator=torch.Generator().manual_seed(3)).to(cuda)
    if case.endswith("collisions"):
        idx.fill_(5)
    entries = idx[0].numel()
    assert bool(kernels.scatter_plan(entries, n, c // 4 if c % 4 == 0 else c)[0]) \
        == (not case.startswith("list_form"))
    g = _cot(cuda, *idx_shape, c, seed=4, positive=case.endswith("collisions"))
    before = kernels.SCATTER_LAUNCHES
    got = kernels.scatter_add_rows(g, idx, n)
    torch.cuda.synchronize()
    assert kernels.SCATTER_LAUNCHES == before + 1
    _close(got, ref.scatter_add_rows(g, idx, n))


@pytest.mark.parametrize("B,n,c,m,k", [(2, 3072, 64, 1536, 10), (3, 97, 6, 41, 7),
                                       (1, 4000, 8, 2100, 10)])
def test_group_max_backward_kernel_matches_plain_version_with_ties(cuda, B, n, c,
                                                                   m, k):
    """The last case lists its 21000 entries in two chunks."""
    f = torch.relu(_rand(cuda, B, n, c, seed=5) - 0.5)     # half 0: ties
    idx = torch.randint(0, n, (B, m, k), dtype=torch.int32,
                        generator=torch.Generator().manual_seed(6)).to(cuda)
    idx[:, :, k - 1] = idx[:, :, 0]                         # a row twice
    _, slot = kernels.group_max_forward(f, idx)
    g = _cot(cuda, B, m, c, seed=7)
    got = kernels.group_max_backward(g, idx, slot, n)
    _close(got, ref.group_max_backward(g, idx, slot, n))
    _bitwise([got], [ref.group_max_backward(g.cpu(), idx.cpu(), slot.cpu(), n).to(cuda)])
    # all of each (m, c) goes to its lowest tied slot: the sums are kept
    _close(got.sum(1), g.sum(1))


@pytest.mark.parametrize("case", ["2x1536x128_to_3072", "2x37x5_to_101",
                                  "collisions"])
def test_three_interpolate_backward_kernel_matches_plain_version(cuda, case):
    B, ms, c, n = {"2x1536x128_to_3072": (2, 1536, 128, 3072),
                   "2x37x5_to_101": (2, 37, 5, 101),
                   "collisions": (2, 64, 16, 512)}[case]
    f = _cot(cuda, B, ms, c, seed=8)
    idx, w = ref.three_nn_upsampling(_rand(cuda, B, n, 3, seed=9),
                                     _rand(cuda, B, ms, 3, seed=10))
    if case == "collisions":
        idx = torch.zeros_like(idx)
    g = _cot(cuda, B, n, c, seed=11, positive=case == "collisions")
    for need_w in (False, True):
        got = kernels.three_interpolate_backward(g, idx, w, f, need_w)
        want = ref.three_interpolate_backward(g, idx, w, f, need_w)
        _close(got[0], want[0])
        assert (got[1] is None) == (not need_w)
        if need_w:
            _close(got[1], want[1])


def _ti_plan(form, ms, c, n):
    """The plan of ``kernels.three_interpolate_backward_plan`` a test
    forces: the list form, the one-launch form's, or one whose entries pass
    in chunks of 37 at 2 output vectors a thread."""
    vectors = c // 8 if c % 8 == 0 else c
    if form == "list":
        return 0, 0, 0
    if form == "chunks":
        rows, _, lanes = kernels.three_interpolate_backward_local_plan(ms, c, n, vectors, 2)
        return rows, 37, lanes
    return kernels.three_interpolate_backward_local_plan(ms, c, n, vectors)


@pytest.mark.parametrize("form", ["local", "list", "chunks"])
@pytest.mark.parametrize("case", ["2x1536x128_to_3072", "2x1024x512_to_3072",
                                  "2x37x5_to_101", "whole_cloud_to_row_0",
                                  "out_of_range"])
def test_three_interpolate_backward_forms_bitwise_on_cpu_copies(cuda, monkeypatch, case,
                                                                form):
    """Both forms of the plan (the list in shared memory in one launch, or
    the list in device memory and the gather), and the one-launch form with
    its entries in several chunks: d_features bitwise the plain version on
    CPU copies and a second run; an index outside [0, ms) NaN at row 0 of
    its cloud, the other rows as the plain version of the valid part."""
    B, ms, c, n = {"2x1536x128_to_3072": (2, 1536, 128, 3072),
                   "2x1024x512_to_3072": (2, 1024, 512, 3072),
                   "2x37x5_to_101": (2, 37, 5, 101),
                   "whole_cloud_to_row_0": (2, 64, 16, 512),
                   "out_of_range": (2, 50, 24, 200)}[case]
    f = _cot(cuda, B, ms, c, seed=60)
    idx, w = ref.three_nn_upsampling(_rand(cuda, B, n, 3, seed=61),
                                     _rand(cuda, B, ms, 3, seed=62))
    if case == "whole_cloud_to_row_0":
        idx[1] = 0
    g = _cot(cuda, B, n, c, seed=63)
    ok = idx.cpu().clone()
    if case == "out_of_range":
        idx[0, 7, 1], idx[1, 150, 2] = ms + 3, -1
        ok[0, 7, 1] = ok[1, 150, 2] = 0
    plan = _ti_plan(form, ms, c, n)
    monkeypatch.setattr(kernels, "three_interpolate_backward_plan", lambda *a: plan)
    got, _ = kernels.three_interpolate_backward(g, idx, w, f, False)
    again, _ = kernels.three_interpolate_backward(g, idx, w, f, False)
    want, _ = ref.three_interpolate_backward(g.cpu(), ok, w.cpu(), f.cpu(), False)
    if case == "out_of_range":
        want[:, 0] = float("nan")
    _bitwise_nan(got, want.to(cuda))
    _bitwise([again.view(torch.int32)], [got.view(torch.int32)])


# (B, n rows, c, m points, k): the VRCNet step's three, ECG's three, at two
# clouds
GROUP_MAX_STEP_SHAPES = [(2, 3072, 64, 1536, 10), (2, 1536, 128, 768, 10),
                         (2, 768, 256, 384, 10), (2, 256, 840, 64, 16),
                         (2, 1024, 360, 256, 16), (2, 3072, 120, 1024, 16)]


@pytest.mark.parametrize("B,n,c,m,k,vec,stage", [
    (*shape, vec, stage) for shape in GROUP_MAX_STEP_SHAPES + [
        (2, 300, 24, 100, 1), (2, 300, 24, 100, 17), (2, 300, 8, 40, 255),
        (3, 97, 5, 41, 7), (2, 50, 1, 30, 255)]
    for stage in (kernels.GROUP_MAX_STAGE_SMEM, 0) for vec in (4, 1) if shape[2] % vec == 0])
def test_group_max_forward_plans_bitwise_with_ties_and_nan(cuda, monkeypatch, B, n, c, m,
                                                           k, vec, stage):
    """Both forms of ``kernels.group_max_forward_plan`` (staged in slices as
    wide as fit, k unrolled or looped, and direct; 4 or 1 channels a thread)
    at the steps' shapes, k 1 / 17 / 255 and odd C: the max and the slot bitwise
    ``ref.group_max`` on CPU copies, with exact ties (relu'd features, a
    neighbour twice), a NaN row (at j = 0 it stays, later it is passed
    over) and an out-of-range index (NaN and slot 255 in its row)."""
    f = torch.relu(_rand(cuda, B, n, c, seed=64) - 0.5)
    f[0, 5] = float("nan")
    idx = _idx(cuda, n, (B, m, k), seed=65)
    idx[:, :, k - 1] = idx[:, :, 0]
    idx[0, 3, 0] = 5                                  # NaN at j = 0
    if k > 1:
        idx[0, 4, 1] = 5                              # NaN at j = 1
    idx[1, 2, k // 2] = n + 2
    plan = (vec, 0, 0)                                # direct
    if stage:                                         # staged, however narrow
        plan = (vec, min(c, stage // (4 * n) // vec * vec),
                k if k in kernels.GROUP_MAX_FWD_UNROLLED else 0)
    monkeypatch.setattr(kernels, "group_max_forward_plan", lambda *a: plan)
    out, slot = kernels.group_max_forward(f, idx)
    ok = idx.cpu().clone()
    ok[1, 2, k // 2] = 0
    want, want_slot = ref.group_max(f.cpu(), ok)
    want[1, 2], want_slot[1, 2] = float("nan"), 255
    _bitwise_nan(out, want.to(cuda))
    _bitwise([slot], [want_slot.to(cuda)])
    again = kernels.group_max_forward(f, idx)
    _bitwise([again[0].view(torch.int32), again[1]], [out.view(torch.int32), slot])


@pytest.mark.parametrize("B,N,k,rel,mid", [
    (2, 3072, 16, 4, 16), (2, 1536, 16, 8, 32), (2, 768, 16, 16, 64),
    (2, 384, 16, 32, 128), (3, 97, 8, 4, 16), (2, 100, 32, 32, 128),
    (2, 33, 1, 16, 64)])
def test_sa_attention_backward_kernel_matches_plain_version(cuda, B, N, k, rel, mid):
    args = _sa_inputs(cuda, B, N, k, rel, mid, seed=12)
    g = _cot(cuda, B, N, mid, seed=13)
    before = kernels.SA_ATTENTION_BWD_LAUNCHES
    got = kernels.sa_attention_backward(g, *args, rel, mid, 8)
    torch.cuda.synchronize()
    assert kernels.SA_ATTENTION_BWD_LAUNCHES == before + 1
    want = ref.sa_attention_backward(g, *args, rel, mid, 8)
    for i, (a, b) in enumerate(zip(got, want)):
        _close(a, b, normwise=i >= 2)


def test_sa_attention_backward_collisions_and_the_gradients_asked_for(cuda):
    """Every neighbour is row 3 (k * N atomic adds into one row of d_proj),
    and only dW1 and db2 asked for: the others are None."""
    args = _sa_inputs(cuda, 2, 64, 16, 8, 32, seed=14)
    args[2].fill_(3)
    g = _cot(cuda, 2, 64, 32, seed=15)
    want = ref.sa_attention_backward(g, *args, 8, 32, 8)
    got = kernels.sa_attention_backward(g, *args, 8, 32, 8)
    for i, (a, b) in enumerate(zip(got, want)):
        _close(a, b, normwise=i >= 2)
    some = kernels.sa_attention_backward(g, *args, 8, 32, 8,
                                         need=(False, False, True, False, True))
    assert some[0] is None and some[1] is None and some[3] is None
    _close(some[2], want[2], normwise=True)
    _close(some[4], want[4], normwise=True)


# ---------------------------------------------------------------------------
# The completion backwards in a fixed order: reverse lists, bitwise reruns
# ---------------------------------------------------------------------------


def _idx(device, high, shape, seed):
    return torch.randint(0, high, shape, dtype=torch.int32,
                         generator=torch.Generator().manual_seed(seed)).to(device)


@pytest.mark.parametrize("B,M,k,n,case", [
    (64, 3072, 16, 3072, "random"), (3, 41, 7, 97, "random"),
    (2, 64, 16, 64, "one_row"), (3, 50, 3, 200, "out_of_range"),
    (2, 300, 1, 70000, "random")])
def test_reverse_list_kernel_equals_plain_version(cuda, B, M, k, n, case):
    """reverse_list.cu's list bitwise ``ref.reverse_list``'s at the SA
    block's level 1 (two blocks a cloud), ragged, every entry naming one
    row, entries outside [0, n) (listed under row 0), and 70000 rows (two
    blocks a cloud of one warp)."""
    idx = _idx(cuda, n, (B, M, k), seed=30)
    if case == "one_row":
        idx.fill_(3)
    elif case == "out_of_range":
        idx[0, 0, 0], idx[1, 7, 2], idx[2, 49, 1] = -1, n, n + 5
    got = kernels.reverse_list(idx, n)
    _bitwise(got, ref.reverse_list(idx, n))


def _backward_call(device, name):
    """A call of one of the five backwards at a case of chip_smoke.py's
    phase 3b: VRCNet's train-step shape or its collision case."""
    if name.startswith("chamfer"):
        if name == "chamfer_path":                  # calc_cd(pred, gt): db
            a, b = _on(device, *clouds(40, 64, 2048, 3072))
            need = (False, True)
        else:                                       # 1000 copies of one point
            a, b = _on(device, *clouds(41, 4, 2048, 1024))
            b[:, :1000] = b[:, :1]
            need = (True, True)
        d1, d2, i1, i2 = kernels.chamfer_forward(a, b)
        g1, g2 = _cot(device, *d1.shape, seed=43), _cot(device, *d2.shape, seed=44)
        return lambda: kernels.chamfer_backward(a, b, i1, g1, i2, g2, *need)
    if name.startswith("scatter"):
        B, n, shape, c = {"scatter_path": (64, 3072, (1536,), 64),
                          "scatter_list_path": (32, 3072, (3072, 16), 24)}.get(
                              name, (4, 2048, (2048,), 24))
        idx = _idx(device, n, (B, *shape), seed=45)
        if name == "scatter_collisions":
            idx.fill_(5)
        g = _cot(device, B, *shape, c, seed=46, positive=True)
        return lambda: (kernels.scatter_add_rows(g, idx, n),)
    if name.startswith("group_max"):
        B, n, c, m, k = (64, 3072, 64, 1536, 10) if name == "group_max_path" else (3, 97, 6, 41, 7)
        f = torch.relu(_rand(device, B, n, c, seed=47) - 0.5)
        idx = _idx(device, n, (B, m, k), seed=48)
        idx[:, :, k - 1] = idx[:, :, 0]
        _, slot = kernels.group_max_forward(f, idx)
        g = _cot(device, B, m, c, seed=49)
        return lambda: (kernels.group_max_backward(g, idx, slot, n),)
    if name.startswith("three_interpolate"):
        B, ms, n, c = (64, 1536, 3072, 128) if name == "three_interpolate_path" else (2, 64, 512, 16)
        f = _cot(device, B, ms, c, seed=50)
        idx, w = ref.three_nn_upsampling(_rand(device, B, n, 3, seed=51),
                                         _rand(device, B, ms, 3, seed=52))
        if name != "three_interpolate_path":
            idx = torch.zeros_like(idx)
        g = _cot(device, B, n, c, seed=53)
        return lambda: kernels.three_interpolate_backward(g, idx, w, f, True)
    B, n, k, rel, mid = (64, 3072, 16, 4, 16) if name == "sa_path" else (2, 64, 16, 8, 32)
    args = _sa_inputs(device, B, n, k, rel, mid, seed=54)
    if name != "sa_path":
        args[2].fill_(3)
    g = _cot(device, B, n, mid, seed=55)
    return lambda: kernels.sa_attention_backward(g, *args, rel, mid, 8)


@pytest.mark.parametrize("name", [
    "chamfer_path", "chamfer_collapsed", "scatter_path", "scatter_list_path",
    "scatter_collisions",
    "group_max_path", "group_max_ties", "three_interpolate_path",
    "three_interpolate_collisions", "sa_path", "sa_collisions"])
def test_backward_kernels_rerun_bitwise(cuda, name):
    """Two launches of each completion backward on the same inputs give
    bitwise-equal outputs: no float atomics, every row summed in a fixed
    order."""
    call = _backward_call(cuda, name)
    first, second = call(), call()
    torch.cuda.synchronize()
    first, second = ([x for x in out if x is not None] for out in (first, second))
    assert first and len(first) == len(second)
    _bitwise(first, second)


@pytest.mark.parametrize("k", [1, 16, 32])
@pytest.mark.parametrize("level", range(4))
def test_sa_attention_kernel_at_the_train_step_levels(cuda, level, k):
    """The forward at batch 64 (a VRCNet train step) at each level and k 1,
    16 and 32 (k 32: the plan's smaller blocks at level 4), within 1e-5 +
    1e-4 |plain|, two runs bitwise equal."""
    rel, mid, _ = kernels.SA_LEVELS[level]
    args = _sa_inputs(cuda, 64, 3072 >> level, k, rel, mid, seed=level)
    got = kernels.sa_attention_forward(*args, rel, mid, 8)
    _bitwise([got], [kernels.sa_attention_forward(*args, rel, mid, 8)])
    _within_sa_tolerance(got, ref.sa_attention(*args, rel, mid, 8))


def test_sa_forward_plan_fits_and_matches_the_library(cuda):
    """The forward's host plan: its shared memory is the kernel's, at
    VRCNet's four levels and k 1, 16 and 32, and it launches."""
    lib = kernels.load()
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for rel, mid, ms in kernels.SA_LEVELS:
        for k in (1, 16, 32):
            warps, grid, smem = kernels.sa_forward_plan(64, 384, k, rel, mid, 8, sms)
            assert smem == lib.sa_attention_forward_smem(rel, ms, k, warps)
            assert smem <= kernels.MAX_SMEM and 1 <= grid <= sms


def test_sa_backward_plan_fits_and_matches_the_library(cuda):
    """The host plan's shared memory is the kernel's, at VRCNet's four
    levels and at k 32 on level 4 (the 4-warp fallback)."""
    lib = kernels.load()
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for n, k, rel, mid in ((3072, 16, 4, 16), (1536, 16, 8, 32), (768, 16, 16, 64),
                           (384, 16, 32, 128), (384, 32, 32, 128)):
        warps, grid, smem = kernels.sa_backward_plan(64, n, k, rel, mid, 8, sms)
        assert smem == lib.sa_attention_backward_smem(rel, mid // 8, k, warps * (32 // rel))
        assert smem <= kernels.MAX_SMEM and 1 <= grid


def _step_losses(name):
    """The train losses of chip_smoke.py's completion steps at the smoke
    configs: PCN's calc_cd pair, VRCNet's dual path with its noise drawn
    once, ECG's losses with the uniform terms."""
    if name == "pcn":
        def losses(model, x, gt):
            _, loss2, total = model(x, gt, prefix="train", alpha=0.5)
            return {"loss2": loss2, "total": total}
        return losses
    if name == "ecg":
        def losses(model, x, gt):
            t = model.train_losses(x, gt, 0.5)
            return {k: t[k] for k in ("loss1", "uniform1", "loss2", "uniform2", "total")}
        return losses
    noise = {}

    def losses(model, x, gt):
        if not noise:
            noise.update(model.draw_noise(2, torch.Generator().manual_seed(2)))
        t = model.train_losses(x, gt, 0.5, {k: v.to(x.device) for k, v in noise.items()})
        return {k: t[k] for k in ("loss1", "dl_rec", "dl_g", "total")}
    return losses


@pytest.mark.parametrize("deterministic", [True, False])
@pytest.mark.parametrize("name", ["pcn", "vrcnet", "ecg"])
def test_train_step_on_card_is_bitwise_reproducible(cuda, name, deterministic,
                                                    monkeypatch):
    """Two train steps from the same seed on the same two clouds give
    bitwise-equal losses and parameter gradients, the completion backwards
    summing every row in a fixed order: under
    ``torch.use_deterministic_algorithms(True)`` (inside this test alone),
    so that no PyTorch op's own order can hide a kernel's, and without it,
    as the engine runs the step."""
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    cfg = _smoke_cfg(name)
    points = 512 if name == "ecg" else 128           # ECG's uniform loss needs 512
    cfg.num_points = points
    x, gt = (_rand(torch.device("cpu"), 2, points, 3, seed=s) for s in (56, 57))
    losses = _step_losses(name)
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(deterministic)
    try:
        (l1, g1), (l2, g2) = (_train_step(cfg, cuda, x, gt, losses) for _ in range(2))
    finally:
        torch.use_deterministic_algorithms(was)
    assert l1.keys() == l2.keys() and g1 and len(g1) == len(g2)
    for k in l1:
        assert torch.equal(l1[k], l2[k]), k
    for i, (a, b) in enumerate(zip(g1, g2)):
        assert torch.equal(a, b), i


def test_backward_wrappers_reject_bad_inputs(cuda):
    a, b = _on(cuda, *clouds(7, 2, 64, 48))
    d1, d2, i1, i2 = kernels.chamfer_forward(a, b)
    with pytest.raises(ValueError, match="i1/g1 must be"):
        kernels.chamfer_backward(a, b, i1, d1, i2, d1)
    with pytest.raises(TypeError, match="int32"):
        kernels.chamfer_backward(a, b, i1.long(), d1, i2, d2)
    g = _rand(cuda, 2, 10, 4)
    idx = torch.zeros(2, 10, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="idx's shape"):
        kernels.scatter_add_rows(g, idx[:, :5].contiguous(), 20)
    with pytest.raises(ValueError, match="num_rows"):
        kernels.scatter_add_rows(g, idx, 0)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.scatter_add_rows(g, idx.cpu(), 20)
    slot = torch.zeros(2, 10, 4, dtype=torch.uint8, device=cuda)
    idx3 = torch.zeros(2, 10, 3, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError, match="uint8"):
        kernels.group_max_backward(g, idx3, slot.int(), 20)
    with pytest.raises(ValueError, match="slot must be"):
        kernels.group_max_backward(g, idx3, slot[:, :, :2].contiguous(), 20)
    with pytest.raises(ValueError, match="idx and weight"):
        kernels.three_interpolate_backward(g, idx3, _rand(cuda, 2, 10, 2),
                                           _rand(cuda, 2, 5, 4))
    args = _sa_inputs(cuda, 2, 40, 8, 8, 32)
    with pytest.raises(ValueError, match="g must be"):
        kernels.sa_attention_backward(_rand(cuda, 2, 40, 16), *args, 8, 32, 8)


def test_backward_out_of_range_indices_give_nan_not_a_fault(cuda):
    g = _rand(cuda, 1, 3, 4)
    idx = torch.tensor([[0, 7, 2]], dtype=torch.int32, device=cuda)
    out = kernels.scatter_add_rows(g, idx, 5)
    f = _rand(cuda, 1, 5, 4)
    idx3 = torch.tensor([[[0, 1, 9], [1, 2, 3], [0, 0, 1]]], dtype=torch.int32,
                        device=cuda)
    slot = torch.zeros(1, 3, 4, dtype=torch.uint8, device=cuda)
    slot[0, 1, 0] = 5                                       # outside k = 3
    gm = kernels.group_max_backward(g, idx3, slot, 5)
    ti, tw = kernels.three_interpolate_backward(g, idx3, _rand(cuda, 1, 3, 3), f)
    proj, x1, sidx, W1, W2, b2 = _sa_inputs(cuda, 1, 20, 8, 4, 16)
    sidx[0, 3, 5] = 20
    sa = kernels.sa_attention_backward(_rand(cuda, 1, 20, 16), proj, x1, sidx, W1,
                                       W2, b2, 4, 16, 8)
    torch.cuda.synchronize()
    assert torch.isnan(out[0, 0]).all()
    assert torch.isnan(gm[0, 0, 0]) and torch.isfinite(gm[0, 0, 1:]).all()
    assert torch.isnan(ti[0, 0]).all() and torch.isnan(tw[0, 0, 2])
    assert torch.isnan(sa[1][0, 3]).all() and torch.isnan(sa[4][0])


def _scatter_case(device, B, n, shape, c, seed, fill=None):
    idx = _idx(device, n, (B, *shape), seed)
    if fill is not None:
        idx.fill_(fill)
    return _cot(device, B, *shape, c, seed=seed + 1, positive=fill is not None), idx


@pytest.mark.parametrize("case,B,n,shape,c,form", [
    ("uniform_knn_3264_clouds_of_48", 3264, 24, (24, 2), 3, "packed"),
    ("70000_clouds", 70000, 4, (8,), 3, "packed"),
    ("at_the_packing_limit_256_entries", 5, 1024, (256,), 1, "packed"),
    ("past_the_packing_limit_257_entries", 5, 1024, (257,), 1, "range"),
    ("at_the_packing_limit_1024_vectors", 5, 256, (64,), 16, "packed"),
    ("past_the_packing_limit_1028_vectors", 5, 257, (64,), 16, "range"),
    ("all_into_one_row_packed", 9, 24, (48,), 3, "packed"),
    ("all_into_one_row_range", 3, 3072, (2048,), 3, "range"),
    ("all_into_one_row_8192", 2, 300, (8192,), 1, "range"),
    ("vrcnet_64x1536x64_into_3072", 64, 3072, (1536,), 64, "range")])
def test_scatter_add_rows_bitwise_at_the_plan_boundaries(cuda, case, B, n, shape, c, form):
    """The one-launch forms at and past their limits (the packed form's 256
    entries and 1024 output vectors a cloud, more than 65535 clouds, all
    entries into one row, 8192 entries): bitwise against the plain version
    run on CPU copies (index_add_ in ascending order), two runs equal."""
    g, idx = _scatter_case(cuda, B, n, shape, c, seed=11,
                           fill=5 if "one_row" in case else None)
    entries = int(np.prod(shape))
    rows, warps, clouds = kernels.scatter_plan(entries, n, c // 4 if c % 4 == 0 else c)
    assert (clouds > 1) == (form == "packed") and rows > 0
    got = kernels.scatter_add_rows(g, idx, n)
    _bitwise([got], [kernels.scatter_add_rows(g, idx, n)])
    _bitwise([got.cpu()], [ref.scatter_add_rows(g.cpu(), idx.cpu(), n)])


@pytest.mark.parametrize("B,n,m,c", [(9, 24, 48, 3), (3, 1024, 2048, 3)])
def test_scatter_one_launch_out_of_range_index_gives_nan_at_row_0(cuda, B, n, m, c):
    """The packed and the range form add NaN at row 0 of a cloud for an index
    outside [0, n); every other row is bitwise the plain version over the
    entries left."""
    g, idx = _scatter_case(cuda, B, n, (m,), c, seed=21)
    idx[1, m // 2] = n
    idx[2, 3] = -1
    out = kernels.scatter_add_rows(g, idx, n)
    torch.cuda.synchronize()
    assert torch.isnan(out[1, 0]).all() and torch.isnan(out[2, 0]).all()
    kept = idx.clone()
    kept[1, m // 2] = 0
    kept[2, 3] = 0
    gk = g.clone()
    gk[1, m // 2] = 0.0
    gk[2, 3] = 0.0
    want = ref.scatter_add_rows(gk.cpu(), kept.cpu(), n)
    _bitwise([out[:, 1:].cpu()], [want[:, 1:]])
    _bitwise([out[0].cpu()], [want[0]])


def test_scatter_list_form_out_of_range_index_gives_nan(cuda):
    """The list form (past 8192 entries a cloud) adds NaN at row 0 for an
    index outside [0, n), as the local form does."""
    idx = _idx(cuda, 50, (2, 9000), seed=7)
    idx[1, 4321] = -3
    assert kernels.scatter_plan(9000, 50, 1)[0] == 0
    out = kernels.scatter_add_rows(_rand(cuda, 2, 9000, 3), idx, 50)
    torch.cuda.synchronize()
    assert torch.isnan(out[1, 0]).all() and torch.isfinite(out[0]).all()
    assert torch.isfinite(out[1, 1:]).all()


# ---------------------------------------------------------------------------
# Train steps, card against CPU, at chip_smoke.py's bars
# ---------------------------------------------------------------------------


def _train_step(cfg, device, x, gt, losses):
    from mvp_benchmark_tpu_torch.models import get_model

    model = get_model(cfg.model_name, cfg, generator=torch.Generator().manual_seed(1))
    model = model.to(device).train()
    out = losses(model, x.to(device), gt.to(device))
    out["total"].backward()
    return ({k: v.detach().cpu() for k, v in out.items()},
            [torch.zeros_like(p).cpu() if p.grad is None else p.grad.cpu()
             for p in model.parameters()])


def _smoke_cfg(name):
    import os
    from mvp_benchmark_tpu_torch.train.config import load_config

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return load_config(os.path.join(root, "completion", "cfgs", f"{name}_smoke.yaml"))


def test_pcn_train_step_on_card_equals_cpu(cuda):
    """pcn_smoke's shape, two clouds: total and every gradient within atol
    1e-5 / rtol 1e-4; one chamfer forward and one backward per calc_cd."""
    cfg = _smoke_cfg("pcn")
    x, gt = (_rand(torch.device("cpu"), 2, 128, 3, seed=s) for s in (16, 17))

    def losses(model, x, gt):
        _, loss2, total = model(x, gt, prefix="train", alpha=0.5)
        return {"loss2": loss2, "total": total}

    want, g_cpu = _train_step(cfg, torch.device("cpu"), x, gt, losses)
    kernels.reset_launch_counts()
    got, g_card = _train_step(cfg, cuda, x, gt, losses)
    assert kernels.launch_counts() == dict(_NO_LAUNCHES, chamfer=2, chamfer_backward=2)
    for k in got:
        torch.testing.assert_close(got[k], want[k], rtol=1e-4, atol=1e-5)
    for a, b in zip(g_card, g_cpu):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


def test_vrcnet_train_step_on_card_equals_cpu(cuda):
    """vrcnet_smoke's shape (FPS, score top-k, folding), two clouds, the same
    noise: loss1 and the KL terms within atol 1e-5 / rtol 1e-4; the total
    loss and the gradient, as one vector, as a cloud (norms within 1%,
    cosine >= 0.999: looser than chip_smoke.py's protocol-shaped step, as
    this shape also passes through the score top-k); every backward kernel
    launched (scatter_add_rows 7: the top-k and folding reach three gathers
    more than the protocol config)."""
    cfg = _smoke_cfg("vrcnet")
    x, gt = (_rand(torch.device("cpu"), 2, 128, 3, seed=s) for s in (18, 19))
    noise = {}

    def losses(model, x, gt):
        if not noise:
            noise.update(model.draw_noise(2, torch.Generator().manual_seed(2)))
        t = model.train_losses(x, gt, 0.5, {k: v.to(x.device) for k, v in noise.items()})
        return {k: t[k] for k in ("loss1", "dl_rec", "dl_g", "total")}

    want, g_cpu = _train_step(cfg, torch.device("cpu"), x, gt, losses)
    kernels.reset_launch_counts()
    got, g_card = _train_step(cfg, cuda, x, gt, losses)
    assert kernels.launch_counts() == dict(
        _NO_LAUNCHES, chamfer=4, knn=7, fps=4, gather=10, group_max=3,
        three_interpolate=3, sa_attention=4, chamfer_backward=4,
        scatter_add_rows=7, group_max_backward=3, three_interpolate_backward=3,
        sa_attention_backward=4)
    for k in ("loss1", "dl_rec", "dl_g"):
        torch.testing.assert_close(got[k], want[k], rtol=1e-4, atol=1e-5)
    assert abs(float(got["total"] - want["total"])) <= 0.01 * abs(float(want["total"]))
    gc = torch.cat([g.reshape(-1) for g in g_card]).double()
    gw = torch.cat([g.reshape(-1) for g in g_cpu]).double()
    assert abs(float(gc.norm() - gw.norm())) <= 0.01 * float(gw.norm())
    assert float(gc @ gw / (gc.norm() * gw.norm())) >= 0.999


# ---------------------------------------------------------------------------
# Ball query and auction EMD
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B,N,M,lo,nsample", [
    (2, 2048, 102, 0.0, 24), (2, 1024, 51, 0.0, 4), (3, 777, 41, 0.05, 7),
    (2, 50, 9, 0.0, 64), (1, 3000, 5, 0.0, 200)])
def test_ball_query_kernel_equals_plain_version(cuda, B, N, M, lo, nsample):
    """Indices equal, at the uniform loss's shapes and radii, ragged N and
    M, min_r > 0, nsample > N; with duplicate points and a centre far from
    every point (zeros)."""
    xyz = _rand(cuda, B, N, 3, seed=20)
    xyz[:, 1::5] = xyz[:, ::5][:, :xyz[:, 1::5].shape[1]]
    centers = xyz[:, :M].clone()
    centers[:, -1] = 5.0
    r = float(np.sqrt(min(nsample / N, 0.5)))
    got = kernels.ball_query(lo, r, nsample, xyz, centers)
    want = ref.ball_query(lo, r, nsample, xyz, centers)
    torch.cuda.synchronize()
    _bitwise([got], [want])
    assert (got[:, -1] == 0).all()


def test_ball_query_wrapper_rejects_bad_inputs(cuda):
    x = _rand(cuda, 2, 64, 3)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.ball_query(0.0, 0.2, 8, x.cpu(), x.cpu())
    with pytest.raises(ValueError, match="batch"):
        kernels.ball_query(0.0, 0.2, 8, x, x[:1].contiguous())
    with pytest.raises(ValueError, match="empty"):
        kernels.ball_query(0.0, 0.2, 0, x, x)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.ball_query(0.0, 0.2, 8, x, x[:, ::2])
    assert not dispatch.ball_query(0.0, 0.2, 8, x.requires_grad_(), x).requires_grad


@pytest.mark.parametrize("B,n,eps,iters", [
    (2, 256, 0.02, 50), (3, 1000, 0.01, 5), (2, 2048, 0.004, 300), (1, 1, 0.01, 10),
    (2, 7, 0.5, 1), (3, 777, 0.01, 200), (2, 1000, 0.01, 300), (2, 2048, 0.004, 20)])
def test_emd_kernel_equals_plain_version(cuda, B, n, eps, iters):
    """Assignments equal, converged or ended by the forced round (20
    iterations at 2048 points), at ragged n, n = 1 and iters = 1 (the
    forced round alone); two runs equal."""
    a, b = _rand(cuda, B, n, 3, seed=21), _rand(cuda, B, n, 3, seed=22)
    got = kernels.emd_assignment(a, b, eps, iters)
    want = ref.emd_assignment(a, b, eps, iters)
    torch.cuda.synchronize()
    _bitwise([got], [want])
    _bitwise([kernels.emd_assignment(a, b, eps, iters)], [got])


@pytest.mark.parametrize("C,B", [(8, 16), (4, 33), (2, 66), (1, 67)])
def test_emd_kernel_on_each_cluster_size(cuda, C, B):
    """The batch sizes whose plan is C CTAs a cloud on 132 SMs, and C forced
    at a small batch: assignments equal the plain version's."""
    n, eps, iters = 512, 0.01, 100
    a, b = _rand(cuda, B, n, 3, seed=26), _rand(cuda, B, n, 3, seed=27)
    assert kernels.emd_plan(B, n, 132) == C
    want = ref.emd_assignment(a, b, eps, iters)
    _bitwise([kernels.emd_assignment(a, b, eps, iters)], [want])
    _bitwise([kernels._emd_launch(a[:3].contiguous(), b[:3].contiguous(), eps, iters, C)],
             [want[:3]])


def test_emd_kernel_price_war(cuda):
    """A blob of bidders against uniform targets (a price war, as
    random-weight predictions bid) at the val metric's (32, 2048, eps 0.004,
    3000): equal to the plain version, two runs equal."""
    from mvp_benchmark_tpu_torch.probe_emd_chamfer import price_war_clouds

    a, b = price_war_clouds(cuda, 32, 2048, 90)
    want = ref.emd_assignment(a, b, 0.004, 3000)
    got = kernels.emd_assignment(a, b, 0.004, 3000)
    _bitwise([got], [want])
    _bitwise([kernels.emd_assignment(a, b, 0.004, 3000)], [got])


def test_emd_kernel_far_points_and_non_finite_coordinates(cuda):
    """Points as far out as the wrapper takes (2^62, squared distances up to
    ~2^126, benefits tied at -2^63 and below) equal the plain version; a NaN,
    an infinite or a larger coordinate, whose squared distances the kernel's
    square root does not take, raises."""
    a, b = _rand(cuda, 2, 300, 3, seed=28), _rand(cuda, 2, 300, 3, seed=29)
    a[0, 5, 1] = kernels.EMD_MAX_ABS
    a[1, :40, 0] = -kernels.EMD_MAX_ABS
    b[0, 7, 2] = -kernels.EMD_MAX_ABS
    b[1, 9] = 1e18
    for C in (1, 2, 4):
        _bitwise([kernels._emd_launch(a, b, 0.01, 300, C)],
                 [ref.emd_assignment(a, b, 0.01, 300)])
    for bad in (float("nan"), float("inf"), 1e20):
        far = b.clone()
        far[1, 3, 0] = bad
        with pytest.raises(ValueError, match="finite coordinates"):
            kernels.emd_assignment(a, far, 0.01, 300)
        with pytest.raises(ValueError, match="finite coordinates"):
            kernels.emd_assignment(far, a, 0.01, 300)


def test_emd_square_root_is_ieee(cuda):
    """The auction's square root (sqrt.rn's fast path on d clamped to
    2^-100) equals __fsqrt_rn bitwise at every float from 2^-100 to FLT_MAX."""
    assert kernels.emd_sqrt_mismatches(cuda) == 0


def test_emd_kernel_all_points_equal(cuda):
    """Every bidder and target at one point: every benefit ties."""
    a = torch.full((2, 300, 3), 0.25, device=cuda)
    b = torch.full((2, 300, 3), 0.75, device=cuda)
    for C in (1, 2, 4, 8):
        _bitwise([kernels._emd_launch(a, b, 0.01, 1000, C)],
                 [ref.emd_assignment(a, b, 0.01, 1000)])


def test_emd_kernel_ties_and_equal_clouds(cuda):
    """Equal clouds give the identity; a prediction with every point twice
    (the tie rules decide) equals the plain version."""
    a = _rand(cuda, 2, 512, 3, seed=23)
    ident = kernels.emd_assignment(a, a, 0.005, 50)
    assert (ident.long() == torch.arange(512, device=cuda)).all()
    twice = torch.cat([a[:, :256], a[:, :256]], 1)
    _bitwise([kernels.emd_assignment(twice, a, 0.005, 200)],
             [ref.emd_assignment(twice, a, 0.005, 200)])


def test_emd_wrapper_rejects_bad_inputs(cuda):
    a = _rand(cuda, 2, 64, 3)
    with pytest.raises(ValueError, match="like xyz1"):
        kernels.emd_assignment(a, a[:, :32].contiguous(), 0.01, 10)
    with pytest.raises(ValueError, match="eps"):
        kernels.emd_assignment(a, a, 0.0, 10)
    big = _rand(cuda, 1, kernels.EMD_MAX_N + 1, 3)
    with pytest.raises(ValueError, match="n <="):
        kernels.emd_assignment(big, big, 0.01, 10)
    with pytest.raises(ValueError, match="n == m"):
        dispatch.emd_auction(a, a[:, :32].contiguous())


def test_calc_emd_and_its_gradient_on_card_equal_cpu(cuda):
    from mvp_benchmark_tpu_torch.metrics import calc_emd

    a, b = _rand(torch.device("cpu"), 2, 1024, 3, seed=24), _rand(
        torch.device("cpu"), 2, 1024, 3, seed=25)
    outs = []
    for dev in (torch.device("cpu"), cuda):
        x = a.clone().to(dev).requires_grad_()
        e = calc_emd(x, b.to(dev), 0.004, 500)
        e.sum().backward()
        outs.append((e.detach().cpu(), x.grad.cpu()))
    torch.testing.assert_close(outs[1][0], outs[0][0], rtol=1e-6, atol=0)
    torch.testing.assert_close(outs[1][1], outs[0][1], rtol=1e-5, atol=1e-7)


def test_knn_points_distances_differentiable_only_where_needed(cuda):
    """With a graph, the distances are recomputed from the gathered
    neighbours (one gather, bitwise the kernel's), and the gradient equals
    the CPU's; without one, the kNN launches alone."""
    q = _rand(cuda, 3, 20, 3, seed=26)
    kernels.reset_launch_counts()
    with torch.no_grad():
        d0, i0 = dispatch.knn_points(q, q, 2)
    assert kernels.launch_counts() == dict(_NO_LAUNCHES, knn=1)
    x = q.clone().requires_grad_()
    d, i = dispatch.knn_points(x, x, 2)
    assert kernels.launch_counts() == dict(_NO_LAUNCHES, knn=2, gather=1)
    _bitwise([d.detach(), i], [d0, i0])
    d.sum().backward()
    xc = q.cpu().requires_grad_()
    ref.knn_points(xc, xc, 2)[0].sum().backward()
    torch.testing.assert_close(x.grad.cpu(), xc.grad, rtol=1e-5, atol=1e-7)


def test_uniform_loss_on_card_equals_cpu(cuda):
    from mvp_benchmark_tpu_torch.models import common

    v = torch.randn(2, 2048, 3, generator=torch.Generator().manual_seed(27))
    pcd = 0.5 * v / v.norm(dim=-1, keepdim=True)
    outs = []
    for dev in (torch.device("cpu"), cuda):
        x = pcd.clone().to(dev).requires_grad_()
        kernels.reset_launch_counts()
        loss = common.get_uniform_loss(x)
        loss.backward()
        outs.append((float(loss.detach()), x.grad.cpu(), kernels.launch_counts()))
    assert outs[1][2] == dict(_NO_LAUNCHES, fps=1, gather=11, ball_query=5, knn=5,
                              scatter_add_rows=10)
    assert outs[1][0] == pytest.approx(outs[0][0], rel=1e-5)
    torch.testing.assert_close(outs[1][1], outs[0][1], rtol=1e-4, atol=1e-7)


def test_ecg_train_step_on_card_equals_cpu(cuda):
    """ecg_smoke at 512 points (the uniform loss needs nsample >= 2), two
    clouds: loss1 and uniform1 (the coarse output) within atol 1e-5 / rtol
    1e-4; the total within rtol 1e-4 and the gradient as one vector (norms
    within 0.1%, cosine >= 0.9999), as chip_smoke.py holds the protocol
    step; every kernel of ECG_PER_STEP launched."""
    cfg = _smoke_cfg("ecg")
    cfg.num_points = 512
    x, gt = (_rand(torch.device("cpu"), 2, 512, 3, seed=s) for s in (28, 29))

    def losses(model, x, gt):
        t = model.train_losses(x, gt, 0.5)
        return {k: t[k] for k in ("loss1", "uniform1", "loss2", "uniform2", "total")}

    want, g_cpu = _train_step(cfg, torch.device("cpu"), x, gt, losses)
    kernels.reset_launch_counts()
    got, g_card = _train_step(cfg, cuda, x, gt, losses)
    assert all(kernels.launch_counts()[k] > 0 for k in (
        "ball_query", "knn", "gather", "scatter_add_rows", "group_max_backward",
        "three_interpolate_backward", "chamfer_backward"))
    for k in ("loss1", "uniform1"):
        torch.testing.assert_close(got[k], want[k], rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(got["total"], want["total"], rtol=1e-4, atol=0)
    gc = torch.cat([g.reshape(-1) for g in g_card]).double()
    gw = torch.cat([g.reshape(-1) for g in g_cpu]).double()
    assert abs(float(gc.norm() - gw.norm())) <= 1e-3 * float(gw.norm())
    assert float(gc @ gw / (gc.norm() * gw.norm())) >= 0.9999


# ---------------------------------------------------------------------------
# DCP: attention (rows 14-15) and the edge chain (row 16)
# ---------------------------------------------------------------------------

def _normwise(got, want):
    got, want = got.double(), want.double()
    return float((got - want).norm() / want.norm())


def _bnhd_inputs(cuda, B, N, M, H):
    """bf16 heads as DCP's lie: views of fused projection rows."""
    g = torch.Generator(device="cuda").manual_seed(N)
    d = H * 128
    y = torch.randn(B, N, 3 * d, device=cuda, generator=g).to(torch.bfloat16)
    ym = torch.randn(B, M, 3 * d, device=cuda, generator=g).to(torch.bfloat16)
    return (y[..., :d].reshape(B, N, H, 128), ym[..., d:2 * d].reshape(B, M, H, 128),
            ym[..., 2 * d:].reshape(B, M, H, 128))


def _f32_inputs(cuda, B, N, M, D):
    g = torch.Generator(device="cuda").manual_seed(D)
    return (torch.randn(B, N, D, device=cuda, generator=g),
            torch.randn(B, M, D, device=cuda, generator=g),
            torch.rand(B, M, 3, device=cuda, generator=g))


# the forwards' tiles: 128 queries a block, 128 keys a tile; these cut both
BNHD_SHAPES = [(2, 2048, 2048, 4), (2, 1000, 777, 3), (3, 1000, 777, 4), (1, 129, 65, 1),
               (1, 5, 3, 1)]
F32_SHAPES = [(2, 2048, 2048, 512), (3, 1000, 777, 64), (3, 1000, 777, 512),
              (1, 129, 65, 512), (1, 5, 3, 64)]


@pytest.mark.parametrize("B,N,M,H", BNHD_SHAPES)
def test_attention_bnhd_kernel_matches_plain_version(cuda, B, N, M, H):
    """bf16 heads read in place from fused projection rows; the online
    softmax rounds p before its division by l, the plain version after, so
    the bar is normwise 1e-2 (3.1e-3 measured at DCP's shape)."""
    q, k, v = _bnhd_inputs(cuda, B, N, M, H)
    scale = 128 ** -0.5
    before = kernels.ATTENTION_BNHD_LAUNCHES
    got = dispatch.attention_bnhd(q, k, v, scale)
    torch.cuda.synchronize()
    assert kernels.ATTENTION_BNHD_LAUNCHES == before + 1
    want = ref.attention_bnhd(q, k, v, scale)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert _normwise(got, want) < 1e-2
    _, m, l = kernels.attention_bnhd_forward(q, k, v, scale, stats=True)
    s = torch.matmul(q.float().transpose(1, 2), k.float().permute(0, 2, 3, 1)) * scale
    torch.testing.assert_close(m, s.amax(-1), rtol=0, atol=1e-4)
    torch.testing.assert_close(l, torch.exp(s - s.amax(-1, keepdim=True)).sum(-1),
                               rtol=1e-4, atol=0)


@pytest.mark.parametrize("B,N,M,D", F32_SHAPES)
def test_attention_f32_kernel_matches_plain_version(cuda, B, N, M, D):
    """The svd head's fp32 correspondence with the 3-wide value, its scores
    as 3xTF32, within 1e-5 + 1e-4 |plain| (another summation order); its
    row max and row sum within the same bar of a plain recomputation."""
    q, k, v = _f32_inputs(cuda, B, N, M, D)
    before = kernels.ATTENTION_LAUNCHES
    got = dispatch.attention(q, k, v, D ** -0.5)
    torch.cuda.synchronize()
    assert kernels.ATTENTION_LAUNCHES == before + 1
    want = ref.attention(q, k, v, D ** -0.5)
    assert got.shape == want.shape
    assert ((got - want).abs() <= 1e-5 + 1e-4 * want.abs()).all()
    _, m, l = kernels.attention_forward(q, k, v, D ** -0.5, stats=True)
    s = torch.matmul(q, k.transpose(1, 2)) * D ** -0.5
    want_m = s.amax(-1)
    want_l = torch.exp(s - want_m[..., None]).sum(-1)
    for a, w in ((m, want_m), (l, want_l)):
        assert ((a - w).abs() <= 1e-5 + 1e-4 * w.abs()).all()


@pytest.mark.parametrize("B,N,M,H", BNHD_SHAPES[1:])
def test_attention_bnhd_kernel_reruns_bitwise(cuda, B, N, M, H):
    q, k, v = _bnhd_inputs(cuda, B, N, M, H)
    first = kernels.attention_bnhd_forward(q, k, v, 128 ** -0.5, stats=True)
    second = kernels.attention_bnhd_forward(q, k, v, 128 ** -0.5, stats=True)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.parametrize("B,N,M,D", F32_SHAPES[1:])
def test_attention_f32_kernel_reruns_bitwise(cuda, B, N, M, D):
    q, k, v = _f32_inputs(cuda, B, N, M, D)
    first = kernels.attention_forward(q, k, v, D ** -0.5, stats=True)
    second = kernels.attention_forward(q, k, v, D ** -0.5, stats=True)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.parametrize("B,N,K", [(2, 2048, 20), (3, 1001, 7), (2, 37, 20), (2, 5, 1)])
def test_edge_mlp_kernel_matches_plain_version(cuda, B, N, K):
    """Normwise 1e-4 a layer (1.4e-5 measured at (3, 1001, k 7)): a bf16
    rounding of an activation may land on the other side. The shapes cut
    the final pass's rounds of 16 points and its tiles of 4 slots; two runs
    bitwise equal."""
    g = torch.Generator(device="cuda").manual_seed(K)
    x = torch.rand(B, N, 3, device=cuda, generator=g)
    nb = ref.gather_points(x, ref.knn_indices(x, K))
    a1 = torch.cat([nb, x[:, :, None].expand_as(nb)], -1).to(torch.bfloat16)
    chs, cins = (64, 64, 128, 256), (6, 64, 64, 128)
    Ws = [(torch.rand(ci, c, device=cuda, generator=g) * 2 - 1) * ci ** -0.5
          for ci, c in zip(cins, chs)]
    params = [[1 + 0.1 * torch.randn(c, device=cuda, generator=g) for c in chs],
              [0.1 * torch.randn(c, device=cuda, generator=g) for c in chs],
              [0.1 * torch.randn(c, device=cuda, generator=g) for c in chs],
              [0.5 + torch.rand(c, device=cuda, generator=g) for c in chs]]
    before = kernels.EDGE_MLP_LAUNCHES
    got = dispatch.edge_mlp_eval(a1, Ws, *params)
    torch.cuda.synchronize()
    assert kernels.EDGE_MLP_LAUNCHES == before + 1
    for gl, wl in zip(got, ref.edge_mlp_eval(a1, Ws, *params)):
        assert gl.shape == wl.shape and _normwise(gl, wl) < 1e-4
    again = dispatch.edge_mlp_eval(a1, Ws, *params)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_attention_and_edge_mlp_wrappers_reject_bad_inputs(cuda):
    q = torch.zeros(1, 8, 2, 128, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="D = Dv = 128"):
        kernels.attention_bnhd_forward(q[..., :64], q[..., :64], q[..., :64], 1.0)
    with pytest.raises(ValueError, match="Dv = 3"):
        kernels.attention_forward(q[:, :, 0].float(), q[:, :, 0].float(),
                                  q[:, :, 0].float(), 1.0)
    with pytest.raises(TypeError, match="share a dtype"):
        kernels.attention_bnhd_forward(q, q.float(), q, 1.0)
    with pytest.raises(ValueError, match="scale > 0"):
        kernels.attention_bnhd_forward(q, q, q, 0.0)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.attention_bnhd_forward(q.transpose(1, 2).contiguous().transpose(1, 2),
                                       q, q, 1.0)
    a1 = torch.zeros(1, 4, 3, 6, device=cuda, dtype=torch.bfloat16)
    Ws = [torch.zeros(ci, c, device=cuda) for ci, c in
          ((6, 64), (64, 64), (64, 128), (128, 256))]
    ps = [[torch.ones(c, device=cuda) for c in (64, 64, 128, 256)]] * 4
    with pytest.raises(TypeError, match="bfloat16"):
        kernels.edge_mlp_forward(a1.float(), Ws, *ps)
    with pytest.raises(ValueError, match="W2"):
        kernels.edge_mlp_forward(a1, Ws[:2] + [Ws[1]] + Ws[3:], *ps)


def test_dcp_on_card_equals_cpu(cuda, monkeypatch):
    """DCP at the smoke size, the same seeded weights on both devices, every
    batch of the synthetic val split: the bf16 transformer's products round
    differently in cuBLAS and on the CPU. Each output's bar (rtol, atol) is
    ~10x its gap on the first batch measured on an H100 (loss 2.7e-6, transE
    2.5e-4, RMSE 7.0e-5, MSE 4.9e-4, T_12 2.6e-4). RotE is the angle of the
    pose T_12 holds, and is held to T_12's bar: rtol 5e-3 + atol 2.5e-3 rad
    in degrees. With random weights the svd head's soft correspondences are
    nearly uniform and the pose moves with the transformer's last bf16 bits:
    on an H100 the plain attention versions on the card leave RotE 0.023-0.151
    degrees from the CPU over these batches, so they are held to RotE's bar
    too, as a witness that the bar is one a right implementation meets."""
    from mvp_benchmark_tpu_torch.train import engine
    from mvp_benchmark_tpu_torch.train.config import load_config

    cfg = load_config("registration/cfgs/dcp_smoke.yaml")
    batches = list(engine.registration_dataset(cfg, "val", "nodata").batches(
        engine.BatchSpec(4)))

    def run(device):
        step = engine.make_registration_eval_step(engine.build_model(cfg, device), device)
        return [[o.cpu() for o in step(b, "val")] + [step(b, "test").cpu()]
                for b in batches]

    want, got = run(torch.device("cpu")), run(cuda)
    monkeypatch.setattr(kernels.AttentionFunction, "apply", ref.attention)
    monkeypatch.setattr(kernels.AttentionBnhdFunction, "apply", ref.attention_bnhd)
    plain = run(cuda)
    bars = {"loss": (0, 3e-5), "RotE": (5e-3, math.degrees(2.5e-3)),
            "transE": (0, 2.5e-3), "RMSE": (0, 7e-4), "MSE": (0, 5e-3),
            "T_12": (0, 2.5e-3)}
    for i, (g, p, w) in enumerate(zip(got, plain, want)):
        print(f"val batch {i}: RotE max |card - CPU| through the kernels "
              f"{float((g[1] - w[1]).abs().max())!r}, through the plain attention "
              f"{float((p[1] - w[1]).abs().max())!r} degrees")
        for (name, (rtol, atol)), gn, wn in zip(bars.items(), g, w):
            torch.testing.assert_close(gn, wn, rtol=rtol, atol=atol,
                                       msg=f"{name}, val batch {i}")
        torch.testing.assert_close(p[1], w[1], rtol=5e-3, atol=math.degrees(2.5e-3),
                                   msg=f"RotE through the plain attention, val batch {i}")


# ---------------------------------------------------------------------------
# DCP training: the attention backwards (rows 14-15) and the edge chain's
# stat and backward passes (row 16)
# ---------------------------------------------------------------------------

def _attention_case(cuda, B, N, M, H, dtype):
    g = torch.Generator(device="cuda").manual_seed(N + H)
    if dtype == torch.bfloat16:
        d = H * 128
        y = torch.randn(B, N, 3 * d, device=cuda, generator=g).to(dtype)
        ym = torch.randn(B, M, 3 * d, device=cuda, generator=g).to(dtype)
        q = y[..., :d].reshape(B, N, H, 128)
        k, v = ym[..., d:2 * d].reshape(B, M, H, 128), ym[..., 2 * d:].reshape(B, M, H, 128)
        scale = 128 ** -0.5
        o, m, l = kernels.attention_bnhd_forward(q, k, v, scale, stats=True)
    else:
        q = torch.randn(B, N, 512, device=cuda, generator=g)
        k = torch.randn(B, M, 512, device=cuda, generator=g)
        v = torch.rand(B, M, 3, device=cuda, generator=g)
        scale = 512 ** -0.5
        o, m, l = kernels.attention_forward(q, k, v, scale, stats=True)
    d_out = torch.randn(o.shape, device=cuda, generator=g).to(dtype)
    return q, k, v, o, m, l, d_out, scale


@pytest.mark.parametrize("B,N,M,H", [(32, 2048, 2048, 4), (2, 1000, 777, 3),
                                     (1, 129, 65, 1)])
def test_attention_bnhd_backward_kernel_matches_plain_version(cuda, B, N, M, H):
    """dq, dk, dv of the heads read in place, normwise 1e-3 against
    ``ref.attention_backward`` (1.7e-4 measured at DCP's shape, B 32); two
    runs bitwise equal (no atomics); only the gradients asked for are
    computed, equal to the full call's."""
    *x, d_out, scale = _attention_case(cuda, B, N, M, H, torch.bfloat16)
    before = kernels.ATTENTION_BNHD_BWD_LAUNCHES
    got = kernels.attention_bnhd_backward(*x, d_out, scale)
    torch.cuda.synchronize()
    assert kernels.ATTENTION_BNHD_BWD_LAUNCHES == before + 1
    for g, w in zip(got, ref.attention_backward(*x, d_out, scale)):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
        assert _normwise(g, w) < 1e-3
    again = kernels.attention_bnhd_backward(*x, d_out, scale)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    for need in ((True, False, False), (False, True, False), (False, False, True)):
        some = kernels.attention_bnhd_backward(*x, d_out, scale, need=need)
        for n, a, b in zip(need, some, got):
            assert (a is None) if not n else torch.equal(a, b)


@pytest.mark.parametrize("B,N,M", [(32, 2048, 2048), (3, 1000, 777), (1, 129, 65)])
def test_attention_f32_backward_kernel_matches_plain_version(cuda, B, N, M):
    """The svd head's backward (3xTF32 on the tensor cores) within 1e-5 +
    1e-4 |plain| elementwise (max |diff| 3.9e-7 measured on an H100 at DCP's
    shape, B 32); two runs bitwise equal (ds through a scratch, dv's
    partials summed in order); only the gradients asked for are computed,
    equal to the full call's."""
    *x, d_out, scale = _attention_case(cuda, B, N, M, 1, torch.float32)
    got = kernels.attention_backward(*x, d_out, scale)
    for g, w in zip(got, ref.attention_backward(*x, d_out, scale)):
        assert g.shape == w.shape
        assert ((g - w).abs() <= 1e-5 + 1e-4 * w.abs()).all()
    again = kernels.attention_backward(*x, d_out, scale)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    for need in ((True, True, False), (True, False, False), (False, True, False),
                 (False, False, True)):
        some = kernels.attention_backward(*x, d_out, scale, need=need)
        for n, a, b in zip(need, some, got):
            assert (a is None) if not n else torch.equal(a, b)


@pytest.mark.parametrize("B,N,K", [(2, 2048, 20), (3, 1001, 7)])
def test_edge_mlp_train_kernels_match_plain_version(cuda, B, N, K):
    """The train chain's forward (max-pools normwise 1e-3, batch statistics
    1e-5) and its five backward passes (every gradient normwise 2e-2:
    another bf16 rounding of the carried cotangent; 1.6e-2 measured), with
    launches counted, and two runs bitwise equal."""
    g = torch.Generator(device="cuda").manual_seed(K)
    x = torch.rand(B, N, 3, device=cuda, generator=g)
    nb = ref.gather_points(x, ref.knn_indices(x, K))
    a1 = torch.cat([nb, x[:, :, None].expand_as(nb)], -1).to(torch.bfloat16)
    chs, cins = (64, 64, 128, 256), (6, 64, 64, 128)
    Ws = [(torch.rand(ci, c, device=cuda, generator=g) * 2 - 1) * ci ** -0.5
          for ci, c in zip(cins, chs)]
    gammas = [1 + 0.1 * torch.randn(c, device=cuda, generator=g) for c in chs]
    betas = [0.1 * torch.randn(c, device=cuda, generator=g) for c in chs]
    gxs = [torch.randn(B, N, c, device=cuda, generator=g) for c in chs]
    leaves = [t.clone().requires_grad_() for t in (a1, *Ws, *gammas, *betas)]
    before = (kernels.EDGE_MLP_STAT_LAUNCHES, kernels.EDGE_MLP_LAUNCHES,
              kernels.EDGE_MLP_BWD_LAUNCHES)
    out = dispatch.edge_mlp_train(leaves[0], leaves[1:5], leaves[5:9], leaves[9:])
    got = torch.autograd.grad(out[0], leaves, gxs)
    torch.cuda.synchronize()
    assert (kernels.EDGE_MLP_STAT_LAUNCHES, kernels.EDGE_MLP_LAUNCHES,
            kernels.EDGE_MLP_BWD_LAUNCHES) == (before[0] + 4, before[1] + 1, before[2] + 5)
    want_xs, want_stats = ref.edge_mlp_train(leaves[0], leaves[1:5], leaves[5:9], leaves[9:])
    for gl, wl in zip(out[0], want_xs):
        assert _normwise(gl, wl.detach()) < 1e-3
    for gl, wl in zip(out[1], want_stats):
        assert _normwise(gl, wl) < 1e-5
    want = torch.autograd.grad(want_xs, leaves, gxs)
    for gl, wl in zip(got, want):
        assert gl.shape == wl.shape and _normwise(gl.float(), wl.float()) < 2e-2
    again = torch.autograd.grad(dispatch.edge_mlp_train(
        leaves[0], leaves[1:5], leaves[5:9], leaves[9:])[0], leaves, gxs)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def _edge_train_case(cuda, B, N, K):
    g = torch.Generator(device="cuda").manual_seed(N + K)
    x = torch.rand(B, N, 3, device=cuda, generator=g)
    nb = ref.gather_points(x, ref.knn_indices(x, K))
    a1 = torch.cat([nb, x[:, :, None].expand_as(nb)], -1).to(torch.bfloat16)
    chs, cins = (64, 64, 128, 256), (6, 64, 64, 128)
    Ws = [(torch.rand(ci, c, device=cuda, generator=g) * 2 - 1) * ci ** -0.5
          for ci, c in zip(cins, chs)]
    gammas = [1 + 0.1 * torch.randn(c, device=cuda, generator=g) for c in chs]
    betas = [0.1 * torch.randn(c, device=cuda, generator=g) for c in chs]
    gxs = [torch.randn(B, N, c, device=cuda, generator=g) for c in chs]
    return a1, Ws, gammas, betas, gxs


@pytest.mark.parametrize("B,N,K", [(2, 5, 1), (1, 21, 20), (2, 37, 20), (3, 1001, 7)])
def test_edge_mlp_backward_ragged_tiles_match_plain_and_rerun_bitwise(cuda, B, N, K):
    """The five backward passes where the B N k edges are no multiple of
    the kernel's 64-edge tile (10, 420, 1480 and 21021 edges; k 1, 20, 7),
    on the kernel forward's statistics and slots: every gradient normwise
    within chip_smoke.EDGE_GRAD_NORM of ``ref.edge_mlp_backward``, which
    rounds where the kernel does (1.8e-3 measured on an H100 80GB HBM3 at
    700 W); two runs bitwise equal."""
    import chip_smoke

    a1, Ws, gammas, betas, gxs = _edge_train_case(cuda, B, N, K)
    _, stats, slots = kernels.edge_mlp_train_forward(a1, Ws, gammas, betas)
    flat = lambda r: [r[0], *r[1], *r[2], *r[3]]
    run = lambda: flat(kernels.edge_mlp_train_backward(a1, Ws, gammas, betas, stats, slots,
                                                       gxs, need_a1=True))
    got, again = run(), run()
    want = flat(ref.edge_mlp_backward(a1, Ws, gammas, betas, stats, slots, gxs))
    for gl, wl in zip(got, want):
        assert gl.shape == wl.shape
        assert _normwise(gl.float(), wl.float()) <= chip_smoke.EDGE_GRAD_NORM
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_train_wrappers_reject_bad_inputs(cuda):
    *x, d_out, scale = _attention_case(cuda, 1, 64, 64, 1, torch.float32)
    q, k = (t[..., :256].contiguous() for t in x[:2])
    with pytest.raises(ValueError, match="D = 512"):
        kernels.attention_backward(q, k, *x[2:], d_out, scale)
    with pytest.raises(ValueError, match="row_max"):
        kernels.attention_backward(*x[:4], x[4][:, :10], x[5], d_out, scale)
    a1 = torch.zeros(1, 4, 256, 6, device=cuda, dtype=torch.bfloat16)
    Ws = [torch.zeros(ci, c, device=cuda) for ci, c in
          ((6, 64), (64, 64), (64, 128), (128, 256))]
    ps = [[torch.ones(c, device=cuda) for c in (64, 64, 128, 256)]] * 2
    with pytest.raises(ValueError, match="k=256"):
        kernels.edge_mlp_train_forward(a1, Ws, *ps)


def test_dcp_train_step_on_card_equals_cpu(cuda):
    """A DCP train step at the smoke size, the same seeded weights on both
    devices: the loss (rtol 1e-3) and the updated running statistics (atol
    1e-3); every gradient leaf by cosine 0.99 (0.99963 measured on an H100),
    the edge chain's also normwise 2e-2 of the leaf's norm (5.3e-3
    measured; a zero or sign-flipped gradient fails both), the key
    projections' biases (exactly 0) to 1e-5 of the whole gradient's norm
    (9.5e-7). chip_smoke.check_dcp_step_on_cpu holds the same at full
    width."""
    from mvp_benchmark_tpu_torch.models.dcp import SHIFT_INVARIANT
    from mvp_benchmark_tpu_torch.train import engine
    from mvp_benchmark_tpu_torch.train.config import load_config
    from mvp_benchmark_tpu_torch.train.optim import build_optimizer

    cfg = load_config("registration/cfgs/dcp_smoke.yaml")
    batch = next(engine.registration_dataset(cfg, "train", "nodata").batches(
        engine.BatchSpec(4)))
    outs = []
    for device in (cuda, torch.device("cpu")):
        model = engine.build_model(cfg, device, seed=1, for_training=True)
        out = engine.make_registration_train_step(
            model, build_optimizer(cfg, model.parameters()), device)(batch)
        outs.append((float(out["total_loss"]),
                     {n: p.grad.double().cpu() for n, p in model.named_parameters()},
                     {n: b.cpu() for n, b in model.named_buffers()}))
    (loss, g_card, st_card), (want, g_cpu, st_cpu) = outs
    assert abs(loss - want) <= 1e-3 * abs(want)
    for n, w in st_cpu.items():
        torch.testing.assert_close(st_card[n], w, rtol=0, atol=1e-3, msg=n)
    total = float(torch.sqrt(sum((w * w).sum() for w in g_cpu.values())))
    for n, w in g_cpu.items():
        g = g_card[n].flatten()
        w = w.flatten()
        gap = float((g - w).norm())
        if n.endswith(SHIFT_INVARIANT):
            assert gap <= 1e-5 * total, n
            continue
        cos = float(g @ w / (g.norm() * w.norm()))
        assert cos >= 0.99, (n, cos)
        if ".fused_" in n:
            assert gap <= 2e-2 * float(w.norm()), (n, cos, gap / float(w.norm()))


# ---------------------------------------------------------------------------
# IDAM evaluation: the Propagate edge block (rows 18-19) and the similarity
# MLP (row 17)
# ---------------------------------------------------------------------------

def _propagate_case(cuda, B, N, k, C, dup=False):
    g = torch.Generator(device="cuda").manual_seed(N + k + C)
    idx = ref.knn_indices(torch.rand(B, N, 3, device=cuda, generator=g), k)
    if dup:
        idx[:, :, k - k // 2:] = idx[:, :, :k // 2]
    u = lambda *s: (torch.rand(*s, device=cuda, generator=g) * 2 - 1) * C ** -0.5
    vec = lambda sd, mu: mu + sd * torch.randn(C, device=cuda, generator=g)
    return (torch.randn(B, N, C, device=cuda, generator=g), idx, u(C, C), u(C),
            vec(0.1, 1.0), vec(0.1, 0.0), vec(0.1, 0.0),
            0.5 + torch.rand(C, device=cuda, generator=g))


@pytest.mark.parametrize("B,N,k,C,dup", [(2, 2048, 12, 64, False), (3, 1001, 12, 32, False),
                                         (2, 37, 5, 64, False), (2, 300, 12, 64, True)])
def test_gnn_propagate_kernel_equals_plain_version(cuda, B, N, k, C, dup):
    """Within chip_smoke's bar (``check_propagate_final``): x1 is the plain
    version's bitwise, but the product runs on the tensor cores, which sum
    the channels in another order. Two runs bitwise equal."""
    import chip_smoke

    x = _propagate_case(cuda, B, N, k, C, dup)
    before = kernels.GNN_PROPAGATE_LAUNCHES
    got, stats = dispatch.gnn_propagate(*x, train=False)
    torch.cuda.synchronize()
    assert stats is None and kernels.GNN_PROPAGATE_LAUNCHES == before + 1
    chip_smoke.check_propagate_final("gnn_propagate", got, ref.gnn_propagate_candidates(*x))
    assert torch.equal(got, dispatch.gnn_propagate(*x, train=False)[0])


def _sim_case(cuda, B, M, emb=64, ties=False):
    g = torch.Generator(device="cuda").manual_seed(M + emb)
    C = kernels.SIM_MLP_C
    src, tgt = (torch.rand(B, M, 3, device=cuda, generator=g) for _ in range(2))
    semb, temb = (torch.randn(B, M, emb, device=cuda, generator=g) for _ in range(2))
    if ties:
        h = M // 4
        tgt[:, h:2 * h], temb[:, h:2 * h] = tgt[:, :h], temb[:, :h]
    u = lambda *s: (torch.rand(*s, device=cuda, generator=g) * 2 - 1) * s[0] ** -0.5
    vec = lambda sd, mu: mu + sd * torch.randn(C, device=cuda, generator=g)
    var = lambda: 0.5 + torch.rand(C, device=cuda, generator=g)
    return (src, tgt, semb, temb, u(2 * emb + 4, C), u(C, C), u(C), u(C, C), u(C, 1),
            u(1), vec(0.1, 1.0), vec(0.1, 0.0), vec(0.1, 1.0), vec(0.1, 0.0),
            vec(0.1, 0.0), var(), vec(0.1, 0.0), var())


@pytest.mark.parametrize("B,M,ties", [(2, 341, False), (3, 37, False), (2, 64, True),
                                      (1, 1, False)])
def test_sim_mlp_kernel_equals_plain_version(cuda, B, M, ties):
    """sim and wmax within chip_smoke.SIM_FINAL_ATOL + SIM_FINAL_RTOL |plain|
    and bf16(wmax) equal (``chip_smoke.check_sim_final``): the projections
    are the same plain product on both paths, and the kernel's tensor cores
    sum the channels in another order, with every bf16 rounding of h1 and
    every relu mask the plain version's; two runs bitwise equal."""
    import chip_smoke

    x = _sim_case(cuda, B, M, ties=ties)
    before = kernels.SIM_MLP_LAUNCHES
    sim, wmax, stats = dispatch.sim_mlp(*x, train=False)
    torch.cuda.synchronize()
    assert stats is None and kernels.SIM_MLP_LAUNCHES == before + 1
    chip_smoke.check_sim_final(f"sim_mlp ({B}, {M})", (sim, wmax), ref.sim_mlp_eval(*x))
    again = dispatch.sim_mlp(*x, train=False)
    assert torch.equal(sim, again[0]) and torch.equal(wmax, again[1])


def test_idam_wrappers_reject_bad_inputs_and_bad_indices_give_nan(cuda):
    p, idx, *rest = _propagate_case(cuda, 1, 40, 4, 64)
    with pytest.raises(ValueError, match="channels"):
        kernels.gnn_propagate_forward(p[..., :48].contiguous(), idx, *rest)
    with pytest.raises(TypeError, match="int32"):
        kernels.gnn_propagate_forward(p, idx.long(), *rest)
    with pytest.raises(ValueError, match="W must be"):
        kernels.gnn_propagate_forward(p, idx, rest[0][:32], *rest[1:])
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.gnn_propagate_forward(p.cpu(), idx, *rest)
    bad = idx.clone()
    bad[0, 3, 1] = 40
    out = kernels.gnn_propagate_forward(p, bad, *rest)
    torch.cuda.synchronize()
    assert bool(torch.isnan(out[0, 3]).all()) and bool(torch.isfinite(out[0, 4:]).all())
    x = list(_sim_case(cuda, 1, 8))
    sp, tp = ref.sim_projections(x[2], x[3], x[4])
    w0, wxyz = ref.sim_mlp_split(x[4], 64)
    core = [sp, tp, x[0], x[1], w0, wxyz, *x[5:8], x[8], *x[10:]]
    with pytest.raises(ValueError, match="int32 indexing"):
        big = torch.zeros(1, 46341, 32, device=cuda)      # 46341^2 >= 2^31 logits
        pos = torch.zeros(1, 46341, 3, device=cuda)
        kernels.sim_mlp_forward(big, big, pos, pos, *core[4:])
    with pytest.raises(ValueError, match="W4"):
        kernels.sim_mlp_forward(*core[:9], core[9].reshape(1, 32), *core[10:])
    with pytest.raises(ValueError, match="tp must be"):
        kernels.sim_mlp_forward(sp, tp[:, :4].contiguous(), *core[2:])


def test_idam_on_card_against_cpu(cuda):
    """IDAM at the smoke size (emb 32, 2 iterations, 4 pairs of 128 points,
    M 21), the same seeded weights on both devices, held as
    chip_smoke.check_idam_batch_on_cpu holds two full-width pairs: the GNN
    embeddings normwise within 2e-2; kept points and correspondences
    flipped counted; with the card's kept points on both devices, each pair
    without a flipped correspondence within chip_smoke.IDAM_CPU_ATOL."""
    import chip_smoke
    from mvp_benchmark_tpu_torch.train import engine
    from mvp_benchmark_tpu_torch.train.config import load_config

    cfg = load_config("registration/cfgs/idam_smoke.yaml")
    batch = next(engine.registration_dataset(cfg, "val", "nodata").batches(
        engine.BatchSpec(4)))
    chip_smoke.check_idam_batch_on_cpu(cfg, cuda, batch, clouds_cut=4)


# ---------------------------------------------------------------------------
# IDAM training: the edge block's and the similarity MLP's stat, train final
# and backward passes (rows 17-19)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,N,k,C,dup", [(2, 2048, 12, 64, False), (3, 1001, 12, 32, False),
                                         (2, 37, 5, 64, False), (2, 300, 12, 64, True)])
def test_gnn_propagate_train_kernels_match_plain_version(cuda, B, N, k, C, dup):
    """Through ``dispatch.gnn_propagate(train=True)`` and autograd: the
    statistics normwise within chip_smoke.IDAM_STAT_NORM of the plain
    version's, the output within the final pass's bar of the plain
    version's given them and the slots by its slot rule
    (``chip_smoke.check_propagate_final``), every gradient normwise within
    chip_smoke.IDAM_GRAD_NORM of ``ref.gnn_propagate_backward``'s on the
    kernels' statistics and slots; launches: one stat, one final pass, two
    backward and the list the backward builds when given none; with the
    list given, no list and the same gradients; two runs bitwise equal."""
    import chip_smoke

    p, idx, W, b, gamma, beta, mean, var = _propagate_case(cuda, B, N, k, C, dup)
    leaves = [x.clone().requires_grad_() for x in (p, W, b, gamma, beta)]
    dx = torch.randn(p.shape, device=cuda, generator=torch.Generator(device="cuda").manual_seed(1))
    runs = []
    for _ in range(2):
        before = kernels.launch_counts()
        x, stats = dispatch.gnn_propagate(leaves[0], idx, *leaves[1:], mean, var, train=True)
        grads = torch.autograd.grad(x, leaves, dx)
        torch.cuda.synchronize()
        after = kernels.launch_counts()
        assert {key: after[key] - before[key] for key in after if after[key] != before[key]} == {
            "gnn_propagate_stat": 1, "gnn_propagate": 1, "gnn_propagate_backward": 2,
            "gnn_propagate_list": 1}
        runs.append((x, stats, *grads))
    assert all(torch.equal(a, c) for a, c in zip(*runs))
    lst = dispatch.gnn_propagate_list(idx, N)
    before = kernels.launch_counts()
    x, _ = dispatch.gnn_propagate(leaves[0], idx, *leaves[1:], mean, var, train=True, lst=lst)
    shared = torch.autograd.grad(x, leaves, dx)
    after = kernels.launch_counts()
    assert after["gnn_propagate_list"] == before["gnn_propagate_list"]
    assert all(torch.equal(a, c) for a, c in zip(shared, runs[0][2:]))
    x, stats, *grads = runs[0]
    rel = lambda g, w: float((g - w).double().norm() / w.double().norm())
    assert rel(stats, ref.gnn_propagate_stats(p, idx)) <= chip_smoke.IDAM_STAT_NORM
    _, _, slot = kernels.gnn_propagate_train_forward(p, idx, W, b, gamma, beta)
    chip_smoke.check_propagate_final(
        "gnn_propagate train", x,
        ref.gnn_propagate_candidates(p, idx, W, b, gamma, beta, stats[0], stats[1]), slot)
    want = ref.gnn_propagate_backward(p, idx, W, gamma, beta, stats, slot, dx)
    gaps = {name: rel(g, w) for name, g, w in
            zip(("d_p", "dW", "db", "dgamma", "dbeta"), grads, want)}
    assert max(gaps.values()) <= chip_smoke.IDAM_GRAD_NORM, gaps


@pytest.mark.parametrize("B,N,k,C", [(2, 2048, 12, 64), (3, 1001, 12, 32), (2, 37, 5, 64),
                                     (2, 100, 32, 64), (1, 3, 1, 32)])
def test_gnn_propagate_stat_pass_is_the_ordered_plain_version_bitwise(cuda, B, N, k, C):
    """The stat pass's per-block partials and its wrapper's statistics
    bitwise those of the plain version in its summation order
    (``ref.gnn_propagate_partials_ordered``, ``gnn_propagate_stats_ordered``
    with the wrapper's block count), also at the most neighbours it takes
    (k 32: two stages of rows in shared memory instead of four); a
    neighbour index outside [0, N) makes NaN where the plain version's
    does."""
    p, idx = _propagate_case(cuda, B, N, k, C)[:2]
    blocks = kernels._max_blocks(cuda)
    got = kernels.gnn_propagate_stat_partials(p, idx)
    assert torch.equal(got, ref.gnn_propagate_partials_ordered(p, idx, blocks))
    assert torch.equal(kernels.gnn_propagate_batch_stats(p, idx),
                       ref.gnn_propagate_stats_ordered(p, idx, blocks))
    idx[0, N - 1, k - 1] = N
    got = kernels.gnn_propagate_stat_partials(p, idx)
    want = ref.gnn_propagate_partials_ordered(p, idx, blocks)
    assert torch.equal(got.isnan(), want.isnan()) and bool(got.isnan().any())
    assert torch.equal(got.nan_to_num(), want.nan_to_num())


@pytest.mark.parametrize("B,N,K", [(2, 2048, 20), (3, 1001, 7), (2, 37, 20), (1, 21, 20),
                                   (2, 5, 1)])
def test_edge_mlp_stat_passes_match_plain_given_the_layers_below(cuda, B, N, K):
    """The four stat passes within chip_smoke.EDGE_STAT_NORM normwise of
    ``ref.edge_mlp_stats_given`` on their own statistics for the layers
    below (the same folded BatchNorm; the tensor cores sum in another
    order), at B N k edges no multiple of the 64-edge tile down to 10; two
    runs bitwise equal."""
    import chip_smoke

    a1, Ws, gammas, betas, _ = _edge_train_case(cuda, B, N, K)
    ws = [w.to(torch.bfloat16).contiguous() for w in Ws]
    got = kernels.edge_mlp_batch_stats(a1, ws, gammas, betas)
    want = ref.edge_mlp_stats_given(a1, Ws, gammas, betas, got)
    for g, w in zip(got, want):
        assert g.shape == w.shape and _normwise(g, w) <= chip_smoke.EDGE_STAT_NORM
    assert all(torch.equal(a, b) for a, b in
               zip(got, kernels.edge_mlp_batch_stats(a1, ws, gammas, betas)))


@pytest.mark.parametrize("B,M,ties", [(2, 341, False), (3, 37, False), (2, 64, True),
                                      (1, 2, False)])
def test_sim_mlp_train_kernels_match_plain_version(cuda, B, M, ties):
    """Through ``dispatch.sim_mlp(train=True)`` and autograd: the two
    statistics normwise within chip_smoke.IDAM_STAT_NORM, sim, wmax and the
    saved j against the plain version's on the kernels' statistics by
    ``chip_smoke.check_sim_final`` (its bar, bf16(wmax) equal, a j other
    than the plain version's only at a near tie), the gradients of
    the embeddings and of every parameter normwise within 5e-3 of the plain
    version's on the kernels' statistics and argmax (``ref.sim_mlp_backward``
    under the same projections): the weights' gradients and those of the
    embeddings through the bf16 projections round to bf16, where the
    kernel's and the plain version's fp32 sums may fall on either side of a
    boundary (4.1e-4 measured on an H100 80GB HBM3 at 700 W; the pairwise
    chain's own outputs are held within chip_smoke.IDAM_GRAD_NORM in
    chip_smoke.py); launches: two stat, one final pass, three backward; two
    runs bitwise equal."""
    import chip_smoke

    x = _sim_case(cuda, B, M, ties=ties)
    leaves = [t.clone().requires_grad_() for t in x[2:14]]
    g = torch.Generator(device="cuda").manual_seed(M)
    dsim = torch.randn((B, M, M), device=cuda, generator=g)
    dwmax = torch.randn((B, M, 32), device=cuda, generator=g)
    runs = []
    for _ in range(2):
        before = kernels.launch_counts()
        sim, wmax, (st1, st2) = dispatch.sim_mlp(x[0], x[1], *leaves, *x[14:], train=True)
        grads = torch.autograd.grad((sim, wmax), leaves, (dsim, dwmax))
        torch.cuda.synchronize()
        after = kernels.launch_counts()
        assert {key: after[key] - before[key] for key in after if after[key] != before[key]} == {
            "sim_mlp_stat": 2, "sim_mlp": 1, "sim_mlp_backward": 3}
        runs.append((sim, wmax, st1, st2, *grads))
    assert all(torch.equal(a, c) for a, c in zip(*runs))
    sim, wmax, st1, st2, *grads = runs[0]
    rel = lambda a, w: float((a - w).double().norm() / w.double().norm())
    sp, tp = ref.sim_projections(x[2], x[3], x[4])
    core = (sp, tp, x[0], x[1], *ref.sim_mlp_split(x[4], 64), *x[5:9], *x[10:14])
    for got, want in zip((st1, st2), ref.sim_mlp_batch_stats(*core[:9], *core[10:12])):
        assert rel(got, want) <= chip_smoke.IDAM_STAT_NORM
    simr, want_wmax, want_argj = ref.sim_mlp_slots(*core, st1, st2)
    argj = kernels.sim_mlp_train_forward(*core)[4]
    chip_smoke.check_sim_final(f"sim_mlp train ({B}, {M})", (sim, wmax, argj),
                               (ref.sim_logits(simr, x[9]), want_wmax, want_argj),
                               ref.sim_h1(*core[:8], *core[10:12], st1))
    # the plain chain's backward on the kernels' statistics, then autograd of
    # the projections and the logits' bias and clip
    plain = [t.clone().requires_grad_() for t in x[2:14]]
    sp, tp = ref.sim_projections(plain[0], plain[1], plain[2])
    w0, wxyz = ref.sim_mlp_split(plain[2], 64)
    simr_p = simr.clone().requires_grad_()
    dsimr, = torch.autograd.grad(ref.sim_logits(simr_p, plain[7]), simr_p, dsim)
    back = ref.sim_mlp_backward(sp.detach(), tp.detach(), x[0], x[1], w0.detach(),
                                wxyz.detach(), *x[5:9], *x[10:14], st1, st2, argj, dsimr,
                                dwmax)
    dsp, dtp, dw0, dwxyz, dW2, db2, dW3, dW4, dg1, dbe1, dg2, dbe2 = back
    outs = (sp, tp, w0, wxyz, ref.sim_logits(simr_p, plain[7]))
    want = torch.autograd.grad(outs, plain, (dsp, dtp, dw0, dwxyz, dsim), allow_unused=True)
    extra = {3: dW2, 4: db2, 5: dW3, 6: dW4, 8: dg1, 9: dbe1, 10: dg2, 11: dbe2}
    names = ("semb", "temb", "Wcat", "W2", "b2", "W3", "W4", "b4", "g1", "be1", "g2", "be2")
    gaps = {name: rel(got, extra.get(i, want[i])) for i, (name, got) in
            enumerate(zip(names, grads))}
    assert max(gaps.values()) <= 5e-3, gaps


@pytest.mark.parametrize("B,M,ties", [(1, 1, False), (3, 37, False), (2, 341, False),
                                      (2, 64, True)])
def test_sim_mlp_backward_ragged_tiles_match_plain_and_rerun_bitwise(cuda, B, M, ties):
    """The three backward passes where M is no multiple of the kernel's
    16-row tile (1, 37, 341) and with ties (repeated targets), on the
    kernel forward's statistics and argj, against ``ref.sim_mlp_backward``:
    the fp32 outputs normwise within chip_smoke.IDAM_GRAD_NORM (a one-pair
    batch's exact zeros exactly); dwxyz, dW2 and dW3, bf16 roundings of
    sums over every pair that the kernel and the plain version take in
    other orders, within one bf16 ulp of it elementwise (a single element
    whose sums fall on either side of a rounding boundary moves by an ulp,
    as ``test_sim_mlp_train_kernels_match_plain_version`` notes); two runs
    bitwise equal."""
    import chip_smoke

    x = _sim_case(cuda, B, M, ties=ties)
    sp, tp = ref.sim_projections(x[2], x[3], x[4])
    core = (sp, tp, x[0], x[1], *ref.sim_mlp_split(x[4], 64), *x[5:9], *x[10:14])
    g = torch.Generator(device="cuda").manual_seed(M)
    dsimr = torch.randn((B, M, M), device=cuda, generator=g)
    dwmax = torch.randn((B, M, 32), device=cuda, generator=g)
    _, _, st1, st2, argj = kernels.sim_mlp_train_forward(*core)
    got = kernels.sim_mlp_train_backward(*core, st1, st2, argj, dsimr, dwmax)
    again = kernels.sim_mlp_train_backward(*core, st1, st2, argj, dsimr, dwmax)
    want = ref.sim_mlp_backward(*core, st1, st2, argj, dsimr, dwmax)
    for i, (gl, wl) in enumerate(zip(got, want)):
        assert gl.shape == wl.shape
        if i in (3, 4, 6):                       # dwxyz, dW2, dW3: bf16 roundings
            assert bool(((gl - wl).abs() <= wl.abs() * 2 ** -7).all()), i
        else:
            gap, norm = float((gl - wl).double().norm()), float(wl.double().norm())
            assert gap <= chip_smoke.IDAM_GRAD_NORM * norm, i
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_idam_train_wrappers_reject_bad_inputs(cuda):
    p, idx, W, b, gamma, beta, _, _ = _propagate_case(cuda, 1, 40, 4, 64)
    _, stats, slot = kernels.gnn_propagate_train_forward(p, idx, W, b, gamma, beta)
    with pytest.raises(ValueError, match="limit"):
        big = idx.repeat(1, 1, 9)
        kernels.gnn_propagate_train_forward(p, big.contiguous(), W, b, gamma, beta)
    with pytest.raises(TypeError, match="uint8"):
        kernels.gnn_propagate_train_backward(p, idx, W, gamma, beta, stats, slot.int(), p)
    with pytest.raises(ValueError, match="dx must be"):
        kernels.gnn_propagate_train_backward(p, idx, W, gamma, beta, stats, slot,
                                             p[:, :20].contiguous())
    order, off = kernels.gnn_propagate_list(idx, 40)
    with pytest.raises(ValueError, match="order must be"):
        kernels.gnn_propagate_train_backward(p, idx, W, gamma, beta, stats, slot, p,
                                             lst=(order[:-1], off))
    x = list(_sim_case(cuda, 1, 8))
    sp, tp = ref.sim_projections(x[2], x[3], x[4])
    core = [sp, tp, x[0], x[1], *ref.sim_mlp_split(x[4], 64), *x[5:9], *x[10:14]]
    simr, wmax, st1, st2, argj = kernels.sim_mlp_train_forward(*core)
    with pytest.raises(ValueError, match="dsimr must be"):
        kernels.sim_mlp_train_backward(*core, st1, st2, argj, simr[:, :4].contiguous(), wmax)
    with pytest.raises(TypeError, match="int32"):
        kernels.sim_mlp_train_backward(*core, st1, st2, argj.long(), simr, wmax)


def test_idam_train_step_on_card_against_cpu(cuda):
    """An IDAM train step at the smoke size (emb 32, 2 iterations, 4 pairs
    of 128 points of the train split, M 21), held as
    chip_smoke.check_idam_step_on_cpu holds two full-width pairs: the same
    kept points, gt-match and correspondence flips counted, then with the
    card's selections on the CPU the loss, every gradient leaf and the
    running statistics within chip_smoke.IDAM_STEP_BARS."""
    import chip_smoke
    from mvp_benchmark_tpu_torch.train.config import load_config

    cfg = load_config("registration/cfgs/idam_smoke.yaml")
    saved = chip_smoke.REG_DATA_DIR
    chip_smoke.REG_DATA_DIR = "nodata"
    try:
        chip_smoke.check_idam_step_on_cpu(cfg, cuda, clouds_cut=4)
    finally:
        chip_smoke.REG_DATA_DIR = saved


def test_sim_mlp_train_backward_skips_the_inputs_pass_when_not_asked(cuda):
    """Only the parameters after the first layer need a gradient: the third
    backward pass (dsp, dtp, dw0, dWxyz) is not launched, and W2's gradient
    equals the one a full backward gives, bitwise."""
    x = list(_sim_case(cuda, 2, 64))
    W2 = x[5].clone().requires_grad_()
    sim, wmax, _ = dispatch.sim_mlp(*x[:5], W2, *x[6:], train=True)
    before = kernels.SIM_MLP_BWD_LAUNCHES
    (g,) = torch.autograd.grad(sim.sum() + wmax.sum(), W2)
    torch.cuda.synchronize()
    assert kernels.SIM_MLP_BWD_LAUNCHES == before + 2
    semb = x[2].clone().requires_grad_()
    W2b = x[5].clone().requires_grad_()
    sim, wmax, _ = dispatch.sim_mlp(*x[:2], semb, *x[3:5], W2b, *x[6:], train=True)
    before = kernels.SIM_MLP_BWD_LAUNCHES
    _, g_full = torch.autograd.grad(sim.sum() + wmax.sum(), (semb, W2b))
    torch.cuda.synchronize()
    assert kernels.SIM_MLP_BWD_LAUNCHES == before + 3
    torch.testing.assert_close(g, g_full, rtol=0, atol=0)
