#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``mvp_benchmark_tpu_torch``) on one
NVIDIA card -- the quickest proof that the port still starts on the GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0):

1. needs ``torch.cuda.is_available()``; prints the card's name and power limit;
2. builds the CUDA kernels from ``mvp_benchmark_tpu_torch/ops/csrc`` with nvcc;
3. holds each kernel against its plain PyTorch version on the card, at the
   shapes of the main paths plus ragged and duplicate-point cases: indices
   equal, distances and values bitwise equal (0 ulp); the SA block, which
   sums in another order, within |kernel - plain| <= 1e-5 + 1e-4 |plain|;
4. drives each main path through the functions ``completion/test_torch.py``
   calls, with seeded weights, over the synthetic val pass (cd_p, cd_t, f1)
   and test pass (52 predictions): full-width PCN from
   ``completion/cfgs/pcn.yaml``, ECG from ``completion/cfgs/ecg.yaml`` and
   VRCNet from ``completion/cfgs/vrcnet.yaml``, each with the launch counts
   zeroed just before and read just after (ECG's and VRCNet's counts must
   equal the ones derived from the model's code);
5. checks the results: finite, of the expected shape, metrics equal to the
   ones recomputed with the plain chamfer on the card (rtol 1e-6), a val
   batch equal to the same model run on the CPU (PCN outputs atol 1e-5 /
   rtol 1e-4; ECG's and VRCNet's coarse output likewise and their fine
   output as a cloud, see ``check_batch_on_cpu_as_cloud``), and cd_p/cd_t/f1
   of clouds near gt equal to the CPU's (rtol 1e-6);
6. times the val and test passes per batch, and each kernel against its
   plain version (and a single PyTorch call computing the same function,
   where one exists) at a main-path shape, beside the least time the card
   could take (``bound_ms``).

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from mvp_benchmark_tpu_torch.metrics import calc_cd, fscore
from mvp_benchmark_tpu_torch.ops import kernels, ref
from mvp_benchmark_tpu_torch.data.mvp import BatchSpec, MVPCompletionDataset
from mvp_benchmark_tpu_torch.train import engine, submission
from mvp_benchmark_tpu_torch.train.meters import AverageValueMeter
from mvp_benchmark_tpu_torch.train.config import load_config

ROOT = os.path.dirname(os.path.abspath(__file__))
PCN_CFG = os.path.join(ROOT, "completion", "cfgs", "pcn.yaml")
ECG_CFG = os.path.join(ROOT, "completion", "cfgs", "ecg.yaml")
VRCNET_CFG = os.path.join(ROOT, "completion", "cfgs", "vrcnet.yaml")
DATA_DIR = os.path.join(ROOT, "completion", "data")   # test_torch.py's default

# H100 SXM peaks (NVIDIA's data sheet, at the 700 W limit): fp32 outside the
# tensor cores, and device memory.
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12

_PK = "mvp_benchmark_tpu/ops/pallas_kernels.py"
_CSRC = "mvp_benchmark_tpu_torch/ops/csrc"
KERNELS = {   # launch-count key -> the kernel's identity in the kernels line
    "chamfer": {"name": "chamfer_forward", "source": f"{_CSRC}/chamfer.cu",
                "replaces": f"{_PK}:133"},
    "knn": {"name": "knn", "source": f"{_CSRC}/knn.cu",
            "replaces": f"{_PK}:714"},
    "fps": {"name": "furthest_point_sample", "source": f"{_CSRC}/fps.cu",
            "replaces": f"{_PK}:498"},
    "gather": {"name": "gather_rows", "source": f"{_CSRC}/gather.cu",
               "replaces": f"{_PK}:1712"},
    "group_max": {"name": "group_max_forward", "source": f"{_CSRC}/gather.cu",
                  "replaces": f"{_PK}:887"},
    "three_interpolate": {"name": "three_interpolate_forward",
                          "source": f"{_CSRC}/gather.cu",
                          "replaces": f"{_PK}:1050"},
    "sa_attention": {"name": "sa_attention_forward",
                     "source": f"{_CSRC}/sa_attention.cu",
                     "replaces": f"{_PK}:1354"},
}

# ECG's kernel launches per forward pass, read off models/ecg.py and
# models/common.py: kNN 4 DenseConv self-kNN + 3 edge_preserve_sampling
# knn_points + 3 three_nn; FPS 3 edge_preserve_sampling + 1 on the 3072
# predicted points; gather 2 per edge_preserve_sampling + 4 DenseEdge
# neighbour gathers + 1 after the final FPS; group_max 3; three_interpolate 3.
# calc_cd adds one chamfer launch per val batch.
ECG_PER_BATCH = {"knn": 10, "fps": 4, "gather": 11, "group_max": 3,
                 "three_interpolate": 3}
# VRCNet's, read off models/vrcnet.py and models/common.py at
# completion/cfgs/vrcnet.yaml (knn_list 16, pk 10, layers 1,1,1,1, 3072
# encoder points, num_fps = num_coarse = num_points): kNN 4 self-kNN of the
# pyramid levels + 3 three_nn (edge_preserve_sampling reuses the k 16 self-kNN
# rows, so it launches no kNN); FPS 3 edge_preserve_sampling + 1 of the 3072
# predicted points to 2048; gather 2 per edge_preserve_sampling + 2 after that
# FPS; group_max 3; three_interpolate 3; sa_attention one per SK-SA level (one
# SA branch, one layer each). No score top-k or folding: 2048 points leave the
# FPS, as many as num_coarse and num_points.
VRCNET_PER_BATCH = {"knn": 7, "fps": 4, "gather": 8, "group_max": 3,
                    "three_interpolate": 3, "sa_attention": 4}
# The SA block's tolerance against its plain version on the card:
# |kernel - plain| <= SA_ATOL + SA_RTOL |plain| (another summation order).
SA_ATOL, SA_RTOL = 1e-5, 1e-4


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def uniform(seed, shape, device):
    rng = np.random.default_rng([seed, *shape])
    return torch.from_numpy(rng.random(shape, dtype=np.float64)
                            .astype(np.float32)).to(device)


def indices(seed, high, shape, device):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, high, shape, generator=g, dtype=torch.int32).to(device)


def clouds(seed, B, N, M, device):
    rng = np.random.default_rng(seed)
    a = rng.random((B, N, 3), dtype=np.float64).astype(np.float32)
    b = rng.random((B, M, 3), dtype=np.float64).astype(np.float32)
    return torch.from_numpy(a).to(device), torch.from_numpy(b).to(device)


def duplicate_clouds(device):
    """Exact ties, within a shared-memory tile and across tiles."""
    a, b = clouds(9, 4, 2048, 2048, device)
    b[:, 1024:] = b[:, :1024]         # b[j + 1024] == b[j]: across tiles
    b[:, 10:20] = b[:, 0:10]          # within a tile
    a[:, :512] = b[:, 100:612]        # exact hits on duplicated b points
    a[:, 1500:1600] = a[:, 0:100]
    return a, b


def check_equal(name, got, want):
    """Indices equal and float values bitwise equal (0 ulp apart); returns
    the largest absolute difference of the float outputs."""
    max_abs = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        check(g.shape == w.shape and g.dtype == w.dtype,
              f"{name} output {i}: {g.shape}/{g.dtype} vs {w.shape}/{w.dtype}")
        if g.dtype == torch.float32:
            max_abs = max(max_abs, float((g - w).abs().max()))
            g, w = g.view(torch.int32), w.view(torch.int32)
        bad = int((g != w).sum())
        check(bad == 0, f"{name} output {i}: {bad} of {g.numel()} differ")
    print(f"kernel == plain: {name}: indices equal, values 0 ulp apart")
    return max_abs


def check_close(name, got, want):
    """|got - want| <= SA_ATOL + SA_RTOL |want| everywhere; returns the
    largest absolute difference."""
    check(got.shape == want.shape and got.dtype == want.dtype,
          f"{name}: {got.shape}/{got.dtype} vs {want.shape}/{want.dtype}")
    diff = (got - want).abs()
    bad = int((~(diff <= SA_ATOL + SA_RTOL * want.abs())).sum())
    max_abs = float(diff.max())
    check(bad == 0, f"{name}: {bad} of {got.numel()} outside the tolerance, "
          f"max |diff| {max_abs!r}")
    print(f"kernel ~ plain: {name}: max |diff| {max_abs!r} within "
          f"{SA_ATOL} + {SA_RTOL} |plain|")
    return max_abs


def sa_inputs(seed, B, N, k, rel, mid, device, share=8):
    """The SA block's inputs: unit-scale proj and x1 in [-0.5, 0.5), weights
    at torch's init scale (the model's), neighbour indices uniform."""
    ms = mid // share
    proj = uniform(seed, (B, N, rel + mid), device) - 0.5
    x1 = uniform(seed + 1, (B, N, rel), device) - 0.5
    idx = indices(seed + 2, N, (B, N, k), device)
    b1, b2 = ((1 + k) * rel) ** -0.5, ms ** -0.5
    W1 = (uniform(seed + 3, ((1 + k) * rel, ms), device) * 2 - 1) * b1
    W2 = (uniform(seed + 4, (ms, k * ms), device) * 2 - 1) * b2
    bias = (uniform(seed + 5, (k * ms,), device) * 2 - 1) * b2
    return proj, x1, idx, W1, W2, bias


def compare_kernels_with_plain(device):
    """Phase 3. Returns {launch-count key: max |kernel - plain|}."""
    err = {k: 0.0 for k in KERNELS}

    cases = {
        "random_32x2048x2048": clouds(0, 32, 2048, 2048, device),
        "random_2x96x50": clouds(1, 2, 96, 50, device),
        "duplicates_4x2048x2048": duplicate_clouds(device),
    }
    for name, (a, b) in cases.items():
        err["chamfer"] = max(err["chamfer"], check_equal(
            f"chamfer {name}", kernels.chamfer_forward(a, b),
            ref.chamfer_distance(a, b)))

    x1 = uniform(1, (32, 3072, 3), device)          # ECG's encoder points
    x2 = x1[:, :1024].contiguous()
    f1 = uniform(2, (32, 3072, 24), device)         # DenseConv 1's features
    dup = uniform(3, (4, 3072, 3), device)
    dup[:, 1536:] = dup[:, :1536]
    dup[:, 7] = dup[:, 3000]
    knn_cases = {
        "self_32x3072x3072_C24_k16": (f1, f1, 16),
        "feature_32x1024x1024_C48_k16": (uniform(4, (32, 1024, 48), device),) * 2 + (16,),
        "knn_points_32x1024x3072_C3_k16": (x2, x1, 16),
        "three_nn_32x3072x1024_C3_k3": (x1, x2, 3),
        "duplicates_4x3072x3072_C3_k16": (dup, dup, 16),
        "ragged_2x96x200_C3_k16": (uniform(5, (2, 96, 3), device),
                                   uniform(6, (2, 200, 3), device), 16),
    }
    for name, (q, p, k) in knn_cases.items():
        err["knn"] = max(err["knn"], check_equal(
            f"knn {name}", kernels.knn(q, p, k), ref.knn(q, p, k)))

    for name, (x, s) in {"32x3072->2048": (x1, 2048), "32x3072->1024": (x1, 1024),
                         "duplicates_4x3072->2048": (dup, 2048),
                         "ragged_3x200->24": (uniform(7, (3, 200, 3), device), 24)}.items():
        got = kernels.furthest_point_sample(x, s)
        want = ref.furthest_point_sample(x, s)
        err["fps"] = max(err["fps"], check_equal(f"fps {name}", [got], [want]))

    t120 = uniform(8, (32, 3072, 120), device)
    t24 = uniform(9, (32, 3072, 24), device)
    p_idx = indices(10, 3072, (32, 1024), device)
    edge_idx = indices(11, 3072, (32, 3072, 16), device)
    gather_cases = {
        "points_32x3072x3_by_1024": (x1, p_idx),
        "features_32x3072x120_by_1024": (t120, p_idx),
        "dense_edge_32x3072x24_by_3072x16": (t24, edge_idx),
    }
    for name, (f, idx) in gather_cases.items():
        err["gather"] = max(err["gather"], check_equal(
            f"gather_rows {name}", [kernels.gather_rows(f, idx)],
            [ref.gather_points(f, idx)]))

    for (n, c, m) in ((3072, 120, 1024), (1024, 360, 256), (256, 840, 64)):
        f = uniform(12 + n, (32, n, c), device)
        idx = indices(13 + n, n, (32, m, 16), device)
        err["group_max"] = max(err["group_max"], check_equal(
            f"group_max {n}x{c}->{m}", kernels.group_max_forward(f, idx),
            ref.group_max(f, idx)))

    for (ms, c, n) in ((64, 1024, 256), (256, 768, 1024), (1024, 512, 3072)):
        f = uniform(14 + ms, (32, ms, c), device) - 0.5
        src = uniform(15 + ms, (32, ms, 3), device)
        tgt = uniform(16 + ms, (32, n, 3), device)
        idx, w = ref.three_nn_upsampling(tgt, src)
        err["three_interpolate"] = max(err["three_interpolate"], check_equal(
            f"three_interpolate {ms}x{c}->{n}",
            [kernels.three_interpolate_forward(f, idx, w)],
            [ref.three_interpolate(f, idx, w)]))

    # VRCNet's four SK-SA levels at full width, then ragged N and k 8/32.
    for (B, n, k, rel, mid) in ((32, 3072, 16, 4, 16), (32, 1536, 16, 8, 32),
                                (32, 768, 16, 16, 64), (32, 384, 16, 32, 128),
                                (3, 97, 8, 4, 16), (2, 1001, 8, 32, 128),
                                (2, 333, 32, 16, 64)):
        args = sa_inputs(30 + n, B, n, k, rel, mid, device)
        err["sa_attention"] = max(err["sa_attention"], check_close(
            f"sa_attention ({B}, {n}, k {k}, rel {rel}, mid {mid})",
            kernels.sa_attention_forward(*args, rel, mid, 8),
            ref.sa_attention(*args, rel, mid, 8)))
    torch.cuda.synchronize()
    return err


def drive_slice(cfg, device):
    """The main path, as test_torch.py runs it: --val, then the test pass."""
    val = engine.run_completion_val(cfg, DATA_DIR, device)
    preds = submission.predict_completion_test(cfg, DATA_DIR, device)
    torch.cuda.synchronize()
    return val, preds


def drive_path(name, cfg, device, expected):
    """Phase 4 for one path: counts zeroed just before, read just after, and
    equal to ``expected`` ({key: count}, derived from the model's code)."""
    kernels.reset_launch_counts()
    val, preds = drive_slice(cfg, device)
    launches = kernels.launch_counts()
    print(f"{name} main path launches: {launches}")
    check(launches == expected,
          f"{name}: launches {launches}, expected {expected}")
    return val, preds, launches


def _batches(cfg):
    spec = BatchSpec(int(cfg.batch_size))
    n = int(cfg.num_points)
    return (MVPCompletionDataset("val", DATA_DIR, n).steps_per_epoch(spec),
            MVPCompletionDataset("test", DATA_DIR, n).steps_per_epoch(spec))


def expected_counts(cfg, per_batch):
    """``per_batch`` launches in every val and test batch, plus one chamfer
    launch per val batch (calc_cd); 0 for every other kernel."""
    val_b, test_b = _batches(cfg)
    counts = dict.fromkeys(KERNELS, 0)
    counts.update({k: v * (val_b + test_b) for k, v in per_batch.items()})
    counts["chamfer"] = val_b
    return counts


def check_metrics(name, cfg, device, val, preds):
    """Finite results of the expected shape, and the val metrics equal to the
    ones recomputed with the plain chamfer on the card."""
    n = int(cfg.num_points)
    check(sorted(val) == ["cd_p", "cd_t", "f1"], f"{name} val metrics {sorted(val)}")
    check(all(np.isfinite(v) for v in val.values()), f"{name} val metrics {val}")
    check(preds.shape == (52, n, 3), f"{name} test predictions {preds.shape}")
    check(bool(np.isfinite(preds).all()), f"{name}: non-finite test predictions")

    model = engine.build_model(cfg, device)
    step = engine.make_eval_step(model, device)
    dataset = MVPCompletionDataset("val", DATA_DIR, n)
    sums, total, first = {m: 0.0 for m in val}, 0, None
    for batch in dataset.batches(BatchSpec(int(cfg.batch_size))):
        count = int(batch["count"])
        out2 = step(batch, prefix="test")["result"]
        with torch.inference_mode():
            gt = torch.as_tensor(batch["gt"]).to(device)
            d1, d2, _, _ = ref.chamfer_distance(gt, out2)
            per = {"cd_p": (d1.sqrt().mean(1) + d2.sqrt().mean(1)) / 2.0,
                   "cd_t": d1.mean(1) + d2.mean(1),
                   "f1": fscore(d1, d2)[0]}
        for m in sums:
            sums[m] += float(per[m][:count].mean().cpu()) * count
        total += count
        if first is None:
            first = batch
    for m, v in val.items():
        want = sums[m] / total
        check(abs(v - want) <= 1e-6 * abs(want),
              f"{name} {m}: kernel path {v!r} vs plain chamfer {want!r}")
    print(f"{name} val metrics == plain-chamfer metrics (rtol 1e-6): "
          + ", ".join(f"{m} {v!r}" for m, v in val.items()))
    return step, first


def check_pcn_batch_on_cpu(cfg, step, first):
    """One full-width PCN val batch on the CPU, plain versions throughout."""
    cpu = torch.device("cpu")
    got = step(first, prefix="val")
    want = engine.make_eval_step(engine.build_model(cfg, cpu), cpu)(first, "val")
    for k in ("out1", "out2"):
        torch.testing.assert_close(got[k].cpu(), want[k], rtol=1e-4, atol=1e-5)
    for k in ("cd_p", "cd_t"):
        torch.testing.assert_close(got[k].cpu(), want[k], rtol=1e-4, atol=0)
    print("PCN card == CPU on a full-width val batch: out1/out2 (atol 1e-5, "
          "rtol 1e-4), cd_p/cd_t (rtol 1e-4)")


# ECG's and VRCNet's fine output on the card against the CPU, as clouds: at
# most this share of the points of either cloud may lie further than a tenth
# of the cloud's mean spacing from every point of the other
# (check_batch_on_cpu_as_cloud).
MOVED_SHARE = 0.02


def check_batch_on_cpu_as_cloud(name, cfg, step, first, clouds_cut=2):
    """One full-width val batch, cut to ``clouds_cut`` clouds, on the card
    and on the CPU (plain versions throughout, the same latent noise).

    out1 (the coarse head: plain matmuls, no kNN) is held at PCN's bar. out2
    comes through selections over activations that cuBLAS and the CPU round
    differently in the last bits: ECG's feature-space kNN of four DenseConv
    blocks and FPS of the 3072 predicted points, VRCNet's FPS of its 3072
    predicted points and the 3-D kNN of the coarse head's GEMM outputs. A
    near tie can then take another neighbour or another sample, which moves a
    point by up to the cloud's spacing, legitimately. So out2 is held as a
    cloud: at most 2% of the points of either cloud may lie further than a
    tenth of the cloud's mean nearest-neighbour spacing from every point of
    the other. A point that took another neighbour set counts as moved; fp32
    rounding of the coordinates (~1e-7 relative) does not."""
    cpu = torch.device("cpu")
    batch = {k: (v[:clouds_cut] if isinstance(v, np.ndarray) and v.ndim else v)
             for k, v in first.items()}
    got = step(batch, prefix="val")
    want = engine.make_eval_step(engine.build_model(cfg, cpu), cpu)(batch, "val")
    torch.testing.assert_close(got["out1"].cpu(), want["out1"], rtol=1e-4, atol=1e-5)
    spacing = float(ref.knn(want["out2"], want["out2"], 2)[0][..., 1].sqrt().mean())
    near = 0.1 * spacing
    d1, d2, _, _ = ref.chamfer_distance(got["out2"].cpu(), want["out2"])
    moved = max(float((d1.sqrt() > near).float().mean()),
                float((d2.sqrt() > near).float().mean()))
    cd_t = (d1.mean(1) + d2.mean(1)).tolist()
    print(f"{name} card vs CPU on {clouds_cut} full-width clouds: out1 equal "
          f"(atol 1e-5, rtol 1e-4); out2 share of points further than "
          f"{near!r} from the other cloud {moved!r} (bar {MOVED_SHARE}), "
          f"cd_t(card, cpu) per cloud {cd_t!r}, mean spacing {spacing!r}, "
          f"max |out2 diff| "
          f"{float((got['out2'].cpu() - want['out2']).abs().max())!r}")
    check(moved <= MOVED_SHARE,
          f"{name} out2 card vs CPU: {moved} of the points moved")


def check_f1_near(device, first):
    """Random weights put every prediction far from gt (f1 = 0), so the F1
    threshold is checked on clouds near gt: kernel on the card against the
    plain version on the CPU (distances are correctly rounded on both)."""
    gt = torch.as_tensor(first["gt"])
    rng = np.random.default_rng(4)
    near = gt[:, rng.permutation(gt.shape[1])] + torch.from_numpy(
        rng.normal(0.0, 0.012, tuple(gt.shape)).astype(np.float32))
    got = calc_cd(near.to(device), gt.to(device), calc_f1=True)
    want = calc_cd(near, gt, calc_f1=True)
    check(0.05 < float(want[2].min()) and float(want[2].max()) < 0.95,
          f"f1 check not in its range: {want[2]}")
    for g, w in zip(got, want):
        torch.testing.assert_close(g.cpu(), w, rtol=1e-6, atol=0)
    print(f"calc_cd on near clouds, card == CPU (rtol 1e-6): mean f1 "
          f"{float(want[2].mean())!r}")


def time_passes(name, cfg, device, card, repeats=3):
    n = int(cfg.num_points)
    model = engine.build_model(cfg, device)
    step = engine.make_eval_step(model, device)
    spec = BatchSpec(int(cfg.batch_size))
    val_ds = MVPCompletionDataset("val", DATA_DIR, n)
    test_ds = MVPCompletionDataset("test", DATA_DIR, n)
    meters = {m: AverageValueMeter() for m in engine.completion_metrics(cfg)}
    out = {}
    for split, ds, run in (
            ("val", val_ds, lambda: engine.val_completion(step, val_ds, spec, meters)),
            ("test", test_ds, lambda: engine.predict_completion(step, test_ds, spec))):
        run()                                            # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(repeats):
            run()
        torch.cuda.synchronize()
        batches = repeats * ds.steps_per_epoch(spec)
        out[split] = (time.perf_counter() - t0) * 1e3 / batches
        print(f"{name} {split} pass: {out[split]!r} ms/batch (batch "
              f"{spec.batch_size}, {n} points, host batching + copy included) "
              f"on {card}")
    return out


def time_cuda(fn, iters, warmup=2) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _iters(fn, budget_ms=150.0) -> int:
    """Launches per timing window: about ``budget_ms`` of work, 3 to 50."""
    return int(min(50, max(3, budget_ms / max(time_cuda(fn, 1, warmup=1), 1e-3))))


def bound(nbytes, ops):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    fp32 operations over the fp32 peak."""
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, ops / PEAK_FP32 * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def timing_cases(device):
    """{key: (shape label, kernel fn, plain fn, library fn or None, bytes,
    operations)} at one main-path shape per kernel."""
    B = 32
    a, b = clouds(2, B, 2048, 2048, device)
    f24 = uniform(20, (B, 3072, 24), device)
    x1 = uniform(21, (B, 3072, 3), device)
    t24 = uniform(22, (B, 3072, 24), device)
    edge_idx = indices(23, 3072, (B, 3072, 16), device)
    edge_idx64 = edge_idx.reshape(B, -1, 1).long().expand(-1, -1, 24)
    t120 = uniform(24, (B, 3072, 120), device)
    gm_idx = indices(25, 3072, (B, 1024, 16), device)
    sa = sa_inputs(29, B, 3072, 16, 4, 16, device)     # VRCNet level 1
    t512 = uniform(26, (B, 1024, 512), device)
    ti_idx, ti_w = ref.three_nn_upsampling(uniform(27, (B, 3072, 3), device),
                                           uniform(28, (B, 1024, 3), device))
    N, M, S = 2048, 2048, 2048
    return {
        "chamfer": ("(32, 2048, 2048)",
                    lambda: kernels.chamfer_forward(a, b),
                    lambda: ref.chamfer_distance(a, b), None,
                    B * (N + M) * 12 + B * (N + M) * 8,
                    2 * B * N * M * 8),
        "knn": ("(32, 3072 x 3072, C 24, k 16)",
                lambda: kernels.knn(f24, f24, 16),
                lambda: ref.knn(f24, f24, 16), None,
                2 * B * 3072 * 24 * 4 + B * 3072 * 16 * 8,
                B * 3072 * 3072 * (3 * 24 + 1)),
        "fps": ("(32, 3072 -> 2048)",
                lambda: kernels.furthest_point_sample(x1, S),
                lambda: ref.furthest_point_sample(x1, S), None,
                B * 3072 * 12 + B * S * 4,
                B * (S - 1) * 3072 * 10),
        "gather": ("(32, 3072 x 24) by (32, 3072 x 16)",
                   lambda: kernels.gather_rows(t24, edge_idx),
                   lambda: ref.grouping_operation(t24, edge_idx),
                   lambda: torch.gather(t24, 1, edge_idx64),
                   B * 3072 * 24 * 4 + B * 3072 * 16 * 4 + B * 3072 * 16 * 24 * 4,
                   0),
        "group_max": ("(32, 3072 x 120) by (32, 1024 x 16)",
                      lambda: kernels.group_max_forward(t120, gm_idx),
                      lambda: ref.group_max(t120, gm_idx), None,
                      B * 3072 * 120 * 4 + B * 1024 * 16 * 4 + 2 * B * 1024 * 120 * 4,
                      B * 1024 * 120 * 15),
        "three_interpolate": ("(32, 1024 x 512) -> 3072",
                              lambda: kernels.three_interpolate_forward(t512, ti_idx, ti_w),
                              lambda: ref.three_interpolate(t512, ti_idx, ti_w), None,
                              B * 1024 * 512 * 4 + B * 3072 * 3 * 8 + B * 3072 * 512 * 4,
                              B * 3072 * 512 * 5),
        # bytes: proj, x1, idx read once, out written once (the weights are
        # 1.4 KB); operations: the two MLP products, the bias and the
        # weighted sum, 2 per multiply-add (relu not counted)
        "sa_attention": ("(32, 3072, rel 4, mid 16, k 16)",
                         lambda: kernels.sa_attention_forward(*sa, 4, 16, 8),
                         lambda: ref.sa_attention(*sa, 4, 16, 8), None,
                         B * 3072 * (20 + 4 + 16 + 16) * 4,
                         B * 3072 * (2 * 17 * 4 * 2 + 2 * 2 * 32 + 32
                                     + 2 * 16 * 16)),
    }


def time_kernels(device, card):
    """Each kernel against its plain version in the order plain, kernel,
    kernel, plain (CUDA events), and the library call where there is one."""
    out = {}
    for key, (shape, kern, plain, lib, nbytes, ops) in timing_cases(device).items():
        n_k, n_p = _iters(kern), _iters(plain)
        runs = {"plain": [], "kernel": []}
        for which in ("plain", "kernel", "kernel", "plain"):
            fn, n = (plain, n_p) if which == "plain" else (kern, n_k)
            runs[which].append(time_cuda(fn, n))
        lib_ms = time_cuda(lib, _iters(lib)) if lib is not None else None
        bound_ms, bound_by = bound(nbytes, ops)
        out[key] = {"ms": sum(runs["kernel"]) / 2, "plain_ms": sum(runs["plain"]) / 2,
                    "library_ms": lib_ms, "bound_ms": bound_ms, "bound_by": bound_by}
        print(f"{KERNELS[key]['name']} {shape}: kernel {runs['kernel']!r} ms, "
              f"plain {runs['plain']!r} ms (plain, kernel, kernel, plain), "
              f"library call {lib_ms!r} ms, bound {bound_ms!r} ms ({bound_by}) "
              f"on {card}")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this smoke run needs one "
              "NVIDIA card", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    print(card)

    kernels.load()
    ptxas = [ln for ln in kernels.BUILD_LOG.splitlines()
             if "registers" in ln or "Compiling entry" in ln or "spill" in ln]
    print(f"kernel build: {kernels.BUILD_SECONDS!r} s (nvcc, sm_90a, one per "
          f"source in parallel) on {card}")
    for ln in ptxas:
        print(f"  {ln.strip()}")

    max_abs = compare_kernels_with_plain(device)

    pcn = load_config(PCN_CFG)
    val, preds, pcn_launches = drive_path("PCN", pcn, device,
                                          expected_counts(pcn, {}))
    step, first = check_metrics("PCN", pcn, device, val, preds)
    check_pcn_batch_on_cpu(pcn, step, first)
    check_f1_near(device, first)

    ecg = load_config(ECG_CFG)
    val, preds, ecg_launches = drive_path(
        "ECG", ecg, device, expected_counts(ecg, ECG_PER_BATCH))
    step, first = check_metrics("ECG", ecg, device, val, preds)
    check_batch_on_cpu_as_cloud("ECG", ecg, step, first)

    vrc = load_config(VRCNET_CFG)
    val, preds, vrc_launches = drive_path(
        "VRCNet", vrc, device, expected_counts(vrc, VRCNET_PER_BATCH))
    step, first = check_metrics("VRCNet", vrc, device, val, preds)
    check_batch_on_cpu_as_cloud("VRCNet", vrc, step, first)

    time_passes("PCN", pcn, device, card)
    time_passes("ECG", ecg, device, card)
    time_passes("VRCNet", vrc, device, card)
    times = time_kernels(device, card)

    print(f"chip_smoke: {time.perf_counter() - t_start!r} s on {card}")
    print(json.dumps({"kernels": [
        dict(KERNELS[k], route="cuda",
             launches=pcn_launches[k] + ecg_launches[k] + vrc_launches[k],
             max_abs_err=max_abs[k], **times[k])
        for k in KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
