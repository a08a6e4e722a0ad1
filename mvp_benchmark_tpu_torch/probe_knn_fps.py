"""FPS (``ops/csrc/fps.cu``) and kNN (``ops/csrc/knn.cu``) on the card, alone,
at every shape the driven paths launch them with (VRCNet's val batch of 32
and train step of 64, ECG's, DCP's and IDAM's). Each call's output is held
bitwise against its plain version (``ref.knn``, ``ref.furthest_point_sample``)
and against a second run, and timed with CUDA events (the mean of two
windows of ~30 ms after two warm-up calls) and by the kernels' device time
under torch.profiler; FPS also at S = 2, for its time a step, (t(S) - t(2)) /
(S - 2) of the device times. ``chip_smoke.py`` calls ``probe_knn`` and
``probe_fps`` with the plain versions timed too.

    python -m mvp_benchmark_tpu_torch.probe_knn_fps [--sweep] [--out FILE]

``--sweep`` also times every launch plan the kernels take at each shape
(for kNN the direct or the queue kernel and rows a thread; for FPS threads
and points a thread), each held bitwise too, by device time: the readings
``knn_plan`` and ``fps_plan`` in ``ops/kernels.py`` follow. Without it, only
the public wrappers are called, so the script also times an older
checkout's kernels when copied into it. Writes its readings as JSON to
``--out`` (default ``build/probe_knn_fps.json``). Needs a card; exits 1 if a
check fails.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

from mvp_benchmark_tpu_torch.ops import kernels, ref

# (label, B, M query rows, N points, C, k); "self" rows query their own cloud
KNN_SHAPES = [
    *[(f"VRCNet B{B} self {n}", B, n, n, 3, 16)
      for B in (32, 64) for n in (3072, 1536, 768, 384)],
    *[(f"VRCNet B{B} three_nn {2 * n}<-{n}", B, 2 * n, n, 3, 3)
      for B in (32, 64) for n in (1536, 768, 384)],
    ("ECG self C24 3072", 32, 3072, 3072, 24, 16),
    *[(f"ECG self C48 {n}", 32, n, n, 48, 16) for n in (1024, 256, 64)],
    *[(f"ECG knn_points {n}<-{4 * n if n < 1024 else 3072}", 32, n,
       4 * n if n < 1024 else 3072, 3, 16) for n in (1024, 256, 64)],
    *[(f"ECG three_nn {m}<-{n}", 32, m, n, 3, 3)
      for m, n in ((3072, 1024), (1024, 256), (256, 64))],
    ("ECG uniform k2 24", 32 * 102, 24, 24, 3, 2),
    ("ECG uniform k2 4", 32 * 51, 4, 4, 3, 2),
    ("DCP self k20 2048", 32, 2048, 2048, 3, 20),
    ("IDAM self k12 2048", 32, 2048, 2048, 3, 12),
]
# (label, B, N, S)
FPS_SHAPES = [
    *[(f"VRCNet B{B} {n}->{s}", B, n, s) for B in (32, 64)
      for n, s in ((3072, 2048), (3072, 1536), (1536, 768), (768, 384))],
    *[(f"ECG {n}->{s}", 32, n, s) for n, s in ((3072, 1024), (1024, 256),
                                                (256, 64), (1024, 51), (2048, 102))],
]


def _cloud(dev, shape, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.rand(*shape, device=dev, generator=g)


def _time(fn, budget_ms=30.0):
    """Mean ms a call over two windows of ~``budget_ms`` after two warm-up
    calls; one call a window, after one warm-up, for a call longer than the
    budget (the plain versions)."""
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    fn()
    torch.cuda.synchronize()
    a.record()
    fn()
    b.record()
    torch.cuda.synchronize()
    n = int(min(200, max(1 if a.elapsed_time(b) > budget_ms else 3,
                         budget_ms / max(a.elapsed_time(b), 1e-3))))
    out = []
    for _ in range(2):
        a.record()
        for _ in range(n):
            fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b) / n)
    return sum(out) / 2


def _same(name, got, want):
    """Indices equal and distances bitwise equal, else raise."""
    for g, w in zip(got, want):
        if g.dtype == torch.float32:
            g, w = g.view(torch.int32), w.view(torch.int32)
        if g.shape != w.shape or not torch.equal(g, w):
            raise RuntimeError(f"probe_knn_fps: {name} differs")


def knn_plans(B, M, N, C, k):
    """Every plan knn.cu takes at this shape: the direct kernel, and at
    k > 3 the queue kernel at each row count allowed."""
    out = [(0, 1)]
    if min(k, N) > 3:
        out += [(1, R) for R in kernels.knn_rows_allowed(C, k)]
    return out


def fps_plans(N):
    """Every (threads, per) fps.cu takes for N points with at most 32
    points a thread."""
    out = []
    for threads in (64, 128, 256, 512, 1024):
        plan = kernels._fps_fit(N, threads)
        if plan is not None and plan not in out:
            out.append(plan)
    return out


def device_ms(fn, n=5, names=("knn", "fps")):
    """Device time a call of the kernels named, under torch.profiler: the
    host's launch overhead, which bounds small calls timed with events,
    left out. The larger of two windows of ``n`` calls: a window the
    profiler dropped kernels from reads low."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(2):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        us = 0.0
        for e in prof.key_averages():
            if any(m in e.key for m in names):
                us += getattr(e, "self_device_time_total", None) or e.self_cuda_time_total
        out.append(us / n / 1e3)
    return max(out)


def probe_knn(dev, sweep=False, plain=False):
    """One row a shape of ``KNN_SHAPES``: the kernel bitwise against
    ``ref.knn`` and against a second run, its event and device times (and
    the plain version's event time where ``plain``; every plan's device
    time where ``sweep``)."""
    rows = []
    for i, (label, B, M, N, C, k) in enumerate(KNN_SHAPES):
        self_ = M == N and "self" in label
        p = _cloud(dev, (B, N, C), 100 + i)
        q = p if self_ else _cloud(dev, (B, M, C), 200 + i)
        want = ref.knn(q, p, k)
        first = kernels.knn(q, p, k)
        _same(label, first, want)
        _same(f"{label}, run twice", kernels.knn(q, p, k), first)
        row = {"shape": label, "B": B, "M": M, "N": N, "C": C, "k": k,
               "self": self_, "ms": _time(lambda: kernels.knn(q, p, k)),
               "device_ms": device_ms(lambda: kernels.knn(q, p, k))}
        if plain:
            row["plain_ms"] = _time(lambda: ref.knn(q, p, k))
        if sweep:
            row["plan"] = list(kernels.knn_plan(B, M, N, C, k))
            row["plans"] = {}
            for plan in knn_plans(B, M, N, C, k):
                fn = lambda: kernels._knn_launch(q, p, min(k, N), plan)
                _same(f"{label} plan {plan}", fn(), want)
                row["plans"][str(plan)] = device_ms(fn)
        print(f"knn {label}: {row['ms']!r} ms, device {row['device_ms']!r} ms"
              + (f", plain {row['plain_ms']!r} ms" if plain else "")
              + (f", plan {row['plan']}, plans {row['plans']}" if sweep else ""),
              flush=True)
        rows.append(row)
        del want, first
    return rows


def probe_fps(dev, sweep=False, plain=False):
    """One row a shape of ``FPS_SHAPES``: the kernel bitwise against
    ``ref.furthest_point_sample`` and against a second run, its event and
    device times, its time a step (and the plain version's event time where
    ``plain``; every plan's device time where ``sweep``)."""
    rows = []
    for i, (label, B, N, S) in enumerate(FPS_SHAPES):
        x = _cloud(dev, (B, N, 3), 300 + i)
        want = ref.furthest_point_sample(x, S)
        first = kernels.furthest_point_sample(x, S)
        _same(label, [first], [want])
        _same(f"{label}, run twice", [kernels.furthest_point_sample(x, S)], [first])
        t_dev = device_ms(lambda: kernels.furthest_point_sample(x, S))
        t_dev2 = device_ms(lambda: kernels.furthest_point_sample(x, 2))
        row = {"shape": label, "B": B, "N": N, "S": S,
               "ms": _time(lambda: kernels.furthest_point_sample(x, S)),
               "device_ms": t_dev, "device_ms_s2": t_dev2,
               "us_per_step": (t_dev - t_dev2) / (S - 2) * 1e3}
        if plain:
            row["plain_ms"] = _time(lambda: ref.furthest_point_sample(x, S))
        if sweep:
            row["plan"] = list(kernels.fps_plan(B, N, S))
            row["plans"] = {}
            for plan in fps_plans(N):
                fn = lambda: kernels._fps_launch(x, S, plan)
                _same(f"{label} plan {plan}", [fn()], [want])
                row["plans"][str(plan)] = device_ms(fn, 3)
        print(f"fps {label}: {row['ms']!r} ms, device {t_dev!r} ms, S=2 "
              f"{t_dev2!r} ms, {row['us_per_step']!r} us a step"
              + (f", plain {row['plain_ms']!r} ms" if plain else "")
              + (f", plan {row['plan']}, plans {row['plans']}" if sweep else ""),
              flush=True)
        rows.append(row)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--out", default=os.path.join("build", "probe_knn_fps.json"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_knn_fps: needs an NVIDIA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    kernels.load()
    print(f"{card}; kernel build {kernels.BUILD_SECONDS!r} s", flush=True)
    for section in kernels.BUILD_LOG.split("== ")[1:]:
        if section.startswith(("knn.cu", "fps.cu")):
            for ln in section.splitlines():
                if "registers" in ln or "spill" in ln or "Compiling entry" in ln:
                    print(f"  {ln.strip()}")
    out = {"card": card, "fps": probe_fps(dev, args.sweep),
           "knn": probe_knn(dev, args.sweep)}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(f"probe_knn_fps: all outputs equal their plain versions; {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
