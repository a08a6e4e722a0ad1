"""The row scatter-add (``scatter_add_rows``, ``ops/csrc/gather.cu``) and the
SA block's forward (``sa_attention_forward``, ``ops/csrc/sa_attention.cu``)
on the card, alone and on their paths.

- The scatter at ECG's five train-step shapes and VRCNet's: the output
  bitwise against ``ref.scatter_add_rows`` run on CPU copies (``index_add_``
  in ascending order) and against a second run, event and device time a
  call beside ``torch.index_add``'s (events in the order library, kernel,
  kernel, library) and the bound (each input read once, the output written
  once), and the launch plan.
- The SA forward at VRCNet's four levels at batch 32 (a val batch) and 64
  (a train step), k 16, share 8: within 1e-5 + 1e-4 |plain| of
  ``ref.sa_attention`` and bitwise against a second run, event time of the
  kernel and of the plain version (plain, kernel, kernel, plain), device
  time a call, the bound and the plan.
- ``group_max``'s backward at the VRCNet step's three shapes: device time
  a call beside its bound.
- ``--sweep``: the SA forward at batch 64 under other launch plans (warps,
  blocks an SM), and the scatter's range form under other (rows, warps).
- ``--host``: the host time a call of the scatter's wrapper at ECG's
  smallest shape and of its parts (the stream, the allocation), beside
  ``torch.index_add``'s.
- ``--models``: the VRCNet train step and val batch and the ECG train step,
  on the host clock (calls ending in a synchronise) and in device time
  under torch.profiler, with the scatter's and the SA forward's share.

    python -m mvp_benchmark_tpu_torch.probe_scatter_sa [--sweep] [--host] [--models] [--out FILE]

Only the public wrappers are timed, so the script also times an older
checkout's kernels when copied into it with ``probe_knn_fps.py`` (its
profiler helpers). Writes its readings as JSON to
``--out`` (default ``build/probe_scatter_sa.json``). Needs a card; exits 1
if a check fails.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

from mvp_benchmark_tpu_torch.ops import kernels, ref
from mvp_benchmark_tpu_torch.probe_knn_fps import device_ms, device_window

PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
# the kernels' names under torch.profiler
SCATTER_KERNELS = ("scatter_add_rows",)
SA_FORWARD_KERNELS = ("sa_attention_kernel",)
SA_ATOL, SA_RTOL = 1e-5, 1e-4
# (label, B, rows of the output n, entries a cloud m, channels c, launches
# an ECG step or a VRCNet step); the uniform losses' kNN gather is
# (B 3264, 24 x 2) at out2's largest percentage
SCATTER_SHAPES = [
    ("ECG uniform_knn (3264, 24 x 2) into 24 x 3", 3264, 24, 48, 3),
    ("ECG uniform_group (32, 102 x 24) into 2048 x 3", 32, 2048, 2448, 3),
    ("ECG centres (32, 1024) into 3072 x 120", 32, 3072, 1024, 120),
    ("ECG fine_fps (32, 2048) into 3072 x 3", 32, 3072, 2048, 3),
    ("ECG dense_edge (32, 3072 x 16) into 3072 x 24", 32, 3072, 49152, 24),
    ("VRCNet centre (64, 1536) into 3072 x 64", 64, 3072, 1536, 64),
]
# VRCNet's SA levels: (N, rel, mid), level i on 3072 / 2^i points
SA_LEVELS = [(3072 >> i, rel, mid) for i, (rel, mid, _) in enumerate(kernels.SA_LEVELS)]
# group_max's backward in the VRCNet step: (B, n rows, c, m points, k)
GROUP_MAX_BWD_SHAPES = [(64, 3072, 64, 1536, 10), (64, 1536, 128, 768, 10),
                        (64, 768, 256, 384, 10)]


def _gen(dev, seed):
    return torch.Generator(device=dev).manual_seed(seed)


def _uniform(dev, shape, seed):
    return torch.rand(shape, generator=_gen(dev, seed), device=dev)


def _indices(dev, high, shape, seed):
    return torch.randint(0, high, shape, generator=_gen(dev, seed), device=dev,
                         dtype=torch.int32)


def _time(fn, budget_ms=100.0):
    """Event ms a call over a window of ~``budget_ms`` after one warm-up."""
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    fn()
    torch.cuda.synchronize()
    s.record()
    fn()
    e.record()
    torch.cuda.synchronize()
    n = int(min(200, max(1, budget_ms / max(s.elapsed_time(e), 1e-3))))
    s.record()
    for _ in range(n):
        fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / n


def _in_turns(a, b):
    """Event ms of ``a`` and ``b`` in the order a, b, b, a: two readings each."""
    out = {"a": [], "b": []}
    for which in ("a", "b", "b", "a"):
        out[which].append(_time(a if which == "a" else b))
    return out["a"], out["b"]


def _bitwise(name, got, want):
    if got.shape != want.shape or not torch.equal(got.view(torch.int32),
                                                  want.view(torch.int32)):
        bad = int((got.view(torch.int32) != want.view(torch.int32)).sum()) \
            if got.shape == want.shape else -1
        raise RuntimeError(f"probe_scatter_sa: {name}: {bad} values differ")


def bound(nbytes, ops):
    """(ms, by): the larger of bytes over the memory rate and fp32
    operations over their peak rate."""
    t_b, t_o = nbytes / PEAK_BYTES * 1e3, ops / PEAK_FP32 * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def scatter_bound(B, n, m, c):
    """(ms, by): g and idx read once, the output written once; one add an
    entry and channel."""
    return bound(B * m * (c + 1) * 4 + B * n * c * 4, B * m * c)


def _scatter_plan(m, n, c):
    vectors = c // 4 if c % 4 == 0 else c
    return list(kernels.scatter_plan(m, n, vectors))


def probe_scatter(dev):
    rows = []
    for i, (label, B, n, m, c) in enumerate(SCATTER_SHAPES):
        g = _uniform(dev, (B, m, c), 300 + i) * 2 - 1
        idx = _indices(dev, n, (B, m), 400 + i)
        want = ref.scatter_add_rows(g.cpu(), idx.cpu(), n)
        first = kernels.scatter_add_rows(g, idx, n)
        _bitwise(f"scatter {label} against the CPU", first.cpu(), want)
        _bitwise(f"scatter {label}, run twice", kernels.scatter_add_rows(g, idx, n), first)
        flat = (idx.long() + torch.arange(B, device=dev)[:, None] * n).reshape(-1)
        zero = torch.zeros(B * n, c, device=dev)
        kern = lambda: kernels.scatter_add_rows(g, idx, n)
        lib = lambda: torch.index_add(zero, 0, flat, g.reshape(-1, c))
        lib_ms, ms = _in_turns(lib, kern)
        bound_ms, bound_by = scatter_bound(B, n, m, c)
        row = {"shape": label, "B": B, "n": n, "m": m, "c": c,
               "plan": _scatter_plan(m, n, c), "ms": ms, "library_ms": lib_ms,
               "device_ms": device_ms(kern, names=SCATTER_KERNELS),
               "device_all_ms": device_ms(kern, names=None),
               "library_device_ms": device_ms(lib, names=None),
               "bound_ms": bound_ms, "bound_by": bound_by}
        print(f"scatter {label}: {ms!r} ms (events), device {row['device_ms']!r} ms "
              f"(all launches of a call {row['device_all_ms']!r}); index_add {lib_ms!r} "
              f"ms, device {row['library_device_ms']!r} ms; bound {bound_ms!r} ms "
              f"({bound_by}); plan {row['plan']}", flush=True)
        rows.append(row)
    return rows


def sa_forward_work(B, n, k, rel, mid, share=8):
    """(bytes, operations) of the SA block's forward: proj, x1 and idx read
    once, out written once (the weights are at most 70 KB); the two MLP
    products, the bias and the weighted sum, 2 operations a multiply-add
    (relu not counted)."""
    ms_ = mid // share
    in_w, kms = (1 + k) * rel, k * ms_
    nbytes = B * n * ((rel + mid) + rel + k + mid) * 4
    ops = B * n * (2 * in_w * ms_ + 2 * ms_ * kms + kms + 2 * k * mid)
    return nbytes, ops


def sa_inputs(dev, B, n, k, rel, mid, seed, share=8):
    """Unit-scale proj and x1 in [-0.5, 0.5), weights at torch's init
    scale, neighbour indices uniform (``chip_smoke.sa_inputs``)."""
    ms_ = mid // share
    proj = _uniform(dev, (B, n, rel + mid), seed) - 0.5
    x1 = _uniform(dev, (B, n, rel), seed + 1) - 0.5
    idx = _indices(dev, n, (B, n, k), seed + 2)
    b1, b2 = ((1 + k) * rel) ** -0.5, ms_ ** -0.5
    W1 = (_uniform(dev, ((1 + k) * rel, ms_), seed + 3) * 2 - 1) * b1
    W2 = (_uniform(dev, (ms_, k * ms_), seed + 4) * 2 - 1) * b2
    bias = (_uniform(dev, (k * ms_,), seed + 5) * 2 - 1) * b2
    return proj, x1, idx, W1, W2, bias


def probe_sa_forward(dev, batches=(32, 64), k=16):
    rows = []
    plan_fn = getattr(kernels, "sa_forward_plan", None)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for B in batches:
        for i, (n, rel, mid) in enumerate(SA_LEVELS):
            args = sa_inputs(dev, B, n, k, rel, mid, 500 + 10 * i + B)
            want = ref.sa_attention(*args, rel, mid, 8)
            first = kernels.sa_attention_forward(*args, rel, mid, 8)
            diff = (first - want).abs()
            bad = int((~(diff <= SA_ATOL + SA_RTOL * want.abs())).sum())
            if bad:
                raise RuntimeError(f"probe_scatter_sa: SA forward level {i + 1} B {B}: "
                                   f"{bad} outside the tolerance")
            _bitwise(f"SA forward level {i + 1} B {B}, run twice",
                     kernels.sa_attention_forward(*args, rel, mid, 8), first)
            del want
            kern = lambda: kernels.sa_attention_forward(*args, rel, mid, 8)
            plain = lambda: ref.sa_attention(*args, rel, mid, 8)
            plain_ms, ms = _in_turns(plain, kern)
            bound_ms, bound_by = bound(*sa_forward_work(B, n, k, rel, mid))
            row = {"level": i + 1, "B": B, "N": n, "k": k, "rel": rel, "mid": mid,
                   "ms": ms, "plain_ms": plain_ms,
                   "device_ms": device_ms(kern, names=SA_FORWARD_KERNELS),
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "max_abs_err": float(diff.max())}
            if plan_fn is not None:
                row["plan"] = list(plan_fn(B, n, k, rel, mid, 8, sms))
            print(f"SA forward level {i + 1} (B {B}, N {n}, rel {rel}, mid {mid}, k {k}): "
                  f"{ms!r} ms (events), device {row['device_ms']!r} ms; plain "
                  f"{plain_ms!r} ms; bound {bound_ms!r} ms ({bound_by}); "
                  f"max |diff| {row['max_abs_err']!r}; plan {row.get('plan')}", flush=True)
            rows.append(row)
    return rows


def probe_group_max_backward(dev):
    rows = []
    for i, (B, n, c, m, k) in enumerate(GROUP_MAX_BWD_SHAPES):
        f = torch.relu(_uniform(dev, (B, n, c), 600 + i) - 0.5)
        idx = _indices(dev, n, (B, m, k), 610 + i)
        _, slot = kernels.group_max_forward(f, idx)
        g = _uniform(dev, (B, m, c), 620 + i) * 2 - 1
        fn = lambda: kernels.group_max_backward(g, idx, slot, n)
        nbytes = B * m * (2 * c + k) * 4 + B * n * c * 4
        row = {"shape": f"({B}, {m} x {c}) by x {k} into {n}", "ms": _time(fn),
               "device_ms": device_ms(fn, names=None), "bound_ms": nbytes / PEAK_BYTES * 1e3,
               "bound_by": "bytes"}
        print(f"group_max backward {row['shape']}: {row['ms']!r} ms (events), device "
              f"{row['device_ms']!r} ms (list and gather); bound {row['bound_ms']!r} ms",
              flush=True)
        rows.append(row)
    return rows


def sweep_sa_forward(dev, k=16, B=64):
    """Device ms a call of the SA forward at each level under the launch
    plans (warps, blocks an SM) around ``kernels.sa_forward_plan``'s, each
    held to the tolerance."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = []
    for i, (n, rel, mid) in enumerate(SA_LEVELS):
        args = sa_inputs(dev, B, n, k, rel, mid, 700 + i)
        want = ref.sa_attention(*args, rel, mid, 8)
        ms_ = mid // 8
        units = -(-(B * n) // kernels.sa_forward_points_a_warp(rel, ms_))
        for warps in (32, 16, 8, 4):
            if warps * 32 > kernels.SA_FWD_MAX_THREADS[ms_] or \
                    kernels._sa_fwd_smem(rel, ms_, k, warps) > kernels.MAX_SMEM:
                continue
            for per_sm in (1, 2, 4, 8):
                if warps * per_sm > 64:
                    continue
                grid = max(1, min(sms * per_sm, -(-units // warps)))
                fn = lambda: kernels._sa_forward_launch(*args, rel, mid, 8, warps, grid)
                got = fn()
                if not bool(((got - want).abs() <= SA_ATOL + SA_RTOL * want.abs()).all()):
                    raise RuntimeError(f"probe_scatter_sa: SA forward level {i + 1} "
                                       f"plan ({warps}, {grid}) outside the tolerance")
                row = {"level": i + 1, "warps": warps, "blocks_a_sm": per_sm, "grid": grid,
                       "device_ms": device_ms(fn, names=SA_FORWARD_KERNELS)}
                print(f"SA forward sweep: {json.dumps(row)}", flush=True)
                out.append(row)
    # the neighbours drawn from the first `window` rows of each cloud only:
    # how far a smaller set of rows, held in L1, shortens the launch
    for i in (0, 2, 3):
        n, rel, mid = SA_LEVELS[i]
        args = list(sa_inputs(dev, B, n, k, rel, mid, 720 + i))
        for window in (n // 64, n // 16, n // 4, n):
            args[2] = _indices(dev, window, (B, n, k), 730 + i)
            fn = lambda: kernels.sa_attention_forward(*args, rel, mid, 8)
            row = {"level": i + 1, "window_rows": window,
                   "device_ms": device_ms(fn, names=SA_FORWARD_KERNELS)}
            print(f"SA forward window: {json.dumps(row)}", flush=True)
            out.append(row)
    return out


def sweep_scatter(dev):
    """Device ms a call of the scatter's range form at ECG's and VRCNet's
    shapes under other plans (rows a block, warps), each held bitwise."""
    out = []
    plan_fn = kernels.scatter_plan
    try:
        for i, (label, B, n, m, c) in enumerate(SCATTER_SHAPES):
            vectors = c // 4 if c % 4 == 0 else c
            base = plan_fn(m, n, vectors)
            if len(base) < 3 or base[2] != 1:
                continue
            g = _uniform(dev, (B, m, c), 800 + i) * 2 - 1
            idx = _indices(dev, n, (B, m), 810 + i)
            want = kernels.scatter_add_rows(g, idx, n)
            for rows in (64, 128, 256):
                for warps in (4, 8, 16):
                    if -(-m // (32 * warps)) > 16:
                        continue
                    plan = (min(rows, n), warps, 1)
                    kernels.scatter_plan = lambda *a, plan=plan: plan
                    fn = lambda: kernels.scatter_add_rows(g, idx, n)
                    _bitwise(f"scatter {label} plan {plan}", fn(), want)
                    row = {"shape": label, "plan": list(plan),
                           "device_ms": device_ms(fn, names=SCATTER_KERNELS)}
                    kernels.scatter_plan = plan_fn
                    print(f"scatter sweep: {json.dumps(row)}", flush=True)
                    out.append(row)
    finally:
        kernels.scatter_plan = plan_fn
    return out


def host_parts(dev, calls=2000):
    """Host us a call, back to back with one synchronise at the end, of
    the scatter's wrapper at ECG's smallest shape, of torch.index_add on the
    same inputs, and of the wrapper's parts."""
    label, B, n, m, c = SCATTER_SHAPES[0]
    g = _uniform(dev, (B, m, c), 900) * 2 - 1
    idx = _indices(dev, n, (B, m), 901)
    flat = (idx.long() + torch.arange(B, device=dev)[:, None] * n).reshape(-1)
    zero = torch.zeros(B * n, c, device=dev)
    parts = {
        "scatter_add_rows": lambda: kernels.scatter_add_rows(g, idx, n),
        "torch.index_add": lambda: torch.index_add(zero, 0, flat, g.reshape(-1, c)),
        "torch.empty": lambda: torch.empty((B, n, c), dtype=torch.float32, device=dev),
        "g.new_empty": lambda: g.new_empty((B, n, c)),
        "current_stream().cuda_stream": lambda: torch.cuda.current_stream(dev).cuda_stream,
        "torch.cuda.current_device()": torch.cuda.current_device,
        "with torch.cuda.device": lambda: torch.cuda.device(dev).__enter__(),
        "scatter_plan": lambda: kernels.scatter_plan(m, n, c),
    }
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:
        parts["_cuda_getCurrentRawStream"] = lambda: raw(0)
    out = {}
    for name, fn in parts.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        out[name] = (t1 - t0) * 1e6 / calls
    print(f"host us a call ({label}): {json.dumps(out)}", flush=True)
    return out


def _host(fn, calls, repeats=3):
    out = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3 / calls)
    return out


def _of(window, names):
    return sum(v for k, v in window.items() if any(m in k for m in names))


def model_times(dev):
    """The VRCNet train step and val batch and the ECG train step: host ms a
    call (three runs), device ms a call (two profiler windows), and the
    device ms of the scatter's and of the SA forward's launches in it."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    import chip_smoke
    from mvp_benchmark_tpu_torch.data.mvp import BatchSpec, MVPCompletionDataset
    from mvp_benchmark_tpu_torch.train import engine
    from mvp_benchmark_tpu_torch.train.config import load_config

    vrc = load_config(chip_smoke.VRCNET_CFG)
    vrc_step, _ = chip_smoke.completion_step(vrc, dev)
    val_step = engine.make_eval_step(engine.build_model(vrc, dev), dev)
    batch = next(iter(MVPCompletionDataset("val", chip_smoke.DATA_DIR, int(
        vrc.num_points)).batches(BatchSpec(int(vrc.batch_size)))))
    ecg_step, _ = chip_smoke.completion_step(load_config(chip_smoke.ECG_CFG), dev)
    out = {}
    for what, fn, calls in (("VRCNet train step", vrc_step, 5),
                            ("VRCNet val batch", lambda: val_step(batch, prefix="val"), 5),
                            ("ECG train step", ecg_step, 5)):
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        host = _host(fn, calls)
        windows = [device_window(fn, calls) for _ in range(2)]
        out[what] = {
            "host_ms": host,
            "device_ms": [sum(w.values()) for w in windows],
            "scatter_ms": [_of(w, SCATTER_KERNELS) for w in windows],
            "sa_forward_ms": [_of(w, SA_FORWARD_KERNELS) for w in windows]}
        r = out[what]
        print(f"{what}: host {r['host_ms']!r} ms, device {r['device_ms']!r} ms; the "
              f"scatter {r['scatter_ms']!r} ms, the SA forward {r['sa_forward_ms']!r} ms "
              f"(device, a call)", flush=True)
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--models", action="store_true",
                        help="time the VRCNet step and val batch and the ECG step too")
    parser.add_argument("--sweep", action="store_true",
                        help="time other launch plans of both kernels")
    parser.add_argument("--host", action="store_true",
                        help="time the scatter wrapper's parts on the host")
    parser.add_argument("--parts", default="scatter,sa,group_max",
                        help="which of scatter, sa, group_max to probe")
    parser.add_argument("--out", default=os.path.join("build", "probe_scatter_sa.json"))
    arg = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_scatter_sa: needs an NVIDIA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    kernels.load()
    for ln in kernels.BUILD_LOG.splitlines():   # ptxas -v of the two sources
        if ("scatter" in ln or "sa_attention_kernel" in ln or "registers" in ln
                or "spill" in ln):
            print(f"  {ln.strip()}")
    parts = arg.parts.split(",")
    out = {"card": card}
    if "scatter" in parts:
        out["scatter"] = probe_scatter(dev)
    if "sa" in parts:
        out["sa_forward"] = probe_sa_forward(dev)
    if "group_max" in parts:
        out["group_max_backward"] = probe_group_max_backward(dev)
    if arg.sweep:
        out["sweep"] = {"sa_forward": sweep_sa_forward(dev), "scatter": sweep_scatter(dev)}
    if arg.host:
        out["host"] = host_parts(dev)
    if arg.models:
        out["models"] = model_times(dev)
    print(f"on {card}")
    os.makedirs(os.path.dirname(os.path.abspath(arg.out)), exist_ok=True)
    with open(arg.out, "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
