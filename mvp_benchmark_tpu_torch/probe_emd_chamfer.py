"""The auction EMD (``ops/csrc/emd.cu``) and the chamfer forward
(``ops/csrc/chamfer.cu``) on the card, alone and on their paths.

- The auction at (32, 2048, eps 0.004, 3000 iterations) in both of its
  regimes: uniform clouds (few bidders a round, latency) and a price war
  (a tight blob of bidders against uniform targets, as random-weight
  predictions are, ~10^3 bidders a round). Each: the assignment bitwise
  against ``ref.emd_assignment`` and against a second run, the device time
  a launch (torch.profiler) and its event time, the rounds, bidder-rounds
  and the slowest cloud's bidder-rounds (the plain auction's counts), the
  batch's operation bound and the slowest cloud's bound on the SMs it gets;
  the launch plan and the cost of a cluster barrier.
- The chamfer forward at (32, 2048, 2048) and at the VRCNet train step's
  four shapes (batch 64, each prediction against gt's 2048 points):
  dist and idx bitwise against ``ref.chamfer_distance`` and a second run,
  event and device time a call, beside the bound and the issue floor.
- ``--models``: the PCN val batch with ``eval_emd: True`` (the first val
  batch: a price war) and the VRCNet train step, on the host clock (calls
  ending in a synchronise) and in device time under torch.profiler, with
  the auction's and the chamfer forward's share.

    python -m mvp_benchmark_tpu_torch.probe_emd_chamfer [--models] [--sweep] [--out FILE]

``--sweep``: the auction also on clusters of every size whose shared
memory fits, each held bitwise (``kernels.emd_plan`` follows).

Only the public wrappers are timed, so the script also times an older
checkout's kernels when copied into it with ``probe_knn_fps.py`` (its
profiler helpers; the counts and the plan are then left out). Writes its readings as JSON to ``--out`` (default
``build/probe_emd_chamfer.json``). Needs a card; exits 1 if a check fails.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from mvp_benchmark_tpu_torch.ops import kernels, ref
from mvp_benchmark_tpu_torch.probe_knn_fps import device_ms, device_window

PEAK_FP32 = 67e12
ISSUE_FP32 = PEAK_FP32 / 2
PEAK_BYTES = 3.35e12
SMS = 132
EMD_EPS, EMD_ITERS = 0.004, 3000
# the auction's operations a pair: 3 + 3 + 2 for d, the sqrt, 2 subtractions
# for the benefit and 2 compares for the top-2 (chip_smoke's count)
EMD_OPS = 13
# the chamfer forward's operations a pair: 8 for the distance, one compare
# a direction; each an fp32 instruction under its rounding rule
CHAMFER_OPS = 10
# (label, B, N predicted, M gt points, launches a VRCNet step)
CHAMFER_SHAPES = [
    ("(32, 2048, 2048)", 32, 2048, 2048, 0),
    ("VRCNet step coarse_raw (64, 1024, 2048)", 64, 1024, 2048, 1),
    ("VRCNet step coarse_high (64, 3072, 2048)", 64, 3072, 2048, 1),
    ("VRCNet step coarse, fine (64, 2048, 2048)", 64, 2048, 2048, 2),
]


def uniform_clouds(dev, B, n, seed):
    rng = np.random.default_rng(seed)
    a = rng.random((B, n, 3), dtype=np.float64).astype(np.float32)
    b = rng.random((B, n, 3), dtype=np.float64).astype(np.float32)
    return torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev)


def price_war_clouds(dev, B, n, seed):
    """Bidders in a cube of side 0.05 at the centre, targets uniform in the
    unit cube: every bidder ranks the targets nearly alike, a price war."""
    a, b = uniform_clouds(dev, B, n, seed)
    return (0.5 + 0.05 * (a - 0.5)).contiguous(), b


def _time(fn, budget_ms=100.0):
    """Mean event ms a call over two windows of ~``budget_ms`` after one
    warm-up call."""
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    fn()
    torch.cuda.synchronize()
    s.record()
    fn()
    e.record()
    torch.cuda.synchronize()
    n = int(min(200, max(1, budget_ms / max(s.elapsed_time(e), 1e-3))))
    out = []
    for _ in range(2):
        s.record()
        for _ in range(n):
            fn()
        e.record()
        torch.cuda.synchronize()
        out.append(s.elapsed_time(e) / n)
    return sum(out) / 2


def _forward_chamfer(name):
    return "chamfer" in name and "backward" not in name


def _same(name, got, want):
    for g, w in zip(got, want):
        if g.dtype == torch.float32:
            g, w = g.view(torch.int32), w.view(torch.int32)
        if g.shape != w.shape or not torch.equal(g, w):
            raise RuntimeError(f"probe_emd_chamfer: {name} differs")


def _has_counts():
    return "counts" in inspect.signature(ref.emd_assignment).parameters


def emd_plan(dev, B, n):
    """The launch plan at (B, n) and the cost of a cluster barrier at it,
    or {} on a kernel without a plan."""
    if not hasattr(kernels, "emd_cluster_size"):
        return {}
    C = kernels.emd_cluster_size(B, n, dev)
    plan = {"C": C, "sms": torch.cuda.get_device_properties(dev).multi_processor_count,
            "targets_a_cta": -(-n // C),
            "shared_bytes": kernels.emd_shared_bytes(n, C),
            "resident_clusters": {c: kernels.emd_resident(n, c) for c in range(1, 9)
                                  if kernels.emd_shared_bytes(n, c) <= kernels.EMD_SMEM},
            "lanes_a_bidder": "a CTA: with u >= 32 bidders the largest power of 2 G with "
                              "u G <= 1024 (1 above 1024), with fewer g warps, the "
                              "largest power of 2 up to 32 / u",
            "barrier_ms": {c: kernels.emd_cluster_barrier_ms(c, min(B, SMS // c), dev)
                           for c in sorted({1, 2, C, 8})}}
    plan["barriers_a_round"] = 1 if C > 1 else 0
    plan["barrier_ms_a_round"] = plan["barrier_ms"][C] * plan["barriers_a_round"]
    return plan


def emd_sweep(dev, a, b, want, n):
    """Event ms of the auction on clusters of every size whose shared memory
    fits, each held bitwise against ``want``."""
    out = {}
    for c in range(1, kernels.EMD_MAX_CLUSTER + 1):
        if kernels.emd_shared_bytes(n, c) > kernels.EMD_SMEM:
            continue
        fn = lambda: kernels._emd_launch(a, b, EMD_EPS, EMD_ITERS, c)
        _same(f"emd on clusters of {c}", [fn()], [want])
        out[f"C {c}"] = _time(fn, 300.0)
    return out


def probe_emd(dev, sweep=False):
    """Both regimes at (32, 2048, eps 0.004, 3000): bitwise checks, times,
    counts and bounds (and with ``sweep`` every cluster size and hand-over
    threshold)."""
    rows = []
    B, n = 32, 2048
    plan = emd_plan(dev, B, n)
    for label, make, seed in (("uniform", uniform_clouds, 80),
                              ("price war", price_war_clouds, 90)):
        a, b = make(dev, B, n, seed)
        bids = []
        st = torch.zeros((B, 2), dtype=torch.int64, device=dev) if _has_counts() else None
        want = ref.emd_assignment(a, b, EMD_EPS, EMD_ITERS, bids,
                                  **({} if st is None else {"counts": st}))
        first = kernels.emd_assignment(a, b, EMD_EPS, EMD_ITERS)
        _same(f"emd {label}", [first], [want])
        _same(f"emd {label}, run twice",
              [kernels.emd_assignment(a, b, EMD_EPS, EMD_ITERS)], [first])
        fn = lambda: kernels.emd_assignment(a, b, EMD_EPS, EMD_ITERS)
        row = {"case": label, "B": B, "n": n, "rounds": len(bids),
               "bidder_rounds": sum(bids), "ms": _time(fn, 300.0),
               "device_ms": device_ms(fn, n=2, names=("emd",))}
        row["bound_ms"] = sum(bids) * n * EMD_OPS / PEAK_FP32 * 1e3
        if st is not None:
            st = st.cpu()
            slow = int(st[:, 1].argmax())
            row["slowest_cloud"] = {"cloud": slow, "rounds": int(st[slow, 0]),
                                    "bidder_rounds": int(st[slow, 1])}
            C = plan.get("C", 1)
            row["slowest_cloud_bound_ms"] = {
                f"C {c}": int(st[slow, 1]) * n * EMD_OPS / (PEAK_FP32 * c / SMS) * 1e3
                for c in sorted({1, C})}
        if sweep and plan:
            row["sweep_ms"] = emd_sweep(dev, a, b, want, n)
            print(f"emd {label} by plan: {json.dumps(row['sweep_ms'])}", flush=True)
        print(f"emd {label}: {row['ms']!r} ms (events), device {row['device_ms']!r} ms; "
              f"{row['rounds']} rounds, {row['bidder_rounds']} bidder-rounds; bound "
              f"{row['bound_ms']!r} ms; slowest cloud {row.get('slowest_cloud')}, its "
              f"bound {row.get('slowest_cloud_bound_ms')}", flush=True)
        rows.append(row)
    return {"plan": plan, "cases": rows}


def probe_chamfer(dev):
    """The chamfer forward at ``CHAMFER_SHAPES``: bitwise checks, event and
    device time, bound and issue floor."""
    rows = []
    for i, (label, B, N, M, per_step) in enumerate(CHAMFER_SHAPES):
        a, b = uniform_clouds(dev, B, N, 400 + i)
        b = uniform_clouds(dev, B, M, 500 + i)[1]
        want = ref.chamfer_distance(a, b)
        first = kernels.chamfer_forward(a, b)
        _same(f"chamfer {label}", first, want)
        _same(f"chamfer {label}, run twice", kernels.chamfer_forward(a, b), first)
        del want
        fn = lambda: kernels.chamfer_forward(a, b)
        pairs = B * N * M
        t_ops = pairs * CHAMFER_OPS / PEAK_FP32 * 1e3
        t_bytes = B * (N + M) * (12 + 8) / PEAK_BYTES * 1e3
        row = {"shape": label, "B": B, "N": N, "M": M, "launches_a_vrcnet_step": per_step,
               "ms": _time(fn), "device_ms": device_ms(fn, n=10, pick=_forward_chamfer),
               "bound_ms": max(t_ops, t_bytes),
               "bound_by": "operations" if t_ops >= t_bytes else "bytes",
               "issue_floor_ms": pairs * CHAMFER_OPS / ISSUE_FP32 * 1e3}
        print(f"chamfer {label}: {row['ms']!r} ms (events), device {row['device_ms']!r} "
              f"ms; bound {row['bound_ms']!r} ms ({row['bound_by']}), issue floor "
              f"{row['issue_floor_ms']!r} ms", flush=True)
        rows.append(row)
    step = sum(r["device_ms"] * r["launches_a_vrcnet_step"] for r in rows)
    print(f"chamfer forward, the VRCNet step's four launches: {step!r} ms of device time")
    return {"shapes": rows, "vrcnet_step_device_ms": step}


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


def model_times(dev):
    """The PCN val batch with ``eval_emd`` and the VRCNet train step: host ms
    a call (three runs) and device ms a call (two profiler windows), with
    the auction's and the chamfer forward's device ms."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    import chip_smoke
    from mvp_benchmark_tpu_torch.data.mvp import BatchSpec, MVPCompletionDataset
    from mvp_benchmark_tpu_torch.train import engine
    from mvp_benchmark_tpu_torch.train.config import load_config

    out = {}
    cfg = load_config(chip_smoke.PCN_CFG, eval_emd=True)
    step = engine.make_eval_step(engine.build_model(cfg, dev), dev)
    batch = next(iter(MVPCompletionDataset("val", chip_smoke.DATA_DIR, int(
        cfg.num_points)).batches(BatchSpec(int(cfg.batch_size)))))
    vrc = load_config(chip_smoke.VRCNET_CFG)
    run, _ = chip_smoke.completion_step(vrc, dev)
    for what, fn, calls in (("PCN val batch with eval_emd", lambda: step(batch, prefix="val"), 2),
                            ("VRCNet train step", run, 5)):
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        host = _host(fn, calls)
        windows = [device_window(fn, calls) for _ in range(2)]
        out[what] = {
            "host_ms": host,
            "device_ms": [sum(w.values()) for w in windows],
            "emd_ms": [sum(v for k, v in w.items() if "emd" in k) for w in windows],
            "chamfer_forward_ms": [sum(v for k, v in w.items() if _forward_chamfer(k))
                                   for w in windows]}
        r = out[what]
        print(f"{what}: host {r['host_ms']!r} ms, device {r['device_ms']!r} ms; the "
              f"auction {r['emd_ms']!r} ms, the chamfer forward "
              f"{r['chamfer_forward_ms']!r} ms (device, a call)", flush=True)
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--models", action="store_true",
                        help="time the PCN val batch with eval_emd and the VRCNet step too")
    parser.add_argument("--sweep", action="store_true",
                        help="time the auction at every cluster size")
    parser.add_argument("--out", default=os.path.join("build", "probe_emd_chamfer.json"))
    arg = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_emd_chamfer: needs an NVIDIA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    kernels.load()
    out = {"card": card, "chamfer": probe_chamfer(dev), "emd": probe_emd(dev, arg.sweep)}
    print(f"emd plan at (32, 2048): {json.dumps(out['emd']['plan'])}")
    if arg.models:
        out["models"] = model_times(dev)
    print(f"on {card}")
    os.makedirs(os.path.dirname(os.path.abspath(arg.out)), exist_ok=True)
    with open(arg.out, "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
