"""IDAM's Propagate edge block (``ops/csrc/gnn_propagate.cu``) on the card,
alone, at the path shape (B 32, N 2048, k 12, C 64): each public wrapper
timed with CUDA events (the mean of two windows of ~30 ms after a warm-up),
and each kernel it launches by device time under torch.profiler, so that a
call of several launches is split by launch. Beside each launch, the least
time the card could take for its own work (``launch_work``: its inputs read
once and its outputs written once at 3.35 TB/s, against its operations at
the peak of their type). With ``--plain``, the plain versions in
``ops/ref.py`` are timed too; with ``--idam``, IDAM itself on the host
clock (``time_idam``: a val batch and a train step at
``registration/cfgs/idam.yaml``). ``chip_smoke.py`` calls ``probe``.

    python -m mvp_benchmark_tpu_torch.probe_propagate [--plain] [--idam] [--out FILE]

Only the public wrappers are called, so the script also times an older
checkout's kernels when copied into it (there the backward builds its own
reverse list). Writes its readings as JSON to ``--out`` (default
``build/probe_propagate.json``). Needs a card.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess

import torch

from mvp_benchmark_tpu_torch.ops import kernels, ref
from mvp_benchmark_tpu_torch.probe_knn_fps import _time

SHAPE = (32, 2048, 12, 64)      # B, N, k, C of IDAM's GNN (registration/cfgs/idam.yaml)
PEAK_BYTES, PEAK_FP32, PEAK_BF16 = 3.35e12, 67e12, 989e12


def inputs(dev, seed, B, N, k, C):
    """A unit-normal projection p, the self-kNN of a uniform cloud, W and b
    at torch's init scale, BatchNorm parameters and running statistics near
    their initial values, and a unit-normal cotangent dx (B, N, C)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    idx = ref.knn_indices(torch.rand(B, N, 3, device=dev, generator=g), k)
    p = torch.randn(B, N, C, device=dev, generator=g)
    u = lambda *s: (torch.rand(*s, device=dev, generator=g) * 2 - 1) * C ** -0.5
    vec = lambda sd, mu: mu + sd * torch.randn(C, device=dev, generator=g)
    args = (p, idx, u(C, C), u(C), vec(0.1, 1.0), vec(0.1, 0.0), vec(0.1, 0.0),
            0.5 + torch.rand(C, device=dev, generator=g))
    return args, torch.randn(B, N, C, device=dev, generator=g)


def launch_work(B, N, k, C):
    """{launch: (bytes, operations, peak)} of each launch, its inputs read
    once and its outputs written once (the weights and (C,) vectors, under
    20 KB, left out), 2 operations a multiply-add. The final pass's product
    takes bf16 inputs (bf16 peak); the other operations are fp32, counted
    at the fp32 peak."""
    pts, E = B * N * C * 4, B * N * k
    return {
        # p, idx -> out (+ the slot bytes in train); the edge's product
        "final": (2 * pts + E * 4, 2 * E * C * C, PEAK_BF16),
        "final_slot": (2 * pts + E * 4 + B * N * C, 2 * E * C * C, PEAK_BF16),
        # p, idx -> per-block sums; a subtraction, e and e^2 an edge channel
        "stat": (pts + E * 4, 4 * E * C, PEAK_FP32),
        # pass 1: p, idx, dx, slot -> dy (B, N, k, C) bf16; the edge and
        # BatchNorm recomputed (8 an element), dx1 and dW from the routed
        # slot (C^2 multiply-adds each a point), S
        "pass1": (3 * pts + E * 4 + B * N * C + E * C * 2,
                  10 * E * C + 4 * B * N * C * C, PEAK_FP32),
        # the gather: dy, p, idx, the reverse list -> d_p; da recomputed
        # for each edge twice (as a neighbour and as a centre), 9 an element
        "gather": (E * C * 2 + 2 * pts + E * 4 + E * 4 + (B * N + 1) * 4,
                   2 * 9 * E * C, PEAK_FP32),
        # the reverse list: idx -> order, off
        "list": (2 * E * 4 + (B * N + 1) * 4, 0, PEAK_FP32),
        # the whole backward (chip_smoke's row): p, idx, dx, slot -> d_p
        "backward": (3 * pts + E * 4 + B * N * C,
                     4 * B * N * C * C + 14 * E * C, PEAK_FP32),
    }


def bound_ms(nbytes, ops, peak):
    return max(nbytes / PEAK_BYTES, ops / peak) * 1e3


def _short(name: str) -> str:
    """The kernel's identifier with its template arguments, without the
    namespace and the parameter list."""
    name = name.replace("(anonymous namespace)::", "").replace("void ", "")
    return re.sub(r"\(.*$", "", name).strip()


def kernel_ms(fn, n=5):
    """{kernel: device ms a call} of every kernel ``fn`` launches, under
    torch.profiler: the larger of two windows of ``n`` calls (a window the
    profiler dropped kernels from reads low)."""
    fn()
    torch.cuda.synchronize()
    out: dict = {}
    for _ in range(2):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        seen: dict = {}
        for e in prof.key_averages():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            us = getattr(e, "self_device_time_total", None) or e.self_cuda_time_total
            key = _short(e.key)
            seen[key] = seen.get(key, 0.0) + us / n / 1e3
        for key, ms in seen.items():
            out[key] = max(out.get(key, 0.0), ms)
    return out


def probe(dev, plain=False, shape=SHAPE):
    """One row a wrapper call at ``shape``: its event time, the device time
    of each kernel it launches, and (``plain``) the plain version's event
    time; plus the bound of each launch (``launch_work``)."""
    B, N, k, C = shape
    args, dx = inputs(dev, 900, B, N, k, C)
    p, idx, W, b, gamma, beta, mean, var = args
    _, stats, slot = kernels.gnn_propagate_train_forward(p, idx, W, b, gamma, beta)
    shared = getattr(kernels, "gnn_propagate_list", None)
    lst = shared(idx, N) if shared else None
    back = lambda need_p=True: kernels.gnn_propagate_train_backward(
        p, idx, W, gamma, beta, stats, slot, dx, need_p=need_p,
        **({"lst": lst} if shared else {}))
    calls = {
        "final pass (eval)": (lambda: kernels.gnn_propagate_forward(*args),
                              lambda: ref.gnn_propagate_eval(*args)),
        "stat pass": (lambda: kernels.gnn_propagate_batch_stats(p, idx),
                      lambda: ref.gnn_propagate_stats(p, idx)),
        "train forward (stat, final pass with slot)": (
            lambda: kernels.gnn_propagate_train_forward(p, idx, W, b, gamma, beta),
            lambda: ref.gnn_propagate_slots(p, idx, W, b, gamma, beta, stats[0], stats[1])),
        "backward": (back, lambda: ref.gnn_propagate_backward(p, idx, W, gamma, beta,
                                                              stats, slot, dx)),
        "backward without d_p": (lambda: back(False), None),
    }
    if shared:
        calls["reverse list (once a graph a step)"] = (lambda: shared(idx, N),
                                                       lambda: ref.reverse_list(idx, N))
    rows = []
    for label, (kern, pl) in calls.items():
        row = {"call": label, "ms": _time(kern), "device_ms": kernel_ms(kern)}
        if plain and pl is not None:
            row["plain_ms"] = _time(pl)
        rows.append(row)
    bounds = {key: bound_ms(*w) for key, w in launch_work(B, N, k, C).items()}
    return {"shape": {"B": B, "N": N, "k": k, "C": C}, "calls": rows, "bound_ms": bounds}


def time_idam(dev, repeats=3, steps=5):
    """IDAM (``registration/cfgs/idam.yaml``, seeded weights, the synthetic
    splits) on the host clock, each timing ending in a synchronise: ms a val
    batch (``engine.val_registration`` over the val split, after a warm-up
    pass; ``repeats`` passes) and ms a train step
    (``engine.make_registration_train_step`` on one batch of the train
    split, ``steps`` steps after two warm-ups)."""
    import time

    from mvp_benchmark_tpu_torch.data.mvp import BatchSpec
    from mvp_benchmark_tpu_torch.train import engine
    from mvp_benchmark_tpu_torch.train.config import load_config
    from mvp_benchmark_tpu_torch.train.meters import AverageValueMeter
    from mvp_benchmark_tpu_torch.train.optim import build_optimizer

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = load_config(os.path.join(root, "registration", "cfgs", "idam.yaml"))
    data = os.path.join(root, "registration", "data")
    spec = BatchSpec(int(cfg.batch_size))
    step = engine.make_registration_eval_step(engine.build_model(cfg, dev), dev)
    ds = engine.registration_dataset(cfg, "val", data)
    meters = {m: AverageValueMeter() for m in engine.REG_METRICS}
    split = engine.registration_split_meters(cfg)

    def timed(fn, per):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / per

    run = lambda: engine.val_registration(step, ds, spec, meters, split)
    run()
    torch.cuda.synchronize()
    val = [timed(run, ds.steps_per_epoch(spec)) for _ in range(repeats)]
    model = engine.build_model(cfg, dev, seed=1, for_training=True)
    train = engine.make_registration_train_step(
        model.train(), build_optimizer(cfg, model.parameters()), dev)
    batch = next(engine.registration_dataset(cfg, "train", data).batches(
        BatchSpec(int(cfg.batch_size), shuffle=True, seed=1)))
    for _ in range(2):
        train(batch)
    torch.cuda.synchronize()
    step_ms = timed(lambda: [train(batch) for _ in range(steps)], steps)
    return {"val_ms_per_batch": val, "train_ms_per_step": step_ms}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--plain", action="store_true",
                        help="time the plain versions too")
    parser.add_argument("--idam", action="store_true",
                        help="time IDAM's val batch and train step on the host clock too")
    parser.add_argument("--out", default=os.path.join("build", "probe_propagate.json"))
    arg = parser.parse_args(argv)
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    out = {"card": card, **probe(dev, arg.plain)}
    if arg.idam:
        out["idam"] = time_idam(dev)
        print(f"IDAM on the host clock: {json.dumps(out['idam'])}")
    for row in out["calls"]:
        split = ", ".join(f"{n} {ms!r}" for n, ms in sorted(row["device_ms"].items(),
                                                             key=lambda kv: -kv[1]))
        print(f"{row['call']}: {row['ms']!r} ms (events)"
              + (f", plain {row['plain_ms']!r} ms" if "plain_ms" in row else "")
              + f"; device ms a call: {split}")
    print(f"bounds (ms): {json.dumps(out['bound_ms'])}")
    print(f"on {card}")
    os.makedirs(os.path.dirname(os.path.abspath(arg.out)), exist_ok=True)
    with open(arg.out, "w") as f:
        json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
