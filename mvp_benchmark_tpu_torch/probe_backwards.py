"""The chamfer backward (``chamfer_backward``, ``ops/csrc/chamfer.cu``) and
group_max's backward (``group_max_backward``, ``ops/csrc/gather.cu``) on the
card, alone and on their paths.

- Every call of the two that one PCN, VRCNet and ECG train step makes
  (seeded weights, the synthetic train batch), captured and replayed: the
  output bitwise against the plain version on CPU copies and against a
  second run, the device time a call under torch.profiler split by kernel
  (a two-launch form's list build and gather apart), the bound (each input
  read once, the output written once) and the lengths of the rows' lists
  (the longest, and the share of entries in rows of more than 8).
- group_max's forward at the VRCNet step's shapes and ECG's largest: checks
  and device time (its saved slot's bytes set what it writes).
- Both at the VRCNet step's shapes on seeded inputs: group_max's backward
  with uniform neighbour indices, the chamfer backward of gt's 2048 points
  against uniform predictions of 1024 / 3072 / 2048 points and against a
  collapsed one (1000 copies of a point).
- ``--models``: the PCN, VRCNet and ECG train steps, on the host clock
  (calls ending in a synchronise) and in device time under torch.profiler,
  with the two backwards' kernels' share.

    python -m mvp_benchmark_tpu_torch.probe_backwards [--models] [--out FILE]

Only the public wrappers are called, so the script also times an older
checkout's kernels when copied into it with ``probe_knn_fps.py`` (its
profiler helpers). Writes its readings as JSON to ``--out`` (default
``build/probe_backwards.json``). Needs a card; exits 1 if a check fails.
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
from mvp_benchmark_tpu_torch.probe_knn_fps import device_window

PEAK_BYTES = 3.35e12
# the kernels of the two backwards under torch.profiler, with the list and
# flag kernels of the two-launch forms an older checkout runs
BACKWARD_NAMES = ("chamfer_backward", "group_max_backward", "group_max_flag",
                  "reverse_list")
# group_max's backward in the VRCNet step: (B, n rows, c, m points, k)
GROUP_MAX_SHAPES = [(64, 3072, 64, 1536, 10), (64, 1536, 128, 768, 10),
                    (64, 768, 256, 384, 10)]
# the chamfer backward in the VRCNet step: (B, gt points, predicted points)
CHAMFER_SHAPES = [(64, 2048, 1024), (64, 2048, 3072), (64, 2048, 2048)]


def _gen(dev, seed):
    return torch.Generator(device=dev).manual_seed(seed)


def _uniform(dev, shape, seed):
    return torch.rand(shape, generator=_gen(dev, seed), device=dev)


def _bitwise(name, got, want):
    got, want = got.contiguous(), want.contiguous()
    if got.shape != want.shape or not torch.equal(got.view(torch.int32),
                                                  want.view(torch.int32)):
        bad = int((got.view(torch.int32) != want.view(torch.int32)).sum()) \
            if got.shape == want.shape else -1
        raise RuntimeError(f"probe_backwards: {name}: {bad} values differ")


def _split(fn, n=10):
    """{kernel: device ms a call}: the window of two whose total is the
    larger (a window that lost kernels reads low)."""
    fn()
    torch.cuda.synchronize()
    wins = [device_window(fn, n) for _ in range(2)]
    best = max(wins, key=lambda w: sum(w.values()))
    if not best:
        raise RuntimeError("probe_backwards: no profiler window recorded a kernel")
    return best


def _list_lengths(idx, num_rows):
    """(longest row, share of entries in rows of more than 8) of the lists
    of idx (B, ...) into ``num_rows`` rows a cloud (outside rows under 0)."""
    B = idx.shape[0]
    rows = idx.reshape(B, -1).long()
    rows = torch.where((rows >= 0) & (rows < num_rows), rows, 0)
    rows = rows + torch.arange(B, device=idx.device)[:, None] * num_rows
    counts = torch.bincount(rows.reshape(-1), minlength=B * num_rows)
    return int(counts.max()), float(counts[counts > 8].sum()) / max(1, rows.numel())


def chamfer_case(label, args):
    """One chamfer backward call ``args`` = (a, b, i1, g1, i2, g2, need_a,
    need_b): checks, device time by kernel, bound, list lengths."""
    a, b, i1, g1, i2, g2, need_a, need_b = args
    fn = lambda: kernels.chamfer_backward(*args)
    got = fn()
    again = fn()
    want = ref.chamfer_backward(*(x.cpu() for x in args[:6]), need_a, need_b)
    for side, g, r, w in zip("ab", got, again, want):
        if (g is None) != (w is None):
            raise RuntimeError(f"probe_backwards: chamfer {label} d{side}: sides differ")
        if g is not None:
            _bitwise(f"chamfer {label} d{side} against the plain version on CPU copies",
                     g.cpu(), w)
            _bitwise(f"chamfer {label} d{side}, run twice", r, g)
    B, N, M = a.shape[0], a.shape[1], b.shape[1]
    nbytes = 0
    lists = {}
    for need, np_, nq, iq, side in ((need_a, N, M, i2, "a"), (need_b, M, N, i1, "b")):
        if need:
            nbytes += B * (np_ + nq) * (12 + 8) + B * np_ * 12
            lists[f"d{side}"] = _list_lengths(iq, np_)
    split = _split(fn)
    row = {"call": label, "B": B, "N": N, "M": M, "need": [need_a, need_b],
           "device_ms": sum(split.values()), "by_kernel": split,
           "bound_ms": nbytes / PEAK_BYTES * 1e3, "bound_by": "bytes",
           "lists": {k: {"longest": v[0], "share_over_8": v[1]} for k, v in lists.items()}}
    print(f"chamfer backward {label} (B {B}, N {N}, M {M}, need {row['need']}): device "
          f"{row['device_ms']!r} ms {json.dumps(split)}; bound {row['bound_ms']!r} ms; "
          f"lists {json.dumps(row['lists'])}; bitwise the plain version on CPU copies, "
          f"run twice", flush=True)
    return row


def group_max_case(label, args):
    """One group_max backward call ``args`` = (g, idx, slot, num_rows)."""
    g, idx, slot, n = args
    fn = lambda: kernels.group_max_backward(*args)
    got = fn()
    _bitwise(f"group_max {label} against the plain version on CPU copies", got.cpu(),
             ref.group_max_backward(g.cpu(), idx.cpu(), slot.cpu(), n))
    _bitwise(f"group_max {label}, run twice", fn(), got)
    B, m, c = g.shape
    k = idx.shape[2]
    nbytes = B * m * c * (4 + slot.element_size()) + B * m * k * 4 + B * n * c * 4
    split = _split(fn)
    longest, share = _list_lengths(idx, n)
    row = {"call": label, "shape": [B, n, c, m, k], "slot_bytes": slot.element_size(),
           "device_ms": sum(split.values()), "by_kernel": split,
           "bound_ms": nbytes / PEAK_BYTES * 1e3, "bound_by": "bytes",
           "lists": {"longest": longest, "share_over_8": share}}
    print(f"group_max backward {label} ((B, n, c, m, k) {row['shape']}, slot "
          f"{row['slot_bytes']} B): device {row['device_ms']!r} ms {json.dumps(split)}; "
          f"bound {row['bound_ms']!r} ms; lists {json.dumps(row['lists'])}; bitwise the "
          f"plain version on CPU copies, run twice", flush=True)
    return row


def capture(run):
    """The arguments of every chamfer_backward and group_max_backward call
    that ``run()`` makes, cloned."""
    calls = {"chamfer": [], "group_max": []}
    orig = kernels.chamfer_backward, kernels.group_max_backward

    def chamfer(*args):
        calls["chamfer"].append(tuple(x.clone() if torch.is_tensor(x) else x
                                      for x in args))
        return orig[0](*args)

    def group_max(*args):
        calls["group_max"].append(tuple(x.clone() if torch.is_tensor(x) else x
                                        for x in args))
        return orig[1](*args)

    kernels.chamfer_backward, kernels.group_max_backward = chamfer, group_max
    try:
        run()
        torch.cuda.synchronize()
    finally:
        kernels.chamfer_backward, kernels.group_max_backward = orig
    return calls


def _steps(dev):
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    import chip_smoke
    from mvp_benchmark_tpu_torch.train.config import load_config
    return {name: chip_smoke.completion_step(load_config(path), dev)[0]
            for name, path in (("PCN", chip_smoke.PCN_CFG),
                               ("VRCNet", chip_smoke.VRCNET_CFG),
                               ("ECG", chip_smoke.ECG_CFG))}


def probe_paths(dev, steps):
    """Every call of the two in one train step of each model, replayed."""
    out = {}
    for name, run in steps.items():
        calls = capture(run)
        rows = [chamfer_case(f"{name} step call {i + 1}", args)
                for i, args in enumerate(calls["chamfer"])]
        rows += [group_max_case(f"{name} step call {i + 1}", args)
                 for i, args in enumerate(calls["group_max"])]
        for kind in ("chamfer", "group_max"):
            got = [r["device_ms"] for r in rows if (kind == "chamfer") == ("N" in r)]
            if got:
                print(f"{name} step: the {len(got)} {kind} backwards {sum(got)!r} ms "
                      f"of device time", flush=True)
        out[name] = rows
    return out


def probe_forward(dev):
    """group_max's forward at the VRCNet step's shapes and at ECG's largest
    (32, 3072 x 120 by 1024 x 16): the max bitwise and the slot's values
    equal to ``ref.group_max`` on CPU copies, device time a call beside the
    bound (features and idx read once, the max and the slot written once)."""
    rows = []
    for i, (B, n, c, m, k) in enumerate(GROUP_MAX_SHAPES + [(32, 3072, 120, 1024, 16)]):
        f = _uniform(dev, (B, n, c), 670 + i)
        idx = torch.randint(0, n, (B, m, k), generator=_gen(dev, 680 + i), device=dev,
                            dtype=torch.int32)
        out, slot = kernels.group_max_forward(f, idx)
        want, want_slot = ref.group_max(f.cpu(), idx.cpu())
        _bitwise(f"group_max forward {i + 1}", out.cpu(), want)
        if not torch.equal(slot.cpu().long(), want_slot.long()):
            raise RuntimeError(f"probe_backwards: group_max forward {i + 1}: slots differ")
        split = _split(lambda: kernels.group_max_forward(f, idx))
        nbytes = B * (n * c * 4 + m * k * 4 + m * c * (4 + slot.element_size()))
        row = {"shape": [B, n, c, m, k], "slot_bytes": slot.element_size(),
               "device_ms": sum(split.values()), "bound_ms": nbytes / PEAK_BYTES * 1e3}
        print(f"group_max forward (B, n, c, m, k) {row['shape']}, slot {row['slot_bytes']} B: "
              f"device {row['device_ms']!r} ms, bound {row['bound_ms']!r} ms", flush=True)
        rows.append(row)
    return rows


def probe_shapes(dev):
    """Both at the VRCNet step's shapes on seeded inputs."""
    rows = []
    for i, (B, n, c, m, k) in enumerate(GROUP_MAX_SHAPES):
        f = torch.relu(_uniform(dev, (B, n, c), 600 + i) - 0.5)
        idx = torch.randint(0, n, (B, m, k), generator=_gen(dev, 610 + i), device=dev,
                            dtype=torch.int32)
        _, slot = kernels.group_max_forward(f, idx)
        g = _uniform(dev, (B, m, c), 620 + i) * 2 - 1
        rows.append(group_max_case(f"level {i + 1}", (g, idx, slot, n)))
    for i, (B, N, M) in enumerate(CHAMFER_SHAPES + [(64, 2048, 2048)]):
        gt, pred = _uniform(dev, (B, N, 3), 630 + i), _uniform(dev, (B, M, 3), 640 + i)
        label = f"uniform, {M} predicted"
        if i == len(CHAMFER_SHAPES):
            pred[:, :1000] = pred[:, :1]               # 1000 copies of one point
            label = f"collapsed, {M} predicted"
        _, _, i1, i2 = kernels.chamfer_forward(gt, pred)
        g1 = _uniform(dev, (B, N), 650 + i) * 2 - 1
        g2 = _uniform(dev, (B, M), 660 + i) * 2 - 1
        rows.append(chamfer_case(label, (gt, pred, i1, g1, i2, g2, False, True)))
    return rows


def sweep_group_max(dev, steps):
    """group_max's backward under other plans (output vectors a thread,
    which sets the rows a block), each held bitwise against the plan's own
    output: at the VRCNet step's shapes on uniform indices, and at every
    call of the VRCNet and ECG steps on their own."""
    cases = []
    for i, (B, n, c, m, k) in enumerate(GROUP_MAX_SHAPES):
        f = torch.relu(_uniform(dev, (B, n, c), 600 + i) - 0.5)
        idx = torch.randint(0, n, (B, m, k), generator=_gen(dev, 610 + i), device=dev,
                            dtype=torch.int32)
        _, slot = kernels.group_max_forward(f, idx)
        g = _uniform(dev, (B, m, c), 620 + i) * 2 - 1
        cases.append((f"uniform {[B, n, c, m, k]}", (g, idx, slot, n)))
    for name in ("VRCNet", "ECG"):
        cases += [(f"{name} step call {i + 1}", args)
                  for i, args in enumerate(capture(steps[name])["group_max"])]
    out = []
    plan_fn = kernels.group_max_backward_plan
    try:
        for label, (g, idx, slot, n) in cases:
            (B, m, c), k = g.shape, idx.shape[2]
            want = kernels.group_max_backward(g, idx, slot, n)
            base = plan_fn(n, c, m, k, c // 8)
            for items, lanes in ((4, base[2]), (8, c // 8), (8, base[2]), (16, base[2])):
                rows = min(n, items * 32 * kernels.GROUP_MAX_BWD_WARPS // lanes)
                plan = (rows, base[1], lanes)
                if kernels.group_max_backward_smem(rows, base[1], c) > kernels.MAX_SMEM:
                    continue
                kernels.group_max_backward_plan = lambda *a, plan=plan: plan
                fn = lambda: kernels.group_max_backward(g, idx, slot, n)
                _bitwise(f"group_max {label} plan {plan}", fn(), want)
                row = {"call": label, "plan": list(plan), "items": items, "lanes": lanes,
                       "device_ms": sum(_split(fn).values())}
                kernels.group_max_backward_plan = plan_fn
                print(f"group_max sweep: {json.dumps(row)}", flush=True)
                out.append(row)
    finally:
        kernels.group_max_backward_plan = plan_fn
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


def model_times(steps):
    """Each train step: host ms a call (three runs of 5) and device ms a
    call (two profiler windows), with the two backwards' kernels' device ms."""
    out = {}
    for name, fn in steps.items():
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        host = _host(fn, 5)
        windows = [device_window(fn, 5) for _ in range(2)]
        out[name] = {
            "host_ms": host, "device_ms": [sum(w.values()) for w in windows],
            "backwards_ms": [{k: v for k, v in w.items()
                              if any(m in k for m in BACKWARD_NAMES)} for w in windows]}
        r = out[name]
        print(f"{name} train step: host {r['host_ms']!r} ms, device {r['device_ms']!r} ms; "
              f"the backwards' kernels {json.dumps(r['backwards_ms'])} (device, a call)",
              flush=True)
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--models", action="store_true",
                        help="time the PCN, VRCNet and ECG train steps too")
    parser.add_argument("--sweep", action="store_true",
                        help="time group_max's backward under other launch plans")
    parser.add_argument("--out", default=os.path.join("build", "probe_backwards.json"))
    arg = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_backwards: needs an NVIDIA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    kernels.load()
    steps = _steps(dev)
    out = {"card": card, "forward": probe_forward(dev), "shapes": probe_shapes(dev),
           "paths": probe_paths(dev, steps)}
    if arg.sweep:
        out["sweep"] = sweep_group_max(dev, steps)
    if arg.models:
        out["models"] = model_times(steps)
    print(f"on {card}")
    os.makedirs(os.path.dirname(os.path.abspath(arg.out)), exist_ok=True)
    with open(arg.out, "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
