"""The completion gathers of ``ops/csrc/{chamfer,gather,ball_query}.cu`` on
the card, alone and on their paths: the chamfer backward
(``chamfer_backward``), group_max's backward and forward
(``group_max_backward``, ``group_max_forward``), three_interpolate's
backward (``three_interpolate_backward``) and the ball query
(``ball_query``).

- Every call of these that one PCN, VRCNet and ECG train step makes (seeded
  weights, the synthetic train batch), captured and replayed: the output
  bitwise against the plain version on CPU copies and against a second run,
  the device time a call under torch.profiler split by kernel (a two-launch
  form's list build and gather apart), the bound (each input read once, the
  output written once; the ball query's operations over the pairs its
  inputs scan) and, for the backwards, the lengths of the rows' lists (the
  longest, and the share of entries in rows of more than 8).
  three_interpolate's backward also says whether d_weight was asked for.
- group_max's forward at the VRCNet and ECG steps' shapes and
  three_interpolate's backward at theirs, on seeded uniform inputs: checks
  and device time.
- The chamfer and group_max backwards at the VRCNet step's shapes on seeded
  inputs: group_max's with uniform neighbour indices, the chamfer backward
  of gt's 2048 points against uniform predictions of 1024 / 3072 / 2048
  points and against a collapsed one (1000 copies of a point).
- ``--sweep``: group_max's backward, group_max's forward and
  three_interpolate's backward under other launch plans, at the steps'
  calls and on uniform inputs, each held bitwise against the default plan.
- ``--models``: the PCN, VRCNet and ECG train steps, on the host clock
  (calls ending in a synchronise) and in device time under torch.profiler,
  with the probed kernels' share.
- ``--parts``: the kernels probed (default all of ``PARTS``).

    python -m mvp_benchmark_tpu_torch.probe_backwards [--models] [--sweep]
        [--parts three_interpolate_backward,group_max_forward] [--out FILE]

Without ``--sweep`` only the public wrappers are called, so the script also
times an older checkout's kernels when copied into it with
``probe_knn_fps.py`` (its profiler helpers). Writes its readings as JSON to
``--out`` (default ``build/probe_backwards.json``). Needs a card; exits 1 if
a check fails.
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
PEAK_FP32 = 67e12
PARTS = ("chamfer_backward", "group_max_backward", "group_max_forward",
         "three_interpolate_backward", "ball_query")
# the probed kernels under torch.profiler, with the list and flag kernels
# of the two-launch forms an older checkout runs
KERNEL_NAMES = ("chamfer_backward", "group_max", "three_interpolate_backward",
                "three_interpolate_dweight", "reverse_list", "ball_query")
# group_max's backward in the VRCNet step: (B, n rows, c, m points, k)
GROUP_MAX_SHAPES = [(64, 3072, 64, 1536, 10), (64, 1536, 128, 768, 10),
                    (64, 768, 256, 384, 10)]
# group_max's forward: the VRCNet step's three and ECG's three
GROUP_MAX_FWD_SHAPES = GROUP_MAX_SHAPES + [(32, 256, 840, 64, 16), (32, 1024, 360, 256, 16),
                                           (32, 3072, 120, 1024, 16)]
# three_interpolate's backward: (B, Ms source rows, C, N targets), the VRCNet
# step's three and ECG's three
TI_SHAPES = [(64, 384, 512, 768), (64, 768, 256, 1536), (64, 1536, 128, 3072),
             (32, 64, 1024, 256), (32, 256, 768, 1024), (32, 1024, 512, 3072)]
# the chamfer backward in the VRCNet step: (B, gt points, predicted points)
CHAMFER_SHAPES = [(64, 2048, 1024), (64, 2048, 3072), (64, 2048, 2048)]


def _gen(dev, seed):
    return torch.Generator(device=dev).manual_seed(seed)


def _uniform(dev, shape, seed):
    return torch.rand(shape, generator=_gen(dev, seed), device=dev)


def _bitwise(name, got, want):
    got, want = got.contiguous(), want.contiguous()
    if got.dtype == torch.float32:
        got, want = got.view(torch.int32), want.view(torch.int32)
    if got.shape != want.shape or not torch.equal(got, want):
        bad = int((got != want).sum()) if got.shape == want.shape else -1
        raise RuntimeError(f"probe_backwards: {name}: {bad} values differ")


def _split(fn, n=10):
    """{kernel: device ms a call}: of the first two profiler windows that
    recorded a kernel, of at most six, the one whose total is the larger (a
    window that lost kernels reads low)."""
    fn()
    torch.cuda.synchronize()
    wins = []
    for _ in range(6):
        w = device_window(fn, n)
        if w:
            wins.append(w)
            if len(wins) == 2:
                break
    if not wins:
        raise RuntimeError("probe_backwards: no profiler window of six recorded a kernel")
    return max(wins, key=lambda w: sum(w.values()))


def _part(split, *names):
    return sum(v for k, v in split.items() if any(m in k for m in names))


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
    row = {"kind": "chamfer_backward", "call": label, "B": B, "N": N, "M": M,
           "need": [need_a, need_b], "device_ms": sum(split.values()), "by_kernel": split,
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
    row = {"kind": "group_max_backward", "call": label, "shape": [B, n, c, m, k],
           "slot_bytes": slot.element_size(),
           "device_ms": sum(split.values()), "by_kernel": split,
           "bound_ms": nbytes / PEAK_BYTES * 1e3, "bound_by": "bytes",
           "lists": {"longest": longest, "share_over_8": share}}
    print(f"group_max backward {label} ((B, n, c, m, k) {row['shape']}, slot "
          f"{row['slot_bytes']} B): device {row['device_ms']!r} ms {json.dumps(split)}; "
          f"bound {row['bound_ms']!r} ms; lists {json.dumps(row['lists'])}; bitwise the "
          f"plain version on CPU copies, run twice", flush=True)
    return row


def group_max_forward_bytes(B, n, c, m, k, slot_bytes=1):
    """features read once, idx read once, the max and the slot written once."""
    return B * (n * c * 4 + m * k * 4 + m * c * (4 + slot_bytes))


def group_max_forward_case(label, args):
    """One group_max forward call ``args`` = (features, idx): the max (NaN
    rows included) and the slot bitwise ``ref.group_max`` on CPU copies and
    a second run, device time, bound."""
    f, idx = args
    fn = lambda: kernels.group_max_forward(f, idx)
    out, slot = fn()
    want, want_slot = ref.group_max(f.cpu(), idx.cpu())
    _bitwise(f"group_max forward {label} against the plain version on CPU copies",
             out.cpu(), want)
    _bitwise(f"group_max forward {label} slot", slot.cpu(), want_slot.to(slot.dtype))
    again = fn()
    _bitwise(f"group_max forward {label}, run twice", again[0], out)
    _bitwise(f"group_max forward {label} slot, run twice", again[1], slot)
    (B, n, c), (m, k) = f.shape, idx.shape[1:]
    split = _split(fn)
    nbytes = group_max_forward_bytes(B, n, c, m, k, slot.element_size())
    row = {"kind": "group_max_forward", "call": label, "shape": [B, n, c, m, k],
           "slot_bytes": slot.element_size(), "device_ms": _part(split, "group_max"),
           "by_kernel": split, "bound_ms": nbytes / PEAK_BYTES * 1e3, "bound_by": "bytes"}
    print(f"group_max forward {label} ((B, n, c, m, k) {row['shape']}, slot "
          f"{row['slot_bytes']} B): device {row['device_ms']!r} ms, bound "
          f"{row['bound_ms']!r} ms; bitwise the plain version on CPU copies, run twice",
          flush=True)
    return row


def ti_backward_bytes(B, ms, c, n, need_w):
    """g, idx and w read once, d_features written once; with need_w also
    the features read and d_weight written."""
    return B * (n * c * 4 + n * 3 * 8 + ms * c * 4) + (B * (ms * c * 4 + n * 3 * 4)
                                                        if need_w else 0)


def ti_backward_case(label, args):
    """One three_interpolate backward call ``args`` = (g, idx, weight,
    features, need_w): d_features bitwise the plain version on CPU copies
    and a second run (d_weight, a dot product in another order, within
    1e-5 + 1e-4 |plain|), device time by kernel (the list launches and the
    gather apart), bound, list lengths."""
    g, idx, w, f, need_w = args
    fn = lambda: kernels.three_interpolate_backward(*args)
    got = fn()
    again = fn()
    want = ref.three_interpolate_backward(g.cpu(), idx.cpu(), w.cpu(), f.cpu(), need_w)
    _bitwise(f"three_interpolate backward {label} against the plain version on CPU "
             "copies", got[0].cpu(), want[0])
    _bitwise(f"three_interpolate backward {label}, run twice", again[0], got[0])
    if (got[1] is None) != (not need_w):
        raise RuntimeError(f"probe_backwards: three_interpolate backward {label}: d_weight")
    if need_w:
        _bitwise(f"three_interpolate backward {label} d_weight, run twice", again[1], got[1])
        err = (got[1].cpu() - want[1]).abs()
        if not bool((err <= 1e-5 + 1e-4 * want[1].abs()).all()):
            raise RuntimeError(f"probe_backwards: three_interpolate backward {label} "
                               f"d_weight off by {float(err.max())}")
    B, N, C = g.shape
    Ms = f.shape[1]
    split = _split(fn)
    longest, share = _list_lengths(idx, Ms)
    nbytes = ti_backward_bytes(B, Ms, C, N, need_w)
    row = {"kind": "three_interpolate_backward", "call": label, "shape": [B, Ms, C, N],
           "need_w": bool(need_w), "device_ms": sum(split.values()), "by_kernel": split,
           "list_ms": _part(split, "reverse_list"),
           "gather_ms": _part(split, "three_interpolate_backward"),
           "dweight_ms": _part(split, "three_interpolate_dweight"),
           "bound_ms": nbytes / PEAK_BYTES * 1e3, "bound_by": "bytes",
           "lists": {"longest": longest, "share_over_8": share}}
    print(f"three_interpolate backward {label} ((B, Ms, C, N) {row['shape']}, need_w "
          f"{row['need_w']}): device {row['device_ms']!r} ms (list {row['list_ms']!r}, "
          f"gather {row['gather_ms']!r}, d_weight {row['dweight_ms']!r}) "
          f"{json.dumps(split)}; bound {row['bound_ms']!r} ms; lists "
          f"{json.dumps(row['lists'])}; bitwise the plain version on CPU copies, run twice",
          flush=True)
    return row


def ball_query_work(min_r, max_r, nsample, xyz, centers):
    """(bytes, operations) of a ball query on these inputs: the points and
    centres read once, the indices written once; each centre's pairs up to
    its ``nsample``-th hit, 11 operations a pair (3 subtractions, 3
    multiplies, 2 adds, 3 compares), as ``chip_smoke.geometry_timing_cases``
    counts them."""
    (B, n, _), m = xyz.shape, centers.shape[1]
    with torch.no_grad():
        d = ref._sqdist(centers, xyz)
        hit = (d == 0) | ((d >= ref.squared_radius(min_r)) & (d < ref.squared_radius(max_r)))
        scanned = torch.clamp((hit.cumsum(-1) < nsample).sum(-1) + 1, max=n)
    return B * (n + m) * 12 + B * m * nsample * 4, int(scanned.sum()) * 11


def ball_query_case(label, args):
    """One ball query call ``args`` = (min_r, max_r, nsample, xyz, centers):
    indices equal to ``ref.ball_query`` on CPU copies and a second run,
    device time, bound."""
    min_r, max_r, ns, xyz, centers = args
    fn = lambda: kernels.ball_query(*args)
    got = fn()
    _bitwise(f"ball_query {label} against the plain version on CPU copies", got.cpu(),
             ref.ball_query(min_r, max_r, ns, xyz.cpu(), centers.cpu()))
    _bitwise(f"ball_query {label}, run twice", fn(), got)
    nbytes, ops = ball_query_work(*args)
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, ops / PEAK_FP32 * 1e3
    split = _split(fn)
    row = {"kind": "ball_query", "call": label,
           "shape": [xyz.shape[0], xyz.shape[1], centers.shape[1], ns],
           "radius": [min_r, max_r], "device_ms": _part(split, "ball_query"),
           "by_kernel": split, "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    print(f"ball_query {label} ((B, N, M, nsample) {row['shape']}, r {row['radius']}): "
          f"device {row['device_ms']!r} ms, bound {row['bound_ms']!r} ms "
          f"({row['bound_by']}); equal to the plain version on CPU copies, run twice",
          flush=True)
    return row


CASES = {"chamfer_backward": chamfer_case, "group_max_backward": group_max_case,
         "group_max_forward": group_max_forward_case,
         "three_interpolate_backward": ti_backward_case, "ball_query": ball_query_case}


def capture(run, parts=PARTS):
    """The arguments of every call of the wrappers named in ``parts`` that
    ``run()`` makes, cloned: {wrapper name: [args, ...]}."""
    calls = {name: [] for name in parts}
    orig = {name: getattr(kernels, name) for name in parts}

    def wrap(name):
        def fn(*args):
            calls[name].append(tuple(x.clone() if torch.is_tensor(x) else x for x in args))
            return orig[name](*args)
        return fn

    for name in parts:
        setattr(kernels, name, wrap(name))
    try:
        run()
        torch.cuda.synchronize()
    finally:
        for name, fn in orig.items():
            setattr(kernels, name, fn)
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


def probe_paths(dev, steps, parts=PARTS):
    """Every call of the kernels in ``parts`` in one train step of each
    model, replayed."""
    out = {}
    for name, run in steps.items():
        calls = capture(run, parts)
        rows = []
        for kind in parts:
            got = [CASES[kind](f"{name} step call {i + 1}", args)
                   for i, args in enumerate(calls[kind])]
            if got:
                total = sum(r["device_ms"] for r in got)
                extra = ""
                if kind == "three_interpolate_backward":
                    extra = (f", d_weight asked for in {sum(r['need_w'] for r in got)} of "
                             f"{len(got)}")
                print(f"{name} step: the {len(got)} {kind} calls {total!r} ms of device "
                      f"time{extra}", flush=True)
            rows += got
        out[name] = rows
    return out


def ti_uniform_args(dev, i, B, ms, c, n):
    """three_interpolate backward inputs at (B, Ms, C, N): the 3-NN of N
    uniform points among Ms, unit-scale g, the d_features of a step (no
    d_weight)."""
    idx, w = ref.three_nn_upsampling(_uniform(dev, (B, n, 3), 700 + i),
                                     _uniform(dev, (B, ms, 3), 710 + i))
    g = _uniform(dev, (B, n, c), 720 + i) * 2 - 1
    f = _uniform(dev, (B, ms, c), 730 + i) * 2 - 1
    return g, idx, w, f, False


def gm_forward_uniform_args(dev, i, B, n, c, m, k):
    return (_uniform(dev, (B, n, c), 670 + i),
            torch.randint(0, n, (B, m, k), generator=_gen(dev, 680 + i), device=dev,
                          dtype=torch.int32))


def probe_uniform(dev, parts=PARTS):
    """group_max's forward and three_interpolate's backward at the steps'
    shapes on seeded uniform inputs."""
    rows = []
    if "group_max_forward" in parts:
        rows += [group_max_forward_case(f"uniform {list(s)}", gm_forward_uniform_args(dev, i, *s))
                 for i, s in enumerate(GROUP_MAX_FWD_SHAPES)]
    if "three_interpolate_backward" in parts:
        rows += [ti_backward_case(f"uniform {list(s)}", ti_uniform_args(dev, i, *s))
                 for i, s in enumerate(TI_SHAPES)]
    return rows


def probe_shapes(dev, parts=PARTS):
    """The chamfer and group_max backwards at the VRCNet step's shapes on
    seeded inputs."""
    rows = []
    if "group_max_backward" in parts:
        for i, (B, n, c, m, k) in enumerate(GROUP_MAX_SHAPES):
            f = torch.relu(_uniform(dev, (B, n, c), 600 + i) - 0.5)
            idx = torch.randint(0, n, (B, m, k), generator=_gen(dev, 610 + i), device=dev,
                                dtype=torch.int32)
            _, slot = kernels.group_max_forward(f, idx)
            g = _uniform(dev, (B, m, c), 620 + i) * 2 - 1
            rows.append(group_max_case(f"level {i + 1}", (g, idx, slot, n)))
    if "chamfer_backward" in parts:
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


def _sweep(label, kind, fn, want, plan_name, plans):
    """Device time of ``fn`` under each plan of ``plans`` set as
    ``kernels.<plan_name>``'s answer, each held bitwise against ``want``."""
    plan_fn = getattr(kernels, plan_name)
    out = []
    try:
        for plan in plans:
            setattr(kernels, plan_name, lambda *a, plan=plan: plan)
            got = fn()
            for x, y in zip(got if isinstance(got, tuple) else (got,), want):
                if x is not None:
                    _bitwise(f"{kind} {label} plan {plan}", x, y)
            row = {"kind": kind, "call": label, "plan": list(plan),
                   "device_ms": _part(_split(fn), *KERNEL_NAMES)}
            print(f"sweep: {json.dumps(row)}", flush=True)
            out.append(row)
    finally:
        setattr(kernels, plan_name, plan_fn)
    return out


def sweep_group_max(cases):
    """group_max's backward under other plans (output vectors a thread,
    which sets the rows a block)."""
    out = []
    for label, (g, idx, slot, n) in cases:
        (B, m, c), k = g.shape, idx.shape[2]
        want = (kernels.group_max_backward(g, idx, slot, n),)
        base = kernels.group_max_backward_plan(n, c, m, k, c // 8)
        plans = []
        for items, lanes in ((4, base[2]), (8, c // 8), (8, base[2]), (16, base[2])):
            rows = min(n, items * 32 * kernels.GROUP_MAX_BWD_WARPS // lanes)
            if kernels.group_max_backward_smem(rows, base[1], c) <= kernels.MAX_SMEM:
                plans.append((rows, base[1], lanes))
        out += _sweep(label, "group_max_backward",
                      lambda: kernels.group_max_backward(g, idx, slot, n), want,
                      "group_max_backward_plan", plans)
    return out


def sweep_group_max_forward(cases):
    """group_max's forward direct, and staged in the widest slices (a
    multiple of 8 channels) that fit in a half and in all of an SM's shared
    memory, with the loop over j unrolled for k where it can be and not."""
    out = []
    for label, (f, idx) in cases:
        (B, n, c), k = f.shape, idx.shape[2]
        want = kernels.group_max_forward(f, idx)
        widths = {min(c, stage // (4 * n) // 8 * 8)
                  for stage in (kernels.GROUP_MAX_STAGE_SMEM, kernels.MAX_SMEM)}
        unrolled = (0, k) if k in kernels.GROUP_MAX_FWD_UNROLLED else (0,)
        plans = [(4, 0, 0)] + [(4, cs, u) for cs in sorted(widths) if cs for u in unrolled]
        out += _sweep(label, "group_max_forward", lambda: kernels.group_max_forward(f, idx),
                      want, "group_max_forward_plan", plans)
    return out


def sweep_ti_backward(cases):
    """three_interpolate's backward in its list form and in its one-launch
    form at 1, 2, 4, 8 and 16 output vectors a thread (fewer, more blocks a
    cloud: each lists all of the cloud's entries, and fewer clouds' g are
    read at once)."""
    out = []
    for label, (g, idx, w, f, need_w) in cases:
        (B, N, C), Ms = g.shape, f.shape[1]
        want = kernels.three_interpolate_backward(g, idx, w, f, need_w)
        plans = [(0, 0, 0)] + [kernels.three_interpolate_backward_local_plan(Ms, C, N, C // 8, items)
                               for items in (1, 2, 4, 8, 16)]
        out += _sweep(label, "three_interpolate_backward",
                      lambda: kernels.three_interpolate_backward(g, idx, w, f, need_w),
                      want, "three_interpolate_backward_plan", plans)
    return out


def sweep(dev, steps, parts=PARTS):
    """The plans of the kernels in ``parts`` that have more than one: at
    the VRCNet and ECG steps' calls and on uniform inputs."""
    captured = {name: capture(steps[name], parts) for name in ("VRCNet", "ECG")}

    def cases(kind):
        return [(f"{name} step call {i + 1}", args) for name in ("VRCNet", "ECG")
                for i, args in enumerate(captured[name].get(kind, []))]

    out = []
    if "group_max_backward" in parts:
        uni = []
        for i, (B, n, c, m, k) in enumerate(GROUP_MAX_SHAPES):
            f = torch.relu(_uniform(dev, (B, n, c), 600 + i) - 0.5)
            idx = torch.randint(0, n, (B, m, k), generator=_gen(dev, 610 + i), device=dev,
                                dtype=torch.int32)
            _, slot = kernels.group_max_forward(f, idx)
            g = _uniform(dev, (B, m, c), 620 + i) * 2 - 1
            uni.append((f"uniform {[B, n, c, m, k]}", (g, idx, slot, n)))
        out += sweep_group_max(uni + cases("group_max_backward"))
    if "group_max_forward" in parts:
        out += sweep_group_max_forward(
            [(f"uniform {list(s)}", gm_forward_uniform_args(dev, i, *s))
             for i, s in enumerate(GROUP_MAX_FWD_SHAPES)] + cases("group_max_forward"))
    if "three_interpolate_backward" in parts:
        out += sweep_ti_backward(
            [(f"uniform {list(s)}", ti_uniform_args(dev, i, *s))
             for i, s in enumerate(TI_SHAPES)] + cases("three_interpolate_backward"))
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
    call (two profiler windows), with the probed kernels' device ms."""
    out = {}
    for name, fn in steps.items():
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        host = _host(fn, 5)
        windows = [device_window(fn, 5) for _ in range(2)]
        out[name] = {
            "host_ms": host, "device_ms": [sum(w.values()) for w in windows],
            "probed_ms": [{k: v for k, v in w.items()
                           if any(m in k for m in KERNEL_NAMES)} for w in windows]}
        r = out[name]
        print(f"{name} train step: host {r['host_ms']!r} ms, device {r['device_ms']!r} ms; "
              f"the probed kernels {json.dumps(r['probed_ms'])} (device, a call)",
              flush=True)
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--models", action="store_true",
                        help="time the PCN, VRCNet and ECG train steps too")
    parser.add_argument("--sweep", action="store_true",
                        help="time the kernels under other launch plans")
    parser.add_argument("--parts", default=",".join(PARTS),
                        help=f"the kernels probed, of {','.join(PARTS)}")
    parser.add_argument("--out", default=os.path.join("build", "probe_backwards.json"))
    arg = parser.parse_args(argv)
    parts = tuple(p for p in arg.parts.split(",") if p)
    if not set(parts) <= set(PARTS):
        parser.error(f"--parts: unknown {sorted(set(parts) - set(PARTS))}")
    if not torch.cuda.is_available():
        print("probe_backwards: needs an NVIDIA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    kernels.load()
    steps = _steps(dev)
    out = {"card": card, "uniform": probe_uniform(dev, parts),
           "shapes": probe_shapes(dev, parts), "paths": probe_paths(dev, steps, parts)}
    if arg.sweep:
        out["sweep"] = sweep(dev, steps, parts)
    if arg.models:
        out["models"] = model_times(steps)
    print(f"on {card}")
    os.makedirs(os.path.dirname(os.path.abspath(arg.out)), exist_ok=True)
    with open(arg.out, "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
