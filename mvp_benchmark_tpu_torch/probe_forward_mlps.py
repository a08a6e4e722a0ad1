"""The forward passes of the two per-pair MLP kernels on the card, alone, at
their path shapes: IDAM's similarity MLP (``ops/csrc/sim_mlp.cu``, B 32, M
341, C 32: the eval final pass, the train final pass, stat passes 0 and 1)
and DGCNN's edge chain (``ops/csrc/edge_mlp.cu``, a1 (32, 2048, k 20, 6)
bf16 -> 64/64/128/256: the eval final pass, the train final pass with its
slots, and the stat pass of each layer). Each form is timed with CUDA
events (``probe_knn_fps._time``) and by the device time of each kernel it
launches under torch.profiler (``probe_propagate.kernel_ms``); beside it,
the least time the card could take for its work (``launch_work``); the
checks of record are ``chip_smoke.py``'s. With ``--plain`` the plain
versions in ``ops/ref.py`` are timed too. With ``--models``, DCP and IDAM
(``registration/cfgs/{dcp,idam}.yaml``, seeded weights, the synthetic
splits): a val batch and a train step on the host clock and by device
time under torch.profiler, with the two kernels' share (``model_times``).
With ``--dcp-loss cpu,kernels,plain chain,all plain``, DCP's train step loss
over ten seeds of the weights and the batch, on the CPU and on the card
(``dcp_loss_spread``); with ``--dcp-stats``, the edge chain's statistics
at that step's batch against the chain in fp64 (``dcp_stat_gaps``); with
``--dcp-stages``, ``chip_smoke.check_dcp_step_on_cpu``'s stages over the
ten seeds for the kernels and the plain chain (``dcp_stage_spread``); with
``--train-steps``, each model's train step on the host clock as
``chip_smoke.py`` times it. These four import ``chip_smoke`` (run from the
repository's root).

    python -m mvp_benchmark_tpu_torch.probe_forward_mlps [--plain] [--models]
        [--dcp-loss VARIANTS] [--dcp-stats] [--dcp-stages] [--train-steps] [--no-forms]
        [--out FILE]

Only the wrappers and their launch helpers of ``ops/kernels.py`` are
called, so the script also times an older checkout's kernels when copied
into it. Writes its readings as JSON to ``--out`` (default
``build/probe_forward_mlps.json``). Needs a card.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import re
import subprocess
import time

import torch

from mvp_benchmark_tpu_torch.ops import kernels, ref
from mvp_benchmark_tpu_torch.probe_knn_fps import _time
from mvp_benchmark_tpu_torch.probe_propagate import (PEAK_BF16, PEAK_FP32, bound_ms,
                                                     kernel_ms)

SIM_SHAPE = (32, 341)            # B, M of IDAM (registration/cfgs/idam.yaml: 2048 // 6)
EDGE_SHAPE = (32, 2048, 20)      # B, N, k of DCP's DGCNN (registration/cfgs/dcp.yaml)


def sim_inputs(dev, seed, B, M, emb=64):
    """The similarity MLP's arguments (``ref.sim_mlp_core``'s): projections
    of unit-normal embeddings, uniform positions, weights at torch's init
    scale, BatchNorm parameters and running statistics near their initial
    values."""
    C = kernels.SIM_MLP_C
    g = torch.Generator(device=dev).manual_seed(seed)
    src, tgt = (torch.rand(B, M, 3, device=dev, generator=g) for _ in range(2))
    semb, temb = (torch.randn(B, M, emb, device=dev, generator=g) for _ in range(2))
    u = lambda *s: (torch.rand(*s, device=dev, generator=g) * 2 - 1) * s[0] ** -0.5
    vec = lambda sd, mu: mu + sd * torch.randn(C, device=dev, generator=g)
    Wcat = u(2 * emb + 4, C)
    sp, tp = ref.sim_projections(semb, temb, Wcat)
    return (sp, tp, src, tgt, *ref.sim_mlp_split(Wcat, emb), u(C, C), u(C), u(C, C),
            u(C, 1), vec(0.1, 1.0), vec(0.1, 0.0), vec(0.1, 1.0), vec(0.1, 0.0),
            vec(0.1, 0.0), 0.5 + torch.rand(C, device=dev, generator=g), vec(0.1, 0.0),
            0.5 + torch.rand(C, device=dev, generator=g))


def edge_inputs(dev, seed, B, N, K):
    """Uniform clouds, their kNN edges [x_j | x_i] bf16, weights at torch's
    init scale, BatchNorm parameters near their initial values and running
    statistics."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.rand(B, N, 3, device=dev, generator=g)
    nb = ref.gather_points(x, ref.knn_indices(x, K))
    a1 = torch.cat([nb, x[:, :, None].expand_as(nb)], -1).to(torch.bfloat16)
    chs, cins = kernels.EDGE_MLP_CHANNELS[1:], kernels.EDGE_MLP_CHANNELS[:-1]
    Ws = [(torch.rand(ci, c, device=dev, generator=g) * 2 - 1) * ci ** -0.5
          for ci, c in zip(cins, chs)]
    vec = lambda c, sd, mu: mu + sd * torch.randn(c, device=dev, generator=g)
    gammas = [vec(c, 0.1, 1.0) for c in chs]
    betas = [vec(c, 0.1, 0.0) for c in chs]
    means = [vec(c, 0.1, 0.0) for c in chs]
    variances = [0.5 + torch.rand(c, device=dev, generator=g) for c in chs]
    return a1, Ws, gammas, betas, means, variances


def launch_work(B=SIM_SHAPE[0], M=SIM_SHAPE[1], EB=EDGE_SHAPE[0], EN=EDGE_SHAPE[1],
                K=EDGE_SHAPE[2]):
    """{form: (bytes, operations, peak)}: the inputs read once and the
    outputs written once; 2 operations a multiply-add, the products with
    two bf16 inputs at the bf16 peak and the fp32 operations counted as
    bf16-peak operations (times 989 / 67), so that one peak bounds their
    sum (``chip_smoke.idam_timing_cases``' rule). The similarity MLP, a
    pair: 13 fp32 operations for the distance and direction and, a channel,
    the bf16 direction product (3 multiply-adds), 4 fp32 for h0 (the
    distance term, sp + tp, the sum), 4 a BatchNorm, 1 for b2, 2 for the W4
    logit, 3 for a moment sum (an add and a multiply-add); the two 32 x 32
    bf16 products. The edge chain: layer l's product over every edge (stat
    pass l: layers 0..l; BatchNorm and relu not counted)."""
    C, P, f32 = kernels.SIM_MLP_C, B * M * M, PEAK_BF16 / PEAK_FP32
    sim_in = (2 * B * M * (C + 3) + 2496) * 4
    prods = 2 * P * (3 * C + 2 * C * C)
    E, pts = EB * EN * K, EB * EN
    c = [a * b for a, b in zip(kernels.EDGE_MLP_CHANNELS[:-1], kernels.EDGE_MLP_CHANNELS[1:])]
    a1 = E * 6 * 2
    work = {
        "sim final (eval)": (sim_in + (P + B * M * C) * 4,
                             prods + P * (13 + 15 * C) * f32, PEAK_BF16),
        "sim final (train, argj)": (sim_in + (P + 2 * B * M * C) * 4,
                                    prods + P * (13 + 15 * C) * f32, PEAK_BF16),
        "sim stat 0": (sim_in, 2 * P * 3 * C + P * (13 + 7 * C) * f32, PEAK_BF16),
        "sim stat 1": (sim_in, prods + P * (13 + 12 * C) * f32, PEAK_BF16),
        "edge final (eval)": (a1 + sum(c) * 2 + pts * 512 * 4, 2 * E * sum(c), PEAK_BF16),
        "edge final (train, slots)": (a1 + sum(c) * 2 + pts * 512 * 5, 2 * E * sum(c),
                                      PEAK_BF16),
    }
    for layer in range(4):
        work[f"edge stat {layer}"] = (a1 + sum(c[:layer + 1]) * 2,
                                      2 * E * sum(c[:layer + 1]), PEAK_BF16)
    return work


def sim_forms(dev):
    """{form: (kernel call, plain call)} of the similarity MLP."""
    x = sim_inputs(dev, 901, *SIM_SHAPE)
    args = x[4:14]
    sp, tp, src, tgt = x[:4]
    st1, st2 = kernels.sim_mlp_batch_stats(*x[:14])
    lib = kernels.load()
    launch = lambda mode, s1, s2: kernels._sim_forward_launch(
        lib, mode, sp, tp, src, tgt, kernels._sim_params(*args, s1, s2), None)
    return {
        "sim final (eval)": (lambda: kernels.sim_mlp_forward(*x),
                             lambda: ref.sim_mlp_core(*x)),
        "sim final (train, argj)": (lambda: launch(1, st1, st2),
                                    lambda: ref.sim_mlp_slots(*x[:14], st1, st2)),
        "sim stat 0": (lambda: launch(2, None, None), None),
        "sim stat 1": (lambda: launch(3, st1, None), None),
        "sim two stat passes": (lambda: kernels.sim_mlp_batch_stats(*x[:14]),
                                lambda: ref.sim_mlp_batch_stats(*x[:9], *x[10:12])),
        "sim train forward": (lambda: kernels.sim_mlp_train_forward(*x[:14]), None),
    }


def edge_forms(dev):
    """{form: (kernel call, plain call)} of the edge chain."""
    B, N, K = EDGE_SHAPE
    a1, Ws, gammas, betas, means, variances = edge_inputs(dev, 402, B, N, K)
    ws = [w.to(torch.bfloat16).contiguous() for w in Ws]
    lib = kernels.load()
    stats = kernels.edge_mlp_batch_stats(a1, ws, gammas, betas)
    smean, svar = [s[0] for s in stats], [s[1] for s in stats]
    train_ss = kernels._folded(gammas, betas, smean, svar, dev)
    slots = torch.empty((B, N, 512), dtype=torch.uint8, device=dev)
    cap = kernels._max_blocks(dev)
    # rows for two partials a block: enough for either partial layout
    part = torch.zeros((2 * cap, 2, 256), dtype=torch.float32, device=dev)

    def stat(layer):
        scale, shift = kernels._folded(gammas[:layer], betas[:layer], smean[:layer],
                                       svar[:layer], dev)
        return lambda: kernels._launch(
            lib.edge_mlp_stat, a1.data_ptr(), *[w.data_ptr() for w in ws], scale.data_ptr(),
            shift.data_ptr(), B * N, K, layer, cap, part.data_ptr(), kernels._stream(dev))

    forms = {
        "edge final (eval)": (
            lambda: kernels.edge_mlp_forward(a1, Ws, gammas, betas, means, variances),
            lambda: ref.edge_mlp_eval(a1, Ws, gammas, betas, means, variances)),
        "edge final (train, slots)": (
            lambda: kernels._edge_final(lib, a1, ws, *train_ss, slots), None),
    }
    for layer in range(4):
        forms[f"edge stat {layer}"] = (stat(layer), None)
    forms["edge four stat passes"] = (
        lambda: kernels.edge_mlp_batch_stats(a1, ws, gammas, betas),
        lambda: ref.edge_mlp_train(a1, Ws, gammas, betas))
    forms["edge train forward"] = (
        lambda: kernels.edge_mlp_train_forward(a1, Ws, gammas, betas), None)
    return forms


def probe(dev, plain=False):
    """One row a form: its event time, the device time of each kernel it
    launches and (``plain``) the plain version's event time."""
    bounds = {key: bound_ms(*w) for key, w in launch_work().items()}
    rows = []
    for forms in (sim_forms, edge_forms):
        for label, (kern, pl) in forms(dev).items():
            row = {"form": label, "ms": _time(kern), "device_ms": kernel_ms(kern),
                   "bound_ms": bounds.get(label)}
            if plain and pl is not None:
                row["plain_ms"] = _time(pl)
            rows.append(row)
            torch.cuda.synchronize()
    return rows


def _device_window(fn, n):
    """{kernel: device ms a call} over ``n`` calls of ``fn`` under
    torch.profiler."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out: dict = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us = getattr(e, "self_device_time_total", None) or e.self_cuda_time_total
            key = re.sub(r"\(.*$", "", e.key.replace("(anonymous namespace)::", "")
                         .replace("void ", "")).strip()
            out[key] = out.get(key, 0.0) + us / n / 1e3
    return out


def model_times(dev, cfg_path, steps=5, repeats=3):
    """A registration model's val batch (``make_registration_eval_step`` on
    the val split's first batch) and train step
    (``make_registration_train_step`` on the train split's first batch),
    after three warm-ups: the host clock over ``steps`` calls ending in a
    synchronise, ``repeats`` times; the device time a call under
    torch.profiler in two windows of ``steps`` calls (all kernels, and the
    two MLP kernels' launches by name)."""
    from mvp_benchmark_tpu_torch.data.mvp import BatchSpec
    from mvp_benchmark_tpu_torch.train import engine
    from mvp_benchmark_tpu_torch.train.config import load_config
    from mvp_benchmark_tpu_torch.train.optim import build_optimizer

    cfg = load_config(cfg_path)
    data = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(cfg_path))), "data")
    spec = BatchSpec(int(cfg.batch_size))
    step = engine.make_registration_eval_step(engine.build_model(cfg, dev), dev)
    batch = next(iter(engine.registration_dataset(cfg, "val", data).batches(spec)))
    model = engine.build_model(cfg, dev, seed=1, for_training=True)
    train = engine.make_registration_train_step(
        model.train(), build_optimizer(cfg, model.parameters()), dev)
    tbatch = next(engine.registration_dataset(cfg, "train", data).batches(
        BatchSpec(int(cfg.batch_size), shuffle=True, seed=1)))
    out = {}
    for what, fn in (("val batch", lambda: step(batch, prefix="val")),
                     ("train step", lambda: train(tbatch))):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        host = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            for _ in range(steps):
                fn()
            torch.cuda.synchronize()
            host.append((time.perf_counter() - t0) * 1e3 / steps)
        windows = [_device_window(fn, steps) for _ in range(2)]
        out[what] = {
            "host_ms": host,
            "device_ms": [sum(w.values()) for w in windows],
            "mlp_kernels_ms": [{k: v for k, v in w.items()
                                if "edge_mlp" in k or "sim_mlp" in k} for w in windows]}
    return out


DCP_VARIANTS = ("cpu", "kernels", "plain chain", "all plain")


@contextlib.contextmanager
def _plain_attention():
    """DCP's attentions (``ops.attention``, ``ops.attention_bnhd``) by their
    plain versions, differentiated by autograd."""
    from mvp_benchmark_tpu_torch import ops

    saved = ops.attention, ops.attention_bnhd
    ops.attention, ops.attention_bnhd = ref.attention, ref.attention_bnhd
    try:
        yield
    finally:
        ops.attention, ops.attention_bnhd = saved


@contextlib.contextmanager
def _plain_forward():
    """DCP's step forward with its edge chain
    (``chip_smoke.plain_dcp_chain``) and its attentions plain."""
    import chip_smoke

    with chip_smoke.plain_dcp_chain(), _plain_attention():
        yield


def dcp_loss_spread(dev, seeds=range(1, 11), variants=DCP_VARIANTS):
    """DCP's train step loss on two full-width pairs (``chip_smoke``'s
    ``_dcp_step_on``), the weights and the batch seeded by each of
    ``seeds``: on the CPU, and on the card with the kernels, with the plain
    edge chain (``chip_smoke.plain_dcp_chain``) and with the plain chain and
    attentions (``_plain_forward``) -> {variant: [loss a seed]}."""
    import chip_smoke
    from mvp_benchmark_tpu_torch.train.config import load_config

    cfg = load_config(chip_smoke.DCP_CFG)
    runs = {"cpu": (torch.device("cpu"), contextlib.nullcontext),
            "kernels": (dev, contextlib.nullcontext),
            "plain chain": (dev, chip_smoke.plain_dcp_chain),
            "all plain": (dev, _plain_forward)}
    out = {v: [] for v in variants}
    for seed in seeds:
        batch = chip_smoke._dcp_train_batch(cfg, 2, seed=seed)
        for v in variants:
            device, ctx = runs[v]
            with ctx():
                out[v].append(chip_smoke._dcp_step_on(cfg, device, batch, seed=seed)[0])
    return out


def dcp_stage_spread(dev, seeds=range(1, 11)):
    """``chip_smoke.check_dcp_step_on_cpu``'s stages over ten seeds of the
    weights and the batch, for the kernels and the witness (the plain chain
    on the card, ``chip_smoke.plain_dcp_chain``) -> {variant: [a seed's
    readings]}: stage (a)'s worst gap to fp64, and for stage (b) (the CPU
    given the card's statistics) and the free run the loss gap absolute and
    relative, the worst cosine outside the chain, the chain's worst cosine
    and normwise gap."""
    import chip_smoke
    from mvp_benchmark_tpu_torch.train.config import load_config

    cfg = load_config(chip_smoke.DCP_CFG)
    out = {"kernels": [], "plain chain": []}
    for seed in seeds:
        batch = chip_smoke._dcp_train_batch(cfg, 2, seed=seed)
        free = chip_smoke._dcp_step_on(cfg, torch.device("cpu"), batch, seed=seed)
        for variant, ctx in (("kernels", contextlib.nullcontext),
                             ("plain chain", chip_smoke.plain_dcp_chain)):
            r = chip_smoke.dcp_step_stages(cfg, dev, batch, free, ctx, seed=seed)
            row = {"seed": seed, "loss": r["given"]["loss"],
                   "a": max(g for call in r["stat_gaps"] for layer in call for g in layer)}
            for stage in ("given", "free"):
                s = r[stage]
                row[stage] = {"abs": s["abs"], "rel": s["rel"], "cosine": s["cosine"][1],
                              "chain_cosine": min(c[0] for c in s["chain"].values()),
                              "chain_normwise": max(c[1] for c in s["chain"].values())}
            out[variant].append(row)
    return out


def dcp_stat_gaps(dev, seed=1):
    """The edge chain's batch statistics at DCP's own step batch (the first
    ``ops.edge_mlp_train`` call of ``chip_smoke._dcp_step_on`` on the card,
    seed ``seed``), each layer's mean and variance normwise against the
    chain in fp64 (``ref.edge_mlp_stats_given``): the kernel's stat
    passes, the plain chain on the card and on the CPU
    (``ref.edge_mlp_train``, fp32), each with its own statistics for the
    layers below; and, with the fp64 statistics folded
    into the layers below (``ref.bn_scale_shift``), the kernel's stat pass
    against the fp32 chain on the card, which isolates each pass's sums
    from what the layers below hand it."""
    import chip_smoke
    from mvp_benchmark_tpu_torch.train.config import load_config

    cfg = load_config(chip_smoke.DCP_CFG)
    seen = []
    with chip_smoke.record_dcp_chain(seen):
        chip_smoke._dcp_step_on(cfg, dev, chip_smoke._dcp_train_batch(cfg, 2, seed=seed),
                                seed=seed)
    a1, Ws, gammas, betas, _ = seen[0]
    ws = [w.to(torch.bfloat16).contiguous() for w in Ws]
    f64 = torch.float64
    truth = ref.edge_mlp_stats_given(a1, Ws, gammas, betas, dtype=f64)

    def given(gs, bs, means, variances, device):
        """``kernels._folded`` with the fp64 statistics of the layers below."""
        n = len(gs)
        return folded(gs, bs, [t[0].float() for t in truth[:n]],
                      [t[1].float() for t in truth[:n]], device)

    folded = kernels._folded
    kernels._folded = given
    try:
        isolated = kernels.edge_mlp_batch_stats(a1, ws, gammas, betas)
    finally:
        kernels._folded = folded
    cpu = lambda xs: [x.cpu() for x in xs]
    readings = {
        "kernel": kernels.edge_mlp_batch_stats(a1, ws, gammas, betas),
        "plain card": ref.edge_mlp_train(a1, Ws, gammas, betas)[1],
        "plain cpu": ref.edge_mlp_train(*cpu([a1]), cpu(Ws), cpu(gammas), cpu(betas))[1],
        "kernel, fp64 below": isolated,
        "fp32 chain card, fp64 below": ref.edge_mlp_stats_given(a1, Ws, gammas, betas,
                                                                truth)}
    gaps = {}
    for name, stats in readings.items():
        gaps[name] = [[float((st[i].to(f64).cpu() - t[i].cpu()).norm() / t[i].norm())
                       for i in (0, 1)] for st, t in zip(stats, truth)]
    return {"edges": int(a1.shape[0] * a1.shape[1] * a1.shape[2]),
            "gaps [mean, var] a layer": gaps}


def train_steps(dev, card):
    """``chip_smoke.time_train_steps`` for each model's train step, host
    clock, as chip_smoke.py times them."""
    import chip_smoke
    from mvp_benchmark_tpu_torch.train.config import load_config

    out = {}
    for name, path in (("PCN", chip_smoke.PCN_CFG), ("VRCNet", chip_smoke.VRCNET_CFG),
                       ("ECG", chip_smoke.ECG_CFG)):
        cfg = load_config(path)
        out[name] = chip_smoke.time_train_steps(
            name, cfg, card, *chip_smoke.completion_step(cfg, dev), "points")["ms_per_step"]
    for name, path in (("DCP", chip_smoke.DCP_CFG), ("IDAM", chip_smoke.IDAM_CFG)):
        cfg = load_config(path)
        out[name] = chip_smoke.time_train_steps(
            name, cfg, card, *chip_smoke.registration_step(cfg, dev), "pairs",
            steps=3)["ms_per_step"]
    return out


def resources():
    """ptxas's registers, spills and shared memory of the forward kernels."""
    lines, entry = [], ""
    for ln in kernels.BUILD_LOG.splitlines():
        if "Compiling entry" in ln:
            entry = ln.split("entry function")[-1].strip()
        elif (("sim_mlp" in entry or "edge_mlp" in entry) and "backward" not in entry
              and ("Used" in ln or "spill" in ln)):
            lines.append(f"{entry}: {ln.strip()}")
    return lines


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--plain", action="store_true", help="time the plain versions too")
    parser.add_argument("--models", action="store_true",
                        help="time DCP's and IDAM's val batch and train step too")
    parser.add_argument("--dcp-loss", default="",
                        help="comma-separated variants of DCP's step loss over ten seeds "
                             f"(of {', '.join(DCP_VARIANTS)})")
    parser.add_argument("--dcp-stats", action="store_true",
                        help="the edge chain's statistics at DCP's step batch against fp64")
    parser.add_argument("--dcp-stages", action="store_true",
                        help="chip_smoke's staged DCP step check over ten seeds, kernels "
                             "and the plain chain")
    parser.add_argument("--train-steps", action="store_true",
                        help="each model's train step on the host clock, as chip_smoke's")
    parser.add_argument("--no-forms", action="store_true", help="skip the forms' timings")
    parser.add_argument("--out", default=os.path.join("build", "probe_forward_mlps.json"))
    arg = parser.parse_args(argv)
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    kernels.load()
    out = {"card": card, "build_s": kernels.BUILD_SECONDS, "resources": resources()}
    if arg.dcp_loss:
        out["dcp_loss"] = dcp_loss_spread(dev, variants=arg.dcp_loss.split(","))
        print(f"DCP step loss a seed: {json.dumps(out['dcp_loss'])}")
    if arg.dcp_stats:
        out["dcp_stats"] = dcp_stat_gaps(dev)
        print(f"DCP step edge chain statistics: {json.dumps(out['dcp_stats'])}")
    if arg.dcp_stages:
        out["dcp_stages"] = dcp_stage_spread(dev)
        for variant, rows in out["dcp_stages"].items():
            for r in rows:
                print(f"DCP step stages, {variant}, seed {r['seed']}: loss {r['loss']!r}; "
                      f"(a) {r['a']!r}; (b) {json.dumps(r['given'])}; free "
                      f"{json.dumps(r['free'])}")
    if arg.train_steps:
        out["train_steps_ms"] = train_steps(dev, card)
    out["forms"] = [] if arg.no_forms else probe(dev, arg.plain)
    for ln in out["resources"]:
        print(ln)
    for row in out["forms"]:
        split = ", ".join(f"{n} {ms!r}" for n, ms in sorted(row["device_ms"].items(),
                                                             key=lambda kv: -kv[1]))
        print(f"{row['form']}: {row['ms']!r} ms (events)"
              + (f", plain {row['plain_ms']!r} ms" if "plain_ms" in row else "")
              + (f", bound {row['bound_ms']!r} ms" if row["bound_ms"] else "")
              + f"; device ms a call: {split}")
    if arg.models:
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        out["models"] = {m: model_times(dev, os.path.join(root, "registration", "cfgs",
                                                         f"{m}.yaml"))
                         for m in ("idam", "dcp")}
        for m, rows in out["models"].items():
            for what, r in rows.items():
                print(f"{m} {what}: host {r['host_ms']!r} ms, device {r['device_ms']!r} ms; "
                      f"the MLP kernels (device ms a call): {json.dumps(r['mlp_kernels_ms'])}")
    print(f"on {card}")
    os.makedirs(os.path.dirname(os.path.abspath(arg.out)), exist_ok=True)
    with open(arg.out, "w") as f:
        json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
