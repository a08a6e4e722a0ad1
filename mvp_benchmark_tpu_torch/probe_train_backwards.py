"""The two training backwards redesigned for Hopper, on the card, alone:
DGCNN's edge chain (``edge_mlp_train_backward``, ``ops/csrc/edge_mlp.cu``)
and IDAM's similarity MLP (``sim_mlp_train_backward``,
``ops/csrc/sim_mlp.cu``). Their build resources; each held against its
plain version at ragged shapes and at the train step's (the edge chain
against autograd of ``ref.edge_mlp_train``, normwise 2e-2; the similarity
MLP against ``ref.sim_mlp_backward``, normwise 2e-4), two runs bitwise
equal; their times at the train step's shapes beside the plain versions'
(CUDA events, in the order plain, kernel, kernel, plain) and each pass's
device time under ``torch.profiler``.

    python -m mvp_benchmark_tpu_torch.probe_train_backwards

Needs a card (~1 min with the build); exits 1 if a check fails.
"""

from __future__ import annotations

import subprocess
import sys

import torch

from mvp_benchmark_tpu_torch.ops import kernels, ref

EDGE_GRAD_NORM, IDAM_GRAD_NORM = 2e-2, 2e-4


def _edge_case(dev, B, N, K, seed):
    """Uniform clouds, their kNN edges [x_j | x_i] bf16, weights at torch's
    init scale, BatchNorm parameters near their initial values, unit-normal
    cotangents of the four max-pools."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.rand(B, N, 3, device=dev, generator=g)
    nb = ref.gather_points(x, ref.knn_indices(x, K))
    a1 = torch.cat([nb, x[:, :, None].expand_as(nb)], -1).to(torch.bfloat16)
    chs, cins = kernels.EDGE_MLP_CHANNELS[1:], kernels.EDGE_MLP_CHANNELS[:-1]
    Ws = [(torch.rand(ci, c, device=dev, generator=g) * 2 - 1) * ci ** -0.5
          for ci, c in zip(cins, chs)]
    gammas = [1 + 0.1 * torch.randn(c, device=dev, generator=g) for c in chs]
    betas = [0.1 * torch.randn(c, device=dev, generator=g) for c in chs]
    gxs = [torch.randn(B, N, c, device=dev, generator=g) for c in chs]
    return a1, Ws, gammas, betas, gxs


def _sim_case(dev, B, M, seed, ties=False):
    """The similarity MLP's train inputs (``ref.sim_mlp_batch_stats``'
    arguments and W4, g2, be2; ``ties``: the second quarter of the targets
    repeats the first), unit-normal cotangents of simr and wmax."""
    C, emb = kernels.SIM_MLP_C, 64
    g = torch.Generator(device=dev).manual_seed(seed)
    src, tgt = (torch.rand(B, M, 3, device=dev, generator=g) for _ in range(2))
    semb, temb = (torch.randn(B, M, emb, device=dev, generator=g) for _ in range(2))
    if ties:
        h = M // 4
        tgt[:, h:2 * h], temb[:, h:2 * h] = tgt[:, :h], temb[:, :h]
    u = lambda *s: (torch.rand(*s, device=dev, generator=g) * 2 - 1) * s[0] ** -0.5
    vec = lambda sd, mu: mu + sd * torch.randn(C, device=dev, generator=g)
    Wcat = u(2 * emb + 4, C)
    sp, tp = ref.sim_projections(semb, temb, Wcat)
    x = (sp, tp, src, tgt, *ref.sim_mlp_split(Wcat, emb), u(C, C), u(C), u(C, C), u(C, 1),
         vec(0.1, 1.0), vec(0.1, 0.0), vec(0.1, 1.0), vec(0.1, 0.0))
    return x, torch.randn(B, M, M, device=dev, generator=g), torch.randn(
        B, M, C, device=dev, generator=g)


def _normwise(got, want):
    g, w = got.double(), want.double()
    gap, norm = float((g - w).norm()), float(w.norm())
    return gap / norm if norm > 0 else (0.0 if gap == 0 else float("inf"))


def _time(fn, n=10, warm=2):
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


def _edge(dev, shape):
    a1, Ws, gammas, betas, gxs = _edge_case(dev, *shape, seed=700 + shape[1])
    _, stats, slots = kernels.edge_mlp_train_forward(a1, Ws, gammas, betas)
    run = lambda: kernels.edge_mlp_train_backward(a1, Ws, gammas, betas, stats, slots, gxs,
                                                  need_a1=True)
    got, again = run(), run()
    flat = lambda r: [r[0], *r[1], *r[2], *r[3]]
    plain = flat(ref.edge_mlp_backward(a1, Ws, gammas, betas, stats, slots, gxs))
    errs = [_normwise(x.float(), w.float()) for x, w in zip(flat(got), plain)]
    leaves = [x.clone().requires_grad_() for x in (a1, *Ws, *gammas, *betas)]
    want_xs, _ = ref.edge_mlp_train(leaves[0], leaves[1:5], leaves[5:9], leaves[9:])
    auto = [_normwise(x.float(), w.float()) for x, w in zip(
        flat(got), torch.autograd.grad(want_xs, leaves, gxs))]
    same = all(torch.equal(x, y) for x, y in zip(flat(got), flat(again)))
    ok = max(errs) <= EDGE_GRAD_NORM and same
    print(f"edge_mlp_backward {shape} (B, N, k): normwise d_a1, dW0..3, dgamma0..3, "
          f"dbeta0..3 against ref.edge_mlp_backward {[float(f'{e:.3g}') for e in errs]}, "
          f"worst {max(errs)!r}; against autograd of ref.edge_mlp_train "
          f"{[float(f'{e:.3g}') for e in auto]}, worst {max(auto)!r}; two runs bitwise "
          f"equal {same} -> {'ok' if ok else 'FAIL'}")
    return ok


def _sim(dev, shape, ties=False):
    x, dsimr, dwmax = _sim_case(dev, *shape, seed=4000 + shape[1], ties=ties)
    _, _, st1, st2, argj = kernels.sim_mlp_train_forward(*x)
    run = lambda: kernels.sim_mlp_train_backward(*x, st1, st2, argj, dsimr, dwmax)
    got, again = run(), run()
    want = ref.sim_mlp_backward(*x, st1, st2, argj, dsimr, dwmax)
    errs = [_normwise(a, w) for a, w in zip(got, want)]
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    ok = max(errs) <= IDAM_GRAD_NORM and same
    print(f"sim_mlp_backward {shape} (B, M){', ties' if ties else ''}: normwise dsp, dtp, "
          f"dw0, dwxyz, dW2, db2, dW3, dW4, dg1, dbe1, dg2, dbe2 "
          f"{[float(f'{e:.3g}') for e in errs]}, worst {max(errs)!r}; two runs bitwise "
          f"equal {same} -> {'ok' if ok else 'FAIL'}")
    return ok


def _profile(fn, names):
    """Device time a call of each kernel whose name holds one of ``names``,
    over 3 calls under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        if any(n in ev.key for n in names):
            dt = getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0)
            out[ev.key] = (ev.count // 3, dt / 3 / 1e3)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_train_backwards needs a card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card)
    kernels.load()
    print(f"kernel build {kernels.BUILD_SECONDS!r} s")
    entry = ""
    for ln in kernels.BUILD_LOG.splitlines():
        if "Compiling entry" in ln:
            entry = ln
        elif ("backward_kernel" in entry and ("edge_mlp" in entry or "sim_mlp" in entry)
              and ("Used" in ln or "spill" in ln)):
            print(f"  {entry.split('entry function')[-1].strip()}: {ln.strip()}")
    ok = all([_edge(dev, s) for s in ((2, 5, 1), (1, 21, 20), (3, 1001, 7), (2, 37, 20),
                                      (32, 2048, 20))])
    ok &= all([_sim(dev, s) for s in ((1, 1), (3, 37), (32, 341))])
    ok &= _sim(dev, (2, 64), ties=True)

    a1, Ws, gammas, betas, gxs = _edge_case(dev, 32, 2048, 20, seed=802)
    _, stats, slots = kernels.edge_mlp_train_forward(a1, Ws, gammas, betas)
    leaves = [x.clone().requires_grad_() for x in (*Ws, *gammas, *betas)]
    plain_xs, _ = ref.edge_mlp_train(a1, leaves[:4], leaves[4:8], leaves[8:])
    kern = lambda: kernels.edge_mlp_train_backward(a1, Ws, gammas, betas, stats, slots, gxs)
    plain = lambda: torch.autograd.grad(plain_xs, leaves, gxs, retain_graph=True)
    r = [_time(f, 5) for f in (plain, kern, kern, plain)]
    print(f"edge_mlp_backward (32, 2048, k 20), five passes: kernel {r[1]!r} / {r[2]!r} ms, "
          f"plain {r[0]!r} / {r[3]!r} ms on {card}")
    for name, (n, ms) in _profile(kern, ["edge_mlp_backward"]).items():
        print(f"  {name}: {n} a call, {ms!r} ms a call")
    del plain_xs, leaves
    x, dsimr, dwmax = _sim_case(dev, 32, 341, seed=912)
    _, _, st1, st2, argj = kernels.sim_mlp_train_forward(*x)
    kern = lambda: kernels.sim_mlp_train_backward(*x, st1, st2, argj, dsimr, dwmax)
    plain = lambda: ref.sim_mlp_backward(*x, st1, st2, argj, dsimr, dwmax)
    r = [_time(f, 5) for f in (plain, kern, kern, plain)]
    print(f"sim_mlp_backward (32, 341 x 341, C 32), three passes: kernel {r[1]!r} / "
          f"{r[2]!r} ms, plain {r[0]!r} / {r[3]!r} ms on {card}")
    for name, (n, ms) in _profile(kern, ["sim_mlp_backward"]).items():
        print(f"  {name}: {n} a call, {ms!r} ms a call")
    print("all checks ok" if ok else "a check FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
