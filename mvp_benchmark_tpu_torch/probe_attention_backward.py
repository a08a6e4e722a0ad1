"""The two attention backward kernels (``ops/csrc/attention_backward.cu``)
on the card, alone: their build resources, each held against
``ref.attention_backward`` at a small, two ragged and DCP's shape (bf16
heads normwise 1e-3, the svd head's fp32 within 1e-5 + 1e-4 |plain|), two
runs bitwise equal, and their times at DCP's shapes beside
``scaled_dot_product_attention``'s backward on the same tensors (CUDA
events, in the order library, kernel, kernel, library), the heads' two
passes apart, and the svd head's peak of allocated memory.

    python -m mvp_benchmark_tpu_torch.probe_attention_backward

Needs a card; exits 1 if a check fails.
"""

from __future__ import annotations

import subprocess
import sys

import torch

from mvp_benchmark_tpu_torch.ops import kernels, ref


def _heads_case(dev, B, N, M, H, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    d = H * 128
    y = torch.randn(B, N, 3 * d, device=dev, generator=g).to(torch.bfloat16)
    ym = torch.randn(B, M, 3 * d, device=dev, generator=g).to(torch.bfloat16)
    q = y[..., :d].reshape(B, N, H, 128)
    k, v = ym[..., d:2 * d].reshape(B, M, H, 128), ym[..., 2 * d:].reshape(B, M, H, 128)
    scale = 128 ** -0.5
    o, m, l = kernels.attention_bnhd_forward(q, k, v, scale, stats=True)
    d_out = torch.randn(o.shape, device=dev, generator=g).to(torch.bfloat16)
    return q, k, v, o, m, l, d_out, scale


def _svd_case(dev, B, N, M, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(B, N, 512, device=dev, generator=g)
    k = torch.randn(B, M, 512, device=dev, generator=g)
    v = torch.rand(B, M, 3, device=dev, generator=g)
    scale = 512 ** -0.5
    o, m, l = kernels.attention_forward(q, k, v, scale, stats=True)
    return q, k, v, o, m, l, torch.randn(o.shape, device=dev, generator=g), scale


def _time(fn, n=10, warm=3):
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


def _check_heads(dev, shape):
    *x, d_out, scale = _heads_case(dev, *shape, seed=500 + shape[1])
    got = kernels.attention_bnhd_backward(*x, d_out, scale)
    again = kernels.attention_bnhd_backward(*x, d_out, scale)
    want = ref.attention_backward(*x, d_out, scale)
    torch.cuda.synchronize()
    errs = [float((a.double() - w.double()).norm() / w.double().norm())
            for a, w in zip(got, want)]
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    ok = max(errs) <= 1e-3 and same
    print(f"bf16 heads {shape} (B, N, M, H): normwise dq, dk, dv {errs!r}, two runs "
          f"bitwise equal {same} -> {'ok' if ok else 'FAIL'}")
    return ok


def _check_svd(dev, shape):
    *x, d_out, scale = _svd_case(dev, *shape, seed=600 + shape[1])
    got = kernels.attention_backward(*x, d_out, scale)
    again = kernels.attention_backward(*x, d_out, scale)
    want = ref.attention_backward(*x, d_out, scale)
    torch.cuda.synchronize()
    over = [int(((a - w).abs() > 1e-5 + 1e-4 * w.abs()).sum()) for a, w in zip(got, want)]
    worst = [float((a - w).abs().max()) for a, w in zip(got, want)]
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    ok = sum(over) == 0 and same
    print(f"fp32 svd head {shape} (B, N, M): max |diff| dq, dk, dv {worst!r}, elements "
          f"over the bar {over}, two runs bitwise equal {same} -> {'ok' if ok else 'FAIL'}")
    return ok


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_attention_backward needs a card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card)
    kernels.load()
    print(f"kernel build {kernels.BUILD_SECONDS!r} s")
    take = False
    for ln in kernels.BUILD_LOG.splitlines():
        if ln.startswith("== "):
            take = ln.strip() == "== attention_backward.cu"
        elif take and ("Compiling entry" in ln or "Used" in ln or "spill" in ln
                       or "Performance" in ln or "setmaxnreg" in ln):
            print(f"  {ln.strip()}")
    ok = all(_check_heads(dev, s) for s in
             ((1, 128, 128, 1), (1, 129, 65, 1), (2, 1000, 777, 3), (32, 2048, 2048, 4)))
    ok &= all(_check_svd(dev, s) for s in
              ((1, 128, 128), (1, 129, 65), (3, 1000, 777), (32, 2048, 2048)))

    sdpa = torch.nn.functional.scaled_dot_product_attention
    *hx, h_do, h_scale = _heads_case(dev, 32, 2048, 2048, 4, 800)
    hq, hk, hv = (t.transpose(1, 2).detach().requires_grad_() for t in hx[:3])
    h_out = sdpa(hq, hk, hv)
    lib = lambda: torch.autograd.grad(h_out, (hq, hk, hv), h_do.transpose(1, 2),
                                      retain_graph=True)
    kern = lambda: kernels.attention_bnhd_backward(*hx, h_do, h_scale)
    r = [_time(f) for f in (lib, kern, kern, lib)]
    dq = _time(lambda: kernels.attention_bnhd_backward(*hx, h_do, h_scale,
                                                       need=(True, False, False)))
    dkv = _time(lambda: kernels.attention_bnhd_backward(*hx, h_do, h_scale,
                                                        need=(False, True, True)))
    print(f"bf16 heads backward (32, 2048 x 2048, H 4, dk 128): SDPA's backward "
          f"{r[0]!r} / {r[3]!r} ms, kernel {r[1]!r} / {r[2]!r} ms; the dQ pass alone "
          f"{dq!r} ms, the dK/dV pass alone {dkv!r} ms (each with the statistics "
          f"kernel) on {card}")
    *fx, f_do, f_scale = _svd_case(dev, 32, 2048, 2048, 801)
    fq, fk = (t.detach().requires_grad_() for t in fx[:2])
    f_out = sdpa(fq, fk, fx[2])
    flib = lambda: torch.autograd.grad(f_out, (fq, fk), f_do, retain_graph=True)
    fkern = lambda: kernels.attention_backward(*fx, f_do, f_scale, need=(True, True, False))
    r = [_time(f, 5, 2) for f in (flib, fkern, fkern, flib)]
    dq = _time(lambda: kernels.attention_backward(*fx, f_do, f_scale,
                                                  need=(True, False, False)), 5, 2)
    dk = _time(lambda: kernels.attention_backward(*fx, f_do, f_scale,
                                                  need=(False, True, False)), 5, 2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    fkern()
    torch.cuda.synchronize()
    extra = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
    print(f"fp32 svd head backward (32, 2048 x 2048, D 512, Dv 3), dq and dk: SDPA's "
          f"backward {r[0]!r} / {r[3]!r} ms, kernel {r[1]!r} / {r[2]!r} ms; dq alone "
          f"{dq!r} ms, dk alone {dk!r} ms (each with the ds pass); the call "
          f"allocates {extra!r} MiB at its peak (outputs and the ds scratch) on {card}")
    print("all checks ok" if ok else "a check FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
