"""The two attention forward kernels (``ops/csrc/attention.cu``) on the card,
alone, at DCP's shapes: their times beside ``scaled_dot_product_attention``'s
forward on the same tensors (CUDA events, in the order library, kernel,
kernel, library), and SDPA's time by each of its backends. ``chip_smoke.py``
holds the kernels against their plain versions.

    python -m mvp_benchmark_tpu_torch.probe_attention

Needs a card.
"""

from __future__ import annotations

import subprocess
import sys

import torch

from mvp_benchmark_tpu_torch.ops import kernels


def _smi(query):
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()


def _heads(dev, B, N, M, H, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    d = H * 128
    y = torch.randn(B, N, 3 * d, device=dev, generator=g).to(torch.bfloat16)
    ym = torch.randn(B, M, 3 * d, device=dev, generator=g).to(torch.bfloat16)
    return (y[..., :d].reshape(B, N, H, 128), ym[..., d:2 * d].reshape(B, M, H, 128),
            ym[..., 2 * d:].reshape(B, M, H, 128))


def _svd(dev, B, N, M, D, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn(B, N, D, device=dev, generator=g),
            torch.randn(B, M, D, device=dev, generator=g),
            torch.rand(B, M, 3, device=dev, generator=g))


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


def _sdpa_backends(name, fn):
    """fn() -> ms per call, under SDPA's default choice and under each
    backend that takes the inputs."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    res = {"default": fn()}
    for be in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
               SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        try:
            with sdpa_kernel(be):
                res[be.name] = fn()
        except RuntimeError as e:   # a backend that refuses these inputs
            res[be.name] = f"refused ({str(e).splitlines()[0][:80]})"
    print(f"{name}: SDPA by backend, ms: {res!r}")
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_attention needs a card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = _smi("name,power.limit")
    print(card)
    kernels.load()
    print(f"kernel build {kernels.BUILD_SECONDS!r} s")

    sdpa = torch.nn.functional.scaled_dot_product_attention
    q, k, v = _heads(dev, 32, 2048, 2048, 4, 400)
    qs, ks, vs = (t.transpose(1, 2) for t in (q, k, v))
    qc, kc, vc = (t.contiguous() for t in (qs, ks, vs))
    kern = lambda: kernels.attention_bnhd_forward(q, k, v, 128 ** -0.5)
    lib_fn = lambda: sdpa(qs, ks, vs)
    r = [_time(f, 20, 3) for f in (lib_fn, kern, kern, lib_fn)]
    print(f"bf16 heads forward (32, 2048 x 2048, H 4, dk 128): SDPA {r[0]!r} / {r[3]!r} "
          f"ms, kernel {r[1]!r} / {r[2]!r} ms (kernel with stats "
          f"{_time(lambda: kernels.attention_bnhd_forward(q, k, v, 128 ** -0.5, True), 20, 3)!r}"
          f" ms); SDPA on contiguous (B, H, N, dk) copies "
          f"{_time(lambda: sdpa(qc, kc, vc), 20, 3)!r} ms on {card}")
    _sdpa_backends("bf16 heads forward", lambda: _time(lib_fn, 20, 3))
    del q, k, v, qs, ks, vs, qc, kc, vc

    sq, sk, sv = _svd(dev, 32, 2048, 2048, 512, 401)
    fkern = lambda: kernels.attention_forward(sq, sk, sv, 512 ** -0.5)
    flib = lambda: sdpa(sq, sk, sv)
    r = [_time(f, 10, 2) for f in (flib, fkern, fkern, flib)]
    print(f"fp32 svd head forward (32, 2048 x 2048, D 512, Dv 3): SDPA {r[0]!r} / {r[3]!r} "
          f"ms, kernel {r[1]!r} / {r[2]!r} ms on {card}")
    _sdpa_backends("fp32 svd head forward", lambda: _time(flib, 10, 2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
