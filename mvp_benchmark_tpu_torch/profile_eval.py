"""Where the time of an eval pass goes on the card: ``torch.profiler`` over a
few val passes of a completion config, after warm-up passes.

    python -m mvp_benchmark_tpu_torch.profile_eval -c completion/cfgs/ecg.yaml
    python -m mvp_benchmark_tpu_torch.profile_eval -c completion/cfgs/vrcnet.yaml

Prints, per val batch: the device time by kernel group (the port's CUDA
kernels by name, cuBLAS GEMMs, the rest of PyTorch's kernels), the wall
time under the profiler and the share of it the device is busy, the matrix
products' FLOPs (counted by ``FlopCounterMode`` on one batch) and their
rate; then the profiler's table of the kernels with the most device time.
Needs a card.
"""

from __future__ import annotations

import argparse
import os
import time

import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils.flop_counter import FlopCounterMode

from mvp_benchmark_tpu_torch.data.mvp import BatchSpec, MVPCompletionDataset
from mvp_benchmark_tpu_torch.train import engine
from mvp_benchmark_tpu_torch.train.config import load_config
from mvp_benchmark_tpu_torch.train.meters import AverageValueMeter

# Substrings of the port's kernel names (ops/csrc/*.cu).
PORT_KERNELS = ("chamfer_rowmin_kernel", "knn_kernel", "fps_kernel",
                "gather_rows_kernel", "group_max_kernel",
                "three_interpolate_kernel", "sa_attention_kernel")
GEMM_MARKS = ("gemm", "xmma", "cutlass", "sm90_", "sm80_")


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def group_of(name: str) -> str:
    for k in PORT_KERNELS:
        if k in name:
            return k
    if any(m in name.lower() for m in GEMM_MARKS):
        return "GEMM (cuBLAS)"
    return "other PyTorch kernels"


def profile_val(cfg_path: str, data_dir: str, passes: int = 5,
                warmup: int = 3, top: int = 25) -> str:
    cfg = load_config(cfg_path)
    device = engine.resolve_device("cuda")
    n = int(cfg.num_points)
    step = engine.make_eval_step(engine.build_model(cfg, device), device)
    spec = BatchSpec(int(cfg.batch_size))
    ds = MVPCompletionDataset("val", data_dir, n)
    meters = {m: AverageValueMeter() for m in engine.completion_metrics(cfg)}
    with FlopCounterMode(display=False) as flops:
        step(next(iter(ds.batches(spec))), prefix="val")
    for _ in range(warmup):
        engine.val_completion(step, ds, spec, meters)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(passes):
            engine.val_completion(step, ds, spec, meters)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    batches = passes * ds.steps_per_epoch(spec)
    groups: dict = {}
    for evt in prof.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            g = group_of(evt.key)
            groups[g] = groups.get(g, 0.0) + _device_us(evt) / 1e3
    device_ms = sum(groups.values())
    lines = [f"{cfg.model_name}: {batches} val batches (batch {spec.batch_size}, "
             f"{n} points) on {torch.cuda.get_device_name(0)}",
             f"per batch: device {device_ms / batches!r} ms, wall under the "
             f"profiler {wall_ms / batches!r} ms, device busy "
             f"{device_ms / wall_ms!r}"]
    gemm_ms = groups.get("GEMM (cuBLAS)", 0.0) / batches
    gflop = flops.get_total_flops() / 1e9
    lines.append(f"matrix products: {gflop!r} GFLOP per batch (FlopCounterMode), "
                 f"{gflop / max(gemm_ms, 1e-9)!r} TFLOP/s in the GEMM kernels")
    for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        lines.append(f"  {g}: {ms / batches!r} ms per batch "
                     f"({ms / device_ms!r} of device time)")
    sort = ("self_device_time_total"
            if hasattr(prof.key_averages()[0], "self_device_time_total")
            else "self_cuda_time_total")
    lines.append(prof.key_averages().table(sort_by=sort, row_limit=top))
    return "\n".join(lines)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("-c", "--config", required=True)
    parser.add_argument("--data-dir", default=os.path.join("completion", "data"))
    parser.add_argument("--passes", type=int, default=5)
    arg = parser.parse_args(argv)
    print(profile_val(arg.config, arg.data_dir, arg.passes))


if __name__ == "__main__":
    main()
