"""Where the time of an eval pass, or of a train step, goes on the card:
``torch.profiler`` over a few val passes, or train steps, of a completion
or registration config, after warm-up.

    python -m mvp_benchmark_tpu_torch.profile_eval -c completion/cfgs/ecg.yaml
    python -m mvp_benchmark_tpu_torch.profile_eval -c registration/cfgs/dcp.yaml
    python -m mvp_benchmark_tpu_torch.profile_eval -c registration/cfgs/idam.yaml
    python -m mvp_benchmark_tpu_torch.profile_eval -c completion/cfgs/vrcnet.yaml
    python -m mvp_benchmark_tpu_torch.profile_eval -c completion/cfgs/vrcnet.yaml --train
    python -m mvp_benchmark_tpu_torch.profile_eval -c completion/cfgs/ecg.yaml --train
    python -m mvp_benchmark_tpu_torch.profile_eval -c registration/cfgs/dcp.yaml --train
    python -m mvp_benchmark_tpu_torch.profile_eval -c registration/cfgs/idam.yaml --train

Prints, per val batch (per train step with ``--train``: forward, backward
and the optimizer, as ``engine.make_train_step`` and
``make_registration_train_step`` run them): the device time
by kernel group (the port's CUDA kernels by name, cuBLAS GEMMs, the rest of
PyTorch's kernels), the wall time under the profiler and the share of it
the device is busy, the matrix products' FLOPs (counted by
``FlopCounterMode`` on one batch or step) and their rate; then the
profiler's table of the kernels with the most device time. Needs a card.
"""

from __future__ import annotations

import argparse
import os
import time

import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils.flop_counter import FlopCounterMode

from mvp_benchmark_tpu_torch.data.mvp import BatchSpec, MVPCompletionDataset
from mvp_benchmark_tpu_torch.models import REGISTRATION_MODELS
from mvp_benchmark_tpu_torch.train import engine
from mvp_benchmark_tpu_torch.train.config import load_config
from mvp_benchmark_tpu_torch.train.meters import AverageValueMeter
from mvp_benchmark_tpu_torch.train.optim import build_optimizer

# Substrings of the port's kernel names (ops/csrc/*.cu).
PORT_KERNELS = ("chamfer_fused_kernel", "chamfer_columns_kernel", "knn_queue_kernel",
                "knn_direct_kernel", "fps_kernel",
                "gather_rows_kernel", "group_max_forward_kernel",
                "three_interpolate_kernel", "sa_attention_kernel",
                "chamfer_backward_kernel", "scatter_add_rows_local_kernel",
                "scatter_add_rows_packed_kernel",
                "scatter_add_rows_kernel",
                "group_max_backward_kernel",
                "three_interpolate_backward_kernel",
                "three_interpolate_backward_local_kernel", "three_interpolate_dweight_kernel",
                "sa_backward_points_kernel", "sa_backward_sum_kernel",
                "sa_backward_rows_kernel", "reverse_list_kernel",
                "ball_query_kernel", "emd_kernel",
                "attention_bf16_backward_kernel", "attention_bf16_stats_kernel",
                "attention_f32_ds_kernel", "attention_f32_grad_kernel",
                "attention_bf16_kernel", "attention_f32_partials_kernel",
                "attention_f32_combine_kernel",
                "edge_mlp_backward_kernel", "edge_mlp_kernel",
                "gnn_propagate_kernel", "gnn_propagate_stat_kernel",
                "gnn_propagate_backward_kernel", "gnn_propagate_gather_kernel",
                "sim_mlp_kernel<2>", "sim_mlp_kernel<3>",
                "sim_mlp_kernel", "sim_mlp_backward_kernel<1>",
                "sim_mlp_backward_kernel<2>", "sim_mlp_backward_kernel<3>")
GEMM_MARKS = ("gemm", "xmma", "cutlass", "nvjet", "sm90_", "sm80_")


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
    if cfg.model_name in REGISTRATION_MODELS:
        return profile_registration_val(cfg, data_dir, device, passes, warmup, top)
    step = engine.make_eval_step(engine.build_model(cfg, device), device)
    spec = BatchSpec(int(cfg.batch_size))
    ds = MVPCompletionDataset("val", data_dir, int(cfg.num_points))
    meters = {m: AverageValueMeter() for m in engine.completion_metrics(cfg)}
    return _profile(cfg, lambda: step(next(iter(ds.batches(spec))), prefix="val"),
                    lambda: engine.val_completion(step, ds, spec, meters),
                    ds.steps_per_epoch(spec), "val batches", passes, warmup, top)


def profile_registration_val(cfg, data_dir: str, device: torch.device,
                             passes: int, warmup: int, top: int) -> str:
    step = engine.make_registration_eval_step(engine.build_model(cfg, device), device)
    spec = BatchSpec(int(cfg.batch_size))
    ds = engine.registration_dataset(cfg, "val", data_dir)
    meters = {m: AverageValueMeter() for m in engine.REG_METRICS}
    split = engine.registration_split_meters(cfg)
    return _profile(cfg, lambda: step(next(iter(ds.batches(spec))), prefix="val"),
                    lambda: engine.val_registration(step, ds, spec, meters, split),
                    ds.steps_per_epoch(spec), "val batches", passes, warmup, top)


def profile_train(cfg_path: str, data_dir: str, steps: int = 5,
                  warmup: int = 3, top: int = 25) -> str:
    cfg = load_config(cfg_path)
    device = engine.resolve_device("cuda")
    model = engine.build_model(cfg, device, seed=1, for_training=True)
    optimizer = build_optimizer(cfg, model.parameters())
    bs = int(cfg.batch_size)
    if cfg.model_name in REGISTRATION_MODELS:
        reg_step = engine.make_registration_train_step(model.train(), optimizer, device)
        reg_batch = next(engine.registration_dataset(cfg, "train", data_dir).batches(
            BatchSpec(bs, shuffle=True, seed=1)))
        return _profile(cfg, lambda: reg_step(reg_batch), lambda: reg_step(reg_batch),
                        1, "train steps", steps, warmup, top)
    step = engine.make_train_step(model.train(), optimizer, device)
    batch = next(MVPCompletionDataset("train", data_dir, int(cfg.num_points))
                 .batches(BatchSpec(bs, shuffle=True, seed=1)))
    gen = torch.Generator().manual_seed(1)

    def run():
        return step(batch, 0.5, engine.draw_noise(model, bs, gen))

    return _profile(cfg, run, run, 1, "train steps", steps, warmup, top)


def _profile(cfg, once, unit, batches_per_unit, what, units, warmup, top) -> str:
    """Profiles ``units`` calls of ``unit`` (``batches_per_unit`` batches
    each) after ``warmup`` calls; FLOPs counted over one call of ``once``."""
    with FlopCounterMode(display=False) as flops:
        once()
    for _ in range(warmup):
        unit()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(units):
            unit()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    batches = units * batches_per_unit
    groups: dict = {}
    for evt in prof.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            g = group_of(evt.key)
            groups[g] = groups.get(g, 0.0) + _device_us(evt) / 1e3
    device_ms = sum(groups.values())
    lines = [f"{cfg.model_name}: {batches} {what} (batch {cfg.batch_size}, "
             f"{cfg.num_points} points) on {torch.cuda.get_device_name(0)}",
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
    parser.add_argument("--data-dir", default=None,
                        help="default: the data/ folder beside the config's cfgs/")
    parser.add_argument("--passes", type=int, default=5,
                        help="val passes (train steps with --train) profiled")
    parser.add_argument("--train", action="store_true",
                        help="profile train steps instead of val passes")
    arg = parser.parse_args(argv)
    run = profile_train if arg.train else profile_val
    data_dir = arg.data_dir or os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(arg.config))), "data")
    print(run(arg.config, data_dir, arg.passes))


if __name__ == "__main__":
    main()
