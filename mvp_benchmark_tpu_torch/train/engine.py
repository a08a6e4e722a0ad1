"""Eval engine for the completion track (port of the eval subset of
``mvp_benchmark_tpu/train/engine.py``).

PyTorch runs eagerly, so the eval step is the model called under
``torch.inference_mode()`` on an explicit device; there is nothing to jit.
The val pass reproduces ``val_completion`` (``engine.py:406-430`` of the JAX
package): per-batch metrics averaged over the real ``count`` of each padded
batch, pulled to the host once at the end of the pass. Saving the best
checkpoint waits for the training loop.
"""

from __future__ import annotations

import logging
from typing import Callable, Dict, Optional

import numpy as np
import torch

from mvp_benchmark_tpu_torch.data.mvp import BatchSpec, MVPCompletionDataset
from mvp_benchmark_tpu_torch.models import get_model
from mvp_benchmark_tpu_torch.models.transplant import load_flax_params
from mvp_benchmark_tpu_torch.train import checkpoint as ckpt
from mvp_benchmark_tpu_torch.train.config import Config
from mvp_benchmark_tpu_torch.train.meters import AverageValueMeter

logger = logging.getLogger(__name__)


def resolve_device(name: str) -> torch.device:
    """The device a run asked for. A CUDA request without a card raises; it
    never moves to the CPU on its own."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {name!r} requested, but CUDA is not available")
    return device


def build_model(cfg: Config, device: torch.device, seed: int = 0) -> torch.nn.Module:
    """The config's model with weights drawn from a torch.Generator seeded
    with ``seed`` (on the CPU, so every device gets the same weights), or
    transplanted from the JAX checkpoint named by ``cfg.load_model``; moved
    to ``device`` in eval mode."""
    if str(cfg.compute_dtype or "float32").lower() not in ("f32", "float32"):
        raise NotImplementedError(
            f"compute_dtype {cfg.compute_dtype!r}: the port runs fp32 so far")
    model = get_model(cfg.model_name, cfg,
                      generator=torch.Generator().manual_seed(seed))
    if cfg.load_model:
        load_flax_params(model, ckpt.load_model(cfg.load_model)["net_state_dict"])
        logger.info("%s's previous weights loaded.", cfg.model_name)
    return model.to(device).eval()


def latent_noise(model: torch.nn.Module, batch_size: int) -> Optional[torch.Tensor]:
    """The standard-normal latent noise of one eval batch for a model that
    samples one (VRCNet: ``size_z``), else None. Drawn on the CPU from a
    torch.Generator seeded 0 at every batch, as the JAX eval step seeds its
    ``sample`` RNG with PRNGKey(0) at every batch (``engine.py:249-252`` of
    the JAX package): a card run and a CPU run see the same numbers (not
    JAX's: the two generators differ)."""
    size = getattr(model, "size_z", None)
    if size is None:
        return None
    return torch.randn((batch_size, size), generator=torch.Generator().manual_seed(0))


def make_eval_step(model: torch.nn.Module, device: torch.device) -> Callable:
    """step(batch, prefix) -> the model's output dict for a numpy batch."""

    def step(batch: Dict[str, np.ndarray], prefix: str = "val"):
        with torch.inference_mode():
            x = torch.as_tensor(batch["inputs"]).to(device)
            eps = latent_noise(model, x.shape[0])
            kw = {} if eps is None else {"eps": eps.to(device)}
            if prefix == "test":
                return model(x, None, prefix="test", **kw)
            gt = torch.as_tensor(batch["gt"]).to(device)
            return model(x, gt, prefix=prefix, **kw)

    return step


def val_completion(eval_step: Callable, dataset_val, spec: BatchSpec,
                   val_meters: Dict[str, AverageValueMeter]) -> Dict[str, float]:
    """One val pass; returns {metric: average over the real samples}."""
    for v in val_meters.values():
        v.reset()
    pending = []
    for batch in dataset_val.batches(spec):
        result = eval_step(batch, prefix="val")
        pending.append((int(batch["count"]), {m: result[m] for m in val_meters}))
    for count, result in pending:
        for name, meter in val_meters.items():
            vals = result[name].cpu().numpy()
            meter.update(float(vals[:count].mean()), count)
    return {m: meter.avg for m, meter in val_meters.items()}


def predict_completion(eval_step: Callable, dataset, spec: BatchSpec) -> np.ndarray:
    """Test-branch predictions for every real sample, (len(dataset), N, 3)."""
    outs = []
    for batch in dataset.batches(spec):
        res = eval_step(batch, prefix="test")
        outs.append((int(batch["count"]), res["result"]))
    return np.concatenate([r[:count].cpu().numpy() for count, r in outs], axis=0)


def completion_metrics(cfg: Config):
    return ["cd_p", "cd_t", "emd", "f1"] if cfg.eval_emd else ["cd_p", "cd_t", "f1"]


def run_completion_val(cfg: Config, data_dir: str,
                       device: torch.device) -> Dict[str, float]:
    """The val pass over the val split (MVP_Test_CP) at ``cfg``'s size."""
    dataset = MVPCompletionDataset("val", data_dir, int(cfg.num_points or 2048))
    model = build_model(cfg, device)
    meters = {m: AverageValueMeter() for m in completion_metrics(cfg)}
    res = val_completion(make_eval_step(model, device), dataset,
                         BatchSpec(int(cfg.batch_size)), meters)
    logger.info("".join(f"curr_{m}: {v:f}; " for m, v in res.items()))
    return res
