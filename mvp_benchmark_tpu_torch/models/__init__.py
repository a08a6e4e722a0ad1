"""Model registry (port of ``mvp_benchmark_tpu.models``): every model module
exposes ``Model`` and ``build(args, generator)``."""

from __future__ import annotations

import importlib
from typing import Optional

import torch

COMPLETION_MODELS = ("pcn", "ecg", "vrcnet")
REGISTRATION_MODELS = ("dcp", "deepgmr", "idam")
PORTED_MODELS = ("pcn", "ecg", "vrcnet", "dcp", "idam")
# the ported models whose train branch is ported too
TRAIN_PORTED_MODELS = ("pcn", "ecg", "vrcnet", "dcp", "idam")


def get_model_module(name: str):
    if name not in COMPLETION_MODELS + REGISTRATION_MODELS:
        raise ValueError(f"unknown model {name!r}")
    if name not in PORTED_MODELS:
        raise NotImplementedError(
            f"model {name!r} is not yet ported to mvp_benchmark_tpu_torch "
            f"(ported: {', '.join(PORTED_MODELS)})")
    return importlib.import_module(f"mvp_benchmark_tpu_torch.models.{name}")


def get_model(name: str, args=None,
              generator: Optional[torch.Generator] = None) -> torch.nn.Module:
    """Build a model on the CPU from a config, its weights drawn from
    ``generator``; the caller moves it to its device."""
    return get_model_module(name).build(args, generator=generator)
