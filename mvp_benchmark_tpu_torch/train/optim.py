"""Optimizers and the completion schedules (port of
``mvp_benchmark_tpu/train/optim.py``).

- Adam, AdamW when ``weight_decay`` is not 0 (decoupled, as the JAX
  package's ``optax.adamw``), and Adagrad, selected by the config
  (reference ``completion/train.py:71-77``), from ``torch.optim``: the
  optimizer is elementwise work that PyTorch's own kernels do.
- ``epoch_lr``: every ``lr_decay_interval`` epochs multiply by
  ``lr_decay_rate``, or explicit step lists, clipped at ``lr_clip``
  (reference ``completion/train.py:110-120``); ``set_learning_rate`` edits
  the optimizer's ``param_groups``.
- ``alpha_for_epoch``: the loss-weight schedule (``completion/train.py:101-108``).
- ``PlateauScheduler``: registration's reduce-on-plateau learning rate
  (``optim.py:106-127`` of the JAX package), stepped with the val RMSE only
  under ``lr_plateau_step``, as the reference never steps its scheduler.
"""

from __future__ import annotations

from typing import Iterable, Optional

import torch

from mvp_benchmark_tpu_torch.train.config import (Config, parse_float_list,
                                                  parse_int_list)


def build_optimizer(cfg: Config, params: Iterable[torch.nn.Parameter]
                    ) -> torch.optim.Optimizer:
    """The config's optimizer at ``cfg.lr``. Adam and AdamW keep optax's
    eps 1e-8; Adagrad takes ``initial_accum_val`` (default 0.1) and torch's
    eps, 1e-10 added to the root (optax adds 1e-7 under it)."""
    name = (cfg.optimizer or "Adam").lower()
    lr = float(cfg.lr)
    if name == "adam":
        betas = tuple(parse_float_list(cfg.betas or "0.9, 0.999"))
        wd = float(cfg.weight_decay or 0.0)
        if wd:
            return torch.optim.AdamW(params, lr=lr, betas=betas, eps=1e-8,
                                     weight_decay=wd)
        return torch.optim.Adam(params, lr=lr, betas=betas, eps=1e-8)
    if name == "adagrad":
        return torch.optim.Adagrad(
            params, lr=lr,
            initial_accumulator_value=float(cfg.initial_accum_val or 0.1))
    raise ValueError(f"unsupported optimizer {cfg.optimizer!r}")


def epoch_lr(cfg: Config, epoch: int) -> float:
    """Reference completion LR schedule (train.py:110-120), pure function."""
    lr = float(cfg.lr)
    if not cfg.lr_decay:
        return lr
    if cfg.lr_decay_interval and cfg.lr_step_decay_epochs:
        raise ValueError(
            "lr_decay_interval and lr_step_decay_epochs are mutually exclusive!")
    if cfg.lr_decay_interval:
        steps = epoch // int(cfg.lr_decay_interval)
        lr = lr * float(cfg.lr_decay_rate) ** steps
    elif cfg.lr_step_decay_epochs:
        decay_epochs = parse_int_list(cfg.lr_step_decay_epochs)
        decay_rates = parse_float_list(cfg.lr_step_decay_rates)
        for e, r in zip(decay_epochs, decay_rates):
            if epoch >= e:
                lr = lr * r
    if cfg.lr_clip:
        lr = max(lr, float(cfg.lr_clip))
    return lr


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr


def alpha_for_epoch(cfg: Config, epoch: int) -> Optional[float]:
    """Loss-weight alpha schedule (``completion/train.py:101-108``)."""
    if not cfg.varying_constant:
        return None
    epochs = parse_int_list(cfg.varying_constant_epochs)
    consts = parse_float_list(cfg.varying_constant)
    if len(consts) != len(epochs) + 1:
        raise ValueError(f"varying_constant has {len(consts)} values for "
                         f"{len(epochs)} epochs; needs one more")
    for ind, ep in enumerate(epochs):
        if epoch < ep:
            return consts[ind]
    return consts[-1]


class PlateauScheduler:
    """torch's ReduceLROnPlateau (mode min, patience 10) on a plain learning
    rate, as the JAX package's: ``step(metric)`` returns the rate, cut by
    ``factor`` (not below ``min_lr``) after more than ``patience`` epochs
    without a new best."""

    def __init__(self, lr: float, factor: float, min_lr: float,
                 patience: int = 10):
        self.lr = lr
        self.factor = factor
        self.min_lr = min_lr
        self.patience = patience
        self.best = float("inf")
        self.bad_epochs = 0

    def step(self, metric: float) -> float:
        if metric < self.best:
            self.best = metric
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
            if self.bad_epochs > self.patience:
                self.lr = max(self.lr * self.factor, self.min_lr)
                self.bad_epochs = 0
        return self.lr
