"""Train and eval engine (port of ``mvp_benchmark_tpu/train/engine.py``): the
completion track and the registration track.

PyTorch runs eagerly, so a step is the model called on an explicit device;
there is nothing to jit. The eval step runs under ``torch.inference_mode()``.
The val pass reproduces ``val_completion`` (``engine.py:406-430`` of the JAX
package): per-batch metrics averaged over the real ``count`` of each padded
batch, pulled to the host once at the end of the pass.

The train loop reproduces ``train_completion`` (``engine.py:280-403``) on one
device: a shuffled ``BatchSpec`` seeded from ``manual_seed``, the epoch's
alpha and learning rate, a train step of forward in ``train()`` mode,
``total.mean()`` backward and an optimizer step, losses kept on the device
and pulled once per flush (every ``min(step_interval_to_print, 20)`` steps)
for ``NanGuard``, an epoch checkpoint, and a val pass in ``eval()`` mode that
writes ``best_<metric>_network.pkl``. A model that samples noise in train
(VRCNet) gets it from ``draw_noise`` on the CPU, per step, from a
``torch.Generator`` seeded from ``manual_seed``. Multi-process data
parallelism comes with a later slice.

The registration val pass reproduces ``val_registration``
(``engine.py:596-660``): RotE, transE, MSE (the model's fifth output,
``rt_mse``), RMSE and recall at RMSE < 0.1, averaged over the real samples,
and the same metrics split by rotation level and match level. Registration
training reproduces ``train_registration`` (``engine.py:460-595``): a train
step of the forward with ``prefix="train"`` (batch statistics, which move
the model's running ones), ``loss.mean()`` backward and an optimizer step;
the plateau-managed learning rate set every epoch; the same flushes, epoch
checkpoint and val pass with ``best_<metric>_network.pkl`` (recall highest,
the others lowest).
"""

from __future__ import annotations

import logging
import math
import os
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from mvp_benchmark_tpu_torch.data.mvp import (BatchSpec, MVPCompletionDataset,
                                              MVPRegistrationDataset)
from mvp_benchmark_tpu_torch.models import TRAIN_PORTED_MODELS, get_model
from mvp_benchmark_tpu_torch.models.transplant import load_flax_params
from mvp_benchmark_tpu_torch.train import checkpoint as ckpt
from mvp_benchmark_tpu_torch.train.config import Config
from mvp_benchmark_tpu_torch.train.meters import AverageValueMeter
from mvp_benchmark_tpu_torch.train.optim import (PlateauScheduler, alpha_for_epoch,
                                                 build_optimizer, epoch_lr,
                                                 set_learning_rate)

logger = logging.getLogger(__name__)


def resolve_device(name: str) -> torch.device:
    """The device a run asked for. A CUDA request without a card raises; it
    never moves to the CPU on its own."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {name!r} requested, but CUDA is not available")
    return device


class NanGuard:
    """Failure detection for the train loop (``engine.py:48-72`` of the JAX
    package): logs non-finite losses and aborts after ``limit`` consecutive
    ones."""

    def __init__(self, limit: int = 5):
        self.limit = limit
        self.consecutive = 0
        self.total = 0

    def check(self, loss: float, where: str) -> None:
        if math.isfinite(loss):
            self.consecutive = 0
            return
        self.consecutive += 1
        self.total += 1
        logger.warning("non-finite loss (%s) at %s [%d consecutive]",
                       loss, where, self.consecutive)
        if self.consecutive >= self.limit:
            raise FloatingPointError(
                f"{self.consecutive} consecutive non-finite losses at {where}"
                " -- check LR / input normalization (EMD expects coords in"
                " [0,1]) / distribution-loss stability.")


def build_model(cfg: Config, device: torch.device, seed: int = 0,
                for_training: bool = False) -> torch.nn.Module:
    """The config's model with weights drawn from a torch.Generator seeded
    with ``seed`` (on the CPU, so every device gets the same weights), or
    transplanted from the checkpoint named by ``cfg.load_model`` (one the
    JAX package or the port wrote; ``for_training`` needs every parameter
    there, VRCNet's prior net included); moved to ``device`` in eval mode."""
    if str(cfg.compute_dtype or "float32").lower() not in ("f32", "float32"):
        raise NotImplementedError(
            f"compute_dtype {cfg.compute_dtype!r}: the port runs fp32 so far")
    model = get_model(cfg.model_name, cfg,
                      generator=torch.Generator().manual_seed(seed))
    if for_training and cfg.model_name not in TRAIN_PORTED_MODELS:
        raise NotImplementedError(
            f"training {cfg.model_name!r} is not yet ported to "
            f"mvp_benchmark_tpu_torch (its val and test passes are; trains: "
            f"{', '.join(TRAIN_PORTED_MODELS)})")
    if cfg.load_model:
        load_flax_params(model, ckpt.load_model(cfg.load_model)["net_state_dict"],
                         for_training=for_training)
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


def _to_device(x: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host batch array on ``device``; to a card through pinned memory
    without blocking the host, so the next step is enqueued while the card
    runs this one."""
    t = torch.as_tensor(x)
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def draw_noise(model: torch.nn.Module, batch_size: int,
               generator: torch.Generator) -> Optional[Dict[str, torch.Tensor]]:
    """One train step's noise for a model that samples it (VRCNet's
    ``draw_noise``), else None."""
    draw = getattr(model, "draw_noise", None)
    return None if draw is None else draw(batch_size, generator)


def make_train_step(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                    device: torch.device) -> Callable:
    """step(batch, alpha, noise) -> {"total_loss", "fine_loss"} as device
    scalars: the forward in train mode, ``total.mean()`` backward and one
    optimizer step (``engine.py:186-240`` of the JAX package)."""

    def step(batch: Dict[str, np.ndarray], alpha: float,
             noise: Optional[Dict[str, torch.Tensor]] = None):
        x = _to_device(batch["inputs"], device)
        gt = _to_device(batch["gt"], device)
        kw = {} if noise is None else {
            "noise": {k: v.to(device, non_blocking=True) for k, v in noise.items()}}
        optimizer.zero_grad(set_to_none=True)
        _, loss2, total = model(x, gt, prefix="train", alpha=alpha, **kw)
        total = total.mean()
        total.backward()
        optimizer.step()
        return {"total_loss": total.detach(), "fine_loss": loss2.mean().detach()}

    return step


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


# metrics whose best value is the highest; the others' is the lowest
HIGHER_IS_BETTER = ("f1", "recall")


def _record_best(best: Dict[str, tuple], res: Dict[str, float], epoch: int,
                 model: torch.nn.Module, log_dir: str) -> None:
    """Keeps the best value of each metric (f1 and recall highest, the
    others lowest) and writes ``best_<metric>_network.pkl`` when it improves
    (``engine.py:431-450`` and ``:634-652`` of the JAX package)."""
    log, best_log = "", ""
    for m, value in res.items():
        improved = value > best[m][1] if m in HIGHER_IS_BETTER else value < best[m][1]
        if improved:
            best[m] = (epoch, value)
            ckpt.save_model(os.path.join(log_dir, f"best_{m}_network.pkl"), model)
            logger.info("Best %s net saved!", m)
        log += f"curr_{m}: {value:f}; "
        best_log += f"best_{m}: {best[m][1]:f} [epoch {best[m][0]}]; "
    logger.info(log)
    logger.info(best_log)


def _initial_best(metrics) -> Dict[str, tuple]:
    return {m: (0, 0.0) if m in HIGHER_IS_BETTER else (0, math.inf) for m in metrics}


def _flusher(guard: "NanGuard", where: str, on_step: Callable):
    """(pending, flush): the loop appends (step index, device outputs) to
    ``pending``; ``flush()`` pulls them to the host at once, feeds each
    total loss to the guard and calls ``on_step(j, outputs, loss, steps per
    second)``."""
    pending = []
    t_flush = time.perf_counter()

    def flush():
        nonlocal t_flush
        if not pending:
            return
        dt = time.perf_counter() - t_flush
        sps = len(pending) / dt if dt > 0 else 0.0
        for j, dev in pending:
            loss = float(dev["total_loss"])
            guard.check(loss, f"{where} step {j}")
            on_step(j, dev, loss, sps)
        pending.clear()
        t_flush = time.perf_counter()

    return pending, flush


def train_completion(cfg: Config, log_dir: str, data_dir: str = "./data",
                     max_steps_per_epoch: Optional[int] = None,
                     device: torch.device = torch.device("cuda")) -> Dict[str, Any]:
    """Completion training loop (reference completion/train.py:21-153) ->
    {"best", "history", "model", "optimizer"}."""
    metrics = completion_metrics(cfg)
    best = _initial_best(metrics)
    train_meter = AverageValueMeter()
    val_meters = {m: AverageValueMeter() for m in metrics}
    num_points = int(cfg.num_points or 2048)
    dataset = MVPCompletionDataset("train", data_dir, num_points)
    dataset_val = MVPCompletionDataset("val", data_dir, num_points)
    seed = int(cfg.manual_seed or 1)
    batch_size = int(cfg.batch_size)
    spec = BatchSpec(batch_size, shuffle=True, seed=seed)
    val_spec = BatchSpec(batch_size)

    model = build_model(cfg, device, seed=seed, for_training=True)
    optimizer = build_optimizer(cfg, model.parameters())
    train_step = make_train_step(model, optimizer, device)
    eval_step = make_eval_step(model, device)
    noise_generator = torch.Generator().manual_seed(seed)
    guard = NanGuard()
    print_every = int(cfg.step_interval_to_print or 100)
    # flush the device-side losses at least every 20 steps, so a NaN aborts
    # within ~20 optimizer updates (engine.py:326-330 of the JAX package)
    guard_every = min(print_every, 20)

    history = {"train_loss": [], "val": []}
    for epoch in range(int(cfg.start_epoch or 0), int(cfg.nepoch)):
        train_meter.reset()
        alpha = alpha_for_epoch(cfg, epoch)
        lr = epoch_lr(cfg, epoch)
        set_learning_rate(optimizer, lr)
        model.train()

        def on_step(j, dev, loss, sps):
            train_meter.update(loss)
            if j % print_every == 0:
                logger.info(
                    "train [%d: %d] loss_type: %s fine_loss: %f "
                    "total_loss: %f lr: %f alpha: %s steps/s: %.2f",
                    epoch, j, cfg.loss, float(dev["fine_loss"]), loss,
                    lr, alpha, sps)

        pending, flush = _flusher(guard, f"completion epoch {epoch}", on_step)
        for i, batch in enumerate(dataset.batches(spec, epoch)):
            if max_steps_per_epoch and i >= max_steps_per_epoch:
                break
            noise = draw_noise(model, batch_size, noise_generator)
            pending.append((i, train_step(batch, 1.0 if alpha is None else alpha,
                                          noise)))
            if len(pending) >= guard_every:
                flush()
        flush()
        history["train_loss"].append(train_meter.avg)

        model.eval()
        if epoch % int(cfg.epoch_interval_to_save or 1) == 0:
            ckpt.save_model(os.path.join(log_dir, "network.pkl"), model, optimizer)
        if (epoch % int(cfg.epoch_interval_to_val or 1) == 0
                or epoch == int(cfg.nepoch) - 1):
            res = val_completion(eval_step, dataset_val, val_spec, val_meters)
            _record_best(best, res, epoch, model, log_dir)
            history["val"].append(res)
    return {"best": best, "history": history, "model": model,
            "optimizer": optimizer}


# ---------------------------------------------------------------------------
# Registration track
# ---------------------------------------------------------------------------

REG_METRICS = ["RotE", "transE", "MSE", "RMSE", "recall"]


def make_registration_eval_step(model: torch.nn.Module,
                                device: torch.device) -> Callable:
    """step(batch, prefix) for a numpy registration batch: "test" -> T_12
    (B, 4, 4); "val" -> (loss, r_err, t_err, rmse, rt_mse)."""

    def step(batch: Dict[str, np.ndarray], prefix: str = "val"):
        with torch.inference_mode():
            src = _to_device(batch["src"], device)
            tgt = _to_device(batch["tgt"], device)
            if prefix == "test":
                return model(src, tgt, None, prefix="test")
            T = _to_device(batch["transform"], device)
            return model(src, tgt, T, prefix=prefix)

    return step


def registration_split_meters(cfg: Config):
    """[rot_level][match_level] -> {metric: meter}."""
    return [[{m: AverageValueMeter() for m in REG_METRICS}
             for _ in range(int(cfg.num_corr_levels or 2))]
            for _ in range(int(cfg.num_rot_levels or 2))]


def val_registration(eval_step: Callable, dataset_val, spec: BatchSpec,
                     val_meters: Dict[str, AverageValueMeter], split_meters,
                     rmse_thresh: float = 0.1) -> Dict[str, float]:
    """One val pass; returns {metric: average over the real samples} and
    fills ``split_meters`` per (rot_level, match_level), logging both."""
    for v in val_meters.values():
        v.reset()
    for row in split_meters:
        for cell in row:
            for v in cell.values():
                v.reset()
    pending = []
    for batch in dataset_val.batches(spec):
        _, r_err, t_err, rmse, mse = eval_step(batch, prefix="val")
        pending.append(((r_err, t_err, rmse, mse),
                        (int(batch["count"]), batch["rot_level"], batch["match_level"])))
    for outs, (count, rot_level, match_level) in pending:
        r_err, t_err, rmse, mse = (o.cpu().numpy() for o in outs)
        recall = (rmse < rmse_thresh).astype(np.float32)
        vals = {"RotE": r_err, "transE": t_err, "MSE": mse, "RMSE": rmse,
                "recall": recall}
        for m, arr in vals.items():
            val_meters[m].update(float(arr[:count].mean()), count)
        for i in range(count):
            cell = split_meters[int(rot_level[i])][int(match_level[i])]
            for m, arr in vals.items():
                cell[m].update(float(arr[i]))
    logger.info("".join(f"curr_{m}: {v.avg:f}; " for m, v in val_meters.items()))
    for rl, row in enumerate(split_meters):
        for ml, cell in enumerate(row):
            logger.info("[rot_level %d, match_level %d] %s", rl, ml,
                        "; ".join(f"curr_{m}: {v.avg:f}" for m, v in cell.items()))
    return {m: meter.avg for m, meter in val_meters.items()}


def registration_dataset(cfg: Config, prefix: str, data_dir: str):
    return MVPRegistrationDataset(
        prefix, max_angle=float(cfg.max_angle or 180.0),
        max_trans=float(cfg.max_trans or 0.5), category=cfg.category,
        data_dir=data_dir, num_points=int(cfg.num_points or 2048))


def predict_registration(eval_step: Callable, dataset, spec: BatchSpec) -> np.ndarray:
    """Test-branch poses T_12 for every real sample, (len(dataset), 4, 4)."""
    outs = [(int(batch["count"]), eval_step(batch, prefix="test"))
            for batch in dataset.batches(spec)]
    return np.concatenate([T[:count].cpu().numpy() for count, T in outs], axis=0)


def run_registration_val(cfg: Config, data_dir: str,
                         device: torch.device) -> Dict[str, float]:
    """The val pass over the val split (MVP_Test_RG) at ``cfg``'s size:
    RotE, transE, MSE, RMSE, recall, and the rot/match split in the log."""
    model = build_model(cfg, device)
    meters = {m: AverageValueMeter() for m in REG_METRICS}
    return val_registration(make_registration_eval_step(model, device),
                            registration_dataset(cfg, "val", data_dir),
                            BatchSpec(int(cfg.batch_size)), meters,
                            registration_split_meters(cfg))


def make_registration_train_step(model: torch.nn.Module,
                                 optimizer: torch.optim.Optimizer,
                                 device: torch.device) -> Callable:
    """step(batch) -> {"total_loss", "r_err", "t_err", "rmse", "mse"} as
    device scalars: the forward with ``prefix="train"``, ``loss.mean()``
    backward and one optimizer step (``engine.py:186-240`` of the JAX
    package, kind "registration")."""

    def step(batch: Dict[str, np.ndarray]):
        src = _to_device(batch["src"], device)
        tgt = _to_device(batch["tgt"], device)
        T = _to_device(batch["transform"], device)
        optimizer.zero_grad(set_to_none=True)
        loss, r_err, t_err, rmse, mse = model(src, tgt, T, prefix="train")
        total = loss.mean()
        total.backward()
        optimizer.step()
        return {"total_loss": total.detach(), "r_err": r_err.mean().detach(),
                "t_err": t_err.mean().detach(), "rmse": rmse.mean().detach(),
                "mse": mse.mean().detach()}

    return step


def train_registration(cfg: Config, log_dir: str, data_dir: str = "./data",
                       max_steps_per_epoch: Optional[int] = None,
                       device: torch.device = torch.device("cuda")) -> Dict[str, Any]:
    """Registration training loop (reference registration/train.py:28-111)
    -> {"best", "history", "model", "optimizer"}; ``history`` holds each
    epoch's step losses and val metrics. The learning rate is
    ``cfg.lr``, cut on an RMSE plateau only under ``lr_plateau_step`` (the
    reference builds its scheduler but never steps it)."""
    best = _initial_best(REG_METRICS)
    val_meters = {m: AverageValueMeter() for m in REG_METRICS}
    split_meters = registration_split_meters(cfg)
    seed = int(cfg.manual_seed or 1)
    dataset = MVPRegistrationDataset(
        "train", max_angle=float(cfg.max_angle), max_trans=float(cfg.max_trans),
        category=cfg.category, data_dir=data_dir,
        num_points=int(cfg.num_points or 2048), seed=seed)
    dataset_val = registration_dataset(cfg, "val", data_dir)
    spec = BatchSpec(int(cfg.batch_size), shuffle=True, seed=seed)
    val_spec = BatchSpec(int(cfg.batch_size))

    model = build_model(cfg, device, seed=seed, for_training=True)
    optimizer = build_optimizer(cfg, model.parameters())
    train_step = make_registration_train_step(model, optimizer, device)
    eval_step = make_registration_eval_step(model, device)
    guard = NanGuard()
    lr = float(cfg.lr)
    plateau = PlateauScheduler(lr, float(cfg.lr_decay_rate or 0.5),
                               float(cfg.lr_clip or 0.0))
    print_every = int(cfg.step_interval_to_print or 100)
    guard_every = min(print_every, 20)   # see train_completion

    history = {"step_losses": [], "val": []}
    for epoch in range(int(cfg.start_epoch or 0), int(cfg.nepoch)):
        set_learning_rate(optimizer, lr)
        model.train()
        losses = []

        def on_step(j, dev, loss, sps):
            losses.append(loss)
            if j % print_every == 0:
                logger.info(
                    "train [%d: %d] total_loss: %.4f rot: %.4f trans: %.4f "
                    "rmse: %.4f mse: %.4f lr: %f steps/s: %.2f", epoch, j, loss,
                    float(dev["r_err"]), float(dev["t_err"]), float(dev["rmse"]),
                    float(dev["mse"]), lr, sps)

        pending, flush = _flusher(guard, f"registration epoch {epoch}", on_step)
        for i, batch in enumerate(dataset.batches(spec, epoch)):
            if max_steps_per_epoch and i >= max_steps_per_epoch:
                break
            pending.append((i, train_step(batch)))
            if len(pending) >= guard_every:
                flush()
        flush()
        history["step_losses"].append(losses)

        model.eval()
        if epoch % int(cfg.epoch_interval_to_save or 1) == 0:
            ckpt.save_model(os.path.join(log_dir, "network.pkl"), model, optimizer)
        if (epoch % int(cfg.epoch_interval_to_val or 1) == 0
                or epoch == int(cfg.nepoch) - 1):
            res = val_registration(eval_step, dataset_val, val_spec, val_meters,
                                   split_meters)
            _record_best(best, res, epoch, model, log_dir)
            history["val"].append(res)
            if cfg.lr_plateau_step:
                lr = plateau.step(res["RMSE"])
    return {"best": best, "history": history, "model": model,
            "optimizer": optimizer}
