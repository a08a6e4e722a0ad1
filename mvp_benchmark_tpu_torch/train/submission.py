"""Codalab-style submission writers (port of
``mvp_benchmark_tpu/train/submission.py``): results.h5 with a ``results`` key
+ a ``submission.zip`` containing it, for the completion track's predicted
clouds and the registration track's poses."""

from __future__ import annotations

import os
import zipfile

import numpy as np
import torch

from mvp_benchmark_tpu_torch.data.mvp import BatchSpec, MVPCompletionDataset
from mvp_benchmark_tpu_torch.train import engine


def write_submission(log_dir: str, results: np.ndarray) -> str:
    """Write results.h5 (+ submission.zip) into log_dir; returns zip path."""
    import h5py

    h5_path = os.path.join(log_dir, "results.h5")
    with h5py.File(h5_path, "w") as f:
        f.create_dataset("results", data=results)
    zip_path = os.path.join(log_dir, "submission.zip")
    with zipfile.ZipFile(zip_path, "w") as z:
        z.write(h5_path, arcname="results.h5")
    return zip_path


def predict_completion_test(cfg, data_dir: str,
                            device: torch.device) -> np.ndarray:
    """Predictions over the extra-test split (reference completion/test.py:23-53)."""
    dataset = MVPCompletionDataset("test", data_dir, int(cfg.num_points))
    model = engine.build_model(cfg, device)
    return engine.predict_completion(engine.make_eval_step(model, device),
                                     dataset, BatchSpec(int(cfg.batch_size)))


def run_completion_test(cfg, log_dir: str, data_dir: str,
                        device: torch.device):
    """Inference over the extra-test split + submission files (reference
    completion/test.py:23-64). Returns (zip path, results)."""
    results = predict_completion_test(cfg, data_dir, device)
    return write_submission(log_dir, results), results


def predict_registration_test(cfg, data_dir: str,
                              device: torch.device) -> np.ndarray:
    """Poses T_12 (n, 4, 4) over the extra-test split (reference
    registration/test.py:27-54)."""
    model = engine.build_model(cfg, device)
    return engine.predict_registration(
        engine.make_registration_eval_step(model, device),
        engine.registration_dataset(cfg, "test", data_dir),
        BatchSpec(int(cfg.batch_size)))


def run_registration_test(cfg, log_dir: str, data_dir: str,
                          device: torch.device):
    """Pose prediction over the extra-test split + submission files
    (reference registration/test.py:27-66). Returns (zip path, results)."""
    results = predict_registration_test(cfg, data_dir, device)
    return write_submission(log_dir, results), results
