"""Host-side (numpy) SE(3) augmentation for registration (a copy of
``mvp_benchmark_tpu/data/augment.py``, which the port cannot import: that
package's ``__init__`` imports jax).

Mirrors the reference's per-item augmentation
(``registration/dataset.py:9-35,102-107``): axis-angle rotation with uniform
angle in [0, max_angle], unit random translation direction scaled by
U[0, max_dist], and the two-pose composition (pose1 to src, transform @
pose1 to tgt). The same ``np.random.Generator`` draws give the same poses as
the JAX package, bit for bit.
"""

from __future__ import annotations

import numpy as np


def jitter_pcd(pcd: np.ndarray, rng: np.random.Generator,
               sigma: float = 0.01, clip: float = 0.05) -> np.ndarray:
    return pcd + np.clip(sigma * rng.standard_normal(pcd.shape), -clip, clip)


def random_rotation(max_angle: float, rng: np.random.Generator) -> np.ndarray:
    axis = rng.standard_normal(3)
    axis /= np.linalg.norm(axis)
    angle = rng.random() * max_angle
    A = np.array(
        [
            [0, -axis[2], axis[1]],
            [axis[2], 0, -axis[0]],
            [-axis[1], axis[0], 0],
        ]
    )
    return np.eye(3) + np.sin(angle) * A + (1 - np.cos(angle)) * (A @ A)


def random_translation(max_dist: float, rng: np.random.Generator) -> np.ndarray:
    t = rng.standard_normal(3)
    t /= np.linalg.norm(t)
    t *= rng.random() * max_dist
    return t[:, None]


def random_pose(max_angle: float, max_trans: float,
                rng: np.random.Generator) -> np.ndarray:
    R = random_rotation(max_angle, rng)
    t = random_translation(max_trans, rng)
    return np.concatenate([np.concatenate([R, t], 1), [[0, 0, 0, 1]]], 0)


def augment_pair(src: np.ndarray, tgt: np.ndarray, max_angle: float,
                 max_trans: float, rng: np.random.Generator):
    """Apply the reference's training-time pose augmentation to one pair.

    Returns (src', tgt', transform) with transform the gt src'->tgt' pose.
    """
    transform = random_pose(max_angle, max_trans / 2, rng)
    pose1 = random_pose(np.pi, max_trans, rng)
    pose2 = transform @ pose1
    src = src @ pose1[:3, :3].T + pose1[:3, 3]
    tgt = tgt @ pose2[:3, :3].T + pose2[:3, 3]
    return (
        src.astype(np.float32),
        tgt.astype(np.float32),
        transform.astype(np.float32),
    )
