"""Registration metrics and SE(3) helpers (port of
``mvp_benchmark_tpu/metrics/registration.py``).

Numerics follow the reference ``registration/train_utils.py:36-100``:
- rotation_error: trace -> clamped acos, DEGREES;
- translation_error: L2 norm;
- rmse_loss: mean point distance between the two transformed clouds;
- rotation_geodesic_error: clamped acos, RADIANS.

The 3x3 and 4x4 pose products are plain fp32 matmuls: TF32 is off for the
whole package (``mvp_benchmark_tpu_torch/__init__.py``), which is what the JAX
package's ``precision=HIGHEST`` asks of its backend.
"""

from __future__ import annotations

import math

import torch


def quat2mat(quat: torch.Tensor) -> torch.Tensor:
    """Quaternion (x, y, z, w) batch -> rotation matrices (B, 3, 3)."""
    x, y, z, w = quat[:, 0], quat[:, 1], quat[:, 2], quat[:, 3]
    w2, x2, y2, z2 = w * w, x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    rot = torch.stack(
        [
            w2 + x2 - y2 - z2, 2 * xy - 2 * wz, 2 * wy + 2 * xz,
            2 * wz + 2 * xy, w2 - x2 + y2 - z2, 2 * yz - 2 * wx,
            2 * xz - 2 * wy, 2 * wx + 2 * yz, w2 - x2 - y2 + z2,
        ],
        dim=1,
    ).reshape(-1, 3, 3)
    return rot


def transform_point_cloud(point_cloud: torch.Tensor, rotation: torch.Tensor,
                          translation: torch.Tensor) -> torch.Tensor:
    """Apply (R|t) to channels-first clouds (B, 3, N), like the reference."""
    rot_mat = quat2mat(rotation) if rotation.dim() == 2 else rotation
    return torch.matmul(rot_mat, point_cloud) + translation[..., None]


def rt_to_transformation(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(B, 3, 3), (B, 3, 1) -> homogeneous (B, 4, 4)."""
    B = R.shape[0]
    bot = torch.tensor([[[0.0, 0.0, 0.0, 1.0]]], dtype=R.dtype,
                       device=R.device).expand(B, 1, 4)
    return torch.cat([torch.cat([R, t], dim=2), bot], dim=1)


def rotation_error(R: torch.Tensor, R_gt: torch.Tensor) -> torch.Tensor:
    """Rotation error in degrees, per sample (B,)."""
    cos_theta = (torch.einsum("bij,bij->b", R, R_gt) - 1.0) / 2.0
    cos_theta = torch.clamp(cos_theta, -1.0, 1.0)
    return torch.arccos(cos_theta) * 180.0 / math.pi


def translation_error(t: torch.Tensor, t_gt: torch.Tensor) -> torch.Tensor:
    """Translation L2 error, per sample (B,)."""
    return torch.linalg.norm(t - t_gt, dim=1)


def rmse_loss(pts: torch.Tensor, T: torch.Tensor, T_gt: torch.Tensor) -> torch.Tensor:
    """Mean point error between clouds transformed by T vs T_gt.

    pts: (B, N, 3) channels-last; T/T_gt: (B, 4, 4). Returns (B,)."""
    pts_pred = torch.matmul(pts, T[:, :3, :3].transpose(1, 2)) + T[:, :3, 3][:, None, :]
    pts_gt = torch.matmul(pts, T_gt[:, :3, :3].transpose(1, 2)) + T_gt[:, :3, 3][:, None, :]
    return torch.linalg.norm(pts_pred - pts_gt, dim=2).mean(dim=1)


def rotation_geodesic_error(m1: torch.Tensor, m2: torch.Tensor) -> torch.Tensor:
    """Geodesic rotation distance in radians, per sample (B,)."""
    m = torch.matmul(m1, m2.transpose(1, 2))
    cos = (m[:, 0, 0] + m[:, 1, 1] + m[:, 2, 2] - 1.0) / 2.0
    cos = torch.clamp(cos, -1.0, 1.0)
    return torch.arccos(cos)
