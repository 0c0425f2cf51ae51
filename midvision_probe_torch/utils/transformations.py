"""SE(3) utilities (counterpart of the JAX package's
``utils/transformations.py``)."""

from __future__ import annotations

import torch


def transform_points_Rt(points: torch.Tensor, viewpoint: torch.Tensor,
                        inverse: bool = False) -> torch.Tensor:
    """Apply (or invert) a (..., 3, 4|4, 4) rigid transform to (..., n, 3)
    points."""
    R = viewpoint[..., :3, :3]
    t = viewpoint[..., None, :3, 3]
    if inverse:
        return (points - t) @ R
    return points @ R.transpose(-2, -1) + t


def so3_rotation_angle(R: torch.Tensor, eps: float = 1e-4) -> torch.Tensor:
    """Rotation angle (radians) of a batch of 3x3 matrices."""
    rot_trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    phi_cos = (rot_trace - 1.0) * 0.5
    return torch.arccos(phi_cos.clamp(-1.0, 1.0))


def so3_relative_angle(R1: torch.Tensor, R2: torch.Tensor,
                       eps: float = 1e-4) -> torch.Tensor:
    """Angle of the relative rotation ``R1 R2^T``."""
    return so3_rotation_angle(torch.einsum("...ij,...kj->...ik", R1, R2), eps=eps)
