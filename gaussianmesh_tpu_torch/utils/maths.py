"""Core Gaussian math (port of `gaussianmesh_tpu/utils/maths.py`, render path only).

Quaternion (w, x, y, z) -> rotation matrix, L = R @ diag(s), world
covariance Sigma = L @ L^T stored as the 6 upper coefficients
(xx, xy, xz, yy, yz, zz). Batched over leading axes.
"""

from __future__ import annotations

import torch


def inverse_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.log(x / (1.0 - x))


def normalize(v: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """L2-normalize along `dim`; the eps guard keeps all-zero rows finite."""
    n = torch.sqrt(torch.sum(v * v, dim=dim, keepdim=True) + eps * eps)
    return v / n


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) quaternions (w, x, y, z) -> (..., 3, 3) rotations. Does NOT
    normalize (the model layer does, before the rasterizer sees them)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r00 = 1.0 - 2.0 * (y * y + z * z)
    r01 = 2.0 * (x * y - w * z)
    r02 = 2.0 * (x * z + w * y)
    r10 = 2.0 * (x * y + w * z)
    r11 = 1.0 - 2.0 * (x * x + z * z)
    r12 = 2.0 * (y * z - w * x)
    r20 = 2.0 * (x * z - w * y)
    r21 = 2.0 * (y * z + w * x)
    r22 = 1.0 - 2.0 * (x * x + y * y)
    return torch.stack([
        torch.stack([r00, r01, r02], dim=-1),
        torch.stack([r10, r11, r12], dim=-1),
        torch.stack([r20, r21, r22], dim=-1),
    ], dim=-2)


def build_scaling_rotation(s: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """L = R @ diag(s), (..., 3, 3)."""
    return quat_to_rotmat(q) * s[..., None, :]


def build_covariance(scaling: torch.Tensor, rotation_q: torch.Tensor,
                     scaling_modifier: float = 1.0) -> torch.Tensor:
    """World covariance Sigma = L L^T as full (..., 3, 3) matrices.

    Written as an explicit sum over the inner axis (not a batched matmul)
    so it runs in f32 on every device with no TF32 path to guard."""
    L = build_scaling_rotation(scaling_modifier * scaling, rotation_q)
    return (L[..., :, None, :] * L[..., None, :, :]).sum(-1)


def strip_symmetric(sym: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) symmetric -> (..., 6) uppers (xx, xy, xz, yy, yz, zz)."""
    return torch.stack([sym[..., 0, 0], sym[..., 0, 1], sym[..., 0, 2],
                        sym[..., 1, 1], sym[..., 1, 2], sym[..., 2, 2]], dim=-1)


def covariance_6(scaling: torch.Tensor, rotation_q: torch.Tensor,
                 scaling_modifier: float = 1.0) -> torch.Tensor:
    """Sigma as (..., 6) uppers — the form the rasterizer consumes."""
    return strip_symmetric(build_covariance(scaling, rotation_q, scaling_modifier))
