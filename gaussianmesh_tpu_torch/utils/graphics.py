"""Camera matrices and projection helpers (port of `gaussianmesh_tpu/utils/graphics.py`).

Conventions are the JAX package's:

- `world_to_view(R, t)` builds V with x_view = V[:3,:3] @ x_world + V[:3,3],
  where R is the cam-to-world rotation and t the world-to-cam translation
  (COLMAP/3DGS convention).
- `projection_matrix` matches the reference getProjectionMatrix: after
  P @ x_view, w' = z_view, and ndc = clip / (w + 1e-7).
- `ndc_to_pix(v, S) = ((v + 1) * S - 1) / 2` (pixel-center convention).

Matrices are in natural math orientation (apply as M @ x). The numpy
helpers build host-side camera matrices; `CameraArrays` carries them to the
device as tensors.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch


class CameraArrays(NamedTuple):
    """Device-side camera parameters (tensors; H/W travel in the config)."""
    viewmatrix: torch.Tensor   # (4, 4) world -> view
    projmatrix: torch.Tensor   # (4, 4) full projection = P @ V
    campos: torch.Tensor       # (3,)
    tanfovx: torch.Tensor      # ()
    tanfovy: torch.Tensor      # ()

    @classmethod
    def from_numpy(cls, viewmatrix, projmatrix, campos, tanfovx, tanfovy,
                   device: str | torch.device) -> "CameraArrays":
        def t(x):
            return torch.tensor(np.asarray(x, np.float32), device=device)
        return cls(t(viewmatrix), t(projmatrix), t(campos), t(tanfovx),
                   t(tanfovy))


def world_to_view(R: np.ndarray, t: np.ndarray,
                  translate: np.ndarray | None = None,
                  scale: float = 1.0) -> np.ndarray:
    """4x4 world->view matrix; optional scene recentering like getWorld2View2."""
    Rt = np.zeros((4, 4), dtype=np.float64)
    Rt[:3, :3] = R.T
    Rt[:3, 3] = t
    Rt[3, 3] = 1.0
    if (translate is not None and np.any(translate)) or scale != 1.0:
        translate = np.zeros(3) if translate is None else translate
        C2W = np.linalg.inv(Rt)
        C2W[:3, 3] = (C2W[:3, 3] + translate) * scale
        Rt = np.linalg.inv(C2W)
    return Rt.astype(np.float32)


def projection_matrix(znear: float, zfar: float, fovx: float, fovy: float) -> np.ndarray:
    tan_half_fovy = math.tan(fovy / 2)
    tan_half_fovx = math.tan(fovx / 2)
    top = tan_half_fovy * znear
    right = tan_half_fovx * znear
    P = np.zeros((4, 4), dtype=np.float32)
    P[0, 0] = znear / right
    P[1, 1] = znear / top
    P[3, 2] = 1.0
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    return P


def fov2focal(fov: float, pixels: float) -> float:
    return pixels / (2 * math.tan(fov / 2))


def focal2fov(focal: float, pixels: float) -> float:
    return 2 * math.atan(pixels / (2 * focal))


def ndc_to_pix(v: torch.Tensor, size: int) -> torch.Tensor:
    """auxiliary.h:40-43 — pixel-center convention of the reference."""
    return ((v + 1.0) * size - 1.0) * 0.5


def transform_points_h(points: torch.Tensor, M: torch.Tensor) -> torch.Tensor:
    """(N, 3) points through M: a 3x4 [R | t] -> (N, 3) R p + t; a 4x4 ->
    the homogeneous (N, 4) M [p, 1]."""
    if M.shape[0] == 3:
        return points @ M[:3, :3].T + M[:3, 3]
    return torch.cat([points, torch.ones_like(points[..., :1])], -1) @ M.T


def camera_center_from_w2v(V: np.ndarray) -> np.ndarray:
    """Camera position in world space from the 4x4 world->view matrix."""
    return np.linalg.inv(V)[:3, 3].astype(np.float32)
