"""Per-face mesh quantities (port of `gaussianmesh_tpu/utils/subdivision.py`,
the part the render path needs; subdivision itself comes with training)."""

from __future__ import annotations

import torch


def face_mean_edge_length(v1: torch.Tensor, v2: torch.Tensor,
                          v3: torch.Tensor) -> torch.Tensor:
    """The per-face `r` used by the offset law (mesh_based_gaussian_model.py:208-215)."""
    a = torch.linalg.vector_norm(v1 - v2, dim=-1)
    b = torch.linalg.vector_norm(v2 - v3, dim=-1)
    c = torch.linalg.vector_norm(v3 - v1, dim=-1)
    return ((a + b + c) / 3.0)[..., None]


def face_normals(v1: torch.Tensor, v2: torch.Tensor, v3: torch.Tensor,
                 degenerate: tuple[float, float, float] = (1.0, 0.0, 0.0)) -> torch.Tensor:
    """Unit per-face normals; degenerate faces get `degenerate` (igl convention)."""
    n = torch.linalg.cross(v2 - v1, v3 - v1, dim=-1)
    norm = torch.linalg.vector_norm(n, dim=-1, keepdim=True)
    fallback = torch.tensor(degenerate, dtype=n.dtype, device=n.device)
    return torch.where(norm > 1e-12, n / torch.clamp(norm, min=1e-12), fallback)
