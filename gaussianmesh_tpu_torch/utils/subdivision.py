"""Per-face mesh quantities, the midpoint-split tables and the batched
subdivision (port of `gaussianmesh_tpu/utils/subdivision.py`).

A split face (a, b, c) gets the midpoint children (reference
utils/general_utils.py:133-212)

    0: (a,   m_ab, m_ac)    1: (m_ab, b,   m_bc)
    2: (m_ac, m_bc, c)      3: (m_ab, m_bc, m_ac)

and, in the 1->5 variant, a fifth child equal to the parent. Three new
vertices (m_ab, m_ac, m_bc) are appended per split face, not deduplicated
across neighbours.
"""

from __future__ import annotations

import numpy as np
import torch

# child -> its three corners as fixed weights of the parent corners (a, b, c)
CHILD_W = np.array(
    [
        [[1.0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5]],    # child 0
        [[0.5, 0.5, 0], [0, 1.0, 0], [0, 0.5, 0.5]],    # child 1
        [[0.5, 0, 0.5], [0, 0.5, 0.5], [0, 0, 1.0]],    # child 2
        [[0.5, 0.5, 0], [0, 0.5, 0.5], [0.5, 0, 0.5]],  # child 3
        [[1.0, 0, 0], [0, 1.0, 0], [0, 0, 1.0]],        # child 4 (parent copy)
    ],
    dtype=np.float32,
)

# child -> vertex index code per corner: 0..2 the parent corners a, b, c;
# 3..5 the new midpoints m_ab, m_ac, m_bc
CHILD_IDX_CODE = np.array(
    [[0, 3, 4], [3, 1, 5], [4, 5, 2], [3, 5, 4], [0, 1, 2]], dtype=np.int32)


def subdivide(v1: torch.Tensor, v2: torch.Tensor, v3: torch.Tensor,
              vidx: torch.Tensor, n_children: int, v_base: int):
    """Split N faces (corners (N, 3) each, parent vertex indices vidx (N, 3))
    into `n_children` (4 or 5) midpoint children; the three new vertices of
    face i get indices v_base + 3 i + (0, 1, 2) = (m_ab, m_ac, m_bc).
    -> ((c_v1, c_v2, c_v3) (N, C, 3) child corners, c_vidx (N, C, 3) int32
    child vertex indices, new_v (N, 3, 3) the new vertices)."""
    n = v1.shape[0]
    corners = torch.stack([v1, v2, v3], 1)                       # (N, 3, 3)
    w = torch.as_tensor(CHILD_W[:n_children], dtype=corners.dtype, device=corners.device)
    child = torch.einsum("cvk,nkd->ncvd", w, corners)            # (N, C, 3, 3)
    new_v = torch.stack([(v1 + v2) * 0.5, (v1 + v3) * 0.5, (v2 + v3) * 0.5], 1)
    code = torch.as_tensor(CHILD_IDX_CODE[:n_children], device=vidx.device).long()
    code = code.expand(n, n_children, 3)
    parent = torch.gather(vidx.long()[:, None, :].expand(n, n_children, 3), 2,
                          code.clamp(max=2))
    base = v_base + 3 * torch.arange(n, device=vidx.device)
    fresh = base[:, None, None] + (code - 3).clamp(0, 2)
    c_vidx = torch.where(code < 3, parent, fresh).to(torch.int32)
    return (child[:, :, 0], child[:, :, 1], child[:, :, 2]), c_vidx, new_v


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
