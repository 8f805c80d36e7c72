"""Real spherical harmonics, degrees 0..3 (port of `gaussianmesh_tpu/utils/sh.py`).

Same basis constants and sign conventions as the reference kernel
(forward.cu:20-71); `eval_sh_color` adds the +0.5 offset and clamps at 0.
"""

from __future__ import annotations

import torch

C0 = 0.28209479177387814
C1 = 0.4886025119029199
C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
      -1.0925484305920792, 0.5462742152960396)
C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
      0.3731763325901154, -0.4570457994644658, 1.445305721320277,
      -0.5900435899266435)

MAX_COEFFS = 16  # degree 3


def num_sh_coeffs(degree: int) -> int:
    return (degree + 1) ** 2


def rgb_to_sh(rgb: torch.Tensor) -> torch.Tensor:
    """DC color <- RGB (reference utils/sh_utils.py:114)."""
    return (rgb - 0.5) / C0


def sh_to_rgb(sh: torch.Tensor) -> torch.Tensor:
    return sh * C0 + 0.5


def _sh_basis_cols(dirs: torch.Tensor, degree: int) -> list[torch.Tensor]:
    """Basis columns for unit directions (..., 3) as a list of (...,) tensors;
    b1 = (-y, +z, -x) * C1 as in forward.cu:30-59."""
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    cols = [C0 * torch.ones_like(x)]
    if degree >= 1:
        cols += [-C1 * y, C1 * z, -C1 * x]
    if degree >= 2:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        cols += [
            C2[0] * xy,
            C2[1] * yz,
            C2[2] * (2.0 * zz - xx - yy),
            C2[3] * xz,
            C2[4] * (xx - yy),
        ]
    if degree >= 3:
        xx, yy, zz = x * x, y * y, z * z
        xy = x * y
        cols += [
            C3[0] * y * (3.0 * xx - yy),
            C3[1] * xy * z,
            C3[2] * y * (4.0 * zz - xx - yy),
            C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
            C3[4] * x * (4.0 * zz - xx - yy),
            C3[5] * z * (xx - yy),
            C3[6] * x * (xx - 3.0 * yy),
        ]
    return cols


def sh_basis(dirs: torch.Tensor, degree: int) -> torch.Tensor:
    """(..., 3) unit directions -> (..., (degree+1)**2) basis values."""
    return torch.stack(_sh_basis_cols(dirs, degree), dim=-1)


def eval_sh(sh: torch.Tensor, dirs: torch.Tensor, degree: int) -> torch.Tensor:
    """SH (..., K, 3), K >= (degree+1)**2, at unit dirs (..., 3) -> raw
    color (..., 3), before the +0.5 offset."""
    cols = _sh_basis_cols(dirs, degree)
    out = []
    for c in range(3):
        acc = cols[0] * sh[..., 0, c]
        for i in range(1, len(cols)):
            acc = acc + cols[i] * sh[..., i, c]
        out.append(acc)
    return torch.stack(out, dim=-1)


def eval_sh_color(sh: torch.Tensor, means: torch.Tensor, campos: torch.Tensor,
                  degree: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Reference color path: normalize(mean - campos), eval, +0.5, clamp.
    Returns (rgb, clamped_mask)."""
    d = means - campos
    d = d / torch.clamp(torch.linalg.vector_norm(d, dim=-1, keepdim=True), min=1e-12)
    raw = eval_sh(sh, d, degree) + 0.5
    return torch.clamp(raw, min=0.0), raw < 0.0
