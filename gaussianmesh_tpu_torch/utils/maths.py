"""Core Gaussian math (port of `gaussianmesh_tpu/utils/maths.py`).

Quaternion (w, x, y, z) -> rotation matrix, L = R @ diag(s), world
covariance Sigma = L @ L^T stored as the 6 upper coefficients
(xx, xy, xz, yy, yz, zz); and the edit path's batched 3x3 algebra
(inverse, polar decomposition, congruence). Batched over leading axes.

The JAX package carries the edit path's matrices in "component form", a
9-tuple of (V,) arrays, because a 3x3 block pads to (8, 128) TPU vector
registers. Here each tuple operation would be its own kernel launch, so
matrices stay (..., 3, 3) tensors (row-major (..., 9) where a gather wants
one row per vertex: a reshape) and products are broadcast multiply-and-sum
in float32, with no TF32 path. The JAX names map as: `m9_mul` -> `mat_mul`,
`m9_vec` -> `mat_vec`, `m9_det` -> `det3`, `m9_inv_det` -> `inv3x3`,
`m9_t` -> `.transpose(-1, -2)`, `m9_from_packed` / `m9_to_packed` ->
`reshape`, `sym6_to_m9` -> `unstrip_symmetric`, `m9_sym6` ->
`strip_symmetric`; `polar_rs9` and `congruence_sym6` keep their names.
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


def rotmat_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrices (..., 3, 3) -> quaternions (..., 4) (w, x, y, z),
    w >= 0, normalised. Branch-free Shepperd selection: all four candidate
    quaternions, the one with the largest 4 q_i^2 taken (reference:
    edittool/__init__.py:23-38, 204-207)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    t = torch.stack([1.0 + m00 + m11 + m22, 1.0 + m00 - m11 - m22,    # 4w^2, 4x^2,
                     1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22], -1)  # 4y^2, 4z^2
    s = torch.sqrt(torch.clamp(t, min=1e-12))
    sw, sx, sy, sz = s.unbind(-1)
    cands = torch.stack([
        torch.stack([0.5 * sw, 0.5 * (m21 - m12) / sw, 0.5 * (m02 - m20) / sw,
                     0.5 * (m10 - m01) / sw], -1),
        torch.stack([0.5 * (m21 - m12) / sx, 0.5 * sx, 0.5 * (m01 + m10) / sx,
                     0.5 * (m02 + m20) / sx], -1),
        torch.stack([0.5 * (m02 - m20) / sy, 0.5 * (m01 + m10) / sy, 0.5 * sy,
                     0.5 * (m12 + m21) / sy], -1),
        torch.stack([0.5 * (m10 - m01) / sz, 0.5 * (m02 + m20) / sz,
                     0.5 * (m12 + m21) / sz, 0.5 * sz], -1)], -2)       # (..., 4, 4)
    best = torch.argmax(t, dim=-1)[..., None, None].expand(*t.shape[:-1], 1, 4)
    q = torch.gather(cands, -2, best)[..., 0, :]
    return normalize(torch.where(q[..., :1] < 0, -q, q))


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


_UNSTRIP = [0, 1, 2, 1, 3, 4, 2, 4, 5]


def unstrip_symmetric(c6: torch.Tensor) -> torch.Tensor:
    """(..., 6) uppers -> (..., 3, 3) symmetric."""
    return c6[..., _UNSTRIP].reshape(*c6.shape[:-1], 3, 3)


def mat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) @ (..., 3, 3) as a broadcast multiply-and-sum."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(-2)


def mat_vec(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) @ (..., 3) -> (..., 3)."""
    return (m * v[..., None, :]).sum(-1)


# flat (row-major) indices of A's entries that the cofactor rows
# cross(r1, r2), cross(r2, r0), cross(r0, r1) multiply: C = A[P] A[Q] - A[S] A[U]
_COF = ([4, 5, 3, 7, 8, 6, 1, 2, 0], [8, 6, 7, 2, 0, 1, 5, 3, 4],
        [5, 3, 4, 8, 6, 7, 2, 0, 1], [7, 8, 6, 1, 2, 0, 4, 5, 3])


def _cofactors(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Cofactor matrix (..., 3, 3) (row i = cross of the other two rows, in
    cyclic order) and determinant (...,), in the JAX package's products."""
    f = a.reshape(*a.shape[:-2], 9)
    p, q, s, u = _COF
    cof = (f[..., p] * f[..., q] - f[..., s] * f[..., u]).reshape(a.shape)
    return cof, (a[..., 0, :] * cof[..., 0, :]).sum(-1)


def det3(a: torch.Tensor) -> torch.Tensor:
    """Determinant of (..., 3, 3) by the first row's cofactor expansion."""
    return _cofactors(a)[1]


# the JAX package's guards and step count (gaussianmesh_tpu/utils/maths.py)
INV_EPS = 1e-12      # |det| at or under which an "inverse" is the adjugate
POLAR_EPS = 1e-9     # |det| at or under which the polar factors are I, I
NEWTON_STEPS = 7


def inv3x3(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Closed-form batched 3x3 inverse via the adjugate -> (inv, det). Where
    |det| <= INV_EPS the adjugate itself comes back (the JAX package's guard)."""
    cof, det = _cofactors(a)
    inv_det = 1.0 / torch.where(det.abs() > INV_EPS, det, 1.0)
    return cof.transpose(-1, -2) * inv_det[..., None, None], det


def polar_decompose_rs(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Polar decomposition A = R S of (..., 3, 3) matrices.

    Higham's scaled Newton iteration X <- (s X + X^-T / s) / 2 with the
    determinant scaling s = |det X|^(-1/3) clipped to [0.1, 10],
    NEWTON_STEPS steps, as the JAX package. R is a proper rotation (an
    improper A is flipped first, so S takes the negative eigenvalue, the SVD
    convention) and S is symmetrised; inputs with |det| <= POLAR_EPS give
    R = S = I. Not an SVD: `torch.linalg.svd` gives another S on
    ill-conditioned inputs."""
    eye = torch.eye(3, dtype=a.dtype, device=a.device)
    det_a = det3(a)
    safe = torch.where((det_a.abs() > POLAR_EPS)[..., None, None], a, eye)
    x = safe * torch.where(det_a < 0, -1.0, 1.0)[..., None, None]
    for _ in range(NEWTON_STEPS):
        cof, det = _cofactors(x)
        inv_det = 1.0 / torch.where(det.abs() > INV_EPS, det, 1.0)
        s = torch.clamp(det.abs() ** (-1.0 / 3.0), 0.1, 10.0)[..., None, None]
        # X^-T is the cofactor matrix over det
        x = 0.5 * (x * s + cof * inv_det[..., None, None] / s)
    s_mat = mat_mul(x.transpose(-1, -2), safe)
    return x, 0.5 * (s_mat + s_mat.transpose(-1, -2))


def polar_rs9(t9: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """`polar_decompose_rs` on row-major packed (..., 9) matrices."""
    r, s = polar_decompose_rs(t9.reshape(*t9.shape[:-1], 3, 3))
    return r.reshape(t9.shape), s.reshape(t9.shape)


def congruence_sym6(a: torch.Tensor, c6: torch.Tensor) -> torch.Tensor:
    """A Sigma A^T for symmetric Sigma given as (..., 6) uppers, A (..., 3, 3)
    -> (..., 6), in the JAX package's order A (Sigma A^T)."""
    return strip_symmetric(mat_mul(a, mat_mul(unstrip_symmetric(c6),
                                              a.transpose(-1, -2))))
