"""Per-Gaussian preprocessing: projection, EWA 2D covariance, culling.

Port of `gaussianmesh_tpu/ops/preprocess.py` (the reference preprocess kernel,
forward.cu:156-256): one elementwise pipeline over all N Gaussians, in
plain PyTorch on any device.

- near cull: view-space z <= 0.2 (auxiliary.h:153)
- projection: p_ndc = (P_full @ [x,1]).xyz / (w + 1e-7)
- EWA: t.x/t.y clamped to ±1.3·tanfov·t.z; cov2d = A V Σ Vᵀ Aᵀ + 0.3·I
- conic = inverse(cov2d); cull if det == 0
- radius = ceil(3·sqrt(max eigenvalue)), eigenvalue floor 0.1
- tile rect from `getRect` (auxiliary.h:45-56), opacity-gated when the
  opacity is given; cull if empty
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gaussianmesh_tpu_torch.utils.graphics import CameraArrays, ndc_to_pix

TILE = 16  # BLOCK_X = BLOCK_Y = 16 (config.h:16-17)
NEAR_Z = 0.2


class Preprocessed(NamedTuple):
    valid: torch.Tensor          # (N,) bool — survives all culls
    mean2d: torch.Tensor         # (N, 2) pixel coordinates
    depth: torch.Tensor          # (N,) view-space z (0 when culled)
    conic: torch.Tensor          # (N, 3) inverse 2D covariance (a, b, c)
    radius: torch.Tensor         # (N,) int32 screen radius (0 when culled)
    rect_min: torch.Tensor       # (N, 2) int32 tile rect (x, y)
    rect_max: torch.Tensor       # (N, 2) int32 tile rect (x, y), exclusive
    tiles_touched: torch.Tensor  # (N,) int32


def tile_grid(width: int, height: int) -> tuple[int, int]:
    return (width + TILE - 1) // TILE, (height + TILE - 1) // TILE


def preprocess(means3d: torch.Tensor, cov6: torch.Tensor, cam: CameraArrays,
               width: int, height: int,
               opacity: torch.Tensor | None = None) -> Preprocessed:
    """Project N Gaussians; compute conics, radii and tile rects.

    When `opacity` is given, tile rects cover the Gaussian's GATED footprint
    {q <= 2 ln(255 op)} (the only pixels where alpha >= 1/255), intersected
    with the reference's 3-sigma circle. `radius` keeps the reference
    formula (it feeds visibility and densification stats).
    """
    V = cam.viewmatrix
    grid_x, grid_y = tile_grid(width, height)

    # view space and homogeneous projection in one affine map (7 rows: V's
    # 3, then P's 4), written out per coordinate: a matmul's result for a
    # row can depend on how many rows it is given, and the composite
    # playback frame must equal the render of the concatenated scene
    P = cam.projmatrix
    m = torch.cat([V[:3], P])                              # (7, 4)
    x = means3d
    affine = (x[:, 0:1] * m[:, 0] + x[:, 1:2] * m[:, 1]
              + x[:, 2:3] * m[:, 2] + m[:, 3])             # (N, 7)
    t = affine[:, :3]                                      # (N, 3) view space
    p_hom = affine[:, 3:6]
    w_hom = affine[:, 6]
    p_w = 1.0 / (w_hom + 1e-7)
    p_proj = p_hom * p_w[:, None]                           # (N, 3) NDC

    in_front = t[:, 2] > NEAR_Z

    # EWA Jacobian with fov clamping (forward.cu:82-92)
    fx = width / (2.0 * cam.tanfovx)
    fy = height / (2.0 * cam.tanfovy)
    limx = 1.3 * cam.tanfovx
    limy = 1.3 * cam.tanfovy
    tz = torch.where(in_front, t[:, 2], 1.0)
    tx = torch.clamp(t[:, 0] / tz, -limx, limx) * tz
    ty = torch.clamp(t[:, 1] / tz, -limy, limy) * tz

    inv_tz = 1.0 / tz
    a00 = fx * inv_tz
    a02 = -fx * tx * inv_tz * inv_tz
    a11 = fy * inv_tz
    a12 = -fy * ty * inv_tz * inv_tz

    # M = A @ V_rot (2x3 per Gaussian), cov2d = M Σ Mᵀ, elementwise
    R = V[:3, :3]
    m0 = a00[:, None] * R[0] + a02[:, None] * R[2]          # (N, 3)
    m1 = a11[:, None] * R[1] + a12[:, None] * R[2]          # (N, 3)
    xx, xy, xz, yy, yz, zz = cov6.unbind(-1)

    def quad(u, v):
        return (u[:, 0] * (xx * v[:, 0] + xy * v[:, 1] + xz * v[:, 2])
                + u[:, 1] * (xy * v[:, 0] + yy * v[:, 1] + yz * v[:, 2])
                + u[:, 2] * (xz * v[:, 0] + yz * v[:, 1] + zz * v[:, 2]))

    c_a = quad(m0, m0) + 0.3
    c_b = quad(m0, m1)
    c_c = quad(m1, m1) + 0.3

    det = c_a * c_c - c_b * c_b
    det_ok = det != 0.0
    det_safe = torch.where(det_ok, det, 1.0)
    inv_det = 1.0 / det_safe
    conic = torch.stack([c_c * inv_det, -c_b * inv_det, c_a * inv_det], dim=-1)

    # screen extent (forward.cu:229-237)
    mid = 0.5 * (c_a + c_c)
    lam_max = mid + torch.sqrt(torch.clamp(mid * mid - det_safe, min=0.1))
    radius_f = torch.ceil(3.0 * torch.sqrt(torch.clamp(lam_max, min=0.0))).detach()
    radius = radius_f.to(torch.int32)

    px = ndc_to_pix(p_proj[:, 0], width)
    py = ndc_to_pix(p_proj[:, 1], height)
    mean2d = torch.stack([px, py], dim=-1)

    px_s, py_s = px.detach(), py.detach()
    radius_f32 = radius.to(torch.float32)
    if opacity is not None:
        op_s = opacity.detach().reshape(-1)
        qcut = 2.0 * torch.log(torch.clamp(op_s, min=1e-12) * 255.0)
        qpos = torch.clamp(qcut, min=0.0)
        # c_a/c_c are the 2D covariance diagonal (incl. the 0.3 low-pass);
        # +0.5px covers pixel-center vs bbox-edge rounding
        hx = torch.minimum(radius_f32, torch.sqrt(qpos * c_a.detach()) + 0.5)
        hy = torch.minimum(radius_f32, torch.sqrt(qpos * c_c.detach()) + 0.5)
        gated = qcut > 0.0
    else:
        hx = hy = radius_f32
        gated = torch.ones_like(in_front)
    rmin_x = torch.clamp(torch.floor((px_s - hx) / TILE), 0, grid_x).to(torch.int32)
    rmin_y = torch.clamp(torch.floor((py_s - hy) / TILE), 0, grid_y).to(torch.int32)
    rmax_x = torch.clamp(torch.floor((px_s + hx) / TILE) + 1, 0, grid_x).to(torch.int32)
    rmax_y = torch.clamp(torch.floor((py_s + hy) / TILE) + 1, 0, grid_y).to(torch.int32)
    tiles_touched = (rmax_x - rmin_x) * (rmax_y - rmin_y)

    finite = (torch.isfinite(px_s) & torch.isfinite(py_s)
              & torch.isfinite(det_safe.detach()))
    valid = in_front & det_ok & (tiles_touched > 0) & finite & gated
    radius = torch.where(valid, radius, 0)
    tiles_touched = torch.where(valid, tiles_touched, 0).to(torch.int32)

    # Sanitize culled rows: never blended (alpha gated to zero), but
    # non-finite values would turn zero cotangents into NaN under autograd.
    mean2d = torch.where(valid[:, None], mean2d, 0.0)
    conic = torch.where(valid[:, None], conic,
                        torch.tensor([1.0, 0.0, 1.0], dtype=conic.dtype,
                                     device=conic.device))

    return Preprocessed(
        valid=valid,
        mean2d=mean2d,
        depth=torch.where(valid, t[:, 2], 0.0),
        conic=conic,
        radius=radius,
        rect_min=torch.stack([rmin_x, rmin_y], dim=-1),
        rect_max=torch.stack([rmax_x, rmax_y], dim=-1),
        tiles_touched=tiles_touched,
    )
