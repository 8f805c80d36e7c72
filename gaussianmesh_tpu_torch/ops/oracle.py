"""Oracle renderers: the blending semantics in plain PyTorch, small scenes only.

Port of `gaussianmesh_tpu/ops/oracle.py`. Two formulations of the reference's
per-pixel loop (forward.cu:325-373) over ALL Gaussians, depth-ordered:

- `render_oracle`: closed form. Transmittance is monotone, so the early
  exit `T*(1-alpha) < 1e-4` defines a prefix of included contributors:
      w_i = alpha_i * prod_{j<i}(1 - alpha_j) * [prod_{j<=i}(1 - alpha_j) >= 1e-4]
- `render_sequential`: a literal transcription of the loop (done flag
  and all).

Gating: skip if power > 0; alpha = min(0.99, op * exp(power)), skipped
below 1/255; a Gaussian only touches pixels of its tile rect (3-sigma).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gaussianmesh_tpu_torch.ops.preprocess import TILE, Preprocessed, preprocess
from gaussianmesh_tpu_torch.utils.graphics import CameraArrays

ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
T_EPS = 1e-4


class RenderOut(NamedTuple):
    color: torch.Tensor      # (3, H, W)
    final_t: torch.Tensor    # (H, W)
    n_contrib: torch.Tensor  # (H, W) int32


def _pixel_alphas(prep: Preprocessed, opacity, order, px, py):
    """alpha (P, M) for P pixels x M depth-ordered Gaussians, all gates
    applied, and the (P, M) candidate mask."""
    mean2d = prep.mean2d[order]
    conic = prep.conic[order]
    op = opacity[order]
    rmin, rmax = prep.rect_min[order], prep.rect_max[order]

    dx = mean2d[None, :, 0] - px[:, None]
    dy = mean2d[None, :, 1] - py[:, None]
    a, b, c = conic[:, 0], conic[:, 1], conic[:, 2]
    power = -0.5 * (a[None] * dx * dx + c[None] * dy * dy) - b[None] * dx * dy
    alpha = torch.clamp(op[None, :] * torch.exp(power), max=ALPHA_MAX)

    tx = torch.div(px, TILE, rounding_mode="floor").to(torch.int32)
    ty = torch.div(py, TILE, rounding_mode="floor").to(torch.int32)
    in_rect = ((tx[:, None] >= rmin[None, :, 0]) & (tx[:, None] < rmax[None, :, 0])
               & (ty[:, None] >= rmin[None, :, 1]) & (ty[:, None] < rmax[None, :, 1]))
    candidate = prep.valid[order][None, :] & in_rect
    gate = (power <= 0.0) & (alpha >= ALPHA_MIN) & candidate
    return torch.where(gate, alpha, 0.0), candidate


def _setup(means3d, cov6, rgb, cam, width, height):
    prep = preprocess(means3d, cov6, cam, width, height)
    order = torch.argsort(torch.where(prep.valid, prep.depth, torch.inf),
                          stable=True)
    ys, xs = torch.meshgrid(torch.arange(height, device=means3d.device),
                            torch.arange(width, device=means3d.device),
                            indexing="ij")
    return (prep, order, rgb[order], xs.reshape(-1).to(torch.float32),
            ys.reshape(-1).to(torch.float32))


def render_oracle(means3d, cov6, opacity, rgb, cam: CameraArrays,
                  width: int, height: int, bg,
                  pixel_chunk: int = 4096) -> RenderOut:
    """Closed-form oracle. O(chunk * N) memory per pixel chunk."""
    prep, order, colors, px_all, py_all = _setup(means3d, cov6, rgb, cam,
                                                 width, height)
    out_c, out_t, out_n = [], [], []
    for s in range(0, px_all.shape[0], pixel_chunk):
        alpha, candidate = _pixel_alphas(prep, opacity, order,
                                         px_all[s:s + pixel_chunk],
                                         py_all[s:s + pixel_chunk])
        log_om = torch.log1p(-alpha)
        cum = torch.cumsum(log_om, dim=1)
        include = torch.exp(cum) >= T_EPS
        w = alpha * torch.exp(cum - log_om) * include
        final_t = torch.exp(torch.sum(torch.where(include, log_om, 0.0), dim=1))
        # n_contrib: rank, within the pixel's candidate list, of the last
        # Gaussian that contributed (`last_contributor`, forward.cu:328,361)
        cand_rank = torch.cumsum(candidate.to(torch.int32), dim=1)
        contributes = include & (alpha > 0.0)
        out_c.append(w @ colors + final_t[:, None] * bg[None, :])
        out_t.append(final_t)
        out_n.append(torch.where(contributes, cand_rank, 0).amax(dim=1))
    color = torch.cat(out_c).reshape(height, width, 3).permute(2, 0, 1)
    return RenderOut(color=color,
                     final_t=torch.cat(out_t).reshape(height, width),
                     n_contrib=torch.cat(out_n).reshape(height, width).to(torch.int32))


def render_sequential(means3d, cov6, opacity, rgb, cam: CameraArrays,
                      width: int, height: int, bg) -> RenderOut:
    """Literal transcription of renderCUDA's per-pixel loop."""
    prep, order, colors, px, py = _setup(means3d, cov6, rgb, cam, width, height)
    alpha, candidate = _pixel_alphas(prep, opacity, order, px, py)   # (P, M)
    n_pix = px.shape[0]
    T = torch.ones(n_pix, device=px.device)
    C = torch.zeros(n_pix, 3, device=px.device)
    done = torch.zeros(n_pix, dtype=torch.bool, device=px.device)
    contrib = torch.zeros(n_pix, dtype=torch.int32, device=px.device)
    last = torch.zeros_like(contrib)
    for i in range(alpha.shape[1]):
        a = alpha[:, i]
        contrib = contrib + candidate[:, i].to(torch.int32)
        test_t = T * (1.0 - a)
        fire = ~done & (a > 0.0)
        terminate = fire & (test_t < T_EPS)
        emit = fire & ~terminate
        C = C + torch.where(emit, a * T, 0.0)[:, None] * colors[i][None, :]
        T = torch.where(emit, test_t, T)
        last = torch.where(emit, contrib, last)
        done = done | terminate
    C = C + T[:, None] * bg[None, :]
    return RenderOut(color=C.reshape(height, width, 3).permute(2, 0, 1),
                     final_t=T.reshape(height, width),
                     n_contrib=last.reshape(height, width))
