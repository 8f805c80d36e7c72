"""Training losses: L1, SSIM, mesh-restrict; eval PSNR.

Port of `gaussianmesh_tpu/train/loss.py` (reference utils/loss_utils.py:
l1_loss :17, ssim :36-81 with an 11x11 sigma-1.5 Gaussian window, C1 =
0.01^2, C2 = 0.03^2; mesh_restrict_loss :86-107). The training loss
(train_mesh_gaussian.py:92-94) is (1 - l) L1 + l (1 - SSIM) + mrloss.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F


def l1_loss(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return torch.abs(pred - gt).mean()


def l2_loss(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return ((pred - gt) ** 2).mean()


def psnr(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Per-image PSNR over flattened pixels (utils/image_utils.py:21-23)."""
    mse = torch.mean((pred - gt) ** 2)
    return 20.0 * torch.log10(1.0 / torch.sqrt(mse))


@functools.lru_cache(maxsize=None)
def _gaussian_window(window_size: int, sigma: float) -> tuple:
    g = [math.exp(-((x - window_size // 2) ** 2) / (2 * sigma ** 2))
         for x in range(window_size)]
    s = sum(g)
    return tuple(v / s for v in g)


def ssim_map(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11,
             pad_rows: bool = True) -> torch.Tensor:
    """The SSIM map of (C, H, W) or (B, C, H, W) images, (B, C, H', W). The
    11x11 window is separable: two 1-D grouped convolutions (along W, then
    along H), zero padded, as in the JAX package. With `pad_rows` False the
    convolution along H is valid (H' = H - window_size + 1): a band given
    its neighbours' rows as a halo then gets the full image's map rows."""
    if img1.dim() == 3:
        img1, img2 = img1[None], img2[None]
    c = img1.shape[1]
    w1d = torch.tensor(_gaussian_window(window_size, 1.5), dtype=img1.dtype,
                       device=img1.device)
    kx = w1d.reshape(1, 1, 1, -1).repeat(c, 1, 1, 1)       # (C, 1, 1, W)
    ky = w1d.reshape(1, 1, -1, 1).repeat(c, 1, 1, 1)       # (C, 1, W, 1)
    pad = window_size // 2
    pad_h = pad if pad_rows else 0

    def blur(x):
        x = F.conv2d(x, kx, padding=(0, pad), groups=c)
        return F.conv2d(x, ky, padding=(pad_h, 0), groups=c)

    mu1, mu2 = blur(img1), blur(img2)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1 = blur(img1 * img1) - mu1_sq
    sigma2 = blur(img2 * img2) - mu2_sq
    sigma12 = blur(img1 * img2) - mu12

    c1, c2 = 0.01 ** 2, 0.03 ** 2
    return ((2 * mu12 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1 + sigma2 + c2))


def ssim(img1: torch.Tensor, img2: torch.Tensor,
         window_size: int = 11) -> torch.Tensor:
    """Mean SSIM of (C, H, W) or (B, C, H, W) images (`ssim_map`)."""
    return ssim_map(img1, img2, window_size).mean()


def mesh_restrict_loss(scaling: torch.Tensor, v1: torch.Tensor,
                       v2: torch.Tensor, v3: torch.Tensor, alive: torch.Tensor,
                       weight: float = 6.0) -> torch.Tensor:
    """sum over alive of clamp(max_axis_scale - weight * sqrt(2 * area), 0)."""
    max_s = torch.max(scaling, dim=1).values
    cross = torch.linalg.cross(v2 - v1, v3 - v1, dim=-1)
    r = torch.sqrt(torch.linalg.vector_norm(cross, dim=1))
    return torch.sum(torch.where(alive, torch.clamp(max_s - weight * r, min=0.0),
                                 0.0))


def photometric_loss(pred: torch.Tensor, gt: torch.Tensor,
                     lambda_dssim: float = 0.2) -> torch.Tensor:
    """(1 - l) L1 + l (1 - SSIM): the training loss without mrloss."""
    return ((1.0 - lambda_dssim) * l1_loss(pred, gt)
            + lambda_dssim * (1.0 - ssim(pred, gt)))
