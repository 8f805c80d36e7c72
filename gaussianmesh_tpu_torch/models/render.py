"""Render orchestration: model -> rasterizer inputs -> image.

Port of `gaussianmesh_tpu/models/render.py` (the reference renderer layer,
gaussian_renderer/__init__.py:26-260). SH -> RGB and scale/quat ->
covariance run as plain PyTorch. Foreground and background models are
concatenated before binning, so depth sorting interleaves them.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gaussianmesh_tpu_torch.models.gaussians import GaussianModel
from gaussianmesh_tpu_torch.models.mesh_gaussians import MeshGaussianModel
from gaussianmesh_tpu_torch.ops.rasterize import RasterizeOut, RasterizerConfig, rasterize
from gaussianmesh_tpu_torch.utils import sh as sh_utils
from gaussianmesh_tpu_torch.utils.graphics import CameraArrays


class GaussianArrays(NamedTuple):
    """Rasterizer-ready per-Gaussian arrays (activations and SH applied)."""
    xyz: torch.Tensor      # (N, 3)
    cov6: torch.Tensor     # (N, 6)
    opacity: torch.Tensor  # (N,)
    rgb: torch.Tensor      # (N, 3)
    active: torch.Tensor   # (N,) bool


def mesh_model_arrays(model: MeshGaussianModel, cam: CameraArrays,
                      sh_degree: int,
                      scaling_modifier: float = 1.0) -> GaussianArrays:
    xyz = model.get_xyz()
    rgb, _ = sh_utils.eval_sh_color(model.get_features(), xyz, cam.campos,
                                    sh_degree)
    return GaussianArrays(xyz=xyz, cov6=model.get_covariance6(scaling_modifier),
                          opacity=model.get_opacity()[:, 0], rgb=rgb,
                          active=model.alive)


def gaussian_model_arrays(model: GaussianModel, cam: CameraArrays,
                          sh_degree: int,
                          scaling_modifier: float = 1.0) -> GaussianArrays:
    rgb, _ = sh_utils.eval_sh_color(model.get_features(), model.xyz,
                                    cam.campos, sh_degree)
    return GaussianArrays(xyz=model.xyz,
                          cov6=model.get_covariance6(scaling_modifier),
                          opacity=model.get_opacity()[:, 0], rgb=rgb,
                          active=model.alive)


def freeze(a: GaussianArrays) -> GaussianArrays:
    """Detach a model that is composited but not trained (bg_render's frozen
    mesh model, gaussian_renderer/__init__.py:221-232). Build its arrays
    under `torch.no_grad()` as well, so no graph is recorded for them."""
    return GaussianArrays(*(x.detach() for x in a))


def concat_arrays(a: GaussianArrays, b: GaussianArrays) -> GaussianArrays:
    return GaussianArrays(*(torch.cat([x, y], dim=0) for x, y in zip(a, b)))


def render(arrays: GaussianArrays, cam: CameraArrays, cfg: RasterizerConfig,
           bg_color: torch.Tensor,
           mean2d_offset: torch.Tensor | None = None) -> RasterizeOut:
    return rasterize(arrays.xyz, arrays.cov6, arrays.opacity, arrays.rgb,
                     bg_color, cam, cfg, mean2d_offset=mean2d_offset,
                     active_mask=arrays.active)
