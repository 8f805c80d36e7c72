"""Vanilla 3DGS model, the background model (port of
`gaussianmesh_tpu/models/gaussians.py`).

`GaussianModel` is an `nn.Module` whose trainable leaves (the JAX
`GaussianParams` fields) are `nn.Parameter`s; `alive` (C,) is a buffer, and
the densification statistics (`state`, the rest of the JAX
`GaussianState`) sit on the model as a plain attribute, as
`MeshGaussianModel` keeps them. Activations mirror the reference: scaling =
exp, opacity = sigmoid, rotation = L2-normalize. Densification (clone,
split, prune) is `train/densify.py::densify_and_prune_bg`.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from gaussianmesh_tpu_torch import resolve_device
from gaussianmesh_tpu_torch.models.mesh_gaussians import (
    STATE_FIELDS, MeshGaussianState as GaussianState, empty_state)
from gaussianmesh_tpu_torch.ops.knn import mean_sq_dist3
from gaussianmesh_tpu_torch.utils import maths, sh as sh_utils

PARAM_FIELDS = ("xyz", "features_dc", "features_rest", "scaling", "rotation",
                "opacity")


class GaussianModel(nn.Module):
    """Parameters (capacity C rows): xyz (C, 3), features_dc (C, 1, 3),
    features_rest (C, K-1, 3), scaling (C, 3) log-scale, rotation (C, 4)
    unnormalized (w, x, y, z), opacity (C, 1) pre-sigmoid.
    Buffer: alive (C,) bool. Attribute: state (`GaussianState`: max_radii2d,
    grad_accum, denom, each (C,) f32)."""

    def __init__(self, params: dict[str, torch.Tensor], alive: torch.Tensor,
                 state: GaussianState | None = None):
        super().__init__()
        for name in PARAM_FIELDS:
            setattr(self, name, nn.Parameter(params[name]))
        self.register_buffer("alive", alive)
        self.state = (empty_state(alive.shape[0], alive.device)
                      if state is None else state)

    @property
    def capacity(self) -> int:
        return self.alive.shape[0]

    def params(self) -> dict[str, torch.Tensor]:
        return {name: getattr(self, name) for name in PARAM_FIELDS}

    def get_scaling(self) -> torch.Tensor:
        return torch.exp(self.scaling)

    def get_opacity(self) -> torch.Tensor:
        return torch.sigmoid(self.opacity)

    def get_rotation(self) -> torch.Tensor:
        return maths.normalize(self.rotation)

    def get_features(self) -> torch.Tensor:
        return torch.cat([self.features_dc, self.features_rest], dim=1)

    def get_covariance6(self, scaling_modifier: float = 1.0) -> torch.Tensor:
        return maths.covariance_6(self.get_scaling(), self.get_rotation(),
                                  scaling_modifier)


def from_numpy(params: dict, alive, device: str | torch.device | None = None,
               state: dict | None = None) -> GaussianModel:
    """Build the model from numpy leaves named as the JAX `GaussianParams`
    fields, the `alive` mask of its `GaussianState` and, optionally, the
    state's statistics ({field: array})."""
    dev = resolve_device(device)

    def f32(x):
        return torch.tensor(np.asarray(x, np.float32), device=dev)

    stats = None if state is None else GaussianState(
        *(f32(state[k]) for k in STATE_FIELDS))
    return GaussianModel({k: f32(params[k]) for k in PARAM_FIELDS},
                         torch.tensor(np.asarray(alive, bool), device=dev), stats)


def create_from_points(points, colors, capacity: int, max_sh_degree: int = 3,
                       device: str | torch.device | None = None) -> GaussianModel:
    """SfM-point initialization (reference gaussian_model.py:124-161): scale
    from sqrt(mean 3-NN squared distance), opacity 0.1, identity quaternion,
    DC color from RGB; rows past the points are dead."""
    dev = resolve_device(device)
    points = torch.tensor(np.asarray(points, np.float32), device=dev)
    colors = torch.tensor(np.asarray(colors, np.float32), device=dev)
    n = points.shape[0]
    if capacity < n:
        raise ValueError(f"capacity {capacity} < {n} points")
    k = (max_sh_degree + 1) ** 2
    dist2 = torch.clamp(mean_sq_dist3(points), min=1e-7)
    log_scale = torch.log(torch.sqrt(dist2))[:, None].repeat(1, 3)

    def cap(x):
        return torch.cat([x, x.new_zeros((capacity - n,) + tuple(x.shape[1:]))])

    f32 = dict(dtype=torch.float32, device=dev)
    params = {
        "xyz": cap(points),
        "features_dc": cap(sh_utils.rgb_to_sh(colors)[:, None, :]),
        "features_rest": torch.zeros((capacity, k - 1, 3), **f32),
        "scaling": cap(log_scale),
        "rotation": cap(torch.tensor([[1.0, 0, 0, 0]], **f32).repeat(n, 1)),
        "opacity": cap(maths.inverse_sigmoid(torch.full((n, 1), 0.1, **f32))),
    }
    return GaussianModel(params, torch.arange(capacity, device=dev) < n)
