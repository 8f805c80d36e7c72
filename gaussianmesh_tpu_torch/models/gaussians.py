"""Vanilla 3DGS model, the background model (port of
`gaussianmesh_tpu/models/gaussians.py`; densification comes with training).

`GaussianModel` is an `nn.Module` whose trainable leaves (the JAX
`GaussianParams` fields) are `nn.Parameter`s; `alive` (C,) is a buffer.
Activations mirror the reference: scaling = exp, opacity = sigmoid,
rotation = L2-normalize.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from gaussianmesh_tpu_torch import resolve_device
from gaussianmesh_tpu_torch.utils import maths

PARAM_FIELDS = ("xyz", "features_dc", "features_rest", "scaling", "rotation",
                "opacity")


class GaussianModel(nn.Module):
    """Parameters (capacity C rows): xyz (C, 3), features_dc (C, 1, 3),
    features_rest (C, K-1, 3), scaling (C, 3) log-scale, rotation (C, 4)
    unnormalized (w, x, y, z), opacity (C, 1) pre-sigmoid.
    Buffer: alive (C,) bool."""

    def __init__(self, params: dict[str, torch.Tensor], alive: torch.Tensor):
        super().__init__()
        for name in PARAM_FIELDS:
            setattr(self, name, nn.Parameter(params[name]))
        self.register_buffer("alive", alive)

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


def from_numpy(params: dict, alive,
               device: str | torch.device | None = None) -> GaussianModel:
    """Build the model from numpy leaves named as the JAX `GaussianParams`
    fields, plus the `alive` mask of its `GaussianState`."""
    dev = resolve_device(device)
    return GaussianModel(
        {k: torch.tensor(np.asarray(params[k], np.float32), device=dev)
         for k in PARAM_FIELDS},
        torch.tensor(np.asarray(alive, bool), device=dev))
