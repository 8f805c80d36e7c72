"""Per-group Adam with scheduled learning rates.

Port of `gaussianmesh_tpu/train/optim.py`: optax's
`scale_by_adam(b1=0.9, b2=0.999, eps=1e-15)` followed by a per-parameter
learning rate (the reference training_setup,
scene/mesh_based_gaussian_model.py:243-262). As in optax:

- one step counter shared by every parameter; the bias corrections use the
  incremented count, and the learning rates are evaluated at the count
  before it (0-based);
- eps is added outside the square root: m_hat / (sqrt(v_hat) + eps).

The moments are plain tensors keyed like the model's parameters, so the
densifier can scatter into them and zero them when it replaces a parameter
tensor (`torch.optim.Adam` keys its state by tensor identity and keeps a
step per parameter; both break under densification).
"""

from __future__ import annotations

from typing import Callable

import torch

from gaussianmesh_tpu_torch.config import OptimizationParams
from gaussianmesh_tpu_torch.utils.lr import expon_lr


class Adam:
    """mu, nu: {name: tensor} like the parameters; step: int."""

    def __init__(self, params: dict[str, torch.Tensor],
                 lr_fn: Callable[[int], dict[str, float]],
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-15):
        self.lr_fn = lr_fn
        self.b1, self.b2, self.eps = b1, b2, eps
        self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.step = 0

    @torch.no_grad()
    def update(self, params: dict[str, torch.Tensor],
               grads: dict[str, torch.Tensor]) -> None:
        """One Adam step; updates `params` (and the moments) in place."""
        lrs = self.lr_fn(self.step)
        count = self.step + 1
        f32 = torch.float32
        bc1 = 1 - torch.tensor(self.b1, dtype=f32) ** count
        bc2 = 1 - torch.tensor(self.b2, dtype=f32) ** count
        for name, p in params.items():
            g = grads[name]
            mu = (1 - self.b1) * g + self.b1 * self.mu[name]
            nu = (1 - self.b2) * (g ** 2) + self.b2 * self.nu[name]
            self.mu[name], self.nu[name] = mu, nu
            u = (mu / bc1.to(p.device)) / (torch.sqrt(nu / bc2.to(p.device))
                                           + self.eps)
            p.add_(-lrs[name] * u)
        self.step = count


def _lr_fn(opt: OptimizationParams, spatial_lr_scale: float,
           position_fields: tuple[str, ...]) -> Callable[[int], dict[str, float]]:
    def fn(step: int) -> dict[str, float]:
        pos_lr = expon_lr(step, opt.position_lr_init * spatial_lr_scale,
                          opt.position_lr_final * spatial_lr_scale,
                          lr_delay_mult=opt.position_lr_delay_mult,
                          max_steps=opt.position_lr_max_steps)
        return {**{k: pos_lr for k in position_fields},
                "features_dc": opt.feature_lr,
                "features_rest": opt.feature_lr / 20.0,
                "scaling": opt.scaling_lr, "rotation": opt.rotation_lr,
                "opacity": opt.opacity_lr}
    return fn


def mesh_lr_fn(opt: OptimizationParams, spatial_lr_scale: float
               ) -> Callable[[int], dict[str, float]]:
    """Per-parameter learning rates of the mesh model at a step (the JAX
    `mesh_lr_tree_fn`): bc and distance follow the position schedule scaled
    by the scene extent."""
    return _lr_fn(opt, spatial_lr_scale, ("bc", "distance"))


def gaussian_lr_fn(opt: OptimizationParams, spatial_lr_scale: float
                   ) -> Callable[[int], dict[str, float]]:
    """The background model's learning rates (the JAX `gaussian_lr_tree_fn`):
    xyz follows the position schedule."""
    return _lr_fn(opt, spatial_lr_scale, ("xyz",))
