"""Parameter groups and defaults (port of `gaussianmesh_tpu/config.py`).

The same names and defaults as the reference (arguments/__init__.py:47-114)
and the JAX package, for the fields the training step reads. Left out,
because nothing in the port reads them yet: the model group
(`ModelParams`: dataset paths, resolution, background, eval split; the
command-line tools read it) and the pipeline group,
`OptimizationParams.random_background` (the background trainer) and
`percent_dense`, `RuntimeParams.blend_chunk` and `use_pallas` (TPU kernel
options), and the device-mesh fields `data_axis`, `tile_axis` and
`shard_gaussians` (multi-device training). The argparse reflection comes
with the command-line tools.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class OptimizationParams:
    iterations: int = 30_000
    position_lr_init: float = 0.000_16
    position_lr_final: float = 0.000_001_6
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 30_000
    feature_lr: float = 0.0025
    opacity_lr: float = 0.05
    scaling_lr: float = 0.005
    rotation_lr: float = 0.001
    lambda_dssim: float = 0.2
    densification_interval: int = 200
    opacity_reset_interval: int = 3000
    densify_from_iter: int = 500
    densify_until_iter: int = 15_000
    densify_grad_threshold: float = 0.0002
    alpha_mrloss: float = 6.0


@dataclass
class RuntimeParams:
    """Capacities and seed (no reference analog)."""
    capacity: int = 0            # 0 -> from the init subdivision's count
    max_per_tile: int = 1024
    # rasterizer pair / row capacity per Gaussian; overflow is counted and
    # reported, never silent
    pair_capacity_per_gaussian: int = 10
    row_capacity_per_gaussian: int = 4
    seed: int = 0
