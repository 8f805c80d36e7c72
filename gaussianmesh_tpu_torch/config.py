"""Parameter groups, their argparse reflection and `cfg_args.json` (port of
`gaussianmesh_tpu/config.py`).

The same group names, field names, shorthands and defaults as the reference
(arguments/__init__.py:47-114) and the JAX package. Every field becomes a
`--name` flag (`-m`, `-s`, ... for the reference's shorthands); a training
run stores the merged groups as JSON `cfg_args.json` in its model directory
and `load_combined` overlays the command line on it.

Left out, because nothing in the port reads them:
`RuntimeParams.blend_chunk` and `use_pallas` (TPU kernel options).
`data_axis` and `tile_axis` shape the (data, tile) process mesh of
`parallel/`, `shard_gaussians` the Gaussian-table shard. `load_combined`
skips the left-out keys in a `cfg_args.json` the JAX package wrote, so a
model directory trained by either package loads here; every key the port
writes is one of the JAX package's, so the reverse holds too.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from dataclasses import dataclass


def _short(name: str) -> str | None:
    # the reference's leading-underscore attributes get one-letter flags
    return {"source_path": "s", "model_path": "m", "images": "i",
            "resolution": "r", "white_background": "w"}.get(name)


@dataclass
class ModelParams:
    sh_degree: int = 3
    source_path: str = ""
    model_path: str = ""
    images: str = "images"
    resolution: int = -1
    white_background: bool = True
    eval: bool = False


@dataclass
class PipelineParams:
    # kept for the reference's command line; both paths are PyTorch here
    convert_SHs_python: bool = False
    compute_cov3D_python: bool = False
    debug: bool = False


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
    percent_dense: float = 0.01
    lambda_dssim: float = 0.2
    densification_interval: int = 200
    opacity_reset_interval: int = 3000
    densify_from_iter: int = 500
    densify_until_iter: int = 15_000
    densify_grad_threshold: float = 0.0002
    random_background: bool = True
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
    # (data, tile) process mesh: data_axis cameras per step, each image cut
    # into tile_axis bands; their product is the world size (1: one process)
    data_axis: int = 1
    tile_axis: int = 1
    # > 1: the Gaussian table and the tile bands sharded over that many
    # ranks (exclusive with the (data, tile) mesh); 0 or 1: no shard
    shard_gaussians: int = 0


GROUPS = {"model": ModelParams, "pipeline": PipelineParams,
          "optimization": OptimizationParams, "runtime": RuntimeParams}

# fields of the JAX package's groups that the port leaves out (see above)
JAX_ONLY = {"runtime": ("blend_chunk", "use_pallas")}


def add_group(parser: argparse.ArgumentParser, cls) -> None:
    g = parser.add_argument_group(cls.__name__)
    for f in dataclasses.fields(cls):
        names = [f"--{f.name}"]
        if _short(f.name):
            names.append(f"-{_short(f.name)}")
        if f.type in ("bool", bool):
            # --no-<flag> disables a default-True boolean (white_background)
            g.add_argument(*names, action=argparse.BooleanOptionalAction,
                           default=None)
        else:
            typ = {"int": int, "float": float}.get(f.type, str)
            g.add_argument(*names, type=typ, default=None)


def extract(cls, args: argparse.Namespace):
    """The group `cls` from the flags given (None: not given)."""
    return cls(**{f.name: getattr(args, f.name) for f in dataclasses.fields(cls)
                  if getattr(args, f.name, None) is not None})


def save_cfg(model_path: str, groups: dict) -> None:
    os.makedirs(model_path, exist_ok=True)
    blob = {name: dataclasses.asdict(g) for name, g in groups.items()}
    with open(os.path.join(model_path, "cfg_args.json"), "w") as f:
        json.dump(blob, f, indent=2)


def load_cfg(model_path: str) -> dict:
    path = os.path.join(model_path, "cfg_args.json")
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return json.load(f)


def load_combined(model_path: str, args: argparse.Namespace) -> dict:
    """The training run's groups (`cfg_args.json`, JAX-only keys skipped)
    overlaid with the flags given: {"model", "pipeline", "optimization",
    "runtime"} -> dataclass. An unknown key raises."""
    saved = load_cfg(model_path)
    out = {}
    for name, cls in GROUPS.items():
        kw = {k: v for k, v in saved.get(name, {}).items()
              if k not in JAX_ONLY.get(name, ())}
        kw.update({f.name: getattr(args, f.name) for f in dataclasses.fields(cls)
                   if getattr(args, f.name, None) is not None})
        out[name] = cls(**kw)
    return out
