"""Shared command-line plumbing (port of `gaussianmesh_tpu/cli/common.py`):
the parser of every parameter group plus `--device`, and PNG output through
the port's own codec (`io/png.py`, `zlib` alone: the machines the port runs
on need no imaging package).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from gaussianmesh_tpu_torch import config as cfg_mod
from gaussianmesh_tpu_torch.io.png import read_png, write_png  # noqa: F401


def base_parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    for cls in cfg_mod.GROUPS.values():
        cfg_mod.add_group(p, cls)
    p.add_argument("--device", type=str, default=None,
                   help="cuda (the default; raises without a card) or cpu")
    return p


def to_uint8(color) -> np.ndarray:
    """(3, H, W) float in [0, 1] -> (H, W, 3) uint8, truncated as the JAX
    command line's images are."""
    arr = color.detach().cpu().numpy() if torch.is_tensor(color) else np.asarray(color)
    return (np.clip(arr, 0, 1).transpose(1, 2, 0) * 255).astype(np.uint8)


def save_image(path: str, color) -> None:
    """(3, H, W) float image -> PNG (RGB; the reference's render.py wrote BGR
    through cv2)."""
    write_png(path, to_uint8(color))
