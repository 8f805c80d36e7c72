"""Whole-training-state checkpoints (port of the single-file half of
`gaussianmesh_tpu/utils/checkpoint.py`; the reference saved a tuple with
jt.save at --checkpoint_iterations, train_mesh_gaussian.py:133-135).

A checkpoint is `torch.save` of a trainer's `capture()`: a host tree of
plain dicts, CPU tensors and ints (the generator state is a uint8
tensor), read back with `torch.load(..., weights_only=True)`, which accepts
nothing else. Per-rank checkpoints of the multi-device trainer (the JAX
package's orbax flavour) come with the multi-device slice.
"""

from __future__ import annotations

import os

import torch


def save_checkpoint(path: str, tree: dict) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save(tree, path)


def load_checkpoint(path: str) -> dict:
    return torch.load(path, map_location="cpu", weights_only=True)
