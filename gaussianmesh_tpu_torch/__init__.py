"""gaussianmesh_tpu_torch — mesh-bound 3D Gaussian splatting on PyTorch + CUDA.

The PyTorch port of `gaussianmesh_tpu` (the JAX package beside it, which
stays the reference). Module for module it mirrors the JAX tree (`ops/`,
`models/`, `io/`, `utils/`); plain tensor code is PyTorch, and each Pallas
kernel of the JAX package becomes a kernel written by hand for Hopper
(`csrc/`, built at first use by `ops/_cuda.py`). Every kernel keeps a plain
PyTorch version beside it, which runs for CPU tensors; CUDA tensors go to
the kernel or raise.

This package never imports `jax` or `gaussianmesh_tpu`.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"

# Geometry (projection, KNN distances) needs true f32 matmuls: TF32 keeps
# ~3 decimal digits. This is PyTorch's default; the JAX package pins the
# same ("jax_default_matmul_precision" = highest). cuDNN convolutions
# (SSIM's grouped blurs) default to TF32 on the card: off as well.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    the CPU. Raises when CUDA is asked for (or implied) and no card is
    present — there is no silent fallback to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "gaussianmesh_tpu_torch runs on CUDA by default and no CUDA "
            "device is available; pass device='cpu' to run on the CPU")
    return dev
