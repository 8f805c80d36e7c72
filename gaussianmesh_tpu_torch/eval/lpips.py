"""LPIPS with a VGG16 backbone (port of `gaussianmesh_tpu/eval/lpips.py`;
the reference's lpips_jittor/lpips.py:44-188).

The same graph: the input in [0, 1] mapped to [-1, 1], then shifted and
scaled per channel (the documented `normalize=True` path, lpips.py:142-145)
-> VGG16 conv slices (relu1_2, relu2_2, relu3_3, relu4_3, relu5_3, 2x2
max pools between blocks) -> each layer's channels divided by their norm
+ 1e-10 -> squared difference -> 1x1 `lin` weights -> spatial mean -> sum
over layers. The convolutions are cuDNN's on the card (the package turns
TF32 off).

The pretrained weights are not in the repository: an .npz in the JAX
package's layout (`convN_w` (O, I, 3, 3), `convN_b`, `linL_w` (1, C, 1, 1))
is read from `GM_TPU_LPIPS_WEIGHTS`, else from `weights/lpips_vgg16.npz`
under the repository root. `convert_torch_weights` writes one from a
torchvision VGG16 state dict and the LPIPS lins. Without them, the
metric reports LPIPS as missing; `random_weights(0)` draws the JAX
package's seed weights, for the graph reported as `LPIPS_uncalibrated`.
"""

from __future__ import annotations

import os
import pathlib

import numpy as np
import torch
import torch.nn.functional as F

from gaussianmesh_tpu_torch import resolve_device

# channels per VGG16 block and its conv layers before each max pool
_VGG_CFG = [(64, 2), (128, 2), (256, 3), (512, 3), (512, 3)]
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)
_REPO_ROOT = pathlib.Path(__file__).resolve().parents[2]


def default_weights_path() -> str:
    """`GM_TPU_LPIPS_WEIGHTS`, else weights/lpips_vgg16.npz under the
    repository root."""
    return os.environ.get("GM_TPU_LPIPS_WEIGHTS",
                          str(_REPO_ROOT / "weights" / "lpips_vgg16.npz"))


def load_weights(path: str | None = None) -> dict | None:
    """The .npz's arrays, or None where the file does not exist."""
    path = path or default_weights_path()
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def random_weights(seed: int = 0) -> dict:
    """Seed weights (the graph only; not perceptual): the JAX package's
    draws, in its numpy generator order."""
    rng = np.random.default_rng(seed)
    w, idx, in_ch = {}, 0, 3
    for li, (ch, n_convs) in enumerate(_VGG_CFG):
        for _ in range(n_convs):
            w[f"conv{idx}_w"] = rng.normal(scale=0.05, size=(ch, in_ch, 3, 3)).astype(
                np.float32)
            w[f"conv{idx}_b"] = np.zeros(ch, np.float32)
            in_ch = ch
            idx += 1
        w[f"lin{li}_w"] = rng.uniform(0, 0.1, (1, ch, 1, 1)).astype(np.float32)
    return w


def convert_torch_weights(vgg_state_dict, lin_state_dict, out_path: str) -> None:
    """torchvision vgg16.features + LPIPS lins -> the .npz layout."""
    out = {}
    # numeric sort on the layer index: a lexicographic one puts features.10
    # before features.2 and scrambles every conv
    conv_keys = sorted((k for k in vgg_state_dict if k.endswith(".weight")
                        and "features" in k),
                       key=lambda k: int(k.split("features.")[-1].split(".")[0]))
    for idx, k in enumerate(conv_keys):
        out[f"conv{idx}_w"] = np.asarray(vgg_state_dict[k])
        out[f"conv{idx}_b"] = np.asarray(vgg_state_dict[k.replace(".weight", ".bias")])
    for li in range(5):
        out[f"lin{li}_w"] = np.asarray(lin_state_dict[f"lin{li}.model.1.weight"])
    np.savez(out_path, **out)


class LPIPSNet(torch.nn.Module):
    """The LPIPS graph over given weights: forward(img1, img2), each (3, H, W)
    in [0, 1] -> the distance (0-d tensor)."""

    def __init__(self, weights: dict):
        super().__init__()
        for k, v in weights.items():
            self.register_buffer(k, torch.as_tensor(np.asarray(v, np.float32)))
        self.register_buffer("shift", torch.from_numpy(_SHIFT)[:, None, None])
        self.register_buffer("scale", torch.from_numpy(_SCALE)[:, None, None])

    def _features(self, x):
        feats, idx = [], 0
        for block, (_, n_convs) in enumerate(_VGG_CFG):
            for _ in range(n_convs):
                x = F.relu(F.conv2d(x, getattr(self, f"conv{idx}_w"),
                                    getattr(self, f"conv{idx}_b"), padding=1))
                idx += 1
            feats.append(x)
            if block < len(_VGG_CFG) - 1:
                x = F.max_pool2d(x, 2, 2)
        return feats

    def forward(self, img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
        prep = lambda im: ((im * 2.0 - 1.0 - self.shift) / self.scale)[None]  # noqa: E731
        total = torch.zeros((), device=img1.device)
        for li, (a, b) in enumerate(zip(self._features(prep(img1)),
                                        self._features(prep(img2)))):
            # norm + eps, not max(norm, eps): the reference's normalize_tensor
            a = a / (torch.linalg.vector_norm(a, dim=1, keepdim=True) + 1e-10)
            b = b / (torch.linalg.vector_norm(b, dim=1, keepdim=True) + 1e-10)
            total = total + torch.mean(torch.sum((a - b) ** 2 * getattr(self, f"lin{li}_w"),
                                                 dim=1))
        return total


class LPIPS:
    """lpips_jittor.LPIPS(net='vgg') as the metric calls it: the pretrained
    weights if found; with `uncalibrated=True` and none found, the seed
    weights, whose distances are reported as `LPIPS_uncalibrated` and never
    as LPIPS. Runs on CUDA unless `device` says otherwise."""

    def __init__(self, weights_path: str | None = None, uncalibrated: bool = False,
                 device=None):
        weights = load_weights(weights_path)
        self.calibrated = weights is not None
        if weights is None and uncalibrated:
            weights = random_weights(seed=0)
        self.device = resolve_device(device)
        self.net = None if weights is None else LPIPSNet(weights).to(self.device)

    @property
    def available(self) -> bool:
        return self.net is not None

    @torch.no_grad()
    def __call__(self, img1, img2) -> float:
        if not self.available:
            raise RuntimeError("LPIPS weights not found; provide lpips_vgg16.npz (see "
                               "gaussianmesh_tpu_torch/eval/lpips.py)")
        as_t = lambda im: torch.as_tensor(im, dtype=torch.float32, device=self.device)  # noqa: E731
        return float(self.net(as_t(img1), as_t(img2)))
