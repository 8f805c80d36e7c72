"""CUDA kernels of the port against their plain PyTorch versions, on the
card. Skipped where no CUDA device is present. This file imports neither
JAX nor the JAX package, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import math

import numpy as np
import pytest
import torch

from gaussianmesh_tpu_torch.ops import binning, preprocess, tile_blend
from gaussianmesh_tpu_torch.ops.rasterize import RasterizerConfig, rasterize
from gaussianmesh_tpu_torch.utils import graphics, maths
from gaussianmesh_tpu_torch.utils.graphics import CameraArrays


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the H100 run of the port)")
    return torch.device("cuda")


def _camera(width, height, device, distance=4.0, azimuth=0.3):
    fovx = math.radians(60.0)
    fovy = graphics.focal2fov(graphics.fov2focal(fovx, width), height)
    pos = distance * np.array([math.cos(0.2) * math.sin(azimuth), math.sin(0.2),
                               math.cos(0.2) * math.cos(azimuth)])
    fwd = -pos / np.linalg.norm(pos)
    right = np.cross([0.0, 1.0, 0.0], fwd)
    right /= np.linalg.norm(right)
    R = np.stack([right, np.cross(fwd, right), fwd], axis=1)
    V = graphics.world_to_view(R, -R.T @ pos)
    P = graphics.projection_matrix(0.01, 100.0, fovx, fovy)
    return CameraArrays.from_numpy(V, P @ V, pos, math.tan(fovx / 2),
                                   math.tan(fovy / 2), device=device)


def _scene(n, device, seed=3):
    rng = np.random.default_rng(seed)
    means = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    scales = rng.uniform(0.02, 0.12, (n, 3)).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    t = {k: torch.tensor(x, device=device) for k, x in
         dict(means=means, scales=scales, quats=quats,
              opacity=rng.uniform(0.2, 0.95, n).astype(np.float32),
              rgb=rng.uniform(0.05, 0.95, (n, 3)).astype(np.float32)).items()}
    t["cov6"] = maths.covariance_6(t["scales"], maths.normalize(t["quats"]))
    return t


@pytest.mark.cuda
@pytest.mark.parametrize("max_per_tile", [1024, 64])
def test_k1_matches_plain(cuda, max_per_tile):
    width = height = 256
    sc = _scene(5000, cuda)
    cam = _camera(width, height, cuda)
    gx, gy = preprocess.tile_grid(width, height)
    prep = preprocess.preprocess(sc["means"], sc["cov6"], cam, width, height,
                                 opacity=sc["opacity"])
    tiles = binning.build_tile_lists(prep, gx, gy, max_per_tile, 50000,
                                     opacity=sc["opacity"], row_capacity=20000)
    assert (int(tiles.tile_overflow) > 0) == (max_per_tile == 64)
    feat = tile_blend.pack_features(prep.mean2d, prep.conic, sc["opacity"],
                                    sc["rgb"], prep.valid)
    args = (feat, tiles.sorted_gid, tiles.starts, tiles.counts, gx, width, height)
    before = tile_blend.blend_forward.launches
    color, final_t, n_contrib = tile_blend.blend_forward(*args)
    torch.cuda.synchronize()
    assert tile_blend.blend_forward.launches == before + 1
    pc, pt, pn = tile_blend.blend_forward_plain(*args)
    # same operation order, no FMA contraction, same expf: equal to rounding
    torch.testing.assert_close(color, pc, atol=1e-6, rtol=0)
    torch.testing.assert_close(final_t, pt, atol=1e-6, rtol=0)
    assert (n_contrib == pn).float().mean().item() >= 0.999


@pytest.mark.cuda
def test_rasterize_on_cuda_matches_cpu(cuda):
    """The whole forward on the card against the plain path on the CPU;
    1e-3 covers a pair whose alpha the two devices' exp rounds across the
    1/255 gate."""
    width, height = 256, 200   # 200 % 16 != 0: a partial last tile row
    sc = _scene(5000, cuda, seed=5)
    bg = torch.tensor([0.1, 0.2, 0.3], device=cuda)
    cfg = RasterizerConfig(width=width, height=height, max_per_tile=1024)
    out = rasterize(sc["means"], sc["cov6"], sc["opacity"], sc["rgb"], bg,
                    _camera(width, height, cuda), cfg)
    ref = rasterize(*(sc[k].cpu() for k in ("means", "cov6", "opacity", "rgb")),
                    bg.cpu(), _camera(width, height, "cpu"), cfg)
    d = (out.color.cpu() - ref.color).abs()
    assert d.max().item() <= 1e-3 and d.mean().item() <= 1e-5
    assert int(out.num_rendered) == int(ref.num_rendered)
    with pytest.raises(NotImplementedError):
        rasterize(sc["means"], sc["cov6"], sc["opacity"].requires_grad_(),
                  sc["rgb"], bg, _camera(width, height, cuda), cfg)
