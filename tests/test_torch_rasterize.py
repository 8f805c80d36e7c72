"""The port's whole `rasterize` (plain blend on the CPU) against the JAX
package's: its jnp path, and its Pallas blend kernel in interpret mode."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussianmesh_tpu.ops.rasterize import RasterizerConfig as JaxConfig
from gaussianmesh_tpu.ops.rasterize import rasterize as jax_rasterize
from gaussianmesh_tpu_torch.ops.rasterize import RasterizerConfig, rasterize
from gaussianmesh_tpu_torch.utils.graphics import CameraArrays
from tests.scenes import look_at_camera, random_gaussians

torch.set_num_threads(2)

BG = np.array([0.15, 0.25, 0.35], np.float32)
COUNTERS = ("num_rendered", "tile_overflow", "rect_overflow", "pair_overflow")


def _t(x):
    return torch.tensor(np.asarray(x))


def _both(width, n, max_per_tile, pallas=False):
    cam = look_at_camera(width, width)
    sc = random_gaussians(n, seed=3)
    args = (sc["means3d"], sc["cov6"], sc["opacity"], sc["rgb"])
    jcfg = JaxConfig(width=width, height=width, max_per_tile=max_per_tile,
                     use_pallas=pallas)
    if pallas:
        # interpret-mode Pallas runs under disable_jit on the CPU
        from jax.experimental.pallas import tpu as pltpu
        with jax.disable_jit(), pltpu.force_tpu_interpret_mode():
            oj = jax_rasterize(*args, jnp.asarray(BG), cam, jcfg)
    else:
        oj = jax_rasterize(*args, jnp.asarray(BG), cam, jcfg)
    tcam = CameraArrays.from_numpy(*[np.asarray(x) for x in cam], device="cpu")
    ot = rasterize(*(_t(a) for a in args), _t(BG), tcam,
                   RasterizerConfig(width=width, height=width,
                                    max_per_tile=max_per_tile))
    return oj, ot


def test_matches_jax_jnp_path_64px():
    oj, ot = _both(64, 400, 256)
    np.testing.assert_allclose(ot.color.numpy(), np.asarray(oj.color), atol=3e-5)
    np.testing.assert_allclose(ot.final_t.numpy(), np.asarray(oj.final_t), atol=3e-5)
    np.testing.assert_array_equal(ot.n_contrib.numpy(),
                                  np.asarray(oj.n_contrib).astype(np.int32))
    for name in COUNTERS:
        assert int(getattr(ot, name)) == int(getattr(oj, name)), name
    np.testing.assert_array_equal(ot.radii.numpy(), np.asarray(oj.radii))
    np.testing.assert_array_equal(ot.visibility.numpy(), np.asarray(oj.visibility))
    np.testing.assert_allclose(ot.mean2d.numpy(), np.asarray(oj.mean2d),
                               rtol=1e-5, atol=1e-4)


def test_matches_jax_jnp_path_256px_overflow_clamped():
    """max_per_tile=64 clamps most tiles; ~1e-3 covers a borderline pair
    whose alpha rounds across the 1/255 gate (the binning and blend are
    otherwise identical)."""
    oj, ot = _both(256, 5000, 64)
    assert int(ot.tile_overflow) > 0
    for name in COUNTERS:
        assert int(getattr(ot, name)) == int(getattr(oj, name)), name
    d = np.abs(ot.color.numpy() - np.asarray(oj.color))
    assert d.max() <= 1e-3 and d.mean() <= 1e-5, (d.max(), d.mean())
    dt = np.abs(ot.final_t.numpy() - np.asarray(oj.final_t))
    assert dt.max() <= 1e-3


def test_matches_jax_pallas_kernel_interpret_64px():
    """Against the Pallas K1 itself (interpret mode): it evaluates power as
    a tile-local monomial contraction with no power > 0 guard, hence 3e-5
    and not bit equality."""
    oj, ot = _both(64, 400, 256, pallas=True)
    np.testing.assert_allclose(ot.color.numpy(), np.asarray(oj.color), atol=3e-5)
    np.testing.assert_allclose(ot.final_t.numpy(), np.asarray(oj.final_t), atol=3e-5)
    assert int(ot.num_rendered) == int(oj.num_rendered)
