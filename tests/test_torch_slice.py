"""The port's render slice end to end against the JAX package: the flagship
mesh-bound scene (`__graft_entry__`), perturbed to look trained, saved as
a PLY by the JAX package, loaded and rendered by the port."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from __graft_entry__ import _flagship_scene
from gaussianmesh_tpu.io import gaussian_ply as jply
from gaussianmesh_tpu.models import render as jrender
from gaussianmesh_tpu.ops.rasterize import RasterizerConfig as JaxConfig
from gaussianmesh_tpu_torch.io import gaussian_ply
from gaussianmesh_tpu_torch.models import render
from gaussianmesh_tpu_torch.ops.rasterize import RasterizerConfig
from gaussianmesh_tpu_torch.utils.graphics import CameraArrays

torch.set_num_threads(2)

W = H = 256
SH_DEGREE = 3
# 320 large splats at 256 px: ~32 pairs each, past the default capacities
CAPACITY = dict(max_per_tile=256, pair_capacity_per_gaussian=64,
                row_capacity_per_gaussian=16)


def _perturbed_flagship():
    p, b, _, cam = _flagship_scene(2, W, H)
    rng = np.random.default_rng(11)

    def jitter(x, scale, shift=0.0):
        x = np.asarray(x)
        return jnp.asarray((x + shift + rng.normal(0, scale, x.shape))
                           .astype(np.float32))

    p = p.replace(bc=jitter(p.bc, 0.5), distance=jitter(p.distance, 0.5),
                  scaling=jitter(p.scaling, 0.3),
                  rotation=jitter(p.rotation, 0.5),
                  opacity=jitter(p.opacity, 1.5, shift=2.5),
                  features_dc=jitter(p.features_dc, 0.2),
                  features_rest=jitter(p.features_rest, 0.1))
    return p, b, cam


def test_flagship_render_matches_jax(tmp_path):
    p, b, cam = _perturbed_flagship()
    bg = np.ones(3, np.float32)
    jcfg = JaxConfig(width=W, height=H, use_pallas=False, **CAPACITY)
    arrays = jrender.mesh_model_arrays(p, b, cam, sh_degree=SH_DEGREE)
    oj = jax.jit(lambda a, c: jrender.render(a, c, jcfg, jnp.asarray(bg)))(arrays, cam)

    path = str(tmp_path / "point_cloud.ply")
    jply.save_mesh_gaussian_ply(path, p, b)
    model, _ = gaussian_ply.load_mesh_gaussian_ply(path, device="cpu")
    tcam = CameraArrays.from_numpy(*[np.asarray(x) for x in cam], device="cpu")
    with torch.no_grad():
        ot = render.render(render.mesh_model_arrays(model, tcam, SH_DEGREE), tcam,
                           RasterizerConfig(width=W, height=H, **CAPACITY),
                           torch.tensor(bg))

    color = ot.color.numpy()
    assert color.shape == (3, H, W) and np.isfinite(color).all()
    assert (ot.final_t.numpy() < 0.5).mean() > 0.05  # the object is in view
    d = np.abs(color - np.asarray(oj.color))
    assert d.max() <= 1e-3 and d.mean() <= 1e-5, (d.max(), d.mean())
    for name in ("num_rendered", "tile_overflow", "rect_overflow"):
        assert int(getattr(ot, name)) == int(getattr(oj, name)), name
    assert int(ot.rect_overflow) == 0 and int(ot.tile_overflow) == 0
