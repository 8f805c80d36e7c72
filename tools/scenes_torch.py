"""Synthetic scenes of the port's measurement tools, without JAX.

JAX-free copies of the JAX repository's scene helpers, for `bench_torch.py`,
`tools/profile_raster_torch.py` and `tools/bench_playback_torch.py`:

* `look_at_camera` and `random_gaussians` (`tests/scenes.py`);
* `icosphere` (`tests/meshes.py`);
* `twist_frames` and `make_object` (`tools/bench_playback.py`'s
  `_twist_frames` and `_make_object`).

Every random draw is numpy's `default_rng(seed)`, in the JAX helpers' order,
so each scene is the JAX tools' scene; the tensors land on the caller's
device.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from gaussianmesh_tpu_torch.utils import graphics, maths


def look_at_camera(width: int, height: int, fovx_deg: float = 60.0,
                   distance: float = 4.0, azimuth: float = 0.3,
                   elevation: float = 0.2, device="cuda") -> graphics.CameraArrays:
    """Camera orbiting the origin, the reference's matrix conventions."""
    fovx = math.radians(fovx_deg)
    fovy = graphics.focal2fov(graphics.fov2focal(fovx, width), height)
    cam_pos = distance * np.array([math.cos(elevation) * math.sin(azimuth),
                                   math.sin(elevation),
                                   math.cos(elevation) * math.cos(azimuth)])
    fwd = -cam_pos / np.linalg.norm(cam_pos)
    up = np.array([0.0, 1.0, 0.0])
    right = np.cross(up, fwd)
    right /= np.linalg.norm(right)
    up2 = np.cross(fwd, right)
    R = np.stack([right, up2, fwd], axis=1)      # cam-to-world rotation
    t = -R.T @ cam_pos                           # world-to-cam translation
    V = graphics.world_to_view(R, t)
    P = graphics.projection_matrix(0.01, 100.0, fovx, fovy)
    return graphics.CameraArrays.from_numpy(V, P @ V, cam_pos, math.tan(fovx / 2),
                                            math.tan(fovy / 2), device=device)


def random_gaussians(n: int, seed: int = 0, spread: float = 1.0,
                     scale_range=(0.02, 0.12), opacity_range=(0.2, 0.95),
                     device="cuda") -> dict[str, torch.Tensor]:
    """Random cloud near the origin -> {means3d, scales, quats, cov6,
    opacity, rgb} tensors."""
    rng = np.random.default_rng(seed)
    means = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    scales = rng.uniform(*scale_range, (n, 3)).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    opacity = rng.uniform(*opacity_range, (n,)).astype(np.float32)
    rgb = rng.uniform(0.05, 0.95, (n, 3)).astype(np.float32)
    out = {k: torch.tensor(x, device=device) for k, x in
           (("means3d", means), ("scales", scales), ("quats", quats),
            ("opacity", opacity), ("rgb", rgb))}
    out["cov6"] = maths.covariance_6(out["scales"], out["quats"])
    return out


def icosphere(subdiv: int = 1, radius: float = 1.0):
    """Icosahedron refined `subdiv` times -> (V (v, 3) f32, F (f, 3) i32)."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array([
        [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
        [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
        [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
    ], dtype=np.float64)
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.array([
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
    ], dtype=np.int64)

    for _ in range(subdiv):
        cache = {}
        verts = list(verts)

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in cache:
                m = (np.asarray(verts[a]) + np.asarray(verts[b])) / 2
                m /= np.linalg.norm(m)
                cache[key] = len(verts)
                verts.append(m)
            return cache[key]

        new_faces = []
        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        faces = np.asarray(new_faces)
        verts = np.asarray(verts)

    return (radius * np.asarray(verts)).astype(np.float32), faces.astype(np.int32)


def twist_frames(v: np.ndarray, n_frames: int, amp=0.6) -> np.ndarray:
    """A twist about z by amp * sin(2 pi i / n) * z, frames i < n ->
    (n, V, 3) f32."""
    out = []
    for i in range(n_frames):
        a = amp * np.sin(2 * np.pi * i / n_frames)
        ang = a * v[:, 2]
        c, s = np.cos(ang), np.sin(ang)
        out.append(np.stack([c * v[:, 0] - s * v[:, 1],
                             s * v[:, 0] + c * v[:, 1], v[:, 2]], axis=-1))
    return np.stack(out).astype(np.float32)


def make_object(tmp: str, level: int, name: str, offset=(0, 0, 0),
                opacity_logit=4.0, device="cuda"):
    """Synthetic trained-style object: one near-opaque Gaussian per face of
    an icosphere, coloured by its centroid, saved as <tmp>/<name>.ply +
    <name>.obj for the edit runtime's loaders -> (PLY path, OBJ path,
    vertices, faces)."""
    from gaussianmesh_tpu_torch.io import gaussian_ply, mesh as mesh_io
    from gaussianmesh_tpu_torch.models import mesh_gaussians as mgs
    from gaussianmesh_tpu_torch.utils import sh as sh_utils

    v, f = icosphere(level)
    v = v + np.asarray(offset, np.float32)
    n = f.shape[0]
    model = mgs.create_from_mesh(v, f, capacity=n, vertex_capacity=4 * n,
                                 device=device)
    with torch.no_grad():
        cent = model.get_xyz().cpu().numpy()
        cols = (cent - cent.min(0)) / (np.ptp(cent, 0) + 1e-6)
        model.features_dc.copy_(sh_utils.rgb_to_sh(
            torch.tensor(cols, device=device))[:, None, :])
        model.opacity.fill_(opacity_logit)
    ply = os.path.join(tmp, f"{name}.ply")
    obj = os.path.join(tmp, f"{name}.obj")
    gaussian_ply.save_mesh_gaussian_ply(ply, model)
    mesh_io.write_triangle_mesh(obj, v, f)
    return ply, obj, v, f
