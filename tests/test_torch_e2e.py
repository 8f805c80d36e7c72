"""The port's end-to-end script (`examples/synthetic_e2e_torch.sh`) on the CPU,
and the scene generator it imports. This file imports neither JAX nor the
JAX package nor an imaging package: the script runs it where none is
installed."""

import json
import math
import os
import subprocess

import numpy as np
import torch

from gaussianmesh_tpu_torch.data import readers
from gaussianmesh_tpu_torch.data.cameras import Camera
from gaussianmesh_tpu_torch.io import mesh as mesh_io, ply as ply_io, png
from gaussianmesh_tpu_torch.models import mesh_gaussians as mgs
from gaussianmesh_tpu_torch.models import render as render_mod
from gaussianmesh_tpu_torch.ops.rasterize import RasterizerConfig
from gaussianmesh_tpu_torch.utils import sh as sh_utils
# the script puts tests/ on sys.path, as pytest does
from meshes import icosphere

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W = H = 64
FOVX = math.radians(50)
MAX_PER_TILE = 256


def _orbit(i, n_cams):
    az, el = 2 * np.pi * i / n_cams, 0.3 * np.sin(i * 1.7)
    pos = 3.2 * np.array([np.cos(el) * np.sin(az), np.sin(el),
                          np.cos(el) * np.cos(az)])
    fwd = -pos / np.linalg.norm(pos)
    right = np.cross([0.0, 1.0, 0.0], fwd)
    right /= np.linalg.norm(right)
    return np.stack([right, np.cross(fwd, right), fwd], axis=1), pos


def make_dataset(root, n_cams=10, n_points=300):
    """A Blender-style scene, as `tests/test_cli_pipeline.py::_make_dataset`
    makes one, with the port alone (on the CPU): an icosphere-2 teacher
    colored by position, orbit views at 64 px written as RGBA PNGs (alpha =
    1 - final T), a points3d.ply (points on a shell around the object, a
    tenth on its surface) and an icosphere-1 proxy. -> proxy mesh path."""
    v, f = icosphere(2)
    teacher = mgs.create_from_mesh(v, f, device="cpu")
    with torch.no_grad():
        cent = teacher.get_xyz()
        teacher.features_dc.copy_(sh_utils.rgb_to_sh(
            (cent / cent.abs().max() + 1.0) / 2.0)[:, None, :])
        teacher.opacity.fill_(4.0)
    os.makedirs(os.path.join(root, "train"), exist_ok=True)
    frames = []
    for i in range(n_cams):
        R, pos = _orbit(i, n_cams)
        cam = Camera(uid=i, R=R, T=-R.T @ pos, fovx=FOVX, fovy=FOVX, image=None,
                     width=W, height=H).arrays("cpu")
        with torch.no_grad():
            out = render_mod.render(render_mod.mesh_model_arrays(teacher, cam, 0),
                                    cam, RasterizerConfig(W, H, MAX_PER_TILE),
                                    torch.zeros(3))
        rgba = torch.cat([out.color, 1.0 - out.final_t[None]]).clamp(0, 1)
        png.write_png(os.path.join(root, "train", f"r_{i}.png"),
                      (rgba.numpy().transpose(1, 2, 0) * 255).astype(np.uint8))
        c2w = np.eye(4)
        c2w[:3, :3], c2w[:3, 3] = R, pos
        c2w[:3, 1:3] *= -1  # COLMAP -> OpenGL (the reader undoes this)
        frames.append({"file_path": f"train/r_{i}", "transform_matrix": c2w.tolist()})
    for split, fr in (("train", frames), ("test", frames[:2])):
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as fh:
            json.dump({"camera_angle_x": FOVX, "frames": fr}, fh)

    rng = np.random.default_rng(3)
    d = rng.normal(size=(n_points, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    r = np.where(np.arange(n_points) < n_points // 10, 1.0,
                 rng.uniform(1.5, 2.5, n_points))
    pts = (d * r[:, None]).astype(np.float32)
    rgb = rng.integers(0, 256, (n_points, 3)).astype(np.uint8)
    ply_io.write_ply(os.path.join(root, "points3d.ply"), {"vertex": {
        "x": pts[:, 0], "y": pts[:, 1], "z": pts[:, 2],
        "red": rgb[:, 0], "green": rgb[:, 1], "blue": rgb[:, 2]}})
    mesh_path = os.path.join(root, "proxy.obj")
    mesh_io.write_triangle_mesh(mesh_path, *icosphere(1))
    return mesh_path


def test_make_dataset_reads_back(tmp_path):
    """The port's Blender reader takes the scene: 10 train views and 2 test
    views (the first two train views), RGBA composited over white, points."""
    root = str(tmp_path / "scene")
    proxy = make_dataset(root, n_cams=10)
    assert mesh_io.read_triangle_mesh(proxy)[1].shape == (80, 3)
    info = readers.read_scene(root, "images", white_background=True, eval_split=True)
    assert len(info.train_cameras) == 10 and len(info.test_cameras) == 2
    img = png.read_png(os.path.join(root, "train", "r_3.png"))
    assert img.shape == (H, W, 4) and img[..., 3].max() > 200 and img[..., 3].min() == 0
    assert len(info.point_cloud.points) == 300


def test_synthetic_e2e_script(tmp_path):
    """`GM_DEVICE=cpu bash examples/synthetic_e2e_torch.sh` runs the four
    command lines: the renders, results.json and 8 orbit frames exist. 40
    iterations (densify at 20 is past the window's end: none fires) keep it
    short on the CPU, where the plain blend walks each tile in Python."""
    work = tmp_path / "e2e"
    env = {**os.environ, "GM_DEVICE": "cpu", "GM_E2E_ITERATIONS": "40",
           "OMP_NUM_THREADS": "2"}
    proc = subprocess.run(["bash", os.path.join(ROOT, "examples",
                                                "synthetic_e2e_torch.sh"), str(work)],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "E2E OK" in proc.stdout
    model = work / "model"
    renders = sorted((model / "test" / "ours_40" / "renders").iterdir())
    assert [p.name for p in renders] == ["00000.png", "00001.png"]
    results = json.loads((model / "results.json").read_text())
    psnr = results["ours_40"]["PSNR"]
    assert math.isfinite(psnr) and psnr > 10.0, results
    frames = sorted(p.name for p in (work / "edit_out").iterdir())
    assert frames == [f"f0000_c{i:03d}.png" for i in range(8)]
    assert png.read_png(str(work / "edit_out" / frames[0])).shape == (H, W, 3)
