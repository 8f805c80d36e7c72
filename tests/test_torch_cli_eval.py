"""The port's evaluation and dataset-tool command lines on the CPU:
`cli.full_eval --device cpu` trains, renders and evaluates a 64x48 JPEG
COLMAP scene and writes the JAX layout of results.json / per_view.json;
`normalize_info`, `convert_mesh` and `inspect_ply` give the JAX command
lines' outputs; `convert` stops with the JAX message where COLMAP is
missing."""

import json
import math
import os
import shutil

import numpy as np
import pytest
import torch

from gaussianmesh_tpu.cli import convert as jconvert, convert_mesh as jconvert_mesh
from gaussianmesh_tpu.cli import inspect_ply as jinspect_ply
from gaussianmesh_tpu.cli import normalize_info as jnormalize_info
from gaussianmesh_tpu.eval import metrics as jmetrics
from gaussianmesh_tpu.io import mesh as jmesh_io
from gaussianmesh_tpu_torch.cli import convert, convert_mesh, full_eval, inspect_ply
from gaussianmesh_tpu_torch.cli import metrics as cli_metrics, normalize_info
from gaussianmesh_tpu_torch.data.cameras import Camera
from gaussianmesh_tpu_torch.io import colmap, jpeg, mesh as mesh_io, png
from gaussianmesh_tpu_torch.models import mesh_gaussians as mgs
from gaussianmesh_tpu_torch.models import render as render_mod
from gaussianmesh_tpu_torch.ops.rasterize import RasterizerConfig
from gaussianmesh_tpu_torch.utils import graphics, sh as sh_utils
from tests.meshes import icosphere

torch.set_num_threads(2)

W, H = 64, 48
FOVX = math.radians(55)
N_VIEWS = 9                              # llffhold 8: views 0 and 8 are the test split


def _rotmat2qvec(R):
    """COLMAP's rotation matrix -> unit quaternion (w, x, y, z), w >= 0."""
    rxx, ryx, rzx, rxy, ryy, rzy, rxz, ryz, rzz = R.flat
    k = np.array([[rxx - ryy - rzz, 0, 0, 0], [ryx + rxy, ryy - rxx - rzz, 0, 0],
                  [rzx + rxz, rzy + ryz, rzz - rxx - ryy, 0],
                  [ryz - rzy, rzx - rxz, rxy - ryx, rxx + ryy + rzz]]) / 3.0
    vals, vecs = np.linalg.eigh(k)
    q = vecs[[3, 0, 1, 2], np.argmax(vals)]
    return q if q[0] >= 0 else -q


def _make_scene(root):
    """A COLMAP scene: an icosphere-2 teacher coloured by position rendered
    by the port over white from N_VIEWS orbit poses at 64x48, written as
    JPEGs (quality 90, 4:2:0) by `write_jpeg`, one PINHOLE camera, the
    teacher's centres as points3D. -> proxy mesh path."""
    v, f = icosphere(2)
    teacher = mgs.create_from_mesh(v, f, device="cpu")
    with torch.no_grad():
        cent = teacher.get_xyz()
        teacher.features_dc.copy_(sh_utils.rgb_to_sh(
            (cent / cent.abs().max() + 1.0) / 2.0)[:, None, :])
        teacher.opacity.fill_(4.0)
    fovy = graphics.focal2fov(graphics.fov2focal(FOVX, W), H)
    os.makedirs(os.path.join(root, "images"))
    images = {}
    for i in range(N_VIEWS):
        az, el = 2 * np.pi * i / N_VIEWS, 0.3 * np.sin(i * 1.7)
        pos = 3.2 * np.array([np.cos(el) * np.sin(az), np.sin(el), np.cos(el) * np.cos(az)])
        fwd = -pos / np.linalg.norm(pos)
        right = np.cross([0.0, 1.0, 0.0], fwd)
        right /= np.linalg.norm(right)
        R = np.stack([right, np.cross(fwd, right), fwd], axis=1)
        cam = Camera(uid=i, R=R, T=-R.T @ pos, fovx=FOVX, fovy=fovy, image=None,
                     width=W, height=H).arrays("cpu")
        with torch.no_grad():
            out = render_mod.render(render_mod.mesh_model_arrays(teacher, cam, 0), cam,
                                    RasterizerConfig(W, H, 256), torch.ones(3))
        name = f"{i:03d}.jpg"
        jpeg.write_jpeg(os.path.join(root, "images", name),
                        (out.color.clamp(0, 1) * 255).round().to(torch.uint8)
                        .permute(1, 2, 0).numpy())
        images[i + 1] = colmap.ColmapImage(i + 1, _rotmat2qvec(R.T), -R.T @ pos, 1, name)
    fx = graphics.fov2focal(FOVX, W)
    fy = graphics.fov2focal(fovy, H)
    cams = {1: colmap.ColmapCamera(1, "PINHOLE", W, H, np.array([fx, fy, W / 2, H / 2]))}
    with torch.no_grad():
        xyz = teacher.get_xyz().numpy().astype(np.float64)
    colmap.write_model_binary(os.path.join(root, "sparse", "0"), cams, images, xyz,
                              np.full((len(xyz), 3), 128.0), np.zeros(len(xyz)))
    mesh_path = os.path.join(root, "proxy.obj")
    mesh_io.write_triangle_mesh(mesh_path, *icosphere(1))
    return mesh_path


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("scenes"))
    mesh = _make_scene(os.path.join(base, "s"))
    return base, mesh


def test_full_eval_writes_the_jax_layout(scene_dir, tmp_path):
    """train_mesh (10 iterations, a shrunk initial subdivision passed on as a
    train_mesh flag) -> render --skip_train -> metrics, in one call on the
    CPU: the test views' gt PNGs are the JPEGs' bits, the renders finite
    images of the views' size, and results.json / per_view.json equal what
    the JAX metrics command line writes for the same directory (keys and
    values within 1e-5); `cli.metrics --lpips_uncalibrated` then adds
    LPIPS_uncalibrated with LPIPS still null."""
    base, mesh = scene_dir
    out = str(tmp_path / "out")
    full_eval.main(["--base", base, "--scenes", "s", "--meshes", mesh, "--output", out,
                    "--iterations", "10", "--device", "cpu", "--init_target", "300",
                    "--sh_degree", "1", "--max_per_tile", "256"])
    model = os.path.join(out, "s")
    method_dir = os.path.join(model, "test", "ours_10")
    names = sorted(os.listdir(os.path.join(method_dir, "gt")))
    assert names == ["00000.png", "00001.png"]
    for i, name in enumerate(names):
        gt = png.read_png(os.path.join(method_dir, "gt", name))
        src = jpeg.read_jpeg(os.path.join(base, "s", "images", f"{8 * i:03d}.jpg"))
        assert np.array_equal(gt, src), name
        assert png.read_png(os.path.join(method_dir, "renders", name)).shape == (H, W, 3)
    results = json.load(open(os.path.join(model, "results.json")))
    per_view = json.load(open(os.path.join(model, "per_view.json")))
    assert results["ours_10"]["LPIPS"] is None and "LPIPS_note" in results["ours_10"]
    assert math.isfinite(results["ours_10"]["PSNR"]) and 0 < results["ours_10"]["SSIM"] <= 1

    jmodel = str(tmp_path / "jax_model")
    shutil.copytree(os.path.join(model, "test"), os.path.join(jmodel, "test"))
    jmetrics.evaluate_model_paths([jmodel])
    jres = json.load(open(os.path.join(jmodel, "results.json")))
    jper = json.load(open(os.path.join(jmodel, "per_view.json")))
    assert results.keys() == jres.keys() and per_view.keys() == jper.keys()
    assert results["ours_10"].keys() == jres["ours_10"].keys()
    for k in ("PSNR", "SSIM"):
        assert abs(results["ours_10"][k] - jres["ours_10"][k]) <= 1e-5 * abs(jres["ours_10"][k])
    for name in jper["ours_10"]:
        assert per_view["ours_10"][name].keys() == jper["ours_10"][name].keys()

    cli_metrics.main(["-m", model, "--lpips_uncalibrated", "--device", "cpu"])
    again = json.load(open(os.path.join(model, "results.json")))["ours_10"]
    assert again["LPIPS"] is None and math.isfinite(again["LPIPS_uncalibrated"])
    assert again["PSNR"] == results["ours_10"]["PSNR"]


def test_normalize_info_matches_jax(scene_dir, tmp_path, capsys):
    base, _ = scene_dir
    mine, theirs = str(tmp_path / "port.json"), str(tmp_path / "jax.json")
    normalize_info.main(["-s", os.path.join(base, "s"), "--out", mine])
    jnormalize_info.main(["-s", os.path.join(base, "s"), "--out", theirs])
    a, b = json.load(open(mine)), json.load(open(theirs))
    assert a == b and a["scaling_factor"] > 0
    normalize_info.main(["-s", os.path.join(base, "s")])
    printed = capsys.readouterr().out
    assert json.loads(printed[printed.index("{"):]) == b


def test_convert_mesh_matches_jax(tmp_path):
    v, f = icosphere(2)
    src = str(tmp_path / "recon.obj")
    jmesh_io.write_triangle_mesh(src, v.astype(np.float32), f)
    m = np.eye(4)
    m[:3, :3] = np.linalg.qr(np.random.default_rng(0).normal(size=(3, 3)))[0]
    m[:3, 3] = [0.3, -1.2, 2.0]
    t = str(tmp_path / "t.json")
    json.dump({"transform_matrix": m.tolist(), "scaling_factor": 0.37}, open(t, "w"))
    for ext in (".obj", ".ply"):
        mine, theirs = str(tmp_path / f"port{ext}"), str(tmp_path / f"jax{ext}")
        convert_mesh.main(["--input", src, "--output", mine, "--transform", t])
        jconvert_mesh.main(["--input", src, "--output", theirs, "--transform", t])
        (va, fa), (vb, fb) = mesh_io.read_triangle_mesh(mine), jmesh_io.read_triangle_mesh(theirs)
        assert np.array_equal(va, vb) and np.array_equal(fa, fb)
    back = (va.astype(np.float64) @ m[:3, :3].T + m[:3, 3]) * 0.37
    np.testing.assert_allclose(back, v, atol=1e-5)


def test_inspect_ply_prints_as_jax(tmp_path, capsys):
    """The same report for one Gaussian PLY, and the same diff of two, line
    for line."""
    model = mgs.create_from_mesh(*icosphere(1), device="cpu")
    a, b = str(tmp_path / "a.ply"), str(tmp_path / "b.ply")
    from gaussianmesh_tpu_torch.io import gaussian_ply
    gaussian_ply.save_mesh_gaussian_ply(a, model)
    with torch.no_grad():
        model.opacity.add_(1e-3)
    gaussian_ply.save_mesh_gaussian_ply(b, model)
    for argv in ([a], [a, b], [a, b, "--atol", "1e-2"]):
        inspect_ply.main(argv)
        mine = capsys.readouterr().out
        jinspect_ply.main(argv)
        assert mine == capsys.readouterr().out, argv
    assert "DIFFER" in mine or "MATCH" in mine


def test_convert_without_colmap_exits_as_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))
    argv = ["-s", str(tmp_path), "--colmap_executable", "no-such-colmap"]
    with pytest.raises(SystemExit) as mine:
        convert.main(argv)
    with pytest.raises(SystemExit) as theirs:
        jconvert.main(argv)
    assert str(mine.value) == str(theirs.value) and "colmap binary not found" in str(
        mine.value)


def test_import_walk_covers_the_eval_slice():
    """`test_torch_import.py`'s walk of the package reaches every module of
    this slice."""
    from test_torch_import import _modules
    mods = set(_modules())
    for m in ("io.jpeg", "io.resample", "eval.lpips", "eval.metrics", "cli.metrics",
              "cli.full_eval", "cli.normalize_info", "cli.convert_mesh",
              "cli.inspect_ply", "cli.convert"):
        assert f"gaussianmesh_tpu_torch.{m}" in mods, m
