"""The port's edit command line (`gaussianmesh_tpu_torch.cli.edit`) and config
reflection on a model directory written by the JAX package, on the CPU."""

import argparse
import dataclasses
import json

import numpy as np
import pytest
import torch

from gaussianmesh_tpu import config as jconfig
from gaussianmesh_tpu.data import cameras as jcameras
from gaussianmesh_tpu.edit import pose_paths as jpose
from gaussianmesh_tpu.io import mesh as jmesh
from gaussianmesh_tpu_torch import config
from gaussianmesh_tpu_torch.cli import common, edit
from gaussianmesh_tpu_torch.edit import runtime
from gaussianmesh_tpu_torch.ops.rasterize import RasterizerConfig
# pytest puts tests/ on sys.path
from test_torch_edit import jax_object, twist

torch.set_num_threads(2)


def _jax_groups(**runtime_kw):
    """The JAX package's four groups, TPU-only runtime fields included."""
    return {"model": jconfig.ModelParams(sh_degree=3),
            "pipeline": jconfig.PipelineParams(),
            "optimization": jconfig.OptimizationParams(),
            "runtime": jconfig.RuntimeParams(**runtime_kw)}


@pytest.fixture
def model_dir(tmp_path):
    """A model directory as the JAX package writes one: the object's PLY and
    origin mesh, two deformed meshes, cameras.json (one 96x64 camera) and
    cfg_args.json."""
    ply, origin, v, f = jax_object(tmp_path)
    meshes = []
    for i, amp in enumerate((0.4, -0.6)):
        path = str(tmp_path / f"frame{i}.obj")
        jmesh.write_triangle_mesh(path, twist(v, amp), f)
        meshes.append(path)
    cams = jpose.ellipse_path(3, np.zeros(3), (3.5, 3.5), 0.8, 1.0, 0.7, 96, 64)
    (tmp_path / "cameras.json").write_text(json.dumps(
        [jcameras.camera_to_json(i, c) for i, c in enumerate(cams)]))
    groups = _jax_groups(max_per_tile=512, blend_chunk=256, use_pallas=False,
                         data_axis=2, tile_axis=2, shard_gaussians=4)
    groups["model"] = dataclasses.replace(groups["model"], model_path=str(tmp_path))
    jconfig.save_cfg(str(tmp_path), groups)
    return tmp_path, ply, origin, meshes


def test_cli_edit_writes_the_editor_frames(model_dir, capsys):
    """`--device cpu` plays two meshes from camera 1: one PNG per frame,
    decoding to the port's `SceneEditor.render` of that mesh, quantised."""
    root, ply, origin, meshes = model_dir
    out = root / "out"
    edit.main(["-m", str(root), "--gaussian_ply", ply, "--origin_mesh", origin,
               "--frames", *meshes, "--camera_index", "1", "--out", str(out),
               "--device", "cpu"])
    assert "2 frames" in capsys.readouterr().out
    editor = runtime.SceneEditor(device="cpu")
    editor.add_object(ply, origin, name="object")
    cam = runtime.SceneEditor.cameras_from_json(str(root))[1]
    cfg = RasterizerConfig(cam.width, cam.height, max_per_tile=512)
    for i, mesh_path in enumerate(meshes):
        img = common.read_png(str(out / f"f{i:04d}_c000.png"))
        editor.deform_object("object", mesh_path)
        want = common.to_uint8(editor.render(cam, cfg).color)
        assert img.shape == (64, 96, 3) and np.array_equal(img, want)
        assert want.max() > 50                             # the object is in view
    assert sorted(p.name for p in out.iterdir()) == ["f0000_c000.png",
                                                     "f0001_c000.png"]


def test_cli_edit_runs_on_cuda_by_default(model_dir, monkeypatch):
    """No --device means CUDA: without a card the command raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    root, ply, origin, meshes = model_dir
    with pytest.raises(RuntimeError, match="CUDA"):
        edit.main(["-m", str(root), "--gaussian_ply", ply, "--origin_mesh",
                   origin, "--deformed_mesh", meshes[0], "--out",
                   str(root / "out")])


def test_load_combined_reads_a_jax_cfg(model_dir):
    """The JAX package's cfg_args.json loads with its TPU-only keys skipped
    (the process-mesh axes and the shard count are the port's too); the
    command line overrides it; an unknown key raises."""
    root = str(model_dir[0])
    parser = common.base_parser("test")
    groups = config.load_combined(root, parser.parse_args(["--sh_degree", "2"]))
    assert groups["model"].sh_degree == 2 and groups["model"].model_path == root
    assert groups["runtime"] == config.RuntimeParams(max_per_tile=512, data_axis=2,
                                                     tile_axis=2, shard_gaussians=4)
    assert groups["optimization"] == config.OptimizationParams()
    args = parser.parse_args(["--no-white_background", "-m", "x", "--device", "cpu"])
    assert config.extract(config.ModelParams, args) == config.ModelParams(
        white_background=False, model_path="x")
    blob = config.load_cfg(root)
    blob["runtime"]["not_a_field"] = 1
    (model_dir[0] / "cfg_args.json").write_text(json.dumps(blob))
    with pytest.raises(TypeError):
        config.load_combined(root, argparse.Namespace())


def test_png_round_trip(tmp_path):
    img = np.random.default_rng(0).integers(0, 256, (17, 23, 3), dtype=np.uint8)
    path = str(tmp_path / "sub" / "x.png")
    common.write_png(path, img)
    assert np.array_equal(common.read_png(path), img)
    color = torch.tensor(np.random.default_rng(1).uniform(-0.2, 1.2, (3, 5, 7)),
                         dtype=torch.float32)
    common.save_image(path, color)
    want = (np.clip(color.numpy(), 0, 1).transpose(1, 2, 0) * 255).astype(np.uint8)
    assert np.array_equal(common.read_png(path), want)


def test_import_walk_covers_edit_and_cli():
    """`test_torch_import.py`'s walk of the package reaches the edit and
    command-line modules."""
    from test_torch_import import _modules
    mods = set(_modules())
    for m in ("edit.deform", "edit.runtime", "edit.pose_paths", "cli.common",
              "cli.edit", "config", "data.cameras", "ops.rasterize"):
        assert f"gaussianmesh_tpu_torch.{m}" in mods, m
