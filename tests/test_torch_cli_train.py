"""The port's training command lines on the CPU: `cli.train_mesh` ->
`cli.train_bg` -> `cli.render --with_bg` on a 64 px Blender scene, model
directories crossing between the two packages, and checkpoints: a resumed
run ends with the bits of the run that never stopped, and a capture is a
snapshot."""

import json
import math
import os
import sys

import imageio.v2 as imageio
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussianmesh_tpu import config as jconfig
from gaussianmesh_tpu.cli import render as jcli_render
from gaussianmesh_tpu.io import gaussian_ply as jgaussian_ply
from gaussianmesh_tpu.io import mesh as jmesh_io, ply as jply_io
from gaussianmesh_tpu.models import gaussians as jgs
from gaussianmesh_tpu.models import mesh_gaussians as jmgs
from gaussianmesh_tpu.models import render as jrender
from gaussianmesh_tpu.ops.preprocess import CameraArrays as JCameraArrays
from gaussianmesh_tpu.ops.rasterize import RasterizerConfig as JRasterizerConfig
from gaussianmesh_tpu.scene import Scene as JScene
from gaussianmesh_tpu_torch.cli import common, render as cli_render
from gaussianmesh_tpu_torch.cli import train_bg, train_mesh
from gaussianmesh_tpu_torch.config import ModelParams, OptimizationParams, RuntimeParams
from gaussianmesh_tpu_torch.data.cameras import Camera, camera_from_json
from gaussianmesh_tpu_torch.io import gaussian_ply, mesh as mesh_io
from gaussianmesh_tpu_torch.models import mesh_gaussians as mgs
from gaussianmesh_tpu_torch.models import render as render_mod
from gaussianmesh_tpu_torch.ops.rasterize import RasterizerConfig
from gaussianmesh_tpu_torch.scene import Scene
from gaussianmesh_tpu_torch.train.trainer import DeviceDataset, MeshTrainer, copy_tree
from gaussianmesh_tpu_torch.utils import sh as sh_utils
from gaussianmesh_tpu_torch.utils.logging import StepTimer, TrainLogger, profile_trace
from tests.meshes import icosphere

torch.set_num_threads(2)

W = H = 64
FOVX = math.radians(50)
MAX_PER_TILE = 256


def _make_dataset(root, n_cams=10, n_points=300):
    """A Blender-style scene as `tests/test_cli_pipeline.py::_make_dataset`
    makes one (an icosphere-2 teacher colored by position, orbit views at
    64 px), rendered by the port and written as RGBA through imageio
    (alpha = 1 - final T), with a points3d.ply: points on a shell around
    the object, a tenth of them on its surface. -> proxy mesh path."""
    v, f = icosphere(2)
    teacher = mgs.create_from_mesh(v, f, device="cpu")
    with torch.no_grad():
        cent = teacher.get_xyz()
        teacher.features_dc.copy_(sh_utils.rgb_to_sh(
            (cent / cent.abs().max() + 1.0) / 2.0)[:, None, :])
        teacher.opacity.fill_(4.0)
    os.makedirs(os.path.join(root, "train"))
    frames = []
    for i in range(n_cams):
        az, el = 2 * np.pi * i / n_cams, 0.3 * np.sin(i * 1.7)
        pos = 3.2 * np.array([np.cos(el) * np.sin(az), np.sin(el),
                              np.cos(el) * np.cos(az)])
        fwd = -pos / np.linalg.norm(pos)
        right = np.cross([0.0, 1.0, 0.0], fwd)
        right /= np.linalg.norm(right)
        R = np.stack([right, np.cross(fwd, right), fwd], axis=1)
        cam = Camera(uid=i, R=R, T=-R.T @ pos, fovx=FOVX, fovy=FOVX, image=None,
                     width=W, height=H).arrays("cpu")
        with torch.no_grad():
            out = render_mod.render(render_mod.mesh_model_arrays(teacher, cam, 0), cam,
                                    RasterizerConfig(W, H, MAX_PER_TILE),
                                    torch.zeros(3))
        rgba = torch.cat([out.color, 1.0 - out.final_t[None]]).clamp(0, 1)
        imageio.imwrite(os.path.join(root, "train", f"r_{i}.png"),
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
    jply_io.write_ply(os.path.join(root, "points3d.ply"), {"vertex": {
        "x": pts[:, 0], "y": pts[:, 1], "z": pts[:, 2],
        "red": rgb[:, 0], "green": rgb[:, 1], "blue": rgb[:, 2]}})
    mesh_path = os.path.join(root, "proxy.obj")
    jmesh_io.write_triangle_mesh(mesh_path, *icosphere(1))
    return mesh_path


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("data"))
    return root, _make_dataset(root)


def _train_flags(data, model, mesh_path, *extra):
    return ["-s", data, "-m", model, "--input_mesh", mesh_path, "--eval",
            "--init_target", "300", "--sh_degree", "1",
            "--max_per_tile", str(MAX_PER_TILE), "--densify_from_iter", "10",
            "--densification_interval", "10", "--densify_until_iter", "30",
            "--opacity_reset_interval", "20", "--device", "cpu", *extra]


def _renders(model_dir, it, n=2):
    return [common.read_png(os.path.join(model_dir, "test", f"ours_{it}", "renders",
                                         f"{i:05d}.png")) for i in range(n)]


def _float_renders(model_dir, it, sh_degree):
    """The first test view (cameras.json lists the test views last) of the
    iteration's foreground + background PLYs, rendered by each package
    from the same files -> (port, jax) (3, H, W) floats."""
    entries = json.load(open(os.path.join(model_dir, "cameras.json")))
    cam = camera_from_json(entries[-2]).arrays("cpu")
    pc = os.path.join(model_dir, "point_cloud", f"iteration_{it}")
    fg_ply, bg_ply = (os.path.join(pc, n) for n in ("point_cloud.ply",
                                                      "bg_point_cloud.ply"))
    fg, _ = gaussian_ply.load_mesh_gaussian_ply(fg_ply, device="cpu")
    bg = gaussian_ply.load_gaussian_ply(bg_ply, device="cpu")
    with torch.no_grad():
        a = render_mod.concat_arrays(render_mod.mesh_model_arrays(fg, cam, sh_degree),
                                     render_mod.gaussian_model_arrays(bg, cam,
                                                                      sh_degree))
        port = render_mod.render(a, cam, RasterizerConfig(W, H, MAX_PER_TILE),
                                 torch.ones(3)).color.numpy()
    jp, jb, _ = jgaussian_ply.load_mesh_gaussian_ply(fg_ply)
    bp, balive = jgaussian_ply.load_gaussian_ply(bg_ply)
    jcam = JCameraArrays(*(jnp.asarray(x.numpy()) for x in cam))
    ja = jrender.concat_arrays(jrender.mesh_model_arrays(jp, jb, jcam, sh_degree),
                               jrender.gaussian_model_arrays(bp, balive, jcam, sh_degree))
    jcfg = JRasterizerConfig(width=W, height=H, max_per_tile=MAX_PER_TILE,
                             use_pallas=False)
    return port, np.asarray(jrender.render(ja, jcam, jcfg, jnp.ones(3)).color)


def test_train_mesh_train_bg_render_with_bg(data_dir, tmp_path):
    """The three command lines with --device cpu. The --with_bg PNGs equal
    the port's render of the saved PLYs after uint8; the JAX command line
    renders the port's model directory to within one level, and the two
    packages' float renders of its PLYs agree to 3e-5. A run started from
    the iteration-20 checkpoint ends with the uninterrupted run's bits."""
    data, mesh_path = data_dir
    model = str(tmp_path / "model")
    tr = train_mesh.main(_train_flags(data, model, mesh_path, "--iterations", "40",
                                      "--save_iterations", "40", "--test_iterations",
                                      "40", "--checkpoint_iterations", "20"))
    for name in ("cfg_args.json", "cameras.json", "input.ply", "chkpnt20.ckpt",
                 "point_cloud/iteration_40/point_cloud.ply",
                 "point_cloud/iteration_40/split_mesh.obj"):
        assert os.path.exists(os.path.join(model, name)), name
    assert [(it, kind) for it, kind, _ in tr.events] == [
        (10, "opacity_reset"), (20, "densify"), (20, "opacity_reset")]
    assert jconfig.load_combined(model, jconfig.argparse.Namespace())["model"].eval

    resumed = train_mesh.main(_train_flags(
        data, str(tmp_path / "resumed"), mesh_path, "--iterations", "40",
        "--save_iterations", "40", "--start_checkpoint",
        os.path.join(model, "chkpnt20.ckpt")))
    assert resumed.global_it == tr.global_it == 40
    for name, p in tr.model.params().items():
        assert torch.equal(getattr(resumed.model, name), p), name
    for name in mgs.PARAM_FIELDS:
        assert torch.equal(resumed.adam.mu[name], tr.adam.mu[name]), name
        assert torch.equal(resumed.adam.nu[name], tr.adam.nu[name]), name

    bg = train_bg.main(["-m", model, "--iterations", "40", "--save_iterations", "40",
                        "--remove_neighbor_gaussian_iterations", "10",
                        "--capacity", "4096", "--device", "cpu"])
    assert bg.model.capacity == 4096 and bg.global_it == 40
    (it, kind, info), = [e for e in bg.events if e[1] == "prune_near_mesh"]
    assert it == 10 and info["n_retired"] >= 1, info
    assert os.path.exists(os.path.join(model, "point_cloud/iteration_40/"
                                              "bg_point_cloud.ply"))

    cli_render.main(["-m", model, "--with_bg", "--skip_train", "--device", "cpu"])
    port_pngs = _renders(model, 40)
    gt = common.read_png(os.path.join(model, "test", "ours_40", "gt", "00000.png"))
    assert gt.shape == (H, W, 3) and gt.min() < 200      # the object over white
    port, jax_ = _float_renders(model, 40, 1)
    assert np.array_equal(port_pngs[0], common.to_uint8(port))
    assert np.abs(port - jax_).max() <= 3e-5

    jcli_render.main(["-m", model, "--with_bg", "--skip_train"])
    for a, b in zip(port_pngs, _renders(model, 40)):
        assert np.abs(a.astype(int) - b).max() <= 1


def test_a_jax_model_directory_renders_in_the_port(data_dir, tmp_path):
    """A model directory the JAX package writes (its Scene's cameras.json,
    cfg_args.json with TPU-only keys, its PLYs) renders through the port's
    `cli.render --with_bg`: the PNGs are the port's render after uint8, and
    the float renders of both packages agree to 3e-5."""
    data, _ = data_dir
    jdir = str(tmp_path / "jax_model")
    groups = {"model": jconfig.ModelParams(source_path=data, model_path=jdir,
                                           eval=True, sh_degree=1),
              "pipeline": jconfig.PipelineParams(),
              "optimization": jconfig.OptimizationParams(),
              "runtime": jconfig.RuntimeParams(max_per_tile=MAX_PER_TILE,
                                               use_pallas=False, shard_gaussians=4)}
    jconfig.save_cfg(jdir, groups)
    JScene(groups["model"]).write_static_artifacts()
    v, f = icosphere(2)
    p, b, _, _ = jmgs.create_from_mesh(jnp.asarray(v), jnp.asarray(f), capacity=len(f),
                                      vertex_capacity=len(v), max_sh_degree=1)
    rng = np.random.default_rng(4)
    p = p.replace(opacity=jnp.asarray(rng.normal(2.0, 1.0, p.opacity.shape), jnp.float32),
                  features_rest=jnp.asarray(rng.normal(0, 0.2, p.features_rest.shape),
                                            jnp.float32))
    pc = os.path.join(jdir, "point_cloud", "iteration_7")
    os.makedirs(pc)
    jgaussian_ply.save_mesh_gaussian_ply(os.path.join(pc, "point_cloud.ply"), p, b)
    pts = rng.uniform(-2, 2, (200, 3)).astype(np.float32)
    bp, bst = jgs.create_from_points(jnp.asarray(pts), jnp.asarray(
        rng.uniform(0, 1, (200, 3)), jnp.float32), capacity=256, max_sh_degree=1)
    jgaussian_ply.save_gaussian_ply(os.path.join(pc, "bg_point_cloud.ply"), bp,
                                    bst.alive)

    cli_render.main(["-m", jdir, "--with_bg", "--skip_train", "--device", "cpu"])
    port, jax_ = _float_renders(jdir, 7, 1)
    assert np.abs(port - jax_).max() <= 3e-5
    assert np.array_equal(_renders(jdir, 7)[0], common.to_uint8(port))
    assert common.to_uint8(port).min() < 200


def test_resume_is_bit_identical_and_capture_is_a_snapshot(data_dir, tmp_path):
    """Train 6 steps, save_ckpt, train 6 more (a densify and an opacity
    reset among them, random backgrounds from the trainer's generator); a
    fresh trainer that loads the checkpoint and trains 6 steps ends with the
    same parameters, moments, statistics and events, bit for bit; the
    capture taken at the checkpoint is unchanged by the later steps."""
    data, mesh_path = data_dir
    scene = Scene(ModelParams(source_path=data, model_path=str(tmp_path)))
    ds = DeviceDataset.from_cameras(scene.train_cameras, device="cpu")
    v, f = mesh_io.read_triangle_mesh(mesh_path)
    opt = OptimizationParams(densify_from_iter=3, densification_interval=4,
                             densify_until_iter=12, opacity_reset_interval=5,
                             densify_grad_threshold=1e-6)

    def make():
        return MeshTrainer(v, f, ds, opt, RuntimeParams(max_per_tile=MAX_PER_TILE),
                           spatial_lr_scale=scene.cameras_extent, is_exist_bg=True,
                           init_target=300, max_sh_degree=1)

    a = make()
    a.train(6)
    path = a.save_ckpt(str(tmp_path / "chkpnt6.ckpt"))
    cap = a.capture()
    frozen = {k: copy_tree(x) if isinstance(x, dict) else
              x.clone() if torch.is_tensor(x) else x for k, x in cap.items()}
    a.train(6)
    b = make()
    b.load_ckpt(path)
    b.train(6)

    assert a.global_it == b.global_it == 12 and a.adam.step == b.adam.step == 12
    assert [e[:2] for e in a.events[-2:]] == [(8, "densify"), (10, "opacity_reset")]
    assert a.events[-2:] == b.events and a.events[-2][2]["n_split"] > 0
    _assert_same_tree(a.capture(), b.capture())
    _assert_same_tree(cap, frozen)


def _assert_same_tree(x, y, where=()):
    assert type(x) is type(y), where
    if isinstance(x, dict):
        assert x.keys() == y.keys(), where
        for k in x:
            _assert_same_tree(x[k], y[k], where + (k,))
    elif torch.is_tensor(x):
        assert x.dtype == y.dtype and torch.equal(x, y), where
    else:
        assert x == y, where


def test_logging_writes_scalars_traces_and_times(tmp_path, monkeypatch):
    """TrainLogger writes tensorboard events under <model>/tb and does
    nothing without tensorboardX; profile_trace leaves a Chrome trace (and
    nothing for no directory); StepTimer keeps a rolling window."""
    log = TrainLogger(str(tmp_path))
    log.scalars(1, {"train/loss": torch.tensor(0.5)})
    log.close()
    log.scalars(2, {"train/loss": 0.4})                  # closed: a no-op
    assert any(n.startswith("events") for n in os.listdir(tmp_path / "tb"))
    monkeypatch.setitem(sys.modules, "tensorboardX", None)
    quiet = TrainLogger(str(tmp_path / "none"))
    assert quiet.writer is None and not (tmp_path / "none").exists()
    quiet.scalars(1, {"x": 1.0})

    with profile_trace(str(tmp_path / "prof")) as prof:
        torch.ones(8).sum()
    assert prof is not None and (tmp_path / "prof" / "trace.json").stat().st_size > 0
    with profile_trace(None) as prof:
        assert prof is None

    timer = StepTimer(window=3)
    dts = [timer.tick() for _ in range(5)]
    assert len(timer.times) == 3 and timer.times == dts[2:]
    assert timer.mean_ms == pytest.approx(1e3 * sum(dts[2:]) / 3)


def test_latest_checkpoint_and_cuda_by_default(tmp_path, monkeypatch, data_dir):
    """--auto_resume picks the checkpoint with the largest iteration; with no
    --device each command line runs on CUDA and raises without a card."""
    for n in (5, 20, 100):
        (tmp_path / f"chkpnt{n}.ckpt").write_bytes(b"")
    assert train_mesh.latest_checkpoint(str(tmp_path)).endswith("chkpnt100.ckpt")
    assert train_mesh.latest_checkpoint(str(tmp_path / "none")) is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data, mesh_path = data_dir
    model = str(tmp_path / "m")
    with pytest.raises(RuntimeError, match="CUDA"):
        train_mesh.main(["-s", data, "-m", model, "--input_mesh", mesh_path])
    for cli in (train_bg, cli_render):
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(["-m", model])
