"""The port's HTTP viewer (`gaussianmesh_tpu_torch/viewer.py`,
`cli/viewer.py`) on the CPU: the JAX viewer's four cases, the orbit camera
against the JAX one, PNGs against PIL, and a served frame of a model
directory the JAX package wrote against the port's `SceneEditor.render`."""

import dataclasses
import io
import json
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

from gaussianmesh_tpu import config as jconfig
from gaussianmesh_tpu import viewer as jviewer
from gaussianmesh_tpu_torch.cli import viewer as cli_viewer
from gaussianmesh_tpu_torch.edit import runtime
from gaussianmesh_tpu_torch.io import png
from gaussianmesh_tpu_torch.ops import tile_blend
from gaussianmesh_tpu_torch.ops.rasterize import RasterizerConfig
from gaussianmesh_tpu_torch.viewer import (ViewerServer, editor_render_fn,
                                           encode_png, orbit_camera, to_uint8)
# pytest puts tests/ on sys.path
from test_torch_edit import jax_object

torch.set_num_threads(2)


def _gradient_render(cam):
    h, w = cam.height, cam.width
    v = np.linspace(0.0, 1.0, h)[:, None] * np.ones((1, w))
    u = np.ones((h, 1)) * np.linspace(0.0, 1.0, w)[None, :]
    return np.stack([u, v, 0.5 * (u + v)])


def _get(url):
    return urllib.request.urlopen(url, timeout=30).read()


def test_viewer_serves_png_and_state():
    server = ViewerServer(_gradient_render, width=64, height=48, port=0).start()
    try:
        base = f"http://{server.host}:{server.port}"
        page = _get(base + "/")
        assert b"orbit" in page and b"/frame" in page
        frame = _get(base + "/frame?theta=0.4&phi=0.2&r=3.5")
        assert frame[:8] == b"\x89PNG\r\n\x1a\n"
        assert png.decode_png(frame).shape == (48, 64, 3)
        state = json.loads(_get(base + "/state"))
        assert state == {"width": 64, "height": 48, "frames_served": 1}
        assert len(server.frame_ms) == 1
        with pytest.raises(urllib.error.HTTPError) as err:
            _get(base + "/nothing")
        assert err.value.code == 404
    finally:
        server.stop()


def test_viewer_reports_render_errors():
    def boom(cam):
        raise RuntimeError("render exploded")

    server = ViewerServer(boom, width=8, height=8, port=0).start()
    try:
        with pytest.raises(urllib.error.HTTPError) as err:
            _get(f"http://{server.host}:{server.port}/frame")
        assert err.value.code == 500
        assert b"render exploded" in err.value.read()
        assert server.frames_served == 0
    finally:
        server.stop()


@pytest.mark.parametrize("args", [(0.7, 0.3, 5.0, 128, 96, 60.0, (1.0, 2.0, 3.0)),
                                  (-2.1, -1.2, 2.5, 64, 200, 45.0, (0.0, 0.0, 0.0))])
def test_orbit_camera_looks_at_center_as_jax(args):
    theta, phi, radius, w, h, fov, center = args
    cam = orbit_camera(theta, phi, radius, w, h, fovx_deg=fov, center=center)
    cc = cam.camera_center
    d = np.asarray(center) - cc
    assert abs(np.linalg.norm(d) - radius) < 1e-6
    assert np.dot(cam.R[:, 2], d / np.linalg.norm(d)) > 0.999
    jcam = jviewer.orbit_camera(theta, phi, radius, w, h, fovx_deg=fov,
                                center=center)
    for name in ("R", "T", "fovx", "fovy"):
        np.testing.assert_allclose(getattr(cam, name), getattr(jcam, name),
                                   atol=1e-12, rtol=0)
    assert (cam.width, cam.height) == (jcam.width, jcam.height) == (w, h)


def test_encode_png_roundtrip():
    img = _gradient_render(orbit_camera(0.0, 0.0, 1.0, 32, 16))
    data = encode_png(img)
    back = np.asarray(Image.open(io.BytesIO(data)))
    assert back.shape == (16, 32, 3)
    np.testing.assert_array_equal(back, to_uint8(img))
    np.testing.assert_allclose(back / 255.0, img.transpose(1, 2, 0),
                               atol=1 / 255.0 + 1e-6)
    # the JAX viewer's quantisation, bit for bit
    jback = np.asarray(Image.open(io.BytesIO(jviewer.encode_png(img))))
    np.testing.assert_array_equal(back, jback)


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_encode_png_decodes_with_pil(channels):
    rng = np.random.default_rng(channels)
    img = rng.integers(0, 256, (7, 13, channels)).astype(np.uint8)
    back = np.asarray(Image.open(io.BytesIO(png.encode_png(img))))
    np.testing.assert_array_equal(back.reshape(img.shape), img)


@pytest.fixture
def model_dir(tmp_path):
    """A model directory as the JAX package writes one: the object's PLY,
    its origin mesh and cfg_args.json (TPU-only keys included)."""
    ply, origin, _, _ = jax_object(tmp_path)
    groups = {"model": jconfig.ModelParams(sh_degree=3, model_path=str(tmp_path)),
              "pipeline": jconfig.PipelineParams(),
              "optimization": jconfig.OptimizationParams(),
              "runtime": jconfig.RuntimeParams(max_per_tile=512, use_pallas=False)}
    jconfig.save_cfg(str(tmp_path), groups)
    return tmp_path, ply, origin


def test_served_frame_equals_editor_render(model_dir):
    """`cli.viewer` on the JAX-written directory with `--device cpu`: each
    served PNG is the quantised `SceneEditor.render` of its orbit camera,
    at the request's size."""
    root, ply, origin = model_dir
    server = cli_viewer.build_server(
        ["-m", str(root), "--gaussian_ply", ply, "--origin_mesh", origin,
         "--port", "0", "--width", "96", "--height", "64", "--device", "cpu"])
    editor = runtime.SceneEditor(device="cpu")
    editor.add_object(ply, origin, name="object")
    center = editor.objects["object"].pos0.mean(0).numpy()
    server.start()
    try:
        base = f"http://{server.host}:{server.port}"
        for theta, phi, r, (w, h) in ((0.4, 0.2, 3.5, (96, 64)),
                                      (2.0, -0.3, 4.0, (48, 80))):
            data = _get(f"{base}/frame?theta={theta}&phi={phi}&r={r}&w={w}&h={h}")
            cam = orbit_camera(theta, phi, r, w, h, center=center)
            want = to_uint8(editor.render(cam, RasterizerConfig(w, h, 512)).color)
            got = png.decode_png(data)
            assert got.shape == (h, w, 3) and want.max() > 50
            np.testing.assert_array_equal(got, want)
        assert json.loads(_get(base + "/state"))["frames_served"] == 2
    finally:
        server.stop()


def test_editor_render_fn_returns_host_image(model_dir):
    """The render function names the editor's device and hands back a host
    tensor; with a card absent the command line's default device raises."""
    root, ply, origin = model_dir
    editor = runtime.SceneEditor(device="cpu")
    editor.add_object(ply, origin, name="object")
    fn = editor_render_fn(editor, RasterizerConfig(32, 32, 512), (1.0, 1.0, 1.0))
    before = tile_blend.blend_forward.launches
    img = fn(orbit_camera(0.5, 0.3, 3.5, 40, 24))
    assert img.device.type == "cpu" and img.shape == (3, 24, 40)
    assert tile_blend.blend_forward.launches == before   # plain on the CPU
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli_viewer.build_server(["-m", str(root), "--gaussian_ply", ply,
                                     "--origin_mesh", origin, "--port", "0"])


def test_viewer_groups_skip_jax_only_keys(model_dir):
    """cfg_args.json with TPU-only keys loads into the port's groups."""
    root, _, _ = model_dir
    saved = json.loads((root / "cfg_args.json").read_text())
    assert "use_pallas" in saved["runtime"]
    groups = dataclasses.asdict(
        cli_viewer.cfg_mod.load_combined(str(root), cli_viewer.base_parser("x")
                                         .parse_args([]))["runtime"])
    assert groups["max_per_tile"] == 512 and "use_pallas" not in groups
