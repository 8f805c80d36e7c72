"""The port's measurement tools (`bench_torch.py`, `tools/profile_raster_torch.py`,
`tools/bench_playback_torch.py` and their helpers `tools/scenes_torch.py`,
`tools/timing_torch.py`) against the JAX repository's scenes, tools and
rasterizer, at 64x48 on the CPU."""

import importlib.util
import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _p in (ROOT, os.path.join(ROOT, "tools")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import bench_playback_torch  # noqa: E402
import bench_torch  # noqa: E402
import profile_raster_torch  # noqa: E402
import scenes_torch  # noqa: E402

import meshes  # noqa: E402
import scenes  # noqa: E402

W, H = 64, 48
SMALL = ["--device", "cpu", "--width", str(W), "--height", str(H)]


def load_jax_tool(name):
    """tools/<name>.py of the JAX repository, loaded by path; its additions
    to sys.path are taken back."""
    spec = importlib.util.spec_from_file_location(f"jax_{name}",
                                                  os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    kept = list(sys.path)
    spec.loader.exec_module(mod)
    sys.path[:] = kept
    return mod


def stale(path):
    """An old artifact with a key no run writes."""
    with open(path, "w") as fh:
        json.dump({"stale_key": 1}, fh)


def test_scenes_match_the_jax_helpers():
    """random_gaussians: means, scales, quats, opacity and rgb equal, cov6
    within 1e-7; look_at_camera's matrices within 1e-12; icosphere bit for
    bit."""
    kw = dict(seed=3, spread=1.4, scale_range=(0.004, 0.02))
    ref = scenes.random_gaussians(700, **kw)
    got = scenes_torch.random_gaussians(700, device="cpu", **kw)
    for k in ("means3d", "scales", "quats", "opacity", "rgb"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), err_msg=k)
    np.testing.assert_allclose(got["cov6"].numpy(), np.asarray(ref["cov6"]), rtol=0,
                               atol=1e-7)
    for args in ((W, H), (1920, 1080, 50.0, 3.0, -0.4, 0.5)):
        cam_ref = scenes.look_at_camera(*args)
        cam = scenes_torch.look_at_camera(*args, device="cpu")
        for k in cam_ref._fields:
            np.testing.assert_allclose(getattr(cam, k).numpy(), np.asarray(getattr(cam_ref, k)),
                                       rtol=0, atol=1e-12, err_msg=k)
    for level in (0, 2, 3):
        v, f = scenes_torch.icosphere(level)
        v_ref, f_ref = meshes.icosphere(level)
        assert v.dtype == v_ref.dtype and f.dtype == f_ref.dtype
        assert v.tobytes() == v_ref.tobytes() and f.tobytes() == f_ref.tobytes()


def test_twist_frames_match_the_jax_tool():
    tool = load_jax_tool("bench_playback")
    v, _ = meshes.icosphere(2)
    for n in (1, 4, 64):
        got = scenes_torch.twist_frames(v, n)
        assert got.dtype == np.float32
        assert got.tobytes() == tool._twist_frames(v, n).tobytes()


def tol(name):
    """Parameter tolerances: the log-scales come from the 3-NN distances of
    the face centroids (|a|^2 + |b|^2 - 2 a.b in f32 in both packages), held
    at `test_torch_models.py`'s bar for `create_from_mesh`; the rest 1e-6."""
    if name == "scaling":
        return dict(rtol=1e-4, atol=1e-5, err_msg=name)
    return dict(rtol=0, atol=1e-6, err_msg=name)


def test_make_object_matches_the_jax_tool(tmp_path):
    """make_object(level=2) with an offset: its PLY and OBJ read back with
    each package's reader equal the JAX tool's."""
    from gaussianmesh_tpu.io import gaussian_ply as ply_jax, mesh as mesh_jax
    from gaussianmesh_tpu_torch.io import gaussian_ply as ply_port, mesh as mesh_port

    tool = load_jax_tool("bench_playback")
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    off = (2.2, 0.6, 0.0)
    ref = tool._make_object(str(tmp_path / "jax"), level=2, name="side", offset=off)
    got = scenes_torch.make_object(str(tmp_path / "port"), 2, "side", offset=off,
                                   device="cpu")
    assert got[2].tobytes() == ref[2].tobytes() and got[3].tobytes() == ref[3].tobytes()
    for read in (mesh_jax.read_triangle_mesh, mesh_port.read_triangle_mesh):
        (va, fa), (vb, fb) = read(ref[1]), read(got[1])
        np.testing.assert_array_equal(va, vb)
        np.testing.assert_array_equal(fa, fb)

    pj, bj, xyz_j = ply_jax.load_mesh_gaussian_ply(ref[0])
    pp, bp, xyz_p = ply_jax.load_mesh_gaussian_ply(got[0])
    np.testing.assert_allclose(xyz_p, xyz_j, rtol=0, atol=1e-6)
    for name in ("bc", "distance", "features_dc", "features_rest", "scaling",
                 "rotation", "opacity"):
        np.testing.assert_allclose(np.asarray(getattr(pp, name)),
                                   np.asarray(getattr(pj, name)), **tol(name))
    for name in ("vertex1", "vertex2", "vertex3", "fid"):
        np.testing.assert_array_equal(np.asarray(getattr(bp, name)),
                                      np.asarray(getattr(bj, name)), err_msg=name)
    mj, xj = ply_port.load_mesh_gaussian_ply(ref[0], device="cpu")
    mp, xp = ply_port.load_mesh_gaussian_ply(got[0], device="cpu")
    np.testing.assert_allclose(xp, xj, rtol=0, atol=1e-6)
    for name, p in mp.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(),
                                   getattr(mj, name).detach().numpy(), **tol(name))
    assert float(torch.sigmoid(mp.opacity.detach()).min()) > 0.98


def bench_line(capsys, n_gauss=500):
    res = bench_torch.main(SMALL + ["--n_gauss", str(n_gauss), "--steps", "1",
                                    "--warm", "1"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(line) == json.loads(json.dumps(res))
    return res


def test_bench_matches_the_jax_rasterizer(capsys):
    """The bench line's keys; num_rendered equal to the JAX jnp path's on
    the same scene and config, the loss within 1e-5 relative."""
    from gaussianmesh_tpu.ops.rasterize import RasterizerConfig, rasterize

    res = bench_line(capsys)
    assert set(res) == {"metric", "value", "unit", "vs_baseline", "detail"}
    assert res["metric"] == "rasterize_fwd_bwd_mpix_per_s" and res["unit"] == "Mpix/s"
    d = res["detail"]
    for k in ("step_ms", "device_ms", "busy_ms", "idle_share", "device_operations",
              "n_gauss", "num_rendered", "overflow", "card", "power_limit"):
        assert k in d, k
    assert d["step_ms"] > 0 and res["value"] > 0 and d["overflow"] == 0
    assert d["device_ms"] is None and d["card"] == "cpu"    # no device clock here
    assert d["launches_per_step"] == {"K1": 0, "K2": 0, "K3": 0}

    sc = scenes.random_gaussians(500, seed=0, spread=1.4, scale_range=(0.004, 0.02))
    cfg = RasterizerConfig(W, H, max_per_tile=1024, pair_capacity_per_gaussian=9,
                           row_capacity_per_gaussian=3, use_pallas=False)
    out = rasterize(sc["means3d"], sc["cov6"], sc["opacity"], sc["rgb"], jnp.ones(3),
                    scenes.look_at_camera(W, H, distance=4.0), cfg)
    assert d["num_rendered"] == int(out.num_rendered) > 0
    loss = float(jnp.sum(out.color * out.color))
    assert abs(d["loss"] - loss) <= 1e-5 * loss, (d["loss"], loss)


def test_profile_modes_close_with_the_bench(tmp_path, capsys):
    """All three modes at 64x48: F7's num_rendered is the bench's, the
    prefix differences sum to B7, the expansion mirror equals
    `expand_pairs`; a stale artifact is rewritten without its old key."""
    bench = bench_line(capsys)["detail"]
    out = tmp_path / "profile.json"
    stale(out)
    art = profile_raster_torch.main(SMALL + ["--n_gauss", "500", "--stages", "--prefix",
                                             "--expand", "--reps", "1", "--out", str(out)])
    assert json.loads(out.read_text()) == json.loads(json.dumps(art))
    assert "stale_key" not in art and art["card"] == "cpu"
    pre = art["prefix"]
    assert pre["f7_num_rendered"] == bench["num_rendered"]
    names = [r["name"][:2] for r in pre["rows"]]
    assert names == ["F1", "F2", "F3", "F4", "F5", "F6", "F7", "B6", "B7"]
    assert sum(d["host_ms"] for d in pre["diffs"]) == pytest.approx(pre["b7_host_ms"],
                                                                    rel=1e-9)
    assert art["stages"]["scene"]["pairs_live"] == bench["num_rendered"]
    assert art["stages"]["scene"]["tile_overflow"] == 0
    assert len(art["stages"]["rows"]) == 11
    exp = art["expand"]
    assert exp["mirrors_expand_pairs"] and exp["pairs"] == bench["num_rendered"]
    assert [s["sync"].split()[0] for s in exp["host_stalls"]] == [
        "binning.py:126", "binning.py:156", "binning.py:159"]


def test_playback_matches_the_jax_runtime(tmp_path, capsys):
    """At 64x48, 4 frames (frame 1 twisted), level-2 objects, a 1,000-Gaussian
    background and one config-4 step: every overflow counter 0, the
    covariances rotate, config 3's frames within 3e-5 of the JAX runtime's
    `_playback_fns` frames of the same object; the artifact written afresh."""
    from gaussianmesh_tpu.edit.runtime import ObjectDeformer, _playback_fns
    from gaussianmesh_tpu.ops.rasterize import RasterizerConfig

    out = tmp_path / "playback.json"
    stale(out)
    keep = {}
    art = bench_playback_torch.main(
        SMALL + ["--frames", "4", "--level", "2", "--side_level", "2", "--n_bg", "1000",
                 "--steps4", "1", "--warm4", "0", "--out", str(out)], keep=keep)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["metric"] == "playback_fps_1080p" and line["value"] == art["config3"]["fps"]
    assert json.loads(out.read_text()) == json.loads(json.dumps(art))
    assert "stale_key" not in art
    for key in ("config3", "config5"):
        assert art[key]["tile_overflow_max"] == 0 and art[key]["rect_overflow_max"] == 0
    assert art["config3"]["n_gauss"] == 320
    assert art["config5"]["n_gauss_total"] == 3 * 320 + 1000
    assert art["config3"]["cov_rotation_max"] > 1e-2
    assert art["config4"]["tile_overflow"] == 0 and art["config4"]["rect_overflow"] == 0
    assert np.isfinite(art["config4"]["loss"])
    static = art["config5"]["static"]
    assert static["start_capacity"] == [8, 3] and static["pairs"] == static["start_pairs"]
    c4 = art["config4"]
    assert c4["jax_runtime"]["max_per_tile"] == 1024 and c4["jax_runtime"]["capacity"] == [10, 4]
    assert c4["sized"]["largest_tile"] <= c4["max_per_tile"]
    for d, r in art["config5_tile_axis"]["per_d"].items():
        assert len(r["per_band_ms"]) == int(d) and r["critical_ms"] == max(r["per_band_ms"])
        assert not any(r["max_overflow"])

    ply, objpath, v, _ = scenes_torch.make_object(str(tmp_path), 2, "main", device="cpu")
    frame_fn, _ = _playback_fns(ObjectDeformer(ply, objpath), scenes.look_at_camera(W, H),
                                RasterizerConfig(W, H, max_per_tile=1024,
                                                 use_pallas=False), None)
    frames = scenes_torch.twist_frames(v, 4)
    for i, got in enumerate(keep["config3"]):
        ref = np.asarray(frame_fn(jnp.asarray(frames[i])))
        err = np.abs(got.numpy() - ref).max()
        assert err <= 3e-5, (i, err)
    assert np.abs(keep["config3"][1].numpy() - keep["config3"][0].numpy()).max() > 1e-2


def test_tools_raise_without_a_card(tmp_path, monkeypatch, capsys):
    """Without --device cpu and with no card, each tool fails: the bench with
    its error line and exit code 1, the other two with the port's error."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        bench_torch.main(["--n_gauss", "10"])
    assert exc.value.code == 1
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["value"] == 0.0 and "CUDA" in line["error"]
    for tool in (profile_raster_torch, bench_playback_torch):
        with pytest.raises(RuntimeError, match="CUDA"):
            tool.main(["--out", str(tmp_path / "x.json")])
    assert not (tmp_path / "x.json").exists()
