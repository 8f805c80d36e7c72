"""The port's config-2 quality protocol (`tools/quality_run_torch.py`) against
the JAX package's (`tools/quality_run.py`), on the CPU at 32x32: the same
dataset, the same `train_mesh` flags in every mode, and the tool end to end
with its resume. Both tools are loaded by file path with their mode's
environment, and their size constants set on the loaded module; neither
file is edited."""

import importlib.util
import json
import math
import os
import shutil
import sys

import numpy as np
import pytest
import torch

import gaussianmesh_tpu.cli.train_mesh as jax_train_mesh
from gaussianmesh_tpu.data import readers as jreaders
from gaussianmesh_tpu.io import gaussian_ply as jply
from gaussianmesh_tpu.models import render as jrender
from gaussianmesh_tpu.ops import binning as jbinning
from gaussianmesh_tpu.ops import preprocess as jprep
from gaussianmesh_tpu.ops.rasterize import RasterizerConfig as JRasterizerConfig
from gaussianmesh_tpu.ops.tile_blend import ALPHA_MIN, T_EPS
from gaussianmesh_tpu.train.loss import psnr as jpsnr
import gaussianmesh_tpu_torch.cli.train_mesh as torch_train_mesh
from gaussianmesh_tpu_torch.io import png

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODES = {"small": {"GM_QUALITY_SMALL": "1"}, "default": {},
         "protocol": {"GM_QUALITY_PROTOCOL": "1"}}
# the keys of the JAX tool's artifact (tools/quality_run.py's `out`)
JAX_KEYS = {"config", "protocol", "resolution", "iterations", "init_target", "backend",
            "train_seconds", "iters_per_second", "trajectory", "lpips_note",
            "reset_note", "reproduce"}


def load_tool(name, monkeypatch, mode):
    """tools/<name>.py loaded afresh under `mode`'s environment; the JAX
    tool's additions to sys.path are taken back once it is loaded."""
    for key in ("GM_QUALITY_SMALL", "GM_QUALITY_PROTOCOL", "GM_QUALITY_ITERS"):
        monkeypatch.delenv(key, raising=False)
    for key, value in MODES[mode].items():
        monkeypatch.setenv(key, value)
    path = os.path.join(ROOT, "tools", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"{name}_{mode}", path)
    mod = importlib.util.module_from_spec(spec)
    kept = list(sys.path)
    spec.loader.exec_module(mod)
    sys.path[:] = kept
    return mod


def shrink(*tools):
    for tool in tools:
        tool.W = tool.H = 32
        tool.N_CAMS = 6


@pytest.mark.parametrize("mode", ["small", "protocol"])
def test_dataset_matches_the_jax_tool(mode, tmp_path, monkeypatch):
    """At 32x32 and 6 cameras (10 poses): every PNG within one uint8 level
    of the JAX tool's with >= 99.9 % of the values equal, the transforms to
    1e-12, proxy.obj the same bytes; for the SMALL (icosphere-2 teacher,
    icosphere-1 proxy) and the PROTOCOL (icosphere-4, uv sphere) sets."""
    ref = load_tool("quality_run", monkeypatch, mode)
    port = load_tool("quality_run_torch", monkeypatch, mode)
    shrink(ref, port)
    ref.make_dataset(str(tmp_path / "jax"))
    port.make_dataset(str(tmp_path / "port"), "cpu")

    names = sorted(os.listdir(tmp_path / "jax" / "train"))
    assert names == sorted(os.listdir(tmp_path / "port" / "train"))
    assert len(names) == 10
    diffs = []
    for name in names:
        a = png.read_png(str(tmp_path / "jax" / "train" / name)).astype(int)
        b = png.read_png(str(tmp_path / "port" / "train" / name)).astype(int)
        assert a.shape == b.shape == (32, 32, 3), name
        assert a.min() < 200, name                   # the object is in view
        diffs.append(np.abs(a - b).ravel())
    diffs = np.concatenate(diffs)
    assert diffs.max() <= 1, diffs.max()
    assert (diffs == 0).mean() >= 0.999, (diffs == 0).mean()

    for split in ("train", "test"):
        with open(tmp_path / "jax" / f"transforms_{split}.json") as fh:
            a = json.load(fh)
        with open(tmp_path / "port" / f"transforms_{split}.json") as fh:
            b = json.load(fh)
        assert a["camera_angle_x"] == b["camera_angle_x"]
        assert [f["file_path"] for f in a["frames"]] == [f["file_path"] for f in b["frames"]]
        np.testing.assert_allclose([f["transform_matrix"] for f in b["frames"]],
                                   [f["transform_matrix"] for f in a["frames"]],
                                   rtol=0, atol=1e-12)
    assert len(b["frames"]) == 1                     # pose 7 of 10
    assert ((tmp_path / "jax" / "proxy.obj").read_bytes()
            == (tmp_path / "port" / "proxy.obj").read_bytes())


class Captured(Exception):
    pass


def capture_train_argv(monkeypatch, module, tool, run):
    """The argv `tool` hands to `module.main` (stubbed to stop there), with
    the dataset step stubbed too."""
    seen = []

    def stub(argv):
        seen.append(list(argv))
        raise Captured

    monkeypatch.setattr(module, "main", stub)
    monkeypatch.setattr(tool, "make_dataset",
                        lambda root, *_: os.path.join(root, "proxy.obj"))
    with pytest.raises(Captured):
        run()
    assert len(seen) == 1
    return seen[0]


@pytest.mark.parametrize("mode", ["small", "default", "protocol"])
def test_train_flags_match_the_jax_tool(mode, tmp_path, monkeypatch):
    """Each mode passes `train_mesh` the JAX tool's flags letter for letter;
    the port adds only `--checkpoint_iterations` (every eval iteration and
    every 5,000), `--auto_resume` and `--device`."""
    work = str(tmp_path / "work")
    ref = load_tool("quality_run", monkeypatch, mode)
    monkeypatch.setattr(sys, "argv", ["quality_run.py", work])
    want = capture_train_argv(monkeypatch, jax_train_mesh, ref, ref.main)
    port = load_tool("quality_run_torch", monkeypatch, mode)
    got = capture_train_argv(monkeypatch, torch_train_mesh, port,
                             lambda: port.main([work, "--device", "cpu"]))

    i = got.index("--checkpoint_iterations")
    j = got.index("--auto_resume")
    ckpts = [int(x) for x in got[i + 1:j]]
    assert got[:i] == want
    assert got[j:] == ["--auto_resume", "--device", "cpu"]
    evals = [int(x) for x in want[want.index("--test_iterations") + 1:
                                  want.index("--save_iterations")]]
    assert evals == ref.EVAL_ITERS
    iters = int(want[want.index("--iterations") + 1])
    assert ckpts == sorted(set(evals) | set(range(5000, iters + 1, 5000)))
    assert ("--pair_capacity_per_gaussian" in want) == (mode == "protocol")
    assert "--white_background" not in got


def repo_files():
    """(path, size, mtime) of the repository's files outside `.git` and
    the build and cache directories."""
    skip = {".git", "__pycache__", "_build", ".jax_cache", ".pytest_cache",
            ".hypothesis"}
    out = set()
    for dirpath, dirnames, filenames in os.walk(ROOT):
        dirnames[:] = [d for d in dirnames if d not in skip]
        for name in filenames:
            st = os.stat(os.path.join(dirpath, name))
            out.add((os.path.join(dirpath, name), st.st_size, st.st_mtime_ns))
    return out


def test_tool_end_to_end_on_the_cpu_resumes(tmp_path, monkeypatch):
    """The SMALL tool at 32x32, 6 cameras, 30 iterations, evals at 10 and
    30 with `--device cpu`: the artifact has the JAX artifact's keys plus
    `device` and `n_gauss_final`, a finite trajectory; run again on the same
    work directory it trains nothing; with the final checkpoint and PLY
    removed it resumes from the one at 10 and ends with the same PLY bytes.
    Nothing under the repository is written."""
    tool = load_tool("quality_run_torch", monkeypatch, "small")
    shrink(tool)
    tool.ITERS, tool.EVAL_ITERS = 30, [10, 30]
    work, out = tmp_path / "work", tmp_path / "quality.json"
    argv = [str(work), "--device", "cpu", "--out", str(out)]
    model = work / "model"
    before = repo_files()

    first = tool.main(argv)
    with open(out) as fh:
        assert json.load(fh) == json.loads(json.dumps(first))
    assert JAX_KEYS | {"device", "n_gauss_final"} <= set(first)
    assert first["resolution"] == [32, 32] and first["iterations"] == 30
    assert first["backend"] == "cpu" and first["device"]["name"] == "cpu"
    assert first["segments"] == 1 and first["losses_finite"]
    assert sorted(first["trajectory"]) == ["10", "30"]
    for it, res in first["trajectory"].items():
        assert res["LPIPS"] is None, it
        for key in ("PSNR", "SSIM", "LPIPS_uncalibrated"):
            assert math.isfinite(res[key]), (it, key)
    # 80 proxy faces, 4x subdivided twice past init_target 500; densify
    # starts at 300
    assert first["n_gauss_final"] == 1280
    assert first["host_events"]["densify"]["count"] == 0
    assert sorted(p.name for p in model.glob("chkpnt*")) == ["chkpnt10.ckpt",
                                                             "chkpnt30.ckpt"]
    ply = model / "point_cloud" / "iteration_30" / "point_cloud.ply"
    ply_bytes = ply.read_bytes()
    stamps = {p.name: p.stat().st_mtime_ns for p in model.glob("chkpnt*")}

    again = tool.main(argv)
    assert again["segments"] == 1
    assert again["train_seconds"] == first["train_seconds"]
    assert again["trajectory"] == first["trajectory"]
    assert {p.name: p.stat().st_mtime_ns for p in model.glob("chkpnt*")} == stamps

    (model / "chkpnt30.ckpt").unlink()
    shutil.rmtree(ply.parent)
    resumed = tool.main(argv)
    with open(work / "segments.json") as fh:
        segments = json.load(fh)
    assert resumed["segments"] == 2
    assert [(s["from"], s["to"]) for s in segments] == [(0, 30), (10, 30)]
    assert ply.read_bytes() == ply_bytes
    assert resumed["trajectory"] == first["trajectory"]
    assert repo_files() == before


def jax_clamp_view(p, b, cam, max_per_tile, sh_degree):
    """The clamp report's figures of one view through the JAX package's
    rasterizer (the jnp path): the renders at `max_per_tile` and at the
    view's largest tile count, the raw per-tile counts from its binning."""
    import jax.numpy as jnp

    ca = cam.arrays()
    a = jrender.mesh_model_arrays(p, b, ca, sh_degree)
    n = a.xyz.shape[0]

    def cfg(mpt):
        return JRasterizerConfig(cam.width, cam.height, max_per_tile=mpt,
                                 use_pallas=False)

    c = cfg(max_per_tile)
    prep = jprep.preprocess(a.xyz, a.cov6, ca, c.width, c.height, opacity=a.opacity)
    prep = prep._replace(valid=prep.valid & a.active,
                         radius=jnp.where(a.active, prep.radius, 0),
                         tiles_touched=jnp.where(a.active, prep.tiles_touched, 0))
    gx, gy = c.grid
    tiles = jbinning.build_tile_lists(
        prep, gx, gy, max_per_tile, expand_capacity=c.expand_capacity(n),
        pair_capacity=c.pair_capacity(n), chunk=c.blend_chunk, opacity=a.opacity,
        row_capacity=c.row_capacity(n))
    raw = np.diff(np.asarray(tiles.starts))
    white = jnp.ones(3)
    clamped = jrender.render(a, ca, c, white)
    free = jrender.render(a, ca, cfg(int(raw.max())), white)
    for out in (clamped, free):
        assert int(out.pair_overflow) == 0 and int(out.rect_overflow) == 0

    def image(color):
        u8 = (np.clip(np.asarray(color), 0, 1).transpose(1, 2, 0) * 255).astype(np.uint8)
        return jnp.asarray(u8.transpose(2, 0, 1).astype(np.float32) / 255.0)

    cut = raw > max_per_tile
    ys, xs = np.mgrid[:c.height, :c.width] // 16
    in_cut = cut[ys * gx + xs]
    t_c = np.asarray(clamped.final_t)[in_cut]
    img_c, img_u, gt = image(clamped.color), image(free.color), image(cam.image)
    return {"largest_tile": int(raw.max()), "dropped": int(clamped.tile_overflow),
            "free_dropped": int(free.tile_overflow), "cut_tiles": int(cut.sum()),
            "t_share": float((t_c >= T_EPS).mean()),
            "shown_share": float((np.asarray(free.final_t)[in_cut]
                                  < t_c * (1 - 0.5 * ALPHA_MIN)).mean()),
            "psnr_renders": float(jpsnr(img_c, img_u)),
            "psnr_clamped": float(jpsnr(img_c, gt)),
            "psnr_unclamped": float(jpsnr(img_u, gt))}


def test_clamp_report_matches_the_jax_rasterizer(tmp_path, monkeypatch):
    """The SMALL tool at 64x64 (14 cameras, 2 held-out views), 10
    iterations at `--max_per_tile 64`, which cuts some of the 16 tiles: the
    clamp report's figures of each view equal those of the JAX package's
    jnp rasterizer on the saved PLY and the JAX reader's cameras at the same
    two `max_per_tile` values: pairs dropped, tiles cut and the largest tile
    exactly, the T shares within one pixel of the cut tiles, PSNRs within
    1e-3 dB; the clamped render's test PSNR is the trajectory's."""
    tool = load_tool("quality_run_torch", monkeypatch, "small")
    tool.W = tool.H = 64
    tool.N_CAMS = 14
    tool.ITERS, tool.EVAL_ITERS = 10, [10]
    work = tmp_path / "work"
    art = tool.main([str(work), "--device", "cpu", "--out", str(tmp_path / "q.json"),
                     "--max_per_tile", "64"])
    assert art["max_per_tile"] == 64
    assert art["reproduce"].endswith("--max_per_tile 64")
    rep = art["clamp"]["10"]
    assert rep["max_per_tile"] == 64 and len(rep["views"]) == 2

    info = jreaders.read_scene(str(work / "data"), eval_split=True)
    p, b, _ = jply.load_mesh_gaussian_ply(
        str(work / "model" / "point_cloud" / "iteration_10" / "point_cloud.ply"),
        max_sh_degree=2)
    for cam, got in zip(info.test_cameras, rep["views"]):
        want = jax_clamp_view(p, b, cam, 64, 2)
        assert want["free_dropped"] == 0
        assert 0 < got["cut_tiles"] < 16, got
        for key in ("largest_tile", "dropped", "cut_tiles"):
            assert got[key] == want[key], (key, got, want)
        pixels = got["cut_tiles"] * 256
        for key in ("t_share", "shown_share"):
            assert abs(got[key] - want[key]) * pixels <= 1.0 + 1e-6, (key, got, want)
        assert got["t_share"] == 1.0 and 0 < got["shown_share"] < 1, got
        for key in ("psnr_renders", "psnr_clamped", "psnr_unclamped"):
            assert got[key] == pytest.approx(want[key], abs=1e-3), (key, got, want)
    assert rep["worst"]["psnr_clamped"] == min(v["psnr_clamped"] for v in rep["views"])
    assert rep["worst"]["dropped"] == max(v["dropped"] for v in rep["views"])
    assert rep["mean"]["psnr_clamped"] == pytest.approx(art["trajectory"]["10"]["PSNR"],
                                                        abs=1e-5)
