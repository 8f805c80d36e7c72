"""Config-2 quality protocol on the PyTorch port (port of
`tools/quality_run.py`): train a synthetic object through the port's command
lines and record the held-out PSNR / SSIM / LPIPS_uncalibrated trajectory.

A procedurally textured teacher sphere is rendered over white from
N_CAMS + max(4, N_CAMS // 6) poses (every 8th a test view); a coarse proxy
mesh starts the student; `cli.train_mesh` trains it with the JAX tool's
flags letter for letter, then `cli.render` and `cli.metrics` evaluate each
eval iteration. Three modes, chosen as in the JAX tool:

    python tools/quality_run_torch.py [workdir]                       # 7K, 448x448
    GM_QUALITY_SMALL=1 python tools/quality_run_torch.py [workdir]    # 300, 128x128
    GM_QUALITY_PROTOCOL=1 python tools/quality_run_torch.py [workdir] # 30K protocol

`GM_QUALITY_ITERS` overrides the iteration count. Runs on CUDA unless
`--device cpu` is given, and raises without a card. `--seed` goes on to
`train_mesh` (the views and backgrounds it draws, the init's random colors).
`--max_per_tile N` (default 768, the JAX tool's) is the training run's
per-tile pair clamp: both packages blend only the nearest N pairs of a tile,
where the reference blends every pair. A second run of the protocol with an
N larger than any tile's pair count (1048576 at this size) trains and
evaluates at the reference's unclamped blend.

The clamp report (the artifact's `clamp`): at each eval iteration every
held-out view is rendered twice through `models/render.py`, at the run's
`max_per_tile` and with no clamp (`max_per_tile` the view's largest tile
count, so nothing is dropped). Per view: the pairs dropped, the tiles cut,
the share of the cut tiles' pixels whose final T after the kept pairs is
still >= T_EPS (`t_share`; the walk ends before T would fall below T_EPS, so
this share is 1 wherever a tile is cut) and the share where the unclamped
render blended a dropped pair (its final T lower by half of the least
alpha a pair blends with, 1/255: `shown_share`), the
PSNR between the two renders (null where they are equal) and each render's
test PSNR against the ground truth, all on the 8-bit images `cli.render`
writes; per iteration the worst view and the mean over views of each.

The run is resumable: `train_mesh` checkpoints at every eval iteration and
every 5,000, and runs with `--auto_resume`, so the same command on the same
work directory continues from the newest checkpoint (bit for bit); a run
that finds the final checkpoint trains nothing. The dataset is written once.
Each training call is one segment, kept in <workdir>/segments.json with its
seconds, its host events (each densify and capacity growth, timed on the
host clock between two synchronizes) and its largest overflow counters; a segment cut before its
end is not recorded.

The artifact, written afresh on every run, has the JAX artifact's keys plus
`device` (nvidia-smi's name and power limit; the torch device on the CPU),
`n_gauss_final`, `seed`, `max_per_tile`, `segments`, `host_events`,
`overflow` and `clamp`:
results/config2_quality_torch.json, or results/config2_quality_torch_smoke.json
in SMALL mode (beside this file's repository), or `--out`.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

SMALL = bool(os.environ.get("GM_QUALITY_SMALL"))
# GM_QUALITY_PROTOCOL=1: the reference's full config-2 protocol: 30K
# iterations, >= 100K Gaussians after the init subdivision, densify every
# 200 in (500, 15000), opacity reset every 3000, evals at 7K / 30K plus
# {2950, 3000, 3050} around the reset at 3000 (the eval at 3000 runs after
# that iteration's reset, in the reference's order)
PROTOCOL = bool(os.environ.get("GM_QUALITY_PROTOCOL"))
W = H = 128 if SMALL else 448
N_CAMS = 12 if SMALL else 48
ITERS = int(os.environ.get("GM_QUALITY_ITERS", 0)) or (
    300 if SMALL else (30000 if PROTOCOL else 7000))
EVAL_ITERS = ([100, 300] if SMALL else
              [1000, 2950, 3000, 3050, 7000, 15000, 30000] if PROTOCOL
              else [500, 1000, 3000, 7000])
EVAL_ITERS = [i for i in EVAL_ITERS if i <= ITERS]
if ITERS not in EVAL_ITERS:
    EVAL_ITERS.append(ITERS)
INIT_TARGET = 500 if SMALL else (100_000 if PROTOCOL else 20000)
FOVX = 0.8
TEACHER_MAX_PER_TILE = 512
MAX_PER_TILE = 768
CHECKPOINT_EVERY = 5000


def mesh_builders():
    """`tests/meshes.py` (numpy only): the icosphere and uv-sphere builders
    the JAX tool uses."""
    tests = os.path.join(ROOT, "tests")
    if tests not in sys.path:
        sys.path.append(tests)
    import meshes

    return meshes


def teacher_colors(cent: np.ndarray) -> np.ndarray:
    """The procedural texture at centroids (N, 3): angular stripes and a
    checker, in [0.05, 0.95]."""
    return np.stack([
        0.5 + 0.45 * np.sin(9.0 * cent[:, 0] + 5.0 * cent[:, 1]),
        0.5 + 0.45 * np.sin(7.0 * cent[:, 1] - 4.0 * cent[:, 2]),
        0.5 + 0.45 * np.sign(np.sin(6.0 * cent[:, 2]) * np.sin(8.0 * cent[:, 0])) * 0.9,
    ], axis=-1)


def make_teacher(level: int, device):
    """The teacher: an icosphere of `level` as a mesh-bound model, one opaque
    Gaussian per face colored by `teacher_colors` (SH DC only)."""
    from gaussianmesh_tpu_torch.models import mesh_gaussians as mgs
    from gaussianmesh_tpu_torch.utils import sh as sh_utils

    v, f = mesh_builders().icosphere(level)
    cap = f.shape[0] + 8
    teacher = mgs.create_from_mesh(v, f, capacity=cap, vertex_capacity=4 * cap,
                                   device=device)
    with torch.no_grad():
        cols = teacher_colors(teacher.get_xyz().cpu().numpy())
        teacher.features_dc.copy_(sh_utils.rgb_to_sh(torch.from_numpy(cols))
                                  .to(torch.float32)[:, None, :])
        teacher.opacity.fill_(6.0)
    return teacher


def pose(i: int, n_total: int):
    """Pose i of n_total, winding 3.1 times around the object at radius 3.2:
    -> (R cam-to-world, T world-to-cam, the Blender c2w matrix)."""
    az = 2 * np.pi * i / n_total * 3.1
    el = 0.9 * np.sin(i * 0.71)
    pos = 3.2 * np.array([np.cos(el) * np.sin(az), np.sin(el),
                          np.cos(el) * np.cos(az)])
    fwd = -pos / np.linalg.norm(pos)
    up = np.array([0.0, 1.0, 0.0])
    right = np.cross(up, fwd)
    right /= np.linalg.norm(right)
    up2 = np.cross(fwd, right)
    R = np.stack([right, up2, fwd], axis=1)
    T = -R.T @ pos
    c2w = np.eye(4)
    c2w[:3, :3] = R
    c2w[:3, 3] = pos
    c2w[:3, 1:3] *= -1
    return R, T, c2w


def proxy_mesh():
    """The student's proxy: a 1,600-face uv sphere under PROTOCOL (1:4
    subdivided once to 102,400 Gaussians, just past the reference's 100K
    init floor), else an icosphere of level 1 (SMALL) or 2."""
    meshes = mesh_builders()
    if PROTOCOL:
        return meshes.uv_sphere(40, 21)
    return meshes.icosphere(1 if SMALL else 2)


def make_dataset(root: str, device) -> str:
    """A Blender-style set in `root`: the teacher rendered over white as
    train/r_<i>.png, transforms_{train,test}.json (every 8th pose a test
    view) and proxy.obj, written last. A set already complete in `root`
    is kept as it is. -> the proxy mesh's path."""
    from gaussianmesh_tpu_torch.cli.common import save_image
    from gaussianmesh_tpu_torch.data.cameras import Camera
    from gaussianmesh_tpu_torch.io import mesh as mesh_io
    from gaussianmesh_tpu_torch.models import render as render_mod
    from gaussianmesh_tpu_torch.ops.rasterize import RasterizerConfig

    mesh_path = os.path.join(root, "proxy.obj")
    if os.path.exists(mesh_path):
        return mesh_path
    teacher = make_teacher(2 if SMALL else 4, device)
    cfg = RasterizerConfig(W, H, TEACHER_MAX_PER_TILE)
    white = torch.ones(3, device=device)
    os.makedirs(os.path.join(root, "train"), exist_ok=True)
    frames_tr, frames_te = [], []
    n_total = N_CAMS + max(4, N_CAMS // 6)
    for i in range(n_total):
        R, T, c2w = pose(i, n_total)
        cam = Camera(uid=i, R=R, T=T, fovx=FOVX, fovy=FOVX, image=None,
                     width=W, height=H).arrays(device)
        with torch.no_grad():
            out = render_mod.render(render_mod.mesh_model_arrays(teacher, cam, 0),
                                    cam, cfg, white)
        save_image(os.path.join(root, "train", f"r_{i}.png"), out.color)
        rec = {"file_path": f"train/r_{i}", "transform_matrix": c2w.tolist()}
        (frames_te if i % 8 == 7 else frames_tr).append(rec)

    for split, frames in (("train", frames_tr), ("test", frames_te)):
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as fh:
            json.dump({"camera_angle_x": FOVX, "frames": frames}, fh)
    mesh_io.write_triangle_mesh(mesh_path, *proxy_mesh())
    return mesh_path


def train_args(data: str, model: str, mesh_path: str,
               max_per_tile: int = MAX_PER_TILE) -> list[str]:
    """`cli.train_mesh`'s flags, those of the JAX tool letter for letter at
    the default `max_per_tile`."""
    ev = [str(i) for i in EVAL_ITERS]
    args = [
        "-s", data, "-m", model, "--input_mesh", mesh_path,
        "--iterations", str(ITERS), "--init_target", str(INIT_TARGET),
        "--eval", "--sh_degree", "2",
        "--densify_from_iter", "500" if PROTOCOL else "300",
        "--densify_until_iter",
        "15000" if PROTOCOL else str(int(ITERS * 0.6)),
        "--densification_interval", "200",
        "--opacity_reset_interval", "3000",
        "--test_iterations", *ev, "--save_iterations", *ev,
        "--max_per_tile", str(max_per_tile)]
    if PROTOCOL:
        # 102K Gaussians at 448^2: coverage-bound pair counts; overflow stays
        # counted and reported
        args += ["--pair_capacity_per_gaussian", "6",
                 "--row_capacity_per_gaussian", "3"]
    return args


def checkpoint_iterations() -> list[int]:
    """Every eval iteration and every CHECKPOINT_EVERY."""
    return sorted(set(EVAL_ITERS) | set(range(CHECKPOINT_EVERY, ITERS + 1,
                                              CHECKPOINT_EVERY)))


@contextlib.contextmanager
def wrapped(owner, name: str, wrap):
    """`owner.name` replaced by `wrap(owner.name)` inside the block."""
    orig = getattr(owner, name)
    setattr(owner, name, wrap(orig))
    try:
        yield
    finally:
        setattr(owner, name, orig)


class Recorder:
    """What a run reads off the port's own calls: the largest overflow
    counters of the training steps' metrics or of the renders, whether every
    training loss was finite (both kept on the device, read once at the
    end), and the ms of each densify and capacity growth (host clock between
    two synchronizes)."""

    def __init__(self, device: torch.device):
        self.device = device
        self.maxima: dict[str, torch.Tensor] = {}
        self.finite = torch.ones((), dtype=torch.bool, device=device)
        self.events: dict[str, list[float]] = {"densify": [], "grow": []}

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def keep_max(self, key: str, value: torch.Tensor):
        old = self.maxima.get(key)
        self.maxima[key] = value if old is None else torch.maximum(old, value)

    def read_max(self) -> dict[str, int]:
        return {k: int(v) for k, v in self.maxima.items()}

    def steps(self, fn):
        @functools.wraps(fn)
        def step(*args, **kwargs):
            out = fn(*args, **kwargs)
            self.keep_max("tile_overflow", out["tile_overflow"])
            self.keep_max("rect_overflow", out["rect_overflow"])
            self.finite &= torch.isfinite(out["loss"])
            return out
        return step

    def renders(self, fn):
        @functools.wraps(fn)
        def render(*args, **kwargs):
            out = fn(*args, **kwargs)
            self.keep_max("tile_overflow", out.tile_overflow)
            self.keep_max("rect_overflow", out.rect_overflow)
            return out
        return render

    def timed(self, kind: str):
        def wrap(fn):
            @functools.wraps(fn)
            def event(*args, **kwargs):
                self.sync()
                t0 = time.perf_counter()
                out = fn(*args, **kwargs)
                self.sync()
                self.events[kind].append((time.perf_counter() - t0) * 1e3)
                return out
            return event
        return wrap


def checkpoint_iteration(model: str) -> int:
    """The iteration of the newest checkpoint in `model`, 0 without one."""
    from gaussianmesh_tpu_torch.cli.train_mesh import latest_checkpoint

    found = latest_checkpoint(model)
    if found is None:
        return 0
    return int("".join(c for c in os.path.basename(found) if c.isdigit()))


def train_segment(argv: list[str], device: torch.device) -> dict:
    """One `cli.train_mesh` call, timed on the host clock, with its steps,
    densifies and capacity growths recorded. -> the segment's record."""
    from gaussianmesh_tpu_torch.cli import train_mesh as cli_train
    from gaussianmesh_tpu_torch.train.trainer import MeshTrainer

    rec = Recorder(device)
    with wrapped(MeshTrainer, "step", rec.steps), \
            wrapped(MeshTrainer, "densify", rec.timed("densify")), \
            wrapped(MeshTrainer, "_grow", rec.timed("grow")):
        t0 = time.time()
        trainer = cli_train.main(argv)
        rec.sync()
        seconds = time.time() - t0
    return {"seconds": seconds, "to": trainer.global_it,
            "losses_finite": bool(rec.finite),
            "overflow": rec.read_max(),
            "densify_ms": rec.events["densify"], "grow_ms": rec.events["grow"],
            "densify_splits": [info["n_split"] for _, kind, info in trainer.events
                               if kind == "densify"]}


def evaluate(model: str, it: int, device: torch.device) -> tuple[dict, dict]:
    """`cli.render` of the test views at iteration `it`, then `cli.metrics`
    with the uncalibrated LPIPS. -> (results.json's ours_<it>, the largest
    overflow counters of the renders)."""
    from gaussianmesh_tpu_torch.cli import metrics as cli_metrics
    from gaussianmesh_tpu_torch.cli import render as cli_render
    from gaussianmesh_tpu_torch.models import render as render_mod

    rec = Recorder(device)
    with wrapped(render_mod, "render", rec.renders):
        cli_render.main(["-m", model, "--iteration", str(it), "--skip_train",
                         "--device", device.type])
    # LPIPS_uncalibrated: the seed-weight graph (eval/lpips.py): deltas
    # along the trajectory mean something, the absolute value does not
    cli_metrics.main(["-m", model, "--lpips_uncalibrated", "--device", device.type])
    with open(os.path.join(model, "results.json")) as fh:
        return json.load(fh)[f"ours_{it}"], rec.read_max()


def as_8bit(color, device) -> torch.Tensor:
    """(3, H, W) color -> the float image of the PNG `cli.render` writes of
    it, as `cli.metrics` reads it back."""
    from gaussianmesh_tpu_torch.cli.common import to_uint8

    return torch.from_numpy(to_uint8(color).transpose(2, 0, 1).astype(np.float32)
                            / 255.0).to(device)


def clamp_view(arrays, cam, cfg, bg, gt) -> dict:
    """One view of the clamp report: `arrays` rendered at `cfg.max_per_tile`
    and with no clamp, both held against `gt` (3, H, W), as 8-bit images."""
    import dataclasses

    from gaussianmesh_tpu_torch.models import render as render_mod
    from gaussianmesh_tpu_torch.ops.preprocess import TILE
    from gaussianmesh_tpu_torch.ops.rasterize import tile_pair_counts
    from gaussianmesh_tpu_torch.ops.tile_blend import ALPHA_MIN, T_EPS
    from gaussianmesh_tpu_torch.train.loss import psnr

    raw = tile_pair_counts(arrays.xyz, arrays.cov6, arrays.opacity, cam, cfg,
                           arrays.active)
    largest = int(raw.max())
    clamped = render_mod.render(arrays, cam, cfg, bg)
    free = render_mod.render(arrays, cam, dataclasses.replace(
        cfg, max_per_tile=max(largest, 1)), bg)
    dropped = int((raw - raw.clamp(max=cfg.max_per_tile)).sum())
    assert dropped == int(clamped.tile_overflow) and int(free.tile_overflow) == 0
    cut = raw > cfg.max_per_tile
    ys = torch.arange(cfg.height, device=raw.device)[:, None] // TILE
    xs = torch.arange(cfg.width, device=raw.device)[None, :] // TILE
    in_cut = cut[ys * cfg.grid[0] + xs]
    t_kept = clamped.final_t[in_cut]
    img_c, img_u = as_8bit(clamped.color, gt.device), as_8bit(free.color, gt.device)
    return {"largest_tile": largest, "dropped": dropped, "cut_tiles": int(cut.sum()),
            "t_share": float((t_kept >= T_EPS).float().mean()) if t_kept.numel() else 0.0,
            # a blended pair has alpha >= ALPHA_MIN: T falls by that share at least
            "shown_share": (float((free.final_t[in_cut] < t_kept * (1 - 0.5 * ALPHA_MIN))
                                  .float().mean()) if t_kept.numel() else 0.0),
            "psnr_renders": (None if torch.equal(img_c, img_u)
                             else float(psnr(img_c, img_u))),
            "psnr_clamped": float(psnr(img_c, gt)),
            "psnr_unclamped": float(psnr(img_u, gt))}


# the clamp report's figures and which end of them is the worst view's
WORST = {"largest_tile": max, "dropped": max, "cut_tiles": max, "t_share": max,
         "shown_share": max, "psnr_renders": min, "psnr_clamped": min,
         "psnr_unclamped": min}


def clamp_report(model: str, it: int, device: torch.device) -> dict:
    """The clamp report of iteration `it`'s table on the held-out views, as
    `cli.render` loads them (the run's `cfg_args.json`): {"max_per_tile",
    "views": [per view], "worst": {figure: worst view's}, "mean": {figure:
    mean over views}}. `psnr_renders` is null for a view whose two renders
    are equal; its worst and mean are over the other views
    (`identical_views` counts them)."""
    from gaussianmesh_tpu_torch import config as cfg_mod
    from gaussianmesh_tpu_torch.cli.common import base_parser
    from gaussianmesh_tpu_torch.io import gaussian_ply
    from gaussianmesh_tpu_torch.models import render as render_mod
    from gaussianmesh_tpu_torch.ops.rasterize import RasterizerConfig
    from gaussianmesh_tpu_torch.scene import Scene

    groups = cfg_mod.load_combined(model, base_parser("clamp report").parse_args(
        ["-m", model]))
    params, rt = groups["model"], groups["runtime"]
    fg, _ = gaussian_ply.load_mesh_gaussian_ply(
        os.path.join(model, "point_cloud", f"iteration_{it}", "point_cloud.ply"),
        max_sh_degree=params.sh_degree, device=device)
    bg = torch.full((3,), 1.0 if params.white_background else 0.0, device=device)
    views = []
    with torch.no_grad():
        for cam in Scene(params, shuffle=False).test_cameras:
            ca = cam.arrays(device)
            views.append(clamp_view(render_mod.mesh_model_arrays(fg, ca, params.sh_degree),
                                    ca, RasterizerConfig.from_runtime(
                                        rt, cam.width, cam.height), bg,
                                    as_8bit(cam.image, device)))
    worst, mean = {}, {}
    for key, pick in WORST.items():
        vals = [v[key] for v in views if v[key] is not None]
        worst[key] = pick(vals) if vals else None
        mean[key] = float(np.mean(vals)) if vals else None
    return {"max_per_tile": rt.max_per_tile, "views": views, "worst": worst,
            "mean": mean,
            "identical_views": sum(v["psnr_renders"] is None for v in views)}


def card(device: torch.device) -> dict:
    """The card's name and power limit as nvidia-smi gives them; on the CPU
    the torch device."""
    if device.type != "cuda":
        return {"name": str(device), "power.limit": None}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", str(device.index or 0)],
                         capture_output=True, text=True, check=True).stdout.strip()
    name, limit = (s.strip() for s in smi.rsplit(",", 1))
    return {"name": name, "power.limit": limit}


def count_gaussians(ply_path: str) -> int:
    from gaussianmesh_tpu_torch.io import ply as ply_io

    return int(ply_io.read_ply(ply_path)["vertex"]["x"].shape[0])


def default_out() -> str:
    name = "config2_quality_torch_smoke.json" if SMALL else "config2_quality_torch.json"
    return os.path.join(ROOT, "results", name)


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("work", nargs="?",
                        default=os.path.join(tempfile.gettempdir(), "gm_quality_torch"))
    parser.add_argument("--device", default=None,
                        help="cuda (the default; raises without a card) or cpu")
    parser.add_argument("--seed", type=int, default=None,
                        help="train_mesh's --seed (its default, 0, when not given)")
    parser.add_argument("--out", default=None, help="the artifact's path")
    parser.add_argument("--max_per_tile", type=int, default=MAX_PER_TILE,
                        help="the training run's per-tile pair clamp (768, the "
                             "JAX tool's; 1048576 never clamps at this size: the "
                             "reference's unclamped blend)")
    args = parser.parse_args(argv)

    from gaussianmesh_tpu_torch import resolve_device

    device = resolve_device(args.device)
    data = os.path.join(args.work, "data")
    model = os.path.join(args.work, "model")
    os.makedirs(data, exist_ok=True)
    print(f"[quality] dataset {W}x{H}, {N_CAMS} cams -> {data}", flush=True)
    mesh_path = make_dataset(data, device)

    seg_path = os.path.join(args.work, "segments.json")
    segments = []
    if os.path.exists(seg_path):
        with open(seg_path) as fh:
            segments = json.load(fh)
    start = checkpoint_iteration(model)
    if start < ITERS:
        argv_train = train_args(data, model, mesh_path, args.max_per_tile) + [
            "--checkpoint_iterations", *map(str, checkpoint_iterations()),
            "--auto_resume", "--device", device.type]
        if args.seed is not None:
            argv_train += ["--seed", str(args.seed)]
        seg = {"from": start, **train_segment(argv_train, device)}
        segments.append(seg)
        with open(seg_path, "w") as fh:
            json.dump(segments, fh)
        print(f"[quality] segment {len(segments)}: iterations {seg['from']} -> "
              f"{seg['to']} in {seg['seconds']:.1f} s", flush=True)
    else:
        print(f"[quality] trained: checkpoint at {start}, nothing to resume", flush=True)
    train_s = sum(s["seconds"] for s in segments)
    print(f"[quality] trained {ITERS} iters in {train_s:.0f}s "
          f"({ITERS / train_s:.2f} it/s) over {len(segments)} segment(s)", flush=True)

    traj, eval_overflow, clamp = {}, {}, {}
    for it in EVAL_ITERS:
        traj[str(it)], eval_overflow[str(it)] = evaluate(model, it, device)
        print(f"[quality] iter {it}: {traj[str(it)]}", flush=True)
        clamp[str(it)] = clamp_report(model, it, device)
        print(f"[quality] iter {it} clamp report: worst {json.dumps(clamp[str(it)]['worst'])}",
              flush=True)

    densify_ms = [x for s in segments for x in s["densify_ms"]]
    grow_ms = [x for s in segments for x in s["grow_ms"]]
    train_overflow = {k: max(s["overflow"][k] for s in segments)
                      for k in ("tile_overflow", "rect_overflow")}
    out = {
        "config": 2,
        "protocol": ("train_mesh_gaussian.py full protocol: 30K iters, "
                     ">=100K gaussians, densify every 200 in (500,15000], "
                     "opacity reset every 3000; eval on held-out views "
                     "(every 8th)" if PROTOCOL else
                     "train_mesh_gaussian.py-style eval at fixed iters "
                     "on held-out views (every 8th)"),
        "resolution": [W, H],
        "iterations": ITERS,
        "init_target": INIT_TARGET,
        "backend": device.type,
        "device": card(device),
        "seed": 0 if args.seed is None else args.seed,
        "max_per_tile": args.max_per_tile,
        "train_seconds": round(train_s, 1),
        "iters_per_second": round(ITERS / train_s, 2),
        "segments": len(segments),
        "trajectory": traj,
        "n_gauss_final": count_gaussians(os.path.join(
            model, "point_cloud", f"iteration_{ITERS}", "point_cloud.ply")),
        "host_events": {
            "densify": {"count": len(densify_ms), "total_ms": sum(densify_ms),
                        "ms": densify_ms,
                        "n_split": [x for s in segments for x in s["densify_splits"]]},
            "grow": {"count": len(grow_ms), "total_ms": sum(grow_ms), "ms": grow_ms}},
        "overflow": {"train": train_overflow, "eval": eval_overflow},
        "clamp": clamp,
        "losses_finite": all(s["losses_finite"] for s in segments),
        "lpips_note": ("LPIPS_uncalibrated uses the deterministic seed-0 "
                       "graph weights (eval/lpips.py): trajectory deltas are "
                       "meaningful, absolute values are NOT comparable to "
                       "published LPIPS; the calibrated LPIPS field stays null "
                       "until weights/lpips_vgg16.npz is in the repository"),
        "reset_note": ("evals at {2950, 3000, 3050} bracket the "
                       "iter-3000 opacity reset: the dip AT 3000 is the "
                       "eval running right after the reset (reference "
                       "ordering), not a training bug"
                       if PROTOCOL else None),
        "reproduce": ("GM_QUALITY_PROTOCOL=1 python tools/quality_run_torch.py"
                      if PROTOCOL else
                      "GM_QUALITY_SMALL=1 python tools/quality_run_torch.py"
                      if SMALL else "python tools/quality_run_torch.py")
                     + ("" if args.seed is None else f" --seed {args.seed}")
                     + ("" if args.max_per_tile == MAX_PER_TILE
                        else f" --max_per_tile {args.max_per_tile}"),
    }
    print(f"[quality] largest overflow: train {json.dumps(train_overflow)}, eval "
          f"renders {json.dumps(eval_overflow)}", flush=True)
    print(f"[quality] host events: {len(densify_ms)} densifies, "
          f"{sum(densify_ms):.1f} ms in all; {len(grow_ms)} capacity growths, "
          f"{sum(grow_ms):.1f} ms in all", flush=True)
    path = args.out or default_out()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as fh:
        json.dump(out, fh, indent=1)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
