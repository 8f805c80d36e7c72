"""Deformation-playback benchmarks of the PyTorch port on one card: configs
3, 5 and 4 at 1080p (the port of `tools/bench_playback.py`).

    python3 tools/bench_playback_torch.py [--device cpu] [--out PATH]
        [--width W --height H --frames F --level L --side_level L2
         --n_bg N --steps4 S --warm4 K]

Config 3, one object: `make_object(level=6)` (81,920 near-opaque Gaussians
on an icosphere, one per face, colours from the centroids), written as PLY
+ OBJ and loaded by `edit/runtime.py::ObjectDeformer`; 64 twist frames
(amplitude 0.6) at 1080p, `max_per_tile` 1024, through `make_playback_fn`
(one-ring deformation gradients -> polar R / S -> barycentric transfer ->
SH at the rotated view directions -> rasterize, K1). Per frame the host
clock around the frame function, ending in a synchronize; the device's
busy ms and operations per frame from torch.profiler (taken after every
host time of the tool) and its idle share, 1 - busy / the median frame; the
frames' mean pixel; the largest |R^ - I| (Frobenius) over the frames'
interpolated rotations, which is not 0 (the JAX tool's artifact has
R = S = I at this level, so the two are not compared). Every frame's
`tile_overflow` and `rect_overflow` must be 0.

Config 5, composite: a `SceneEditor` of the level-6 object, two level-4
objects at (2.2, 0.6, 0) and (-2.2, -0.6, 0.3) and a 100,000-Gaussian
background (uniform(-6, 6) positions, uniform colours, log-scale ln 0.05,
SH degree 1, through a PLY round trip), played through
`make_composite_playback_fn` and a black background; overflow 0 in every
frame, as in config 3. The static set's pair / row capacities start at the
JAX tool's 8 / 3 per Gaussian and double until it bins with no
`rect_overflow` (`load_sized`; `static` in the artifact: the capacities,
the overflow and the live pairs at 8 / 3 and at those used). At 8 / 3 the
counter is not 0 at this scene's size though every live pair is kept: in
the slot model both packages share, each unused row slot takes a pair
slot.

Config 5's tile axis: for D = 2 and 4 each band of D is timed alone through
`parallel/train_step.py::rasterize_band` (the deformed object and the
static set concatenated) with the JAX tool's load-sized capacities, doubled
while a band overflows: the per-band ms, the critical path (the largest
band), each band's largest overflow at the JAX tool's capacities and at
those timed. The band keeps the image's height H (the JAX tool renders at the
padded height, fault B9).

Config 4, background training: one `BgTrainer` step at 1080p, the level-6
object frozen at opacity logit 4, the 100,000-Gaussian background (the next
draws of the same generator), a 0.5-grey target, densify and resets off,
capacity 102,400; 3 warm steps, then 30 timed, first at the JAX tool's
runtime parameters (`jax_runtime`: `max_per_tile` 1024, 10 pairs and 4
rows per Gaussian, whose overflow counters it reports), then at those
`load_sized` gives the step's scene (doubled until no slot and no tile
overflows), the step a user who drops no pair pays for.

Writes results/playback_torch.json (or --out) afresh, never merged into an
old one, with the card's name and power limit, and prints one line:
  {"metric": "playback_fps_1080p", "value": config-3 fps, "unit": "fps",
   "vs_baseline": fps / 30, "detail": {...}}
The size flags exist for the CPU tests; the defaults are the JAX tool's
sizes. Runs on CUDA unless `--device cpu`; with no card it raises.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _p in (ROOT, os.path.join(ROOT, "tools")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import numpy as np  # noqa: E402
import torch  # noqa: E402

WIDTH, HEIGHT = 1920, 1080
FRAMES = 64
LEVEL, SIDE_LEVEL = 6, 4
SIDE_OFFSETS = ((2.2, 0.6, 0.0), (-2.2, -0.6, 0.3))
N_BG = 100_000
STEPS4, WARM4 = 30, 3
CAPACITY4 = 102_400
PROFILED = 3
FPS_BAR = 30.0


def frame_loop(frame_fn, frames, dev):
    """Host ms of each frame (one warm frame first) -> (ms list, outputs)."""
    import timing_torch as timing

    frame_fn(frames[-1])
    times, outs = [], []
    for v in frames:
        timing.sync(dev)
        t0 = time.perf_counter()
        outs.append(frame_fn(v))
        timing.sync(dev)
        times.append((time.perf_counter() - t0) * 1e3)
    return times, outs


def frame_stats(times, outs, label) -> dict:
    """Times, mean pixel and overflow of a frame loop; raises on any
    overflow or a non-finite image."""
    for i, o in enumerate(outs):
        if not bool(torch.isfinite(o.color).all()):
            raise FloatingPointError(f"{label}: frame {i} is not finite")
        if int(o.tile_overflow) or int(o.rect_overflow):
            raise AssertionError(f"{label}: frame {i} overflows (tile "
                                 f"{int(o.tile_overflow)}, rect {int(o.rect_overflow)})")
    mean_ms = float(np.mean(times))
    return dict(frame_ms_mean=mean_ms, frame_ms_median=float(np.median(times)),
                frame_ms=times, fps=1e3 / mean_ms,
                mean_px=float(np.mean([float(o.color.mean()) for o in outs])),
                num_rendered=[int(o.num_rendered) for o in outs],
                tile_overflow_max=max(int(o.tile_overflow) for o in outs),
                rect_overflow_max=max(int(o.rect_overflow) for o in outs))


def background(n, rng, device, sh_degree=1):
    """The JAX tool's background: n Gaussians at uniform(-6, 6) with
    uniform colours from `rng`, log-scale ln 0.05."""
    from gaussianmesh_tpu_torch.models import gaussians as gs

    model = gs.create_from_points(rng.uniform(-6, 6, (n, 3)).astype(np.float32),
                                  rng.uniform(0, 1, (n, 3)).astype(np.float32),
                                  capacity=n, max_sh_degree=sh_degree, device=device)
    with torch.no_grad():
        model.scaling.fill_(math.log(0.05))
    return model


@torch.no_grad()
def load_sized(arrays, cam, cfg, tiles=True, band=None):
    """cfg's pair / row capacities doubled until `arrays` seen from `cam`
    bin with no `rect_overflow`, then (with `tiles`) its `max_per_tile`
    doubled until no tile holds more -> (that config, a record: the
    capacities, the live pairs and the overflow at cfg's and at the
    chosen, the largest tile). `band` = (y0_tiles, gy_local) sizes for that
    band of the image alone, as `rasterize(..., band=)` bins it."""
    from gaussianmesh_tpu_torch.ops import binning, preprocess as prep_mod
    from gaussianmesh_tpu_torch.ops.rasterize import band_view

    n = arrays.xyz.shape[0]
    prep = prep_mod.preprocess(arrays.xyz, arrays.cov6, cam, cfg.width, cfg.height,
                               opacity=arrays.opacity)
    prep = prep._replace(valid=prep.valid & arrays.active)
    gx, gy = cfg.grid
    if band is not None:
        prep, gy = band_view(prep, *band), band[1]

    def probe(c):
        e = binning.expand_pairs(prep, gx, gy, c.expand_capacity(n), opacity=arrays.opacity,
                                 row_capacity=c.row_capacity(n))
        return int(e.rect_overflow), int(e.pair_tile.shape[0]), e.pair_tile

    c = cfg
    overflow0, pairs0, _ = overflow, pairs, pair_tile = probe(c)
    while overflow:
        c = dataclasses.replace(c, pair_capacity_per_gaussian=2 * c.pair_capacity_per_gaussian,
                                row_capacity_per_gaussian=2 * c.row_capacity_per_gaussian)
        overflow, pairs, pair_tile = probe(c)
    largest = int(torch.bincount(pair_tile, minlength=gx * gy).max()) if pairs else 0
    while tiles and c.max_per_tile < largest:
        c = dataclasses.replace(c, max_per_tile=2 * c.max_per_tile)
    return c, dict(capacity=[c.pair_capacity_per_gaussian, c.row_capacity_per_gaussian],
                   pairs=pairs, largest_tile=largest,
                   start_capacity=[cfg.pair_capacity_per_gaussian,
                                   cfg.row_capacity_per_gaussian],
                   start_rect_overflow=overflow0, start_pairs=pairs0)


def profile_later(deferred, res, fn, host_key):
    """Queue a profile of fn() into `res` (busy_ms, device_operations and
    the idle share against res[host_key]) for `run_profiles`."""
    deferred.append((res, fn, host_key))
    return res


def run_profiles(deferred, dev):
    """torch.profiler over PROFILED calls of each queued function, after
    every host time is taken: a profiler session slows the process's later
    launches (`timing_torch.profile`)."""
    import timing_torch as timing

    for res, fn, host_key in deferred:
        prof = timing.profile(fn, PROFILED, dev)
        res.update(busy_ms=prof["busy_ms"], device_operations=prof["device_operations"],
                   idle_share=timing.idle_share(prof["busy_ms"], res[host_key]))


def run_config3(obj, cam, cfg, frames, dev, deferred, keep=None) -> dict:
    from gaussianmesh_tpu_torch.edit import runtime

    frame_fn = runtime.make_playback_fn(obj, cam, cfg, None)
    times, outs = frame_loop(frame_fn, frames, dev)
    if keep is not None:
        keep["config3"] = [o.color.cpu() for o in outs]
    res = profile_later(deferred, frame_stats(times, outs, "config 3"),
                        lambda: frame_fn(frames[0]), "frame_ms_median")
    eye = torch.eye(3, device=dev)
    rot = 0.0
    for v in frames:
        r_hat = obj.transfer(v)[2]
        rot = max(rot, float(torch.linalg.matrix_norm(r_hat - eye).max()))
    res["cov_rotation_max"] = rot
    return res


def run_tile_axis(main_obj, static_arrays, cam, width, height, frames, bg, dev) -> dict:
    """Config 5's bands of D = 2, 4, each alone, with load-sized capacities."""
    from gaussianmesh_tpu_torch.edit import runtime
    from gaussianmesh_tpu_torch.models.render import concat_arrays
    from gaussianmesh_tpu_torch.ops.rasterize import RasterizerConfig
    from gaussianmesh_tpu_torch.parallel.train_step import rasterize_band

    import timing_torch as timing

    def time_bands(d, gy_local, bcfg):
        per_band, overflow = [], []
        for k in range(d):
            @torch.no_grad()
            def band(v_def, y0=k * gy_local):
                arrays = concat_arrays(runtime.deformed_object_arrays(main_obj, v_def, cam),
                                       static_arrays)
                return rasterize_band(arrays, cam, bcfg, gy_local, y0, bg)

            band(frames[-1])
            timing.sync(dev)
            t0 = time.perf_counter()
            outs = [band(v) for v in frames]
            timing.sync(dev)
            per_band.append((time.perf_counter() - t0) * 1e3 / len(frames))
            overflow.append(max(int(o.tile_overflow + o.rect_overflow + o.pair_overflow)
                                for o in outs))
        return per_band, overflow

    per_d = {}
    for d in (2, 4):
        gy = (height + 15) // 16
        gy_local = -(-gy // d)
        jax_cap = [max(2, -(-10 // d) + 1), max(1, -(-4 // d))]
        cap, jax_overflow = jax_cap, None
        while True:     # the JAX tool's capacities, doubled while a band overflows
            bcfg = RasterizerConfig(width, height, max_per_tile=1024,
                                    pair_capacity_per_gaussian=cap[0],
                                    row_capacity_per_gaussian=cap[1])
            per_band, overflow = time_bands(d, gy_local, bcfg)
            jax_overflow = overflow if jax_overflow is None else jax_overflow
            if not any(overflow):
                break
            cap = [2 * cap[0], 2 * cap[1]]
        crit = max(per_band)
        per_d[str(d)] = dict(gy_local=gy_local, per_band_ms=per_band, critical_ms=crit,
                             fps=1e3 / crit, max_overflow=overflow, capacity=cap,
                             jax_capacity=jax_cap, jax_capacity_max_overflow=jax_overflow)
    return dict(note=("each band of D timed alone on one card (rasterize_band, no "
                      "collective on this forward path); fps = 1 / the largest band's "
                      "ms, assuming D cards run their bands at once"), per_d=per_d)


def run_config4(v, f, rng, n_bg, cam, width, height, steps, warm, dev, deferred) -> dict:
    """Config 4's step timed at the JAX tool's runtime parameters
    (`max_per_tile` 1024, 10 pairs and 4 rows per Gaussian), then at those
    `load_sized` gives for the step's scene, which drops nothing."""
    from gaussianmesh_tpu_torch.config import OptimizationParams, RuntimeParams
    from gaussianmesh_tpu_torch.models import mesh_gaussians as mgs
    from gaussianmesh_tpu_torch.models import render as render_mod
    from gaussianmesh_tpu_torch.train.bg_trainer import BgTrainer
    from gaussianmesh_tpu_torch.train.trainer import DeviceDataset

    import timing_torch as timing

    n = f.shape[0]
    fg = mgs.create_from_mesh(v, f, capacity=n, vertex_capacity=4 * n, device=dev)
    with torch.no_grad():
        fg.opacity.fill_(4.0)
    gt = np.full((1, 3, height, width), 0.5, np.float32)
    ds = DeviceDataset(view=cam.viewmatrix[None], proj=cam.projmatrix[None],
                       campos=cam.campos[None], tanfovx=cam.tanfovx[None],
                       tanfovy=cam.tanfovy[None],
                       images=torch.tensor((gt * 255).astype(np.uint8), device=dev),
                       masks=None, width=width, height=height)
    opt = OptimizationParams(densify_from_iter=10**9, opacity_reset_interval=10**9)
    rt = RuntimeParams(max_per_tile=1024, capacity=max(CAPACITY4, n_bg))
    trainer = BgTrainer(fg, rng.uniform(-6, 6, (n_bg, 3)).astype(np.float32),
                        rng.uniform(0, 1, (n_bg, 3)).astype(np.float32), ds, opt, rt,
                        spatial_lr_scale=4.0)

    def timed():
        if warm:
            trainer.train(iterations=warm, log_every=10**9)
        timing.sync(dev)
        t0 = time.perf_counter()
        last = trainer.train(iterations=steps, log_every=10**9)[-1]
        timing.sync(dev)
        step_ms = (time.perf_counter() - t0) * 1e3 / steps
        if not math.isfinite(last["loss"]):
            raise FloatingPointError(f"config 4: loss {last['loss']}")
        return dict(train_step_ms=step_ms, it_per_s=1e3 / step_ms, loss=last["loss"],
                    tile_overflow=int(last["tile_overflow"]),
                    rect_overflow=int(last["rect_overflow"]),
                    num_rendered=int(last["num_rendered"]))

    jax_run = dict(max_per_tile=rt.max_per_tile,
                   capacity=[rt.pair_capacity_per_gaussian, rt.row_capacity_per_gaussian],
                   **timed())
    with torch.no_grad():           # the step's scene: background rows first
        arrays = render_mod.concat_arrays(
            render_mod.gaussian_model_arrays(trainer.model, cam, trainer.sh_degree),
            render_mod.mesh_model_arrays(fg, cam, trainer.max_sh_degree))
    cfg, sized = load_sized(arrays, cam, trainer.raster_cfg())
    trainer.rt = dataclasses.replace(rt, max_per_tile=cfg.max_per_tile,
                                     pair_capacity_per_gaussian=cfg.pair_capacity_per_gaussian,
                                     row_capacity_per_gaussian=cfg.row_capacity_per_gaussian)
    res = dict(n_gauss=n + n_bg, table_rows=trainer.model.capacity + n, steps=steps,
               warm=warm, max_per_tile=cfg.max_per_tile, sized=sized, **timed(),
               jax_runtime=jax_run)
    return profile_later(deferred, res,
                         lambda: trainer.train(iterations=1, log_every=10**9),
                         "train_step_ms")


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("--out", default=os.path.join(ROOT, "results", "playback_torch.json"))
    p.add_argument("--width", type=int, default=WIDTH)
    p.add_argument("--height", type=int, default=HEIGHT)
    p.add_argument("--frames", type=int, default=FRAMES)
    p.add_argument("--level", type=int, default=LEVEL, help="the main object's icosphere")
    p.add_argument("--side_level", type=int, default=SIDE_LEVEL)
    p.add_argument("--n_bg", type=int, default=N_BG)
    p.add_argument("--steps4", type=int, default=STEPS4)
    p.add_argument("--warm4", type=int, default=WARM4)
    return p


def main(argv=None, keep=None) -> dict:
    """Run the four sections -> the artifact (also written to --out).
    `keep`, a dict, receives config 3's frames (CPU tensors) under
    "config3"."""
    from gaussianmesh_tpu_torch import resolve_device
    from gaussianmesh_tpu_torch.edit import runtime
    from gaussianmesh_tpu_torch.io import gaussian_ply
    from gaussianmesh_tpu_torch.models.render import concat_arrays
    from gaussianmesh_tpu_torch.ops.rasterize import RasterizerConfig

    import scenes_torch
    import timing_torch as timing

    args = parser().parse_args(argv)
    dev = resolve_device(args.device)
    card = timing.card(dev)
    w, h = args.width, args.height
    cam = scenes_torch.look_at_camera(w, h, distance=4.0, device=dev)
    out = dict(tool="tools/bench_playback_torch.py", device=str(dev), card=card["name"],
               power_limit=card["power_limit"], width=w, height=h, frames=args.frames)
    deferred = []   # profiles, taken once every host time is
    with tempfile.TemporaryDirectory(prefix="gm_playback_torch_") as tmp:
        # config 3: one object
        ply, objpath, v, f = scenes_torch.make_object(tmp, args.level, "main", device=dev)
        obj = runtime.ObjectDeformer(ply, objpath, device=dev)
        cfg = RasterizerConfig(w, h, max_per_tile=1024)
        frames = torch.tensor(scenes_torch.twist_frames(v, args.frames), device=dev)
        out["config3"] = run_config3(obj, cam, cfg, frames, dev, deferred, keep)
        out["config3"].update(n_gauss=int(obj.n), level=args.level,
                              proxy=dict(verts=int(v.shape[0]), faces=int(f.shape[0])),
                              max_per_tile=cfg.max_per_tile)
        print(f"config 3: {obj.n} Gaussians, {out['config3']['frame_ms_mean']:.3f} ms a "
              f"frame ({out['config3']['fps']:.1f} fps)", flush=True)

        # config 5: the object among two static objects and a background
        editor = runtime.SceneEditor(device=dev)
        editor.add_object(ply, objpath, name="main")
        for i, off in enumerate(SIDE_OFFSETS):
            p2, o2, _, _ = scenes_torch.make_object(tmp, args.side_level, f"side{i}",
                                                    offset=off, device=dev)
            editor.add_object(p2, o2, name=f"side{i}")
        rng = np.random.default_rng(0)
        bg_ply = os.path.join(tmp, "bg.ply")
        gaussian_ply.save_gaussian_ply(bg_ply, background(args.n_bg, rng, dev))
        editor._bg = gaussian_ply.load_gaussian_ply(bg_ply, max_sh_degree=1, device=dev)
        editor._bg_sh_degree = 1
        n_total = sum(int(o.n) for o in editor.objects.values()) + args.n_bg
        black = torch.zeros(3, device=dev)
        cfg5 = RasterizerConfig(w, h, max_per_tile=1024)
        with torch.no_grad():
            parts = [o.arrays(cam) for name, o in editor.objects.items() if name != "main"]
            static_arrays = parts[0]
            for a in parts[1:] + [editor._bg_arrays(cam)]:
                static_arrays = concat_arrays(static_arrays, a)
        # the static set's capacities from the JAX tool's 8 / 3 per Gaussian up
        static_cfg, static = load_sized(static_arrays, cam, dataclasses.replace(
            cfg5, pair_capacity_per_gaussian=8, row_capacity_per_gaussian=3), tiles=False)
        timing.sync(dev)
        t0 = time.perf_counter()
        frame5 = runtime.make_composite_playback_fn(editor, "main", cam, cfg5, black,
                                                    static_cfg=static_cfg)
        timing.sync(dev)
        static_ms = (time.perf_counter() - t0) * 1e3
        times5, outs5 = frame_loop(frame5, frames, dev)
        out["config5"] = profile_later(deferred, frame_stats(times5, outs5, "config 5"),
                                       lambda: frame5(frames[0]), "frame_ms_median")
        out["config5"].update(n_gauss_total=n_total, side_level=args.side_level,
                              n_bg=args.n_bg, static=static,
                              static_precompute_ms=static_ms)
        del outs5
        print(f"config 5: {n_total} Gaussians, {out['config5']['frame_ms_mean']:.3f} ms "
              f"a frame ({out['config5']['fps']:.1f} fps)", flush=True)

        out["config5_tile_axis"] = run_tile_axis(editor.objects["main"], static_arrays,
                                                 cam, w, h, frames, black, dev)
        for d, r in out["config5_tile_axis"]["per_d"].items():
            print(f"config 5, D = {d}: bands {[round(x, 3) for x in r['per_band_ms']]} ms, "
                  f"overflow {r['max_overflow']}", flush=True)

    # config 4: one background training step
    out["config4"] = run_config4(v, f, rng, args.n_bg, cam, w, h, args.steps4,
                                 args.warm4, dev, deferred)
    print(f"config 4: {out['config4']['train_step_ms']:.3f} ms a step", flush=True)
    run_profiles(deferred, dev)

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:              # afresh: never merged (fault B5)
        json.dump(out, fh, indent=1)
    fps3 = out["config3"]["fps"]
    print(json.dumps({
        "metric": "playback_fps_1080p", "value": fps3, "unit": "fps",
        "vs_baseline": fps3 / FPS_BAR,
        "detail": {"config3_fps": fps3, "config5_fps": out["config5"]["fps"],
                   "config4_it_per_s": out["config4"]["it_per_s"],
                   "config3_n_gauss": out["config3"]["n_gauss"],
                   "config5_n_gauss_total": n_total, "card": card["name"],
                   "power_limit": card["power_limit"], "file": args.out},
    }), flush=True)
    return out


if __name__ == "__main__":
    main()
