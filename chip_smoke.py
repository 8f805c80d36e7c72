#!/usr/bin/env python3
"""Drive the PyTorch port's render path on one CUDA card and check it.

    python3 chip_smoke.py

Phases (any failure raises, so the exit code is not 0):

1. card: needs CUDA; prints torch, the card's name and power limit.
2. build: compiles every CUDA kernel of the port from `csrc/` (one nvcc per
   source, in parallel) and prints nvcc's register / shared-memory lines.
3. oracle: a small scene rendered on the card through `rasterize` agrees
   with the port's sequential oracle renderer.
4. slice: a mesh-bound model at the size of a trained config-2 model
   (icosphere subdivision 7: 327,680 faces, one Gaussian each, SH degree 3),
   perturbed from a seed to look trained, saved as a PLY, loaded back on
   the card and rendered at 1920x1080 from 8 orbit views through
   `mesh_model_arrays` -> `render`. Every kernel of the path must have
   launched there (launch counters set to 0 just before, read just after).
   A profiled pass over 3 more frames prints device time by kernel and the
   device's idle share.
5. kernels: each kernel against its plain PyTorch version on the slice's own
   inputs (and an overflow-clamped config), timed with CUDA events, with
   its bound (bytes or operations) computed from this run's data.

The last three lines: the `kernels` JSON, the card's name and power limit
(nvidia-smi), and the device JSON.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time
import types

import numpy as np

SEED = 0
WIDTH, HEIGHT = 1920, 1080
N_VIEWS = 8
SUBDIV = 7             # 20 * 4**7 = 327,680 faces
SH_DEGREE = 3
TIMED_LAUNCHES = 20

# H100 SXM peaks (NVIDIA data sheet; the CUDA programming guide's throughput
# table for the special-function unit: 16 exp2 results / clock / SM) at the
# 700 W limit; a card set below it is slower under load
PEAK_BYTES_S = 3.35e12
PEAK_FP32_S = 67e12
PEAK_MUFU_S = 132 * 16 * 1.98e9

# K1 tolerances against its plain version (the same operation order, so
# they should agree to rounding; these are the acceptance bars)
MAX_ABS, MEAN_ABS, SHARE_OFF, NCONTRIB_EQ = 4e-3, 1e-5, 1e-4, 0.999


def log(*a):
    print(*a, flush=True)


def icosphere(subdiv: int):
    """Icosahedron refined `subdiv` times (1:4 midpoint splits), vectorized."""
    t = (1.0 + math.sqrt(5.0)) / 2.0
    v = np.array([[-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
                  [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
                  [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1]], np.float64)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    f = np.array([[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
                  [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
                  [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
                  [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]],
                 np.int64)
    for _ in range(subdiv):
        e = np.sort(np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]]), 1)
        keys, inv = np.unique(e[:, 0] * len(v) + e[:, 1], return_inverse=True)
        mid = v[keys // len(v)] + v[keys % len(v)]
        mid /= np.linalg.norm(mid, axis=1, keepdims=True)
        ab, bc, ca = (len(v) + inv.reshape(3, -1))
        a, b, c = f.T
        f = np.stack([np.stack([a, ab, ca], 1), np.stack([b, bc, ab], 1),
                      np.stack([c, ca, bc], 1), np.stack([ab, bc, ca], 1)],
                     1).reshape(-1, 3)
        v = np.concatenate([v, mid])
    return v.astype(np.float32), f.astype(np.int32)


def orbit_camera(graphics, azimuth, device, distance=4.0, elevation=0.3):
    fovx = math.radians(60.0)
    fovy = graphics.focal2fov(graphics.fov2focal(fovx, WIDTH), HEIGHT)
    pos = distance * np.array([math.cos(elevation) * math.sin(azimuth),
                               math.sin(elevation),
                               math.cos(elevation) * math.cos(azimuth)])
    fwd = -pos / np.linalg.norm(pos)
    right = np.cross([0.0, 1.0, 0.0], fwd)
    right /= np.linalg.norm(right)
    R = np.stack([right, np.cross(fwd, right), fwd], axis=1)
    V = graphics.world_to_view(R, -R.T @ pos)
    P = graphics.projection_matrix(0.01, 100.0, fovx, fovy)
    return graphics.CameraArrays.from_numpy(V, P @ V, pos, math.tan(fovx / 2),
                                            math.tan(fovy / 2), device=device)


def cuda_ms(torch, fn, n):
    """Mean device ms of fn() over n launches, after 3 warm ones."""
    for _ in range(3):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def k1_evaluations(torch, tile_blend, feat, tiles, grid_x):
    """(pair, pixel) evaluations the sequential walk needs on this data:
    each pixel evaluates its tile's pairs up to and including the one that
    ends it (T * (1 - alpha) < 1e-4), all of them if none does; pixels
    outside the image need none."""
    lists = tile_blend.tile_id_lists(tiles.sorted_gid, tiles.starts,
                                     tiles.counts, feat.shape[0] - 1)
    tf = feat[lists]                                          # (T, K, FEAT)
    num_tiles = tf.shape[0]
    px, py = tile_blend._pixel_coords(torch.arange(num_tiles, device=feat.device),
                                      grid_x)
    done = (px >= WIDTH) | (py >= HEIGHT)
    T = torch.ones_like(px)
    evals = torch.zeros_like(px, dtype=torch.int64)
    counts = tiles.counts.long()[:, None]
    for j in range(tf.shape[1]):
        live = ~done & (j < counts)
        evals += live
        alpha = tile_blend._alphas(tf[:, j], px, py)
        test_t = T * (1.0 - alpha)
        fire = live & (alpha > 0.0)
        term = fire & (test_t < tile_blend.T_EPS)
        T = torch.where(fire & ~term, test_t, T)
        done = done | term
    return int(evals.sum())


def phase_card(torch):
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; the port's render path "
                         "runs on the card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)}; devices {torch.cuda.device_count()}")
    assert torch.backends.cuda.matmul.allow_tf32 is False, "TF32 matmuls on"
    return smi


def phase_build(_cuda):
    t0 = time.perf_counter()
    logs = _cuda.build()
    log(f"[build] {len(logs)} kernel libraries in {time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "ptxas" in line and ("registers" in line or "bytes" in line):
                log(f"[build] {name}: {line.strip()}")


def phase_oracle(torch, port):
    """Small scene: rasterize on the card == the sequential oracle."""
    dev = "cuda"
    rng = np.random.default_rng(SEED + 1)
    n, w = 400, 64
    means = torch.tensor(rng.uniform(-1, 1, (n, 3)), dtype=torch.float32, device=dev)
    cov6 = port.maths.covariance_6(
        torch.tensor(rng.uniform(0.02, 0.12, (n, 3)), dtype=torch.float32, device=dev),
        port.maths.normalize(torch.tensor(rng.normal(size=(n, 4)), dtype=torch.float32,
                                          device=dev)))
    op = torch.tensor(rng.uniform(0.2, 0.95, n), dtype=torch.float32, device=dev)
    rgb = torch.tensor(rng.uniform(0.05, 0.95, (n, 3)), dtype=torch.float32, device=dev)
    bg = torch.tensor([0.15, 0.25, 0.35], device=dev)
    fovx = math.radians(60.0)
    g = port.graphics
    pos = np.array([4 * math.sin(0.3), 0.8, 4 * math.cos(0.3)])
    fwd = -pos / np.linalg.norm(pos)
    right = np.cross([0.0, 1.0, 0.0], fwd)
    right /= np.linalg.norm(right)
    R = np.stack([right, np.cross(fwd, right), fwd], axis=1)
    V = g.world_to_view(R, -R.T @ pos)
    cam = g.CameraArrays.from_numpy(V, g.projection_matrix(0.01, 100.0, fovx, fovx) @ V,
                                    pos, math.tan(fovx / 2), math.tan(fovx / 2), dev)
    out = port.rasterize.rasterize(means, cov6, op, rgb, bg, cam,
                                   port.rasterize.RasterizerConfig(w, w, max_per_tile=256))
    ref = port.oracle.render_sequential(means, cov6, op, rgb, cam, w, w, bg)
    err = (out.color - ref.color).abs().max().item()
    log(f"[oracle] {w}px / {n} Gaussians: max |rasterize - render_sequential| "
        f"= {err:.3g} (tolerance 3e-5)")
    assert err <= 3e-5, err


def make_model(torch, port, tmpdir):
    v, f = icosphere(SUBDIV)
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    model = port.mesh_gaussians.create_from_mesh(v, f, max_sh_degree=SH_DEGREE,
                                                 device="cuda", generator=gen)
    torch.cuda.synchronize()
    log(f"[slice] create_from_mesh: {f.shape[0]} faces -> {model.bc.shape[0]} "
        f"Gaussians in {time.perf_counter() - t0:.1f} s")
    # perturb to look trained: moved along the faces and off them, resized,
    # turned, mostly opaque, view-dependent color
    rng = np.random.default_rng(SEED)
    n = f.shape[0]
    k = (SH_DEGREE + 1) ** 2 - 1

    def add(param, noise):
        with torch.no_grad():
            param.add_(torch.tensor(noise.astype(np.float32), device="cuda"))

    add(model.bc, rng.normal(0, 0.5, (n, 3)))
    add(model.distance, rng.normal(0, 0.5, (n, 1)))
    add(model.scaling, rng.normal(0, 0.3, (n, 3)))
    add(model.rotation, rng.normal(0, 0.5, (n, 4)))
    add(model.opacity, rng.normal(4.2, 1.5, (n, 1)))
    add(model.features_dc, rng.normal(0, 0.3, (n, 1, 3)))
    add(model.features_rest, rng.normal(0, 0.05, (n, k, 3)))
    path = os.path.join(tmpdir, "point_cloud.ply")
    port.gaussian_ply.save_mesh_gaussian_ply(path, model)
    loaded, _ = port.gaussian_ply.load_mesh_gaussian_ply(path, device="cuda")
    log(f"[slice] PLY round trip: {os.path.getsize(path) / 1e6:.1f} MB, "
        f"{loaded.bc.shape[0]} Gaussians, SH degree {SH_DEGREE}")
    for name, p in model.named_parameters():
        assert torch.equal(p, getattr(loaded, name)), name
    return loaded


def size_capacities(torch, port, model, cams):
    """max_per_tile and the pair capacities large enough that no view of
    this model overflows, from 1024 and the defaults up; and each view's
    largest per-tile pair count."""
    cfg = port.rasterize.RasterizerConfig(WIDTH, HEIGHT, max_per_tile=1024)
    gx, gy = cfg.grid
    n = model.bc.shape[0]
    while True:
        largest, rect_over = [], 0
        for cam in cams:
            a = port.render.mesh_model_arrays(model, cam, SH_DEGREE)
            prep = port.preprocess.preprocess(a.xyz, a.cov6, cam, WIDTH, HEIGHT,
                                              opacity=a.opacity)
            prep = prep._replace(valid=prep.valid & a.active)
            tiles = port.binning.build_tile_lists(
                prep, gx, gy, 1 << 30, cfg.expand_capacity(n), opacity=a.opacity,
                row_capacity=cfg.row_capacity(n))
            largest.append(int(tiles.counts.max()))
            rect_over += int(tiles.rect_overflow)
        if rect_over == 0:
            break
        log(f"[slice] rect_overflow {rect_over}: doubling the pair capacities")
        cfg = port.rasterize.RasterizerConfig(
            WIDTH, HEIGHT, cfg.max_per_tile, 2 * cfg.pair_capacity_per_gaussian,
            2 * cfg.row_capacity_per_gaussian)
    mpt = cfg.max_per_tile
    while mpt < max(largest):
        mpt *= 2
    if mpt != cfg.max_per_tile:
        log(f"[slice] largest tile holds {max(largest)} pairs: max_per_tile "
            f"{cfg.max_per_tile} -> {mpt}")
    return port.rasterize.RasterizerConfig(
        WIDTH, HEIGHT, mpt, cfg.pair_capacity_per_gaussian,
        cfg.row_capacity_per_gaussian), largest


def phase_profile(torch, frame, cams, n=3):
    """Device time by kernel over n frames (torch.profiler), and the share
    of the profiled frame's wall time in which the device was idle."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for cam in cams[:n]:
            frame(cam)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n
    rows = []
    for e in prof.key_averages():
        if str(e.device_type).endswith("CUDA"):
            us = getattr(e, "self_device_time_total", 0)
            rows.append((us / 1e3 / n, e.count / n, e.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    log(f"[profile] {n} frames under torch.profiler: wall {wall:.3f} ms/frame, "
        f"device busy {busy:.3f} ms/frame, idle share {1 - busy / wall:.3f}")
    for ms, count, name in rows[:15]:
        log(f"[profile] {ms:8.3f} ms/frame x{count:g} {name[:100]}")


def phase_slice(torch, port, tmpdir):
    model = make_model(torch, port, tmpdir)
    cams = [orbit_camera(port.graphics, 2 * math.pi * i / N_VIEWS, "cuda")
            for i in range(N_VIEWS)]
    bg = torch.ones(3, device="cuda")
    with torch.no_grad():
        cfg, largest = size_capacities(torch, port, model, cams)
        log(f"[slice] config: max_per_tile {cfg.max_per_tile}, pair capacity "
            f"{cfg.pair_capacity_per_gaussian}/Gaussian, row capacity "
            f"{cfg.row_capacity_per_gaussian}/Gaussian")

        def frame(cam):
            a = port.render.mesh_model_arrays(model, cam, SH_DEGREE)
            return port.render.render(a, cam, cfg, bg)

        frame(cams[0])                                   # warm frame
        torch.cuda.synchronize()
        port.tile_blend.blend_forward.launches = 0       # main path starts
        frames, outs = [], []
        for i, cam in enumerate(cams):
            t0 = time.perf_counter()
            out = frame(cam)
            torch.cuda.synchronize()
            frames.append((time.perf_counter() - t0) * 1e3)
            outs.append(out)
        launches = port.tile_blend.blend_forward.launches  # main path ends
        phase_profile(torch, frame, cams)
    for i, out in enumerate(outs):
        covered = (out.final_t < 0.5).float().mean().item()
        log(f"[slice] view {i}: {frames[i]:.2f} ms, num_rendered "
            f"{int(out.num_rendered)}, largest tile {largest[i]}, "
            f"tile/rect/pair overflow "
            f"{int(out.tile_overflow)}/{int(out.rect_overflow)}/"
            f"{int(out.pair_overflow)}, covered {covered:.3f}")
        assert out.color.shape == (3, HEIGHT, WIDTH)
        assert torch.isfinite(out.color).all() and torch.isfinite(out.final_t).all()
        assert int(out.tile_overflow) == 0 and int(out.rect_overflow) == 0
        assert covered >= 0.05, covered
    log(f"[slice] 1080p frame ms: mean {np.mean(frames):.2f}, median "
        f"{np.median(frames):.2f}, all {[round(x, 2) for x in frames]}")
    assert launches == N_VIEWS, f"K1 launched {launches} times for {N_VIEWS} frames"
    return model, cams[0], cfg, launches, frames


def phase_kernels(torch, port, model, cam, cfg, launches):
    """K1 against its plain version on view 0's binned pair domain, at the
    slice's max_per_tile and clamped to 64."""
    tb = port.tile_blend
    gx, gy = cfg.grid
    n = model.bc.shape[0]
    with torch.no_grad():
        a = port.render.mesh_model_arrays(model, cam, SH_DEGREE)
        prep = port.preprocess.preprocess(a.xyz, a.cov6, cam, WIDTH, HEIGHT,
                                          opacity=a.opacity)
        prep = prep._replace(valid=prep.valid & a.active)
        feat = tb.pack_features(prep.mean2d, prep.conic, a.opacity, a.rgb, prep.valid)
        results = {}
        for label, mpt in (("slice", cfg.max_per_tile), ("clamped", 64)):
            tiles = port.binning.build_tile_lists(
                prep, gx, gy, mpt, cfg.expand_capacity(n), opacity=a.opacity,
                row_capacity=cfg.row_capacity(n))
            args = (feat, tiles.sorted_gid, tiles.starts, tiles.counts, gx,
                    WIDTH, HEIGHT)
            kc, kt, kn = tb.blend_forward(*args)
            pc, pt, pn = tb.blend_forward_plain(*args)
            torch.cuda.synchronize()
            dc = (kc - pc).abs()
            dt = (kt - pt).abs()
            r = dict(
                max_per_tile=mpt, pairs=int(tiles.counts.sum()),
                tile_overflow=int(tiles.tile_overflow),
                largest_tile=int(tiles.counts.max()),
                color_max_abs=dc.max().item(), color_mean_abs=dc.mean().item(),
                final_t_max_abs=dt.max().item(), final_t_mean_abs=dt.mean().item(),
                share_off=(dc.amax(0) > 1e-4).float().mean().item(),
                n_contrib_equal=(kn == pn).float().mean().item())
            r["ms"] = cuda_ms(torch, lambda: tb.blend_forward(*args), TIMED_LAUNCHES)
            r["plain_ms"] = cuda_ms(torch, lambda: tb.blend_forward_plain(*args),
                                    TIMED_LAUNCHES)
            evals = k1_evaluations(torch, tb, feat, tiles, gx)
            n_tiles = gx * gy
            bytes_ = (r["pairs"] * (4 + 36) + 8 * n_tiles + 20 * WIDTH * HEIGHT)
            bytes_ms = bytes_ / PEAK_BYTES_S * 1e3
            ops_ms = max(evals * 12 / PEAK_FP32_S, evals / PEAK_MUFU_S) * 1e3
            r.update(evaluations=evals, bytes=bytes_, bytes_ms=bytes_ms,
                     ops_ms=ops_ms, bound_ms=max(bytes_ms, ops_ms),
                     bound_by="bytes" if bytes_ms >= ops_ms else "operations")
            log(f"[kernels] K1 {label}: " + json.dumps(r))
            if label == "clamped":
                assert r["tile_overflow"] > 0
            assert r["color_max_abs"] <= MAX_ABS and r["final_t_max_abs"] <= MAX_ABS
            assert r["color_mean_abs"] <= MEAN_ABS, r
            assert r["share_off"] <= SHARE_OFF, r
            assert r["n_contrib_equal"] >= NCONTRIB_EQ, r
            results[label] = r
    s = results["slice"]
    max_abs = max(max(r["color_max_abs"], r["final_t_max_abs"])
                  for r in results.values())
    return [{
        "name": "tile_blend_fwd (K1, blend forward)",
        "route": "cuda",
        "source": "gaussianmesh_tpu_torch/csrc/tile_blend_fwd.cu",
        "replaces": "gaussianmesh_tpu/ops/tile_blend.py:1111",
        "launches": launches,
        "max_abs_err": max_abs, "max_abs": max_abs,
        "ms": s["ms"], "kernel_ms": s["ms"],
        "plain_ms": s["plain_ms"],
        "bound_ms": s["bound_ms"], "bound_by": s["bound_by"],
        "library_ms": None,
        "clamped_ms": results["clamped"]["ms"],
        "clamped_plain_ms": results["clamped"]["plain_ms"],
    }]


def main() -> int:
    import torch

    smi = phase_card(torch)
    from gaussianmesh_tpu_torch.io import gaussian_ply
    from gaussianmesh_tpu_torch.models import mesh_gaussians, render
    from gaussianmesh_tpu_torch.ops import (_cuda, binning, oracle, preprocess,
                                            rasterize, tile_blend)
    from gaussianmesh_tpu_torch.utils import graphics, maths

    port = types.SimpleNamespace(
        gaussian_ply=gaussian_ply, mesh_gaussians=mesh_gaussians, render=render,
        binning=binning, oracle=oracle, preprocess=preprocess,
        rasterize=rasterize, tile_blend=tile_blend, graphics=graphics,
        maths=maths)
    t_start = time.perf_counter()
    phase_build(_cuda)
    phase_oracle(torch, port)
    with tempfile.TemporaryDirectory() as tmpdir:
        model, cam, cfg, launches, frames = phase_slice(torch, port, tmpdir)
    kernels = phase_kernels(torch, port, model, cam, cfg, launches)
    log(f"[done] {time.perf_counter() - t_start:.1f} s; 1080p frame ms mean "
        f"{np.mean(frames):.3f}")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
