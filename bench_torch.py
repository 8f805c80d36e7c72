"""Benchmark of the PyTorch port: the rasterizer's forward + backward at
1080p on one card (the port of `bench.py`).

    python3 bench_torch.py [--device cpu] [--width W --height H --n_gauss N
                            --steps S --warm K]
    python3 bench_torch.py --sharded [tools/bench_scaling_torch.py's flags]

The workload is `bench.py`'s: 100,000 random Gaussians
(`random_gaussians(100_000, seed=0, spread=1.4, scale_range=(0.004,
0.02))`), `look_at_camera(1920, 1080, distance=4.0)`, `max_per_tile` 1024
with 9 pairs and 3 rows per Gaussian, a white background, the loss
sum(color^2) and the gradients of all four inputs (means3d, cov6, opacity,
rgb). Each step sets `requires_grad` on the four, runs `backward()` and
reduces each `.grad`, so no part of K2, K3 or the autograd chain is skipped.
10 steps are timed after 3 warm ones. The size flags exist for the CPU
tests; the defaults are `bench.py`'s sizes.

Prints one JSON line:
  {"metric": "rasterize_fwd_bwd_mpix_per_s", "value": N, "unit": "Mpix/s",
   "vs_baseline": N, "detail": {...}}
with `vs_baseline` against 62.2 Mpix/s (30 fps at 1080p, `bench.py`'s bar)
and in `detail`: `step_ms` (the median over the timed steps of the host
clock around one step, ending in a synchronize; `step_ms_all` each step's),
`device_ms` (CUDA events around the timed steps queued behind a sleep of
the card), `busy_ms` and `device_operations` per step (torch.profiler over
3 more steps, after the timed ones), `idle_share` (1 - busy / step ms),
`n_gauss`, `num_rendered`, `overflow` (tile + rect + pair), K1-K3 launches
per step, the loss, the card's name and power limit. On any failure it prints the same line with value 0 and
an `error` and exits 1. Runs on CUDA unless `--device cpu` is given; with
no card it fails (no fallback).

`--sharded` runs `tools/bench_scaling_torch.py`'s `main` with the other
flags instead (as `bench.py --sharded` runs `tools/bench_scaling.py`): it
writes that tool's artifact and prints its `scaling_efficiency_8dev_model`
line; a failure raises.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
from typing import NamedTuple

ROOT = os.path.dirname(os.path.abspath(__file__))
for _p in (ROOT, os.path.join(ROOT, "tools")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import torch  # noqa: E402

WIDTH, HEIGHT = 1920, 1080
N_GAUSS = 100_000
STEPS, WARM = 10, 3
PROFILED_STEPS = 3
BASELINE_MPIX_S = 30 * (WIDTH * HEIGHT) / 1e6    # 30 fps at 1080p = 62.2
METRIC = "rasterize_fwd_bwd_mpix_per_s"


class Workload(NamedTuple):
    inputs: list        # means3d, cov6, opacity, rgb: leaves that require grad
    bg: torch.Tensor
    cam: object         # CameraArrays
    cfg: object         # RasterizerConfig
    device: torch.device


def make_workload(width: int = WIDTH, height: int = HEIGHT, n_gauss: int = N_GAUSS,
                  device="cuda") -> Workload:
    """`bench.py`'s scene and rasterizer config on `device`."""
    import scenes_torch
    from gaussianmesh_tpu_torch import resolve_device
    from gaussianmesh_tpu_torch.ops.rasterize import RasterizerConfig

    dev = resolve_device(device)
    sc = scenes_torch.random_gaussians(n_gauss, seed=0, spread=1.4,
                                       scale_range=(0.004, 0.02), device=dev)
    inputs = [sc[k].detach().clone().requires_grad_(True)
              for k in ("means3d", "cov6", "opacity", "rgb")]
    cfg = RasterizerConfig(width, height, max_per_tile=1024,
                           pair_capacity_per_gaussian=9, row_capacity_per_gaussian=3)
    cam = scenes_torch.look_at_camera(width, height, distance=4.0, device=dev)
    return Workload(inputs, torch.ones(3, device=dev), cam, cfg, dev)


def fwd_bwd(w: Workload, inputs=None):
    """One bench step: rasterize, loss sum(color^2), backward to the inputs
    that require grad, each gradient reduced. -> (loss, gradient sum, the
    rasterizer's output)."""
    from gaussianmesh_tpu_torch.ops.rasterize import rasterize

    inputs = w.inputs if inputs is None else inputs
    for x in inputs:
        x.grad = None
    out = rasterize(*inputs, w.bg, w.cam, w.cfg)
    loss = (out.color * out.color).sum()
    loss.backward()
    gsum = sum(x.grad.sum() for x in inputs if x.grad is not None)
    return loss.detach(), gsum, out


def measure(args) -> dict:
    import timing_torch as timing

    w = make_workload(args.width, args.height, args.n_gauss, args.device)
    dev = w.device
    for _ in range(args.warm):
        loss, gsum, out = fwd_bwd(w)
    timing.sync(dev)
    before = timing.kernel_launches()
    step_all = timing.host_times(lambda: fwd_bwd(w), args.steps, dev, warm=0)
    launches = {k: (v - before[k]) / args.steps
                for k, v in timing.kernel_launches().items()}
    step_ms = statistics.median(step_all)
    device_ms = timing.queued_ms(lambda: fwd_bwd(w), args.steps, dev)
    prof = timing.profile(lambda: fwd_bwd(w), PROFILED_STEPS, dev)
    loss, gsum, out = fwd_bwd(w)
    card = timing.card(dev)
    mpix_s = args.width * args.height / (step_ms / 1e3) / 1e6
    overflow = int(out.tile_overflow + out.rect_overflow + out.pair_overflow)
    if not (torch.isfinite(loss) and torch.isfinite(gsum)):
        raise FloatingPointError(f"loss {float(loss)} or gradient sum {float(gsum)} "
                                 "is not finite")
    return {
        "metric": METRIC, "value": mpix_s, "unit": "Mpix/s",
        "vs_baseline": mpix_s / BASELINE_MPIX_S,
        "detail": {"step_ms": step_ms, "step_ms_all": step_all, "device_ms": device_ms,
                   "busy_ms": prof["busy_ms"],
                   "idle_share": timing.idle_share(prof["busy_ms"], step_ms),
                   "device_operations": prof["device_operations"],
                   "n_gauss": args.n_gauss, "width": args.width,
                   "height": args.height, "steps": args.steps,
                   "num_rendered": int(out.num_rendered), "overflow": overflow,
                   "launches_per_step": launches, "loss": float(loss),
                   "device": str(dev), "card": card["name"],
                   "power_limit": card["power_limit"]},
    }


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("--width", type=int, default=WIDTH)
    p.add_argument("--height", type=int, default=HEIGHT)
    p.add_argument("--n_gauss", type=int, default=N_GAUSS)
    p.add_argument("--steps", type=int, default=STEPS)
    p.add_argument("--warm", type=int, default=WARM)
    return p


def main(argv=None) -> dict:
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--sharded" in argv:
        # the scaling tool (`bench.py --sharded`): its artifact and its own line
        import bench_scaling_torch

        return bench_scaling_torch.main([a for a in argv if a != "--sharded"])
    args = parser().parse_args(argv)
    try:
        result = measure(args)
    except Exception as e:  # noqa: BLE001 — the line is the interface
        print(json.dumps({"metric": METRIC, "value": 0.0, "unit": "Mpix/s",
                          "vs_baseline": 0.0,
                          "error": f"{type(e).__name__}: {e}"}), flush=True)
        raise SystemExit(1) from e
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
