#!/usr/bin/env python3
"""Time variants of the port's blend kernels on the arguments of
`chip_smoke.py`'s main paths, on one CUDA card.

    python3 tools/torch_kernel_variants.py SPEC.json [--counts] [--plain]

It runs `chip_smoke.py`'s slice, kernels and train phases with their
checks replaced by recorders, which keeps K1's and K2's arguments at the
three shapes the smoke measures: view 0 of the 1080p slice, the same
clamped to `max_per_tile` 64, and one captured training step. Then it
builds every variant with `nvcc` (one process per source, in parallel)
and, at each shape, times it with CUDA events (mean of 20 launches after
3 warm ones), times the heaviest tile alone (`num_tiles` 1 with the
heaviest-first order, for variants that take an order), checks it against
the port's own wrapper (and with --plain against the plain versions) and
runs it twice for bit-identity. --counts adds K2's (pair, warp) work
counts (`chip_smoke.k2_walk_counts`) for 8- and 4-warp layouts.

SPEC.json maps a variant name to
    {"source": a .cu file (relative to SPEC.json's directory),
     "defines": ["NAME" or "NAME=VALUE", ...] (optional),
     "kernel": "k1" or "k2", "entry": the C entry point (default
     gm_tile_blend_fwd / gm_tile_blend_bwd),
     "order": "none" (the entry point takes no order argument),
              "ordered" (heaviest first) or "identity" (0, 1, ...)}
with the argument lists of `ops/_cuda.py`, `order` (when taken) placed
after `counts` for K1 and after `g_final_t` for K2. Results go to
chiprun_out/kernel_variants.json and standard output.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def log(*a):
    print(*a, flush=True)


def port_namespace():
    from gaussianmesh_tpu_torch import config
    from gaussianmesh_tpu_torch.io import gaussian_ply
    from gaussianmesh_tpu_torch.models import mesh_gaussians, render
    from gaussianmesh_tpu_torch.ops import (_cuda, binning, oracle, preprocess,
                                            rasterize, segsum, tile_blend)
    from gaussianmesh_tpu_torch.train import densify, trainer
    from gaussianmesh_tpu_torch.utils import graphics, maths
    return types.SimpleNamespace(
        gaussian_ply=gaussian_ply, mesh_gaussians=mesh_gaussians, render=render,
        binning=binning, oracle=oracle, preprocess=preprocess,
        rasterize=rasterize, segsum=segsum, tile_blend=tile_blend,
        graphics=graphics, maths=maths, config=config, trainer=trainer,
        densify=densify, _cuda=_cuda)


def capture(torch, port):
    """-> {"1080p" | "clamped" | "step": (K1 arguments, K2 arguments)}"""
    got, k1_args = {}, {}

    def record_k1(torch_, tb, args, mpt=None):
        _, final_t, n_contrib = tb.blend_forward(*args)
        k1_args["last"] = args
        return {}, final_t, n_contrib, 0

    def record_k2(torch_, port_, k2_args, grouped_pos, seg_starts, blended,
                  step_rows=None):
        label = ("step" if step_rows is not None
                 else "clamped" if "1080p" in got else "1080p")
        got[label] = (k1_args["last"], k2_args)
        return {}, {}

    cs.check_k1, cs.check_k2_k3 = record_k1, record_k2
    cs.phase_profile = lambda *a, **k: None
    with tempfile.TemporaryDirectory() as tmpdir:
        model, cam, cfg, _, _ = cs.phase_slice(torch, port, tmpdir)
    cs.phase_kernels(torch, port, model, cam, cfg)
    cs.phase_train(torch, port, model)
    return got


def build(port, spec, spec_dir, out_dir):
    """-> {variant: CDLL}; prints ptxas' register and shared-memory lines."""
    _cuda = port._cuda
    procs = {}
    for name, v in spec.items():
        lib = out_dir / f"{name}.so"
        cmd = [_cuda._nvcc(), *_cuda.NVCC_FLAGS,
               *(f"-D{d}" for d in v.get("defines", [])),
               "-o", str(lib), str(spec_dir / v["source"])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        text = proc.communicate()[0]
        for line in text.splitlines():
            if "registers" in line or ("spill" in line and "0 bytes spill" not in line):
                log(f"[build {name}] {line.strip()}")
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{text}")
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("spec", type=Path)
    ap.add_argument("--counts", action="store_true")
    ap.add_argument("--plain", action="store_true")
    args = ap.parse_args()
    import torch

    smi = cs.phase_card(torch)
    port = port_namespace()
    tb = port.tile_blend
    spec = json.loads(args.spec.read_text())
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    port._cuda.build()
    t0 = time.perf_counter()
    got = capture(torch, port)
    log(f"[variants] arguments captured in {time.perf_counter() - t0:.1f} s")
    with tempfile.TemporaryDirectory() as build_dir:
        libs = build(port, spec, args.spec.resolve().parent, Path(build_dir))
        results = {"card": smi}
        for label, (k1a, k2a) in got.items():
            results[label] = measure(torch, tb, spec, libs, k1a, k2a, args)
            log(f"[variants] {label}: {json.dumps(results[label])}")
    (out_dir / "kernel_variants.json").write_text(json.dumps(results, indent=1))
    return 0


def measure(torch, tb, spec, libs, k1a, k2a, args):
    feat, sorted_gid, starts, counts, gx, width, height = k1a
    _, _, _, _, final_t, n_contrib, g_color, g_final_t = k2a
    nt = counts.shape[0]
    orders = {"ordered": tb.tile_order(counts),
              "identity": torch.arange(nt, dtype=torch.int32, device=counts.device)}
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    ref = tb.blend_forward(*k1a)
    ref_rows = tb.blend_backward(*k2a)
    top = torch.sort(counts, descending=True).values
    r = {"tiles": nt, "largest": int(top[0]), "top_counts": top[:6].tolist(),
         "K1_wrapper_ms": cs.cuda_ms(torch, lambda: tb.blend_forward(*k1a), 20),
         "K2_wrapper_ms": cs.cuda_ms(torch, lambda: tb.blend_backward(*k2a), 20),
         "tile_order_ms": cs.cuda_ms(torch, lambda: tb.tile_order(counts), 20)}
    if args.counts:
        r["counts"] = {w: cs.k2_walk_counts(torch, tb, k2a, w) for w in (8, 4)}
    plain = None
    if args.plain:
        plain = (*tb.blend_forward_plain(*k1a), tb.blend_backward_plain(*k2a))
    P = lambda x: ctypes.c_void_p(x.data_ptr())  # noqa: E731
    fe = tb._aligned(feat.contiguous())
    for name, lib in libs.items():
        v = spec[name]
        kind = v["kernel"]
        entry = getattr(lib, v.get("entry", "gm_tile_blend_fwd" if kind == "k1"
                                   else "gm_tile_blend_bwd"))
        order = ([P(orders[v["order"]])] if v["order"] != "none" else [])
        alone_order = [P(orders["ordered"])] if v["order"] != "none" else None
        if kind == "k1":
            outs = [torch.empty_like(x) for x in ref]
            head = [P(fe), P(sorted_gid), P(starts), P(counts)]
            tail = [gx, width, height, *map(P, outs), stream]
        else:
            outs = [torch.full_like(ref_rows, float("nan"))]
            head = [P(x) for x in (fe, sorted_gid, starts, final_t, n_contrib,
                                   g_color, g_final_t)]
            tail = [gx, width, height, P(outs[0]), stream]

        def launch(n_tiles=nt, o=order):
            err = entry(*head, *o, n_tiles, *tail)
            if err != 0:
                raise RuntimeError(f"{name}: cudaError {err}")

        launch()
        torch.cuda.synchronize()
        first = [x.clone() for x in outs]
        launch()
        torch.cuda.synchronize()
        e = {"repeat_equal": all(torch.equal(a, b) for a, b in zip(first, outs))}
        if alone_order is not None:
            e["alone_ms"] = cs.cuda_ms(torch, lambda: launch(1, alone_order), 20)
        e["ms"] = cs.cuda_ms(torch, launch, 20)
        if kind == "k1":
            e["equal_wrapper"] = all(torch.equal(a, b) for a, b in zip(first, ref))
            if plain is not None:
                e["equal_plain"] = all(torch.equal(a, b) for a, b in zip(first, plain[:3]))
        else:
            rows = first[0]
            for key, base in (("wrapper", ref_rows),) + (
                    (("plain", plain[3]),) if plain is not None else ()):
                d = (rows - base).abs() / base.abs().amax(0).clamp(min=1e-30)
                e[f"rel_{key}"] = d.max().item()
                e[f"zero_rows_equal_{key}"] = bool(torch.equal(rows == 0, base == 0))
        r[name] = e
    return r


if __name__ == "__main__":
    sys.exit(main())
