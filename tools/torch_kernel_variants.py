#!/usr/bin/env python3
"""Time variants of the port's kernels on the arguments of
`chip_smoke.py`'s main paths, on one CUDA card.

    python3 tools/torch_kernel_variants.py SPEC.json [--counts] [--plain]
        [--dense] [--train-more STEPS]

It runs `chip_smoke.py`'s slice, kernels and train phases with their
checks replaced by recorders, which keeps K1's, K2's and K3's arguments at
the three shapes the smoke measures: view 0 of the 1080p slice, the same
clamped to `max_per_tile` 64, and one captured training step; and K3's on
the smoke's full-screen case (K3 variants only). --dense adds a K3 shape
of view 0's Gaussian count with every segment 0-128 rows long (seeded).
--train-more trains the smoke's student STEPS more steps and prints the
segment-length statistics K3 met on them. Then it
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
     "kernel": "k1", "k2" or "k3", "entry": the C entry point (default
     gm_tile_blend_fwd / gm_tile_blend_bwd),
     "order": "none" (the entry point takes no order argument),
              "ordered" (heaviest first) or "identity" (0, 1, ...)
              (K1 and K2),
     "wrapper": the K3 wrapper module that drives the source (a copy of an
             `ops/segsum.py`, relative to SPEC.json's directory; default
             the port's own), loaded on its own with its `_cuda.library`
             pointed at the variant}
with the argument lists of `ops/_cuda.py`, `order` (when taken) placed
after `counts` for K1 and after `g_final_t` for K2. K3 variants are called
through their wrappers, timed three ways (`chip_smoke.cuda_ms`,
`queued_ms` and the wrapper's `host_ms`), held against `segment_sum_plain`
at each column's largest sum and run twice for bit-identity. Results go
to standard output and to kernel_variants.json in the repository's
gitignored output directory (`out_dir` in `main`).
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time
import types
from pathlib import Path

import numpy as np

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
    """-> {"1080p" | "clamped" | "step": (K1 arguments, K2 arguments,
    K3's (grouped_pos, seg_starts))}, {"fullscreen": K3 arguments}, the
    smoke's trainer"""
    got, k1_args, k3_only, kept = {}, {}, {}, {}

    def record_k1(torch_, tb, args, mpt=None):
        _, final_t, n_contrib = tb.blend_forward(*args)
        k1_args["last"] = args
        return {}, final_t, n_contrib, 0

    def record_k2(torch_, port_, k2_args, grouped_pos, seg_starts, blended,
                  step_rows=None):
        label = ("step" if step_rows is not None
                 else "clamped" if "1080p" in got else "1080p")
        got[label] = (k1_args["last"], k2_args, (grouped_pos, seg_starts))
        return {}, {}

    def record_k3(torch_, seg, *k3_args, again=None):
        k3_only["fullscreen"] = k3_args
        return {}

    capture_step = cs.capture_step

    def keep_trainer(torch_, port_, trainer):
        kept["trainer"] = trainer
        return capture_step(torch_, port_, trainer)

    cs.check_k1, cs.check_k2_k3, cs.check_k3 = record_k1, record_k2, record_k3
    cs.capture_step = keep_trainer
    cs.phase_profile = lambda *a, **k: None
    with tempfile.TemporaryDirectory() as tmpdir:
        model, cam, cfg, _, _ = cs.phase_slice(torch, port, tmpdir)
    cs.phase_kernels(torch, port, model, cam, cfg)
    cs.phase_train(torch, port, model)
    return got, k3_only, kept["trainer"]


def dense_case(torch, seg, n, seed):
    """K3's inputs with every one of n segments 0-128 rows long (seeded),
    rows N(0, 1), `grouped_pos` a seeded permutation."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    counts = torch.randint(0, 129, (n,), generator=gen, device="cuda")
    seg_starts = seg.segment_starts(counts)
    m = int(seg_starts[-1])
    rows = torch.randn((m, seg.FEAT), generator=gen, device="cuda")
    grouped_pos = torch.randperm(m, generator=gen, device="cuda")
    return rows, grouped_pos.to(torch.int32), seg_starts


def train_more(torch, port, trainer, steps):
    """Train `steps` more steps, recording the segment lengths K3 is handed
    at each; -> their statistics over the steps."""
    seg = port.segsum
    kernel, seen = seg.segment_sum, []

    @functools.wraps(kernel)   # the wrapper bumps `launches` by its name
    def record(rows, grouped_pos, seg_starts):
        lengths = seg_starts[1:] - seg_starts[:-1]
        seen.append((lengths.max(), (lengths > seg.LONG_SEGMENT).sum()))
        return kernel(rows, grouped_pos, seg_starts)

    seg.segment_sum = record
    try:
        trainer.train(steps, log_every=1000)
    finally:
        seg.segment_sum = kernel
    longest = [int(a) for a, _ in seen]
    return {"steps": steps, "first_iteration": trainer.global_it - steps + 1,
            "seg_len_max": max(longest),
            "seg_len_max_median": float(np.median(longest)),
            "steps_with_long": sum(int(b) > 0 for _, b in seen),
            "long_segments": sum(int(b) for _, b in seen)}


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
    ap.add_argument("--dense", action="store_true")
    ap.add_argument("--train-more", type=int, default=0)
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
    got, k3_only, trainer = capture(torch, port)
    log(f"[variants] arguments captured in {time.perf_counter() - t0:.1f} s")
    results = {"card": smi}
    if args.train_more:
        results["train_more"] = train_more(torch, port, trainer, args.train_more)
        log(f"[variants] train_more: {json.dumps(results['train_more'])}")
    del trainer
    if args.dense:
        k3_only["dense"] = dense_case(torch, port.segsum,
                                      got["1080p"][2][1].shape[0] - 1, cs.SEED + 4)
    spec_dir = args.spec.resolve().parent
    with tempfile.TemporaryDirectory() as build_dir:
        libs = build(port, spec, spec_dir, Path(build_dir))
        blend = {k: v for k, v in libs.items() if spec[k]["kernel"] != "k3"}
        segment = {k: (v, k3_wrapper(port, spec_dir, k, spec[k], v))
                   for k, v in libs.items() if spec[k]["kernel"] == "k3"}
        for label, (k1a, k2a, (gp, ss)) in got.items():
            results[label] = measure(torch, tb, spec, blend, k1a, k2a, args)
            k3_only[label] = (tb.blend_backward(*k2a), gp, ss)
        for label, k3a in k3_only.items():
            results.setdefault(label, {}).update(
                measure_k3(torch, port.segsum, spec, segment, *k3a))
        for label, r in results.items():
            if label != "card":
                log(f"[variants] {label}: {json.dumps(r)}")
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


def k3_wrapper(port, spec_dir, name, v, lib):
    """The K3 wrapper module of variant v (its "wrapper" file, default the
    port's `ops/segsum.py`), loaded as a module of its own whose
    `_cuda.library` returns the variant's library `lib`."""
    path = (spec_dir / v["wrapper"] if "wrapper" in v
            else Path(port.segsum.__file__))
    mod_spec = importlib.util.spec_from_file_location(f"k3_wrapper_{name}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    lib.gm_segment_sum.argtypes = port._cuda.KERNELS["segment_sum"]["gm_segment_sum"]
    lib.gm_segment_sum.restype = ctypes.c_int
    mod._cuda = types.SimpleNamespace(library=lambda _name: lib)
    return mod


def measure_k3(torch, seg, spec, libs, rows, grouped_pos, seg_starts):
    """K3 variants on one shape, each called through its wrapper: ms
    (`chip_smoke.cuda_ms`, mean of 20 after 3 warm calls), queued_ms (the
    calls queued behind a sleep of the card), host_ms (the wrapper's host
    time per call), repeat_equal, rel (against `segment_sum_plain`, over
    each column's largest sum) and equal_wrapper (bits of the port's K3)."""
    ref64 = seg.segment_sum_plain(rows, grouped_pos, seg_starts)
    mine = seg.segment_sum(rows, grouped_pos, seg_starts)
    r = {"K3_pairs": rows.shape[0], **cs.segment_stats(torch, seg, seg_starts),
         **cs.bound(rows.shape[0] * (64 + 4) + seg_starts.shape[0] * (4 + 64))}
    for name, (_, mod) in libs.items():
        def launch(_mod=mod):
            return _mod.segment_sum(rows, grouped_pos, seg_starts)

        first, second = launch(), launch()
        torch.cuda.synchronize()
        d = (first - ref64).abs() / ref64.abs().amax(0).clamp(min=1e-30)
        r[name] = {"ms": cs.cuda_ms(torch, launch, 20),
                   "queued_ms": cs.queued_ms(torch, launch, 20),
                   "host_ms": cs.host_ms(torch, launch, 20),
                   "repeat_equal": bool(torch.equal(first, second)),
                   "rel": d.max().item(),
                   "equal_wrapper": bool(torch.equal(first, mine))}
    return r


if __name__ == "__main__":
    sys.exit(main())
