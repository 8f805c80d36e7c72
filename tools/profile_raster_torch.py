"""Stage-by-stage timing of the port's 1080p rasterize forward + backward
(the port of `tools/profile_raster.py`), on `bench_torch.py`'s scene.

    python3 tools/profile_raster_torch.py [--stages] [--prefix] [--expand]
        [--reps N] [--out PATH] [--device cpu] [--width W --height H --n_gauss N]

An engineering tool for finding the next layer to attack. Three modes, as
in the JAX tool; any of them may be given together, the stage table alone
when none is:

* `--stages` (the default): each stage's inputs are built once and each
  stage is timed alone: `preprocess`, `binning.expand_pairs`,
  `binning.sort_pairs`, `binning.finish_tile_lists`,
  `tile_blend.pack_features`, the feature gather `feat[sorted_gid]` (not on
  the port's path: K1 reads the table's rows through `sorted_gid` itself;
  timed as what the JAX path pays for its gather), K1 `blend_forward`, K1 +
  K2 + K3 through `tile_blend.blend` forward and backward, `rasterize`
  forward (a render, no autograd), `rasterize` fwd+bwd w.r.t. means and
  w.r.t. all four inputs (the bench step). Also the live pairs, the tile
  lists' sizes and the overflow counters.
* `--prefix`: rows F1-F7 are cumulative prefixes of the step's forward
  (autograd recording, as in the step), from preprocess to the whole
  `rasterize`; B6 is the blend's forward + backward (loss sum(color^2) +
  sum(final_t^2) through K1, K2, K3 and the preprocess backward), B7 the
  whole forward + backward, which is `bench_torch.py`'s step. The
  consecutive differences F1, F2 - F1, ..., B7 - B6 attribute the step's
  time and device operations to the layers, and sum to B7.
* `--expand`: the sub-stages of the port's `binning.expand_pairs`, rebuilt
  here stage by stage (and checked against the function): the row
  expansion, the exact row x-extents (`_row_x_extent`), the `kept`
  compaction (capacity clipping), the pair emission, and the host stall at
  each of its three host syncs (`binning.py:126, 156, 159`): host ms spent
  waiting in `int(...)` for the work queued before it, not kernel ms.

Every row: host ms (the median of --reps calls, each clock stopped after a
synchronize; the prefix rows' calls in interleaved rounds), device ms (CUDA
events around --reps calls queued behind a sleep of the card; a stage with
a host sync reads the host's pace), device operations per call and device
busy ms (torch.profiler over --reps calls, once every row is timed), and
the K1 / K2 / K3 launches of one call. The artifact, written afresh:
results/profile_raster_torch.json (or --out), with the card's name and
power limit. Runs on CUDA unless `--device cpu`; with no card it raises.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _p in (ROOT, os.path.join(ROOT, "tools")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import torch  # noqa: E402

REPS = 10


def row(name, fn, reps, dev, pending, host=None, **extra) -> dict:
    """One row: host ms (the median of `reps` synchronized calls, or
    `host` where the caller measured it), queued device ms and the launches
    of one call; its device operations and busy ms come later: (row, fn)
    joins `pending` for `profile_rows`."""
    import timing_torch as timing

    host = timing.host_ms(fn, reps, dev) if host is None else host
    r = dict(name=name, host_ms=host, device_ms=timing.queued_ms(fn, reps, dev),
             device_operations=None, busy_ms=None,
             launches=timing.launches_of(fn, dev), **extra)
    pending.append((r, fn))
    dms = "" if r["device_ms"] is None else f" {r['device_ms']:9.3f} dev ms"
    print(f"{name:46s} {host:9.3f} ms{dms}  {r['launches']}", flush=True)
    return r


def profile_rows(pending, reps, dev) -> None:
    """torch.profiler over `reps` calls of every row timed so far, after all
    of them: a profiler session slows the process's later launches, so no
    host time is taken after one (`timing_torch.profile`)."""
    import timing_torch as timing

    if dev.type != "cuda":
        return
    print("\n--- device operations and busy ms per call (torch.profiler) ---")
    for r, fn in pending:
        prof = timing.profile(fn, reps, dev)
        r.update(device_operations=prof["device_operations"], busy_ms=prof["busy_ms"])
        print(f"{r['name']:46s} {r['device_operations']:7.1f} ops {r['busy_ms']:9.3f} "
              "busy ms", flush=True)


def attribution(rows) -> dict:
    """The prefix rows' consecutive differences F1, F2 - F1, ..., B7 - B6,
    which sum to B7."""
    diffs = []
    print("\n--- attribution (consecutive differences; they sum to B7) ---")
    for i, r in enumerate(rows):
        prev = rows[i - 1] if i else None
        d = {"name": r["name"] if prev is None else f"{r['name']} - {prev['name'][:2]}"}
        for k in ("host_ms", "device_ms", "device_operations", "busy_ms"):
            d[k] = (None if r[k] is None or (prev is not None and prev[k] is None)
                    else r[k] - (prev[k] if prev is not None else 0.0))
        diffs.append(d)
        dev_s = "" if d["device_ms"] is None else f" {d['device_ms']:+9.3f} dev ms"
        ops_s = ("" if d["device_operations"] is None
                 else f" {d['device_operations']:+8.1f} ops {d['busy_ms']:+8.3f} busy ms")
        print(f"{d['name']:46s} {d['host_ms']:+9.3f} ms{dev_s}{ops_s}", flush=True)
    total = sum(d["host_ms"] for d in diffs)
    print(f"{'sum of the differences':46s} {total:9.3f} ms (B7 {rows[-1]['host_ms']:.3f})")
    return dict(diffs=diffs, sum_of_diffs_host_ms=total)


class Stages:
    """The step's stage inputs, built once (no autograd)."""

    @torch.no_grad()
    def __init__(self, w):
        from gaussianmesh_tpu_torch.ops import binning, preprocess as prep_mod, tile_blend

        self.w = w
        cfg = w.cfg
        means, cov6, op, rgb = (x.detach() for x in w.inputs)
        self.args = (means, cov6, op, rgb)
        self.gx, self.gy = cfg.grid
        self.n = means.shape[0]
        self.prep = prep_mod.preprocess(means, cov6, w.cam, cfg.width, cfg.height,
                                        opacity=op)
        self.exp = binning.expand_pairs(self.prep, self.gx, self.gy,
                                        cfg.expand_capacity(self.n), opacity=op,
                                        row_capacity=cfg.row_capacity(self.n))
        self.sorted_tile, self.sorted_gid, self.grouped_pos = binning.sort_pairs(
            self.exp.pair_tile, self.exp.pair_depth, self.exp.pair_gid)
        self.tiles = binning.finish_tile_lists(
            self.sorted_tile, self.sorted_gid, self.exp.rect_overflow, cfg.num_tiles,
            cfg.max_per_tile, self.exp.gid_counts, self.grouped_pos)
        self.feat = tile_blend.pack_features(self.prep.mean2d, self.prep.conic,
                                             op.reshape(-1), rgb, self.prep.valid)

    def summary(self) -> dict:
        t = self.tiles
        counts = t.counts.long()
        return dict(pairs_live=int(t.num_rendered), sorted_pairs=t.sorted_gid.shape[0],
                    expand_capacity=self.w.cfg.expand_capacity(self.n),
                    num_tiles=counts.shape[0], tiles_with_pairs=int((counts > 0).sum()),
                    largest_tile=int(counts.max()), mean_tile=float(counts.float().mean()),
                    tile_overflow=int(t.tile_overflow), rect_overflow=int(t.rect_overflow),
                    pair_overflow=int(t.pair_overflow))


def profile_stages(w, reps, pending) -> dict:
    """Each stage alone on inputs built once."""
    from gaussianmesh_tpu_torch.ops import binning, preprocess as prep_mod, tile_blend
    from gaussianmesh_tpu_torch.ops.rasterize import rasterize

    import bench_torch

    s = Stages(w)
    cfg, dev = w.cfg, w.device
    means, cov6, op, rgb = s.args
    summary = s.summary()
    print("scene: " + json.dumps(summary), flush=True)
    ng = torch.no_grad

    def prep():
        with ng():
            return prep_mod.preprocess(means, cov6, w.cam, cfg.width, cfg.height,
                                       opacity=op)

    def expand():
        with ng():
            return binning.expand_pairs(s.prep, s.gx, s.gy, cfg.expand_capacity(s.n),
                                        opacity=op, row_capacity=cfg.row_capacity(s.n))

    def sort():
        with ng():
            return binning.sort_pairs(s.exp.pair_tile, s.exp.pair_depth, s.exp.pair_gid)

    def finish():
        with ng():
            return binning.finish_tile_lists(
                s.sorted_tile, s.sorted_gid, s.exp.rect_overflow, cfg.num_tiles,
                cfg.max_per_tile, s.exp.gid_counts, s.grouped_pos)

    def pack():
        with ng():
            return tile_blend.pack_features(s.prep.mean2d, s.prep.conic,
                                            op.reshape(-1), rgb, s.prep.valid)

    def gather():
        with ng():
            return s.feat[s.tiles.sorted_gid.long()]

    def k1():
        with ng():
            return tile_blend.blend_forward(s.feat, s.tiles.sorted_gid, s.tiles.starts,
                                            s.tiles.counts, s.gx, cfg.width, cfg.height)

    feat_leaf = s.feat.clone().requires_grad_(True)

    def k123():
        feat_leaf.grad = None
        color, _, _ = tile_blend.blend(feat_leaf, s.tiles, s.gx, cfg.width, cfg.height)
        (color * color).sum().backward()
        return feat_leaf.grad.sum()

    def render():
        with ng():
            return rasterize(means, cov6, op, rgb, w.bg, w.cam, cfg).color

    means_leaf = means.clone().requires_grad_(True)

    def step_means():
        return bench_torch.fwd_bwd(w, [means_leaf, cov6, op, rgb])

    rows = [row("preprocess", prep, reps, dev, pending),
            row("binning.expand_pairs", expand, reps, dev, pending),
            row("binning.sort_pairs", sort, reps, dev, pending),
            row("binning.finish_tile_lists", finish, reps, dev, pending),
            row("tile_blend.pack_features", pack, reps, dev, pending),
            row("feature gather feat[sorted_gid] (off the path)", gather, reps, dev, pending,
                on_path=False),
            row("K1 blend_forward", k1, reps, dev, pending),
            row("K1 + K2 + K3: tile_blend.blend fwd+bwd", k123, reps, dev, pending),
            row("rasterize fwd (render, no autograd)", render, reps, dev, pending),
            row("rasterize fwd+bwd w.r.t. means", step_means, reps, dev, pending),
            row("rasterize fwd+bwd w.r.t. all four (bench)",
                lambda: bench_torch.fwd_bwd(w), reps, dev, pending)]
    return dict(scene=summary, rows=rows)


def profile_prefix(w, reps, pending) -> dict:
    """Cumulative prefixes of the step: F1-F7 forward, B6, B7 forward +
    backward; consecutive differences attribute the step."""
    from gaussianmesh_tpu_torch.ops import binning, preprocess as prep_mod, tile_blend
    from gaussianmesh_tpu_torch.ops.rasterize import rasterize

    import bench_torch
    import timing_torch as timing

    cfg, dev = w.cfg, w.device
    means, cov6, op, rgb = w.inputs
    gx, gy = cfg.grid
    n = means.shape[0]

    def f1():
        return prep_mod.preprocess(means, cov6, w.cam, cfg.width, cfg.height, opacity=op)

    def f2():
        prep = f1()
        with torch.no_grad():
            exp = binning.expand_pairs(prep, gx, gy, cfg.expand_capacity(n), opacity=op,
                                       row_capacity=cfg.row_capacity(n))
        return prep, exp

    def f3():
        prep, exp = f2()
        with torch.no_grad():
            st, sg, gp = binning.sort_pairs(exp.pair_tile, exp.pair_depth, exp.pair_gid)
        return prep, exp, st, sg, gp

    def f4():
        prep, exp, st, sg, gp = f3()
        with torch.no_grad():
            tiles = binning.finish_tile_lists(st, sg, exp.rect_overflow, cfg.num_tiles,
                                              cfg.max_per_tile, exp.gid_counts, gp)
        return prep, tiles

    def f5():
        prep, tiles = f4()
        feat = tile_blend.pack_features(prep.mean2d, prep.conic, op.reshape(-1), rgb,
                                        prep.valid)
        return feat, tiles

    def f6():
        feat, tiles = f5()
        return tile_blend.blend(feat, tiles, gx, cfg.width, cfg.height)

    def f7():
        return rasterize(means, cov6, op, rgb, w.bg, w.cam, cfg)

    def b6():
        for x in w.inputs:
            x.grad = None
        color, final_t, _ = f6()
        ((color * color).sum() + (final_t * final_t).sum()).backward()
        return sum(x.grad.sum() for x in w.inputs)

    prefixes = [("F1 preprocess", f1), ("F2 + binning.expand_pairs", f2),
                ("F3 + binning.sort_pairs", f3), ("F4 + binning.finish_tile_lists", f4),
                ("F5 + tile_blend.pack_features", f5), ("F6 + blend fwd (K1)", f6),
                ("F7 + background: rasterize fwd", f7),
                ("B6 blend fwd+bwd (K1, K2, K3, prep bwd)", b6),
                ("B7 rasterize fwd+bwd (= bench step)", lambda: bench_torch.fwd_bwd(w))]
    # host ms in interleaved rounds, one call of each row a round, so that a
    # slow spell of the shared host falls on every row alike
    times = [timing.host_times(fn, 0, dev) for _, fn in prefixes]   # one warm call each
    for _ in range(reps):
        for t, (_, fn) in zip(times, prefixes):
            t += timing.host_times(fn, 1, dev, warm=0)
    rows = [row(name, fn, reps, dev, pending, host=statistics.median(t),
                **(dict(num_rendered=int(f7().num_rendered)) if fn is f7 else {}))
            for (name, fn), t in zip(prefixes, times)]
    return dict(rows=rows, b7_host_ms=rows[-1]["host_ms"],
                f7_num_rendered=rows[6]["num_rendered"])


def profile_expand(w, reps, pending) -> dict:
    """The sub-stages of `binning.expand_pairs`, mirrored here, and the host
    stall at each of its three syncs."""
    import time

    from gaussianmesh_tpu_torch.ops import binning
    from gaussianmesh_tpu_torch.ops.preprocess import TILE

    import timing_torch as timing

    s = Stages(w)
    cfg, dev = w.cfg, w.device
    prep, gx, n = s.prep, s.gx, s.n
    m, m1 = cfg.expand_capacity(n), cfg.row_capacity(n)
    op = s.args[2]

    def rows_pre():
        rect_min, rect_max = prep.rect_min.long(), prep.rect_max.long()
        heights_raw = torch.where(prep.valid, rect_max[:, 1] - rect_min[:, 1], 0)
        heights = torch.clamp(heights_raw, min=1)
        return rect_min, rect_max, heights_raw, heights, torch.cumsum(heights, 0)

    def rows_stage():                       # stage 1, sync 1 (binning.py:126)
        rect_min, rect_max, heights_raw, heights, row_end = rows_pre()
        total_rows = int(row_end[-1])
        n_rows = min(total_rows, m1)
        j1 = torch.arange(n_rows, device=dev)
        parent = torch.searchsorted(row_end, j1, right=True)
        rr = j1 - (row_end - heights)[parent]
        ty = rect_min[parent, 1] + rr
        return dict(rect_min=rect_min, rect_max=rect_max, total_rows=total_rows,
                    n_rows=n_rows, parent=parent, ty=ty,
                    real_row=rr < heights_raw[parent])

    with torch.no_grad():
        r1 = rows_stage()
        qcut_all = torch.clamp(2.0 * torch.log(torch.clamp(op, min=1e-12)
                                               / binning.ALPHA_MIN)
                               + binning._CULL_SLACK, min=0.0)

    def extents_stage():
        parent, rect_min, rect_max = r1["parent"], r1["rect_min"], r1["rect_max"]
        ca, cb, cc = prep.conic[parent].unbind(-1)
        mx, my = prep.mean2d[parent].unbind(-1)
        pd = (ca > 0) & (cc > 0) & (ca * cc > cb * cb)
        dx_min, dx_max = binning._row_x_extent(my, ca, cb, cc, qcut_all[parent],
                                               r1["ty"].to(torch.float32))
        x_lo = rect_min[parent, 0].to(torch.float32)
        x_hi = rect_max[parent, 0].to(torch.float32)
        lo = torch.where(pd, torch.floor((mx + dx_min) / TILE), x_lo)
        hi = torch.where(pd, torch.floor((mx + dx_max) / TILE) + 1.0, x_hi)
        tx0 = torch.minimum(torch.maximum(lo, x_lo), x_hi).long()
        tx1 = torch.minimum(torch.maximum(hi, x_lo), x_hi).long()
        row_live = torch.where(pd, dx_min <= dx_max, True)
        width_real = torch.where(r1["real_row"] & row_live,
                                 torch.clamp(tx1 - tx0, min=0), 0)
        return tx0, width_real

    with torch.no_grad():
        tx0, width_real = extents_stage()

    def slots_pre():
        slot_w = torch.clamp(width_real, min=1)
        return slot_w, binning._exclusive_cumsum(slot_w)

    def kept_stage():                       # syncs 2 and 3 (binning.py:156, 159)
        slot_w, toff = slots_pre()
        total_slots = int(toff[-1] + slot_w[-1]) + (m1 - r1["n_rows"])
        kept = torch.minimum(torch.clamp(m - toff, min=0), width_real)
        return kept, int(kept.sum()), max(total_slots - m, 0)

    with torch.no_grad():
        kept, n_pairs, pair_lost = kept_stage()

    def emit_stage():
        pair_row = torch.repeat_interleave(kept, output_size=n_pairs)
        j_in_row = (torch.arange(n_pairs, device=dev)
                    - binning._exclusive_cumsum(kept)[pair_row])
        pair_tile = r1["ty"][pair_row] * gx + tx0[pair_row] + j_in_row
        pair_gid = r1["parent"][pair_row]
        return (pair_tile, pair_gid, prep.depth[pair_gid],
                torch.bincount(pair_gid, minlength=n).to(torch.int32))

    def whole():
        return binning.expand_pairs(prep, gx, s.gy, m, opacity=op, row_capacity=m1)

    with torch.no_grad():
        pair_tile, pair_gid, _, gid_counts = emit_stage()
        ref = whole()
        rect_overflow = max(r1["total_rows"] - m1, 0) + pair_lost
        same = (torch.equal(pair_tile, ref.pair_tile) and torch.equal(pair_gid, ref.pair_gid)
                and torch.equal(gid_counts, ref.gid_counts)
                and rect_overflow == int(ref.rect_overflow))
    if not same:
        raise AssertionError("the mirrored expansion differs from binning.expand_pairs")

    def stall(pre, read):
        """Mean host ms in `read` (an int(...) of `pre`'s outputs) with
        `pre`'s work queued ahead of it."""
        total = 0.0
        with torch.no_grad():
            for _ in range(reps + 1):
                timing.sync(dev)
                x = pre()
                t0 = time.perf_counter()
                read(x)
                if _:
                    total += time.perf_counter() - t0
        return total * 1e3 / reps

    def nograd(fn):
        def run():
            with torch.no_grad():
                return fn()
        return run

    print(f"expand: {r1['total_rows']} rows ({r1['n_rows']} kept of {m1}), "
          f"{n_pairs} pairs of {m}, rect_overflow {rect_overflow}", flush=True)
    rows = [row("row expansion (incl. sync 1)", nograd(rows_stage), reps, dev, pending),
            row("row x-extents (_row_x_extent)", nograd(extents_stage), reps, dev, pending),
            row("kept compaction (incl. syncs 2, 3)", nograd(kept_stage), reps, dev, pending),
            row("pair emission", nograd(emit_stage), reps, dev, pending),
            row("binning.expand_pairs (whole)", nograd(whole), reps, dev, pending)]
    stalls = [dict(sync="binning.py:126 int(row_end[-1])",
                   host_ms=stall(rows_pre, lambda x: int(x[-1][-1]))),
              dict(sync="binning.py:156 int(toff[-1] + slot_w[-1])",
                   host_ms=stall(slots_pre, lambda x: int(x[1][-1] + x[0][-1]))),
              dict(sync="binning.py:159 int(kept.sum())",
                   host_ms=stall(lambda: torch.minimum(torch.clamp(m - slots_pre()[1],
                                                                   min=0), width_real),
                                 lambda k: int(k.sum())))]
    for st in stalls:
        print(f"host stall at {st['sync']:40s} {st['host_ms']:9.3f} ms", flush=True)
    return dict(total_rows=r1["total_rows"], rows_kept=r1["n_rows"], row_capacity=m1,
                pairs=n_pairs, expand_capacity=m, rect_overflow=rect_overflow,
                mirrors_expand_pairs=same, rows=rows, host_stalls=stalls)


def parser() -> argparse.ArgumentParser:
    import bench_torch

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--stages", action="store_true", help="each stage alone (default)")
    p.add_argument("--prefix", action="store_true", help="cumulative prefixes F1-B7")
    p.add_argument("--expand", action="store_true", help="expand_pairs' sub-stages")
    p.add_argument("--reps", type=int, default=REPS, help="calls a row is timed over")
    p.add_argument("--out", default=os.path.join(ROOT, "results",
                                                 "profile_raster_torch.json"))
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("--width", type=int, default=bench_torch.WIDTH)
    p.add_argument("--height", type=int, default=bench_torch.HEIGHT)
    p.add_argument("--n_gauss", type=int, default=bench_torch.N_GAUSS)
    return p


def main(argv=None) -> dict:
    import bench_torch
    import timing_torch as timing

    args = parser().parse_args(argv)
    if not (args.stages or args.prefix or args.expand):
        args.stages = True
    w = bench_torch.make_workload(args.width, args.height, args.n_gauss, args.device)
    card = timing.card(w.device)
    print(f"{card['name']} ({card['power_limit']}); {args.n_gauss} Gaussians at "
          f"{args.width}x{args.height}; {args.reps} calls a row", flush=True)
    out = dict(tool="tools/profile_raster_torch.py", device=str(w.device),
               card=card["name"], power_limit=card["power_limit"], width=args.width,
               height=args.height, n_gauss=args.n_gauss, reps=args.reps)
    pending = []    # (row, fn): profiled once every row is timed
    for mode, fn in (("stages", profile_stages), ("prefix", profile_prefix),
                     ("expand", profile_expand)):
        if getattr(args, mode):
            print(f"\n--- {mode} ---", flush=True)
            out[mode] = fn(w, args.reps, pending)
    profile_rows(pending, args.reps, w.device)
    if args.prefix:
        out["prefix"].update(attribution(out["prefix"]["rows"]))
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:              # afresh: never merged
        json.dump(out, fh, indent=1)
    print(f"wrote {args.out}", flush=True)
    return out


if __name__ == "__main__":
    main()
