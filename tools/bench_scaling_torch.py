"""Scaling of the PyTorch port measured on one card, with the bytes each
collective moves and a model of D cards (the port of `tools/bench_scaling.py`).

    python3 tools/bench_scaling_torch.py [--device cpu] [--out PATH]
        [--width W --height H --n_gauss N --steps S --warm K --d_list D ...]
        [--profile all|critical]

`bench_torch.py`'s scene (100,000 random Gaussians at 1080p, `max_per_tile`
1024, 9 pairs and 3 rows per Gaussian, white, loss sum(color^2) over the
image's rows, the gradients of all four inputs); every step timed as the
bench times its own (median host ms of S synchronized steps after K warm
ones; device busy ms and operations from torch.profiler once every host time
is taken: of every item, or with `--profile critical` of the plain and
training steps and each D's critical band and emulated ranks alone, whose
busy ms the model reads). Five parts:

(a) the plain step, `bench_torch.fwd_bwd`.
(b) the tile axis at each D of --d_list (1, 2, 4, 8): each band of the grid
    padded to D bands (`sharding.padded_grid_y(H, D)`) alone, its
    `rasterize_band` forward + backward (`bench_sharded_torch.band_grads`):
    `per_band_ms`, `critical_ms` (the largest), `mean_ms`, each band's busy
    ms and operations (`critical_busy_ms`), live pairs and overflow. Each
    band's counters at the JAX tool's capacities (`max(2, ceil(9 / D) + 1)`
    pairs, `max(1, ceil(3 / D))` rows per Gaussian, `tools/bench_scaling.py:
    153-156`, fault B13), then timed at those doubled until no band overflows
    (`bench_playback_torch.load_sized` on each band).
(c) the Gaussian-table axis at each D: each of the D shard slices (N / D
    rows) as one emulated rank, `rasterize_band_gauss_sharded(...,
    emulate_d=D)` forward + backward (its own buckets stand in for the
    received ones). The exact (shard, band) bucket histogram and its max;
    `per_device_ms`, `critical_ms` and each rank's `send_overflow` at two
    send capacities: the design's `gauss_shard.send_capacity` (what training
    sends) and the JAX tool's `bucket_max + 256` rounded up to 128 (what
    live splits would need).
(d) communication per card and step at each D, counted as
    `tools/bench_sharded_torch.py` counts it (fault B12): each band's pair
    histogram, the gradient all-reduce, the halo, the pair exchange at the
    design's splits and for the live pairs, and the JAX tool's figures under
    `jax_count`; the data axis's all-reduce is the one the (1, 1) training
    step of (e) hands `torch.distributed`.
(e) one `MeshTrainer` (an icosphere-3 proxy subdivided past N Gaussians at
    the bench's 1080p, SH degree 0, lambda 0.2, alpha_mrloss 6.0, a grey
    target): its single-process `step` and `train_step.make_sharded_train_step`
    on a world-of-one (1, 1) mesh, each from a copy of the same state; the
    first step's losses and parameters held against each other; the ratio.

The model, per D and for both axes, on the host clock (what the card does
today) and on the device-busy clock (what it would do if the host kept up),
over the links of `bench_sharded_torch.LINKS` (public spec figures, not
measurements): efficiency = plain / (D x (compute + comm)) without overlap
and plain / (D x max(compute, comm)) with it. The tile axis's compute is its
critical band and its comm the bench step's gradient all-reduce and the
halo; the Gaussian-table axis's compute is its critical rank at the design
capacity and its comm the design's exchange; the data axis runs the whole
training step per card with the step's all-reduces as comm.

Writes results/scaling_torch.json (or --out) afresh, with the card's name
and power limit, and prints the JAX tool's line:
  {"metric": "scaling_efficiency_8dev_model", "value": x, "unit": "fraction",
   "vs_baseline": x / 0.8, "detail": {...}}
where x is the better axis's overlap efficiency at the largest D of the list
(8 by default) on the host clock over NVLink. The size flags exist for the
CPU tests; the defaults are the JAX tool's sizes. Runs on CUDA unless
`--device cpu`; with no card it raises.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _p in (ROOT, os.path.join(ROOT, "tools")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import numpy as np  # noqa: E402
import torch  # noqa: E402

D_LIST = (1, 2, 4, 8)
DATA_D = (2, 4, 8, 16)
PROXY_SUBDIV = 3
LR_SCALE = 4.0
BASELINE = 0.8              # BASELINE.md's scaling bar, as in the JAX tool


def jax_capacity(d: int) -> list[int]:
    """The JAX tool's per-band pairs and rows per Gaussian
    (`tools/bench_scaling.py:153-156`)."""
    return [max(2, -(-9 // d) + (1 if d > 1 else 0)), max(1, -(-3 // d))]


def band_geometry(height: int, d: int) -> tuple[int, int]:
    """(padded tile rows, tile rows per band) of D bands."""
    from gaussianmesh_tpu_torch.parallel import sharding

    gy_pad = sharding.padded_grid_y(height, d)
    return gy_pad, sharding.band_rows(gy_pad, d)


def band_config(cfg, rec: dict):
    """cfg at a band record's timed capacities and max_per_tile."""
    return dataclasses.replace(cfg, pair_capacity_per_gaussian=rec["capacity"][0],
                               row_capacity_per_gaussian=rec["capacity"][1],
                               max_per_tile=rec["max_per_tile"])


def band_call(w, cfg, gy_local: int, y0: int):
    """One band's timed step: its forward + backward, gradients reduced."""
    import bench_sharded_torch as sharded

    return sharded.reduced(lambda: sharded.band_grads(w, cfg, gy_local, y0))


def shard_inputs(w, d: int, k: int) -> list[torch.Tensor]:
    """Rows [k N / D, (k + 1) N / D) of the bench's four inputs, as leaves."""
    n_local = w.inputs[0].shape[0] // d
    return [x.detach()[k * n_local:(k + 1) * n_local].clone().requires_grad_(True)
            for x in w.inputs]


def gshard_call(w, d: int, inputs, cap: int):
    """One emulated rank's timed step: `rasterize_band_gauss_sharded(...,
    emulate_d=D)` of its shard, loss sum(color^2), gradients reduced."""
    import bench_sharded_torch as sharded
    from gaussianmesh_tpu_torch.parallel import gauss_shard

    def step():
        out = gauss_shard.rasterize_band_gauss_sharded(
            sharded.arrays_of(inputs), w.cam, w.cfg, None, cap, w.bg, emulate_d=d)
        loss = (out.color ** 2).sum()
        return loss.detach(), torch.autograd.grad(loss, inputs), out
    return sharded.reduced(step)


@torch.no_grad()
def band_counters(w, cfg, gy_local: int, y0: int) -> dict:
    """One band's forward at cfg: its overflow counters and live pairs."""
    import bench_sharded_torch as sharded
    from gaussianmesh_tpu_torch.parallel.train_step import rasterize_band

    o = rasterize_band(sharded.arrays_of(w.inputs), w.cam, cfg, gy_local, y0, w.bg)
    return dict(tile_overflow=int(o.tile_overflow), rect_overflow=int(o.rect_overflow),
                pair_overflow=int(o.pair_overflow), num_rendered=int(o.num_rendered))


def tile_axis(w, d_list, hist, steps, warm, deferred) -> dict:
    """(b): each band of each D alone, at capacities sized for the bands."""
    import bench_playback_torch as playback
    import bench_sharded_torch as sharded

    cfg, dev = w.cfg, w.device
    arrays = sharded.arrays_of([x.detach() for x in w.inputs])
    per_d = {}
    for d in d_list:
        gy_pad, gy_local = band_geometry(cfg.height, d)
        jcap = jax_capacity(d)
        jcfg = dataclasses.replace(cfg, pair_capacity_per_gaussian=jcap[0],
                                   row_capacity_per_gaussian=jcap[1])
        at_jax = [band_counters(w, jcfg, gy_local, k * gy_local) for k in range(d)]
        sized = [playback.load_sized(arrays, w.cam, jcfg, band=(k * gy_local, gy_local))
                 for k in range(d)]
        rec = dict(gy_pad=gy_pad, gy_local=gy_local, jax_capacity=jcap,
                   jax_max_per_tile=cfg.max_per_tile, at_jax_capacity=at_jax,
                   capacity=[max(c.pair_capacity_per_gaussian for c, _ in sized),
                             max(c.row_capacity_per_gaussian for c, _ in sized)],
                   max_per_tile=max(c.max_per_tile for c, _ in sized),
                   largest_tile=[s["largest_tile"] for _, s in sized],
                   pair_hist=hist[str(d)], bands=[])
        tcfg = band_config(cfg, rec)
        for k in range(d):
            call = band_call(w, tcfg, gy_local, k * gy_local)
            o = call()[2]
            if int(o.tile_overflow + o.rect_overflow + o.pair_overflow):
                raise AssertionError(f"D = {d}, band {k} overflows at the sized capacities")
            rec["bands"].append(sharded.timed_step(
                call, steps, warm, dev, deferred, y0_tiles=k * gy_local,
                num_rendered=int(o.num_rendered), tile_overflow=int(o.tile_overflow),
                rect_overflow=int(o.rect_overflow), pair_overflow=int(o.pair_overflow)))
        per_d[str(d)] = rec
    return per_d


def gauss_axis(w, d_list, tiles, gids, steps, warm, deferred) -> dict:
    """(c): each shard slice of each D as one emulated rank, at the design's
    send capacity and at the JAX tool's."""
    import bench_sharded_torch as sharded
    from gaussianmesh_tpu_torch.parallel import gauss_shard

    cfg, dev, n = w.cfg, w.device, w.inputs[0].shape[0]
    gx, gy = cfg.grid
    per_d = {}
    for d in d_list:
        if n % d:
            raise ValueError(f"{n} Gaussians do not split into {d} equal shards")
        buckets = sharded.bucket_hist(tiles, gids, gx, gy, n, d)
        bmax = int(buckets.max())
        caps = {"design": gauss_shard.send_capacity(cfg, n // d, d),
                "jax_live": -(-(bmax + 256) // 128) * 128}
        rec = dict(n_local=n // d, buckets=buckets.tolist(), bucket_max=bmax,
                   send_capacity=dict(caps))
        for label, cap in caps.items():
            ranks = []
            for k in range(d):
                call = gshard_call(w, d, shard_inputs(w, d, k), cap)
                o = call()[2]
                if int(o.sent) != int(buckets[k].sum()) or int(o.send_overflow):
                    raise AssertionError(f"D = {d}, rank {k} at {label} capacity {cap}: "
                                         f"sent {int(o.sent)} pairs of the histogram's "
                                         f"{int(buckets[k].sum())}")
                ranks.append(sharded.timed_step(
                    call, steps, warm, dev, deferred, send_overflow=int(o.send_overflow),
                    sent=int(o.sent), received_live=int(o.num_rendered),
                    tile_overflow=int(o.tile_overflow), rect_overflow=int(o.rect_overflow)))
            rec[label] = dict(ranks=ranks)
        per_d[str(d)] = rec
    return per_d


def summarize_items(rec: dict, items: list, key: str) -> None:
    """rec gains the items' host ms (under `key`, the largest `critical_ms`
    and its index, `mean_ms`) and busy ms (`per_busy_ms`, `critical_busy_ms`)."""
    ms = [r["host_ms"] for r in items]
    busy = [r["busy_ms"] for r in items]
    profiled = [b for b in busy if b is not None]
    rec.update({key: ms}, critical_ms=max(ms), critical_index=int(np.argmax(ms)),
               mean_ms=float(np.mean(ms)), per_busy_ms=busy,
               critical_busy_ms=max(profiled) if profiled else None)


def critical_only(deferred: list, tile: dict, gauss: dict) -> list:
    """The queued profiles less those of the bands and emulated ranks that
    are not their D's critical one (the largest host ms); with only the
    critical item profiled, its busy ms is the D's `critical_busy_ms`."""
    groups = [rec["bands"] for rec in tile.values()] + [
        rec[label]["ranks"] for rec in gauss.values() for label in ("design", "jax_live")]
    items = {id(r) for g in groups for r in g}
    keep = {id(max(g, key=lambda r: r["host_ms"])) for g in groups}
    return [e for e in deferred if id(e[0]) not in items or id(e[0]) in keep]



def trainer_1x1(w, mesh, steps, warm, deferred) -> dict:
    """(e): the single-process trainer step and the (1, 1) sharded step on
    `mesh` of one `MeshTrainer`, each from a copy of the same state."""
    import bench_sharded_torch as sharded
    import scenes_torch
    from gaussianmesh_tpu_torch.config import OptimizationParams, RuntimeParams
    from gaussianmesh_tpu_torch.parallel import sharding, train_step
    from gaussianmesh_tpu_torch.train.trainer import DeviceDataset, MeshTrainer

    cfg, dev, cam = w.cfg, w.device, w.cam
    gt = torch.full((1, 3, cfg.height, cfg.width), 127, dtype=torch.uint8, device=dev)
    ds = DeviceDataset(view=cam.viewmatrix[None], proj=cam.projmatrix[None],
                       campos=cam.campos[None], tanfovx=cam.tanfovx[None],
                       tanfovy=cam.tanfovy[None], images=gt, masks=None,
                       width=cfg.width, height=cfg.height)
    opt = OptimizationParams()
    rt = RuntimeParams(max_per_tile=cfg.max_per_tile,
                       pair_capacity_per_gaussian=cfg.pair_capacity_per_gaussian,
                       row_capacity_per_gaussian=cfg.row_capacity_per_gaussian)
    v, f = scenes_torch.icosphere(PROXY_SUBDIV)
    tr = MeshTrainer(v, f, ds, opt, rt, spatial_lr_scale=LR_SCALE,
                     init_target=w.inputs[0].shape[0])
    s0 = tr.capture()
    bg = tr.bg_const
    pad = sharding.padded_grid_y(cfg.height, 1) * 16 - cfg.height
    gt_pad = torch.nn.functional.pad(ds.target(0, bg), (0, 0, 0, pad))
    res = dict(proxy_subdiv=PROXY_SUBDIV, faces=int(f.shape[0]),
               n_gauss=int(tr.model.alive.sum()), capacity=tr.model.capacity,
               sh_degree=tr.sh_degree, lambda_dssim=opt.lambda_dssim,
               alpha_mrloss=opt.alpha_mrloss)
    step = train_step.make_sharded_train_step(
        mesh, tr.adam, tr.raster_cfg(), tr.sh_degree, opt.lambda_dssim,
        opt.alpha_mrloss, cfg.width, cfg.height)

    def sharded_step():
        return step(tr.model, ds.camera(0), gt_pad, bg)

    # the first step of each from the same state
    m = tr.step(0, bg)
    plain_params = [p.detach().clone() for p in tr.model.params().values()]
    plain = dict(loss=float(m["loss"]), num_rendered=int(m["num_rendered"]),
                 overflow=int(m["tile_overflow"] + m["rect_overflow"]))
    tr.restore(s0)
    with sharded.Traffic(mesh) as traffic:
        m = sharded_step()
    got = [p.detach() for p in tr.model.params().values()]
    one = dict(loss=float(m["loss"]), num_rendered=int(m["num_rendered"]),
               overflow=int(m["tile_overflow"] + m["rect_overflow"]),
               loss_rel=abs(float(m["loss"]) - plain["loss"]) / abs(plain["loss"]),
               param_rel=sharded.max_rel(got, plain_params))
    del got, plain_params
    tr.restore(s0)
    res["plain"] = sharded.timed_step(lambda: tr.step(0, bg), steps, warm, dev,
                                      deferred, first_step=plain)
    tr.restore(s0)
    res["sharded_1x1"] = sharded.timed_step(sharded_step, steps, warm, dev, deferred,
                                            first_step=one)
    res["traffic"] = traffic.calls
    return res


def comms(w, d_list, tiles, gids, gauss, trainer, grad_buffer, per_slot) -> dict:
    """(d): bytes per card and step at each D."""
    import bench_sharded_torch as sharded

    cfg, n = w.cfg, w.inputs[0].shape[0]
    gx, gy = cfg.grid
    by_group = {}
    for c in trainer["traffic"]:
        if c["kind"] == "all_reduce":
            by_group[c["group"]] = by_group.get(c["group"], 0) + c["bytes"]
    out = {}
    for d in sorted(set(d_list) | set(DATA_D)):
        hist = sharded.band_hist(tiles, gx, gy, d)
        rec = dict(pair_hist=hist.tolist(),
                   bench_grad_all_reduce_buffer=grad_buffer,
                   bench_grad_all_reduce_ring=sharded.ring(grad_buffer, d) if d > 1 else 0,
                   halo=sharded.halo_bytes(cfg.width, d),
                   # the (1, 1) training step's all-reduces, on a (D, 1) mesh (data
                   # axis: its world and data groups) and a (1, D) mesh (tile axis:
                   # its world and tile groups)
                   train_data_axis_ring=sum(sharded.ring(by_group.get(g, 0), d)
                                            for g in ("world", "data")) if d > 1 else 0,
                   train_tile_axis_ring=sum(sharded.ring(by_group.get(g, 0), d)
                                            for g in ("world", "tile")) if d > 1 else 0)
        g = gauss.get(str(d))
        if g is not None:
            buckets = np.asarray(g["buckets"])
            rec["exchange"] = sharded.exchange_bytes(d, g["send_capacity"]["design"],
                                                     buckets, per_slot)
            rec["exchange_jax_live_capacity"] = sharded.exchange_bytes(
                d, g["send_capacity"]["jax_live"], buckets, per_slot)
        ar = 2 * (d - 1) / d * n * sharded.JAX_PARAM_FLOATS_SCALING * 4
        rec["jax_count"] = dict(
            a2a_send_capacity=int(hist.max()),
            a2a_bytes_per_dev=d * int(hist.max()) * sharded.JAX_PAIR_BYTES,
            grad_allreduce_bytes=int(ar) if d > 1 else 0,
            halo_bytes=2 * 2 * sharded.HALO * cfg.width * 3 * 4 if d > 1 else 0)
        out[str(d)] = rec
    return out


def efficiency(t_plain, t_comp, comm_bytes, d):
    """{link: {comm_ms, eff_no_overlap, eff_overlap}} of D cards."""
    import bench_sharded_torch as sharded

    if t_plain is None or t_comp is None:
        return None
    out = dict(t_comp_ms=t_comp)
    for link, spec in sharded.LINKS.items():
        comm_ms = comm_bytes / spec["bytes_per_s"] * 1e3
        out[link] = dict(comm_ms=comm_ms,
                         eff_no_overlap=t_plain / (d * (t_comp + comm_ms)),
                         eff_overlap=t_plain / (d * max(t_comp, comm_ms)))
    return out


def models(plain, tile, gauss, trainer, comm, d_list) -> dict:
    """The efficiency model of both axes and of the data axis, on the host
    clock and on the device-busy clock."""
    out = {}
    for clock, t_key, c_key in (("host", "host_ms", "critical_ms"),
                                ("busy", "busy_ms", "critical_busy_ms")):
        t_plain = plain[t_key]
        tile_m, gauss_m, data_m = {}, {}, {}
        for d in d_list:
            if d == 1:
                continue
            c = comm[str(d)]
            tile_m[str(d)] = efficiency(t_plain, tile[str(d)][c_key],
                                        c["bench_grad_all_reduce_ring"] + c["halo"], d)
            design = gauss[str(d)]["design"]
            gauss_m[str(d)] = efficiency(t_plain, design[c_key],
                                         c["exchange"]["design_bytes_leaving"], d)
        t_step = trainer["plain"][t_key]
        for d in DATA_D:       # D cards, each a whole step on its own camera
            data_m[str(d)] = efficiency(None if t_step is None else d * t_step, t_step,
                                        comm[str(d)]["train_data_axis_ring"], d)
        out[clock] = dict(tile_axis=tile_m, gauss_shard_axis=gauss_m, data_axis=data_m)
    return out


def parser() -> argparse.ArgumentParser:
    import bench_torch

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("--out", default=os.path.join(ROOT, "results", "scaling_torch.json"))
    p.add_argument("--width", type=int, default=bench_torch.WIDTH)
    p.add_argument("--height", type=int, default=bench_torch.HEIGHT)
    p.add_argument("--n_gauss", type=int, default=bench_torch.N_GAUSS)
    p.add_argument("--steps", type=int, default=bench_torch.STEPS)
    p.add_argument("--warm", type=int, default=bench_torch.WARM)
    p.add_argument("--d_list", type=int, nargs="+", default=list(D_LIST))
    p.add_argument("--profile", choices=("all", "critical"), default="all",
                   help="profile every band and emulated rank, or each D's critical ones")
    return p


def main(argv=None) -> dict:
    from gaussianmesh_tpu_torch.parallel import gauss_shard

    import bench_playback_torch as playback
    import bench_sharded_torch as sharded
    import bench_torch
    import timing_torch as timing

    args = parser().parse_args(argv)
    w = bench_torch.make_workload(args.width, args.height, args.n_gauss, args.device)
    dev, cfg, n, d_list = w.device, w.cfg, args.n_gauss, sorted(set(args.d_list))
    card = timing.card(dev)
    gx, gy = cfg.grid
    out = dict(tool="tools/bench_scaling_torch.py", device=str(dev), card=card["name"],
               power_limit=card["power_limit"], n_gauss=n, width=args.width,
               height=args.height, steps=args.steps, warm=args.warm, d_list=d_list,
               profile=args.profile,
               links=sharded.LINKS, factors=sharded.FACTORS)
    deferred = []

    # (a) the plain step
    loss, _, o = bench_torch.fwd_bwd(w)
    plain = sharded.timed_step(lambda: bench_torch.fwd_bwd(w), args.steps, args.warm,
                               dev, deferred, loss=float(loss),
                               num_rendered=int(o.num_rendered),
                               overflow=int(o.tile_overflow + o.rect_overflow))
    tiles, gids, _ = sharded.scene_pairs(w)
    hist = {str(d): sharded.band_hist(tiles, gx, gy, d).tolist() for d in d_list}

    # (b), (c)
    tile = tile_axis(w, d_list, hist, args.steps, args.warm, deferred)
    gauss = gauss_axis(w, d_list, tiles, gids, args.steps, args.warm, deferred)
    with sharded.world_of_one(dev) as mesh:
        # (e), then every profile (after every host time)
        trainer = trainer_1x1(w, mesh, args.steps, args.warm, deferred)
        if args.profile == "critical":
            deferred = critical_only(deferred, tile, gauss)
        playback.run_profiles(deferred, dev)
        # (d): the bench step's all-reduce and the exchange's slots, from one
        # (1, 1) step of each regime
        with sharded.Traffic(mesh) as t_tile:
            sharded.tile_step(w, mesh)
        with sharded.Traffic(mesh) as t_gauss:
            sharded.gauss_step(w, mesh, gauss_shard.send_capacity(cfg, n, 1))
    for clock in ("host", "busy"):
        a, b = (trainer[k][f"{clock}_ms"] for k in ("sharded_1x1", "plain"))
        trainer[f"ratio_{clock}"] = None if b is None else a / b
    for rec in tile.values():
        summarize_items(rec, rec["bands"], "per_band_ms")
    for rec in gauss.values():
        for label in ("design", "jax_live"):
            summarize_items(rec[label], rec[label]["ranks"], "per_device_ms")
    grad_buffer = sum(c["bytes"] for c in t_tile.calls if c["kind"] == "all_reduce")
    comm = comms(w, d_list, tiles, gids, gauss, trainer, grad_buffer,
                 sharded.slot_bytes(t_gauss.calls))

    out.update(plain_step=plain, tile_bands=tile, gauss_shard_bands=gauss,
               sharded_train_step=trainer, comms=comm,
               efficiency_model=dict(
                   formula=("eff_no_overlap = plain / (D x (compute + comm)); "
                            "eff_overlap = plain / (D x max(compute, comm))"),
                   compute=("tile axis: the critical band; Gaussian-table axis: the "
                            "critical emulated rank at the design's send capacity; "
                            "data axis: the whole training step"),
                   comm=("tile axis: the bench step's gradient all-reduce (ring) + the "
                         "training step's halo; Gaussian-table axis: the design's "
                         "exchange leaving a card, out and back; data axis: the "
                         "training step's all-reduces (ring)"),
                   **models(plain, tile, gauss, trainer, comm, d_list)))

    d_top = max(d_list)
    host = out["efficiency_model"]["host"]
    axes = {k: (host[k].get(str(d_top)) or {}).get("nvlink4", {}).get("eff_overlap")
            for k in ("tile_axis", "gauss_shard_axis")}
    best = max([v for v in axes.values() if v is not None], default=0.0)
    out["summary"] = dict(d=d_top, clock="host", link="nvlink4", bound="overlap", **axes)

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:              # afresh: never merged
        json.dump(out, fh, indent=1)
    print(json.dumps({
        "metric": "scaling_efficiency_8dev_model", "value": best, "unit": "fraction",
        "vs_baseline": best / BASELINE,
        "detail": {"d": d_top, "plain_step_ms": plain["host_ms"],
                   "plain_busy_ms": plain["busy_ms"],
                   "critical_band_ms": {d: r["critical_ms"] for d, r in tile.items()},
                   "gauss_shard_critical_ms": {d: r["design"]["critical_ms"]
                                               for d, r in gauss.items()},
                   "tile_axis_eff": axes["tile_axis"],
                   "gauss_shard_eff": axes["gauss_shard_axis"],
                   "sharded_1x1_step_ms": trainer["sharded_1x1"]["host_ms"],
                   "plain_train_step_ms": trainer["plain"]["host_ms"],
                   "card": card["name"], "power_limit": card["power_limit"],
                   "file": args.out},
    }), flush=True)
    return out


if __name__ == "__main__":
    main()
