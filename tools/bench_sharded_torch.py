"""The sharded steps' overhead on one card and the bytes each collective moves
(the port of `tools/bench_sharded.py`).

    python3 tools/bench_sharded_torch.py [--device cpu] [--out PATH]
        [--width W --height H --n_gauss N --steps S --warm K]

The workload is `bench_torch.py`'s: 100,000 random Gaussians at 1080p,
`max_per_tile` 1024, 9 pairs and 3 rows per Gaussian, a white background,
the loss sum(color^2) over the image's rows and the gradients of all four
inputs. Three steps, each timed as the bench times its own (the median host
ms of S steps, each ending in a synchronize, after K warm ones; the device's
busy ms and operations from torch.profiler once every host time is taken):

1. plain: `bench_torch.fwd_bwd`;
2. tile: the (data, tile) regime's step on a (1, 1) `ProcessMesh`, as
   `parallel/train_step.py` runs it: `rasterize_band` over the whole padded
   grid, the gradients, then one `all_reduce` of the flattened gradients and
   the loss over the world;
3. gauss: the Gaussian-table step on the same mesh:
   `gauss_shard.rasterize_band_gauss_sharded` with the real `all_to_all` (a
   device copy in a world of one) at `gauss_shard.send_capacity`, the
   gradients, then one `all_reduce` of the loss and the counters.

Each step's overhead is its host ms over the plain step's (and its busy ms
over the plain busy ms); its loss and gradients are held against the plain
step's (`agreement`). The world of one is the caller's process group when
one is initialised (it must have one rank), else one this tool creates on a
`FileStore` in a temporary directory (nccl on the card, gloo on the CPU) and
destroys before it returns.

The replicated share: the host (and busy) ms of the step's forward through
the expansion, preprocess + `binning.expand_pairs`
(`tools/profile_raster_torch.py`'s F2 row), which every band of the tile
axis repeats. The JAX tool took it as a constant 1.0 ms measured on a TPU.

Bytes per step (fault B12, ROADMAP.md), from the tensors the port's
collectives are handed in steps 2 and 3 (`Traffic`): the all-reduce buffer,
and per exchanged slot the metadata and the feature row out and the feature
cotangent back. From them, for D = 2, 4, 8, 16: the all-reduce's ring bytes;
the pair exchange at the design's equal splits, D x send_capacity(N / D)
slots, of which (D - 1) / D leave the card; the live pairs alone (what split
sizes would send) from the scene's exact (shard, band) histogram; the SSIM
halo of a training step (`sharding.halo_exchange_rows` all-gathers each
band's 2 x 5 edge rows over the D bands: image and target forward, the
image's cotangent back). Beside them, under `jax_count`, the JAX tool's
formulas.

The model: per-card ms = replicated + (step - replicated) / D + bytes /
link, efficiency = plain / (D x per-card ms), no overlap, on the host clock
and on the device-busy clock, over two links whose rates are public spec
figures, not measurements (`LINKS`).

Writes results/sharded_bench_torch.json (or --out) afresh, with the card's
name and power limit, and prints it as one JSON line. Runs on CUDA unless
`--device cpu`; with no card it raises.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _p in (ROOT, os.path.join(ROOT, "tools")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

STEPS, WARM = 10, 3
MODEL_D = (2, 4, 8, 16)
HALO = 5                      # the 11-wide SSIM window's half (train_step.ssim_sum_band)
# Link rates of the model: public spec figures, assumptions, not measurements.
LINKS = {
    "nvlink4": dict(bytes_per_s=450e9, spec=(
        "NVLink 4, H100 SXM5: 900 GB/s per GPU in all, 450 GB/s per direction "
        "(NVIDIA H100 data sheet); an assumption, not measured")),
    "ib_ndr": dict(bytes_per_s=50e9, spec=(
        "InfiniBand NDR: 400 Gb/s = 50 GB/s per direction per card, one "
        "ConnectX-7 per GPU as in a DGX H100; an assumption, not measured")),
}
FACTORS = {"all_reduce": "2 (D - 1) / D of the buffer per card (ring)",
           "all_to_all": "(D - 1) / D of a card's buffer leaves it (equal splits)",
           "all_gather": "(D - 1) chunks per card"}
# the JAX tools' counts, kept beside the port's (fault B12)
JAX_PAIR_BYTES = 4 * (16 + 3)     # bench_sharded.py:177, bench_scaling.py:59
JAX_PARAM_FLOATS_SHARDED = 60     # bench_sharded.py:171-176
JAX_PARAM_FLOATS_SCALING = 59     # bench_scaling.py:232-234


@contextlib.contextmanager
def world_of_one(device: torch.device):
    """A (1, 1) `ProcessMesh`: over the caller's process group when one is
    initialised (one rank), else over a world of one this creates on a
    `FileStore` in a temporary directory (nccl on the card, gloo on the CPU)
    and destroys on the way out."""
    from gaussianmesh_tpu_torch.parallel import multihost, sharding

    if dist.is_initialized():
        if dist.get_world_size() != 1:
            raise RuntimeError(f"a one-card measurement needs a world of one, not "
                               f"{dist.get_world_size()}")
        yield sharding.make_mesh(1, 1)
        return
    cuda = device.type == "cuda"
    if cuda and device.index is not None:
        torch.cuda.set_device(device)
    with tempfile.TemporaryDirectory(prefix="gm_world1_") as tmp:
        dist.init_process_group("nccl" if cuda else "gloo",
                                store=dist.FileStore(os.path.join(tmp, "store"), 1),
                                rank=0, world_size=1, timeout=multihost.group_timeout())
        try:
            yield sharding.make_mesh(1, 1)
        finally:
            dist.destroy_process_group()


class Traffic:
    """While active, records each tensor handed to the port's collectives:
    `sharding.all_reduce`, and `sharding._exchange`, which both directions of
    `sharding.all_to_all` go through. `calls`: {kind, group, shape, bytes}."""

    def __init__(self, mesh):
        self.groups = {id(mesh.world_group): "world", id(mesh.data_group): "data",
                       id(mesh.tile_group): "tile"}
        self.calls = []

    def _record(self, kind, x, group):
        self.calls.append(dict(kind=kind, group=self.groups.get(id(group), "other"),
                               shape=list(x.shape), bytes=x.numel() * x.element_size()))

    def __enter__(self):
        from gaussianmesh_tpu_torch.parallel import sharding

        self._kept = sharding.all_reduce, sharding._exchange
        all_reduce, exchange = self._kept

        def recorded_all_reduce(x, group, *a, **k):
            self._record("all_reduce", x, group)
            return all_reduce(x, group, *a, **k)

        def recorded_exchange(x, group):
            self._record("all_to_all", x, group)
            return exchange(x, group)

        sharding.all_reduce, sharding._exchange = recorded_all_reduce, recorded_exchange
        return self

    def __exit__(self, *exc):
        from gaussianmesh_tpu_torch.parallel import sharding

        sharding.all_reduce, sharding._exchange = self._kept
        return False


def valid_rows(w, rows: int, y0_px: int = 0) -> torch.Tensor:
    """(1, rows, 1): 1 on the image's pixel rows of a band starting at pixel
    row y0_px, 0 on the padding below the image."""
    r = y0_px + torch.arange(rows, device=w.device)
    return (r < w.cfg.height).to(torch.float32)[None, :, None]


def arrays_of(inputs):
    """`GaussianArrays` of (means3d, cov6, opacity, rgb), every row active."""
    from gaussianmesh_tpu_torch.models.render import GaussianArrays

    means, cov6, op, rgb = inputs
    return GaussianArrays(means, cov6, op, rgb,
                          torch.ones(means.shape[0], dtype=torch.bool, device=means.device))


def band_grads(w, cfg, gy_local: int, y0: int, inputs=None):
    """`rasterize_band` of tile rows [y0, y0 + gy_local) of the bench scene,
    loss sum((color * valid rows)^2) -> (loss, gradients of the inputs, out)."""
    from gaussianmesh_tpu_torch.parallel.train_step import rasterize_band

    inputs = w.inputs if inputs is None else inputs
    out = rasterize_band(arrays_of(inputs), w.cam, cfg, gy_local, y0, w.bg)
    ok = valid_rows(w, out.color.shape[1], y0 * 16)
    loss = ((out.color * ok) ** 2).sum()
    return loss.detach(), list(torch.autograd.grad(loss, inputs)), out


def tile_step(w, mesh):
    """The (data, tile) step on `mesh`: this rank's band, then one
    `all_reduce` of the flattened gradients and the loss over the world."""
    from gaussianmesh_tpu_torch.parallel import sharding

    gy_local = sharding.band_rows(sharding.padded_grid_y(w.cfg.height, mesh.n_tile),
                                  mesh.n_tile)
    loss, grads, out = band_grads(w, w.cfg, gy_local, mesh.tile_index * gy_local)
    flat = sharding.all_reduce(torch.cat([g.reshape(-1) for g in grads]
                                         + [loss.reshape(1)]), mesh.world_group)
    parts = torch.split(flat[:-1], [x.numel() for x in w.inputs])
    return flat[-1], [p.view_as(x) for p, x in zip(parts, w.inputs)], out


def gauss_step(w, mesh, send_capacity: int):
    """The Gaussian-table step on `mesh` (the whole table is this rank's
    shard in a world of one): the band from the exchanged pairs, the
    gradients, one `all_reduce` of the loss and the counters."""
    from gaussianmesh_tpu_torch.parallel import gauss_shard, sharding

    out = gauss_shard.rasterize_band_gauss_sharded(arrays_of(w.inputs), w.cam, w.cfg,
                                                   mesh, send_capacity, w.bg)
    ok = valid_rows(w, out.color.shape[1], mesh.tile_index * out.color.shape[1])
    loss = ((out.color * ok) ** 2).sum()
    grads = torch.autograd.grad(loss, w.inputs)
    sums = sharding.all_reduce(torch.stack([loss.detach().double()] + [
        c.double() for c in (out.send_overflow, out.tile_overflow, out.rect_overflow,
                             out.num_rendered)]), mesh.tile_group)
    return sums[0].float(), list(grads), out


def reduced(step):
    """step() with its gradients reduced, as `bench_torch.fwd_bwd` reduces
    its own."""
    def call():
        loss, grads, out = step()
        return loss, sum(g.sum() for g in grads), out
    return call


def forward_through_expansion(w):
    """Preprocess (recording autograd, as in the step) + the whole image's
    `binning.expand_pairs`: `tools/profile_raster_torch.py`'s F2 row."""
    from gaussianmesh_tpu_torch.ops import binning, preprocess as prep_mod

    cfg = w.cfg
    means, cov6, op, _ = w.inputs
    n = means.shape[0]
    prep = prep_mod.preprocess(means, cov6, w.cam, cfg.width, cfg.height, opacity=op)
    with torch.no_grad():
        exp = binning.expand_pairs(prep, *cfg.grid, cfg.expand_capacity(n), opacity=op,
                                   row_capacity=cfg.row_capacity(n))
    return prep, exp


@torch.no_grad()
def scene_pairs(w):
    """The whole image's live pairs -> (tile ids, Gaussian ids) as int64
    numpy arrays, and the expansion's rect_overflow."""
    _, exp = forward_through_expansion(w)
    return (exp.pair_tile.cpu().numpy(), exp.pair_gid.cpu().numpy(),
            int(exp.rect_overflow))


def band_hist(tiles, gx: int, gy: int, d: int) -> np.ndarray:
    """Live pairs per band of D (`tools/bench_scaling.py:256-258`)."""
    gy_pad = -(-gy // d) * d
    return np.bincount(np.minimum(tiles // gx // (gy_pad // d), d - 1), minlength=d)


def bucket_hist(tiles, gids, gx: int, gy: int, n: int, d: int) -> np.ndarray:
    """(D, D) live pairs by (shard of the Gaussian, band of the tile)
    (`tools/bench_scaling.py:196-209`)."""
    gy_pad = -(-gy // d) * d
    shard_of = np.minimum(gids // (n // d), d - 1)
    band_of = np.minimum(tiles // gx // (gy_pad // d), d - 1)
    buckets = np.zeros((d, d), np.int64)
    np.add.at(buckets, (shard_of, band_of), 1)
    return buckets


def slot_bytes(calls) -> dict:
    """Bytes per exchanged slot from a recorded Gaussian-table step: the
    forward's metadata and feature rows, the backward's cotangent rows."""
    a2a = [c for c in calls if c["kind"] == "all_to_all"]
    if len(a2a) != 3:
        raise AssertionError(f"the Gaussian-table step made {len(a2a)} exchanges, not 3")
    meta, feat, back = ((c["bytes"] // c["shape"][0]) for c in a2a)
    return dict(meta=meta, feature=feat, cotangent=back)


def exchange_bytes(d: int, cap: int, buckets: np.ndarray, per_slot: dict) -> dict:
    """The pair exchange of one step per card at D: the design's equal
    splits (D x cap slots out and back, the own chunk staying) and the live
    pairs alone (the busiest card of the histogram)."""
    out_b = per_slot["meta"] + per_slot["feature"]
    back_b = per_slot["cotangent"]
    slots = d * cap
    live = buckets.sum(1)
    leaving = live - np.diag(buckets)
    k = int(np.argmax(leaving)) if d > 1 else 0
    return dict(send_capacity=cap, slots=slots, bytes_per_slot_out=out_b,
                bytes_per_slot_back=back_b,
                design_bytes_out=slots * out_b, design_bytes_back=slots * back_b,
                design_bytes_leaving=(slots - cap) * (out_b + back_b),
                live_pairs_max=int(live.max()), live_share_of_slots=float(live.max() / slots),
                live_bytes_leaving=int(leaving[k]) * (out_b + back_b))


def halo_bytes(width: int, d: int) -> int:
    """Bytes a card receives for the SSIM halo of one training step over D
    bands: `halo_exchange_rows` all-gathers a (3, 2 x HALO, W) float32 chunk
    per band, for the image and the target forward and the image's
    cotangent back."""
    chunk = 3 * 2 * HALO * width * torch.tensor([], dtype=torch.float32).element_size()
    return 3 * (d - 1) * chunk if d > 1 else 0


def ring(nbytes: int, d: int) -> float:
    return 2 * (d - 1) / d * nbytes


def timed_step(fn, steps, warm, dev, deferred, **extra) -> dict:
    """Host ms of fn() (median of `steps` synchronized calls after `warm`);
    its profile is queued in `deferred` for
    `bench_playback_torch.run_profiles`, which takes every profile after
    every host time."""
    import bench_playback_torch as playback
    import timing_torch as timing

    all_ms = timing.host_times(fn, steps, dev, warm=warm)
    res = dict(host_ms=statistics.median(all_ms), host_ms_all=all_ms, busy_ms=None,
               device_operations=None, idle_share=None, **extra)
    return playback.profile_later(deferred, res, fn, "host_ms")


def max_rel(got, ref) -> float:
    """max |got - ref| over each leaf's largest |ref|, over the leaves."""
    return max(float((g - r).abs().max() / r.abs().max().clamp(min=1e-30))
               for g, r in zip(got, ref))


def agreement(loss, grads, ref_loss, ref_grads) -> dict:
    return dict(loss=float(loss), loss_rel=abs(float(loss) - float(ref_loss))
                / abs(float(ref_loss)), grad_rel=max_rel(grads, ref_grads))


def model(t_plain, t_repl, t_tile, t_gauss, comm: dict) -> dict | None:
    """Per-card ms and efficiency at each D of MODEL_D over each link, no
    overlap; None where a time is (the device clock on the CPU)."""
    if None in (t_plain, t_repl, t_tile, t_gauss):
        return None
    out = {}
    for link, spec in LINKS.items():
        rate = spec["bytes_per_s"]
        per = {}
        for d in MODEL_D:
            c = comm[str(d)]
            row = {}
            for regime, t_d1, nbytes in (
                    ("tile", t_tile, c["grad_all_reduce_ring"] + c["halo"]),
                    ("gauss_design", t_gauss, c["exchange"]["design_bytes_leaving"]),
                    ("gauss_live", t_gauss, c["exchange"]["live_bytes_leaving"])):
                comm_ms = nbytes / rate * 1e3
                card_ms = t_repl + (t_d1 - t_repl) / d + comm_ms
                row[regime] = dict(comm_ms=comm_ms, card_ms=card_ms,
                                   efficiency=t_plain / (d * card_ms))
            per[str(d)] = row
        out[link] = per
    return out


def parser() -> argparse.ArgumentParser:
    import bench_torch

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("--out", default=os.path.join(ROOT, "results", "sharded_bench_torch.json"))
    p.add_argument("--width", type=int, default=bench_torch.WIDTH)
    p.add_argument("--height", type=int, default=bench_torch.HEIGHT)
    p.add_argument("--n_gauss", type=int, default=bench_torch.N_GAUSS)
    p.add_argument("--steps", type=int, default=STEPS)
    p.add_argument("--warm", type=int, default=WARM)
    return p


def main(argv=None) -> dict:
    from gaussianmesh_tpu_torch.parallel import gauss_shard

    import bench_playback_torch as playback
    import bench_torch
    import timing_torch as timing

    args = parser().parse_args(argv)
    w = bench_torch.make_workload(args.width, args.height, args.n_gauss, args.device)
    dev, cfg, n = w.device, w.cfg, args.n_gauss
    card = timing.card(dev)
    gx, gy = cfg.grid
    send_cap = gauss_shard.send_capacity(cfg, n, 1)
    deferred = []
    out = dict(tool="tools/bench_sharded_torch.py", device=str(dev), card=card["name"],
               power_limit=card["power_limit"],
               workload=dict(width=args.width, height=args.height, n_gauss=n,
                             steps=args.steps, warm=args.warm,
                             max_per_tile=cfg.max_per_tile,
                             capacity=[cfg.pair_capacity_per_gaussian,
                                       cfg.row_capacity_per_gaussian]))

    # 1. the plain step, and its gradients to hold the others against
    loss0, _, out0 = bench_torch.fwd_bwd(w)
    ref_grads = [x.grad.detach().clone() for x in w.inputs]
    steps = {"plain": timed_step(lambda: bench_torch.fwd_bwd(w), args.steps, args.warm,
                                 dev, deferred, loss=float(loss0),
                                 num_rendered=int(out0.num_rendered))}
    tiles, gids, rect_overflow = scene_pairs(w)
    out["workload"].update(live_pairs=int(tiles.shape[0]), rect_overflow=rect_overflow)

    # 2-3. the (1, 1) steps, their collectives recorded once
    with world_of_one(dev) as mesh:
        with Traffic(mesh) as tile_traffic:
            loss, grads, o = tile_step(w, mesh)
        steps["tile"] = timed_step(reduced(lambda: tile_step(w, mesh)), args.steps,
                                   args.warm, dev, deferred,
                                   agreement=agreement(loss, grads, loss0, ref_grads),
                                   num_rendered=int(o.num_rendered),
                                   overflow=int(o.tile_overflow + o.rect_overflow))
        with Traffic(mesh) as gauss_traffic:
            loss, grads, o = gauss_step(w, mesh, send_cap)
        steps["gauss"] = timed_step(reduced(lambda: gauss_step(w, mesh, send_cap)),
                                    args.steps, args.warm, dev, deferred,
                                    agreement=agreement(loss, grads, loss0, ref_grads),
                                    send_capacity=send_cap,
                                    num_rendered=int(o.num_rendered),
                                    send_overflow=int(o.send_overflow),
                                    overflow=int(o.tile_overflow + o.rect_overflow))
        del grads, o
        repl = timed_step(lambda: forward_through_expansion(w), args.steps, args.warm,
                          dev, deferred)
        playback.run_profiles(deferred, dev)
    for key in ("tile", "gauss"):
        s, p = steps[key], steps["plain"]
        s["overhead_host"] = s["host_ms"] / p["host_ms"]
        s["overhead_busy"] = (None if s["busy_ms"] is None
                              else s["busy_ms"] / p["busy_ms"])
    out["steps"] = steps
    out["replicated"] = dict(repl, what=(
        "preprocess + binning.expand_pairs of the whole scene, recording autograd "
        "(tools/profile_raster_torch.py's F2 row), per step"))

    # 4. bytes per step, from the recorded tensors
    ar = [c for c in tile_traffic.calls if c["kind"] == "all_reduce"]
    if len(ar) != 1 or ar[0]["group"] != "world":
        raise AssertionError(f"the (data, tile) step's collectives: {tile_traffic.calls}")
    grad_buffer = ar[0]["bytes"]
    per_slot = slot_bytes(gauss_traffic.calls)
    comm = {}
    for d in MODEL_D:
        buckets = bucket_hist(tiles, gids, gx, gy, n, d)
        cap = gauss_shard.send_capacity(cfg, n // d, d)
        comm[str(d)] = dict(
            grad_all_reduce_buffer=grad_buffer, grad_all_reduce_ring=ring(grad_buffer, d),
            halo=halo_bytes(args.width, d),
            exchange=exchange_bytes(d, cap, buckets, per_slot),
            jax_count=dict(
                grad_all_reduce=2 * n * JAX_PARAM_FLOATS_SHARDED * 4,
                halo=2 * HALO * args.width * 3 * 4,
                pair_exchange=tiles.shape[0] * JAX_PAIR_BYTES / d * (d - 1) / d))
    out["traffic"] = dict(tile_step=tile_traffic.calls, gauss_step=gauss_traffic.calls,
                          bytes_per_slot=per_slot)
    out["bytes_per_step"] = dict(
        per_d=comm, factors=FACTORS,
        note=("per card and step; the design's exchange is what training sends "
              "(gauss_shard.send_capacity: 4x headroom over the shard's pair capacity "
              "spread over the D bands); live is what split sizes would send; "
              "jax_count is tools/bench_sharded.py's formula (fault B12)"))

    # 5. the model
    st = steps
    out["model"] = dict(
        links=LINKS, factors=FACTORS,
        formula=("per-card ms = replicated + (step - replicated) / D + bytes / link; "
                 "efficiency = plain / (D x per-card ms); no overlap"),
        host=model(st["plain"]["host_ms"], repl["host_ms"], st["tile"]["host_ms"],
                   st["gauss"]["host_ms"], comm),
        busy=model(st["plain"]["busy_ms"], repl["busy_ms"], st["tile"]["busy_ms"],
                   st["gauss"]["busy_ms"], comm))

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:              # afresh: never merged
        json.dump(out, fh, indent=1)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
