"""Gaussian-table sharding: a pair all_to_all to the tile-band owners (port of
`gaussianmesh_tpu/parallel/gauss_shard.py` on `torch.distributed`).

The memory-scaling regime (SURVEY §5.8): on a (1, D) `ProcessMesh` each rank
owns a shard of the Gaussian table (parameters, Adam moments, statistics) and
one horizontal band of tile rows. Per step, on every rank:

1. preprocess the local shard and expand its pairs over the whole (padded)
   tile grid: a local Gaussian may reach any band;
2. bucket the pairs by destination band with one stable sort (each bucket
   keeps emission order) into a fixed (D, send_capacity) send buffer, the
   pairs past a bucket's capacity counted in `send_overflow`, never dropped
   silently; gather each slot's feature row (`segsum.gather_rows`) and shift
   its y into the destination band's frame;
3. one `all_to_all` of integer metadata (band-local tile, depth bits) and one
   of the feature rows (`sharding.all_to_all`, differentiable);
4. the receiver keeps the live slots (a padding slot names tile `nt_local`),
   sorts them once by (tile, depth) with `binning.sort_pairs` and blends its
   band through `tile_blend.BlendFunction`, the received rows (plus a dummy
   row) as the feature table.

The JAX package sorts the received pairs on (tile, depth, global id) and so
sends the global id (packed through float32, below 2^24). Here the arrival
order already ascends by global id within every tile: a Gaussian emits at
most one pair per tile, each bucket keeps emission order (Gaussian-major),
the ranks' chunks arrive in rank order, and global id = rank * N_local +
local id. So the stable (tile, depth) sort breaks depth ties as the single
process's does, and no id travels.

Gradients: K2 writes one row per blended pair; K3 reduces them onto the
received rows (every count 1: a permutation); the all_to_all's backward
sends those cotangents back to the ranks that own the pairs; there K3 again
(`gather_rows`'s backward) sums each Gaussian's slots onto its feature row.
Every cross-band term lands on the owner, so no parameter gradient needs a
collective, and no float atomic runs.

The projection keeps the image's own height: the tile grid is padded with
whole rows so that D divides it (`sharding.padded_grid_y`), as the (data,
tile) step does. The JAX trainer renders this regime at the padded height
(`gaussianmesh_tpu/train/trainer.py:321-322`), which stretches the image
whenever ceil(H / 16) is not a multiple of D (fault B9).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gaussianmesh_tpu_torch.models import render as render_mod
from gaussianmesh_tpu_torch.ops import binning, segsum, tile_blend
from gaussianmesh_tpu_torch.ops.preprocess import TILE
from gaussianmesh_tpu_torch.ops.rasterize import RasterizerConfig, _preprocess
from gaussianmesh_tpu_torch.parallel import sharding
from gaussianmesh_tpu_torch.parallel.sharding import ProcessMesh
from gaussianmesh_tpu_torch.parallel.train_step import ssim_sum_band
from gaussianmesh_tpu_torch.train import densify as densify_mod
from gaussianmesh_tpu_torch.train import loss as loss_mod
from gaussianmesh_tpu_torch.utils.graphics import CameraArrays


class GaussShardOut(NamedTuple):
    color: torch.Tensor          # (3, H_band, W)
    final_t: torch.Tensor        # (H_band, W)
    radii: torch.Tensor          # (N_local,) int32, the local shard's
    mean2d: torch.Tensor         # (N_local, 2)
    send_overflow: torch.Tensor  # () pairs past send_capacity, not sent
    rect_overflow: torch.Tensor  # () the local expansion's
    tile_overflow: torch.Tensor  # () pairs of this band past max_per_tile
    pair_overflow: torch.Tensor  # () always 0 (binning.TileLists)
    num_rendered: torch.Tensor   # () live pairs received by this band
    sent: torch.Tensor           # () live pairs this rank sent


def send_capacity(cfg: RasterizerConfig, n_local: int, d: int) -> int:
    """Pair slots per destination band (gaussianmesh_tpu/train/trainer.py:
    323-328): the shard's pair capacity spread over the D bands, with 4x
    headroom for skew, at least 1024. The exchange and the receiver's
    buffers then scale with the shard, not with the whole table."""
    return max(-(-cfg.expand_capacity(n_local) // d) * 4, 1024)


def send_slots(dest: torch.Tensor, d: int, send_capacity: int):
    """The send layout of the emitted pairs (emission order, destination
    band `dest`): -> (slot (M,) int64, the flat (D * send_capacity) slot of
    each pair, or D * send_capacity for a pair past its bucket's capacity;
    send_overflow ()). A stable sort by destination keeps each bucket in
    emission order."""
    m = dest.shape[0]
    order = torch.sort(dest, stable=True).indices
    bucket = torch.bincount(dest, minlength=d)
    pos = torch.empty_like(order)
    pos[order] = torch.arange(m, device=dest.device)
    rank = pos - (torch.cumsum(bucket, 0) - bucket)[dest]
    slot = torch.where(rank < send_capacity, dest * send_capacity + rank,
                       d * send_capacity)
    return slot, torch.clamp(bucket - send_capacity, min=0).sum()


def rasterize_band_gauss_sharded(
        arrays: render_mod.GaussianArrays, cam: CameraArrays,
        cfg: RasterizerConfig, mesh: ProcessMesh | None, send_capacity: int,
        bg: torch.Tensor, mean2d_offset: torch.Tensor | None = None,
        emulate_d: int | None = None) -> GaussShardOut:
    """This rank's band of cfg's image (cfg the image's own size) from the
    pairs of every rank's shard; `arrays` is this rank's shard (N_local
    rows), `mesh` the (1, D) mesh (its tile group is the shard group). The
    band is tile rows [idx * gy_local, (idx + 1) * gy_local) of the grid
    padded to D bands (`sharding.padded_grid_y`). Differentiable in `arrays` and
    `mean2d_offset`; every rank must call it, and its backward, together.

    `emulate_d` (a scaling measurement, not a training path): one rank's
    work of a D-way shard in one process, without a mesh; the exchange is
    the identity, so this rank's own buckets stand in for the received ones
    (the same row count as a real average, the tiles approximated). The
    JAX package's `_emulate_idx` has nothing to choose here: it numbered the
    global ids, which the port does not send."""
    if emulate_d is not None:
        d = emulate_d

        def exchange(x):
            return x
    else:
        d = mesh.n_tile

        def exchange(x):
            return sharding.all_to_all(x, mesh.tile_group)
    gx, _ = cfg.grid
    gy_local = sharding.band_rows(sharding.padded_grid_y(cfg.height, d), d)
    nt_local = gx * gy_local
    n = arrays.xyz.shape[0]
    cap = send_capacity
    s = d * cap

    # 1. the local shard over the whole image
    prep = _preprocess(arrays.xyz, arrays.cov6, arrays.opacity, cam, cfg,
                       arrays.active)
    mean2d = prep.mean2d if mean2d_offset is None else prep.mean2d + mean2d_offset
    feat = tile_blend.pack_features(mean2d, prep.conic, arrays.opacity.reshape(-1),
                                    arrays.rgb, prep.valid)
    grad = torch.is_grad_enabled() and feat.requires_grad

    with torch.no_grad():
        exp = binning.expand_pairs(prep, gx, gy_local * d, cfg.expand_capacity(n),
                                   opacity=arrays.opacity,
                                   row_capacity=cfg.row_capacity(n))
        # 2. buckets by destination band, into the fixed send buffer; row s
        # of each scatter takes the pairs no slot holds and is cut off
        dest = exp.pair_tile // nt_local
        slot, send_overflow = send_slots(dest, d, cap)
        slot_gid = torch.full((s + 1,), n, dtype=torch.int64, device=dest.device)
        slot_gid[slot] = exp.pair_gid
        meta = torch.zeros((s + 1, 2), dtype=torch.int32, device=dest.device)
        meta[:, 0] = nt_local                              # padding: past the band
        meta[slot, 0] = (exp.pair_tile - dest * nt_local).to(torch.int32)
        meta[slot, 1] = exp.pair_depth.contiguous().view(torch.int32)
        sent = (slot < s).sum()
        # slot row k * cap + r goes to band k (a padding row is never blended)
        y0 = (torch.arange(s, device=dest.device) // cap * (gy_local * TILE)).float()

    send = segsum.gather_rows(feat, slot_gid[:s], slot.to(torch.int32),
                              segsum.segment_starts(exp.gid_counts))
    # the destination band's pixel rows: a constant shift, so the y
    # gradient passes through unchanged
    send[:, tile_blend.ROW_Y] -= y0

    # 3. the exchange: chunk k of the result is what rank k sent to this band
    meta_recv = exchange(meta[:s])
    feat_recv = exchange(send)

    # 4. the receiver: live slots in arrival order, one stable (tile, depth) sort
    with torch.no_grad():
        live = torch.nonzero(meta_recv[:, 0] < nt_local).flatten()
        sorted_tile, sorted_gid, grouped_pos = binning.sort_pairs(
            meta_recv[live, 0].long(), meta_recv[live, 1].view(torch.float32),
            live, with_grouped_pos=grad)
        counts = torch.zeros(s, dtype=torch.int32, device=live.device)
        counts[live] = 1
        tiles = binning.finish_tile_lists(sorted_tile, sorted_gid, exp.rect_overflow,
                                          nt_local, cfg.max_per_tile, counts,
                                          grouped_pos)
    table = torch.cat([feat_recv, feat_recv.new_zeros(1, tile_blend.FEAT)])
    height = gy_local * TILE
    if grad:
        color, final_t, _ = tile_blend.blend(table, tiles, gx, cfg.width, height)
    else:
        color, final_t, _ = tile_blend.blend_forward(
            table, tiles.sorted_gid, tiles.starts, tiles.counts, gx, cfg.width, height)
    color = color + final_t[None] * bg[:, None, None]
    return GaussShardOut(
        color=color, final_t=final_t, radii=prep.radius, mean2d=prep.mean2d,
        send_overflow=send_overflow, rect_overflow=tiles.rect_overflow,
        tile_overflow=tiles.tile_overflow, pair_overflow=tiles.pair_overflow,
        num_rendered=tiles.num_rendered, sent=sent)


def make_gauss_sharded_train_step(mesh: ProcessMesh, adam, cfg: RasterizerConfig,
                                  sh_degree: int, lambda_dssim: float,
                                  mr_weight: float, width: int, height_valid: int,
                                  send_capacity: int):
    """-> step(model, cam, gt, bg) for this rank of the (1, D) mesh: `model`
    is its shard, `cam` the step's one camera, `gt` that camera's (3, H_pad,
    W) target zero-padded to whole bands (cfg is the image's own size,
    H_valid = cfg.height). It updates the shard's parameters, `adam` and
    the densification statistics in place and returns the metrics.

    Each rank differentiates its own band's loss: L1 on its valid rows, SSIM
    through the halo exchange, and the mesh-restrict loss of its shard (a
    sum over Gaussians, so the shards' terms add up to the whole table's).
    The exchange's backward lands every cross-band term on the owner, so the
    shard's gradient is the whole loss's: Adam and the statistics run on the
    shard with no collective. Only the loss and the overflow counters are
    summed over the ranks, for the metrics; `overflow` is the sum of the
    four counters, the JAX step's `tile_overflow`."""
    d = mesh.n_tile
    gy_local = sharding.band_rows(sharding.padded_grid_y(cfg.height, d), d)
    y0 = mesh.tile_index * gy_local * TILE
    n_pix = 3 * height_valid * width

    def step(model, cam: CameraArrays, gt: torch.Tensor, bg: torch.Tensor
             ) -> dict[str, torch.Tensor]:
        dev = gt.device
        rows = y0 + torch.arange(gy_local * TILE, device=dev)
        row_ok = (rows < height_valid).to(torch.float32)[None, :, None]
        gt_band = gt[:, y0:y0 + gy_local * TILE]
        params = model.params()
        m2d_off = torch.zeros((model.capacity, 2), device=dev, requires_grad=True)

        arrays = render_mod.mesh_model_arrays(model, cam, sh_degree)
        out = rasterize_band_gauss_sharded(arrays, cam, cfg, mesh, send_capacity,
                                           bg, m2d_off)
        l1_sum = torch.sum(torch.abs(out.color - gt_band) * row_ok)
        ssim_sum = ssim_sum_band(out.color * row_ok, gt_band * row_ok, mesh,
                                 row_mask=row_ok)
        mr = loss_mod.mesh_restrict_loss(model.get_scaling(), model.vertex1,
                                         model.vertex2, model.vertex3, model.alive,
                                         mr_weight)
        local = ((1.0 - lambda_dssim) * l1_sum / n_pix
                 + lambda_dssim * (1.0 / d - ssim_sum / n_pix) + mr)
        leaves = list(params.values()) + [m2d_off]
        grads = torch.autograd.grad(local, leaves, allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g
                 for x, g in zip(leaves, grads)]

        with torch.no_grad():
            sums = sharding.all_reduce(torch.stack([
                local.double(), *(x.double() for x in (
                    out.tile_overflow, out.rect_overflow, out.send_overflow,
                    out.pair_overflow, out.num_rendered))]), mesh.tile_group)
        adam.update(params, dict(zip(params, grads[:-1])))
        with torch.no_grad():
            visible = out.radii > 0
            st = densify_mod.add_densification_stats(model.state, grads[-1], visible,
                                                     width, height_valid)
            model.state = st._replace(max_radii2d=torch.where(
                visible, torch.maximum(st.max_radii2d, out.radii.to(torch.float32)),
                st.max_radii2d))
        counts = sums[1:].long()
        return {"loss": sums[0].float(), "tile_overflow": counts[0],
                "rect_overflow": counts[1], "send_overflow": counts[2],
                "overflow": counts[:4].sum(), "num_rendered": counts[4]}

    return step
