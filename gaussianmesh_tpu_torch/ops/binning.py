"""Tile binning: exact gated-ellipse pair expansion + one (tile, depth) sort.

Port of `gaussianmesh_tpu/ops/binning.py` (the reference's duplicateWithKeys +
radix sort + identifyTileRanges, rasterizer_impl.cu:70-138,277-308) with the
same semantics and without the TPU layout:

1. Gaussians expand to the tile ROWS of their rect, in Gaussian order.
2. Each row keeps only the tiles that its band of the gated ellipse
   {alpha >= 1/255} reaches (`_row_x_extent`, exact per row).
3. Pairs are emitted Gaussian-major, then row, then tile. That emission
   order decides which pairs the `row_capacity` / `expand_capacity`
   clipping drops, and breaks (tile, depth) ties in the stable sort.
4. One stable sort of the int64 key `tile << 32 | float_bits(depth)`
   (depth > 0.2 after the near cull, so its bits order like the float)
   groups the pairs by tile, depth-ordered within each tile.
5. Per-tile `starts` / `counts` (clamped to `max_per_tile`) and the
   overflow counters.
6. `grouped_pos`, the inverse of the sort's permutation: the sorted
   position of each emission-order pair. Emission is Gaussian-major, so
   Gaussian g's pairs are the run [seg_starts[g], seg_starts[g + 1]) of it
   (seg_starts the exclusive cumsum of `gid_counts`): the per-Gaussian
   gradient reduction (`ops/segsum.py`) needs no second sort. Only a
   backward needs it, so a render without gradients skips it.

The capacity accounting replicates the JAX package's slot model exactly,
so `rect_overflow` is equal between the two: in the JAX expansion every
Gaussian with no rows (culled) still takes one row slot, every unused row
slot up to the row capacity and every row with no live tile take one pair
slot each. The aligned layout (64-lane granules, `aligned_starts`,
`block_tile`, `sorted_shift`) is not ported: the CUDA blend kernel reads
the ragged per-tile ranges directly.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gaussianmesh_tpu_torch.ops.preprocess import TILE, Preprocessed

ALPHA_MIN = 1.0 / 255.0
# slack on the cull threshold so rounding differences between the
# closed-form extent and the blend's own alpha never cull a pair the
# blend would keep (alpha ratio e^{5e-5} of headroom)
_CULL_SLACK = 1e-4


class PairExpansion(NamedTuple):
    """The unsorted (tile, Gaussian) pair domain, live pairs only, in
    emission order."""
    pair_tile: torch.Tensor      # (M,) int64
    pair_gid: torch.Tensor       # (M,) int64
    pair_depth: torch.Tensor     # (M,) f32 view depth of the parent
    rect_overflow: torch.Tensor  # () int64 — slots lost to row_capacity +
                                 # expand_capacity
    gid_counts: torch.Tensor     # (N,) int32 — pairs emitted per Gaussian


class TileLists(NamedTuple):
    counts: torch.Tensor         # (T,) int32 — clamped to max_per_tile
    starts: torch.Tensor         # (T + 1,) int32 — per-tile ranges in the
                                 # sorted pair domain
    sorted_gid: torch.Tensor     # (M,) int32 — tile-grouped, depth-ordered
    num_rendered: torch.Tensor   # () int32 — live pairs after the ellipse cull
    tile_overflow: torch.Tensor  # () int32 — pairs dropped by max_per_tile
    rect_overflow: torch.Tensor  # () int32 — slots dropped by the row and
                                 # pair capacities
    pair_overflow: torch.Tensor  # () int32 — always 0: it counts overflow of
                                 # the JAX package's aligned pair domain,
                                 # which this port does not build
    gid_counts: torch.Tensor     # (N,) int32 exact pairs per Gaussian
    grouped_pos: torch.Tensor | None  # (M,) int32 — sorted position of
                                 # each emission-order (Gaussian-major)
                                 # pair; None unless asked for


def _row_x_extent(my, ca, cb, cc, qcut, ty):
    """Exact x-extent of the gated ellipse {q <= qcut} within one tile row
    (pixel band dy in [ty*16 - my, ty*16 - my + 15]), relative to the mean.
    At fixed dy, dx_max(dy) = (-cb dy + sqrt(ca qcut - det dy^2)) / ca is
    concave with maximizer dy* = -cb sqrt(qcut / (det cc)), so the band max
    is at clip(dy*); dx_min mirrors it. Empty rows come back with
    dx_min > dx_max."""
    ly = ty * TILE - my
    hy = ly + (TILE - 1)
    det = torch.clamp(ca * cc - cb * cb, min=1e-12)
    dy_star = -cb * torch.sqrt(qcut / (det * cc))

    def bound(dy, sign):
        s = torch.sqrt(torch.clamp(ca * qcut - det * dy * dy, min=0.0))
        return (-cb * dy + sign * s) / ca

    dx_max = bound(torch.minimum(torch.maximum(dy_star, ly), hy), 1.0)
    dx_min = bound(torch.minimum(torch.maximum(-dy_star, ly), hy), -1.0)
    ey = torch.sqrt(qcut * ca / det)
    empty = (ly > ey) | (hy < -ey)
    return (torch.where(empty, 1.0, dx_min - 0.5),
            torch.where(empty, 0.0, dx_max + 0.5))


def _exclusive_cumsum(x: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(x, 0) - x


def expand_pairs(prep: Preprocessed, grid_x: int, grid_y: int,
                 expand_capacity: int, opacity: torch.Tensor | None = None,
                 row_capacity: int | None = None) -> PairExpansion:
    n = prep.depth.shape[0]
    dev = prep.depth.device
    m = expand_capacity
    m1 = row_capacity if row_capacity is not None else max(m // 2, 1)

    op = (opacity.detach().reshape(-1) if opacity is not None
          else torch.ones(n, dtype=torch.float32, device=dev))
    # alpha = op*exp(-q/2) >= 1/255  <=>  q <= 2 ln(255 op); slack as above
    qcut_all = 2.0 * torch.log(torch.clamp(op, min=1e-12) / ALPHA_MIN) + _CULL_SLACK
    qcut_all = torch.clamp(qcut_all, min=0.0)

    # stage 1: Gaussians -> tile rows (culled Gaussians take one slot)
    rect_min = prep.rect_min.long()
    rect_max = prep.rect_max.long()
    heights_raw = torch.where(prep.valid, rect_max[:, 1] - rect_min[:, 1], 0)
    heights = torch.clamp(heights_raw, min=1)
    row_end = torch.cumsum(heights, 0)
    total_rows = int(row_end[-1]) if n else 0
    n_rows = min(total_rows, m1)
    row_overflow = max(total_rows - m1, 0)
    j1 = torch.arange(n_rows, device=dev)
    parent = torch.searchsorted(row_end, j1, right=True)
    rr = j1 - (row_end - heights)[parent]
    ty = rect_min[parent, 1] + rr
    real_row = rr < heights_raw[parent]

    # per-row exact x-extent of the gated ellipse
    ca, cb, cc = prep.conic[parent].unbind(-1)
    mx, my = prep.mean2d[parent].unbind(-1)
    pd = (ca > 0) & (cc > 0) & (ca * cc > cb * cb)
    dx_min, dx_max = _row_x_extent(my, ca, cb, cc, qcut_all[parent],
                                   ty.to(torch.float32))
    x_lo = rect_min[parent, 0].to(torch.float32)
    x_hi = rect_max[parent, 0].to(torch.float32)
    # non-PD conics (preprocess already culled det == 0) keep the rect width
    lo = torch.where(pd, torch.floor((mx + dx_min) / TILE), x_lo)
    hi = torch.where(pd, torch.floor((mx + dx_max) / TILE) + 1.0, x_hi)
    tx0 = torch.minimum(torch.maximum(lo, x_lo), x_hi).long()
    tx1 = torch.minimum(torch.maximum(hi, x_lo), x_hi).long()
    row_live = torch.where(pd, dx_min <= dx_max, True)
    width_real = torch.where(real_row & row_live,
                             torch.clamp(tx1 - tx0, min=0), 0)

    # stage 2: rows -> pairs. A row with no live tile, and each unused row
    # slot up to m1, take one pair slot, as in the JAX expansion.
    slot_w = torch.clamp(width_real, min=1)
    toff = _exclusive_cumsum(slot_w)
    total_slots = (int(toff[-1] + slot_w[-1]) if n_rows else 0) + (m1 - n_rows)
    pair_lost = max(total_slots - m, 0)
    kept = torch.minimum(torch.clamp(m - toff, min=0), width_real)
    n_pairs = int(kept.sum())

    pair_row = torch.repeat_interleave(kept, output_size=n_pairs)
    j_in_row = (torch.arange(n_pairs, device=dev)
                - _exclusive_cumsum(kept)[pair_row])
    pair_tile = ty[pair_row] * grid_x + tx0[pair_row] + j_in_row
    pair_gid = parent[pair_row]
    return PairExpansion(
        pair_tile=pair_tile,
        pair_gid=pair_gid,
        pair_depth=prep.depth[pair_gid],
        rect_overflow=torch.tensor(row_overflow + pair_lost, device=dev),
        gid_counts=torch.bincount(pair_gid, minlength=n).to(torch.int32),
    )


def concat_expansions(first: PairExpansion, second: PairExpansion,
                      n_first: int) -> PairExpansion:
    """The pair domain of the Gaussians [first's n_first | second's], in
    emission order: `second`'s ids shift by n_first, overflow adds up."""
    return PairExpansion(
        pair_tile=torch.cat([first.pair_tile, second.pair_tile]),
        pair_gid=torch.cat([first.pair_gid, second.pair_gid + n_first]),
        pair_depth=torch.cat([first.pair_depth, second.pair_depth]),
        rect_overflow=first.rect_overflow + second.rect_overflow,
        gid_counts=torch.cat([first.gid_counts, second.gid_counts]),
    )


def sort_pairs(pair_tile: torch.Tensor, pair_depth: torch.Tensor,
               pair_gid: torch.Tensor, with_grouped_pos: bool = True
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor | None]:
    """One stable sort by (tile, depth), ties in emission order. Depths are
    positive f32 (near cull at 0.2), so their int bits order like the
    floats. -> (sorted_tile int64, sorted_gid int32, grouped_pos int32: the
    sorted position of each emission-order pair, or None when not asked
    for)."""
    depth_bits = pair_depth.contiguous().view(torch.int32).long()
    key = (pair_tile << 32) | depth_bits
    _, order = torch.sort(key, stable=True)
    grouped_pos = None
    if with_grouped_pos:
        grouped_pos = torch.empty_like(order, dtype=torch.int32)
        grouped_pos[order] = torch.arange(order.shape[0], dtype=torch.int32,
                                          device=order.device)
    return pair_tile[order], pair_gid[order].to(torch.int32), grouped_pos


def finish_tile_lists(sorted_tile: torch.Tensor, sorted_gid: torch.Tensor,
                      rect_overflow: torch.Tensor, num_tiles: int,
                      max_per_tile: int, gid_counts: torch.Tensor,
                      grouped_pos: torch.Tensor | None = None) -> TileLists:
    raw_counts = torch.bincount(sorted_tile, minlength=num_tiles)
    starts = torch.zeros(num_tiles + 1, dtype=torch.int64,
                         device=sorted_tile.device)
    starts[1:] = torch.cumsum(raw_counts, 0)
    counts = torch.clamp(raw_counts, max=max_per_tile)
    i32 = torch.int32
    return TileLists(
        counts=counts.to(i32),
        starts=starts.to(i32),
        sorted_gid=sorted_gid,
        num_rendered=torch.tensor(sorted_gid.shape[0], dtype=i32,
                                  device=sorted_gid.device),
        tile_overflow=(raw_counts - counts).sum().to(i32),
        rect_overflow=rect_overflow.to(i32),
        pair_overflow=torch.zeros((), dtype=i32, device=sorted_gid.device),
        gid_counts=gid_counts,
        grouped_pos=grouped_pos,
    )


def build_tile_lists(prep: Preprocessed, grid_x: int, grid_y: int,
                     max_per_tile: int, expand_capacity: int,
                     opacity: torch.Tensor | None = None,
                     row_capacity: int | None = None,
                     with_grouped_pos: bool = True,
                     extra: PairExpansion | None = None) -> TileLists:
    """`with_grouped_pos=False` leaves `grouped_pos` None: a render that
    will not be differentiated needs no reduction map. `extra`, a pair
    domain expanded earlier (composite playback's static set), joins after
    this set's pairs (`concat_expansions`) before the sort."""
    exp = expand_pairs(prep, grid_x, grid_y, expand_capacity,
                       opacity=opacity, row_capacity=row_capacity)
    if extra is not None:
        exp = concat_expansions(exp, extra, prep.depth.shape[0])
    sorted_tile, sorted_gid, grouped_pos = sort_pairs(
        exp.pair_tile, exp.pair_depth, exp.pair_gid, with_grouped_pos)
    return finish_tile_lists(sorted_tile, sorted_gid, exp.rect_overflow,
                             grid_x * grid_y, max_per_tile, exp.gid_counts,
                             grouped_pos)

