"""Differentiable tile rasterizer: preprocess -> binning -> blend -> background.

Port of `gaussianmesh_tpu/ops/rasterize.py::rasterize` (the reference's
rasterizer_impl.cu:198-511). Binning is index work with no gradient; the
blend is `tile_blend.blend` (`BlendFunction`): forward K1, backward K2 then
the per-Gaussian reduction K3, as CUDA kernels for CUDA tensors and as their
plain PyTorch versions for CPU tensors — the tensors' device decides, there
is no flag. A render that will not be differentiated (no grad mode, or no
input that requires grad) runs the forward `blend_forward` alone and skips
the reduction map `grouped_pos`. Preprocess gradients (mean2d, conic, rgb -> means3d, cov6, SH)
come from autograd of `ops/preprocess.py`.

`rasterize(..., band=(y0_tiles, gy_local))` renders one horizontal band of
tile rows of the image (the tile axis of `parallel/`): the tile rects are
clipped to the band (`clip_to_band`) and the means shifted into band-local
pixel rows before the features are packed, so the blend runs on a
gx x gy_local grid; `radii` stay the full image's.

`precompute_static_pairs` and `rasterize(..., static=)` (forward only;
`rasterize_composite` under the JAX package's name) serve composite
playback: a static set's pair domain is expanded once per camera and merged
into each frame's expansion of the dynamic set before the sort.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from gaussianmesh_tpu_torch.ops import binning, preprocess as prep_mod, tile_blend
from gaussianmesh_tpu_torch.utils.graphics import CameraArrays


@dataclasses.dataclass(frozen=True)
class RasterizerConfig:
    width: int
    height: int
    max_per_tile: int = 512
    # capacity headroom over measured live counts; overflow is counted and
    # reported, never silent
    pair_capacity_per_gaussian: int = 10
    row_capacity_per_gaussian: int = 4

    @classmethod
    def from_runtime(cls, rt, width: int, height: int) -> "RasterizerConfig":
        """The capacities of a `config.RuntimeParams` at a view's size."""
        return cls(width, height, rt.max_per_tile, rt.pair_capacity_per_gaussian,
                   rt.row_capacity_per_gaussian)

    def expand_capacity(self, n: int) -> int:
        return n * self.pair_capacity_per_gaussian

    def row_capacity(self, n: int) -> int:
        return n * self.row_capacity_per_gaussian

    @property
    def grid(self) -> tuple[int, int]:
        return prep_mod.tile_grid(self.width, self.height)

    @property
    def num_tiles(self) -> int:
        gx, gy = self.grid
        return gx * gy


class RasterizeOut(NamedTuple):
    color: torch.Tensor          # (3, H, W)
    final_t: torch.Tensor        # (H, W)
    n_contrib: torch.Tensor      # (H, W) int32
    radii: torch.Tensor          # (N,) int32
    mean2d: torch.Tensor         # (N, 2)
    visibility: torch.Tensor     # (N,) bool (radii > 0)
    num_rendered: torch.Tensor   # () int32
    tile_overflow: torch.Tensor  # () int32
    rect_overflow: torch.Tensor  # () int32
    pair_overflow: torch.Tensor  # () int32, always 0 (see binning.TileLists)


def _preprocess(means3d, cov6, opacity, cam, cfg, active_mask):
    prep = prep_mod.preprocess(means3d, cov6, cam, cfg.width, cfg.height,
                               opacity=opacity)
    if active_mask is None:
        return prep
    # capacity + mask models: dead rows are culled entirely
    return prep._replace(
        valid=prep.valid & active_mask,
        radius=torch.where(active_mask, prep.radius, 0),
        tiles_touched=torch.where(active_mask, prep.tiles_touched, 0))


def clip_to_band(prep: prep_mod.Preprocessed, y0_tiles: int,
                 gy_local: int) -> prep_mod.Preprocessed:
    """Restrict tile rects to tile rows [y0, y0 + gy_local), in band-local
    rows; a Gaussian that touches none of them is culled."""
    rmin_y = torch.clamp(prep.rect_min[:, 1] - y0_tiles, 0, gy_local)
    rmax_y = torch.clamp(prep.rect_max[:, 1] - y0_tiles, 0, gy_local)
    touched = (prep.rect_max[:, 0] - prep.rect_min[:, 0]) * (rmax_y - rmin_y)
    return prep._replace(
        rect_min=torch.stack([prep.rect_min[:, 0], rmin_y], -1),
        rect_max=torch.stack([prep.rect_max[:, 0], rmax_y], -1),
        tiles_touched=touched.to(torch.int32),
        valid=prep.valid & (touched > 0))


def band_view(prep: prep_mod.Preprocessed, y0_tiles: int,
              gy_local: int) -> prep_mod.Preprocessed:
    """`prep` as the band of tile rows [y0, y0 + gy_local) bins it: the
    rects clipped (`clip_to_band`) and the means in band-local pixel rows.
    The binning's ellipse cull and the blend derive pixel positions from
    local tile ids; a constant shift leaves the mean2d gradient as it is."""
    prep = clip_to_band(prep, y0_tiles, gy_local)
    return prep._replace(mean2d=prep.mean2d - prep.mean2d.new_tensor(
        [0.0, float(y0_tiles * prep_mod.TILE)]))


class StaticPairs(NamedTuple):
    """The pair domain of a static Gaussian set seen from one camera, for
    composite playback (one object deforms in a scene of static objects
    and a background): expanded once by `precompute_static_pairs`, merged
    by `rasterize(..., static=)` into every frame's expansion of the
    deforming set, so the static part never runs preprocess or expansion
    again."""
    feat: torch.Tensor                 # (Ns + 1, FEAT) feature table, dummy last
    pairs: binning.PairExpansion       # live pairs, local ids, emission order


def rasterize(means3d: torch.Tensor, cov6: torch.Tensor, opacity: torch.Tensor,
              rgb: torch.Tensor, bg: torch.Tensor, cam: CameraArrays,
              cfg: RasterizerConfig,
              mean2d_offset: torch.Tensor | None = None,
              active_mask: torch.Tensor | None = None,
              static: StaticPairs | None = None,
              band: tuple[int, int] | None = None) -> RasterizeOut:
    """Render N Gaussians (world means, 3D covariance uppers, activated
    opacity in [0, 1], per-view RGB) over the background color `bg` (3,).

    `mean2d_offset` (N, 2), when given, is added to the projected pixel
    means: a zero input whose gradient is the screen-space positional
    gradient of the densification statistics (the reference's
    `screenspace_points`). `active_mask` (N,) culls dead capacity rows.

    `static`, when given, is a static set's cached pair domain, merged after
    this set's pairs (ids shifted by N; the feature table is [this set |
    static | dummy]) before the one stable (tile, depth) sort: composite
    playback, forward only. Expansion is Gaussian-major, so this is the
    emission order of the concatenated scene [this set | static]: without
    capacity clipping the frame equals the render of that scene bit for
    bit. `rect_overflow` then counts both expansions; `radii`, `mean2d` and
    `visibility` report this set.

    `band` = (y0_tiles, gy_local) renders tile rows [y0_tiles, y0_tiles +
    gy_local) of cfg's image alone, (3, gy_local * 16, W); rows past the
    image's tile grid (padding) render the background. `radii`, `mean2d`
    and `visibility` stay the full image's."""
    gx, gy = cfg.grid
    height = cfg.height
    full = prep = _preprocess(means3d, cov6, opacity, cam, cfg, active_mask)
    if band is not None:
        if static is not None:
            raise ValueError("rasterize: a band render takes no static pair domain")
        y0_tiles, gy = band
        height = gy * prep_mod.TILE
        prep = band_view(prep, y0_tiles, gy)

    mean2d = prep.mean2d
    if mean2d_offset is not None:
        mean2d = mean2d + mean2d_offset
    feat = tile_blend.pack_features(mean2d, prep.conic, opacity.reshape(-1),
                                    rgb, prep.valid)
    # only a render that will be differentiated pays for the reduction map
    # and the autograd function
    grad = torch.is_grad_enabled() and feat.requires_grad
    if grad and static is not None:
        raise ValueError("rasterize: a render with a static pair domain is "
                         "forward only; run it under torch.no_grad()")

    n = means3d.shape[0]
    with torch.no_grad():
        tiles = binning.build_tile_lists(
            prep, gx, gy, cfg.max_per_tile,
            expand_capacity=cfg.expand_capacity(n), opacity=opacity,
            row_capacity=cfg.row_capacity(n), with_grouped_pos=grad,
            extra=None if static is None else static.pairs)
    if static is not None:
        feat = torch.cat([feat[:n], static.feat])

    if grad:
        color, final_t, n_contrib = tile_blend.blend(feat, tiles, gx, cfg.width,
                                                     height)
    else:
        color, final_t, n_contrib = tile_blend.blend_forward(
            feat, tiles.sorted_gid, tiles.starts, tiles.counts, gx, cfg.width,
            height)
    color = color + final_t[None] * bg[:, None, None]

    return RasterizeOut(
        color=color,
        final_t=final_t,
        n_contrib=n_contrib,
        radii=full.radius,
        mean2d=full.mean2d,
        visibility=full.radius > 0,
        num_rendered=tiles.num_rendered,
        tile_overflow=tiles.tile_overflow,
        rect_overflow=tiles.rect_overflow,
        pair_overflow=tiles.pair_overflow,
    )


@torch.no_grad()
def tile_pair_counts(means3d: torch.Tensor, cov6: torch.Tensor,
                     opacity: torch.Tensor, cam: CameraArrays,
                     cfg: RasterizerConfig,
                     active_mask: torch.Tensor | None = None) -> torch.Tensor:
    """(num_tiles,) int64: the live pairs of each tile that `rasterize`
    bins for these inputs, before `cfg.max_per_tile` clamps them."""
    gx, gy = cfg.grid
    n = means3d.shape[0]
    prep = _preprocess(means3d, cov6, opacity, cam, cfg, active_mask)
    pairs = binning.expand_pairs(prep, gx, gy, cfg.expand_capacity(n),
                                 opacity=opacity, row_capacity=cfg.row_capacity(n))
    return torch.bincount(pairs.pair_tile, minlength=cfg.num_tiles)


@torch.no_grad()
def precompute_static_pairs(means3d: torch.Tensor, cov6: torch.Tensor,
                            opacity: torch.Tensor, rgb: torch.Tensor,
                            cam: CameraArrays, cfg: RasterizerConfig,
                            active_mask: torch.Tensor | None = None
                            ) -> StaticPairs:
    gx, gy = cfg.grid
    n = means3d.shape[0]
    prep = _preprocess(means3d, cov6, opacity, cam, cfg, active_mask)
    pairs = binning.expand_pairs(prep, gx, gy, cfg.expand_capacity(n),
                                 opacity=opacity, row_capacity=cfg.row_capacity(n))
    feat = tile_blend.pack_features(prep.mean2d, prep.conic, opacity.reshape(-1),
                                    rgb, prep.valid)
    return StaticPairs(feat=feat, pairs=pairs)


@torch.no_grad()
def rasterize_composite(means3d: torch.Tensor, cov6: torch.Tensor,
                        opacity: torch.Tensor, rgb: torch.Tensor,
                        bg: torch.Tensor, cam: CameraArrays,
                        cfg: RasterizerConfig, static: StaticPairs,
                        active_mask: torch.Tensor | None = None) -> RasterizeOut:
    """The JAX package's `rasterize_composite`: `rasterize` of the dynamic
    set with `static` merged in, without autograd."""
    return rasterize(means3d, cov6, opacity, rgb, bg, cam, cfg,
                     active_mask=active_mask, static=static)
