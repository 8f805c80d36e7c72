"""The training step over a (data, tile) process mesh (port of
`gaussianmesh_tpu/parallel/train_step.py` on `torch.distributed`).

Per step each data group takes one camera; within a data group each rank
owns a contiguous horizontal band of tile rows:

1. preprocess all Gaussians (every rank: elementwise and cheap beside the
   blend, which scales with pixels);
2. clip the tile rects to the band, shift the means into band-local pixel
   rows, bin, sort and blend the band alone: K1 forward, K2 and K3
   backward, on a gx x gy_local grid (`rasterize(..., band=)`);
3. the photometric loss of the band: L1 on its rows, SSIM with a 5-row
   halo exchange so the band edges match the single-process convolution;
4. one `all_reduce` SUM of the parameter gradients and the loss over the
   world; Adam then applies the same update on every rank.

The arithmetic is the JAX step's: the band loss normalisation, the
per-view densification statistic (the mean2d gradient summed over the
TILE group, times n_data, scaled by (W/2, H_valid/2), its norm where
visible, then summed over the DATA group; visibility counted the same
way), the world MAX of the radii and SUM of the overflow counters.

The tile grid is padded with whole tile rows so that the tile axis divides
it, and the padded rows are masked out of the loss. The projection keeps
the image's own height: the JAX trainer renders at the padded height
(`gaussianmesh_tpu/train/trainer.py:283-285`), which stretches the image
against its unpadded ground truth whenever ceil(H / 16) is not a multiple
of the tile axis.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from gaussianmesh_tpu_torch.models import render as render_mod
from gaussianmesh_tpu_torch.ops.preprocess import TILE
from gaussianmesh_tpu_torch.ops.rasterize import (  # noqa: F401 (clip_to_band:
    RasterizeOut, RasterizerConfig, clip_to_band, rasterize)  # the JAX module's name)
from gaussianmesh_tpu_torch.parallel import sharding
from gaussianmesh_tpu_torch.parallel.sharding import ProcessMesh
from gaussianmesh_tpu_torch.train import loss as loss_mod
from gaussianmesh_tpu_torch.utils.graphics import CameraArrays


def rasterize_band(arrays: render_mod.GaussianArrays, cam: CameraArrays,
                   cfg: RasterizerConfig, gy_local: int, y0_tiles: int,
                   bg: torch.Tensor,
                   mean2d_offset: torch.Tensor | None = None) -> RasterizeOut:
    """Tile rows [y0_tiles, y0_tiles + gy_local) of cfg's image:
    `rasterize(..., band=)` of the arrays (radii of the full image, which
    feed densification on every rank)."""
    return rasterize(arrays.xyz, arrays.cov6, arrays.opacity, arrays.rgb, bg, cam,
                     cfg, mean2d_offset=mean2d_offset, active_mask=arrays.active,
                     band=(y0_tiles, gy_local))


def ssim_sum_band(img: torch.Tensor, gt: torch.Tensor, mesh: ProcessMesh | None,
                  row_mask: torch.Tensor | None = None,
                  window_size: int = 11) -> torch.Tensor:
    """Sum of the SSIM map over this band, halo-exchanged so that the sums
    of all bands equal a single process's `ssim_map` total. `row_mask`
    (1, H_local, 1) drops map rows of the padded region (the inputs must
    be zero there already, as a single process's zero padding)."""
    halo = window_size // 2
    img_h = sharding.halo_exchange_rows(img, halo, mesh)
    gt_h = sharding.halo_exchange_rows(gt, halo, mesh)
    # a valid convolution along H over the halo'd band is the zero-padded
    # full image's convolution on this band's rows
    m = loss_mod.ssim_map(img_h, gt_h, window_size, pad_rows=False)[0]
    if row_mask is not None:
        m = m * row_mask
    return m.sum()


def make_sharded_train_step(mesh: ProcessMesh, adam, cfg: RasterizerConfig,
                            sh_degree: int, lambda_dssim: float,
                            mr_weight: float, width: int, height_valid: int):
    """-> step(model, cam, gt, bg) for this rank: `cam` is its data group's
    camera, `gt` that camera's (3, H_pad, W) target zero-padded to the
    padded grid (`sharding.padded_grid_y(cfg.height, n_tile)` tile rows;
    cfg is the image's own size, H_valid = cfg.height). It updates
    the model's parameters, `adam` and the densification statistics in
    place, identically on every rank, and returns the metrics (world-wide
    loss and overflow counters)."""
    n_data, n_tile = mesh.n_data, mesh.n_tile
    gy_local = sharding.band_rows(sharding.padded_grid_y(cfg.height, n_tile), n_tile)
    y0 = mesh.tile_index * gy_local
    n_pix = 3 * height_valid * width      # per camera, valid rows
    world = mesh.world_group

    def step(model, cam: CameraArrays, gt: torch.Tensor, bg: torch.Tensor
             ) -> dict[str, torch.Tensor]:
        dev = gt.device
        rows = y0 * TILE + torch.arange(gy_local * TILE, device=dev)
        row_ok = (rows < height_valid).to(torch.float32)[None, :, None]
        gt_band = gt[:, y0 * TILE:(y0 + gy_local) * TILE]
        params = model.params()
        m2d_off = torch.zeros((model.capacity, 2), device=dev, requires_grad=True)

        arrays = render_mod.mesh_model_arrays(model, cam, sh_degree)
        out = rasterize_band(arrays, cam, cfg, gy_local, y0, bg, m2d_off)
        l1_sum = torch.sum(torch.abs(out.color - gt_band) * row_ok)
        ssim_sum = ssim_sum_band(out.color * row_ok, gt_band * row_ok, mesh,
                                 row_mask=row_ok)
        mr = loss_mod.mesh_restrict_loss(model.get_scaling(), model.vertex1,
                                         model.vertex2, model.vertex3, model.alive,
                                         mr_weight)
        local = (((1.0 - lambda_dssim) * l1_sum / n_pix
                  + lambda_dssim * (1.0 / n_tile - ssim_sum / n_pix)) / n_data
                 + mr / (n_data * n_tile))
        leaves = list(params.values()) + [m2d_off]
        grads = torch.autograd.grad(local, leaves, allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g
                 for x, g in zip(leaves, grads)]

        # one SUM over the world: every parameter gradient and the loss
        flat = torch.cat([g.reshape(-1) for g in grads[:-1]]
                         + [local.detach().reshape(1)])
        flat = sharding.all_reduce(flat, world)
        summed, off = {}, 0
        for name, p in params.items():
            summed[name] = flat[off:off + p.numel()].view_as(p)
            off += p.numel()
        loss = flat[off]

        with torch.no_grad():
            # per view: the bands partition one camera's pixels
            g_off_view = sharding.all_reduce(grads[-1], mesh.tile_group) * n_data
            scale = torch.tensor([0.5 * width, 0.5 * height_valid], device=dev)
            vis_v = out.radii > 0
            norm_v = torch.where(vis_v, torch.linalg.vector_norm(g_off_view * scale,
                                                                 dim=-1), 0.0)
            stats = sharding.all_reduce(torch.stack([norm_v, vis_v.float()], -1),
                                        mesh.data_group)
            radii = sharding.all_reduce(out.radii, world, dist.ReduceOp.MAX)
            counts = sharding.all_reduce(torch.stack(
                [out.tile_overflow, out.rect_overflow + out.pair_overflow,
                 out.num_rendered]).long(), world)

        adam.update(params, summed)
        with torch.no_grad():
            st = model.state
            visible = radii > 0
            model.state = st._replace(
                grad_accum=st.grad_accum + stats[:, 0],
                denom=st.denom + stats[:, 1],
                max_radii2d=torch.where(visible, torch.maximum(
                    st.max_radii2d, radii.to(torch.float32)), st.max_radii2d))
        return {"loss": loss, "tile_overflow": counts[0],
                "rect_overflow": counts[1], "num_rendered": counts[2]}

    return step

