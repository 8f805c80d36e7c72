"""Process mesh, band geometry and the collectives of the (data, tile) regime
(port of `gaussianmesh_tpu/parallel/sharding.py` on `torch.distributed`).

One process per rank, ranks laid out as a (data, tile) grid: rank =
data_index * n_tile + tile_index, as the JAX package reshapes its devices.
- The data axis replicates the model; each data group takes its own camera
  per step and the parameter gradients are summed over the world.
- Within a data group, the tile axis cuts the image into contiguous
  horizontal bands of tile rows, one per rank; SSIM crosses the band
  boundaries through a 5-row halo exchange (`halo_exchange_rows`).
- Parameters and Adam state stay replicated: every rank holds the whole
  Gaussian table.

The Gaussian-table shard (`parallel/gauss_shard.py`) runs on a (1, D) mesh:
its tile group is the shard group, and `all_to_all` carries the pairs to the
band owners.

Only `all_reduce`, `all_gather` and `all_to_all_single` run, each on an
explicit process group. Every rank issues the same collectives in the same
order whatever its data. Under nccl each takes tensors on this rank's
current card only, and raises, naming itself, on any other device: no
collective moves a tensor across devices (gloo takes CPU and CUDA tensors
alike).
"""

from __future__ import annotations

import dataclasses
from datetime import timedelta

import torch
import torch.distributed as dist

from gaussianmesh_tpu_torch.parallel import multihost

DATA_AXIS = "data"
TILE_AXIS = "tile"


@dataclasses.dataclass(eq=False)
class ProcessMesh:
    """This rank's place in the (data, tile) grid and the groups it uses:
    `data_group` joins the ranks of one tile index across the data groups,
    `tile_group` the bands of one data group (tile order = rank order),
    `world_group` every rank."""
    n_data: int
    n_tile: int
    rank: int
    data_index: int
    tile_index: int
    data_group: object
    tile_group: object
    world_group: object


def make_mesh(n_data: int, n_tile: int,
              timeout: timedelta | None = None) -> ProcessMesh:
    """The (n_data, n_tile) mesh over the initialised default process group,
    whose world size must be n_data * n_tile. Every rank creates every
    group, in the same order (`dist.new_group` requires it), each with
    `timeout` (default `multihost.group_timeout()`)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs torch.distributed initialised "
                           "(parallel.multihost.initialize)")
    world = dist.get_world_size()
    if n_data * n_tile != world:
        raise ValueError(f"mesh {n_data} x {n_tile} does not match the world "
                         f"size {world}")
    timeout = timeout or multihost.group_timeout()
    rank = dist.get_rank()
    d, t = divmod(rank, n_tile)
    data_groups = [dist.new_group([i * n_tile + j for i in range(n_data)],
                                  timeout=timeout) for j in range(n_tile)]
    tile_groups = [dist.new_group([i * n_tile + j for j in range(n_tile)],
                                  timeout=timeout) for i in range(n_data)]
    world_group = dist.new_group(list(range(world)), timeout=timeout)
    return ProcessMesh(n_data, n_tile, rank, d, t, data_groups[t], tile_groups[d],
                       world_group)


def band_rows(grid_y: int, n_tile: int) -> int:
    """Tile rows per band; grid_y must divide evenly (pad H upstream)."""
    if grid_y % n_tile:
        raise ValueError(f"{grid_y} tile rows do not split into {n_tile} bands")
    return grid_y // n_tile


def padded_grid_y(height: int, n_tile: int) -> int:
    """Tile rows of `height` pixels, rounded up to a multiple of n_tile."""
    gy = -(-height // 16)
    return -(-gy // n_tile) * n_tile


def check_device(x: torch.Tensor, group, site: str) -> None:
    """Raise unless `group`'s backend takes x where it lies: under nccl, x
    must be on this rank's current card."""
    if dist.get_backend(group) != "nccl":
        return
    if x.device.type != "cuda" or x.device.index != torch.cuda.current_device():
        raise RuntimeError(
            f"sharding.{site}: nccl takes tensors on this "
            f"rank's card cuda:{torch.cuda.current_device()}, not on {x.device}")


def all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """x reduced over `group`, as a new tensor on x's device."""
    check_device(x, group, "all_reduce")
    out = x.detach().clone().contiguous()
    dist.all_reduce(out, op=op, group=group)
    return out


def all_gather(x: torch.Tensor, group) -> list[torch.Tensor]:
    """Every rank's x over `group`, in the group's rank order (a bool tensor
    travels as uint8)."""
    if x.dtype == torch.bool:
        return [o.bool() for o in all_gather(x.to(torch.uint8), group)]
    check_device(x, group, "all_gather")
    src = x.detach().contiguous()
    outs = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(outs, src, group=group)
    return outs


def _exchange(x: torch.Tensor, group) -> torch.Tensor:
    check_device(x, group, "all_to_all")
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


class _AllToAll(torch.autograd.Function):
    """Equal-split all-to-all along axis 0. Its transpose is itself: the
    backward sends each cotangent chunk back to the rank it came from."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _exchange(x, group)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.group), None


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """x (D * C, ...) cut into D equal chunks along axis 0: chunk k goes to
    the group's rank k, and the result's chunk k is what rank k sent here.
    Differentiable (`_AllToAll`); every rank of the group must call it, and
    its backward, in the same order."""
    if x.shape[0] % dist.get_world_size(group):
        raise ValueError(f"{x.shape[0]} rows do not split into "
                         f"{dist.get_world_size(group)} equal chunks")
    return _AllToAll.apply(x, group)


class _HaloExchange(torch.autograd.Function):
    """[previous band's last `halo` rows | x | next band's first `halo`
    rows] along axis -2; zeros at the image's edges. Backward: the halo
    cotangents go back to the ranks whose rows they came from."""

    @staticmethod
    def forward(ctx, x, halo, mesh):
        ctx.halo, ctx.mesh = halo, mesh
        t, n = mesh.tile_index, mesh.n_tile
        parts = all_gather(torch.cat([x[..., :halo, :], x[..., -halo:, :]], -2),
                           mesh.tile_group)
        zeros = x.new_zeros(*x.shape[:-2], halo, x.shape[-1])
        prev_tail = parts[t - 1][..., halo:, :] if t > 0 else zeros
        next_head = parts[t + 1][..., :halo, :] if t < n - 1 else zeros
        return torch.cat([prev_tail, x, next_head], -2)

    @staticmethod
    def backward(ctx, g):
        halo, mesh = ctx.halo, ctx.mesh
        t, n = mesh.tile_index, mesh.n_tile
        g = g.contiguous()
        # [cotangent of the previous band's tail | of the next band's head]
        parts = all_gather(torch.cat([g[..., :halo, :], g[..., -halo:, :]], -2),
                           mesh.tile_group)
        gx = g[..., halo:-halo, :].clone()
        if t > 0:       # my head rows are the previous band's "next head"
            gx[..., :halo, :] += parts[t - 1][..., halo:, :]
        if t < n - 1:   # my tail rows are the next band's "previous tail"
            gx[..., -halo:, :] += parts[t + 1][..., :halo, :]
        return gx, None, None


def halo_exchange_rows(x: torch.Tensor, halo: int, mesh: ProcessMesh | None
                       ) -> torch.Tensor:
    """x (..., H_local, W) with `halo` rows of the neighbouring bands (over the
    tile group) concatenated above and below along axis -2; the image's top
    and bottom bands get zeros, matching a single process's zero padding.
    Differentiable. Without a mesh, or with one band, it pads zeros."""
    if mesh is None or mesh.n_tile == 1:
        return torch.nn.functional.pad(x, (0, 0, halo, halo))
    if x.shape[-2] < halo:
        raise ValueError(f"a band of {x.shape[-2]} rows is shorter than the "
                         f"{halo}-row halo")
    return _HaloExchange.apply(x, halo, mesh)
