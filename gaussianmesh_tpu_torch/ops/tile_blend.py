"""Per-tile alpha blending — the rasterizer hot loop.

Port of `gaussianmesh_tpu/ops/tile_blend.py`, forward only. Per pixel, over
its tile's depth-sorted pairs, front to back (the reference's renderCUDA,
forward.cu:261-374):

    skip the pair if power > 0 or alpha = min(0.99, op * e^power) < 1/255
    stop when T * (1 - alpha) < 1e-4 (the pair is not blended)
    color += alpha * T * rgb ;  T *= 1 - alpha
    n_contrib = 1-based rank of the last blended pair

Two implementations of that one function:

* `blend_tiles` — the plain PyTorch version on dense per-tile lists
  (T, FEAT, K). It walks the K axis with the reference's sequential
  transmittance chain, vectorized over tiles and pixels. It runs on any
  device; the CPU tests hold it against the JAX package's
  `blend_tiles_jnp` and its sequential oracle.
* `blend_forward` — the wrapper of the CUDA kernel
  `csrc/tile_blend_fwd.cu` (K1), which replaces the Pallas kernel
  `_make_sorted_fwd_kernel` and reads the ragged sorted pair domain
  directly. CPU tensors go to the plain version (`blend_forward_plain`);
  CUDA tensors go to the kernel or raise.

Feature-row layout (FEAT=16): 0=x, 1=y, 2..4=conic(a,b,c), 5=opacity,
6..8=rgb, 9=real-entry flag, 10..15 padding.
"""

from __future__ import annotations

import torch

from gaussianmesh_tpu_torch.ops import _cuda

TILE = 16
PIX = TILE * TILE          # 256 pixels per tile
FEAT = 16
ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
T_EPS = 1e-4

ROW_X, ROW_Y, ROW_CA, ROW_CB, ROW_CC, ROW_OP = 0, 1, 2, 3, 4, 5
ROW_R, ROW_G, ROW_B, ROW_REAL = 6, 7, 8, 9


def pack_features(mean2d, conic, opacity, rgb, valid) -> torch.Tensor:
    """(N, ...) attributes -> (N + 1, FEAT) table; the last row is the dummy."""
    n = mean2d.shape[0]
    cols = [mean2d, conic, torch.where(valid, opacity, 0.0)[:, None], rgb,
            valid.to(mean2d.dtype)[:, None]]
    feat = torch.cat(cols + [mean2d.new_zeros(n, FEAT - 10)], dim=1)
    return torch.cat([feat, feat.new_zeros(1, FEAT)], dim=0)


def _pixel_coords(tile_ids: torch.Tensor, grid_x: int):
    """Pixel centers of the given tiles, (T, PIX) each (row-major in tile)."""
    p = torch.arange(PIX, device=tile_ids.device)
    px = (tile_ids[:, None] % grid_x) * TILE + p[None, :] % TILE
    py = (tile_ids[:, None] // grid_x) * TILE + p[None, :] // TILE
    return px.to(torch.float32), py.to(torch.float32)


def _alphas(f: torch.Tensor, px: torch.Tensor, py: torch.Tensor) -> torch.Tensor:
    """Gated alphas of one pair per tile: f (T, FEAT) -> alpha (T, PIX)."""
    dx = f[:, ROW_X, None] - px
    dy = f[:, ROW_Y, None] - py
    power = (-0.5 * (f[:, ROW_CA, None] * dx * dx + f[:, ROW_CC, None] * dy * dy)
             - f[:, ROW_CB, None] * dx * dy)
    alpha = torch.clamp(f[:, ROW_OP, None] * torch.exp(power), max=ALPHA_MAX)
    gate = (power <= 0.0) & (alpha >= ALPHA_MIN)
    return torch.where(gate, alpha, 0.0)


def blend_tiles(tile_feats: torch.Tensor, grid_x: int,
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain blend. tile_feats (T, FEAT, K), depth-ordered per tile, padded
    with zero rows -> (color (T, 3, PIX), final_t (T, PIX), n_contrib
    (T, PIX) int32)."""
    num_tiles, _, k = tile_feats.shape
    dev = tile_feats.device
    px, py = _pixel_coords(torch.arange(num_tiles, device=dev), grid_x)
    T = torch.ones_like(px)
    color = tile_feats.new_zeros(num_tiles, 3, PIX)
    last = torch.zeros(num_tiles, PIX, dtype=torch.int32, device=dev)
    done = torch.zeros(num_tiles, PIX, dtype=torch.bool, device=dev)
    for j in range(k):
        f = tile_feats[:, :, j]
        alpha = _alphas(f, px, py)
        test_t = T * (1.0 - alpha)
        fire = ~done & (alpha > 0.0)
        done = done | (fire & (test_t < T_EPS))
        emit = fire & ~done
        w = torch.where(emit, alpha * T, 0.0)
        color = color + w[:, None, :] * f[:, ROW_R:ROW_B + 1, None]
        T = torch.where(emit, test_t, T)
        real = f[:, ROW_REAL, None] > 0.0
        last = torch.where(emit & real, j + 1, last)
    return color, T, last


def _assemble(tile_img: torch.Tensor, grid_x: int, width: int,
              height: int) -> torch.Tensor:
    """(num_tiles, C, PIX) row-major tile blocks -> (C, H, W)."""
    gy = tile_img.shape[0] // grid_x
    c = tile_img.shape[1]
    img = tile_img.reshape(gy, grid_x, c, TILE, TILE).permute(2, 0, 3, 1, 4)
    return img.reshape(c, gy * TILE, grid_x * TILE)[:, :height, :width]


def tile_id_lists(sorted_gid: torch.Tensor, starts: torch.Tensor,
                  counts: torch.Tensor, n: int) -> torch.Tensor:
    """Dense (num_tiles, K) id matrix, K = the largest count, padded with
    the dummy id N — the plain blend's input layout."""
    counts = counts.long()
    k = max(int(counts.max()), 1) if counts.numel() else 1
    rank = torch.arange(k, device=counts.device)
    live = rank[None, :] < counts[:, None]
    src = starts[:-1].long()[:, None] + rank[None, :]
    lists = torch.full(live.shape, n, dtype=torch.int64, device=counts.device)
    lists[live] = sorted_gid.long()[src[live]]
    return lists


def blend_forward_plain(feat, sorted_gid, starts, counts, grid_x: int,
                        width: int, height: int):
    """The plain version of K1 on K1's inputs: gather the dense per-tile
    lists, `blend_tiles`, assemble to images."""
    lists = tile_id_lists(sorted_gid, starts, counts, feat.shape[0] - 1)
    tile_feats = feat[lists].transpose(1, 2)                 # (T, FEAT, K)
    color_t, final_t_t, ncon_t = blend_tiles(tile_feats, grid_x)
    return (_assemble(color_t, grid_x, width, height),
            _assemble(final_t_t[:, None], grid_x, width, height)[0],
            _assemble(ncon_t[:, None], grid_x, width, height)[0])


def _check_inputs(feat, sorted_gid, starts, counts, grid_x, width, height):
    num_tiles = counts.shape[0]
    gx, gy = -(-width // TILE), -(-height // TILE)
    if grid_x != gx or num_tiles != gx * gy:
        raise ValueError(f"{num_tiles} tiles / grid_x {grid_x} do not match "
                         f"a {width}x{height} image")
    if feat.dtype != torch.float32 or feat.dim() != 2 or feat.shape[1] != FEAT:
        raise ValueError(f"feat must be (N+1, {FEAT}) float32, got "
                         f"{tuple(feat.shape)} {feat.dtype}")
    for name, x, size in (("sorted_gid", sorted_gid, None),
                          ("starts", starts, num_tiles + 1),
                          ("counts", counts, num_tiles)):
        if x.dtype != torch.int32 or x.dim() != 1:
            raise ValueError(f"{name} must be 1-D int32, got {x.dtype}")
        if size is not None and x.shape[0] != size:
            raise ValueError(f"{name} has {x.shape[0]} entries, want {size}")
    for x in (sorted_gid, starts, counts):
        if x.device != feat.device:
            raise ValueError("blend_forward inputs lie on different devices")


def blend_forward(feat: torch.Tensor, sorted_gid: torch.Tensor,
                  starts: torch.Tensor, counts: torch.Tensor, grid_x: int,
                  width: int, height: int
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K1: blend every tile's pairs [starts[t], starts[t] + counts[t]) of
    `sorted_gid` (indices into the (N+1, FEAT) `feat` table).
    -> color (3, H, W), final_t (H, W), n_contrib (H, W) int32.

    CPU tensors run `blend_forward_plain`; CUDA tensors launch the kernel.
    Forward only: the backward kernel comes with the training slice."""
    _check_inputs(feat, sorted_gid, starts, counts, grid_x, width, height)
    if feat.device.type == "cpu":
        return blend_forward_plain(feat, sorted_gid, starts, counts, grid_x,
                                   width, height)
    if feat.device.type != "cuda":
        raise ValueError(f"blend_forward runs on cpu or cuda, not {feat.device}")
    if feat.requires_grad:
        raise NotImplementedError(
            "the CUDA blend is forward-only: its backward kernel (K2) comes "
            "with the training slice of the port")
    feat, sorted_gid = feat.contiguous(), sorted_gid.contiguous()
    starts, counts = starts.contiguous(), counts.contiguous()
    dev = feat.device
    color = torch.empty((3, height, width), dtype=torch.float32, device=dev)
    final_t = torch.empty((height, width), dtype=torch.float32, device=dev)
    n_contrib = torch.empty((height, width), dtype=torch.int32, device=dev)
    lib = _cuda.library("tile_blend_fwd")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.gm_tile_blend_fwd(
            feat.data_ptr(), sorted_gid.data_ptr(), starts.data_ptr(),
            counts.data_ptr(), counts.shape[0], grid_x, width, height,
            color.data_ptr(), final_t.data_ptr(), n_contrib.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"tile_blend_fwd launch failed: cudaError {err}")
    blend_forward.launches += 1
    return color, final_t, n_contrib


blend_forward.launches = 0  # kernel launches since the last reset
