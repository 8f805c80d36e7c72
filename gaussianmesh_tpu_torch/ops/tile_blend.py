"""Per-tile alpha blending — the rasterizer hot loop, forward and backward.

Port of `gaussianmesh_tpu/ops/tile_blend.py`. Per pixel, over its tile's
depth-sorted pairs, front to back (the reference's renderCUDA,
forward.cu:261-374):

    skip the pair if power > 0 or alpha = min(0.99, op * e^power) < 1/255
    stop when T * (1 - alpha) < 1e-4 (the pair is not blended)
    color += alpha * T * rgb ;  T *= 1 - alpha
    n_contrib = 1-based rank of the last blended pair

and back to front for the gradient (backward.cu:399-557; see
`blend_backward_plain`).

Forward, two implementations of one function:

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

Backward, likewise: `blend_backward_plain` and `blend_backward`, the
wrapper of `csrc/tile_blend_bwd.cu` (K2, replaces `_make_sorted_bwd_kernel`),
which write one gradient row per sorted pair. `BlendFunction` joins K1, K2
and the per-Gaussian reduction K3 (`ops/segsum.py`) into one autograd
function of the (N + 1, FEAT) feature table; `blend` applies it.

Feature-row layout (FEAT=16): 0=x, 1=y, 2..4=conic(a,b,c), 5=opacity,
6..8=rgb, 9=real-entry flag, 10..15 padding. Gradient rows use the same
layout (9 = real flag has no gradient).
"""

from __future__ import annotations

import torch

from gaussianmesh_tpu_torch.ops import _cuda, segsum

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


def tile_order(counts: torch.Tensor) -> torch.Tensor:
    """K2's block order: tiles by descending pair count, ties in tile order
    (a stable sort) -> (num_tiles,) int32 permutation. Block b takes tile
    order[b], so the longest walks start first; the rows do not depend on
    it. (K1 gains less from it than the sort costs.)"""
    return torch.sort(counts, descending=True, stable=True).indices.to(torch.int32)


def _aligned(feat: torch.Tensor) -> torch.Tensor:
    """The kernels copy feature rows in 16-B pieces: a table whose storage
    does not start on 16 B is copied."""
    return feat if feat.data_ptr() % 16 == 0 else feat.clone()


def blend_forward(feat: torch.Tensor, sorted_gid: torch.Tensor,
                  starts: torch.Tensor, counts: torch.Tensor, grid_x: int,
                  width: int, height: int
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K1: blend every tile's pairs [starts[t], starts[t] + counts[t]) of
    `sorted_gid` (indices into the (N+1, FEAT) `feat` table).
    -> color (3, H, W), final_t (H, W), n_contrib (H, W) int32.

    CPU tensors run `blend_forward_plain`; CUDA tensors launch the kernel,
    which records no autograd graph: differentiate through `blend`."""
    _check_inputs(feat, sorted_gid, starts, counts, grid_x, width, height)
    if feat.device.type == "cpu":
        return blend_forward_plain(feat, sorted_gid, starts, counts, grid_x,
                                   width, height)
    if feat.device.type != "cuda":
        raise ValueError(f"blend_forward runs on cpu or cuda, not {feat.device}")
    if feat.requires_grad and torch.is_grad_enabled():
        raise ValueError("blend_forward's kernel is not differentiable by "
                         "autograd: call `blend` (BlendFunction) for gradients")
    feat, sorted_gid = _aligned(feat.contiguous()), sorted_gid.contiguous()
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


def _tile_blocks(img: torch.Tensor, grid_x: int) -> torch.Tensor:
    """(C, H, W) -> (num_tiles, C, PIX) row-major tile blocks, zero outside
    the image — the inverse of `_assemble`."""
    c, height, width = img.shape
    gy = -(-height // TILE)
    pad = img.new_zeros(c, gy * TILE, grid_x * TILE)
    pad[:, :height, :width] = img
    blocks = pad.reshape(c, gy, TILE, grid_x, TILE).permute(1, 3, 0, 2, 4)
    return blocks.reshape(gy * grid_x, c, PIX)


def blend_backward_plain(feat, sorted_gid, starts, counts, final_t, n_contrib,
                         g_color, g_final_t) -> torch.Tensor:
    """The plain version of K2 on K2's inputs -> rows (M, FEAT).

    An explicit reverse walk over the K axis of the dense per-tile lists,
    in the kernel's operation order, vectorized over tiles and pixels; no
    autograd graph, so it fits a 1080p step. Each pixel starts from its
    final T and its last blended pair (`n_contrib`) and recovers the
    transmittance in front of each blended pair as T / (1 - alpha). Per
    blended pair and pixel:

        dL/dw     = rgb . g_color
        dL/dalpha = dL/dw * T - q / (1 - alpha), q = the sum of dL/dw * w
                    over the later blended pairs + g_final_t * final_t
        dL/dpower = dL/dalpha * alpha, d opacity = dL/dalpha * e^power,
                    both 0 where the 0.99 cap is active
        d(x, y, conic) = dL/dpower * d power / d(x, y, conic)
        d rgb     = w * g_color

    summed over the tile's 256 pixels. Rows of pairs no pixel blends,
    and of pairs `max_per_tile` dropped, are zero."""
    height, width = final_t.shape
    grid_x = -(-width // TILE)
    with torch.no_grad():
        lists = tile_id_lists(sorted_gid, starts, counts, feat.shape[0] - 1)
        num_tiles, k = lists.shape
        px, py = _pixel_coords(torch.arange(num_tiles, device=feat.device), grid_x)
        last = _tile_blocks(n_contrib[None], grid_x)[:, 0]       # 0 outside
        gc = _tile_blocks(g_color, grid_x)                       # (T, 3, PIX)
        gr, gg, gb = gc[:, 0], gc[:, 1], gc[:, 2]
        inside = (px < width) & (py < height)
        T = torch.where(inside, _tile_blocks(final_t[None], grid_x)[:, 0], 1.0)
        q = _tile_blocks(g_final_t[None], grid_x)[:, 0] * T
        out = feat.new_zeros(num_tiles, k, 9)
        for j in range(k - 1, -1, -1):
            f = feat[lists[:, j]]                                # (T, FEAT)
            x, y, ca, cb, cc, op, r, g, b = (f[:, i, None] for i in range(9))
            dx = x - px
            dy = y - py
            qa = (ca * dx) * dx
            qc = (cc * dy) * dy
            qb = (cb * dx) * dy
            power = -0.5 * (qa + qc) - qb
            e = torch.exp(power)
            raw = op * e
            alpha = torch.clamp(raw, max=ALPHA_MAX)
            blended = (j < last) & (power <= 0.0) & (alpha >= ALPHA_MIN)
            om = 1.0 - alpha
            T = torch.where(blended, T / om, T)
            w = alpha * T
            dldw = (r * gr + g * gg) + b * gb
            dalpha = dldw * T - q / om
            q = torch.where(blended, q + dldw * w, q)
            live = blended & (raw <= ALPHA_MAX)
            dpower = dalpha * alpha
            cols = [dpower * -(ca * dx + cb * dy),
                    dpower * -(cc * dy + cb * dx),
                    dpower * (-0.5 * (dx * dx)),
                    dpower * -(dx * dy),
                    dpower * (-0.5 * (dy * dy)),
                    dalpha * e]
            cols = [torch.where(live, c, 0.0) for c in cols]
            cols += [torch.where(blended, w * gch, 0.0) for gch in (gr, gg, gb)]
            out[:, j] = torch.stack(cols, dim=-1).sum(dim=1)
        rows = feat.new_zeros(sorted_gid.shape[0], FEAT)
        rank = torch.arange(k, device=feat.device)
        kept = rank[None, :] < counts.long()[:, None]
        src = starts[:-1].long()[:, None] + rank[None, :]
        rows[src[kept], :9] = out[kept]
    return rows


def _check_bwd_inputs(feat, sorted_gid, starts, counts, final_t, n_contrib,
                      g_color, g_final_t):
    height, width = final_t.shape
    _check_inputs(feat, sorted_gid, starts, counts, -(-width // TILE), width,
                  height)
    for name, x, shape, dtype in (
            ("n_contrib", n_contrib, (height, width), torch.int32),
            ("g_color", g_color, (3, height, width), torch.float32),
            ("g_final_t", g_final_t, (height, width), torch.float32),
            ("final_t", final_t, (height, width), torch.float32)):
        if tuple(x.shape) != shape or x.dtype != dtype:
            raise ValueError(f"{name} must be {shape} {dtype}, got "
                             f"{tuple(x.shape)} {x.dtype}")
        if x.device != feat.device:
            raise ValueError("blend_backward inputs lie on different devices")


def blend_backward(feat: torch.Tensor, sorted_gid: torch.Tensor,
                   starts: torch.Tensor, counts: torch.Tensor,
                   final_t: torch.Tensor, n_contrib: torch.Tensor,
                   g_color: torch.Tensor, g_final_t: torch.Tensor
                   ) -> torch.Tensor:
    """K2: one gradient row per sorted pair -> rows (M, FEAT) f32, from K1's
    inputs, its outputs final_t and n_contrib (H, W), and the cotangents
    g_color (3, H, W) and g_final_t (H, W).

    CPU tensors run `blend_backward_plain`; CUDA tensors launch the kernel."""
    _check_bwd_inputs(feat, sorted_gid, starts, counts, final_t, n_contrib,
                      g_color, g_final_t)
    if feat.device.type == "cpu":
        return blend_backward_plain(feat, sorted_gid, starts, counts, final_t,
                                    n_contrib, g_color, g_final_t)
    if feat.device.type != "cuda":
        raise ValueError(f"blend_backward runs on cpu or cuda, not {feat.device}")
    height, width = final_t.shape
    args = [x.contiguous() for x in (feat, sorted_gid, starts, final_t,
                                     n_contrib, g_color, g_final_t)]
    args[0] = _aligned(args[0])
    rows = torch.empty((sorted_gid.shape[0], FEAT), dtype=torch.float32,
                       device=feat.device)
    lib = _cuda.library("tile_blend_bwd")
    with torch.cuda.device(feat.device):
        order = tile_order(counts.contiguous())
        stream = torch.cuda.current_stream(feat.device).cuda_stream
        err = lib.gm_tile_blend_bwd(*(x.data_ptr() for x in args),
                                    order.data_ptr(), counts.shape[0],
                                    -(-width // TILE), width, height,
                                    rows.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"tile_blend_bwd launch failed: cudaError {err}")
    blend_backward.launches += 1
    return rows


blend_backward.launches = 0  # kernel launches since the last reset


class BlendFunction(torch.autograd.Function):
    """The blend as one autograd function of the (N + 1, FEAT) feature
    table: forward K1 (`blend_forward`), backward K2 (`blend_backward`)
    then K3 (`segsum.segment_sum` over `grouped_pos` and the exclusive
    cumsum of the per-Gaussian pair counts). Outputs color (3, H, W),
    final_t (H, W) and n_contrib (H, W) int32 (not differentiable)."""

    @staticmethod
    def forward(ctx, feat, sorted_gid, starts, counts, grouped_pos, seg_starts,
                grid_x, width, height):
        color, final_t, n_contrib = blend_forward(
            feat, sorted_gid, starts, counts, grid_x, width, height)
        ctx.save_for_backward(feat, sorted_gid, starts, counts, grouped_pos,
                              seg_starts, final_t, n_contrib)
        ctx.mark_non_differentiable(n_contrib)
        return color, final_t, n_contrib

    @staticmethod
    def backward(ctx, g_color, g_final_t, _g_n_contrib):
        (feat, sorted_gid, starts, counts, grouped_pos, seg_starts, final_t,
         n_contrib) = ctx.saved_tensors
        rows = blend_backward(feat, sorted_gid, starts, counts, final_t,
                              n_contrib, g_color.contiguous(),
                              g_final_t.contiguous())
        d_feat = segsum.segment_sum(rows, grouped_pos, seg_starts)
        return d_feat, None, None, None, None, None, None, None, None


def blend(feat: torch.Tensor, tiles, grid_x: int, width: int, height: int
          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Differentiable blend of the binned pair domain `tiles`
    (`binning.TileLists`) -> color (3, H, W), final_t (H, W), n_contrib
    (H, W) int32, through `BlendFunction`."""
    return BlendFunction.apply(
        feat, tiles.sorted_gid, tiles.starts, tiles.counts, tiles.grouped_pos,
        segsum.segment_starts(tiles.gid_counts), grid_x, width, height)
