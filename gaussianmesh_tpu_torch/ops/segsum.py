"""Per-Gaussian gradient reduction (K3): a deterministic segmented sum.

Port of the reduction in `gaussianmesh_tpu/ops/segsum.py` (`_reduce_grouped`
and its Pallas kernel `_segtree_kernel`), the TPU's stand-in for the
reference backward's atomicAdd (backward.cu:523,545-554). The blend backward
(K2) writes one gradient row per sorted pair; this sums each Gaussian's rows
into its row of the (N + 1, 16) feature table, in a fixed order, so two runs
give the same bits.

The binning emits pairs Gaussian-major, so in emission order Gaussian g owns
the contiguous segment [seg_starts[g], seg_starts[g + 1]), and
`grouped_pos[e]` is the sorted position (the K2 row) of emission pair e. No
second sort is needed, and no segment is capped in length (the JAX package's
`_reduce_grouped` caps the extra heads it can add, `segsum.py:194-199`, and
loses gradient for long segments at high destinations).

Two implementations of that one function:

* `segment_sum_plain` — `index_add_` into float64 zeros, then f32. CPU
  tensors use it.
* `segment_sum` — the wrapper of the CUDA kernel `csrc/segment_sum.cu`.
  CUDA tensors launch it or raise. The kernel sums segments of up to
  `LONG_SEGMENT` rows with 4 lanes per Gaussian; the block that holds a
  longer one sums it with all its threads (the source's note gives the
  design).

The kernel reads `rows` only through `grouped_pos`, so the rows may be any
table: `segment_sum_rows` is the same wrapper without `segment_sum`'s rule
of one `grouped_pos` entry per row. `gather_rows` uses it: the Gaussian-table
shard (`parallel/gauss_shard.py`) gathers each emitted pair's feature row
into a send slot, and the transpose of that gather sums every Gaussian's
slot cotangents with K3 (the counterpart of the JAX package's
`gather_rows_counted`, `segsum.py:56-63`; PyTorch's own backward of
`feat[idx]` would scatter-add with atomics on CUDA).
"""

from __future__ import annotations

import torch

from gaussianmesh_tpu_torch.ops import _cuda

FEAT = 16
LONG_SEGMENT = 32   # csrc/segment_sum.cu's kLongSegment: longer, the block sums it


def segment_starts(gid_counts: torch.Tensor) -> torch.Tensor:
    """(N,) per-Gaussian pair counts -> (N + 1,) int32 segment starts (the
    exclusive cumsum, total last)."""
    out = torch.zeros(gid_counts.shape[0] + 1, dtype=torch.int32,
                      device=gid_counts.device)
    out[1:] = torch.cumsum(gid_counts, 0)
    return out


def segment_sum_plain(rows: torch.Tensor, grouped_pos: torch.Tensor,
                      seg_starts: torch.Tensor) -> torch.Tensor:
    """The plain version of K3: out[g] = sum of rows[grouped_pos[e]] over
    e in [seg_starts[g], seg_starts[g + 1]), accumulated in float64.
    -> (N + 1, FEAT) f32; the last (dummy) row is zero."""
    n = seg_starts.shape[0] - 1
    lengths = (seg_starts[1:] - seg_starts[:-1]).long()
    gid = torch.repeat_interleave(torch.arange(n, device=rows.device), lengths)
    out = torch.zeros((n + 1, rows.shape[1]), dtype=torch.float64,
                      device=rows.device)
    out.index_add_(0, gid, rows[grouped_pos.long()].double())
    return out.float()


def _check_inputs(rows, grouped_pos, seg_starts):
    if rows.dtype != torch.float32 or rows.dim() != 2 or rows.shape[1] != FEAT:
        raise ValueError(f"rows must be (M, {FEAT}) float32, got "
                         f"{tuple(rows.shape)} {rows.dtype}")
    for name, x in (("grouped_pos", grouped_pos), ("seg_starts", seg_starts)):
        if x.dtype != torch.int32 or x.dim() != 1:
            raise ValueError(f"{name} must be 1-D int32, got {x.dtype}")
        if x.device != rows.device:
            raise ValueError("segment_sum inputs lie on different devices")
    if seg_starts.shape[0] < 1:
        raise ValueError("seg_starts needs at least one entry")


def segment_sum(rows: torch.Tensor, grouped_pos: torch.Tensor,
                seg_starts: torch.Tensor) -> torch.Tensor:
    """K3: rows (M, FEAT) f32 in sorted-pair order, grouped_pos (M,) int32,
    seg_starts (N + 1,) int32 (exclusive cumsum of the per-Gaussian pair
    counts, seg_starts[N] == M) -> (N + 1, FEAT) f32.

    CPU tensors run `segment_sum_plain`; CUDA tensors launch the kernel."""
    if grouped_pos.shape[0] != rows.shape[0]:
        raise ValueError(f"grouped_pos has {grouped_pos.shape[0]} entries for "
                         f"{rows.shape[0]} rows")
    return segment_sum_rows(rows, grouped_pos, seg_starts)


def segment_sum_rows(rows: torch.Tensor, grouped_pos: torch.Tensor,
                     seg_starts: torch.Tensor) -> torch.Tensor:
    """K3 over any table of rows: out[g] = sum of rows[grouped_pos[e]] over e
    in [seg_starts[g], seg_starts[g + 1]), for rows (R, FEAT) f32,
    grouped_pos (M,) int32 with entries < R and seg_starts[N] == M.
    -> (N + 1, FEAT) f32. CPU tensors run `segment_sum_plain`; CUDA tensors
    launch the kernel (and count in `segment_sum.launches`)."""
    _check_inputs(rows, grouped_pos, seg_starts)
    if rows.device.type == "cpu":
        return segment_sum_plain(rows, grouped_pos, seg_starts)
    if rows.device.type != "cuda":
        raise ValueError(f"segment_sum runs on cpu or cuda, not {rows.device}")
    rows, grouped_pos = rows.contiguous(), grouped_pos.contiguous()
    seg_starts = seg_starts.contiguous()
    if rows.data_ptr() % 16:                    # the kernel reads float4s
        rows = rows.clone()
    n = seg_starts.shape[0] - 1
    out = torch.empty((n + 1, FEAT), dtype=torch.float32, device=rows.device)
    lib = _cuda.library("segment_sum")
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream(rows.device).cuda_stream
        err = lib.gm_segment_sum(rows.data_ptr(), grouped_pos.data_ptr(),
                                 seg_starts.data_ptr(), n, out.data_ptr(),
                                 stream)
    if err != 0:
        raise RuntimeError(f"segment_sum launch failed: cudaError {err}")
    segment_sum.launches += 1
    return out


segment_sum.launches = 0  # calls that launched the kernel since the last reset


class GatherRows(torch.autograd.Function):
    """send[s] = feat[slot_gid[s]]: the (N + 1, FEAT) feature table's rows
    gathered into S send slots (an empty slot names the zero dummy row N).
    Backward: K3 (`segment_sum_rows`) over the emission order, the pairs
    Gaussian-major with `seg_starts` from their per-Gaussian counts, and
    `grouped_pos[e]` the send slot of emission pair e, or S for a pair no
    slot took (it reads an appended zero row)."""

    @staticmethod
    def forward(ctx, feat, slot_gid, grouped_pos, seg_starts):
        ctx.save_for_backward(grouped_pos, seg_starts)
        return feat[slot_gid]

    @staticmethod
    def backward(ctx, g_send):
        grouped_pos, seg_starts = ctx.saved_tensors
        table = torch.cat([g_send, g_send.new_zeros(1, g_send.shape[1])])
        return segment_sum_rows(table, grouped_pos, seg_starts), None, None, None


def gather_rows(feat: torch.Tensor, slot_gid: torch.Tensor,
                grouped_pos: torch.Tensor, seg_starts: torch.Tensor
                ) -> torch.Tensor:
    """Differentiable `feat[slot_gid]` whose gradient is K3 (`GatherRows`):
    feat (N + 1, FEAT) f32, slot_gid (S,) int64, grouped_pos (M,) int32 with
    entries <= S, seg_starts (N + 1,) int32 -> (S, FEAT)."""
    return GatherRows.apply(feat, slot_gid, grouped_pos, seg_starts)
