"""Mean squared distance to the 3 nearest neighbors — scale seeding at init.

Port of `gaussianmesh_tpu/ops/knn.py` (the reference's simple_knn `distCUDA2`):
exact chunked pairwise distances ||a-b||^2 = |a|^2 + |b|^2 - 2 a.b (an f32
matmul; TF32 stays off) and a 4-way smallest top-k per row (self + 3).
Chunks keep one (row_chunk, N) distance block in memory at a time:
2048 x 327,680 f32 is 2.7 GB.
"""

from __future__ import annotations

import torch


def mean_sq_dist3(points: torch.Tensor, row_chunk: int = 2048) -> torch.Tensor:
    """points (N, 3) -> (N,) mean of squared distances to the 3 nearest."""
    sq = torch.sum(points * points, dim=-1)
    out = []
    for s in range(0, points.shape[0], row_chunk):
        r_pts, r_sq = points[s:s + row_chunk], sq[s:s + row_chunk]
        d2 = r_sq[:, None] + sq[None, :] - 2.0 * (r_pts @ points.T)
        # the 4 smallest include the self-distance (~0)
        d4 = torch.topk(d2, 4, dim=1, largest=False).values
        out.append((torch.sum(d4, dim=1) - d4[:, 0]) / 3.0)
    return torch.clamp(torch.cat(out), min=0.0)
