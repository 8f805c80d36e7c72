"""Per-vertex deformation gradients: the reference's missing `pyACAP.GetRS`.

Port of `gaussianmesh_tpu/edit/deform.py`. For each vertex i, with its
one-ring edges e_j = v_j - v_i (reference) and e'_j (deformed),

    T_i = argmin_T sum_j || e'_j - T e_j ||^2 = A_i B_i^-1,
    A_i = sum_j e'_j e_j^T,   B_i = sum_j e_j e_j^T + eps I,

then the polar decomposition T = R S (`utils.maths.polar_decompose_rs`).
Vertices without a ring get R = S = I.

**Ring normalisation (a fault of the JAX package that this port repairs).**
The JAX package forms A and B from the raw edges and guards two
determinants absolutely: |det B| > 1e-12 in the inverse
(`gaussianmesh_tpu/utils/maths.py:300`) and |det T| > 1e-9 in the polar
decomposition (`maths.py:314`). On a fine mesh the one-ring is nearly flat,
B's normal eigenvalue scales like edge^4, det B falls under 1e-12, the
"inverse" becomes the adjugate, T shrinks by det B, det T underflows the
second guard and every vertex silently gets R = I and S = I. Measured on
the JAX package (unit icospheres, a rigid rotation Q by 0.7 rad):

    level  vertices  max |R - Q|  share of vertices with R == I
    1..5   42..10,242  <= 1.1e-4   0
    6      40,962      0.62        1.000
    7      163,842     0.62        1.000

and a uniform x1.7 scale gives S = I at levels 6 and 7. `native/acap.cpp`
has the same guards. Here each vertex's reference and deformed ring edges
are divided by the same factor, the RMS length of its reference ring
edges: T = A B^-1 is unchanged in exact arithmetic, B becomes O(1), and the
guards (kept, with RING_EPS = 1e-8) no longer trip. What remains at levels 6
and 7 (max |R - Q| ~4e-4 / ~2e-3) is the float32 rounding of the input
vertices.

The reference ring (its normalised edges, scale and B^-1) depends only on
the reference mesh, so `MeshDeformer` computes it once; a frame gathers the
deformed ring, forms A and runs the polar decomposition.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from gaussianmesh_tpu_torch import resolve_device
from gaussianmesh_tpu_torch.utils import maths

RING_EPS = 1e-8      # B + RING_EPS I, on the normalised ring (O(1) entries)
MAX_DEGREE = 16      # one-ring lists are cut to this many neighbours


def build_one_ring(triangles: np.ndarray, n_vertices: int,
                   max_degree: int = MAX_DEGREE) -> tuple[np.ndarray, np.ndarray]:
    """Adjacency (V, D) int32 neighbour indices and (V, D) bool mask (host).

    The same arrays as the JAX package's loop: per face (a, b, c) and edge
    (a, b), (b, c), (c, a), v joins u's list and then u joins v's, each only
    the first time; every list keeps that order (it fixes the order of the
    ring sums) and is cut to D = min(max(largest degree, 3), max_degree)."""
    tri = np.asarray(triangles, np.int64).reshape(-1, 3)
    a, b, c = tri.T
    # the loop's insertion events, in its order: (src gains dst)
    src = np.stack([a, b, b, c, c, a], axis=1).reshape(-1)
    dst = np.stack([b, a, c, b, a, c], axis=1).reshape(-1)
    _, first = np.unique(src * n_vertices + dst, return_index=True)
    first = np.sort(first)                             # kept events, in order
    first = first[np.argsort(src[first], kind="stable")]
    s, d = src[first], dst[first]
    counts = np.bincount(s, minlength=n_vertices)
    deg = int(counts.max()) if counts.size else 0
    width = min(max(deg, 3), max_degree)
    rank = np.arange(s.size) - (np.cumsum(counts) - counts)[s]
    keep = rank < width
    out = np.zeros((n_vertices, width), np.int32)
    mask = np.zeros((n_vertices, width), bool)
    out[s[keep], rank[keep]] = d[keep]
    mask[s[keep], rank[keep]] = True
    return out, mask


class ReferenceRing(NamedTuple):
    """What the deformation gradients need of the reference mesh."""
    edges: torch.Tensor      # (V, D, 3) ring edges over the RMS edge length,
                             # 0 on masked slots
    inv_scale: torch.Tensor  # (V,) 1 / RMS ring edge length, 0 without a ring
    b_inv: torch.Tensor      # (V, 3, 3) (B + RING_EPS I)^-1 of the normalised ring
    has_ring: torch.Tensor   # (V,) bool: tr B > 1e-12 (else R = S = I)


def reference_ring(v_ref: torch.Tensor, neighbors: torch.Tensor,
                   mask: torch.Tensor) -> ReferenceRing:
    e = torch.where(mask[..., None], v_ref[neighbors] - v_ref[:, None, :], 0.0)
    count = mask.sum(1).clamp(min=1).to(v_ref.dtype)
    rms = torch.sqrt((e * e).sum((1, 2)) / count)
    inv_scale = torch.where(rms > 0, 1.0 / torch.where(rms > 0, rms, 1.0), 0.0)
    e = e * inv_scale[:, None, None]
    b = (e[..., :, None] * e[..., None, :]).sum(1)
    trace = b.diagonal(dim1=-2, dim2=-1).sum(-1)      # tr B before RING_EPS
    eye = torch.eye(3, dtype=v_ref.dtype, device=v_ref.device)
    b_inv, _ = maths.inv3x3(b + RING_EPS * eye)
    return ReferenceRing(e, inv_scale, b_inv, trace > 1e-12)


def gradients_from_ring(ring: ReferenceRing, v_def: torch.Tensor,
                        neighbors: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """(R, S), each (V, 3, 3), of the deformed vertices against `ring`."""
    e_def = (v_def[neighbors] - v_def[:, None, :]) * ring.inv_scale[:, None, None]
    # masked slots: the reference edge is 0, so they add nothing to A
    a = (e_def[..., :, None] * ring.edges[..., None, :]).sum(1)
    t = maths.mat_mul(a, ring.b_inv)
    eye = torch.eye(3, dtype=t.dtype, device=t.device)
    t = torch.where(ring.has_ring[:, None, None], t, eye)
    return maths.polar_decompose_rs(t)


def deformation_gradients(v_ref: torch.Tensor, v_def: torch.Tensor,
                          neighbors: torch.Tensor, mask: torch.Tensor
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (R (V, 3, 3), S (V, 3, 3)) with T = R S the normalised one-ring
    deformation gradient (identity where a vertex has no ring)."""
    return gradients_from_ring(reference_ring(v_ref, neighbors, mask),
                               v_def, neighbors)


class MeshDeformer:
    """The reference mesh, its adjacency and its reference ring; maps deformed
    vertices to per-vertex (R, S): the `pyACAP` object's counterpart."""

    def __init__(self, v_ref: np.ndarray, triangles: np.ndarray,
                 device: str | torch.device | None = None):
        dev = resolve_device(device)
        t0 = time.perf_counter()
        neighbors, mask = build_one_ring(triangles, v_ref.shape[0])
        self.setup_s = time.perf_counter() - t0   # the host adjacency build
        self.v_ref = torch.tensor(np.asarray(v_ref, np.float32), device=dev)
        self.triangles = np.asarray(triangles, np.int32)
        self.neighbors = torch.tensor(neighbors, dtype=torch.int64, device=dev)
        self.mask = torch.tensor(mask, device=dev)
        self.ring = reference_ring(self.v_ref, self.neighbors, self.mask)

    @torch.no_grad()
    def get_rs(self, v_def) -> tuple[torch.Tensor, torch.Tensor]:
        v_def = torch.as_tensor(v_def, dtype=torch.float32, device=self.v_ref.device)
        return gradients_from_ring(self.ring, v_def, self.neighbors)
