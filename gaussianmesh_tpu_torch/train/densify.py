"""Densification of the mesh model as masked compaction.

Port of the mesh part of `gaussianmesh_tpu/train/densify.py` (reference
scene/mesh_based_gaussian_model.py:411-563). The model lives in
fixed-capacity tensors with an `alive` mask. `densify_and_split` picks the
highest-gradient Gaussians, midpoint-subdivides their triangles (1->4, or
1->5 keeping a parent copy), writes the children into free (dead) slots,
retires the parents, zeroes the Adam moments at the new slots and appends
three midpoint vertices per split face to the vertex pool. Quirks kept from
the reference: children inherit the parent's `r`, `fid` and normal; scale is
divided by 4 * 0.8; bc logits reset to 1/3 and distance to 0; the
densification statistics reset to zero afterwards. `split_all_for_init` is
the same pass with every Gaussian selected and 4 children (the init loop,
densify_and_split_for_init:596-647). `densify_and_split_gauss_sharded` runs
it on each shard of the Gaussian-table-sharded regime, with the vertex pool
replicated.

The background model (vanilla 3DGS, reference scene/gaussian_model.py:
373-427) densifies by `densify_and_prune_bg`: clone small high-gradient
Gaussians, split large ones into 2 resampled children, prune by opacity;
`prune_near_mesh` retires background Gaussians close to the mesh model.

Running out of room is reported (`dropped`), never silent: the trainers grow
the capacities (`round_up`, `pad0`) and retry.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from gaussianmesh_tpu_torch.models.gaussians import GaussianModel
from gaussianmesh_tpu_torch.models.mesh_gaussians import (
    MeshGaussianModel, MeshGaussianState, MeshVertices, empty_state)
from gaussianmesh_tpu_torch.parallel import sharding
from gaussianmesh_tpu_torch.utils.maths import normalize, quat_to_rotmat
from gaussianmesh_tpu_torch.utils.subdivision import CHILD_IDX_CODE, CHILD_W


def round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def pad0(x: torch.Tensor, new_cap: int) -> torch.Tensor:
    """x padded with zero (False) rows to new_cap rows."""
    n = new_cap - x.shape[0]
    if n <= 0:
        return x
    return torch.cat([x, x.new_zeros((n,) + tuple(x.shape[1:]))])


class SplitResult(NamedTuple):
    model: MeshGaussianModel      # new parameters, binding, vertex pool, state
    mu: dict[str, torch.Tensor]   # Adam first moments
    nu: dict[str, torch.Tensor]   # Adam second moments
    n_split: int                  # parents split
    dropped: int                  # selected parents with no room


def _select_parents(alive, grads_avg, threshold, n_children, max_split, vroom):
    """Up to `max_split` highest-gradient parents (ties in index order, as
    `jax.lax.top_k`) with room for their children in dead slots and for
    their 3 midpoints in the vertex pool (`vroom` free vertex slots)."""
    c = alive.shape[0]
    if max_split > c:
        raise ValueError(f"max_split {max_split} exceeds the capacity {c}")
    dev = alive.device
    scores = torch.where(alive & (grads_avg >= threshold), grads_avg,
                         float("-inf"))
    top_scores, sel_idx = torch.sort(scores, descending=True, stable=True)
    top_scores, sel_idx = top_scores[:max_split], sel_idx[:max_split]
    sel_ok = top_scores > float("-inf")

    # only slots dead now: a parent that is selected but dropped keeps its
    # row, so no parent's slot is reused in the same pass
    size = max_split * n_children
    free_idx = torch.nonzero(~alive).flatten()[:size]
    free_idx = torch.cat([free_idx, free_idx.new_full((size - free_idx.shape[0],), c)])

    # free_idx ascends, so the last child's slot decides the room
    ranks = torch.arange(max_split, device=dev)
    last_slot = free_idx[ranks * n_children + (n_children - 1)]
    vertex_ok = 3 * (ranks + 1) <= vroom
    parent_ok = sel_ok & (last_slot < c) & vertex_ok
    n_split = int(parent_ok.sum())
    return sel_idx, parent_ok, free_idx, n_split, int(sel_ok.sum()) - n_split


def densify_and_split(model: MeshGaussianModel, mu: dict, nu: dict,
                      grads_avg: torch.Tensor, threshold: float,
                      n_children: int, max_split: int) -> SplitResult:
    """Split the selected Gaussians' faces; -> a new model (the input model
    is not modified) with its moments."""
    with torch.no_grad():
        return _densify_and_split(model, mu, nu, grads_avg, threshold,
                                  n_children, max_split)


def densify_and_split_gauss_sharded(mesh, model: MeshGaussianModel, mu: dict,
                                    nu: dict, grads_avg: torch.Tensor,
                                    threshold: float, n_children: int,
                                    max_split_per_shard: int) -> SplitResult:
    """`densify_and_split` of this rank's shard in the Gaussian-table-sharded
    regime (`mesh` the (1, D) `ProcessMesh`; every rank calls it together).

    Each shard selects and compacts its own parents into its own free rows
    (at most `max_split_per_shard`, and the shard's capacity), with vertex
    room (vcap - count) // D. One all_gather of the shards' n_split gives
    each an exclusive-scan base for its new vertices, so `vertex_index`
    stays global; the vertex pool stays replicated: every rank writes all
    shards' midpoints (one all_gather) in rank order. `n_split` and
    `dropped` are the sums over the shards. A threshold test distributes
    over shards, so with no cap binding the selection is the single
    table's."""
    with torch.no_grad():
        return _densify_and_split(model, mu, nu, grads_avg, threshold, n_children,
                                  min(max_split_per_shard, model.capacity), mesh)


def _densify_and_split(model, mu, nu, grads_avg, threshold, n_children,
                       max_split, mesh=None):
    alive = model.alive
    c = alive.shape[0]
    dev = alive.device
    nch = n_children
    pool = model.mesh_v
    n_shards = 1 if mesh is None else mesh.n_tile
    sel_idx, parent_ok, free_idx, n_split, dropped = _select_parents(
        alive, grads_avg, threshold, nch, max_split,
        vroom=(pool.v.shape[0] - pool.count) // n_shards)
    base, split_by_shard = pool.count, [n_split]
    if mesh is not None:
        group = mesh.tile_group
        split_by_shard = [int(x) for x in sharding.all_gather(
            torch.tensor([n_split], device=dev), group)]
        base += 3 * sum(split_by_shard[:mesh.tile_index])
        dropped = int(sharding.all_reduce(torch.tensor(dropped, device=dev), group))

    # --- child geometry ----------------------------------------------------
    k_ids = torch.arange(max_split * nch, device=dev)
    pj = k_ids // nch                                  # parent rank
    cid = k_ids % nch                                  # child index
    parent = sel_idx[pj]
    ok = parent_ok[pj]
    dest = free_idx[ok]                                # children written
    src = parent[ok]

    pv1, pv2, pv3 = model.vertex1[src], model.vertex2[src], model.vertex3[src]
    corners = torch.stack([pv1, pv2, pv3], dim=1)      # (K, 3 corners, 3)
    w = torch.as_tensor(CHILD_W, device=dev)[cid[ok]]  # (K, 3 verts, 3 corners)
    child = torch.einsum("kvc,kcd->kvd", w, corners)   # (K, 3 verts, 3)

    # new vertices: 3 per split parent, packed after the pool's count (and
    # the lower shards' new vertices)
    vbase = base + 3 * pj[ok]
    code = torch.as_tensor(CHILD_IDX_CODE, device=dev)[cid[ok]].long()
    parent_vidx = model.vertex_index[src].long()
    child_vidx = torch.where(
        code < 3, torch.gather(parent_vidx, 1, torch.clamp(code, 0, 2)),
        vbase[:, None] + torch.clamp(code - 3, 0, 2)).to(torch.int32)

    def scat(arr, vals):
        out = arr.clone()
        out[dest] = vals.to(arr.dtype)
        return out

    p = model.params()
    k = dest.shape[0]
    shrink = torch.log(torch.tensor(4.0 * 0.8, dtype=torch.float32, device=dev))
    params = {
        "bc": scat(p["bc"], torch.full((k, 3), 1.0 / 3.0, device=dev)),
        "distance": scat(p["distance"], torch.zeros((k, 1), device=dev)),
        "features_dc": scat(p["features_dc"], p["features_dc"][src]),
        "features_rest": scat(p["features_rest"], p["features_rest"][src]),
        "scaling": scat(p["scaling"], p["scaling"][src] - shrink),
        "rotation": scat(p["rotation"], p["rotation"][src]),
        "opacity": scat(p["opacity"], p["opacity"][src]),
    }

    kill = torch.zeros(c, dtype=torch.bool, device=dev)
    kill[sel_idx[parent_ok]] = True
    new_alive = alive & ~kill
    new_alive[dest] = True
    binding = {
        "vertex1": scat(model.vertex1, child[:, 0]),
        "vertex2": scat(model.vertex2, child[:, 1]),
        "vertex3": scat(model.vertex3, child[:, 2]),
        "vertex_index": scat(model.vertex_index, child_vidx),
        "fid": scat(model.fid, model.fid[src]),
        "normal": scat(model.normal, model.normal[src]),
        "r": scat(model.r, model.r[src]),
        "alive": new_alive,
    }

    # midpoints, reference layout m_ab, m_ac, m_bc, one triple per parent
    split = sel_idx[parent_ok]
    a, b, cc = model.vertex1[split], model.vertex2[split], model.vertex3[split]
    mids = torch.stack([(a + b) * 0.5, (a + cc) * 0.5, (b + cc) * 0.5],
                       dim=1).reshape(-1, 3)
    most = max(split_by_shard)
    if mesh is not None and most > 0:      # every shard's, in rank order
        pad = torch.cat([mids, mids.new_zeros(3 * (most - n_split), 3)])
        mids = torch.cat([m[:3 * k] for m, k in zip(
            sharding.all_gather(pad, mesh.tile_group), split_by_shard)])
    v = pool.v.clone()
    v[pool.count:pool.count + mids.shape[0]] = mids
    mesh_v = MeshVertices(v=v, count=pool.count + 3 * sum(split_by_shard))

    def zero_at_dest(m):
        out = m.clone()
        out[dest] = 0.0
        return out

    new_model = MeshGaussianModel(params, binding, mesh_v=mesh_v,
                                  state=empty_state(c, dev))
    return SplitResult(model=new_model,
                       mu={n: zero_at_dest(m) for n, m in mu.items()},
                       nu={n: zero_at_dest(m) for n, m in nu.items()},
                       n_split=sum(split_by_shard), dropped=dropped)


def split_all_for_init(model: MeshGaussianModel, mu: dict, nu: dict,
                       max_split: int) -> SplitResult:
    """1->4 split of every alive Gaussian (the init loop until > 100K)."""
    grads = torch.where(model.alive, 1.0, 0.0)
    return densify_and_split(model, mu, nu, grads, 0.5, 4, max_split)


def reset_opacity(opacity: torch.Tensor) -> torch.Tensor:
    """opacity <- min(opacity, 0.01) in activated space
    (mesh_based_gaussian_model.py:334-339). The reference also zeroes the
    opacity's Adam moments (replace_tensor_to_optimizer,
    gaussian_model.py:290-301); the trainer does that."""
    op = torch.clamp(torch.sigmoid(opacity), max=0.01)
    return torch.log(op / (1.0 - op))


def add_densification_stats(state: MeshGaussianState, mean2d_grad: torch.Tensor,
                            visibility: torch.Tensor, width: int,
                            height: int) -> MeshGaussianState:
    """Accumulate ||dL/d mean2d|| in the reference's NDC-half units
    (pixel gradient x (W/2, H/2), backward.cu:460-461), visible rows only."""
    scale = torch.tensor([0.5 * width, 0.5 * height], dtype=mean2d_grad.dtype,
                         device=mean2d_grad.device)
    norm = torch.linalg.vector_norm(mean2d_grad * scale, dim=-1)
    return state._replace(
        grad_accum=state.grad_accum + torch.where(visibility, norm, 0.0),
        denom=state.denom + visibility.to(torch.float32))


def grads_avg(state: MeshGaussianState) -> torch.Tensor:
    g = state.grad_accum / torch.clamp(state.denom, min=1.0)
    return torch.nan_to_num(g, nan=0.0)


# ---------------------------------------------------------------------------
# The background model: vanilla 3DGS adaptive density control
# ---------------------------------------------------------------------------


class BgDensifyResult(NamedTuple):
    model: GaussianModel          # new parameters and alive mask, zero statistics
    mu: dict[str, torch.Tensor]
    nu: dict[str, torch.Tensor]
    n_cloned: int
    n_split: int
    n_pruned: int
    dropped: int                  # candidates with no room


@torch.no_grad()
def densify_and_prune_bg(model: GaussianModel, mu: dict, nu: dict,
                         grads_avg: torch.Tensor, eps: torch.Tensor,
                         grad_threshold: float, min_opacity: float,
                         extent: float, percent_dense: float,
                         max_screen: float, max_new: int) -> BgDensifyResult:
    """Clone + split (N = 2) + prune in one compaction pass (the JAX
    `densify_and_prune_bg`); -> a new model (the input is not modified).

    Candidates are the alive rows with grads_avg >= grad_threshold, ranked
    by gradient (ties in index order, as `jax.lax.top_k`), at most
    `max_new`: a clone (largest scale <= percent_dense * extent) takes one
    free slot, a split two (its parent retires). Split children sample
    their position N(mean, Sigma) from `eps` (2 max_new, 3) standard normal
    draws, row 2 i + k for candidate rank i's child k, and divide the scale
    by 1.6. Then rows with opacity < min_opacity die; `max_screen` <= 0
    turns the screen / world size prune off (the reference passes
    size_threshold=None in background training, train_bg_gaussian.py:148)."""
    alive = model.alive
    c = alive.shape[0]
    dev = alive.device
    if max_new > c:
        raise ValueError(f"max_new {max_new} exceeds the capacity {c}")
    p = model.params()
    max_scale = torch.exp(p["scaling"]).amax(dim=1)
    hot = alive & (grads_avg >= grad_threshold)
    small = max_scale <= percent_dense * extent
    split_sel = hot & ~small
    score = torch.where(hot, grads_avg, float("-inf"))
    top_score, cand = torch.sort(score, descending=True, stable=True)
    top_score, cand = top_score[:max_new], cand[:max_new]
    cand_ok = top_score > float("-inf")
    cand_is_split = split_sel[cand]

    # candidate i takes `need` slots from slot0 on, in the ascending free rows
    n_free = int((~alive).sum())
    need = torch.where(cand_ok, torch.where(cand_is_split, 2, 1), 0)
    slot0 = torch.cumsum(need, 0) - need
    ok = cand_ok & (slot0 + need <= n_free)
    n_cloned = int((ok & ~cand_is_split).sum())
    n_split = int((ok & cand_is_split).sum())
    dropped = int(cand_ok.sum()) - n_cloned - n_split

    free_idx = torch.nonzero(~alive).flatten()[:2 * max_new]
    k_ids = torch.arange(2 * max_new, device=dev)
    ci, k = k_ids // 2, k_ids % 2
    needed = ok[ci] & (k < need[ci])                     # child rows written
    parent = cand[ci][needed]
    dest = free_idx[(slot0[ci] + k)[needed]]
    is_split_row = cand_is_split[ci][needed][:, None]

    rot = quat_to_rotmat(normalize(p["rotation"][parent]))
    sample = p["xyz"][parent] + torch.einsum(
        "nij,nj->ni", rot, eps[needed] * torch.exp(p["scaling"][parent]))
    new_vals = {k_: v[parent] for k_, v in p.items()}
    new_vals["xyz"] = torch.where(is_split_row, sample, new_vals["xyz"])
    new_vals["scaling"] = torch.where(is_split_row,
                                      new_vals["scaling"] - math.log(0.8 * 2),
                                      new_vals["scaling"])

    def scat(arr, vals):
        out = arr.detach().clone()
        out[dest] = vals
        return out

    params = {k_: scat(v, new_vals[k_]) for k_, v in p.items()}
    kill = torch.zeros(c, dtype=torch.bool, device=dev)
    kill[cand[ok & cand_is_split]] = True
    new_alive = alive & ~kill
    new_alive[dest] = True

    prune = new_alive & (torch.sigmoid(params["opacity"][:, 0]) < min_opacity)
    if max_screen > 0:
        size_prune = (model.state.max_radii2d > max_screen) | (
            torch.exp(params["scaling"]).amax(dim=1) > 0.1 * extent)
        prune = prune | (new_alive & size_prune)
    n_pruned = int(prune.sum())
    new_alive = new_alive & ~prune

    def zero_at_dest(m):
        out = m.clone()
        out[dest] = 0.0
        return out

    return BgDensifyResult(
        model=GaussianModel(params, new_alive),
        mu={n: zero_at_dest(m) for n, m in mu.items()},
        nu={n: zero_at_dest(m) for n, m in nu.items()},
        n_cloned=n_cloned, n_split=n_split, n_pruned=n_pruned, dropped=dropped)


reset_opacity_bg = reset_opacity  # the same law for both models

# background rows per distance matmul: 1,024 x 491,692 alive mesh rows of
# config 4 is a 2 GB f32 block on the card
NEAR_MESH_CHUNK = 1024


@torch.no_grad()
def prune_near_mesh(alive: torch.Tensor, bg_xyz: torch.Tensor,
                    mesh_xyz: torch.Tensor, mesh_alive: torch.Tensor,
                    min_dist_sq: float = 0.01) -> torch.Tensor:
    """Retire background Gaussians whose nearest alive mesh Gaussian is
    closer than sqrt(min_dist_sq) (train_bg_gaussian.py:129-138, squared
    distances as jt.misc.knn gives them) -> the new alive mask. Distances in
    the JAX package's expanded form |b|^2 + |m|^2 - 2 b.m (dead mesh rows at
    +inf), an f32 matmul per NEAR_MESH_CHUNK background rows."""
    m_sq = torch.where(mesh_alive, torch.sum(mesh_xyz * mesh_xyz, dim=1),
                       float("inf"))
    dmin = []
    for s in range(0, bg_xyz.shape[0], NEAR_MESH_CHUNK):
        b = bg_xyz[s:s + NEAR_MESH_CHUNK]
        d2 = (torch.sum(b * b, dim=1)[:, None] + m_sq[None, :]
              - 2.0 * (b @ mesh_xyz.T))
        dmin.append(d2.amin(dim=1))
    return alive & ~(torch.cat(dmin) < min_dist_sq)
