"""Mesh-bound Gaussian model (port of `gaussianmesh_tpu/models/mesh_gaussians.py`).

Each Gaussian lives on a proxy-mesh triangle via pre-softmax barycentric
logits `bc` and a pre-sigmoid signed offset `distance` along the face
normal; the position law (mesh_based_gaussian_model.py:139-152) is

    xyz = softmax(bc) . [v1; v2; v3]
          + alpha_distance * r * (sigmoid(distance) - 0.5) * normal

with alpha_distance = 4 and r the face's mean edge length.

`MeshGaussianModel` is an `nn.Module`: the trainable leaves (the JAX
`MeshGaussianParams` fields) are `nn.Parameter`s, the attachment state (the
JAX `MeshBinding` fields) is registered buffers. Capacity rows past the
live ones carry `alive = False`. Beside them the model carries the proxy
mesh's vertex pool (`mesh_v`, which densification appends midpoints to)
and the densification statistics (`state`), as plain attributes: the
trainer replaces them whole.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from gaussianmesh_tpu_torch import resolve_device
from gaussianmesh_tpu_torch.ops.knn import mean_sq_dist3
from gaussianmesh_tpu_torch.utils import maths, sh as sh_utils, subdivision

ALPHA_DISTANCE = 4.0  # mesh_based_gaussian_model.py:48

PARAM_FIELDS = ("bc", "distance", "features_dc", "features_rest", "scaling",
                "rotation", "opacity")
BINDING_FIELDS = ("vertex1", "vertex2", "vertex3", "vertex_index", "fid",
                  "normal", "r", "alive")


STATE_FIELDS = ("max_radii2d", "grad_accum", "denom")


class MeshVertices(NamedTuple):
    """The (subdividing) proxy-mesh vertex pool, fixed capacity."""
    v: torch.Tensor   # (VC, 3) f32
    count: int        # valid prefix length


class MeshGaussianState(NamedTuple):
    """Densification statistics, one entry per capacity row."""
    max_radii2d: torch.Tensor  # (C,) f32
    grad_accum: torch.Tensor   # (C,) f32 accumulated ||dL/d mean2d||
    denom: torch.Tensor        # (C,) f32 views in which the row was visible


def empty_state(capacity: int, device) -> MeshGaussianState:
    return MeshGaussianState(*(torch.zeros(capacity, dtype=torch.float32,
                                           device=device)
                               for _ in STATE_FIELDS))


class MeshGaussianModel(nn.Module):
    """Parameters (capacity C rows): bc (C, 3), distance (C, 1),
    features_dc (C, 1, 3), features_rest (C, K-1, 3), scaling (C, 3)
    log-scale, rotation (C, 4), opacity (C, 1) pre-sigmoid.
    Buffers: vertex1..3 (C, 3), vertex_index (C, 3) int32, fid (C, 1)
    int32, normal (C, 3), r (C, 1), alive (C,) bool.
    Attributes: mesh_v (`MeshVertices`, None when the model was loaded
    without its mesh), state (`MeshGaussianState`)."""

    def __init__(self, params: dict[str, torch.Tensor],
                 binding: dict[str, torch.Tensor],
                 mesh_v: MeshVertices | None = None,
                 state: MeshGaussianState | None = None):
        super().__init__()
        for name in PARAM_FIELDS:
            setattr(self, name, nn.Parameter(params[name]))
        for name in BINDING_FIELDS:
            self.register_buffer(name, binding[name])
        self.mesh_v = mesh_v
        self.state = (empty_state(binding["alive"].shape[0],
                                  binding["alive"].device)
                      if state is None else state)

    @property
    def capacity(self) -> int:
        return self.alive.shape[0]

    def params(self) -> dict[str, torch.Tensor]:
        return {name: getattr(self, name) for name in PARAM_FIELDS}

    def binding(self) -> dict[str, torch.Tensor]:
        return {name: getattr(self, name) for name in BINDING_FIELDS}

    def get_bc(self) -> torch.Tensor:
        return torch.softmax(self.bc, dim=1)

    def get_proj_xyz(self) -> torch.Tensor:
        bc = self.get_bc()
        return (bc[:, 0:1] * self.vertex1 + bc[:, 1:2] * self.vertex2
                + bc[:, 2:3] * self.vertex3)

    def get_xyz(self) -> torch.Tensor:
        offset = (ALPHA_DISTANCE * self.r * (torch.sigmoid(self.distance) - 0.5)
                  * self.normal)
        return self.get_proj_xyz() + offset

    def get_scaling(self) -> torch.Tensor:
        return torch.exp(self.scaling)

    def get_opacity(self) -> torch.Tensor:
        return torch.sigmoid(self.opacity)

    def get_features(self) -> torch.Tensor:
        return torch.cat([self.features_dc, self.features_rest], dim=1)

    def get_covariance6(self, scaling_modifier: float = 1.0) -> torch.Tensor:
        return maths.covariance_6(self.get_scaling(), maths.normalize(self.rotation),
                                  scaling_modifier)


def from_numpy(params: dict, binding: dict,
               device: str | torch.device | None = None,
               mesh_v: dict | None = None,
               state: dict | None = None) -> MeshGaussianModel:
    """Build the model from numpy leaves named as the JAX dataclasses'
    fields (`MeshGaussianParams`, `MeshBinding`, and optionally
    `MeshVertices` and `MeshGaussianState`) — e.g. a JAX model's state moved
    over as numpy."""
    dev = resolve_device(device)
    int_fields = ("vertex_index", "fid")

    def t(name, x):
        x = np.asarray(x)
        if name == "alive":
            return torch.as_tensor(x.astype(bool), device=dev)
        dtype = np.int32 if name in int_fields else np.float32
        return torch.as_tensor(x.astype(dtype), device=dev)

    pool = None
    if mesh_v is not None:
        pool = MeshVertices(v=t("v", mesh_v["v"]), count=int(mesh_v["count"]))
    stats = None
    if state is not None:
        stats = MeshGaussianState(*(t(k, state[k]) for k in STATE_FIELDS))
    return MeshGaussianModel({k: t(k, params[k]) for k in PARAM_FIELDS},
                             {k: t(k, binding[k]) for k in BINDING_FIELDS},
                             mesh_v=pool, state=stats)


def create_from_mesh(vertices, triangles, capacity: int | None = None,
                     max_sh_degree: int = 3,
                     device: str | torch.device | None = None,
                     generator: torch.Generator | None = None,
                     vertex_capacity: int | None = None) -> MeshGaussianModel:
    """One Gaussian per face (mesh_based_gaussian_model.py:183-241): bc
    logits 1/3 (uniform), distance 0 (on-surface), random DC color from
    `generator`, scale from the mean 3-NN distance of the face centroids,
    opacity 0.1. The vertex pool holds the mesh's vertices padded with
    zeros to `vertex_capacity` (default: no room to split)."""
    dev = resolve_device(device)
    vertices = torch.tensor(np.asarray(vertices, np.float32), device=dev)
    triangles = torch.tensor(np.asarray(triangles, np.int64), device=dev)
    n = triangles.shape[0]
    capacity = n if capacity is None else capacity
    if capacity < n:
        raise ValueError(f"capacity {capacity} < {n} faces")
    n_v = vertices.shape[0]
    vertex_capacity = n_v if vertex_capacity is None else vertex_capacity
    if vertex_capacity < n_v:
        raise ValueError(f"vertex_capacity {vertex_capacity} < {n_v} vertices")
    k = (max_sh_degree + 1) ** 2
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)

    v1, v2, v3 = (vertices[triangles[:, i]] for i in range(3))
    normals = subdivision.face_normals(v1, v2, v3)
    r = subdivision.face_mean_edge_length(v1, v2, v3)
    centroid = (v1 + v2 + v3) / 3.0
    dist2 = torch.clamp(mean_sq_dist3(centroid), min=1e-7)
    log_scale = torch.log(torch.sqrt(dist2))[:, None].repeat(1, 3)
    colors = torch.rand((n, 3), generator=generator, device=dev)

    def cap(x, fill=0):
        pad = x.new_full((capacity - n,) + tuple(x.shape[1:]), fill)
        return torch.cat([x, pad])

    f32 = dict(dtype=torch.float32, device=dev)
    params = {
        "bc": cap(torch.full((n, 3), 1.0 / 3.0, **f32)),
        "distance": torch.zeros((capacity, 1), **f32),
        "features_dc": cap(sh_utils.rgb_to_sh(colors)[:, None, :]),
        "features_rest": torch.zeros((capacity, k - 1, 3), **f32),
        "scaling": cap(log_scale),
        "rotation": cap(torch.tensor([[1.0, 0, 0, 0]], **f32).repeat(n, 1)),
        "opacity": cap(maths.inverse_sigmoid(torch.full((n, 1), 0.1, **f32))),
    }
    binding = {
        "vertex1": cap(v1), "vertex2": cap(v2), "vertex3": cap(v3),
        "vertex_index": cap(triangles.to(torch.int32)),
        "fid": cap(torch.arange(n, dtype=torch.int32, device=dev)[:, None]),
        "normal": cap(normals), "r": cap(r),
        "alive": torch.arange(capacity, device=dev) < n,
    }
    pool = MeshVertices(v=torch.cat([vertices, vertices.new_zeros(
        vertex_capacity - n_v, 3)]), count=n_v)
    return MeshGaussianModel(params, binding, mesh_v=pool)
