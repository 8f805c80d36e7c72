"""Gaussian model <-> PLY in the reference's interchange schemas (port of
`gaussianmesh_tpu/io/gaussian_ply.py`; a PLY written by either package loads
in the other).

Mesh-bound schema (scene/mesh_based_gaussian_model.py:290-332): per vertex
  x y z nx ny nz ca cb cc v1x..v3z dis v_index1..3 radius face_id
  f_dc_0..2 f_rest_* opacity scale_0..2 rot_0..3       (all float32)
Vanilla 3DGS schema (scene/gaussian_model.py:221-288): the same without the
attachment block. SH rest coefficients are stored channel-major.

Loading rebuilds `bc` / `distance` from the saved logits (ca/cb/cc, dis),
so positions recompute through the attachment law; the saved x/y/z come
back as `load_xyz`.
"""

from __future__ import annotations

import numpy as np
import torch

from gaussianmesh_tpu_torch.io import ply as ply_io
from gaussianmesh_tpu_torch.models import gaussians as gs
from gaussianmesh_tpu_torch.models import mesh_gaussians as mgs


def _np(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy().astype(np.float32)


def _sh_rest_to_flat(features_rest: np.ndarray) -> dict[str, np.ndarray]:
    # (N, K-1, 3) -> channel-major flat f_rest_i
    cm = np.transpose(features_rest, (0, 2, 1)).reshape(features_rest.shape[0], -1)
    return {f"f_rest_{i}": cm[:, i].astype(np.float32) for i in range(cm.shape[1])}


def sh_degree_from_props(props) -> int:
    k_rest = sum(1 for p in props if p.startswith("f_rest_")) // 3
    deg = int(round((k_rest + 1) ** 0.5)) - 1
    if (deg + 1) ** 2 - 1 != k_rest:
        raise ValueError(f"{k_rest} SH rest coefficients match no degree")
    return deg


def _sh_rest_from_props(props, n, max_sh_degree):
    k = (max_sh_degree + 1) ** 2 - 1
    names = sorted((p for p in props if p.startswith("f_rest_")),
                   key=lambda s: int(s.split("_")[-1]))
    if len(names) != 3 * k:
        raise ValueError(f"{len(names)} f_rest fields for SH degree {max_sh_degree}")
    if k == 0:
        return np.zeros((n, 0, 3), np.float32)
    cm = np.stack([props[p] for p in names], axis=1).reshape(n, 3, k)
    return np.transpose(cm, (0, 2, 1))


def _common_props(m, sel) -> dict[str, np.ndarray]:
    """f_dc / f_rest / opacity / scale / rot of the rows `sel`."""
    props: dict[str, np.ndarray] = {}
    fdc = _np(m.features_dc)[sel, 0]
    for i in range(3):
        props[f"f_dc_{i}"] = fdc[:, i]
    props.update(_sh_rest_to_flat(_np(m.features_rest)[sel]))
    props["opacity"] = _np(m.opacity)[sel, 0]
    scaling = _np(m.scaling)[sel]
    for i in range(3):
        props[f"scale_{i}"] = scaling[:, i]
    rot = _np(m.rotation)[sel]
    for i in range(4):
        props[f"rot_{i}"] = rot[:, i]
    return props


def save_mesh_gaussian_ply(path: str, model: mgs.MeshGaussianModel) -> None:
    sel = np.nonzero(model.alive.cpu().numpy())[0]
    props: dict[str, np.ndarray] = {}
    xyz = _np(model.get_xyz())[sel]
    for i, name in enumerate("xyz"):
        props[name] = xyz[:, i]
    normal = _np(model.normal)[sel]
    for i, name in enumerate(("nx", "ny", "nz")):
        props[name] = normal[:, i]
    bc = _np(model.bc)[sel]
    for i, name in enumerate(("ca", "cb", "cc")):
        props[name] = bc[:, i]
    for vname, vv in (("v1", model.vertex1), ("v2", model.vertex2),
                      ("v3", model.vertex3)):
        vv = _np(vv)[sel]
        for i, axis in enumerate("xyz"):
            props[f"{vname}{axis}"] = vv[:, i]
    props["dis"] = _np(model.distance)[sel, 0]
    vidx = _np(model.vertex_index)[sel]
    for i in range(3):
        props[f"v_index{i + 1}"] = vidx[:, i]
    props["radius"] = _np(model.r)[sel, 0]
    props["face_id"] = _np(model.fid)[sel, 0]
    props.update(_common_props(model, sel))
    ply_io.write_ply(path, {"vertex": props})


def _padder(n: int, cap: int):
    def cap_pad(x, dtype=np.float32):
        x = np.asarray(x, dtype)
        return np.pad(x, [(0, cap - n)] + [(0, 0)] * (x.ndim - 1))
    return cap_pad


def load_mesh_gaussian_ply(path: str, capacity: int | None = None,
                           max_sh_degree: int | None = None,
                           device: str | torch.device | None = None):
    """-> (model, load_xyz (N, 3) numpy array of the saved positions).
    max_sh_degree=None infers the degree from the stored f_rest count."""
    v = ply_io.read_ply(path)["vertex"]
    n = len(v["x"])
    cap = capacity or n
    if max_sh_degree is None:
        max_sh_degree = sh_degree_from_props(v)
    cap_pad = _padder(n, cap)

    def stack(*names):
        return np.stack([v[nm] for nm in names], axis=1)

    params = {
        "bc": cap_pad(stack("ca", "cb", "cc")),
        "distance": cap_pad(v["dis"][:, None]),
        "features_dc": cap_pad(stack("f_dc_0", "f_dc_1", "f_dc_2")[:, None, :]),
        "features_rest": cap_pad(_sh_rest_from_props(v, n, max_sh_degree)),
        "scaling": cap_pad(stack("scale_0", "scale_1", "scale_2")),
        "rotation": cap_pad(stack("rot_0", "rot_1", "rot_2", "rot_3")),
        "opacity": cap_pad(v["opacity"][:, None]),
    }
    binding = {
        "vertex1": cap_pad(stack("v1x", "v1y", "v1z")),
        "vertex2": cap_pad(stack("v2x", "v2y", "v2z")),
        "vertex3": cap_pad(stack("v3x", "v3y", "v3z")),
        "vertex_index": cap_pad(stack("v_index1", "v_index2", "v_index3"),
                                np.int32),
        "fid": cap_pad(v["face_id"][:, None], np.int32),
        "normal": cap_pad(stack("nx", "ny", "nz")),
        "r": cap_pad(v["radius"][:, None]),
        "alive": np.arange(cap) < n,
    }
    load_xyz = stack("x", "y", "z").astype(np.float32)
    return mgs.from_numpy(params, binding, device), load_xyz


def save_gaussian_ply(path: str, model: gs.GaussianModel) -> None:
    sel = np.nonzero(model.alive.cpu().numpy())[0]
    xyz = _np(model.xyz)[sel]
    props: dict[str, np.ndarray] = {}
    for i, name in enumerate("xyz"):
        props[name] = xyz[:, i]
    for name in ("nx", "ny", "nz"):
        props[name] = np.zeros(len(sel), np.float32)
    props.update(_common_props(model, sel))
    ply_io.write_ply(path, {"vertex": props})


def load_gaussian_ply(path: str, capacity: int | None = None,
                      max_sh_degree: int | None = None,
                      device: str | torch.device | None = None) -> gs.GaussianModel:
    v = ply_io.read_ply(path)["vertex"]
    n = len(v["x"])
    cap = capacity or n
    if max_sh_degree is None:
        max_sh_degree = sh_degree_from_props(v)
    cap_pad = _padder(n, cap)

    def stack(*names):
        return np.stack([v[nm] for nm in names], axis=1)

    params = {
        "xyz": cap_pad(stack("x", "y", "z")),
        "features_dc": cap_pad(stack("f_dc_0", "f_dc_1", "f_dc_2")[:, None, :]),
        "features_rest": cap_pad(_sh_rest_from_props(v, n, max_sh_degree)),
        "scaling": cap_pad(stack("scale_0", "scale_1", "scale_2")),
        "rotation": cap_pad(stack("rot_0", "rot_1", "rot_2", "rot_3")),
        "opacity": cap_pad(v["opacity"][:, None]),
    }
    return gs.from_numpy(params, np.arange(cap) < n, device)
