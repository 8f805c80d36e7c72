"""Triangle mesh IO, OBJ and PLY (port of `gaussianmesh_tpu/io/mesh.py`, in
place of igl.read/write_triangle_mesh): the proxy mesh a trainer starts
from, and the split mesh it saves."""

from __future__ import annotations

import os

import numpy as np

from gaussianmesh_tpu_torch.io import ply as ply_io


def read_triangle_mesh(path: str) -> tuple[np.ndarray, np.ndarray]:
    """-> (vertices (V, 3) f32, triangles (F, 3) i32). Polygons are fanned."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".obj":
        return _read_obj(path)
    if ext == ".ply":
        data = ply_io.read_ply(path)
        v = np.stack([data["vertex"][k] for k in ("x", "y", "z")], axis=1)
        face = data.get("face", {})
        key = "vertex_indices" if "vertex_indices" in face else "vertex_index"
        return v.astype(np.float32), _fan_triangulate(face[key]).astype(np.int32)
    raise ValueError(f"unsupported mesh format: {path}")


def write_triangle_mesh(path: str, vertices: np.ndarray,
                        triangles: np.ndarray) -> None:
    ext = os.path.splitext(path)[1].lower()
    vertices = np.asarray(vertices, np.float32)
    triangles = np.asarray(triangles, np.int32)
    if ext == ".obj":
        with open(path, "w") as f:
            for v in vertices:
                f.write(f"v {v[0]} {v[1]} {v[2]}\n")
            for t in triangles:
                f.write(f"f {t[0] + 1} {t[1] + 1} {t[2] + 1}\n")
        return
    if ext == ".ply":
        ply_io.write_ply(
            path,
            {"vertex": {"x": vertices[:, 0], "y": vertices[:, 1],
                        "z": vertices[:, 2]},
             "face": {"vertex_indices": triangles}},
            list_properties={"face": ["vertex_indices"]})
        return
    raise ValueError(f"unsupported mesh format: {path}")


def _read_obj(path: str) -> tuple[np.ndarray, np.ndarray]:
    verts, faces = [], []
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                verts.append([float(x) for x in line.split()[1:4]])
            elif line.startswith("f "):
                idx = [int(tok.split("/")[0]) - 1 for tok in line.split()[1:]]
                for i in range(1, len(idx) - 1):  # fan
                    faces.append([idx[0], idx[i], idx[i + 1]])
    return np.asarray(verts, np.float32), np.asarray(faces, np.int32)


def _fan_triangulate(faces_raw) -> np.ndarray:
    if (isinstance(faces_raw, np.ndarray) and faces_raw.ndim == 2
            and faces_raw.shape[1] == 3):
        return faces_raw
    out = []
    for row in faces_raw:
        row = list(row)
        for i in range(1, len(row) - 1):
            out.append([row[0], row[i], row[i + 1]])
    return np.asarray(out)
