"""COLMAP sparse-reconstruction parsers (binary + text) and a binary writer,
pure numpy (a copy of `gaussianmesh_tpu/io/colmap.py`; the reference's
scene/colmap_loader.py).

The on-disk layout is the public COLMAP format: cameras/images/points3D in
either .bin (little-endian packed) or .txt. Only what the pipeline needs is
kept: intrinsics (model, w, h, params), extrinsics (qvec, tvec, camera_id,
name), and the 3D points (xyz, rgb, error).
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass

import numpy as np

CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3), 1: ("PINHOLE", 4), 2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5), 4: ("OPENCV", 8), 5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12), 7: ("FOV", 5), 8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5), 10: ("THIN_PRISM_FISHEYE", 12),
}
_MODEL_BY_NAME = {name: (mid, n) for mid, (name, n) in CAMERA_MODELS.items()}


@dataclass
class ColmapCamera:
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray


@dataclass
class ColmapImage:
    id: int
    qvec: np.ndarray
    tvec: np.ndarray
    camera_id: int
    name: str


def qvec2rotmat(qvec: np.ndarray) -> np.ndarray:
    w, x, y, z = qvec
    return np.array([
        [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * w * z, 2 * x * z + 2 * w * y],
        [2 * x * y + 2 * w * z, 1 - 2 * x * x - 2 * z * z, 2 * y * z - 2 * w * x],
        [2 * x * z - 2 * w * y, 2 * y * z + 2 * w * x, 1 - 2 * x * x - 2 * y * y],
    ])


def _read(f, fmt: str):
    size = struct.calcsize(fmt)
    return struct.unpack("<" + fmt, f.read(size))


def read_cameras_binary(path: str) -> dict[int, ColmapCamera]:
    out = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "Q")
        for _ in range(n):
            cid, model_id, w, h = _read(f, "iiQQ")
            name, np_ = CAMERA_MODELS[model_id]
            params = np.array(_read(f, "d" * np_))
            out[cid] = ColmapCamera(cid, name, int(w), int(h), params)
    return out


def read_images_binary(path: str) -> dict[int, ColmapImage]:
    out = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "Q")
        for _ in range(n):
            iid = _read(f, "i")[0]
            qvec = np.array(_read(f, "dddd"))
            tvec = np.array(_read(f, "ddd"))
            cam_id = _read(f, "i")[0]
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            (n2d,) = _read(f, "Q")
            f.read(24 * n2d)  # skip 2D points (x, y, point3D_id)
            out[iid] = ColmapImage(iid, qvec, tvec, cam_id, name.decode())
    return out


def read_points3d_binary(path: str):
    with open(path, "rb") as f:
        (n,) = _read(f, "Q")
        xyz = np.empty((n, 3))
        rgb = np.empty((n, 3))
        err = np.empty(n)
        for i in range(n):
            _read(f, "Q")  # id
            xyz[i] = _read(f, "ddd")
            rgb[i] = _read(f, "BBB")
            err[i] = _read(f, "d")[0]
            (tl,) = _read(f, "Q")
            f.read(12 * tl)  # track elements
    return xyz, rgb, err


def read_cameras_text(path: str) -> dict[int, ColmapCamera]:
    out = {}
    with open(path) as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            e = line.split()
            out[int(e[0])] = ColmapCamera(int(e[0]), e[1], int(e[2]), int(e[3]),
                                          np.array([float(x) for x in e[4:]]))
    return out


def read_images_text(path: str) -> dict[int, ColmapImage]:
    out = {}
    with open(path) as f:
        # keep blank lines: COLMAP writes an EMPTY POINTS2D line for
        # images with zero observations, and the header/points
        # alternation must consume it (the reference reads the points
        # line unconditionally, colmap_loader.py)
        lines = [l for l in f if not l.startswith("#")]
    i = 0
    while i < len(lines):
        if not lines[i].strip():
            i += 1
            continue
        e = lines[i].split()
        out[int(e[0])] = ColmapImage(
            int(e[0]), np.array([float(x) for x in e[1:5]]),
            np.array([float(x) for x in e[5:8]]), int(e[8]), e[9])
        i += 2  # skip the (possibly empty) POINTS2D line
    return out


def read_points3d_text(path: str):
    xyz, rgb, err = [], [], []
    with open(path) as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            e = line.split()
            xyz.append([float(x) for x in e[1:4]])
            rgb.append([float(x) for x in e[4:7]])
            err.append(float(e[7]))
    return np.asarray(xyz), np.asarray(rgb), np.asarray(err)


def read_model(sparse_dir: str):
    """Auto-detect bin/text. -> (cameras, images, (xyz, rgb, err))."""
    if os.path.exists(os.path.join(sparse_dir, "cameras.bin")):
        cams = read_cameras_binary(os.path.join(sparse_dir, "cameras.bin"))
        imgs = read_images_binary(os.path.join(sparse_dir, "images.bin"))
        pts = read_points3d_binary(os.path.join(sparse_dir, "points3D.bin"))
    else:
        cams = read_cameras_text(os.path.join(sparse_dir, "cameras.txt"))
        imgs = read_images_text(os.path.join(sparse_dir, "images.txt"))
        pts = read_points3d_text(os.path.join(sparse_dir, "points3D.txt"))
    return cams, imgs, pts


def write_model_binary(sparse_dir: str, cameras: dict[int, ColmapCamera],
                       images: dict[int, ColmapImage], xyz, rgb, err) -> None:
    """Writer (test fixtures + convert tooling)."""
    os.makedirs(sparse_dir, exist_ok=True)
    with open(os.path.join(sparse_dir, "cameras.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(cameras)))
        for c in cameras.values():
            mid, np_ = _MODEL_BY_NAME[c.model]
            f.write(struct.pack("<iiQQ", c.id, mid, c.width, c.height))
            f.write(struct.pack("<" + "d" * np_, *c.params))
    with open(os.path.join(sparse_dir, "images.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for im in images.values():
            f.write(struct.pack("<i", im.id))
            f.write(struct.pack("<dddd", *im.qvec))
            f.write(struct.pack("<ddd", *im.tvec))
            f.write(struct.pack("<i", im.camera_id))
            f.write(im.name.encode() + b"\x00")
            f.write(struct.pack("<Q", 0))
    with open(os.path.join(sparse_dir, "points3D.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(xyz)))
        for i in range(len(xyz)):
            f.write(struct.pack("<Q", i))
            f.write(struct.pack("<ddd", *xyz[i]))
            f.write(struct.pack("<BBB", *(int(v) for v in rgb[i])))
            f.write(struct.pack("<d", float(err[i])))
            f.write(struct.pack("<Q", 0))
