"""Scene readers: COLMAP and Blender (NeRF-synthetic) datasets (port of
`gaussianmesh_tpu/data/readers.py`; the reference's
scene/dataset_readers.py).

Scene-type detection (`sparse/` vs `transforms_train.json`), the eval split
(every 8th camera), the nerf++ normalization radius, the Blender 150-frame
cap and the alpha -> mask conversion follow the reference (:46-67,
:145-236, :163-165, :203). The arrays equal the JAX reader's dtype for
dtype: images decode to float32 / 255, a Blender RGBA image composites over
a float64 background (so it comes out float64, and its uint8 targets
truncate as the JAX package's do), masks are float32.

Images are read by the port's own codecs (`io/png.py::read_image`:
`io/jpeg.py`, the PNG path, `io/bmp.py`, `io/tiff.py`, `io/gif.py`,
`io/webp.py`, `io/pnm.py`, `io/qoi.py`, `io/sgi.py`, `io/pcx.py`,
`io/ico.py`, `io/icns.py`, `io/tga.py`) and resized by `io/resample.py`, where the JAX reader uses
PIL: the same arrays, bit for bit, for the images PIL reads, with these
repairs: palette images expand to their colours (faults B6, B15), 16-bit
gray keeps its high byte (`io/png.py`; a PGM of maxval over 255 too,
fault B19: the JAX reader divides PIL's 0-65535 by 255), gray + alpha (2
channels) is taken as PIL's `convert("RGBA")` gives it, gray in R, G and B
and the alpha a mask (fault A2: the JAX reader keeps the two channels as
colours), a CMYK or YCCK JPEG or a CMYK TIFF comes as PIL's
`convert("RGB")` of it, 3 channels and no mask (fault B14: the JAX reader
takes K as the alpha), and a TGA whose descriptor counts no alpha bits
comes with no alpha and so no mask (fault B20: PIL takes its fourth byte
or bit 15 as alpha, and the JAX reader masks the view with it), and a
32-bit icon frame whose every fourth byte is 0 takes its alpha from its
AND mask (fault B23: PIL gives it alpha 0 everywhere, and the JAX reader
masks the whole view out).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass

import numpy as np

from gaussianmesh_tpu_torch.data.cameras import Camera, pick_resolution
from gaussianmesh_tpu_torch.io import colmap, ply as ply_io
from gaussianmesh_tpu_torch.io.png import read_image
from gaussianmesh_tpu_torch.io.resample import resize
from gaussianmesh_tpu_torch.utils.graphics import focal2fov, fov2focal


@dataclass
class PointCloud:
    points: np.ndarray
    colors: np.ndarray
    normals: np.ndarray


@dataclass
class SceneInfo:
    point_cloud: PointCloud | None
    train_cameras: list[Camera]
    test_cameras: list[Camera]
    nerf_norm: dict
    ply_path: str | None


def detect_scene_type(source_path: str) -> str:
    if os.path.exists(os.path.join(source_path, "sparse")):
        return "colmap"
    if os.path.exists(os.path.join(source_path, "transforms_train.json")):
        return "blender"
    raise ValueError(f"Could not recognize scene type for {source_path}")


def read_scene(source_path: str, images: str = "images", resolution: int = -1,
               white_background: bool = True, eval_split: bool = False,
               is_exist_bg: bool = False, llffhold: int = 8,
               max_frames: int = 150) -> SceneInfo:
    kind = detect_scene_type(source_path)
    if kind == "colmap":
        return read_colmap_scene(source_path, images, resolution, eval_split,
                                 is_exist_bg, llffhold)
    return read_blender_scene(source_path, resolution, white_background,
                              eval_split, max_frames)


def nerfpp_norm(cameras: list[Camera]) -> dict:
    centers = np.stack([c.camera_center for c in cameras], axis=0)
    avg = centers.mean(axis=0)
    diag = np.linalg.norm(centers - avg, axis=1).max()
    return {"translate": -avg, "radius": float(diag * 1.1)}


def _load_image(path: str, resolution: int, bg: np.ndarray | None,
                mask_path: str | None = None):
    """-> (image (3, H, W), mask (1, H, W) float32 | None). A mask is
    resized to the image's size; an RGB or gray + alpha mask counts by its
    first channel."""
    im = read_image(path)
    size = pick_resolution(im.shape[1], im.shape[0], resolution)
    arr = resize(im, size).astype(np.float32) / 255.0
    if arr.ndim == 2:
        arr = np.repeat(arr[..., None], 3, axis=2)
    elif arr.shape[2] == 2:                         # gray + alpha -> RGBA
        arr = arr[..., [0, 0, 0, 1]]
    mask = None
    if arr.shape[2] == 4:
        mask = arr[..., 3:4]
        if bg is not None:
            arr = arr[..., :3] * mask + bg * (1 - mask)
        else:
            arr = arr[..., :3]
        mask = mask.transpose(2, 0, 1)
    else:
        arr = arr[..., :3]
    if mask_path is not None:
        m_arr = resize(read_image(mask_path), size).astype(np.float32) / 255.0
        if m_arr.ndim == 3:
            m_arr = m_arr[..., 0]
        mask = m_arr[None]
    return arr.transpose(2, 0, 1), mask


def read_colmap_scene(source_path: str, images: str, resolution: int,
                      eval_split: bool, is_exist_bg: bool,
                      llffhold: int = 8) -> SceneInfo:
    sparse0 = os.path.join(source_path, "sparse", "0")
    sparse = sparse0 if os.path.exists(sparse0) else os.path.join(source_path, "sparse")
    cams_intr, cams_extr, (xyz, rgb, _err) = colmap.read_model(sparse)

    images_folder = os.path.join(source_path, images)
    masks_folder = os.path.join(source_path, "masks")
    have_masks = os.path.exists(masks_folder)
    if is_exist_bg and not have_masks:
        raise ValueError("You need masks to deform the scene! "
                         f"(expected {masks_folder})")

    cam_list: list[Camera] = []
    for iid in sorted(cams_extr.keys()):
        extr = cams_extr[iid]
        intr = cams_intr[extr.camera_id]
        R = colmap.qvec2rotmat(extr.qvec).T
        T = extr.tvec
        if intr.model == "SIMPLE_PINHOLE":
            fovx = focal2fov(intr.params[0], intr.width)
            fovy = focal2fov(intr.params[0], intr.height)
        elif intr.model == "PINHOLE":
            fovx = focal2fov(intr.params[0], intr.width)
            fovy = focal2fov(intr.params[1], intr.height)
        else:
            raise ValueError("only undistorted PINHOLE/SIMPLE_PINHOLE supported; "
                             "run convert (image undistortion) first")
        name = os.path.basename(extr.name)
        stem = os.path.splitext(name)[0]
        mask_path = os.path.join(masks_folder, stem + ".png") if have_masks else None
        img, mask = _load_image(os.path.join(images_folder, name), resolution,
                                None, mask_path)
        cam_list.append(Camera(uid=intr.id, R=R, T=T, fovx=fovx, fovy=fovy,
                               image=img, image_name=stem, mask=mask))

    if eval_split:
        train = [c for i, c in enumerate(cam_list) if i % llffhold != 0]
        test = [c for i, c in enumerate(cam_list) if i % llffhold == 0]
    else:
        train, test = cam_list, []

    ply_path = os.path.join(source_path, "sparse", "points3D.ply")
    pcd = PointCloud(points=xyz.astype(np.float32),
                     colors=(rgb / 255.0).astype(np.float32),
                     normals=np.zeros_like(xyz, dtype=np.float32))
    return SceneInfo(pcd, train, test, nerfpp_norm(train), ply_path)


def read_blender_scene(source_path: str, resolution: int,
                       white_background: bool, eval_split: bool,
                       max_frames: int = 150) -> SceneInfo:
    bg = np.array([1.0, 1.0, 1.0]) if white_background else np.zeros(3)

    def read_split(transforms_file: str) -> list[Camera]:
        with open(os.path.join(source_path, transforms_file)) as f:
            meta = json.load(f)
        fovx = meta["camera_angle_x"]
        cams = []
        for idx, frame in enumerate(meta["frames"][:max_frames]):
            path = os.path.join(source_path, frame["file_path"])
            if not os.path.splitext(path)[1]:
                path += ".png"
            c2w = np.array(frame["transform_matrix"])
            c2w[:3, 1:3] *= -1  # OpenGL -> COLMAP axes
            w2c = np.linalg.inv(c2w)
            img, mask = _load_image(path, resolution, bg)
            h, w = img.shape[-2:]
            cams.append(Camera(uid=idx, R=w2c[:3, :3].T, T=w2c[:3, 3], fovx=fovx,
                               fovy=focal2fov(fov2focal(fovx, w), h),
                               image=img, mask=mask,
                               image_name=os.path.basename(path)))
        return cams

    train = read_split("transforms_train.json")
    test = []
    if eval_split and os.path.exists(os.path.join(source_path, "transforms_test.json")):
        test = read_split("transforms_test.json")

    ply_path = os.path.join(source_path, "points3d.ply")
    if os.path.exists(ply_path):
        data = ply_io.read_ply(ply_path)["vertex"]
        pts = np.stack([data["x"], data["y"], data["z"]], axis=1)
        cols = (np.stack([data[c] for c in ("red", "green", "blue")], axis=1) / 255.0
                if "red" in data else np.full((len(pts), 3), 0.5))
        pcd = PointCloud(pts.astype(np.float32), cols.astype(np.float32),
                         np.zeros_like(pts, dtype=np.float32))
    else:
        # the reference synthesizes 100K random points (dataset_readers.py:221-230)
        rng = np.random.default_rng(0)
        pts = (rng.random((100_000, 3)) * 2.6 - 1.3).astype(np.float32)
        pcd = PointCloud(pts, rng.random((100_000, 3)).astype(np.float32),
                         np.zeros_like(pts))
    return SceneInfo(pcd, train, test, nerfpp_norm(train), ply_path)
