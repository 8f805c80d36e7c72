"""Host-side cameras and the resolution ladder (port of
`gaussianmesh_tpu/data/cameras.py`; datasets are read by `data/readers.py`).

A `Camera` carries the (R, T, fov) extrinsics in the COLMAP/3DGS convention,
the ground-truth image (float32 CHW in [0, 1]) and an optional mask, and
gives the device-side `CameraArrays` the rasterizer takes. `cameras.json`
entries (the layout of the reference's utils/camera_utils.py:64-83) convert
both ways, so a file written by either package loads in the other.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from gaussianmesh_tpu_torch import resolve_device
from gaussianmesh_tpu_torch.utils import graphics
from gaussianmesh_tpu_torch.utils.graphics import CameraArrays

Z_NEAR, Z_FAR = 0.01, 100.0  # scene/cameras.py:33-34


@dataclass
class Camera:
    uid: int
    R: np.ndarray              # (3, 3) cam-to-world rotation
    T: np.ndarray              # (3,) world-to-cam translation
    fovx: float
    fovy: float
    image: np.ndarray | None   # (3, H, W) float32 in [0, 1]
    image_name: str = ""
    mask: np.ndarray | None = None  # (1, H, W) float32
    width: int = 0
    height: int = 0
    translate: np.ndarray = field(default_factory=lambda: np.zeros(3))
    scale: float = 1.0

    def __post_init__(self):
        if self.image is not None:
            self.height, self.width = self.image.shape[-2:]

    @property
    def world_view(self) -> np.ndarray:
        return graphics.world_to_view(self.R, self.T, self.translate, self.scale)

    @property
    def projection(self) -> np.ndarray:
        return graphics.projection_matrix(Z_NEAR, Z_FAR, self.fovx, self.fovy)

    @property
    def camera_center(self) -> np.ndarray:
        return graphics.camera_center_from_w2v(self.world_view)

    def arrays_np(self) -> tuple:
        """Stackable numpy form (V, P @ V, campos, tanfovx, tanfovy)."""
        V = self.world_view
        return (V, (self.projection @ V).astype(np.float32), self.camera_center,
                np.float32(math.tan(self.fovx / 2)),
                np.float32(math.tan(self.fovy / 2)))

    def arrays(self, device=None) -> CameraArrays:
        """The rasterizer's view of this camera, on `device` (CUDA unless
        the caller asks for the CPU)."""
        return CameraArrays.from_numpy(*self.arrays_np(),
                                       device=resolve_device(device))


def pick_resolution(orig_w: int, orig_h: int, resolution: int,
                    resolution_scale: float = 1.0) -> tuple[int, int]:
    """The -1 -> 1600 px cap ladder (utils/camera_utils.py:22-39)."""
    if resolution in (1, 2, 4, 8):
        return (round(orig_w / (resolution_scale * resolution)),
                round(orig_h / (resolution_scale * resolution)))
    if resolution == -1:
        global_down = orig_w / 1600 if orig_w > 1600 else 1
    else:
        global_down = orig_w / resolution
    scale = float(global_down) * float(resolution_scale)
    return int(orig_w / scale), int(orig_h / scale)


def camera_to_json(cam_id: int, cam: Camera) -> dict:
    """cameras.json entry: camera-to-world position and rotation, focal
    lengths in pixels."""
    c2w = np.linalg.inv(graphics.world_to_view(cam.R, cam.T).astype(np.float64))
    return {
        "id": cam_id,
        "img_name": cam.image_name,
        "width": cam.width,
        "height": cam.height,
        "position": c2w[:3, 3].tolist(),
        "rotation": [r.tolist() for r in c2w[:3, :3]],
        "fy": graphics.fov2focal(cam.fovy, cam.height),
        "fx": graphics.fov2focal(cam.fovx, cam.width),
    }


def camera_from_json(entry: dict) -> Camera:
    """Inverse of `camera_to_json`: the edit runtime's camera source."""
    c2w = np.eye(4)
    c2w[:3, :3] = np.array(entry["rotation"])
    c2w[:3, 3] = np.array(entry["position"])
    w2c = np.linalg.inv(c2w)
    w, h = entry["width"], entry["height"]
    return Camera(
        uid=entry.get("id", 0), R=w2c[:3, :3].T, T=w2c[:3, 3],
        fovx=graphics.focal2fov(entry["fx"], w),
        fovy=graphics.focal2fov(entry["fy"], h),
        image=None, image_name=entry.get("img_name", ""), width=w, height=h)
