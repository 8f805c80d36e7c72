"""Camera path generators for playback (port of
`gaussianmesh_tpu/edit/pose_paths.py`; the reference's edittool/pose_utils.py).

The paths the edit runtime uses: elliptical orbits around a focus point
(generate_ellipse_path / create_circle_cam, edittool/__init__.py:338-382),
spiral paths, spherical sampling and pose jitter, as plain numpy producing
the port's `Camera` objects.
"""

from __future__ import annotations

import math

import numpy as np

from gaussianmesh_tpu_torch.data.cameras import Camera


def _look_at(pos: np.ndarray, target: np.ndarray, up=np.array([0.0, 1.0, 0.0])):
    fwd = target - pos
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(up, fwd)
    if np.linalg.norm(right) < 1e-6:
        right = np.array([1.0, 0.0, 0.0])
    right = right / np.linalg.norm(right)
    up2 = np.cross(fwd, right)
    R = np.stack([right, up2, fwd], axis=1)  # cam-to-world
    T = -R.T @ pos
    return R, T


def ellipse_path(n_frames: int, center: np.ndarray, radii: tuple[float, float],
                 height: float, fovx: float, fovy: float,
                 width: int, height_px: int,
                 target: np.ndarray | None = None) -> list[Camera]:
    """Elliptical orbit at constant height looking at `target`."""
    target = center if target is None else np.asarray(target)
    cams = []
    for i in range(n_frames):
        th = 2 * math.pi * i / n_frames
        pos = np.asarray(center) + np.array(
            [radii[0] * math.cos(th), height, radii[1] * math.sin(th)])
        R, T = _look_at(pos, target)
        cams.append(Camera(uid=i, R=R, T=T, fovx=fovx, fovy=fovy, image=None,
                           width=width, height=height_px,
                           image_name=f"ellipse_{i:04d}"))
    return cams


def spiral_path(n_frames: int, center: np.ndarray, radius: float,
                height_range: tuple[float, float], turns: float,
                fovx: float, fovy: float, width: int, height_px: int) -> list[Camera]:
    cams = []
    for i in range(n_frames):
        t = i / max(n_frames - 1, 1)
        th = 2 * math.pi * turns * t
        h = height_range[0] + (height_range[1] - height_range[0]) * t
        pos = np.asarray(center) + np.array(
            [radius * math.cos(th), h, radius * math.sin(th)])
        R, T = _look_at(pos, np.asarray(center))
        cams.append(Camera(uid=i, R=R, T=T, fovx=fovx, fovy=fovy, image=None,
                           width=width, height=height_px,
                           image_name=f"spiral_{i:04d}"))
    return cams


def spherical_sample_path(n_frames: int, center: np.ndarray, radius: float,
                          fovx: float, fovy: float, width: int,
                          height_px: int, elevation_range=(0.1, 1.2)) -> list[Camera]:
    """Fibonacci-lattice sampling of viewpoints on a sphere cap."""
    cams = []
    golden = math.pi * (3 - math.sqrt(5))
    for i in range(n_frames):
        el = elevation_range[0] + (elevation_range[1] - elevation_range[0]) * (
            i / max(n_frames - 1, 1))
        az = i * golden
        pos = np.asarray(center) + radius * np.array([
            math.cos(el) * math.cos(az), math.sin(el),
            math.cos(el) * math.sin(az)])
        R, T = _look_at(pos, np.asarray(center))
        cams.append(Camera(uid=i, R=R, T=T, fovx=fovx, fovy=fovy, image=None,
                           width=width, height=height_px,
                           image_name=f"sphere_{i:04d}"))
    return cams


def jitter_poses(cams: list[Camera], std_pos: float = 0.02,
                 seed: int = 0) -> list[Camera]:
    """Small positional jitter (gaussian_poses analog, pose_utils.py:446)."""
    rng = np.random.default_rng(seed)
    out = []
    for c in cams:
        T = c.T + rng.normal(scale=std_pos, size=3)
        out.append(Camera(uid=c.uid, R=c.R, T=T, fovx=c.fovx, fovy=c.fovy,
                          image=None, width=c.width, height=c.height,
                          image_name=c.image_name + "_j"))
    return out
