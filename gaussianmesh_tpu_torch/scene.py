"""Scene orchestration (port of `gaussianmesh_tpu/scene.py`; the reference's
scene/__init__.py `Scene`).

Owns the dataset (COLMAP or Blender, detected as scene/__init__.py:35-41
does), the model-directory layout, and the artifacts written into it, in
the JAX package's layout so a directory written by either package loads in
the other:

  <model_path>/
    cfg_args.json                 (JSON in place of an eval()-able repr)
    cameras.json                  (the reference's schema)
    input.ply                     (the copied SfM points)
    point_cloud/iteration_N/point_cloud.ply      (mesh-bound foreground)
    point_cloud/iteration_N/bg_point_cloud.ply   (vanilla background)
    point_cloud/iteration_N/split_mesh.obj       (subdivided proxy)

`cameras_extent` is the nerf++ radius used for learning-rate scaling and
densification thresholds (dataset_readers.getNerfppNorm:46-67). The
training cameras are shuffled by `np.random.default_rng(seed)`, as the JAX
package shuffles them, so both order them alike.
"""

from __future__ import annotations

import json
import os

import numpy as np

from gaussianmesh_tpu_torch.config import ModelParams
from gaussianmesh_tpu_torch.data import readers
from gaussianmesh_tpu_torch.data.cameras import camera_to_json
from gaussianmesh_tpu_torch.io import ply as ply_io


class Scene:
    def __init__(self, model: ModelParams, is_exist_bg: bool = False,
                 shuffle: bool = True, seed: int = 0):
        self.model_path = model.model_path
        self.info = readers.read_scene(
            model.source_path, images=model.images,
            resolution=model.resolution,
            white_background=model.white_background,
            eval_split=model.eval, is_exist_bg=is_exist_bg)
        self.train_cameras = list(self.info.train_cameras)
        self.test_cameras = list(self.info.test_cameras)
        if shuffle:
            np.random.default_rng(seed).shuffle(self.train_cameras)
        self.cameras_extent = self.info.nerf_norm["radius"]

    def write_static_artifacts(self) -> None:
        os.makedirs(self.model_path, exist_ok=True)
        cams = [camera_to_json(i, c)
                for i, c in enumerate(self.train_cameras + self.test_cameras)]
        with open(os.path.join(self.model_path, "cameras.json"), "w") as f:
            json.dump(cams, f)
        pcd = self.info.point_cloud
        if pcd is not None:
            rgb8 = (np.clip(pcd.colors, 0, 1) * 255).astype(np.uint8)
            ply_io.write_ply(
                os.path.join(self.model_path, "input.ply"),
                {"vertex": {
                    "x": pcd.points[:, 0], "y": pcd.points[:, 1],
                    "z": pcd.points[:, 2],
                    "red": rgb8[:, 0], "green": rgb8[:, 1],
                    "blue": rgb8[:, 2]}})

    def iteration_dir(self, iteration: int) -> str:
        d = os.path.join(self.model_path, "point_cloud", f"iteration_{iteration}")
        os.makedirs(d, exist_ok=True)
        return d

    @staticmethod
    def find_latest_iteration(model_path: str) -> int:
        base = os.path.join(model_path, "point_cloud")
        iters = [int(d.split("_")[-1]) for d in os.listdir(base)
                 if d.startswith("iteration_")]
        if not iters:
            raise FileNotFoundError(f"no saved iterations under {base}")
        return max(iters)
