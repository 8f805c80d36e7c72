"""Deformation playback over a (data, tile) process mesh (port of
`gaussianmesh_tpu/parallel/edit_step.py` on `torch.distributed`).

Per call, the data axis plays FRAMES: each data group deforms and renders
its own frame of the mesh sequence. Within a data group the tile axis cuts
the image into bands: every rank runs the deformation (vertex-sized work)
and the preprocess, then bins, sorts and blends (K1) its band alone. The
static objects and the background are evaluated once, when the function is
made, for its fixed camera. One `all_gather` over the world gives every
rank the (F, 3, H_valid, W) frames.
"""

from __future__ import annotations

import torch

from gaussianmesh_tpu_torch.edit.runtime import _bg_tensor, deformed_object_arrays
from gaussianmesh_tpu_torch.models.render import concat_arrays
from gaussianmesh_tpu_torch.ops.rasterize import RasterizerConfig
from gaussianmesh_tpu_torch.parallel import sharding
from gaussianmesh_tpu_torch.parallel.sharding import ProcessMesh
from gaussianmesh_tpu_torch.parallel.train_step import rasterize_band
from gaussianmesh_tpu_torch.utils.graphics import CameraArrays


def make_sharded_playback_fn(mesh: ProcessMesh, editor, obj_name: str,
                             cam_arrays: CameraArrays, cfg: RasterizerConfig,
                             bg_color=None, height_valid: int | None = None):
    """-> playback(v_frames (F, V, 3)) -> (F, 3, H_valid, W), with F =
    mesh.n_data frames per call, on every rank.

    `editor` is a `SceneEditor`; object `obj_name` deforms (one object per
    call, as the reference's edit.py:38), every other object and the
    background render at their current state, composited as
    `SceneEditor.render` does. cfg is the image's own size; the tile grid
    is padded with whole rows to split into the bands, and rows from
    `height_valid` (default cfg.height) on are cut."""
    gy_local = sharding.band_rows(sharding.padded_grid_y(cfg.height, mesh.n_tile),
                                  mesh.n_tile)
    y0 = mesh.tile_index * gy_local
    h_valid = cfg.height if height_valid is None else height_valid
    obj = editor.objects[obj_name]
    bg = _bg_tensor(bg_color, obj.device)

    static = None
    with torch.no_grad():
        parts = [o.arrays(cam_arrays) for name, o in editor.objects.items()
                 if name != obj_name]
        bg_a = editor._bg_arrays(cam_arrays)
        parts += [] if bg_a is None else [bg_a]
        for a in parts:
            static = a if static is None else concat_arrays(static, a)

    @torch.no_grad()
    def playback(v_frames) -> torch.Tensor:
        if len(v_frames) != mesh.n_data:
            raise ValueError(f"{len(v_frames)} frames for {mesh.n_data} data groups")
        arrays = deformed_object_arrays(obj, v_frames[mesh.data_index], cam_arrays)
        if static is not None:
            arrays = concat_arrays(arrays, static)
        band = rasterize_band(arrays, cam_arrays, cfg, gy_local, y0, bg).color
        bands = sharding.all_gather(band, mesh.world_group)
        frames = [torch.cat(bands[d * mesh.n_tile:(d + 1) * mesh.n_tile], -2)
                  for d in range(mesh.n_data)]
        return torch.stack(frames)[:, :, :h_valid, :]

    return playback
