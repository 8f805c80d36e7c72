"""Deformation playback (port of `gaussianmesh_tpu/edit/runtime.py`).

An `ObjectDeformer` binds a trained mesh-Gaussian PLY to its origin proxy
mesh: each Gaussian's triangle comes from the saved `fid`, its weights are
the area barycentric coordinates of its on-surface projection. Per frame,
the per-vertex deformation-gradient factors (R, S) of the deformed mesh
(`edit/deform.py`) are interpolated per Gaussian:

    dpos = sum_i w_i (v'_i - v_i)       R^ = sum_i w_i R_i
    S^   = sum_i w_i S_i                A  = R^ S^
    cov' = A cov A^T                    pos' = pos + dpos

so a Gaussian off its face moves with the surface point it projects to.
This is the JAX package's A cov A^T: the reference transposes its
interpolated rotation (edittool/__init__.py:121-122), which reads as
compensation for its native library's flattening order; a rigid rotation
Q must carry cov to Q cov Q^T. SH is evaluated at the view direction
rotated into the undeformed frame, R^^T d, with the blended R^ as it is
(not re-orthonormalised), as the JAX package does.

Playback is forward only: everything here runs without autograd and ends
in `rasterize` / `rasterize_composite`, whose blend is K1 on the card. A
frame function returns the image with the frame's overflow counters
(`PlaybackFrame`); `playback_sequence` is a loop of such frames.
"""

from __future__ import annotations

import json
import os
from typing import Callable, NamedTuple

import torch

from gaussianmesh_tpu_torch import resolve_device
from gaussianmesh_tpu_torch.data.cameras import Camera, camera_from_json
from gaussianmesh_tpu_torch.edit.deform import MeshDeformer
from gaussianmesh_tpu_torch.io import gaussian_ply, mesh as mesh_io
from gaussianmesh_tpu_torch.models.render import (GaussianArrays, concat_arrays,
                                                  gaussian_model_arrays)
from gaussianmesh_tpu_torch.ops.rasterize import (RasterizeOut, RasterizerConfig,
                                                  precompute_static_pairs,
                                                  rasterize, rasterize_composite)
from gaussianmesh_tpu_torch.utils import maths, sh as sh_utils
from gaussianmesh_tpu_torch.utils.graphics import CameraArrays


class PlaybackFrame(NamedTuple):
    """One played frame, or a sequence of them stacked on a leading axis."""
    color: torch.Tensor          # (3, H, W)
    tile_overflow: torch.Tensor  # () int32
    rect_overflow: torch.Tensor  # () int32; a composite frame's includes the
                                 # static precompute's
    num_rendered: torch.Tensor   # () int32


def _frame(out: RasterizeOut) -> PlaybackFrame:
    return PlaybackFrame(out.color, out.tile_overflow, out.rect_overflow,
                         out.num_rendered)


def _sh_degree(features_rest: torch.Tensor) -> int:
    return int(round((features_rest.shape[1] + 1) ** 0.5)) - 1


def barycentric_weights(p: torch.Tensor, v1: torch.Tensor, v2: torch.Tensor,
                        v3: torch.Tensor) -> torch.Tensor:
    """Area barycentric coordinates (..., 3) of points on or near their
    triangles (edittool/general_utils.py:73-88)."""
    def area2(a, b, c):
        return torch.linalg.vector_norm(torch.linalg.cross(b - a, c - a), dim=-1)

    total = torch.clamp(area2(v1, v2, v3), min=1e-12)
    w = torch.stack([area2(p, v2, v3), area2(p, v1, v3), area2(p, v1, v2)],
                    dim=-1) / total[..., None]
    return w / (w[..., 0] + w[..., 1] + w[..., 2])[..., None]


def transfer_deformation(v_ref: torch.Tensor, v_def: torch.Tensor,
                         rot: torch.Tensor, shear: torch.Tensor,
                         gaussian_tris: torch.Tensor, weights: torch.Tensor,
                         pos0: torch.Tensor, cov6_0: torch.Tensor
                         ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Barycentric transfer of per-vertex deformation to N Gaussians ->
    (pos (N, 3), cov6 (N, 6), R^ (N, 3, 3)). The per-vertex fields ride one
    (V, 21) table (dv, R and S row-major) through one row gather."""
    vtab = torch.cat([v_def - v_ref, rot.reshape(-1, 9), shear.reshape(-1, 9)],
                     dim=-1)
    g = vtab[gaussian_tris]                                   # (N, 3, 21)
    blended = (weights[:, 0, None] * g[:, 0] + weights[:, 1, None] * g[:, 1]
               + weights[:, 2, None] * g[:, 2])               # (N, 21)
    r_hat = blended[:, 3:12].reshape(-1, 3, 3)
    a = maths.mat_mul(r_hat, blended[:, 12:21].reshape(-1, 3, 3))
    return pos0 + blended[:, 0:3], maths.congruence_sym6(a, cov6_0), r_hat


class ObjectDeformer:
    """A trained mesh-Gaussian object bound to its origin proxy mesh, on
    `device` (CUDA unless the caller asks for the CPU)."""

    @torch.no_grad()
    def __init__(self, gaussian_ply_path: str, origin_mesh_path: str,
                 name: str | None = None,
                 device: str | torch.device | None = None):
        self.device = resolve_device(device)
        self.name = name or origin_mesh_path
        model, load_xyz = gaussian_ply.load_mesh_gaussian_ply(
            gaussian_ply_path, device=self.device)
        self.sh_degree = _sh_degree(model.features_rest)
        self.n = load_xyz.shape[0]
        self.pos0 = torch.tensor(load_xyz, device=self.device)
        self.proj0 = model.get_proj_xyz()
        self.cov6_0 = model.get_covariance6()
        self.opacity = model.get_opacity()[:, 0]
        self.features = model.get_features()                  # (N, K, 3)

        v, f = mesh_io.read_triangle_mesh(origin_mesh_path)
        self.deformer = MeshDeformer(v, f, device=self.device)
        tris = f[model.fid[:, 0].cpu().numpy()]               # (N, 3) vertex ids
        self.gaussian_tris = torch.tensor(tris, dtype=torch.int64, device=self.device)
        tri_v = torch.tensor(v[tris], device=self.device)     # (N, 3, 3)
        self.weights = barycentric_weights(self.proj0, tri_v[:, 0], tri_v[:, 1],
                                           tri_v[:, 2])
        self.reset()

    def reset(self) -> None:
        self.pos, self.cov6 = self.pos0, self.cov6_0
        self.rot = torch.eye(3, device=self.device).expand(self.n, 3, 3)

    def _vertices(self, v_def) -> torch.Tensor:
        if isinstance(v_def, str):
            v_def, _ = mesh_io.read_triangle_mesh(v_def)
        return torch.as_tensor(v_def, dtype=torch.float32, device=self.device)

    @torch.no_grad()
    def transfer(self, v_def) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Deformed vertices (a mesh path, an array or a tensor) ->
        (pos, cov6, R^) of the Gaussians."""
        v_def = self._vertices(v_def)
        d = self.deformer
        rot, shear = d.get_rs(v_def)
        return transfer_deformation(d.v_ref, v_def, rot, shear, self.gaussian_tris,
                                    self.weights, self.pos0, self.cov6_0)

    def deform(self, v_def) -> None:
        self.pos, self.cov6, self.rot = self.transfer(v_def)

    @torch.no_grad()
    def arrays(self, cam: CameraArrays) -> GaussianArrays:
        """Rasterizer inputs of the current state, SH at R^^T d."""
        return _object_arrays(self, self.pos, self.cov6, self.rot, cam)


def _object_arrays(obj: ObjectDeformer, pos, cov6, r_hat, cam) -> GaussianArrays:
    d = pos - cam.campos
    d = d / torch.clamp(torch.linalg.vector_norm(d, dim=-1, keepdim=True), min=1e-12)
    d_rot = maths.mat_vec(r_hat.transpose(-1, -2), d)
    rgb = torch.clamp(sh_utils.eval_sh(obj.features, d_rot, obj.sh_degree) + 0.5,
                      min=0.0)
    return GaussianArrays(xyz=pos, cov6=cov6, opacity=obj.opacity, rgb=rgb,
                          active=torch.ones(obj.n, dtype=torch.bool,
                                            device=pos.device))


def deformed_object_arrays(obj: ObjectDeformer, v_def,
                           cam_arrays: CameraArrays) -> GaussianArrays:
    """The per-frame deformation math as a function of the deformed
    vertices: one-ring deformation gradients -> barycentric transfer -> SH
    at the rotated view directions. Leaves `obj`'s state as it was."""
    return _object_arrays(obj, *obj.transfer(v_def), cam_arrays)


def _bg_tensor(bg_color, device) -> torch.Tensor:
    if bg_color is None:
        return torch.zeros(3, device=device)
    return torch.as_tensor(bg_color, dtype=torch.float32, device=device)


class SceneEditor:
    """Objects (in insertion order) and an optional background model: the
    reference's SceneVisualTool / ObjectVisualTool. `max_sh_degree` is the
    background PLY's SH degree (None: read from the file)."""

    def __init__(self, bg_ply_path: str | None = None,
                 max_sh_degree: int | None = 3,
                 device: str | torch.device | None = None):
        self.device = resolve_device(device)
        self.objects: dict[str, ObjectDeformer] = {}
        self._bg = None
        if bg_ply_path:
            self._bg = gaussian_ply.load_gaussian_ply(
                bg_ply_path, max_sh_degree=max_sh_degree, device=self.device)
            self._bg_sh_degree = _sh_degree(self._bg.features_rest)

    def add_object(self, gaussian_ply_path: str, origin_mesh_path: str,
                   name: str | None = None) -> ObjectDeformer:
        obj = ObjectDeformer(gaussian_ply_path, origin_mesh_path, name,
                             device=self.device)
        self.objects[obj.name] = obj
        return obj

    def deform_object(self, name: str, deformed_mesh) -> None:
        self.objects[name].deform(deformed_mesh)

    @torch.no_grad()
    def _bg_arrays(self, cam: CameraArrays) -> GaussianArrays | None:
        if self._bg is None:
            return None
        return gaussian_model_arrays(self._bg, cam, self._bg_sh_degree)

    def _camera(self, cam: Camera | CameraArrays) -> CameraArrays:
        return cam.arrays(self.device) if isinstance(cam, Camera) else cam

    def arrays(self, cam: Camera | CameraArrays) -> GaussianArrays:
        """The scene's rasterizer inputs: the objects' in insertion order,
        then the background's."""
        cam = self._camera(cam)
        parts = [obj.arrays(cam) for obj in self.objects.values()]
        bg = self._bg_arrays(cam)
        parts += [] if bg is None else [bg]
        if not parts:
            raise ValueError("SceneEditor: no objects and no background model; "
                             "add_object() or construct with bg_ply_path first")
        out = parts[0]
        for a in parts[1:]:
            out = concat_arrays(out, a)
        return out

    @torch.no_grad()
    def render(self, cam: Camera | CameraArrays, cfg: RasterizerConfig,
               bg_color=None) -> RasterizeOut:
        cam = self._camera(cam)
        a = self.arrays(cam)
        return rasterize(a.xyz, a.cov6, a.opacity, a.rgb,
                         _bg_tensor(bg_color, self.device), cam, cfg,
                         active_mask=a.active)

    @staticmethod
    def cameras_from_json(model_path: str) -> list[Camera]:
        """<model>/cameras.json (edittool/__init__.py:300-337)."""
        with open(os.path.join(model_path, "cameras.json")) as f:
            return [camera_from_json(e) for e in json.load(f)]


FrameFn = Callable[[torch.Tensor], PlaybackFrame]


def make_playback_fn(obj: ObjectDeformer, cam_arrays: CameraArrays,
                     cfg: RasterizerConfig, bg_color=None) -> FrameFn:
    """The per-frame hot path of config 3: deformed vertices (V, 3) in,
    `PlaybackFrame` out (deformation, transfer, SH, rasterize)."""
    bg = _bg_tensor(bg_color, obj.device)

    @torch.no_grad()
    def frame_fn(v_def) -> PlaybackFrame:
        a = deformed_object_arrays(obj, v_def, cam_arrays)
        return _frame(rasterize(a.xyz, a.cov6, a.opacity, a.rgb, bg, cam_arrays,
                                cfg, active_mask=a.active))

    return frame_fn


def playback_sequence(obj: ObjectDeformer, cam_arrays: CameraArrays,
                      cfg: RasterizerConfig, vertex_frames: torch.Tensor,
                      bg_color=None) -> PlaybackFrame:
    """A mesh sequence (F, V, 3) -> `PlaybackFrame` of (F, 3, H, W) images
    and (F,) counters: a loop of `make_playback_fn`'s frames on the device."""
    frame_fn = make_playback_fn(obj, cam_arrays, cfg, bg_color)
    frames = [frame_fn(v) for v in vertex_frames]
    return PlaybackFrame(*(torch.stack(x) for x in zip(*frames)))


def make_composite_playback_fn(editor: SceneEditor, obj_name: str,
                               cam_arrays: CameraArrays, cfg: RasterizerConfig,
                               bg_color=None,
                               static_cfg: RasterizerConfig | None = None
                               ) -> FrameFn:
    """Config 5: object `obj_name` deforms in a scene of the editor's other
    objects and background. Their pair domain is expanded once, here, for
    this camera (`precompute_static_pairs`, with `static_cfg`'s capacities
    where given) and merged into each frame's (`rasterize_composite`). The
    frame equals `editor.render` of the deformed scene bit for bit when
    `obj_name` is the first object added (the same emission order) and no
    capacity clips. Each frame's `rect_overflow` includes the static part's.
    A scene of one object gets `make_playback_fn`'s frame."""
    obj = editor.objects[obj_name]
    parts = [o.arrays(cam_arrays) for name, o in editor.objects.items()
             if name != obj_name]
    bg_a = editor._bg_arrays(cam_arrays)
    parts += [] if bg_a is None else [bg_a]
    if not parts:
        return make_playback_fn(obj, cam_arrays, cfg, bg_color)
    if static_cfg is not None and static_cfg.grid != cfg.grid:
        raise ValueError(f"static_cfg's tile grid {static_cfg.grid} is not "
                         f"the frame's {cfg.grid}")
    static_arrays = parts[0]
    for a in parts[1:]:
        static_arrays = concat_arrays(static_arrays, a)
    static = precompute_static_pairs(
        static_arrays.xyz, static_arrays.cov6, static_arrays.opacity,
        static_arrays.rgb, cam_arrays, static_cfg or cfg,
        active_mask=static_arrays.active)
    bg = _bg_tensor(bg_color, obj.device)

    @torch.no_grad()
    def frame_fn(v_def) -> PlaybackFrame:
        a = deformed_object_arrays(obj, v_def, cam_arrays)
        return _frame(rasterize_composite(a.xyz, a.cov6, a.opacity, a.rgb, bg,
                                          cam_arrays, cfg, static,
                                          active_mask=a.active))

    return frame_fn
