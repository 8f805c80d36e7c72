"""Deformation playback from the command line (port of
`gaussianmesh_tpu/cli/edit.py`, the reference's edit.py without its broken
render_origin import).

    python -m gaussianmesh_tpu_torch.cli.edit -m <model_dir> \
        --gaussian_ply <trained.ply> --origin_mesh <mesh.obj> \
        --deformed_mesh <deformed.obj> [--bg_ply <bg.ply>] \
        [--frames <mesh1.obj mesh2.obj ...>] --out <dir> [--device cpu]

Runs on CUDA unless `--device cpu` is given, and raises without a card.
Cameras come from <model_dir>/cameras.json; the model directory's
`cfg_args.json`, written by either package, supplies the SH degree and
the rasterizer capacities. One PNG per (frame, camera), f<frame>_c<camera>.png.
"""

from __future__ import annotations

import os
import time

import numpy as np

from gaussianmesh_tpu_torch import config as cfg_mod, resolve_device
from gaussianmesh_tpu_torch.cli.common import base_parser, save_image


def main(argv=None) -> None:
    parser = base_parser("Deformation playback (PyTorch + CUDA)")
    parser.add_argument("--gaussian_ply", type=str, required=True)
    parser.add_argument("--origin_mesh", type=str, required=True)
    parser.add_argument("--deformed_mesh", type=str, default=None)
    parser.add_argument("--frames", nargs="*", type=str, default=[],
                        help="mesh sequence for animation playback")
    parser.add_argument("--bg_ply", type=str, default=None)
    parser.add_argument("--out", type=str, default="edit_output")
    parser.add_argument("--camera_index", type=int, default=0)
    parser.add_argument("--all_cameras", action="store_true")
    parser.add_argument("--orbit", type=int, default=0,
                        help="render an N-frame ellipse orbit around the "
                             "object instead of dataset cameras "
                             "(create_circle_cam, edittool/__init__.py:338)")
    args = parser.parse_args(argv)
    frames = args.frames or ([args.deformed_mesh] if args.deformed_mesh else [])
    if not frames:
        parser.error("provide --deformed_mesh or --frames")
    device = resolve_device(args.device)

    groups = cfg_mod.load_combined(args.model_path or "", args)
    model, rt = groups["model"], groups["runtime"]

    from gaussianmesh_tpu_torch.edit.runtime import SceneEditor
    from gaussianmesh_tpu_torch.ops.rasterize import RasterizerConfig

    editor = SceneEditor(bg_ply_path=args.bg_ply, max_sh_degree=model.sh_degree,
                         device=device)
    editor.add_object(args.gaussian_ply, args.origin_mesh, name="object")

    cams = SceneEditor.cameras_from_json(model.model_path)
    if args.orbit > 0:
        from gaussianmesh_tpu_torch.edit import pose_paths
        ref = cams[args.camera_index]
        # orbit at the reference camera's distance and height around the object
        center = editor.objects["object"].pos0.mean(0).cpu().numpy()
        cc = np.asarray(ref.camera_center)
        r = float(np.linalg.norm((cc - center)[[0, 2]]))
        sel = pose_paths.ellipse_path(args.orbit, center, (r, r),
                                      float(cc[1] - center[1]), ref.fovx,
                                      ref.fovy, ref.width, ref.height,
                                      target=center)
    else:
        sel = cams if args.all_cameras else [cams[args.camera_index]]

    def cfg_for(cam):
        return RasterizerConfig.from_runtime(rt, cam.width, cam.height)

    os.makedirs(args.out, exist_ok=True)
    t_start = time.time()
    n_images = overflow = 0
    for fi, frame_mesh in enumerate(frames):
        editor.deform_object("object", frame_mesh)
        for ci, cam in enumerate(sel):
            out = editor.render(cam, cfg_for(cam))
            save_image(os.path.join(args.out, f"f{fi:04d}_c{ci:03d}.png"), out.color)
            overflow += int(out.tile_overflow) + int(out.rect_overflow)
            n_images += 1
    dt = time.time() - t_start
    print(f"[edit] {n_images} frames in {dt:.2f}s ({n_images / dt:.1f} fps incl. "
          f"IO) on {device}; tile + rect overflow {overflow}")


if __name__ == "__main__":
    main()
