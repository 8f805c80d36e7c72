"""Interactive model viewer (port of `gaussianmesh_tpu/cli/viewer.py`; the HTTP
counterpart of the reference's SIBR remote viewer).

    python -m gaussianmesh_tpu_torch.cli.viewer -m <model_dir> \
        [--gaussian_ply <trained.ply>] [--bg_ply <bg.ply>] \
        [--origin_mesh mesh.obj --deformed_mesh def.obj] \
        [--port 6017] [--width 800 --height 600] [--device cpu]

Serves an orbit-control page at http://host:port/ that renders the trained
model live; with --deformed_mesh the deformed state is shown. Renders on
CUDA unless `--device cpu` is given, and raises without a card.
"""

from __future__ import annotations

import os
import time

import numpy as np

from gaussianmesh_tpu_torch import config as cfg_mod, resolve_device
from gaussianmesh_tpu_torch.cli.common import base_parser


def build_server(argv=None):
    """The parsed command line's `ViewerServer`, not started yet."""
    parser = base_parser("Interactive HTTP viewer (PyTorch + CUDA)")
    parser.add_argument("--gaussian_ply", type=str, default=None,
                        help="foreground ply (default: latest "
                             "point_cloud/iteration_*/point_cloud.ply)")
    parser.add_argument("--bg_ply", type=str, default=None)
    parser.add_argument("--origin_mesh", type=str, default=None)
    parser.add_argument("--deformed_mesh", type=str, default=None)
    parser.add_argument("--port", type=int, default=6017)
    parser.add_argument("--host", type=str, default="127.0.0.1")
    parser.add_argument("--width", type=int, default=800)
    parser.add_argument("--height", type=int, default=600)
    parser.add_argument("--white_bg", action="store_true")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    groups = cfg_mod.load_combined(args.model_path or "", args)
    model, rt = groups["model"], groups["runtime"]

    from gaussianmesh_tpu_torch.edit.runtime import SceneEditor
    from gaussianmesh_tpu_torch.ops.rasterize import RasterizerConfig
    from gaussianmesh_tpu_torch.scene import Scene
    from gaussianmesh_tpu_torch.viewer import ViewerServer, editor_render_fn

    ply = args.gaussian_ply
    if ply is None:
        it = Scene.find_latest_iteration(model.model_path)
        ply = os.path.join(model.model_path, "point_cloud", f"iteration_{it}",
                           "point_cloud.ply")
    if args.origin_mesh:
        editor = SceneEditor(bg_ply_path=args.bg_ply, max_sh_degree=model.sh_degree,
                             device=device)
        editor.add_object(ply, args.origin_mesh, name="object")
        if args.deformed_mesh:
            editor.deform_object("object", args.deformed_mesh)
        center = editor.objects["object"].pos0.mean(0).cpu().numpy()
    else:
        # no proxy mesh: serve the Gaussians as a frozen model (the editor's
        # background path renders a plain Gaussian PLY as it is)
        editor = SceneEditor(bg_ply_path=ply, max_sh_degree=model.sh_degree,
                             device=device)
        alive = editor._bg.alive
        center = (editor._bg.xyz[alive].mean(0).cpu().numpy() if bool(alive.any())
                  else np.zeros(3))

    cfg = RasterizerConfig.from_runtime(rt, args.width, args.height)
    bg = (1.0, 1.0, 1.0) if args.white_bg else (0.0, 0.0, 0.0)
    return ViewerServer(editor_render_fn(editor, cfg, bg), width=args.width,
                        height=args.height, host=args.host, port=args.port,
                        center=tuple(np.asarray(center, float)))


def main(argv=None) -> None:
    server = build_server(argv).start()
    print(f"[viewer] serving http://{server.host}:{server.port}/ (ctrl-c to stop)")
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        server.stop()


if __name__ == "__main__":
    main()
