"""Render the train / test views of a trained model (port of
`gaussianmesh_tpu/cli/render.py`; the reference render.py).

    python -m gaussianmesh_tpu_torch.cli.render -m <model_dir> [--iteration N] \
        [--skip_train] [--skip_test] [--with_bg] [--device cpu]

Runs on CUDA unless `--device cpu` is given, and raises without a card.
Reads a model directory written by either package (`cfg_args.json` names
the dataset). `--with_bg` composites the iteration's bg_point_cloud.ply
after the foreground (the JAX command line's order). Writes
<model_dir>/<split>/ours_<N>/{renders,gt}/<index>.png through the port's
PNG codec.
"""

from __future__ import annotations

import os

import torch

from gaussianmesh_tpu_torch import config as cfg_mod
from gaussianmesh_tpu_torch.cli.common import base_parser, save_image


def main(argv=None) -> None:
    parser = base_parser("Render a trained model (PyTorch + CUDA)")
    parser.add_argument("--iteration", type=int, default=-1)
    parser.add_argument("--skip_train", action="store_true")
    parser.add_argument("--skip_test", action="store_true")
    parser.add_argument("--with_bg", action="store_true",
                        help="composite the trained background model")
    args = parser.parse_args(argv)

    groups = cfg_mod.load_combined(args.model_path or "", args)
    model, rt = groups["model"], groups["runtime"]

    from gaussianmesh_tpu_torch import resolve_device
    from gaussianmesh_tpu_torch.io import gaussian_ply
    from gaussianmesh_tpu_torch.models import render as render_mod
    from gaussianmesh_tpu_torch.ops.rasterize import RasterizerConfig
    from gaussianmesh_tpu_torch.scene import Scene

    device = resolve_device(args.device)
    it = args.iteration
    if it == -1:
        it = Scene.find_latest_iteration(model.model_path)
    pc_dir = os.path.join(model.model_path, "point_cloud", f"iteration_{it}")
    fg, _ = gaussian_ply.load_mesh_gaussian_ply(
        os.path.join(pc_dir, "point_cloud.ply"), max_sh_degree=model.sh_degree,
        device=device)
    bg_model = None
    if args.with_bg:
        bg_ply = os.path.join(pc_dir, "bg_point_cloud.ply")
        if not os.path.exists(bg_ply):
            raise SystemExit(f"--with_bg: {bg_ply} not found (run train_bg, or pick "
                             "the iteration it saved at)")
        bg_model = gaussian_ply.load_gaussian_ply(bg_ply, max_sh_degree=model.sh_degree,
                                                  device=device)

    scene = Scene(model, shuffle=False)
    bg_color = torch.full((3,), 1.0 if model.white_background else 0.0, device=device)

    @torch.no_grad()
    def render_set(name: str, cams) -> None:
        base = os.path.join(model.model_path, name, f"ours_{it}")
        for idx, cam in enumerate(cams):
            ca = cam.arrays(device)
            cfg = RasterizerConfig.from_runtime(rt, cam.width, cam.height)
            arrays = render_mod.mesh_model_arrays(fg, ca, model.sh_degree)
            if bg_model is not None:
                arrays = render_mod.concat_arrays(arrays, render_mod.gaussian_model_arrays(
                    bg_model, ca, model.sh_degree))
            out = render_mod.render(arrays, ca, cfg, bg_color)
            save_image(os.path.join(base, "renders", f"{idx:05d}.png"), out.color)
            if cam.image is not None:
                save_image(os.path.join(base, "gt", f"{idx:05d}.png"), cam.image)
        if cams:
            print(f"[render] {name}: {len(cams)} views -> {base}")

    if not args.skip_train:
        render_set("train", scene.train_cameras)
    if not args.skip_test:
        render_set("test", scene.test_cameras)


if __name__ == "__main__":
    main()
