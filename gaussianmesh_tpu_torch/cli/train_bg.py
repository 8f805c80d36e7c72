"""Train the background model beside the frozen foreground (port of
`gaussianmesh_tpu/cli/train_bg.py`; the reference train_bg_gaussian.py).

    python -m gaussianmesh_tpu_torch.cli.train_bg -s <data> -m <model_dir> \
        [--mesh_gaussian_ply <path>] [--iterations 30000] [--device cpu]

Runs on CUDA unless `--device cpu` is given, and raises without a card.
The groups come from <model_dir>/cfg_args.json (either package's) under
the flags given. The foreground is the newest iteration's point_cloud.ply
unless `--mesh_gaussian_ply` names one; the background initialises from
the dataset's SfM points and is saved as bg_point_cloud.ply at each save
iteration and the last.
"""

from __future__ import annotations

import os

from gaussianmesh_tpu_torch import config as cfg_mod
from gaussianmesh_tpu_torch.cli.common import base_parser


def main(argv=None):
    """-> the `BgTrainer` at the end of training."""
    parser = base_parser("Train background Gaussians (PyTorch + CUDA)")
    parser.add_argument("--mesh_gaussian_ply", type=str, default=None)
    parser.add_argument("--save_iterations", nargs="+", type=int,
                        default=[7_000, 30_000])
    parser.add_argument("--remove_neighbor_gaussian_iterations", nargs="+",
                        type=int, default=[1_000, 10_000])
    args = parser.parse_args(argv)

    groups = cfg_mod.load_combined(args.model_path or "", args)
    model, opt, rt = groups["model"], groups["optimization"], groups["runtime"]

    from gaussianmesh_tpu_torch import resolve_device
    from gaussianmesh_tpu_torch.io import gaussian_ply
    from gaussianmesh_tpu_torch.scene import Scene
    from gaussianmesh_tpu_torch.train.bg_trainer import BgTrainer
    from gaussianmesh_tpu_torch.train.trainer import DeviceDataset
    from gaussianmesh_tpu_torch.utils.logging import TrainLogger

    device = resolve_device(args.device)
    fg_ply = args.mesh_gaussian_ply
    if fg_ply is None:
        it = Scene.find_latest_iteration(model.model_path)
        fg_ply = os.path.join(model.model_path, "point_cloud", f"iteration_{it}",
                              "point_cloud.ply")
    print(f"[train_bg] frozen foreground: {fg_ply}")
    fg, _ = gaussian_ply.load_mesh_gaussian_ply(fg_ply, max_sh_degree=model.sh_degree,
                                                device=device)

    scene = Scene(model, is_exist_bg=True, seed=rt.seed)
    ds = DeviceDataset.from_cameras(scene.train_cameras, device=device)
    pcd = scene.info.point_cloud
    trainer = BgTrainer(fg, pcd.points, pcd.colors, ds, opt, rt,
                        spatial_lr_scale=scene.cameras_extent,
                        white_background=model.white_background,
                        max_sh_degree=model.sh_degree,
                        remove_neighbor_iterations=tuple(
                            args.remove_neighbor_gaussian_iterations))
    trainer.logger = TrainLogger(model.model_path)
    print(f"[train_bg] {pcd.points.shape[0]} SfM points -> capacity "
          f"{trainer.model.capacity}; {fg.capacity} frozen foreground Gaussians; "
          f"{device}")

    def cb(m):
        print(f"  iter {m['iter']:>6d}  loss {m['loss']:.5f}  "
              f"n {m['n_alive']}  {m['elapsed']:.0f}s", flush=True)

    prev = trainer.global_it
    for b in sorted({b for b in args.save_iterations if b <= opt.iterations}
                    | {opt.iterations}):
        if b <= prev:
            continue
        trainer.train(iterations=b - prev, log_every=200, callback=cb)
        prev = b
        print(f"[ITER {b}] Saving bg Gaussians")
        trainer.save(scene.iteration_dir(b))
    trainer.logger.close()
    return trainer


if __name__ == "__main__":
    main()
