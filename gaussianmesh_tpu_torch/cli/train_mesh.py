"""Train the mesh-bound foreground model from a dataset on disk (port of
`gaussianmesh_tpu/cli/train_mesh.py`; the reference train_mesh_gaussian.py).

    python -m gaussianmesh_tpu_torch.cli.train_mesh -s <data> -m <out> \
        --input_mesh proxy.obj [--is_exist_bg] [--iterations 30000] [--device cpu]

Runs on CUDA unless `--device cpu` is given, and raises without a card.
Writes the JAX package's model-directory layout (`scene.py`): a directory
written here renders in either package. The flags, boundaries and output
are the JAX command line's: test / save / checkpoint iterations past
`--iterations` are dropped; checkpoints are `chkpnt<N>.ckpt` in the model
directory (`utils/checkpoint.py`), `--start_checkpoint` resumes from one and
`--auto_resume` from the newest. One difference: the test PSNR compares
each render with its image masked onto the constant background, as
`MeshTrainer.eval_psnr` does (the JAX command line compares with the
unmasked image).

On several processes, one per rank, over a (data, tile) mesh or with the
Gaussian table sharded over D ranks:

    torchrun --nproc_per_node N -m gaussianmesh_tpu_torch.cli.train_mesh ... \
        --data_axis D --tile_axis T          (D * T = N)
    torchrun --nproc_per_node N -m gaussianmesh_tpu_torch.cli.train_mesh ... \
        --shard_gaussians N

`parallel.multihost.initialize` joins torchrun's process group first (nccl
on cards, gloo with `--device cpu`); rank 0 alone writes the model
directory and prints, the others wait for each write. With a shard the
checkpoints are per rank, `chkpnt<N>.ckpt.shards/` (`utils/checkpoint.py`),
and `--auto_resume` finds them too.
"""

from __future__ import annotations

import glob
import os
import re

from gaussianmesh_tpu_torch import config as cfg_mod
from gaussianmesh_tpu_torch.cli.common import base_parser


def latest_checkpoint(model_path: str) -> str | None:
    """The chkpnt<N>.ckpt (or per-rank chkpnt<N>.ckpt.shards) with the
    largest N in `model_path`, if any."""
    found = glob.glob(os.path.join(model_path, "chkpnt*.ckpt*"))
    return max(found, key=lambda f: int(re.sub(r"\D", "", os.path.basename(f))),
               default=None)


def main(argv=None):
    """-> the `MeshTrainer` at the end of training."""
    parser = base_parser("Train mesh-bound Gaussians (PyTorch + CUDA)")
    parser.add_argument("--input_mesh", type=str, required=True)
    parser.add_argument("--is_exist_bg", action="store_true", default=False)
    parser.add_argument("--test_iterations", nargs="+", type=int,
                        default=[7_000, 30_000])
    parser.add_argument("--save_iterations", nargs="+", type=int,
                        default=[7_000, 30_000])
    parser.add_argument("--checkpoint_iterations", nargs="+", type=int,
                        default=[])
    parser.add_argument("--start_checkpoint", type=str, default=None)
    parser.add_argument("--auto_resume", action="store_true", default=False,
                        help="resume from the latest chkpnt*.ckpt in the "
                             "model dir (crash recovery)")
    parser.add_argument("--init_target", type=int, default=100_000)
    args = parser.parse_args(argv)

    from gaussianmesh_tpu_torch import resolve_device
    from gaussianmesh_tpu_torch.parallel import multihost

    device = resolve_device(args.device)
    multihost.initialize(backend="gloo" if device.type == "cpu" else None)
    writer = multihost.is_writer()

    model = cfg_mod.extract(cfg_mod.ModelParams, args)
    opt = cfg_mod.extract(cfg_mod.OptimizationParams, args)
    pipe = cfg_mod.extract(cfg_mod.PipelineParams, args)
    rt = cfg_mod.extract(cfg_mod.RuntimeParams, args)
    if not model.model_path:
        model = cfg_mod.ModelParams(**{**model.__dict__, "model_path": os.path.join(
            "output", "mesh_gaussian")})
    if writer:
        cfg_mod.save_cfg(model.model_path, {"model": model, "pipeline": pipe,
                                            "optimization": opt, "runtime": rt})

    from gaussianmesh_tpu_torch.io import mesh as mesh_io
    from gaussianmesh_tpu_torch.scene import Scene
    from gaussianmesh_tpu_torch.train.trainer import DeviceDataset, MeshTrainer
    from gaussianmesh_tpu_torch.utils.logging import TrainLogger

    log = print if writer else (lambda *a, **k: None)
    scene = Scene(model, is_exist_bg=args.is_exist_bg, seed=rt.seed)
    if writer:
        scene.write_static_artifacts()
    multihost.barrier()
    ds = DeviceDataset.from_cameras(scene.train_cameras, device=device)
    v, f = mesh_io.read_triangle_mesh(args.input_mesh)
    log(f"[train] proxy mesh: {v.shape[0]} verts, {f.shape[0]} faces; "
        f"{len(scene.train_cameras)} train cams; "
        f"extent {scene.cameras_extent:.3f}; {device}")

    trainer = MeshTrainer(v, f, ds, opt, rt, spatial_lr_scale=scene.cameras_extent,
                          white_background=model.white_background,
                          is_exist_bg=args.is_exist_bg,
                          init_target=args.init_target,
                          max_sh_degree=model.sh_degree)
    if trainer.n_shards > 1:
        log(f"[train] Gaussian table sharded over {trainer.n_shards} ranks")
    elif trainer.mesh is not None:
        log(f"[train] process mesh: data {rt.data_axis} x tile {rt.tile_axis}")
    trainer.logger = TrainLogger(model.model_path) if writer else None
    ckpt_path = args.start_checkpoint
    if args.auto_resume and not ckpt_path:
        ckpt_path = latest_checkpoint(model.model_path)
    if ckpt_path:
        trainer.load_ckpt(ckpt_path)
        log(f"[train] resumed from {ckpt_path} at iter {trainer.global_it}")
    log(f"[train] {trainer.n_alive()} gaussians after init")

    test_iters = {b for b in args.test_iterations if b <= opt.iterations}
    save_iters = {b for b in args.save_iterations if b <= opt.iterations}
    ckpt_iters = {b for b in args.checkpoint_iterations if b <= opt.iterations}

    def cb(m):
        log(f"  iter {m['iter']:>6d}  loss {m['loss']:.5f}  "
            f"n {m['n_alive']}  {m['elapsed']:.0f}s", flush=True)

    test_ds = (DeviceDataset.from_cameras(scene.test_cameras, device=device)
               if scene.test_cameras and test_iters else None)
    prev = trainer.global_it
    for b in sorted(test_iters | save_iters | ckpt_iters | {opt.iterations}):
        if b <= prev:
            continue
        trainer.train(iterations=b - prev, log_every=200, callback=cb)
        prev = b
        if b in save_iters or b == opt.iterations:
            log(f"[ITER {b}] Saving Gaussians")
            trainer.save(scene.iteration_dir(b))
        if b in ckpt_iters:
            trainer.save_ckpt(os.path.join(model.model_path, f"chkpnt{b}.ckpt"))
        if b in test_iters and test_ds is not None:
            log(f"[ITER {b}] test PSNR {trainer.eval_psnr(dataset=test_ds):.2f}")
    if trainer.logger is not None:
        trainer.logger.close()
    return trainer


if __name__ == "__main__":
    main()
