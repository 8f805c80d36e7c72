"""Train, render and evaluate a list of scenes (port of
`gaussianmesh_tpu/cli/full_eval.py`; the reference full_eval.py).

    python -m gaussianmesh_tpu_torch.cli.full_eval --base <datasets_root> \
        --scenes scene1 scene2 --meshes m1.obj m2.obj --output <out_root> \
        [--iterations 30000] [--with_bg] [--device cpu] [train_mesh flags ...]

Calls the port's `train_mesh` (with `--eval`), `train_bg` (with
`--with_bg`), `render --skip_train` and `metrics` in this process, with the
JAX command line's arguments and `--device` passed on to each. Flags
full_eval does not know go to `train_mesh` (a schedule, the rasterizer's
capacities); they are saved in the model directory's cfg_args.json, which
the later steps read.
"""

from __future__ import annotations

import argparse
import os


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="Batch train/render/eval")
    parser.add_argument("--base", required=True,
                        help="root directory containing the scene folders")
    parser.add_argument("--scenes", nargs="+", required=True)
    parser.add_argument("--meshes", nargs="+", required=True,
                        help="proxy mesh per scene (parallel to --scenes)")
    parser.add_argument("--output", default="./eval_output")
    parser.add_argument("--skip_training", action="store_true")
    parser.add_argument("--skip_rendering", action="store_true")
    parser.add_argument("--skip_metrics", action="store_true")
    parser.add_argument("--iterations", type=int, default=30_000)
    parser.add_argument("--with_bg", action="store_true")
    parser.add_argument("--device", type=str, default=None,
                        help="cuda (the default; raises without a card) or cpu")
    args, train_args = parser.parse_known_args(argv)
    if len(args.scenes) != len(args.meshes):
        parser.error("--scenes and --meshes must pair up")

    from gaussianmesh_tpu_torch.cli import (metrics as cli_metrics,
                                            render as cli_render,
                                            train_bg as cli_train_bg,
                                            train_mesh as cli_train_mesh)

    dev = [] if args.device is None else ["--device", args.device]
    model_paths = []
    for scene, mesh in zip(args.scenes, args.meshes):
        src = os.path.join(args.base, scene)
        model = os.path.join(args.output, scene)
        model_paths.append(model)
        if not args.skip_training:
            cli_train_mesh.main(["-s", src, "-m", model, "--input_mesh", mesh, "--eval",
                                 "--iterations", str(args.iterations), *train_args, *dev])
            if args.with_bg:
                cli_train_bg.main(["-s", src, "-m", model, "--eval", "--iterations",
                                   str(args.iterations), *dev])
        if not args.skip_rendering:
            cli_render.main(["-m", model, "--skip_train", *(
                ["--with_bg"] if args.with_bg else []), *dev])
    if not args.skip_metrics:
        cli_metrics.main(["-m", *model_paths, *dev])


if __name__ == "__main__":
    main()
