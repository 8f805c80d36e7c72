"""COLMAP structure from motion over a folder of photos (port of
`gaussianmesh_tpu/cli/convert.py`; the reference convert.py): feature
extraction, matching, mapping, undistortion and an optional 1/2, 1/4, 1/8
resize, by the `colmap` and `magick` programs, which must be installed; a
clear message says so where `colmap` is not.

    python -m gaussianmesh_tpu_torch.cli.convert -s <data_dir> [--no_gpu] \
        [--skip_matching] [--resize] [--camera OPENCV]

Reads <data_dir>/input/ and writes <data_dir>/{images,sparse/0} (and
images_{2,4,8} with `--resize`), the layout the readers take.
"""

from __future__ import annotations

import argparse
import os
import shlex
import shutil
import subprocess
import sys


def _run(cmd: str) -> None:
    print(f"[convert] {cmd}")
    code = subprocess.call(cmd, shell=True)
    if code != 0:
        print(f"command failed with code {code}. Exiting.")
        sys.exit(code)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="COLMAP converter")
    parser.add_argument("--source_path", "-s", required=True, type=str)
    parser.add_argument("--no_gpu", action="store_true")
    parser.add_argument("--skip_matching", action="store_true")
    parser.add_argument("--camera", default="OPENCV", type=str)
    parser.add_argument("--colmap_executable", default="", type=str)
    parser.add_argument("--resize", action="store_true")
    parser.add_argument("--magick_executable", default="", type=str)
    args = parser.parse_args(argv)

    colmap = args.colmap_executable or "colmap"
    magick = args.magick_executable or "magick"
    if shutil.which(colmap.split()[0]) is None:
        sys.exit("colmap binary not found — install COLMAP or pass "
                 "--colmap_executable")
    use_gpu = 0 if args.no_gpu else 1
    # the raw path for file operations; the quoted one in every shell command
    src_raw = args.source_path
    src = shlex.quote(src_raw)

    if not args.skip_matching:
        os.makedirs(os.path.join(src_raw, "distorted", "sparse"), exist_ok=True)
        _run(f"{colmap} feature_extractor"
             f" --database_path {src}/distorted/database.db"
             f" --image_path {src}/input"
             f" --ImageReader.single_camera 1"
             f" --ImageReader.camera_model {args.camera}"
             f" --SiftExtraction.use_gpu {use_gpu}")
        _run(f"{colmap} exhaustive_matcher"
             f" --database_path {src}/distorted/database.db"
             f" --SiftMatching.use_gpu {use_gpu}")
        _run(f"{colmap} mapper"
             f" --database_path {src}/distorted/database.db"
             f" --image_path {src}/input"
             f" --output_path {src}/distorted/sparse"
             f" --Mapper.ba_global_function_tolerance=0.000001")

    _run(f"{colmap} image_undistorter"
         f" --image_path {src}/input"
         f" --input_path {src}/distorted/sparse/0"
         f" --output_path {src}"
         f" --output_type COLMAP")

    sparse = os.path.join(src_raw, "sparse")
    os.makedirs(os.path.join(sparse, "0"), exist_ok=True)
    for f in os.listdir(sparse):
        if f != "0":
            shutil.move(os.path.join(sparse, f), os.path.join(sparse, "0", f))

    if args.resize:
        for scale, pct in (("_2", 50), ("_4", 25), ("_8", 12.5)):
            dst = os.path.join(src_raw, f"images{scale}")
            shutil.copytree(os.path.join(src_raw, "images"), dst, dirs_exist_ok=True)
            for name in os.listdir(dst):
                _run(f"{magick} mogrify -resize {pct}% "
                     f"{shlex.quote(os.path.join(dst, name))}")
    print("Done.")


if __name__ == "__main__":
    main()
