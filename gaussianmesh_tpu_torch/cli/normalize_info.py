"""Scene-normalization info for surface reconstruction (port of
`gaussianmesh_tpu/cli/normalize_info.py`): the producer side of the
mesh-preprocess loop (SURVEY.md §2.13).

    python -m gaussianmesh_tpu_torch.cli.normalize_info -s <data> --out t.json
    # ... reconstruct a mesh in normalized space (any pipeline) ...
    python -m gaussianmesh_tpu_torch.cli.convert_mesh --input recon.obj \
        --output proxy.obj --transform t.json

The normalization (centre on the camera centroid, scale by the nerf++
radius) comes from the COLMAP / Blender scene through the port's readers.
"""

from __future__ import annotations

import argparse
import json

import numpy as np


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="Scene normalization info")
    ap.add_argument("-s", "--source_path", required=True)
    ap.add_argument("--out", type=str, default=None,
                    help="write JSON here (default: print)")
    ap.add_argument("--resolution", type=int, default=-1)
    args = ap.parse_args(argv)

    from gaussianmesh_tpu_torch.data import readers
    info = readers.read_scene(args.source_path, resolution=args.resolution,
                              eval_split=False)
    centers = np.stack([np.asarray(c.camera_center) for c in info.train_cameras])
    center = centers.mean(axis=0)
    radius = float(info.nerf_norm["radius"])

    # normalized = (world - center) / radius: transform_matrix carries the
    # translation, scaling_factor the radius (the convention convert_mesh
    # inverts)
    m = np.eye(4)
    m[:3, 3] = -center
    text = json.dumps({"transform_matrix": m.tolist(), "scaling_factor": 1.0 / radius},
                      indent=1)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
        print(f"wrote {args.out} (center {center.round(4).tolist()}, "
              f"radius {radius:.4f})")
    else:
        print(text)


if __name__ == "__main__":
    main()
