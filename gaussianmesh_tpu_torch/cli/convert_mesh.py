"""Bring a reconstructed mesh back to scene coordinates (port of
`gaussianmesh_tpu/cli/convert_mesh.py`; the reference's
mesh_preprocess/convert_mesh.py).

    python -m gaussianmesh_tpu_torch.cli.convert_mesh --input m.obj \
        --output o.obj --transform t.json

`t.json` holds {"transform_matrix": 4x4, "scaling_factor": s}, the
normalization a reconstruction pipeline applied (`normalize_info`); the
inverse is applied to the mesh's vertices.
"""

from __future__ import annotations

import argparse
import json

import numpy as np


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="Mesh de-normalization")
    parser.add_argument("--input", required=True)
    parser.add_argument("--output", required=True)
    parser.add_argument("--transform", required=True,
                        help="JSON with transform_matrix (4x4) and "
                             "scaling_factor printed by the recon pipeline")
    args = parser.parse_args(argv)

    from gaussianmesh_tpu_torch.io import mesh as mesh_io
    with open(args.transform) as f:
        t = json.load(f)
    m = np.asarray(t["transform_matrix"], np.float64).reshape(4, 4)
    s = float(t.get("scaling_factor", 1.0))

    v, faces = mesh_io.read_triangle_mesh(args.input)
    inv = np.linalg.inv(m[:3, :3])
    v = (v.astype(np.float64) / s) @ inv.T - inv @ m[:3, 3]
    mesh_io.write_triangle_mesh(args.output, v.astype(np.float32), faces)
    print(f"wrote {args.output} ({v.shape[0]} verts)")


if __name__ == "__main__":
    main()
