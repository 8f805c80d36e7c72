"""Inspect or diff Gaussian PLY files (port of
`gaussianmesh_tpu/cli/inspect_ply.py`): each field group's shape and
statistics, and with a second file the largest difference per field.

    python -m gaussianmesh_tpu_torch.cli.inspect_ply model.ply [other.ply] [--atol 1e-5]
"""

from __future__ import annotations

import argparse

import numpy as np

from gaussianmesh_tpu_torch.io import ply as ply_io


def _stats(name: str, arr: np.ndarray) -> str:
    a = np.asarray(arr, np.float64)
    return (f"  {name:16s} shape={tuple(arr.shape)!s:14s} "
            f"min={a.min():+.4g} max={a.max():+.4g} "
            f"mean={a.mean():+.4g} std={a.std():.4g} "
            f"finite={np.isfinite(a).all()}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="Inspect / diff Gaussian PLYs")
    ap.add_argument("ply", type=str)
    ap.add_argument("other", type=str, nargs="?", default=None)
    ap.add_argument("--atol", type=float, default=1e-5)
    args = ap.parse_args(argv)

    fields = ply_io.read_ply(args.ply)["vertex"]
    names = list(fields.keys())
    n = fields[names[0]].shape[0]
    kind = "mesh-bound" if "face_id" in names else "vanilla 3DGS"
    print(f"{args.ply}: {n} gaussians, {len(names)} fields ({kind})")
    groups: dict[str, list[str]] = {}
    for name in names:
        groups.setdefault(name.rstrip("0123456789_xyz") or name, []).append(name)
    for key, members in groups.items():
        stacked = np.stack([fields[m] for m in members], axis=-1)
        print(_stats(key if len(members) == 1 else f"{key}[{len(members)}]", stacked))

    if args.other:
        fields2 = ply_io.read_ply(args.other)["vertex"]
        names2 = list(fields2.keys())
        missing = sorted(set(names) ^ set(names2))
        if missing:
            print(f"fields only in one file: {missing}")
        n2 = fields2[names2[0]].shape[0]
        if n2 != n:
            print(f"COUNT MISMATCH: {n} vs {n2}")
            return
        worst = 0.0
        for m in (m for m in names if m in set(names2)):
            d = float(np.abs(np.asarray(fields[m], np.float64)
                             - np.asarray(fields2[m], np.float64)).max())
            worst = max(worst, d)
            print(f"  {m:16s} max|diff| = {d:.3e}" + ("" if d <= args.atol else
                                                     "   <-- DIFFERS"))
        verdict = "MATCH" if worst <= args.atol else "DIFFER"
        print(f"{verdict} (worst {worst:.3e}, atol {args.atol:g})")


if __name__ == "__main__":
    main()
