"""Offline evaluation of rendered views against their ground truth (port of
`gaussianmesh_tpu/eval/metrics.py`; the reference's metrics.py:41-107).

For each <model>/test/<method>/{renders,gt} pair of directories, SSIM,
PSNR and LPIPS per view, on the card unless asked otherwise, written to
<model>/results.json (means per method) and per_view.json with the JAX
package's keys. Without pretrained LPIPS weights `LPIPS` is null, with
`LPIPS_note` beside it, and the seed-weight graph is reported only as
`LPIPS_uncalibrated`, when asked for.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from gaussianmesh_tpu_torch import resolve_device
from gaussianmesh_tpu_torch.eval.lpips import LPIPS
from gaussianmesh_tpu_torch.io.png import read_image
from gaussianmesh_tpu_torch.train.loss import psnr as psnr_fn, ssim as ssim_fn

LPIPS_NOTE = ("pretrained VGG16 + LPIPS lin weights not found (weights/lpips_vgg16.npz "
              "or GM_TPU_LPIPS_WEIGHTS); the LPIPS graph itself is held against the "
              "JAX package's in tests/test_torch_eval.py")


def read_rgb(path: str, device) -> torch.Tensor:
    """An image file as PIL's `convert("RGB")` gives it -> (3, H, W) float32
    in [0, 1]: alpha dropped, gray repeated."""
    im = read_image(path)
    if im.ndim == 2:
        im = im[..., None]
    im = im[..., :1] if im.shape[2] == 2 else im[..., :3]
    if im.shape[2] == 1:
        im = np.repeat(im, 3, axis=2)
    arr = im.astype(np.float32) / 255.0
    return torch.from_numpy(np.ascontiguousarray(arr.transpose(2, 0, 1))).to(device)


def evaluate_dirs(renders_dir: str, gt_dir: str, lpips_weights: str | None = None,
                  lpips_uncalibrated: bool = False, device=None) -> dict:
    """-> {"mean": {SSIM, PSNR, LPIPS[, LPIPS_uncalibrated, LPIPS_note]},
    "per_view": {name: {SSIM, PSNR[, LPIPS | LPIPS_uncalibrated]}}}."""
    device = resolve_device(device)
    names = sorted(os.listdir(renders_dir))
    lpips = LPIPS(lpips_weights, uncalibrated=lpips_uncalibrated, device=device)
    lpips_key = "LPIPS" if lpips.calibrated else "LPIPS_uncalibrated"
    if not lpips.calibrated:
        print("[metrics] WARNING: no pretrained LPIPS weights — "
              + ("reporting LPIPS_uncalibrated (seed-weight graph; "
                 "NOT comparable to published LPIPS)."
                 if lpips.available else
                 "reporting PSNR/SSIM only. Supply lpips_vgg16.npz (see "
                 "gaussianmesh_tpu_torch/eval/lpips.py), pass --lpips_weights, "
                 "or opt into --lpips_uncalibrated."))
    per_view: dict[str, dict] = {}
    ssims, psnrs, lpipss = [], [], []
    for name in names:
        render = read_rgb(os.path.join(renders_dir, name), device)
        gt = read_rgb(os.path.join(gt_dir, name), device)
        with torch.no_grad():
            s, p = float(ssim_fn(render, gt)), float(psnr_fn(render, gt))
        entry = {"SSIM": s, "PSNR": p}
        ssims.append(s)
        psnrs.append(p)
        if lpips.available:
            entry[lpips_key] = lpips(render, gt)
            lpipss.append(entry[lpips_key])
        per_view[name] = entry
    out = {"SSIM": float(np.mean(ssims)) if ssims else None,
           "PSNR": float(np.mean(psnrs)) if psnrs else None,
           # null, not absent, without weights: the gap shows in results.json
           "LPIPS": float(np.mean(lpipss)) if (lpipss and lpips.calibrated) else None}
    if not lpips.calibrated:
        if lpips.available and lpipss:
            out["LPIPS_uncalibrated"] = float(np.mean(lpipss))
        out["LPIPS_note"] = LPIPS_NOTE
    return {"mean": out, "per_view": per_view}


def evaluate_model_paths(model_paths: list[str], lpips_weights: str | None = None,
                         lpips_uncalibrated: bool = False, device=None) -> None:
    """The metrics command line: every <model>/test/<method>/ with renders/
    and gt/ -> <model>/results.json and per_view.json."""
    for model_path in model_paths:
        results, per_view_all = {}, {}
        test_dir = os.path.join(model_path, "test")
        if not os.path.isdir(test_dir):
            print(f"[metrics] no test dir in {model_path}")
            continue
        for method in sorted(os.listdir(test_dir)):
            renders = os.path.join(test_dir, method, "renders")
            gt = os.path.join(test_dir, method, "gt")
            if not (os.path.isdir(renders) and os.path.isdir(gt)):
                continue
            res = evaluate_dirs(renders, gt, lpips_weights, lpips_uncalibrated, device)
            results[method] = res["mean"]
            per_view_all[method] = res["per_view"]
            print(f"  {method}: " + "  ".join(
                f"{k} {v:.7f}" for k, v in res["mean"].items() if isinstance(v, float)))
        with open(os.path.join(model_path, "results.json"), "w") as f:
            json.dump(results, f, indent=2)
        with open(os.path.join(model_path, "per_view.json"), "w") as f:
            json.dump(per_view_all, f, indent=2)
