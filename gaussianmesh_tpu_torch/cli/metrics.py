"""Evaluate rendered views (port of `gaussianmesh_tpu/cli/metrics.py`; the
reference metrics.py).

    python -m gaussianmesh_tpu_torch.cli.metrics -m <model_dir> [<model_dir> ...] \
        [--lpips_weights W.npz] [--lpips_uncalibrated] [--device cpu]

Runs on CUDA unless `--device cpu` is given, and raises without a card.
Writes <model_dir>/results.json and per_view.json (`eval/metrics.py`).
"""

from __future__ import annotations

import argparse


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="Metrics (PSNR/SSIM/LPIPS)")
    parser.add_argument("--model_paths", "-m", nargs="+", type=str, required=True)
    parser.add_argument("--lpips_weights", type=str, default=None)
    parser.add_argument("--lpips_uncalibrated", action="store_true",
                        help="without pretrained weights, report the seed-weight "
                             "LPIPS graph as LPIPS_uncalibrated (relative ranking "
                             "only; NOT comparable to published LPIPS)")
    parser.add_argument("--device", type=str, default=None,
                        help="cuda (the default; raises without a card) or cpu")
    args = parser.parse_args(argv)

    from gaussianmesh_tpu_torch.eval.metrics import evaluate_model_paths
    evaluate_model_paths(args.model_paths, args.lpips_weights,
                         lpips_uncalibrated=args.lpips_uncalibrated, device=args.device)


if __name__ == "__main__":
    main()
