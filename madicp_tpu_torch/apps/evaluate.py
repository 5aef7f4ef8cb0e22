"""Trajectory evaluation CLI: ATE RMSE + KITTI segment drift.

The reference delegates evaluation to external tooling (the paper's
tables; SURVEY.md §4). This ships the standard metrics in-framework so a
benchmark run is one command:

    python -m madicp_tpu_torch.apps.evaluate --estimate out/estimate.txt \
        --ground-truth gt/00.txt [--json]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="madicp_tpu_torch.evaluate",
        description="score a KITTI-format trajectory against ground truth",
    )
    p.add_argument("--estimate", type=Path, required=True,
                   help="estimated trajectory (KITTI 12-scalar lines)")
    p.add_argument("--ground-truth", type=Path, required=True,
                   help="ground-truth trajectory (same format)")
    p.add_argument("--no-align", action="store_true",
                   help="skip SE(3) alignment before ATE")
    p.add_argument("--segment-lengths", type=float, nargs="+", default=None,
                   help="drift segment lengths in meters (default: the "
                        "KITTI benchmark's 100..800); pass short lengths "
                        "for short sequences, which otherwise report nan")
    p.add_argument("--json", action="store_true",
                   help="print one machine-readable JSON line")
    return p


def evaluate(estimate_path, ground_truth_path, align: bool = True,
             lengths=None) -> dict:
    from madicp_tpu_torch.utils.trajectory import ate_rmse, kitti_drift, load_kitti_poses

    est = load_kitti_poses(estimate_path)
    gt = load_kitti_poses(ground_truth_path)
    n = min(len(est), len(gt))
    drift = (kitti_drift(est, gt, lengths=tuple(lengths))
             if lengths else kitti_drift(est, gt))
    return {
        "poses": int(n),
        "ate_rmse_m": ate_rmse(est, gt, align=align),
        "t_err_pct": drift["t_err_pct"],
        "r_err_deg_per_m": drift["r_err_deg_per_m"],
        "segments": drift["segments"],
    }


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    for f in (args.estimate, args.ground_truth):
        if not f.exists():
            print(f"error: {f} does not exist", file=sys.stderr)
            return -1
    m = evaluate(args.estimate, args.ground_truth, align=not args.no_align,
                 lengths=args.segment_lengths)
    if args.json:
        print(json.dumps(m))
    else:
        print(f"poses compared : {m['poses']}")
        print(f"ATE RMSE       : {m['ate_rmse_m']:.4f} m")
        print(f"KITTI drift    : {m['t_err_pct']:.4f} %  "
              f"({m['segments']} segments)")
        print(f"rotation error : {m['r_err_deg_per_m']:.6f} deg/m")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
