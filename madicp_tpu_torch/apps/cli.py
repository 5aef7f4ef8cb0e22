"""Odometry CLI of the PyTorch port.

Option parity with the JAX package's CLI (itself mirroring the reference
Typer app, ``apps/mad_icp.py:71-216``) plus ``--device``: config
resolution by preset name or YAML path, per-scan timing prints, KITTI
pose lines written to ``estimate.txt``. KITTI ``.bin`` directories only
for now; options whose modules are still to be ported (ROS/MCAP readers,
checkpoints, profiling, the visualizer) fail with a clear message
instead of being ignored.

Usage:
    python -m madicp_tpu_torch --data-path DIR --estimate-path DIR \\
        --dataset-config kitti --noviz [--device cuda]
"""

from __future__ import annotations

import argparse
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="mad_icp_tpu_torch",
        description="MAD-ICP LiDAR odometry (PyTorch, CUDA)",
    )
    p.add_argument("--data-path", type=Path, required=True,
                   help="directory with KITTI .bin scans")
    p.add_argument("--estimate-path", type=Path, required=True,
                   help="trajectory estimate output directory")
    p.add_argument("--dataset-config", type=str, required=True,
                   help="dataset preset name or YAML path")
    p.add_argument("--mad-icp-params", type=str, default="default",
                   help="solver preset name or YAML path")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on (default cuda; 'cpu' runs "
                        "the plain versions of the kernels)")
    p.add_argument("--num-cores", type=int, default=4,
                   help="accepted for reference-CLI parity; unused")
    p.add_argument("--num-keyframes", type=int, default=4,
                   help="max keyframes kept in the local map")
    p.add_argument("--realtime", action="store_true",
                   help="anytime realtime (measured, not enforced)")
    p.add_argument("--noviz", action="store_true", help="disable visualizer")
    p.add_argument("--n-points", type=int, default=131072,
                   help="static padded cloud size")
    p.add_argument("--depth", type=int, default=16, help="static tree depth")
    p.add_argument("--max-leaves", type=int, default=0,
                   help="moving-leaf capacity (0 = n_points)")
    p.add_argument("--assoc-mode", type=str, default="exact",
                   choices=("exact", "fast"),
                   help="ICP association schedule ('fast' is not ported yet)")
    p.add_argument("--reassoc-every", type=int, default=7,
                   help="fast mode: rounds between full re-descents")
    p.add_argument("--no-certify", action="store_true",
                   help="exact mode: disable the certified re-association")
    p.add_argument("--certify-compact", type=int, default=0,
                   help="not ported yet (0 = off)")
    p.add_argument("--certify-prefix", type=int, default=0,
                   help="not ported yet (0 = off)")
    p.add_argument("--assoc-ladder", type=int, default=3,
                   help="accepted for parity; the TPU select ladder is a "
                        "no-op here")
    p.add_argument("--deskew-mode", type=str, default="reference",
                   choices=("reference", "binned"),
                   help="deskew semantics when the dataset enables deskew")
    p.add_argument("--max-scans", type=int, default=0,
                   help="stop after this many scans (0 = all)")
    p.add_argument("--no-prefetch", action="store_true",
                   help="read each scan only after the previous one is done")
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="not ported yet (0 = off)")
    p.add_argument("--resume", action="store_true", help="not ported yet")
    p.add_argument("--profile", type=Path, default=None, help="not ported yet")
    return p


def sniff_format(data_path: Path) -> str:
    """Dataset-format sniffing (reference ``apps/mad_icp.py:99-111``)."""
    if list(data_path.glob("*.bag")):
        return "ros1"
    if list(data_path.glob("*.db3")):
        return "ros2"
    if list(data_path.glob("*.mcap")):
        return "mcap"
    return "kitti"


def _not_ported(args, fmt: str) -> list[str]:
    """Requested features whose modules are still to be ported."""
    out = []
    if fmt != "kitti":
        out.append(f"{fmt} datasets (ROS/MCAP readers, ROADMAP A9)")
    if args.resume or args.checkpoint_every:
        out.append("--resume/--checkpoint-every (checkpoints, ROADMAP A9)")
    if args.profile is not None:
        out.append("--profile (ROADMAP A10)")
    if not args.noviz:
        out.append("the visualizer (ROADMAP A9); pass --noviz")
    return out


def _prefetched(reader):
    """Yield the reader's scans, reading the next one on a worker thread
    while the caller processes the current one."""
    it = iter(reader)
    with ThreadPoolExecutor(max_workers=1) as pool:
        fut = pool.submit(next, it, None)
        while True:
            item = fut.result()
            if item is None:
                return
            fut = pool.submit(next, it, None)
            yield item


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    if not args.data_path.exists():
        print(f"error: {args.data_path} does not exist", file=sys.stderr)
        return -1
    fmt = sniff_format(args.data_path)
    missing = _not_ported(args, fmt)
    if missing:
        print("error: not yet ported in madicp_tpu_torch: " + "; ".join(missing),
              file=sys.stderr)
        return 2
    args.estimate_path.mkdir(parents=True, exist_ok=True)

    from madicp_tpu_torch.models.pipeline import Pipeline
    from madicp_tpu_torch.utils.config import load_dataset_config, load_mad_params
    from madicp_tpu_torch.utils.kitti import KittiReader
    from madicp_tpu_torch.utils.trajectory import write_transformed_pose

    print(f"dataset format: {fmt}")
    data_cf = load_dataset_config(args.dataset_config)
    mad_cf = load_mad_params(args.mad_icp_params)
    pipeline = Pipeline(
        sensor_hz=data_cf.sensor_hz,
        deskew=data_cf.deskew,
        b_max=mad_cf.b_max,
        rho_ker=mad_cf.rho_ker,
        p_th=mad_cf.p_th,
        b_min=mad_cf.b_min,
        b_ratio=mad_cf.b_ratio,
        num_keyframes=args.num_keyframes,
        realtime=args.realtime,
        n_points=args.n_points,
        depth=args.depth,
        max_leaves=args.max_leaves,
        assoc_mode=args.assoc_mode,
        reassoc_every=args.reassoc_every,
        certify=not args.no_certify,
        certify_compact=args.certify_compact,
        certify_prefix=args.certify_prefix,
        assoc_ladder=args.assoc_ladder,
        deskew_mode=args.deskew_mode,
        device=args.device,
    )
    reader = KittiReader(
        args.data_path, data_cf.min_range, data_cf.max_range,
        apply_correction=data_cf.apply_correction, sensor_hz=data_cf.sensor_hz,
    )
    scans = iter(reader) if args.no_prefetch else _prefetched(reader)

    n_scans = 0
    budget_ms = 1000.0 / data_cf.sensor_hz
    estimate_path = args.estimate_path / "estimate.txt"
    with open(estimate_path, "w") as estimate_file:
        t_read = time.perf_counter()
        for ts, points in scans:
            read_ms = (time.perf_counter() - t_read) * 1000
            t0 = time.perf_counter()
            pipeline.compute(ts, points)
            lidar_to_world = pipeline.current_pose()  # waits for the device
            odom_ms = (time.perf_counter() - t0) * 1000

            write_transformed_pose(estimate_file, lidar_to_world, data_cf.extrinsics)
            print(
                f"scan {pipeline.current_id():6d}  read {read_ms:7.2f} ms  "
                f"odometry {odom_ms:7.2f} ms  (budget {budget_ms:.0f} ms)  "
                f"inliers {pipeline.inlier_ratio():.2f}"
            )
            dropped = pipeline.leaves_dropped()
            if dropped:
                print(
                    f"warning: scan {pipeline.current_id()} exceeded the leaf "
                    f"capacity by {dropped} leaves — raise --max-leaves (map "
                    f"and inlier ratio are truncated)",
                    file=sys.stderr,
                )
            pts_dropped = pipeline.points_dropped()
            if pts_dropped:
                print(
                    f"warning: scan {pipeline.current_id()} exceeded the point "
                    f"capacity by {pts_dropped} points — raise --n-points",
                    file=sys.stderr,
                )
            n_scans += 1
            if args.max_scans and n_scans >= args.max_scans:
                break
            t_read = time.perf_counter()
    print(f"wrote {n_scans} poses to {estimate_path}")
    return 0


def run() -> None:
    raise SystemExit(main())


if __name__ == "__main__":
    run()
