"""Odometry CLI of the PyTorch port.

Option parity with the JAX package's CLI (itself mirroring the reference
Typer app, ``apps/mad_icp.py:71-216``) plus ``--device``: config
resolution by preset name or YAML path, dataset-format sniffing (KITTI
``.bin``, ROS1 ``.bag``, ROS2 ``.db3``, MCAP), per-scan timing prints,
KITTI pose lines written to ``estimate.txt``, background checkpoints and
resume, a ``torch.profiler`` trace and the Open3D visualizer.

Usage:
    python -m madicp_tpu_torch --data-path DIR --estimate-path DIR \\
        --dataset-config kitti [--noviz] [--device cuda] \\
        [--checkpoint-every N] [--resume] [--profile DIR]
"""

from __future__ import annotations

import argparse
import contextlib
import itertools
import json
import sys
import time
from pathlib import Path


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="mad_icp_tpu_torch",
        description="MAD-ICP LiDAR odometry (PyTorch, CUDA)",
    )
    p.add_argument("--data-path", type=Path, required=True,
                   help="directory with .bin files or rosbags")
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
                   help="ICP association schedule")
    p.add_argument("--reassoc-every", type=int, default=7,
                   help="fast mode: rounds between full re-descents")
    p.add_argument("--no-certify", action="store_true",
                   help="exact mode: disable the certified re-association")
    p.add_argument("--certify-compact", type=int, default=0,
                   help="experimental: certified rounds descend each "
                        "keyframe's uncertified leaves through a buffer of "
                        "this size (0 = off)")
    p.add_argument("--certify-prefix", type=int, default=0,
                   help="experimental: prefix-certified rounds with a "
                        "prefix buffer of this size (0 = off; exclusive "
                        "with --certify-compact)")
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
                   help="save a resumable checkpoint every N scans (0 = off)")
    p.add_argument("--resume", action="store_true",
                   help="resume from the checkpoint in --estimate-path")
    p.add_argument("--profile", type=Path, default=None,
                   help="write a torch.profiler trace of the whole run to "
                        "DIR/trace.json and the program's own trace (spans "
                        "of each scan's host calls and device phases, and "
                        "its counts) to DIR/spans.json; every event stays "
                        "in host memory until the run ends, so bound the "
                        "run with --max-scans")
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


def make_reader(fmt: str, data_path: Path, data_cf):
    from madicp_tpu_torch.utils.kitti import KittiReader
    if fmt == "kitti":
        return KittiReader(
            data_path,
            data_cf.min_range,
            data_cf.max_range,
            apply_correction=data_cf.apply_correction,
            sensor_hz=data_cf.sensor_hz,
        )
    from madicp_tpu_torch.utils.rosbag import McapReader, Ros1Reader, Ros2Reader
    cls = {"ros1": Ros1Reader, "ros2": Ros2Reader, "mcap": McapReader}[fmt]
    return cls(
        data_path,
        data_cf.min_range,
        data_cf.max_range,
        topic=data_cf.rosbag_topic,
        sensor_hz=data_cf.sensor_hz,
    )


def _device(name: str):
    """The run's device with its index: the prefetcher's thread stages
    scans there, and torch's current device is per thread."""
    import torch

    from madicp_tpu_torch.utils.device import resolve_device

    dev = resolve_device(name)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _profiler(device):
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    return profile(activities=activities, acc_events=True)  # one cycle, kept whole


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    if not args.data_path.exists():
        print(f"error: {args.data_path} does not exist", file=sys.stderr)
        return -1
    args.estimate_path.mkdir(parents=True, exist_ok=True)

    from madicp_tpu_torch.models.pipeline import Pipeline
    from madicp_tpu_torch.utils.checkpoint import (
        checkpoint_path,
        load_pipeline,
        save_pipeline,
    )
    from madicp_tpu_torch.utils.config import load_dataset_config, load_mad_params
    from madicp_tpu_torch.utils.trajectory import write_transformed_pose

    fmt = sniff_format(args.data_path)
    print(f"dataset format: {fmt}")
    data_cf = load_dataset_config(args.dataset_config)
    mad_cf = load_mad_params(args.mad_icp_params)
    device = _device(args.device)

    ckpt = checkpoint_path(args.estimate_path)
    start_scan = 0
    if args.resume and ckpt.exists():
        pipeline = load_pipeline(ckpt, device=device)
        start_scan = pipeline.current_id()
        print(f"resumed from {ckpt} at scan {start_scan}")
    else:
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
            device=device,
        )

    visualizer = None
    if not args.noviz:
        from madicp_tpu_torch.utils.visualizer import Visualizer

        visualizer = Visualizer()

    estimate_path = args.estimate_path / "estimate.txt"
    if start_scan and estimate_path.exists():
        # poses written after the last checkpoint would be recomputed —
        # truncate the trajectory to exactly the checkpointed scan count
        with open(estimate_path) as f:
            kept = f.readlines()[:start_scan]
        with open(estimate_path, "w") as f:
            f.writelines(kept)

    reader = make_reader(fmt, args.data_path, data_cf)
    staged = not args.no_prefetch
    if staged:
        from madicp_tpu_torch.native.prefetch import Prefetcher

        scan_index = itertools.count()

        def _stage(item):
            # producer thread: the copy to the pipeline's device, padded
            # there; none of the step's kernels. A resume's skipped scans
            # are not copied.
            if next(scan_index) < start_scan:
                return None
            ts, points = item
            return (ts, *pipeline.stage(points))

        reader = Prefetcher(reader, transform=_stage)

    n_scans = 0
    budget_ms = 1000.0 / data_cf.sensor_hz
    ckpt_thread = None
    t_first = None  # the end of the run's first scan: its rate starts here
    with contextlib.ExitStack() as stack:
        estimate_file = stack.enter_context(
            open(estimate_path, "a" if start_scan else "w"))
        prof = None
        if args.profile is not None:
            from madicp_tpu_torch.utils.timing import Trace

            args.profile.mkdir(parents=True, exist_ok=True)
            prof = stack.enter_context(_profiler(device))
            pipeline.trace = Trace(pipeline.device)
        stack.enter_context(reader)
        t_read = time.perf_counter()
        for item in reader:
            if n_scans < start_scan:  # resume: skip already-processed scans
                n_scans += 1
                t_read = time.perf_counter()
                continue
            read_ms = (time.perf_counter() - t_read) * 1000
            t0 = time.perf_counter()
            if staged:
                pipeline.compute_device(*item)
            else:
                pipeline.compute(*item)
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

            if visualizer is not None:
                if pipeline.is_map_updated():
                    visualizer.update(
                        pipeline.current_leaves(),
                        pipeline.model_leaves(),
                        lidar_to_world,
                        pipeline.keyframe_pose(),
                    )
                else:
                    visualizer.update(
                        pipeline.current_leaves(), None, lidar_to_world, None
                    )

            n_scans += 1
            if args.checkpoint_every and n_scans % args.checkpoint_every == 0:
                estimate_file.flush()
                if ckpt_thread is not None:
                    ckpt_thread.join()  # never two writers on the same file
                # snapshot synchronously (a copy: the next step updates
                # the rings in place), write on a background thread
                ckpt_thread = save_pipeline(ckpt, pipeline, background=True)
            if args.max_scans and n_scans >= args.max_scans:
                break
            t_read = time.perf_counter()
            if t_first is None:
                t_first, n_first = t_read, n_scans
        t_end = time.perf_counter()

    if ckpt_thread is not None:
        ckpt_thread.join()
    if prof is not None:
        prof.export_chrome_trace(str(args.profile / "trace.json"))
        (args.profile / "spans.json").write_text(json.dumps(pipeline.trace.drain()))
        pipeline.trace = None
        print(f"profiler trace written to {args.profile / 'trace.json'}, the program's "
              f"spans to {args.profile / 'spans.json'}")
    if visualizer is not None:
        visualizer.close()
    print(f"wrote {n_scans} poses to {estimate_path}")
    if t_first is not None and n_scans > n_first:
        # wall clock, so checkpoints, prints and the viewer are counted
        n, s = n_scans - n_first, t_end - t_first
        print(f"{n} scans after the first in {s:.3f} s: {n / s:.3f} scans/s")
    return 0


def run() -> None:
    raise SystemExit(main())


if __name__ == "__main__":
    run()
