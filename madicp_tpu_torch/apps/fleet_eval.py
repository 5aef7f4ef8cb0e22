"""Fleet evaluation harness: N sequences -> batched odometry -> metrics.

One command wiring dataset readers into the batched
:class:`~madicp_tpu_torch.parallel.Fleet` and the in-framework evaluator
(the port of the JAX package's ``apps/fleet_eval.py``). Every sequence
advances in one batched step per scan index; each sequence's
KITTI-format trajectory, plus drift and ATE when ground truth is given,
lands in its own directory.

Usage (one process, every sequence on one device):

    python -m madicp_tpu_torch.apps.fleet_eval \\
        --data-paths seq00/ seq01/ ... --estimate-path out/ \\
        --dataset-config kitti [--ground-truth-paths gt00.txt ...] \\
        [--num-keyframes 16] [--device cuda] [--json]

``--seq-axis S --kf-axis K`` split the sequences over S and each
keyframe ring over K processes; they need a ``torch.distributed`` world
of S*K processes, one device each:

    python -m torch.distributed.run --standalone --nproc-per-node 4 \\
        -m madicp_tpu_torch.apps.fleet_eval --seq-axis 2 --kf-axis 2 ...

Without such a world they raise ``ValueError``; they never run on one
process quietly. Backend: NCCL where every rank has a card, gloo on the
CPU and where ranks share a card (parallel/distributed.py). Rank 0
writes ``estimate.txt`` and the summary; every other rank r writes its
own copy of the gathered poses as ``estimate.rank<r>.txt``, so the
replicas can be compared.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="madicp_tpu_torch.fleet_eval",
        description="batched multi-sequence odometry + evaluation",
    )
    p.add_argument("--data-paths", type=Path, nargs="+", required=True,
                   help="one dataset directory per sequence")
    p.add_argument("--estimate-path", type=Path, required=True,
                   help="output root (one subdirectory per sequence)")
    p.add_argument("--dataset-config", type=str, required=True,
                   help="dataset preset name or YAML path (shared)")
    p.add_argument("--mad-icp-params", type=str, default="default")
    p.add_argument("--ground-truth-paths", type=Path, nargs="*", default=None,
                   help="KITTI-format ground truth, one per sequence "
                        "(order matches --data-paths)")
    p.add_argument("--num-keyframes", type=int, default=16,
                   help="benchmark default (reference README.md:41)")
    p.add_argument("--n-points", type=int, default=131072)
    p.add_argument("--depth", type=int, default=16)
    p.add_argument("--max-leaves", type=int, default=0)
    p.add_argument("--assoc-mode", type=str, default="exact",
                   choices=("exact", "fast"))
    p.add_argument("--reassoc-every", type=int, default=7)
    p.add_argument("--no-certify", action="store_true",
                   help="disable the certified re-association schedule "
                        "(exact mode; see PipelineConfig.certify)")
    p.add_argument("--certify-compact", type=int, default=0,
                   help="per-keyframe compact re-descent buffer size "
                        "(0 = off; see PipelineConfig.certify_compact)")
    p.add_argument("--certify-prefix", type=int, default=0,
                   help="uncertified-prefix buffer size (0 = off; see "
                        "PipelineConfig.certify_prefix)")
    p.add_argument("--deskew-mode", type=str, default="reference",
                   choices=("reference", "binned"))
    p.add_argument("--seq-axis", type=int, default=0,
                   help="split the sequences over this many processes "
                        "(0 = no mesh: one process steps the whole batch)")
    p.add_argument("--kf-axis", type=int, default=1,
                   help="split each sequence's keyframe ring over this "
                        "many processes (needs --seq-axis; processes = "
                        "seq_axis * kf_axis)")
    p.add_argument("--shard-points", action="store_true",
                   help="also split each scan's tree build over --kf-axis "
                        "(results within partial-sum reassociation noise "
                        "of the replicated build)")
    p.add_argument("--max-scans", type=int, default=0,
                   help="cap scans per sequence (0 = shortest sequence)")
    p.add_argument("--json", action="store_true",
                   help="print one machine-readable JSON line")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (cuda, cuda:N or cpu); with a world, "
                        "a bare 'cuda' takes the local rank's card")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    for d in args.data_paths:
        if not d.exists():
            print(f"error: {d} does not exist", file=sys.stderr)
            return -1
    gts = args.ground_truth_paths
    if gts and len(gts) != len(args.data_paths):
        print("error: --ground-truth-paths count must match --data-paths",
              file=sys.stderr)
        return -1
    if not args.seq_axis and args.kf_axis != 1:
        print("error: --kf-axis needs --seq-axis (a mesh)", file=sys.stderr)
        return -1
    if args.shard_points and (not args.seq_axis or args.kf_axis < 2):
        # stricter than the library (which accepts a size-1 kf axis as
        # a no-op): from the CLI a no-op flag is a user mistake
        print("error: --shard-points shards the build over the kf axis; "
              "pass --seq-axis and --kf-axis >= 2 to form that mesh",
              file=sys.stderr)
        return -1
    need = args.seq_axis * args.kf_axis if args.seq_axis else 1
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world != need:
        raise ValueError(
            f"--seq-axis {args.seq_axis} --kf-axis {args.kf_axis} needs a "
            f"torch.distributed world of {need} processes, this one has {world}: "
            f"launch python -m torch.distributed.run --nproc-per-node {need} "
            f"-m madicp_tpu_torch.apps.fleet_eval ...")
    args.estimate_path.mkdir(parents=True, exist_ok=True)

    import contextlib

    import numpy as np
    import torch
    import torch.distributed

    from madicp_tpu_torch.apps.cli import make_reader, sniff_format
    from madicp_tpu_torch.apps.evaluate import evaluate
    from madicp_tpu_torch.models.pipeline import PipelineConfig
    from madicp_tpu_torch.parallel import distributed
    from madicp_tpu_torch.parallel.fleet import Fleet
    from madicp_tpu_torch.utils.config import load_dataset_config, load_mad_params
    from madicp_tpu_torch.utils.trajectory import write_transformed_pose

    data_cf = load_dataset_config(args.dataset_config)
    mad_cf = load_mad_params(args.mad_icp_params)
    mesh = None
    owned = not torch.distributed.is_initialized()  # leave a caller's world up
    topo = distributed.initialize(device=args.device)
    try:
        if need > 1:
            from madicp_tpu_torch.parallel.mesh import make_mesh

            mesh = make_mesh(kf=args.kf_axis, seq=args.seq_axis)
        rank = topo["process_index"]
        # bag/mcap readers hold open file handles from construction; the
        # stack closes every reader on ANY exit path
        reader_stack = contextlib.ExitStack()
        readers = [
            reader_stack.enter_context(make_reader(sniff_format(d), d, data_cf))
            for d in args.data_paths
        ]
        n_seq = len(readers)
        lengths = [len(r) for r in readers]
        n_scans = min(lengths)
        if args.max_scans:
            n_scans = min(n_scans, args.max_scans)
        for d, ln in zip(args.data_paths, lengths):
            if ln > n_scans and rank == 0:  # no silent truncation
                print(f"note: {d.name}: processing {n_scans}/{ln} scans "
                      f"(fleet advances sequences in lockstep)")

        cfg = PipelineConfig(
            sensor_hz=float(data_cf.sensor_hz),
            deskew=bool(data_cf.deskew),
            b_max=mad_cf.b_max,
            rho_ker=mad_cf.rho_ker,
            p_th=mad_cf.p_th,
            b_min=mad_cf.b_min,
            b_ratio=mad_cf.b_ratio,
            num_keyframes=args.num_keyframes,
            n_points=args.n_points,
            depth=args.depth,
            max_leaves=args.max_leaves,
            dtype=torch.float32,
            assoc_mode=args.assoc_mode,
            reassoc_every=args.reassoc_every,
            certify=not args.no_certify,
            certify_compact=args.certify_compact,
            certify_prefix=args.certify_prefix,
            deskew_mode=args.deskew_mode,
        )
        fleet = Fleet(cfg, n_seq, mesh=mesh, shard_points=args.shard_points,
                      device=args.device)
        # line the ranks up before the first collective (a cold kernel
        # build can hold one back for minutes)
        distributed.barrier("fleet_eval: fleets built")

        E = np.asarray(data_cf.lidar_to_base, float)
        trajectories: list[list[np.ndarray]] = [[] for _ in range(n_seq)]
        t0 = time.perf_counter()
        with reader_stack:
            for i in range(n_scans):
                stamps = np.zeros(n_seq, np.float64)
                pts = np.zeros((n_seq, cfg.n_points, 3), np.float32)
                val = np.zeros((n_seq, cfg.n_points), bool)
                for s, reader in enumerate(readers):
                    ts, cloud = reader[i]
                    n = min(len(cloud), cfg.n_points)
                    if len(cloud) > cfg.n_points and rank == 0:
                        print(f"warning: seq {s} scan {i}: {len(cloud)} points "
                              f"truncated to n_points={cfg.n_points}",
                              file=sys.stderr)
                    stamps[s] = ts
                    pts[s, :n] = cloud[:n]
                    val[s, :n] = True
                fleet.compute(stamps, pts, val)
                for s, T in enumerate(fleet.poses()):
                    trajectories[s].append(np.asarray(T))
                if rank == 0:
                    print(f"\rscan {i + 1}/{n_scans}", end="", file=sys.stderr)
        wall = time.perf_counter() - t0
        if rank == 0:
            print(file=sys.stderr)

        results = []
        name = "estimate.txt" if rank == 0 else f"estimate.rank{rank}.txt"
        for s, d in enumerate(args.data_paths):
            seq_dir = args.estimate_path / d.name
            seq_dir.mkdir(parents=True, exist_ok=True)
            est_file = seq_dir / name
            with open(est_file, "w") as f:
                for T in trajectories[s]:
                    write_transformed_pose(f, T, E)
            entry = {"sequence": d.name, "scans": n_scans,
                     "estimate": str(est_file)}
            if gts and rank == 0:
                entry.update(evaluate(est_file, gts[s]))
            results.append(entry)
    finally:
        if owned:
            distributed.shutdown()
    if rank:
        return 0

    summary = {
        "sequences": n_seq,
        "scans_per_sequence": n_scans,
        "wall_s": round(wall, 3),
        "fleet_scans_per_sec": round(n_seq * n_scans / wall, 3),
        "results": results,
        "processes": topo["process_count"],
        "backend": topo["backend"],
        "device": topo["device"],
    }
    if gts:
        drifts = [r["t_err_pct"] for r in results]
        ates = [r["ate_rmse_m"] for r in results]
        summary["mean_t_err_pct"] = float(np.mean(drifts))
        summary["mean_ate_rmse_m"] = float(np.mean(ates))
    if args.json:
        print(json.dumps(summary))
    else:
        print(f"sequences        : {n_seq}")
        print(f"scans/sequence   : {n_scans}")
        print(f"fleet throughput : {summary['fleet_scans_per_sec']} scans/s")
        for r in results:
            line = f"  {r['sequence']}: {r['scans']} poses -> {r['estimate']}"
            if "t_err_pct" in r:
                line += (f"  drift {r['t_err_pct']:.4f}%  "
                         f"ATE {r['ate_rmse_m']:.4f} m")
            print(line)
        if "mean_t_err_pct" in summary:
            print(f"mean drift       : {summary['mean_t_err_pct']:.4f} %")
            print(f"mean ATE RMSE    : {summary['mean_ate_rmse_m']:.4f} m")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
