"""Per-level times of the moment segment-sum at a flagship tree build.

The main path calls :func:`madicp_tpu_torch.kernels.segsum.segsum_moments`
once a level, 17 times a build at the flagship configuration (131072
points, depth 16). This probe captures those 17 calls' inputs from one
``build_tree`` of a KITTI-like scan (the world of the JAX package's bench,
at scan 3 of its drive; ``chip_smoke.py``'s kernels phase holds the
kernel to its plain version on the same levels) and reports, per level,
on the card:

- ``device_us``: the wrapper in a CUDA graph (20 calls, replayed), the
  kernels' device time with no host work; ``path`` the plan it took;
- ``library_device_us``: one ``index_add_`` of the moment columns into a
  table, the same sums, in a CUDA graph;
- ``kept``: points whose id lies in ``[0, sz)``.

``--paths`` adds each level's time on every path the wrapper can be
told to take there (the A/B that sets the plan's thresholds);
``--profile`` the CUDA kernels of one whole build (17 calls) with their
device microseconds from ``torch.profiler``, memsets included;
``--floor`` the device time of 17 one-element ``add_`` kernels in one
CUDA graph, the launch floor of 17 dependent kernel nodes. Every line is
JSON and carries the card's name and power limit. Run on the card:

    python -m madicp_tpu_torch.probes.segsum_levels --paths --profile --floor
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from madicp_tpu_torch.kernels import segsum
from madicp_tpu_torch.utils.device import card_name, resolve_device
from madicp_tpu_torch.utils.timing import device_kernels, graph_ms

# flagship configuration of the JAX package's bench (bench.py:100-169)
N_POINTS, DEPTH = 131072, 16
REPS = 20


def kitti_like_world(rng, n_points=120000):
    """KITTI-ish geometry of the JAX bench (bench.py:66-93): ground, eight
    walls parallel to x, poles/clutter."""
    n_ground, n_walls = n_points // 2, n_points // 3
    n_rest = n_points - n_ground - n_walls
    r = rng.uniform(2.0, 60.0, n_ground)
    th = rng.uniform(-np.pi, np.pi, n_ground)
    ground = np.column_stack(
        [r * np.cos(th), r * np.sin(th), -1.7 + rng.normal(0, 0.02, n_ground)]
    )
    walls = []
    for i in range(8):
        d = 8.0 + 6.0 * i
        side = 1 if i % 2 == 0 else -1
        m = n_walls // 8
        walls.append(np.column_stack([
            rng.uniform(-40, 40, m), side * d + rng.normal(0, 0.01, m),
            rng.uniform(-1.5, 3.0, m),
        ]))
    rest = np.column_stack([
        rng.uniform(-30, 30, n_rest), rng.uniform(-30, 30, n_rest),
        rng.uniform(-1.5, 2.0, n_rest),
    ])
    return np.vstack([ground, np.vstack(walls)[:n_walls], rest])


def bench_pose(i: float):
    """Sensor pose of scan i on the bench drive: 1.4 m/scan, mild yaw."""
    c, s = np.cos(0.004 * i), np.sin(0.004 * i)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]]), np.array([1.4 * i, 0.05 * i, 0.0])


def capture_levels(points, valid, depth=DEPTH):
    """(d, idx, sz) of every level of one build, as ``build_tree`` hands
    them to the segment-sum."""
    import madicp_tpu_torch.ops.tree as tree_mod

    seen = []
    real = tree_mod.segsum_moments

    def record(d, idx, sz):
        seen.append((d.clone(), idx.clone(), sz))
        return real(d, idx, sz)

    tree_mod.segsum_moments = record
    try:
        tree_mod.build_tree(points, valid, depth=depth, b_max=0.2, b_min=0.1)
    finally:
        tree_mod.segsum_moments = real
    return seen


def flagship_levels(dtype, device, n_points=N_POINTS, depth=DEPTH):
    """The 17 segment-sum calls of one flagship build (seed 0, scan 3 of
    the bench drive, padded to ``n_points`` with invalid points)."""
    rng = np.random.default_rng(0)
    R, t = bench_pose(3)
    scan = ((kitti_like_world(rng) - t) @ R)[:n_points]
    pts = np.zeros((n_points, 3))
    pts[: len(scan)] = scan
    valid = torch.zeros(n_points, dtype=torch.bool, device=device)
    valid[: len(scan)] = True
    return capture_levels(torch.as_tensor(pts, dtype=dtype, device=device), valid, depth)


def library_call(d, idx, sz):
    """``index_add_`` of the moment columns into a table with a spare row
    for dropped ids: the same sums as one PyTorch call (the yardstick)."""
    ids = torch.where((idx >= 0) & (idx < sz), idx.long(), sz)
    mom = segsum._moment_columns(d)
    tab = torch.zeros((sz + 1, 10), dtype=d.dtype, device=d.device)
    return lambda: tab.index_add_(0, ids, mom)


def run(dtype=torch.float32, paths=False, profile=False, floor=False, emit=print):
    dev = resolve_device("cuda")
    card = card_name(dev)
    dname = str(dtype).split(".")[1]
    levels = flagship_levels(dtype, dev)
    sms = segsum.sm_count(dev)
    tot = dict(device_us=0.0, library_device_us=0.0)
    for d, idx, sz in levels:
        n = d.shape[0]
        row = {"probe": "segsum_levels", "dtype": dname, "sz": sz, "n": n,
               "kept": int(((idx >= 0) & (idx < sz)).sum()),
               "path": segsum.plan(n, sz, sms).path,
               "device_us": 1e3 * graph_ms(lambda: segsum.segsum_moments(d, idx, sz), REPS),
               "library_device_us": 1e3 * graph_ms(library_call(d, idx, sz), REPS)}
        if paths:
            want = segsum.segsum_moments_ref(d.double(), idx, sz)
            row["paths_us"] = {}
            for p in segsum.PATHS:
                pl = segsum.plan(n, sz, sms, path=p)
                if pl is None:
                    continue
                got = segsum.launch(d, idx, sz, pl)
                err = float((got.double() - want).abs().max() / want.abs().max())
                us = 1e3 * graph_ms(lambda pl=pl: segsum.launch(d, idx, sz, pl), REPS)
                row["paths_us"][p] = {"us": us, "max_rel_err": err}
        for k in tot:
            tot[k] += row[k]
        emit(json.dumps(dict(row, card=card)))
    emit(json.dumps({"probe": "segsum_levels", "dtype": dname, "per_build": tot,
                     "card": card}))
    if profile:
        by, wall = device_kernels(
            lambda: [segsum.segsum_moments(d, idx, sz) for d, idx, sz in levels])
        emit(json.dumps({"probe": "segsum_levels", "dtype": dname, "trace_one_build": {
            k: {"us": us, "count": c} for k, (us, c) in sorted(by.items())},
            "wall_ms": wall, "card": card}))
    if floor:
        x = torch.zeros(1, device=dev)

        def nodes():
            for _ in levels:
                x.add_(1)

        emit(json.dumps({"probe": "segsum_levels", "floor_17_nodes_us":
                         1e3 * graph_ms(nodes, 1, replays=50), "card": card}))
    return tot


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dtype", default="float32,float64",
                    help="comma-separated: float32, float64")
    ap.add_argument("--paths", action="store_true", help="time every path at each level")
    ap.add_argument("--profile", action="store_true", help="trace one build by CUDA kernel")
    ap.add_argument("--floor", action="store_true", help="17 one-element kernels in a graph")
    args = ap.parse_args(argv)
    for i, name in enumerate(args.dtype.split(",")):
        run(getattr(torch, name), args.paths, args.profile, args.floor and i == 0)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
