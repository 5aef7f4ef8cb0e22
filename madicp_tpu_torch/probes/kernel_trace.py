"""Per-launch device time of the tree build's point pass (K8) and of one
normal-equations call (K7) at the flagship configuration, graphed.

- ``build``: one ``build_tree`` of the bench's scan 1 (131072 points with
  the padding, depth 16) is captured whole in a CUDA graph and replayed
  ``reps`` times under ``torch.profiler``. For each K8 launch, in order
  (17 level passes, then the two pick kernels): its level, its
  ``__global__`` function with the template arguments, the plan's path,
  the level's segments ``nseg``, the live points, the device µs (median
  over the replays), the bound µs (:func:`build_levels.call_cost` at the
  H100's rates), the distinct nodes of its live points and the distinct
  (warp, node) pairs (32 points in index order a warp: the groups a
  warp-merged pass reduces one after the other).
- ``terms``: one ``terms_from_payload`` call at the flagship (16 keyframes
  x 32768 leaves of the bench's scan 1 against a primed ring, the
  round-0 payload of a pose near it), called ``reps`` times under
  ``torch.profiler``: every kernel the call launches, by name, with its
  median device µs.

``--paths`` adds the A/B that sets K8's plan: every level of the float32
and float64 builds on every path that can take it (:data:`build_points.PATHS`),
each held bit for bit to the plain version and timed in a CUDA graph
(:func:`graph_ms`); and K7 at the flagship's 16 and the fleet's 64
leading indices with every cluster size. ``chip_smoke.py``'s ``tree``
and ``assoc`` phases report the traces. Every line is JSON and carries
the card's name and power limit. Run on the card:

    python -m madicp_tpu_torch.probes.kernel_trace [--paths]
"""

from __future__ import annotations

import argparse
import json
import math
import re
import statistics

import numpy as np
import torch

from madicp_tpu_torch.kernels import build_points, icp_terms
from madicp_tpu_torch.probes import build_levels
from madicp_tpu_torch.utils.timing import bound_ms, device_trace, graph_ms

REPS = 5  # graph replays a trace


def short_name(name: str) -> str:
    """``stage_kernel<float>`` of a CUDA trace's full kernel name
    (the function and its template arguments), else the name itself."""
    m = re.search(r"::(\w+(?:<[^()]*>)?)\(", name)
    return m.group(1) if m else name


def traced_runs(run, reps: int) -> list:
    """The CUDA kernel records of ``run()``, which launches the same
    kernels ``reps`` times: ``reps`` lists of ``(short name, device µs)``
    in launch order, from one profiled window. Raises where the records
    do not split into ``reps`` equal runs: the profiler lost one."""
    records, _ = device_trace(run)
    per = len(records) // reps
    runs = [records[k * per:(k + 1) * per] for k in range(reps)]
    if not per or per * reps != len(records) or any(
            [r[0] for r in run] != [r[0] for r in runs[0]] for run in runs):
        raise RuntimeError(f"a profiled window of {reps} equal runs kept {len(records)} "
                           "kernel records that do not split into them")
    return [[(short_name(n), us) for n, _, us in run] for run in runs]


def graphed_records(fn, reps: int = REPS) -> list:
    """The CUDA kernel records of ``fn()`` captured in one CUDA graph and
    replayed ``reps`` times (:func:`traced_runs`)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the capture stream
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    runs = traced_runs(lambda: [graph.replay() for _ in range(reps)], reps)
    del graph
    return runs


def call_rows(calls, esize: int) -> list:
    """One row a recorded K8 call (:func:`build_levels.record_build`):
    its level, bound µs, and for a level pass its ``nseg``, plan path,
    live points, distinct nodes and distinct (warp, node) pairs."""
    dname = "float32" if esize == 4 else "float64"
    rows = []
    for c in calls:
        if c.name not in build_levels.KERNELS["build_points"]:
            continue
        nbytes, ops = build_levels.call_cost(c, esize)
        row = {"call": c.name, "level": c.kwargs.get("level"),
               "bound_us": bound_ms(nbytes, ops, dname)[0] * 1e3}
        if c.name == "build_points":
            idx, packA = c.args[2], c.args[5]
            nseg = packA.shape[0]
            live = (idx >= 0) & (idx < nseg)
            at = torch.nonzero(live)[:, 0]
            g = idx[at].long()
            row.update(nseg=nseg,
                       path=build_points.plan(idx.shape[0], nseg, c.args[0].dtype).path,
                       live=int(at.numel()), nodes=int(torch.unique(g).numel()),
                       warp_node_pairs=int(torch.unique((at >> 5) * nseg + g).numel()))
        rows.append(row)
    return rows


def build_trace(points, valid, *, depth, b_max, b_min, reps: int = REPS) -> list:
    """:func:`call_rows` of one graphed ``build_tree``, each with its
    ``__global__`` function and its device µs from torch.profiler (module
    doc)."""
    from madicp_tpu_torch.ops.tree import build_tree

    _, _, calls, _ = build_levels.record_build(points, valid, depth=depth, b_max=b_max,
                                               b_min=b_min)
    rows = call_rows(calls, points.element_size())
    runs = graphed_records(lambda: build_tree(points, valid, depth=depth, b_max=b_max,
                                              b_min=b_min), reps)
    runs = [[r for r in run if r[0].split("<")[0] in build_points.KERNEL_NAMES]
            for run in runs]
    if any(len(run) != len(rows) for run in runs):
        raise RuntimeError(f"{[len(r) for r in runs]} K8 records a replay, want {len(rows)}")
    for j, row in enumerate(rows):
        row.update(kernel=runs[0][j][0], device_us=statistics.median(run[j][1] for run in runs))
    return rows


def point_paths(calls, reps: int = 20) -> list:
    """Each recorded K8 level pass on every path that can take it: ``[{
    "level", "nseg", "plan", "paths": {path: device µs or None}}]``; a
    path whose results differ from the plain version's raises."""
    rows = []
    for c in calls:
        if c.name != "build_points":
            continue
        n, nseg, dtype = c.args[0].shape[0], c.args[5].shape[0], c.args[0].dtype
        plain_args = build_levels.copy_args(c.args)
        want = build_levels.results(c.name, build_points.build_points_plain(
            *plain_args, **c.kwargs), plain_args)
        row = {"level": c.kwargs["level"], "nseg": nseg,
               "plan": build_points.plan(n, nseg, dtype).path, "paths": {}}
        for path in build_points.PATHS:
            try:
                pl = build_points.plan(n, nseg, dtype, path=path)
            except ValueError:  # the table does not fit
                row["paths"][path] = None
                continue
            args = build_levels.copy_args(c.args)
            got = build_levels.results(c.name, build_points.launch(*args, **c.kwargs, pl=pl),
                                       args)
            for a, b in zip(got, want):
                if not build_levels.compare(a, b)[0]:
                    raise AssertionError(f"build_points level {row['level']} {path}: differs "
                                         "from the plain version")
            row["paths"][path] = graph_ms(
                lambda args=args, pl=pl: build_points.launch(*args, **c.kwargs, pl=pl),
                reps) * 1e3
        rows.append(row)
    return rows


def terms_plans(args, kw, reps: int = 20) -> dict:
    """Device µs of one ``icp_terms`` call launched with every block size
    of :data:`icp_terms.BLOCKS` and every cluster size that the card holds
    in one wave and that gives a thread its entries, beside the clusters
    of each it holds at once: ``{"threads x cluster": [µs or None,
    clusters]}``; and the plan the wrapper takes."""
    dev, dtype = args[0].device, args[0].dtype
    capacity = icp_terms.card_capacity(dev, dtype)
    lead = torch.broadcast_shapes(args[0].shape[:-2], args[1].shape[:-2], args[3].shape[:-2])
    n_lead, L = math.prod(lead), args[0].shape[-2]
    out = {"plan": icp_terms.plan(n_lead, L, capacity)._asdict()}
    for threads in icp_terms.BLOCKS:
        for cluster in range(1, icp_terms.MAX_CLUSTER + 1):
            # the plan on a card that holds this shape alone
            pl = icp_terms.plan(n_lead, L, lambda t, c, want=(threads, cluster):
                                n_lead if (t, c) == want else 0)
            fits = (n_lead <= capacity(threads, cluster)
                    and (pl.threads, pl.cluster) == (threads, cluster))
            out[f"{threads}x{cluster}"] = [
                graph_ms(lambda pl=pl: icp_terms.launch(*args, **kw, pl=pl), reps) * 1e3
                if fits else None, capacity(threads, cluster)]
    return out


def terms_trace(args, kw, reps: int = REPS) -> list:
    """Every kernel of one ``icp_terms.terms(*args, **kw)`` call, in launch
    order: ``[{"kernel", "device_us"}]``, the median over ``reps`` eager
    calls under torch.profiler (the call allocates its outputs, so it
    runs no kernel but its own)."""
    icp_terms.terms(*args, **kw)
    runs = traced_runs(lambda: [icp_terms.terms(*args, **kw) for _ in range(reps)], reps)
    return [{"kernel": name, "device_us": statistics.median(run[j][1] for run in runs)}
            for j, (name, _) in enumerate(runs[0])]


def flagship_terms_args(device, dtype):
    """(args, kwargs) of one flagship ``icp_terms.terms`` call: the bench's
    scan 1's leaves (32768) against its primed ring of 16 trees, the
    round-0 payload of a pose 2 cm off the scan's, shaped as the pipeline
    hands them over."""
    from madicp_tpu_torch import bench
    from madicp_tpu_torch.kernels import descent
    from madicp_tpu_torch.ops.tree import build_tree, get_leaves
    from madicp_tpu_torch.probes.segsum_levels import bench_pose

    setup = bench.BenchSetup(device, 131072, 16, 16, 32768)
    pipe = setup.make_pipe("certified")
    setup.prime(pipe)
    cfg = pipe.cfg
    pts, val, _ = pipe.stage(setup.scan_at(1))
    tree, _ = build_tree(pts, val, depth=cfg.depth, b_max=cfg.b_max, b_min=cfg.b_min)
    leaves = get_leaves(tree, cfg.leaves_cap)
    R, t = bench_pose(1)
    X = np.eye(4)
    X[:3, :3], X[:3, 3] = R, t + np.array([0.02, -0.01, 0.0])
    nav = pipe.state.kf_tree.nav.to(dtype)
    K, M = nav.shape[0], nav.shape[1]
    L = leaves.pts.shape[0]
    lp = leaves.pts.to(dtype)
    Xt = torch.as_tensor(X, dtype=dtype, device=device)
    q = (lp @ Xt[:3, :3].mT + Xt[:3, 3]).expand(K, L, 3).reshape(K * L, 3)
    base = (torch.arange(K, device=device) * M)[:, None].expand(K, L).reshape(K * L)
    valid = leaves.valid[None].expand(K, L).reshape(K * L)
    _, payload, _ = descent.descend(nav.reshape(K * M, 56), q, base, cfg.depth, valid=valid,
                                    return_blocks=True, return_margin=True)
    args = (payload.view(1, K, L, 8), lp[None, None], leaves.valid[None, None], Xt[None, None])
    return args, dict(b_max=cfg.b_max, b_ratio=cfg.b_ratio, rho_ker=cfg.rho_ker)


def main(argv=None) -> int:
    from madicp_tpu_torch import bench
    from madicp_tpu_torch.utils.device import card_name

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=REPS)
    ap.add_argument("--paths", action="store_true",
                    help="every K8 level on every path, K7 with every cluster size")
    a = ap.parse_args(argv)
    dev = torch.device("cuda")
    smi = card_name(dev)
    setup = bench.BenchSetup(dev, 131072, 16, 16, 32768)
    scan = setup.scan_at(1)
    pts = np.zeros((131072, 3))
    pts[:len(scan)] = scan
    for dtype in (torch.float32, torch.float64):
        dname = str(dtype).split(".")[1]
        points = torch.as_tensor(pts, dtype=dtype, device=dev)
        valid = torch.arange(131072, device=dev) < len(scan)
        kw = dict(depth=16, b_max=0.2, b_min=0.1)
        rows = build_trace(points, valid, **kw, reps=a.reps)
        print(json.dumps({"part": "build", "dtype": dname, "nvidia_smi": smi,
                          "device_us": sum(r["device_us"] for r in rows),
                          "bound_us": sum(r["bound_us"] for r in rows), "calls": rows}),
              flush=True)
        if a.paths:
            _, _, calls, _ = build_levels.record_build(points, valid, **kw)
            print(json.dumps({"part": "build_paths", "dtype": dname, "nvidia_smi": smi,
                              "levels": point_paths(calls)}), flush=True)
            del calls
        args, tkw = flagship_terms_args(dev, dtype)
        print(json.dumps({"part": "terms", "dtype": dname, "nvidia_smi": smi,
                          "kernels": terms_trace(args, tkw, a.reps)}), flush=True)
        if a.paths:
            fleet = (args[0].expand(4, 16, *args[0].shape[2:]),) + args[1:]
            print(json.dumps({"part": "terms_plans", "dtype": dname, "nvidia_smi": smi,
                              "leads_16": terms_plans(args, tkw),
                              "leads_64": terms_plans(fleet, tkw)}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
