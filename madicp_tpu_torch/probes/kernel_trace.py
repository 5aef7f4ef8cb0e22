"""Per-launch device time of the hand-written kernels at the flagship
configuration (16 keyframes x 32768 leaves, 131072 points, depth 16), the
parts named by ``--parts`` (default: ``build``, ``terms``, ``descent``,
``ring``, ``nodes``, ``resources`` and ``gn``):

- ``build``: one ``build_tree`` of the bench's scan 1 captured whole in a
  CUDA graph and replayed in ``reps`` profiled windows. For each K8
  launch, in order (17 level passes, then the two pick kernels): its
  level, its ``__global__`` function with the template arguments, the
  plan's path, the level's segments ``nseg``, the live points, the device
  µs (median over the replays), the bound µs (:func:`build_levels.call_cost`
  at the H100's rates), the distinct nodes of its live points and the
  distinct (warp, node) pairs.
- ``nodes``: the same for K9 (17 node passes and the close: level, nodes,
  blocks, node kernel, device and bound µs), for the bench's scan and
  for a B = 4 batch of its scans 1-4; with the launch floor (a
  one-element ``add_``, device µs and graphed µs a launch).
- ``terms``: one ``terms_from_payload`` call on the round-0 payload of a
  pose near scan 1: every kernel it launches, with its median device µs;
  then K7 and K11 at the benchmark's 16 keyframes x 131,072 leaf slots
  with a scan's valid leaves a prefix of 131,072, 59,000 (a KITTI scan)
  and 28,000 (a MulRan sweep) slots, each walking every slot and bounded
  by the leaf count (:func:`bounded_terms`: graphed device µs a call, and
  whether the bounded calls give the unbounded ones' flags).
- ``descent``: K6 at a certified round 0, a later certified round (16%
  of the entries live), the fast warm start and a live-share sweep (0%,
  16%, 100%): live entries, panel reads, distinct panels, bound µs,
  kernel µs (median of ``reps`` eager calls under torch.profiler) and
  graphed µs a call. ``ring`` (with ``descent``) adds the ring form the
  step launches (scan-frame leaves and the pose), the merged later round
  and the round as the step runs it.
- ``resources``: each K6 and K9 kernel's registers, stack and spills from
  ``nvcc -Xptxas -v`` and the threads an SM holds at that count.
- ``gn``: a certified round's pose update and slack pass on the
  flagship's real normal equations (the round-0 payload of scan 1 under
  B poses 1 cm apart, B = 1 and 4): K10's and K11's registers, spills
  and SASS instructions; the GN update as the plain chain (``solve_gn``,
  ``clamp_step``, ``exp_se3_split``, the product; each step's kernels
  and graphed µs, and the whole); the keyframe sums the step formed with
  two einsums; K10 ``gn_update`` on the summed and on the per-keyframe
  terms, its plain version and a stamped variant's cycles a phase
  (:func:`gn_stamps`); K11 ``certify_slack`` warm and after an
  L2 flush, its launch's share of the card, and its plain version.
- ``step``: the bench's certified, exact and fast schedules graphed
  (median scans/s, device busy ms and kernels a scan; certified's 8
  poses and every kernel's µs a call in two graphed scans) and fleets of
  B = 1, 2 and 4, each beside an eager twin (scans/s, host enqueue ms).
- ``deskew``: the step's deskew (``ops/deskew.py`` ``deskew_scan``) of
  MulRan-shaped sweeps (``probes/deskew_drive.py``) in both modes, float32
  and float64, B = 1 and 4, each sweep in draw order and in column
  order: every kernel of one graphed call with its device µs and kind
  (the sort, K12, the other tensor ops), graphed and eager µs a call, and
  whether a capture runs with no host sync; then the certified flagship
  drive graphed with deskew off and in both modes, twice in turns
  (:func:`deskew_rates`: scans/s, device busy ms and kernels a scan, the
  deskew phase's ms, the distance to the truth). Not in the default.
- ``tail``: the step's constant-velocity prediction and its tail
  (everything after the round loop up to the new state,
  :func:`tail_region`) for the certified flagship, float32 and float64,
  B = 1 and 4, on a scan where every sequence promotes and on one where
  none does: every kernel with its device µs and the line of
  ``_phased_step`` and the innermost package line that issued it (a
  marker kernel a line, :func:`step_lines`), the copies ``write_state``
  makes after the step by its line, and from a replay of the step
  captured whole, the prediction's, the tail's and the copies' graphed
  device µs and kernel counts (:func:`tail_trace`); then, on a recorded
  step's operands at each B, the cycles of each warp of K14's tail
  between its phases (:func:`tail_stamps`). Not in the default.
- ``rates``: the deskew part's certified flagship drive alone
  (:func:`deskew_rates`, one round: deskew off, reference, binned). Not
  in the default.
- ``step_ops``: where the step's library GEMMs come from: one eager step
  of each schedule of :data:`bench.SCHEDULES` at B = 1 and of the
  certified one at the fleet's B = 11, on the bench's primed scan stream
  at the benchmark's leaf count (:func:`step_ops`): every kernel whose
  name is a GEMM's and every kernel the association's descents issue,
  each with the package lines that issued it (:func:`step_lines`). Not
  in the default.

``--paths`` adds the A/Bs that set the plans: every K8 level on every
path that can take it (:data:`build_points.PATHS`), every K9 call on both
node kernels (:data:`build_nodes.PATHS`), K7 at the flagship's 16 and
the fleet's 64 leading indices with every cluster size (and at the
bounded 59,000 and 28,000 leaves of 131,072), each held bit
for bit to the plain version and timed in a CUDA graph (:func:`graph_ms`). ``chip_smoke.py``'s ``tree``
and ``assoc`` phases report the traces. Every line is JSON and carries
the card's name and power limit. Run on the card:

    python -m madicp_tpu_torch.probes.kernel_trace [--parts a,b,...] [--paths]
"""

from __future__ import annotations

import argparse
import contextlib
import itertools
import json
import math
import re
import statistics
import time
from typing import NamedTuple

import numpy as np
import torch

from madicp_tpu_torch.kernels import build, build_nodes, build_points, descent, icp_terms
from madicp_tpu_torch.probes import build_levels
from madicp_tpu_torch.utils.timing import bound_ms, device_trace, graph_ms

REPS = 5  # graph replays a trace
PARTS = ("build", "terms", "descent", "ring", "nodes", "resources", "gn", "step", "deskew",
         "tail", "rates", "step_ops")
DEFAULT_PARTS = PARTS[:-5]
# a later certified round's uncertified share: a certified flagship scan
# descends 1.71 M entries, 0.52 M of them in round 0, and each of the other
# 14 rounds hands the descent 0.52 M entries of which ~16% are live
LIVE = 0.16
LIVE_SEED = 5
SWEEP = (0.0, 0.16, 1.0)  # live shares of the sweep
DESCENT_FLOPS_PER_PANEL = 8  # the side value: 3 subtractions, 3 products, 2 adds


def short_name(name: str) -> str:
    """``stage_kernel<float>`` of a CUDA trace's full kernel name
    (the function and its template arguments), else the name itself."""
    m = re.search(r"::(\w+(?:<[^()]*>)?)\(", name)
    return m.group(1) if m else name


def windows(fn, reps: int) -> list:
    """The CUDA kernel records of ``fn()`` in profiled windows of one
    call each: up to ``reps`` lists of ``(short name, device µs)`` in
    launch order. The profiler on the card drops records (a flagship
    build's window kept 97 of its 98; most windows of one short kernel
    kept none), so windows that kept fewer records than the most any
    kept are dropped, up to ``5 reps`` windows are taken, and the full
    ones are returned (at least one); raises where none kept a record or
    the full ones disagree on the kernels."""
    kept, most = [], 0
    for _ in range(5 * reps):
        w = [(short_name(n), us) for n, _, us in device_trace(fn)[0]]
        if len(w) > most:
            kept, most = [], len(w)
        if w and len(w) == most:
            kept.append(w)
        if len(kept) == reps:
            break
    if not kept or any([r[0] for r in w] != [r[0] for r in kept[0]] for w in kept):
        raise RuntimeError(f"{len(kept)} of {5 * reps} profiled windows kept {most} kernel "
                           "records in one order")
    return kept


def graphed_records(fn, reps: int = REPS) -> list:
    """:func:`windows` of one replay of ``fn()`` captured in a CUDA graph."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the capture stream
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    runs = windows(graph.replay, reps)
    del graph
    return runs


def call_rows(calls, esize: int, kernel: str = "build_points") -> list:
    """One row a recorded call of ``kernel`` (K8 ``build_points`` or K9
    ``build_nodes``; :func:`build_levels.record_build`): its level and
    bound µs; for a K8 level pass its ``nseg``, plan path, live points,
    distinct nodes and distinct (warp, node) pairs; for a K9 call its
    ``nseg``, blocks and node kernel."""
    dname = "float32" if esize == 4 else "float64"
    rows = []
    for c in calls:
        if c.name not in build_levels.KERNELS[kernel]:
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
        elif kernel == "build_nodes":
            nseg = c.args[0].shape[0]
            row.update(nseg=nseg, blocks=-(-nseg // build_nodes.THREADS),
                       path=build_nodes.plan(nseg) if c.name == "build_nodes" else None)
        rows.append(row)
    return rows


def build_trace(points, valid, *, depth, b_max, b_min, reps: int = REPS,
                kernel: str = "build_points") -> list:
    """:func:`call_rows` of ``kernel`` in one graphed ``build_tree``, each
    with its ``__global__`` function and its device µs from
    torch.profiler (module doc)."""
    from madicp_tpu_torch.ops.tree import build_tree

    _, _, calls, _ = build_levels.record_build(points, valid, depth=depth, b_max=b_max,
                                               b_min=b_min)
    rows = call_rows(calls, points.element_size(), kernel)
    runs = graphed_records(lambda: build_tree(points, valid, depth=depth, b_max=b_max,
                                              b_min=b_min), reps)
    names = {"build_points": build_points.KERNEL_NAMES,
             "build_nodes": build_nodes.KERNEL_NAMES}[kernel]
    runs = [[r for r in run if r[0].split("<")[0] in names] for run in runs]
    if any(len(run) != len(rows) for run in runs):
        raise RuntimeError(f"{[len(r) for r in runs]} {kernel} records a replay, want "
                           f"{len(rows)}")
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


def node_paths(calls, reps: int = 20) -> list:
    """Each recorded K9 call on both node kernels (:data:`build_nodes.PATHS`;
    the close as it is): ``[{"call", "level", "nseg", "plan", "paths":
    {path: device µs}}]``, each held bit for bit to the plain version and
    timed in a CUDA graph (:func:`graph_ms`)."""
    rows = []
    for c in calls:
        if c.name not in build_levels.KERNELS["build_nodes"]:
            continue
        plain_args = build_levels.copy_args(c.args)
        want = build_levels.results(c.name, build_levels.PLAIN[c.name](*plain_args, **c.kwargs),
                                    plain_args)
        nseg = c.args[0].shape[0]
        paths = build_nodes.PATHS if c.name == "build_nodes" else (None,)
        row = {"call": c.name, "level": c.kwargs["level"], "nseg": nseg,
               "plan": build_nodes.plan(nseg) if c.name == "build_nodes" else None,
               "paths": {}}
        fn = getattr(build_nodes, c.name)
        for path in paths:
            kw = dict(c.kwargs) if path is None else dict(c.kwargs, path=path)
            args = build_levels.copy_args(c.args)
            got = build_levels.results(c.name, fn(*args, **kw), args)
            for a, b in zip(got, want):
                if not build_levels.compare(a, b)[0]:
                    raise AssertionError(f"{c.name} level {row['level']} {path}: differs from "
                                         "the plain version")
            row["paths"][str(path)] = graph_ms(lambda args=args, kw=kw: fn(*args, **kw),
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
    runs = windows(lambda: icp_terms.terms(*args, **kw), reps)
    return [{"kernel": name, "device_us": statistics.median(run[j][1] for run in runs)}
            for j, (name, _) in enumerate(runs[0])]


BOUNDED_L = 131072  # the benchmark's leaf slots a scan (max_leaves 0: n_points)
BOUNDED_LIVE = (131072, 59000, 28000)  # every slot; a KITTI scan's leaves; a MulRan sweep's


def bounded_terms(device, dtype, reps: int = 20, paths: bool = False) -> list:
    """K7 and K11 on a certified round's synthetic inputs
    (:func:`~madicp_tpu_torch.probes.gn_cases.round_inputs`, B = 1, 16
    keyframes, :data:`BOUNDED_L` leaf slots) with the valid leaves a
    prefix of ``n`` slots, for each ``n`` of :data:`BOUNDED_LIVE`: the
    graphed device µs a call (``reps`` calls a graph) of K7 walking every
    slot (no ``n_live``), bounded by ``n`` with and without ``matched``,
    and of K11 walking every slot and bounded; whether the bounded calls'
    ``matched``, ``need``, count and slack below the bound equal the
    unbounded calls' and H, b's largest relative gap. With ``paths``, K7
    bounded in every block and cluster shape (:func:`terms_plans`)."""
    from madicp_tpu_torch.kernels import certify_slack
    from madicp_tpu_torch.probes.gn_cases import TERMS_KW, round_inputs

    r = {k: v.to(device) for k, v in round_inputs(dtype, B=1, K=16, L=BOUNDED_L).items()}
    rows = []
    for n in BOUNDED_LIVE:
        valid = torch.arange(BOUNDED_L, device=device)[None] < n  # (1, L): a prefix
        nl = torch.tensor([n], dtype=torch.int64, device=device)
        args = (r["payload"], r["pts"][:, None], valid[:, None], r["Xp"][:, None])
        full = icp_terms.terms(*args, **TERMS_KW)
        bounded = icp_terms.terms(*args, **TERMS_KW, n_live=nl[:, None])
        gap = max(float(((a.double() - w.double()).abs().max() / w.double().abs().max()))
                  for a, w in zip(bounded[:2], full[:2]))
        slack = [r["slack"].clone() for _ in range(2)]
        count = [r["n_descents"].clone() for _ in range(2)]

        def slack_pass(i, live=None):
            return certify_slack.certify_slack(slack[i], r["Xp"], r["X"], r["pts"], r["r_norm"],
                                               valid, r["kf_live"], count[i], n_live=live)

        need = (slack_pass(0), slack_pass(1, nl))
        row = {"n_live": n, "slots": BOUNDED_L, "keyframes": 16,
               "matched_equal": torch.equal(full[2], bounded[2]), "h_b_rel_gap": gap,
               "need_equal": torch.equal(*need), "count_equal": torch.equal(*count),
               "slack_equal_below": torch.equal(slack[0][..., :n], slack[1][..., :n])}
        row["k7_full_us"] = graph_ms(lambda: icp_terms.terms(*args, **TERMS_KW), reps) * 1e3
        row["k7_bounded_us"] = graph_ms(
            lambda: icp_terms.terms(*args, **TERMS_KW, n_live=nl[:, None]), reps) * 1e3
        row["k7_bounded_no_matched_us"] = graph_ms(
            lambda: icp_terms.terms(*args, **TERMS_KW, n_live=nl[:, None], with_matched=False),
            reps) * 1e3
        row["k11_full_us"] = graph_ms(lambda: slack_pass(0), reps) * 1e3
        row["k11_bounded_us"] = graph_ms(lambda: slack_pass(1, nl), reps) * 1e3
        if paths:
            row["k7_bounded_plans"] = terms_plans(args, dict(TERMS_KW, n_live=nl[:, None]))
        rows.append(row)
    return rows


class Flagship(NamedTuple):
    """The association's inputs at the flagship: the bench's primed ring
    of 16 trees (float32), the leaves of its scan 1, a pose 2 cm off the
    scan's and the pipeline's configuration."""
    cfg: object
    ring: torch.Tensor  # (K, M, 56)
    leaves: object  # ops.tree.Leaves, L = 32768
    X: np.ndarray  # (4, 4)


def flagship_assoc(device) -> Flagship:
    from madicp_tpu_torch import bench
    from madicp_tpu_torch.ops.tree import build_tree, get_leaves
    from madicp_tpu_torch.probes.segsum_levels import bench_pose

    setup = bench.BenchSetup(device, 131072, 16, 16, 32768)
    pipe = setup.make_pipe("certified")
    setup.prime(pipe)
    cfg = pipe.cfg
    pts, val, _ = pipe.stage(setup.scan_at(1))
    tree, _ = build_tree(pts, val, depth=cfg.depth, b_max=cfg.b_max, b_min=cfg.b_min)
    R, t = bench_pose(1)
    X = np.eye(4)
    X[:3, :3], X[:3, 3] = R, t + np.array([0.02, -0.01, 0.0])
    return Flagship(cfg, pipe.state.kf_tree.nav.clone(), get_leaves(tree, cfg.leaves_cap), X)


def descent_inputs(fl: Flagship, dtype) -> dict:
    """The descent's flagship inputs in ``dtype``, as the step hands them
    over (every (keyframe, leaf) entry, keyframe-major): the flat table
    ``nav`` (K M, 56), the scan-frame leaves ``pts`` (1, L, 3), the pose
    ``X`` (1, 4, 4), the map-frame queries ``q`` (K L, 3) (``moving_in_map``:
    the ring form's in-kernel query) for the flat form, ``base`` (K
    L,), ``need`` (K, L) the live entries, ``later`` (K, L) a later
    certified round's uncertified share (:data:`LIVE`, seed
    :data:`LIVE_SEED`), and round 0's ``ids``, ``payload``, ``margin`` (K,
    L, ...)."""
    dev = fl.ring.device
    K, M = fl.ring.shape[:2]
    L = fl.leaves.pts.shape[0]
    lp = fl.leaves.pts.to(dtype)
    Xt = torch.as_tensor(fl.X, dtype=dtype, device=dev)
    nav = fl.ring.reshape(K * M, 56).to(dtype)
    q = icp_terms.moving_in_map(lp, Xt).expand(K, L, 3).reshape(K * L, 3)
    base = (torch.arange(K, device=dev) * M)[:, None].expand(K, L).reshape(K * L)
    need = fl.leaves.valid[None].expand(K, L).contiguous()
    later = need & live_mask((K, L), LIVE, dev)
    ids, payload, margin = descent.descend(nav, q, base, fl.cfg.depth, valid=need.reshape(-1),
                                           return_blocks=True, return_margin=True)
    return dict(nav=nav, pts=lp[None], X=Xt[None], q=q, base=base, need=need, later=later,
                ids=ids.view(K, L), payload=payload.view(K, L, 8), margin=margin.view(K, L))


def live_mask(shape, share: float, device) -> torch.Tensor:
    """A random ``share`` of the entries (numpy seed :data:`LIVE_SEED`)."""
    return torch.from_numpy(np.random.default_rng(LIVE_SEED).random(shape) < share).to(device)


def descent_cost(nav, q, base, depth, kw: dict) -> dict:
    """What one descent call needs (:func:`descent.panel_reads`): the
    panels read, the distinct ones, and the bound's bytes: each distinct
    panel once, each entry's query, base, valid flag and outputs (id,
    block, margin where asked), a warm start's node."""
    esize = nav.element_size()
    valid = kw.get("valid")
    _, _, _, keys = descent.panel_reads(nav, q, base, depth, valid, kw.get("start"),
                                        kw.get("n_gathers"), kw.get("return_blocks", False))
    Q = q.shape[0]
    distinct = int(torch.unique(keys).numel())
    nbytes = (distinct * 8 * esize + Q * (3 * esize + 8 + 1 + 8)
              + (Q * 8 * esize if kw.get("return_blocks") else 0)
              + (Q * 8 if "start" in kw else 0) + (Q * esize if kw.get("return_margin") else 0))
    return {"panel_reads": int(keys.numel()), "distinct_panels": distinct, "bytes": nbytes,
            "operations": int(keys.numel()) * DESCENT_FLOPS_PER_PANEL}


def ring_cost(nav, queries, X, depth, need, start=None, n_gathers=None, return_margin=False,
              merged=False) -> dict:
    """What one :func:`descent.descend_ring` call needs, as
    :func:`descent_cost` counts it: ``nav`` (T, M, 56), ``queries`` (G, Q,
    3) in the scan frame, ``X`` (P, 4, 4) their poses, ``need`` (T, Q).
    The scan-frame queries are read once a group (as many bytes as
    map-frame ones) and the poses once; ``merged`` (``out`` given)
    descends and writes only the ``need`` entries, and reads the others'
    flags alone."""
    T, M = nav.shape[:2]
    G, Q = queries.shape[:2]
    esize = nav.element_size()
    flat = nav.reshape(T * M, 56)
    mapped = icp_terms.moving_in_map(queries, X.repeat_interleave(G // X.shape[0], dim=0))
    q = mapped[:, None].expand(G, T // G, Q, 3).reshape(T * Q, 3)
    base = (torch.arange(T, device=nav.device) * M)[:, None].expand(T, Q).reshape(T * Q)
    live = need.reshape(-1)
    kw = dict(start=None if start is None else start.reshape(-1), n_gathers=n_gathers,
              return_blocks=True)
    if merged:
        sel = lambda t: None if t is None else t[live]  # noqa: E731
        _, _, _, keys = descent.panel_reads(flat, q[live], base[live], depth, None,
                                            sel(kw["start"]), n_gathers, True)
        n = int(live.sum())
        nbytes = T * Q + n * 3 * esize
    else:
        _, _, _, keys = descent.panel_reads(flat, q, base, depth, live, **kw)
        n = T * Q
        nbytes = T * Q + G * Q * 3 * esize
    distinct = int(torch.unique(keys).numel())
    nbytes += (distinct * 8 * esize + n * (8 + 8 * esize) + (n * esize if return_margin else 0)
               + (n * 8 if start is not None else 0) + X.shape[0] * 16 * esize)
    return {"descended": n, "panel_reads": int(keys.numel()), "distinct_panels": distinct,
            "bytes": nbytes, "operations": int(keys.numel()) * DESCENT_FLOPS_PER_PANEL}


def launch_us(fn, reps: int = REPS, parts: dict = None) -> dict:
    """``graph_us``: the device µs of one ``fn()``, captured 20 times in a
    CUDA graph (gaps between launches included); ``kernels``: every kernel
    it launches, in order, with its median device µs over profiled eager
    calls (:func:`windows`; a kernel's device time is the same in a
    graph), or None with the reason where the profiler kept no full
    window; ``parts_graph_us``: the same graphed µs of each of ``parts``
    (name: callable), the steps of ``fn`` on their own."""
    fn()
    out = {"graph_us": graph_ms(fn, 20) * 1e3}
    try:
        runs = windows(fn, reps)
        out["kernels"] = [{"kernel": name,
                           "device_us": statistics.median(r[j][1] for r in runs)}
                          for j, (name, _) in enumerate(runs[0])]
        out["profiled_calls"] = len(runs)
    except RuntimeError as e:  # the trace is lost, the graphed times stand
        out["kernels"], out["profiler"] = None, str(e)
    if parts:
        out["parts_graph_us"] = {name: graph_ms(p, 20) * 1e3 for name, p in parts.items()}
    return out


def descent_cases(inp: dict, depth: int) -> dict:
    """The keyword arguments of the traced descent cases: a certified
    round 0 (every live entry), a later certified round (:data:`LIVE` of
    them uncertified), the fast schedule's warm start (6 levels up, 3
    gathers), and the live-share sweep (:data:`SWEEP`) at the later
    round's form."""
    need = inp["need"].reshape(-1)
    full = dict(valid=need, return_blocks=True, return_margin=True)
    cases = {"round0": full,
             "later_round": dict(full, valid=inp["later"].reshape(-1)),
             "warm": dict(valid=need, start=inp["ids"].reshape(-1) >> 6, n_gathers=3,
                          return_blocks=True)}
    for share in SWEEP:
        mask = live_mask(inp["need"].shape, share, need.device).reshape(-1)
        cases[f"live_{share:g}"] = dict(full, valid=need & mask)
    return cases


def merged_round(nav, depth, pts, X, need, ids, payload, slack):
    """A certified re-association round as the step runs it
    (``models/pipeline.py`` ``icp_rounds``, ``certify_compact`` 0): the
    ``need`` (B, K, L) entries descended with the scan-frame leaves ``pts``
    (B, L, 3) mapped by their sequence's pose ``X`` (B, 4, 4) in the kernel
    and merged into ``ids``, ``payload``, ``slack`` in place."""
    from madicp_tpu_torch.ops.icp_core import associate_ring

    B, K, Q = need.shape
    return associate_ring(nav.view(B * K, -1, nav.shape[-1]), depth, pts, need.reshape(B * K, Q),
                          X=X, return_margin=True,
                          out=tuple(o.view((B * K,) + o.shape[2:]) for o in (ids, payload, slack)))


def descent_trace(fl: Flagship, dtype, reps: int = REPS, ring: bool = False) -> dict:
    """K6 at the flagship in ``dtype``: each case of :func:`descent_cases`
    (its live entries, panel reads, distinct panels, bound µs, its
    kernel's device µs and the graphed µs of a call). ``ring`` adds the
    ring form of the cases (the scan-frame leaves (1, L, 3) and the pose
    for the K trees, each query mapped in the kernel), the merged later
    round (only its live entries descended and written in place) and the
    round as the step runs it (:func:`merged_round`, at the later round's
    share)."""
    inp = descent_inputs(fl, dtype)
    depth = fl.cfg.depth
    dname = str(dtype).split(".")[1]
    nav, q, base = inp["nav"], inp["q"], inp["base"]
    K, L = inp["need"].shape
    out = {}
    calls = {}
    for case, kw in descent_cases(inp, depth).items():
        cost = descent_cost(nav, q, base, depth, kw)
        calls[case] = lambda kw=kw: descent.descend(nav, q, base, depth, **kw)
        out[case] = {"live": int(kw["valid"].sum()), **cost,
                     "bound_us": bound_ms(cost["bytes"], cost["operations"], dname)[0] * 1e3,
                     **launch_us(calls[case], reps)}
    if ring:
        ring_nav = nav.view(K, -1, 56)
        pts, X = inp["pts"], inp["X"]  # the step's operands: (1, L, 3) and (1, 4, 4)
        args = (nav, depth, pts, X, inp["later"][None])
        bufs = (inp["ids"][None].clone(), inp["payload"][None].clone(),
                inp["margin"][None].clone())
        flat = {"round0": dict(need=inp["need"], return_margin=True),
                "later_round": dict(need=inp["later"], return_margin=True),
                "later_merged": dict(need=inp["later"], return_margin=True,
                                     out=tuple(b[0] for b in bufs))}
        for case, kw in flat.items():
            calls[f"ring_{case}"] = lambda kw=kw: descent.descend_ring(ring_nav, pts, depth, X=X,
                                                                       **kw)
            out[f"ring_{case}"] = launch_us(calls[f"ring_{case}"], reps)
            cost = ring_cost(ring_nav, pts, X, depth, kw["need"], return_margin=True,
                             merged="out" in kw)
            out[f"ring_{case}"].update(
                cost, bound_us=bound_ms(cost["bytes"], cost["operations"], dname)[0] * 1e3)
        out["round_merged"] = launch_us(
            lambda: merged_round(*args, *bufs), reps,
            {"descend, merged": calls["ring_later_merged"]})
    return out


def floor_us(device, reps: int = 200) -> dict:
    """The launch floor: a one-element ``add_`` (a kernel that does
    nothing measurable) ``reps`` times in one CUDA graph: its device µs
    under the profiler and the graph's µs a launch (gaps included)."""
    x = torch.zeros(1, device=device)
    kernel = launch_us(lambda: x.add_(1.0))["kernels"][0]
    return {**kernel, "graph_us_a_launch": graph_ms(lambda: x.add_(1.0), reps) * 1e3}


def flagship_clouds(device, dtype) -> dict:
    """{case: (points, valid)} of the K9 trace: the bench's scan 1 padded
    to 131072 points, and a B = 4 fleet batch of its scans 1-4."""
    from madicp_tpu_torch import bench

    setup = bench.BenchSetup(device, 131072, 16, 16, 32768)
    out = {}
    for name, scans in (("bench_scan", [1]), ("fleet_b4", [1, 2, 3, 4])):
        pts = np.zeros((len(scans), 131072, 3))
        valid = np.zeros((len(scans), 131072), dtype=bool)
        for b, i in enumerate(scans):
            scan = setup.scan_at(i)
            pts[b, :len(scan)], valid[b, :len(scan)] = scan, True
        squeeze = (lambda a: a[0]) if len(scans) == 1 else (lambda a: a)
        out[name] = (torch.as_tensor(squeeze(pts), dtype=dtype, device=device),
                     torch.as_tensor(squeeze(valid), device=device))
    return out


def resident_threads(registers: int, threads: int) -> int:
    """Threads an H100 SM holds of a kernel with no shared memory, from
    its registers a thread (allocated 256 a warp at a time) and block
    size: at most 64 warps and 32 blocks an SM, 65536 registers."""
    warps = threads // 32
    per_block = -(-registers * 32 // 256) * 256 * warps
    return min(65536 // per_block, 64 // warps, 32) * threads


def ptxas_usage(names=("descent", "build_nodes")) -> dict:
    """``{source: {kernel: {registers, stack, spill_stores, spill_loads}}}``
    from ``nvcc -Xptxas -v`` on each CUDA source (built with the
    package's flags, all at once, into a scratch directory)."""
    import subprocess
    import tempfile

    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as tmp:
        procs = {n: subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o", f"{tmp}/{n}.so",
             str(build.CSRC / f"{n}.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for n in names}
        logs = {n: p.communicate()[0] for n, p in procs.items()}
    out = {}
    for n, log in logs.items():
        rows, cur = {}, None
        for line in log.splitlines():
            m = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)", line)
            if m:
                cur = rows.setdefault(m.group(1), {})
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                          r"(\d+) bytes spill loads", line)
            if m and cur is not None:
                cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                           spill_loads=int(m.group(3)))
            m = re.search(r"Used (\d+) registers", line)
            if m and cur is not None:
                cur["registers"] = int(m.group(1))
        rows = {k: v for k, v in rows.items() if "registers" in v}  # entry functions
        if not rows:
            raise RuntimeError(f"nvcc -Xptxas -v printed no kernel for {n}:\n{log}")
        out[n] = {demangled: rows[m] for m, demangled in zip(rows, demangle(list(rows)))}
    return out


def demangle(names: list) -> list:
    """Short names (:func:`short_name`) of mangled kernel symbols."""
    import shutil
    import subprocess

    tool = shutil.which("cu++filt") or str(build.Path(build.nvcc()).parent / "cu++filt")
    if not build.Path(tool).exists():
        tool = shutil.which("c++filt")
    if tool is None:
        return names
    text = subprocess.run([tool, *names], capture_output=True, text=True).stdout.splitlines()
    if len(text) != len(names):
        return names
    out = []
    for t in text:  # "void <unnamed>::descend_kernel<float, (bool)1, 4>(const T1 *, ...)"
        t = t.replace("(bool)0", "false").replace("(bool)1", "true").split("::", 1)[-1]
        out.append(t[:t.index(">(") + 1] if ">(" in t else t.split("(")[0])
    return out


STEP_SCHEDULES = ("certified", "exact", "fast")  # the step part's graphed schedules
STEP_FLEETS = (1, 2, 4)  # and fleet sizes


EAGER_WARM, EAGER_WINDOWS, EAGER_STEPS = 2, 3, 12  # an eager twin's scans


def eager_numbers(step, staged: list) -> dict:
    """An eager twin's median scans/s over :data:`EAGER_WINDOWS` windows
    of :data:`EAGER_STEPS` scans (each ending in a synchronisation) and
    its median host enqueue ms a scan: ``step(s)`` on the first
    :data:`EAGER_WARM` scans of ``staged``, then on the rest, from the
    start again where they run out."""
    for s in staged[:EAGER_WARM]:
        step(s)
    torch.cuda.synchronize()
    scans = itertools.cycle(staged[EAGER_WARM:])
    rates, enq = [], []
    for _ in range(EAGER_WINDOWS):
        t0 = time.perf_counter()
        for _ in range(EAGER_STEPS):
            s = next(scans)
            t = time.perf_counter()
            step(s)
            enq.append((time.perf_counter() - t) * 1e3)
        torch.cuda.synchronize()
        rates.append(EAGER_STEPS / (time.perf_counter() - t0))
    return {"scans_per_s": statistics.median(rates), "windows": rates,
            "enqueue_ms_median": statistics.median(enq)}


def step_numbers(device, n_warm: int = 3, n_timed: int = 8, n_prof: int = 2) -> dict:
    """The end-to-end numbers a kernel change should move, graphed and
    eager: the bench's schedules of :data:`STEP_SCHEDULES`
    (:func:`bench.run_schedule`, 3 windows of 12 scans each: median
    scans/s, device busy ms and kernels a scan) beside an eager twin (a
    second primed pipeline running the captured body,
    :func:`eager_numbers`); for certified, the poses of 8 scans of a
    primed pipeline (to compare two trees) and every kernel's µs a call
    in two more (:func:`step_kernels`); and fleets of :data:`STEP_FLEETS`
    sequences of the bench's drive, staggered by 5 scans (fleet scans/s
    over ``n_timed`` batched scans, device busy ms and kernels a batched
    scan), each beside an eager twin on the same batches (cycled)."""
    from madicp_tpu_torch import bench
    from madicp_tpu_torch.models.step_graph import step_in_place
    from madicp_tpu_torch.parallel import Fleet
    from madicp_tpu_torch.utils.timing import device_kernels

    setup = bench.BenchSetup(device, 131072, 16, 16, 32768)
    out = {}
    for spec in STEP_SCHEDULES:
        r = bench.run_schedule(setup, spec, 3, 12, 3)
        out[spec] = {k: r[k] for k in ("median_scans_per_sec", "windows", "profile")}
        twin = setup.make_pipe(spec)
        setup.prime(twin)
        staged = [twin.stage(setup.scan_at(i))
                  for i in range(1, 1 + EAGER_WARM + EAGER_WINDOWS * EAGER_STEPS)]
        out[spec]["eager"] = eager_numbers(
            lambda s, twin=twin: step_in_place(twin.cfg, twin._graphs.state, s[0][None],
                                               s[1][None]), staged)
        del twin, staged
        torch.cuda.empty_cache()
    pipe = setup.make_pipe("certified")
    setup.prime(pipe)
    poses = []
    for i in range(1, 9):  # graphed from the third: their poses, to compare trees bit for bit
        pipe.compute_device(0.1 * i, *pipe.stage(setup.scan_at(i)))
        poses.append(pipe._last.pose.double().cpu().numpy().tolist())
    out["certified"]["poses"] = poses
    out["certified"]["kernels"] = step_kernels(pipe, setup, 9)
    cfg = pipe.cfg
    total = n_warm + n_timed + n_prof
    for B in STEP_FLEETS:
        staged = []
        for k in range(total):
            batch = [pipe.stage(setup.scan_at(1 + k + 5 * b)) for b in range(B)]
            staged.append((torch.stack([p for p, _, _ in batch]),
                           torch.stack([v for _, v, _ in batch])))
        fleet = Fleet(cfg, B, device=device)
        for k in range(n_warm):
            fleet.compute(None, *staged[k])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for k in range(n_warm, n_warm + n_timed):
            fleet.compute(None, *staged[k])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        by_name, wall_ms = device_kernels(
            lambda: [fleet.compute(None, *staged[k]) for k in range(n_warm + n_timed, total)])
        twin = Fleet(cfg, B, device=device)
        twin.compute(None, *staged[0])  # the bootstrap scan
        eager = eager_numbers(lambda s: step_in_place(cfg, twin.states, *s), staged[1:])
        out[f"fleet_b{B}"] = {
            "fleet_scans_per_s": B * n_timed / wall,
            "device_busy_ms_per_batched_scan": sum(us for us, _ in by_name.values()) / 1e3 / n_prof,
            "kernels_per_batched_scan": sum(c for _, c in by_name.values()) / n_prof,
            "profiled_wall_ms_per_batched_scan": wall_ms / n_prof,
            "eager_fleet_scans_per_s": B * eager["scans_per_s"],
            "eager_fleet_windows": [B * r for r in eager["windows"]],
            "eager_enqueue_ms_median": eager["enqueue_ms_median"]}
        del fleet, twin, staged
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    from madicp_tpu_torch import bench
    from madicp_tpu_torch.utils.device import card_name

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=REPS)
    ap.add_argument("--paths", action="store_true",
                    help="every K8 and K9 level on every path, K7 with every cluster size")
    ap.add_argument("--parts", default=",".join(DEFAULT_PARTS),
                    help=f"comma list of {', '.join(PARTS)} (default: all but step, deskew, "
                    "tail, rates and step_ops)")
    a = ap.parse_args(argv)
    parts = set(a.parts.split(","))
    if parts - set(PARTS):
        ap.error(f"unknown parts {sorted(parts - set(PARTS))}; choose from {PARTS}")
    dev = torch.device("cuda")
    smi = card_name(dev)

    def emit(part, **kw):
        print(json.dumps({"part": part, "nvidia_smi": smi, **kw}), flush=True)

    if "resources" in parts:
        usage = ptxas_usage()
        for src, kernels in usage.items():
            for name, row in kernels.items():
                threads = build_nodes.THREADS if src == "build_nodes" else descent.THREADS
                row["resident_threads_an_sm"] = resident_threads(row["registers"], threads)
        emit("resources", usage=usage)
    if "nodes" in parts:
        emit("floor", **floor_us(dev))
    if "ring" in parts and "descent" not in parts:
        ap.error("the ring part extends the descent part: ask for both")
    fl = flagship_assoc(dev) if parts & {"terms", "descent", "gn"} else None
    for dtype in (torch.float32, torch.float64):
        dname = str(dtype).split(".")[1]
        kw = dict(depth=16, b_max=0.2, b_min=0.1)
        clouds = flagship_clouds(dev, dtype) if parts & {"build", "nodes"} else {}
        if "build" in parts:
            points, valid = clouds["bench_scan"]
            rows = build_trace(points, valid, **kw, reps=a.reps)
            emit("build", dtype=dname, device_us=sum(r["device_us"] for r in rows),
                 bound_us=sum(r["bound_us"] for r in rows), calls=rows)
            if a.paths:
                _, _, calls, _ = build_levels.record_build(points, valid, **kw)
                emit("build_paths", dtype=dname, levels=point_paths(calls))
                del calls
        if "nodes" in parts:
            for name, (points, valid) in clouds.items():
                rows = build_trace(points, valid, **kw, reps=a.reps, kernel="build_nodes")
                emit("nodes", dtype=dname, cloud=name,
                     device_us=sum(r["device_us"] for r in rows),
                     bound_us=sum(r["bound_us"] for r in rows), calls=rows)
                if a.paths:
                    _, _, calls, _ = build_levels.record_build(points, valid, **kw)
                    emit("nodes_paths", dtype=dname, cloud=name, calls=node_paths(calls))
                    del calls
        del clouds
        if "descent" in parts:
            emit("descent", dtype=dname, **descent_trace(fl, dtype, a.reps, "ring" in parts))
        if "terms" in parts:
            args, tkw = flagship_terms_args(fl, dtype)
            emit("terms", dtype=dname, kernels=terms_trace(args, tkw, a.reps))
            for row in bounded_terms(dev, dtype, paths=a.paths):
                emit("terms_bounded", dtype=dname, **row)
            if a.paths:
                fleet = (args[0].expand(4, 16, *args[0].shape[2:]),) + args[1:]
                emit("terms_plans", dtype=dname, leads_16=terms_plans(args, tkw),
                     leads_64=terms_plans(fleet, tkw))
        torch.cuda.empty_cache()
    if "gn" in parts:
        fl = fl or flagship_assoc(dev)
        res = gn_resources()
        emit("gn_resources", usage=res)
        for dtype in (torch.float32, torch.float64):
            for B in GN_BATCHES:
                K, L = fl.ring.shape[0], fl.leaves.pts.shape[0]
                emit("gn", dtype=str(dtype).split(".")[1], B=B, **gn_trace(fl, dtype, B, a.reps),
                     slack_launch=slack_occupancy(res["certify_slack"], B, K, L, dtype))
        torch.cuda.empty_cache()
    if "step" in parts:
        fl = None
        torch.cuda.empty_cache()
        emit("step", **step_numbers(dev))
    if "deskew" in parts:
        from madicp_tpu_torch.probes.deskew_drive import SweepSetup

        setup = SweepSetup(dev)
        for dtype, B, column, mode in itertools.product(
                (torch.float32, torch.float64), DESKEW_BATCHES, (False, True), DESKEW_MODES):
            emit("deskew", mode=mode, dtype=str(dtype).split(".")[1], B=B,
                 order="column" if column else "random",
                 **deskew_trace(setup, mode, dtype, B, column, a.reps))
        del setup
        torch.cuda.empty_cache()
        emit("deskew_rates", **deskew_rates(dev))
    if "tail" in parts:
        for row in tail_traces(dev, a.reps):
            emit("tail", **row)
        for row in tail_stamp_traces(dev):
            emit("tail_stamps", **row)
    if "rates" in parts:
        emit("deskew_rates", **deskew_rates(dev, rounds=1))
    if "step_ops" in parts:
        for row in step_ops(dev, a.reps):
            emit("step_ops", **row)
    return 0


def flagship_terms_args(fl: Flagship, dtype):
    """(args, kwargs) of one flagship ``icp_terms.terms`` call: the bench's
    scan 1's leaves (32768) against its primed ring of 16 trees, the
    round-0 payload of a pose 2 cm off the scan's, shaped as the pipeline
    hands them over."""
    inp = descent_inputs(fl, dtype)
    K, L = inp["need"].shape
    args = (inp["payload"].view(1, K, L, 8), inp["pts"][None], fl.leaves.valid[None, None],
            inp["X"][None])
    return args, dict(b_max=fl.cfg.b_max, b_ratio=fl.cfg.b_ratio, rho_ker=fl.cfg.rho_ker)



GN_BATCHES = (1, 4)  # a Pipeline and the fleet's B = 4
GN_STAMP_CALLS = 20  # eager calls of the stamped K10 variant
L2_FLUSH_BYTES = 128 << 20  # more than the H100's 50 MB L2


def gn_inputs(fl: Flagship, dtype, B: int) -> dict:
    """A certified round's inputs at the flagship in ``dtype`` for ``B``
    sequences: the poses ``Xp`` (B, 4, 4) (scan 1's, 2 cm off, then 1 cm
    apart along x), the per-keyframe normal equations ``Hk`` (B, K, 6, 6),
    ``bk`` (B, K, 6) from the round-0 payload (K7's output) with the
    keyframe weights ``w`` (B, K) (every slot live), their sums ``H`` (B,
    6, 6), ``b`` (B, 6) (what the step hands the update), the updated
    poses ``X``, round 0's margins as the ``slack`` (B, K, L), the leaves
    ``pts`` (B, L, 3), their norms ``r_norm`` (B, L), ``leaves_valid`` (B,
    L), ``kf_live`` (B, K) and a descent count ``n_descents`` (B,)."""
    from madicp_tpu_torch.ops.icp_core import gn_se3_step

    inp = descent_inputs(fl, dtype)
    K, L = inp["need"].shape
    dev = fl.ring.device
    Xp = inp["X"].expand(B, 4, 4).clone()
    Xp[:, 0, 3] += 0.01 * torch.arange(B, device=dev, dtype=dtype)
    Hk, bk, _ = icp_terms.terms(inp["payload"][None], inp["pts"][:, None],
                                fl.leaves.valid[None, None], Xp[:, None],
                                b_max=fl.cfg.b_max, b_ratio=fl.cfg.b_ratio,
                                rho_ker=fl.cfg.rho_ker)
    w = torch.ones((B, K), dtype=dtype, device=dev)
    H, b = terms_sum(w, Hk, bk)
    pts = inp["pts"].expand(B, L, 3).contiguous()
    return dict(Xp=Xp, Hk=Hk, bk=bk, w=w, H=H, b=b, X=gn_se3_step(Xp, H, b),
                slack=inp["margin"][None].expand(B, K, L).contiguous(), pts=pts,
                r_norm=torch.sqrt(torch.sum(pts * pts, dim=-1)),
                leaves_valid=fl.leaves.valid[None].expand(B, L).contiguous(),
                kf_live=torch.ones((B, K), dtype=torch.bool, device=dev),
                n_descents=torch.zeros((B,), dtype=torch.int64, device=dev))


def terms_sum(w, Hk, bk) -> tuple:
    """The keyframe sums of ``icp_rounds``' ``terms_scan`` (two einsums)."""
    return torch.einsum("bk,bkij->bij", w, Hk), torch.einsum("bk,bki->bi", w, bk)


def gn_stamps(gn_update, g: dict, calls: int = GN_STAMP_CALLS) -> dict:
    """Where K10's time goes: a variant of ``csrc/gn_update.cu`` with
    ``clock64`` stamps at its phases (:func:`kernel_variants.stamp_source`),
    called ``calls`` times eagerly (each launch lands on an SM that may
    not hold its code) on the flagship's round: the median cycles of
    each phase on block 0's thread 0, and of the whole."""
    from madicp_tpu_torch.probes import kernel_variants as kv

    holder = {}

    def transform(text):
        text, holder["labels"] = kv.stamp_source(text)
        return text

    lib, _ = kv.build_variant("gn_update", transform=transform)
    labels = holder["labels"]
    args = (g["Xp"], g["Hk"], g["bk"], g["w"])
    runs = []
    with kv.use_variant(gn_update._launch, lib):
        for _ in range(calls):
            gn_update.gn_update(*args)
            torch.cuda.synchronize()
            runs.append(kv.read_stamps(lib, len(labels)))
    phases = {labels[i]: statistics.median(r[i + 1] - r[i] for r in runs)
              for i in range(len(labels) - 1)}
    return {"cycles": phases, "total_cycles": statistics.median(r[-1] - r[0] for r in runs),
            "first_call_cycles": runs[0][-1] - runs[0][0], "calls": calls}


def gn_resources() -> dict:
    """Registers, stack and spills (``nvcc -Xptxas -v``) and SASS
    instructions (``cuobjdump -sass``) of each K10 and K11 kernel."""
    from madicp_tpu_torch.probes import kernel_variants as kv

    usage = ptxas_usage(("gn_update", "certify_slack"))
    for name in ("gn_update", "certify_slack"):
        counts = kv.sass_counts(build.build_all((name,))[name])
        for short, n in zip(demangle(list(counts)), counts.values()):
            usage[name].setdefault(short, {})["sass_instructions"] = n
    return usage


def slack_occupancy(regs: dict, B: int, K: int, L: int, dtype) -> dict:
    """K11's launch at (B, K, L): blocks, threads and their share of the
    threads the card holds at its register count (no shared-memory
    limit; 132 SMs) of the vector form of ``certify_slack_kernel<T, VEC>``
    (named in ``regs``, :func:`gn_resources`): a block covers 64 x 16
    bytes of leaves and 16 keyframes."""
    threads = 256
    f64 = dtype == torch.float64
    name = next(k for k in regs if ("double" in k) == f64 and "true" in k)
    grid = (-(-L // (64 * 128 // torch.finfo(dtype).bits)), -(-K // 16), B)
    blocks = math.prod(grid)
    registers = regs[name]["registers"]
    return {"kernel": name, "grid": list(grid), "blocks": blocks, "threads_a_block": threads,
            "registers": registers,
            "resident_share": blocks * threads / (132 * resident_threads(registers, threads))}


def cold_us(fn, reps: int = 20) -> float:
    """Device µs of ``fn()`` after an L2 flush: a graph of ``reps`` (flush,
    call) pairs less a graph of ``reps`` flushes (:data:`L2_FLUSH_BYTES`
    zeroed)."""
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    both = graph_ms(lambda: (flush.zero_(), fn()), reps)
    alone = graph_ms(flush.zero_, reps)
    return (both - alone) * 1e3


def gn_trace(fl: Flagship, dtype, B: int, reps: int = REPS) -> dict:
    """The ``gn`` part (module doc) for ``B`` sequences in ``dtype``: for
    each traced call its kernels in launch order with their median device
    µs (``kernels``; their count is the call's launches) and its graphed
    µs (``graph_us``)."""
    from madicp_tpu_torch.kernels import certify_slack, gn_update
    from madicp_tpu_torch.ops.icp_core import clamp_step, solve_gn
    from madicp_tpu_torch.ops.lie import exp_se3_split

    g = gn_inputs(fl, dtype, B)
    Xp, H, b, X = g["Xp"], g["H"], g["b"], g["X"]
    dx = solve_gn(H, b)
    dxc = clamp_step(dx)
    dX = exp_se3_split(dxc)
    out = {"gn_plain": launch_us(lambda: Xp @ exp_se3_split(clamp_step(solve_gn(H, b))), reps,
                                 {"solve": lambda: solve_gn(H, b),
                                  "clamp": lambda: clamp_step(dx),
                                  "exp": lambda: exp_se3_split(dxc),
                                  "product": lambda: Xp @ dX}),
           "terms_sum": launch_us(lambda: terms_sum(g["w"], g["Hk"], g["bk"]), reps)}
    out["gn_update"] = launch_us(lambda: gn_update.gn_update(Xp, H, b), reps)
    out["gn_update_folded"] = launch_us(
        lambda: gn_update.gn_update(Xp, g["Hk"], g["bk"], g["w"]), reps)
    out["gn_update_plain_folded"] = launch_us(
        lambda: gn_update.gn_update_plain(Xp, g["Hk"], g["bk"], g["w"]), reps)
    out["gn_update_plain"] = launch_us(lambda: gn_update.gn_update_plain(Xp, H, b), reps)
    out["gn_stamps"] = gn_stamps(gn_update, g)
    tail = (g["slack"], Xp, X, g["pts"], g["r_norm"], g["leaves_valid"], g["kf_live"],
            g["n_descents"])
    work = tuple(t.clone() for t in tail)  # the slack and the count change in place
    out["certify_slack"] = launch_us(lambda: certify_slack.certify_slack(*work), reps)
    out["certify_slack"]["cold_l2_us"] = cold_us(lambda: certify_slack.certify_slack(*work))
    out["certify_slack_plain"] = launch_us(
        lambda: certify_slack.certify_slack_plain(*work), reps)
    return out


def step_kernels(pipe, setup, first: int, n: int = 2) -> dict:
    """{kernel: {"us_a_call", "calls_a_scan"}} of ``n`` graphed scans of a
    primed pipeline from scan ``first``, every kernel of the profiled
    window, by its short name."""
    from madicp_tpu_torch.utils.timing import device_kernels

    staged = [pipe.stage(setup.scan_at(i)) for i in range(first, first + n)]
    by_name, _ = device_kernels(lambda: [pipe.compute_device(0.1 * (first + i), *s)
                                         for i, s in enumerate(staged)])
    rows = {}
    for name, (us, cnt) in by_name.items():
        key = short_name(name)
        tot, c = rows.get(key, (0.0, 0))
        rows[key] = (tot + us, c + cnt)
    return {k: {"us_a_call": us / c, "calls_a_scan": c / n, "us_a_scan": us / n}
            for k, (us, c) in sorted(rows.items(), key=lambda kv: -kv[1][0])}


DESKEW_MODES = ("reference", "binned")
DESKEW_SCAN = 3  # the first sweep a trace deskews (with the true poses of scans 2 and 3)
DESKEW_BATCHES = (1, 4)
DESKEW_DRIVE = dict(warm=3, steps=8, windows=3, phase=2, profiled=2)


def deskew_kind(name: str) -> str:
    """The part of the step's deskew a CUDA kernel belongs to, by its
    name: the stable sort (cub's radix sort), K12 (the ``__global__``
    functions of ``csrc/deskew.cu``), or the other tensor ops (the
    azimuths, the sort's key, its copies and fills, and the bin motions in
    trees that form them in tensor ops)."""
    from madicp_tpu_torch.kernels.deskew import KERNEL_NAMES

    low = name.lower()
    if "sort" in low or "radix" in low:
        return "sort"
    if any(k in name for k in KERNEL_NAMES):
        return "k12"
    return "other"


def deskew_trace(setup, mode: str, dtype=torch.float32, B: int = 1, column: bool = False,
                 reps: int = REPS) -> dict:
    """The step's deskew (``ops/deskew.py`` ``deskew_scan``) of ``B``
    sweeps of ``setup``'s drive from scan :data:`DESKEW_SCAN` on (65,536
    points padded to 131072; in capture-time order with ``column``) with
    their true velocity: the kernels of one graphed call in order with
    their median device µs and kind (:func:`deskew_kind`), the µs and
    kernels of each kind, graphed and eager µs a call, and whether a
    capture under ``set_sync_debug_mode("error")`` went through."""
    from madicp_tpu_torch.ops.deskew import deskew_scan
    from madicp_tpu_torch.probes.deskew_drive import sweep_batch
    from madicp_tpu_torch.utils.timing import event_ms

    pts, valid, T_prev, T_now, hz = sweep_batch(setup, DESKEW_SCAN, B, dtype, column)
    do = torch.ones(B, dtype=torch.bool, device=pts.device)
    call = lambda: deskew_scan(pts, valid, do, T_prev, T_now, hz, mode)  # noqa: E731
    call()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.cuda.graph(graph):
            call()
        capture = "no host sync"
    except RuntimeError as e:
        capture = f"failed: {str(e)[:300]}"
    finally:
        torch.cuda.set_sync_debug_mode(0)
    del graph
    out = {"points": int(valid.sum()), "n_points": pts.shape[1], "capture": capture,
           "graph_us": graph_ms(call, 20) * 1e3, "eager_us": event_ms(call, 20) * 1e3}
    try:
        runs = graphed_records(call, reps)
    except RuntimeError as e:  # the trace is lost, the graphed times stand
        return {**out, "kernels": None, "profiler": str(e)}
    kernels = [{"kernel": name, "kind": deskew_kind(name),
                "device_us": statistics.median(r[j][1] for r in runs)}
               for j, (name, _) in enumerate(runs[0])]
    by_kind: dict = {}
    for k in kernels:
        us, n = by_kind.get(k["kind"], (0.0, 0))
        by_kind[k["kind"]] = (us + k["device_us"], n + 1)
    total = sum(us for us, _ in by_kind.values())
    return {**out, "kernels": kernels, "device_us": total, "launches": len(kernels),
            "us_by_kind": {k: us for k, (us, _) in by_kind.items()},
            "kernels_by_kind": {k: n for k, (_, n) in by_kind.items()},
            "share_by_kind": {k: us / total for k, (us, _) in by_kind.items()}}


def deskew_rates(device, rounds: int = 2) -> dict:
    """The certified flagship drive on the MulRan-shaped sweeps, graphed,
    with deskew off and in both modes, in turns ``rounds`` times (off,
    reference, binned, then the reverse): each run's median scans/s over
    :data:`DESKEW_DRIVE`'s windows, device busy ms and kernels a scan
    (profiled), each phase's device ms (graphed, under the program's
    trace), and its distance to the truth."""
    from madicp_tpu_torch.probes.deskew_drive import SweepSetup, truth_error
    from madicp_tpu_torch.utils.timing import Trace, device_kernels, layer_ms

    w, n, nw, nph, npr = (DESKEW_DRIVE[k] for k in ("warm", "steps", "windows", "phase",
                                                    "profiled"))
    setup = SweepSetup(device)
    last = w + n * nw + 1 + nph + npr
    order = [None, "reference", "binned"]
    runs = []
    for r in range(rounds):
        for mode in (order if r % 2 == 0 else order[::-1]):
            pipe = setup.make_pipe(deskew=mode is not None, mode=mode or "reference")
            setup.prime(pipe)
            staged = setup.staged(pipe, 1, last)
            poses = []

            def run(lo, hi):
                for k in range(lo, hi):
                    pipe.compute_device(0.1 * k, *staged[k])
                    poses.append(pipe._last.pose)

            run(1, 1 + w)
            torch.cuda.synchronize()
            rates, lo = [], 1 + w
            for _ in range(nw):
                t0 = time.perf_counter()
                run(lo, lo + n)
                torch.cuda.synchronize()
                rates.append(n / (time.perf_counter() - t0))
                lo += n
            pipe.trace = Trace(device)
            run(lo, lo + 1)  # the traced graph's capture
            pipe.trace.drain()
            run(lo + 1, lo + 1 + nph)
            phases = {k: ms / nph for k, ms in layer_ms(pipe.trace.drain()).items()}
            pipe.trace = None
            lo += 1 + nph
            by_name, wall_ms = device_kernels(lambda: run(lo, lo + npr))
            got = torch.stack(poses).double().cpu().numpy()
            runs.append({
                "deskew": mode or "off", "median_scans_per_s": statistics.median(rates),
                "windows": rates,
                "device_busy_ms_per_scan": sum(us for us, _ in by_name.values()) / 1e3 / npr,
                "kernels_per_scan": sum(c for _, c in by_name.values()) / npr,
                "phase_ms": phases,
                "from_truth": truth_error(got, np.stack([setup.truth(k)
                                                         for k in range(1, last + 1)]))})
            del pipe, staged
            torch.cuda.empty_cache()
    return {"dataset": setup.dataset, "scans": last, **DESKEW_DRIVE, "runs": runs}


TAIL_SCAN = 3  # the bench scan the first sequence of a tail trace steps
TAIL_BATCHES = (1, 4)
# p_th of a scan that promotes (every ratio is below it) and of one that does not
TAIL_P_TH = {True: 2.0, False: -1.0}
PACKAGE = "madicp_tpu_torch"


@contextlib.contextmanager
def line_marks(mark, skip=("/kernels/", "/utils/", "/probes/")):
    """While open, call ``mark(chain)`` at every line the package's own
    Python runs (its modules under ``madicp_tpu_torch/`` but ``skip``):
    ``chain`` is the list of ``"path:line func"`` of every package frame
    on the stack, outermost first (marked again where a call returns to
    its caller's line). On the card ``mark`` launches a marker
    kernel, so the kernels between two markers of a device trace are the
    ones that line issued (:func:`step_lines`)."""
    import sys

    stack: list = []  # [frame, label] of the package frames, outermost first

    def rel(frame):
        path = frame.f_code.co_filename
        return path[path.rindex(PACKAGE):]

    def local(frame, event, arg):
        if event == "line":
            stack[-1][1] = f"{rel(frame)}:{frame.f_lineno} {frame.f_code.co_name}"
            mark([label for _, label in stack])
        elif event == "return":
            stack.pop()
            if stack:  # back in the caller's line: its later kernels are its own
                mark([label for _, label in stack])
        return local

    def call(frame, event, arg):
        path = frame.f_code.co_filename
        if PACKAGE not in path or any(s in path for s in skip):
            return None
        stack.append([frame, None])
        return local

    sys.settrace(call)
    try:
        yield
    finally:
        sys.settrace(None)


def step_lines(fn, reps: int = REPS) -> list:
    """The CUDA kernels of one eager ``fn()`` in launch order, each with
    the package line that issued it: ``[(kernel, device µs, chain)]`` with
    ``chain`` as :func:`line_marks` gives it. A marker kernel
    (``torch.cuda._sleep(0)``) is launched at every line; the trace is
    taken in up to ``5 reps`` profiled windows until one keeps every
    marker and the most kernels (the profiler on the card drops records).
    Raises where no window kept every marker."""
    chains: list = []
    best, full = None, 0
    for _ in range(5 * reps):
        chains.clear()

        def run():
            with line_marks(lambda chain: (chains.append(chain), torch.cuda._sleep(0))):
                fn()

        records, _ = device_trace(run)
        marks = [i for i, (name, _, _) in enumerate(records) if "spin" in name.lower()]
        if len(marks) != len(chains):
            continue
        full += 1
        if best is None or len(records) > len(best[0]):
            best = (records, marks, list(chains))
        if full == reps:
            break
    if best is None:
        raise RuntimeError(f"no profiled window of {5 * reps} kept every line marker")
    records, marks, chain_of = best
    out, m = [], -1
    for i, (name, _, us) in enumerate(records):
        if m + 1 < len(marks) and marks[m + 1] == i:
            m += 1
            continue
        out.append((short_name(name), us, chain_of[m] if m >= 0 else []))
    return out


def tail_region(pipeline_path: str) -> tuple:
    """``(prediction lines, tail lines)`` of the odometry step's body
    (``_phased_step`` in ``models/pipeline.py``): the line that forms
    ``X0``, and every line of the ``tail`` phase after the round loop up
    to ``new_state = PipelineState(`` (everything after the rounds up to
    the new state)."""
    lines = open(pipeline_path).read().splitlines()
    start = next(i for i, s in enumerate(lines) if s.startswith("def _phased_step(")) + 1
    find = lambda text, lo=start: next(i for i in range(lo, len(lines))  # noqa: E731
                                       if lines[i - 1].strip().startswith(text))
    x0 = find("X0 =")
    return {x0}, set(range(find('with phase(stamps, "tail")', find("X, H_last, matched")),
                           find("new_state = PipelineState(")))


def _in(chain, func: str, lines: set = None):
    """The line of ``func``'s frame in ``chain`` if it is one of ``lines``
    (any line where ``lines`` is None)."""
    for label in chain:
        where, name = label.split(" ")
        if name == func:
            line = int(where.rsplit(":", 1)[1])
            return line if lines is None or line in lines else None
    return None


def tail_pipe(setup, dtype):
    """A certified flagship pipeline in ``dtype``, primed as the bench
    primes its own."""
    from madicp_tpu_torch.bench import schedule_kwargs
    from madicp_tpu_torch.models.pipeline import Pipeline

    pipe = Pipeline(sensor_hz=10.0, deskew=False, b_max=0.2, rho_ker=0.1, p_th=0.8, b_min=0.1,
                    b_ratio=0.02, num_keyframes=setup.num_keyframes, n_points=setup.n_points,
                    depth=setup.depth, max_leaves=setup.max_leaves, dtype=dtype,
                    device=setup.device, **schedule_kwargs("certified"))
    setup.prime(pipe)
    return pipe


def tail_trace(setup, pipe, B: int, promote: bool, reps: int = REPS) -> dict:
    """The step's prediction and tail (:func:`tail_region`) for ``B``
    sequences stepping the bench's scans from :data:`TAIL_SCAN` on, each
    from ``pipe``'s primed state, with a ``p_th`` that makes every
    sequence promote or none: every kernel of an eager step with the line
    of ``_phased_step`` and the innermost package line that issued it
    (:func:`step_lines`), their device µs and kernels by step line and by
    source, and, from a replay of the step captured whole in a CUDA graph
    (its kernels in the eager step's order), the prediction's and the
    tail's graphed device µs (busy and first start to last end) and
    kernel counts; the same for the copies of the new state into the
    state's tensors that ``write_state`` makes after the step (part
    ``write_state``, by its line)."""
    import dataclasses

    from madicp_tpu_torch.models import pipeline as pipeline_mod
    from madicp_tpu_torch.models.pipeline import _map
    from madicp_tpu_torch.models.step_graph import step_in_place

    cfg = dataclasses.replace(pipe.cfg, p_th=TAIL_P_TH[promote])
    single = pipe.state
    state = _map(lambda t: t[None].repeat((B,) + (1,) * t.dim()).contiguous(), single)
    staged = [pipe.stage(setup.scan_at(TAIL_SCAN + b)) for b in range(B)]
    pts = torch.stack([p for p, _, _ in staged])
    valid = torch.stack([v for _, v, _ in staged])
    step = lambda: step_in_place(cfg, state, pts, valid)  # noqa: E731
    for _ in range(2):
        step()
    torch.cuda.synchronize()
    eager = step_lines(step, reps)
    predict_lines, tail_lines = tail_region(pipeline_mod.__file__)
    rows = []
    for j, (name, us, chain) in enumerate(eager):
        for part, func, lines in (("predict", "_phased_step", predict_lines),
                                  ("tail", "_phased_step", tail_lines),
                                  ("write_state", "write_state", None)):
            line = _in(chain, func, lines)
            if line is not None:
                rows.append({"index": j, "part": part, "step_line": line,
                             "source": chain[-1] if chain else None, "kernel": name,
                             "device_us": us})
    out = {"B": B, "promote": promote, "step_kernels_eager": len(eager), "kernels": rows}
    for key in ("step_line", "source"):
        groups: dict = {}
        for r in rows:
            k = f"{r['part']} {r[key]}"
            us, n = groups.get(k, (0.0, 0))
            groups[k] = (us + r["device_us"], n + 1)
        out[f"by_{key}"] = {k: {"device_us": us, "kernels": n} for k, (us, n) in groups.items()}
    for part in ("predict", "tail", "write_state"):
        mine = [r for r in rows if r["part"] == part]
        out[f"{part}_eager_busy_us"] = sum(r["device_us"] for r in mine)
        out[f"{part}_kernels"] = len(mine)
    # the graphed step: its replay's kernels are the eager step's, in order
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        step()
    graph.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(5):
        graph.replay()
    t1.record()
    torch.cuda.synchronize()
    out["step_graph_us"] = t0.elapsed_time(t1) / 5 * 1e3
    kept = None
    for _ in range(5 * reps):
        recs, _ = device_trace(graph.replay)
        if len(recs) >= len(eager) and (kept is None or len(recs) > len(kept)):
            kept = recs
        if kept is not None and len(kept) >= len(eager):
            break
    names = None if kept is None else [short_name(n) for n, _, _ in kept]
    if names is None or names[:len(eager)] != [e[0] for e in eager]:
        out["graph"] = ("the replay's kernels are not the eager step's"
                        if names is not None else "no profiled replay kept every kernel")
    else:
        out["step_kernels_graphed"] = len(kept)
        for part in ("predict", "tail", "write_state"):
            idx = [r["index"] for r in rows if r["part"] == part]
            if idx:
                sel = [kept[i] for i in idx]
                out[f"{part}_graphed_busy_us"] = sum(us for _, _, us in sel)
                out[f"{part}_graphed_span_us"] = (kept[idx[-1]][1] + kept[idx[-1]][2]
                                                  - kept[idx[0]][1])
    del graph, state
    torch.cuda.empty_cache()
    return out


def tail_traces(device, reps: int = REPS):
    """:func:`tail_trace` in float32 and float64, at each of
    :data:`TAIL_BATCHES`, promoting and not (yields one dict each)."""
    from madicp_tpu_torch import bench

    setup = bench.BenchSetup(device, 131072, 16, 16, 32768)
    for dtype in (torch.float32, torch.float64):
        pipe = tail_pipe(setup, dtype)
        for B, promote in itertools.product(TAIL_BATCHES, (False, True)):
            yield {"dtype": str(dtype).split(".")[1], **tail_trace(setup, pipe, B, promote, reps)}
        del pipe
        torch.cuda.empty_cache()


def record_tail(cfg, state, pts, valid) -> dict:
    """The arguments of the step's predict, tail and ring write in one
    eager ``step_in_place`` of ``state`` (which it advances), cloned as
    they were handed over: ``{"predict": (X, v, hz), "tail": (the state's
    scalars (its trees None), (X, H, matched, valid, hz), keywords but
    ``out``), "ring": (nav, X)}``."""
    from madicp_tpu_torch.kernels import ring_write, step_scalars
    from madicp_tpu_torch.models.step_graph import step_in_place
    from madicp_tpu_torch.ops.tree import SearchTree

    rec = {}
    real = step_scalars.predict, step_scalars.tail, ring_write.ring_write

    def predict(*args):
        rec["predict"] = tuple(a.clone() for a in args)
        return real[0](*args)

    def tail(state, *args, **kw):
        # the scalars of the state (the tail reads no tree)
        scalars = type(state)(*(None if isinstance(v, SearchTree) else v.clone() for v in state))
        rec["tail"] = (scalars, tuple(a.clone() for a in args),
                       {k: v for k, v in kw.items() if k != "out"})
        return real[1](state, *args, **kw)

    def ring(nav, X, plan, fr, kf):
        rec["ring"] = (nav.clone(), X.clone())
        return real[2](nav, X, plan, fr, kf)

    step_scalars.predict, step_scalars.tail, ring_write.ring_write = predict, tail, ring
    try:
        step_in_place(cfg, state, pts, valid)
    finally:
        step_scalars.predict, step_scalars.tail, ring_write.ring_write = real
    return rec


def clone_scalars(state):
    """A copy of a recorded state's scalars (its trees stay None)."""
    return type(state)(*(None if v is None else v.clone() for v in state))


def tail_stamps(rec: dict) -> dict:
    """Where K14's tail spends its cycles on one recorded step
    (:func:`record_tail`): the package's kernel in place, built with a
    ``clock64`` stamp at every ``// phase:`` line of its source kept by
    each warp of block 0 (:func:`kernel_variants.stamp_source` with
    ``per_warp``), launched once eagerly: {phase: {warp: cycles after
    the first stamp}}."""
    from madicp_tpu_torch.kernels import build as kbuild
    from madicp_tpu_torch.kernels import step_scalars
    from madicp_tpu_torch.probes import kernel_variants as kv

    st, args, kw = rec["tail"]
    stamped, labels = kv.stamp_source((kbuild.CSRC / "step_scalars.cu").read_text(),
                                      per_warp=True)
    lib, _ = kv.build_variant("step_scalars", source=stamped)
    dst = clone_scalars(st)
    with kv.use_variant(step_scalars._launch, lib):
        kv.clear_stamps(lib)
        step_scalars.launch_tail(dst, *args, **kw, out=dst)
        torch.cuda.synchronize()
    return kv.read_warp_stamps(lib, labels)


def tail_stamp_traces(device):
    """:func:`tail_stamps` on a step of the primed certified flagship
    (:func:`tail_pipe`) after two warm steps, float32 and float64, at each
    of :data:`TAIL_BATCHES` (yields one dict each)."""
    from madicp_tpu_torch import bench
    from madicp_tpu_torch.models.pipeline import _map
    from madicp_tpu_torch.models.step_graph import step_in_place

    setup = bench.BenchSetup(device, 131072, 16, 16, 32768)
    for dtype in (torch.float32, torch.float64):
        pipe = tail_pipe(setup, dtype)
        for B in TAIL_BATCHES:
            state = _map(lambda t: t[None].repeat((B,) + (1,) * t.dim()).contiguous(),
                         pipe.state)
            staged = [pipe.stage(setup.scan_at(TAIL_SCAN + b)) for b in range(B)]
            pts = torch.stack([p for p, _, _ in staged])
            valid = torch.stack([v for _, v, _ in staged])
            for _ in range(2):
                step_in_place(pipe.cfg, state, pts, valid)
            rec = record_tail(pipe.cfg, state, pts, valid)
            yield {"dtype": str(dtype).split(".")[1], "B": B, "stamps": tail_stamps(rec)}
            del state, rec
            torch.cuda.empty_cache()
        del pipe
        torch.cuda.empty_cache()


# a library GEMM's kernel names (cuBLAS, CUTLASS)
GEMM_NAME = re.compile(r"(gemm|gemv|Gemm|Gemv|xmma|cutlass)")
STEP_OPS_BATCHES = (1, 11)  # a CLI sequence; the fleet's KITTI 00-10
STEP_OPS_LEAVES = 131072  # the benchmark's leaf slots (max_leaves 0: n_points)


def step_ops(device, reps: int = REPS):
    """One eager step (``step_in_place``, float32) of each schedule of
    :data:`bench.SCHEDULES` at B = 1 and of the certified one at every B
    of :data:`STEP_OPS_BATCHES`, each sequence from the bench's primed
    state on its own scan (:data:`TAIL_SCAN` on), with
    :data:`STEP_OPS_LEAVES` leaf slots: the step's kernel count, its
    GEMMs (:data:`GEMM_NAME`) and the kernels the association's descents
    issue (``icp_rounds``' ``descend``), each grouped by the chain of
    package lines that issued it (:func:`step_lines`) with its count and
    device µs. Yields one dict a step."""
    from madicp_tpu_torch import bench
    from madicp_tpu_torch.models.pipeline import _map
    from madicp_tpu_torch.models.step_graph import step_in_place

    setup = bench.BenchSetup(device, 131072, 16, 16, STEP_OPS_LEAVES)
    cases = [(spec, 1) for spec in bench.SCHEDULES] + [
        ("certified", B) for B in STEP_OPS_BATCHES if B > 1]
    for spec, B in cases:
        pipe = setup.make_pipe(spec)
        setup.prime(pipe)
        state = _map(lambda t: t[None].repeat((B,) + (1,) * t.dim()).contiguous(), pipe.state)
        staged = [pipe.stage(setup.scan_at(TAIL_SCAN + b)) for b in range(B)]
        pts = torch.stack([p for p, _, _ in staged])
        valid = torch.stack([v for _, v, _ in staged])
        cfg = pipe.cfg
        del pipe, staged
        step = lambda: step_in_place(cfg, state, pts, valid)  # noqa: E731
        for _ in range(2):
            step()
        torch.cuda.synchronize()
        eager = step_lines(step, reps)
        groups: dict = {}
        for name, us, chain in eager:
            if not (GEMM_NAME.search(name) or _in(chain, "descend") is not None):
                continue
            key = (name, " > ".join(chain))
            n, total = groups.get(key, (0, 0.0))
            groups[key] = (n + 1, total + us)
        rows = [{"kernel": name, "gemm": bool(GEMM_NAME.search(name)), "count": n,
                 "device_us": us, "issued_by": chain}
                for (name, chain), (n, us) in groups.items()]
        yield {"schedule": spec, "B": B, "leaf_slots": STEP_OPS_LEAVES,
               "step_kernels": len(eager),
               "gemms": sum(r["count"] for r in rows if r["gemm"]),
               "gemm_us": sum(r["device_us"] for r in rows if r["gemm"]), "kernels": rows}
        del state, pts, valid
        torch.cuda.empty_cache()


if __name__ == "__main__":
    raise SystemExit(main())

