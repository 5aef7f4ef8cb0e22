#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (madicp_tpu_torch) on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

Phases, each printed as one JSON line (any failed check raises and the
script exits non-zero without the final line):

1. device     card name and power limit (nvidia-smi);
2. build      nvcc builds every CUDA kernel from csrc/, all at once;
3. kernels    segsum_moments against its plain PyTorch version on the
              card, at the shapes and on the data of a flagship tree
              build (all 17 levels, float32 and float64), with the path
              and launches the plan chose at each level, kernel and
              library (each eager and in a CUDA graph), plain and bound
              times;
3a. assoc     descend (K6) and icp_terms (K7) against their plain PyTorch
              versions on the card at flagship shapes (a primed ring of
              16 trees, 32768 leaves of a bench scan, depth 16), float32
              and float64: the descent's ids, blocks and margins bit for
              bit at a certified round 0, a later certified round (most
              entries parked) and a warm start, with the distinct panels
              it reads (the bound's bytes); the terms' matched bit for bit
              and H, b within 1e-5 (1e-12 in float64) relative of a float64
              sum of the plain version's per-entry terms; eager, graphed
              and plain ms and bounds. Then the certified flagship drive,
              graphed, with the kernels and with both functions routed to
              their plain versions (a patch of this script): scans/s,
              device busy and kernels a scan of each on the bench's world
              (y and z within 5e-4 m; x is unobservable there), and the
              accuracy drive both ways within 5e-4 m;
3c. tree      build_nodes (K9) and build_points (K8), the tree build's
              level pass and leaf pick, against their plain PyTorch
              versions on the card at flagship shapes (131072 points,
              depth 16: the bench's scan, a scan of the two-orientation
              world, a B = 4 fleet batch), float32 and float64: every
              call of a build bit for bit (ids, extents, freeze distances,
              representatives, node fields), and the built nav and
              point_leaf equal to the plain versions' build on the same
              moments; launches a build; eager, graphed and plain ms of
              each kernel and of a whole build, with the bound. Then the
              certified flagship drive, graphed, with the build kernels
              and with the build routed to its plain versions (a patch of
              this script): scans/s, device busy and kernels a scan of
              each, the two-orientation world's drive both ways within
              5e-4 m;
3b. probe     one run of the probe entry point (python -m
              madicp_tpu_torch.probes.scatter_probe), its launches counted
              from 0: it holds the four scatter-probe kernels
              (onehot_segsum in its three modes, fused_moments,
              rmw_segsum, scatter_segsum) against their plain versions at
              every probe shape (rmw_segsum bit for bit, the others
              within 1e-3 of float64), then times them;
4. precision  float32 point transforms at 40 m range within 1e-4 m of
              float64 (the TF32 guard);
5. golden     the four-walls golden drive (tests/test_golden.py): float64
              poses at 1e-6 from tests/golden_four_walls.npz, float32
              within 5e-3 m of ground truth with inliers > 0.95, both
              certify settings;
6. accuracy   the flagship main path (131072 points, depth 16, 16
              keyframes, 32768 leaves, 15 rounds, float32, certified
              exact) on a world with walls in both orientations, 0.3 m a
              scan along x: per-scan x error <= 1 cm;
7. steady     the same configuration with the keyframe ring prefilled
              with 16 trees (the bench module's BenchSetup): steady-state
              scans/s, per-phase ms from CUDA events, descents, kernel
              launches per scan;
8. schedules  the schedules beside certified exact: the float64 golden
              drive under compact (U = 16, 2048) and prefix (U = 16, 2048)
              within 1e-9 of plain exact on the card, with certified's
              descents (compact) or the CPU run's (prefix); fast (every
              2 and 7, and 2 warm-started 6 levels up) within 5e-3 m and
              1e-3 rad of exact; compute_batch over 4 scans within 1e-6 m
              of 4 compute_device calls, its 4 poses distinct, through a
              captured graph; then all five schedules at the flagship
              configuration through the bench module
              (python -m madicp_tpu_torch.bench) in short windows: scans/s,
              descents, phase ms, peak memory, segment-sum launches;
8b. graphs    the flagship step graphed against eager for every schedule
              (two bench pipelines primed alike on the same scans; the
              eager one runs the captured body, step_in_place): per scan
              scans/s, host enqueue ms, device busy and kernels, 17
              segment-sum launches; the graph's capture ms, nodes and pool
              bytes; poses within 5e-4 m over 15 scans, kernels a scan
              within 1%; then a realtime
              pipeline whose budget (0.4 of the graphed certified step
              just measured) moves its iteration count: a graph captured
              for each count;
9. apps       the CLI, checkpoints, evaluator, demos and native loader at
              the CLI's defaults (131072 points, depth 16, 4 keyframes) on
              10 KITTI .bin scans of the two-orientation world (~122k
              points a scan, 0.3 m a scan): a run under --profile whose
              trace must hold one segsum_moments accumulating kernel a
              launch; --checkpoint-every 4 --max-scans 6, then --resume,
              within 1e-6 m of the uninterrupted run; the checkpoint's
              snapshot ms and background write seconds; evaluate against
              the ground truth (<= 1 cm a scan); nn_search (every point
              matches itself) and mad_registration (identity within
              5e-3); the native loader bitwise equal to numpy. Every run
              counts its segment-sum launches from 0 and needs some.
10. fleet     the batched fleet (madicp_tpu_torch.parallel) at the
              flagship widths (certified exact, float32) with B = 1, 2
              and 4 sequences, graphed, beside an eager twin on the same
              scans: every sequence within 5e-4 of one single Pipeline and
              of the twin, a step where promotion differs across
              sequences, fleet scans/s, device busy and kernels a batched
              scan of both, the graph's capture ms, nodes and pool bytes,
              17 segment-sum launches a batched scan;
              segsum_moments against float64 at every level of a B = 4
              build (up to 262,144 segments); a fleet on a one-rank NCCL
              mesh (its keyframe all-reduces issued); fleet_eval on two
              ranks sharing the card through torch.distributed.run (gloo;
              keyframe ring split, then the build too) within 5e-4 of
              one process on both ranks — plumbing, not scaling.

Then the line {"kernels": [...]} (all nine kernels: segsum_moments,
build_nodes and build_points per flagship build, descend at a certified
round 0 and icp_terms on its payload, each with its launches in the
steady phase's main-path run; the probe kernels summed over one probe
pass with the probe's launches), the
nvidia-smi line, and last
{"ok": true, "device": {...}}. Imports nothing of JAX or of the JAX
package; the golden file is read with numpy. Needs one card.

Phase 7 ends with a torch.profiler window of steady-state scans: device
kernel time by kernel name, and the device's busy share.

Every phase that goes through Pipeline.compute/compute_device/
compute_batch or Fleet.compute without a mesh replays captured CUDA
graphs from the second odometry scan on; a capture that fails raises.
Every run of the step (every schedule, the fleet, the CLI, the demos)
counts its kernels' launches from 0 and fails if build_nodes,
build_points, descend or icp_terms was never launched. The realtime
scenario of phase 8b derives its sensor rate from the graphed certified
step's measured time, so that its budget is overrun.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
DEV = "cuda"

# flagship configuration of the JAX package's bench (bench.py:100-169)
N_POINTS, DEPTH, KEYFRAMES, MAX_LEAVES = 131072, 16, 16, 32768
# the golden four-walls drive's configuration (tests/test_golden.py)
GOLDEN_KW = dict(num_keyframes=3, n_points=8192, depth=12, max_leaves=4096)
SEGSUM_FLOPS_PER_POINT = 19  # 9 products + 10 adds


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


ASSOC_KERNELS = ("descend", "icp_terms")  # the association's and the terms' kernels
BUILD_KERNELS = ("build_nodes", "build_points")  # the tree build's level pass and pick
# their __global__ functions, as a CUDA trace names them
KERNEL_NAMES = {"descend": ("descend_kernel",),
                "icp_terms": ("terms_kernel", "finish_kernel"),
                "build_nodes": ("nodes_kernel", "close_kernel"),
                "build_points": ("advance_kernel", "pick_min_kernel", "pick_near_kernel")}


def reset_launches() -> None:
    """Set the launch counter of every kernel of the step to 0."""
    from madicp_tpu_torch.models.step_graph import COUNTERS

    for c in COUNTERS.values():
        c.launches = 0


def launches() -> dict:
    """{kernel name: launches since its counter was reset} of the step's
    kernels (segsum_moments, descend, icp_terms)."""
    from madicp_tpu_torch.models.step_graph import COUNTERS

    return {name: c.launches for name, c in COUNTERS.items()}


def check_launched(counts: dict, what: str, kernels=BUILD_KERNELS + ASSOC_KERNELS) -> None:
    for name in kernels:
        check(counts[name] > 0, f"{what}: {name} was never launched")


# ---------------------------------------------------------------- scenes --
def golden_scans():
    """The scans of tests/test_golden.py::_drive (seed 42), in order."""
    rng = np.random.default_rng(42)

    def plane(xr, yr, zr, n):
        return np.column_stack(
            [rng.uniform(*xr, n), rng.uniform(*yr, n), rng.uniform(*zr, n)]
        )

    w, h, n = 4.0, 2.0, 1000
    room = np.vstack([
        plane([0, w], [0, 0], [0, h], n), plane([0, w], [w, w], [0, h], n),
        plane([0, 0], [0, w], [0, h], n), plane([w, w], [0, w], [0, h], n),
        plane([0, w], [0, w], [0, 0], n),
    ])
    scans = []
    for i in range(10):
        t = np.array([0.05 * i, 0.02 * i, 0.0])
        c, s = np.cos(0.003 * i), np.sin(0.003 * i)
        R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])
        scans.append((room - t) @ R + rng.normal(0, 0.001, room.shape))
    return scans


def two_way_world(rng, density: int = 1):
    """Ground plus walls in BOTH orientations (scripts/accuracy_probe.py):
    x translation is observable, unlike in kitti_like_world. 40,800
    points times ``density``."""
    pts = [rng.uniform([-40, -40, -0.05], [40, 40, 0.05], (12000 * density, 3))]
    for i in range(8):
        y = -35 + 10 * i + rng.uniform(-2, 2)
        pts.append(rng.uniform([-40, y - 0.03, 0], [40, y + 0.03, 6], (1800 * density, 3)))
    for i in range(8):
        x = -35 + 10 * i + rng.uniform(-2, 2)
        pts.append(rng.uniform([x - 0.03, -40, 0], [x + 0.03, 40, 6], (1800 * density, 3)))
    return np.concatenate(pts)


def pipeline(**kw):
    from madicp_tpu_torch.models.pipeline import Pipeline

    base = dict(sensor_hz=10.0, deskew=False, b_max=0.2, rho_ker=0.1, p_th=0.8,
                b_min=0.1, b_ratio=0.02, device=DEV)
    base.update(kw)
    return Pipeline(**base)


# ---------------------------------------------------------------- phases --
def phase_device(torch) -> dict:
    from madicp_tpu_torch.utils.device import card_name

    out = {"phase": "device", "name": torch.cuda.get_device_name(0),
           "count": torch.cuda.device_count(),
           "nvidia_smi": card_name(torch.device("cuda", 0)),
           "torch": torch.__version__, "cuda": torch.version.cuda}
    emit(out)
    return out


def phase_build() -> None:
    from madicp_tpu_torch.kernels import build

    t0 = time.perf_counter()
    libs = build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": {k: str(v.relative_to(ROOT)) for k, v in libs.items()}})


def phase_kernels(torch) -> dict:
    from madicp_tpu_torch.kernels import segsum
    from madicp_tpu_torch.probes.segsum_levels import flagship_levels, library_call
    from madicp_tpu_torch.utils.timing import bound_ms, event_ms, graph_ms

    summary = {}
    for dtype in (torch.float32, torch.float64):
        dname = str(dtype).split(".")[1]
        levels = flagship_levels(dtype, torch.device(DEV), N_POINTS, DEPTH)
        check(len(levels) == DEPTH + 1, f"expected {DEPTH + 1} levels, got {len(levels)}")
        esize = torch.finfo(dtype).bits // 8
        rows, tot = [], dict(ms=0.0, device_ms=0.0, plain_ms=0.0, library_ms=0.0,
                             library_device_ms=0.0, bound_ms=0.0)
        max_abs = max_rel = 0.0
        bound_by = set()
        for d, idx, sz in levels:
            got = segsum.segsum_moments(d, idx, sz)
            want = segsum.segsum_moments_ref(d.double(), idx, sz)
            if dtype == torch.float32:
                tol = dict(rtol=1e-5, atol=5e-3)
            else:
                tol = dict(rtol=1e-9, atol=1e-9 * float(want.abs().max()))
            torch.testing.assert_close(got.double(), want, **tol,
                                       msg=lambda m, sz=sz: f"{dname} sz={sz}: {m}")
            err = (got.double() - want).abs()
            max_abs = max(max_abs, float(err.max()))
            max_rel = max(max_rel, float((err / want.abs().clamp_min(1e-30)).max()))
            library = library_call(d, idx, sz)
            ms = event_ms(lambda: segsum.segsum_moments(d, idx, sz), 20)
            device_ms = graph_ms(lambda: segsum.segsum_moments(d, idx, sz), 20)
            plain_ms = event_ms(lambda: segsum.segsum_moments_ref(d, idx, sz), 20)
            library_ms = event_ms(library, 20)
            library_device_ms = graph_ms(library, 20)
            n = d.shape[0]
            pl = segsum.plan(n, sz, segsum.sm_count(d.device))
            bound, by = bound_ms(n * (3 * esize + 4) + sz * 10 * esize,
                                 n * SEGSUM_FLOPS_PER_POINT, dname)
            bound_by.add(by)
            row = {"sz": sz, "path": pl.path, "launches": pl.launches,
                   "ms": ms, "device_ms": device_ms, "plain_ms": plain_ms,
                   "library_ms": library_ms, "library_device_ms": library_device_ms,
                   "bound_ms": bound}
            for k in tot:
                tot[k] += row[k]
            rows.append(dict(row, max_abs_err=float(err.max())))
        summary[dname] = dict(tot, max_abs_err=max_abs, max_rel_err=max_rel,
                              bound_by="/".join(sorted(bound_by)))
        emit({"phase": "kernels", "kernel": "segsum_moments", "dtype": dname,
              "n": N_POINTS, "per_build": summary[dname], "levels": rows})
    return summary


# the association's and the terms' kernels -> the JAX function each
# counterpart ports (XLA-lowered there), and their sources
ASSOC_REPLACES = {"descend": "madicp_tpu/ops/tree.py:685",
                  "icp_terms": "madicp_tpu/ops/icp_core.py:69"}
ASSOC_SOURCES = {"descend": "descent", "icp_terms": "icp_terms"}

PROBE_KERNELS = {  # wrapper -> the TPU kernel it replaces
    "onehot_segsum": "scripts/pallas_scatter_probe.py:66",
    "fused_moments": "scripts/pallas_scatter_probe.py:155",
    "rmw_segsum": "scripts/pallas_scatter_probe.py:365",
    "scatter_segsum": "scripts/pallas_scatter_probe.py:401",
}


def phase_probe(torch) -> dict:
    """One run of the probe entry point, which checks every case before
    it times it; per kernel, its sums over that run's cases and the
    launches the run made."""
    from madicp_tpu_torch.kernels import scatter_probe as sp
    from madicp_tpu_torch.probes import scatter_probe as probe

    for k in sp.launches:
        sp.launches[k] = 0  # the probe's run starts here
    t0 = time.perf_counter()
    records = probe.run(DEV, emit=lambda s: print(s, flush=True))
    seconds = time.perf_counter() - t0
    launches = dict(sp.launches)  # read right after the run
    bad = [r for r in records if not r["ok"]]
    check(not bad, f"probe: cases disagree with their plain versions: {bad}")
    out = {}
    for name in PROBE_KERNELS:
        recs = [r for r in records if r["kernel"] == name]
        check(launches[name] > 0, f"probe: {name} was never launched")
        lib = [r["library_ms"] for r in recs]
        lib_dev = [r["library_device_ms"] for r in recs]
        out[name] = {
            "cases": len(recs), "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in recs),
            **{k: sum(r[k] for r in recs)
               for k in ("ms", "device_ms", "plain_ms", "bound_ms")},
            "library_ms": None if None in lib else sum(lib),
            "library_device_ms": None if None in lib_dev else sum(lib_dev),
            "bound_by": max(recs, key=lambda r: r["bound_ms"])["bound_by"],
        }
    emit({"phase": "probe", "seconds": seconds, "tol": probe.TOL,
          "rmw_segsum": "bitwise equal to the in-order plain version",
          "per_probe_pass": out})
    return out


ASSOC_REPS = 20  # calls a timing
# the live share of a certified round after round 0: a certified flagship
# scan descends 1.71 M entries, 0.52 M of them in round 0, and the other
# 14 rounds hand the descent 0.52 M entries each (PERF.md)
ASSOC_LIVE = 0.16
ASSOC_DRIVE = dict(warm=2, timed=6, profiled=2)  # scans of each certified drive
ASSOC_BOUND_M = 5e-4  # certified f32 divergence bound (tests/test_pipeline.py:368)
DESCENT_FLOPS_PER_PANEL = 8  # the side value: 3 subtractions, 3 products, 2 adds
TERMS_FLOPS_PER_ENTRY = 114  # gate 17, residual 5, u 15, m x u 9, weight 8, s J 6, sums 54


def plain_association():
    """A context in which ``search_forest`` and ``terms_from_payload`` take
    their plain versions on the card too (the kernels' counters stand
    still): the yardstick of the ``assoc`` drive."""
    import contextlib

    from madicp_tpu_torch.kernels import descent, icp_terms

    @contextlib.contextmanager
    def patched():
        real = descent.descend, icp_terms.terms
        descent.descend, icp_terms.terms = descent.descend_plain, icp_terms.terms_plain
        try:
            yield
        finally:
            descent.descend, icp_terms.terms = real

    return patched()


def pose_gap(a, b) -> dict:
    """How far two (S, 4, 4) pose sequences are apart: the largest
    translation difference along x, y and z (m), rotation angle (rad)
    and matrix entry."""
    d = np.abs(a[:, :3, 3] - b[:, :3, 3]).max(axis=0)
    return {"x_m": float(d[0]), "y_m": float(d[1]), "z_m": float(d[2]),
            "rot_rad": max(rotation_angle(p[:3, :3], q[:3, :3]) for p, q in zip(a, b)),
            "max_abs": float(np.abs(a - b).max())}


def rel_frobenius(got, want, axes) -> float:
    """Largest relative Frobenius distance over the leading indices."""
    d = (got.double() - want).square().sum(axes).sqrt()
    return float((d / want.square().sum(axes).sqrt().clamp_min(1e-300)).max())


def plain_build():
    """A context in which the tree build's functions take their plain
    versions on the card too (the build kernels' counters stand still):
    the yardstick of the ``tree`` drive."""
    from madicp_tpu_torch.probes.build_levels import plain_build as patched

    return patched()


def route_context(route: str):
    """The context of a drive's route: the kernels, or the association and
    terms (``plain_association``) or the build (``plain_build``) on their
    plain versions."""
    import contextlib

    return {"kernels": contextlib.nullcontext, "plain_association": plain_association,
            "plain_build": plain_build}[route]()


def certified_drive(torch, route: str) -> dict:
    """The certified flagship drive on the bench's primed ring, graphed:
    poses, launches, scans/s of the timed scans, and a profiled window;
    ``route`` as :func:`route_context`."""
    from madicp_tpu_torch import bench
    from madicp_tpu_torch.probes.segsum_levels import bench_pose

    setup = bench.BenchSetup(DEV, N_POINTS, KEYFRAMES, DEPTH, MAX_LEAVES)
    n_warm, n_timed, n_prof = (ASSOC_DRIVE[k] for k in ("warm", "timed", "profiled"))
    with route_context(route):
        pipe = setup.make_pipe("certified")
        setup.prime(pipe)
        total = n_warm + n_timed + n_prof
        staged = {i: pipe.stage(setup.scan_at(i)) for i in range(1, 1 + total)}
        poses = []

        def step(i):
            pipe.compute_device(0.1 * i, *staged[i])
            poses.append(pipe._last.pose)

        for i in range(1, 1 + n_warm):
            step(i)
        reset_launches()  # the timed run starts here
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(1 + n_warm, 1 + n_warm + n_timed):
            step(i)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launches()  # read right after it
        prof = profile_window(
            lambda: [step(i) for i in range(1 + n_warm + n_timed, 1 + total)], n_prof)
        (capture_ms, nodes, _), = pipe._graphs.captured().values()
    out = {"route": route, "scans_per_s": n_timed / wall,
           "launches_per_scan": {k: v / n_timed for k, v in counts.items()},
           "capture_ms": capture_ms, "nodes": nodes, "profile": prof,
           "poses": torch.stack(poses).cpu().numpy().astype(np.float64)}
    truth = np.stack([np.eye(4) for _ in range(total)])
    for i in range(total):
        truth[i, :3, :3], truth[i, :3, 3] = bench_pose(i + 1)
    out["from_truth"] = pose_gap(out["poses"], truth)
    del pipe, staged
    torch.cuda.empty_cache()
    return out


def phase_assoc(torch, nvidia_smi: str) -> dict:
    """The descent (K6) and the terms (K7) kernels against their plain
    versions on the card at flagship shapes (a primed ring of 16 trees,
    32768 leaves of a bench scan, depth 16), float32 and float64: the
    descent's ids, blocks and margins bit for bit at a certified round 0,
    a later certified round (most entries parked) and a warm start; the
    terms' matched bit for bit and H, b within 1e-5 (1e-12 in float64)
    relative of a float64 sum of the plain version's per-entry terms.
    Eager, graphed and plain ms and the bound of each. Then the certified
    drive graphed twice, with the kernels and with the plain versions:
    device busy and kernels a scan of both on the bench's world (y and z
    within 5e-4 m: x is unobservable there), and the accuracy phase's
    drive on the two-orientation world both ways, within 5e-4 m."""
    from madicp_tpu_torch import bench
    from madicp_tpu_torch.kernels import descent, icp_terms
    from madicp_tpu_torch.ops.tree import build_tree, get_leaves
    from madicp_tpu_torch.probes.segsum_levels import bench_pose
    from madicp_tpu_torch.utils.timing import bound_ms, event_ms, graph_ms

    t_phase = time.perf_counter()
    dev = torch.device(DEV)
    setup = bench.BenchSetup(DEV, N_POINTS, KEYFRAMES, DEPTH, MAX_LEAVES)
    pipe = setup.make_pipe("certified")
    setup.prime(pipe)
    cfg = pipe.cfg
    pts, val, _ = pipe.stage(setup.scan_at(1))
    tree, _ = build_tree(pts, val, depth=cfg.depth, b_max=cfg.b_max, b_min=cfg.b_min)
    leaves = get_leaves(tree, cfg.leaves_cap)
    R, t = bench_pose(1)
    X = np.eye(4)
    X[:3, :3], X[:3, 3] = R, t + np.array([0.02, -0.01, 0.0])  # a GN round near scan 1
    ring = pipe.state.kf_tree.nav.clone()  # (K, M, 56) float32
    del pipe, tree
    K, M = ring.shape[0], ring.shape[1]
    L = leaves.pts.shape[0]
    Q = K * L
    later = torch.from_numpy(np.random.default_rng(5).random((K, L)) < ASSOC_LIVE).to(dev)
    base = (torch.arange(K, device=dev) * M)[:, None].expand(K, L).reshape(Q)
    need = leaves.valid[None].expand(K, L)
    terms_kw = dict(b_max=cfg.b_max, b_ratio=cfg.b_ratio, rho_ker=cfg.rho_ker)
    out = {"phase": "assoc", "nvidia_smi": nvidia_smi,
           "config": {"keyframes": K, "arena_rows": M, "leaves": L,
                      "valid_leaves": int(leaves.valid.sum()), "depth": DEPTH,
                      "later_round_live_share": ASSOC_LIVE}, "descend": {}, "icp_terms": {}}
    for dtype in (torch.float32, torch.float64):
        dname = str(dtype).split(".")[1]
        esize = torch.finfo(dtype).bits // 8
        nav = ring.reshape(K * M, 56).to(dtype)
        lp = leaves.pts.to(dtype)
        Xt = torch.as_tensor(X, dtype=dtype, device=dev)
        q = (lp @ Xt[:3, :3].mT + Xt[:3, 3]).expand(K, L, 3).reshape(Q, 3)
        full = dict(valid=need.reshape(Q), return_blocks=True, return_margin=True)
        ids0, payload0, _ = descent.descend_plain(nav, q, base, DEPTH, **full)
        cases = {
            "round0": full,
            "later_round": dict(full, valid=(need & later).reshape(Q)),
            "warm": dict(valid=need.reshape(Q), start=ids0 >> 6, n_gathers=3,
                         return_blocks=True),
        }
        for case, kw in cases.items():
            got = descent.descend(nav, q, base, DEPTH, **kw)
            want = descent.descend_plain(nav, q, base, DEPTH, **kw)
            for name, a, b in zip(("ids", "blocks", "margins"), got, want):
                check(a.dtype == b.dtype and torch.equal(a, b),
                      f"descend {dname} {case}: {name} differ from the plain version in "
                      f"{int((a != b).reshape(len(a), -1).any(-1).sum())} queries")
            node, blk, margin, keys = descent.panel_reads(
                nav, q, base, DEPTH, kw["valid"], kw.get("start"), kw.get("n_gathers"),
                kw["return_blocks"])
            check(torch.equal(node, want[0]) and torch.equal(blk, want[1]),
                  f"descend {dname} {case}: the read pattern's results differ")
            distinct, reads = int(torch.unique(keys).numel()), int(keys.numel())
            nbytes = (distinct * 8 * esize + Q * (3 * esize + 8 + 1 + 8 + 8 * esize)
                      + (Q * 8 if "start" in kw else 0)
                      + (Q * esize if kw.get("return_margin") else 0))
            bound, by = bound_ms(nbytes, reads * DESCENT_FLOPS_PER_PANEL, dname)
            call = lambda kw=kw: descent.descend(nav, q, base, DEPTH, **kw)  # noqa: E731
            out["descend"].setdefault(dname, {})[case] = {
                "queries": Q, "live": int(kw["valid"].sum()), "panel_reads": reads,
                "distinct_panels": distinct, "plain_rows_read": Q * (
                    kw.get("n_gathers") or descent.default_gathers(DEPTH, True)),
                "ms": event_ms(call, ASSOC_REPS), "device_ms": graph_ms(call, ASSOC_REPS),
                "plain_ms": event_ms(lambda kw=kw: descent.descend_plain(
                    nav, q, base, DEPTH, **kw), ASSOC_REPS),
                "bound_ms": bound, "bound_by": by, "max_abs_err": 0.0,
                "library_ms": None}

        # K7 on the round-0 payload, shaped as the pipeline hands it over
        args = (payload0.view(1, K, L, 8), lp[None, None], leaves.valid[None, None],
                Xt[None, None])
        H, b, matched = icp_terms.terms(*args, **terms_kw)
        Hp, bp, mp = icp_terms.terms_plain(*args, **terms_kw)
        J, s, e, _ = icp_terms.entry_terms(*args, **terms_kw)
        Js = (J * s[..., None]).double()
        H_ref, b_ref = Js.mT @ J.double(), torch.sum(Js * e.double()[..., None], dim=-2)
        tol = 1e-5 if dtype == torch.float32 else 1e-12
        errs = {"H": rel_frobenius(H, H_ref, (-2, -1)), "b": rel_frobenius(b, b_ref, (-1,)),
                "plain_H": rel_frobenius(Hp, H_ref, (-2, -1)),
                "plain_b": rel_frobenius(bp, b_ref, (-1,))}
        check(torch.equal(matched, mp), f"icp_terms {dname}: matched differs from the plain "
              f"version in {int((matched != mp).sum())} entries")
        check(errs["H"] <= tol and errs["b"] <= tol,
              f"icp_terms {dname}: H, b {errs} from the float64 sum, tolerance {tol}")
        nbytes = (K * L * (8 * esize + 1) + L * (3 * esize + 1) + 16 * esize
                  + K * 42 * esize)
        bound, by = bound_ms(nbytes, K * L * TERMS_FLOPS_PER_ENTRY, dname)
        call = lambda: icp_terms.terms(*args, **terms_kw)  # noqa: E731
        out["icp_terms"][dname] = {
            "entries": K * L, "matched": int(matched.sum()), "rel_err": errs, "tol": tol,
            "max_abs_err": max(float((H.double() - H_ref).abs().max()),
                               float((b.double() - b_ref).abs().max())),
            "ms": event_ms(call, ASSOC_REPS), "device_ms": graph_ms(call, ASSOC_REPS),
            "plain_ms": event_ms(lambda: icp_terms.terms_plain(*args, **terms_kw),
                                 ASSOC_REPS),
            "bound_ms": bound, "bound_by": by, "library_ms": None}
        del nav, q, ids0, payload0, args, H, b, matched, Hp, bp, mp, J, s, e, Js
        torch.cuda.empty_cache()
    del ring, leaves
    torch.cuda.empty_cache()

    # the certified drive with the kernels, then with the plain versions:
    # on the bench's world (timed) and on the two-orientation world
    drives = [certified_drive(torch, route) for route in ("kernels", "plain_association")]
    bench_gap = pose_gap(drives[0].pop("poses"), drives[1].pop("poses"))
    two_way = []
    for route in ("kernels", "plain_association"):
        with route_context(route):
            two_way.append(two_way_drive()[0])
        torch.cuda.empty_cache()
    two_way_gap = pose_gap(*two_way)
    out["drive"] = {"schedule": "certified", "graphed": True, **ASSOC_DRIVE,
                    "kernels": drives[0], "plain": drives[1], "bench_world_gap": bench_gap,
                    "two_way_world_gap": two_way_gap, "bound_m": ASSOC_BOUND_M}
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)
    check(two_way_gap["max_abs"] <= ASSOC_BOUND_M,
          f"assoc: kernel and plain drives {two_way_gap} apart on the two-orientation world")
    # the bench's world has no wall across x (x is unobservable there: both
    # drives stay ~10 m behind the truth along it), so only y and z hold
    check(max(bench_gap["y_m"], bench_gap["z_m"]) <= ASSOC_BOUND_M,
          f"assoc: kernel and plain drives {bench_gap} apart on the bench's world")
    check_launched(drives[0]["launches_per_scan"], "assoc drive")
    check_launched(drives[1]["launches_per_scan"], "assoc plain drive", BUILD_KERNELS)
    for name in ASSOC_KERNELS:
        check(drives[1]["launches_per_scan"][name] == 0,
              f"assoc plain drive: {name} was launched")
    return out


# the tree build's kernels -> the JAX code each counterpart ports (XLA
# lowered there), and their sources
BUILD_REPLACES = {"build_nodes": "madicp_tpu/ops/tree.py:457",
                  "build_points": "madicp_tpu/ops/tree.py:492"}
TREE_REPS = 10  # calls a timing
NODE_FLOPS = 400  # about: the eigensolver ~350 (six cross products, roots), node fields ~50
POINT_FLOPS = 24  # d2 3, v 15, a norm 6


def padded(scan, n: int):
    """A cloud padded (or cut) to ``n`` points: (n, 3) points, (n,) valid."""
    pts = np.zeros((n, 3))
    m = min(len(scan), n)
    pts[:m] = scan[:m]
    return pts, np.arange(n) < m


def build_call_cost(c, esize: int) -> tuple:
    """(bytes, operations) of one recorded call of the build (a
    :class:`~madicp_tpu_torch.probes.build_levels.Call`): each input read
    once and each output written once, counting what this call's data
    needs (the live points, their distinct nodes, the points that freeze)."""
    import torch

    ksize = esize  # keys have the floats' width
    if c.name == "build_nodes":
        mom, prev, arena = c.args
        nseg = mom.shape[0]
        parents = 0 if prev is None else nseg // 2
        # a node: 10 moments read, pack, state and arena row written, 6
        # keys set; a parent: its mean and PCA normal (6 of its pack), 8
        # state values and 6 keys read, its bbox0 and is_leaf written
        nbytes = (nseg * (10 + 13 + 8 + 10) * esize + nseg * 6 * ksize
                  + parents * ((6 + 8 + 2) * esize + 6 * ksize)
                  + (arena.shape[0] * 12 * esize if prev is None else 0))
        return nbytes, nseg * NODE_FLOPS
    if c.name == "close_level":
        state, ext, _ = c.args
        return state.shape[0] * (3 * esize + 6 * ksize), state.shape[0] * 10
    if c.name == "build_points":
        # every id read and next id written; a live point's position; d
        # read by the points that retire, d_next written by those that
        # advance; a live node's pack and keys; leaf_of and frz_dist
        # written by the points that retire or freeze
        idx, packA = c.args[2], c.args[5]
        n, nseg = idx.shape[0], packA.shape[0]
        live = (idx >= 0) & (idx < nseg)
        dead = live & (packA[torch.where(live, idx, 0).long(), 12] > 0)
        n_live, n_dead = int(live.sum()), int(dead.sum())
        n_adv = int((c.results[1] >= 0).sum())
        nodes = int(torch.unique(idx[live]).numel())
        nbytes = (n * 8 + (n_live + n_dead + n_adv) * 3 * esize
                  + nodes * (13 * esize + 6 * ksize) + (n_live - n_adv) * (8 + esize))
        return nbytes, n_live * POINT_FLOPS
    valid = c.args[0]
    n, n_valid, rows = valid.numel(), int(valid.sum()), c.results[0].numel()
    nbytes = n + n_valid * (8 + esize) + rows * ksize
    if c.name == "pick_near":
        nbytes += rows * 8
    return nbytes, n_valid * 3


def time_build_calls(torch, calls, kernel: str, dname: str) -> dict:
    """A kernel's eager, graphed and plain ms and bound, summed over its
    recorded calls of one build (each call on copies of its inputs; the
    in-place results are idempotent, so repeats redo the same work)."""
    from madicp_tpu_torch.probes import build_levels as bl
    from madicp_tpu_torch.utils.timing import bound_ms, event_ms, graph_ms

    esize = torch.finfo(getattr(torch, dname)).bits // 8
    tot = dict(ms=0.0, device_ms=0.0, plain_ms=0.0, bound_ms=0.0, bytes=0, operations=0)
    by = set()
    for c in calls:
        if c.name not in bl.KERNELS[kernel]:
            continue
        args = bl.copy_args(c.args)
        fn = getattr(bl._MODULE[c.name], c.name)
        call = lambda fn=fn, args=args, kw=c.kwargs: fn(*args, **kw)  # noqa: E731
        plain = lambda c=c, args=args: bl.PLAIN[c.name](*args, **c.kwargs)  # noqa: E731
        nbytes, ops = build_call_cost(c, esize)
        bound, b = bound_ms(nbytes, ops, dname)
        by.add(b)
        tot["ms"] += event_ms(call, TREE_REPS)
        tot["device_ms"] += graph_ms(call, TREE_REPS)
        tot["plain_ms"] += event_ms(plain, TREE_REPS)
        tot["bound_ms"] += bound
        tot["bytes"] += nbytes
        tot["operations"] += ops
    tot["bound_by"] = "bytes" if by == {"bytes"} else "operations"
    return tot


def phase_tree(torch, nvidia_smi: str) -> dict:
    """The tree build's kernels, build_nodes (K9) and build_points (K8),
    against their plain versions on the card at flagship shapes (131072
    points, depth 16: the bench's scan, a scan of the two-orientation
    world, a B = 4 fleet batch), float32 and float64: every call of a
    build bit for bit, and the nav and point_leaf of the kernels' build
    equal to those of the plain versions' build on the same moments;
    launches a build. Eager, graphed and plain ms of each kernel and of a
    whole build, with the bound. Then the certified drive graphed twice,
    with the build kernels and with the build on its plain versions:
    scans/s, device busy and kernels a scan of both on the bench's world
    (y and z within 5e-4 m), and the accuracy phase's drive on the
    two-orientation world both ways, within 5e-4 m."""
    import contextlib

    from madicp_tpu_torch import bench
    from madicp_tpu_torch.ops.tree import build_tree
    from madicp_tpu_torch.probes import build_levels
    from madicp_tpu_torch.utils.timing import bound_ms, event_ms, graph_ms

    t_phase = time.perf_counter()
    dev = torch.device(DEV)
    kw = dict(depth=DEPTH, b_max=0.2, b_min=0.1)
    setup = bench.BenchSetup(DEV, N_POINTS, KEYFRAMES, DEPTH, MAX_LEAVES)
    world = two_way_world(np.random.default_rng(7))
    r = np.linalg.norm(world, axis=1)
    clouds = {
        "bench_scan": padded(setup.scan_at(1), N_POINTS),
        "two_way_scan": padded(world[(r > 1.0) & (r < 80.0)], N_POINTS),
        "fleet_b4": fleet_batch(fleet_sequences(FLEET_SPEEDS, 1), 0, N_POINTS),
    }
    out = {"phase": "tree", "nvidia_smi": nvidia_smi, "depth": DEPTH, "cases": {},
           "timing": {}}
    for name, (pts, val) in clouds.items():
        for dtype in (torch.float32, torch.float64):
            dname = str(dtype).split(".")[1]
            points = torch.as_tensor(pts, dtype=dtype, device=dev)
            valid = torch.as_tensor(val, device=dev)
            reset_launches()  # one build's launches
            tree, leaf, calls, moments = build_levels.record_build(points, valid, **kw)
            torch.cuda.synchronize()
            counts = launches()
            report = build_levels.check_calls(calls)
            tree_p, leaf_p = build_levels.replay_build(points, valid, moments, **kw)
            row = {"clouds": 1 if points.dim() == 2 else points.shape[0],
                   "valid_points": int(valid.sum()), "launches_a_build": counts,
                   "calls": report, "nav_equal": torch.equal(tree.nav, tree_p.nav),
                   "point_leaf_equal": torch.equal(leaf, leaf_p),
                   "nav_max_abs_diff": float((tree.nav - tree_p.nav).abs().max()),
                   "points_on_another_leaf": int((leaf != leaf_p).sum())}
            out["cases"][f"{name} {dname}"] = row
            if name == "bench_scan":  # the main path's build, timed
                esize = torch.finfo(dtype).bits // 8
                seg_bytes = sum(d.shape[0] * (3 * esize + 4) + t.numel() * esize
                                for d, _, t in moments)
                seg_ops = sum(d.shape[0] * SEGSUM_FLOPS_PER_POINT for d, _, _ in moments)
                kernels = {k: time_build_calls(torch, calls, k, dname) for k in BUILD_KERNELS}
                seg_bound, _ = bound_ms(seg_bytes, seg_ops, dname)
                build = lambda: build_tree(points, valid, **kw)  # noqa: E731
                whole = {"ms": event_ms(build, TREE_REPS), "device_ms": graph_ms(build, TREE_REPS),
                         "bound_ms": seg_bound + sum(k["bound_ms"] for k in kernels.values())}
                with plain_build():
                    whole["plain_ms"] = event_ms(build, TREE_REPS)
                # float64: the segment-sum's double atomics may round a
                # table's last bit differently from run to run, so the graph
                # replays the recorded tables there (the build's own kernels
                # are what the replay must repeat)
                with (build_levels.replaying(moments, check=False) if dtype == torch.float64
                      else contextlib.nullcontext()):
                    g_tree, g_leaf = graph_build(torch, build)
                whole["graph_replay_equal"] = (torch.equal(g_tree.nav, tree.nav)
                                               and torch.equal(g_leaf, leaf))
                whole["graph_replays_recorded_moments"] = dtype == torch.float64
                out["timing"][dname] = {"kernels": {k: dict(v, max_abs_err=report[k]["max_abs_err"])
                                                    for k, v in kernels.items()},
                                        "build": whole}
                check(whole["graph_replay_equal"], f"tree {dname}: a graph replay of the build "
                      "differs from the eager build")
            emit({"phase": "tree", "part": f"{name} {dname}", **row})
            for k in BUILD_KERNELS:
                check(report[k]["equal"], f"tree {name} {dname}: {k} differs from its plain "
                      f"version: {report[k]}")
            check(row["nav_equal"] and row["point_leaf_equal"],
                  f"tree {name} {dname}: the kernels' build differs from the plain versions' "
                  f"by {row['nav_max_abs_diff']} in nav, {row['points_on_another_leaf']} "
                  "points on another leaf")
            check(counts["build_nodes"] == DEPTH + 2 and counts["build_points"] == DEPTH + 3,
                  f"tree {name} {dname}: launches {counts}, want {DEPTH + 2} build_nodes and "
                  f"{DEPTH + 3} build_points")
            del points, valid, tree, leaf, calls, moments, tree_p, leaf_p
            torch.cuda.empty_cache()

    # the certified drive with the build kernels, then with the plain build
    drives = [certified_drive(torch, route) for route in ("kernels", "plain_build")]
    bench_gap = pose_gap(drives[0].pop("poses"), drives[1].pop("poses"))
    two_way = []
    for route in ("kernels", "plain_build"):
        with route_context(route):
            two_way.append(two_way_drive()[0])
        torch.cuda.empty_cache()
    two_way_gap = pose_gap(*two_way)
    out["drive"] = {"schedule": "certified", "graphed": True, **ASSOC_DRIVE,
                    "kernels": drives[0], "plain_build": drives[1],
                    "bench_world_gap": bench_gap, "two_way_world_gap": two_way_gap,
                    "bound_m": ASSOC_BOUND_M}
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)
    check(two_way_gap["max_abs"] <= ASSOC_BOUND_M,
          f"tree: kernel and plain-build drives {two_way_gap} apart on the two-orientation world")
    check(max(bench_gap["y_m"], bench_gap["z_m"]) <= ASSOC_BOUND_M,
          f"tree: kernel and plain-build drives {bench_gap} apart on the bench's world")
    check_launched(drives[0]["launches_per_scan"], "tree drive")
    check_launched(drives[1]["launches_per_scan"], "tree plain drive", ASSOC_KERNELS)
    for name in BUILD_KERNELS:
        check(drives[1]["launches_per_scan"][name] == 0,
              f"tree plain drive: {name} was launched")
    return out


def graph_build(torch, build):
    """``build()`` captured in a CUDA graph and replayed once: its
    (tree, point_leaf), copied."""
    build()  # warm: the segment-sum's workspace is sized outside capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        tree, leaf = build()
    tree.nav.zero_()
    leaf.zero_()
    graph.replay()
    torch.cuda.synchronize()
    out = type(tree)(nav=tree.nav.clone()), leaf.clone()
    del graph
    return out


def phase_precision(torch) -> None:
    """f32 point transforms on the card vs f64 at 40 m range (a TF32
    matmul would be off by centimetres)."""
    from madicp_tpu_torch.ops.lie import exp_so3

    g = torch.Generator().manual_seed(3)
    dirs = torch.randn(65536, 3, generator=g, dtype=torch.float64)
    pts = 40.0 * dirs / dirs.norm(dim=1, keepdim=True)
    R = exp_so3(torch.tensor([0.3, -0.2, 0.9], dtype=torch.float64))
    t = torch.tensor([5.0, -3.0, 0.5], dtype=torch.float64)
    want = pts @ R.T + t
    p32, R32, t32 = (x.float().to(DEV) for x in (pts, R, t))
    errs = {
        "matmul": float(((p32 @ R32.T + t32).double().cpu() - want).norm(dim=1).max()),
        "einsum": float((torch.einsum("ij,nj->ni", R32, p32) + t32).double().cpu()
                        .sub(want).norm(dim=1).max()),
    }
    emit({"phase": "precision", "range_m": 40.0, "max_err_m": errs, "bound_m": 1e-4})
    check(max(errs.values()) <= 1e-4, f"point transform error {errs} > 1e-4 m")


def phase_golden(torch) -> None:
    golden = np.load(ROOT / "tests" / "golden_four_walls.npz")
    scans = golden_scans()
    gt = np.stack([np.array([0.05 * i, 0.02 * i, 0.0]) for i in range(10)])
    for dtype in (torch.float64, torch.float32):
        for certify in (True, False):
            pipe = pipeline(dtype=dtype, certify=certify, **GOLDEN_KW)
            poses, ratios = [], []
            for i, scan in enumerate(scans):
                pipe.compute(0.1 * i, scan)
                poses.append(pipe.current_pose().astype(np.float64))
                ratios.append(pipe.inlier_ratio())
            poses = np.stack(poses)
            dev_golden = float(np.abs(poses - golden["poses"]).max())
            dev_gt = float(np.linalg.norm(poses[:, :3, 3] - gt, axis=1).max())
            emit({"phase": "golden", "dtype": str(dtype).split(".")[1],
                  "certify": certify, "max_dev_from_golden": dev_golden,
                  "max_err_vs_truth_m": dev_gt, "min_inlier_ratio": min(ratios)})
            if dtype == torch.float64:
                check(dev_golden <= 1e-6, f"f64 golden deviates {dev_golden:.2e}")
            else:
                check(dev_gt < 5e-3, f"f32 golden drive error {dev_gt:.2e} m")
                check(min(ratios) > 0.95, f"f32 inlier ratio {min(ratios):.3f}")


def two_way_drive():
    """The flagship main path over 12 scans of the two-orientation world,
    0.3 m a scan along x: ((12, 4, 4) float64 poses, the pipeline)."""
    world = two_way_world(np.random.default_rng(7))
    pipe = pipeline(num_keyframes=KEYFRAMES, n_points=N_POINTS,
                    depth=DEPTH, max_leaves=MAX_LEAVES)
    poses = []
    for k in range(12):
        p = world - np.array([0.3 * k, 0.0, 0.0])
        r = np.linalg.norm(p, axis=1)
        pipe.compute(0.1 * k, p[(r > 1.0) & (r < 80.0)])
        poses.append(pipe.current_pose().astype(np.float64))
    return np.stack(poses), pipe


def phase_accuracy(torch) -> None:
    reset_launches()
    poses, pipe = two_way_drive()
    counts = launches()
    errs = [abs(float(T[0, 3]) - 0.3 * k) for k, T in enumerate(poses)]
    worst = max(errs[1:])  # scan 0 is the identity bootstrap
    emit({"phase": "accuracy", "scans": 12, "step_m": 0.3,
          "per_scan_x_err_mm": [e * 1e3 for e in errs], "max_err_mm": worst * 1e3,
          "bound_mm": 10.0, "inlier_ratio": pipe.inlier_ratio(),
          "segsum_launches": counts["segsum_moments"], "launches": counts})
    check(counts["segsum_moments"] == 12 * (DEPTH + 1),
          f"segsum launched {counts['segsum_moments']} times in 12 scans")
    check_launched(counts, "accuracy")
    check(worst <= 0.01, f"flagship motion error {worst * 1e3:.2f} mm > 10 mm")


def profile_window(run, n_scans: int) -> dict:
    """Device time by CUDA kernel name and the device's busy share over
    ``run()`` (``n_scans`` scans), from torch.profiler."""
    from madicp_tpu_torch.utils.timing import device_kernels

    by_us, wall_ms = device_kernels(run)
    by_name = {k: (us / 1e3, cnt) for k, (us, cnt) in by_us.items()}
    busy_ms = sum(ms for ms, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:25]
    own = {k: sum(ms for name, (ms, _) in by_name.items()
                  if any(f"::{p}<" in name for p in pats)) / n_scans
           for k, pats in KERNEL_NAMES.items()}
    return {
        "wall_ms_per_scan": wall_ms / n_scans,
        "device_busy_ms_per_scan": busy_ms / n_scans,
        "device_busy_share": busy_ms / wall_ms,
        "kernels_per_scan": sum(c for _, c in by_name.values()) / n_scans,
        "kernel_ms_per_scan": own,
        "top_kernels": [{"name": k[:120], "ms_per_scan": ms / n_scans,
                         "launches_per_scan": c / n_scans} for k, (ms, c) in top],
    }


def phase_steady(torch) -> dict:
    from madicp_tpu_torch.bench import BenchSetup
    from madicp_tpu_torch.utils.timing import PHASES, PhaseTimer

    setup = BenchSetup(DEV, N_POINTS, KEYFRAMES, DEPTH, MAX_LEAVES)
    scan_at = setup.scan_at
    pipe = setup.make_pipe("certified")
    # steady state: a full ring of 16 keyframes from staggered viewpoints
    setup.prime(pipe)

    n_warm, n_timed, n_phase = 3, 12, 4
    total = n_warm + n_timed + 2 * n_phase
    staged = {i: pipe.stage(scan_at(i)) for i in range(1, 1 + total)}
    for i in range(1, 1 + n_warm):
        pipe.compute_device(0.1 * i, *staged[i])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    reset_launches()  # the main path's run starts here
    lo = 1 + n_warm
    poses, descents, n_leaves = [], [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(lo, lo + n_timed):
        pipe.compute_device(0.1 * i, *staged[i])
        descents.append(pipe._last.n_descents)
        n_leaves.append(pipe._last.n_leaves)
        poses.append(pipe._last.pose)  # the scan's own (the state changes in place)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launches()  # read right after the run
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    timer = PhaseTimer(torch.device(DEV))
    pipe.timer = timer
    for i in range(lo + n_timed, lo + n_timed + n_phase):
        pipe.compute_device(0.1 * i, *staged[i])
    per_phase = {k: v / n_phase for k, v in timer.totals_ms().items()}
    pipe.timer = None
    i0 = lo + n_timed + n_phase

    def run():
        for i in range(i0, i0 + n_phase):
            pipe.compute_device(0.1 * i, *staged[i])

    prof = profile_window(run, n_phase)

    poses = torch.stack(poses).cpu().numpy()
    descents = [int(d) for d in descents]
    n_leaves = [int(n) for n in n_leaves]
    out = {"phase": "steady", "config": {"n_points": N_POINTS, "depth": DEPTH,
           "keyframes": KEYFRAMES, "max_leaves": MAX_LEAVES, "rounds": 15,
           "dtype": "float32", "schedule": "certified exact"},
           "scans_timed": n_timed, "scans_per_s": n_timed / wall,
           "ms_per_scan": wall * 1e3 / n_timed,
           "phase_ms_per_scan": {k: per_phase.get(k, 0.0) for k in PHASES},
           "descents_per_scan": descents, "n_leaves": n_leaves,
           "segsum_launches": counts["segsum_moments"], "launches": counts,
           "peak_mem_gb": peak_gb,
           "profile": prof}
    emit(out)
    check(np.isfinite(poses).all(), "non-finite poses")
    check(all(d < 15 * KEYFRAMES * n for d, n in zip(descents, n_leaves)),
          "certified schedule walked every descent: the certificate did nothing")
    check(counts["segsum_moments"] == n_timed * (DEPTH + 1),
          f"segsum launched {counts['segsum_moments']} times in {n_timed} scans, "
          f"want {DEPTH + 1} a scan")
    check_launched(counts, "steady")
    return out


def rotation_angle(Ra, Rb) -> float:
    """Angle in radians of the rotation between Ra and Rb, from
    |Ra - Rb|_F = 2 sqrt(2) sin(angle / 2) (exact near zero, where an
    arccos of the trace rounds to 0)."""
    s = np.linalg.norm(Ra - Rb) / (2.0 * np.sqrt(2.0))
    return float(2.0 * np.arcsin(min(s, 1.0)))


def phase_schedules(torch) -> dict:
    """The schedules beside certified exact, on the card: the float64
    golden drive under each, compute_batch, and the flagship numbers of
    all five through the bench module's own functions."""
    from madicp_tpu_torch import bench

    t0 = time.perf_counter()
    scans = golden_scans()

    def drive(device=DEV, **sched):
        pipe = pipeline(dtype=torch.float64, device=device, **GOLDEN_KW, **sched)
        poses, descents = [], []
        for i, scan in enumerate(scans):
            pipe.compute(0.1 * i, scan)
            poses.append(pipe.current_pose())
            descents.append(pipe.descents())
        return np.stack(poses), descents

    exact, exact_desc = drive(certify=False)
    _, cert_desc = drive()
    golden = []
    for name, sched, tol in (
        ("compact", dict(certify_compact=16), None), ("compact", dict(certify_compact=2048), None),
        ("prefix", dict(certify_prefix=16), None), ("prefix", dict(certify_prefix=2048), None),
        ("fast", dict(assoc_mode="fast", reassoc_every=2), (5e-3, 1e-3)),
        ("fast", dict(assoc_mode="fast", reassoc_every=7), (5e-3, 1e-3)),
        ("fast", dict(assoc_mode="fast", reassoc_every=2, reassoc_backup=6), (5e-3, 1e-3)),
    ):
        poses, desc = drive(**sched)
        row = {"schedule": name, **sched, "descents": desc,
               "max_dev_from_exact": float(np.abs(poses - exact).max()),
               "max_dt_m": float(np.linalg.norm(poses[:, :3, 3] - exact[:, :3, 3], axis=1).max()),
               "max_drot_rad": max(rotation_angle(a[:3, :3], b[:3, :3])
                                   for a, b in zip(poses, exact))}
        label = f"{name} {sched}"
        if tol is None:
            want = cert_desc if name == "compact" else drive(device="cpu", **sched)[1]
            row["descents_want"] = want
            check(row["max_dev_from_exact"] <= 1e-9,
                  f"{label}: {row['max_dev_from_exact']:.2e} from plain exact")
            check(desc == want, f"{label}: descents {desc}, want {want}")
        else:
            check(row["max_dt_m"] <= tol[0] and row["max_drot_rad"] <= tol[1],
                  f"{label}: {row['max_dt_m']:.2e} m, {row['max_drot_rad']:.2e} rad from exact")
        golden.append(row)
    emit({"phase": "schedules", "part": "golden", "dtype": "float64",
          "exact_descents": exact_desc, "certified_descents": cert_desc, "drives": golden})

    stamps = [0.1 * i for i in range(4)]
    chunk = pipeline(dtype=torch.float64, **GOLDEN_KW)
    batch = chunk.compute_batch(stamps, scans[:4])
    one = pipeline(dtype=torch.float64, **GOLDEN_KW)
    seq = []
    for stamp, scan in zip(stamps, scans):
        one.compute_device(stamp, *one.stage(scan))
        seq.append(one.current_pose())
    dt = float(np.linalg.norm(batch[:, :3, 3] - np.stack(seq)[:, :3, 3], axis=1).max())
    distinct = len({p.tobytes() for p in batch})
    emit({"phase": "schedules", "part": "compute_batch", "scans": 4, "max_dt_m": dt,
          "bound_m": 1e-6, "distinct_poses": distinct,
          "graphs": len(chunk._graphs.captured())})
    check(batch.shape == (4, 4, 4) and dt <= 1e-6, f"compute_batch {dt:.2e} m from compute_device")
    check(distinct == 4, f"compute_batch: {distinct} distinct poses of 4 (aliased outputs)")
    check(len(chunk._graphs.captured()) == 1, "compute_batch replayed no captured graph")

    setup = bench.BenchSetup(DEV, N_POINTS, KEYFRAMES, DEPTH, MAX_LEAVES)
    n_windows, n_steps = 3, 4
    flagship = {}
    for spec in ["certified"] + [s for s in bench.SCHEDULES if s != "certified"]:
        r = bench.run_schedule(setup, spec, n_warmup=2, n_steps=n_steps, n_windows=n_windows)
        flagship[spec] = r
        want = n_windows * n_steps * (DEPTH + 1)
        check(r["segsum_launches"] == want,
              f"{spec}: segsum launched {r['segsum_launches']} times, want {want}")
        check_launched(r["kernel_launches"], spec)
        torch.cuda.empty_cache()
    out = {"phase": "schedules", "part": "flagship", "config": {
        "n_points": N_POINTS, "depth": DEPTH, "keyframes": KEYFRAMES,
        "max_leaves": MAX_LEAVES, "rounds": 15, "dtype": "float32",
        "windows": n_windows, "scans_a_window": n_steps},
        "schedules": flagship, "seconds": time.perf_counter() - t0}
    emit(out)
    return out


GRAPH_SCANS, GRAPH_PROFILED = 12, 3  # timed and profiled scans a side
GRAPH_BOUND_M = 5e-4  # certified f32 divergence bound (tests/test_pipeline.py:368)
RT_SCANS, RT_EVERY = 12, 3
# the realtime budget (1 / sensor_hz - 5 ms, the pipeline's reserve) as a
# share of the graphed certified step's measured time: the step overruns
# it, so the iteration count must change
RT_RESERVE_S, RT_BUDGET_SHARE = 0.005, 0.4


def enqueue_run(step, scans) -> tuple:
    """(host enqueue ms of each ``step(i)`` — until it returns, with no
    synchronisation — and the window's wall seconds, synchronised)."""
    import torch

    enq = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in scans:
        t = time.perf_counter()
        step(i)
        enq.append((time.perf_counter() - t) * 1e3)
    torch.cuda.synchronize()
    return enq, time.perf_counter() - t0


def phase_graphs(torch, nvidia_smi: str) -> dict:
    """The flagship step graphed against eager, every schedule: two
    bench pipelines primed alike on the same scans, one through
    ``compute_device`` (a replay of its captured graph a scan from the
    second odometry scan on), one running the captured body
    (``step_in_place``) eagerly; scans/s, host enqueue ms, device busy
    and kernels a scan of each, the graph's capture ms, nodes and pool
    bytes, the pose difference. Then a realtime pipeline whose budget, a
    share of the graphed certified step's measured time, moves its
    iteration count: a graph a count."""
    from madicp_tpu_torch import bench
    from madicp_tpu_torch.models.step_graph import step_in_place

    t_phase = time.perf_counter()
    n_warm = 2  # graphed: the warm-up, then the capture and first replay
    rows = {}
    for spec in ["certified"] + [s for s in bench.SCHEDULES if s != "certified"]:
        setups = [bench.BenchSetup(DEV, N_POINTS, KEYFRAMES, DEPTH, MAX_LEAVES)
                  for _ in range(2)]  # one seed: the same world, rings and noise
        graphed, eager = (st.make_pipe(spec) for st in setups)
        for st, pipe in zip(setups, (graphed, eager)):
            st.prime(pipe)
        total = n_warm + GRAPH_SCANS + GRAPH_PROFILED
        staged = {i: graphed.stage(setups[0].scan_at(i)) for i in range(1, 1 + total)}
        poses = {"graphed": {}, "eager": {}}

        def step_graphed(i):
            graphed.compute_device(0.1 * i, *staged[i])
            poses["graphed"][i] = graphed._last.pose

        def step_eager(i):
            pts, val, _ = staged[i]
            out = step_in_place(eager.cfg, eager._graphs.state, pts[None], val[None])
            poses["eager"][i] = out.pose[0]

        warm, timed = range(1, 1 + n_warm), range(1 + n_warm, 1 + n_warm + GRAPH_SCANS)
        profiled = range(1 + n_warm + GRAPH_SCANS, 1 + total)
        for i in warm:
            step_graphed(i)
            step_eager(i)
        side = {}
        for name, step in (("graphed", step_graphed), ("eager", step_eager)):
            reset_launches()  # this window starts here
            enq, wall = enqueue_run(step, timed)
            counts = launches()  # read right after the window
            prof = profile_window(lambda step=step: [step(i) for i in profiled],
                                  GRAPH_PROFILED)
            side[name] = {"scans_per_s": GRAPH_SCANS / wall,
                          "ms_per_scan": wall * 1e3 / GRAPH_SCANS,
                          "enqueue_ms_median": float(np.median(enq)),
                          "enqueue_ms_max": max(enq),
                          "device_busy_ms_per_scan": prof["device_busy_ms_per_scan"],
                          "device_busy_share": prof["device_busy_share"],
                          "kernels_per_scan": prof["kernels_per_scan"],
                          "segsum_launches_per_scan": counts["segsum_moments"] / GRAPH_SCANS,
                          "launches_per_scan": {k: v / GRAPH_SCANS
                                                for k, v in counts.items()}}
        (capture_ms, nodes, replay_launches), = graphed._graphs.captured().values()
        pool = graphed._graphs.pool_bytes()
        scans = sorted(poses["eager"])
        diff = max(float((poses["graphed"][i] - poses["eager"][i]).abs().max()) for i in scans)
        g, e = side["graphed"], side["eager"]
        kernels_dev = abs(g["kernels_per_scan"] - e["kernels_per_scan"]) / e["kernels_per_scan"]
        rows[spec] = dict(side, capture_ms=capture_ms, nodes=nodes, pool_bytes=pool,
                          launches_a_replay=replay_launches, scans_compared=len(scans),
                          max_pose_dev_m=diff, kernels_rel_dev=kernels_dev,
                          speedup=g["scans_per_s"] / e["scans_per_s"])
        emit({"phase": "graphs", "part": "flagship", "schedule": spec,
              "nvidia_smi": nvidia_smi, **rows[spec]})
        check(diff <= GRAPH_BOUND_M, f"{spec}: graphed pose {diff:.2e} m from eager")
        check(kernels_dev <= 0.01, f"{spec}: {g['kernels_per_scan']} kernels a graphed scan, "
              f"{e['kernels_per_scan']} eager")
        for name in side:
            check(side[name]["segsum_launches_per_scan"] == DEPTH + 1,
                  f"{spec} {name}: {side[name]['segsum_launches_per_scan']} segsum launches "
                  "a scan")
            check_launched(side[name]["launches_per_scan"], f"{spec} {name}")
        del graphed, eager, staged, poses, setups
        torch.cuda.empty_cache()

    # realtime: the anytime budget moves the iteration count, a key a count
    world = two_way_world(np.random.default_rng(7))
    step_s = rows["certified"]["graphed"]["ms_per_scan"] / 1e3
    rt_hz = 1.0 / (RT_RESERVE_S + RT_BUDGET_SHARE * step_s)
    rt = pipeline(realtime=True, sensor_hz=rt_hz, realtime_recal_every=RT_EVERY,
                  num_keyframes=KEYFRAMES, n_points=N_POINTS, depth=DEPTH,
                  max_leaves=MAX_LEAVES)
    rt_poses, its = [], []
    for k in range(RT_SCANS):
        p = world - np.array([0.3 * k, 0.0, 0.0])
        r = np.linalg.norm(p, axis=1)
        rt.compute(k / rt_hz, p[(r > 1.0) & (r < 80.0)])
        rt_poses.append(rt.current_pose())
        its.append(rt.cfg.max_icp_iterations)
    keys = sorted(cfg.max_icp_iterations for cfg in rt._graphs.captured())
    realtime = {"sensor_hz": rt_hz, "budget_ms": (1.0 / rt_hz - RT_RESERVE_S) * 1e3,
                "graphed_step_ms": step_s * 1e3, "recal_every": RT_EVERY, "scans": RT_SCANS,
                "iterations_per_scan": its, "graph_keys_iterations": keys,
                "pool_bytes": rt._graphs.pool_bytes()}
    emit({"phase": "graphs", "part": "realtime", **realtime})
    check(np.isfinite(np.stack(rt_poses)).all(), "realtime: non-finite poses")
    check(len(keys) >= 2, f"realtime: graphs captured for iteration counts {keys}")
    del rt
    torch.cuda.empty_cache()
    out = {"phase": "graphs", "nvidia_smi": nvidia_smi, "flagship": rows,
           "realtime": realtime, "seconds": time.perf_counter() - t_phase}
    emit({"phase": "graphs", "part": "summary", "seconds": out["seconds"]})
    return out


APPS_SCANS, APPS_STEP_M, APPS_DENSITY = 10, 0.3, 3
APPS_CLI = []  # extra CLI options: none, the CLI's defaults


def segsum_kernel_names() -> set:
    """The ``__global__`` functions of kernel #1's source, as a CUDA
    trace names them (``...::warp_kernel<float, true>(...)``)."""
    import re

    src = (ROOT / "madicp_tpu_torch/kernels/csrc/segsum_moments.cu").read_text()
    return set(re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)", src))


def trace_kernel_counts(trace: Path, names) -> dict:
    """How many kernel events of a chrome trace (torch.profiler's
    ``export_chrome_trace``) each name has. A regex over the text: the
    trace of a flagship run holds about a million events, too many to
    parse as JSON in the phase's time."""
    import re

    counts = dict.fromkeys(names, 0)
    text = trace.read_text()
    for m in re.finditer(r'"cat":\s*"kernel",\s*"name":\s*"([^"]*)"', text):
        for n in names:
            counts[n] += f"::{n}<" in m.group(1)
    return counts


def run_cli(argv) -> dict:
    """One run of the port's CLI ``main()``: its segment-sum launches
    (counted from 0), its per-scan read and odometry ms (parsed from its
    scan lines), its scans/s on the wall clock after the first scan (its
    last line: checkpoints and prints included), and the call's wall
    time."""
    import contextlib
    import io
    import re

    from madicp_tpu_torch.apps import cli

    out = io.StringIO()
    reset_launches()  # this run starts here
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cli.main([str(a) for a in argv])
    seconds = time.perf_counter() - t0
    counts = launches()  # read right after the run
    check(rc == 0, f"cli {argv} returned {rc}:\n{out.getvalue()[-2000:]}")
    scans = [(float(r), float(o)) for r, o in re.findall(
        r"^scan +\d+ +read +([\d.]+) ms +odometry +([\d.]+) ms", out.getvalue(), re.M)]
    check(counts["segsum_moments"] > 0, f"cli {argv}: no segment-sum launch")
    check_launched(counts, f"cli {argv}")
    rate = re.search(r"^(\d+) scans after the first in ([\d.]+) s: ([\d.]+) scans/s$",
                     out.getvalue(), re.M)
    check(rate is not None and int(rate.group(1)) == len(scans) - 1,
          f"cli {argv}: no rate line for its {len(scans)} scans")
    # the first scan of a run bootstraps (or resumes) and warms up
    steady = scans[1:]
    return {"scans": len(scans), "seconds": seconds,
            "segsum_launches": counts["segsum_moments"], "launches": counts,
            "odometry_ms": [o for _, o in scans],
            "read_ms_median": float(np.median([r for r, _ in steady])),
            "odometry_ms_median": float(np.median([o for _, o in steady])),
            "scans_per_s": float(rate.group(3)),
            "wall_s_after_first": float(rate.group(2))}


def phase_apps(torch, nvidia_smi: str) -> dict:
    """The CLI, the checkpoint, the evaluator, the demos and the native
    loader on the card, at the CLI's defaults (131072 points, depth 16,
    4 keyframes, float32, certified exact)."""
    import dataclasses
    import shutil
    import tempfile

    from madicp_tpu_torch.apps import evaluate, mad_registration, nn_search
    from madicp_tpu_torch.native import loader
    from madicp_tpu_torch.utils.checkpoint import checkpoint_path, load_pipeline, save_pipeline
    from madicp_tpu_torch.utils.config import DATASET_CONFIGS, dump_yaml
    from madicp_tpu_torch.utils.device import synchronize
    from madicp_tpu_torch.utils.fixtures import generate_four_walls_pointcloud
    from madicp_tpu_torch.utils.kitti import read_bin_numpy
    from madicp_tpu_torch.utils.trajectory import load_kitti_poses, save_kitti_poses

    t_phase = time.perf_counter()
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_apps_"))
    try:
        # a KITTI .bin sequence of the two-orientation world, 0.3 m a scan
        world = two_way_world(np.random.default_rng(11), density=APPS_DENSITY)
        data = work / "data"
        data.mkdir()
        gt = []
        for k in range(APPS_SCANS):
            p = world - np.array([APPS_STEP_M * k, 0.0, 0.0])
            rec = np.concatenate([p, np.ones((len(p), 1))], axis=1).astype(np.float32)
            rec.tofile(data / f"{k:06d}.bin")
            T = np.eye(4)
            T[0, 3] = APPS_STEP_M * k
            gt.append(T)
        save_kitti_poses(work / "gt.txt", gt)
        cfg = work / "dataset.yaml"  # identity extrinsics, no correction
        dump_yaml(dataclasses.replace(DATASET_CONFIGS["vbr_os0"], min_range=1.0,
                                      max_range=80.0), cfg)
        base = ["--dataset-config", cfg, "--noviz", "--device", DEV, *APPS_CLI]

        # 6. the native loader (the CLI's reader uses it)
        check(loader.available(), "native loader did not build")
        for f in sorted(data.glob("*.bin")):
            for corr in (False, True):
                got = loader.read_bin(f, 1.0, 80.0, apply_correction=corr)
                want = read_bin_numpy(f, np.float32, 1.0, 80.0, corr)
                check(got.shape == want.shape and np.array_equal(got, want),
                      f"native loader differs from numpy on {f.name} (correction {corr})")
        points_a_scan = len(loader.read_bin(data / "000000.bin", 1.0, 80.0))

        # 1. uninterrupted, profiled
        out1, prof = work / "out1", work / "prof"
        runs = {"profiled": run_cli(["--data-path", data, "--estimate-path", out1,
                                     "--profile", prof, *base])}
        trace = prof / "trace.json"
        check(trace.exists(), "--profile wrote no trace.json")
        in_trace = trace_kernel_counts(trace, segsum_kernel_names())
        trace_mb = trace.stat().st_size / 1e6
        trace.unlink()
        accumulating = sum(v for k, v in in_trace.items() if k != "round_kernel")
        check(accumulating == runs["profiled"]["segsum_launches"],
              f"the trace has {in_trace} segsum_moments kernels for "
              f"{runs['profiled']['segsum_launches']} launches")
        est1 = load_kitti_poses(out1 / "estimate.txt")
        check(est1.shape == (APPS_SCANS, 4, 4), f"estimate has shape {est1.shape}")

        # 2. checkpoint every 4 scans, stop after 6, resume
        out2 = work / "out2"
        runs["checkpointed"] = run_cli(["--data-path", data, "--estimate-path", out2,
                                        "--checkpoint-every", 4, "--max-scans", 6, *base])
        ckpt = checkpoint_path(out2)
        check(ckpt.exists(), "--checkpoint-every wrote no checkpoint")
        ckpt_gb = ckpt.stat().st_size / 1e9
        runs["resumed"] = run_cli(["--data-path", data, "--estimate-path", out2,
                                   "--resume", *base])
        est2 = load_kitti_poses(out2 / "estimate.txt")
        check(est2.shape == est1.shape, f"resumed estimate has shape {est2.shape}")
        resume_dev = float(np.abs(est2 - est1).max())
        check(resume_dev <= 1e-6, f"resumed run is {resume_dev:.2e} m from the uninterrupted one")

        # the checkpoint's cost: a synchronous snapshot, a background write
        pipe = load_pipeline(ckpt, device=DEV)
        check(pipe.current_id() == 4, f"checkpoint at scan {pipe.current_id()}, want 4")
        synchronize(pipe.device)
        t0 = time.perf_counter()
        writer = save_pipeline(work / "again.npz", pipe, background=True)
        snapshot_ms = (time.perf_counter() - t0) * 1e3
        writer.join()
        write_s = time.perf_counter() - t0 - snapshot_ms / 1e3
        del pipe
        ckpt.unlink()
        (work / "again.npz").unlink()

        # 3. evaluate the uninterrupted run against the ground truth
        metrics = evaluate.evaluate(out1 / "estimate.txt", work / "gt.txt",
                                    lengths=[0.6, 1.2])
        per_scan = np.linalg.norm(est1[:, :3, 3] - np.stack(gt)[:, :3, 3], axis=1)
        check(per_scan.max() <= 0.01, f"per-scan error {per_scan.max() * 1e3:.2f} mm > 10 mm")
        check(metrics["ate_rmse_m"] <= 0.01, f"ATE {metrics['ate_rmse_m']:.4f} m > 1 cm")

        # 4.-5. the demos
        demos = {}
        reset_launches()
        nn_err = nn_search.main(device=DEV)
        demos["nn_search"] = {"launches": launches()}
        np.random.seed(42)  # the demo's cloud, rounded as its float32 tree holds it
        cloud = generate_four_walls_pointcloud(points_per_wall=2000)
        rounding = float(np.sum(np.linalg.norm(
            cloud.astype(np.float32).astype(np.float64) - cloud, axis=1)))
        demos["nn_search"].update(error=nn_err, float32_rounding=rounding)
        check(nn_err == rounding, f"nn_search: error {nn_err} is not the cloud's "
              f"float32 rounding {rounding}: a query matched another point")
        reset_launches()
        T = mad_registration.main(device=DEV)
        demos["mad_registration"] = {"launches": launches(),
                                     "max_abs_dev_from_identity": float(np.abs(T - np.eye(4)).max())}
        check(np.allclose(T, np.eye(4), atol=5e-3), f"mad_registration: {T}")
        for name, d in demos.items():
            check(d["launches"]["segsum_moments"] > 0, f"{name}: no segment-sum launch")
        check(demos["nn_search"]["launches"]["descend"] > 0, "nn_search: no descent launch")
        check_launched(demos["mad_registration"]["launches"], "mad_registration")
    finally:
        shutil.rmtree(work, ignore_errors=True)

    out = {"phase": "apps", "nvidia_smi": nvidia_smi,
           "config": {"cli_options": [str(a) for a in APPS_CLI] or "defaults: "
                      "131072 points, depth 16, 4 keyframes, float32, certified exact",
                      "scans": APPS_SCANS, "points_a_scan": points_a_scan},
           "runs": runs,
           "trace": {"mb": trace_mb, "segsum_kernels": in_trace},
           "resume": {"max_abs_dev_m": resume_dev, "bitwise": resume_dev == 0.0,
                      "bound_m": 1e-6},
           "checkpoint": {"gb": ckpt_gb, "snapshot_ms": snapshot_ms,
                          "background_write_s": write_s},
           "evaluate": {**metrics, "max_per_scan_err_m": float(per_scan.max()),
                        "bound_m": 0.01},
           "demos": demos, "native_loader": "bitwise equal to numpy",
           "seconds": time.perf_counter() - t_phase}
    emit(out)
    return out


# the fleet phase: flagship widths, certified exact, float32
FLEET_BATCHES = (1, 2, 4)
# warm: the bootstrap, the warm-up, the capture and first replay
FLEET_SCANS, FLEET_WARM, FLEET_PROFILED = 13, 3, 2
FLEET_SPEEDS = (0.3, 0.2, 0.25, 0.15)  # m a scan along x: every timed sequence moves
FLEET_MIXED = dict(speeds=(0.3, 0.0), scans=4)  # a moving and a parked sequence
FLEET_P_TH = 0.999  # parked sequences match ~every leaf; moving ones do not
FLEET_BOUND_M = 5e-4  # certified f32 divergence bound (tests/test_pipeline.py:368)
FLEET_MP = dict(n_points=65536, depth=14, keyframes=2, scans=4)  # two-process check


def fleet_world(rng, density: int = 1):
    """The walls of two_way_world (their positions) and a sampler of its
    points: each call draws a fresh set on the same surfaces."""
    ys = [-35 + 10 * i + rng.uniform(-2, 2) for i in range(8)]
    xs = [-35 + 10 * i + rng.uniform(-2, 2) for i in range(8)]

    def sample(r):
        pts = [r.uniform([-40, -40, -0.05], [40, 40, 0.05], (12000 * density, 3))]
        pts += [r.uniform([-40, y - 0.03, 0], [40, y + 0.03, 6], (1800 * density, 3))
                for y in ys]
        pts += [r.uniform([x - 0.03, -40, 0], [x + 0.03, 40, 6], (1800 * density, 3))
                for x in xs]
        return np.concatenate(pts)

    return sample


def fleet_sequences(speeds, n_scans: int, density: int = 3):
    """Scans of one sequence a speed on one two-orientation world, 1-80
    m: sequence b starts 1.5 b m off in y, moves ``speeds[b]`` m a scan
    and draws from a generator of its own (so sequence b is the same in
    every call). A moving sequence draws a fresh sample of the surfaces
    each scan, so some of its leaves miss every keyframe and its inlier
    ratio stays below FLEET_P_TH (it promotes); a parked one (speed 0)
    sees one fixed point set, every leaf matches itself and it never
    promotes after the first scan."""
    sample = fleet_world(np.random.default_rng(21), density)
    seqs = []
    for b, speed in enumerate(speeds):
        rng = np.random.default_rng((21, b))
        fixed = None if speed else sample(rng)
        scans = []
        for k in range(n_scans):
            p = (sample(rng) if speed else fixed) - [speed * k, 1.5 * b, 0.0]
            r = np.linalg.norm(p, axis=1)
            scans.append(p[(r > 1.0) & (r < 80.0)].astype(np.float32))
        seqs.append(scans)
    return seqs


def single_pipeline_poses(scans):
    """One single Pipeline over ``scans``: (S, 4, 4) float64 poses and
    whether each scan promoted."""
    pipe = pipeline(num_keyframes=KEYFRAMES, n_points=N_POINTS, depth=DEPTH,
                    max_leaves=MAX_LEAVES, p_th=FLEET_P_TH)
    poses, promoted = [], []
    for k, scan in enumerate(scans):
        pipe.compute(0.1 * k, scan)
        poses.append(pipe.current_pose().astype(np.float64))
        promoted.append(pipe.is_map_updated())
    return np.stack(poses), promoted


def fleet_batch(seqs, k: int, n_points: int):
    """Scan k of every sequence, padded: (B, N, 3) float32, (B, N) bool."""
    pts = np.zeros((len(seqs), n_points, 3), np.float32)
    val = np.zeros((len(seqs), n_points), bool)
    for b, scans in enumerate(seqs):
        n = min(len(scans[k]), n_points)
        pts[b, :n], val[b, :n] = scans[k][:n], True
    return pts, val


def fleet_config(torch, **kw):
    from madicp_tpu_torch.models.pipeline import PipelineConfig

    base = dict(num_keyframes=KEYFRAMES, n_points=N_POINTS, depth=DEPTH,
                max_leaves=MAX_LEAVES, p_th=FLEET_P_TH, dtype=torch.float32)
    base.update(kw)
    return PipelineConfig(**base)


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def phase_fleet(torch, nvidia_smi: str) -> dict:
    """The batched fleet (parallel/fleet.py) on the card: (a) B = 1, 2, 4
    at flagship widths, every sequence moving, graphed, against one
    single Pipeline per sequence and an eager twin, with the scans/s,
    device busy and kernels a batched scan of both, then a moving and a
    parked sequence as one batch (the masked promotion differs across
    them); (b) segsum_moments
    against its float64 plain version at every level of a B = 4 build;
    (d) a fleet on a one-rank NCCL mesh (the keyframe all-reduce issued
    for real); (c) fleet_eval on two ranks sharing the card (gloo), kf
    split, with and without the points split, against one process."""
    import os
    import subprocess
    import tempfile

    from madicp_tpu_torch.kernels import segsum
    from madicp_tpu_torch.models.step_graph import step_in_place
    from madicp_tpu_torch.parallel import Fleet, distributed, make_mesh
    from madicp_tpu_torch.parallel.sharded_icp import counter
    from madicp_tpu_torch.probes.segsum_levels import capture_levels

    t_phase = time.perf_counter()
    B_max = max(FLEET_BATCHES)
    seqs = fleet_sequences(FLEET_SPEEDS[:B_max], FLEET_SCANS)
    batches = [fleet_batch(seqs, k, N_POINTS) for k in range(FLEET_SCANS)]

    # the reference: one single Pipeline per sequence
    want, want_promoted = zip(*(single_pipeline_poses(scans) for scans in seqs))
    torch.cuda.empty_cache()

    # (a) the fleet at B = 1, 2, 4, graphed, beside an eager twin that runs
    # the captured body on the same scans
    cfg = fleet_config(torch)
    runs = {}
    n_timed = FLEET_SCANS - FLEET_WARM - FLEET_PROFILED
    timed = range(FLEET_WARM, FLEET_WARM + n_timed)
    profiled = range(FLEET_WARM + n_timed, FLEET_SCANS)
    for B in FLEET_BATCHES:
        staged = [tuple(torch.as_tensor(a[:B], device=DEV) for a in batch)
                  for batch in batches]
        fleet, twin = Fleet(cfg, B, device=DEV), Fleet(cfg, B, device=DEV)
        poses, promoted, twin_poses = [], [], []

        def step(k):
            out = fleet.compute(None, *staged[k])
            poses.append(out.pose)
            promoted.append(out.map_updated)

        def step_eager(k):
            twin_poses.append(step_in_place(cfg, twin.states, *staged[k]).pose)

        twin.compute(None, *staged[0])
        for k in range(FLEET_WARM):
            step(k)
            if k:
                step_eager(k)
        side = {}
        for name, fn in (("graphed", step), ("eager", step_eager)):
            reset_launches()  # this timed run starts here
            _, wall = enqueue_run(fn, timed)
            counts = launches()  # read right after the run
            prof = profile_window(lambda fn=fn: [fn(k) for k in profiled], FLEET_PROFILED)
            side[name] = {"fleet_scans_per_s": B * n_timed / wall,
                          "ms_per_batched_scan": wall * 1e3 / n_timed,
                          "segsum_launches": counts["segsum_moments"],
                          "launches": counts,
                          "device_busy_ms_per_batched_scan": prof["device_busy_ms_per_scan"],
                          "device_busy_share": prof["device_busy_share"],
                          "kernels_per_batched_scan": prof["kernels_per_scan"],
                          "wall_ms_per_profiled_scan": prof["wall_ms_per_scan"]}
        got = torch.stack(poses).cpu().numpy().astype(np.float64)  # (S, B, 4, 4)
        got_promoted = torch.stack(promoted).cpu().numpy()  # (S, B)
        dev_m = float(max(np.abs(got[:, b] - want[b]).max() for b in range(B)))
        twin_dev = float(np.abs(got[1:] - torch.stack(twin_poses).cpu().numpy()).max())
        mixed = [k for k in range(FLEET_SCANS) if 0 < got_promoted[k].sum() < B]
        (capture_ms, nodes, _), = fleet._graphs.captured().values()
        runs[B] = {
            "sequences": B, "scans_timed": n_timed, **side["graphed"],
            "batched_scans_per_s": side["graphed"]["fleet_scans_per_s"] / B,
            "eager": side["eager"],
            "capture_ms": capture_ms, "nodes": nodes,
            "pool_bytes": fleet._graphs.pool_bytes(),
            "max_dev_from_eager_m": twin_dev,
            "max_dev_from_pipeline_m": dev_m,
            "promoted": got_promoted.astype(int).tolist(),
            "mixed_promotion_scans": mixed,
            "pipeline_promoted": [want_promoted[b] for b in range(B)],
        }
        emit({"phase": "fleet", "part": f"B={B}", **runs[B]})
        check(np.isfinite(got).all(), f"B={B}: non-finite poses")
        check(dev_m <= FLEET_BOUND_M,
              f"B={B}: fleet is {dev_m:.2e} m from the single Pipeline")
        check(twin_dev <= FLEET_BOUND_M, f"B={B}: graphed fleet {twin_dev:.2e} m from eager")
        for name in side:
            check(side[name]["segsum_launches"] == n_timed * (DEPTH + 1),
                  f"B={B} {name}: segsum launched {side[name]['segsum_launches']} times "
                  f"in {n_timed} batched scans")
            check_launched(side[name]["launches"], f"B={B} {name}")
        del fleet, twin, staged
        torch.cuda.empty_cache()

    # (a) the masked promotion: sequence 0 above beside a parked one
    n_mixed = FLEET_MIXED["scans"]
    mixed_seqs = fleet_sequences(FLEET_MIXED["speeds"], n_mixed)
    mixed_want = [want[0][:n_mixed], single_pipeline_poses(mixed_seqs[1])[0]]
    fleet = Fleet(cfg, 2, device=DEV)
    poses, promoted = [], []
    for k in range(n_mixed):
        staged = (torch.as_tensor(a, device=DEV) for a in fleet_batch(mixed_seqs, k, N_POINTS))
        promoted.append(fleet.compute(None, *staged).map_updated)
        poses.append(fleet.states.X.clone())
    got = torch.stack(poses).cpu().numpy().astype(np.float64)
    got_promoted = torch.stack(promoted).cpu().numpy()
    mixed_dev = float(max(np.abs(got[:, b] - mixed_want[b]).max() for b in range(2)))
    mixed = [k for k in range(n_mixed) if 0 < got_promoted[k].sum() < 2]
    runs["moving+parked"] = {"speeds_m": FLEET_MIXED["speeds"], "scans": n_mixed,
                             "promoted": got_promoted.astype(int).tolist(),
                             "mixed_promotion_scans": mixed,
                             "max_dev_from_pipeline_m": mixed_dev}
    emit({"phase": "fleet", "part": "moving+parked", **runs["moving+parked"]})
    check(np.isfinite(got).all(), "moving+parked: non-finite poses")
    check(mixed_dev <= FLEET_BOUND_M,
          f"moving+parked: fleet is {mixed_dev:.2e} m from the single Pipelines")
    check(mixed, "moving+parked: no step promoted in one sequence and not the other")
    del fleet
    torch.cuda.empty_cache()

    # (b) segsum_moments at the fleet's sizes: every level of a B = 4 build
    pts, val = (torch.as_tensor(a, device=DEV) for a in batches[1])
    levels = capture_levels(pts, val, DEPTH)
    check(len(levels) == DEPTH + 1, f"B=4 build: {len(levels)} levels")
    rows, seg_err = [], 0.0
    for d, idx, sz in levels:
        got = segsum.segsum_moments(d, idx, sz)
        ref = segsum.segsum_moments_ref(d.double(), idx, sz)
        torch.testing.assert_close(got.double(), ref, rtol=1e-5, atol=5e-3,
                                   msg=lambda m, sz=sz: f"B=4 level sz={sz}: {m}")
        err = float((got.double() - ref).abs().max())
        seg_err = max(seg_err, err)
        rows.append({"sz": sz, "n": d.shape[0], "max_abs_err": err,
                     "path": segsum.plan(d.shape[0], sz, segsum.sm_count(d.device)).path})
    del levels, pts, val

    # (d) a one-rank NCCL group: the keyframe hook's all-reduces issue on it
    small = fleet_config(torch, num_keyframes=4)
    distributed.initialize(f"localhost:{free_port()}", 1, 0, backend="nccl", device=DEV)
    try:
        backend = torch.distributed.get_backend()
        sharded = Fleet(small, 2, mesh=make_mesh(kf=1, seq=1), device=DEV)
        plain = Fleet(small, 2, device=DEV)
        before = counter.all_reduces
        for k in range(3):
            batch = tuple(torch.as_tensor(a[:2], device=DEV) for a in batches[k])
            sharded.compute(None, *batch)
            plain.compute(None, *batch)
        nccl_reduces = counter.all_reduces - before
        nccl_dev = float(np.abs(sharded.poses() - plain.poses()).max())
        del sharded, plain
    finally:
        distributed.shutdown()
    check(backend == "nccl", f"one-rank group backend {backend}")
    check(nccl_reduces == 2 * (15 + 2), f"{nccl_reduces} all-reduces in 2 odometry scans")
    check(nccl_dev <= FLEET_BOUND_M, f"NCCL-mesh fleet {nccl_dev:.2e} m from no mesh")
    torch.cuda.empty_cache()

    # (c) fleet_eval on two ranks sharing the card: collective plumbing only
    import dataclasses
    import shutil

    from madicp_tpu_torch.apps import fleet_eval
    from madicp_tpu_torch.utils.config import DATASET_CONFIGS, MADParams, dump_yaml
    from madicp_tpu_torch.utils.trajectory import load_kitti_poses

    work = Path(tempfile.mkdtemp(prefix="chip_smoke_fleet_"))
    try:
        data = work / "seq0"
        data.mkdir()
        for k, p in enumerate(fleet_sequences(FLEET_SPEEDS[:1], FLEET_MP["scans"],
                                              density=1)[0]):
            rec = np.concatenate([p, np.ones((len(p), 1), np.float32)], axis=1)
            rec.tofile(data / f"{k:06d}.bin")
        dump_yaml(dataclasses.replace(DATASET_CONFIGS["vbr_os0"], min_range=1.0,
                                      max_range=80.0), work / "dataset.yaml")
        dump_yaml(MADParams(p_th=FLEET_P_TH), work / "mad.yaml")
        base = ["--data-paths", str(data), "--dataset-config", str(work / "dataset.yaml"),
                "--mad-icp-params", str(work / "mad.yaml"),
                "--num-keyframes", str(FLEET_MP["keyframes"]),
                "--n-points", str(FLEET_MP["n_points"]), "--depth", str(FLEET_MP["depth"]),
                "--device", DEV, "--json"]
        check(fleet_eval.main(base + ["--estimate-path", str(work / "one")]) == 0,
              "fleet_eval on one process failed")
        one = load_kitti_poses(work / "one" / "seq0" / "estimate.txt")
        # both launches at once (four processes on the card): each pays
        # its processes' start-up, which the other overlaps
        variants = {"kf": [], "kf+points": ["--shard-points"]}
        t0 = time.perf_counter()
        procs = {name: subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc-per-node", "2", "-m", "madicp_tpu_torch.apps.fleet_eval",
             *base, "--estimate-path", str(work / name), "--seq-axis", "1",
             "--kf-axis", "2", *extra],
            cwd=ROOT, env=dict(os.environ, OMP_NUM_THREADS="1"), text=True,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE) for name, extra in variants.items()}
        two = {}
        try:
            for name, proc in procs.items():
                stdout, stderr = proc.communicate(timeout=600)
                check(proc.returncode == 0, f"fleet_eval {name} on two ranks failed:\n"
                      f"{stdout[-2000:]}\n{stderr[-3000:]}")
                summary = json.loads(stdout.strip().splitlines()[-1])
                ranks = [load_kitti_poses(work / name / "seq0" / f)
                         for f in ("estimate.txt", "estimate.rank1.txt")]
                devs = [float(np.abs(r - one).max()) for r in ranks]
                two[name] = {"processes": summary["processes"],
                             "backend": summary["backend"],
                             "max_dev_from_one_process_m": devs}
                check(summary["backend"] == "gloo" and summary["processes"] == 2,
                      f"{name}: {summary['processes']} ranks on {summary['backend']}")
                check(max(devs) <= FLEET_BOUND_M, f"{name}: ranks {devs} m from one process")
        finally:
            for proc in procs.values():  # torchrun passes SIGTERM to its ranks
                if proc.poll() is None:
                    proc.terminate()
                    try:
                        proc.wait(timeout=30)
                    except subprocess.TimeoutExpired:
                        proc.kill()
                        proc.wait()
        two["seconds_both"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(work, ignore_errors=True)

    out = {"phase": "fleet", "nvidia_smi": nvidia_smi,
           "config": {"n_points": N_POINTS, "depth": DEPTH, "keyframes": KEYFRAMES,
                      "max_leaves": MAX_LEAVES, "rounds": 15, "dtype": "float32",
                      "schedule": "certified exact", "p_th": FLEET_P_TH,
                      "scans": FLEET_SCANS, "speeds_m": FLEET_SPEEDS},
           "batches": runs,
           "segsum_b4_build": {"levels": rows, "max_abs_err": seg_err,
                               "max_sz": max(r["sz"] for r in rows)},
           "nccl_one_rank": {"all_reduces": nccl_reduces, "max_dev_m": nccl_dev},
           "two_ranks_one_card": dict(two, config=FLEET_MP,
                                      note="checks plumbing; times nothing"),
           "bound_m": FLEET_BOUND_M, "seconds": time.perf_counter() - t_phase}
    emit(out)
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import madicp_tpu_torch  # noqa: F401  (fails outside a checkout)

    t_start = time.perf_counter()
    dev = phase_device(torch)
    phase_build()
    ksum = phase_kernels(torch)
    assoc = phase_assoc(torch, dev["nvidia_smi"])
    tree = phase_tree(torch, dev["nvidia_smi"])
    probe = phase_probe(torch)
    phase_precision(torch)
    phase_golden(torch)
    phase_accuracy(torch)
    steady = phase_steady(torch)
    phase_schedules(torch)
    phase_graphs(torch, dev["nvidia_smi"])
    phase_apps(torch, dev["nvidia_smi"])
    phase_fleet(torch, dev["nvidia_smi"])

    f32 = ksum["float32"]
    rows = [{
        "name": "segsum_moments",
        "route": "cuda",
        "source": "madicp_tpu_torch/kernels/csrc/segsum_moments.cu",
        "replaces": "madicp_tpu/ops/tree.py:279",
        "launches": steady["segsum_launches"],
        "max_abs_err": f32["max_abs_err"],
        "ms": f32["ms"],
        "device_ms": f32["device_ms"],
        "plain_ms": f32["plain_ms"],
        "bound_ms": f32["bound_ms"],
        "bound_by": "bytes" if f32["bound_by"] == "bytes" else "operations",
        "library_ms": f32["library_ms"],
        "library_device_ms": f32["library_device_ms"],
    }]
    for name, replaces in BUILD_REPLACES.items():
        k = tree["timing"]["float32"]["kernels"][name]
        rows.append({
            "name": name, "route": "cuda",
            "source": f"madicp_tpu_torch/kernels/csrc/{name}.cu",
            "replaces": replaces, "launches": steady["launches"][name],
            **{key: k[key] for key in ("max_abs_err", "ms", "device_ms", "plain_ms",
                                       "bound_ms", "bound_by")},
            "library_ms": None, "library_device_ms": None,
        })
    for name, replaces in ASSOC_REPLACES.items():
        k = assoc[name]["float32"]
        if name == "descend":
            k = k["round0"]
        rows.append({
            "name": name, "route": "cuda",
            "source": f"madicp_tpu_torch/kernels/csrc/{ASSOC_SOURCES[name]}.cu",
            "replaces": replaces, "launches": steady["launches"][name],
            **{key: k[key] for key in ("max_abs_err", "ms", "device_ms", "plain_ms",
                                       "bound_ms", "bound_by", "library_ms")},
            "library_device_ms": None,
        })
    for name, replaces in PROBE_KERNELS.items():
        k = probe[name]
        rows.append({
            "name": name, "route": "cuda",
            "source": "madicp_tpu_torch/kernels/csrc/scatter_probe.cu",
            "replaces": replaces, "launches": k["launches"],
            "max_abs_err": k["max_abs_err"], "ms": k["ms"],
            "device_ms": k["device_ms"], "plain_ms": k["plain_ms"],
            "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
            "library_ms": k["library_ms"],
            "library_device_ms": k["library_device_ms"],
        })
    emit({"kernels": rows})
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(dev["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": dev["name"],
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
