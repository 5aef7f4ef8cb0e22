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
              it reads (the bound's bytes), each in the flat form and in
              the ring form the step launches (one query operand for the
              16 trees; the later round merged into round 0's results in
              place), and the step's merged certified re-association
              round, kernel by kernel from torch.profiler; the terms'
              matched bit for bit
              and H, b within 1e-5 (1e-12 in float64) relative of a float64
              sum of the plain version's per-entry terms; eager, graphed
              and plain ms and bounds; the kernels of one call by name,
              from torch.profiler (one terms_kernel a call). Then
              the certified flagship drive,
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
              each kernel and of a whole build, with the bound; every K8
              call of the bench-scan build (level, path, nseg, live
              points, distinct (warp, node) pairs, bound µs and device µs
              in a CUDA graph, the times that sum to K8's) and every K9
              call (level, nodes, blocks, node kernel, bound µs, device
              µs in a CUDA graph). Then the
              certified flagship drive, graphed, with the build kernels
              and with the build routed to its plain versions (a patch of
              this script): scans/s, device busy and kernels a scan of
              each, the two-orientation world's drive both ways within
              5e-4 m;
3d. gn        gn_update (K10) and certify_slack (K11), the GN update and
              the certified rounds' slack pass, against their plain
              PyTorch versions on the card, float32 and float64: the test
              cases (madicp_tpu_torch/probes/gn_cases.py: an infinite
              H_ii among them, per-keyframe terms, K11 on a ragged tile
              and keyframe group) and every call of a certified flagship
              scan (15 updates on the per-keyframe terms, 14 slack
              passes; B = 1 and four stacked), K10 within 5e-6 relative
              (1e-12 in float64) and its keyframe sums within the bound
              of two summation orders, K11's need, slack and count bit
              for bit; eager, graphed and plain ms and the bound at B = 1
              and 4, with torch.linalg.solve_ex beside K10 and each
              call's kernels.
              Then the certified flagship drive, graphed, with the kernels
              and with both on their plain versions (plain_gn, a patch of
              this script): scans/s, device busy and kernels a scan of
              each, poses within 5e-4 m (y and z on the bench's world, the
              two-orientation world whole);
3e. deskew    the deskew sweep (K12), the step's deskew with its bin
              motions, against its plain PyTorch version on the card at
              flagship shapes (131072 points, 65,536 of an OS1-64 sweep
              valid, B = 1 and 4, one sequence of four with do False),
              float32 and float64, both modes, each sweep in draw order
              and in column (capture-time) order, on the poses of a
              turning, a straight and a resting sensor: bins and cloud
              bit for bit; on the turning poses eager, graphed and plain
              ms, the deskew call's (the reference mode's sort included,
              its kernels counted) and the bound. Then the deskewed main path on
              sweeps of a sensor moving at 3 m/s and 0.2 rad/s through the
              two-orientation world (madicp_tpu_torch/probes/deskew_drive.py),
              the certified flagship graphed at the rate and range of
              mulran (10 Hz, 0.7-120 m; both modes) and vbr_os1 (20 Hz,
              1.3-120 m): graphed against an eager twin bit for bit, with
              K12 on its plain version (plain_deskew, a patch of this
              script) and in float64 within 5e-4 m, deskew on closer to
              the truth than off once the naive velocity has settled,
              scans/s, device busy and kernels a scan, one K12 launch a
              scan; the CLI at its defaults with --dataset-config mulran
              on KITTI .bin files of such a drive (from rest), deskew on
              closer to the truth than off, its rate and K12's launches;
              the fleet at B = 4 with deskew on, graphed, every sequence
              within 5e-4 m of its single Pipeline; one deskewed step of a
              captured configuration under set_sync_debug_mode("error");
3f. tail      step_scalars (K14: the constant-velocity prediction and the
              step's tail: inlier ratio, velocity estimate, -log det, the
              frame window and the promotion's bookkeeping) and ring_write
              (K13: the frame record and the promotion's tree copy)
              against their plain PyTorch versions on the card bit for
              bit, on the inputs of a recorded certified flagship step,
              float32 and float64, B = 1 and 4, with no sequence
              promoting, every one promoting an older window frame and
              every one promoting its own scan; the tail with fresh
              outputs and in place (the state its own destination, as
              the step calls it: every destination kept), both routes;
              eager, graphed and plain ms and the bound of each, and the
              tail's graphed ms in place and with fresh outputs, in
              turns. Then
              the certified flagship drive, graphed, with the kernels,
              with all three on their plain versions (plain_tail) and
              with the state copied after the step as before the tail
              wrote it in place (state_copies; both patches of this
              script): scans/s, device busy and kernels a scan, two
              step_scalars and one ring_write launch a scan, the poses
              (equal bit for bit), the graph's nodes (14 fewer than with
              the copies) and the state's buffers kept across the steps;
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
              within 1% of eager's plus the replay's 10 copies (the
              scan in, the output's 8 tensors out); then a realtime
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

Then the line {"kernels": [...]} (all fourteen kernels: segsum_moments,
build_nodes and build_points per flagship build, descend at a certified
round 0 and icp_terms on its payload, gn_update and certify_slack on a
certified flagship scan's round, each with its launches in the
steady phase's main-path run; deskew_sweep on one flagship sweep in the
reference mode, with its launches in the MulRan drive's timed run;
step_scalars (predict and tail summed) and ring_write on a recorded
flagship step that does not promote, with their launches in the steady
phase's run; the probe kernels summed over one probe pass with the
probe's launches), the
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
build_points, descend, icp_terms, gn_update, step_scalars or ring_write
(and certify_slack on the certified and compact schedules) was never
launched; a scan launches
gn_update once a GN round (15) and certify_slack once a later round of
the certified rounds (14). The realtime
scenario of phase 8b derives its sensor rate from the graphed certified
step's measured time, so that its budget is overrun.
"""

from __future__ import annotations

import json
import re
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
GN_KERNELS = ("gn_update", "certify_slack")  # the GN update and the certified slack pass
TAIL_KERNELS = ("step_scalars", "ring_write")  # the prediction and tail's scalars, the rings
# a registration's (MADicp: no odometry step, so no tail)
REGISTRATION_KERNELS = BUILD_KERNELS + ASSOC_KERNELS + ("gn_update",)
STEP_KERNELS = REGISTRATION_KERNELS + TAIL_KERNELS  # every schedule's step
ROUNDS = 15  # GN rounds a scan: one gn_update each, a certify_slack each after the first
GEMM_NAME = re.compile(r"(gemm|gemv|Gemm|Gemv|xmma|cutlass)")  # a library GEMM's kernels


def certifies(spec: str) -> bool:
    """Whether the bench schedule ``spec`` runs the certified rounds' slack
    pass (certified and compact; prefix keeps its own)."""
    return spec.split(":")[0] in ("certified", "compact")


def kernel_names() -> dict:
    """{kernel: its __global__ functions, as a CUDA trace names them}."""
    from madicp_tpu_torch.kernels import (
        build_nodes,
        build_points,
        certify_slack,
        deskew,
        descent,
        gn_update,
        icp_terms,
    )

    from madicp_tpu_torch.kernels import ring_write, step_scalars

    return {"descend": descent.KERNEL_NAMES, "icp_terms": icp_terms.KERNEL_NAMES,
            "build_nodes": build_nodes.KERNEL_NAMES, "build_points": build_points.KERNEL_NAMES,
            "gn_update": gn_update.KERNEL_NAMES, "certify_slack": certify_slack.KERNEL_NAMES,
            "deskew_sweep": deskew.KERNEL_NAMES, "step_scalars": step_scalars.KERNEL_NAMES,
            "ring_write": ring_write.KERNEL_NAMES}


def reset_launches() -> None:
    """Set the launch counter of every kernel of the step to 0."""
    from madicp_tpu_torch.models.step_graph import COUNTERS

    for c in COUNTERS.values():
        c.launches = 0


def launches() -> dict:
    """{kernel name: launches since its counter was reset} of the step's
    kernels (models/step_graph.py COUNTERS)."""
    from madicp_tpu_torch.models.step_graph import COUNTERS

    return {name: c.launches for name, c in COUNTERS.items()}


def check_launched(counts: dict, what: str, kernels=STEP_KERNELS,
                   certified: bool = False) -> None:
    """Fail where a kernel of ``kernels`` (and ``certify_slack`` on a
    ``certified`` run) was never launched."""
    for name in kernels + (("certify_slack",) if certified else ()):
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
    points times ``density`` (utils/fixtures.py)."""
    from madicp_tpu_torch.utils.fixtures import two_orientation_world

    return two_orientation_world(rng, density)


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
        real = descent.descend, descent.descend_ring, icp_terms.terms
        descent.descend, descent.descend_ring, icp_terms.terms = (
            descent.descend_plain, descent.descend_ring_plain, icp_terms.terms_plain)
        try:
            yield
        finally:
            descent.descend, descent.descend_ring, icp_terms.terms = real

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


def plain_gn():
    """A context in which the GN update and the certified slack pass take
    their plain versions on the card too (their counters stand still): the
    yardstick of the ``gn`` drive."""
    import contextlib

    from madicp_tpu_torch.kernels import certify_slack, gn_update

    @contextlib.contextmanager
    def patched():
        real = gn_update.gn_update, certify_slack.certify_slack
        gn_update.gn_update = gn_update.gn_update_plain
        certify_slack.certify_slack = certify_slack.certify_slack_plain
        try:
            yield
        finally:
            gn_update.gn_update, certify_slack.certify_slack = real

    return patched()


def plain_tail():
    """A context in which the step's prediction, tail and ring write take
    their plain versions on the card too (K13's and K14's counters stand
    still): the yardstick of the ``tail`` drive."""
    import contextlib

    from madicp_tpu_torch.kernels import ring_write, step_scalars

    @contextlib.contextmanager
    def patched():
        real = step_scalars.predict, step_scalars.tail, ring_write.ring_write
        step_scalars.predict = step_scalars.predict_plain
        step_scalars.tail = step_scalars.tail_plain
        ring_write.ring_write = ring_write.ring_write_plain
        try:
            yield
        finally:
            step_scalars.predict, step_scalars.tail, ring_write.ring_write = real

    return patched()


def state_copies():
    """A context in which the step forms the new state in fresh tensors
    and copies it into the state's buffers afterwards (``write_state``:
    14 copies a step), as it did before the tail wrote the state in
    place: the yardstick of the ``tail`` drive's graph nodes."""
    import contextlib

    from madicp_tpu_torch.models import step_graph
    from madicp_tpu_torch.models.pipeline import odometry_step

    def step_in_place(cfg, state, points, valid, stamps=None, **kw):
        new, out = odometry_step(cfg, state, points, valid, None, stamps, **kw)
        step_graph.write_state(state, new)
        return out

    @contextlib.contextmanager
    def patched():
        real = step_graph.step_in_place
        step_graph.step_in_place = step_in_place
        try:
            yield
        finally:
            step_graph.step_in_place = real

    return patched()


def route_context(route: str):
    """The context of a drive's route: the kernels, or the association and
    terms (``plain_association``), the build (``plain_build``), the GN
    update and slack pass (``plain_gn``) or the prediction, tail and ring
    write (``plain_tail``) on their plain versions, or the kernels with
    the state copied after the step (``state_copies``)."""
    import contextlib

    return {"kernels": contextlib.nullcontext, "plain_association": plain_association,
            "plain_build": plain_build, "plain_gn": plain_gn, "plain_tail": plain_tail,
            "state_copies": state_copies}[route]()


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
        ptrs = [getattr(t, "nav", t).data_ptr() for t in pipe._graphs.state]
        reset_launches()  # the timed run starts here
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(1 + n_warm, 1 + n_warm + n_timed):
            step(i)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launches()  # read right after it
        kept = ptrs == [getattr(t, "nav", t).data_ptr() for t in pipe._graphs.state]
        prof = profile_window(
            lambda: [step(i) for i in range(1 + n_warm + n_timed, 1 + total)], n_prof)
        (capture_ms, nodes, _), = pipe._graphs.captured().values()
    out = {"route": route, "scans_per_s": n_timed / wall,
           "launches_per_scan": {k: v / n_timed for k, v in counts.items()},
           "capture_ms": capture_ms, "nodes": nodes, "state_buffers_kept": kept, "profile": prof,
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
    from madicp_tpu_torch.probes import kernel_trace
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
        q = icp_terms.moving_in_map(lp, Xt).expand(K, L, 3).reshape(Q, 3)
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

        # the ring form the step launches (the scan-frame leaves (1, L, 3)
        # and the pose for the K trees, each query mapped in the kernel):
        # round 0, the fast schedule's warm start, and a later certified
        # round merged into round 0's results in place
        ring_nav = nav.view(K, M, 56)
        q1, X1 = lp[None], Xt[None]
        prev = descent.descend_ring_plain(ring_nav, q1, DEPTH, need, X=X1, return_margin=True)
        ring_cases = {"ring_round0": dict(need=need, return_margin=True),
                      "ring_warm": dict(need=need, start=prev[0] >> 6, n_gathers=3),
                      "ring_later_merged": dict(need=need & later, return_margin=True)}
        for case, kw in ring_cases.items():
            merged = case.endswith("merged")
            bufs = [tuple(t.clone() for t in prev) if merged else None for _ in range(3)]
            got = descent.descend_ring(ring_nav, q1, DEPTH, **kw, X=X1, out=bufs[0])
            want = descent.descend_ring_plain(ring_nav, q1, DEPTH, **kw, X=X1, out=bufs[1])
            for name, a, b in zip(("ids", "blocks", "margins"), got, want):
                check(a.dtype == b.dtype and torch.equal(a, b),
                      f"descend {dname} {case}: {name} differ from the plain version in "
                      f"{int((a != b).reshape(a.shape[0] * a.shape[1], -1).any(-1).sum())} "
                      "entries")
            cost = kernel_trace.ring_cost(ring_nav, q1, X1, DEPTH, kw["need"], kw.get("start"),
                                          kw.get("n_gathers"), kw.get("return_margin", False),
                                          merged)
            bound, by = bound_ms(cost["bytes"], cost["operations"], dname)
            call = lambda kw=kw, o=bufs[2]: descent.descend_ring(  # noqa: E731
                ring_nav, q1, DEPTH, **kw, X=X1, out=o)
            out["descend"][dname][case] = {
                "entries": Q, "live": int(kw["need"].sum()), **cost,
                "ms": event_ms(call, ASSOC_REPS), "device_ms": graph_ms(call, ASSOC_REPS),
                "plain_ms": event_ms(lambda kw=kw, o=bufs[2]: descent.descend_ring_plain(
                    ring_nav, q1, DEPTH, **kw, X=X1, out=o), ASSOC_REPS),
                "bound_ms": bound, "bound_by": by, "max_abs_err": 0.0, "library_ms": None,
                "trace": kernel_trace.launch_us(call)}
        # the step's certified re-association round, merged in place
        later_args = (nav, DEPTH, lp[None], Xt[None], (need & later)[None])
        bufs = tuple(t[None].clone() for t in prev)
        out["descend"][dname]["round"] = {"merged": kernel_trace.launch_us(
            lambda: kernel_trace.merged_round(*later_args, *bufs))}
        del ring_nav, q1, X1, prev, bufs, got, want

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
            "bound_ms": bound, "bound_by": by, "library_ms": None,
            "parts": kernel_trace.terms_trace(args, terms_kw)}
        parts = out["icp_terms"][dname]["parts"]
        check([p["kernel"].split("<")[0] for p in parts] == list(icp_terms.KERNEL_NAMES),
              f"icp_terms {dname}: a call ran {parts}, want one terms_kernel")
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
    check_launched(drives[0]["launches_per_scan"], "assoc drive", certified=True)
    check_launched(drives[1]["launches_per_scan"], "assoc plain drive",
                   BUILD_KERNELS + GN_KERNELS)
    for name in ASSOC_KERNELS:
        check(drives[1]["launches_per_scan"][name] == 0,
              f"assoc plain drive: {name} was launched")
    return out


# the tree build's kernels -> the JAX code each counterpart ports (XLA
# lowered there), and their sources
BUILD_REPLACES = {"build_nodes": "madicp_tpu/ops/tree.py:457",
                  "build_points": "madicp_tpu/ops/tree.py:492"}
TREE_REPS = 10  # calls a timing


def padded(scan, n: int):
    """A cloud padded (or cut) to ``n`` points: (n, 3) points, (n,) valid."""
    pts = np.zeros((n, 3))
    m = min(len(scan), n)
    pts[:m] = scan[:m]
    return pts, np.arange(n) < m


def time_build_calls(torch, calls, kernel: str, dname: str) -> dict:
    """A kernel's eager, graphed and plain ms and bound, summed over its
    recorded calls of one build, and each call's graphed µs
    (``device_us``, in order); each call on copies of its inputs (the
    in-place results are idempotent, so repeats redo the same work)."""
    from madicp_tpu_torch.probes import build_levels as bl
    from madicp_tpu_torch.utils.timing import bound_ms, event_ms, graph_ms

    esize = torch.finfo(getattr(torch, dname)).bits // 8
    tot = dict(ms=0.0, device_ms=0.0, plain_ms=0.0, bound_ms=0.0, bytes=0, operations=0,
               device_us=[])
    by = set()
    for c in calls:
        if c.name not in bl.KERNELS[kernel]:
            continue
        args = bl.copy_args(c.args)
        fn = getattr(bl._MODULE[c.name], c.name)
        call = lambda fn=fn, args=args, kw=c.kwargs: fn(*args, **kw)  # noqa: E731
        plain = lambda c=c, args=args: bl.PLAIN[c.name](*args, **c.kwargs)  # noqa: E731
        nbytes, ops = bl.call_cost(c, esize)
        bound, b = bound_ms(nbytes, ops, dname)
        by.add(b)
        tot["ms"] += event_ms(call, TREE_REPS)
        tot["device_us"].append(graph_ms(call, TREE_REPS) * 1e3)
        tot["device_ms"] += tot["device_us"][-1] / 1e3
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
    from madicp_tpu_torch.probes import build_levels, kernel_trace
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
                per_call = {}
                for k in BUILD_KERNELS:  # each call's level, bound and graphed µs
                    per_call[k] = kernel_trace.call_rows(calls, esize, k)
                    for call_row, us in zip(per_call[k], kernels[k]["device_us"]):
                        call_row["device_us"] = us
                out["timing"][dname] = {"kernels": {k: dict(v, max_abs_err=report[k]["max_abs_err"])
                                                    for k, v in kernels.items()},
                                        "build": whole, "k8_calls": per_call["build_points"],
                                        "k9_calls": per_call["build_nodes"]}
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
    check_launched(drives[0]["launches_per_scan"], "tree drive", certified=True)
    check_launched(drives[1]["launches_per_scan"], "tree plain drive",
                   ASSOC_KERNELS + GN_KERNELS)
    for name in BUILD_KERNELS:
        check(drives[1]["launches_per_scan"][name] == 0,
              f"tree plain drive: {name} was launched")
    return out


# the GN update's and the slack pass's kernels -> the JAX code each
# counterpart ports (XLA lowered there)
GN_REPLACES = {"gn_update": "madicp_tpu/ops/icp_core.py:256",
               "certify_slack": "madicp_tpu/models/pipeline.py:531"}
GN_REPS = 50  # calls a timing
GN_TOL = {"float32": 5e-6, "float64": 1e-12}  # K10's relative distance to the plain version
# K10: scaling ~100, LU ~155, substitutions ~40, clamp ~20, exp ~50, product 84
GN_FLOPS_PER_SEQUENCE = 450
GN_FLOPS_PER_KEYFRAME = 84  # the keyframe sum: a product and an add for each of 42 values
# K11: the motion bound and the floor ~45 a leaf; a subtraction and a test an entry
SLACK_FLOPS_PER_LEAF, SLACK_FLOPS_PER_ENTRY = 45, 3


def record_gn_calls(torch) -> dict:
    """The arguments of every gn_update and certify_slack call of one
    certified flagship scan (the bench's world and primed ring, its scan
    2, eager): ``{name: [args, ...]}``, 15 and 14 calls, each cloned
    before the call, its keyword arguments (the slack pass's ``n_live``)
    after its positional ones, in the signature's order."""
    from madicp_tpu_torch import bench
    from madicp_tpu_torch.kernels import certify_slack, gn_update
    from madicp_tpu_torch.models.step_graph import step_in_place

    setup = bench.BenchSetup(DEV, N_POINTS, KEYFRAMES, DEPTH, MAX_LEAVES)
    pipe = setup.make_pipe("certified")
    setup.prime(pipe)
    calls = {"gn_update": [], "certify_slack": []}
    real = {"gn_update": (gn_update, gn_update.gn_update),
            "certify_slack": (certify_slack, certify_slack.certify_slack)}

    def recorder(name):
        fn = real[name][1]

        def call(*args, **kw):
            calls[name].append(tuple(a.clone() for a in args + tuple(kw.values())))
            return fn(*args, **kw)
        return call

    pipe.compute_device(0.1, *pipe.stage(setup.scan_at(1)))
    try:
        for name, (mod, _) in real.items():
            setattr(mod, name, recorder(name))
        pts, valid, _ = pipe.stage(setup.scan_at(2))  # eager: every call passes the wrappers
        step_in_place(pipe.cfg, pipe._graphs.state, pts[None], valid[None])
    finally:
        for name, (mod, fn) in real.items():
            setattr(mod, name, fn)
    torch.cuda.synchronize()
    del pipe
    torch.cuda.empty_cache()
    return calls


def gn_batch_of(calls: list, B: int) -> tuple:
    """The first ``B`` recorded calls' arguments stacked along the batch
    axis (each call is one sequence's)."""
    import torch

    return tuple(torch.cat([c[j] for c in calls[:B]]) for j in range(len(calls[0])))


def slack_pass_pair(torch, args) -> tuple:
    """(kernel's, plain version's) ``(need, slack, n_descents)`` of one
    slack pass on copies of ``args``."""
    from madicp_tpu_torch.kernels import certify_slack

    a, p = [t.clone() for t in args], [t.clone() for t in args]
    return ((certify_slack.certify_slack(*a), a[0], a[7]),
            (certify_slack.certify_slack_plain(*p), p[0], p[7]))


def gn_rel(got, want) -> float:
    """Largest relative Frobenius distance of two pose batches."""
    d = (got.double() - want.double()).square().sum((-2, -1)).sqrt()
    return float((d / want.double().square().sum((-2, -1)).sqrt()).max())


def gn_folded_errors(got, want, args) -> dict:
    """K10's per-keyframe form against its plain version (``(X, H, b)``
    each, from ``args = (X, H_k, b_k, w)``): the poses' relative distance
    (``rel``) and largest entry difference, and each sum's largest
    difference over the bound two summation orders keep, 2 K eps times
    the sum of the terms' magnitudes (at most 1 passes)."""
    import torch

    _, Hk, bk, w = args
    eps = torch.finfo(Hk.dtype).eps
    out = {"rel": gn_rel(got[0], want[0]),
           "max_abs": float((got[0] - want[0]).abs().max())}
    for name, g, p, t in (("H", got[1], want[1], Hk), ("b", got[2], want[2], bk)):
        lead = w.shape + (1,) * (t.dim() - w.dim())
        bound = 2 * w.shape[-1] * eps * (w.abs().view(lead) * t.abs()).sum(w.dim() - 1)
        over = (g - p).abs().double() / bound.double().clamp(min=1e-300)
        out[f"{name}_over_bound"] = float(over.max())
    return out


def check_folded(err: dict, tol: float, what: str) -> None:
    """Fail where K10's per-keyframe form (:func:`gn_folded_errors`) is
    further than ``tol`` from its plain version, or a sum outside the
    bound of two summation orders."""
    check(err["rel"] <= tol, f"{what}: {err['rel']:.2e} from the plain version, tolerance {tol}")
    check(err["H_over_bound"] <= 1 and err["b_over_bound"] <= 1,
          f"{what}: the keyframe sums at {err['H_over_bound']:.2f}, {err['b_over_bound']:.2f} "
          "of the bound of two summation orders")


# the deskew phase: K12 and the deskewed main path at MulRan's and VBR-OS1's
# rate and range (madicp_tpu_torch/probes/deskew_drive.py)
DESKEW_REPLACES = ("madicp_tpu/ops/deskew.py:96 deskew_cloud, :37 _bin_times_and_motion; "
                   "madicp_tpu/models/pipeline.py:707-714")
DESKEW_REPS = 20  # calls a timing
# scans of each deskew drive: warm (the bootstrap is scan 0; scan 1 the
# warm-up, scan 2 the capture), timed windows, profiled
DESKEW_DRIVE = dict(warm=3, steps=8, windows=2, profiled=2)
# the naive velocity's transient (the first deskewed scans use the
# velocity of two undeskewed ones) has settled after this many scans
DESKEW_SETTLED = 10
DESKEW_CLI_SCANS, DESKEW_CLI_REST = 16, 2  # the CLI's sequence: 2 scans at rest
DESKEW_FLEET_SCANS = 8
# the fleet's sequences: (body velocity m/s, yaw rad/s, scans at rest)
DESKEW_FLEET = (((3.0, 0.0, 0.0), 0.2, 1), ((2.0, 0.5, 0.0), -0.1, 1),
                ((1.0, 0.0, 0.0), 0.3, 2), ((3.5, -0.3, 0.0), 0.0, 1))
# K12's operations a moved point: the bin (binned: atan2 ~20 and ~4;
# reference: its own c and four of the window's, ~30), the motion of its
# bin (t_k, exp_so3 with two sines at ~20 each: ~100), the apply ~18
DESKEW_FLOPS_PER_POINT = {"binned": 140, "reference": 150}
# the pose cases K12 is held to on the flagship sweeps (turning: the
# drive's truth; straight: the same rotation, 0.3 m along the sensor's x;
# at rest: the same pose twice)
DESKEW_MOTIONS = ("turning", "straight", "rest")


def plain_deskew():
    """A context in which the deskew sweep takes its plain version on the
    card too (K12's counter stands still): the yardstick of the ``deskew``
    drives."""
    import contextlib

    from madicp_tpu_torch.kernels import deskew as k12

    @contextlib.contextmanager
    def patched():
        real = k12.deskew_sweep
        k12.deskew_sweep = k12.deskew_sweep_plain
        try:
            yield
        finally:
            k12.deskew_sweep = real

    return patched()


def deskew_batch(torch, setup, B: int, dtype, column: bool = False,
                 motion: str = "turning") -> tuple:
    """K12's arguments at the flagship shapes: scans 3.. of ``setup`` (B
    of them, 65,536 points padded to 131072; in capture-time order with
    ``column``), the poses of ``motion`` (:data:`DESKEW_MOTIONS`), the
    rate, and ``do`` False for the third sequence of four."""
    from madicp_tpu_torch.probes.deskew_drive import sweep_batch

    pts, valid, T_prev, T_now, hz = sweep_batch(setup, 3, B, dtype, column)
    if motion == "rest":
        T_now = T_prev.clone()
    elif motion == "straight":
        T_now = T_prev.clone()
        T_now[:, :3, 3] += 0.3 * T_prev[:, :3, 0]
    do = torch.ones(B, dtype=torch.bool, device=DEV)
    if B > 2:
        do[2] = False
    return pts, valid, do, T_prev, T_now, hz


def deskew_equal(torch, args, mode: str, what: str) -> dict:
    """K12 against its plain version on ``args`` (bins and cloud bit for
    bit, one count a call); fails where they differ."""
    from madicp_tpu_torch.kernels import deskew as k12

    pts, valid = args[:2]
    keys, order = k12.sweep_order(k12.azimuth(pts), valid) if mode == "reference" else (None,
                                                                                         None)
    before = k12.counter.launches
    got, bins = k12.launch(*args, mode, keys, order, return_bins=True)
    want, want_bins = k12.deskew_sweep_plain(*args, mode, keys, order, return_bins=True)
    torch.cuda.synchronize()
    check(k12.counter.launches == before + 1, f"deskew_sweep {what}: launches "
          f"{k12.counter.launches - before}, want 1")
    row = {"bins_equal": torch.equal(bins.long(), want_bins),
           "bins_differ": int((bins.long() != want_bins).sum()), "equal": torch.equal(got, want),
           "max_abs_err": float((got.double() - want.double()).abs().max())}
    check(row["bins_equal"], f"deskew_sweep {what}: {row['bins_differ']} bins differ from the "
          "plain version")
    check(row["equal"], f"deskew_sweep {what}: the cloud differs from the plain version by "
          f"{row['max_abs_err']:.3e}")
    return row


def deskew_kernel_case(torch, args, mode: str, dname: str, what: str) -> dict:
    """K12 against its plain version on ``args`` (:func:`deskew_equal`),
    its eager, graphed and plain ms, the deskew call's (the step's
    ``deskew_scan``: the reference mode's sort included) and the bound;
    at B = 1 in float32 each call's kernels by name."""
    from madicp_tpu_torch.kernels import deskew as k12
    from madicp_tpu_torch.ops.deskew import deskew_scan
    from madicp_tpu_torch.probes import kernel_trace
    from madicp_tpu_torch.utils.timing import bound_ms, event_ms, graph_ms

    pts, valid, do, T_prev, T_now, hz = args
    B, N, _ = pts.shape
    keys, order = k12.sweep_order(k12.azimuth(pts), valid) if mode == "reference" else (None,
                                                                                         None)
    row = deskew_equal(torch, args, mode, what)
    kernel = lambda: k12.launch(*args, mode, keys, order)  # noqa: E731
    plain = lambda: k12.deskew_sweep_plain(*args, mode, keys, order)  # noqa: E731
    call = lambda: deskew_scan(*args, mode)  # noqa: E731
    esize = torch.finfo(pts.dtype).bits // 8
    n_valid = int(valid.sum())
    # points in and out, do, the poses and the rate; binned the masks,
    # reference the sorted keys and their order
    nbytes = B * N * 6 * esize + B + (32 * B + 1) * esize
    nbytes += B * N * (esize + 8) if mode == "reference" else B * N
    bound, by = bound_ms(nbytes, n_valid * DESKEW_FLOPS_PER_POINT[mode], dname)
    row.update({"B": B, "points": N, "valid": n_valid,
                "moved": int((do[:, None] & valid).sum()),
                "ms": event_ms(kernel, DESKEW_REPS), "device_ms": graph_ms(kernel, DESKEW_REPS),
                "plain_ms": event_ms(plain, DESKEW_REPS),
                "plain_device_ms": graph_ms(plain, DESKEW_REPS),
                "call_ms": event_ms(call, DESKEW_REPS),
                "call_device_ms": graph_ms(call, DESKEW_REPS),
                "bound_ms": bound, "bound_by": by, "bytes": nbytes, "library_ms": None})
    if B == 1 and dname == "float32":
        row["trace"] = kernel_trace.launch_us(kernel)
        row["call_trace"] = kernel_trace.launch_us(call)
        names = [r["kernel"].split("<")[0] for r in (row["trace"]["kernels"] or [])]
        want_names = ["binned_kernel"] if mode == "binned" else ["reference_kernel"]
        check(row["trace"]["kernels"] is None or names == want_names,
              f"deskew_sweep {mode}: a call ran {names}")
        ks = row["call_trace"]["kernels"]
        row["call_kernels"] = None if ks is None else len(ks)
        row["call_kernels_device_us"] = None if ks is None else sum(k["device_us"] for k in ks)
    return row


def deskew_drive(torch, setup, deskew: bool = True, mode: str = "reference", dtype=None,
                 route: str = "kernels", twin: bool = False) -> dict:
    """The certified flagship drive on ``setup``'s primed ring, graphed:
    every scan's pose, the launches a scan and scans/s of the timed
    windows, a profiled window, the distance to the truth (all scans and
    the settled ones); with ``twin`` a second primed pipeline running the
    captured body eagerly on the same scans (its poses). ``route``:
    "kernels" or "plain_deskew" (K12 on its plain version)."""
    import contextlib

    from madicp_tpu_torch.models.step_graph import step_in_place
    from madicp_tpu_torch.probes.deskew_drive import truth_error

    dtype = dtype or torch.float32
    w, n, nw, npr = (DESKEW_DRIVE[k] for k in ("warm", "steps", "windows", "profiled"))
    last = w + n * nw + npr
    ctx = plain_deskew() if route == "plain_deskew" else contextlib.nullcontext()
    with ctx:
        pipe = setup.make_pipe(deskew=deskew, mode=mode, dtype=dtype)
        setup.prime(pipe)
        staged = setup.staged(pipe, 1, last)
        poses = []

        def step(k):
            pipe.compute_device(0.1 * k, *staged[k])
            poses.append(pipe._last.pose)

        for k in range(1, 1 + w):
            step(k)
        torch.cuda.synchronize()
        reset_launches()  # the timed run starts here
        rates, lo = [], 1 + w
        for _ in range(nw):
            t0 = time.perf_counter()
            for k in range(lo, lo + n):
                step(k)
            torch.cuda.synchronize()
            rates.append(n / (time.perf_counter() - t0))
            lo += n
        counts = launches()  # read right after it
        prof = profile_window(lambda: [step(k) for k in range(lo, lo + npr)], npr)
        (capture_ms, nodes, _), = pipe._graphs.captured().values()
        eager = None
        if twin:
            tw = setup.make_pipe(deskew=deskew, mode=mode, dtype=dtype)
            setup.prime(tw)
            eager = torch.stack([step_in_place(tw.cfg, tw._graphs.state, staged[k][0][None],
                                               staged[k][1][None]).pose[0]
                                 for k in range(1, last + 1)])
            eager = eager.double().cpu().numpy()
            del tw
    got = torch.stack(poses).double().cpu().numpy()
    truths = np.stack([setup.truth(k) for k in range(1, last + 1)])
    settled = slice(DESKEW_SETTLED, None)
    out = {"dataset": setup.dataset, "deskew": mode if deskew else "off",
           "dtype": str(dtype).split(".")[1], "route": route, "scans": last,
           "scans_per_s": float(np.median(rates)), "windows": rates,
           "launches_per_scan": {k: v / (n * nw) for k, v in counts.items()},
           "deskew_launches": counts["deskew_sweep"], "capture_ms": capture_ms, "nodes": nodes,
           "profile": prof, "from_truth": truth_error(got, truths),
           "from_truth_settled": truth_error(got[settled], truths[settled]),
           "poses": got, "eager_poses": eager}
    del pipe, staged
    torch.cuda.empty_cache()
    return out


def deskew_dataset(torch, dataset: str, modes) -> dict:
    """Every drive of one dataset's configuration: K12 graphed beside its
    eager twin, on its plain version, in float64, deskew off, and the
    other ``modes``; their checks. Returns the rows (poses dropped)."""
    from madicp_tpu_torch.probes.deskew_drive import SweepSetup

    setup = SweepSetup(DEV, dataset)
    main = deskew_drive(torch, setup, twin=True)
    others = {"plain_deskew": deskew_drive(torch, setup, route="plain_deskew"),
              "float64": deskew_drive(torch, setup, dtype=torch.float64),
              "off": deskew_drive(torch, setup, deskew=False),
              "float64_off": deskew_drive(torch, setup, deskew=False, dtype=torch.float64)}
    for mode in modes:
        others[mode] = deskew_drive(torch, setup, mode=mode)
    eager_gap = pose_gap(main["poses"], main.pop("eager_poses"))
    gaps = {name: pose_gap(main["poses"], d["poses"]) for name, d in others.items()}
    # float32 against float64 with deskew off: the pipeline's own float32 gap
    gaps["off_vs_float64_off"] = pose_gap(others["off"]["poses"], others["float64_off"]["poses"])
    out = {"dataset": dataset, "sensor_hz": setup.cf.sensor_hz,
           "range_m": [setup.cf.min_range, setup.cf.max_range], "mode": "reference",
           "main": main, **others, "graphed_vs_eager": eager_gap, "gaps": gaps}
    for d in (main, *others.values()):
        d.pop("poses")
        d.pop("eager_poses", None)
    what = f"deskew {dataset}"
    check(eager_gap["max_abs"] == 0.0, f"{what}: graphed and eager poses differ: {eager_gap}")
    for name in ("plain_deskew", "float64"):
        g = max(gaps[name]["x_m"], gaps[name]["y_m"], gaps[name]["z_m"])
        check(g <= ASSOC_BOUND_M, f"{what}: {name} drive {g:.2e} m from the kernels' "
              f"(bound {ASSOC_BOUND_M})")
    on, off = (main["from_truth_settled"]["mean_m"], others["off"]["from_truth_settled"]["mean_m"])
    check(on < off, f"{what}: deskew on is {on:.4f} m from the truth, off {off:.4f} m")
    for mode in modes:
        m = others[mode]["from_truth_settled"]["mean_m"]
        check(m < off, f"{what}: {mode} deskew {m:.4f} m from the truth, off {off:.4f} m")
    for d in (main, *(others[m] for m in modes), others["float64"]):
        lps = d["launches_per_scan"]
        check(lps["deskew_sweep"] == 1, f"{what} {d['deskew']} {d['dtype']}: deskew_sweep "
              f"launched {lps['deskew_sweep']} times a scan")
        check_launched(lps, f"{what} {d['deskew']} {d['dtype']}", certified=True)
    for d in (others["plain_deskew"], others["off"], others["float64_off"]):
        check(d["launches_per_scan"]["deskew_sweep"] == 0,
              f"{what} {d['route']} {d['deskew']}: deskew_sweep was launched")
    return out


def deskew_cli(torch) -> dict:
    """The CLI at its defaults with ``--dataset-config mulran`` on KITTI
    .bin files of a MulRan-shaped sequence (two scans at rest, then 3 m/s
    and 0.2 rad/s), and with the same configuration's deskew off: the
    poses against the truth, the rate, K12's launches."""
    import dataclasses
    import shutil
    import tempfile

    from madicp_tpu_torch.probes.deskew_drive import SweepSetup, truth_error
    from madicp_tpu_torch.utils.config import DATASET_CONFIGS, dump_yaml
    from madicp_tpu_torch.utils.trajectory import load_kitti_poses

    setup = SweepSetup(DEV, "mulran", rest=DESKEW_CLI_REST, seed=3)
    E = DATASET_CONFIGS["mulran"].lidar_to_base
    truths = np.stack([setup.truth(k) for k in range(DESKEW_CLI_SCANS)])
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_deskew_"))
    try:
        data = work / "data"
        data.mkdir()
        for k in range(DESKEW_CLI_SCANS):
            p = setup.sweep(k)
            np.concatenate([p, np.ones((len(p), 1), np.float32)], axis=1).tofile(
                data / f"{k:06d}.bin")
        off_cfg = work / "mulran_off.yaml"
        dump_yaml(dataclasses.replace(DATASET_CONFIGS["mulran"], deskew=False), off_cfg)
        out = {}
        for name, cfg in (("mulran", "mulran"), ("mulran_deskew_off", off_cfg)):
            run = run_cli(["--data-path", data, "--estimate-path", work / name,
                           "--dataset-config", cfg, "--noviz", "--device", DEV])
            est = load_kitti_poses(work / name / "estimate.txt")
            lidar = np.linalg.inv(E) @ est @ E  # the estimate is conjugated by the extrinsics
            run["from_truth"] = truth_error(lidar, truths)
            run["from_truth_settled"] = truth_error(lidar[DESKEW_SETTLED:],
                                                    truths[DESKEW_SETTLED:])
            out[name] = run
    finally:
        shutil.rmtree(work, ignore_errors=True)
    on, off = out["mulran"], out["mulran_deskew_off"]
    check(on["launches"]["deskew_sweep"] == DESKEW_CLI_SCANS - 1,
          f"cli mulran: deskew_sweep launched {on['launches']['deskew_sweep']} times in "
          f"{DESKEW_CLI_SCANS} scans")
    check(off["launches"]["deskew_sweep"] == 0, "cli mulran, deskew off: deskew_sweep launched")
    check(on["from_truth_settled"]["mean_m"] < off["from_truth_settled"]["mean_m"],
          f"cli mulran: deskew on {on['from_truth_settled']['mean_m']:.4f} m from the truth, "
          f"off {off['from_truth_settled']['mean_m']:.4f} m")
    check(on["from_truth"]["max_m"] < 0.1, f"cli mulran: {on['from_truth']['max_m']:.3f} m "
          "from the truth (a third of a scan's motion)")
    return {"scans": DESKEW_CLI_SCANS, "rest_scans": DESKEW_CLI_REST, **out}


def deskew_fleet(torch) -> dict:
    """The fleet at B = 4 with deskew on (mulran, reference mode),
    graphed, against one single Pipeline a sequence (each graphed):
    every sequence within 5e-4 m at every scan; fleet scans/s."""
    from madicp_tpu_torch.parallel import Fleet
    from madicp_tpu_torch.probes.deskew_drive import SweepSetup

    setups = [SweepSetup(DEV, "mulran", seed=10 + b, v_lin=v, omega=(0.0, 0.0, yaw), rest=r)
              for b, (v, yaw, r) in enumerate(DESKEW_FLEET)]
    B, S = len(setups), DESKEW_FLEET_SCANS
    pipes = [s.make_pipe() for s in setups]
    staged = [[p.stage(s.sweep(k)) for k in range(S)] for p, s in zip(pipes, setups)]
    single = np.zeros((S, B, 4, 4))
    for b, (pipe, st) in enumerate(zip(pipes, staged)):
        for k in range(S):
            pipe.compute_device(0.1 * k, *st[k])
            single[k, b] = pipe._last.pose.double().cpu().numpy()
    fleet = Fleet(pipes[0].cfg, B, device=DEV)
    del pipes
    batches = [(torch.stack([staged[b][k][0] for b in range(B)]),
                torch.stack([staged[b][k][1] for b in range(B)])) for k in range(S)]
    reset_launches()
    gaps, t0 = [], time.perf_counter()
    for k in range(S):
        out = fleet.compute(None, *batches[k])
        gaps.append(float(np.abs(out.pose.double().cpu().numpy() - single[k]).max()))
    wall = time.perf_counter() - t0
    counts = launches()
    (capture_ms, nodes, _), = fleet._graphs.captured().values()
    row = {"B": B, "scans": S, "max_abs_gap_per_scan": gaps, "bound_m": FLEET_BOUND_M,
           "fleet_scans_per_s_incl_warmup": B * S / wall, "launches": counts,
           "capture_ms": capture_ms, "nodes": nodes}
    check(max(gaps) <= FLEET_BOUND_M, f"deskew fleet: {max(gaps):.2e} from its single "
          "Pipelines")
    check(counts["deskew_sweep"] == S - 1, f"deskew fleet: deskew_sweep launched "
          f"{counts['deskew_sweep']} times in {S} batched scans, want {S - 1}")
    del fleet, staged, batches
    torch.cuda.empty_cache()
    return row


def deskew_no_sync(torch) -> dict:
    """One deskewed step of a captured configuration (the MulRan drive's,
    after its capture) run eagerly under ``set_sync_debug_mode("error")``."""
    from madicp_tpu_torch.models.step_graph import step_in_place
    from madicp_tpu_torch.probes.deskew_drive import SweepSetup

    setup = SweepSetup(DEV, "mulran")
    pipe = setup.make_pipe()
    setup.prime(pipe)
    staged = setup.staged(pipe, 1, 3)
    for k in (1, 2):
        pipe.compute_device(0.1 * k, *staged[k])
    check(len(pipe._graphs.captured()) == 1, "deskew no-sync: the step was not captured")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = step_in_place(pipe.cfg, pipe._graphs.state, staged[3][0][None], staged[3][1][None])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(out.pose).all()), "deskew no-sync: non-finite pose")
    del pipe
    torch.cuda.empty_cache()
    return {"step": "step_in_place under set_sync_debug_mode('error')", "synced": False}


def phase_deskew(torch, nvidia_smi: str) -> dict:
    """The deskew sweep (K12) against its plain version on the card at
    flagship shapes (131072 points, 65,536 of an OS1-64 sweep valid; B =
    1 and 4; float32 and float64; both modes; draw and column order; the
    poses of :data:`DESKEW_MOTIONS`): bins and cloud bit for bit; on the
    turning poses eager, graphed and plain ms, the deskew call's and the
    bound. Then the deskewed
    main path: the MulRan- and VBR-OS1-shaped drives (certified flagship,
    graphed; beside an eager twin, on K12's plain version, in float64,
    deskew off; MulRan in the binned mode too), the CLI with
    ``--dataset-config mulran``, the fleet at B = 4 and a deskewed step
    under ``set_sync_debug_mode("error")``."""
    from madicp_tpu_torch.kernels import deskew as k12
    from madicp_tpu_torch.probes.deskew_drive import SweepSetup

    t_phase = time.perf_counter()
    out = {"phase": "deskew", "nvidia_smi": nvidia_smi, "kernel": {}}
    setup = SweepSetup(DEV, "mulran")
    for dtype in (torch.float32, torch.float64):
        dname = str(dtype).split(".")[1]
        rows = {}
        for B in (1, 4):
            for column in (False, True):
                where = f"B{B}_column" if column else f"B{B}"
                args = deskew_batch(torch, setup, B, dtype, column)
                for mode in k12.MODES:
                    what = f"{dname} {mode} {where}"
                    rows[f"{mode}_{where}"] = deskew_kernel_case(torch, args, mode, dname, what)
                for motion in DESKEW_MOTIONS[1:]:
                    args = deskew_batch(torch, setup, B, dtype, column, motion)
                    for mode in k12.MODES:
                        rows[f"{mode}_{where}_{motion}"] = deskew_equal(
                            torch, args, mode, f"{dname} {mode} {where} {motion}")
                del args
        out["kernel"][dname] = rows
        emit({"phase": "deskew", "part": f"kernel_{dname}", "nvidia_smi": nvidia_smi, **rows})
    del setup
    torch.cuda.empty_cache()
    for dataset, modes in (("mulran", ("binned",)), ("vbr_os1", ())):
        out[dataset] = deskew_dataset(torch, dataset, modes)
        emit({"phase": "deskew", "part": dataset, "nvidia_smi": nvidia_smi, **out[dataset]})
    out["cli"] = deskew_cli(torch)
    out["fleet"] = deskew_fleet(torch)
    out["no_sync"] = deskew_no_sync(torch)
    out["seconds"] = time.perf_counter() - t_phase
    emit({"phase": "deskew", "part": "apps", "nvidia_smi": nvidia_smi, "cli": out["cli"],
          "fleet": out["fleet"], "no_sync": out["no_sync"], "seconds": out["seconds"]})
    return out


# the tail phase: K14 (the prediction and the tail's scalars) and K13 (the
# frame record and the promotion's tree copy) on flagship states
TAIL_REPLACES = {
    "step_scalars": ("madicp_tpu/models/pipeline.py:723 (madicp_tpu/ops/lie.py:147 "
                     "exp_se3_split), :736-792 without the tree copies; "
                     "madicp_tpu/models/vel_estimator.py:21; madicp_tpu/ops/icp_core.py:262"),
    "ring_write": ("madicp_tpu/ops/tree.py:939 transform_tree; madicp_tpu/models/pipeline.py:287, "
                   "751 _set_slot; :768-779 do_promote's tree copy"),
}
TAIL_REPS = 20  # calls a timing
TAIL_WARM = 3  # eager steps before the recorded one: older frames in the window
# the cases K13 and K14 are held to: p_th below every ratio (no sequence
# promotes), above every ratio with every older frame valid and its
# weight lowered by 1e6 (every sequence promotes an older frame; the
# warm-up steps wrote finite weights) and with every older
# frame's weight inf (every one promotes its own scan's slot)
TAIL_CASES = {"no_promote": -1.0, "promote": 2.0, "promote_head": 2.0}
# operations a sequence: predict ~90 (six divisions, exp_so3, 16 entries
# of 5); the tail ~1,600 (9 pairs of ~110: the relative pose 60, two
# atan2 and an asin, the residual, norm, clamp and weight; the LU ~150 and
# six logs; the sums 63; the window ~60) plus 2 a flag pair of the counts
TAIL_FLOPS = {"predict": 90, "tail": 1600}
# the state's fields the tail writes (and X)
IN_PLACE_FIELDS = ("velocity", "traj", "traj_count", "fr_valid", "fr_weight", "fr_seq",
                   "fr_pose", "fr_head", "kf_valid", "kf_head", "keyframe_to_map", "seq",
                   "seq_keyframe")
RING_FLOPS_PER_PANEL = 18  # 9 products and 9 additions


def tensors_equal(torch, a, b) -> bool:
    return torch.equal(a, b) or (a.is_floating_point() and torch.equal(a.isnan(), b.isnan())
                                 and torch.equal(a.nan_to_num(), b.nan_to_num()))


def tail_bytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def tail_case(torch, rec: dict, state, case: str, dname: str, what: str, timed: bool) -> dict:
    """K14 (predict, tail) and K13 on a recorded flagship step's inputs
    with ``p_th`` of :data:`TAIL_CASES` ``[case]``, against their plain
    versions bit for bit (one count each a call), the tail both with
    fresh outputs and in place (the state its own destination, as the
    step calls it: the destination's tensors kept); with ``timed`` eager,
    graphed and plain ms of each and the bound (the tail's in place, as
    the step runs it), and the tail's graphed ms in place and with fresh
    outputs, in turns."""
    from madicp_tpu_torch.kernels import ring_write, step_scalars
    from madicp_tpu_torch.probes.kernel_trace import clone_scalars
    from madicp_tpu_torch.utils.timing import bound_ms, event_ms, graph_ms

    st, (X, H, matched, valid, hz), kw = rec["tail"]
    kw = dict(kw, p_th=TAIL_CASES[case])
    if case == "promote_head":  # no old frame outweighs the record
        st = st._replace(fr_weight=torch.full_like(st.fr_weight, float("inf")))
    elif case == "promote":  # every old frame valid and outweighing it
        st = st._replace(fr_weight=st.fr_weight - 1e6,
                         fr_valid=torch.ones_like(st.fr_valid))
    nav, Xr = rec["ring"]
    Xp, vp, hzp = rec["predict"]
    B = X.shape[0]
    c13, c14 = ring_write.counter.launches, step_scalars.counter.launches
    p_k, p_p = step_scalars.launch_predict(Xp, vp, hzp), step_scalars.predict_plain(Xp, vp, hzp)
    t_k = step_scalars.launch_tail(st, X, H, matched, valid, hz, **kw)
    t_p = step_scalars.tail_plain(st, X, H, matched, valid, hz, **kw)
    # in place: each route's own copy of the state is its destination
    places = {route: clone_scalars(st) for route in ("kernel", "plain")}
    ptrs = {route: [getattr(d, f).data_ptr() for f in ("X",) + IN_PLACE_FIELDS]
            for route, d in places.items()}
    d = places["kernel"]
    i_k = step_scalars.launch_tail(d, X, H, matched, valid, hz, **kw, out=d)
    d = places["plain"]
    i_p = step_scalars.tail_plain(d, X, H, matched, valid, hz, **kw, out=d)
    rings = [(state.fr_tree.nav.clone(), state.kf_tree.nav.clone()) for _ in range(2)]
    ring_write.launch(nav, Xr, t_k.plan, *rings[0])
    ring_write.ring_write_plain(nav, Xr, t_p.plan, *rings[1])
    torch.cuda.synchronize()
    check((ring_write.counter.launches - c13, step_scalars.counter.launches - c14) == (1, 3),
          f"tail {what}: launches {ring_write.counter.launches - c13}, "
          f"{step_scalars.counter.launches - c14}, want 1 and 3")
    unequal = [name for name, a, b in zip(step_scalars.Tail._fields, t_k, t_p)
               if not tensors_equal(torch, a, b)]
    check(tensors_equal(torch, p_k, p_p), f"tail {what}: predict differs from the plain version "
          f"by {float((p_k.double() - p_p.double()).abs().max()):.3e}")
    check(not unequal, f"tail {what}: the tail's {unequal} differ from the plain version")
    for route, got in (("kernel", i_k), ("plain", i_p)):
        d = places[route]
        unequal = [name for name, a, b in zip(step_scalars.Tail._fields, got, t_p)
                   if not tensors_equal(torch, a, b)]
        check(not unequal and torch.equal(d.X, X), f"tail {what}: the {route} route in place: "
              f"{unequal or ['X']} differ from the plain version's fresh outputs")
        check(all(getattr(got, f) is getattr(d, f) for f in IN_PLACE_FIELDS)
              and ptrs[route] == [getattr(d, f).data_ptr() for f in ("X",) + IN_PLACE_FIELDS],
              f"tail {what}: the {route} route in place moved a destination")
    check(torch.equal(rings[0][0], rings[1][0]) and torch.equal(rings[0][1], rings[1][1]),
          f"tail {what}: the rings differ from the plain version's")
    head, best, slot, write = t_k.plan.cpu().tolist()[0]
    row = {"B": B, "promote": t_k.promote.cpu().tolist(), "plan_0": [head, best, slot, write],
           "equal": True, "max_abs_err": 0.0}
    want_promote = case != "no_promote"
    check(all(p == want_promote for p in row["promote"]), f"tail {what}: promote "
          f"{row['promote']}")
    check((best == head) == (case == "promote_head") or case == "no_promote",
          f"tail {what}: best {best}, head {head}")
    del rings
    if not timed:
        return row
    esize = torch.finfo(X.dtype).bits // 8
    tree = nav[0].numel() * esize
    copies = 0 if case == "no_promote" else 1 if case == "promote_head" else 2
    rings = (state.fr_tree.nav.clone(), state.kf_tree.nav.clone())
    kernels = {
        "predict": (lambda: step_scalars.launch_predict(Xp, vp, hzp),
                    lambda: step_scalars.predict_plain(Xp, vp, hzp),
                    tail_bytes((Xp, vp, hzp)) + Xp.numel() * esize,
                    B * TAIL_FLOPS["predict"]),
        # in place, as the step calls it (each route on its own copy)
        "tail": (lambda: step_scalars.launch_tail(places["kernel"], X, H, matched, valid, hz,
                                                  **kw, out=places["kernel"]),
                 lambda: step_scalars.tail_plain(places["plain"], X, H, matched, valid, hz,
                                                 **kw, out=places["plain"]),
                 tail_bytes([X, H, matched, valid, hz] + [getattr(st, f) for f, _, _ in
                                                          step_scalars._STATE])
                 + tail_bytes(t_k), B * TAIL_FLOPS["tail"] + 2 * matched.numel()),
        "ring_write": (lambda: ring_write.launch(nav, Xr, t_k.plan, *rings),
                       lambda: ring_write.ring_write_plain(nav, Xr, t_k.plan, *rings),
                       B * tree * (2 + copies) + tail_bytes((Xr, t_k.plan)),
                       B * nav.shape[1] * 7 * RING_FLOPS_PER_PANEL),
    }
    for name, (kernel, plain, nbytes, flops) in kernels.items():
        bound, by = bound_ms(nbytes, flops, dname)
        row[name] = {"ms": event_ms(kernel, TAIL_REPS), "device_ms": graph_ms(kernel, TAIL_REPS),
                     "plain_ms": event_ms(plain, TAIL_REPS),
                     "plain_device_ms": graph_ms(plain, TAIL_REPS), "bound_ms": bound,
                     "bound_by": by, "bytes": nbytes, "library_ms": None}
    # the tail in place (the step's form) and with fresh outputs, in turns
    # (in place, fresh, fresh, in place), and the eager ms of the fresh call
    forms = {"in_place": kernels["tail"][0],
             "fresh": lambda: step_scalars.launch_tail(st, X, H, matched, valid, hz, **kw)}
    ab = {form: [] for form in forms}
    for form in ("in_place", "fresh", "fresh", "in_place"):
        ab[form].append(graph_ms(forms[form], TAIL_REPS))
    row["tail"]["ab_device_ms"] = ab
    row["tail"]["fresh_ms"] = event_ms(forms["fresh"], TAIL_REPS)
    del rings
    return row


def phase_tail(torch, nvidia_smi: str) -> dict:
    """K14 (``step_scalars``: the prediction and the tail's scalars) and
    K13 (``ring_write``: the frame record and the promotion's tree copy)
    against their plain versions on the card bit for bit, on the inputs of
    a recorded certified flagship step (the bench's primed ring, 16
    keyframes, 32768 leaves, 131072-point trees), float32 and float64, B =
    1 and 4, no sequence promoting, every one promoting from an older
    window frame, and every one promoting its own scan; eager, graphed and
    plain ms and the bound of each. Then
    the certified flagship drive, graphed, with the kernels and with all
    three on their plain versions (``plain_tail``): scans/s, device busy
    and kernels a scan, launches a scan, the poses (equal bit for bit:
    the kernels write their plain versions' bits)."""
    from madicp_tpu_torch import bench
    from madicp_tpu_torch.models.pipeline import _map
    from madicp_tpu_torch.models.step_graph import step_in_place
    from madicp_tpu_torch.probes.kernel_trace import record_tail, tail_pipe

    t_phase = time.perf_counter()
    out = {"phase": "tail", "nvidia_smi": nvidia_smi, "kernel": {}}
    setup = bench.BenchSetup(DEV, N_POINTS, KEYFRAMES, DEPTH, MAX_LEAVES)
    for dtype in (torch.float32, torch.float64):
        dname = str(dtype).split(".")[1]
        pipe = tail_pipe(setup, dtype)
        rows = {}
        for B in (1, 4):
            state = _map(lambda t: t[None].repeat((B,) + (1,) * t.dim()).contiguous(),
                         pipe.state)
            staged = [pipe.stage(setup.scan_at(3 + b)) for b in range(B)]
            pts = torch.stack([p for p, _, _ in staged])
            valid = torch.stack([v for _, v, _ in staged])
            for _ in range(TAIL_WARM):  # the frame window fills (nothing promotes)
                step_in_place(pipe.cfg, state, pts, valid)
            rec = record_tail(pipe.cfg, state, pts, valid)
            for case in TAIL_CASES:
                rows[f"{case}_B{B}"] = tail_case(torch, rec, state, case, dname,
                                                 f"{dname} {case} B={B}", timed=True)
            del state, rec
            torch.cuda.empty_cache()
        out["kernel"][dname] = rows
        emit({"phase": "tail", "part": f"kernel_{dname}", "nvidia_smi": nvidia_smi, **rows})
        del pipe
        torch.cuda.empty_cache()
    drives = [certified_drive(torch, route)
              for route in ("kernels", "plain_tail", "state_copies")]
    gap = pose_gap(drives[0]["poses"], drives[1].pop("poses"))
    copies_gap = pose_gap(drives[0].pop("poses"), drives[2].pop("poses"))
    out["drive"] = {"schedule": "certified", "graphed": True, **ASSOC_DRIVE,
                    "kernels": drives[0], "plain_tail": drives[1], "state_copies": drives[2],
                    "bench_world_gap": gap, "poses_equal": gap["max_abs"] == 0.0,
                    "state_copies_gap": copies_gap,
                    "nodes_saved": drives[2]["nodes"] - drives[0]["nodes"],
                    "kernels_saved": (drives[2]["profile"]["kernels_per_scan"]
                                      - drives[0]["profile"]["kernels_per_scan"])}
    out["seconds"] = time.perf_counter() - t_phase
    emit({"phase": "tail", "part": "drive", **out["drive"], "seconds": out["seconds"]})
    lps = drives[0]["launches_per_scan"]
    check_launched(lps, "tail drive", certified=True)
    check(lps["step_scalars"] == 2 and lps["ring_write"] == 1,
          f"tail drive: step_scalars {lps['step_scalars']} and ring_write {lps['ring_write']} "
          "launches a scan, want 2 and 1")
    for name in TAIL_KERNELS:
        check(drives[1]["launches_per_scan"][name] == 0, f"tail plain drive: {name} launched")
    check(out["drive"]["poses_equal"] and copies_gap["max_abs"] == 0.0,
          f"tail: the kernel drive {gap} from the plain_tail drive and {copies_gap} from the "
          "state_copies drive on the bench's world, want equal")
    # a replay copies no state: the graph holds the state copies' drive's
    # nodes less write_state's 14 copies, and the buffers stay in place
    check(out["drive"]["nodes_saved"] == len(IN_PLACE_FIELDS) + 1,
          f"tail drive: {drives[0]['nodes']} graph nodes against {drives[2]['nodes']} with the "
          f"state copied, want {len(IN_PLACE_FIELDS) + 1} fewer")
    check(all(dr["state_buffers_kept"] for dr in drives),
          "tail drive: a step moved a state buffer")
    return out


def phase_gn(torch, nvidia_smi: str) -> dict:
    """The GN update (K10) and the certified slack pass (K11) against
    their plain versions on the card, float32 and float64: the test cases
    (``probes/gn_cases.py``: real normal equations, an empty H, a singular
    one, steps beyond each trust bound, both branches of exp_so3, an
    infinite diagonal entry, batches of four; per-keyframe terms at K = 1,
    4 and 16; the slack pass on a ragged tile and keyframe group) and
    every call of a certified flagship scan (15 updates on the
    per-keyframe terms, 14 slack passes, B = 1 as recorded and B = 4
    stacked): K10 within 5e-6 (float32) and 1e-12 (float64) relative and
    its sums within the bound of two summation orders, K11's need, slack
    and count bit for bit. At the flagship's B = 1 and 4: eager, graphed and plain ms,
    the bound, torch.linalg.solve_ex on the scaled system beside K10, the
    kernels a call. Then the certified drive graphed twice, with the
    kernels and with both on their plain versions (``plain_gn``): scans/s,
    device busy and kernels a scan of both, poses within 5e-4 m (the
    bench's world on y and z, the two-orientation world whole)."""
    from madicp_tpu_torch.kernels import certify_slack, gn_update
    from madicp_tpu_torch.probes import gn_cases, kernel_trace
    from madicp_tpu_torch.utils.timing import bound_ms, event_ms, graph_ms

    t_phase = time.perf_counter()
    dev = torch.device(DEV)
    out = {"phase": "gn", "nvidia_smi": nvidia_smi, "cases": {}, "flagship": {}}
    recorded = record_gn_calls(torch)
    check(len(recorded["gn_update"]) == ROUNDS
          and len(recorded["certify_slack"]) == ROUNDS - 1,
          f"gn: a certified scan made {len(recorded['gn_update'])} updates and "
          f"{len(recorded['certify_slack'])} slack passes, want {ROUNDS} and {ROUNDS - 1}")
    for dtype in (torch.float32, torch.float64):
        dname = str(dtype).split(".")[1]
        esize = torch.finfo(dtype).bits // 8
        cast = lambda args: tuple(a.to(dtype) if a.is_floating_point() else a  # noqa: E731
                                  for a in args)
        # the test cases
        rows = {}
        for name, cases in gn_cases.BATCHES.items():
            X, H, b = (torch.as_tensor(a, dtype=dtype, device=dev)
                       for a in gn_cases.gn_batch(cases))
            rel = gn_rel(gn_update.gn_update(X, H, b), gn_update.gn_update_plain(X, H, b))
            rows[name] = rel
            check(rel <= GN_TOL[dname], f"gn_update {dname} {name}: {rel:.2e} from the plain "
                  f"version, tolerance {GN_TOL[dname]}")
        for K in (1, 4, KEYFRAMES):  # the per-keyframe form, an empty slot among them
            args = tuple(torch.as_tensor(a, dtype=dtype, device=dev)
                         for a in gn_cases.keyframe_terms(2, K, seed=K))
            rows[f"folded_K{K}"] = gn_folded_errors(gn_update.gn_update(*args),
                                                    gn_update.gn_update_plain(*args), args)
            check_folded(rows[f"folded_K{K}"], GN_TOL[dname], f"gn_update {dname} folded K={K}")
        for B in (1, 2):
            for K, L in ((KEYFRAMES, 4096), (5, 4095)):  # 4095, 5: ragged tile and group
                s = gn_cases.slack_inputs(dtype, B=B, K=K, L=L)
                (nk, sk, ck), (np_, sp, cp) = slack_pass_pair(torch, tuple(
                    v.to(dev) for v in s.values()))
                rows[f"slack_B{B}_K{K}_L{L}"] = {
                    "need": int(np_.sum()),
                    "equal": torch.equal(nk, np_) and torch.equal(sk, sp) and torch.equal(ck, cp)}
                check(rows[f"slack_B{B}_K{K}_L{L}"]["equal"], f"certify_slack {dname} B={B} "
                      f"K={K} L={L}: differs from the plain version")
        out["cases"][dname] = rows
        # every recorded call of the flagship scan, then B = 4 stacks
        gn_errs, sum_errs, slack_equal, need_counts, max_abs = [], [], [], [], 0.0
        for args in recorded["gn_update"]:
            args = cast(args)
            err = gn_folded_errors(gn_update.gn_update(*args), gn_update.gn_update_plain(*args),
                                   args)
            check_folded(err, GN_TOL[dname], f"gn_update {dname} flagship")
            gn_errs.append(err["rel"])
            sum_errs.append([err["H_over_bound"], err["b_over_bound"]])
            max_abs = max(max_abs, err["max_abs"])
        for args in recorded["certify_slack"]:
            (nk, sk, ck), (np_, sp, cp) = slack_pass_pair(torch, cast(args))
            slack_equal.append(torch.equal(nk, np_) and torch.equal(sk, sp)
                               and torch.equal(ck, cp))
            need_counts.append(int(np_.sum()))
        flag = {"gn_rel_err": gn_errs, "gn_max_abs_err": max_abs,
                "sums_over_bound": sum_errs, "slack_equal": slack_equal,
                "need_per_round": need_counts, "tol": GN_TOL[dname]}
        check(max(gn_errs) <= GN_TOL[dname], f"gn_update {dname} flagship: {max(gn_errs):.2e} "
              f"from the plain version, tolerance {GN_TOL[dname]}")
        check(all(slack_equal), f"certify_slack {dname} flagship: rounds {slack_equal} differ "
              "from the plain version")
        for B in (1, 4):
            g = cast(gn_batch_of(recorded["gn_update"], B))
            c = cast(gn_batch_of(recorded["certify_slack"], B))
            err = gn_folded_errors(gn_update.gn_update(*g), gn_update.gn_update_plain(*g), g)
            (nk, sk, ck), (np_, sp, cp) = slack_pass_pair(torch, c)
            equal = torch.equal(nk, np_) and torch.equal(sk, sp) and torch.equal(ck, cp)
            check_folded(err, GN_TOL[dname], f"gn_update {dname} B={B}")
            check(equal, f"certify_slack {dname} B={B}: differs from the plain version")
            A, rhs = gn_cases.scaled_system(*gn_update.keyframe_sums(*g[1:]))
            kernel = lambda g=g: gn_update.gn_update(*g)  # noqa: E731
            plain = lambda g=g: gn_update.gn_update_plain(*g)  # noqa: E731
            solve = lambda A=A, rhs=rhs: torch.linalg.solve_ex(A, rhs)  # noqa: E731
            K = g[3].shape[-1]  # X, the K terms and weights in; X, H, b out
            bound, by = bound_ms(B * (16 + 43 * K + 16 + 42) * esize,
                                 B * (GN_FLOPS_PER_SEQUENCE + GN_FLOPS_PER_KEYFRAME * K), dname)
            k10 = {"rel_err": err["rel"], "max_abs_err": err["max_abs"],
                   "sums_over_bound": [err["H_over_bound"], err["b_over_bound"]],
                   "ms": event_ms(kernel, GN_REPS), "device_ms": graph_ms(kernel, GN_REPS),
                   "plain_ms": event_ms(plain, GN_REPS),
                   "plain_device_ms": graph_ms(plain, GN_REPS),
                   "solve_ex_ms": event_ms(solve, GN_REPS),
                   "solve_ex_device_ms": graph_ms(solve, GN_REPS),
                   "bound_ms": bound, "bound_by": by, "library_ms": None,
                   "trace": kernel_trace.launch_us(kernel),
                   "plain_trace": kernel_trace.launch_us(plain)}
            _, K, L = c[0].shape
            work = [t.clone() for t in c]  # the slack and the count change in place
            pwork = [t.clone() for t in c]
            kernel = lambda: certify_slack.certify_slack(*work)  # noqa: E731
            plain = lambda: certify_slack.certify_slack_plain(*pwork)  # noqa: E731
            nbytes = (B * K * L * (2 * esize + 1) + B * L * (4 * esize + 1) + B * K
                      + B * 32 * esize + 16 * B)
            bound, by = bound_ms(nbytes, B * L * SLACK_FLOPS_PER_LEAF
                                 + B * K * L * SLACK_FLOPS_PER_ENTRY, dname)
            k11 = {"entries": B * K * L, "need": int(np_.sum()), "equal": equal,
                   "max_abs_err": 0.0, "ms": event_ms(kernel, GN_REPS),
                   "device_ms": graph_ms(kernel, GN_REPS), "plain_ms": event_ms(plain, GN_REPS),
                   "plain_device_ms": graph_ms(plain, GN_REPS), "bound_ms": bound,
                   "bound_by": by, "library_ms": None,
                   "trace": kernel_trace.launch_us(kernel),
                   "plain_trace": kernel_trace.launch_us(plain)}
            for name, k in (("gn_update", k10), ("certify_slack", k11)):
                names = [r["kernel"].split("<")[0] for r in (k["trace"]["kernels"] or [])]
                check(k["trace"]["kernels"] is None
                      or names == list(kernel_names()[name]),
                      f"{name} {dname} B={B}: a call ran {names}")
            flag[f"B{B}"] = {"gn_update": k10, "certify_slack": k11}
            del work, pwork
        out["flagship"][dname] = flag
        emit({"phase": "gn", "part": dname, "nvidia_smi": nvidia_smi, "cases": rows, **flag})
    del recorded
    torch.cuda.empty_cache()

    # the certified drive with the kernels, then with both on their plain versions
    drives = [certified_drive(torch, route) for route in ("kernels", "plain_gn")]
    bench_gap = pose_gap(drives[0].pop("poses"), drives[1].pop("poses"))
    two_way = []
    for route in ("kernels", "plain_gn"):
        with route_context(route):
            two_way.append(two_way_drive()[0])
        torch.cuda.empty_cache()
    two_way_gap = pose_gap(*two_way)
    out["drive"] = {"schedule": "certified", "graphed": True, **ASSOC_DRIVE,
                    "kernels": drives[0], "plain_gn": drives[1],
                    "bench_world_gap": bench_gap, "two_way_world_gap": two_way_gap,
                    "bound_m": ASSOC_BOUND_M}
    out["seconds"] = time.perf_counter() - t_phase
    emit({"phase": "gn", "part": "drive", **out["drive"], "seconds": out["seconds"]})
    check(two_way_gap["max_abs"] <= ASSOC_BOUND_M,
          f"gn: kernel and plain_gn drives {two_way_gap} apart on the two-orientation world")
    check(max(bench_gap["y_m"], bench_gap["z_m"]) <= ASSOC_BOUND_M,
          f"gn: kernel and plain_gn drives {bench_gap} apart on the bench's world")
    check_launched(drives[0]["launches_per_scan"], "gn drive", certified=True)
    check(drives[0]["launches_per_scan"]["gn_update"] == ROUNDS
          and drives[0]["launches_per_scan"]["certify_slack"] == ROUNDS - 1,
          f"gn drive: launches a scan {drives[0]['launches_per_scan']}")
    check_launched(drives[1]["launches_per_scan"], "gn plain drive",
                   BUILD_KERNELS + ASSOC_KERNELS)
    for name in GN_KERNELS:
        check(drives[1]["launches_per_scan"][name] == 0, f"gn plain drive: {name} was launched")
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
    check_launched(counts, "accuracy", certified=True)
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
           for k, pats in kernel_names().items()}
    return {
        "wall_ms_per_scan": wall_ms / n_scans,
        "device_busy_ms_per_scan": busy_ms / n_scans,
        "device_busy_share": busy_ms / wall_ms,
        "kernels_per_scan": sum(c for _, c in by_name.values()) / n_scans,
        "gemm_launches_per_scan": sum(c for k, (_, c) in by_name.items()
                                      if GEMM_NAME.search(k)) / n_scans,
        "kernel_ms_per_scan": own,
        "top_kernels": [{"name": k[:120], "ms_per_scan": ms / n_scans,
                         "launches_per_scan": c / n_scans} for k, (ms, c) in top],
    }


def phase_steady(torch) -> dict:
    from madicp_tpu_torch.bench import BenchSetup
    from madicp_tpu_torch.utils.timing import Trace, layer_ms

    setup = BenchSetup(DEV, N_POINTS, KEYFRAMES, DEPTH, MAX_LEAVES)
    scan_at = setup.scan_at
    pipe = setup.make_pipe("certified")
    # steady state: a full ring of 16 keyframes from staggered viewpoints
    setup.prime(pipe)

    n_warm, n_timed, n_phase = 3, 12, 4
    total = n_warm + n_timed + 2 * n_phase + 1
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

    pipe.trace = Trace(DEV)
    pipe.compute_device(0.1 * (lo + n_timed), *staged[lo + n_timed])  # the traced capture
    pipe.trace.drain()
    for i in range(lo + n_timed + 1, lo + n_timed + 1 + n_phase):
        pipe.compute_device(0.1 * i, *staged[i])
    per_phase = {k: ms / n_phase for k, ms in layer_ms(pipe.trace.drain()).items()}
    pipe.trace = None
    i0 = lo + n_timed + 1 + n_phase

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
           "phase_ms_per_scan": per_phase,
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
    check_launched(counts, "steady", certified=True)
    check(counts["gn_update"] == ROUNDS * n_timed
          and counts["certify_slack"] == (ROUNDS - 1) * n_timed,
          f"steady: {counts['gn_update']} gn_update and {counts['certify_slack']} "
          f"certify_slack launches in {n_timed} scans, want {ROUNDS} and {ROUNDS - 1} a scan")
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
        check_launched(r["kernel_launches"], spec, certified=certifies(spec))
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
    from madicp_tpu_torch.models.pipeline import StepOutput
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
                          "gemm_launches_per_scan": prof["gemm_launches_per_scan"],
                          "segsum_launches_per_scan": counts["segsum_moments"] / GRAPH_SCANS,
                          "launches_per_scan": {k: v / GRAPH_SCANS
                                                for k, v in counts.items()}}
        (capture_ms, nodes, replay_launches), = graphed._graphs.captured().values()
        pool = graphed._graphs.pool_bytes()
        scans = sorted(poses["eager"])
        diff = max(float((poses["graphed"][i] - poses["eager"][i]).abs().max()) for i in scans)
        g, e = side["graphed"], side["eager"]
        # a replay also runs its own copies: the scan's points and mask
        # into the static buffers, and a clone of each output tensor
        replay_io = 2 + len(StepOutput._fields)
        kernels_dev = (abs(g["kernels_per_scan"] - replay_io - e["kernels_per_scan"])
                       / e["kernels_per_scan"])
        rows[spec] = dict(side, capture_ms=capture_ms, nodes=nodes, pool_bytes=pool,
                          launches_a_replay=replay_launches, scans_compared=len(scans),
                          max_pose_dev_m=diff, kernels_rel_dev=kernels_dev,
                          speedup=g["scans_per_s"] / e["scans_per_s"])
        emit({"phase": "graphs", "part": "flagship", "schedule": spec,
              "nvidia_smi": nvidia_smi, **rows[spec]})
        check(diff <= GRAPH_BOUND_M, f"{spec}: graphed pose {diff:.2e} m from eager")
        # the association maps its own queries and the output leaves are
        # formed elementwise: a certified scan runs no library GEMM
        check(not certifies(spec) or g["gemm_launches_per_scan"] == 0,
              f"{spec}: {g['gemm_launches_per_scan']} GEMM launches a graphed scan")
        check(kernels_dev <= 0.01, f"{spec}: {g['kernels_per_scan']} kernels a graphed scan "
              f"({replay_io} of them the replay's copies), {e['kernels_per_scan']} eager")
        for name in side:
            check(side[name]["segsum_launches_per_scan"] == DEPTH + 1,
                  f"{spec} {name}: {side[name]['segsum_launches_per_scan']} segsum launches "
                  "a scan")
            check_launched(side[name]["launches_per_scan"], f"{spec} {name}",
                           certified=certifies(spec))
            per_scan = side[name]["launches_per_scan"]
            want = (ROUNDS, ROUNDS - 1 if certifies(spec) else 0)
            check((per_scan["gn_update"], per_scan["certify_slack"]) == want,
                  f"{spec} {name}: {per_scan['gn_update']} gn_update and "
                  f"{per_scan['certify_slack']} certify_slack launches a scan, want {want}")
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
    check_launched(counts, f"cli {argv}", certified=True)
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
        check_launched(demos["mad_registration"]["launches"], "mad_registration",
                       REGISTRATION_KERNELS)
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
            check_launched(side[name]["launches"], f"B={B} {name}", certified=True)
            check(side[name]["launches"]["gn_update"] == ROUNDS * n_timed,
                  f"B={B} {name}: {side[name]['launches']['gn_update']} gn_update launches in "
                  f"{n_timed} batched scans, want {ROUNDS} a batched scan")
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
    gn = phase_gn(torch, dev["nvidia_smi"])
    desk = phase_deskew(torch, dev["nvidia_smi"])
    tail = phase_tail(torch, dev["nvidia_smi"])
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
        if name == "descend":  # the form the step launches
            k = k["ring_round0"]
        rows.append({
            "name": name, "route": "cuda",
            "source": f"madicp_tpu_torch/kernels/csrc/{ASSOC_SOURCES[name]}.cu",
            "replaces": replaces, "launches": steady["launches"][name],
            **{key: k[key] for key in ("max_abs_err", "ms", "device_ms", "plain_ms",
                                       "bound_ms", "bound_by", "library_ms")},
            "library_device_ms": None,
        })
    for name, replaces in GN_REPLACES.items():
        k = gn["flagship"]["float32"]["B1"][name]
        rows.append({
            "name": name, "route": "cuda",
            "source": f"madicp_tpu_torch/kernels/csrc/{name}.cu",
            "replaces": replaces, "launches": steady["launches"][name],
            **{key: k[key] for key in ("max_abs_err", "ms", "device_ms", "plain_ms",
                                       "bound_ms", "bound_by", "library_ms")},
            "library_device_ms": None,
        })
    k = desk["kernel"]["float32"]["reference_B1"]  # the CLI's default mode, one sequence
    rows.append({
        "name": "deskew_sweep", "route": "cuda",
        "source": "madicp_tpu_torch/kernels/csrc/deskew.cu", "replaces": DESKEW_REPLACES,
        "launches": desk["mulran"]["main"]["deskew_launches"],
        **{key: k[key] for key in ("max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms",
                                   "bound_by", "library_ms")},
        "library_device_ms": None,
    })
    f32 = tail["kernel"]["float32"]["no_promote_B1"]  # a scan that does not promote
    for name, parts in (("step_scalars", ("predict", "tail")), ("ring_write", ("ring_write",))):
        rows.append({
            "name": name, "route": "cuda",
            "source": f"madicp_tpu_torch/kernels/csrc/{name}.cu",
            "replaces": TAIL_REPLACES[name], "launches": steady["launches"][name],
            "max_abs_err": f32["max_abs_err"],  # bit for bit
            # a step's launches: predict and tail for K14
            **{key: sum(f32[p][key] for p in parts)
               for key in ("ms", "device_ms", "plain_ms", "bound_ms")},
            "bound_by": f32[parts[-1]]["bound_by"], "library_ms": None,
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
