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
              of 4 compute_device calls; then all five schedules at the
              flagship configuration through the bench module
              (python -m madicp_tpu_torch.bench) in short windows: scans/s,
              descents, phase ms, peak memory, segment-sum launches;
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

Then the line {"kernels": [...]} (all five kernels: segsum_moments per
flagship build with its main-path launches, the probe kernels summed
over one probe pass with the probe's launches), the nvidia-smi line, and last
{"ok": true, "device": {...}}. Imports nothing of JAX or of the JAX
package; the golden file is read with numpy. Needs one card.

Phase 7 ends with a torch.profiler window of steady-state scans: device
kernel time by kernel name, and the device's busy share.
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


def phase_accuracy(torch) -> None:
    from madicp_tpu_torch.kernels import segsum

    rng = np.random.default_rng(7)
    world = two_way_world(rng)
    pipe = pipeline(num_keyframes=KEYFRAMES, n_points=N_POINTS,
                    depth=DEPTH, max_leaves=MAX_LEAVES)
    errs = []
    segsum.counter.launches = 0
    for k in range(12):
        p = world - np.array([0.3 * k, 0.0, 0.0])
        r = np.linalg.norm(p, axis=1)
        pipe.compute(0.1 * k, p[(r > 1.0) & (r < 80.0)])
        errs.append(abs(float(pipe.current_pose()[0, 3]) - 0.3 * k))
    launches = segsum.counter.launches
    worst = max(errs[1:])  # scan 0 is the identity bootstrap
    emit({"phase": "accuracy", "scans": 12, "step_m": 0.3,
          "per_scan_x_err_mm": [e * 1e3 for e in errs], "max_err_mm": worst * 1e3,
          "bound_mm": 10.0, "inlier_ratio": pipe.inlier_ratio(),
          "segsum_launches": launches})
    check(launches == 12 * (DEPTH + 1), f"segsum launched {launches} times in 12 scans")
    check(worst <= 0.01, f"flagship motion error {worst * 1e3:.2f} mm > 10 mm")


def profile_window(run, n_scans: int) -> dict:
    """Device time by CUDA kernel name and the device's busy share over
    ``run()`` (``n_scans`` scans), from torch.profiler."""
    from madicp_tpu_torch.utils.timing import device_kernels

    by_us, wall_ms = device_kernels(run)
    by_name = {k: (us / 1e3, cnt) for k, (us, cnt) in by_us.items()}
    busy_ms = sum(ms for ms, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:25]
    return {
        "wall_ms_per_scan": wall_ms / n_scans,
        "device_busy_ms_per_scan": busy_ms / n_scans,
        "device_busy_share": busy_ms / wall_ms,
        "kernels_per_scan": sum(c for _, c in by_name.values()) / n_scans,
        "top_kernels": [{"name": k[:120], "ms_per_scan": ms / n_scans,
                         "launches_per_scan": c / n_scans} for k, (ms, c) in top],
    }


def phase_steady(torch) -> dict:
    from madicp_tpu_torch.bench import BenchSetup
    from madicp_tpu_torch.kernels import segsum
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

    segsum.counter.launches = 0  # the main path's run starts here
    lo = 1 + n_warm
    poses, descents, n_leaves = [], [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(lo, lo + n_timed):
        pipe.compute_device(0.1 * i, *staged[i])
        descents.append(pipe._last.n_descents)
        n_leaves.append(pipe._last.n_leaves)
        poses.append(pipe.state.X)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = segsum.counter.launches  # read right after the run
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
           "segsum_launches": launches, "peak_mem_gb": peak_gb,
           "profile": prof}
    emit(out)
    check(np.isfinite(poses).all(), "non-finite poses")
    check(all(d < 15 * KEYFRAMES * n for d, n in zip(descents, n_leaves)),
          "certified schedule walked every descent: the certificate did nothing")
    check(launches == n_timed * (DEPTH + 1),
          f"segsum launched {launches} times in {n_timed} scans, want {DEPTH + 1} a scan")
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
    from madicp_tpu_torch.kernels import segsum

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
    emit({"phase": "schedules", "part": "compute_batch", "scans": 4, "max_dt_m": dt,
          "bound_m": 1e-6})
    check(batch.shape == (4, 4, 4) and dt <= 1e-6, f"compute_batch {dt:.2e} m from compute_device")

    setup = bench.BenchSetup(DEV, N_POINTS, KEYFRAMES, DEPTH, MAX_LEAVES)
    n_windows, n_steps = 3, 4
    flagship = {}
    for spec in ["certified"] + [s for s in bench.SCHEDULES if s != "certified"]:
        r = bench.run_schedule(setup, spec, n_warmup=2, n_steps=n_steps, n_windows=n_windows)
        flagship[spec] = r
        want = n_windows * n_steps * (DEPTH + 1)
        check(r["segsum_launches"] == want,
              f"{spec}: segsum launched {r['segsum_launches']} times, want {want}")
        torch.cuda.empty_cache()
    out = {"phase": "schedules", "part": "flagship", "config": {
        "n_points": N_POINTS, "depth": DEPTH, "keyframes": KEYFRAMES,
        "max_leaves": MAX_LEAVES, "rounds": 15, "dtype": "float32",
        "windows": n_windows, "scans_a_window": n_steps},
        "schedules": flagship, "seconds": time.perf_counter() - t0}
    emit(out)
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
    from madicp_tpu_torch.kernels import segsum

    out = io.StringIO()
    segsum.counter.launches = 0  # this run starts here
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cli.main([str(a) for a in argv])
    seconds = time.perf_counter() - t0
    launches = segsum.counter.launches  # read right after the run
    check(rc == 0, f"cli {argv} returned {rc}:\n{out.getvalue()[-2000:]}")
    scans = [(float(r), float(o)) for r, o in re.findall(
        r"^scan +\d+ +read +([\d.]+) ms +odometry +([\d.]+) ms", out.getvalue(), re.M)]
    check(launches > 0, f"cli {argv}: no segment-sum launch")
    rate = re.search(r"^(\d+) scans after the first in ([\d.]+) s: ([\d.]+) scans/s$",
                     out.getvalue(), re.M)
    check(rate is not None and int(rate.group(1)) == len(scans) - 1,
          f"cli {argv}: no rate line for its {len(scans)} scans")
    # the first scan of a run bootstraps (or resumes) and warms up
    steady = scans[1:]
    return {"scans": len(scans), "seconds": seconds, "segsum_launches": launches,
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
    from madicp_tpu_torch.kernels import segsum
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
        segsum.counter.launches = 0
        nn_err = nn_search.main(device=DEV)
        demos["nn_search"] = {"segsum_launches": segsum.counter.launches}
        np.random.seed(42)  # the demo's cloud, rounded as its float32 tree holds it
        cloud = generate_four_walls_pointcloud(points_per_wall=2000)
        rounding = float(np.sum(np.linalg.norm(
            cloud.astype(np.float32).astype(np.float64) - cloud, axis=1)))
        demos["nn_search"].update(error=nn_err, float32_rounding=rounding)
        check(nn_err == rounding, f"nn_search: error {nn_err} is not the cloud's "
              f"float32 rounding {rounding}: a query matched another point")
        segsum.counter.launches = 0
        T = mad_registration.main(device=DEV)
        demos["mad_registration"] = {"segsum_launches": segsum.counter.launches,
                                     "max_abs_dev_from_identity": float(np.abs(T - np.eye(4)).max())}
        check(np.allclose(T, np.eye(4), atol=5e-3), f"mad_registration: {T}")
        for name, d in demos.items():
            check(d["segsum_launches"] > 0, f"{name}: no segment-sum launch")
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
    probe = phase_probe(torch)
    phase_precision(torch)
    phase_golden(torch)
    phase_accuracy(torch)
    steady = phase_steady(torch)
    phase_schedules(torch)
    phase_apps(torch, dev["nvidia_smi"])

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
