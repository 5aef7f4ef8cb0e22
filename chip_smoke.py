#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (madicp_tpu_torch) on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

Phases, each printed as one JSON line (any failed check raises and the
script exits non-zero without the final line):

1. device     card name and power limit (nvidia-smi);
2. build      nvcc builds every CUDA kernel from csrc/, all at once;
3. kernels    segsum_moments against its plain PyTorch version on the
              card, at the shapes and on the data of a flagship tree
              build (all 17 levels, float32 and float64), with kernel
              and library (each eager and in a CUDA graph), plain and bound
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
              with 16 trees: steady-state scans/s, per-phase ms from CUDA
              events, descents, kernel launches per scan.

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


def two_way_world(rng):
    """Ground plus walls in BOTH orientations (scripts/accuracy_probe.py):
    x translation is observable, unlike in kitti_like_world."""
    pts = [rng.uniform([-40, -40, -0.05], [40, 40, 0.05], (12000, 3))]
    for i in range(8):
        y = -35 + 10 * i + rng.uniform(-2, 2)
        pts.append(rng.uniform([-40, y - 0.03, 0], [40, y + 0.03, 6], (1800, 3)))
    for i in range(8):
        x = -35 + 10 * i + rng.uniform(-2, 2)
        pts.append(rng.uniform([x - 0.03, -40, 0], [x + 0.03, 40, 6], (1800, 3)))
    return np.concatenate(pts)


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


def capture_levels(points, valid):
    """(d, idx, sz) of every level of one build, as build_tree hands them
    to the segment-sum."""
    import madicp_tpu_torch.ops.tree as tree_mod

    seen = []
    real = tree_mod.segsum_moments

    def record(d, idx, sz):
        seen.append((d.clone(), idx.clone(), sz))
        return real(d, idx, sz)

    tree_mod.segsum_moments = record
    try:
        tree_mod.build_tree(points, valid, depth=DEPTH, b_max=0.2, b_min=0.1)
    finally:
        tree_mod.segsum_moments = real
    return seen


def phase_kernels(torch) -> dict:
    from madicp_tpu_torch.kernels import segsum
    from madicp_tpu_torch.utils.timing import bound_ms, event_ms, graph_ms

    rng = np.random.default_rng(0)
    R, t = bench_pose(3)
    scan = ((kitti_like_world(rng) - t) @ R)[:N_POINTS]
    pts = np.zeros((N_POINTS, 3))
    pts[: len(scan)] = scan
    valid = torch.zeros(N_POINTS, dtype=torch.bool, device=DEV)
    valid[: len(scan)] = True
    summary = {}
    for dtype in (torch.float32, torch.float64):
        dname = str(dtype).split(".")[1]
        levels = capture_levels(torch.as_tensor(pts, dtype=dtype, device=DEV), valid)
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
            ids = torch.where((idx >= 0) & (idx < sz), idx.long(), sz)
            mom = segsum._moment_columns(d)
            tab = torch.zeros((sz + 1, 10), dtype=dtype, device=DEV)
            ms = event_ms(lambda: segsum.segsum_moments(d, idx, sz), 20)
            device_ms = graph_ms(lambda: segsum.segsum_moments(d, idx, sz), 20)
            plain_ms = event_ms(lambda: segsum.segsum_moments_ref(d, idx, sz), 20)
            library_ms = event_ms(lambda: tab.index_add_(0, ids, mom), 20)
            library_device_ms = graph_ms(lambda: tab.index_add_(0, ids, mom), 20)
            n = d.shape[0]
            bound, by = bound_ms(n * (3 * esize + 4) + sz * 10 * esize,
                                 n * SEGSUM_FLOPS_PER_POINT, dname)
            bound_by.add(by)
            row = {"sz": sz, "ms": ms, "device_ms": device_ms, "plain_ms": plain_ms,
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
    kw = dict(num_keyframes=3, n_points=8192, depth=12, max_leaves=4096)
    for dtype in (torch.float64, torch.float32):
        for certify in (True, False):
            pipe = pipeline(dtype=dtype, certify=certify, **kw)
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
    from madicp_tpu_torch.kernels import segsum
    from madicp_tpu_torch.ops.tree import build_tree, transform_tree
    from madicp_tpu_torch.utils.timing import PHASES, PhaseTimer

    rng = np.random.default_rng(0)
    world = kitti_like_world(rng)

    def scan_at(i):
        R, t = bench_pose(i)
        return ((world - t) @ R + rng.normal(0, 0.008, world.shape)).astype(np.float32)

    pipe = pipeline(num_keyframes=KEYFRAMES, n_points=N_POINTS,
                    depth=DEPTH, max_leaves=MAX_LEAVES)
    pipe.compute(0.0, scan_at(0))
    # steady state: a full ring of 16 keyframes from staggered viewpoints
    for k in range(KEYFRAMES):
        pts, valid, _ = pipe.stage(scan_at(k - KEYFRAMES))
        tree, _ = build_tree(pts, valid, depth=DEPTH, b_max=0.2, b_min=0.1)
        R, t = bench_pose(k - KEYFRAMES)
        moved = transform_tree(tree, torch.as_tensor(R, dtype=torch.float32, device=DEV),
                               torch.as_tensor(t, dtype=torch.float32, device=DEV))
        pipe.state.kf_tree.nav[k].copy_(moved.nav)
    pipe.state = pipe.state._replace(
        kf_valid=torch.ones(KEYFRAMES, dtype=torch.bool, device=DEV))

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
