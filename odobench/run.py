"""One run of one cell: ``python3 -m odobench --workload <name> --seed <n>
--seconds <s> --trace <0|1>`` from the root of a checkout.

Set-up makes one lap of scans from the seed (``traffic.py``), builds the
program's pipeline (``Pipeline``) or fleet (``Fleet``) of the cell's
configuration, primes its keyframe ring with trees of the scans before
the drive at their true poses, and warms up every shape the window uses
(the first scans build the kernels and capture the step's graph). The
window then drives the loop users run for ``--seconds``:

- ``cli``: the CLI's loop with ``--no-prefetch`` (``apps/cli.py:215-255``):
  each of the lap's host scans staged by ``Pipeline.stage``, then
  ``compute_device``, ``current_pose`` and the accessors the CLI reads,
  scan after scan;
- ``fleet``: ``apps/fleet_eval.py:197-215``: the batch padded on the host,
  ``Fleet.compute``, ``Fleet.poses``, step after step.

With ``--trace 1`` a short sub-window follows under ``torch.profiler``.
Once the window has closed and the program's state is freed, the plain
reference (``reference.py``, float64) follows the same drive from its own
primed ring over the set-up's scans and the window's first scans; every
step of the window is held against the drive's known motion; and
``correct`` holds each compared number to its limit (``limits/``).

The last line of standard output is the result's JSON; the lines before
it on standard error say what was run, dropped and compared.
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import re
import statistics
import subprocess
import sys
import time
from dataclasses import dataclass, field

import numpy as np

from odobench import reference, traffic
from odobench import trace as trace_mod
from odobench.loader import Loader

WARM_SCANS = 4       # bootstrap aside: eager warm-up, capture, then replays
TRACE_STEPS = {"cli": 30, "fleet": 10}
TRACE_ATTEMPTS = 3
FORBIDDEN = ("jax", "jaxlib", "flax", "madicp_tpu")
NO_POSE_M = 1e9  # the translation gap read where a pose is not finite


def log(**kw) -> None:
    print(json.dumps(kw), file=sys.stderr, flush=True)


def process_age_s() -> float:
    """Seconds since this process started (``/proc``: the start tick
    against the uptime)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def card_power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60).stdout.splitlines()
    except OSError:
        out = []
    return out[0].strip() if out else "unavailable"


@dataclass
class Run:
    """What a run measured, for the metric readers."""

    workload: str
    config: dict
    batch: int
    dtype: str = "float32"
    setup_s: float = 0.0
    window_s: float = 0.0
    scans: int = 0                 # sequence-scans completed in the window
    latency_ms: list = field(default_factory=list)   # every window scan's
    stage_ms: list = field(default_factory=list)     # every window step's
    enqueue_ms: list = field(default_factory=list)   # every window step's
    wait_ms: list = field(default_factory=list)      # every window step's
    trace: dict = None             # the profiled sub-window
    trace_steps: int = 0
    layers_us: dict = field(default_factory=dict)
    build_stats: list = None
    leaves: float = 0.0            # a scan's leaves, the reference's mean

    def layer_ms(self, layer):
        """Device ms a step of the kernels placed in ``layer`` (None: the
        unplaced ones) in the traced sub-window; None without a trace or
        where the layer ran nothing."""
        if not self.trace or not self.trace_steps or layer not in self.layers_us:
            return None
        return self.layers_us[layer] / 1e3 / self.trace_steps


# ----------------------------------------------------------- the program --
def pipeline_kwargs(config: dict) -> dict:
    """The program's pipeline settings of a configuration."""
    import torch

    a = config["assumed"]
    return dict(
        sensor_hz=config["sensor_hz"], deskew=config["deskew"], b_max=config["b_max"],
        rho_ker=config["rho_ker"], p_th=config["p_th"], b_min=config["b_min"],
        b_ratio=config["b_ratio"], num_keyframes=config["num_keyframes"],
        n_points=a["n_points"], depth=a["depth"], max_leaves=a["max_leaves"],
        dtype=getattr(torch, config["dtype"]), deskew_mode=config["deskew_mode"],
        certify=config["schedule"] == "certified")


def make_pipeline(config: dict, device):
    from madicp_tpu_torch.models.pipeline import Pipeline

    return Pipeline(**pipeline_kwargs(config), device=device)


def make_fleet(config: dict, batch: int, device):
    from madicp_tpu_torch.models.pipeline import PipelineConfig
    from madicp_tpu_torch.parallel.fleet import Fleet

    kw = pipeline_kwargs(config)
    kw.update(sensor_hz=float(kw["sensor_hz"]), b_max=float(kw["b_max"]),
              rho_ker=float(kw["rho_ker"]), p_th=float(kw["p_th"]),
              b_min=float(kw["b_min"]), b_ratio=float(kw["b_ratio"]))
    return Fleet(PipelineConfig(**kw), batch, device=device)


def primed_trees(cfg, kf_scans, kf_poses, device):
    """The program's trees of the priming scans at their poses
    (``madicp_tpu_torch/bench.py:148`` ``BenchSetup.prime``)."""
    import torch

    from madicp_tpu_torch.ops.tree import build_tree, transform_tree

    out = []
    for pts_np, T_np in zip(kf_scans, kf_poses):
        n = len(pts_np)
        pts = torch.zeros((cfg.n_points, 3), dtype=cfg.dtype, device=device)
        pts[:n] = torch.as_tensor(pts_np, device=device)
        valid = torch.arange(cfg.n_points, device=device) < n
        tree, _ = build_tree(pts, valid, depth=cfg.depth, b_max=cfg.b_max, b_min=cfg.b_min)
        T = torch.as_tensor(T_np, dtype=cfg.dtype, device=device)
        out.append(transform_tree(tree, T[:3, :3], T[:3, 3]).nav)
    return out


class Counting:
    """Launches of the program's kernels (its counters) and replays of
    captured graphs while active."""

    def __init__(self):
        import torch

        from madicp_tpu_torch.models.step_graph import COUNTERS

        self.counters = COUNTERS
        self.replays = 0
        self._real = torch.cuda.CUDAGraph.replay
        counting = self

        def replay(graph):
            counting.replays += 1
            return counting._real(graph)

        torch.cuda.CUDAGraph.replay = replay

    def snapshot(self) -> dict:
        return {name: c.launches for name, c in self.counters.items()}

    def close(self) -> None:
        import torch

        torch.cuda.CUDAGraph.replay = self._real


class Recorder:
    """Each step's host times and the program's answers."""

    def __init__(self, batch: int):
        self.B = batch
        self.t0, self.tc, self.t1, self.t2, self.stage = [], [], [], [], []
        self.poses, self.ratios, self.flags, self.dropped = [], [], [], []

    def add(self, t0, tc, t1, t2, stage_s, pose, ratio, flag, dropped) -> None:
        """``t0`` the scan handed to the program, ``tc`` its step called,
        ``t1`` the call returned, ``t2`` the pose on the host."""
        self.t0.append(t0)
        self.tc.append(tc)
        self.t1.append(t1)
        self.t2.append(t2)
        self.stage.append(stage_s)
        self.poses.append(np.asarray(pose, np.float64).reshape(self.B, 4, 4))
        self.ratios.append(np.asarray(ratio, np.float64).reshape(self.B))
        self.flags.append(np.asarray(flag, bool).reshape(self.B))
        self.dropped.append(np.asarray(dropped, np.int64).reshape(self.B))


def span(marks: bool, name: str):
    if not marks:
        return contextlib.nullcontext()
    from torch.profiler import record_function

    return record_function(name)


class CliLoop:
    """The CLI's loop over one sequence with ``--no-prefetch``
    (``apps/cli.py:215-255``): each scan staged by the call itself."""

    def __init__(self, config, lap, offsets, prime, device):
        import torch

        self.pipe = pipe = make_pipeline(config, device)
        self.lap, self.k = lap, 1
        pipe.compute(0.0, lap[offsets[0] % len(lap)])  # the bootstrap scan
        for k, nav in enumerate(primed_trees(pipe.cfg, *prime[0], device)):
            pipe.state.kf_tree.nav[k].copy_(nav)
        K = pipe.cfg.num_keyframes
        pipe.state = pipe.state._replace(kf_valid=torch.ones(K, dtype=torch.bool, device=device))

    def step(self, rec: Recorder, marks=False) -> None:
        pipe, k = self.pipe, self.k
        self.k += 1
        t0 = time.perf_counter()
        with span(marks, "odobench.stage"):
            item = (0.1 * k, *pipe.stage(self.lap[k % len(self.lap)]))
        tc = time.perf_counter()
        with span(marks, "odobench.compute_device"):
            pipe.compute_device(*item)
        t1 = time.perf_counter()
        with span(marks, "odobench.current_pose"):
            pose = pipe.current_pose()  # waits for the device
        t2 = time.perf_counter()
        with span(marks, "odobench.accessors"):
            ratio, flag, dropped = pipe.inlier_ratio(), pipe.is_map_updated(), pipe.leaves_dropped()
        rec.add(t0, tc, t1, t2, tc - t0, pose, ratio, flag, dropped)

    def free(self) -> None:
        del self.pipe


class FleetLoop:
    """``apps/fleet_eval.py:197-215``: B sequences stepped as one batch."""

    def __init__(self, config, lap, offsets, prime, device):
        import torch

        B = len(offsets)
        self.fleet = make_fleet(config, B, device)
        self.lap, self.offsets, self.i = lap, offsets, 1
        cfg = self.fleet.cfg
        self.N = cfg.n_points
        self.fleet.compute(np.zeros(B), *self._pad(0))
        st = self.fleet.states
        for s in range(B):
            for k, nav in enumerate(primed_trees(cfg, *prime[s], device)):
                st.kf_tree.nav[s, k].copy_(nav)
        self.fleet.states = st._replace(
            kf_valid=torch.ones((B, cfg.num_keyframes), dtype=torch.bool, device=device))

    def _pad(self, i):
        B, S = len(self.offsets), len(self.lap)
        pts = np.zeros((B, self.N, 3), np.float32)
        val = np.zeros((B, self.N), bool)
        for s, o in enumerate(self.offsets):
            cloud = self.lap[(o + i) % S]
            n = min(len(cloud), self.N)
            pts[s, :n] = cloud[:n]
            val[s, :n] = True
        return pts, val

    def step(self, rec: Recorder, marks=False) -> None:
        B = len(self.offsets)
        ts = time.perf_counter()
        with span(marks, "odobench.pad"):
            stamps = np.full(B, 0.1 * self.i)
            pts, val = self._pad(self.i)
        t0 = time.perf_counter()
        with span(marks, "odobench.compute_device"):
            out = self.fleet.compute(stamps, pts, val)
        t1 = time.perf_counter()
        with span(marks, "odobench.current_pose"):
            poses = self.fleet.poses()
        t2 = time.perf_counter()
        with span(marks, "odobench.accessors"):
            ratio, flag = out.inlier_ratio.cpu().numpy(), out.map_updated.cpu().numpy()
            dropped = out.n_leaves_dropped.cpu().numpy()
        rec.add(t0, t0, t1, t2, t0 - ts, poses, ratio, flag, dropped)
        self.i += 1

    def free(self) -> None:
        del self.fleet


# -------------------------------------------------------------- the check --
def rotation_gap(Ra, Rb) -> float:
    """The angle of ``Ra^T Rb`` from its skew part (``sin`` of the angle):
    well conditioned near the identity, where the trace's ``arccos`` turns
    a float32 matrix's departure from orthonormality (~1e-7) into ~3e-4."""
    M = Ra.T @ Rb
    w = 0.5 * np.array([M[2, 1] - M[1, 2], M[0, 2] - M[2, 0], M[1, 0] - M[0, 1]])
    return float(np.arcsin(min(1.0, np.linalg.norm(w))))


def step_gaps(poses, D) -> dict:
    """How each step of ``poses`` (n, B, 4, 4; consecutive scans of B
    sequences) departs from the drive's motion ``D`` a scan: the largest
    and the mean translation gap (m) over every step of every sequence,
    the step of the largest, and the largest rotation gap (rad);
    NO_POSE_M where a pose is not finite."""
    P = np.asarray(poses, np.float64)
    if len(P) < 2:
        return {"step_gap_m": 0.0, "step_gap_mean_m": 0.0, "step_rot_rad": 0.0, "step_gap_at": 0}
    if not np.isfinite(P).all():
        return {"step_gap_m": NO_POSE_M, "step_gap_mean_m": NO_POSE_M,
                "step_rot_rad": NO_POSE_M, "step_gap_at": 0}
    rel = np.linalg.solve(P[:-1], P[1:])  # T_k^-1 T_k+1
    trans = np.linalg.norm(rel[..., :3, 3] - D[:3, 3], axis=-1)
    M = np.swapaxes(rel[..., :3, :3], -1, -2) @ D[:3, :3]
    w = 0.5 * np.stack([M[..., 2, 1] - M[..., 1, 2], M[..., 0, 2] - M[..., 2, 0],
                        M[..., 1, 0] - M[..., 0, 1]], -1)
    rot = np.arcsin(np.minimum(1.0, np.linalg.norm(w, axis=-1)))
    return {"step_gap_m": float(trans.max()), "step_gap_mean_m": float(trans.mean()),
            "step_rot_rad": float(rot.max()), "step_gap_at": int(trans.max(-1).argmax())}


def check(rec: Recorder, n_check: int, lap, prime, offsets, config, limits, device,
          window: slice, D, sequences=None) -> dict:
    """The reference over the first ``n_check`` odometry scans of each of
    ``sequences`` (all by default) against the program's answers, and
    every step of the ``window`` against the drive's motion ``D``;
    returns each compared number beside its limit."""
    P = reference.Params.of(config)
    S = len(lap)
    trans = rot = ratio_gap = 0.0
    mismatches, ties, stats, per_scan, leaves = 0, 0, None, [], []
    seconds = {"build": 0.0, "rounds": 0.0}
    for s in range(len(offsets)) if sequences is None else sequences:
        o = offsets[s]
        odo = reference.Odometry(P, device)
        odo.bootstrap(lap[o % S])
        odo.prime(*prime[s])
        for j in range(n_check):
            r = odo.step(lap[(o + 1 + j) % S], promote_hint=bool(rec.flags[j][s]),
                         margin=limits["tie_margin"])
            pose, ratio, flag = rec.poses[j][s], rec.ratios[j][s], rec.flags[j][s]
            ties += r["tie"]
            leaves.append(r["leaves"] - r["leaves_dropped"])
            if not np.isfinite(pose).all():
                trans = NO_POSE_M
                continue
            t_gap = float(np.linalg.norm(pose[:3, 3] - r["pose"][:3, 3]))
            r_gap = rotation_gap(pose[:3, :3], r["pose"][:3, :3])
            gap = abs(float(ratio) - r["ratio"])
            # within the tie margin the reference took the program's decision
            mismatches += int(bool(flag) != r["promote"])
            trans, rot, ratio_gap = max(trans, t_gap), max(rot, r_gap), max(ratio_gap, gap)
            per_scan.append((s, j + 1, t_gap, r_gap, gap, bool(flag), r["ratio"]))
        for k in seconds:
            seconds[k] += odo.seconds[k]
        stats = stats or r["stats"]
    bad = sum(int(not np.isfinite(p).all()) for p in rec.poses[window])
    if bad:
        trans = NO_POSE_M
    readings = {"trans_gap_m": trans, "rot_gap_rad": rot, "ratio_gap": ratio_gap,
                "promote_mismatches": mismatches, **step_gaps(rec.poses[window], D)}
    return {"readings": readings,
            "numbers": {k: (readings[k], lim) for k, lim in limits["limits"].items()},
            "ties": ties, "nonfinite_window_poses": bad, "build_stats": stats,
            "leaves": float(np.mean(leaves)) if leaves else 0.0,
            "per_scan": per_scan, "reference_step_s": seconds}


# ------------------------------------------------------------------ a run --
def prime_scans(drive, lap, offsets, K, device) -> list:
    """Each sequence's priming scans (unskewed: a map built earlier) and
    their poses in the frame of the sequence's first scan."""
    out = []
    for o in offsets:
        ks = [o - K + k for k in range(K)]
        scans = [lap[k % drive.S] if not drive.skew else
                 drive.scan(k, device, skew=False).float().cpu().numpy() for k in ks]
        out.append((scans, [drive.truth(k - o) for k in ks]))
    return out


def cell_inputs(loader: Loader, workload: str, seed: int, device) -> tuple:
    """A cell's configuration, traffic and limits, and its drive from the
    seed: the lap's host scans, each sequence's first scan in the lap,
    each sequence's priming scans and poses, and the motion a scan."""
    w = loader.workload(workload)
    config, traf = loader.config(w["config"]), loader.traffic(w["traffic"])
    limits = loader.limits(workload)
    drive = traffic.make_drive(config, traf, int(seed) % (1 << 63))
    lap = drive.lap(device)
    B = int(traf["sequences"])
    offsets = [s * drive.S // B for s in range(B)]
    prime = prime_scans(drive, lap, offsets, int(config["num_keyframes"]), device)
    return config, traf, limits, lap, offsets, prime, drive.step


def run_cell(workload: str, seed: int, seconds: float, traced: bool, device="cuda",
             loader: Loader = None, n_check=None) -> dict:
    """One run of ``workload``; returns the result's fields and what the
    earlier lines say. ``device`` "cpu" serves the harness's own tests."""
    import torch

    loader = loader or Loader()
    t_set = time.perf_counter()
    config, traf, limits, lap, offsets, prime, D = cell_inputs(loader, workload, seed, device)
    cuda = torch.device(device).type == "cuda"
    B = len(offsets)
    parts = {"lap_s": time.perf_counter() - t_set}
    Loop = {"cli": CliLoop, "fleet": FleetLoop}[traf["loop"]]
    run = Run(workload, config, B, config["dtype"])
    rec = Recorder(B)
    counting = Counting() if cuda else None
    n_check = int(limits["reference_scans"]) if n_check is None else n_check
    extra = {}
    try:
        t_set = time.perf_counter()
        cell_loop = Loop(config, lap, offsets, prime, device)
        parts["program_s"] = time.perf_counter() - t_set
        t_set = time.perf_counter()
        for _ in range(WARM_SCANS):
            cell_loop.step(rec)
        if cuda:
            torch.cuda.synchronize()
        parts["warm_s"] = time.perf_counter() - t_set
        extra["setup_parts"] = parts
        start = len(rec.t0)
        run.setup_s = process_age_s()
        c0 = counting.snapshot() if cuda else {}
        r0 = counting.replays if cuda else 0
        t_begin = time.perf_counter()
        while time.perf_counter() - t_begin < seconds or len(rec.t0) - start < n_check:
            cell_loop.step(rec)
        t_end = time.perf_counter()
        stop = len(rec.t0)
        steps = stop - start
        if cuda:
            c1 = counting.snapshot()
            extra["launches_per_scan"] = {k: (c1[k] - c0[k]) / steps for k in c1}
            extra["window_steps_without_replay"] = steps - (counting.replays - r0)
        if traced:
            best = None
            for _ in range(TRACE_ATTEMPTS if cuda else 0):
                n = TRACE_STEPS[traf["loop"]]
                before = counting.snapshot()
                got = trace_mod.profile(lambda n=n: [cell_loop.step(rec, marks=True)
                                                     for _ in range(n)])
                after = counting.snapshot()
                lost = lost_records(got, loader, {k: after[k] - before[k] for k in after})
                if best is None or lost < best[0]:
                    best = (lost, got, n)
                if not lost:
                    break
            if best is not None:
                extra["trace_lost_records"] = best[0]
                run.trace, run.trace_steps = best[1], best[2]
        window = slice(start, stop)
        run.window_s = t_end - t_begin
        run.scans = steps * B
        lat = [(b - a) * 1e3 for a, b in zip(rec.t0[window], rec.t2[window])]
        run.latency_ms = [x for x in lat for _ in range(B)]
        run.stage_ms = [x * 1e3 for x in rec.stage[window]]
        run.enqueue_ms = [(b - a) * 1e3 for a, b in zip(rec.tc[window], rec.t1[window])]
        run.wait_ms = [(b - a) * 1e3 for a, b in zip(rec.t1[window], rec.t2[window])]
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        cell_loop.free()
        del cell_loop
    finally:
        if counting is not None:
            counting.close()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    found = forbidden_modules()  # the window has closed
    dropped = np.concatenate([d for d in rec.dropped[window]]) if steps else np.zeros(1)
    extra["leaves_dropped"] = {"min": int(dropped.min()), "max": int(dropped.max()),
                               "mean": float(dropped.mean())}
    extra["window_promotions"] = int(sum(f.sum() for f in rec.flags[window]))
    t_ref = time.perf_counter()
    result = check(rec, n_check, lap, prime, offsets, config, limits, device, window, D,
                   checked_sequences(B, seed))
    extra["reference_s"] = time.perf_counter() - t_ref
    extra["reference_step_s"] = result["reference_step_s"]
    extra["reference_scans"] = n_check * len(checked_sequences(B, seed))
    if traced and run.trace is not None:
        run.layers_us = trace_mod.classify(
            [r for r in run.trace["device"] if within(r, run.trace["window"])],
            loader.kernel_layers())
        run.build_stats, run.leaves = result["build_stats"], result["leaves"]
    return dict(run=run, rec=rec, window=window, peak=peak, forbidden=found, check=result,
                extra=extra)


def checked_sequences(B: int, seed: int) -> list:
    """The sequences the reference follows: every one of up to two, else
    one drawn from each half of the batch."""
    if B <= 2:
        return list(range(B))
    rng = np.random.default_rng([int(seed) % (1 << 63), 11])
    return [int(rng.integers(0, B // 2)), int(rng.integers(B // 2, B))]


def forbidden_modules() -> list:
    """The loaded modules whose top-level name, compared whole, is JAX's
    or the JAX package's (the port's own name begins with the latter)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def is_correct(numbers: dict) -> bool:
    """Every compared number within its limit."""
    return all(v <= lim for v, lim in numbers.values())


def within(record, window) -> bool:
    return record[2] > window[0] and record[1] < window[1]


def lost_records(got: dict, loader: Loader, launched: dict) -> int:
    """How many of the launches the program's counters counted in the
    profiled steps have no device record (each ``kernels/*.json`` with a
    ``counter`` names the counter that counts its kernels)."""
    lost = 0
    for path in sorted((loader.root / "kernels").glob("*.json")):
        entry = json.loads(path.read_text())
        if "counter" not in entry:
            continue
        rx = re.compile(entry["pattern"])
        seen = sum(1 for name, _, _ in got["device"] if rx.search(name))
        lost += max(0, launched.get(entry["counter"], 0) - seen)
    return lost


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="python3 -m odobench", description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    loader = Loader()
    w = loader.workload(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(w["chips"]):
        print(f"odobench: {args.workload} needs {w['chips']} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    log(card=card_power_limit(), torch=torch.__version__, cuda=torch.version.cuda,
        workload=args.workload, seed=args.seed, seconds=args.seconds, trace=args.trace)
    if out["forbidden"]:
        print(f"odobench: the run loaded {out['forbidden']}, which the port must not",
              file=sys.stderr)
        return 3
    run, extra, chk = out["run"], out["extra"], out["check"]
    lat = sorted(run.latency_ms)
    log(scans=run.scans, window_s=run.window_s, latency_ms={
        "median": statistics.median(lat), "p95": float(np.percentile(lat, 95)), "n": len(lat)},
        host_median_ms={"stage": statistics.median(run.stage_ms),
                        "enqueue": statistics.median(run.enqueue_ms),
                        "wait": statistics.median(run.wait_ms)})
    log(**extra)
    if run.trace is not None:
        names: dict = {}
        pats = loader.kernel_layers()
        for name, a, b in run.trace["device"]:
            lay = next((la for rx, la in pats if rx.search(name)), None)
            key = (name[:160], lay)
            cnt, us = names.get(key, (0, 0.0))
            names[key] = (cnt + 1, us + b - a)
        log(kernels=[[n, lay, c, us / run.trace_steps]
                     for (n, lay), (c, us) in sorted(names.items(), key=lambda kv: -kv[1][1])])
        log(layers_ms_per_step={str(k): v / 1e3 / run.trace_steps
                                for k, v in run.layers_us.items()},
            trace_steps=run.trace_steps)
    metrics = {}
    for m in loader.metrics(args.workload, bool(args.trace)):
        value = loader.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
              "memory_peak_bytes": int(out["peak"])}
    result = {"correct": False, "attempted": run.scans,
              "failed": chk["nonfinite_window_poses"] * run.batch, "metrics": metrics,
              "device": device}
    if run.trace is not None:
        records = [r for r in run.trace["device"] if within(r, run.trace["window"])]
        win = run.trace["window"]
        device["busy_s"] = trace_mod.busy_us(records, win) * 1e-6
        device["window_s"] = (win[1] - win[0]) * 1e-6
        result["breakdown"] = {
            "device_ops": trace_mod.top_ops(records, win),
            "idle_gaps": trace_mod.idle_gaps(records, run.trace["spans"], win)}
    numbers = chk["numbers"]
    result["correct"] = is_correct(numbers)
    log(readings=chk["readings"], reference_ties=chk["ties"], per_scan=[
        dict(seq=s, scan=j, trans_gap_m=t, rot_gap_rad=r, ratio_gap=g, promoted=f, ratio=q)
        for s, j, t, r, g, f, q in chk["per_scan"]])
    for name, (v, lim) in numbers.items():
        print(f"check {name} {v!r} limit {lim!r}", file=sys.stderr)
    result["check"] = {name: {"value": v, "limit": lim} for name, (v, lim) in numbers.items()}
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
