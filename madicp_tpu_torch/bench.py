"""Headline benchmark of the port: full-pipeline odometry throughput on one card.

Counterpart of the JAX package's ``bench.py`` (its lines 60-317): the same
flagship configuration — KITTI-scale padded scans (131072 points), depth
16, ``num_keyframes=16``, 32768 leaves, all 15 GN rounds a scan, float32 —
on the same synthetic KITTI-like world, the same schedule specs, knobs and
last JSON line, for every association schedule in one process, so their
numbers compare:

  exact        every GN round re-associates every leaf against every
               keyframe (``pipeline.cpp:166-193``);
  certified    the same, with provably unchanged descents parked
               (``PipelineConfig.certify``; the shipped default);
  compact:<U>  certified, each keyframe's uncertified leaves descended
               through a buffer of U (``certify_compact``);
  prefix:<U>   prefix-certified, U-entry prefix buffers
               (``certify_prefix``);
  fast[:<k>]   cached associations, re-descended every k-th round
               (``assoc_mode="fast"``, default k = 7).

The headline (``value``) is the schedule the shipped ``PipelineConfig``
defaults select. Steady state: each schedule gets its own pipeline whose
keyframe ring is prefilled with 16 trees from staggered viewpoints (the
step updates the rings in place, so pipelines never share one), and its
scans are staged on the device before the timed windows. ``vs_baseline``
is scans/s over the reference's 10 Hz anytime-realtime sensor rate
(``pipeline.cpp:62,167``), as in ``bench.py``. Each schedule reports every
window's rate and their median beside the best (``scans_per_sec``, the
JSON ``value``, as in ``bench.py``), its descents (the last scan's, as in
``bench.py``, and their mean), the (keyframe, query) entries its
association calls descend a scan, parked ones included (one eager
scan), per-phase ms from a short window under the program's
:class:`~madicp_tpu_torch.utils.timing.Trace` (its device stamps, a
traced graph on a card), device busy ms and kernels a scan from a short
``torch.profiler`` window (on a card), peak device memory and the
launches of the step's kernels (segment-sum, descent, ICP terms) in the
timed windows. On a card the timed scans replay the step's captured CUDA
graph (``models/step_graph.py``).

Run on the card (``--device cpu`` runs on the CPU; it never falls back to
it on its own)::

    python -m madicp_tpu_torch.bench

Env knobs (``bench.py``'s): BENCH_SCHEDULES (comma list of specs; default
the five above, the headline first), BENCH_N_POINTS, BENCH_KEYFRAMES,
BENCH_DEPTH, BENCH_MAX_LEAVES, BENCH_WARMUP, BENCH_STEPS, BENCH_WINDOWS,
BENCH_LADDER (accepted; the select ladder is a no-op in the port).

Prints one line a schedule to stderr, then one JSON line last:
    {"metric": "odometry_scans_per_sec", "value": N, "unit": "scans/s",
     "vs_baseline": N/10, "baseline": "10hz-sensor-rate-proxy",
     "schedule": "...", "dtype": "float32", "n_descents": D,
     "schedules": {...}, "device": "<name, power limit>"}
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import sys
import time

import numpy as np
import torch

import madicp_tpu_torch.models.pipeline as pipeline_mod
from madicp_tpu_torch.models.pipeline import Pipeline, PipelineConfig
from madicp_tpu_torch.models.step_graph import COUNTERS, step_in_place
from madicp_tpu_torch.ops.tree import build_tree, transform_tree
from madicp_tpu_torch.probes.segsum_levels import bench_pose, kitti_like_world
from madicp_tpu_torch.utils.device import card_name, resolve_device, synchronize
from madicp_tpu_torch.utils.timing import Trace, device_kernels, layer_ms

REALTIME_HZ = 10.0  # the reference's anytime-realtime sensor rate
SCHEDULES = ("exact", "certified", "prefix:8192", "compact:4096", "fast")


def schedule_kwargs(spec: str) -> dict:
    """Pipeline keywords of a spec: exact | certified | compact:<U> |
    prefix:<U> | fast[:<every>] (``bench.py``'s grammar and defaults)."""
    name, _, arg = spec.partition(":")
    kw = dict(assoc_mode="exact", certify=False, certify_compact=0, reassoc_every=7)
    if name == "certified" and not arg:
        kw["certify"] = True
    elif name == "compact":
        kw.update(certify=True, certify_compact=int(arg) if arg else 4096)
    elif name == "prefix":
        kw.update(certify=True, certify_prefix=int(arg) if arg else 8192)
    elif name == "fast":
        kw["assoc_mode"] = "fast"
        if arg:
            kw["reassoc_every"] = int(arg)
    elif spec != "exact":
        raise SystemExit(f"unknown schedule {spec!r}")
    if "BENCH_LADDER" in os.environ:
        kw["assoc_ladder"] = int(os.environ["BENCH_LADDER"])
    return kw


def default_schedule_name(cfg) -> str:
    """The spec a PipelineConfig selects (the shipped default decides the
    headline, so flipping the default flips the headline)."""
    if cfg.assoc_mode == "fast":
        return "fast"
    if cfg.certify and cfg.certify_prefix:
        return f"prefix:{cfg.certify_prefix}"
    if cfg.certify and cfg.certify_compact:
        return f"compact:{cfg.certify_compact}"
    return "certified" if cfg.certify else "exact"


class BenchSetup:
    """The flagship scan stream and the steady-state keyframe ring."""

    def __init__(self, device, n_points=131072, num_keyframes=16, depth=16,
                 max_leaves=32768, seed=0):
        self.device = torch.device(device)
        self.n_points, self.num_keyframes = n_points, num_keyframes
        self.depth, self.max_leaves = depth, max_leaves
        self.rng = np.random.default_rng(seed)
        self.world = kitti_like_world(self.rng, n_points=min(120000, n_points))

    @classmethod
    def from_env(cls, device):
        env = lambda name, default: int(os.environ.get(name, default))  # noqa: E731
        return cls(device, n_points=env("BENCH_N_POINTS", 131072),
                   num_keyframes=env("BENCH_KEYFRAMES", 16), depth=env("BENCH_DEPTH", 16),
                   max_leaves=env("BENCH_MAX_LEAVES", 32768))

    def scan_at(self, i):
        """Scan i of the drive (1.4 m a scan, mild yaw): a re-sampled view
        of one world, so consecutive scans overlap like real data."""
        R, t = bench_pose(i)
        local = (self.world - t) @ R
        return (local + self.rng.normal(0, 0.008, local.shape)).astype(np.float32)

    def make_pipe(self, spec: str) -> Pipeline:
        return Pipeline(
            sensor_hz=10.0, deskew=False, b_max=0.2, rho_ker=0.1, p_th=0.8,
            b_min=0.1, b_ratio=0.02, num_keyframes=self.num_keyframes,
            n_points=self.n_points, depth=self.depth, max_leaves=self.max_leaves,
            dtype=torch.float32, device=self.device, **schedule_kwargs(spec),
        )

    def prime(self, pipe: Pipeline) -> None:
        """Initialise a pipeline and fill its keyframe ring, in place, with
        trees of the scans before the drive, each at its pose."""
        pipe.compute(0.0, self.scan_at(0))
        K, cfg = self.num_keyframes, pipe.cfg
        for k in range(K):
            pts, valid, _ = pipe.stage(self.scan_at(k - K))
            tree, _ = build_tree(pts, valid, depth=cfg.depth, b_max=cfg.b_max, b_min=cfg.b_min)
            R, t = (torch.as_tensor(a, dtype=cfg.dtype, device=pipe.device)
                    for a in bench_pose(k - K))
            pipe.state.kf_tree.nav[k].copy_(transform_tree(tree, R, t).nav)
        pipe.state = pipe.state._replace(
            kf_valid=torch.ones(K, dtype=torch.bool, device=pipe.device))


@contextlib.contextmanager
def counting_descent_queries():
    """Count the (keyframe, query) entries every ``associate_ring`` call of
    the pipeline hands the descent, parked ones included (a list holding
    the running total). On the card a parked entry costs the descent
    kernel one panel read of its tree's row 0 and a certified-live one up
    to three panels a row; on the CPU every entry gathers whole rows.
    Shapes only; no device read."""
    real, total = pipeline_mod.associate_ring, [0]

    def counted(nav, depth, pts, need, **kw):
        total[0] += need.numel()
        return real(nav, depth, pts, need, **kw)

    pipeline_mod.associate_ring = counted
    try:
        yield total
    finally:
        pipeline_mod.associate_ring = real


def run_schedule(setup: BenchSetup, spec: str, n_warmup=3, n_steps=12, n_windows=3,
                 n_phase=2) -> dict:
    """Steady-state numbers of one schedule on a freshly primed pipeline:
    ``n_warmup`` scans, then ``n_windows`` timed windows of ``n_steps``
    scans (each ending in a device synchronisation; on a card a timed
    scan replays the step's captured graph, and with ``n_warmup`` >= 2
    none pays for the warm-up or the capture), then one eager scan (its
    descent queries), one traced scan (on a card the traced graph's
    capture) and ``n_phase`` traced ones (their phases' device ms) and, on
    a card, ``n_phase`` under ``torch.profiler`` (device busy ms and
    kernels a scan; the profiler slows the host, so its wall time is not
    the bench's)."""
    pipe = setup.make_pipe(spec)
    dev = pipe.device
    setup.prime(pipe)
    total = n_warmup + n_windows * n_steps + 2 * n_phase + 2
    # staged before any timing: the bench measures the odometry engine,
    # not the data source
    staged = {i: pipe.stage(setup.scan_at(i)) for i in range(1, 1 + total)}

    def run(lo, hi):
        for i in range(lo, hi):
            pipe.compute_device(0.1 * i, *staged[i])

    run(1, 1 + n_warmup)
    synchronize(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    for c in COUNTERS.values():
        c.launches = 0  # the timed run starts here
    rates, descents = [], []
    lo = 1 + n_warmup
    for _ in range(n_windows):
        t0 = time.perf_counter()
        for i in range(lo, lo + n_steps):
            pipe.compute_device(0.1 * i, *staged[i])
            descents.append(pipe._last.n_descents)
        synchronize(dev)
        rates.append(n_steps / (time.perf_counter() - t0))
        lo += n_steps
    launches = {name: c.launches for name, c in COUNTERS.items()}  # right after it
    # the association calls are counted on an eager scan (a replay runs no
    # Python); their shapes are a scan's in every window
    with counting_descent_queries() as queries:
        pts, valid, _ = staged[lo]
        step_in_place(pipe.cfg, pipe._graphs.state, pts[None], valid[None])
    pipe.trace = Trace(dev)
    run(lo + 1, lo + 2)  # on a card, the traced graph's capture
    pipe.trace.drain()
    lo += 2
    run(lo, lo + n_phase)
    totals = layer_ms(pipe.trace.drain())
    pipe.trace = None
    lo += n_phase
    busy = None
    if dev.type == "cuda":
        by_name, wall_ms = device_kernels(lambda: run(lo, lo + n_phase))
        busy = {"device_busy_ms_per_scan": sum(us for us, _ in by_name.values()) / 1e3 / n_phase,
                "kernels_per_scan": sum(c for _, c in by_name.values()) / n_phase,
                "profiled_wall_ms_per_scan": wall_ms / n_phase}
    descents = [int(d) for d in descents]
    pose = pipe.current_pose()
    if not np.isfinite(pose).all():
        raise RuntimeError(f"{spec}: non-finite pose {pose}")
    return {
        "scans_per_sec": max(rates),
        "median_scans_per_sec": statistics.median(rates),
        "windows": rates,
        "ms_per_scan": 1000.0 / max(rates),
        "descents": descents[-1],
        "descents_mean": statistics.mean(descents),
        "descent_queries_per_scan": queries[0],
        "phase_ms": {k: ms / n_phase for k, ms in totals.items()},
        "peak_mem_gb": (torch.cuda.max_memory_allocated(dev) / 1e9
                        if dev.type == "cuda" else None),
        "segsum_launches": launches["segsum_moments"],
        "kernel_launches": launches,
        "scans_timed": n_windows * n_steps,
        "profile": busy,
    }


def schedule_list(headline: str) -> list:
    """BENCH_SCHEDULES, or the five default specs with the headline first."""
    specs = [s.strip() for s in os.environ.get("BENCH_SCHEDULES", "").split(",") if s.strip()]
    return specs or [headline] + [s for s in SCHEDULES if s != headline]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m madicp_tpu_torch.bench",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; never falls back to the CPU)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    setup = BenchSetup.from_env(device)
    n_warmup = int(os.environ.get("BENCH_WARMUP", 3))
    n_steps = int(os.environ.get("BENCH_STEPS", 12))
    n_windows = int(os.environ.get("BENCH_WINDOWS", 3))
    headline = default_schedule_name(PipelineConfig())
    schedules = schedule_list(headline)
    card = card_name(device)

    results = {}
    for spec in schedules:
        r = run_schedule(setup, spec, n_warmup, n_steps, n_windows)
        results[spec] = r
        print(f"{spec}: windows {r['windows']} scans/s, descents/scan {r['descents']} "
              f"({card})", file=sys.stderr, flush=True)
        if device.type == "cuda":
            torch.cuda.empty_cache()

    head_name = headline if headline in results else schedules[0]
    head = results[head_name]
    print(json.dumps({
        "metric": "odometry_scans_per_sec",
        "value": head["scans_per_sec"],
        "unit": "scans/s",
        "vs_baseline": head["scans_per_sec"] / REALTIME_HZ,
        "baseline": "10hz-sensor-rate-proxy",
        "schedule": head_name,
        "dtype": "float32",
        "n_descents": head["descents"],
        "schedules": results,
        "device": card,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
