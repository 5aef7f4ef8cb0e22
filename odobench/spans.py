"""Reading the program's own trace (``madicp_tpu_torch/utils/timing.py``
``Trace``): its host spans, its device stamps and its counts.

The readers of ``metrics/`` that name this module read a **span
sub-window**, run once a traced run (``--trace 1``) after the run's other
work: the cell's drive made again from the run's seed, the program built,
primed and warmed up as the timed window's was, then :data:`SPAN_STEPS`
steps with the program's trace off and as many with it on (the first
traced step, the traced graph's capture, is left out). Its earlier lines
say how the traced steps' rate compares with the untraced ones', the
graphs' nodes, the device's idle gaps between steps by the program's
host span over them (``program_gaps``), and the steps whose device span
does not sit between its replay's start and its pose's read
(``span_clock_breaks``).

A program without the trace (no ``Trace`` in its ``utils/timing.py``)
gets no sub-window: :func:`summary` returns None and every reader with
it. A test hands a ``Run`` its ``program_trace`` ready made.
"""

from __future__ import annotations

import argparse
import gc
import sys
import time
import traceback

SPAN_STEPS = {"cli": 300, "fleet": 100}
SLACK_NS = 20_000  # how far the clocks may disagree before a step breaks
STEP = "madicp.step"


def summary(run):
    """The span sub-window of ``run`` (run on the first call of a traced
    run on a card, then kept on the run): ``drained`` (the trace's
    records), ``steps``, ``batch`` and ``max_icp_iterations``; None where
    there is none."""
    if not hasattr(run, "program_trace"):
        run.program_trace = _span_window(run) if run.trace is not None else None
    return run.program_trace


def _seed() -> int:
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_known_args(sys.argv[1:])[0].seed


def _span_window(run):
    import torch

    try:
        from madicp_tpu_torch.utils.timing import Trace
    except ImportError:  # a program without its own trace
        return None
    if not torch.cuda.is_available():
        return None
    from odobench import run as run_mod
    from odobench.loader import Loader

    try:
        return measure(run, Trace, run_mod, Loader())
    except Exception:  # the run's other numbers stand; the lines say why these do not
        run_mod.log(span_window_failed=traceback.format_exc())
        return None


def measure(run, Trace, run_mod, loader, device="cuda", steps=SPAN_STEPS):
    """The span sub-window of ``run``'s cell (see the module docstring) on
    ``device``, ``steps`` steps a loop; logs its earlier lines."""
    import torch

    cuda = torch.device(device).type == "cuda"
    config, traf, _, lap, offsets, prime, _ = run_mod.cell_inputs(
        loader, run.workload, _seed(), device)
    loop = {"cli": run_mod.CliLoop, "fleet": run_mod.FleetLoop}[traf["loop"]](
        config, lap, offsets, prime, device)
    program = loop.pipe if traf["loop"] == "cli" else loop.fleet
    rec = run_mod.Recorder(len(offsets))
    n = steps[traf["loop"]]

    def rate():
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            loop.step(rec)
        return n * len(offsets) / (time.perf_counter() - t0)

    for _ in range(run_mod.WARM_SCANS):
        loop.step(rec)
    untraced = rate()
    program.trace = Trace(device)
    loop.step(rec)  # the traced graph's capture
    program.trace.drain()
    traced = rate()
    drained = program.trace.drain()
    program.trace = None
    graphs = program._graphs
    nodes = {t: [g[1] for g in graphs.captured(t).values()] for t in (False, True)}
    out = dict(drained=drained, steps=n, batch=len(offsets),
               max_icp_iterations=program.cfg.max_icp_iterations)
    loop.free()
    del loop, program, graphs, rec
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    run_mod.log(span_window={"steps": n, "untraced_scans_per_s": untraced,
                             "traced_scans_per_s": traced, "on_cost_pct":
                             100.0 * (untraced - traced) / untraced,
                             "graph_nodes": {"untraced": nodes[False], "traced": nodes[True]},
                             "lost": drained["lost"], "clock": drained["clock"]})
    run_mod.log(program_gaps=program_gaps(drained))
    run_mod.log(span_clock_breaks=clock_breaks(drained))
    kernel_ms = sum(run.layers_us.values()) / 1e3 / run.trace_steps if run.trace_steps else None
    step = mean_ms(out, STEP)
    run_mod.log(span_sums={"layers_over_step": sum(mean_ms(out, p) or 0.0 for p in (
        "deskew", "build", "assoc", "terms", "tail")) / step if step else None,
        "step_over_profiled_kernels": step / kernel_ms if step and kernel_ms else None})
    return out


def spans(drained, name: str) -> list:
    return [s for s in drained["spans"] if s["name"] == name]


def mean_ms(summ, name: str):
    """Milliseconds a step of every span ``name`` (host or device), summed
    over the sub-window; None where none ran."""
    if not summ:
        return None
    got = spans(summ["drained"], name)
    if not got:
        return None
    return sum(s["end_ns"] - s["start_ns"] for s in got) / 1e6 / summ["steps"]


def steps_in_order(drained) -> list:
    return sorted(spans(drained, STEP), key=lambda s: s["start_ns"])


def gaps_ms(drained) -> list:
    """The device's time between one step's last stamp and the next's
    first, in ms."""
    st = steps_in_order(drained)
    return [(b["start_ns"] - a["end_ns"]) / 1e6 for a, b in zip(st, st[1:])]


def program_gaps(drained) -> list:
    """Each gap between consecutive steps named by the innermost host span
    of the program over its middle ("caller" where none), summed by
    name: [name, ms], largest first."""
    host = [s for s in drained["spans"] if s["where"] == "host"]
    st = steps_in_order(drained)
    by: dict = {}
    for a, b in zip(st, st[1:]):
        mid = (a["end_ns"] + b["start_ns"]) / 2
        inner = [s for s in host if s["start_ns"] <= mid <= s["end_ns"]]
        name = min(inner, key=lambda s: s["end_ns"] - s["start_ns"])["name"] if inner else "caller"
        by[name] = by.get(name, 0.0) + (b["start_ns"] - a["end_ns"]) / 1e6
    return sorted(([k, v] for k, v in by.items()), key=lambda kv: -kv[1])


def clock_breaks(drained) -> int:
    """Steps whose device span starts before its replay's host span (less
    :data:`SLACK_NS`) or ends after the read of its pose (plus it)."""
    by_id = {s["id"]: s for s in drained["spans"]}
    waits = {s["scan"]: s for s in spans(drained, "madicp.pose.wait")}
    bad = 0
    for s in spans(drained, STEP):
        replay, wait = by_id.get(s["parent"]), waits.get(s["scan"])
        if (replay is None or wait is None or s["start_ns"] < replay["start_ns"] - SLACK_NS
                or s["end_ns"] > wait["end_ns"] + SLACK_NS):
            bad += 1
    return bad


def descended_pct(summ):
    """100 x descents over (rounds x valid keyframes x valid leaves), the
    mean over every sequence-scan of the sub-window."""
    if not summ:
        return None
    its = summ["max_icp_iterations"]
    shares = [100.0 * d / (its * k * n)
              for c in summ["drained"]["counters"]
              for d, k, n in zip(c["n_descents"], c["valid_keyframes"], c["n_leaves"])
              if k * n > 0]
    return sum(shares) / len(shares) if shares else None
