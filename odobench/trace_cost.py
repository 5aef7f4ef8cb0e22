"""What the program's trace costs a cell: ``python3 -m odobench.trace_cost
<cell> [<cell> ...]`` from the root of a checkout, on a card.

For each cell: the drive of seed 7 made, the program built, primed and
warmed up as a run's set-up does (``run.py``); one JSON line with the
untraced step graph's nodes and launches a replay (a program without
the trace stops there: the line is what a parent commit is compared on),
then the traced graph's nodes, both graphs' replay time on the card
(CUDA events, alternating), a host span's cost, and scans/s over
``PAIRS`` alternating pairs of untraced and traced windows in the
cell's loop (medians, and the traced rate's shortfall in %).
"""

from __future__ import annotations

import json
import statistics
import sys
import time

PAIRS = 10
WINDOW = {"cli": 150, "fleet": 50}  # steps a window
SPANS = 20000


def replay_us(graph, reps: int = 30) -> float:
    import torch

    graph.replay()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        graph.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps * 1e3


def cell_cost(cell: str) -> dict:
    import torch

    from madicp_tpu_torch.kernels import build
    from odobench import run
    from odobench.loader import Loader

    config, traf, _, lap, offsets, prime, _ = run.cell_inputs(Loader(), cell, 7, "cuda")
    loop = {"cli": run.CliLoop, "fleet": run.FleetLoop}[traf["loop"]](
        config, lap, offsets, prime, "cuda")
    program = loop.pipe if traf["loop"] == "cli" else loop.fleet
    rec = run.Recorder(len(offsets))
    for _ in range(run.WARM_SCANS):
        loop.step(rec)
    graphs = program._graphs
    (_, nodes, launches), = graphs.captured().values()
    out = {"cell": cell, "untraced_nodes": nodes, "launches": launches,
           "stamp_loaded": "stamp" in build._loaded}
    try:
        from madicp_tpu_torch.utils.timing import Trace
    except ImportError:  # a program without its own trace
        return out
    program.trace = Trace("cuda")
    loop.step(rec)  # the traced graph's capture
    program.trace.drain()
    program.trace = None
    (_, out["traced_nodes"], _), = graphs.captured(traced=True).values()
    pair = [graphs._graphs[(program.cfg, t)].graph for t in (False, True)]
    us = {False: [], True: []}
    for _ in range(5):
        for t, g in zip((False, True), pair):
            us[t].append(replay_us(g))
    out["replay_us"] = {str(t): statistics.median(v) for t, v in us.items()}
    trace = Trace("cuda")
    t0 = time.perf_counter()
    for _ in range(SPANS):
        with trace.span("madicp.cost"):
            pass
    out["span_us"] = (time.perf_counter() - t0) / SPANS * 1e6
    n = WINDOW[traf["loop"]]
    rates = {False: [], True: []}
    for k in range(2 * PAIRS):
        traced = bool(k % 2)
        program.trace = Trace("cuda") if traced else None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            loop.step(rec)
        rates[traced].append(n * len(offsets) / (time.perf_counter() - t0))
        program.trace = None
    med = {t: statistics.median(v) for t, v in rates.items()}
    out.update(rates={str(t): v for t, v in rates.items()},
               median={str(t): v for t, v in med.items()},
               on_cost_pct=100.0 * (med[False] - med[True]) / med[False])
    loop.free()
    return out


def main(argv=None) -> int:
    import torch

    cells = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("odobench.trace_cost: needs a CUDA device", file=sys.stderr)
        return 2
    for cell in cells:
        print(json.dumps(cell_cost(cell)), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
