"""CPU tests of the readers of the program's own trace (``spans.py`` and
the ``metrics/`` that read it): on a fake ``Run`` whose span sub-window is
made by hand, and on the tiny cell of ``test_odobench.py``, where the
sub-window runs the program on the CPU (its stamps read the host's
clock there)."""

from __future__ import annotations

import json

import pytest

from odobench import run, spans
from odobench.loader import Loader
from test_odobench import tiny_bench

MS = 1_000_000  # ns

NEW = ("host.copy_in_ms", "dispatch.replay_ms", "deskew.span_ms", "build.span_ms",
       "assoc.span_ms", "terms.span_ms", "tail.span_ms", "device.step_ms", "device.gap_ms",
       "assoc.descended_pct")


def span(i, name, a, b, parent=None, scan=1, where="host"):
    return dict(id=i, name=name, start_ns=a * MS, end_ns=b * MS, parent=parent, scan=scan,
                where=where)


def fake_window() -> dict:
    """Two CLI steps of 10 ms of host time each: stage 0-2 (copy 1-2),
    compute 2-3 (replay 2-2.5), the device step 2.2-6 (build 1, tail 0.4,
    assoc 1.2, terms 1.2) and pose 3-7 (wait 3-6.5); the second step 10 ms
    later."""
    out = []
    for k in range(2):
        t, i, scan = 10 * k, 100 * k, k + 2
        out += [span(i, "madicp.stage", t, t + 2, scan=scan),
                span(i + 1, "madicp.copy_in", t + 1, t + 2, i, scan),
                span(i + 2, "madicp.compute", t + 2, t + 3, scan=scan),
                span(i + 3, "madicp.replay", t + 2, t + 2.5, i + 2, scan),
                span(i + 4, "madicp.pose", t + 3, t + 7, scan=scan),
                span(i + 5, "madicp.pose.wait", t + 3, t + 6.5, i + 4, scan),
                span(i + 6, spans.STEP, t + 2.2, t + 6, i + 3, scan, "device")]
        edges = [t + 2.2, t + 3.2, t + 3.6, t + 4.8, t + 6]
        for j, (name, a, b) in enumerate(zip(("build", "tail", "assoc", "terms"), edges,
                                             edges[1:])):
            out.append(span(i + 7 + j, name, a, b, i + 6, scan, "device"))
    counters = [dict(scan=2, n_descents=[300], valid_keyframes=[4], n_leaves=[100]),
                dict(scan=3, n_descents=[150], valid_keyframes=[3], n_leaves=[100])]
    drained = dict(spans=out, counters=counters, lost=0, clock=dict(rate=1.0))
    return dict(drained=drained, steps=2, batch=1, max_icp_iterations=5)


def fake_run(summary) -> run.Run:
    r = run.Run("w", {}, 1)
    r.program_trace = summary
    return r


def test_the_readers_read_the_programs_trace():
    r = fake_run(fake_window())
    got = {m: Loader().reader(m)(r) for m in NEW}
    assert got["host.copy_in_ms"] == pytest.approx(1.0)
    assert got["dispatch.replay_ms"] == pytest.approx(0.5)
    assert got["deskew.span_ms"] is None  # no step ran the phase
    assert got["build.span_ms"] == pytest.approx(1.0)
    assert got["tail.span_ms"] == pytest.approx(0.4)
    assert got["assoc.span_ms"] == pytest.approx(1.2)
    assert got["terms.span_ms"] == pytest.approx(1.2)
    assert got["device.step_ms"] == pytest.approx(3.8)
    assert got["device.gap_ms"] == pytest.approx(12.2 - 6)
    # 300 / (5 x 4 x 100) and 150 / (5 x 3 x 100)
    assert got["assoc.descended_pct"] == pytest.approx((15.0 + 10.0) / 2)


def test_gaps_are_named_by_the_programs_innermost_span_and_the_clocks_checked():
    summ = fake_window()
    # the gap 6-12.2 ms: its middle, 9.1, lies in no span of the program
    assert spans.program_gaps(summ["drained"]) == [["caller", pytest.approx(6.2)]]
    assert spans.clock_breaks(summ["drained"]) == 0
    step = next(s for s in summ["drained"]["spans"] if s["name"] == spans.STEP)
    step["end_ns"] = 6.6 * MS  # ends 100 us after its pose was on the host
    assert spans.clock_breaks(summ["drained"]) == 1
    step["end_ns"], step["start_ns"] = 6 * MS, 1.9 * MS  # starts before its replay
    assert spans.clock_breaks(summ["drained"]) == 1


def test_without_the_programs_trace_every_reader_returns_nothing(monkeypatch):
    untraced = run.Run("w", {}, 1)  # a --trace 0 run: no sub-window
    assert all(Loader().reader(m)(untraced) is None for m in NEW)
    traced = run.Run("w", {}, 1)
    traced.trace = {"device": [], "spans": [], "window": (0.0, 1.0)}
    import madicp_tpu_torch.utils.timing as timing

    monkeypatch.delattr(timing, "Trace")  # as a program before its trace
    assert all(Loader().reader(m)(traced) is None for m in NEW)


@pytest.mark.parametrize("loop", ["cli", "fleet"])
def test_the_span_sub_window_runs_the_program_on_the_cpu(tmp_path, capsys, loop):
    from madicp_tpu_torch.utils.timing import Trace

    loader = tiny_bench(tmp_path, loop)
    r = run.Run("tiny.cell", {}, 3 if loop == "fleet" else 1)
    summ = spans.measure(r, Trace, run, loader, device="cpu", steps={"cli": 3, "fleet": 2})
    lines = [json.loads(x) for x in capsys.readouterr().err.splitlines() if x.startswith("{")]
    window = next(x["span_window"] for x in lines if "span_window" in x)
    assert window["lost"] == 0 and window["traced_scans_per_s"] > 0
    assert next(x["span_clock_breaks"] for x in lines if "span_clock_breaks" in x) == 0
    assert any("program_gaps" in x for x in lines)
    r.program_trace = summ
    got = {m: Loader().reader(m)(r) for m in NEW}
    assert got["deskew.span_ms"] is None
    assert all(got[m] > 0 for m in NEW if m != "deskew.span_ms")
    layers = sum(got[f"{p}.span_ms"] for p in ("build", "assoc", "terms", "tail"))
    assert layers == pytest.approx(got["device.step_ms"], rel=1e-9)
    assert 0 < got["assoc.descended_pct"] <= 100
