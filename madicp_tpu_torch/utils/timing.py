"""The program's trace, and kernel timers for the card.

:class:`Trace` is the program's one switch for tracing, off by default
(``Pipeline.trace`` / ``Fleet.trace`` hold one or ``None``). While on:

- **device spans**: the odometry step's ``phase(stamps, name)`` hooks
  stamp the device's clock at every phase boundary (a phase's start is
  the previous one's end), through :class:`StepStamps`, which the step's
  static buffers own (``models/step_graph.py``): each stamp is a
  one-thread kernel (``kernels/stamp.py``), so a captured graph replays
  them and a traced scan stays one replay. The phases, :data:`PHASES`,
  tile the step: ``deskew``, ``build`` (the build and its leaves),
  ``assoc`` (the query transform and the descent, every round), ``terms``
  (the ICP terms, the GN update and the certificate's slack pass) and
  ``tail`` (the prediction; the tail's scalars, the ring write, the
  output's leaves and counts). ``madicp.step`` runs from the first stamp
  to the last;
- **counts** at the same boundaries: each sequence's descents, valid
  keyframes and valid leaves, the leaf slots the terms kernels walk a
  round (their bound: every keyframe's valid leaves) and the slots they
  hold, written beside the stamps;
- **host spans** (``time.perf_counter_ns``): the host API's stage, copies,
  replay, output clones and pose read, each with its parent and the scan
  it serves, and as a ``record_function`` of the same name while a
  ``torch.profiler`` is active.

The stamps stay on the device until the host has waited for their step
anyway (a pose read) or :meth:`Trace.drain`; the drain puts every device
span on the host's clock (the device clock calibrated against it when
the trace starts and at each drain) and returns every record. On the CPU
the stamps read the host's clock, through the same calls and records.
With no trace nothing is stamped, built or loaded, and the captured step
is the untraced one.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time

import torch

PHASES = ("deskew", "build", "assoc", "terms", "tail")
STEP_SPAN = "madicp.step"
SLOTS = 1024  # steps the device ring holds between two host reads

# NVIDIA H100 SXM data sheet: HBM3 bandwidth and peak rates on the CUDA
# cores
H100_BYTES_PER_S = 3.35e12
H100_PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}


def bound_ms(nbytes: float, flops: float, kind: str) -> tuple:
    """(least milliseconds an H100 could take, "bytes" or "operations"):
    the larger of ``nbytes`` over the memory rate and ``flops`` over the
    peak rate of ``kind``."""
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / H100_PEAK_FLOPS[kind] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


class StepStamps:
    """The device stamps of one batch's steps: a ring of :data:`SLOTS`
    slots of ``2 + marks`` clock columns and 5 counts a sequence
    (``kernels/csrc/stamp.cu`` gives the layout), the slot of the step in
    flight and the count of steps begun, on ``device``. ``issued`` is the
    host's count of steps begun: the host advances it for each traced step
    it enqueues (a capture enqueues none), in step with the device's."""

    def __init__(self, batch: int, marks: int, device):
        self.marks = marks
        self.off = 2 + marks  # the counts' first column
        from madicp_tpu_torch.kernels.stamp import COUNTS

        self.ring = torch.zeros((SLOTS, self.off + COUNTS * batch), dtype=torch.int64,
                                device=device)
        self.cursor = torch.zeros(1, dtype=torch.int32, device=device)
        self.tick = torch.zeros(1, dtype=torch.int64, device=device)
        self.issued = 0
        self.layout: list = []  # the phases of the step being issued, in order
        self._seq = None

    @contextlib.contextmanager
    def step(self, seq):
        """Issue one step (``seq``: the state's seq before it): its phases
        stamp as they start, and the step's end is stamped on exit."""
        self.layout, self._seq = [], seq
        yield
        if self.layout:
            self._stamp(len(self.layout))

    @contextlib.contextmanager
    def phase(self, name: str):
        """Phase ``name`` from here: a stamp where it differs from the
        phase running (the ops issued until the next stamp are its)."""
        if not self.layout or self.layout[-1] != name:
            self._stamp(len(self.layout))
            self.layout.append(name)
        yield

    def _stamp(self, mark: int) -> None:
        from madicp_tpu_torch.kernels import stamp

        if mark >= self.marks:
            raise ValueError(f"the step stamps more than the {self.marks} marks its ring holds")
        stamp.stamp(self.ring, self.cursor, self.tick, self._seq if mark == 0 else None, mark)

    def counts(self, n_descents, kf_valid, leaves_valid) -> None:
        """Each sequence's descents, valid keyframes and valid leaves into
        the step's slot."""
        from madicp_tpu_torch.kernels import stamp

        stamp.counts(self.ring, self.cursor, self.off, n_descents, kf_valid, leaves_valid)


_OFF = contextlib.nullcontext()  # reusable: what every hook is with the trace off


def phase(stamps, name: str):
    """``stamps.phase(name)``, or a no-op context without stamps."""
    return _OFF if stamps is None else stamps.phase(name)


def stepping(stamps, seq):
    """``stamps.step(seq)``, or a no-op context without stamps."""
    return _OFF if stamps is None else stamps.step(seq)


def host_span(trace, name: str, scan=None):
    """``trace.span(name, scan)``, or a no-op context without a trace."""
    return _OFF if trace is None else trace.span(name, scan)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


def calibrate(device, tries: int = 16) -> tuple:
    """``(host ns, device ns, bracket ns)``: the device's clock read by a
    stamp ``tries`` times, each bracketed by the host's
    ``perf_counter_ns`` around its launch and a wait for it; the
    narrowest bracket's midpoint is taken as the host's time of its
    stamp."""
    from madicp_tpu_torch.kernels import stamp

    device = torch.device(device)
    out = torch.zeros(1, dtype=torch.int64, device=device)
    best = None
    for _ in range(tries):
        _sync(device)
        h0 = time.perf_counter_ns()
        stamp.now(out)
        _sync(device)
        h1 = time.perf_counter_ns()
        if best is None or h1 - h0 < best[2]:
            best = ((h0 + h1) // 2, int(out[0]), h1 - h0)
    return best


class Trace:
    """The program's trace (see the module docstring): host spans, each
    traced step's device record, and the clock that joins them. Made on
    ``device`` (its clock is calibrated now) and set as
    ``Pipeline.trace`` or ``Fleet.trace``; :meth:`drain` returns what was
    recorded."""

    def __init__(self, device="cpu"):
        self.device = torch.device(device)
        self._ids = itertools.count()
        self._local = threading.local()  # each thread's open spans
        self._spans: list = []      # closed host spans: (id, name, start, end, parent, key)
        self._steps = 0             # traced steps enqueued: the key of the next
        self._staged = 0            # scans staged: the key of the next
        self._pending: list = []    # (key, stamps, ticket, layout, parent) not yet read
        self._records: list = []    # (key, scan, stamps ns, layout, parent, counts)
        self._lost = 0
        self._clock = calibrate(self.device)

    # -- host spans ---------------------------------------------------------
    def span(self, name: str, scan=None) -> "_Span":
        """A host span ``name`` for scan key ``scan`` (by default its
        parent's, else the next step's); its context yields the span's
        id."""
        return _Span(self, name, scan)

    def next_staged(self) -> int:
        """The scan key of a scan being staged: scans are staged, then
        stepped, in one order."""
        self._staged += 1
        return self._staged - 1

    @property
    def last_step(self) -> int:
        """The scan key of the step enqueued last."""
        return self._steps - 1

    # -- device records -----------------------------------------------------
    def enqueued(self, stamps: StepStamps, ticket: int, layout, parent) -> None:
        """A traced step was enqueued: its stamps are in ``stamps``' slot
        of ``ticket``, its phases ``layout``, its host span ``parent``."""
        self._pending.append((self._steps, stamps, ticket, tuple(layout), parent))
        self._steps += 1

    def collect(self, force: bool = False) -> None:
        """Read the pending steps' stamps and counts: now with ``force``
        (a wait for the device), else only once they fill half the ring,
        right after a read that waited for their steps."""
        from madicp_tpu_torch.kernels.stamp import COUNTS

        if not self._pending or (not force and len(self._pending) < SLOTS // 2):
            return
        rings = {}
        for key, stamps, ticket, layout, parent in self._pending:
            if id(stamps) not in rings:
                rings[id(stamps)] = stamps.ring.cpu().numpy()
            row = rings[id(stamps)][ticket % SLOTS]
            if row[0] != ticket:  # overwritten: more steps than slots went unread
                self._lost += 1
                continue
            counts = row[stamps.off:].reshape(-1, COUNTS)
            self._records.append((key, int(row[1]), row[2:3 + len(layout)].tolist(), layout,
                                  parent, counts.tolist()))
        self._pending = []

    def drain(self) -> dict:
        """Every record since the last drain (waits for the device), the
        device's on the host's clock, and clears them: ``spans`` (dicts
        of ``id``, ``name``, ``start_ns``, ``end_ns``, ``parent``,
        ``scan``, ``where``: "host" or "device"), ``counters`` (a traced
        step's ``scan`` and each sequence's ``n_descents``,
        ``valid_keyframes``, ``n_leaves``, ``terms_walked`` and
        ``terms_slots``: the leaf slots of a round the terms kernels walk
        and hold), ``lost`` (steps whose stamps
        were overwritten before a read) and ``clock``. A span's ``scan``
        is its step's id (the state's seq after the step), None where the
        step left no record."""
        self.collect(force=True)
        c0, c1 = self._clock, calibrate(self.device)
        self._clock = c1
        # the two calibrations give the rate only over a long enough span
        rate = (c1[0] - c0[0]) / (c1[1] - c0[1]) if c1[1] - c0[1] > 5e8 else 1.0

        def host_ns(d):
            return c0[0] + round((d - c0[1]) * rate)

        scan_of = {r[0]: r[1] for r in self._records}
        spans = [dict(id=sid, name=name, start_ns=t0, end_ns=t1, parent=parent,
                      scan=scan_of.get(key), where="host")
                 for sid, name, t0, t1, parent, key in self._spans]
        counters = []
        for key, scan, ns, layout, parent, counts in self._records:
            ns = [host_ns(d) for d in ns]
            step = next(self._ids)
            spans.append(dict(id=step, name=STEP_SPAN, start_ns=ns[0], end_ns=ns[-1],
                              parent=parent, scan=scan, where="device"))
            spans += [dict(id=next(self._ids), name=name, start_ns=a, end_ns=b, parent=step,
                           scan=scan, where="device")
                      for name, a, b in zip(layout, ns, ns[1:])]
            counters.append(dict(scan=scan, n_descents=[c[0] for c in counts],
                                 valid_keyframes=[c[1] for c in counts],
                                 n_leaves=[c[2] for c in counts],
                                 terms_walked=[c[3] for c in counts],
                                 terms_slots=[c[4] for c in counts]))
        out = dict(spans=spans, counters=counters, lost=self._lost,
                   clock=dict(rate=rate, brackets_ns=[c0[2], c1[2]]))
        self._spans, self._records, self._lost = [], [], 0
        return out


class _Span:
    """:meth:`Trace.span`'s context (a class: a span costs the host a few
    microseconds less than a generator's context would)."""

    __slots__ = ("trace", "name", "key", "sid", "parent", "t0", "marked", "stack")

    def __init__(self, trace: Trace, name: str, scan):
        self.trace, self.name, self.key = trace, name, scan

    def __enter__(self) -> int:
        tr = self.trace
        try:
            stack = tr._local.stack
        except AttributeError:
            stack = tr._local.stack = []
        self.parent, key = stack[-1] if stack else (None, tr._steps)
        if self.key is None:
            self.key = key
        self.sid = next(tr._ids)
        stack.append((self.sid, self.key))
        self.stack = stack
        self.marked = None
        if torch.autograd._profiler_enabled():
            self.marked = torch.profiler.record_function(self.name)
            self.marked.__enter__()
        self.t0 = time.perf_counter_ns()
        return self.sid

    def __exit__(self, *exc) -> bool:
        t1 = time.perf_counter_ns()
        if self.marked is not None:
            self.marked.__exit__(*exc)
        self.trace._spans.append((self.sid, self.name, self.t0, t1, self.parent, self.key))
        self.stack.pop()
        return False


def layer_ms(drained: dict) -> dict:
    """{phase: device ms} summed over a drained trace's steps, every
    phase of :data:`PHASES` (0 where no step ran it)."""
    out = dict.fromkeys(PHASES, 0.0)
    for s in drained["spans"]:
        if s["where"] == "device" and s["name"] in out:
            out[s["name"]] += (s["end_ns"] - s["start_ns"]) / 1e6
    return out


def event_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` warm eager calls, from
    CUDA events: what a caller pays per call, wrapper included."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


PROFILE_PAD_S = 0.05  # idle seconds at either end of a profiled window


def device_trace(fn) -> tuple:
    """([(CUDA kernel name, device start µs, device µs)] in start order,
    wall ms) of one ``fn()`` under ``torch.profiler``; memsets count as
    kernels. The profiler keeps only the device records that fall inside
    its capture window on its own clock, so the window idles
    :data:`PROFILE_PAD_S` at either end (outside the wall time), and one
    cycle's events are kept whole (``acc_events``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        time.sleep(PROFILE_PAD_S)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        time.sleep(PROFILE_PAD_S)
    records = [(e.name, e.time_range.start, e.device_time_total)
               for e in prof.events() if e.device_type == DeviceType.CUDA]
    return sorted(records, key=lambda r: r[1]), wall_ms


def device_kernels(fn) -> tuple:
    """({CUDA kernel name: (device microseconds, launches)}, wall ms) of
    one ``fn()`` under ``torch.profiler`` (:func:`device_trace`)."""
    records, wall_ms = device_trace(fn)
    by_name: dict = {}
    for name, _, us in records:
        total, cnt = by_name.get(name, (0.0, 0))
        by_name[name] = (total + us, cnt + 1)
    return by_name, wall_ms


def graph_ms(fn, reps: int, replays: int = 3) -> float:
    """Mean device milliseconds of ``fn()``: ``reps`` calls captured in
    one CUDA graph, replayed ``replays`` times. The host work of each
    call (argument checks, allocation, the launch itself) is paid once at
    capture, so this is the kernels' time on the card."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the default stream
        fn()
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * replays)
