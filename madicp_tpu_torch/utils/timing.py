"""Per-phase timing of the odometry step, and kernel timers for the card.

A :class:`PhaseTimer` handed to ``odometry_step`` (or set as
``Pipeline.timer``) brackets each phase — deskew, build, leaves,
association, terms+solve, rings — with CUDA events on the card, or the
host clock on the CPU. With no timer the phases cost nothing extra.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch

PHASES = ("deskew", "build", "leaves", "association", "terms+solve", "rings")

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


class PhaseTimer:
    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self._cuda = self.device.type == "cuda"
        self._events = []  # (name, start, end): CUDA events or host seconds

    @contextlib.contextmanager
    def __call__(self, name: str):
        if self._cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            yield
            end.record()
        else:
            start = time.perf_counter()
            yield
            end = time.perf_counter()
        self._events.append((name, start, end))

    def totals_ms(self) -> dict:
        """Milliseconds per phase summed over everything recorded since
        the last :meth:`reset` (synchronises the device)."""
        if self._cuda:
            torch.cuda.synchronize(self.device)
        out = defaultdict(float)
        for name, start, end in self._events:
            out[name] += (
                start.elapsed_time(end) if self._cuda else (end - start) * 1e3
            )
        return dict(out)

    def reset(self) -> None:
        self._events.clear()


def phase(timer, name: str):
    """``timer(name)``, or a no-op context when there is no timer."""
    return contextlib.nullcontext() if timer is None else timer(name)


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
