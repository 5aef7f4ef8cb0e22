"""Reading the device's work from ``torch.profiler``.

:func:`profile` is a copy of ``madicp_tpu_torch/utils/timing.py:101``
``device_trace`` (the window idles ``PAD_S`` at either end, because the
profiler keeps only the device records that fall inside its capture
window on its own clock), which also returns the host's marked spans on
the same clock. :func:`busy_intervals` and :func:`idle_share` reduce a
trace against the sub-window's own wall time, not the padded capture.
"""

from __future__ import annotations

import time

PAD_S = 0.05
WINDOW_SPAN = "odobench.window"


def profile(fn) -> dict:
    """Run ``fn()`` under ``torch.profiler`` (CPU and CUDA activities)
    inside a span named :data:`WINDOW_SPAN`. Returns ``device``: [(name,
    start µs, end µs)] of every kernel, copy and set on the device in
    start order; ``spans``: [(name, start µs, end µs)] of the host's
    ``record_function`` spans; ``window``: the window span's (start, end)
    in µs."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, record_function

    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                                acc_events=True) as prof:
        time.sleep(PAD_S)
        with record_function(WINDOW_SPAN):
            fn()
            torch.cuda.synchronize()
        time.sleep(PAD_S)
    device, spans, window = [], [], None
    for e in prof.events():
        start, end = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            if not e.name.startswith("odobench."):  # a span's annotation on the device
                device.append((e.name, start, start + e.device_time_total))
        elif e.name == WINDOW_SPAN:
            window = (start, end)
        elif e.name.startswith("odobench."):
            spans.append((e.name, start, end))
    device.sort(key=lambda r: r[1])
    return {"device": device, "spans": spans, "window": window}


def is_copy(name: str) -> bool:
    """Whether a device record is a copy or a set, not a kernel."""
    return name.startswith(("Memcpy", "Memset", "memcpy", "memset"))


def busy_intervals(records, window) -> list:
    """The union of the records' intervals clipped to ``window``, as
    sorted disjoint (start, end) pairs."""
    lo, hi = window
    spans = sorted((max(s, lo), min(e, hi)) for _, s, e in records if e > lo and s < hi)
    merged = []
    for s, e in spans:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [tuple(m) for m in merged]


def busy_us(records, window) -> float:
    return sum(e - s for s, e in busy_intervals(records, window))


def idle_share(records, window) -> float:
    """The share (0-1) of ``window`` in which no kernel or copy runs."""
    return 1.0 - busy_us(records, window) / (window[1] - window[0])


def idle_gaps(records, spans, window, top: int = 10) -> list:
    """The device's idle time in ``window`` by what the host was doing:
    each gap between busy intervals named by the innermost marked host
    span over its middle ("host" where none), summed by name, the
    ``top`` largest as [name, seconds]."""
    lo, hi = window
    edges = [lo] + [x for iv in busy_intervals(records, window) for x in iv] + [hi]
    by: dict = {}
    for s, e in zip(edges[0::2], edges[1::2]):
        if e <= s:
            continue
        mid = (s + e) / 2
        inner = [sp for sp in spans if sp[1] <= mid <= sp[2]]
        name = min(inner, key=lambda sp: sp[2] - sp[1])[0] if inner else "host"
        by[name] = by.get(name, 0.0) + (e - s) * 1e-6
    return sorted(([k, v] for k, v in by.items()), key=lambda kv: -kv[1])[:top]


def top_ops(records, window, top: int = 10) -> list:
    """The device operations that took most time in ``window``, summed by
    name, as [name, seconds]."""
    lo, hi = window
    by: dict = {}
    for name, s, e in records:
        if e > lo and s < hi:
            by[name] = by.get(name, 0.0) + (min(e, hi) - max(s, lo)) * 1e-6
    return sorted(([k, v] for k, v in by.items()), key=lambda kv: -kv[1])[:top]


def classify(records, patterns) -> dict:
    """{layer: device µs} of the kernel records by the first of
    ``patterns`` ([(compiled regex, layer)]) that a kernel's name matches
    (``None`` for a kernel none places; copies and sets are left out)."""
    out: dict = {}
    for name, s, e in records:
        if is_copy(name):
            continue
        layer = next((lay for rx, lay in patterns if rx.search(name)), None)
        out[layer] = out.get(layer, 0.0) + (e - s)
    return out
