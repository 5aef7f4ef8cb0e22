"""How complete a torch.profiler window of the graphed flagship step is.

``chip_smoke.py`` counts the kernels of a graphed scan from a profiled
window of 3 scans and holds them to the eager scan's within 1%. This probe
drives the certified flagship pipeline of the bench (131072 points, depth
16, 16 keyframes) graphed, and profiles ``windows`` windows of 3 scans in
two ways, alternating:

- ``bare``: the window holds only the scans and a synchronisation;
- ``padded``: :func:`madicp_tpu_torch.utils.timing.device_kernels`, which
  idles :data:`~madicp_tpu_torch.utils.timing.PROFILE_PAD_S` at either end.

It prints one JSON object: the graph's nodes, each window's kernel
records, how many windows of each way hold fewer than the graph's nodes a
scan, and, for each short bare window, where its last kernel record ended
against its last host event (µs from the window's start). Run on the
card:

    python -m madicp_tpu_torch.probes.profile_windows 60
"""

from __future__ import annotations

import argparse
import json

import torch

from madicp_tpu_torch import bench
from madicp_tpu_torch.utils.device import card_name
from madicp_tpu_torch.utils.timing import device_kernels

SCANS = 3  # scans a window, as chip_smoke's graphs phase


def bare_window(fn) -> tuple:
    """(device events, host events) of ``fn()`` in a profiler window that
    holds only it and a synchronisation."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.events()
    return ([e for e in events if e.device_type == DeviceType.CUDA],
            [e for e in events if e.device_type != DeviceType.CUDA])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("windows", type=int, help="windows of each way")
    args = ap.parse_args(argv)

    setup = bench.BenchSetup("cuda", 131072, 16, 16, 32768)
    pipe = setup.make_pipe("certified")
    setup.prime(pipe)
    total = 2 * SCANS * (args.windows + 1)
    staged = {i: pipe.stage(setup.scan_at(i)) for i in range(1, 1 + total)}
    nxt = [1]

    def run():
        for _ in range(SCANS):
            i = nxt[0]
            nxt[0] += 1
            pipe.compute_device(0.1 * i, *staged[i])

    run()  # the eager warm-up, then the capture and its first replays
    run()
    (_, nodes, _), = pipe._graphs.captured().values()
    want = nodes * SCANS
    out = {"nvidia_smi": card_name(torch.device("cuda")), "nodes": nodes,
           "scans_a_window": SCANS, "bare": [], "padded": [], "short_bare": [], "short": {}}
    for _ in range(args.windows):
        dev, host = bare_window(run)
        out["bare"].append(len(dev))
        if len(dev) < want:
            out["short_bare"].append({
                "kernels": len(dev),
                "last_kernel_end_us": max((e.time_range.end for e in dev), default=None),
                "last_host_end_us": max((e.time_range.end for e in host), default=None)})
        by_name, _ = device_kernels(run)
        out["padded"].append(sum(c for _, c in by_name.values()))
    out["short"] = {way: sum(n < want for n in out[way]) for way in ("bare", "padded")}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
