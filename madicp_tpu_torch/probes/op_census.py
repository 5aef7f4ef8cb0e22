"""The operations of one steady certified scan, counted on the CPU by
where in the port they come from: the census behind ROADMAP's table of
the step's small kernels.

A ``TorchDispatchMode`` sees every ATen operation of one
``Pipeline.compute_device`` scan of the bench's drive (the bench's world,
a primed ring, two scans before it). Views are not counted (they launch
nothing on the card). Each operation goes to the innermost frame of the
port's package that issued it, ``file:line function``, except under a
kernel's wrapper module (``kernels/``): the card runs that call as the
kernel's own launch, so the census counts the wrapper's calls there
(``kernel:<module>``, one a call of its outermost frame), not the plain
version's operations. On the card one torch operation is one kernel or
a few (``torch.linalg.solve_ex`` is several cuSOLVER kernels), so this
ranks sources of launches; the card's own counts come from its profiler
(``chip_smoke.py``'s ``steady`` and ``graphs`` phases). The count is set
by the depth and the GN rounds, not by the points or the keyframes, so a
small configuration counts what the flagship runs. Run on the CPU:

    python -m madicp_tpu_torch.probes.op_census [--n-points 8192]
        [--keyframes 4] [--depth 16] [--max-leaves 2048] [--schedule certified]
"""

from __future__ import annotations

import argparse
import collections
import json
import sys
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode

PACKAGE = Path(__file__).resolve().parents[1]
_SKIP = {PACKAGE / "probes" / "op_census.py"}


def _source():
    """Where the current operation came from: ``(kernel:<module>, its
    outermost frame in the module)`` under a kernel's wrapper, else
    ``(innermost file:line function of the package, None)``, else
    ``("outside", None)``."""
    frame = sys._getframe(2)
    inner, kernel = None, None
    while frame is not None:
        path = Path(frame.f_code.co_filename)
        if path.is_relative_to(PACKAGE) and path not in _SKIP:
            rel = path.relative_to(PACKAGE)
            if rel.parts[0] == "kernels":
                kernel = (f"kernel:{rel.stem}", frame)
            elif inner is None:
                inner = f"{rel}:{frame.f_lineno} {frame.f_code.co_name}"
        frame = frame.f_back
    return kernel or (inner or "outside", None)


class Census(TorchDispatchMode):
    """Counts the non-view ATen operations it sees by :func:`_source`, a
    kernel wrapper's by its calls."""

    def __init__(self):
        super().__init__()
        self.counts = collections.Counter()
        self._call = None  # the kernel wrapper frame of the last operation, kept alive

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not func.is_view:
            source, frame = _source()
            if frame is None or frame is not self._call:
                self.counts[source] += 1
            self._call = frame
        return func(*args, **(kwargs or {}))


def census(n_points=8192, keyframes=4, depth=16, max_leaves=2048,
           schedule="certified") -> dict:
    """``{"ops": total, "by_source": {source: ops}}`` of one steady scan."""
    from madicp_tpu_torch import bench

    setup = bench.BenchSetup("cpu", n_points, keyframes, depth, max_leaves)
    pipe = setup.make_pipe(schedule)
    setup.prime(pipe)
    for i in (1, 2):
        pipe.compute_device(0.1 * i, *pipe.stage(setup.scan_at(i)))
    staged = pipe.stage(setup.scan_at(3))
    with Census() as c:
        pipe.compute_device(0.3, *staged)
    return {"ops": sum(c.counts.values()),
            "by_source": dict(sorted(c.counts.items(), key=lambda kv: -kv[1]))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n-points", type=int, default=8192)
    ap.add_argument("--keyframes", type=int, default=4)
    ap.add_argument("--depth", type=int, default=16)
    ap.add_argument("--max-leaves", type=int, default=2048)
    ap.add_argument("--schedule", default="certified")
    a = ap.parse_args(argv)
    out = census(a.n_points, a.keyframes, a.depth, a.max_leaves, a.schedule)
    print(json.dumps({"device": "cpu", "schedule": a.schedule, "n_points": a.n_points,
                      "keyframes": a.keyframes, "depth": a.depth,
                      "max_leaves": a.max_leaves, **out}, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
