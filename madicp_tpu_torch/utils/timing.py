"""Per-phase timing of the odometry step.

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
