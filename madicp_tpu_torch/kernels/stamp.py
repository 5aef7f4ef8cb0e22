"""The device side of the program's trace: stamps of the clock at the
step's phase boundaries and the step's counts, into a ring of slots.

:class:`~madicp_tpu_torch.utils.timing.StepStamps` owns the ring and
calls these; ``csrc/stamp.cu`` holds the kernels and their layout (the
header says why a kernel: a captured graph replays a kernel node, not a
host read). On the CPU the same calls write the host's clock
(``time.perf_counter_ns``) into a CPU ring, so the CPU tests run the
trace's whole path. Nothing is built or loaded until a trace first
stamps.
"""

from __future__ import annotations

import contextlib
import ctypes
import time

import torch

from madicp_tpu_torch.kernels import build

counter = build.LaunchCounter()
# the __global__ functions of csrc/stamp.cu, as a CUDA trace names them
KERNEL_NAMES = ("stamp_kernel", "counts_kernel", "now_kernel")
_P = ctypes.c_void_p
_ARGTYPES = {
    "stamp": [_P] * 4 + [ctypes.c_int] * 3 + [_P],
    "counts": [_P] * 2 + [ctypes.c_int] * 2 + [_P] * 2 + [ctypes.c_int, _P, ctypes.c_longlong,
                                                          ctypes.c_int, _P],
    "now": [_P, _P],
}
_fns: dict = {}


def _call(fn: str, dev: torch.device, *args) -> None:
    """Launch ``fn`` of ``csrc/stamp.cu`` on ``dev``'s current stream."""
    entry = _fns.get(fn)
    if entry is None:
        entry = getattr(build.load("stamp"), fn)
        entry.argtypes, entry.restype = _ARGTYPES[fn], ctypes.c_int
        _fns[fn] = entry
    current = dev.index == torch.cuda.current_device()
    with contextlib.nullcontext() if current else torch.cuda.device(dev):
        rc = entry(*args, torch.cuda.current_stream(dev).cuda_stream)
    if rc:
        build.raise_on_error(build.load("stamp"), rc, f"stamp {fn}")
    counter.launches += 1


def stamp(ring, cursor, tick, seq, mark: int) -> None:
    """The clock at ``mark`` into the step's slot of ``ring`` (slots,
    width) int64. With ``seq`` (the state's (B,) int32 seq before the
    step) this is the step's first stamp: it takes the slot ``tick %
    slots``, sets ``cursor`` (1,) int32 to it, advances ``tick`` (1,)
    int64 and writes the tick and the scan's id (``seq[0] + 1``) into the
    slot's first two columns; later stamps write into ``cursor``'s slot."""
    slots, width = ring.shape
    if not 0 <= mark < width - 2:
        raise ValueError(f"stamp: mark {mark} outside the ring's {width - 2} columns")
    if ring.device.type == "cpu":
        t = time.perf_counter_ns()
        if seq is not None:
            k = int(tick[0])
            cursor[0] = k % slots
            tick[0] = k + 1
            ring[k % slots, 0], ring[k % slots, 1] = k, int(seq.reshape(-1)[0]) + 1
        ring[int(cursor[0]), 2 + mark] = t
        return
    _call("stamp", ring.device, ring.data_ptr(), cursor.data_ptr(), tick.data_ptr(),
          None if seq is None else seq.data_ptr(), slots, width, mark)


COUNTS = 5  # counts a sequence


def counts(ring, cursor, off: int, n_descents, kf_valid, leaves_valid) -> None:
    """Each sequence's ``n_descents`` (B,) int64, count of ``kf_valid``
    (B, K) and of ``leaves_valid`` (B, L), the leaf slots the terms
    kernels walk a round (K times the valid leaves, the bound they take)
    and the slots they hold (K x L) into columns ``off + 5 b`` to ``off +
    5 b + 4`` of ``cursor``'s slot."""
    B, K = kf_valid.shape
    L = leaves_valid.shape[1]
    if (off + COUNTS * B > ring.shape[1] or n_descents.shape != (B,)
            or leaves_valid.shape[0] != B):
        raise ValueError(f"counts: {B} sequences do not fit the ring's columns from {off}")
    if ring.device.type == "cpu":
        row = ring[int(cursor[0]), off:off + COUNTS * B].view(B, COUNTS)
        row[:, 0] = n_descents
        row[:, 1] = kf_valid.sum(-1)
        row[:, 2] = leaves_valid.sum(-1)
        row[:, 3] = K * row[:, 2]
        row[:, 4] = K * L
        return
    if n_descents.dtype != torch.int64 or kf_valid.dtype != torch.bool or (
            leaves_valid.dtype != torch.bool):
        raise ValueError("counts: want n_descents int64, kf_valid and leaves_valid bool")
    n_descents, kf_valid, leaves_valid = (t.contiguous() for t in (n_descents, kf_valid,
                                                                   leaves_valid))
    _call("counts", ring.device, ring.data_ptr(), cursor.data_ptr(), ring.shape[1], off,
          n_descents.data_ptr(), kf_valid.data_ptr(), K, leaves_valid.data_ptr(), L, B)


def now(out) -> None:
    """The clock into ``out[0]`` ((1,) int64), on ``out``'s device."""
    if out.device.type == "cpu":
        out[0] = time.perf_counter_ns()
    else:
        _call("now", out.device, out.data_ptr())
