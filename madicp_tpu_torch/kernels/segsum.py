"""Moment segment-sum of the MAD-tree build: CUDA kernel and plain version.

For one tree level: ``(N, 3)`` shifted points ``d`` and ``(N,)`` int32
local node ids -> ``(sz, 10)`` per-node sums of ``[d, outer6(d), 1]``;
ids outside ``[0, sz)`` drop. Replaces the TPU kernel
``madicp_tpu/ops/tree.py:279`` ``_segsum_moments_pallas`` and the
scatter-add it stands in for (``tree.py:451-455``). The kernel lives in
``csrc/segsum_moments.cu`` (design and bound in its header).

Dispatch is by the tensors' device and nothing else: CPU tensors take
the plain version, CUDA tensors take the kernel or the call raises.
"""

from __future__ import annotations

import ctypes

import torch

from madicp_tpu_torch.kernels import build

# Levels with at most this many nodes accumulate in a per-block shared
# table of doubles (40 KB at 512); larger ones use global double atomics.
SHARED_MAX_NODES = 512
_THREADS = 256


class _Counter:
    """Launch count of the kernel (a plain integer, reset by callers)."""

    def __init__(self):
        self.launches = 0


counter = _Counter()


def _moment_columns(d: torch.Tensor) -> torch.Tensor:
    """(N, 3) -> (N, 10) columns ``[d, outer6(d), 1]``."""
    x, y, z = d[:, 0], d[:, 1], d[:, 2]
    return torch.stack(
        [x, y, z, x * x, x * y, x * z, y * y, y * z, z * z, torch.ones_like(x)],
        dim=1,
    )


def segsum_moments_ref(d: torch.Tensor, idx: torch.Tensor, sz: int) -> torch.Tensor:
    """Plain version: the moment columns, ``index_add_`` into a table
    with one spare row that takes every dropped id."""
    ids = idx.long()
    ids = torch.where((ids >= 0) & (ids < sz), ids, sz)
    tab = torch.zeros((sz + 1, 10), dtype=d.dtype, device=d.device)
    tab.index_add_(0, ids, _moment_columns(d))
    return tab[:sz]


def shared_blocks(n: int, sz: int, device: torch.device) -> int:
    """Blocks of the shared-table path (0 selects global atomics): about
    two per SM, but at least ~8 points per table row in each block, so a
    block's slab is never larger than the work it summarises."""
    if sz > SHARED_MAX_NODES:
        return 0
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(2 * sms, -(-n // _THREADS), n // (8 * sz)))


def segsum_moments(d: torch.Tensor, idx: torch.Tensor, sz: int) -> torch.Tensor:
    """Per-level moment table ``(sz, 10)``; see the module docstring."""
    if d.device.type == "cpu":
        return segsum_moments_ref(d, idx, sz)
    if d.device.type != "cuda":
        raise ValueError(f"segsum_moments: unsupported device {d.device}")
    if d.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"segsum_moments: d must be float32/float64, got {d.dtype}")
    if idx.dtype != torch.int32:
        raise TypeError(f"segsum_moments: idx must be int32, got {idx.dtype}")
    if d.dim() != 2 or d.shape[1] != 3 or idx.shape != (d.shape[0],):
        raise ValueError(
            f"segsum_moments: want d (N, 3) and idx (N,), got "
            f"{tuple(d.shape)} and {tuple(idx.shape)}"
        )
    if idx.device != d.device:
        raise ValueError("segsum_moments: d and idx on different devices")
    if not (d.is_contiguous() and idx.is_contiguous()):
        raise ValueError("segsum_moments: d and idx must be contiguous")
    if sz < 1:
        raise ValueError(f"segsum_moments: sz must be >= 1, got {sz}")

    n = d.shape[0]
    lib = build.load("segsum_moments")
    fn = lib.segsum_moments_f32 if d.dtype == torch.float32 else lib.segsum_moments_f64
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    blocks = shared_blocks(n, sz, d.device)
    # every entry of `out` is written by the kernel; the double scratch
    # holds per-block slabs (shared path) or the zeroed atomic
    # accumulators (global path)
    out = torch.empty((sz, 10), dtype=d.dtype, device=d.device)
    if blocks:
        scratch = torch.empty(blocks * sz * 10, dtype=torch.float64, device=d.device)
    else:
        scratch = torch.zeros(sz * 10, dtype=torch.float64, device=d.device)
    with torch.cuda.device(d.device):
        stream = torch.cuda.current_stream(d.device).cuda_stream
        rc = fn(d.data_ptr(), idx.data_ptr(), n, sz, blocks,
                scratch.data_ptr(), out.data_ptr(), stream)
    build.raise_on_error(lib, rc, "segsum_moments")
    counter.launches += 1
    return out
