"""Moment segment-sum of the MAD-tree build: CUDA kernel and plain version.

For one tree level: ``(N, 3)`` shifted points ``d`` and ``(N,)`` int32
local node ids -> ``(sz, 10)`` per-node sums of ``[d, outer6(d), 1]``;
ids outside ``[0, sz)`` drop. Replaces the TPU kernel
``madicp_tpu/ops/tree.py:279`` ``_segsum_moments_pallas`` and the
scatter-add it stands in for (``tree.py:451-455``). The kernel lives in
``csrc/segsum_moments.cu`` (design and bound in its header).

:func:`plan` chooses, on the host and from ``(n, sz, sm_count)`` alone,
the kernel's path and launch shape: ``warp`` or ``sort`` where many
points share a node, ``point`` elsewhere; one launch where the last block
can round the table, two (a rounding kernel) where it is large. Every
path accumulates in a double workspace, one per device, that the kernels
leave zeroed: it is allocated (zeroed) at the first call that needs it
larger, which must not be under CUDA graph capture, and calls that share
it must be ordered on one stream.

Dispatch is by the tensors' device and nothing else: CPU tensors take
the plain version, CUDA tensors take the kernel or the call raises.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from madicp_tpu_torch.kernels import build

NCOL = 10
PATHS = ("point", "sort", "warp")  # the C side's path numbers, in order
# Thresholds from the A/B of every path at every flagship level on an
# H100 (PERF.md): the warp path is faster up to sz 32, the sort path
# from 64, and one atomic a point from 64 points a node down.
CONTENDED_POINTS = 128  # points a node from which a level is contended
WARP_MAX_NODES = 32  # contended levels up to here take the warp path, above the sort path
SORT_MAX_NODES = 4096  # the sort path's count table
TICKET_MAX_ENTRIES = 5120  # tables the last block rounds (sz <= 512); above, a second kernel
MAX_SMEM = 96 * 1024  # dynamic shared bytes a block may ask for (the warp tables)
SORT_THREADS, SORT_TILE = 512, 4096  # a sort block ranks at most 8 points a thread
WARP_MAX_WARPS = 16
THREADS = 256  # point path and rounding kernel
ROUND_BATCH = 8
_MAX_N = 2**26  # 3 N and 10 sz stay within a C int
_WS_HEAD = 2  # workspace doubles before the sums (the last-block ticket)


class Plan(NamedTuple):
    """One call's launches: the accumulating kernel's path and grid, the
    rounding kernel's grid (0: the last block rounds, one launch), and
    the workspace's doubles."""

    path: str
    blocks: int
    threads: int
    tile: int  # points a block takes (sort and warp paths)
    round_blocks: int
    workspace: int

    @property
    def launches(self) -> int:
        return 1 if self.round_blocks == 0 else 2


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def plan(n: int, sz: int, sm_count: int, path: str | None = None) -> Plan | None:
    """The launches for ``n`` points into ``sz`` nodes on a card with
    ``sm_count`` SMs: ``path`` forced (None where it cannot take this
    level), or chosen by contention. Each grid fills the SMs where ``n``
    gives every block at least a warp's worth of points."""
    if path is None:
        if n < CONTENDED_POINTS * sz or sz > SORT_MAX_NODES:
            path = "point"
        else:
            path = "warp" if sz <= WARP_MAX_NODES else "sort"
    entries = NCOL * sz
    if path == "point":
        threads = THREADS
        blocks = max(1, _cdiv(n, threads))
        tile = 0
    elif path == "sort":
        threads = SORT_THREADS
        blocks = max(1, min(_cdiv(n, 32), max(sm_count, _cdiv(n, SORT_TILE))))
        tile = max(1, _cdiv(n, blocks))
        if sz > SORT_MAX_NODES:
            return None
    elif path == "warp":
        warps = min(WARP_MAX_WARPS, MAX_SMEM // (8 * entries))
        if warps < 1:
            return None
        threads = 32 * warps
        # about two blocks an SM, at most four 32-point steps a warp
        blocks = max(1, min(_cdiv(n, 32), max(2 * sm_count, _cdiv(n, 4 * threads))))
        tile = max(1, _cdiv(n, blocks))
    else:
        raise ValueError(f"segsum plan: path must be one of {PATHS}, got {path!r}")
    if entries <= TICKET_MAX_ENTRIES:
        round_blocks = 0
    else:
        round_blocks = min(_cdiv(entries, THREADS),
                           max(sm_count, _cdiv(entries, THREADS * ROUND_BATCH)))
    return Plan(path, blocks, threads, tile, round_blocks, _WS_HEAD + entries)


counter = build.LaunchCounter()
_sm_counts: dict = {}  # device -> SM count
_workspaces: dict = {}  # device -> the double workspace
_retired: list = []  # outgrown workspaces, kept for graphs captured with them
_launch = build.Launcher("segsum_moments", {  # the stream last
    "segsum_moments": [ctypes.c_void_p] * 2 + [ctypes.c_int] * 7 + [ctypes.c_void_p] * 3,
}, counter)


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


def sm_count(device: torch.device) -> int:
    """The card's SM count (cached per device)."""
    sms = _sm_counts.get(device)
    if sms is None:
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        _sm_counts[device] = sms
    return sms


def _workspace(device: torch.device, doubles: int) -> torch.Tensor:
    """The device's double workspace, at least ``doubles`` long: zeroed
    here when it is made or grown, left zeroed by every launch."""
    ws = _workspaces.get(device)
    if ws is None or ws.numel() < doubles:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("segsum_moments: call it once at this size outside CUDA "
                               "graph capture first, to allocate its workspace")
        if ws is not None:
            _retired.append(ws)
        ws = torch.zeros(doubles, dtype=torch.float64, device=device)
        _workspaces[device] = ws
    return ws


def reserve(device: torch.device, n: int, sz: int) -> None:
    """Allocate ``device``'s workspace now for calls of up to ``n`` points
    into ``sz`` nodes, so that no later call at those sizes allocates
    (and none may then be under CUDA graph capture). No-op off CUDA."""
    if device.type == "cuda":
        _workspace(device, plan(n, sz, sm_count(device)).workspace)


def launch(d: torch.Tensor, idx: torch.Tensor, sz: int, pl: Plan) -> torch.Tensor:
    """Run the kernel on checked CUDA tensors as ``pl`` says; one count."""
    dev = d.device
    out = torch.empty((sz, NCOL), dtype=d.dtype, device=dev)
    ws = _workspace(dev, pl.workspace)
    _launch("segsum_moments", d.dtype, dev, d.data_ptr(), idx.data_ptr(), d.shape[0], sz,
            PATHS.index(pl.path), pl.blocks, pl.threads, pl.tile, pl.round_blocks,
            ws.data_ptr(), out.data_ptr())
    return out


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
    if not (1 <= sz <= _MAX_N and d.shape[0] <= _MAX_N):
        raise ValueError(f"segsum_moments: need 1 <= sz <= {_MAX_N} and N <= {_MAX_N}, "
                         f"got sz={sz}, N={d.shape[0]}")
    return launch(d, idx, sz, plan(d.shape[0], sz, sm_count(d.device)))
