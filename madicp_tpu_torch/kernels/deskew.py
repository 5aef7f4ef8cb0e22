"""The deskew sweep (K12): CUDA kernel and plain version.

From a batch of clouds ``points (B, N, 3)``, their masks ``valid (B, N)``,
a flag a sequence ``do (B,)`` (the trajectory holds two poses) and each
sequence's per-bin motions ``R_bins (B, CHUNKS, 3, 3)``, ``t_trans (B,
CHUNKS, 3)`` (:func:`madicp_tpu_torch.ops.deskew.bin_motion`): every valid
point of a ``do`` sequence moved by its azimuth bin's rigid motion, every
other point passed through, in the cloud's own order. It is what
``deskew_cloud`` and the step's ``where`` compute
(``madicp_tpu_torch/ops/deskew.py``, ``models/pipeline.py`` ``_odometry_step``),
the counterparts of the JAX package's ``madicp_tpu/ops/deskew.py``
``deskew_cloud`` and ``madicp_tpu/models/pipeline.py:707-714``. XLA
lowered those, so no Pallas kernel stands behind them. The kernels live in
``csrc/deskew.cu`` (design and bound in its header);
:func:`deskew_sweep_plain` is the same math in tensor ops.

A point's bin (``pipeline.cpp:79-123``):

- ``binned``: ``clamp(floor((pi - az) / res), 0, CHUNKS - 1)`` of its
  azimuth ``az = atan2(y, x)``, ``res = 2 pi / CHUNKS``;
- ``reference``: the reference's once-per-point advance over the sweep in
  descending azimuth (:func:`sweep_order`): with ``c_j = clamp(ceil((pi -
  az_j) / res - 1), 0, CHUNKS - 1)`` (``CHUNKS - 1`` for an invalid point)
  at sorted position ``j``, ``k_j = min(j + 1, j + min_{i <= j} (c_i -
  i))``, clamped, is the bin of point ``order[j]``.

Both versions form every value in one explicit order, one rounding an
operation: ``pi`` and ``res`` are values of the working type and the
division is a true division (torch's CUDA division by a host scalar
multiplies by its reciprocal instead, so the plain version divides by a
0-dim tensor), and the apply is ``((R_c0 x + R_c1 y) + R_c2 z) + t_c`` (no
einsum, whose sum order is cuBLAS's). The reference mode's sort stays
``torch.argsort(stable=True)``: the kernel takes its order and the
azimuths it sorted. The kernel equals the plain version bit for bit where
its ``atan2`` equals torch's (the binned mode forms its own; torch's CUDA
``atan2`` calls the same ``atan2f``/``atan2``).

Dispatch is by the tensors' device and nothing else: CPU tensors take the
plain version, CUDA tensors take the kernel (one call a step: one launch
in the binned mode, a pair in the reference mode, whatever B is) or the
call raises. The wrapper allocates only its outputs and a per-call table
of tile minima, reads nothing back to the host and launches on the
current stream, so it runs inside CUDA graph capture.
"""

from __future__ import annotations

import ctypes
import math

import torch

from madicp_tpu_torch.kernels import build
from madicp_tpu_torch.ops.constants import CHUNKS

MODES = ("reference", "binned")
RESOLUTION = 2.0 * math.pi / CHUNKS  # azimuth bin width
TILE = 1024  # sorted positions a block of the reference mode (csrc/deskew.cu TILE)

counter = build.LaunchCounter()
# the __global__ functions of csrc/deskew.cu, as a CUDA trace names them
KERNEL_NAMES = ("binned_kernel", "tile_min_kernel", "reference_kernel")
_launch = build.Launcher("deskew", {  # the stream last
    "deskew_binned": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + [ctypes.c_double] * 2
    + [ctypes.c_void_p] * 3,
    "deskew_reference": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 2 + [ctypes.c_double] * 2
    + [ctypes.c_void_p] * 4,
}, counter)


def _constants(like: torch.Tensor) -> tuple:
    """``pi`` and the bin width as 0-dim tensors of ``like``'s type and
    device: a division by them is a true division on every device."""
    return tuple(torch.full((), v, dtype=like.dtype, device=like.device)
                 for v in (math.pi, RESOLUTION))


def azimuth(points: torch.Tensor) -> torch.Tensor:
    """``atan2(y, x)`` of every point (..., N)."""
    return torch.atan2(points[..., 1], points[..., 0])


def binned_bins(az: torch.Tensor) -> torch.Tensor:
    """Direct binning: ``clamp(floor((pi - az) / res), 0, CHUNKS - 1)``."""
    pi, res = _constants(az)
    return torch.clamp(torch.floor((pi - az) / res).long(), 0, CHUNKS - 1)


def sweep_order(az: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """The reference's traversal along the last axis: descending azimuth,
    ties in REVERSE original order (the reference sorts ascending and
    walks backwards, ``pipeline.cpp:97-110``), hence a STABLE ascending
    argsort flipped; invalid points sort to the end (azimuth -inf)."""
    key = torch.where(valid, az, -math.inf)
    return torch.flip(torch.argsort(key, dim=-1, stable=True), dims=(-1,))


def reference_bins(az: torch.Tensor, valid: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """Once-per-point bin advance over the sweep ``order``, in the cloud's
    order: the recurrence ``k_j = k_{j-1} + [k_{j-1} < q_j]`` in closed
    form, a prefix minimum (``madicp_tpu/ops/deskew.py`` ``_bins_reference``)."""
    pi, res = _constants(az)
    az_desc = torch.gather(torch.where(valid, az, -math.inf), -1, order)
    q = (pi - az_desc) / res - 1.0
    c = torch.clamp(torch.ceil(q), 0.0, float(CHUNKS - 1))
    j = torch.arange(az.shape[-1], dtype=az.dtype, device=az.device)
    pref = torch.cummin(c - j, dim=-1).values
    k_desc = torch.clamp(torch.minimum(j + 1.0, j + pref).long(), 0, CHUNKS - 1)
    return torch.zeros_like(k_desc).scatter_(-1, order, k_desc)


def apply_motion(points, bins, R_bins, t_trans) -> torch.Tensor:
    """Every point (N, 3) or (B, N, 3) moved by its bin's motion,
    ``((R_c0 x + R_c1 y) + R_c2 z) + t_c``; a batch reads each cloud's own
    tables through flat rows ``b * CHUNKS + bin``."""
    if points.dim() == 2:
        Rp, tp = R_bins.index_select(0, bins), t_trans.index_select(0, bins)
    else:
        B = points.shape[0]
        rows = (bins + (torch.arange(B, device=bins.device) * CHUNKS)[:, None]).reshape(-1)
        Rp = R_bins.reshape(B * CHUNKS, 3, 3).index_select(0, rows).view(bins.shape + (3, 3))
        tp = t_trans.reshape(B * CHUNKS, 3).index_select(0, rows).view(bins.shape + (3,))
    x, y, z = points.unbind(-1)
    return torch.stack([((Rp[..., c, 0] * x + Rp[..., c, 1] * y) + Rp[..., c, 2] * z)
                        + tp[..., c] for c in range(3)], dim=-1)


def sweep_bins(points, valid, mode: str, az=None, order=None) -> torch.Tensor:
    """Every point's bin (..., N) in ``mode``; the reference mode sorts
    (:func:`sweep_order`) unless given the ``order`` of ``az``."""
    az = azimuth(points) if az is None else az
    if mode == "binned":
        return binned_bins(az)
    if order is None:
        order = sweep_order(az, valid)
    return reference_bins(az, valid, order)


def deskew_sweep_plain(points, valid, do, R_bins, t_trans, mode: str, az=None, order=None,
                       return_bins: bool = False):
    """Plain version: the deskewed clouds (B, N, 3) (and, with
    ``return_bins``, every point's bin (B, N), int64)."""
    bins = sweep_bins(points, valid, mode, az, order)
    moved = apply_motion(points, bins, R_bins, t_trans)
    out = torch.where((do[:, None] & valid)[..., None], moved, points)
    return (out, bins) if return_bins else out


def _check(points, valid, do, R_bins, t_trans, mode, az, order) -> None:
    """Raise on what neither version takes (every device)."""
    dev, dtype = points.device, points.dtype
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"deskew_sweep: unsupported device {dev}")
    if mode not in MODES:
        raise ValueError(f"deskew mode must be 'reference' or 'binned', got {mode!r}")
    ts = [t for t in (valid, do, R_bins, t_trans, az, order) if t is not None]
    if any(t.device != dev for t in ts):
        raise ValueError("deskew_sweep: operands on different devices")
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"deskew_sweep: points must be float32/float64, got {dtype}")
    if any(t.dtype != dtype for t in (R_bins, t_trans) + ((az,) if az is not None else ())):
        raise TypeError(f"deskew_sweep: the tables and azimuths must be the points' {dtype}")
    if valid.dtype != torch.bool or do.dtype != torch.bool:
        raise TypeError("deskew_sweep: valid and do must be bool")
    if order is not None and order.dtype != torch.int64:
        raise TypeError(f"deskew_sweep: order must be int64, got {order.dtype}")
    if points.dim() != 3 or points.shape[-1] != 3:
        raise ValueError(f"deskew_sweep: want points (B, N, 3), got {tuple(points.shape)}")
    B, N, _ = points.shape
    want = {"valid": (valid, (B, N)), "do": (do, (B,)), "R_bins": (R_bins, (B, CHUNKS, 3, 3)),
            "t_trans": (t_trans, (B, CHUNKS, 3)), "az": (az, (B, N)), "order": (order, (B, N))}
    for name, (t, shape) in want.items():
        if t is not None and tuple(t.shape) != shape:
            raise ValueError(f"deskew_sweep: want {name} {shape}, got {tuple(t.shape)}")


def deskew_sweep(points, valid, do, R_bins, t_trans, mode: str):
    """The deskewed clouds of :func:`deskew_sweep_plain` (same arguments):
    the plain version for CPU tensors, the kernel for CUDA ones. The
    reference mode sorts the azimuths here (:func:`sweep_order`) and hands
    the kernel their order."""
    _check(points, valid, do, R_bins, t_trans, mode, None, None)
    if points.device.type == "cpu":
        return deskew_sweep_plain(points, valid, do, R_bins, t_trans, mode)
    if mode == "binned":
        return launch(points, valid, do, R_bins, t_trans, mode)
    az = azimuth(points)
    return launch(points, valid, do, R_bins, t_trans, mode, az, sweep_order(az, valid))


def launch(points, valid, do, R_bins, t_trans, mode: str, az=None, order=None,
           return_bins: bool = False):
    """Run the kernels on CUDA tensors (arguments and results as
    :func:`deskew_sweep_plain`; the reference mode needs ``az`` and its
    sweep ``order``, a permutation of each row); one count. ``return_bins``
    also writes every point's bin (int32)."""
    _check(points, valid, do, R_bins, t_trans, mode, az, order)
    if mode == "reference" and (az is None or order is None):
        raise ValueError("deskew_sweep: the reference mode's kernel takes az and order")
    B, N, _ = points.shape
    if N >= 1 << 24:  # c - j and j + 1 stay exact integers in float32
        raise ValueError(f"deskew_sweep: {N} points a cloud, at most {(1 << 24) - 1}")
    dev, dtype = points.device, points.dtype
    ins = [t.contiguous() for t in (points, valid, do, R_bins, t_trans)]
    out = torch.empty((B, N, 3), dtype=dtype, device=dev)
    bins = torch.empty((B, N), dtype=torch.int32, device=dev) if return_bins else None
    bins_ptr = None if bins is None else bins.data_ptr()
    if mode == "binned":
        _launch("deskew_binned", dtype, dev, *(t.data_ptr() for t in ins), B, N, math.pi,
                RESOLUTION, out.data_ptr(), bins_ptr)
    else:
        extra = [az.contiguous(), order.contiguous()]
        tile_min = torch.empty((B, -(-N // TILE)), dtype=torch.int32, device=dev)
        _launch("deskew_reference", dtype, dev, *(t.data_ptr() for t in ins + extra), B, N,
                math.pi, RESOLUTION, tile_min.data_ptr(), out.data_ptr(), bins_ptr)
    return (out, bins) if return_bins else out
