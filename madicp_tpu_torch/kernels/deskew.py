"""The deskew sweep (K12): CUDA kernel and plain version.

From a batch of clouds ``points (B, N, 3)``, their masks ``valid (B, N)``,
a flag a sequence ``do (B,)`` (the trajectory holds two poses), each
sequence's last two trajectory poses ``T_prev, T_now (B, 4, 4)`` and the
sensor rate ``hz`` (a 0-dim tensor): every valid point of a ``do``
sequence moved by its azimuth bin's rigid motion, every other point
passed through, in the cloud's own order. It is what ``deskew_cloud``
and the step's ``where`` compute (``madicp_tpu_torch/ops/deskew.py``,
``models/pipeline.py`` ``_odometry_step``), the counterparts of the JAX
package's ``madicp_tpu/ops/deskew.py`` ``deskew_cloud`` (its bin motions
``_bin_times_and_motion`` included) and
``madicp_tpu/models/pipeline.py:707-714``. XLA lowered those, so no
Pallas kernel stands behind them. The kernels live in ``csrc/deskew.cu``
(design and bound in its header); :func:`deskew_sweep_plain` is the same
math in tensor ops.

A bin's motion (``pipeline.cpp:82-108``, :func:`bin_motion_plain`): the
naive velocity ``v_lin = t_rel / ts``, ``v_ang = log_so3(R_rel) / ts`` of
``T_prev^-1 T_now`` over one scan period ``ts = 1 / hz``, and at bin
``k`` the time ``t_k = -ts + k ts / (CHUNKS - 1)``, the rotation
``exp_so3(v_ang t_k)`` and the translation ``v_lin t_k``.

A point's bin (``pipeline.cpp:79-123``):

- ``binned``: ``clamp(floor((pi - az) / res), 0, CHUNKS - 1)`` of its
  azimuth ``az = atan2(y, x)``, ``res = 2 pi / CHUNKS``;
- ``reference``: the reference's once-per-point advance over the sweep in
  descending azimuth (:func:`sweep_order`): with ``c_j = clamp(ceil((pi -
  key_j) / res - 1), 0, CHUNKS - 1)`` at sorted position ``j`` (an invalid
  point's key is -inf, so its ``c`` is ``CHUNKS - 1``), ``k_j = min(j + 1,
  j + min_{i <= j} (c_i - i))``, clamped, is the bin of point ``order[j]``.

Both versions form every value in one explicit order, one rounding an
operation, on per-component tensors: the relative pose as the products
of ``T_prev^-1 T_now`` written out, ``log_so3`` with its near-pi
sub-branches, regular and Taylor branches, ``exp_so3`` with its
``theta^2 < 1e-8`` branch and ``K K`` in closed form, the apply as ``((R_c0
x + R_c1 y) + R_c2 z) + t_c``; no ``@``, einsum or ``torch.sum``, whose
order is torch's or cuBLAS's. Constants are 0-dim tensors of the working
type, so a division by one is a true division on every device (torch's
CUDA division by a Python scalar multiplies by its reciprocal). The
reference mode's sort stays ``torch.sort(stable=True)``: the kernel
takes the sorted keys and their order. The kernel equals the plain
version bit for bit where the CUDA math library's ``atan2``, ``acos`` and
``sin`` equal torch's (torch's CUDA ops call the same functions).

Dispatch is by the tensors' device and nothing else: CPU tensors take the
plain version, CUDA tensors take the kernel (one launch a call in either
mode, whatever B is) or the call raises. The wrapper allocates only its
outputs, reads nothing back to the host and launches on the current
stream, so it runs inside CUDA graph capture.
"""

from __future__ import annotations

import ctypes
import math

import torch

from madicp_tpu_torch.kernels import build
from madicp_tpu_torch.ops.constants import CHUNKS
from madicp_tpu_torch.ops.lie import exp_so3_components, relative_pose, scalars

MODES = ("reference", "binned")
RESOLUTION = 2.0 * math.pi / CHUNKS  # azimuth bin width

counter = build.LaunchCounter()
# the __global__ functions of csrc/deskew.cu, as a CUDA trace names them
KERNEL_NAMES = ("binned_kernel", "reference_kernel")
_launch = build.Launcher("deskew", {  # the stream last
    "deskew_binned": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2 + [ctypes.c_double] * 2
    + [ctypes.c_void_p] * 3,
    "deskew_reference": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 2 + [ctypes.c_double] * 2
    + [ctypes.c_void_p] * 3,
}, counter)


def azimuth(points: torch.Tensor) -> torch.Tensor:
    """``atan2(y, x)`` of every point (..., N)."""
    return torch.atan2(points[..., 1], points[..., 0])


# ------------------------------------------------------------ bin motions --
def _log_so3(R: list) -> list:
    """``log_so3`` (``ops/lie.py``, ``lie_algebra.h:54-89``) of a rotation
    given as per-component tensors, in the kernel's order."""
    like = R[0][0]
    one, two, half, twelve, pi = scalars(like, 1.0, 2.0, 0.5, 12.0, math.pi)
    tiny, near, axis_tol, taylor = scalars(like, 1e-30, 1e-10, 1e-5, -1e-7)
    tr = (R[0][0] + R[1][1]) + R[2][2]

    def axis(i, a, b, c):  # (pi / sqrt(max(2 + 2 R_ii, 1e-30))) [a, b, c]
        f = pi / torch.sqrt(torch.clamp(two + two * R[i][i], min=tiny))
        return [f * a, f * b, f * c]

    b2 = axis(2, R[0][2], R[1][2], one + R[2][2])
    b1 = axis(1, R[0][1], one + R[1][1], R[2][1])
    b0 = axis(0, one + R[0][0], R[1][0], R[2][0])
    use2 = torch.abs(R[2][2] + one) > axis_tol
    use1 = torch.abs(R[1][1] + one) > axis_tol
    pi_w = [torch.where(use2, x2, torch.where(use1, x1, x0)) for x2, x1, x0 in zip(b2, b1, b0)]

    tr3 = tr - 3.0
    theta = torch.arccos(torch.clamp((tr - one) * half, -1.0, 1.0))
    sn = torch.sin(theta)
    mag_reg = theta / torch.where(torch.abs(sn) < tiny, one, two * sn)
    mag_taylor = half - (tr3 * tr3) / twelve
    mag = torch.where(tr3 < taylor, mag_reg, mag_taylor)
    main = [mag * (R[2][1] - R[1][2]), mag * (R[0][2] - R[2][0]), mag * (R[1][0] - R[0][1])]
    near_pi = (tr + one) < near
    return [torch.where(near_pi, a, b) for a, b in zip(pi_w, main)]


def bin_motion_plain(T_prev: torch.Tensor, T_now: torch.Tensor, hz: torch.Tensor) -> tuple:
    """Naive velocity + per-bin rigid motions ``(R_bins (..., CHUNKS, 3, 3),
    t_trans (..., CHUNKS, 3))`` of poses ``(..., 4, 4)`` and a 0-dim rate
    ``hz`` (``pipeline.cpp:82-108``; the JAX package's
    ``_bin_times_and_motion``), every value in the kernel's order."""
    one, last = scalars(T_now, 1.0, float(CHUNKS - 1))
    ts = one / hz
    R_rel, t_rel = relative_pose(T_prev, T_now)
    v_lin = [c / ts for c in t_rel]
    v_ang = [c / ts for c in _log_so3(R_rel)]
    delta = ts / last
    t_bins = -ts + delta * torch.arange(CHUNKS, dtype=T_now.dtype, device=T_now.device)
    R = exp_so3_components([c[..., None] * t_bins for c in v_ang])  # (..., CHUNKS) each
    R_bins = torch.stack(R, dim=-1).unflatten(-1, (3, 3))
    t_trans = torch.stack([c[..., None] * t_bins for c in v_lin], dim=-1)
    return R_bins, t_trans


# ------------------------------------------------------------------ bins --
def binned_bins(az: torch.Tensor) -> torch.Tensor:
    """Direct binning: ``clamp(floor((pi - az) / res), 0, CHUNKS - 1)``."""
    pi, res = scalars(az, math.pi, RESOLUTION)
    return torch.clamp(torch.floor((pi - az) / res).long(), 0, CHUNKS - 1)


def sweep_order(az: torch.Tensor, valid: torch.Tensor) -> tuple:
    """``(keys, order)`` along the last axis: the azimuths with invalid
    points at -inf, sorted ascending by a STABLE sort, and their indices.
    The reference's traversal is descending azimuth with ties in reverse
    original order (it sorts ascending and walks backwards,
    ``pipeline.cpp:97-110``): these arrays read from the end."""
    return torch.sort(torch.where(valid, az, -math.inf), dim=-1, stable=True)


def reference_bins(keys: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """Once-per-point bin advance over the sweep of :func:`sweep_order`'s
    ``keys`` and ``order``, in the cloud's order: the recurrence ``k_j =
    k_{j-1} + [k_{j-1} < q_j]`` in closed form, a prefix minimum
    (``madicp_tpu/ops/deskew.py`` ``_bins_reference``)."""
    pi, res = scalars(keys, math.pi, RESOLUTION)
    desc = torch.flip(keys, dims=(-1,))  # traversal order
    c = torch.clamp(torch.ceil((pi - desc) / res - 1.0), 0.0, float(CHUNKS - 1))
    j = torch.arange(keys.shape[-1], dtype=keys.dtype, device=keys.device)
    pref = torch.cummin(c - j, dim=-1).values
    k_desc = torch.clamp(torch.minimum(j + 1.0, j + pref).long(), 0, CHUNKS - 1)
    return torch.zeros_like(k_desc).scatter_(-1, torch.flip(order, dims=(-1,)), k_desc)


def sweep_bins(points, valid, mode: str, keys=None, order=None) -> torch.Tensor:
    """Every point's bin (..., N) in ``mode``; the reference mode sorts
    (:func:`sweep_order`) unless given the ``keys`` and their ``order``."""
    if mode == "binned":
        return binned_bins(azimuth(points))
    if keys is None:
        keys, order = sweep_order(azimuth(points), valid)
    return reference_bins(keys, order)


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


# -------------------------------------------------------------- the sweep --
def deskew_sweep_plain(points, valid, do, T_prev, T_now, hz, mode: str, keys=None, order=None,
                       return_bins: bool = False):
    """Plain version: the deskewed clouds (B, N, 3) (and, with
    ``return_bins``, every point's bin (B, N), int64)."""
    R_bins, t_trans = bin_motion_plain(T_prev, T_now, hz)
    bins = sweep_bins(points, valid, mode, keys, order)
    moved = apply_motion(points, bins, R_bins, t_trans)
    out = torch.where((do[:, None] & valid)[..., None], moved, points)
    return (out, bins) if return_bins else out


def _check(points, valid, do, T_prev, T_now, hz, mode, keys, order) -> None:
    """Raise on what neither version takes (every device)."""
    dev, dtype = points.device, points.dtype
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"deskew_sweep: unsupported device {dev}")
    if mode not in MODES:
        raise ValueError(f"deskew mode must be 'reference' or 'binned', got {mode!r}")
    ts = [t for t in (valid, do, T_prev, T_now, hz, keys, order) if t is not None]
    if any(t.device != dev for t in ts):
        raise ValueError("deskew_sweep: operands on different devices")
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"deskew_sweep: points must be float32/float64, got {dtype}")
    if any(t.dtype != dtype for t in (T_prev, T_now, hz) + ((keys,) if keys is not None else ())):
        raise TypeError(f"deskew_sweep: the poses, rate and keys must be the points' {dtype}")
    if valid.dtype != torch.bool or do.dtype != torch.bool:
        raise TypeError("deskew_sweep: valid and do must be bool")
    if order is not None and order.dtype != torch.int64:
        raise TypeError(f"deskew_sweep: order must be int64, got {order.dtype}")
    if points.dim() != 3 or points.shape[-1] != 3:
        raise ValueError(f"deskew_sweep: want points (B, N, 3), got {tuple(points.shape)}")
    B, N, _ = points.shape
    want = {"valid": (valid, (B, N)), "do": (do, (B,)), "T_prev": (T_prev, (B, 4, 4)),
            "T_now": (T_now, (B, 4, 4)), "hz": (hz, ()), "keys": (keys, (B, N)),
            "order": (order, (B, N))}
    for name, (t, shape) in want.items():
        if t is not None and tuple(t.shape) != shape:
            raise ValueError(f"deskew_sweep: want {name} {shape}, got {tuple(t.shape)}")


def deskew_sweep(points, valid, do, T_prev, T_now, hz, mode: str):
    """The deskewed clouds of :func:`deskew_sweep_plain` (same arguments):
    the plain version for CPU tensors, the kernel for CUDA ones. The
    reference mode sorts the azimuths here (:func:`sweep_order`) and hands
    the kernel the sorted keys and their order."""
    _check(points, valid, do, T_prev, T_now, hz, mode, None, None)
    if points.device.type == "cpu":
        return deskew_sweep_plain(points, valid, do, T_prev, T_now, hz, mode)
    if mode == "binned":
        return launch(points, valid, do, T_prev, T_now, hz, mode)
    return launch(points, valid, do, T_prev, T_now, hz, mode,
                  *sweep_order(azimuth(points), valid))


def launch(points, valid, do, T_prev, T_now, hz, mode: str, keys=None, order=None,
           return_bins: bool = False):
    """Run the kernel on CUDA tensors (arguments and results as
    :func:`deskew_sweep_plain`; the reference mode needs the sorted
    ``keys`` and their ``order`` of :func:`sweep_order`); one count.
    ``return_bins`` also writes every point's bin (int32)."""
    _check(points, valid, do, T_prev, T_now, hz, mode, keys, order)
    if mode == "reference" and (keys is None or order is None):
        raise ValueError("deskew_sweep: the reference mode's kernel takes keys and order")
    B, N, _ = points.shape
    if N >= 1 << 24:  # c - j and j + 1 stay exact integers in float32
        raise ValueError(f"deskew_sweep: {N} points a cloud, at most {(1 << 24) - 1}")
    dev, dtype = points.device, points.dtype
    out = torch.empty((B, N, 3), dtype=dtype, device=dev)
    bins = torch.empty((B, N), dtype=torch.int32, device=dev) if return_bins else None
    bins_ptr = None if bins is None else bins.data_ptr()
    poses = [t.contiguous() for t in (T_prev, T_now, hz)]
    if mode == "binned":
        ins = [points.contiguous(), valid.contiguous(), do.contiguous()] + poses
        _launch("deskew_binned", dtype, dev, *(t.data_ptr() for t in ins), B, N, math.pi,
                RESOLUTION, out.data_ptr(), bins_ptr)
    else:
        ins = [points.contiguous(), do.contiguous()] + poses + [keys.contiguous(),
                                                                 order.contiguous()]
        _launch("deskew_reference", dtype, dev, *(t.data_ptr() for t in ins), B, N, math.pi,
                RESOLUTION, out.data_ptr(), bins_ptr)
    return (out, bins) if return_bins else out
