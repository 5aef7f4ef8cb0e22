"""ICP terms and normal equations (K7): CUDA kernel and plain version.

From an association payload ``(..., L, 8)``, the moving points, their
valid mask and the pose ``X``: the gate, residual, Jacobian and weight of
every entry, and per leading index the symmetric ``(6, 6)`` H, the ``(6,)``
b and the ``(L,)`` matched mask. It is the body of
:func:`madicp_tpu_torch.ops.icp_core.terms_from_payload`, the counterpart
of the JAX package's ``madicp_tpu/ops/icp_core.py:69``
``terms_from_payload``. The kernel lives in ``csrc/icp_terms.cu`` (design
and bound in its header); :func:`terms_plain` is the same math in tensor
ops. Both take the map-frame points from one torch expression
(:func:`moving_in_map`) and form each entry's values in one order, so
``matched`` agrees bit for bit on the card; H and b are sums in another
order (the kernel's in double), and the weight differs by the rounding of
``bbox0 / b_max`` (torch multiplies by the host scalar's reciprocal).

Dispatch is by the tensors' device and nothing else: CPU tensors take
the plain version, CUDA tensors take the kernel or the call raises. The
wrapper allocates its workspace per call with ``torch.empty``, reads
nothing back to the host and launches on the current stream, so it runs
inside CUDA graph capture.
"""

from __future__ import annotations

import ctypes
import math

import torch

from madicp_tpu_torch.kernels import build
from madicp_tpu_torch.kernels.segsum import sm_count

counter = build.LaunchCounter()
NSUM = 27  # 21 sums of H's upper triangle and 6 of b
THREADS = 256
BLOCKS_PER_SM = 4  # tiles a leading index gets, as far as L allows
MAX_LEAD_AXES = 4
_launch = build.Launcher("icp_terms", {  # the stream last
    "icp_terms": ([ctypes.c_void_p] * 6 + [ctypes.c_double] * 3 + [ctypes.c_int]
                  + [ctypes.c_void_p] * 5),
}, counter)
_MAX_ENTRIES = 2**31 - 1


def moving_in_map(moving_pts: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """The moving points in the map frame, ``m R^T + t`` (both versions)."""
    return moving_pts @ X[..., :3, :3].mT + X[..., None, :3, 3]


def entry_terms(payload, moving_pts, moving_valid, X, *, b_max, b_ratio, rho_ker):
    """Per-entry values of the plain version: ``(J (..., L, 6), s (..., L),
    e (..., L), matched (..., L))``. The gate is evaluated under the
    CURRENT ``X`` (``mad_icp.cpp:81-83``)."""
    dtype = moving_pts.dtype
    R = X[..., :3, :3]
    # the dtype's own square root, filled in on the device: a tensor copied
    # there from a host scalar would synchronise every GN round
    rho = torch.full((), torch.sqrt(torch.tensor(rho_ker, dtype=dtype)).item(),
                     dtype=dtype, device=X.device)

    ml = moving_in_map(moving_pts, X)
    mlx, mly, mlz = ml[..., 0], ml[..., 1], ml[..., 2]
    mx, my, mz = moving_pts[..., 0], moving_pts[..., 1], moving_pts[..., 2]
    fx, fy, fz = payload[..., 0], payload[..., 1], payload[..., 2]
    nx, ny, nz = payload[..., 3], payload[..., 4], payload[..., 5]
    f_bbox0 = payload[..., 6]
    f_ok = payload[..., 7] == 3.0

    # adaptive-radius gate (radius grows with point range)
    dx, dy, dz = mlx - fx, mly - fy, mlz - fz
    dist = torch.sqrt(dx * dx + dy * dy + dz * dz)
    src_ball = b_max + b_ratio * torch.sqrt(mx * mx + my * my + mz * mz)
    matched = (dist <= src_ball) & moving_valid & f_ok

    # residual and analytic Jacobian: with u = R^T n,
    # J = [u^T, (m x u)^T]  (since -u^T skew(m) = (m x u)^T)
    e = dx * nx + dy * ny + dz * nz
    r = lambda i, j: R[..., i, j, None]  # noqa: E731  (broadcasts over L)
    ux = nx * r(0, 0) + ny * r(1, 0) + nz * r(2, 0)
    uy = nx * r(0, 1) + ny * r(1, 1) + nz * r(2, 1)
    uz = nx * r(0, 2) + ny * r(1, 2) + nz * r(2, 2)
    J = torch.stack(
        [ux, uy, uz, my * uz - mz * uy, mz * ux - mx * uz, mx * uy - my * ux],
        dim=-1,
    )  # (..., L, 6)

    chi = torch.abs(e)
    scale = torch.where(chi > rho, rho / torch.clamp(chi, min=1e-30), 1.0)
    w_plan = torch.clamp(1.0 - f_bbox0 / b_max, 0.0, 1.0)
    s = scale * w_plan * w_plan * matched.to(dtype)
    return J, s, e, matched


def terms_plain(payload, moving_pts, moving_valid, X, *, b_max, b_ratio, rho_ker):
    """Plain version: ``(H (..., 6, 6), b (..., 6), matched (..., L))``,
    the normal equations as one masked ``(s J)^T J`` product."""
    J, s, e, matched = entry_terms(payload, moving_pts, moving_valid, X,
                                   b_max=b_max, b_ratio=b_ratio, rho_ker=rho_ker)
    Js = J * s[..., None]
    H = Js.transpose(-1, -2) @ J
    b = torch.sum(Js * e[..., None], dim=-2)
    return H, b, matched


def _lead(payload, moving_pts, moving_valid, X) -> tuple:
    """Raise on what neither version takes (every device); the leading
    shape the outputs carry."""
    dev = payload.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"icp_terms: unsupported device {dev}")
    if any(t.device != dev for t in (moving_pts, moving_valid, X)):
        raise ValueError("icp_terms: payload, moving_pts, moving_valid and X on "
                         "different devices")
    if payload.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"icp_terms: payload must be float32/float64, got {payload.dtype}")
    if moving_pts.dtype != payload.dtype or X.dtype != payload.dtype:
        raise TypeError(f"icp_terms: moving_pts {moving_pts.dtype} and X {X.dtype} must "
                        f"be the payload's {payload.dtype}")
    if moving_valid.dtype != torch.bool:
        raise TypeError(f"icp_terms: moving_valid must be bool, got {moving_valid.dtype}")
    if (payload.dim() < 2 or payload.shape[-1] != 8 or moving_pts.dim() < 2
            or moving_pts.shape[-1] != 3 or moving_valid.dim() < 1 or X.dim() < 2
            or X.shape[-2:] != (4, 4)):
        raise ValueError(
            f"icp_terms: want payload (..., L, 8), moving_pts (..., L, 3), "
            f"moving_valid (..., L) and X (..., 4, 4), got {tuple(payload.shape)}, "
            f"{tuple(moving_pts.shape)}, {tuple(moving_valid.shape)}, {tuple(X.shape)}")
    L = payload.shape[-2]
    if moving_pts.shape[-2] != L or moving_valid.shape[-1] != L:
        raise ValueError(f"icp_terms: {L} payload entries, {moving_pts.shape[-2]} points, "
                         f"{moving_valid.shape[-1]} valid flags")
    try:
        return tuple(torch.broadcast_shapes(payload.shape[:-2], moving_pts.shape[:-2],
                                            moving_valid.shape[:-1], X.shape[:-2]))
    except RuntimeError as err:
        raise ValueError(f"icp_terms: leading axes do not broadcast: {err}") from None


def _view(t: torch.Tensor, lead: tuple, own: int) -> list:
    """``t``'s strides seen with the leading shape ``lead`` (0 where it
    broadcasts), padded to 4 leading axes, then its last ``own`` axes'
    (two, the second 0 for a mask)."""
    st = t.expand(lead + tuple(t.shape[-own:])).stride()
    inner = list(st[len(lead):]) + [0] * (2 - own)
    return [0] * (MAX_LEAD_AXES - len(lead)) + list(st[:len(lead)]) + inner


def terms(payload, moving_pts, moving_valid, X, *, b_max, b_ratio, rho_ker):
    """``(H, b, matched)`` of :func:`terms_plain` (same arguments): the
    plain version for CPU tensors, the kernel for CUDA ones."""
    lead = _lead(payload, moving_pts, moving_valid, X)
    if payload.device.type == "cpu":
        return terms_plain(payload, moving_pts, moving_valid, X,
                           b_max=b_max, b_ratio=b_ratio, rho_ker=rho_ker)
    if len(lead) > MAX_LEAD_AXES:
        raise ValueError(f"icp_terms: at most {MAX_LEAD_AXES} leading axes, got {lead}")
    dev, dtype = payload.device, payload.dtype
    L = payload.shape[-2]
    n_lead = math.prod(lead)
    if n_lead * max(L, 1) > _MAX_ENTRIES:
        raise ValueError(f"icp_terms: at most {_MAX_ENTRIES} entries, got {n_lead} x {L}")
    ml = moving_in_map(moving_pts, X)
    rho = float(torch.sqrt(torch.tensor(rho_ker, dtype=dtype)))
    tiles = max(1, min(-(-L // THREADS), -(-BLOCKS_PER_SM * sm_count(dev) // max(n_lead, 1))))
    tile = -(-L // tiles)
    meta = ([1] * (MAX_LEAD_AXES - len(lead)) + list(lead)
            + _view(payload, lead, 2) + _view(ml, lead, 2) + _view(moving_pts, lead, 2)
            + _view(moving_valid, lead, 1) + _view(X, lead, 2) + [L, tiles, tile])
    meta = (ctypes.c_longlong * len(meta))(*meta)
    ws = torch.empty((n_lead, tiles, NSUM), dtype=torch.float64, device=dev)
    matched = torch.empty(lead + (L,), dtype=torch.bool, device=dev)
    H = torch.empty(lead + (6, 6), dtype=dtype, device=dev)
    b = torch.empty(lead + (6,), dtype=dtype, device=dev)
    _launch("icp_terms", dtype, dev, meta, payload.data_ptr(), ml.data_ptr(),
            moving_pts.data_ptr(), moving_valid.data_ptr(), X.data_ptr(), float(b_max),
            float(b_ratio), rho, n_lead, ws.data_ptr(), matched.data_ptr(), H.data_ptr(),
            b.data_ptr())
    return H, b, matched
