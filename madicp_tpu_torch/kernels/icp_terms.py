"""ICP terms and normal equations (K7): CUDA kernel and plain version.

From an association payload ``(..., L, 8)``, the moving points, their
valid mask and the pose ``X``: the gate, residual, Jacobian and weight of
every entry, and per leading index the symmetric ``(6, 6)`` H, the ``(6,)``
b and the ``(L,)`` matched mask. It is the body of
:func:`madicp_tpu_torch.ops.icp_core.terms_from_payload`, the counterpart
of the JAX package's ``madicp_tpu/ops/icp_core.py:69``
``terms_from_payload``. The kernel lives in ``csrc/icp_terms.cu`` (design
and bound in its header); :func:`terms_plain` is the same math in tensor
ops. Both form each entry's values in one order, the map-frame points
(:func:`moving_in_map`) included, so ``matched`` agrees bit for bit on
the card; H and b are sums in another order (the kernel's in double), and
the kernel takes ``bbox0 / b_max`` as torch's CUDA division by a host
scalar does, a product with the reciprocal.

``n_live`` (int64, leading axes that broadcast to the call's) bounds each
leading index's entries: an entry at or past it counts as invalid, so its
terms are zero and its ``matched`` false, and the kernel neither reads nor
forms it. The pipeline passes the count of a scan's valid leaves, which
:func:`~madicp_tpu_torch.ops.tree.get_leaves` packs into a prefix of their
slots: the walk stops where the leaves do, on the device, with no host
read. ``with_matched=False`` returns no ``matched`` (the kernel writes
none).

The kernel runs one launch a call: a thread-block cluster a leading
index, its blocks splitting the index's bound (:func:`plan`), a
contiguous payload read with 16-byte loads (:func:`vector_rows`). Dispatch is by the tensors'
device and nothing else: CPU tensors take the plain version, CUDA tensors
take the kernel or the call raises, a cluster launch the card refuses
included. The wrapper allocates only its outputs, reads nothing back to
the host and launches on the current stream, so it runs inside CUDA graph
capture.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from madicp_tpu_torch.kernels import build
from madicp_tpu_torch.ops.lie import broadcast_shape

counter = build.LaunchCounter()
# the __global__ functions of csrc/icp_terms.cu, as a CUDA trace names them
KERNEL_NAMES = ("terms_kernel",)
NSUM = 27  # 21 sums of H's upper triangle and 6 of b
BLOCKS = (256, 512)  # the block sizes csrc/icp_terms.cu takes
THREADS = 256  # the block where no cluster plan fits
MAX_CLUSTER = 8  # blocks a leading index, at most: the portable cluster size
MIN_PER_THREAD = 8  # entries a thread walks, at least
MAX_LEAD_AXES = 4
_launch = build.Launcher("icp_terms", {  # the stream last
    "icp_terms": ([ctypes.c_void_p] * 6 + [ctypes.c_double] * 3 + [ctypes.c_int]
                  + [ctypes.c_void_p] * 4),
}, counter)
_MAX_ENTRIES = 2**31 - 1


class Plan(NamedTuple):
    """A call's launch: ``cluster`` blocks of ``threads`` a leading index,
    each over ``tile`` consecutive entries of L (the kernel tiles a
    leading index's bound, where it has one, the same way: a whole number
    of warps, the cluster's blocks covering it)."""

    cluster: int
    tile: int
    threads: int


def plan(n_lead: int, L: int, capacity) -> Plan:
    """The launch of a call over ``n_lead`` leading indices of ``L``
    entries on a card that holds ``capacity(threads, cluster)`` clusters
    of ``cluster`` blocks of ``threads`` at once: among the block sizes
    of :data:`BLOCKS` and the clusters of 1 to :data:`MAX_CLUSTER` blocks
    that hold every leading index's cluster at once (one wave) and give a
    thread at least :data:`MIN_PER_THREAD` entries, the one with the most
    threads a leading index (the fewer blocks on a tie); one block of
    :data:`THREADS` where none does. Tiles of a multiple of 32 entries."""
    best = (0, 0, THREADS, 1)  # threads a lead, -cluster, threads, cluster
    for threads in BLOCKS:
        for cluster in range(1, MAX_CLUSTER + 1):
            if (n_lead <= capacity(threads, cluster)
                    and -(-L // (cluster * threads)) >= MIN_PER_THREAD):
                best = max(best, (cluster * threads, -cluster, threads, cluster))
    _, _, threads, cluster = best
    tile = -(-L // cluster)
    return Plan(cluster, -(-tile // 32) * 32, threads)


_CAPACITY: dict = {}


def card_capacity(device: torch.device, dtype: torch.dtype):
    """``capacity(threads, cluster)`` of :func:`plan` for the card and the
    working type: the clusters of the kernel that the card holds at once
    (``cudaOccupancyMaxActiveClusters``), asked once a device and type."""
    key = (device.index, dtype)
    if key not in _CAPACITY:
        fn = build.load("icp_terms").icp_terms_max_clusters
        fn.argtypes, fn.restype = [ctypes.c_int] * 3, ctypes.c_int
        with torch.cuda.device(device):
            _CAPACITY[key] = {(t, c): fn(int(dtype == torch.float64), t, c)
                              for t in BLOCKS for c in range(1, MAX_CLUSTER + 1)}
    table = _CAPACITY[key]
    return lambda threads, cluster: table[(threads, cluster)]


def vector_rows(payload: torch.Tensor, lead: tuple) -> bool:
    """Whether every payload row the kernel reads is 8 contiguous values
    at a 16-byte aligned address (its two or four 16-byte loads), seen
    with the leading shape ``lead`` (rows shared across a leading axis
    qualify); a view broadcast along its entries, strided or off a
    16-byte boundary takes the scalar loads."""
    per = 16 // payload.element_size()  # values in 16 bytes
    st = payload.expand(lead + tuple(payload.shape[-2:])).stride()
    return (st[-1] == 1 and st[-2] == 8 and payload.data_ptr() % 16 == 0
            and all(s % per == 0 for s in st[:-2]))


def moving_in_map(moving_pts: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """The moving points ``(..., L, 3)`` in the map frame of the poses
    ``X`` ``(..., 4, 4)`` (leading axes that broadcast), ``m R^T + t``:
    each coordinate ``((m_x R_c0 + m_y R_c1) + m_z R_c2) + t_c``, one
    rounding an operation, the kernels' order (K7's ``ml``, K6's query).
    Four tensor ops, the nine products first: no GEMM, whose order is the
    library's."""
    p = moving_pts[..., None, :] * X[..., None, :3, :3]  # (..., L, 3, 3): m_j R_cj
    return ((p[..., 0] + p[..., 1]) + p[..., 2]) + X[..., None, :3, 3]


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


def terms_plain(payload, moving_pts, moving_valid, X, *, b_max, b_ratio, rho_ker,
                n_live=None, with_matched=True):
    """Plain version: ``(H (..., 6, 6), b (..., 6), matched (..., L))``,
    the normal equations as one masked ``(s J)^T J`` product; the entries
    at or past ``n_live`` masked out (the module docstring), ``matched``
    None without ``with_matched``."""
    if n_live is not None:
        L = moving_valid.shape[-1]
        moving_valid = moving_valid & (torch.arange(L, device=n_live.device)
                                       < n_live[..., None])
    J, s, e, matched = entry_terms(payload, moving_pts, moving_valid, X,
                                   b_max=b_max, b_ratio=b_ratio, rho_ker=rho_ker)
    Js = J * s[..., None]
    H = Js.transpose(-1, -2) @ J
    b = torch.sum(Js * e[..., None], dim=-2)
    return H, b, matched if with_matched else None


def _lead(payload, moving_pts, moving_valid, X, n_live=None) -> tuple:
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
        lead = broadcast_shape(payload.shape[:-2], moving_pts.shape[:-2],
                               moving_valid.shape[:-1], X.shape[:-2])
    except RuntimeError as err:
        raise ValueError(f"icp_terms: leading axes do not broadcast: {err}") from None
    if n_live is not None:
        if n_live.device != dev:
            raise ValueError("icp_terms: n_live on another device than the payload")
        if n_live.dtype != torch.int64:
            raise TypeError(f"icp_terms: n_live must be int64, got {n_live.dtype}")
        try:
            fits = broadcast_shape(lead, n_live.shape) == lead
        except RuntimeError:
            fits = False
        if not fits:
            raise ValueError(f"icp_terms: n_live {tuple(n_live.shape)} does not broadcast to "
                             f"the leading shape {lead}")
    return lead


def _view(t: torch.Tensor, lead: tuple, own: int) -> list:
    """``t``'s strides seen with the leading shape ``lead`` (0 where it
    broadcasts), padded to 4 leading axes, then its last ``own`` axes'
    (two, the second 0 for a mask)."""
    st = t.expand(lead + tuple(t.shape[-own:])).stride()
    inner = list(st[len(lead):]) + [0] * (2 - own)
    return [0] * (MAX_LEAD_AXES - len(lead)) + list(st[:len(lead)]) + inner


def terms(payload, moving_pts, moving_valid, X, *, b_max, b_ratio, rho_ker, n_live=None,
          with_matched=True):
    """``(H, b, matched)`` of :func:`terms_plain` (same arguments): the
    plain version for CPU tensors, the kernel for CUDA ones."""
    lead = _lead(payload, moving_pts, moving_valid, X, n_live)
    if payload.device.type == "cpu":
        return terms_plain(payload, moving_pts, moving_valid, X, b_max=b_max, b_ratio=b_ratio,
                           rho_ker=rho_ker, n_live=n_live, with_matched=with_matched)
    pl = plan(math.prod(lead), payload.shape[-2], card_capacity(payload.device, payload.dtype))
    return launch(payload, moving_pts, moving_valid, X, b_max=b_max, b_ratio=b_ratio,
                  rho_ker=rho_ker, pl=pl, n_live=n_live, with_matched=with_matched)


def launch(payload, moving_pts, moving_valid, X, *, b_max, b_ratio, rho_ker, pl: Plan,
           n_live=None, with_matched=True):
    """Run the kernel on CUDA tensors as ``pl`` says (arguments and results
    as :func:`terms`); one count."""
    lead = _lead(payload, moving_pts, moving_valid, X, n_live)
    if len(lead) > MAX_LEAD_AXES:
        raise ValueError(f"icp_terms: at most {MAX_LEAD_AXES} leading axes, got {lead}")
    dev, dtype = payload.device, payload.dtype
    L = payload.shape[-2]
    n_lead = math.prod(lead)
    if n_lead * max(L, 1) > _MAX_ENTRIES:
        raise ValueError(f"icp_terms: at most {_MAX_ENTRIES} entries, got {n_lead} x {L}")
    rho = float(torch.sqrt(torch.tensor(rho_ker, dtype=dtype)))
    live = [0] * MAX_LEAD_AXES
    if n_live is not None:
        live = [0] * (MAX_LEAD_AXES - len(lead)) + list(n_live.expand(lead).stride())
    meta = ([1] * (MAX_LEAD_AXES - len(lead)) + list(lead)
            + _view(payload, lead, 2) + _view(moving_pts, lead, 2)
            + _view(moving_valid, lead, 1) + _view(X, lead, 2) + live
            + [L, pl.cluster, pl.threads, int(vector_rows(payload, lead))])
    meta = (ctypes.c_longlong * len(meta))(*meta)
    matched = torch.empty(lead + (L,), dtype=torch.bool, device=dev) if with_matched else None
    H = torch.empty(lead + (6, 6), dtype=dtype, device=dev)
    b = torch.empty(lead + (6,), dtype=dtype, device=dev)
    _launch("icp_terms", dtype, dev, meta, payload.data_ptr(), moving_pts.data_ptr(),
            moving_valid.data_ptr(), X.data_ptr(), None if n_live is None else n_live.data_ptr(),
            float(b_max), float(b_ratio), rho, n_lead,
            None if matched is None else matched.data_ptr(), H.data_ptr(), b.data_ptr())
    return H, b, matched
