"""The certified round's slack pass (K11): CUDA kernel and plain version.

In each later round of the certified exact schedule, every (sequence,
keyframe, leaf) entry's slack (its last descent's path margin, less the
displacement of its query since then) shrinks by the query's exact
displacement between the previous and the current pose; the entries whose
slack no longer clears a rounding floor re-descend. From the slack ``(B,
K, L)``, the poses ``Xp``, ``X`` ``(B, 4, 4)``, the leaves ``(B, L, 3)``
and their norms ``r_norm (B, L)``, ``leaves_valid (B, L)`` and ``kf_live
(B, K)``: the slack decremented in place, ``need (B, K, L)`` (the entries
to re-descend) and the descent count added into ``n_descents (B,)`` in
place. It is the tail of a certified round in
:func:`madicp_tpu_torch.models.pipeline.icp_rounds`, the counterpart of
the JAX package's ``madicp_tpu/models/pipeline.py:531-558``
``motion_bound`` and ``eps_cert`` and its rounds' slack, ``uncert`` and
count. The kernel lives in ``csrc/certify_slack.cu`` (design and bound in
its header); :func:`certify_slack_plain` is the same math in tensor ops.

``n_live`` (B,) int64 bounds each sequence's leaves: an entry at or past it
keeps its slack and its ``need`` reads false, and the kernel loads nothing
of a leaf tile wholly past it. The pipeline passes the count of a scan's
valid leaves, a prefix of their slots
(:func:`~madicp_tpu_torch.ops.tree.get_leaves`), so nothing it cuts off
was live.

``need`` is a soundness decision, so both versions form every value in one
explicit order, one rounding an operation: ``d_c = ((m_x dR_c0 + m_y
dR_c1) + m_z dR_c2) + dt_c`` with ``dR = R - Rp``, ``dt = t - tp`` (no
GEMM, whose order is cuBLAS's), norms as ``(x^2 + y^2) + z^2``, and
``eps_cert = (64 eps) ((1 + |t|) + r_norm)``; the kernel's ``need`` and
count equal the plain version's bit for bit.

Dispatch is by the tensors' device and nothing else: CPU tensors take the
plain version, CUDA tensors take the kernel (one launch a round, over leaf
tiles, keyframe groups and sequences) or the call raises. The wrapper
allocates only ``need``, reads nothing back to the host and launches on
the current stream, so it runs inside CUDA graph capture.
"""

from __future__ import annotations

import ctypes

import torch

from madicp_tpu_torch.kernels import build

counter = build.LaunchCounter()
# the __global__ functions of csrc/certify_slack.cu, as a CUDA trace names them
KERNEL_NAMES = ("certify_slack_kernel",)
_launch = build.Launcher("certify_slack", {  # the stream last
    "certify_slack": [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3,
}, counter)


def _norm(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """``sqrt((x^2 + y^2) + z^2)``, one rounding an operation."""
    return torch.sqrt((x * x + y * y) + z * z)


def motion_bound(pts: torch.Tensor, Xp: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """Exact per-leaf displacement ``|X m - Xp m|`` (B, L) of the leaves
    ``pts`` (B, L, 3) between the poses ``Xp`` and ``X`` (B, 4, 4). Its
    own rounding must stay below :func:`eps_cert`: keep it a norm of
    differences. An arccos angle bound carries ~sqrt(eps) error and
    certifies near-zero-slack entries unsoundly (JAX package,
    models/pipeline.py:531-558)."""
    dR = X[:, :3, :3] - Xp[:, :3, :3]
    dt = X[:, :3, 3] - Xp[:, :3, 3]
    m = pts
    d = [((m[..., 0] * dR[:, c, 0, None] + m[..., 1] * dR[:, c, 1, None])
          + m[..., 2] * dR[:, c, 2, None]) + dt[:, c, None] for c in range(3)]
    return _norm(*d)


def eps_cert(X: torch.Tensor, r_norm: torch.Tensor) -> torch.Tensor:
    """The certificate's rounding floor (B, L): the side dot-product's
    rounding noise scales with the map-frame coordinate magnitude.

    It covers the rounding of the query the margin was taken at and of
    the one a later round descends with. The descent forms each query in
    its kernel (``kernels/csrc/descent.cu``, K7's ``ml``): a coordinate is
    ``((m_x R_c0 + m_y R_c1) + m_z R_c2) + t_c``, three products and three
    sums, each rounded once, no FMA. A sum of four terms so formed is
    within ``gamma_4 = 4u / (1 - 4u)`` (``u = eps / 2``) of the exact one
    times the sum of the terms' magnitudes, whatever their order, and R's
    rows are unit vectors, so ``|q_c - exact| <= 2.01 eps (|m| + |t_c|)``
    and ``|q - exact| <= 2.01 eps (sqrt(3) r + |t|)``. The matrix product
    that formed the queries before, in the library's order, with or
    without FMAs, met the same bound, no better. Two queries' rounding,
    ``< 7 eps r + 4.1 eps |t|``, and the side value's own rounding (three
    products and two sums over ``q - c``) stay far below ``64 eps ((1 +
    |t|) + r)``: the floor is unchanged."""
    t_norm = _norm(X[:, 0, 3], X[:, 1, 3], X[:, 2, 3])
    return 64.0 * torch.finfo(X.dtype).eps * ((1.0 + t_norm[:, None]) + r_norm)


def certify_slack_plain(slack, Xp, X, pts, r_norm, leaves_valid, kf_live, n_descents,
                        n_live=None):
    """Plain version: ``slack -= bound`` and ``n_descents += count`` in
    place; returns ``need`` (B, K, L). From ``n_live`` on the slack is kept
    and ``need`` false."""
    bound = motion_bound(pts, Xp, X)[:, None, :]
    if n_live is None:
        slack.sub_(bound)
    else:
        keep = torch.arange(slack.shape[-1], device=slack.device) < n_live[:, None]
        leaves_valid = leaves_valid & keep
        slack.copy_(torch.where(keep[:, None, :], slack - bound, slack))
    need = ((slack <= eps_cert(X, r_norm)[:, None, :]) & leaves_valid[:, None, :]
            & kf_live[:, :, None])
    n_descents.add_(need.sum(dim=(1, 2)))
    return need


def _check(slack, Xp, X, pts, r_norm, leaves_valid, kf_live, n_descents, n_live=None) -> None:
    """Raise on what neither version takes (every device)."""
    dev, dtype = slack.device, slack.dtype
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"certify_slack: unsupported device {dev}")
    ts = (Xp, X, pts, r_norm, leaves_valid, kf_live, n_descents)
    if any(t.device != dev for t in ts):
        raise ValueError("certify_slack: operands on different devices")
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"certify_slack: slack must be float32/float64, got {dtype}")
    if any(t.dtype != dtype for t in (Xp, X, pts, r_norm)):
        raise TypeError(f"certify_slack: Xp, X, pts and r_norm must be the slack's {dtype}")
    if leaves_valid.dtype != torch.bool or kf_live.dtype != torch.bool:
        raise TypeError("certify_slack: leaves_valid and kf_live must be bool")
    if n_descents.dtype != torch.int64:
        raise TypeError(f"certify_slack: n_descents must be int64, got {n_descents.dtype}")
    if slack.dim() != 3:
        raise ValueError(f"certify_slack: want slack (B, K, L), got {tuple(slack.shape)}")
    B, K, L = slack.shape
    want = {"Xp": (Xp, (B, 4, 4)), "X": (X, (B, 4, 4)), "pts": (pts, (B, L, 3)),
            "r_norm": (r_norm, (B, L)), "leaves_valid": (leaves_valid, (B, L)),
            "kf_live": (kf_live, (B, K)), "n_descents": (n_descents, (B,))}
    if n_live is not None:
        if n_live.device != dev:
            raise ValueError("certify_slack: operands on different devices")
        if n_live.dtype != torch.int64:
            raise TypeError(f"certify_slack: n_live must be int64, got {n_live.dtype}")
        want["n_live"] = (n_live, (B,))
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"certify_slack: want {name} {shape}, got {tuple(t.shape)}")


def certify_slack(slack, Xp, X, pts, r_norm, leaves_valid, kf_live, n_descents, n_live=None):
    """``need`` of :func:`certify_slack_plain` (same arguments, the same
    updates in place): the plain version for CPU tensors, the kernel for
    CUDA ones."""
    _check(slack, Xp, X, pts, r_norm, leaves_valid, kf_live, n_descents, n_live)
    if slack.device.type == "cpu":
        return certify_slack_plain(slack, Xp, X, pts, r_norm, leaves_valid, kf_live,
                                   n_descents, n_live)
    return launch(slack, Xp, X, pts, r_norm, leaves_valid, kf_live, n_descents, n_live)


def launch(slack, Xp, X, pts, r_norm, leaves_valid, kf_live, n_descents, n_live=None):
    """Run the kernel on CUDA tensors (arguments and result as
    :func:`certify_slack`); one count. ``slack`` and ``n_descents`` must
    be contiguous (they are written in place); the inputs are read
    contiguous (no copy where they are)."""
    _check(slack, Xp, X, pts, r_norm, leaves_valid, kf_live, n_descents, n_live)
    if not (slack.is_contiguous() and n_descents.is_contiguous()):
        raise ValueError("certify_slack: slack and n_descents must be contiguous (updated "
                         "in place)")
    B, K, L = slack.shape
    need = torch.empty((B, K, L), dtype=torch.bool, device=slack.device)
    ins = [t.contiguous() for t in (Xp, X, pts, r_norm, leaves_valid, kf_live)]
    live = None if n_live is None else n_live.contiguous()
    _launch("certify_slack", slack.dtype, slack.device, slack.data_ptr(),
            *(t.data_ptr() for t in ins), None if live is None else live.data_ptr(), B, K, L,
            need.data_ptr(), n_descents.data_ptr())
    return need
