"""The Gauss-Newton pose update (K10): CUDA kernel and plain version.

From a pose ``X (..., 4, 4)`` and its normal equations (state ordering
``[t(3), omega(3)]``), either summed ``H (..., 6, 6)``, ``b (..., 6)`` or
per keyframe ``H (..., K, 6, 6)``, ``b (..., K, 6)`` with weights ``w
(..., K)`` (the step's ``kf_valid_f``; the sums ``sum_k w_k H_k`` are
formed first): the Jacobi-scaled solve of ``H dx = -b``
(:func:`solve_gn`), the trust-region clamp (:func:`clamp_step`),
MAD-ICP's split increment (:func:`~madicp_tpu_torch.ops.lie.exp_se3_split`)
and ``X <- X dX``. It is the body of
:func:`madicp_tpu_torch.ops.icp_core.gn_se3_step` (the summed form) and of
a round of :func:`madicp_tpu_torch.models.pipeline.icp_rounds` (the
per-keyframe form), the counterparts of the JAX package's
``madicp_tpu/ops/icp_core.py:256`` ``gn_se3_step`` and
``madicp_tpu/models/pipeline.py:432-433``. The kernel lives in
``csrc/gn_update.cu`` (design and bound in its header);
:func:`gn_update_plain` is the same chain in tensor ops. The two agree to
a tolerance: the keyframe sum and the clamp's norms round otherwise than
torch's einsum and reductions (the solve, ``exp_so3`` and the product
follow one written order on both sides: ``csrc/lu6.cuh`` and
``csrc/lie.cuh``, :func:`lu_factor` and ``ops/lie.py``).

The solve is an explicit LU (:func:`lu_solve` on :func:`lu_factor`), not
``torch.linalg``'s:
a column that is zero below its pivot eliminates nothing, as in the JAX
reference's LU. An ``H`` with an infinite diagonal entry then gets the
reference's step (the components that do not depend on that row), where
LAPACK's ``getrf`` and cuSOLVER poison every later row with ``0 / NaN``
multipliers; a singular scaled system zeroes only its non-finite
components on every device.

Dispatch is by the tensors' device and nothing else: CPU tensors take the
plain version, CUDA tensors take the kernel (one launch a call, one warp
a sequence) or the call raises. The wrapper allocates only its outputs, reads
nothing back to the host and launches on the current stream, so it runs
inside CUDA graph capture.
"""

from __future__ import annotations

import ctypes
import math

import torch

from madicp_tpu_torch.kernels import build
from madicp_tpu_torch.ops.lie import broadcast_shape, exp_se3_split, se3_compose

counter = build.LaunchCounter()
# the __global__ functions of csrc/gn_update.cu, as a CUDA trace names them
KERNEL_NAMES = ("gn_update_kernel",)
_launch = build.Launcher("gn_update", {  # the stream last
    "gn_update": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 4,
}, counter)

# Trust-region bound on one GN step (as in the JAX package): inactive on
# nominal trajectories, it only stops catastrophic escapes when the match
# set is degenerate.
GN_STEP_MAX_T = 1.0  # metres
GN_STEP_MAX_R = 0.5  # radians


def lu_factor(M: torch.Tensor, n: int) -> tuple:
    """The elimination of an LU with partial pivoting of the leading ``n``
    columns of ``M (..., n, n + c)`` (a matrix, or a system with its
    right-hand sides beside it), in place: the kernels' steps in tensor
    ops (``csrc/lu6.cuh``, shared by K10 and K14). The pivot is the first
    largest magnitude on or below the diagonal (LAPACK's ``i?amax``: a NaN
    is taken only where it comes first); the multipliers are the column
    times the pivot's reciprocal, and a column that is zero below its
    pivot, or whose pivot is zero, eliminates nothing. Each value rounds
    one operation at a time. Returns ``(pivots, reciprocals, swaps)``: the
    n pivots and their reciprocals in position order and the count of
    steps whose pivot row was not the diagonal's (...)."""
    rows = torch.arange(n, device=M.device)
    pivots, inv_piv = [], []
    swaps = torch.zeros(M.shape[:-2], dtype=torch.int64, device=M.device)
    for k in range(n - 1):  # the last pivot is the last row's, with nothing below
        mag = M[..., k:, k].abs()
        # argmax takes the first NaN: only the diagonal's may be the pivot
        mag[..., 1:].nan_to_num_(nan=-1.0, posinf=math.inf)
        p = torch.argmax(mag, dim=-1, keepdim=True)  # (..., 1), from row k
        swaps = swaps + (p[..., 0] != 0)
        perm = torch.where(rows[:n - k] == p, 0, rows[:n - k])
        perm[..., 0] = p[..., 0]  # rows k and k + p swapped
        M[..., k:, :] = torch.take_along_dim(M[..., k:, :], perm[..., None], dim=-2)
        piv = M[..., k, k].clone()
        rp = torch.reciprocal(piv)
        pivots.append(piv)
        inv_piv.append(rp)
        below = M[..., k + 1:, k]
        skip = ((piv == 0) | (below == 0).all(dim=-1))[..., None, None]
        trail = M[..., k + 1:, k + 1:]
        trail.copy_(torch.where(skip, trail, trail - (below * rp[..., None])[..., None]
                                * M[..., k, None, k + 1:]))
    pivots.append(M[..., n - 1, n - 1].clone())
    inv_piv.append(torch.reciprocal(pivots[-1]))
    return pivots, inv_piv, swaps


def lu_solve(A: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Solve ``A y = r`` for ``A (..., 6, 6)``, ``r (..., 6)`` by
    :func:`lu_factor`; the substitution multiplies by the pivots'
    reciprocals. Each value rounds one operation at a time. Returns ``y``,
    non-finite where the system is singular."""
    M = torch.cat((A, r[..., None]), dim=-1)  # [A | r], rows swapped and eliminated in place
    n = A.shape[-1]
    _, inv_piv, _ = lu_factor(M, n)
    y = torch.empty_like(r)
    for k in reversed(range(n)):
        y[..., k] = M[..., k, n] * inv_piv[k]
        M[..., :k, n] -= M[..., :k, k] * y[..., k, None]
    return y


def solve_gn(H: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve ``H dx = -b`` with Jacobi scaling (translation and rotation
    blocks differ by ~range^2), by :func:`lu_solve`. Zeros when H is
    (numerically) empty; a component of the solve that is not finite is
    zero. The scales enter as reciprocals, as the kernel forms them."""
    diag = torch.diagonal(H, dim1=-2, dim2=-1)
    good = torch.sum(diag, dim=-1) > 0
    e = torch.reciprocal(torch.where(diag > 0, torch.sqrt(torch.clamp(diag, min=1e-30)), 1.0))
    eye = torch.eye(6, dtype=H.dtype, device=H.device)
    dx = lu_solve(H * (e[..., :, None] * e[..., None, :]) + 1e-8 * eye, -(b * e)) * e
    dx = torch.where(torch.isfinite(dx), dx, 0.0)
    return torch.where(good[..., None], dx, torch.zeros_like(dx))


def clamp_step(dx: torch.Tensor) -> torch.Tensor:
    """Scale dx = [t(3), w(3)] into the trust region (direction kept)."""
    dt = torch.sqrt(torch.sum(dx[..., :3] * dx[..., :3], dim=-1))
    dr = torch.sqrt(torch.sum(dx[..., 3:] * dx[..., 3:], dim=-1))
    scale = torch.clamp(
        torch.minimum(
            GN_STEP_MAX_T / torch.clamp(dt, min=1e-30),
            GN_STEP_MAX_R / torch.clamp(dr, min=1e-30),
        ),
        max=1.0,
    )
    return dx * scale[..., None]


def keyframe_sums(H: torch.Tensor, b: torch.Tensor, w: torch.Tensor) -> tuple:
    """``(sum_k w_k H_k, sum_k w_k b_k)`` of per-keyframe terms ``H (...,
    K, 6, 6)``, ``b (..., K, 6)`` and weights ``w (..., K)`` (the JAX
    package's ``madicp_tpu/models/pipeline.py:432-433``)."""
    return (torch.einsum("...k,...kij->...ij", w, H), torch.einsum("...k,...ki->...i", w, b))


def gn_update_plain(X: torch.Tensor, H: torch.Tensor, b: torch.Tensor, w=None):
    """Plain version: one right-multiplicative Gauss-Newton update of X
    (``mad_icp.cpp:105-117``); with ``w``, of the keyframe sums of ``H``
    and ``b``, returned beside it as ``(X dX, H, b)``."""
    if w is None:
        return se3_compose(X, exp_se3_split(clamp_step(solve_gn(H, b))))
    H, b = keyframe_sums(H, b, w)
    return se3_compose(X, exp_se3_split(clamp_step(solve_gn(H, b)))), H, b


def _lead(X, H, b, w=None) -> tuple:
    """Raise on what neither version takes (every device); the leading
    shape of the output."""
    dev = X.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"gn_update: unsupported device {dev}")
    if any(t.device != dev for t in (H, b) + (() if w is None else (w,))):
        raise ValueError("gn_update: X, H, b and w on different devices")
    if X.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"gn_update: X must be float32/float64, got {X.dtype}")
    if any(t.dtype != X.dtype for t in (H, b) + (() if w is None else (w,))):
        raise TypeError(f"gn_update: H {H.dtype}, b {b.dtype} and w must be X's {X.dtype}")
    k = 0 if w is None else 1  # the keyframe axis
    if (X.dim() < 2 or X.shape[-2:] != (4, 4) or H.dim() < 2 + k or H.shape[-2:] != (6, 6)
            or b.dim() < 1 + k or b.shape[-1] != 6):
        raise ValueError(f"gn_update: want X (..., 4, 4), H (...,{' K,' * k} 6, 6) and b "
                         f"(...,{' K,' * k} 6), got {tuple(X.shape)}, {tuple(H.shape)}, "
                         f"{tuple(b.shape)}")
    if w is not None and (w.dim() < 1 or H.shape[-3] != w.shape[-1]
                          or b.shape[-2] != w.shape[-1]):
        raise ValueError(f"gn_update: want w (..., K) of H's and b's K, got {tuple(w.shape)} "
                         f"for H {tuple(H.shape)} and b {tuple(b.shape)}")
    try:
        return broadcast_shape(X.shape[:-2], H.shape[:-2 - k], b.shape[:-1 - k],
                               *(() if w is None else (w.shape[:-1],)))
    except RuntimeError as err:
        raise ValueError(f"gn_update: leading axes do not broadcast: {err}") from None


def gn_update(X: torch.Tensor, H: torch.Tensor, b: torch.Tensor, w=None):
    """``X dX`` of :func:`gn_update_plain` (leading axes broadcast; with
    ``w``, ``(X dX, H, b)`` with the keyframe sums): the plain version for
    CPU tensors, the kernel for CUDA ones."""
    _lead(X, H, b, w)
    if X.device.type == "cpu":
        return gn_update_plain(X, H, b, w)
    return launch(X, H, b, w)


def _flat(t: torch.Tensor, lead: tuple, own: tuple) -> torch.Tensor:
    """``t`` expanded to ``lead + own`` with the leading axes as one,
    contiguous (a copy only where ``t`` is not: the step's operands are
    contiguous, a broadcast axis is made real)."""
    return t.expand(lead + own).reshape((math.prod(lead),) + own).contiguous()


def launch(X: torch.Tensor, H: torch.Tensor, b: torch.Tensor, w=None):
    """Run the kernel on CUDA tensors (arguments and results as
    :func:`gn_update`); one count."""
    lead = _lead(X, H, b, w)
    n = math.prod(lead)
    K = 1 if w is None else w.shape[-1]
    kf = () if w is None else (K,)
    Xf, Hf, bf = _flat(X, lead, (4, 4)), _flat(H, lead, kf + (6, 6)), _flat(b, lead, kf + (6,))
    wf = None if w is None else _flat(w, lead, (K,))
    out = torch.empty(lead + (4, 4), dtype=X.dtype, device=X.device)
    Hs = None if w is None else torch.empty(lead + (6, 6), dtype=X.dtype, device=X.device)
    bs = None if w is None else torch.empty(lead + (6,), dtype=X.dtype, device=X.device)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    _launch("gn_update", X.dtype, X.device, Xf.data_ptr(), Hf.data_ptr(), bf.data_ptr(),
            ptr(wf), n, K, out.data_ptr(), ptr(Hs), ptr(bs))
    return out if w is None else (out, Hs, bs)
