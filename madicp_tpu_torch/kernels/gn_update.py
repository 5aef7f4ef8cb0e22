"""The Gauss-Newton pose update (K10): CUDA kernel and plain version.

From a pose ``X (..., 4, 4)`` and its normal equations ``H (..., 6, 6)``,
``b (..., 6)`` (state ordering ``[t(3), omega(3)]``): the Jacobi-scaled
solve of ``H dx = -b`` (:func:`solve_gn`), the trust-region clamp
(:func:`clamp_step`), MAD-ICP's split increment
(:func:`~madicp_tpu_torch.ops.lie.exp_se3_split`) and ``X <- X dX``. It is
the body of :func:`madicp_tpu_torch.ops.icp_core.gn_se3_step`, the
counterpart of the JAX package's ``madicp_tpu/ops/icp_core.py:256``
``gn_se3_step``. The kernel lives in ``csrc/gn_update.cu`` (design and
bound in its header); :func:`gn_update_plain` is the same chain in tensor
ops. The two agree to a tolerance: the kernel's LU and product round
otherwise than cuSOLVER's and cuBLAS's.

Dispatch is by the tensors' device and nothing else: CPU tensors take the
plain version, CUDA tensors take the kernel (one launch a call, one thread
a sequence) or the call raises. The wrapper allocates only its output,
reads nothing back to the host and launches on the current stream, so it
runs inside CUDA graph capture.
"""

from __future__ import annotations

import ctypes
import math

import torch

from madicp_tpu_torch.kernels import build
from madicp_tpu_torch.ops.lie import exp_se3_split

counter = build.LaunchCounter()
# the __global__ functions of csrc/gn_update.cu, as a CUDA trace names them
KERNEL_NAMES = ("gn_update_kernel",)
_launch = build.Launcher("gn_update", {  # the stream last
    "gn_update": [ctypes.c_void_p] * 4 + [ctypes.c_int] + [ctypes.c_void_p] * 2,
}, counter)

# Trust-region bound on one GN step (as in the JAX package): inactive on
# nominal trajectories, it only stops catastrophic escapes when the match
# set is degenerate.
GN_STEP_MAX_T = 1.0  # metres
GN_STEP_MAX_R = 0.5  # radians


def solve_gn(H: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve ``H dx = -b`` with Jacobi scaling (translation and rotation
    blocks differ by ~range^2). Zeros when H is (numerically) empty; a
    non-finite solve also yields zeros.

    ``solve_ex`` and not ``solve``: the latter checks for singularity on
    the host, which on CUDA would synchronise every GN round.
    """
    diag = torch.diagonal(H, dim1=-2, dim2=-1)
    good = torch.sum(diag, dim=-1) > 0
    d = torch.sqrt(torch.clamp(diag, min=1e-30))
    d = torch.where(diag > 0, d, 1.0)
    Hs = H / (d[..., :, None] * d[..., None, :])
    bs = b / d
    eye = torch.eye(6, dtype=H.dtype, device=H.device)
    dx = torch.linalg.solve_ex(Hs + 1e-8 * eye, -bs)[0] / d
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


def gn_update_plain(X: torch.Tensor, H: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version: one right-multiplicative Gauss-Newton update of X
    (``mad_icp.cpp:105-117``)."""
    return X @ exp_se3_split(clamp_step(solve_gn(H, b)))


def _lead(X, H, b) -> tuple:
    """Raise on what neither version takes (every device); the leading
    shape of the output."""
    dev = X.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"gn_update: unsupported device {dev}")
    if H.device != dev or b.device != dev:
        raise ValueError("gn_update: X, H and b on different devices")
    if X.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"gn_update: X must be float32/float64, got {X.dtype}")
    if H.dtype != X.dtype or b.dtype != X.dtype:
        raise TypeError(f"gn_update: H {H.dtype} and b {b.dtype} must be X's {X.dtype}")
    if (X.dim() < 2 or X.shape[-2:] != (4, 4) or H.dim() < 2 or H.shape[-2:] != (6, 6)
            or b.dim() < 1 or b.shape[-1] != 6):
        raise ValueError(f"gn_update: want X (..., 4, 4), H (..., 6, 6) and b (..., 6), got "
                         f"{tuple(X.shape)}, {tuple(H.shape)}, {tuple(b.shape)}")
    try:
        return tuple(torch.broadcast_shapes(X.shape[:-2], H.shape[:-2], b.shape[:-1]))
    except RuntimeError as err:
        raise ValueError(f"gn_update: leading axes do not broadcast: {err}") from None


def gn_update(X: torch.Tensor, H: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``X dX`` of :func:`gn_update_plain` (leading axes broadcast): the
    plain version for CPU tensors, the kernel for CUDA ones."""
    lead = _lead(X, H, b)
    if X.device.type == "cpu":
        return gn_update_plain(X, H, b)
    return launch(X, H, b)


def _flat(t: torch.Tensor, lead: tuple, own: tuple) -> torch.Tensor:
    """``t`` expanded to ``lead + own`` with the leading axes as one (a
    view where they merge: the step's operands are; broadcast axes keep
    stride 0)."""
    return t.expand(lead + own).reshape((math.prod(lead),) + own)


def launch(X: torch.Tensor, H: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Run the kernel on CUDA tensors (arguments and result as
    :func:`gn_update`); one count."""
    lead = _lead(X, H, b)
    n = math.prod(lead)
    Xf, Hf, bf = _flat(X, lead, (4, 4)), _flat(H, lead, (6, 6)), _flat(b, lead, (6,))
    out = torch.empty(lead + (4, 4), dtype=X.dtype, device=X.device)
    meta = list(Xf.stride()) + list(Hf.stride()) + list(bf.stride()) + [0]
    meta = (ctypes.c_longlong * len(meta))(*meta)
    _launch("gn_update", X.dtype, X.device, meta, Xf.data_ptr(), Hf.data_ptr(),
            bf.data_ptr(), n, out.data_ptr())
    return out
