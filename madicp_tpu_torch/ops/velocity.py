"""The constant-velocity estimate: one Gauss-Newton round over a short
pose window.

Parity with the reference ``VelEstimator`` (``vel_estimator.cpp:32-97``):
residual per pose pair ``dt * v - [trans; eulerXYZ](T_prev^-1 T_now)``,
``J = dt * I6``, linearly decaying weights toward older poses and a robust
clamp at ``chi > E_THRESHOLD_VEL``, masked to the actual window length.

:func:`estimate_velocity` is written one operation at a time on
per-component tensors, in the order of the step's tail kernel
(``kernels/csrc/step_scalars.cu``, K14): each pair's relative pose,
residual, norm, clamp and weight, then the sums over the pairs in pair
order; constants are 0-dim tensors of the working type. K14's plain
version calls it, so the kernel equals it bit for bit.
"""

from __future__ import annotations

import torch

from madicp_tpu_torch.ops.constants import E_THRESHOLD_VEL
from madicp_tpu_torch.ops.lie import euler_xyz, relative_pose, scalars


def estimate_velocity(
    v0: torch.Tensor,
    traj: torch.Tensor,
    count,
    ts,
) -> torch.Tensor:
    """One GN round of the velocity estimate.

    Args:
        v0: (6,) current velocity ``[v_lin, v_ang]``, or (B, 6).
        traj: (W, 4, 4) pose window, newest LAST; older slots may be
              padding. (B, W, 4, 4) with a batch.
        count: number of valid poses occupying the trailing slots
               (window length n = min(count, W)); an int or a tensor of
               the batch's shape.
        ts: scan period (1 / sensor_hz): a number or a 0-dim tensor.

    Slot ``i`` pairs with the newest pose using ``dt = (W-1-i) * ts`` and
    weight ``1 - (W-2-i)/(n-1)``, masked to ``i >= W-n``
    (``vel_estimator.cpp:81-97``).
    """
    dtype, dev = traj.dtype, traj.device
    W = traj.shape[-3]
    ts = torch.as_tensor(ts, dtype=dtype, device=dev)
    one, two, zero, thr, tiny = scalars(traj, 1.0, 2.0, 0.0, E_THRESHOLD_VEL, 1e-30)
    n = torch.clamp(torch.as_tensor(count, device=dev), max=W).to(dtype)[..., None]
    i = torch.arange(W - 1, dtype=dtype, device=dev)  # the pairs: (W-1,)
    dt = torch.arange(W - 1, 0, -1, dtype=dtype, device=dev) * ts  # (W - 1 - i) ts
    active = (i >= W - n) & (n >= two)
    weight = one - torch.arange(W - 2, -1, -1, dtype=dtype, device=dev) / torch.clamp(
        n - one, min=1.0)  # 1 - (W - 2 - i) / max(n - 1, 1)

    R, t = relative_pose(traj[..., :-1, :, :], traj[..., -1:, :, :])  # (..., W-1) each
    eul = euler_xyz(torch.stack([torch.stack(r, dim=-1) for r in R], dim=-2)).unbind(-1)
    v = [v0[..., c, None] for c in range(6)]
    e = [dt * v[c] - t[c] for c in range(3)] + [dt * v[3 + c] - eul[c] for c in range(3)]
    chi2 = e[0] * e[0]
    for c in range(1, 6):
        chi2 = chi2 + e[c] * e[c]
    chi = torch.sqrt(chi2)
    scale = torch.where(chi > thr, thr / torch.clamp(chi, min=tiny), one)
    s = (scale * weight) * active.to(dtype)

    # J = dt * I6 -> H is (sum s dt^2) * I6, b = sum s dt e, over the pairs
    # in order
    sdt = s * dt
    h_terms = sdt * dt
    b_terms = [sdt * c for c in e]
    h, b = h_terms[..., 0], [bt[..., 0] for bt in b_terms]
    for w in range(1, W - 1):
        h = h + h_terms[..., w]
        b = [bc + bt[..., w] for bc, bt in zip(b, b_terms)]
    h_c = torch.clamp(h, min=tiny)
    return torch.stack([v0[..., c] + torch.where(h > zero, -b[c] / h_c, zero)
                        for c in range(6)], dim=-1)
