"""Constant-velocity estimator over a short pose window.

Parity with the reference ``VelEstimator`` (``vel_estimator.cpp:32-97``):
one Gauss-Newton round per scan over the last <= ``SMOOTHING_T`` poses,
residual per pose pair ``dt * v - [trans; eulerXYZ](T_prev^-1 T_now)``,
``J = dt * I6``, linearly decaying weights toward older poses and a robust
clamp at ``chi > E_THRESHOLD_VEL``, masked to the actual window length.
"""

from __future__ import annotations

import numpy as np
import torch

from madicp_tpu_torch.ops.constants import E_THRESHOLD_VEL, SMOOTHING_T
from madicp_tpu_torch.ops.lie import euler_xyz, se3_inverse
from madicp_tpu_torch.utils.device import resolve_device


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
        ts: scan period (1 / sensor_hz).

    Slot ``i`` pairs with the newest pose using ``dt = (W-1-i) * ts`` and
    weight ``1 - (W-2-i)/(n-1)``, masked to ``i >= W-n``
    (``vel_estimator.cpp:81-97``).
    """
    dtype, dev = traj.dtype, traj.device
    W = traj.shape[-3]
    ts = torch.as_tensor(ts, dtype=dtype, device=dev)
    n = torch.clamp(torch.as_tensor(count, device=dev), max=W).to(dtype)[..., None]

    T_now = traj[..., -1:, :, :]
    T_prev = traj[..., :-1, :, :]  # (..., W-1, 4, 4)
    i = torch.arange(W - 1, dtype=dtype, device=dev)
    active = (i >= (W - n)) & (n >= 2)
    dt = (W - 1 - i) * ts
    denom = torch.clamp(n - 1.0, min=1.0)
    weight = 1.0 - (W - 2 - i) / denom

    T_rel = se3_inverse(T_prev) @ T_now  # (..., W-1, 4, 4)
    e_t = dt[:, None] * v0[..., None, :3] - T_rel[..., :3, 3]
    e_r = dt[:, None] * v0[..., None, 3:] - euler_xyz(T_rel[..., :3, :3])
    e = torch.cat([e_t, e_r], dim=-1)  # (..., W-1, 6)

    chi = torch.sqrt(torch.sum(e * e, dim=-1))
    thr = E_THRESHOLD_VEL
    scale = torch.where(chi > thr, thr / torch.clamp(chi, min=1e-30), 1.0)
    s = scale * weight * active.to(dtype)

    # J = dt * I6 -> H is (sum s dt^2) * I6, b = sum s dt e
    h = torch.sum(s * dt * dt, dim=-1, keepdim=True)
    b = torch.einsum("...w,...wi->...i", s * dt, e)
    dx = -b / torch.clamp(h, min=1e-30)
    dx = torch.where(h > 0, dx, torch.zeros_like(dx))
    return v0 + dx


class VelEstimator:
    """Host-facing wrapper mirroring the reference class shape."""

    def __init__(self, sensor_hz: float, dtype=torch.float64, device=None):
        self._ts = 1.0 / float(sensor_hz)
        self._dtype = dtype
        self.device = resolve_device(device)
        self.X = np.zeros(6)
        self._odometry: list[np.ndarray] = []

    def init(self, velocity):
        self.X = np.asarray(velocity, dtype=float).copy()

    def set_odometry(self, odometry):
        self._odometry = [np.asarray(T, dtype=float) for T in odometry]

    def one_round(self):
        # only the last <= SMOOTHING_T poses enter the estimate
        # (vel_estimator.cpp:81-97 via pipeline.cpp:208-217)
        odometry = self._odometry[-SMOOTHING_T:]
        n = len(odometry)
        W = SMOOTHING_T
        traj = np.tile(np.eye(4), (W, 1, 1))
        if n:
            traj[W - n:] = np.stack(odometry)
        kw = dict(dtype=self._dtype, device=self.device)
        self.X = estimate_velocity(
            torch.as_tensor(self.X, **kw), torch.as_tensor(traj, **kw), n, self._ts
        ).cpu().numpy()
        return self.X

    # reference-style aliases
    setOdometry = set_odometry
    oneRound = one_round
