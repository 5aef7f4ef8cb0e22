"""Constant-velocity estimator over a short pose window.

Parity with the reference ``VelEstimator`` (``vel_estimator.cpp:32-97``):
one Gauss-Newton round per scan over the last <= ``SMOOTHING_T`` poses
(:func:`madicp_tpu_torch.ops.velocity.estimate_velocity`).
"""

from __future__ import annotations

import numpy as np
import torch

from madicp_tpu_torch.ops.constants import SMOOTHING_T
from madicp_tpu_torch.ops.velocity import estimate_velocity
from madicp_tpu_torch.utils.device import resolve_device


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
