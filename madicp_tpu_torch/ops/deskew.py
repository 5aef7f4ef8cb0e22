"""Motion-based deskewing of a spinning-LiDAR sweep.

The reference sorts points by azimuth and sweeps 1024 azimuth bins from
+pi downward, advancing a per-bin time offset from ``-ts`` to 0 and
rigidly moving each point by ``exp(v * t_bin)`` (``pipeline.cpp:79-123``).

- ``mode="reference"``: the reference's literal once-per-point bin
  advance, whose recurrence has the closed form ``k_j = min(j+1, j +
  prefixmin(ceil(q)_+ - j))`` over descending azimuth — one stable sort
  plus one prefix minimum.
- ``mode="binned"``: pure binning, a point's bin a direct function of its
  azimuth (identical on sweeps that occupy every bin).

Both keep the cloud in its original order. The per-point math (bins and
the apply, in one explicit order) is the deskew sweep's, K12
(:mod:`madicp_tpu_torch.kernels.deskew`): :func:`deskew_cloud` is its
plain version on every point, :func:`deskew_scan` the step's entry, which
reaches the kernel on the card.
"""

from __future__ import annotations

import torch

from madicp_tpu_torch.kernels import deskew as k12
from madicp_tpu_torch.ops.constants import CHUNKS
from madicp_tpu_torch.ops.lie import exp_so3, log_so3, se3_inverse


def bin_motion(T_prev, T_now, sensor_hz, dtype):
    """Naive velocity + per-bin rigid motions ``(R_bins (..., CHUNKS, 3,
    3), t_trans (..., CHUNKS, 3))`` (``pipeline.cpp:82-108``); leading axes
    of the poses carry through."""
    dev = T_now.device
    ts = 1.0 / torch.as_tensor(sensor_hz, dtype=dtype, device=dev)
    T_rel = se3_inverse(T_prev) @ T_now
    v_lin = T_rel[..., :3, 3] / ts
    v_ang = log_so3(T_rel[..., :3, :3]) / ts

    # per-bin times: t(bin) = -ts + bin * ts/(CHUNKS-1)
    delta = ts / (CHUNKS - 1)
    t_bins = -ts + delta * torch.arange(CHUNKS, dtype=dtype, device=dev)
    R_bins = exp_so3(v_ang[..., None, :] * t_bins[:, None])  # (..., CHUNKS, 3, 3)
    t_trans = v_lin[..., None, :] * t_bins[:, None]           # (..., CHUNKS, 3)
    return R_bins, t_trans


def deskew_cloud(
    points: torch.Tensor,
    T_prev: torch.Tensor,
    T_now: torch.Tensor,
    sensor_hz,
    valid: torch.Tensor | None = None,
    mode: str = "reference",
) -> torch.Tensor:
    """Deskew (N, 3) points given the last two trajectory poses: velocity
    is their finite difference over one scan period, and each azimuth bin
    gets the rigid motion ``[exp(w t) | v t]`` from scan start (t = -ts,
    azimuth +pi) to scan end (t = 0, azimuth -pi). A batch of clouds
    (B, N, 3) takes poses (B, 4, 4) and masks (B, N), one sweep each.
    Every point moves, valid or not (the mask only orders the sweep);
    plain tensor ops on every device."""
    if mode not in k12.MODES:
        raise ValueError(f"deskew mode must be 'reference' or 'binned', got {mode!r}")
    R_bins, t_trans = bin_motion(T_prev, T_now, sensor_hz, points.dtype)
    if valid is None:
        valid = torch.ones(points.shape[:-1], dtype=torch.bool, device=points.device)
    bins = k12.sweep_bins(points, valid, mode)
    return k12.apply_motion(points, bins, R_bins, t_trans)


def deskew_scan(points, valid, do, T_prev, T_now, sensor_hz, mode: str) -> torch.Tensor:
    """The step's deskew of a batch (B, N, 3): each valid point of a
    sequence with ``do`` (B,) moved as :func:`deskew_cloud` moves it, the
    others passed through. The bin motions are tensor ops; the sweep is
    K12 on the card and its plain version on the CPU
    (:func:`madicp_tpu_torch.kernels.deskew.deskew_sweep`)."""
    R_bins, t_trans = bin_motion(T_prev, T_now, sensor_hz, points.dtype)
    return k12.deskew_sweep(points, valid, do, R_bins, t_trans, mode)
