"""Motion-based deskewing of a spinning-LiDAR sweep.

The reference sorts points by azimuth and sweeps 1024 azimuth bins from
+pi downward, advancing a per-bin time offset from ``-ts`` to 0 and
rigidly moving each point by ``exp(v * t_bin)`` (``pipeline.cpp:79-123``).

- ``mode="reference"``: the reference's literal once-per-point bin
  advance, whose recurrence has the closed form ``k_j = min(j+1, j +
  prefixmin(ceil(q)_+ - j))`` over descending azimuth — one stable sort
  plus one ``cummin``.
- ``mode="binned"``: pure binning, a point's bin a direct function of its
  azimuth (identical on sweeps that occupy every bin).

Both keep the cloud in its original order.
"""

from __future__ import annotations

import math

import torch

from madicp_tpu_torch.ops.constants import CHUNKS
from madicp_tpu_torch.ops.lie import exp_so3, log_so3, se3_inverse


def _bin_times_and_motion(T_prev, T_now, sensor_hz, dtype):
    """Naive velocity + per-bin rigid motions (``pipeline.cpp:82-108``)."""
    dev = T_now.device
    ts = 1.0 / torch.as_tensor(sensor_hz, dtype=dtype, device=dev)
    T_rel = se3_inverse(T_prev) @ T_now
    v_lin = T_rel[:3, 3] / ts
    v_ang = log_so3(T_rel[:3, :3]) / ts

    # per-bin times: t(bin) = -ts + bin * ts/(CHUNKS-1)
    delta = ts / (CHUNKS - 1)
    t_bins = -ts + delta * torch.arange(CHUNKS, dtype=dtype, device=dev)
    R_bins = exp_so3(v_ang[None, :] * t_bins[:, None])  # (CHUNKS, 3, 3)
    t_trans = v_lin[None, :] * t_bins[:, None]           # (CHUNKS, 3)
    return R_bins, t_trans


def _bins_pure(azimuth: torch.Tensor) -> torch.Tensor:
    """Direct binning: bin = floor((pi - az) / res), clamped."""
    resolution = 2.0 * math.pi / CHUNKS
    return torch.clamp(
        torch.floor((math.pi - azimuth) / resolution).long(), 0, CHUNKS - 1
    )


def _bins_reference(azimuth: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Once-per-point bin advance over descending azimuth, vectorised.

    The traversal is descending azimuth with ties in REVERSE original
    order (the reference sorts ascending and walks backwards,
    ``pipeline.cpp:97-110``), hence a STABLE ascending argsort flipped.
    ``valid=False`` points sort to the end (azimuth -inf).
    """
    dtype = azimuth.dtype
    az = torch.where(valid, azimuth, -math.inf)
    order = torch.flip(torch.argsort(az, stable=True), dims=(0,))
    az_desc = az.index_select(0, order)

    resolution = 2.0 * math.pi / CHUNKS
    q = (math.pi - az_desc) / resolution - 1.0
    c = torch.clamp(torch.ceil(q), 0.0, float(CHUNKS - 1))
    j = torch.arange(az.shape[0], dtype=dtype, device=az.device)
    pref = torch.cummin(c - j, dim=0).values
    k_desc = torch.minimum(j + 1.0, j + pref).long()
    k_desc = torch.clamp(k_desc, 0, CHUNKS - 1)

    # scatter the advance counts back to the original point order
    return torch.zeros_like(k_desc).scatter_(0, order, k_desc)


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
    azimuth +pi) to scan end (t = 0, azimuth -pi)."""
    R_bins, t_trans = _bin_times_and_motion(T_prev, T_now, sensor_hz, points.dtype)

    azimuth = torch.atan2(points[:, 1], points[:, 0])
    if mode == "reference":
        if valid is None:
            valid = torch.ones(points.shape[0], dtype=torch.bool, device=points.device)
        bins = _bins_reference(azimuth, valid)
    elif mode == "binned":
        bins = _bins_pure(azimuth)
    else:
        raise ValueError(f"deskew mode must be 'reference' or 'binned', got {mode!r}")

    Rp = R_bins.index_select(0, bins)  # (N, 3, 3)
    tp = t_trans.index_select(0, bins)
    return torch.einsum("nij,nj->ni", Rp, points) + tp
