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

Both keep the cloud in its original order. The bin motions and the
per-point math (bins and the apply, in one explicit order) are the deskew
sweep's, K12 (:mod:`madicp_tpu_torch.kernels.deskew`):
:func:`deskew_cloud` is its plain version on every point,
:func:`deskew_scan` the step's entry, which reaches the kernel on the
card.
"""

from __future__ import annotations

import torch

from madicp_tpu_torch.kernels import deskew as k12


def _rate(sensor_hz, like: torch.Tensor) -> torch.Tensor:
    """The sensor rate as a 0-dim tensor of ``like``'s type and device (a
    Python number is filled in on the device: no copy from the host)."""
    if isinstance(sensor_hz, torch.Tensor):
        return sensor_hz.to(dtype=like.dtype, device=like.device)
    return torch.full((), float(sensor_hz), dtype=like.dtype, device=like.device)


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
    R_bins, t_trans = k12.bin_motion_plain(T_prev, T_now, _rate(sensor_hz, points))
    if valid is None:
        valid = torch.ones(points.shape[:-1], dtype=torch.bool, device=points.device)
    bins = k12.sweep_bins(points, valid, mode)
    return k12.apply_motion(points, bins, R_bins, t_trans)


def deskew_scan(points, valid, do, T_prev, T_now, sensor_hz, mode: str) -> torch.Tensor:
    """The step's deskew of a batch (B, N, 3): each valid point of a
    sequence with ``do`` (B,) moved as :func:`deskew_cloud` moves it, the
    others passed through. K12 on the card (the bin motions formed inside
    it), its plain version on the CPU
    (:func:`madicp_tpu_torch.kernels.deskew.deskew_sweep`)."""
    return k12.deskew_sweep(points, valid, do, T_prev, T_now, _rate(sensor_hz, points), mode)
