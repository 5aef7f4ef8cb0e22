"""Batched SO(3)/SE(3) operations.

Numerical conventions follow the reference implementation
(``mad_icp/src/tools/lie_algebra.h:33-89`` and the Euler extraction of
``mad_icp/src/odometry/vel_estimator.cpp:53-56``), written as batched
tensor code at any float dtype. All functions broadcast over leading
batch dimensions.
"""

from __future__ import annotations

import math

import torch


def skew(v: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric (cross-product) matrix of ``v``: (..., 3) -> (..., 3, 3).

    Parity: reference ``lie_algebra.h:33-37``.
    """
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
    )


def _eye3(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device)


def exp_so3(omega: torch.Tensor) -> torch.Tensor:
    """Rodrigues exponential map: (..., 3) -> (..., 3, 3).

    Small-angle branch at ``theta^2 < 1e-8`` returns ``I + W`` exactly like
    the reference (``lie_algebra.h:39-52``); the regular branch uses the
    ``2 sin^2(theta/2)`` form of ``1 - cos(theta)``.
    """
    theta_sq = torch.sum(omega * omega, dim=-1)
    small = theta_sq < 1e-8
    # guard the division so the untaken branch stays finite
    theta = torch.sqrt(torch.where(small, torch.ones_like(theta_sq), theta_sq))
    W = skew(omega)
    K = W / theta[..., None, None]
    eye = _eye3(omega).expand(W.shape)
    one_minus_cos = 2.0 * torch.sin(theta / 2.0) ** 2
    R_full = (
        eye
        + torch.sin(theta)[..., None, None] * K
        + one_minus_cos[..., None, None] * (K @ K)
    )
    R_small = eye + W
    return torch.where(small[..., None, None], R_small, R_full)


def log_so3(R: torch.Tensor) -> torch.Tensor:
    """Logarithm map of SO(3): (..., 3, 3) -> (..., 3).

    Replicates the reference's trace-based formula with its special cases
    near ``theta = pi`` (three sub-branches on the diagonal) and the Taylor
    expansion near ``theta = 0`` (``lie_algebra.h:54-89``).
    """
    R11, R12, R13 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    R21, R22, R23 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    R31, R32, R33 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = R11 + R22 + R33

    near_pi = (tr + 1.0) < 1e-10

    def _axis_branch(Rii, a, b, c):
        denom = torch.sqrt(torch.clamp(2.0 + 2.0 * Rii, min=1e-30))
        return (math.pi / denom)[..., None] * torch.stack([a, b, c], dim=-1)

    # theta ~ pi branches (picked by which diagonal entry is not -1)
    branch33 = _axis_branch(R33, R13, R23, 1.0 + R33)
    branch22 = _axis_branch(R22, R12, 1.0 + R22, R32)
    branch11 = _axis_branch(R11, 1.0 + R11, R21, R31)
    pi_omega = torch.where(
        (torch.abs(R33 + 1.0) > 1e-5)[..., None],
        branch33,
        torch.where(
            (torch.abs(R22 + 1.0) > 1e-5)[..., None], branch22, branch11
        ),
    )

    # regular branch
    tr_3 = tr - 3.0
    regular = tr_3 < -1e-7
    # acos argument clipped for safety at |.| <= 1
    theta = torch.arccos(torch.clamp((tr - 1.0) / 2.0, -1.0, 1.0))
    sin_theta = torch.sin(theta)
    mag_reg = theta / torch.where(
        torch.abs(sin_theta) < 1e-30, torch.ones_like(sin_theta), 2.0 * sin_theta
    )
    mag_taylor = 0.5 - tr_3 * tr_3 / 12.0
    magnitude = torch.where(regular, mag_reg, mag_taylor)
    main_omega = magnitude[..., None] * torch.stack(
        [R32 - R23, R13 - R31, R21 - R12], dim=-1
    )
    return torch.where(near_pi[..., None], pi_omega, main_omega)


def euler_xyz(R: torch.Tensor) -> torch.Tensor:
    """Euler angles in the velocity-estimator convention: (...,3,3) -> (...,3).

    Parity: reference ``vel_estimator.cpp:53-56``::

        ax = atan2(-R(1,2), R(2,2));  ay = asin(R(0,2));  az = atan2(-R(0,1), R(0,0))
    """
    ax = torch.atan2(-R[..., 1, 2], R[..., 2, 2])
    ay = torch.asin(torch.clamp(R[..., 0, 2], -1.0, 1.0))
    az = torch.atan2(-R[..., 0, 1], R[..., 0, 0])
    return torch.stack([ax, ay, az], dim=-1)


def se3_matrix(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Assemble a homogeneous (..., 4, 4) transform from (...,3,3) and (...,3)."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = R.expand(batch + (3, 3))
    t = t.expand(batch + (3,))
    top = torch.cat([R, t[..., :, None]], dim=-1)
    # [0, 0, 0, 1] made on the device: no host-to-device copy, which
    # would synchronise every GN round
    bottom = torch.eye(4, dtype=R.dtype, device=R.device)[3].expand(
        batch + (4,))[..., None, :]
    return torch.cat([top, bottom], dim=-2)


def se3_inverse(T: torch.Tensor) -> torch.Tensor:
    """Inverse of a homogeneous rigid transform (..., 4, 4)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = R.transpose(-1, -2)
    return se3_matrix(Rt, -torch.einsum("...ij,...j->...i", Rt, t))


def se3_apply(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply (..., 4, 4) rigid transform to (..., N, 3) points."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    return torch.einsum("...ij,...nj->...ni", R, pts) + t[..., None, :]


def exp_se3_split(dx: torch.Tensor) -> torch.Tensor:
    """MAD-ICP's SE(3) increment: rotation via exp map, translation raw.

    ``dx`` is (..., 6) ordered ``[t(3), omega(3)]``. The reference applies
    Gauss-Newton increments as ``dX.linear()=expMapSO3(dx.tail(3));
    dX.translation()=dx.head(3)`` (``mad_icp.cpp:112-115``,
    ``pipeline.cpp:146-151``) — i.e. NOT the full SE(3) exponential.
    """
    return se3_matrix(exp_so3(dx[..., 3:6]), dx[..., 0:3])
