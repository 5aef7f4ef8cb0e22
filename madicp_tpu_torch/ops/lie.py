"""Batched SO(3)/SE(3) operations.

Numerical conventions follow the reference implementation
(``mad_icp/src/tools/lie_algebra.h:33-89`` and the Euler extraction of
``mad_icp/src/odometry/vel_estimator.cpp:53-56``), written as batched
tensor code at any float dtype. All functions broadcast over leading
batch dimensions.

The maps the hand-written kernels also form (:func:`exp_so3`,
:func:`relative_pose`, :func:`se3_compose`) are written one operation at
a time on per-component tensors, in the order of the kernels' shared
header ``kernels/csrc/lie.cuh``, with constants as 0-dim tensors of the
working type (a division by one is a true division on every device): no
``@``, einsum or ``torch.sum``, whose order is torch's. So a kernel and
its plain version that use them agree bit for bit.
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


def scalars(like: torch.Tensor, *values) -> tuple:
    """``values`` as 0-dim tensors of ``like``'s type and device."""
    return tuple(torch.full((), v, dtype=like.dtype, device=like.device) for v in values)


def exp_so3_components(w: list) -> list:
    """:func:`exp_so3` of per-component tensors ``w = [w_x, w_y, w_z]``,
    in the kernels' order (``lie.cuh``): ``I + W`` where ``theta^2 < 1e-8``,
    else ``R_ii = 1 + omc KK_ii`` and ``R_ij = sn K_ij + omc KK_ij`` with
    ``theta^2 = (w_x^2 + w_y^2) + w_z^2``, ``K = W / theta``, ``sn =
    sin(theta)``, ``omc = 2 sin(theta / 2)^2`` and ``KK = K K`` in closed
    form (``KK_ii = -(k_a^2 + k_b^2)``, ``KK_ij = k_i k_j``). Returns the
    nine entries, row-major."""
    wx, wy, wz = w
    one, two, half, small_sq = scalars(wx, 1.0, 2.0, 0.5, 1e-8)
    theta_sq = (wx * wx + wy * wy) + wz * wz
    small = theta_sq < small_sq
    # guard the division so the untaken branch stays finite
    theta = torch.sqrt(torch.where(small, one, theta_sq))
    k = [c / theta for c in w]
    sn = torch.sin(theta)
    h = torch.sin(theta * half)
    omc = two * (h * h)
    sq = [c * c for c in k]
    Kx = [[None, -k[2], k[1]], [k[2], None, -k[0]], [-k[1], k[0], None]]
    full = []
    for i in range(3):
        for j in range(3):
            if i == j:
                a, b = [m for m in range(3) if m != i]
                full.append(one + omc * -(sq[a] + sq[b]))
            else:
                full.append(sn * Kx[i][j] + omc * (k[i] * k[j]))
    ones = one.expand_as(wx)
    W = [ones, -wz, wy, wz, ones, -wx, -wy, wx, ones]
    return [torch.where(small, s, f) for s, f in zip(W, full)]


def exp_so3(omega: torch.Tensor) -> torch.Tensor:
    """Rodrigues exponential map: (..., 3) -> (..., 3, 3).

    Small-angle branch at ``theta^2 < 1e-8`` returns ``I + W`` exactly like
    the reference (``lie_algebra.h:39-52``); the regular branch uses the
    ``2 sin^2(theta/2)`` form of ``1 - cos(theta)``
    (:func:`exp_so3_components`).
    """
    R = exp_so3_components(list(omega.unbind(-1)))
    return torch.stack(R, dim=-1).unflatten(-1, (3, 3))


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


def broadcast_shape(*shapes) -> tuple:
    """The shape ``shapes`` broadcast to, as ``torch.broadcast_shapes``
    gives it (a ``RuntimeError`` where they do not broadcast), without
    that function's first-use import of sympy (~1 s a process)."""
    n = max((len(s) for s in shapes), default=0)
    out = []
    for dims in zip(*((1,) * (n - len(s)) + tuple(s) for s in shapes)):
        sizes = {d for d in dims if d != 1}
        if len(sizes) > 1:
            raise RuntimeError(f"shapes {[tuple(s) for s in shapes]} do not broadcast")
        out.append(sizes.pop() if sizes else 1)
    return tuple(out)


def se3_matrix(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Assemble a homogeneous (..., 4, 4) transform from (...,3,3) and (...,3)."""
    batch = broadcast_shape(R.shape[:-2], t.shape[:-1])
    R = R.expand(batch + (3, 3))
    t = t.expand(batch + (3,))
    top = torch.cat([R, t[..., :, None]], dim=-1)
    # [0, 0, 0, 1] made on the device: no host-to-device copy, which
    # would synchronise every GN round
    bottom = torch.eye(4, dtype=R.dtype, device=R.device)[3].expand(
        batch + (4,))[..., None, :]
    return torch.cat([top, bottom], dim=-2)


def relative_pose(T_prev: torch.Tensor, T_now: torch.Tensor) -> tuple:
    """``T_prev^-1 T_now`` of (..., 4, 4) rigid poses as the reference
    forms it (``se3_inverse`` then the product), per component in the
    kernels' order: ``R[i][j] = (P_0i Q_0j + P_1i Q_1j) + P_2i Q_2j`` and
    ``t_i = ((P_0i Q_03 + P_1i Q_13) + P_2i Q_23) + s_i`` with ``s_i =
    -((P_0i P_03 + P_1i P_13) + P_2i P_23)``. Returns ``(R, t)``: a 3 x 3
    nested list and a list of 3 tensors of the leading shape."""
    P = [[T_prev[..., r, c] for c in range(4)] for r in range(3)]
    Q = [[T_now[..., r, c] for c in range(4)] for r in range(3)]

    def col(i, M, c):  # (P_0i M_0c + P_1i M_1c) + P_2i M_2c
        return (P[0][i] * M[0][c] + P[1][i] * M[1][c]) + P[2][i] * M[2][c]

    R = [[col(i, Q, j) for j in range(3)] for i in range(3)]
    t = [col(i, Q, 3) + -col(i, P, 3) for i in range(3)]
    return R, t


def se3_compose(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """``A B`` of (..., 4, 4) transforms, ``B`` rigid (last row ``[0 0 0
    1]``), per component in the kernels' order: entry ``(i, j)`` is
    ``(A_i0 B_0j + A_i1 B_1j) + A_i2 B_2j``, plus ``A_i3`` where ``j = 3``
    (every row of ``A``, its last included)."""
    a = [[A[..., i, c] for c in range(4)] for i in range(4)]
    b = [[B[..., r, j] for j in range(4)] for r in range(3)]
    rows = []
    for i in range(4):
        row = [(a[i][0] * b[0][j] + a[i][1] * b[1][j]) + a[i][2] * b[2][j] for j in range(4)]
        row[3] = row[3] + a[i][3]
        rows.append(torch.stack(torch.broadcast_tensors(*row), dim=-1))
    return torch.stack(rows, dim=-2)


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
