"""Point-to-plane ICP core: association, residuals, normal equations, GN step.

The reference's per-leaf serial loop (``mad_icp.cpp:74-117``) as batched
tensor math: the whole moving-leaf set descends the fixed tree(s) at
once, residual/Jacobian/weight are elementwise, and the 6x6 normal
equations form as one masked ``(s J)^T J`` product per keyframe.

Contracts (SURVEY.md §2.1.3-6, as in the JAX package):
- gate: accept a match iff ``|X m - f| <= b_max + b_ratio * |m|``;
- residual ``e = (X m - f_mean) . n_f``; Jacobian ``J = [n_f^T R,
  -n_f^T R skew(m)]``;
- Huber-style clamp at ``|e| > sqrt(rho_ker)`` times the squared
  planarity weight ``(1 - bbox0_f / b_max)^2``;
- GN update ``dx = -H^{-1} b``; ``X <- X * [exp(dx_rot) | dx_trans]``
  with state ordering ``[t(3), omega(3)]``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from madicp_tpu_torch.ops.lie import exp_se3_split
from madicp_tpu_torch.ops.tree import SearchTree, search_forest


class IcpTerms(NamedTuple):
    H: torch.Tensor        # (..., 6, 6)
    b: torch.Tensor        # (..., 6)
    matched: torch.Tensor  # (..., L) bool — gated matches of this fixed tree


def associate_packed(
    nav: torch.Tensor,
    base,
    depth: int,
    moving_pts_map: torch.Tensor,
    moving_valid: torch.Tensor,
    start: torch.Tensor = None,
    n_gathers: int = None,
    return_margin: bool = False,
    ladder: int = 0,
):
    """Descend the fixed tree(s) for every moving point (already in the
    map frame); the descent's final block IS the matched leaf's payload.

    Returns ``(leaf_ids, payload)`` with ``payload`` (Q, 8) =
    ``[f_pt(3), f_n(3), f_bbox0, flags]`` (``flags == 3`` marks a real
    leaf match), plus the (Q,) path margins with ``return_margin``.
    """
    return search_forest(
        nav, moving_pts_map, base, depth, valid=moving_valid,
        start=start, n_gathers=n_gathers, return_blocks=True,
        return_margin=return_margin, ladder=ladder,
    )


def terms_from_payload(
    payload: torch.Tensor,
    moving_pts: torch.Tensor,
    moving_valid: torch.Tensor,
    X: torch.Tensor,
    *,
    b_max,
    b_ratio,
    rho_ker,
) -> IcpTerms:
    """Gate + residual/Jacobian/weights + normal equations from an
    association payload ``(..., L, 8)`` — no tree access. Leading axes
    (e.g. keyframes) give one ``(H, b, matched)`` each. The gate is
    evaluated under the CURRENT ``X`` (``mad_icp.cpp:81-83``)."""
    dtype = moving_pts.dtype
    R = X[:3, :3]
    t = X[:3, 3]
    rho = torch.sqrt(torch.as_tensor(rho_ker, dtype=dtype, device=X.device))

    ml = moving_pts @ R.T + t
    mlx, mly, mlz = ml[:, 0], ml[:, 1], ml[:, 2]
    mx, my, mz = moving_pts[:, 0], moving_pts[:, 1], moving_pts[:, 2]
    fx, fy, fz = payload[..., 0], payload[..., 1], payload[..., 2]
    nx, ny, nz = payload[..., 3], payload[..., 4], payload[..., 5]
    f_bbox0 = payload[..., 6]
    f_ok = payload[..., 7] == 3.0

    # adaptive-radius gate (radius grows with point range)
    dx, dy, dz = mlx - fx, mly - fy, mlz - fz
    dist = torch.sqrt(dx * dx + dy * dy + dz * dz)
    src_ball = b_max + b_ratio * torch.sqrt(mx * mx + my * my + mz * mz)
    matched = (dist <= src_ball) & moving_valid & f_ok

    # residual and analytic Jacobian: with u = R^T n,
    # J = [u^T, (m x u)^T]  (since -u^T skew(m) = (m x u)^T)
    e = dx * nx + dy * ny + dz * nz
    ux = nx * R[0, 0] + ny * R[1, 0] + nz * R[2, 0]
    uy = nx * R[0, 1] + ny * R[1, 1] + nz * R[2, 1]
    uz = nx * R[0, 2] + ny * R[1, 2] + nz * R[2, 2]
    J = torch.stack(
        [ux, uy, uz, my * uz - mz * uy, mz * ux - mx * uz, mx * uy - my * ux],
        dim=-1,
    )  # (..., L, 6)

    chi = torch.abs(e)
    scale = torch.where(chi > rho, rho / torch.clamp(chi, min=1e-30), 1.0)
    w_plan = torch.clamp(1.0 - f_bbox0 / b_max, 0.0, 1.0)
    s = scale * w_plan * w_plan * matched.to(dtype)

    Js = J * s[..., None]
    H = Js.transpose(-1, -2) @ J
    b = torch.sum(Js * e[..., None], dim=-2)
    return IcpTerms(H=H, b=b, matched=matched)


def icp_terms_packed(
    nav: torch.Tensor,
    base,
    depth: int,
    moving_pts: torch.Tensor,
    moving_valid: torch.Tensor,
    X: torch.Tensor,
    *,
    b_max,
    b_ratio,
    rho_ker,
    ladder: int = 0,
) -> IcpTerms:
    """Normal-equation contribution of one fixed tree inside a flat forest
    (``nav`` e.g. ``(K*M, 56)``, ``base`` the tree's row offset);
    ``moving_pts`` (L, 3) in the local frame, ``X`` the current
    moving-to-fixed estimate."""
    ml = moving_pts @ X[:3, :3].T + X[:3, 3]
    _, payload = associate_packed(nav, base, depth, ml, moving_valid, ladder=ladder)
    return terms_from_payload(
        payload, moving_pts, moving_valid, X,
        b_max=b_max, b_ratio=b_ratio, rho_ker=rho_ker,
    )


def icp_terms(
    fixed_tree: SearchTree,
    moving_pts: torch.Tensor,
    moving_valid: torch.Tensor,
    X: torch.Tensor,
    *,
    b_max,
    b_ratio,
    rho_ker,
    ladder: int = 0,
) -> IcpTerms:
    """Normal-equation contribution of one fixed tree (single-tree view)."""
    return icp_terms_packed(
        fixed_tree.nav, 0, fixed_tree.depth, moving_pts, moving_valid, X,
        b_max=b_max, b_ratio=b_ratio, rho_ker=rho_ker, ladder=ladder,
    )


def icp_normal_equations(H_parts: torch.Tensor, b_parts: torch.Tensor):
    """Reduce per-keyframe (K,6,6)/(K,6) contributions (OpenMP-adder analog)."""
    return torch.sum(H_parts, dim=0), torch.sum(b_parts, dim=0)


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


# Trust-region bound on one GN step (as in the JAX package): inactive on
# nominal trajectories, it only stops catastrophic escapes when the match
# set is degenerate.
GN_STEP_MAX_T = 1.0  # metres
GN_STEP_MAX_R = 0.5  # radians


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


def gn_se3_step(X: torch.Tensor, H: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One right-multiplicative Gauss-Newton update of X (``mad_icp.cpp:105-117``)."""
    return X @ exp_se3_split(clamp_step(solve_gn(H, b)))


def neg_logdet(H: torch.Tensor) -> torch.Tensor:
    """``-log det H``: the reference ranks frames by ``det(H^{-1})``
    (``pipeline.cpp:223, 234-244``); this orders identically and stays
    finite in float32. The dtype's max where ``det H <= 0``."""
    sign, logdet = torch.linalg.slogdet(H)
    return torch.where(sign > 0, -logdet, torch.finfo(H.dtype).max)
