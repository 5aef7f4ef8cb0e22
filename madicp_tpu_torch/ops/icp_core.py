"""Point-to-plane ICP core: association, residuals, normal equations, GN step.

The reference's per-leaf serial loop (``mad_icp.cpp:74-117``) as batched
work: the whole moving-leaf set descends the fixed tree(s) at once,
residual/Jacobian/weight are per entry, and the 6x6 normal equations
are one masked ``(s J)^T J`` sum per keyframe. On the card the descent,
the terms and the GN update are hand-written kernels
(``kernels/descent.py``, ``kernels/icp_terms.py``,
``kernels/gn_update.py``); on the CPU, their plain tensor versions.

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

from madicp_tpu_torch.kernels import descent, gn_update
from madicp_tpu_torch.kernels import icp_terms as terms_kernel
from madicp_tpu_torch.kernels.gn_update import (  # noqa: F401  (the update's steps)
    GN_STEP_MAX_R,
    GN_STEP_MAX_T,
    clamp_step,
    solve_gn,
)
from madicp_tpu_torch.ops.tree import SearchTree, search_forest


class IcpTerms(NamedTuple):
    H: torch.Tensor        # (..., 6, 6)
    b: torch.Tensor        # (..., 6)
    matched: torch.Tensor  # (..., L) bool — gated matches of this fixed tree (or None)


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


def associate_ring(
    nav: torch.Tensor,
    depth: int,
    moving_pts: torch.Tensor,
    need: torch.Tensor,
    *,
    X: torch.Tensor,
    start: torch.Tensor = None,
    n_gathers: int = None,
    return_margin: bool = False,
    out=None,
):
    """Descend every (keyframe, query) entry of a keyframe ring in ONE
    batched call over its ``(K, M, 56)`` arenas, each query on its
    keyframe's rows.

    ``nav`` (K, M, 56); ``moving_pts`` (Q, 3) shared by every keyframe,
    or (G, Q, 3) shared by each group of K / G consecutive keyframes (a
    batch's sequences: G = B, K = B x keyframes), in the scan frame;
    ``X`` the scan-to-map poses, (P, 4, 4) with P dividing G (a
    sequence's pose for its groups) or (4, 4): each entry descends with
    its query mapped by its pose in the terms' order
    (:func:`~madicp_tpu_torch.kernels.icp_terms.moving_in_map`, K7's
    ``ml``); callers holding map-frame points pass the identity. ``need``
    (K, Q) — entries without it park on row 0 of their keyframe's arena.
    ``start`` (K, Q) holds LOCAL node ids. Returns ``(leaf_ids, payload[,
    margin])`` shaped (K, Q, ...), as :func:`associate_packed`. With
    ``out`` (those tensors of an earlier call) only the ``need`` entries
    are descended and written, in place: the certified schedule's
    re-association merge.

    :func:`madicp_tpu_torch.kernels.descent.descend_ring`: on the card one
    launch reads each group's queries where they lie and maps them in
    registers."""
    return descent.descend_ring(nav, moving_pts, depth, need, X=X, start=start,
                                n_gathers=n_gathers, return_margin=return_margin, out=out)


def terms_from_payload(
    payload: torch.Tensor,
    moving_pts: torch.Tensor,
    moving_valid: torch.Tensor,
    X: torch.Tensor,
    *,
    b_max,
    b_ratio,
    rho_ker,
    n_live: torch.Tensor = None,
    with_matched: bool = True,
) -> IcpTerms:
    """Gate + residual/Jacobian/weights + normal equations from an
    association payload ``(..., L, 8)`` — no tree access. Leading axes
    (e.g. keyframes) give one ``(H, b, matched)`` each; ``moving_pts``
    (L, 3) and ``moving_valid`` (L,) are shared by them, or carry the same
    leading axes (a per-keyframe leaf order). ``X`` (4, 4), or (..., 4, 4)
    with leading axes that broadcast against the payload's (one pose per
    sequence of a batch: X (B, 1, 4, 4) against payloads (B, K, L, 8)).
    The gate is evaluated under the CURRENT ``X`` (``mad_icp.cpp:81-83``).
    ``n_live`` (int64, leading axes that broadcast to the payload's): the
    entries at or past it count as invalid and are not walked (a scan's
    leaf count: its leaves are a prefix of their slots); without
    ``with_matched``, ``matched`` is None.

    CPU tensors take the plain version
    (:func:`madicp_tpu_torch.kernels.icp_terms.terms_plain`), CUDA tensors
    the terms kernel (``kernels/csrc/icp_terms.cu``: per-entry values in
    the plain version's order, so ``matched`` agrees bit for bit; the 27
    sums in double, in a fixed order)."""
    H, b, matched = terms_kernel.terms(payload, moving_pts, moving_valid, X, b_max=b_max,
                                       b_ratio=b_ratio, rho_ker=rho_ker, n_live=n_live,
                                       with_matched=with_matched)
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
    ml = terms_kernel.moving_in_map(moving_pts, X)  # the terms' own map-frame points
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


def gn_se3_step(X: torch.Tensor, H: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One right-multiplicative Gauss-Newton update of X (``mad_icp.cpp:105-117``):
    :func:`solve_gn`, :func:`clamp_step`, ``exp_se3_split`` and the
    product. CPU tensors take the plain chain
    (:func:`madicp_tpu_torch.kernels.gn_update.gn_update_plain`), CUDA
    tensors the update kernel (``kernels/csrc/gn_update.cu``: one launch,
    one warp a sequence)."""
    return gn_update.gn_update(X, H, b)


def neg_logdet(H: torch.Tensor) -> torch.Tensor:
    """``-log det H`` of (..., 6, 6): the reference ranks frames by
    ``det(H^{-1})`` (``pipeline.cpp:223, 234-244``); this orders
    identically and stays finite in float32. The dtype's max where ``det
    H <= 0`` (or is not a number). Formed in K14's order
    (``kernels/csrc/step_scalars.cu``): the LU of
    :func:`~madicp_tpu_torch.kernels.gn_update.lu_factor`, then ``-((log
    |u_0| + log |u_1|) + ... + log |u_5|)`` over the pivots in position
    order; the sign of the determinant is that of the row swaps and the
    negative pivots."""
    pivots, _, swaps = gn_update.lu_factor(H.clone(), H.shape[-1])
    total, negative = None, swaps
    bad = torch.zeros(H.shape[:-2], dtype=torch.bool, device=H.device)
    for u in pivots:
        log_u = torch.log(torch.abs(u))
        total = log_u if total is None else total + log_u
        negative = negative + (u < 0)
        bad = bad | ~((u < 0) | (u > 0))
    return torch.where(~bad & (negative % 2 == 0), -total, torch.finfo(H.dtype).max)
