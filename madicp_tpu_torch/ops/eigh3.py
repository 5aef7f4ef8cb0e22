"""Closed-form batched eigendecomposition of symmetric 3x3 matrices.

The same trigonometric (Cardano) solution with cross-product
eigenvectors and degenerate-case conventions as the JAX package's
``ops/eigh3.py``, operation for operation. ``torch.linalg.eigh`` is not
a substitute: the eigenvector SIGN picks the split side of every tree
node (``ops/tree.py``), so another solver builds another — equally
valid — tree, and parity with the reference is lost.
"""

from __future__ import annotations

import math

import torch


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True))


def _normalize(v: torch.Tensor, eps: float) -> tuple[torch.Tensor, torch.Tensor]:
    n = _norm(v)
    ok = n[..., 0] > eps
    v = v / torch.where(n > eps, n, torch.ones_like(n))
    return v, ok


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.linalg.cross(a, b, dim=-1)


def _eigvec_from_rows(A: torch.Tensor, lam: torch.Tensor, eps: float):
    """Eigenvector of symmetric A for eigenvalue lam via row cross-products.

    Rows of (A - lam I) span the orthogonal complement of the eigenspace;
    the largest cross product of row pairs is a stable eigenvector estimate
    when lam is a simple eigenvalue. Returns (unit vector, validity mask).
    """
    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    M = A - lam[..., None, None] * eye
    r0, r1, r2 = M[..., 0, :], M[..., 1, :], M[..., 2, :]
    c01 = _cross(r0, r1)
    c02 = _cross(r0, r2)
    c12 = _cross(r1, r2)
    n01 = torch.sum(c01 * c01, dim=-1)
    n02 = torch.sum(c02 * c02, dim=-1)
    n12 = torch.sum(c12 * c12, dim=-1)
    best01 = (n01 >= n02) & (n01 >= n12)
    best02 = (~best01) & (n02 >= n12)
    v = torch.where(
        best01[..., None], c01, torch.where(best02[..., None], c02, c12)
    )
    return _normalize(v, eps)


def _any_perp(v: torch.Tensor, eps: float) -> torch.Tensor:
    """A unit vector orthogonal to unit vector v (batched, branch-free)."""
    # cross with the coordinate axis least aligned with v
    # made on the device: a copy of host values would synchronise
    ex, ey = torch.eye(3, dtype=v.dtype, device=v.device)[:2]
    use_ex = torch.abs(v[..., 0]) <= torch.abs(v[..., 1])
    axis = torch.where(use_ex[..., None], ex.expand(v.shape), ey.expand(v.shape))
    p, _ = _normalize(_cross(v, axis), eps)
    return p


def _det3(a: torch.Tensor) -> torch.Tensor:
    """Closed-form 3x3 determinant (the expansion ``jnp.linalg.det`` uses)."""
    return (
        a[..., 0, 0] * a[..., 1, 1] * a[..., 2, 2]
        + a[..., 0, 1] * a[..., 1, 2] * a[..., 2, 0]
        + a[..., 0, 2] * a[..., 1, 0] * a[..., 2, 1]
        - a[..., 0, 2] * a[..., 1, 1] * a[..., 2, 0]
        - a[..., 0, 0] * a[..., 1, 2] * a[..., 2, 1]
        - a[..., 0, 1] * a[..., 1, 0] * a[..., 2, 2]
    )


def eigh3(A: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Eigendecomposition of symmetric (..., 3, 3) matrices.

    Returns ``(evals, evecs)`` with eigenvalues ascending and eigenvectors
    as *columns* (``evecs[..., :, k]`` pairs with ``evals[..., k]``), like
    Eigen's ``SelfAdjointEigenSolver`` used at ``mad_tree.cpp:59-61``.
    The returned basis is orthonormal even for (near-)degenerate inputs.
    """
    dtype = A.dtype
    eps = 1e-12 if dtype == torch.float64 else 1e-6
    eye = torch.eye(3, dtype=dtype, device=A.device)

    # scale for conditioning
    scale = torch.amax(torch.abs(A), dim=(-1, -2))
    scale_safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    As = A / scale_safe[..., None, None]

    q = torch.diagonal(As, dim1=-2, dim2=-1).sum(-1) / 3.0
    B = As - q[..., None, None] * eye
    p2 = torch.sum(B * B, dim=(-1, -2)) / 6.0
    p = torch.sqrt(torch.clamp(p2, min=0.0))
    degenerate_all = p < eps  # (near-)spherical: all eigenvalues equal

    p_safe = torch.where(degenerate_all, torch.ones_like(p), p)
    Bn = B / p_safe[..., None, None]
    r = torch.clamp(_det3(Bn) / 2.0, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0

    l2 = q + 2.0 * p * torch.cos(phi)  # largest
    l0 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)  # smallest
    l1 = 3.0 * q - l0 - l2
    l0 = torch.where(degenerate_all, q, l0)
    l1 = torch.where(degenerate_all, q, l1)
    l2 = torch.where(degenerate_all, q, l2)

    # eigenvectors: smallest (the surfel normal — must be the most
    # robust) and largest (the split direction), middle by cross product
    v0, ok0 = _eigvec_from_rows(As, l0, eps)
    v2, ok2 = _eigvec_from_rows(As, l2, eps)

    e0 = eye[:, 0].expand(v0.shape)
    e1 = eye[:, 1].expand(v0.shape)
    e2 = eye[:, 2].expand(v0.shape)

    # fallbacks for degenerate spectra
    v0 = torch.where(
        ok0[..., None], v0, torch.where(ok2[..., None], _any_perp(v2, eps), e0)
    )
    # orthogonalise v2 against v0, fall back to a perpendicular if collapsed
    v2 = v2 - torch.sum(v2 * v0, dim=-1, keepdim=True) * v0
    v2, ok2b = _normalize(v2, eps)
    v2 = torch.where(ok2b[..., None], v2, _any_perp(v0, eps))

    # canonicalise (near-)degenerate PAIRS with the same deterministic
    # convention as the reference package (the coordinate-axis cross
    # product of the well-defined remaining eigenvector); thresholds as
    # there, sized to the trig formula's own error on degenerate pairs
    tol_c = 1e-6 if dtype == torch.float64 else 1e-3
    deg01 = (l1 - l0) < tol_c  # normal/middle plane degenerate
    deg12 = (l2 - l1) < tol_c  # split/middle plane degenerate
    v0 = torch.where((deg01 & ~deg12)[..., None], _any_perp(v2, eps), v0)
    v2 = torch.where((deg12 & ~deg01)[..., None], _any_perp(v0, eps), v2)

    v1, _ = _normalize(_cross(v2, v0), eps)

    # fully degenerate -> identity basis
    v0 = torch.where(degenerate_all[..., None], e0, v0)
    v1 = torch.where(degenerate_all[..., None], e1, v1)
    v2 = torch.where(degenerate_all[..., None], e2, v2)

    evals = torch.stack([l0, l1, l2], dim=-1) * scale_safe[..., None]
    evals = torch.where(scale[..., None] > 0, evals, torch.zeros_like(evals))
    evecs = torch.stack([v0, v1, v2], dim=-1)
    return evals, evecs
