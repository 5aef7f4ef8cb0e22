"""Closed-form batched eigendecomposition of symmetric 3x3 matrices.

The same trigonometric (Cardano) solution with cross-product
eigenvectors and degenerate-case conventions as the JAX package's
``ops/eigh3.py``, operation for operation. ``torch.linalg.eigh`` is not
a substitute: the eigenvector SIGN picks the split side of every tree
node (``ops/tree.py``), so another solver builds another — equally
valid — tree, and parity with the reference is lost.

Every value is formed one elementwise operation at a time, in a written
order, on per-component tensors: sums of three as ``(a + b) + c``, cross
products with one fused multiply-add a component (:func:`_cross`), the
scale as a running maximum in row-major order, and the divisions by 3 and
6 as products with the dtype's rounding of 1/3 and 1/6. Nothing is left
to a reduction whose order torch chooses, so the node kernel of the tree
build (``kernels/csrc/build_nodes.cu``) repeats it bit for bit on the
card.
"""

from __future__ import annotations

import math

import torch

THIRD = 1.0 / 3.0
SIXTH = 1.0 / 6.0
TWO_PI_THIRDS = 2.0 * math.pi / 3.0


def tolerances(dtype: torch.dtype) -> tuple[float, float]:
    """``(eps, tol_c)``: the norm below which a vector does not count and
    the eigenvalue gap below which a pair is canonicalised."""
    return (1e-12, 1e-6) if dtype == torch.float64 else (1e-6, 1e-3)


def _dot(a, b):
    """``(a0 b0 + a1 b1) + a2 b2`` over 3-tuples of tensors."""
    return (a[0] * b[0] + a[1] * b[1]) + a[2] * b[2]


def _cross(a, b):
    """Cross product of 3-tuples of tensors by ``torch.linalg.cross``: each
    component ``a_i b_j - a_j b_i`` is ``fma(a_i, b_j, -(a_j b_i))``, the
    product ``a_j b_i`` rounded and the other fused (torch's CPU kernel as
    GCC compiles it, and XLA's contraction of ``jnp.cross``: written out
    unfused, a near-degenerate node's normal moves 3e-9 from the JAX
    package's in float64)."""
    c = torch.linalg.cross(torch.stack(a, dim=-1), torch.stack(b, dim=-1), dim=-1)
    return c[..., 0], c[..., 1], c[..., 2]


def _select(cond, a, b):
    return tuple(torch.where(cond, x, y) for x, y in zip(a, b))


def _normalize(v, eps: float):
    n = torch.sqrt(_dot(v, v))
    ok = n > eps
    safe = torch.where(ok, n, 1.0)
    return tuple(c / safe for c in v), ok


def _eigvec_from_rows(a, lam, eps: float):
    """Eigenvector of symmetric ``a`` (3 rows of 3 tensors) for eigenvalue
    ``lam`` via row cross-products.

    Rows of (A - lam I) span the orthogonal complement of the eigenspace;
    the largest cross product of row pairs is a stable eigenvector estimate
    when lam is a simple eigenvalue. Returns (unit vector, validity mask).
    """
    r0, r1, r2 = (tuple(a[i][j] - lam if i == j else a[i][j] for j in range(3))
                  for i in range(3))
    c01 = _cross(r0, r1)
    c02 = _cross(r0, r2)
    c12 = _cross(r1, r2)
    n01, n02, n12 = _dot(c01, c01), _dot(c02, c02), _dot(c12, c12)
    best01 = (n01 >= n02) & (n01 >= n12)
    best02 = (~best01) & (n02 >= n12)
    return _normalize(_select(best01, c01, _select(best02, c02, c12)), eps)


def _any_perp(v, eps: float):
    """A unit vector orthogonal to unit vector v (batched, branch-free):
    the cross product with the coordinate axis least aligned with v."""
    use_ex = torch.abs(v[0]) <= torch.abs(v[1])
    axis = (use_ex.to(v[0].dtype), (~use_ex).to(v[0].dtype), torch.zeros_like(v[0]))
    p, _ = _normalize(_cross(v, axis), eps)
    return p


def _det3(a):
    """Closed-form 3x3 determinant (the expansion ``jnp.linalg.det`` uses)."""
    return (
        a[0][0] * a[1][1] * a[2][2]
        + a[0][1] * a[1][2] * a[2][0]
        + a[0][2] * a[1][0] * a[2][1]
        - a[0][2] * a[1][1] * a[2][0]
        - a[0][0] * a[1][2] * a[2][1]
        - a[0][1] * a[1][0] * a[2][2]
    )


def eigh3_parts(a):
    """The decomposition on components: ``a`` is 3 rows of 3 tensors of
    one shape; returns ``((l0, l1, l2), (v0, v1, v2), scale)`` with the
    eigenvalues of the scaled matrix ascending, each eigenvector a 3-tuple
    of tensors, and the scale (the largest ``|a_ij|``)."""
    t = a[0][0]
    eps, tol_c = tolerances(t.dtype)

    # scale for conditioning: the largest |a_ij|, row-major
    scale = torch.abs(a[0][0])
    for i, j in ((0, 1), (0, 2), (1, 0), (1, 1), (1, 2), (2, 0), (2, 1), (2, 2)):
        scale = torch.maximum(scale, torch.abs(a[i][j]))
    scale_safe = torch.where(scale > 0, scale, 1.0)
    s = tuple(tuple(a[i][j] / scale_safe for j in range(3)) for i in range(3))

    q = ((s[0][0] + s[1][1]) + s[2][2]) * THIRD
    b = tuple(tuple(s[i][j] - q if i == j else s[i][j] for j in range(3)) for i in range(3))
    p2 = b[0][0] * b[0][0]
    for i, j in ((0, 1), (0, 2), (1, 0), (1, 1), (1, 2), (2, 0), (2, 1), (2, 2)):
        p2 = p2 + b[i][j] * b[i][j]
    p = torch.sqrt(torch.clamp(p2 * SIXTH, min=0.0))
    degenerate_all = p < eps  # (near-)spherical: all eigenvalues equal

    p_safe = torch.where(degenerate_all, 1.0, p)
    bn = tuple(tuple(b[i][j] / p_safe for j in range(3)) for i in range(3))
    r = torch.clamp(_det3(bn) * 0.5, -1.0, 1.0)
    phi = torch.acos(r) * THIRD

    two_p = 2.0 * p
    l2 = q + two_p * torch.cos(phi)  # largest
    l0 = q + two_p * torch.cos(phi + TWO_PI_THIRDS)  # smallest
    l1 = 3.0 * q - l0 - l2
    l0 = torch.where(degenerate_all, q, l0)
    l1 = torch.where(degenerate_all, q, l1)
    l2 = torch.where(degenerate_all, q, l2)

    # eigenvectors: smallest (the surfel normal — must be the most
    # robust) and largest (the split direction), middle by cross product
    v0, ok0 = _eigvec_from_rows(s, l0, eps)
    v2, ok2 = _eigvec_from_rows(s, l2, eps)

    one, zero = torch.ones_like(t), torch.zeros_like(t)
    e0, e1, e2 = (one, zero, zero), (zero, one, zero), (zero, zero, one)

    # fallbacks for degenerate spectra
    v0 = _select(ok0, v0, _select(ok2, _any_perp(v2, eps), e0))
    # orthogonalise v2 against v0, fall back to a perpendicular if collapsed
    dot = _dot(v2, v0)
    v2, ok2b = _normalize(tuple(c - dot * c0 for c, c0 in zip(v2, v0)), eps)
    v2 = _select(ok2b, v2, _any_perp(v0, eps))

    # canonicalise (near-)degenerate PAIRS with the same deterministic
    # convention as the reference package (the coordinate-axis cross
    # product of the well-defined remaining eigenvector); thresholds as
    # there, sized to the trig formula's own error on degenerate pairs
    deg01 = (l1 - l0) < tol_c  # normal/middle plane degenerate
    deg12 = (l2 - l1) < tol_c  # split/middle plane degenerate
    v0 = _select(deg01 & ~deg12, _any_perp(v2, eps), v0)
    v2 = _select(deg12 & ~deg01, _any_perp(v0, eps), v2)

    v1, _ = _normalize(_cross(v2, v0), eps)

    # fully degenerate -> identity basis
    v0 = _select(degenerate_all, e0, v0)
    v1 = _select(degenerate_all, e1, v1)
    v2 = _select(degenerate_all, e2, v2)
    return (l0, l1, l2), (v0, v1, v2), scale


def eigh3(A: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Eigendecomposition of symmetric (..., 3, 3) matrices.

    Returns ``(evals, evecs)`` with eigenvalues ascending and eigenvectors
    as *columns* (``evecs[..., :, k]`` pairs with ``evals[..., k]``), like
    Eigen's ``SelfAdjointEigenSolver`` used at ``mad_tree.cpp:59-61``.
    The returned basis is orthonormal even for (near-)degenerate inputs.
    """
    a = tuple(tuple(A[..., i, j] for j in range(3)) for i in range(3))
    lams, vecs, scale = eigh3_parts(a)
    scale_safe = torch.where(scale > 0, scale, 1.0)
    evals = torch.stack(lams, dim=-1) * scale_safe[..., None]
    evals = torch.where(scale[..., None] > 0, evals, 0.0)
    evecs = torch.stack([torch.stack(v, dim=-1) for v in vecs], dim=-1)
    return evals, evecs
