"""Inputs of the K10 (``gn_update``) and K11 (``certify_slack``) checks,
made from numpy seeds on the CPU: the GN update's cases (real normal
equations of a room scene, an empty H, a singular one, steps beyond each
trust bound, both branches of ``exp_so3``) and a certified later round's
slack pass. ``tests/test_torch_gn_kernels.py`` holds the plain versions to
the JAX package with them and the kernels to the plain versions on the
card; ``chip_smoke.py``'s ``gn`` phase does the latter too."""

from __future__ import annotations

import numpy as np
import torch
from scipy.spatial.transform import Rotation

from madicp_tpu_torch.ops.icp_core import icp_terms
from madicp_tpu_torch.ops.tree import build_tree

GN_CASES = ("real", "empty", "singular", "clamp_t", "clamp_r", "small_angle")


def pose(rotvec, t) -> np.ndarray:
    X = np.eye(4)
    X[:3, :3] = Rotation.from_rotvec(rotvec).as_matrix()
    X[:3, 3] = t
    return X


_REAL: dict = {}


def real_equations() -> tuple:
    """(H (6, 6), b (6,)) of a 4 m room's points 2 cm and 10 mrad off
    their tree, from the port's terms (plain, float64); made once."""
    if not _REAL:
        rng = np.random.default_rng(7)
        n = 600
        room = np.concatenate([
            rng.uniform([0, 0, 0], [4, 0.01, 2], (n, 3)),
            rng.uniform([0, 0, 0], [0.01, 4, 2], (n, 3)),
            rng.uniform([3.99, 0, 0], [4, 4, 2], (n, 3)),
            rng.uniform([0, 0, 0], [4, 4, 0.01], (n, 3)),
        ])
        pts = torch.from_numpy(room)
        tree, _ = build_tree(pts, torch.ones(len(room), dtype=torch.bool), depth=10,
                             b_max=0.2, b_min=0.1)
        X = torch.from_numpy(pose([0.0, 0.004, 0.01], [0.02, -0.01, 0.005]))
        t = icp_terms(tree, pts, torch.ones(len(room), dtype=torch.bool), X,
                      b_max=0.2, b_ratio=0.02, rho_ker=0.1)
        _REAL["eq"] = (t.H.numpy(), t.b.numpy())
    return _REAL["eq"]


def gn_case(case: str, seed: int = 0) -> tuple:
    """(X (4, 4), H (6, 6), b (6,)) float64 numpy of one case: ``real``
    normal equations; ``empty`` (H = 0: no step); ``singular`` (the third
    axis unobserved, its diagonal entry just below zero: the scaled system
    is singular, the solve's first three components are not finite and
    zero out); ``clamp_t`` and
    ``clamp_r`` (a step beyond the 1 m or the 0.5 rad trust bound);
    ``small_angle`` (a rotation step below exp_so3's theta^2 = 1e-8
    branch)."""
    rng = np.random.default_rng(seed)
    X = pose(rng.normal(0, 0.3, 3), rng.normal(0, 5.0, 3))
    if case == "real":
        H, b = real_equations()
        return X, H.copy(), b.copy()
    if case == "empty":
        return X, np.zeros((6, 6)), np.zeros(6)
    A = rng.normal(0, 1, (6, 6))
    H = A @ A.T + np.diag([400.0, 400.0, 400.0, 2.0, 2.0, 2.0])
    if case == "singular":
        H[2, :] = H[:, 2] = 0.0
        H[2, 2] = -1e-8  # cancels the solve's 1e-8 ridge exactly
        return X, H, rng.normal(0, 1, 6)
    dx = {"clamp_t": [2.5, -1.0, 0.5, 0.01, 0.02, -0.01],
          "clamp_r": [0.01, 0.02, 0.0, 0.6, -0.4, 0.3],
          "small_angle": [0.03, -0.02, 0.01, 4e-5, -3e-5, 2e-5]}[case]
    return X, H, -H @ np.asarray(dx)


def plain_by_sequence(X, H, b):
    """The plain GN update of each sequence of a batch on its own (a
    ``(6, 6)`` solve each): the yardstick of the kernel on the card. The
    plain version's batched LU on the card does not stop at a zero
    pivot, so for a singular system it zeroes the whole step, where
    LAPACK's getrf (the CPU, and so the JAX reference), the card's LU of
    one matrix and the kernel zero only the components that are not
    finite."""
    from madicp_tpu_torch.kernels.gn_update import gn_update_plain

    return torch.stack([gn_update_plain(X[i], H[i], b[i]) for i in range(X.shape[0])])


def gn_batch(cases, seed: int = 0) -> tuple:
    """(X (B, 4, 4), H (B, 6, 6), b (B, 6)) float64 numpy of ``cases``."""
    parts = [gn_case(c, seed + i) for i, c in enumerate(cases)]
    return tuple(np.stack([p[j] for p in parts]) for j in range(3))


BATCHES = {**{c: (c,) for c in GN_CASES},
           "b4_mixed": ("real", "clamp_t", "small_angle", "empty"),
           "b4_edges": ("singular", "clamp_r", "real", "clamp_t")}


def slack_inputs(dtype, B: int = 2, K: int = 3, L: int = 500, seed: int = 0) -> dict:
    """A certified later round's inputs: poses ``Xp`` and ``X`` (B, 4, 4)
    a GN step apart (mm and mrad, at ~20 m from the origin), leaves ``pts``
    (B, L, 3) out to ~40 m, their norms, margins as ``slack`` (B, K, L)
    spread around each entry's motion, ~10% invalid leaves, a dead
    keyframe, and a descent count."""
    rng = np.random.default_rng(seed)
    Xp = np.stack([pose(rng.normal(0, 0.2, 3), rng.normal(0, 12, 3)) for _ in range(B)])
    step = np.stack([pose(rng.normal(0, 2e-3, 3), rng.normal(0, 5e-3, 3)) for _ in range(B)])
    X = Xp @ step
    pts = rng.uniform(-40, 40, (B, L, 3))
    move = np.linalg.norm(pts @ np.transpose(X[:, :3, :3] - Xp[:, :3, :3], (0, 2, 1))
                          + (X[:, :3, 3] - Xp[:, :3, 3])[:, None], axis=-1)
    slack = move[:, None, :] * rng.uniform(0.0, 2.0, (B, K, L))
    valid = rng.random((B, L)) > 0.1
    kf_live = np.ones((B, K), dtype=bool)
    kf_live[0, -1] = False
    t = lambda a: torch.as_tensor(a, dtype=dtype)  # noqa: E731
    p = t(pts)
    return dict(slack=t(slack), Xp=t(Xp), X=t(X), pts=p,
                r_norm=torch.sqrt(torch.sum(p * p, dim=-1)),
                leaves_valid=torch.from_numpy(valid), kf_live=torch.from_numpy(kf_live),
                n_descents=torch.tensor([5, 7][:B] + [0] * max(0, B - 2), dtype=torch.int64))


def scaled_system(H: torch.Tensor, b: torch.Tensor) -> tuple:
    """``(A, rhs)``: the Jacobi-scaled system ``solve_gn`` hands
    ``torch.linalg.solve_ex``, for timing the library solve alone."""
    diag = torch.diagonal(H, dim1=-2, dim2=-1)
    d = torch.where(diag > 0, torch.sqrt(torch.clamp(diag, min=1e-30)), 1.0)
    eye = torch.eye(6, dtype=H.dtype, device=H.device)
    return H / (d[..., :, None] * d[..., None, :]) + 1e-8 * eye, -b / d


def gemm_slack_pass(slack, Xp, X, pts, r_norm, leaves_valid, kf_live, n_descents) -> tuple:
    """A certified later round's slack pass as ``icp_rounds`` formed it
    before K11, on copies (nothing in place): the motion bound through a
    GEMM, norms through ``torch.sum``, ``need = uncert & live_kl``.
    Returns ``(bound (B, L), eps_cert (B, L), slack, need, n_descents)``."""
    d = pts @ (X[:, :3, :3] - Xp[:, :3, :3]).mT + (X[:, :3, 3] - Xp[:, :3, 3])[:, None]
    bound = torch.sqrt(torch.sum(d * d, dim=-1))
    t_norm = torch.sqrt(torch.sum(X[:, :3, 3] * X[:, :3, 3], dim=-1))
    eps = 64.0 * torch.finfo(X.dtype).eps * (1.0 + t_norm[:, None] + r_norm)
    slack = slack - bound[:, None, :]
    uncert = slack <= eps[:, None, :]
    live_kl = leaves_valid[:, None, :] & kf_live[:, :, None]
    need = uncert & live_kl
    return bound, eps, slack, need, n_descents + (uncert & live_kl).sum(dim=(1, 2))
