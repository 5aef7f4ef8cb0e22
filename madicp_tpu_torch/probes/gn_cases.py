"""Inputs of the K10 (``gn_update``) and K11 (``certify_slack``) checks,
made from numpy seeds on the CPU: the GN update's cases (real normal
equations of a room scene, an empty H, a singular one, steps beyond each
trust bound, both branches of ``exp_so3``, an infinite diagonal entry),
per-keyframe terms with their weights, a certified later round's slack
pass, and a round's K7 -> K10 -> K11 inputs.
``tests/test_torch_gn_kernels.py`` holds the plain versions to the JAX
package with them and the kernels to the plain versions on the card;
``chip_smoke.py``'s ``gn`` phase does the latter too."""

from __future__ import annotations

import numpy as np
import torch
from scipy.spatial.transform import Rotation

from madicp_tpu_torch.ops.icp_core import icp_terms
from madicp_tpu_torch.ops.tree import build_tree

GN_CASES = ("real", "empty", "singular", "clamp_t", "clamp_r", "small_angle", "inf_0", "inf_3")


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
    branch); ``inf_0`` and ``inf_3`` (``H_00`` or ``H_33`` infinite: row
    and column i of the scaled system are zero but for a NaN pivot, and
    the components that depend on that row zero out)."""
    rng = np.random.default_rng(seed)
    X = pose(rng.normal(0, 0.3, 3), rng.normal(0, 5.0, 3))
    if case == "real":
        H, b = real_equations()
        return X, H.copy(), b.copy()
    if case == "empty":
        return X, np.zeros((6, 6)), np.zeros(6)
    A = rng.normal(0, 1, (6, 6))
    H = A @ A.T + np.diag([400.0, 400.0, 400.0, 2.0, 2.0, 2.0])
    if case.startswith("inf_"):
        i = int(case[4:])
        H[i, i] = np.inf
        return X, H, rng.normal(0, 1, 6)
    if case == "singular":
        H[2, :] = H[:, 2] = 0.0
        H[2, 2] = -1e-8  # cancels the solve's 1e-8 ridge exactly
        return X, H, rng.normal(0, 1, 6)
    dx = {"clamp_t": [2.5, -1.0, 0.5, 0.01, 0.02, -0.01],
          "clamp_r": [0.01, 0.02, 0.0, 0.6, -0.4, 0.3],
          "small_angle": [0.03, -0.02, 0.01, 4e-5, -3e-5, 2e-5]}[case]
    return X, H, -H @ np.asarray(dx)


def gn_batch(cases, seed: int = 0) -> tuple:
    """(X (B, 4, 4), H (B, 6, 6), b (B, 6)) float64 numpy of ``cases``."""
    parts = [gn_case(c, seed + i) for i, c in enumerate(cases)]
    return tuple(np.stack([p[j] for p in parts]) for j in range(3))


BATCHES = {**{c: (c,) for c in GN_CASES},
           "b4_mixed": ("real", "clamp_t", "small_angle", "empty"),
           "b4_edges": ("singular", "clamp_r", "real", "clamp_t"),
           "b4_inf": ("inf_0", "clamp_t", "inf_3", "real")}


def keyframe_terms(B: int, K: int, seed: int = 0) -> tuple:
    """(X (B, 4, 4), H (B, K, 6, 6), b (B, K, 6), w (B, K)) float64 numpy:
    per-keyframe normal equations of a round (each ``A A^T`` plus a
    diagonal, translations ~100 times the rotations), and the keyframe
    weights with an empty ring slot (0) in each sequence where K > 1."""
    rng = np.random.default_rng(seed)
    X = np.stack([pose(rng.normal(0, 0.3, 3), rng.normal(0, 5.0, 3)) for _ in range(B)])
    A = rng.normal(0, 1, (B, K, 6, 6))
    H = A @ np.swapaxes(A, -1, -2) + np.diag([100.0, 100.0, 100.0, 1.0, 1.0, 1.0])
    b = rng.normal(0, 1, (B, K, 6))
    w = np.ones((B, K))
    if K > 1:
        w[np.arange(B), rng.integers(0, K, B)] = 0.0
    return X, H, b, w


TERMS_KW = dict(b_max=0.2, b_ratio=0.02, rho_ker=0.1)


def round_inputs(dtype, B: int = 2, K: int = 5, L: int = 3000, seed: int = 0) -> dict:
    """A certified later round's K7 -> K10 -> K11 inputs: the K7
    ``payload`` (B, K, L, 8) (map points near the leaves mapped by ``X``,
    unit normals, bbox0 and flags), the leaves ``pts`` (B, L, 3) and their
    ``valid`` (B, L), the previous pose ``Xp`` (B, 4, 4), the keyframe
    weights ``w`` (B, K) and the slack pass's inputs (:func:`slack_inputs`
    for the rest). K7 takes :data:`TERMS_KW`."""
    s = slack_inputs(dtype, B=B, K=K, L=L, seed=seed)
    rng = np.random.default_rng(seed + 1)
    pts = s["pts"].double().numpy()
    X = s["Xp"].double().numpy()
    ml = pts[:, None] @ np.swapaxes(X[:, None, :3, :3], -1, -2) + X[:, None, None, :3, 3]
    n = rng.normal(0, 1, (B, K, L, 3))
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    near = np.broadcast_to(ml, (B, K, L, 3)) + rng.normal(0, 0.1, (B, K, L, 3))
    payload = np.concatenate([near, n, rng.uniform(0, 0.15, (B, K, L, 1)),
                              rng.choice([3.0, 3.0, 3.0, 2.0, 0.0], (B, K, L, 1))], axis=-1)
    w = s["kf_live"].to(dtype)
    return dict(s, payload=torch.as_tensor(payload, dtype=dtype), w=w)


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
    """``(A, rhs)``: the Jacobi-scaled system ``solve_gn`` hands its LU,
    for timing the library solve (``torch.linalg.solve_ex``) alone."""
    diag = torch.diagonal(H, dim1=-2, dim2=-1)
    e = torch.reciprocal(torch.where(diag > 0, torch.sqrt(torch.clamp(diag, min=1e-30)), 1.0))
    eye = torch.eye(6, dtype=H.dtype, device=H.device)
    return H * (e[..., :, None] * e[..., None, :]) + 1e-8 * eye, -(b * e)


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
