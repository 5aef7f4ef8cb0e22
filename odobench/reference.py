"""The plain reference: MAD-ICP odometry in float64, written from the
upstream algorithm (``rvp-group/mad-icp``: ``mad_tree.cpp``,
``mad_icp.cpp``, ``pipeline.cpp``, ``vel_estimator.cpp``) in plain torch
tensor operations. It imports nothing of the program and takes nothing
the program made: it builds its own trees from the same scans, primes its
own ring from the same scans and poses, and works every later state out
itself.

Where upstream leaves a choice that changes the answer, the reference
follows the configuration under test:

- the eigenvectors of a node come from the closed-form trigonometric
  solver with row cross products (the sign of the split direction picks
  which child is left, and with it the arena order), with the float32
  configuration's tolerances for degenerate spectra;
- the tree is an implicit heap of ``2 ** (depth + 1)`` rows with forced
  leaves at the depth cap, and only the first ``max_leaves`` leaves in
  arena order take part in the registration (the static capacity; 0, the
  CLI's default, is ``n_points``: every leaf of a scan);
- a leaf's representative is the point nearest its mean, near ties
  (within a relative 1e-4) to the lowest index;
- the keyframe ring of the configuration's size is overwritten from its
  head, the promoted frame is the one of least ``-log det H`` in the
  window of the last ten scans;
- the Gauss-Newton step is Jacobi-scaled and clamped to 1 m and 0.5 rad.

Every value is float64 (the check's control runs it in float32 with
TF32 matmuls). The functions take and return tensors on any device: on a
card the check runs there once the program's state is freed.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass

import torch

CHUNKS = 1024          # deskew azimuth bins (constants.h:31)
SMOOTHING_T = 10       # velocity window (constants.h:32)
E_THRESHOLD_VEL = 0.3162
MAX_ICP_ITS = 15       # constants.h:34
FRAME_WINDOW = 10      # constants.h:35
STEP_MAX_T, STEP_MAX_R = 1.0, 0.5
EIG_EPS, EIG_TOL = 1e-6, 1e-3  # the float32 configuration's
TIE_TOL = 1e-4
F64 = torch.float64


@dataclass(frozen=True)
class Params:
    sensor_hz: float
    deskew: bool
    b_max: float
    b_min: float
    b_ratio: float
    rho_ker: float
    p_th: float
    num_keyframes: int
    depth: int
    max_leaves: int

    @classmethod
    def of(cls, config: dict) -> "Params":
        a = config["assumed"]
        depth = int(a["depth"])
        cap = min(int(a["max_leaves"]) or int(a["n_points"]), 1 << (depth + 1))
        return cls(float(config["sensor_hz"]), bool(config["deskew"]), config["b_max"],
                   config["b_min"], config["b_ratio"], config["rho_ker"], config["p_th"],
                   int(config["num_keyframes"]), depth, cap)


# ------------------------------------------------------------------ lie --
def skew(w):
    z = torch.zeros_like(w[..., 0])
    x, y, c = w.unbind(-1)
    return torch.stack([torch.stack([z, -c, y], -1), torch.stack([c, z, -x], -1),
                        torch.stack([-y, x, z], -1)], -2)


def exp_so3(w):
    """Rodrigues: (..., 3) -> (..., 3, 3); ``I + W`` below theta^2 1e-8."""
    th2 = (w * w).sum(-1)[..., None, None]
    th = torch.sqrt(torch.where(th2 < 1e-8, torch.ones_like(th2), th2))
    W = skew(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(W.shape)
    full = eye + torch.sin(th) / th * W + (1 - torch.cos(th)) / (th * th) * (W @ W)
    return torch.where(th2 < 1e-8, eye + W, full)


def log_so3(R):
    """(3, 3) -> (3,), away from pi (a deskew's rotation over one scan)."""
    c = torch.clamp((R[0, 0] + R[1, 1] + R[2, 2] - 1) / 2, -1.0, 1.0)
    th = torch.arccos(c)
    v = torch.stack([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    mag = th / (2 * torch.sin(th)) if float(th) > 1e-7 else torch.full((), 0.5, dtype=R.dtype, device=R.device)
    return mag * v


def se3(R, t):
    T = torch.eye(4, dtype=R.dtype, device=R.device)
    T[:3, :3], T[:3, 3] = R, t
    return T


def inverse(T):
    R, t = T[:3, :3], T[:3, 3]
    return se3(R.T, -(R.T @ t))


def euler_xyz(R):
    """vel_estimator.cpp:53-56 (batched)."""
    return torch.stack([torch.atan2(-R[..., 1, 2], R[..., 2, 2]),
                        torch.asin(torch.clamp(R[..., 0, 2], -1.0, 1.0)),
                        torch.atan2(-R[..., 0, 1], R[..., 0, 0])], -1)


# --------------------------------------------------------------- eigh3 --
def _normalize(v):
    n = torch.linalg.norm(v, dim=-1, keepdim=True)
    ok = n[..., 0] > EIG_EPS
    return v / torch.where(n > EIG_EPS, n, torch.ones_like(n)), ok


def _any_perp(v):
    use_x = v[..., 0].abs() <= v[..., 1].abs()
    axis = torch.stack([use_x, ~use_x, torch.zeros_like(use_x)], -1).to(v.dtype)
    return _normalize(torch.linalg.cross(v, axis, dim=-1))[0]


def _eigvec(s, lam):
    r = s - lam[..., None, None] * torch.eye(3, dtype=s.dtype, device=s.device)
    c = torch.stack([torch.linalg.cross(r[..., 0, :], r[..., 1, :], dim=-1),
                     torch.linalg.cross(r[..., 0, :], r[..., 2, :], dim=-1),
                     torch.linalg.cross(r[..., 1, :], r[..., 2, :], dim=-1)], -2)
    n = (c * c).sum(-1)
    b01 = (n[..., 0] >= n[..., 1]) & (n[..., 0] >= n[..., 2])
    b02 = ~b01 & (n[..., 1] >= n[..., 2])
    pick = torch.where(b01, 0, torch.where(b02, 1, 2))
    return _normalize(torch.take_along_dim(c, pick[..., None, None], dim=-2)[..., 0, :])


def eigh3(C):
    """Eigenvectors of symmetric (n, 3, 3): ``(v0, v1, v2)`` for the
    smallest, middle and largest eigenvalue, each (n, 3): the closed-form
    trigonometric solution of the scaled matrix, eigenvectors from row
    cross products, degenerate spectra canonicalised by the cross product
    with the coordinate axis least aligned."""
    scale = C.abs().flatten(-2).amax(-1)
    s = C / torch.where(scale > 0, scale, torch.ones_like(scale))[..., None, None]
    q = (s[..., 0, 0] + s[..., 1, 1] + s[..., 2, 2]) / 3
    eye = torch.eye(3, dtype=C.dtype, device=C.device)
    b = s - q[..., None, None] * eye
    p = torch.sqrt(torch.clamp((b * b).flatten(-2).sum(-1) / 6, min=0.0))
    deg_all = p < EIG_EPS
    bn = b / torch.where(deg_all, torch.ones_like(p), p)[..., None, None]
    det = (bn[..., 0, 0] * (bn[..., 1, 1] * bn[..., 2, 2] - bn[..., 1, 2] * bn[..., 2, 1])
           - bn[..., 0, 1] * (bn[..., 1, 0] * bn[..., 2, 2] - bn[..., 1, 2] * bn[..., 2, 0])
           + bn[..., 0, 2] * (bn[..., 1, 0] * bn[..., 2, 1] - bn[..., 1, 1] * bn[..., 2, 0]))
    r = torch.clamp(det / 2, -1.0, 1.0)
    phi = torch.arccos(r) / 3
    l2 = q + 2 * p * torch.cos(phi)
    l0 = q + 2 * p * torch.cos(phi + 2 * math.pi / 3)
    l1 = 3 * q - l0 - l2
    v0, ok0 = _eigvec(s, l0)
    v2, ok2 = _eigvec(s, l2)
    e0, e1, e2 = (eye[i].expand(v0.shape) for i in range(3))
    v0 = torch.where(ok0[..., None], v0, torch.where(ok2[..., None], _any_perp(v2), e0))
    v2, ok2b = _normalize(v2 - (v2 * v0).sum(-1, keepdim=True) * v0)
    v2 = torch.where(ok2b[..., None], v2, _any_perp(v0))
    deg01, deg12 = (l1 - l0) < EIG_TOL, (l2 - l1) < EIG_TOL
    v0 = torch.where((deg01 & ~deg12)[..., None], _any_perp(v2), v0)
    v2 = torch.where((deg12 & ~deg01)[..., None], _any_perp(v0), v2)
    v1 = _normalize(torch.linalg.cross(v2, v0, dim=-1))[0]
    d = deg_all[..., None]
    return torch.where(d, e0, v0), torch.where(d, e1, v1), torch.where(d, e2, v2)


# ---------------------------------------------------------------- tree --
def build_tree(points, depth: int, b_max: float, b_min: float) -> dict:
    """The MAD-tree of a cloud (n, 3): heap rows (root 1, children 2i,
    2i + 1), level by level. A node's mean and Bessel-corrected
    covariance, its eigenbasis; the oriented extents of its points about
    its mean (origin included); a real node is a leaf when its extent
    along the split direction is below ``b_max`` or at the depth cap. A
    node inherits the PCA normal of its highest ancestor thinner than
    ``b_min`` (the plane predecessor); a node of fewer than 3 points the
    normal of its nearest ancestor of 3 or more. Points go right where
    their offset along the split direction is >= 0.

    Returns the tree's fields (rows ``2 ** (depth + 1)``) and ``stats``:
    for every level the points and nodes the level's passes touch."""
    dev, n, dt = points.device, points.shape[0], points.dtype
    M = 1 << (depth + 1)
    z3 = lambda: torch.zeros((M, 3), dtype=dt, device=dev)  # noqa: E731
    t = dict(mean=z3(), split=z3(), normal=z3(), pca=z3(), ppn=z3(), n3=z3(), repr=z3(),
             bbox0=torch.zeros(M, dtype=dt, device=dev),
             is_leaf=torch.zeros(M, dtype=torch.bool, device=dev),
             is_real=torch.zeros(M, dtype=torch.bool, device=dev),
             has_pp=torch.zeros(M, dtype=torch.bool, device=dev))
    node = torch.ones(n, dtype=torch.int64, device=dev)
    alive = torch.arange(n, device=dev)
    leaf_of = torch.zeros(n, dtype=torch.int64, device=dev)
    frz = torch.full((n,), math.inf, dtype=dt, device=dev)
    stats = []
    retired_prev, children_prev = 0, 0
    for level in range(depth + 1):
        lo = 1 << level
        p = points[alive]
        nd = node[alive]
        j = nd - lo
        k = torch.bincount(j, minlength=lo).to(dt)
        kk = torch.clamp(k, min=1.0)
        mean = torch.zeros((lo, 3), dtype=dt, device=dev).index_add_(0, j, p) / kk[:, None]
        d = p - mean[j]
        cov = torch.zeros((lo, 9), dtype=dt, device=dev).index_add_(
            0, j, (d[:, :, None] * d[:, None, :]).reshape(-1, 9)).view(lo, 3, 3)
        cov = torch.where((k >= 2)[:, None, None], cov / torch.clamp(k - 1, min=1.0)[:, None, None],
                          0.0)
        v0, v1, v2 = eigh3(cov)
        rows = slice(lo, 2 * lo)
        real = k > 0
        if level == 0:
            below = torch.zeros(1, dtype=torch.bool, device=dev)
            par_pp, par_ppn, par_pca = below, torch.zeros_like(v0), torch.zeros_like(v0)
            par_n3 = torch.zeros_like(v0)
        else:
            par = torch.arange(lo, 2 * lo, device=dev) >> 1
            below = t["bbox0"][par] < b_min
            par_pp, par_ppn, par_pca, par_n3 = t["has_pp"][par], t["ppn"][par], t["pca"][par], t["n3"][par]
        has_pp = par_pp | below
        ppn = torch.where(par_pp[:, None], par_ppn, torch.where(below[:, None], par_pca, 0.0))
        n3 = torch.where((k >= 3)[:, None], v0, par_n3)
        fallback = v0 if level == 0 else torch.where((k < 3)[:, None], par_n3, v0)
        normal = torch.where(has_pp[:, None], ppn, fallback)
        proj = torch.stack([(d * v0[j]).sum(-1), (d * v1[j]).sum(-1), (d * v2[j]).sum(-1)], -1)
        zero = torch.zeros((lo, 3), dtype=dt, device=dev)
        vmax = zero.clone().scatter_reduce_(0, j[:, None].expand(-1, 3), proj, "amax")
        vmin = zero.clone().scatter_reduce_(0, j[:, None].expand(-1, 3), proj, "amin")
        ext = vmax - vmin
        leaf = real & ((ext[:, 2] < b_max) | (level == depth))
        for name, val in (("mean", mean), ("split", v2), ("normal", normal), ("pca", v0),
                          ("ppn", ppn), ("n3", n3), ("bbox0", ext[:, 0]), ("is_leaf", leaf),
                          ("is_real", real), ("has_pp", has_pp)):
            t[name][rows] = val
        side = (proj[:, 2] >= 0).long()
        in_leaf = leaf[j]
        ret = alive[in_leaf]
        leaf_of[ret] = nd[in_leaf]
        frz[ret] = torch.linalg.norm(d[in_leaf], dim=-1)
        n_alive = alive.numel()
        n_ret = ret.numel()
        stats.append(dict(live=n_alive + retired_prev, dead=retired_prev,
                          adv=n_alive if level < depth else 0,
                          nodes=int(real.sum()) + children_prev))
        retired_prev = n_ret
        children_prev = int(torch.unique(2 * nd[in_leaf] + side[in_leaf]).numel())
        node[alive] = 2 * nd + side
        alive = alive[~in_leaf]
    # representative: the point nearest the leaf mean, near ties to the
    # lowest index
    dmin = torch.full((M,), math.inf, dtype=dt, device=dev).scatter_reduce_(
        0, leaf_of, frz, "amin")
    near = frz <= dmin[leaf_of] * (1 + TIE_TOL)
    big = torch.full((M,), n, dtype=torch.int64, device=dev)
    pick = big.scatter_reduce_(0, leaf_of[near], torch.arange(n, device=dev)[near], "amin")
    lf = t["is_leaf"]
    t["repr"] = torch.where(lf[:, None], points[torch.clamp(pick, max=n - 1)], t["mean"])
    t["stats"] = stats
    return t


def leaves(tree: dict, cap: int):
    """The first ``cap`` leaves in arena order: points (cap, 3), their
    count, and how many were dropped."""
    ids = torch.nonzero(tree["is_leaf"])[:, 0]
    kept = ids[:cap]
    return tree["repr"][kept], int(ids.numel()), max(0, int(ids.numel()) - cap)


def moved(tree: dict, T) -> dict:
    """The tree's fields a search reads, moved rigidly by ``T``."""
    R, t = T[:3, :3], T[:3, 3]
    return dict(mean=tree["mean"] @ R.T + t, split=tree["split"] @ R.T,
                repr=tree["repr"] @ R.T + t, normal=tree["normal"] @ R.T,
                bbox0=tree["bbox0"], is_leaf=tree["is_leaf"], is_real=tree["is_real"])


def pack_ring(trees: list) -> dict:
    """The trees of a ring as two row tables of ``T M`` rows: ``nav``
    (mean 3, split 3, real interior, left child real, right child real)
    for the descent, ``payload`` (representative 3, normal 3, bbox0, real
    leaf) for what it reaches."""
    M = trees[0]["is_leaf"].shape[0]
    navs, pays = [], []
    for t in trees:
        dt = t["mean"].dtype
        kids = torch.zeros((M, 2), dtype=dt, device=t["mean"].device)
        kids[: M // 2] = t["is_real"].view(M // 2, 2).to(dt)
        inner = (t["is_real"] & ~t["is_leaf"]).to(dt)[:, None]
        navs.append(torch.cat([t["mean"], t["split"], inner, kids], -1))
        ok = (t["is_real"] & t["is_leaf"]).to(dt)[:, None]
        pays.append(torch.cat([t["repr"], t["normal"], t["bbox0"][:, None], ok], -1))
    return dict(nav=torch.cat(navs), payload=torch.cat(pays), M=M, T=len(trees))


def associate(ring: dict, q, depth: int):
    """Pure descent (no backtracking) of queries (T, L, 3) in the T trees
    of ``ring`` (:func:`pack_ring`): at a real interior node a query goes
    to the child on its side of the split plane (``>= 0``: right) when
    that child is real. Returns ``(f, n, bbox0, ok)`` of the node each
    stops at (``ok``: a real leaf)."""
    T, M = ring["T"], ring["M"]
    base = (torch.arange(T, device=q.device) * M)[:, None]
    node = torch.ones(q.shape[:2], dtype=torch.int64, device=q.device)
    for _ in range(depth):
        row = ring["nav"][base + node]
        side = ((q - row[..., 0:3]) * row[..., 3:6]).sum(-1) >= 0
        step = (row[..., 6] > 0) & torch.where(side, row[..., 8] > 0, row[..., 7] > 0)
        node = torch.where(step, 2 * node + side.long(), node)
    p = ring["payload"][base + node]
    return p[..., 0:3], p[..., 3:6], p[..., 6], p[..., 7] > 0


def normal_equations(X, m, f, nrm, bbox0, ok, w, P: Params):
    """Point-to-plane terms of moving leaves ``m`` (L, 3) against the
    matched leaves of T trees (T, L, ...) under ``X``, summed over the
    trees with weights ``w`` (T,): ``(H, b, matched (T, L))``. Gate
    ``|X m - f| <= b_max + b_ratio |m|``; Huber clamp at ``sqrt(rho_ker)``;
    weight ``(1 - bbox0 / b_max)^2``."""
    R, t = X[:3, :3], X[:3, 3]
    ml = m @ R.T + t
    diff = ml[None] - f
    gate = P.b_max + P.b_ratio * torch.linalg.norm(m, dim=-1)
    matched = ok & (torch.linalg.norm(diff, dim=-1) <= gate[None])
    e = (diff * nrm).sum(-1)
    u = nrm @ R  # R^T n
    J = torch.cat([u, torch.linalg.cross(m.expand_as(u), u, dim=-1)], -1)
    rho = math.sqrt(P.rho_ker)
    chi = e.abs()
    scale = torch.where(chi > rho, rho / torch.clamp(chi, min=1e-30), 1.0)
    wp = torch.clamp(1 - bbox0 / P.b_max, 0.0, 1.0)
    s = scale * wp * wp * matched.to(m.dtype) * w[:, None]
    H = torch.einsum("tl,tli,tlj->ij", s, J, J)
    b = torch.einsum("tl,tli,tl->i", s, J, e)
    return H, b, matched


def gn_step(X, H, b):
    """Jacobi-scaled solve of ``H dx = -b``, clamped to the trust region,
    applied as ``X [exp(dx_rot) | dx_trans]``."""
    diag = torch.diagonal(H)
    if float(diag.sum()) <= 0:
        return X
    e = 1.0 / torch.where(diag > 0, torch.sqrt(torch.clamp(diag, min=1e-30)), 1.0)
    A = H * (e[:, None] * e[None]) + 1e-8 * torch.eye(6, dtype=H.dtype, device=H.device)
    dx = torch.linalg.solve(A, -(b * e)) * e
    dx = torch.where(torch.isfinite(dx), dx, 0.0)
    nt, nr = torch.linalg.norm(dx[:3]), torch.linalg.norm(dx[3:])
    scale = min(1.0, STEP_MAX_T / max(float(nt), 1e-30), STEP_MAX_R / max(float(nr), 1e-30))
    dx = dx * scale
    return X @ se3(exp_so3(dx[3:]), dx[:3])


def neg_logdet(H) -> float:
    sign, logabs = torch.linalg.slogdet(H)
    if float(sign) <= 0 or not math.isfinite(float(logabs)):
        return float(torch.finfo(H.dtype).max)
    return -float(logabs)


def estimate_velocity(v, traj, count: int, ts: float):
    """One Gauss-Newton round of the constant-velocity estimate over the
    last ``min(count, W)`` poses (``vel_estimator.cpp:32-97``): pair ``i``
    with the newest pose, ``dt = (W-1-i) ts``, weight ``1 -
    (W-2-i)/(n-1)``, residual ``dt v - [t; euler_xyz(R)]`` of
    ``T_i^-1 T_newest``, robust clamp at :data:`E_THRESHOLD_VEL`."""
    W = traj.shape[0]
    n = min(count, W)
    if n < 2:
        return v
    dev = traj.device
    i = torch.arange(W - 1, dtype=traj.dtype, device=dev)
    dt = (W - 1 - i) * ts
    weight = 1 - (W - 2 - i) / max(n - 1, 1)
    active = i >= W - n
    rel = torch.linalg.solve(traj[:-1], traj[-1].expand(W - 1, 4, 4))
    e = dt[:, None] * v[None] - torch.cat([rel[:, :3, 3], euler_xyz(rel[:, :3, :3])], -1)
    chi = torch.linalg.norm(e, dim=-1)
    scale = torch.where(chi > E_THRESHOLD_VEL, E_THRESHOLD_VEL / torch.clamp(chi, min=1e-30), 1.0)
    s = scale * weight * active.to(traj.dtype)
    h = (s * dt * dt).sum()
    bvec = ((s * dt)[:, None] * e).sum(0)
    return v - bvec / h if float(h) > 0 else v


def deskew(points, T_prev, T_now, hz: float):
    """Move every point of a sweep by the motion of its azimuth bin, the
    velocity the finite difference of the last two poses
    (``pipeline.cpp:79-123``): points sorted by azimuth and walked from
    +pi down, the bin advancing by at most one a point (ties in reverse
    order), bin ``c`` at time ``-ts + c ts / (CHUNKS - 1)``."""
    ts = 1.0 / hz
    rel = inverse(T_prev) @ T_now
    v_lin, v_ang = rel[:3, 3] / ts, log_so3(rel[:3, :3]) / ts
    tb = -ts + (ts / (CHUNKS - 1)) * torch.arange(CHUNKS, dtype=points.dtype, device=points.device)
    Rb = exp_so3(v_ang[None] * tb[:, None])
    tt = v_lin[None] * tb[:, None]
    az = torch.atan2(points[:, 1], points[:, 0])
    keys, order = torch.sort(az, stable=True)
    desc = torch.flip(keys, (0,))
    res = 2 * math.pi / CHUNKS
    c = torch.clamp(torch.ceil((math.pi - desc) / res - 1.0), 0.0, CHUNKS - 1.0)
    j = torch.arange(points.shape[0], dtype=points.dtype, device=points.device)
    pref = torch.cummin(c - j, 0).values
    k = torch.clamp(torch.minimum(j + 1, j + pref).long(), 0, CHUNKS - 1)
    bins = torch.zeros_like(k).scatter_(0, torch.flip(order, (0,)), k)
    return torch.einsum("nij,nj->ni", Rb[bins], points) + tt[bins]


# ---------------------------------------------------------------- state --
class Odometry:
    """One sequence's odometry, stepped scan by scan, in ``dtype``
    (float64; a lower precision only for the check's control)."""

    def __init__(self, P: Params, device, dtype=F64):
        self.P, self.dev, self.dt = P, torch.device(device), dtype
        eye = torch.eye(4, dtype=dtype, device=self.dev)
        self.X = eye.clone()
        self.v = torch.zeros(6, dtype=dtype, device=self.dev)
        self.traj = eye.repeat(SMOOTHING_T, 1, 1)
        self.traj_count = 0
        self.kf: list = [None] * P.num_keyframes
        self.kf_head = 0
        self.fr: list = [None] * FRAME_WINDOW  # (tree, weight, seq, pose)
        self.fr_head = 0
        self.seq = 0
        self.seconds = {"build": 0.0, "rounds": 0.0}  # where a step's time went

    def _tree(self, points):
        return build_tree(points, self.P.depth, self.P.b_max, self.P.b_min)

    def bootstrap(self, points) -> None:
        """The first scan: its tree is keyframe 0 at the identity."""
        pts = torch.as_tensor(points, device=self.dev).to(self.dt)
        self.kf[0] = moved(self._tree(pts), self.X)
        self.kf_head = 1 % self.P.num_keyframes
        self.traj[-1] = self.X
        self.traj_count, self.seq = 1, 1

    def prime(self, scans: list, poses: list) -> None:
        """Fill the ring, slot by slot, with trees of ``scans`` at
        ``poses`` (a map built before the drive)."""
        for k, (pts, T) in enumerate(zip(scans, poses)):
            tree = self._tree(torch.as_tensor(pts, device=self.dev).to(self.dt))
            self.kf[k] = moved(tree, torch.as_tensor(T, dtype=self.dt, device=self.dev))

    def step(self, points, promote_hint=None, margin: float = 0.0) -> dict:
        """One scan: deskew, build, prediction, 15 re-association rounds,
        inlier ratio, velocity, frame record and promotion. Where the
        ratio lies within ``margin`` of ``p_th``, the promotion follows
        ``promote_hint`` (the program's decision at a tie) when given."""
        P, dev = self.P, self.dev
        pts = torch.as_tensor(points, device=dev).to(self.dt)
        if P.deskew and self.traj_count >= 2:
            pts = deskew(pts, self.traj[-2], self.traj[-1], P.sensor_hz)
        t0 = time.perf_counter()
        tree = self._tree(pts)
        m, total, dropped = leaves(tree, P.max_leaves)
        t1 = time.perf_counter()
        live = [t for t in self.kf if t is not None]
        ring = pack_ring(live)
        w = torch.ones(len(live), dtype=self.dt, device=dev)
        X = self.X @ se3(exp_so3(self.v[3:] / P.sensor_hz), self.v[:3] / P.sensor_hz)
        for r in range(MAX_ICP_ITS):
            q = (m @ X[:3, :3].T + X[:3, 3]).expand(len(live), -1, -1)
            f, nrm, bb, ok = associate(ring, q, P.depth)
            H, b, matched = normal_equations(X, m, f, nrm, bb, ok, w, P)
            X = gn_step(X, H, b)
        self.seconds["build"] += t1 - t0
        self.seconds["rounds"] += time.perf_counter() - t1
        ratio = float(matched.any(0).sum()) / max(m.shape[0], 1)
        promote = ratio < P.p_th
        tie = abs(ratio - P.p_th) <= margin
        if tie and promote_hint is not None:
            promote = bool(promote_hint)
        self.traj = torch.cat([self.traj[1:], X[None]])
        self.traj_count += 1
        self.v = estimate_velocity(self.v, self.traj, self.traj_count, 1.0 / P.sensor_hz)
        self.fr[self.fr_head] = (moved(tree, X), neg_logdet(H), self.seq, X)
        if promote:
            best = min((i for i, e in enumerate(self.fr) if e is not None),
                       key=lambda i: (self.fr[i][1], i))
            best_seq = self.fr[best][2]
            self.kf[self.kf_head] = self.fr[best][0]
            self.kf_head = (self.kf_head + 1) % P.num_keyframes
            self.fr = [e if e is not None and e[2] > best_seq else None for e in self.fr]
        self.fr_head = (self.fr_head + 1) % FRAME_WINDOW
        self.seq += 1
        self.X = X
        return dict(pose=X.cpu().numpy(), ratio=ratio, promote=promote, tie=tie,
                    leaves=total, leaves_dropped=dropped, stats=tree["stats"])
