"""Full MAD-ICP odometry pipeline over a state of device tensors.

Port of the JAX package's ``models/pipeline.py`` (itself a re-design of
the reference ``Pipeline``, ``pipeline.cpp:34-308``): per scan — deskew,
MAD-tree build, constant-velocity prediction, ``max_icp_iterations``
re-association Gauss-Newton rounds over the keyframe map, inlier ratio,
velocity smoothing, frame window and information-driven keyframe
promotion. The state keeps the JAX package's static shapes and layouts
(``PipelineState``), so a JAX state converts to this one
(``utils/convert.py``).

Differences of form, not of function:

- the per-keyframe ``lax.scan`` becomes ONE batched descent over the
  flat ``(K*M, 56)`` view of the keyframe ring, with per-query row
  offsets ``base = k*M``; only the summation order of the per-keyframe
  terms changes;
- the keyframe and frame rings (at flagship size 26 trees x 29.4 MB) are
  updated IN PLACE (``index_copy_``), the counterpart of the JAX step's
  buffer donation: ``odometry_step`` mutates ``state.kf_tree`` and
  ``state.fr_tree`` and returns them in the new state;
- the promotion branch reads one boolean on the host — the only host
  synchronisation of a scan; the GN round loop has none.

Schedules: the plain exact and the certified exact schedules are ported
(the shipped default is certified exact). The fast and the prefix /
compact certified schedules and ``compute_batch`` are still to be ported
(ROADMAP A11, A12); a configuration that asks for them raises
``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import time
import warnings
from dataclasses import dataclass
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from madicp_tpu_torch.models.vel_estimator import estimate_velocity
from madicp_tpu_torch.ops.constants import FRAME_WINDOW, MAX_ICP_ITS, SMOOTHING_T
from madicp_tpu_torch.ops.deskew import deskew_cloud
from madicp_tpu_torch.ops.icp_core import (
    associate_packed,
    gn_se3_step,
    neg_logdet,
    terms_from_payload,
)
from madicp_tpu_torch.ops.lie import exp_se3_split
from madicp_tpu_torch.ops.tree import (
    NAV_WIDTH,
    SearchTree,
    build_tree,
    get_leaves,
    transform_tree,
    tree_arena_size,
)
from madicp_tpu_torch.utils.device import resolve_device, synchronize
from madicp_tpu_torch.utils.timing import phase


@dataclass(frozen=True)
class PipelineConfig:
    """Static configuration; defaults follow ``mad_params.py:31-38`` and
    the JAX package's shipped schedule (certified exact)."""

    sensor_hz: float = 10.0
    deskew: bool = False
    deskew_mode: str = "reference"
    b_max: float = 0.2
    rho_ker: float = 0.1
    p_th: float = 0.8
    b_min: float = 0.1
    b_ratio: float = 0.02
    num_keyframes: int = 4
    # static shapes
    n_points: int = 131072
    depth: int = 16
    max_leaves: int = 0  # 0 -> n_points
    max_icp_iterations: int = MAX_ICP_ITS
    dtype: Any = torch.float32
    assoc_mode: str = "exact"
    reassoc_every: int = 7
    reassoc_backup: int = 0
    # the JAX package's TPU select ladder; bitwise equal to the gather
    # descent there, accepted here as a no-op
    assoc_ladder: int = 3
    certify: bool = True
    certify_compact: int = 0
    certify_prefix: int = 0

    def __post_init__(self):
        if self.deskew_mode not in ("reference", "binned"):
            raise ValueError(
                f"deskew_mode must be 'reference' or 'binned', got {self.deskew_mode!r}"
            )
        if self.assoc_mode not in ("exact", "fast"):
            raise ValueError(
                f"assoc_mode must be 'exact' or 'fast', got {self.assoc_mode!r}"
            )
        for name in ("reassoc_backup", "certify_compact", "assoc_ladder",
                     "certify_prefix"):
            if getattr(self, name) < 0:
                raise ValueError(f"{name} must be >= 0, got {getattr(self, name)}")
        if self.reassoc_every < 1:
            raise ValueError(f"reassoc_every must be >= 1, got {self.reassoc_every}")
        if self.certify_prefix and self.certify_compact:
            raise ValueError("certify_prefix and certify_compact are mutually exclusive")
        if self.dtype not in (torch.float32, torch.float64):
            raise ValueError(f"dtype must be torch.float32 or float64, got {self.dtype}")
        if self.assoc_mode == "fast":
            raise NotImplementedError(
                "assoc_mode='fast' is not ported yet (ROADMAP A11)")
        if self.certify_compact or self.certify_prefix:
            raise NotImplementedError(
                "certify_compact/certify_prefix are not ported yet (ROADMAP A12)")

    @property
    def leaves_cap(self) -> int:
        # a tree never has more leaves than arena rows
        return min(self.max_leaves or self.n_points, self.arena)

    @property
    def arena(self) -> int:
        return tree_arena_size(self.depth)


class PipelineState(NamedTuple):
    X: torch.Tensor              # (4,4) frame_to_map
    velocity: torch.Tensor       # (6,)
    traj: torch.Tensor           # (SMOOTHING_T, 4, 4), newest last
    traj_count: torch.Tensor     # () int32
    kf_tree: SearchTree          # nav (K, M, 56)
    kf_valid: torch.Tensor       # (K,) bool
    kf_head: torch.Tensor        # () int32 ring head (next overwrite)
    keyframe_to_map: torch.Tensor  # (4,4) pose of the latest keyframe
    fr_tree: SearchTree          # nav (FRAME_WINDOW, M, 56)
    fr_valid: torch.Tensor       # (F,) bool
    fr_weight: torch.Tensor      # (F,) -logdet(H): smaller = more informative
    fr_seq: torch.Tensor         # (F,) int32
    fr_pose: torch.Tensor        # (F, 4, 4)
    fr_head: torch.Tensor        # () int32
    seq: torch.Tensor            # () int32
    seq_keyframe: torch.Tensor   # () int32


class StepOutput(NamedTuple):
    pose: torch.Tensor           # (4,4) current lidar_to_world
    inlier_ratio: torch.Tensor   # ()
    map_updated: torch.Tensor    # () bool
    n_leaves: torch.Tensor       # () — real leaves of the current scan
    leaves_pts: torch.Tensor     # (L,3) current leaves in the map frame
    leaves_valid: torch.Tensor   # (L,)
    n_leaves_dropped: torch.Tensor  # () leaves beyond the static capacity
    # (valid-keyframe, valid-leaf) descents the schedule actually walked
    n_descents: torch.Tensor     # ()


def init_state(cfg: PipelineConfig, device) -> PipelineState:
    dev = torch.device(device)
    f = dict(dtype=cfg.dtype, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    eye = torch.eye(4, **f)
    M, K, F = cfg.arena, cfg.num_keyframes, FRAME_WINDOW
    return PipelineState(
        X=eye.clone(),
        velocity=torch.zeros(6, **f),
        traj=eye.repeat(SMOOTHING_T, 1, 1),
        traj_count=torch.zeros((), **i32),
        kf_tree=SearchTree(nav=torch.zeros((K, M, NAV_WIDTH), **f)),
        kf_valid=torch.zeros(K, dtype=torch.bool, device=dev),
        kf_head=torch.zeros((), **i32),
        keyframe_to_map=eye.clone(),
        fr_tree=SearchTree(nav=torch.zeros((F, M, NAV_WIDTH), **f)),
        fr_valid=torch.zeros(F, dtype=torch.bool, device=dev),
        fr_weight=torch.full((F,), float("inf"), **f),
        fr_seq=torch.zeros(F, **i32),
        fr_pose=eye.repeat(F, 1, 1),
        fr_head=torch.zeros((), **i32),
        seq=torch.zeros((), **i32),
        seq_keyframe=torch.zeros((), **i32),
    )


def _slot_mask(n: int, slot: torch.Tensor) -> torch.Tensor:
    return torch.arange(n, device=slot.device) == slot


def initialize_step(
    cfg: PipelineConfig, state: PipelineState, points, valid, stamp, timer=None
) -> tuple[PipelineState, StepOutput]:
    """First-scan bootstrap (reference ``pipeline.cpp:267-284``): the scan
    becomes keyframe 0 at identity; no deskew, no ICP. Writes keyframe
    slot 0 of ``state.kf_tree`` in place."""
    del stamp
    with phase(timer, "build"):
        tree, _ = build_tree(
            points, valid, depth=cfg.depth, b_max=cfg.b_max, b_min=cfg.b_min
        )
    with phase(timer, "leaves"):
        leaves = get_leaves(tree, cfg.leaves_cap)
    dev = points.device
    eye = torch.eye(4, dtype=cfg.dtype, device=dev)
    with phase(timer, "rings"):
        state.kf_tree.nav[0].copy_(tree.nav)
        state = state._replace(
            kf_valid=state.kf_valid | (torch.arange(cfg.num_keyframes, device=dev) == 0),
            kf_head=torch.full((), 1 % cfg.num_keyframes, dtype=torch.int32, device=dev),
            traj=torch.cat([state.traj[:-1], eye[None]], dim=0),
            traj_count=torch.ones((), dtype=torch.int32, device=dev),
            seq=state.seq + 1,
        )
    out = StepOutput(
        pose=eye,
        inlier_ratio=torch.ones((), dtype=cfg.dtype, device=dev),
        map_updated=torch.ones((), dtype=torch.bool, device=dev),
        n_leaves=leaves.valid.sum(),
        leaves_pts=leaves.pts,
        leaves_valid=leaves.valid,
        n_leaves_dropped=torch.clamp(leaves.total - cfg.leaves_cap, min=0),
        n_descents=torch.zeros((), dtype=torch.int64, device=dev),
    )
    return state, out


def icp_rounds(
    cfg: PipelineConfig,
    kf_tree: SearchTree,
    kf_valid_f: torch.Tensor,
    leaves_pts: torch.Tensor,
    leaves_valid: torch.Tensor,
    X0: torch.Tensor,
    timer=None,
):
    """The GN round schedule over the keyframe ring (``pipeline.cpp:
    166-193``): plain exact (``certify=False``) or certified exact.

    Every (keyframe, leaf) pair descends in one batched call over the
    flat ``(K*M, 56)`` view of the ring. Returns ``(X, H_last, matched,
    n_descents)``; ``matched`` comes from the final round only, like the
    reference; ``n_descents`` counts the (valid-keyframe, valid-leaf)
    descents actually walked (empty ring slots excluded).
    """
    dtype, dev = cfg.dtype, X0.device
    K = kf_valid_f.shape[0]
    L = leaves_pts.shape[0]
    M = kf_tree.nav.shape[-2]
    nav = kf_tree.nav.reshape(K * M, NAV_WIDTH)
    base = (torch.arange(K, device=dev) * M).repeat_interleave(L)  # (K*L,)
    nv = leaves_valid.sum()  # valid moving leaves
    kv = (kf_valid_f > 0).sum()  # valid keyframes
    kf_live = kf_valid_f > 0  # (K,)
    terms_kw = dict(b_max=cfg.b_max, b_ratio=cfg.b_ratio, rho_ker=cfg.rho_ker)

    def descend(X, need, margin: bool):
        """Descend every (keyframe, leaf) entry with ``need`` (K, L);
        the others park on row 0 of their keyframe's arena."""
        with phase(timer, "association"):
            ml = leaves_pts @ X[:3, :3].T + X[:3, 3]
            out = associate_packed(
                nav, base, cfg.depth, ml.repeat(K, 1), need.reshape(K * L),
                return_margin=margin,
            )
        return tuple(o.reshape((K, L) + o.shape[1:]) for o in out)

    def terms_scan(X, payload, with_matched: bool):
        """H/b (+ matched) over all keyframes from (K, L, 8) payloads."""
        terms = terms_from_payload(payload, leaves_pts, leaves_valid, X, **terms_kw)
        H = torch.einsum("k,kij->ij", kf_valid_f, terms.H)
        b = torch.einsum("k,ki->i", kf_valid_f, terms.b)
        if with_matched:
            return H, b, torch.any(terms.matched & kf_live[:, None], dim=0)
        return H, b

    def step(X, payload, with_matched=False):
        with phase(timer, "terms+solve"):
            out = terms_scan(X, payload, with_matched)
            return (gn_se3_step(X, out[0], out[1]),) + out

    n_its = cfg.max_icp_iterations
    if n_its <= 0:
        return (
            X0,
            torch.zeros((6, 6), dtype=dtype, device=dev),
            torch.zeros(L, dtype=torch.bool, device=dev),
            torch.zeros((), dtype=torch.int64, device=dev),
        )

    if not cfg.certify:
        # plain exact: every round re-descends every leaf against every
        # keyframe (empty slots descend an all-zero arena and add nothing)
        need = leaves_valid.expand(K, L)
        X = X0
        for _ in range(n_its - 1):
            _, payload = descend(X, need, False)
            X = step(X, payload)[0]
        _, payload = descend(X, need, False)
        X, H_last, _, matched = step(X, payload, True)
        return X, H_last, matched, n_its * kv * nv

    # ---- certified exact schedule (JAX PipelineConfig.certify) ----
    # Every round is a full re-association; an entry whose accumulated
    # displacement stays strictly below its descent's path margin
    # provably descends to the same leaf, so its cached payload is kept
    # and its descent parked.
    dinfo = torch.finfo(dtype)
    r_norm = torch.sqrt(torch.sum(leaves_pts * leaves_pts, dim=-1))  # (L,)
    live_kl = leaves_valid[None, :] & kf_live[:, None]  # (K, L)

    def motion_bound(Xa, Xb):
        """Exact per-leaf displacement ||Xb m - Xa m|| between rounds.
        Its own rounding must stay below eps_cert: keep it a norm of
        differences — an arccos angle bound carries ~sqrt(eps) error and
        certifies near-zero-slack entries unsoundly (JAX package,
        models/pipeline.py:531-558)."""
        d = leaves_pts @ (Xb[:3, :3] - Xa[:3, :3]).T + (Xb[:3, 3] - Xa[:3, 3])
        return torch.sqrt(torch.sum(d * d, dim=-1))

    def eps_cert(X):
        """fp-safety floor: the side dot-product's rounding noise scales
        with the map-frame coordinate magnitude."""
        t_norm = torch.sqrt(torch.sum(X[:3, 3] * X[:3, 3]))
        return 64.0 * dinfo.eps * (1.0 + t_norm + r_norm)  # (L,)

    def reassociate(X, uncert, ids, payload, slack):
        need = uncert & live_kl
        ids2, payload2, margin2 = descend(X, need, True)
        return (
            torch.where(need, ids2, ids),
            torch.where(need[..., None], payload2, payload),
            torch.where(need, margin2, slack),
        )

    ids, payload, slack = descend(X0, live_kl, True)
    n_descents = kv * nv  # round 0: every live entry descends
    if n_its == 1:
        X, H_last, _, matched = step(X0, payload, True)
        return X, H_last, matched, n_descents

    Xp, X = X0, step(X0, payload)[0]
    for _ in range(1, n_its - 1):
        slack = slack - motion_bound(Xp, X)[None, :]
        uncert = slack <= eps_cert(X)[None, :]
        ids, payload, slack = reassociate(X, uncert, ids, payload, slack)
        n_descents = n_descents + (uncert & live_kl).sum()
        Xp, X = X, step(X, payload)[0]
    # final round: matched flags and H_last from this round's (certified)
    # re-association, like the reference's last-iteration reset
    # (pipeline.cpp:172-176)
    slack = slack - motion_bound(Xp, X)[None, :]
    uncert = slack <= eps_cert(X)[None, :]
    _, payload, _ = reassociate(X, uncert, ids, payload, slack)
    n_descents = n_descents + (uncert & live_kl).sum()
    X, H_last, _, matched = step(X, payload, True)
    return X, H_last, matched, n_descents


def odometry_step(
    cfg: PipelineConfig,
    state: PipelineState,
    points,
    valid,
    stamp,
    timer=None,
) -> tuple[PipelineState, StepOutput]:
    """One full odometry step (reference ``Pipeline::compute``,
    ``pipeline.cpp:125-265``). Updates ``state.fr_tree`` (and, on
    promotion, ``state.kf_tree``) in place; reads one boolean on the host
    to decide the promotion. ``timer``: an optional
    :class:`~madicp_tpu_torch.utils.timing.PhaseTimer`."""
    del stamp
    dtype, dev = cfg.dtype, points.device
    hz = torch.tensor(cfg.sensor_hz, dtype=dtype, device=dev)

    # ---- deskew (pipeline.cpp:137-138, 79-123) ----
    if cfg.deskew:
        with phase(timer, "deskew"):
            do = state.traj_count >= 2
            skewed = deskew_cloud(
                points, state.traj[-2], state.traj[-1], hz,
                valid=valid, mode=cfg.deskew_mode,
            )
            points = torch.where((do & valid)[:, None], skewed, points)

    # ---- current-scan tree (pipeline.cpp:140-144) ----
    with phase(timer, "build"):
        tree, _ = build_tree(
            points, valid, depth=cfg.depth, b_max=cfg.b_max, b_min=cfg.b_min
        )
    with phase(timer, "leaves"):
        leaves = get_leaves(tree, cfg.leaves_cap)

    # ---- constant-velocity prediction + ICP (pipeline.cpp:146-193) ----
    X0 = state.X @ exp_se3_split(state.velocity / hz)
    X, H_last, matched, n_descents = icp_rounds(
        cfg, state.kf_tree, state.kf_valid.to(dtype),
        leaves.pts, leaves.valid, X0, timer=timer,
    )

    with phase(timer, "rings"):
        # ---- inlier ratio over final-round matches (pipeline.cpp:197-204)
        n_leaves = leaves.valid.sum()
        ratio = (matched & leaves.valid).sum().to(dtype) / torch.clamp(
            n_leaves, min=1
        ).to(dtype)

        # ---- trajectory + velocity smoothing (pipeline.cpp:206-217) ----
        traj = torch.cat([state.traj[1:], X[None]], dim=0)
        traj_count = state.traj_count + 1
        velocity = estimate_velocity(state.velocity, traj, traj_count, 1.0 / hz)

        # ---- frame record (pipeline.cpp:219-232), ring slot in place ----
        F, K = FRAME_WINDOW, cfg.num_keyframes
        head = state.fr_head
        at = _slot_mask(F, head)
        tree_map_frame = transform_tree(tree, X[:3, :3], X[:3, 3])
        state.fr_tree.nav.index_copy_(0, head.long().view(1), tree_map_frame.nav[None])
        fr_valid = state.fr_valid | at
        fr_weight = torch.where(at, neg_logdet(H_last), state.fr_weight)
        fr_seq = torch.where(at, state.seq, state.fr_seq)
        fr_pose = torch.where(at[:, None, None], X, state.fr_pose)
        fr_head = (head + 1) % F

        # ---- keyframe promotion (pipeline.cpp:234-262) ----
        promote = ratio < cfg.p_th
        best = torch.argmin(torch.where(fr_valid, fr_weight, float("inf")))
        kf_tree, kf_valid, kf_head = state.kf_tree, state.kf_valid, state.kf_head
        keyframe_to_map, seq_keyframe = state.keyframe_to_map, state.seq_keyframe
        if bool(promote):  # the scan's one host synchronisation
            best_seq = fr_seq[best]
            kf_tree.nav.index_copy_(
                0, kf_head.long().view(1), state.fr_tree.nav.index_select(0, best.view(1))
            )
            kf_valid = kf_valid | _slot_mask(K, kf_head)
            kf_head = (kf_head + 1) % K
            # drop window frames at or before the promoted one
            # (pipeline.cpp:246-251)
            fr_valid = fr_valid & (fr_seq > best_seq)
            keyframe_to_map = fr_pose[best]
            seq_keyframe = best_seq

    new_state = PipelineState(
        X=X,
        velocity=velocity,
        traj=traj,
        traj_count=traj_count,
        kf_tree=kf_tree,
        kf_valid=kf_valid,
        kf_head=kf_head,
        keyframe_to_map=keyframe_to_map,
        fr_tree=state.fr_tree,
        fr_valid=fr_valid,
        fr_weight=fr_weight,
        fr_seq=fr_seq,
        fr_pose=fr_pose,
        fr_head=fr_head,
        seq=state.seq + 1,
        seq_keyframe=seq_keyframe,
    )
    out = StepOutput(
        pose=X,
        inlier_ratio=ratio,
        map_updated=promote,
        n_leaves=n_leaves,
        leaves_pts=leaves.pts @ X[:3, :3].T + X[:3, 3],
        leaves_valid=leaves.valid,
        n_leaves_dropped=torch.clamp(leaves.total - cfg.leaves_cap, min=0),
        n_descents=n_descents,
    )
    return new_state, out


def _warn_if_matmul_precision_degraded() -> None:
    """Warn when float32 matmuls were lowered (TF32) AFTER ``import
    madicp_tpu_torch`` pinned full precision. TF32 keeps ~10 mantissa
    bits: point transforms at 40 m range then carry centimetre-class
    error and the certificate's motion budgets go unsound — the Hopper
    twin of the TPU one-pass-bf16 fault the JAX package guards against
    (its models/pipeline.py:876-901)."""
    bad = []
    if torch.backends.cuda.matmul.allow_tf32:
        bad.append("torch.backends.cuda.matmul.allow_tf32=True")
    if torch.backends.cudnn.allow_tf32:
        bad.append("torch.backends.cudnn.allow_tf32=True")
    prec = torch.get_float32_matmul_precision()
    if prec != "highest":
        bad.append(f"float32_matmul_precision={prec!r}")
    if bad:
        warnings.warn(
            "madicp_tpu_torch: " + ", ".join(bad) + " lowers float32 "
            "matmuls to TF32 and corrupts odometry geometry; restore "
            "allow_tf32=False and set_float32_matmul_precision('highest') "
            "(the madicp_tpu_torch import-time setting)",
            RuntimeWarning,
            stacklevel=3,
        )


class Pipeline:
    """Host-facing odometry engine (API parity with the reference
    ``pypeline.Pipeline``, ``pypeline.cpp:52-75``). Runs on ``device``,
    CUDA unless the caller passes ``device="cpu"``."""

    def __init__(
        self,
        sensor_hz: float,
        deskew: bool,
        b_max: float,
        rho_ker: float,
        p_th: float,
        b_min: float,
        b_ratio: float,
        num_keyframes: int,
        num_threads: int = 0,   # API parity; unused
        realtime: bool = False,  # measured, not enforced (SURVEY.md §7)
        *,
        n_points: int = 131072,
        depth: int = 16,
        max_leaves: int = 0,
        max_icp_iterations: int = MAX_ICP_ITS,
        dtype=torch.float32,
        assoc_mode: str = "exact",
        reassoc_every: int = 7,
        reassoc_backup: int = 0,
        deskew_mode: str = "reference",
        realtime_recal_every: int = 32,
        certify: bool = True,
        certify_compact: int = 0,
        certify_prefix: int = 0,
        assoc_ladder: int = 3,
        device=None,
    ):
        del num_threads
        self.device = resolve_device(device)
        _warn_if_matmul_precision_degraded()
        self.cfg = PipelineConfig(
            sensor_hz=float(sensor_hz),
            deskew=bool(deskew),
            deskew_mode=str(deskew_mode),
            b_max=float(b_max),
            rho_ker=float(rho_ker),
            p_th=float(p_th),
            b_min=float(b_min),
            b_ratio=float(b_ratio),
            num_keyframes=int(num_keyframes),
            n_points=int(n_points),
            depth=int(depth),
            max_leaves=int(max_leaves),
            max_icp_iterations=int(max_icp_iterations),
            dtype=dtype,
            assoc_mode=str(assoc_mode),
            reassoc_every=int(reassoc_every),
            reassoc_backup=int(reassoc_backup),
            certify=bool(certify),
            certify_compact=int(certify_compact),
            certify_prefix=int(certify_prefix),
            assoc_ladder=int(assoc_ladder),
        )
        self.realtime = bool(realtime)
        self.state = init_state(self.cfg, self.device)
        self._last: Optional[StepOutput] = None
        self._initialized = False
        # anytime-realtime calibration (see compute())
        self._rt_scans = 0
        self._rt_calibrated = not self.realtime
        self._rt_every = max(1, int(realtime_recal_every))
        self._rt_its_max = int(max_icp_iterations)
        # a recalibration only times an iteration count that has already
        # run once (the JAX package's warm-only rule)
        self._rt_cfg_warm = False
        self._rt_pending = False
        self._now = None  # injectable clock (tests)
        self._n_points_dropped = 0
        self.timer = None  # optional utils.timing.PhaseTimer

    # -- main entry ---------------------------------------------------------
    def compute(self, stamp: float, points: np.ndarray) -> None:
        """Process one scan (reference ``Pipeline::compute``).

        With ``realtime=True`` the reference breaks out of the ICP loop
        when the wall-clock budget ``1/sensor_hz - 5 ms`` runs out
        (``pipeline.cpp:62,166-169``); here the step is re-timed every
        ``realtime_recal_every`` scans and the iteration count rescaled to
        fit the budget (see :meth:`_calibrate_realtime`).
        """
        self.compute_device(stamp, *self.stage(points))

    def stage(self, points: np.ndarray):
        """Pad a cloud and move it to the device. Returns ``(pts, valid,
        n_dropped)`` for :meth:`compute_device` (``n_dropped``: points
        beyond the static ``n_points`` capacity, truncated in input
        order)."""
        pts, valid, n_dropped = self._pad(points)
        return (
            torch.as_tensor(pts, device=self.device),
            torch.as_tensor(valid, device=self.device),
            n_dropped,
        )

    def compute_device(self, stamp: float, pts, valid, n_dropped: int = 0) -> None:
        """Process a scan already padded and staged on the device (see
        :meth:`stage`); otherwise identical to :meth:`compute`."""
        self._n_points_dropped = int(n_dropped)
        due = (
            self.realtime
            and self._rt_scans >= 2
            and (
                (self._rt_scans - 2) % self._rt_every == 0
                or self._rt_pending
            )
        )
        if due and not self._rt_cfg_warm:
            # this iteration count has never run: run it untimed first and
            # recalibrate on the next scan
            self._rt_pending = True
            self._dispatch_step(pts, valid, stamp)
        elif due:
            self._rt_pending = False
            self._calibrate_realtime(pts, valid, stamp)
        else:
            self._dispatch_step(pts, valid, stamp)
        self._rt_scans += 1

    def _dispatch_step(self, pts, valid, stamp) -> None:
        """Host-side first-scan/odometry branch."""
        self._rt_cfg_warm = True
        if self._initialized:
            self.state, self._last = odometry_step(
                self.cfg, self.state, pts, valid, stamp, timer=self.timer
            )
        else:
            self.state, self._last = initialize_step(
                self.cfg, self.state, pts, valid, stamp, timer=self.timer
            )
            self._initialized = True

    def compute_batch(self, stamps, clouds) -> np.ndarray:
        raise NotImplementedError(
            "Pipeline.compute_batch is not ported yet (ROADMAP A11); "
            "call compute() per scan"
        )

    def _calibrate_realtime(self, pts, valid, stamp) -> None:
        """Rolling anytime-budget calibration: time one synchronised
        steady-state step and rescale the ICP iteration budget to fit.
        The count SHRINKS when the budget is blown and is RESTORED toward
        the configured maximum (at most +4 per recalibration) when
        headroom returns."""
        now = self._now or time.perf_counter
        synchronize(self.device)  # drain the queue
        t0 = now()
        self._dispatch_step(pts, valid, stamp)
        synchronize(self.device)
        step_s = now() - t0

        budget_s = 1.0 / self.cfg.sensor_hz - 0.005  # 5 ms reserve, as ref
        its = self.cfg.max_icp_iterations
        # cost ~ linear in the iteration count with the remainder
        # (build/bookkeeping) as a fixed floor of ~2 rounds' worth
        cand = int(its * budget_s / max(step_s, 1e-9)) - 2
        cand = max(1, min(self._rt_its_max, cand))
        if step_s > budget_s and cand < its:
            new_its = cand
        elif step_s < 0.8 * budget_s and cand > its:
            new_its = min(cand, its + 4)
        else:
            new_its = its
        if new_its != its:
            self.cfg = dataclasses.replace(self.cfg, max_icp_iterations=new_its)
            self._rt_cfg_warm = False
        self._rt_calibrated = True

    def _pad(self, points: np.ndarray):
        """Pad a cloud to the static shape; returns HOST arrays plus the
        count of points truncated by the capacity (surfaced by
        :meth:`points_dropped`)."""
        points = np.asarray(points)
        n = points.shape[0]
        N = self.cfg.n_points
        n_dropped = max(0, n - N)
        if n > N:
            points = points[:N]
            n = N
        np_dtype = np.float64 if self.cfg.dtype == torch.float64 else np.float32
        pts = np.zeros((N, 3), dtype=np_dtype)
        pts[:n] = points
        valid = np.zeros(N, bool)
        valid[:n] = True
        return pts, valid, n_dropped

    # -- accessors (reference pipeline.h:60-71, pipeline.cpp:286-308) -------
    def current_pose(self) -> np.ndarray:
        return self.state.X.cpu().numpy()

    def keyframe_pose(self) -> np.ndarray:
        return self.state.keyframe_to_map.cpu().numpy()

    def current_id(self) -> int:
        return int(self.state.seq)

    def keyframe_id(self) -> int:
        return int(self.state.seq_keyframe)

    def is_initialized(self) -> bool:
        return int(self.state.seq) > 0

    def is_map_updated(self) -> bool:
        return bool(self._last.map_updated) if self._last else False

    def inlier_ratio(self) -> float:
        return float(self._last.inlier_ratio) if self._last else 0.0

    def descents(self) -> int:
        """(valid-keyframe, valid-leaf) tree descents the last scan's ICP
        walked: rounds x K x n_leaves for plain exact, collapsing toward
        one round's worth under the certified schedule."""
        return int(self._last.n_descents) if self._last else 0

    def leaves_dropped(self) -> int:
        """Leaves of the current scan dropped by the static ``max_leaves``
        capacity (the reference never drops, ``mad_tree.cpp:154-163``)."""
        return int(self._last.n_leaves_dropped) if self._last else 0

    def points_dropped(self) -> int:
        """Input points of the last scan truncated by the static
        ``n_points`` capacity (the reference ingests every point)."""
        return self._n_points_dropped

    def current_leaves(self) -> np.ndarray:
        """Current-scan leaf points in the map frame (viewer accessor)."""
        if self._last is None:
            return np.zeros((0, 3))
        return self._last.leaves_pts[self._last.leaves_valid].cpu().numpy()

    def model_leaves(self) -> np.ndarray:
        """All keyframe leaf points (viewer accessor)."""
        kf = self.state.kf_tree
        flag = kf.is_leaf & kf.is_real & self.state.kf_valid[:, None]
        return kf.repr[flag].cpu().numpy()

    # reference-style aliases
    currentPose = current_pose
    keyframePose = keyframe_pose
    currentID = current_id
    keyframeID = keyframe_id
    isMapUpdated = is_map_updated
    currentLeaves = current_leaves
    modelLeaves = model_leaves
