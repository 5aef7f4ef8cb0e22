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
- the step takes a batch of B sequences, a leading axis on every state
  field (the JAX package's fleet is ``jax.vmap`` of its step): the batch
  folds into the flat axes the step already has, so a batched scan
  issues the kernels of one. A single state steps as a batch of one;
- the keyframe promotion (a ``lax.cond`` there) is masked per sequence,
  so no step reads the device from the host;
- the JAX host API's jitted, donated step is a captured CUDA graph over
  static buffers (``models/step_graph.py``): :class:`Pipeline` holds a
  batch-of-one state in those buffers and, on CUDA, replays one graph a
  scan from its second odometry scan on.

Schedules: every schedule of the JAX package is ported — plain exact,
certified exact (the shipped default) with its compacted variant
(``certify_compact``), prefix-certified exact (``certify_prefix``,
``models/schedules_experimental.py``) and fast (``assoc_mode="fast"``).
Where the JAX package branches on device data inside a round
(``lax.cond``), the port computes both branches batched and selects, so
no schedule adds a host read.
"""

from __future__ import annotations

import dataclasses
import time
import warnings
from dataclasses import dataclass
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from madicp_tpu_torch.kernels import certify_slack, gn_update, ring_write, segsum, step_scalars
from madicp_tpu_torch.kernels.icp_terms import moving_in_map
from madicp_tpu_torch.ops.constants import FRAME_WINDOW, MAX_ICP_ITS, SMOOTHING_T
from madicp_tpu_torch.ops.deskew import deskew_scan
from madicp_tpu_torch.ops.icp_core import (
    associate_ring,
    gn_se3_step,
    terms_from_payload,
)
from madicp_tpu_torch.ops.tree import (
    NAV_WIDTH,
    PointShard,
    SearchTree,
    build_tree,
    get_leaves,
    tree_arena_size,
)
from madicp_tpu_torch.utils.device import resolve_device, synchronize
from madicp_tpu_torch.utils.timing import host_span, phase, stepping


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


def init_state(cfg: PipelineConfig, device, batch: Optional[int] = None,
               num_keyframes: Optional[int] = None) -> PipelineState:
    """A fresh state; with ``batch`` = B every field gains a leading axis
    of B sequences. ``num_keyframes`` sizes the keyframe ring held here
    (one process's shard of a ring split over processes; default
    ``cfg.num_keyframes``)."""
    dev = torch.device(device)
    lead = () if batch is None else (batch,)
    f = dict(dtype=cfg.dtype, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    eye = torch.eye(4, **f)
    M, F = cfg.arena, FRAME_WINDOW
    K = cfg.num_keyframes if num_keyframes is None else num_keyframes
    return PipelineState(
        X=eye.repeat(lead + (1, 1)),
        velocity=torch.zeros(lead + (6,), **f),
        traj=eye.repeat(lead + (SMOOTHING_T, 1, 1)),
        traj_count=torch.zeros(lead, **i32),
        kf_tree=SearchTree(nav=torch.zeros(lead + (K, M, NAV_WIDTH), **f)),
        kf_valid=torch.zeros(lead + (K,), dtype=torch.bool, device=dev),
        kf_head=torch.zeros(lead, **i32),
        keyframe_to_map=eye.repeat(lead + (1, 1)),
        fr_tree=SearchTree(nav=torch.zeros(lead + (F, M, NAV_WIDTH), **f)),
        fr_valid=torch.zeros(lead + (F,), dtype=torch.bool, device=dev),
        fr_weight=torch.full(lead + (F,), float("inf"), **f),
        fr_seq=torch.zeros(lead + (F,), **i32),
        fr_pose=eye.repeat(lead + (F, 1, 1)),
        fr_head=torch.zeros(lead, **i32),
        seq=torch.zeros(lead, **i32),
        seq_keyframe=torch.zeros(lead, **i32),
    )


def _map(fn, nt):
    """Apply ``fn`` to every tensor of a state or output (trees by their
    ``nav``)."""
    return type(nt)(*(SearchTree(nav=fn(v.nav)) if isinstance(v, SearchTree) else fn(v)
                      for v in nt))


def _lift(nt):
    """A single sequence's state or output as a batch of one (views)."""
    return _map(lambda t: t[None], nt)


def _drop(nt):
    """The only sequence of a batch of one (views)."""
    return _map(lambda t: t[0], nt)


def initialize_step(
    cfg: PipelineConfig, state: PipelineState, points, valid, stamp, stamps=None,
    *, kf_offset: int = 0, points_shard: Optional[PointShard] = None,
) -> tuple[PipelineState, StepOutput]:
    """First-scan bootstrap (reference ``pipeline.cpp:267-284``): the scan
    becomes keyframe 0 at identity; no deskew, no ICP. Writes keyframe
    slot 0 of ``state.kf_tree`` in place.

    A batched state (leading B on every field, points (B, N, 3)) steps
    every sequence at once. ``kf_offset`` is the global slot of this
    state's first keyframe when the ring is split over processes (only
    the holder of slot 0 writes it); ``points_shard`` builds from this
    process's share of the points (see :func:`odometry_step`). ``stamps``:
    as :func:`odometry_step`'s (phases ``build`` and ``tail``)."""
    del stamp
    if state.X.dim() == 2:
        state, out = initialize_step(cfg, _lift(state), points[None], valid[None], None,
                                     stamps, kf_offset=kf_offset, points_shard=points_shard)
        return _drop(state), _drop(out)
    B = points.shape[0]
    if points_shard is not None:
        points, valid = points_shard.take(points), points_shard.take(valid)
    with stepping(stamps, state.seq):
        with phase(stamps, "build"):
            tree, _ = build_tree(
                points, valid, depth=cfg.depth, b_max=cfg.b_max, b_min=cfg.b_min,
                shard=points_shard,
            )
            leaves = get_leaves(tree, cfg.leaves_cap)
        dev, kf_valid = points.device, state.kf_valid
        with phase(stamps, "tail"):
            eye = torch.eye(4, dtype=cfg.dtype, device=dev)
            K_l = state.kf_valid.shape[1]
            if kf_offset == 0:
                state.kf_tree.nav[:, 0].copy_(tree.nav)
            state = state._replace(
                kf_valid=state.kf_valid | (torch.arange(K_l, device=dev) == -kf_offset),
                kf_head=torch.full((B,), 1 % cfg.num_keyframes, dtype=torch.int32, device=dev),
                traj=torch.cat([state.traj[:, :-1], eye.expand(B, 1, 4, 4)], dim=1),
                traj_count=torch.ones((B,), dtype=torch.int32, device=dev),
                seq=state.seq + 1,
            )
            out = StepOutput(
                pose=eye.expand(B, 4, 4),
                inlier_ratio=torch.ones((B,), dtype=cfg.dtype, device=dev),
                map_updated=torch.ones((B,), dtype=torch.bool, device=dev),
                n_leaves=leaves.valid.sum(-1),
                leaves_pts=leaves.pts,
                leaves_valid=leaves.valid,
                n_leaves_dropped=torch.clamp(leaves.total - cfg.leaves_cap, min=0),
                n_descents=torch.zeros((B,), dtype=torch.int64, device=dev),
            )
            if stamps is not None:
                stamps.counts(out.n_descents, kf_valid, leaves.valid)
    return state, out


def _identity(terms):
    return terms


def icp_rounds(
    cfg: PipelineConfig,
    kf_tree: SearchTree,
    kf_valid_f: torch.Tensor,
    leaves_pts: torch.Tensor,
    leaves_valid: torch.Tensor,
    X0: torch.Tensor,
    stamps=None,
    reduce_terms=None,
):
    """The GN round schedule over the keyframe ring (``pipeline.cpp:
    166-193``): plain exact (``certify=False``), certified exact (with
    ``certify_compact`` its compacted variant), prefix-certified exact
    (``certify_prefix``) or fast (``assoc_mode="fast"``), as selected by
    the JAX package's ``icp_rounds``.

    Every (sequence, keyframe, leaf) entry descends in one batched call
    over the flat ``(B*K*M, 56)`` view of the rings. Shapes: ``kf_tree``
    (K, M, 56), ``kf_valid_f`` (K,), leaves (L, 3) / (L,), ``X0`` (4, 4);
    or each with a leading batch of B sequences, every one with its own
    ring, leaves and pose. Returns ``(X, H_last, matched, n_descents)``
    (leading B where the inputs have it); ``matched`` comes from the
    final round only, like the reference; ``n_descents`` counts the
    (valid-keyframe, valid-leaf) descents actually walked (empty ring
    slots excluded). No schedule reads the device from the host: where
    the JAX package branches on device data, both branches are computed
    batched and selected.

    ``reduce_terms`` completes every round's reduction when the ring is
    split over processes: it receives the batched ``(H (B,6,6), b
    (B,6))`` or ``(H, b, matched (B,L))`` of this process's keyframes
    and returns the reduction over all of them (all-reduce over the
    keyframe group); identity by default. The keyframe count is taken
    from the (local) shapes, not from ``cfg.num_keyframes``.

    ``stamps``: the step's device stamps (``utils/timing.py``), or None:
    the descents, with the masks and counts they start from, are phase
    ``assoc``; the terms, the update and the certificate's slack pass
    ``terms``.
    """
    if X0.dim() == 2:
        X, H, matched, n_desc = icp_rounds(
            cfg, SearchTree(nav=kf_tree.nav[None]), kf_valid_f[None], leaves_pts[None],
            leaves_valid[None], X0[None], stamps=stamps, reduce_terms=reduce_terms)
        return X[0], H[0], matched[0], n_desc[0]
    if reduce_terms is None:
        reduce_terms = _identity
    dtype, dev = cfg.dtype, X0.device
    B, K = kf_valid_f.shape
    L = leaves_pts.shape[1]
    with phase(stamps, "assoc"):
        # (B,) valid moving leaves: get_leaves packs them into a prefix of
        # their slots, so the terms kernel and the slack pass walk no slot
        # past it
        nv = leaves_valid.sum(-1)
        kf_live = kf_valid_f > 0  # (B, K)
        kv = kf_live.sum(-1)  # (B,) valid keyframes
    nav = kf_tree.nav.reshape((B * K,) + kf_tree.nav.shape[2:])
    terms_kw = dict(b_max=cfg.b_max, b_ratio=cfg.b_ratio, rho_ker=cfg.rho_ker,
                    n_live=nv[:, None])

    def descend(X, need, margin: bool, pts=None, start=None, n_gathers=None, out=None):
        """Descend every (sequence, keyframe, query) entry with ``need``
        (B, K, Q); the others park on row 0 of their keyframe's arena.
        ``pts``: the queries in the scan frame, (B, Q, 3) (each sequence's
        serve its K keyframes as they are, never copied K-fold) or (B, K,
        Q, 3); the leaves by default. The descent maps each by its
        sequence's pose in ``X`` (B, 4, 4) itself. Results are (B, K, Q,
        ...); with ``out`` (such results) only the ``need`` entries are
        descended and merged into them, in place."""
        pts = leaves_pts if pts is None else pts
        Q = need.shape[-1]
        with phase(stamps, "assoc"):
            res = associate_ring(
                nav.view(B * K, -1, nav.shape[-1]), cfg.depth, pts.reshape((-1, Q, 3)),
                need.reshape(B * K, Q), X=X,
                start=None if start is None else start.reshape(B * K, Q),
                n_gathers=n_gathers, return_margin=margin,
                out=None if out is None else tuple(o.view((B * K,) + o.shape[2:]) for o in out),
            )
            return tuple(o.view((B, K) + o.shape[1:]) for o in res)

    def terms_scan(X, payload, with_matched: bool):
        """H/b (+ matched) of each sequence over its keyframes from
        (B, K, L, 8) payloads, reduced over the keyframe group."""
        terms = terms_from_payload(payload, leaves_pts[:, None], leaves_valid[:, None],
                                   X[:, None], **terms_kw, with_matched=with_matched)
        H = torch.einsum("bk,bkij->bij", kf_valid_f, terms.H)
        b = torch.einsum("bk,bki->bi", kf_valid_f, terms.b)
        if with_matched:
            return reduce_terms((H, b, torch.any(terms.matched & kf_live[..., None], dim=1)))
        return reduce_terms((H, b))

    def step(X, payload, with_matched=False):
        """``(X dX, H, b)`` (+ matched) of a round. Without a keyframe
        group to reduce over, the update takes the per-keyframe terms and
        forms their sums itself (one kernel on the card); with one, the
        sums are all-reduced before the update."""
        with phase(stamps, "terms"):
            if reduce_terms is not _identity:
                out = terms_scan(X, payload, with_matched)
                return (gn_se3_step(X, out[0], out[1]),) + out
            terms = terms_from_payload(payload, leaves_pts[:, None], leaves_valid[:, None],
                                       X[:, None], **terms_kw, with_matched=with_matched)
            out = gn_update.gn_update(X, terms.H, terms.b, kf_valid_f)
            if with_matched:
                return out + (torch.any(terms.matched & kf_live[..., None], dim=1),)
            return out

    n_its = cfg.max_icp_iterations
    if n_its <= 0:
        with phase(stamps, "terms"):
            return (
                X0,
                torch.zeros((B, 6, 6), dtype=dtype, device=dev),
                torch.zeros((B, L), dtype=torch.bool, device=dev),
                torch.zeros((B,), dtype=torch.int64, device=dev),
            )

    if cfg.assoc_mode == "fast":
        # ---- fast schedule (JAX models/pipeline.py:390-482) ----
        # round 0 and the final round descend in full; in between a
        # re-descent runs every reassoc_every-th round (warm-started
        # reassoc_backup levels above the previous leaf when > 0) and the
        # other rounds reuse the cached payloads. Like the JAX package,
        # its descents mask only invalid leaves, not empty ring slots,
        # and its descent count is static.
        need = leaves_valid[:, None, :].expand(B, K, L)
        warm = cfg.reassoc_backup > 0
        warm_gathers = -(-cfg.reassoc_backup // 3) + 1

        def assoc(X, prev_ids=None):
            if prev_ids is None or not warm:
                return descend(X, need, False)
            return descend(X, need, False, start=prev_ids >> cfg.reassoc_backup,
                           n_gathers=warm_gathers)

        n_redesc = sum(1 for r in range(1, n_its - 1) if r % cfg.reassoc_every == 0)
        with phase(stamps, "assoc"):
            n_descents = (1 if n_its == 1 else 2 + n_redesc) * kv * nv
        ids, payload = assoc(X0)
        if n_its == 1:
            X, H_last, _, matched = step(X0, payload, True)
            return X, H_last, matched, n_descents
        X = step(X0, payload)[0]
        for r in range(1, n_its - 1):
            if r % cfg.reassoc_every == 0:
                ids, payload = assoc(X, ids)
            X = step(X, payload)[0]
        # final round: a FULL re-descent even after warm-started rounds, so
        # the matched flags and H_last carry no warm-descent truncation
        _, payload = assoc(X)
        X, H_last, _, matched = step(X, payload, True)
        return X, H_last, matched, n_descents

    if not cfg.certify:
        # plain exact: every round re-descends every leaf against every
        # keyframe (empty slots descend an all-zero arena and add nothing)
        need = leaves_valid[:, None, :].expand(B, K, L)
        X = X0
        for _ in range(n_its - 1):
            _, payload = descend(X, need, False)
            X = step(X, payload)[0]
        _, payload = descend(X, need, False)
        X, H_last, _, matched = step(X, payload, True)
        with phase(stamps, "terms"):
            return X, H_last, matched, n_its * kv * nv

    if cfg.certify_prefix:
        from madicp_tpu_torch.models.schedules_experimental import (
            prefix_certified_rounds,
        )

        return prefix_certified_rounds(
            cfg, kf_valid_f, leaves_pts, leaves_valid, X0, descend=descend,
            terms_scan=terms_scan, reduce_terms=reduce_terms, kv=kv, nv=nv, stamps=stamps,
        )

    # ---- certified exact schedule (JAX PipelineConfig.certify) ----
    # Every round is a full re-association; an entry whose accumulated
    # displacement stays strictly below its descent's path margin
    # provably descends to the same leaf, so its cached payload is kept
    # and its descent parked.
    with phase(stamps, "assoc"):
        r_norm = torch.sqrt(torch.sum(leaves_pts * leaves_pts, dim=-1))  # (B, L)
        live_kl = leaves_valid[:, None, :] & kf_live[:, :, None]  # (B, K, L)

    def slack_pass(Xp, X, slack, n_descents):
        """A later round's certificate (:mod:`madicp_tpu_torch.kernels.certify_slack`,
        one launch on the card): ``slack`` less each leaf's exact map-frame
        displacement between ``Xp`` and ``X`` (a norm of differences, no
        trig; JAX models/pipeline.py:531-558), in place; the live entries
        whose slack no longer clears the rounding floor ``eps_cert`` are
        returned as ``need`` (B, K, L) and counted into ``n_descents``."""
        with phase(stamps, "terms"):
            return certify_slack.certify_slack(slack, Xp, X, leaves_pts, r_norm, leaves_valid,
                                               kf_live, n_descents, n_live=nv)

    U = min(cfg.certify_compact, L)
    if U:
        with phase(stamps, "assoc"):
            slots = torch.arange(1, U + 1, device=dev).expand(B, K, U).contiguous()
            sweep_col = U + torch.arange(L, device=dev)  # (L,)

    def descend_need(X, need):
        """Fresh (ids, payload, margin) (B, K, L) for the ``need`` entries
        with ``certify_compact`` = U (JAX models/pipeline.py:567-632): a
        keyframe whose live uncertified count fits compacts those leaves
        into its row of a (K, U) buffer, by a cumulative-sum rank; one
        that overflows takes its full parked sweep. Which keyframes
        overflow is device data, so both the buffer and the sweep descend
        in one call and each entry reads its own branch's result."""
        rank = torch.cumsum(need, dim=-1)  # (B, K, L): 1-based rank of need entries
        fits = rank[..., -1] <= U  # (B, K)
        leaf_of_slot = torch.searchsorted(rank, slots)  # (B, K, U); L = empty
        in_buf = (leaf_of_slot < L) & fits[..., None]
        pts = torch.cat([
            torch.take_along_dim(leaves_pts[:, None],
                                 torch.clamp(leaf_of_slot, max=L - 1)[..., None], dim=2),
            leaves_pts[:, None].expand(B, K, L, 3),
        ], dim=2)  # (B, K, U + L, 3)
        out = descend(X, torch.cat([in_buf, need & ~fits[..., None]], dim=-1), True, pts=pts)
        col = torch.where(fits[..., None], torch.clamp(rank - 1, min=0), sweep_col)
        return tuple(
            torch.take_along_dim(o, col.reshape(col.shape + (1,) * (o.dim() - 3)), dim=2)
            for o in out
        )

    def reassociate(X, need, ids, payload, slack):
        """The round's results: fresh descents for the ``need`` entries,
        the previous round's (and the decremented slack) elsewhere. Without
        ``certify_compact`` the full parked sweep merges them into ``ids``,
        ``payload`` and ``slack`` in place (JAX ``reassociate``, models/
        pipeline.py:569, as one kernel on the card)."""
        if not U:
            return descend(X, need, True, out=(ids, payload, slack))
        with phase(stamps, "assoc"):
            ids2, payload2, margin2 = descend_need(X, need)
            return (
                torch.where(need, ids2, ids),
                torch.where(need[..., None], payload2, payload),
                torch.where(need, margin2, slack),
            )

    ids, payload, slack = descend(X0, live_kl, True)
    with phase(stamps, "assoc"):
        n_descents = kv * nv  # round 0: every live entry descends
    if n_its == 1:
        X, H_last, _, matched = step(X0, payload, True)
        return X, H_last, matched, n_descents

    Xp, X = X0, step(X0, payload)[0]
    for _ in range(1, n_its - 1):
        need = slack_pass(Xp, X, slack, n_descents)
        ids, payload, slack = reassociate(X, need, ids, payload, slack)
        Xp, X = X, step(X, payload)[0]
    # final round: matched flags and H_last from this round's (certified)
    # re-association, like the reference's last-iteration reset
    # (pipeline.cpp:172-176)
    need = slack_pass(Xp, X, slack, n_descents)
    _, payload, _ = reassociate(X, need, ids, payload, slack)
    X, H_last, _, matched = step(X, payload, True)
    return X, H_last, matched, n_descents


def odometry_step(
    cfg: PipelineConfig,
    state: PipelineState,
    points,
    valid,
    stamp,
    stamps=None,
    *,
    icp_rounds_fn=None,
    kf_offset: int = 0,
    points_shard: Optional[PointShard] = None,
    into: Optional[PipelineState] = None,
) -> tuple[PipelineState, StepOutput]:
    """One full odometry step (reference ``Pipeline::compute``,
    ``pipeline.cpp:125-265``). Updates ``state.fr_tree`` and
    ``state.kf_tree`` in place. ``stamps``: the device stamps of a traced
    step (:class:`~madicp_tpu_torch.utils.timing.StepStamps`), or None:
    the step's phases, ``deskew``, ``build``, ``assoc``, ``terms`` and
    ``tail`` (the prediction and everything after the rounds), tile it,
    and its counts are recorded before the tail. ``into``: a state
    (shaped as ``state``, contiguous) whose tensors take the new state's
    fields, usually ``state`` itself (the step in place:
    :func:`~madicp_tpu_torch.models.step_graph.step_in_place`); the new
    state returned is then made of them. Without it every field of the
    new state but the trees is a fresh tensor.

    The state is batched (leading B on every field, points (B, N, 3),
    valid (B, N)) or a single sequence's, which steps as a batch of one.
    Promotion is per sequence, with no host read: the prediction and the
    tail's scalars are :mod:`~madicp_tpu_torch.kernels.step_scalars`
    (K14), the frame record and the promoted window tree's copy into its
    ring slot :mod:`~madicp_tpu_torch.kernels.ring_write` (K13; on the
    card a sequence that does not promote, or a process that does not hold
    the slot, copies no tree).

    For a keyframe ring split over processes: ``icp_rounds_fn(kf_tree,
    kf_valid, leaves, X0, stamps) -> (X, H_last, matched, n_descents)`` replaces
    the round loop (the keyframe-sharded step passes :func:`icp_rounds`
    with an all-reduce hook), and ``kf_offset`` is the global slot of
    this state's first keyframe: the promotion writes a slot only where
    this process holds it. ``points_shard``
    (:class:`~madicp_tpu_torch.ops.tree.PointShard`) builds the scan's
    tree from this process's share of the points (``points`` is the
    whole cloud: the deskew sweep needs every point).
    """
    del stamp
    if state.X.dim() == 2:
        state, out = _odometry_step(cfg, _lift(state), points[None], valid[None], stamps,
                                    icp_rounds_fn, kf_offset, points_shard,
                                    None if into is None else _lift(into))
        return _drop(state), _drop(out)
    return _odometry_step(cfg, state, points, valid, stamps, icp_rounds_fn, kf_offset,
                          points_shard, into)


def _odometry_step(cfg, state, points, valid, stamps, icp_rounds_fn, kf_offset,
                   points_shard, into):
    """:func:`odometry_step` on a batched state."""
    with stepping(stamps, state.seq):
        return _phased_step(cfg, state, points, valid, stamps, icp_rounds_fn, kf_offset,
                            points_shard, into)


def _phased_step(cfg, state, points, valid, stamps, icp_rounds_fn, kf_offset, points_shard,
                 into):
    """:func:`_odometry_step`'s body: every op inside one phase."""
    dtype, dev = cfg.dtype, points.device
    with phase(stamps, "deskew" if cfg.deskew else "build"):
        # filled in on the device: a copy from the host would synchronise
        hz = torch.full((), cfg.sensor_hz, dtype=dtype, device=dev)

    # ---- deskew (pipeline.cpp:137-138, 79-123) ----
    if cfg.deskew:
        with phase(stamps, "deskew"):
            points = deskew_scan(points, valid, state.traj_count >= 2, state.traj[:, -2],
                                 state.traj[:, -1], hz, cfg.deskew_mode)

    # ---- current-scan tree (pipeline.cpp:140-144) ----
    if points_shard is not None:
        points, valid = points_shard.take(points), points_shard.take(valid)
    with phase(stamps, "build"):
        tree, _ = build_tree(
            points, valid, depth=cfg.depth, b_max=cfg.b_max, b_min=cfg.b_min,
            shard=points_shard,
        )
        leaves = get_leaves(tree, cfg.leaves_cap)

    # ---- constant-velocity prediction + ICP (pipeline.cpp:146-193) ----
    with phase(stamps, "tail"):
        # X exp_se3_split(velocity / hz): K14's predict on the card
        X0 = step_scalars.predict(state.X, state.velocity, hz)
    if icp_rounds_fn is None:
        with phase(stamps, "assoc"):
            kf_valid_f = state.kf_valid.to(dtype)
        X, H_last, matched, n_descents = icp_rounds(
            cfg, state.kf_tree, kf_valid_f, leaves.pts, leaves.valid, X0, stamps=stamps,
        )
    else:
        X, H_last, matched, n_descents = icp_rounds_fn(
            state.kf_tree, state.kf_valid, leaves, X0, stamps)

    with phase(stamps, "tail"):
        if stamps is not None:  # before the tail moves the ring's flags
            stamps.counts(n_descents, state.kf_valid, leaves.valid)
        # ---- inlier ratio, trajectory and velocity, frame record and
        # promotion (pipeline.cpp:197-262): the scalars by K14's tail (into
        # ``into``'s tensors where given), the trees by K13 on the card. The
        # rings are written in place: the moved scan into its window slot,
        # the promoted window tree into the keyframe ring only where a
        # sequence promotes and this process holds its ring head.
        tail = step_scalars.tail(state, X, H_last, matched, leaves.valid, hz, p_th=cfg.p_th,
                                 num_keyframes=cfg.num_keyframes, kf_offset=kf_offset,
                                 out=into)
        ring_write.ring_write(tree.nav, X, tail.plan, state.fr_tree.nav, state.kf_tree.nav)
        leaves_pts = moving_in_map(leaves.pts, X)
        n_leaves_dropped = torch.clamp(leaves.total - cfg.leaves_cap, min=0)

    new_state = PipelineState(
        X=X if into is None else into.X,
        velocity=tail.velocity,
        traj=tail.traj,
        traj_count=tail.traj_count,
        kf_tree=state.kf_tree,
        kf_valid=tail.kf_valid,
        kf_head=tail.kf_head,
        keyframe_to_map=tail.keyframe_to_map,
        fr_tree=state.fr_tree,
        fr_valid=tail.fr_valid,
        fr_weight=tail.fr_weight,
        fr_seq=tail.fr_seq,
        fr_pose=tail.fr_pose,
        fr_head=tail.fr_head,
        seq=tail.seq,
        seq_keyframe=tail.seq_keyframe,
    )
    out = StepOutput(
        pose=X,
        inlier_ratio=tail.ratio,
        map_updated=tail.promote,
        n_leaves=tail.n_leaves,
        leaves_pts=leaves_pts,
        leaves_valid=leaves.valid,
        n_leaves_dropped=n_leaves_dropped,
        n_descents=n_descents,
    )
    return new_state, out


def fill_rows(dst: np.ndarray, points) -> tuple:
    """Write a cloud's first ``len(dst)`` rows into ``dst``, converted to
    its dtype as numpy converts; rows past the cloud keep what they held.
    Returns ``(n, n_dropped)``: the rows written, and the points beyond
    the capacity (truncated in input order)."""
    points = np.asarray(points)
    N = dst.shape[0]
    n = min(points.shape[0], N)
    dst[:n] = points[:n]
    return n, max(0, points.shape[0] - N)


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
    CUDA unless the caller passes ``device="cpu"``.

    The state is a batch of one in static buffers
    (:class:`~madicp_tpu_torch.models.step_graph.StepGraphs`). On CUDA a
    scan is the replay of one captured graph a configuration, from the
    second odometry scan on; eager are the first scan, the first
    odometry scan (the warm-up) and every scan on the CPU. :attr:`state`
    reads the buffers as one sequence's state (views, which every scan
    overwrites in place) and, assigned, copies into them.

    :attr:`trace`: the program's trace
    (:class:`~madicp_tpu_torch.utils.timing.Trace`), None (off) by
    default. While set, each scan's step stamps its phases on the device
    (on CUDA a second graph, captured once: a traced scan is still one
    replay) and the host API records its spans: ``madicp.stage`` (with
    ``madicp.stage.wait`` on CUDA, ``madicp.stage.pad`` and
    ``madicp.copy_in``), ``madicp.compute`` (with
    ``madicp.replay`` and ``madicp.clone_out``) and ``madicp.pose`` (with
    ``madicp.pose.wait``)."""

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
        from madicp_tpu_torch.models.step_graph import StepGraphs  # imports this module

        self.realtime = bool(realtime)
        self._graphs = StepGraphs(init_state(self.cfg, self.device, batch=1),
                                  self.cfg.n_points, self.cfg.dtype)
        # the build's widest level, 2^depth segments: its workspace is
        # allocated now, before anything could capture the step
        segsum.reserve(self.device, self.cfg.n_points, 1 << self.cfg.depth)
        self._iota = torch.arange(self.cfg.n_points, dtype=torch.int32, device=self.device)
        self._last: Optional[StepOutput] = None
        self._initialized = False
        # anytime-realtime calibration (see compute())
        self._rt_scans = 0
        self._rt_calibrated = not self.realtime
        self._rt_every = max(1, int(realtime_recal_every))
        self._rt_its_max = int(max_icp_iterations)
        # a recalibration only times an iteration count that has already
        # run once, on CUDA as its graph (the JAX package's warm-only rule)
        self._rt_cfg_warm = False
        self._rt_pending = False
        self._now = None  # injectable clock (tests)
        self._n_points_dropped = 0
        self.trace = None

    @property
    def state(self) -> PipelineState:
        """The sequence's state: views of the static buffers, which every
        scan overwrites in place (copy what must outlive a scan)."""
        return _drop(self._graphs.state)

    @state.setter
    def state(self, state: PipelineState) -> None:
        """Copy a single sequence's state of this configuration's shapes
        into the static buffers; the next scan steps from it."""
        self._graphs.assign(_lift(state))

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
        """Move a cloud to the device at the static shape. Returns ``(pts,
        valid, n_dropped)`` for :meth:`compute_device`: fresh device
        tensors, ``pts`` the cloud's first ``n_points`` rows in the
        configuration's dtype (converted as numpy converts) and zeros
        after them, ``valid`` true on those rows (``iota < n``);
        ``n_dropped`` the points beyond the capacity, truncated in input
        order.

        On CUDA the rows cross once, unpadded, by an asynchronous copy
        from a page-locked buffer of torch's caching host allocator, which
        hands a buffer out again only once the copies made from it are
        done; the padding and the mask are made on the card, on the stream
        current here, which the step shares. On the CPU the rows are
        written straight into ``pts``."""
        tr = self.trace
        N, dtype = self.cfg.n_points, self.cfg.dtype
        with host_span(tr, "madicp.stage", None if tr is None else tr.next_staged()):
            if self.device.type != "cuda":
                with host_span(tr, "madicp.stage.pad"):
                    pts = torch.zeros((N, 3), dtype=dtype)
                    n, n_dropped = fill_rows(pts.numpy(), points)
                with host_span(tr, "madicp.copy_in"):
                    return pts, self._iota < n, n_dropped
            with host_span(tr, "madicp.stage.wait"):
                rows = torch.empty((N, 3), dtype=dtype, pin_memory=True)
            with host_span(tr, "madicp.stage.pad"):
                n, n_dropped = fill_rows(rows.numpy(), points)
            with host_span(tr, "madicp.copy_in"):
                pts = torch.zeros((N, 3), dtype=dtype, device=self.device)
                pts[:n].copy_(rows[:n], non_blocking=True)
                return pts, self._iota < n, n_dropped

    def compute_device(self, stamp: float, pts, valid, n_dropped: int = 0) -> None:
        """Process a scan already padded and staged on the device (see
        :meth:`stage`); otherwise identical to :meth:`compute`."""
        with host_span(self.trace, "madicp.compute"):
            self._compute_device(pts, valid, n_dropped)

    def _compute_device(self, pts, valid, n_dropped: int) -> None:
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
            # this iteration count has never run: run it untimed first (on
            # CUDA its graph's capture and first replay) and recalibrate on
            # the next scan
            self._rt_pending = True
            self._dispatch_step(pts, valid)
        elif due:
            self._rt_pending = False
            self._calibrate_realtime(pts, valid)
        else:
            self._dispatch_step(pts, valid)
        self._rt_scans += 1

    def _dispatch_step(self, pts, valid) -> None:
        """Host-side first-scan/odometry branch; enqueues the scan and
        reads nothing on the host."""
        if self._initialized:
            out = self._graphs.step(self.cfg, pts[None], valid[None], self.trace)
        else:
            out = self._graphs.initialize(self.cfg, pts[None], valid[None], self.trace)
            self._initialized = True
        self._rt_cfg_warm = self._graphs.ready(self.cfg, self.trace is not None)
        self._last = _drop(out)

    def compute_batch(self, stamps, clouds) -> np.ndarray:
        """Process a chunk of scans; returns the (C, 4, 4) chunk poses.

        ``stamps`` is a length-C sequence of floats, ``clouds`` a length-C
        sequence of (Ni, 3) arrays. The JAX package runs the chunk as one
        compiled ``lax.scan``; here the scans are staged, then enqueued in
        order with no host read (on CUDA a replay of the step's graph a
        scan), and the poses come to the host in one copy at the end. Each
        scan's pose is that step's own output, which no later step
        changes. The accessors hold the chunk's LAST scan;
        :meth:`points_dropped` sums the chunk's truncated points. A chunk
        may start on an uninitialised pipeline (its first scan
        bootstraps).

        With ``realtime=True`` the anytime budget is a per-scan host
        decision, so chunking is refused until the calibration has run
        (a few scans through :meth:`compute` first); within a chunk the
        iteration count stays fixed.
        """
        if self.realtime and not self._rt_calibrated:
            raise RuntimeError(
                "compute_batch is an offline/throughput API; "
                "realtime mode processes scan-by-scan via compute()"
            )
        C = len(stamps)
        if len(clouds) != C or C < 1:
            raise ValueError(f"need C >= 1 stamps and as many clouds, got {C} and {len(clouds)}")
        staged = [self.stage(cloud) for cloud in clouds]
        poses = []
        for pts, valid, _ in staged:
            with host_span(self.trace, "madicp.compute"):
                self._dispatch_step(pts, valid)
            poses.append(self._last.pose)
        self._n_points_dropped = sum(n for _, _, n in staged)
        self._rt_scans += C
        return self._read_pose(lambda: torch.stack(poses).cpu().numpy())

    def _calibrate_realtime(self, pts, valid) -> None:
        """Rolling anytime-budget calibration: time one synchronised
        steady-state step and rescale the ICP iteration budget to fit.
        The count SHRINKS when the budget is blown and is RESTORED toward
        the configured maximum (at most +4 per recalibration) when
        headroom returns."""
        now = self._now or time.perf_counter
        synchronize(self.device)  # drain the queue
        t0 = now()
        self._dispatch_step(pts, valid)
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

    # -- accessors (reference pipeline.h:60-71, pipeline.cpp:286-308) -------
    # (copies: the buffers change in place, and on the CPU .numpy() of
    # a buffer would share its memory)
    def current_pose(self) -> np.ndarray:
        return self._read_pose(lambda: self.state.X.to("cpu", copy=True).numpy())

    def _read_pose(self, read):
        """``read()``, the host's wait for the device, inside the trace's
        pose spans; the traced steps' stamps are read after it."""
        tr = self.trace
        if tr is None:
            return read()
        with tr.span("madicp.pose", tr.last_step):
            with tr.span("madicp.pose.wait"):
                out = read()
            tr.collect()
        return out

    def keyframe_pose(self) -> np.ndarray:
        return self.state.keyframe_to_map.to("cpu", copy=True).numpy()

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
