"""Keyframe-sharded ICP: each process holds K/n keyframe trees and one
all-reduce a GN round completes the normal equations.

The counterpart of the JAX package's ``shard_map`` + ``psum`` step (and
of the reference's OpenMP keyframe loop, ``pipeline.cpp:180-185``):
every rank of the ``kf`` group descends only its own keyframe trees with
the same batched round schedule as the single-device path
(:func:`~madicp_tpu_torch.models.pipeline.icp_rounds`), and its
``reduce_terms`` hook all-reduces ``(H, b)`` (SUM) and, in the final
round, ``matched`` (int32 SUM > 0) over the group; the descent count is
summed once a step. Everything else of the step — the tree build, the
leaves, the frame window — is the same work on every rank, so its
results are replicated. They agree across ranks up to the order of the
build's double atomic sums on a card (bitwise on the CPU), which is why
the tests compare the pose of every rank.

With ``shard_points`` the scan's tree build is split too: each rank
builds from its N/n points and the per-level moment tables (SUM),
extents (MIN) and leaf pick (MIN over global point indices, then the
owner's point) are all-reduced (:class:`~madicp_tpu_torch.ops.tree.PointShard`).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from madicp_tpu_torch.models.pipeline import (
    PipelineConfig,
    PipelineState,
    icp_rounds,
    initialize_step,
    odometry_step,
)
from madicp_tpu_torch.ops.icp_core import associate_ring, terms_from_payload
from madicp_tpu_torch.ops.tree import PointShard
from madicp_tpu_torch.parallel.mesh import axis_index, axis_size, make_global
from madicp_tpu_torch.utils.timing import phase


class _Counter:
    """All-reduces the hooks issued (a plain integer, reset by callers)."""

    def __init__(self):
        self.all_reduces = 0


counter = _Counter()


def _all_reduce(t: torch.Tensor, op, group) -> torch.Tensor:
    t = t.contiguous()
    dist.all_reduce(t, op=op, group=group)
    counter.all_reduces += 1
    return t


def kf_reduce_terms(group):
    """The ``reduce_terms`` hook of :func:`icp_rounds` over ``group``:
    ``(H, b)`` in one SUM all-reduce, ``matched`` as int32 SUM > 0."""

    def reduce(terms):
        H, b = terms[0], terms[1]
        hb = _all_reduce(torch.cat([H.flatten(-2), b], dim=-1), dist.ReduceOp.SUM, group)
        out = (hb[..., :36].view(H.shape), hb[..., 36:])
        if len(terms) == 3:
            m = _all_reduce(terms[2].to(torch.int32), dist.ReduceOp.SUM, group)
            out += (m > 0,)
        return out

    return reduce


def kf_rounds_fn(cfg: PipelineConfig, group):
    """``odometry_step``'s ``icp_rounds_fn`` for a ring split over
    ``group``: the local round schedule with the all-reduce hook, and the
    descent count summed over the group (the step's ``stamps`` stamp its
    phases)."""
    reduce = kf_reduce_terms(group)

    def rounds(kf_tree, kf_valid, leaves, X0, stamps=None):
        with phase(stamps, "assoc"):
            kf_valid_f = kf_valid.to(cfg.dtype)
        X, H_last, matched, n_desc = icp_rounds(
            cfg, kf_tree, kf_valid_f, leaves.pts, leaves.valid, X0,
            stamps=stamps, reduce_terms=reduce)
        return X, H_last, matched, _all_reduce(n_desc, dist.ReduceOp.SUM, group)

    return rounds


def points_shard(group, index: int, count: int, n_total: int) -> PointShard:
    """The :class:`PointShard` of rank ``index`` of ``count`` in
    ``group``, for clouds of ``n_total`` points."""
    if n_total % count:
        raise ValueError(f"{n_total} points do not split over {count} processes")
    n = n_total // count
    return PointShard(
        all_sum=lambda t: _all_reduce(t, dist.ReduceOp.SUM, group),
        all_min=lambda t: _all_reduce(t, dist.ReduceOp.MIN, group),
        offset=index * n, n_local=n, n_total=n_total)


def icp_round_sharded(
    mesh,
    kf_tree,
    kf_valid: torch.Tensor,
    leaves_pts: torch.Tensor,
    leaves_valid: torch.Tensor,
    X: torch.Tensor,
    *,
    b_max,
    b_ratio,
    rho_ker,
):
    """One association+accumulation round with the keyframe axis sharded.

    Standalone single-round utility (a building block and the reference
    for the collective layout): every rank passes the WHOLE ring
    ``kf_tree`` (K, M, 56) / ``kf_valid`` (K,) and descends its own K/n
    trees. The pipeline does not call this; it hooks
    :func:`kf_reduce_terms` into its round schedule. Returns globally
    reduced ``(H, b, matched)``; ``matched`` is the any-keyframe match
    mask of the moving leaves. The leaves are ``get_leaves``': the valid
    ones a prefix of their slots, so the terms walk only that prefix.
    """
    nav = make_global(kf_tree.nav, ("kf",), mesh)
    valid_f = make_global(kf_valid, ("kf",), mesh).to(leaves_pts.dtype)
    K, L = nav.shape[0], leaves_pts.shape[0]
    _, payload = associate_ring(nav, kf_tree.depth, leaves_pts, leaves_valid.expand(K, L), X=X)
    terms = terms_from_payload(payload, leaves_pts, leaves_valid, X, b_max=b_max,
                               b_ratio=b_ratio, rho_ker=rho_ker, n_live=leaves_valid.sum())
    H = torch.einsum("k,kij->ij", valid_f, terms.H)
    b = torch.einsum("k,ki->i", valid_f, terms.b)
    matched = torch.any(terms.matched & (valid_f > 0)[:, None], dim=0)
    return kf_reduce_terms(mesh.get_group("kf"))((H, b, matched))


def make_sharded_pipeline_step(cfg: PipelineConfig, mesh, shard_points: bool = False,
                               device=None):
    """The full odometry step of one sequence with the keyframe ring split
    over the mesh's ``kf`` axis (and, with ``shard_points``, the scan's
    tree build too).

    Returns ``(step, place_state, place_inputs)``:

    - ``place_state(state)``: this rank's share of a whole state (a
      ``PipelineState`` of tensors, or a mapping of numpy arrays as
      :func:`~madicp_tpu_torch.utils.convert.state_from_numpy` takes):
      its K/n keyframe slots, everything else whole, on ``device``;
    - ``place_inputs(points, valid, stamp)``: the scan's tensors on
      ``device``. Every rank passes the whole cloud (the deskew sweep
      needs it); the step builds from this rank's share;
    - ``step(state, points, valid, stamp) -> (state, out)``: the first
      scan's bootstrap when ``state.seq`` is 0 (read on the host), else
      the odometry step with the all-reduce hook; promotions are masked
      on the device, and only the rank holding slot ``kf_head`` writes
      it.
    """
    from madicp_tpu_torch.parallel.distributed import local_device
    from madicp_tpu_torch.utils.convert import kf_shard, state_from_numpy

    dev = local_device(device)
    n_kf, i_kf = axis_size(mesh, "kf"), axis_index(mesh, "kf")
    K = cfg.num_keyframes
    if K % n_kf:
        raise ValueError(f"{K} keyframes do not split over a kf axis of {n_kf}")
    kf_offset = i_kf * (K // n_kf)
    group = mesh.get_group("kf")
    rounds = kf_rounds_fn(cfg, group)
    shard = points_shard(group, i_kf, n_kf, cfg.n_points) if shard_points else None

    def place_state(state) -> PipelineState:
        if not isinstance(state, PipelineState):
            state = state_from_numpy(cfg, state, dev)
        state = PipelineState(*(f.to(dev) if isinstance(f, torch.Tensor)
                                else type(f)(f.nav.to(dev)) for f in state))
        return kf_shard(state, i_kf, n_kf)

    def place_inputs(points, valid, stamp):
        return (torch.as_tensor(np.asarray(points), dtype=cfg.dtype, device=dev),
                torch.as_tensor(np.asarray(valid), dtype=torch.bool, device=dev),
                float(stamp))

    def step(state, points, valid, stamp):
        if int(state.seq) == 0:
            return initialize_step(cfg, state, points, valid, stamp,
                                   kf_offset=kf_offset, points_shard=shard)
        return odometry_step(cfg, state, points, valid, stamp, icp_rounds_fn=rounds,
                             kf_offset=kf_offset, points_shard=shard)

    return step, place_state, place_inputs
