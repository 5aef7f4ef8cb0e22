"""MAD-tree as a statically-shaped, level-synchronous batched structure.

The tree is an implicit heap-indexed arena (root at row 1, children of
``i`` at ``2i``/``2i+1``) built level by level: each point carries its
segment id, and per level three steps give every node of the level its
mean, covariance, eigenbasis, oriented extents and leaf decision at once:
the moment segment-sum (:mod:`madicp_tpu_torch.kernels.segsum`), the node
math (:mod:`madicp_tpu_torch.kernels.build_nodes`, K9) and the per-point
pass with its min-reduction of extents
(:mod:`madicp_tpu_torch.kernels.build_points`, K8); on the card each is a
hand-written CUDA kernel, on the CPU its plain version.

Storage is the JAX package's gather-optimised ``nav`` layout, unchanged
so the two packages compare row for row: ``nav`` (M, 56) holds, per
node, the 8-float descent blocks of its depth-2 subtree (itself, both
children, four grandchildren). A block is ``[mean(3), split(3), kids,
flags]`` for an interior node and ``[repr(3), normal(3), bbox0, flags]``
for a leaf; ``kids`` = left + 2*right child existence, ``flags`` =
``is_leaf + 2*is_real``. One gather advances a descent three levels.

Algorithmic contracts (reference ``mad_tree.cpp``, as in the JAX
package): leaf when the largest oriented extent ``< b_max`` or at the
depth cap; plane-predecessor normal inheritance below ``b_min``; leaves
of fewer than 3 points inherit the nearest >= 3-point ancestor's normal;
the representative is the input point nearest the leaf mean (near ties
to the lowest original index); extents include the origin; covariance
with the k/(k-1) correction; ``>= 0`` on the split direction goes right;
search is pure descent without backtracking.

JAX's ``.at[i].add/min(..., mode="drop")`` has no torch counterpart:
the plain versions route out-of-range ids to one spare row that is
sliced off.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

from madicp_tpu_torch.kernels import build_nodes, build_points, descent
from madicp_tpu_torch.kernels.segsum import segsum_moments


class SearchTree(NamedTuple):
    """Packed arena form of a built MAD-tree (``nav`` (..., M, 56),
    ``M = 2 ** (depth + 1)``; row 0 unused). A leaf row's ``mean`` /
    ``split`` read as its representative point / surfel normal."""

    nav: torch.Tensor

    @property
    def mean(self) -> torch.Tensor:
        """Interior rows: node mean. Leaf rows: representative point."""
        return self.nav[..., 0:3]

    @property
    def split(self) -> torch.Tensor:
        """Interior rows: split direction. Leaf rows: surfel normal."""
        return self.nav[..., 3:6]

    @property
    def repr(self) -> torch.Tensor:
        return self.nav[..., 0:3]

    @property
    def normal(self) -> torch.Tensor:
        return self.nav[..., 3:6]

    @property
    def bbox0(self) -> torch.Tensor:
        return self.nav[..., 6]

    @property
    def is_leaf(self) -> torch.Tensor:
        flags = self.nav[..., 7]
        return (flags == 1.0) | (flags == 3.0)

    @property
    def is_real(self) -> torch.Tensor:
        return self.nav[..., 7] >= 2.0

    @property
    def depth(self) -> int:
        return int(math.log2(self.nav.shape[-2])) - 1


class Leaves(NamedTuple):
    """Compacted leaf list of a tree (padded to a static capacity).
    ``total`` is the true leaf count before capping; leaves beyond the
    capacity are dropped in arena order."""

    pts: torch.Tensor     # (L, 3) representative points
    normal: torch.Tensor  # (L, 3)
    bbox0: torch.Tensor   # (L,)
    valid: torch.Tensor   # (L,) bool
    total: torch.Tensor   # () int64 — true leaf count (may exceed L)


NAV_WIDTH = 56  # 7 blocks x 8 floats (self, 2 children, 4 grandchildren)


def tree_arena_size(depth: int) -> int:
    return 2 ** (depth + 1)


def _pack_tree(arena: dict, M: int, dtype) -> SearchTree:
    """Assemble the ``nav`` layout from per-field ``(B, M, ...)`` arena
    arrays: panel 0 is each row's own block, panels 1-6 strided copies of
    the block table (children of ``i`` are rows ``2i``/``2i+1``), zero
    beyond."""
    leaf = arena["is_leaf"] & arena["is_real"]
    B = leaf.shape[0]
    flags = leaf.to(dtype) + 2.0 * arena["is_real"].to(dtype)
    real_pairs = arena["is_real"].to(dtype).reshape(B, M // 2, 2)
    kids = torch.zeros((B, M), dtype=dtype, device=flags.device)
    kids[:, : M // 2] = real_pairs[..., 0] + 2.0 * real_pairs[..., 1]

    lf = leaf[..., None]
    blk = torch.cat(
        [
            torch.where(lf, arena["repr"], arena["mean"]),
            torch.where(lf, arena["normal"], arena["split"]),
            torch.where(leaf, arena["bbox0"], kids)[..., None],
            flags[..., None],
        ],
        dim=-1,
    )  # (B, M, 8)
    nav = torch.zeros((B, M, NAV_WIDTH), dtype=dtype, device=blk.device)
    nav[..., 0:8] = blk
    for panel, (k, j) in enumerate(((2, 0), (2, 1), (4, 0), (4, 1), (4, 2), (4, 3))):
        c = 8 * (panel + 1)
        nav[:, : M // k, c:c + 8] = blk.view(B, M // k, k, 8)[:, :, j]
    return SearchTree(nav=nav)


class PointShard(NamedTuple):
    """How a build whose points are split over processes completes its
    per-level tables: ``all_sum`` / ``all_min`` reduce a tensor over the
    processes that share the cloud and return the result, and this
    process holds points ``[offset, offset + n_local)`` of every cloud
    of ``n_total`` points. The built tree comes out the same on every
    process."""

    all_sum: Callable[[torch.Tensor], torch.Tensor]
    all_min: Callable[[torch.Tensor], torch.Tensor]
    offset: int
    n_local: int
    n_total: int

    def take(self, x: torch.Tensor) -> torch.Tensor:
        """This process's share of per-point data ``(B, n_total, ...)``."""
        return x[:, self.offset:self.offset + self.n_local]


def build_tree(
    points: torch.Tensor,
    valid: torch.Tensor,
    *,
    depth: int,
    b_max: float,
    b_min: float,
    shard: Optional[PointShard] = None,
) -> tuple[SearchTree, torch.Tensor]:
    """Build a MAD-tree over a padded point cloud, or one tree per cloud
    of a batch.

    Levels are unrolled in Python; level ``l`` owns arena rows
    ``[2^l, 2^{l+1})``. Per level: the moment segment-sum
    (:func:`segsum_moments`); the node math on the compact ``(B 2^l, .)``
    level tables (eigh3, plane predecessor, normal inheritance), which
    also closes the previous level from its extents
    (:func:`build_nodes.build_nodes`); the per-point pass: each point's
    node pack, the eigenbasis projection, the min of extents and the
    advance (:func:`build_points.build_points`). One more launch closes
    the last level, two pick the leaf representatives. A batch folds into
    the segment axis: node ``j`` of cloud ``b`` is segment ``b 2^l + j``
    of the level, so each launch serves every cloud.

    Args:
        points: (N, 3) or (B, N, 3) padded point clouds (padding must be
            finite).
        valid:  (N,) or (B, N) bool masks of real points.
        depth:  static maximum tree depth (forced leaves at the cap).
        b_max:  leaf criterion on the largest oriented extent.
        b_min:  plane-predecessor criterion on the smallest extent.
        shard:  the points are this process's share of each cloud
            (:class:`PointShard`): the moment tables are summed and the
            extents and the leaf pick minimised over the processes.

    Returns:
        (tree, point_leaf): the packed tree(s), ``nav`` (M, 56) or
        (B, M, 56), and per input point the arena id of its leaf (0 for
        padding points).
    """
    single = points.dim() == 2
    if single:
        points, valid = points[None], valid[None]
    dtype, dev = points.dtype, points.device
    B, N = valid.shape
    BN = B * N
    points = points.reshape(BN, 3).contiguous()
    valid = valid.contiguous()
    M = tree_arena_size(depth)

    # per-point state: the level's shifted deltas (level 0's shift is 0)
    # and segment ids, and the leaf and freeze distance of retired points
    d = points
    idx = torch.where(valid.reshape(BN),
                      torch.arange(B, dtype=torch.int32, device=dev).repeat_interleave(N),
                      build_points.DROP)
    leaf_of = torch.zeros((BN,), dtype=torch.int64, device=dev)
    frz_dist = torch.full((BN,), torch.finfo(dtype).max, dtype=dtype, device=dev)

    arena = torch.empty((B, M, build_nodes.ARENA_COLS), dtype=dtype, device=dev)
    prev = None
    for level in range(depth + 1):
        nseg = B << level
        if shard is None:
            mom = segsum_moments(d, idx, nseg)
        else:  # partial tables summed in double, as the kernel sums
            mom = shard.all_sum(segsum_moments(d.double(), idx, nseg)).to(dtype)
        packA, state, ext = build_nodes.build_nodes(mom, prev, arena, level=level,
                                                    b_max=b_max, b_min=b_min)
        d, idx = build_points.build_points(points, d, idx, leaf_of, frz_dist, packA, ext,
                                           level=level, depth=depth)
        if shard is not None:
            ext = shard.all_min(ext)
        prev = (packA, state, ext)
    build_nodes.close_level(state, ext, arena, level=depth)

    # ---- leaf representatives (mad_tree.cpp:76-86): the point nearest
    # the leaf mean, distances within a relative tie_tol of the minimum
    # resolving to the LOWEST ORIGINAL INDEX within its cloud (the JAX
    # package's rule, so 2-point leaves pick the same representative in
    # both). Leaf ``a`` of cloud ``b`` is row ``b M + a``; a point's index
    # is ``b N + n``, so within a cloud the order is the cloud's own ----
    BM = B * M
    leaf_bn, frz_bn = leaf_of.view(B, N), frz_dist.view(B, N)
    dmin = build_points.pick_dmin(valid, leaf_bn, frz_bn, M)
    if shard is not None:
        dmin = shard.all_min(dmin)
    n_total, offset = (N, 0) if shard is None else (shard.n_total, shard.offset)
    near_pos = build_points.pick_near(valid, leaf_bn, frz_bn, dmin, M, n_total, offset)
    if shard is None:
        near_pt = points.index_select(0, torch.clamp(near_pos, max=BN - 1))
    else:
        # the lowest global index over the processes; the process that
        # holds that point contributes it
        near_pos = shard.all_min(near_pos)
        row_b = torch.arange(B, device=dev).repeat_interleave(M)
        local = near_pos - (row_b * shard.n_total + shard.offset)
        mine = (local >= 0) & (local < N)
        near_pt = points.index_select(0, row_b * N + torch.clamp(local, 0, N - 1))
        near_pt = shard.all_sum(torch.where(mine[:, None], near_pt, 0.0))
    is_leaf = arena[..., 10] > 0
    fields = dict(
        mean=arena[..., 0:3], split=arena[..., 3:6], normal=arena[..., 6:9],
        bbox0=arena[..., 9], is_leaf=is_leaf, is_real=arena[..., 11] > 0,
        repr=torch.where(is_leaf[..., None], near_pt.view(B, M, 3), arena[..., 0:3]),
    )

    tree = _pack_tree(fields, M, dtype)
    point_leaf = torch.where(valid, leaf_bn, 0)
    if single:
        return SearchTree(nav=tree.nav[0]), point_leaf[0]
    return tree, point_leaf


def search_forest(
    nav: torch.Tensor,
    queries: torch.Tensor,
    base,
    depth: int,
    valid: Optional[torch.Tensor] = None,
    start: Optional[torch.Tensor] = None,
    n_gathers: Optional[int] = None,
    return_blocks: bool = False,
    return_margin: bool = False,
    ladder: int = 0,
):
    """Approximate-NN descent inside a flat forest of trees.

    ``nav`` is a stacked flat table (e.g. all keyframe arenas viewed as
    ``(K*M, 56)``) and ``base`` the row offset of each query's tree — an
    int or a (Q,) tensor, so one call descends every (keyframe, query)
    pair. Returns LOCAL heap leaf ids. Pure descent by split-plane sign
    (``>= 0`` goes right), no backtracking (``mad_tree.cpp:144-152``);
    each gathered row advances a query three levels.

    ``start`` (Q,) warm-starts each descent at an interior node, with
    ``n_gathers`` bounding it. ``valid=False`` queries park at row 0 of
    their tree. ``return_blocks`` adds the final (Q, 8) block (for a
    leaf, its payload ``[repr(3), normal(3), bbox0, flags]``);
    ``return_margin`` adds the (Q,) minimum |distance to a split plane|
    over every real interior node evaluated — the path-stability
    certificate of the certified schedule.

    CPU tensors take the plain version
    (:func:`madicp_tpu_torch.kernels.descent.descend_plain`), CUDA tensors
    the descent kernel (``kernels/csrc/descent.cu``, one thread a query,
    which stops a query once it can no longer step), bitwise equal to it.

    ``ladder`` is accepted and ignored: the JAX package's select ladder
    is a TPU gather workaround pinned bitwise equal to this gather path.
    """
    del ladder
    return descent.descend(nav, queries, base, depth, valid, start, n_gathers,
                           return_blocks, return_margin)


def search_tree(tree: SearchTree, queries: torch.Tensor, depth: Optional[int] = None) -> torch.Tensor:
    """Approximate-NN descent on a single tree: (Q, 3) -> (Q,) leaf ids."""
    return search_forest(tree.nav, queries, 0, tree.depth if depth is None else depth)


def search_payload(tree: SearchTree, leaf_ids: torch.Tensor):
    """Leaf payload for descent results in one row read:
    ``(pts, normals, bbox0, ok)``."""
    lf = tree.nav.index_select(0, leaf_ids.long())[:, 0:8]
    return lf[:, 0:3], lf[:, 3:6], lf[:, 6], lf[:, 7] == 3.0


def get_leaves(tree: SearchTree, max_leaves: int) -> Leaves:
    """Compact the tree's leaves into padded fixed-size arrays, in arena
    order; leaves beyond the capacity are dropped. A cumsum and a row
    scatter into a spare row — no host sync. A batch of trees ``nav``
    (B, M, 56) gives every field a leading B (each tree compacted on its
    own)."""
    nav = tree.nav
    single = nav.dim() == 2
    if single:
        nav = nav[None]
    B, M = nav.shape[0], nav.shape[1]
    L = max_leaves
    flag = nav[..., 7] == 3.0  # (B, M)
    pos = torch.cumsum(flag.long(), dim=-1) - 1
    idx = torch.where(flag & (pos < L), pos, L) + (
        torch.arange(B, device=nav.device) * (L + 1))[:, None]
    out = torch.zeros((B * (L + 1), 8), dtype=nav.dtype, device=nav.device)
    out.index_copy_(0, idx.reshape(B * M), nav.reshape(B * M, NAV_WIDTH)[:, 0:8])
    count = flag.sum(dim=-1)  # (B,)
    out = out.view(B, L + 1, 8)[:, :L]
    leaves = Leaves(
        pts=out[..., 0:3],
        normal=out[..., 3:6],
        bbox0=out[..., 6],
        valid=torch.arange(L, device=nav.device) < count[:, None],
        total=count,
    )
    if single:
        return Leaves(*(f[0] for f in leaves))
    return leaves


def count_leaves(tree: SearchTree) -> torch.Tensor:
    return torch.sum(tree.nav[..., 7] == 3.0)


def transform_tree(tree: SearchTree, R: torch.Tensor, t: torch.Tensor) -> SearchTree:
    """Rigidly move a tree into another frame (reference
    ``applyTransform``, ``mad_tree.cpp:165-172``). Every ``nav`` block is
    ``[position(3), direction(3), scalar(2)]``, so the table moves as one
    affine map per block: positions ``R p + t``, directions ``R n`` (every
    row, padding included, as in the JAX package's ``nav @ A + c``). A
    batch of trees (B, M, 56) takes one pose each, R (B, 3, 3) and t
    (B, 3)."""
    nav = tree.nav
    blocks = nav.reshape(nav.shape[:-2] + (-1, 8))  # (..., M * 7, 8)
    Rt = R.to(nav.dtype).mT
    t = t.to(nav.dtype)[..., None, :]
    pos = blocks[..., 0:3] @ Rt + t
    dirs = blocks[..., 3:6] @ Rt
    moved = torch.cat([pos, dirs, blocks[..., 6:8]], dim=-1)
    return SearchTree(nav=moved.reshape(nav.shape))
