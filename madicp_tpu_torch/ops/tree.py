"""MAD-tree as a statically-shaped, level-synchronous batched structure.

The tree is an implicit heap-indexed arena (root at row 1, children of
``i`` at ``2i``/``2i+1``) built level by level: each point carries its
node id, and per level one moment segment-sum (the CUDA kernel of
:mod:`madicp_tpu_torch.kernels.segsum` on the card) plus one scatter-min
of eigenbasis extents give every node of the level its mean, covariance,
eigenbasis, oriented extents and leaf decision at once.

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
out-of-range ids are routed to one spare row that is sliced off.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from madicp_tpu_torch.kernels.segsum import segsum_moments
from madicp_tpu_torch.ops.eigh3 import eigh3


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


def _norm(x: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over the last axis, as ``sqrt(sum(x * x))``."""
    return torch.sqrt(torch.sum(x * x, dim=-1))


def _outer6(d: torch.Tensor) -> torch.Tensor:
    """Upper-triangular entries of d d^T: (N,3) -> (N,6)."""
    x, y, z = d[:, 0], d[:, 1], d[:, 2]
    return torch.stack([x * x, x * y, x * z, y * y, y * z, z * z], dim=-1)


def _sym_from6(u: torch.Tensor) -> torch.Tensor:
    """(N,6) upper-triangular -> (N,3,3) symmetric."""
    xx, xy, xz, yy, yz, zz = (u[:, i] for i in range(6))
    return torch.stack(
        [
            torch.stack([xx, xy, xz], -1),
            torch.stack([xy, yy, yz], -1),
            torch.stack([xz, yz, zz], -1),
        ],
        dim=-2,
    )


def _pack_tree(arena: dict, M: int, dtype) -> SearchTree:
    """Assemble the ``nav`` layout from per-field arena arrays: panel 0
    is each row's own block, panels 1-6 strided copies of the block
    table (children of ``i`` are rows ``2i``/``2i+1``), zero beyond."""
    leaf = arena["is_leaf"] & arena["is_real"]
    flags = leaf.to(dtype) + 2.0 * arena["is_real"].to(dtype)
    real_pairs = arena["is_real"].to(dtype).reshape(M // 2, 2)
    kids = torch.zeros((M,), dtype=dtype, device=flags.device)
    kids[: M // 2] = real_pairs[:, 0] + 2.0 * real_pairs[:, 1]

    lf = leaf[:, None]
    B = torch.cat(
        [
            torch.where(lf, arena["repr"], arena["mean"]),
            torch.where(lf, arena["normal"], arena["split"]),
            torch.where(leaf, arena["bbox0"], kids)[:, None],
            flags[:, None],
        ],
        dim=1,
    )  # (M, 8)
    nav = torch.zeros((M, NAV_WIDTH), dtype=dtype, device=B.device)
    nav[:, 0:8] = B
    for panel, (k, j) in enumerate(((2, 0), (2, 1), (4, 0), (4, 1), (4, 2), (4, 3))):
        c = 8 * (panel + 1)
        nav[: M // k, c:c + 8] = B.view(M // k, k, 8)[:, j]
    return SearchTree(nav=nav)


def build_tree(
    points: torch.Tensor,
    valid: torch.Tensor,
    *,
    depth: int,
    b_max: float,
    b_min: float,
) -> tuple[SearchTree, torch.Tensor]:
    """Build a MAD-tree over a padded point cloud.

    Levels are unrolled in Python; level ``l`` owns arena rows
    ``[2^l, 2^{l+1})``. Per level: the moment segment-sum
    (:func:`segsum_moments`), node math on the compact ``(2^l, .)``
    arrays (eigh3, plane predecessor, normal inheritance), a per-point
    gather of its node's pack, the eigenbasis projection and a
    scatter-min of extents; parent fields flow to the children with a
    ``repeat_interleave``.

    Args:
        points: (N, 3) padded point cloud (padding must be finite).
        valid:  (N,) bool mask of real points.
        depth:  static maximum tree depth (forced leaves at the cap).
        b_max:  leaf criterion on the largest oriented extent.
        b_min:  plane-predecessor criterion on the smallest extent.

    Returns:
        (tree, point_leaf): the packed tree and, per input point, the
        arena id of its leaf (0 for padding points).
    """
    dtype, dev = points.dtype, points.device
    N = points.shape[0]
    M = tree_arena_size(depth)
    big = torch.finfo(dtype).max
    big_i = 2**31 - 1
    iota = torch.arange(N, device=dev)

    # per-point state
    node = torch.where(valid, 1, 0)
    frozen = ~valid
    leaf_of = torch.zeros((N,), dtype=torch.int64, device=dev)
    frz_dist = torch.full((N,), big, dtype=dtype, device=dev)  # |p - leaf mean| at freeze
    prev_mean_pt = torch.zeros((N, 3), dtype=dtype, device=dev)  # parent mean: moment shift

    # per-node pack handed from a level to its children:
    # [mean(3), pca_n(3), ppn(3), n3(3), bbox0(1), has_pp(1), is_leaf(1)]
    prev_pack = torch.zeros((1, 15), dtype=dtype, device=dev)
    prev_pack[0, 12] = big  # level -1 sentinel: shift 0, no pp, no n3

    levels = []
    for level in range(depth + 1):
        lo = sz = 1 << level
        force_leaf = level == depth
        live = (~frozen) & valid
        idx = torch.where(live, node - lo, sz)  # local node index, sz = drop

        # ---- moments, shifted by the parent mean for f32 stability ----
        d = points - prev_mean_pt
        node_mom = segsum_moments(d, idx.to(torch.int32), sz)

        # ---- node math on the compact (sz, .) level arrays ----
        par = prev_pack if level == 0 else prev_pack.repeat_interleave(2, dim=0)
        par_mean, par_pca = par[:, 0:3], par[:, 3:6]
        par_ppn, par_n3 = par[:, 6:9], par[:, 9:12]
        par_bbox0, par_has_pp = par[:, 12], par[:, 13] > 0
        par_leaf = par[:, 14] > 0

        k = node_mom[:, 9]
        k_safe = torch.clamp(k, min=1.0)
        mean_shift = node_mom[:, 0:3] / k_safe[:, None]
        mean = par_mean + mean_shift
        cov6 = node_mom[:, 3:9] / k_safe[:, None] - _outer6(mean_shift)
        bessel = k / torch.clamp(k - 1.0, min=1.0)
        cov6 = torch.where((k >= 2.0)[:, None], cov6 * bessel[:, None], 0.0)
        _, evecs = eigh3(_sym_from6(cov6))  # (sz,3,3): columns ascending
        pca_n = evecs[:, :, 0]
        split_dir = evecs[:, :, 2]

        # plane predecessor (mad_tree.cpp:65-67, 90-93)
        below = par_bbox0 < b_min
        has_pp = par_has_pp | below
        ppn = torch.where(
            par_has_pp[:, None],
            par_ppn,
            torch.where(below[:, None], par_pca, 0.0),
        )
        # nearest >=3-point ancestor-or-self normal (mad_tree.cpp:68-73)
        n3 = torch.where((k >= 3.0)[:, None], pca_n, par_n3)
        if level == 0:  # the root has no ancestors to inherit from
            fallback = pca_n
        else:
            fallback = torch.where((k < 3.0)[:, None], par_n3, pca_n)
        normal = torch.where(has_pp[:, None], ppn, fallback)

        # ---- per-point: eigenbasis coordinates and oriented bbox ----
        packA = torch.cat(
            [mean, evecs.reshape(sz, 9), par_leaf.to(dtype)[:, None]], dim=1
        )  # (sz, 13)
        ptA = packA.index_select(0, torch.clamp(idx, max=sz - 1))
        mean_pt = ptA[:, 0:3]
        d2 = points - mean_pt
        v = (
            ptA[:, 3:6] * d2[:, 0:1]
            + ptA[:, 6:9] * d2[:, 1:2]
            + ptA[:, 9:12] * d2[:, 2:3]
        )  # E^T d2
        ext = torch.cat([v, -v], dim=1)  # (N, 6)
        node_ext = torch.full((sz + 1, 6), big, dtype=dtype, device=dev)
        node_ext.scatter_reduce_(0, idx[:, None].expand(N, 6), ext, "amin")
        vmin = node_ext[:sz, 0:3]
        vmax = -node_ext[:sz, 3:6]
        extents = torch.clamp(vmax, min=0.0) - torch.clamp(vmin, max=0.0)
        is_real_node = (k > 0) & ~par_leaf
        is_leaf_node = is_real_node & ((extents[:, 2] < b_max) | force_leaf)

        levels.append(
            dict(
                mean=mean,
                split=split_dir,
                normal=normal,
                bbox0=extents[:, 0],
                is_leaf=is_leaf_node,
                is_real=is_real_node,
            )
        )

        # ---- per-point updates: retire points whose parent was a leaf;
        # at the depth cap every surviving point freezes in place ----
        dead_pt = live & (ptA[:, 12] > 0)
        leaf_of = torch.where(dead_pt, node >> 1, leaf_of)
        frz_dist = torch.where(dead_pt, _norm(d), frz_dist)
        frozen = frozen | dead_pt
        if level < depth:
            go_right = v[:, 2] >= 0
            node = torch.where(live & ~dead_pt, 2 * node + go_right.long(), node)
            prev_mean_pt = torch.where(live[:, None], mean_pt, prev_mean_pt)
            prev_pack = torch.cat(
                [mean, pca_n, ppn, n3, extents[:, 0:1],
                 has_pp.to(dtype)[:, None], is_leaf_node.to(dtype)[:, None]],
                dim=1,
            )
        else:
            here = live & ~dead_pt
            leaf_of = torch.where(here, node, leaf_of)
            frz_dist = torch.where(here, _norm(d2), frz_dist)

    arena = {
        key: torch.cat(
            [torch.zeros((1,) + levels[0][key].shape[1:],
                         dtype=levels[0][key].dtype, device=dev)]
            + [lv[key] for lv in levels]
        )
        for key in levels[0]
    }
    point_leaf = torch.where(valid, leaf_of, 0)

    # ---- leaf representatives (mad_tree.cpp:76-86): the point nearest
    # the leaf mean, distances within a relative tie_tol of the minimum
    # resolving to the LOWEST ORIGINAL INDEX (the JAX package's rule, so
    # 2-point leaves pick the same representative in both) ----
    aid = torch.where(valid, leaf_of, M)
    dmin = torch.full((M + 1,), big, dtype=dtype, device=dev)
    dmin.scatter_reduce_(0, aid, frz_dist, "amin")
    tie_tol = 1e-9 if dtype == torch.float64 else 1e-4
    is_near = valid & (
        frz_dist <= dmin.index_select(0, torch.clamp(aid, max=M - 1)) * (1.0 + tie_tol)
    )
    near_pos = torch.full((M + 1,), big_i, dtype=torch.int64, device=dev)
    near_pos.scatter_reduce_(0, torch.where(is_near, aid, M), iota, "amin")
    near_pt = points.index_select(0, torch.clamp(near_pos[:M], max=N - 1))
    arena["repr"] = torch.where(arena["is_leaf"][:, None], near_pt, arena["mean"])

    return _pack_tree(arena, M, dtype), point_leaf


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

    ``ladder`` is accepted and ignored: the JAX package's select ladder
    is a TPU gather workaround pinned bitwise equal to this gather path.
    """
    del ladder
    Q = queries.shape[0]
    dev = queries.device
    known_levels = start is None
    if n_gathers is None:
        n_gathers = -(-depth // 3)
        if return_blocks and depth % 3 == 0:
            # the deepest leaf is then entered on a third substep, whose
            # block is not in the gathered row: one more gather fetches it
            n_gathers += 1
    if start is None:
        node = torch.ones((Q,), dtype=torch.int64, device=dev)
    else:
        node = torch.clamp(start.long(), min=1)
    if valid is not None:
        node = node * valid.long()
    base = torch.as_tensor(base, dtype=torch.int64, device=dev)

    blk = torch.zeros((Q, 8), dtype=nav.dtype, device=dev)
    margin = torch.full((Q,), torch.finfo(nav.dtype).max, dtype=nav.dtype, device=dev)
    for g in range(n_gathers):
        row = nav.index_select(0, base + node)  # (Q, 56)
        blk = row[:, 0:8]
        b1 = None
        for s in range(3):
            if known_levels and g * 3 + s >= depth:
                break  # below the depth cap nothing can step
            sval = torch.sum((queries - blk[:, 0:3]) * blk[:, 3:6], dim=-1)
            side = sval >= 0
            flags = blk[:, 7]
            kids = blk[:, 6]
            has = torch.where(side, kids >= 2.0, (kids == 1.0) | (kids == 3.0))
            # every real interior node evaluated is consequential
            consider = (flags >= 2.0) & (flags != 3.0)
            if return_margin:
                margin = torch.where(
                    consider, torch.minimum(margin, torch.abs(sval)), margin
                )
            step = consider & has
            node = torch.where(step, 2 * node + side.long(), node)
            if s == 0:
                child = torch.where(side[:, None], row[:, 16:24], row[:, 8:16])
                blk = torch.where(step[:, None], child, blk)
                b1 = side & step
            elif s == 1:
                lo = torch.where(side[:, None], row[:, 32:40], row[:, 24:32])
                hi = torch.where(side[:, None], row[:, 48:56], row[:, 40:48])
                blk = torch.where(step[:, None], torch.where(b1[:, None], hi, lo), blk)
    out = (node,)
    if return_blocks:
        out += (blk,)
    if return_margin:
        out += (margin,)
    return out if len(out) > 1 else node


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
    scatter into a spare row — no host sync."""
    nav = tree.nav
    flag = nav[:, 7] == 3.0
    pos = torch.cumsum(flag.long(), dim=0) - 1
    idx = torch.where(flag & (pos < max_leaves), pos, max_leaves)
    out = torch.zeros((max_leaves + 1, 8), dtype=nav.dtype, device=nav.device)
    out.index_copy_(0, idx, nav[:, 0:8])
    count = flag.sum()
    out = out[:max_leaves]
    return Leaves(
        pts=out[:, 0:3],
        normal=out[:, 3:6],
        bbox0=out[:, 6],
        valid=torch.arange(max_leaves, device=nav.device) < count,
        total=count,
    )


def count_leaves(tree: SearchTree) -> torch.Tensor:
    return torch.sum(tree.nav[..., 7] == 3.0)


def transform_tree(tree: SearchTree, R: torch.Tensor, t: torch.Tensor) -> SearchTree:
    """Rigidly move a tree into another frame (reference
    ``applyTransform``, ``mad_tree.cpp:165-172``). Every ``nav`` block is
    ``[position(3), direction(3), scalar(2)]``, so the table moves as one
    affine map per block: positions ``R p + t``, directions ``R n`` (every
    row, padding included, as in the JAX package's ``nav @ A + c``)."""
    nav = tree.nav
    blocks = nav.reshape(nav.shape[:-1] + (7, 8))
    Rt = R.to(nav.dtype).T
    pos = blocks[..., 0:3] @ Rt + t.to(nav.dtype)
    dirs = blocks[..., 3:6] @ Rt
    moved = torch.cat([pos, dirs, blocks[..., 6:8]], dim=-1)
    return SearchTree(nav=moved.reshape(nav.shape))
