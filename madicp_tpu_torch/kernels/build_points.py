"""The MAD-tree build's per-point pass and leaf pick (K8): CUDA kernels and
plain versions.

Per level (:func:`build_points`): every live point gathers its node's
pack (``packA``: mean, the 3x3 eigenbasis row-major, the parent-leaf
flag), forms ``d2 = p - mean`` and ``v = E^T d2``, min-reduces ``[v, -v]``
into its node's row of the level's extents table, and then retires (its
parent was a leaf: leaf ``node >> 1``, freeze distance ``|d|``), advances
(``v[2] >= 0`` goes right) or, at the depth cap, freezes in place (leaf
``node``, ``|d2|``). It returns the next level's int32 segment ids
(``2 idx + right``, :data:`DROP` elsewhere) and shifted deltas (``d2``
where the point advances; the other rows are unspecified, and the kernel
leaves them unwritten, since no later call reads them: the segment-sum
drops their ids and the next pass reads ``d`` only of points that retire,
which advanced a level before), which the moment segment-sum reads as
they are. After the levels, the leaf pick: :func:`pick_dmin`, the
least freeze distance of every leaf, then :func:`pick_near`, the lowest
point index within a relative ``tie_tol`` of it. It is the counterpart of
the JAX package's ``madicp_tpu/ops/tree.py:492-541, 561-592`` (per-point
pass) and ``:594-618`` (leaf pick), which XLA lowered: no Pallas kernel
stands behind them. The kernels live in ``csrc/build_points.cu`` (design
and bound in its header); :func:`plan` picks a level's path: the
contended levels near the root reduce into each block's shared table and
merge a thread-block cluster's tables through distributed shared memory,
the others issue their atomics to the global table, a warp's rows at a
time.

Minima are taken over order-preserving integer keys of the floats
(:func:`float_keys`: int32 for float32, int64 for float64) in both
versions, so they are exact and order-free, ``-0.0`` below ``+0.0``
included: the kernels' results equal the plain versions' bit for bit.
Each value is formed one operation at a time in the plain version's order
(``v`` as ``(e0 x + e1 y) + e2 z``, norms as ``sqrt((x x + y y) + z z)``).

Dispatch is by the tensors' device and nothing else: CPU tensors take
the plain versions, CUDA tensors take the kernels or the call raises.
Every table is allocated per call; the wrappers read nothing back to the
host and launch on the current stream, so they run inside CUDA graph
capture.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from madicp_tpu_torch.kernels import build

counter = build.LaunchCounter()
# the __global__ functions of csrc/build_points.cu, as a CUDA trace names them
KERNEL_NAMES = ("cluster_kernel", "stage_kernel", "pick_min_kernel", "pick_near_kernel")
DROP = -1  # the segment id of a point that is no longer live
PACK_COLS = 13  # packA: mean (3), E row-major (9), parent-leaf flag
EXT_COLS = 6  # the extents table: keys of min v (3) and of min -v (3)
TIE_TOL = {torch.float32: 1e-4, torch.float64: 1e-9}  # the leaf pick's near ties
NO_POINT = 2**31 - 1  # the pick's index table before any point
# levels where many points share a node reduce in shared memory first
CONTENDED_POINTS = 128  # points a node from which a level is contended
CLUSTER_SMEM = 48 * 1024  # a block's dynamic shared bytes without the opt-in
# nodes of the largest table the cluster path takes, in either dtype: a
# float64 table (6 int64 keys a node) of 1024 nodes fills CLUSTER_SMEM
CLUSTER_MAX_NODES = CLUSTER_SMEM // (6 * 8)
PATHS = ("cluster", "stage")  # csrc/build_points.cu's Path, in order
CLUSTER = 8  # blocks of a cluster (the portable size)
CLUSTER_THREADS = 512  # a block of the cluster path, a point a thread
THREADS = 256  # a block of the stage path and of the pick
_KEY = {torch.float32: torch.int32, torch.float64: torch.int64}
_MASK = {torch.int32: 0x7FFFFFFF, torch.int64: 0x7FFFFFFFFFFFFFFF}
_MAX_N = 2**30  # 2 idx + 1 and 6 n stay within a C int
_launch = build.Launcher("build_points", {  # the stream last
    "advance": [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + [ctypes.c_void_p],
    "pick_min": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p],
    "pick_near": ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_double]
                  + [ctypes.c_longlong] * 2 + [ctypes.c_void_p]),
}, counter)


class Plan(NamedTuple):
    """A level's launch: its path (:data:`PATHS`), its blocks (a point a
    thread), the blocks of a cluster and the dynamic shared bytes a
    block (the cluster path's table)."""

    path: str
    blocks: int
    cluster: int
    smem: int


def plan(n: int, nseg: int, dtype: torch.dtype, path: str | None = None) -> Plan:
    """The launch of a level of ``n`` points into ``nseg`` nodes: ``path``
    forced, or the cluster path where the level is contended (at most
    :data:`CLUSTER_MAX_NODES` nodes, at least :data:`CONTENDED_POINTS`
    points a node), else the stage path. Raises for a forced cluster path
    whose block table (``nseg`` rows of 6 keys) exceeds
    :data:`CLUSTER_SMEM`."""
    table = nseg * EXT_COLS * (torch.finfo(dtype).bits // 8)  # keys have the floats' width
    if path is None:
        contended = nseg <= CLUSTER_MAX_NODES and n >= CONTENDED_POINTS * nseg
        path = "cluster" if contended else "stage"
    if path == "cluster":
        if table > CLUSTER_SMEM:
            raise ValueError(f"build_points: a table of {nseg} nodes takes {table} shared "
                             f"bytes, more than {CLUSTER_SMEM}")
        blocks = -(-max(n, 1) // CLUSTER_THREADS)
        return Plan(path, -(-blocks // CLUSTER) * CLUSTER, CLUSTER, table)
    if path not in PATHS:
        raise ValueError(f"build_points: unknown path {path!r}, want one of {PATHS}")
    return Plan(path, max(1, -(-n // THREADS)), 1, 0)


def key_dtype(dtype: torch.dtype) -> torch.dtype:
    """The integer type of the keys of ``dtype``."""
    return _KEY[dtype]


def float_keys(x: torch.Tensor) -> torch.Tensor:
    """Order-preserving integer keys of float32/float64 values: the bits
    where the sign bit is clear, the bits with the other bits flipped where
    it is set, as signed integers (``-0.0`` keys below ``+0.0``)."""
    bits = x.view(_KEY[x.dtype])
    return torch.where(bits >= 0, bits, bits ^ _MASK[bits.dtype])


def keys_to_float(k: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The floats of :func:`float_keys` (its own inverse on the bits)."""
    return torch.where(k >= 0, k, k ^ _MASK[k.dtype]).view(dtype)


def big_key(dtype: torch.dtype) -> int:
    """The key of the dtype's largest finite value: every table's start."""
    return int(torch.tensor(torch.finfo(dtype).max, dtype=dtype).view(_KEY[dtype]))


def _norm3(v) -> torch.Tensor:
    """``sqrt((x x + y y) + z z)`` over a 3-tuple of tensors."""
    return torch.sqrt((v[0] * v[0] + v[1] * v[1]) + v[2] * v[2])


def build_points_plain(points, d, idx, leaf_of, frz_dist, packA, ext, *, level, depth):
    """Plain version of one level's point pass (arguments and results as
    :func:`build_points`)."""
    nseg, sz = packA.shape[0], 1 << level
    live = (idx >= 0) & (idx < nseg)
    g = torch.where(live, idx, 0).long()
    ptA = packA.index_select(0, g)
    d2 = tuple(points[:, c] - ptA[:, c] for c in range(3))
    v = tuple((ptA[:, 3 + c] * d2[0] + ptA[:, 6 + c] * d2[1]) + ptA[:, 9 + c] * d2[2]
              for c in range(3))
    keys = float_keys(torch.stack(v + tuple(-x for x in v), dim=1))
    tab = torch.cat([ext, ext.new_full((1, EXT_COLS), big_key(points.dtype))])
    tab.scatter_reduce_(0, torch.where(live, g, nseg)[:, None].expand(-1, EXT_COLS),
                        keys, "amin")
    ext.copy_(tab[:nseg])

    dead = live & (ptA[:, 12] > 0)
    stay = live & ~dead
    node = sz + (g & (sz - 1))
    leaf_of.copy_(torch.where(dead, node >> 1, leaf_of))
    frz_dist.copy_(torch.where(dead, _norm3(tuple(d[:, c] for c in range(3))), frz_dist))
    d_next = torch.stack(d2, dim=1)  # read where the point advances, nowhere else
    if level < depth:
        right = (v[2] >= 0).to(idx.dtype)
        return d_next, torch.where(stay, 2 * idx + right, DROP)
    leaf_of.copy_(torch.where(stay, node, leaf_of))
    frz_dist.copy_(torch.where(stay, _norm3(d2), frz_dist))
    return d_next, torch.full_like(idx, DROP)


def _aid(valid, leaf_of, M):
    """Each point's leaf as a row of the batch's ``B M`` arena rows
    (``B M`` for padding)."""
    B, N = valid.shape
    seq = torch.arange(B, device=valid.device)[:, None]
    return torch.where(valid, leaf_of + seq * M, B * M).reshape(B * N)


def pick_dmin_plain(valid, leaf_of, frz_dist, M):
    """Plain version of :func:`pick_dmin`."""
    B = valid.shape[0]
    tab = torch.full((B * M + 1,), big_key(frz_dist.dtype), dtype=_KEY[frz_dist.dtype],
                     device=valid.device)
    tab.scatter_reduce_(0, _aid(valid, leaf_of, M), float_keys(frz_dist.reshape(-1)), "amin")
    return tab[: B * M]


def pick_near_plain(valid, leaf_of, frz_dist, dmin, M, n_total, offset):
    """Plain version of :func:`pick_near`."""
    B, N = valid.shape
    BM, dtype, dev = B * M, frz_dist.dtype, valid.device
    aid = _aid(valid, leaf_of, M)
    least = keys_to_float(dmin, dtype).index_select(0, torch.clamp(aid, max=BM - 1))
    near = valid.reshape(-1) & (frz_dist.reshape(-1) <= least * (1.0 + TIE_TOL[dtype]))
    iota = (torch.arange(N, device=dev)[None]
            + (torch.arange(B, device=dev) * n_total + offset)[:, None]).reshape(-1)
    pos = torch.full((BM + 1,), NO_POINT, dtype=torch.int64, device=dev)
    pos.scatter_reduce_(0, torch.where(near, aid, BM), iota, "amin")
    return pos[:BM]


def _device(what: str, *tensors) -> torch.device:
    dev = tensors[0].device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {dev}")
    if any(t.device != dev for t in tensors):
        raise ValueError(f"{what}: tensors on different devices")
    return dev


def _check_contiguous(what: str, *tensors) -> None:
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{what}: every tensor must be contiguous")


def _check_float(what: str, ref: torch.Tensor, **tensors) -> None:
    if ref.dtype not in _KEY:
        raise TypeError(f"{what}: want float32/float64, got {ref.dtype}")
    for name, t in tensors.items():
        if t.dtype != ref.dtype:
            raise TypeError(f"{what}: {name} is {t.dtype}, want {ref.dtype}")


def build_points(points, d, idx, leaf_of, frz_dist, packA, ext, *, level, depth):
    """One level's point pass over ``n`` points into ``nseg`` nodes.

    Args:
        points: (n, 3) the build's points (a batch folded in).
        d: (n, 3) each point's shift by its parent's mean (the segment-sum's
            input of this level).
        idx: (n,) int32 segment ids of this level, :data:`DROP` (or any
            id outside ``[0, nseg)``) for points no longer live.
        leaf_of: (n,) int64, updated in place: the arena id of the leaf a
            point froze in.
        frz_dist: (n,), updated in place: its distance to that leaf's mean.
        packA: (nseg, 13) the level's node pack (:mod:`build_nodes`).
        ext: (nseg, 6) keys of the level's extents, min-reduced in place.
        level, depth: this level and the depth cap.

    Returns:
        ``(d_next, idx_next)``: the next level's shifted deltas and ids;
        a row of ``d_next`` is defined only where ``idx_next`` is not
        :data:`DROP`.
    """
    what = "build_points"
    dev = _device(what, points, d, idx, leaf_of, frz_dist, packA, ext)
    _check_float(what, points, d=d, frz_dist=frz_dist, packA=packA)
    if idx.dtype != torch.int32 or leaf_of.dtype != torch.int64:
        raise TypeError(f"{what}: want idx int32 and leaf_of int64, got {idx.dtype} and "
                        f"{leaf_of.dtype}")
    if ext.dtype != _KEY[points.dtype]:
        raise TypeError(f"{what}: ext holds {_KEY[points.dtype]} keys, got {ext.dtype}")
    n = points.shape[0]
    if (points.dim() != 2 or points.shape[1] != 3 or d.shape != points.shape
            or idx.shape != (n,) or leaf_of.shape != (n,) or frz_dist.shape != (n,)
            or packA.dim() != 2 or packA.shape[1] != PACK_COLS
            or ext.shape != (packA.shape[0], EXT_COLS)):
        raise ValueError(
            f"{what}: want points and d (n, 3), idx, leaf_of and frz_dist (n,), packA "
            f"(nseg, {PACK_COLS}) and ext (nseg, {EXT_COLS}), got {tuple(points.shape)}, "
            f"{tuple(d.shape)}, {tuple(idx.shape)}, {tuple(leaf_of.shape)}, "
            f"{tuple(frz_dist.shape)}, {tuple(packA.shape)}, {tuple(ext.shape)}")
    if not 0 <= level <= depth:
        raise ValueError(f"{what}: need 0 <= level <= depth, got {level} and {depth}")
    if dev.type == "cpu":
        return build_points_plain(points, d, idx, leaf_of, frz_dist, packA, ext,
                                  level=level, depth=depth)
    _check_contiguous(what, points, d, idx, leaf_of, frz_dist, packA, ext)
    nseg = packA.shape[0]
    if not (n <= _MAX_N and 1 <= nseg <= _MAX_N):
        raise ValueError(f"{what}: need n <= {_MAX_N} and 1 <= nseg <= {_MAX_N}, got "
                         f"{n} and {nseg}")
    return launch(points, d, idx, leaf_of, frz_dist, packA, ext, level=level, depth=depth,
                  pl=plan(n, nseg, points.dtype))


def launch(points, d, idx, leaf_of, frz_dist, packA, ext, *, level, depth, pl: Plan):
    """Run the level pass on checked CUDA tensors as ``pl`` says (results
    as :func:`build_points`); one count."""
    d_next, idx_next = torch.empty_like(d), torch.empty_like(idx)
    n = points.shape[0]
    if n == 0:
        return d_next, idx_next
    _launch("advance", points.dtype, points.device, points.data_ptr(), d.data_ptr(),
            idx.data_ptr(), packA.data_ptr(), ext.data_ptr(), leaf_of.data_ptr(),
            frz_dist.data_ptr(), d_next.data_ptr(), idx_next.data_ptr(), n, packA.shape[0],
            1 << level, int(level == depth), PATHS.index(pl.path), pl.blocks, pl.cluster,
            pl.smem)
    return d_next, idx_next


def _check_pick(what, valid, leaf_of, frz_dist, M) -> torch.device:
    dev = _device(what, valid, leaf_of, frz_dist)
    _check_float(what, frz_dist)
    if valid.dtype != torch.bool or leaf_of.dtype != torch.int64:
        raise TypeError(f"{what}: want valid bool and leaf_of int64, got {valid.dtype} and "
                        f"{leaf_of.dtype}")
    if valid.dim() != 2 or leaf_of.shape != valid.shape or frz_dist.shape != valid.shape:
        raise ValueError(f"{what}: want valid, leaf_of and frz_dist (B, N), got "
                         f"{tuple(valid.shape)}, {tuple(leaf_of.shape)}, "
                         f"{tuple(frz_dist.shape)}")
    if M < 2 or M & (M - 1) or valid.numel() > _MAX_N or valid.shape[0] * M > _MAX_N:
        raise ValueError(f"{what}: need an arena of 2^k >= 2 rows and B N, B M <= {_MAX_N}, "
                         f"got M={M} for {tuple(valid.shape)}")
    return dev


def pick_dmin(valid, leaf_of, frz_dist, M):
    """Keys ``(B M,)`` of each leaf's least freeze distance over the valid
    points that froze in it (``big_key`` where none did): ``valid``,
    ``leaf_of`` and ``frz_dist`` are ``(B, N)``, leaf ``a`` of cloud ``b``
    is row ``b M + a``."""
    dev = _check_pick("pick_dmin", valid, leaf_of, frz_dist, M)
    if dev.type == "cpu":
        return pick_dmin_plain(valid, leaf_of, frz_dist, M)
    _check_contiguous("pick_dmin", valid, leaf_of, frz_dist)
    B, N = valid.shape
    dtype = frz_dist.dtype
    tab = torch.full((B * M,), big_key(dtype), dtype=_KEY[dtype], device=dev)
    if B * N:
        _launch("pick_min", dtype, dev, valid.data_ptr(), leaf_of.data_ptr(),
                frz_dist.data_ptr(), tab.data_ptr(), B * N, N, M)
    return tab


def pick_near(valid, leaf_of, frz_dist, dmin, M, n_total, offset):
    """``(B M,)`` int64: per leaf, the lowest index among its valid points
    whose freeze distance is at most its least one (``dmin``, keys of
    :func:`pick_dmin`) times ``1 + tie_tol`` (rounded to the dtype, as
    torch rounds it); :data:`NO_POINT` where none. A point's index is
    ``b n_total + offset + n``: its place in its whole cloud when this
    process holds points ``[offset, offset + N)`` of clouds of
    ``n_total``."""
    dev = _check_pick("pick_near", valid, leaf_of, frz_dist, M)
    B, N = valid.shape
    dtype = frz_dist.dtype
    if dmin.device != dev or dmin.dtype != _KEY[dtype] or dmin.shape != (B * M,):
        raise ValueError(f"pick_near: want dmin ({B * M},) {_KEY[dtype]} keys on {dev}, got "
                         f"{tuple(dmin.shape)} {dmin.dtype} on {dmin.device}")
    if dev.type == "cpu":
        return pick_near_plain(valid, leaf_of, frz_dist, dmin, M, n_total, offset)
    _check_contiguous("pick_near", valid, leaf_of, frz_dist, dmin)
    pos = torch.full((B * M,), NO_POINT, dtype=torch.int64, device=dev)
    if B * N:
        _launch("pick_near", dtype, dev, valid.data_ptr(), leaf_of.data_ptr(),
                frz_dist.data_ptr(), dmin.data_ptr(), pos.data_ptr(), B * N, N, M,
                1.0 + TIE_TOL[dtype], n_total, offset)
    return pos
