"""The MAD-tree build's node math (K9): CUDA kernel and plain version.

Per level (:func:`build_nodes`), for every node of the ``B 2^l`` of the
level (a batch folded into the segment axis): from its ``(10,)`` moments
(the segment-sum's row: shifted sums, outer products, count) and its
parent's fields, the mean, the Bessel-corrected covariance, the closed-form
eigenbasis (:func:`madicp_tpu_torch.ops.eigh3.eigh3_parts`, degenerate
fallbacks included), the plane predecessor, the >= 3-point normal and
``is_real``; written into the level's rows ``[2^l, 2^{l+1})`` of the
``(B, M, 12)`` arena, and handed on as ``packA`` (the point pass's gather)
and ``state``. The same launch closes level ``l - 1``: each parent's
extents from the keys the point pass reduced, its ``bbox0`` and leaf
decision into the arena. :func:`close_level` closes the last level. It is
the counterpart of the JAX package's ``madicp_tpu/ops/tree.py:457-490``
(node math), ``madicp_tpu/ops/eigh3.py:61`` ``eigh3`` and the level close
``:542-559, 575-579``, which XLA lowered: no Pallas kernel stands behind
them. The kernel lives in ``csrc/build_nodes.cu`` (design and bound in its
header); the plain versions are the same math in tensor ops, one operation
at a time in one order, so the kernel equals them bit for bit on the card.

Arena columns: mean (3), split (3), normal (3), bbox0, is_leaf, is_real
(flags as 1.0 / 0.0); row 0 of each cloud is zeros. ``packA``: mean (3),
the eigenbasis row-major (9; column 0 the PCA normal, column 2 the split
direction), the parent-leaf flag. ``state``: plane-predecessor normal (3),
>= 3-point normal (3), has-predecessor and is_real flags.

Dispatch is by the tensors' device and nothing else: CPU tensors take
the plain version, CUDA tensors take the kernel or the call raises. The
wrapper allocates its outputs per call, reads nothing back to the host
and launches on the current stream, so it runs inside CUDA graph capture.
"""

from __future__ import annotations

import ctypes

import torch

from madicp_tpu_torch.kernels import build
from madicp_tpu_torch.kernels.build_points import (
    EXT_COLS, PACK_COLS, big_key, key_dtype, keys_to_float)
from madicp_tpu_torch.ops.eigh3 import (
    SIXTH, THIRD, TWO_PI_THIRDS, eigh3_parts, tolerances)

counter = build.LaunchCounter()
MOM_COLS = 10
STATE_COLS = 8
ARENA_COLS = 12
THREADS = 128
_MAX_NODES = 2**30
_launch = build.Launcher("build_nodes", {  # the stream last
    "nodes": [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_double] * 7
    + [ctypes.c_void_p],
    "close": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
}, counter)


def _extents(ext: torch.Tensor, dtype) -> torch.Tensor:
    """(nseg, 3) oriented extents from a level's extents keys: the span
    ``max(vmax, 0) - min(vmin, 0)``, so the node's origin is inside."""
    e = keys_to_float(ext, dtype)
    vmin, vmax = e[:, 0:3], -e[:, 3:6]
    return torch.where(vmax > 0, vmax, 0.0) - torch.where(vmin < 0, vmin, 0.0)


def close_level_plain(state, ext, arena, *, level, b_max=None):
    """Plain version of :func:`close_level` (``b_max`` None), and the close
    of a level above the cap (a real node is a leaf when its largest
    extent is below ``b_max``); returns the level's ``(bbox0, is_leaf)``."""
    B, sz = arena.shape[0], 1 << level
    extents = _extents(ext, arena.dtype)
    is_leaf = state[:, 7] > 0
    if b_max is not None:
        is_leaf = is_leaf & (extents[:, 2] < b_max)
    rows = arena[:, sz:2 * sz]
    rows[..., 9] = extents[:, 0].view(B, sz)
    rows[..., 10] = is_leaf.to(arena.dtype).view(B, sz)
    return extents[:, 0], is_leaf


def build_nodes_plain(mom, prev, arena, *, level, b_max, b_min):
    """Plain version of :func:`build_nodes`."""
    dtype, dev = mom.dtype, mom.device
    B, sz = arena.shape[0], 1 << level
    nseg = B * sz
    if prev is None:  # the root's sentinel parent: shift 0, no pp, no n3
        zero = torch.zeros(nseg, dtype=dtype, device=dev)
        par_mean = par_pca = par_ppn = par_n3 = (zero, zero, zero)
        par_bbox0 = torch.full((nseg,), torch.finfo(dtype).max, dtype=dtype, device=dev)
        par_has_pp = par_leaf = torch.zeros(nseg, dtype=torch.bool, device=dev)
        arena[:, 0] = 0.0
    else:
        pack_p, state_p, ext_p = prev
        bbox0_p, leaf_p = close_level_plain(state_p, ext_p, arena, level=level - 1,
                                            b_max=b_max)

        def rep(t):
            return t.repeat_interleave(2, dim=0)

        par_mean = tuple(rep(pack_p[:, c]) for c in range(3))
        par_pca = tuple(rep(pack_p[:, 3 + 3 * c]) for c in range(3))
        par_ppn = tuple(rep(state_p[:, c]) for c in range(3))
        par_n3 = tuple(rep(state_p[:, 3 + c]) for c in range(3))
        par_bbox0, par_has_pp, par_leaf = rep(bbox0_p), rep(state_p[:, 6] > 0), rep(leaf_p)

    k = mom[:, 9]
    k_safe = torch.clamp(k, min=1.0)
    shift = tuple(mom[:, c] / k_safe for c in range(3))
    mean = tuple(par_mean[c] + shift[c] for c in range(3))
    outer = tuple(shift[i] * shift[j] for i, j in ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2),
                                                   (2, 2)))
    bessel = k / torch.clamp(k - 1.0, min=1.0)
    many = k >= 2.0
    xx, xy, xz, yy, yz, zz = (torch.where(many, (mom[:, 3 + j] / k_safe - outer[j]) * bessel,
                                          0.0) for j in range(6))
    _, (v0, v1, v2), _ = eigh3_parts(((xx, xy, xz), (xy, yy, yz), (xz, yz, zz)))

    # plane predecessor (mad_tree.cpp:65-67, 90-93)
    below = par_bbox0 < b_min
    has_pp = par_has_pp | below
    ppn = tuple(torch.where(par_has_pp, par_ppn[c], torch.where(below, par_pca[c], 0.0))
                for c in range(3))
    # nearest >=3-point ancestor-or-self normal (mad_tree.cpp:68-73)
    n3 = tuple(torch.where(k >= 3.0, v0[c], par_n3[c]) for c in range(3))
    if level == 0:  # the root has no ancestors to inherit from
        fallback = v0
    else:
        fallback = tuple(torch.where(k < 3.0, par_n3[c], v0[c]) for c in range(3))
    normal = tuple(torch.where(has_pp, ppn[c], fallback[c]) for c in range(3))
    is_real = (k > 0) & ~par_leaf

    packA = torch.stack(mean + tuple(v[r] for r in range(3) for v in (v0, v1, v2))
                        + (par_leaf.to(dtype),), dim=1)
    state = torch.stack(ppn + n3 + (has_pp.to(dtype), is_real.to(dtype)), dim=1)
    rows = arena[:, sz:2 * sz]
    rows[..., 0:9] = torch.stack(mean + v2 + normal, dim=1).view(B, sz, 9)
    rows[..., 11] = is_real.to(dtype).view(B, sz)
    ext = torch.full((nseg, EXT_COLS), big_key(dtype), dtype=key_dtype(dtype), device=dev)
    return packA, state, ext


def _check_level(what, arena, level, tensors: dict, rows: dict) -> None:
    """Raise on what neither version takes (every device)."""
    dev = arena.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {dev}")
    if any(t.device != dev for t in tensors.values()):
        raise ValueError(f"{what}: tensors on different devices")
    if arena.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{what}: want float32/float64, got {arena.dtype}")
    if arena.dim() != 3 or arena.shape[2] != ARENA_COLS:
        raise ValueError(f"{what}: want arena (B, M, {ARENA_COLS}), got {tuple(arena.shape)}")
    B, M = arena.shape[:2]
    if not 0 <= level or (2 << level) > M or B * M > _MAX_NODES:
        raise ValueError(f"{what}: level {level} has no rows in an arena of {M}")
    for name, t in tensors.items():
        want = key_dtype(arena.dtype) if name.startswith("ext") else arena.dtype
        if t.dtype != want:
            raise TypeError(f"{what}: {name} is {t.dtype}, want {want}")
        shape = (B << rows[name][0], rows[name][1])
        if tuple(t.shape) != shape:
            raise ValueError(f"{what}: want {name} {shape}, got {tuple(t.shape)}")


def build_nodes(mom, prev, arena, *, level, b_max, b_min):
    """Node math of ``level``, and the close of ``level - 1``.

    Args:
        mom: (B 2^level, 10) the level's moment table (segment-sum).
        prev: None at level 0, else the previous level's
            ``(packA, state, ext)``, ``ext`` the keys its point pass
            reduced (min over the processes of a points-split build).
        arena: (B, M, 12), written in place: this level's rows but their
            bbox0 and is_leaf, those of the previous level's rows, and
            at level 0 row 0.
        level: the level; ``b_max`` the leaf criterion on the largest
            extent, ``b_min`` the plane-predecessor criterion on the
            smallest.

    Returns:
        ``(packA (B 2^level, 13), state (B 2^level, 8), ext (B 2^level, 6))``
        with ``ext`` every entry the key of the dtype's largest value, for
        the point pass to min-reduce.
    """
    what = "build_nodes"
    tensors, rows = {"mom": mom}, {"mom": (level, MOM_COLS)}
    if prev is not None:
        tensors.update(zip(("pack_prev", "state_prev", "ext_prev"), prev))
        rows.update(pack_prev=(level - 1, PACK_COLS), state_prev=(level - 1, STATE_COLS),
                    ext_prev=(level - 1, EXT_COLS))
    elif level:
        raise ValueError(f"{what}: level {level} needs the previous level's tables")
    _check_level(what, arena, level, tensors, rows)
    if arena.device.type == "cpu":
        return build_nodes_plain(mom, prev, arena, level=level, b_max=b_max, b_min=b_min)
    if not all(t.is_contiguous() for t in (arena, *tensors.values())):
        raise ValueError(f"{what}: every tensor must be contiguous")
    dtype, dev = arena.dtype, arena.device
    B, M = arena.shape[:2]
    nseg = B << level
    packA = torch.empty((nseg, PACK_COLS), dtype=dtype, device=dev)
    state = torch.empty((nseg, STATE_COLS), dtype=dtype, device=dev)
    ext = torch.empty((nseg, EXT_COLS), dtype=key_dtype(dtype), device=dev)
    prev_ptrs = [0, 0, 0] if prev is None else [t.data_ptr() for t in prev]
    eps, tol_c = tolerances(dtype)
    _launch("nodes", dtype, dev, mom.data_ptr(), *prev_ptrs, arena.data_ptr(),
            packA.data_ptr(), state.data_ptr(), ext.data_ptr(), nseg, 1 << level, M,
            -(-nseg // THREADS), float(b_max), float(b_min), eps, tol_c, THIRD, SIXTH,
            TWO_PI_THIRDS)
    return packA, state, ext


def close_level(state, ext, arena, *, level):
    """Close the last level (the depth cap, where every real node is a
    leaf): its rows' bbox0 and is_leaf, from ``state`` and the extents
    keys ``ext`` of its point pass, into ``arena`` in place."""
    what = "close_level"
    _check_level(what, arena, level, {"state": state, "ext": ext},
                 {"state": (level, STATE_COLS), "ext": (level, EXT_COLS)})
    if arena.device.type == "cpu":
        close_level_plain(state, ext, arena, level=level)
        return
    if not all(t.is_contiguous() for t in (arena, state, ext)):
        raise ValueError(f"{what}: every tensor must be contiguous")
    B, M = arena.shape[:2]
    nseg = B << level
    _launch("close", arena.dtype, arena.device, state.data_ptr(), ext.data_ptr(),
            arena.data_ptr(), nseg, 1 << level, M, -(-nseg // THREADS))
