"""Descent of the MAD-tree forest (K6): CUDA kernel and plain version.

For each query, a no-backtracking descent in a flat ``(R, 56)`` ``nav``
table at rows ``base + node``: the LOCAL node id it ends on, optionally
its final 8-value block and its path margin (the least |distance to a
split plane| over every real interior node evaluated). It is the body of
:func:`madicp_tpu_torch.ops.tree.search_forest`, the counterpart of the
JAX package's ``madicp_tpu/ops/tree.py:685`` ``search_forest`` (gather
path). The kernel lives in ``csrc/descent.cu`` (design and bound in its
header); :func:`descend_plain` is the same loop in tensor ops, and both
form the side value in one order, ``(p0 + p1) + p2`` over ``p = (q - c)
* n``, so their ids, blocks and margins agree bit for bit on the card.

:func:`descend_ring` is the same descent over a ring of trees, the form
the step launches (:func:`madicp_tpu_torch.ops.icp_core.associate_ring`):
each sequence's queries, in the scan frame, serve its keyframes' trees
where they lie, each entry mapping its query by its sequence's pose
``X`` in K7's order (:func:`~madicp_tpu_torch.kernels.icp_terms.moving_in_map`,
so the descent and the terms' gate see one point), and with ``out`` only
the ``need`` entries are descended and written into the previous round's
results in place, which is the certified schedule's merge (the JAX
package's ``madicp_tpu/models/pipeline.py:569`` ``reassociate``);
:func:`descend_ring_plain` is ``moving_in_map`` and the flat plain
descent, followed by that merge's ``torch.where``s.

Dispatch is by the tensors' device and nothing else: CPU tensors take
the plain version, CUDA tensors take the kernel or the call raises. The
kernel allocates nothing but its outputs, reads nothing back to the host
and launches on the current stream, so it runs inside CUDA graph capture.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from madicp_tpu_torch.kernels import build
from madicp_tpu_torch.kernels.icp_terms import moving_in_map

counter = build.LaunchCounter()
# the __global__ functions of csrc/descent.cu, as a CUDA trace names them
KERNEL_NAMES = ("descend_kernel", "descend_merge_kernel")
_launch = build.Launcher("descent", {  # the stream last
    "descend": ([ctypes.c_void_p] * 2 + [ctypes.c_longlong] * 3 + [ctypes.c_void_p]
                + [ctypes.c_longlong] + [ctypes.c_void_p] * 2
                + [ctypes.c_longlong] + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 3
                + [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int] + [ctypes.c_void_p] * 4),
}, counter)
THREADS = 256  # a block of csrc/descent.cu
_MAX_QUERIES = 2**31 - 1


def default_gathers(depth: int, return_blocks: bool) -> int:
    """Row reads of a descent from the root: ``ceil(depth / 3)``, plus one
    when the blocks are wanted and ``depth % 3 == 0`` (the deepest leaf is
    then entered on a third substep, whose block is not in the row)."""
    n = -(-depth // 3)
    if return_blocks and depth % 3 == 0:
        n += 1
    return n


def descend_plain(nav, queries, base, depth, valid=None, start=None, n_gathers=None,
                  return_blocks=False, return_margin=False):
    """Plain version: the descent as tensor ops, a whole 56-value row
    gathered a round for every query (parked ones included)."""
    Q = queries.shape[0]
    dev = queries.device
    known_levels = start is None
    if n_gathers is None:
        n_gathers = default_gathers(depth, return_blocks)
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
            # the kernel's order: (p0 + p1) + p2
            p = (queries - blk[:, 0:3]) * blk[:, 3:6]
            sval = (p[:, 0] + p[:, 1]) + p[:, 2]
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


def panel_reads(nav, queries, base, depth, valid=None, start=None, n_gathers=None,
                return_blocks=False):
    """The kernel's loop in tensor ops: ``(node, blk, margin, keys)``, the
    descent's results (as :func:`descend_plain` with blocks and margins)
    and the flat keys ``row * 7 + panel`` of every panel the kernel reads,
    in read order. A query reads panel 0 of a row, then the child and
    grandchild panels its steps pick, and stops after the first row in
    which it takes no step. The keys give the bound's bytes (the distinct
    panels) and the kernel's reads; the results show that the stop keeps
    the plain version's, bit for bit."""
    Q = queries.shape[0]
    dev = queries.device
    known_levels = start is None
    if n_gathers is None:
        n_gathers = default_gathers(depth, return_blocks)
    node = (torch.ones((Q,), dtype=torch.int64, device=dev) if start is None
            else torch.clamp(start.long(), min=1))
    if valid is not None:
        node = node * valid.long()
    base = torch.as_tensor(base, dtype=torch.int64, device=dev)
    blk = torch.zeros((Q, 8), dtype=nav.dtype, device=dev)
    margin = torch.full((Q,), torch.finfo(nav.dtype).max, dtype=nav.dtype, device=dev)
    active = torch.ones((Q,), dtype=torch.bool, device=dev)
    keys = []
    for g in range(n_gathers):
        rows = base + node
        keys.append((rows * 7)[active])
        row = nav.index_select(0, rows)
        blk = torch.where(active[:, None], row[:, 0:8], blk)
        live, b1 = active, None
        for s in range(3):
            if known_levels and g * 3 + s >= depth:
                break
            p = (queries - blk[:, 0:3]) * blk[:, 3:6]
            sval = (p[:, 0] + p[:, 1]) + p[:, 2]
            side = sval >= 0
            kids, flags = blk[:, 6], blk[:, 7]
            has = torch.where(side, kids >= 2.0, (kids == 1.0) | (kids == 3.0))
            consider = (flags >= 2.0) & (flags != 3.0)
            margin = torch.where(live & consider, torch.minimum(margin, torch.abs(sval)),
                                 margin)
            step = live & consider & has
            node = torch.where(step, 2 * node + side.long(), node)
            if s == 0:
                panel = 1 + side.long()
                blk = torch.where(step[:, None],
                                  torch.where(side[:, None], row[:, 16:24], row[:, 8:16]), blk)
                b1, moved = side, step
            elif s == 1:
                panel = 3 + 2 * b1.long() + side.long()
                lo = torch.where(side[:, None], row[:, 32:40], row[:, 24:32])
                hi = torch.where(side[:, None], row[:, 48:56], row[:, 40:48])
                blk = torch.where(step[:, None], torch.where(b1[:, None], hi, lo), blk)
            if s < 2:
                keys.append((rows * 7 + panel)[step])
            live = step
        active = active & moved if b1 is not None else torch.zeros_like(active)
    keys = torch.cat(keys) if keys else torch.zeros((0,), dtype=torch.int64, device=dev)
    return node, blk, margin, keys


def _check(nav, queries, base, depth, valid, start, n_gathers) -> None:
    """Raise on what neither version takes (every device)."""
    dev = queries.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"descend: unsupported device {dev}")
    if nav.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"descend: nav must be float32/float64, got {nav.dtype}")
    if queries.dtype != nav.dtype:
        raise TypeError(f"descend: queries are {queries.dtype}, nav {nav.dtype}")
    if nav.dim() != 2 or nav.shape[1] != 56 or queries.dim() != 2 or queries.shape[1] != 3:
        raise ValueError(f"descend: want nav (R, 56) and queries (Q, 3), got "
                         f"{tuple(nav.shape)} and {tuple(queries.shape)}")
    if nav.device != dev:
        raise ValueError("descend: nav and queries on different devices")
    Q = queries.shape[0]
    for name, t in (("base", base), ("valid", valid), ("start", start)):
        if not isinstance(t, torch.Tensor):
            continue
        if t.device != dev:
            raise ValueError(f"descend: queries and {name} on different devices")
        if t.shape != (Q,):
            raise ValueError(f"descend: {name} must be (Q,) = ({Q},), got {tuple(t.shape)}")
        if name == "valid" and t.dtype != torch.bool:
            raise TypeError(f"descend: valid must be bool, got {t.dtype}")
        if name != "valid" and (t.is_floating_point() or t.dtype == torch.bool):
            raise TypeError(f"descend: {name} must be an integer tensor, got {t.dtype}")
    if depth < 0 or (n_gathers is not None and n_gathers < 0):
        raise ValueError(f"descend: need depth >= 0 and n_gathers >= 0, got {depth}, "
                         f"{n_gathers}")


def _run(nav, queries, depth, n_gathers, known_levels, node, blk, margin, *, base=0,
         valid=None, start=None, ring=(0, 1, 0), pose=None, pose_k=1, merge=False) -> None:
    """Launch the kernel over ``node.numel()`` entries (arguments as the C
    interface of ``csrc/descent.cu`` takes them; the queries (Q, 3) or
    (G, Q, 3) are read through their strides, no copy)."""
    n = node.numel()
    if n > _MAX_QUERIES:
        raise ValueError(f"descend: at most {_MAX_QUERIES} entries, got {n}")
    if isinstance(base, torch.Tensor):
        base_t, base0 = base.to(torch.int64).contiguous(), 0
    else:
        base_t, base0 = None, int(base)
    # 16-byte vectors where the table's rows (224 or 448 bytes) and the
    # blocks out start on 16-byte boundaries
    vec = nav.data_ptr() % 16 == 0 and (blk is None or blk.data_ptr() % 16 == 0)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    q_group = queries.stride(0) if queries.dim() == 3 else 0
    _launch("descend", nav.dtype, nav.device, nav.data_ptr(), queries.data_ptr(), q_group,
            queries.stride(-2), queries.stride(-1), ptr(base_t), base0, ptr(valid), ptr(start),
            n, depth, n_gathers, int(known_levels), int(vec), *ring, ptr(pose), pose_k,
            int(merge), node.data_ptr(), ptr(blk), ptr(margin))


def descend(nav, queries, base, depth, valid=None, start=None,
            n_gathers: Optional[int] = None, return_blocks: bool = False,
            return_margin: bool = False):
    """The descent of :func:`madicp_tpu_torch.ops.tree.search_forest`
    (same arguments and results): the plain version for CPU tensors, the
    kernel for CUDA ones."""
    _check(nav, queries, base, depth, valid, start, n_gathers)
    if queries.device.type == "cpu":
        return descend_plain(nav, queries, base, depth, valid, start, n_gathers,
                             return_blocks, return_margin)
    if not nav.is_contiguous():
        raise ValueError("descend: nav must be contiguous (the kernel reads its rows)")
    Q = queries.shape[0]
    dev = queries.device
    known_levels = start is None
    if n_gathers is None:
        n_gathers = default_gathers(depth, return_blocks)
    node = torch.empty((Q,), dtype=torch.int64, device=dev)
    blk = torch.empty((Q, 8), dtype=nav.dtype, device=dev) if return_blocks else None
    margin = torch.empty((Q,), dtype=nav.dtype, device=dev) if return_margin else None
    _run(nav, queries, depth, n_gathers, known_levels, node, blk, margin,
         base=base, valid=None if valid is None else valid.contiguous(),
         start=None if start is None else start.to(torch.int64).contiguous())
    out = (node,)
    if return_blocks:
        out += (blk,)
    if return_margin:
        out += (margin,)
    return out if len(out) > 1 else node


def descend_ring_plain(nav, queries, depth, need, *, X, start=None, n_gathers=None,
                       return_margin=False, out=None):
    """Plain version of :func:`descend_ring`: each group's queries mapped
    by its pose (:func:`~madicp_tpu_torch.kernels.icp_terms.moving_in_map`,
    the kernel's order), copied to every tree of the group and descended
    by :func:`descend_plain` over the flat table; with ``out``, each result
    merged into its buffer where ``need`` holds (``torch.where``, then
    copied in place)."""
    T, M = nav.shape[:2]
    queries = queries.reshape((-1,) + queries.shape[-2:])
    G, Q = queries.shape[:2]
    X = X.reshape((-1, 4, 4))
    mapped = moving_in_map(queries, X.repeat_interleave(G // X.shape[0], dim=0))
    q = mapped[:, None].expand(G, T // G, Q, 3).reshape(T * Q, 3)
    base = (torch.arange(T, device=nav.device) * M)[:, None].expand(T, Q).reshape(T * Q)
    res = descend_plain(nav.reshape(T * M, nav.shape[2]), q, base, depth, need.reshape(T * Q),
                        None if start is None else start.reshape(T * Q), n_gathers, True,
                        return_margin)
    res = tuple(r.view((T, Q) + r.shape[1:]) for r in res)
    if out is None:
        return res
    for o, r in zip(out, res):
        o.copy_(torch.where(need.view(need.shape + (1,) * (r.dim() - 2)), r, o))
    return out


def _check_ring(nav, queries, X, depth, need, start, n_gathers, return_margin, out) -> None:
    """Raise on what neither version of :func:`descend_ring` takes."""
    if nav.dim() != 3 or queries.dim() not in (2, 3) or need.dim() != 2:
        raise ValueError(f"descend_ring: want nav (T, M, 56), queries (G, Q, 3) or (Q, 3) "
                         f"and need (T, Q), got {tuple(nav.shape)}, {tuple(queries.shape)} "
                         f"and {tuple(need.shape)}")
    T, Q = need.shape
    G = queries.shape[0] if queries.dim() == 3 else 1
    if nav.shape[0] != T or queries.shape[-2] != Q or T % G:
        raise ValueError(f"descend_ring: {T} trees and {Q} queries a tree do not match nav "
                         f"{tuple(nav.shape)} and queries {tuple(queries.shape)}")
    if X.dim() not in (2, 3) or X.shape[-2:] != (4, 4) or (X.dim() == 3 and G % X.shape[0]):
        raise ValueError(f"descend_ring: X must be (P, 4, 4) with P dividing the {G} query "
                         f"groups, or (4, 4), got {tuple(X.shape)}")
    if X.dtype != nav.dtype or X.device != nav.device:
        raise TypeError(f"descend_ring: X is {X.dtype} on {X.device}, nav {nav.dtype} on "
                        f"{nav.device}")
    # one group's queries: flattening a strided (G, Q, 3) view would copy it
    _check(nav.reshape(-1, nav.shape[-1]), queries[0] if queries.dim() == 3 else queries, 0,
           depth, None, None, n_gathers)
    for name, t in (("need", need), ("start", start)):
        if t is not None and (t.device != nav.device or t.shape != (T, Q)):
            raise ValueError(f"descend_ring: {name} must be ({T}, {Q}) on {nav.device}")
    if need.dtype != torch.bool:
        raise TypeError(f"descend_ring: need must be bool, got {need.dtype}")
    if start is not None and (start.is_floating_point() or start.dtype == torch.bool):
        raise TypeError(f"descend_ring: start must be an integer tensor, got {start.dtype}")
    if out is None:
        return
    want = [((T, Q), torch.int64), ((T, Q, 8), nav.dtype)]
    if return_margin:
        want.append(((T, Q), nav.dtype))
    if len(out) != len(want) or any(o.shape != s or o.dtype != d or o.device != nav.device
                                    for o, (s, d) in zip(out, want)):
        raise ValueError(f"descend_ring: out must be {want} on {nav.device}")


def descend_ring(nav, queries, depth, need, *, X, start=None, n_gathers: Optional[int] = None,
                 return_margin: bool = False, out=None):
    """Descend every (tree, query) entry of a ring of trees in one launch.

    ``nav`` (T, M, 56): T trees of M rows (a batch's keyframe rings, B K
    trees); ``queries`` (G, Q, 3) in the scan frame, each shared by the T
    / G consecutive trees of its group (a sequence's keyframes), or (Q, 3)
    shared by all; ``X`` (P, 4, 4) the scan-to-map poses, P dividing G,
    each shared by G / P consecutive groups (a sequence's pose: P = G = B
    for shared queries, P = B with G = B K per-tree queries), or (4, 4)
    for all: an entry descends with its query mapped by its pose in K7's
    order (``((m_x X_c0 + m_y X_c1) + m_z X_c2) + X_c3``); ``need`` (T, Q)
    the entries to descend, the others park on row 0 of their tree;
    ``start`` (T, Q) LOCAL warm-start nodes. Returns ``(ids (T, Q), blocks
    (T, Q, 8)[, margins (T, Q)])``, as :func:`descend` with blocks over
    the flat entries of the mapped queries. With ``out``, those tensors'
    previous values: only the ``need`` entries are descended and written,
    in place (the certified re-association's merge), and ``out`` is
    returned.

    CPU tensors take :func:`descend_ring_plain`; CUDA tensors the kernel,
    which reads each group's queries where they lie, through their
    strides, and forms each descended entry's map-frame query in registers
    from its sequence's pose (no map-frame copy, no K-fold copy, no
    row-offset table)."""
    _check_ring(nav, queries, X, depth, need, start, n_gathers, return_margin, out)
    if nav.device.type == "cpu":
        return descend_ring_plain(nav, queries, depth, need, X=X, start=start,
                                  n_gathers=n_gathers, return_margin=return_margin, out=out)
    if not nav.is_contiguous():
        raise ValueError("descend_ring: nav must be contiguous (the kernel reads its rows)")
    T, M = nav.shape[:2]
    Q = need.shape[1]
    G = queries.shape[0] if queries.dim() == 3 else 1
    P = X.shape[0] if X.dim() == 3 else 1
    known_levels = start is None
    if n_gathers is None:
        n_gathers = default_gathers(depth, True)
    if out is not None and not all(o.is_contiguous() for o in out):
        raise ValueError("descend_ring: out must be contiguous (the kernel writes its rows)")
    if out is None:
        dev, dtype = nav.device, nav.dtype
        res = (torch.empty((T, Q), dtype=torch.int64, device=dev),
               torch.empty((T, Q, 8), dtype=dtype, device=dev))
        if return_margin:
            res += (torch.empty((T, Q), dtype=dtype, device=dev),)
    else:
        res = tuple(out)
    _run(nav, queries, depth, n_gathers, known_levels, res[0], res[1],
         res[2] if return_margin else None, valid=need.contiguous(),
         start=None if start is None else start.to(torch.int64).contiguous(),
         ring=(Q, T // G, M), pose=X.contiguous(), pose_k=T // P, merge=out is not None)
    return res
