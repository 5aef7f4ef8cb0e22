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

counter = build.LaunchCounter()
_launch = build.Launcher("descent", {  # the stream last
    "descend": ([ctypes.c_void_p] * 3 + [ctypes.c_longlong] + [ctypes.c_void_p] * 2
                + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 4),
}, counter)
_MAX_QUERIES = 2**31 - 1  # one thread a query, indexed by an int


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
    if Q > _MAX_QUERIES:
        raise ValueError(f"descend: at most {_MAX_QUERIES} queries, got {Q}")
    dev = queries.device
    known_levels = start is None
    if n_gathers is None:
        n_gathers = default_gathers(depth, return_blocks)
    queries = queries.contiguous()
    if isinstance(base, torch.Tensor):
        base_t, base0 = base.to(torch.int64).contiguous(), 0
    else:
        base_t, base0 = None, int(base)
    valid_t = None if valid is None else valid.contiguous()
    start_t = None if start is None else start.to(torch.int64).contiguous()
    node = torch.empty((Q,), dtype=torch.int64, device=dev)
    blk = torch.empty((Q, 8), dtype=nav.dtype, device=dev) if return_blocks else None
    margin = torch.empty((Q,), dtype=nav.dtype, device=dev) if return_margin else None
    # 16-byte vectors where the table's rows (224 or 448 bytes) and the
    # blocks out start on 16-byte boundaries
    vec = nav.data_ptr() % 16 == 0 and (blk is None or blk.data_ptr() % 16 == 0)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    _launch("descend", nav.dtype, dev, nav.data_ptr(), queries.data_ptr(), ptr(base_t), base0,
            ptr(valid_t), ptr(start_t), Q, depth, n_gathers, int(known_levels), int(vec),
            node.data_ptr(), ptr(blk), ptr(margin))
    out = (node,)
    if return_blocks:
        out += (blk,)
    if return_margin:
        out += (margin,)
    return out if len(out) > 1 else node
