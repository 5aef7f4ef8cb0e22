"""The ring write (K13): CUDA kernel and plain version.

The step's frame record and keyframe promotion on the rings, in place:
the scan's tree ``nav (B, M, 56)`` moved by its pose ``X (B, 4, 4)``
(``ops/tree.py`` :func:`~madicp_tpu_torch.ops.tree.transform_tree`) into
the frame window's slot ``head`` of ``fr_nav (B, F, M, 56)``, then, where
a sequence writes, the window's tree ``best`` copied into the keyframe
ring's slot ``slot`` of ``kf_nav (B, K_l, M, 56)``; ``plan (B, 4)`` =
(head, best, slot, write) is the step's tail's
(:func:`madicp_tpu_torch.kernels.step_scalars.tail`). It is the
counterpart of the JAX package's ``madicp_tpu/ops/tree.py:939``
``transform_tree``, the frame slot's ``_set_slot``
(``madicp_tpu/models/pipeline.py:287, 751``) and ``do_promote``'s tree
copy (``:768-779``, under a ``lax.cond``: most scans do not promote).
XLA lowered those, so no Pallas kernel stands behind them. The kernel
lives in ``csrc/ring_write.cu`` (design and bound in its header);
:func:`ring_write_plain` is the same in tensor ops, ``transform_tree``
written in the kernel's order, so the two write the same bits.

Dispatch is by the tensors' device and nothing else: CPU tensors take the
plain version, CUDA tensors take the kernel (one launch a step; a
sequence that does not promote copies no keyframe tree) or the call
raises. The wrapper allocates nothing, reads nothing back to the host and
launches on the current stream, so it runs inside CUDA graph capture.
"""

from __future__ import annotations

import ctypes

import torch

from madicp_tpu_torch.kernels import build
from madicp_tpu_torch.ops.tree import NAV_WIDTH, SearchTree, transform_tree

counter = build.LaunchCounter()
# the __global__ functions of csrc/ring_write.cu, as a CUDA trace names them
KERNEL_NAMES = ("ring_write_kernel",)
_launch = build.Launcher("ring_write", {  # the stream last
    "ring_write": [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_longlong]
    + [ctypes.c_int] * 2 + [ctypes.c_void_p],
}, counter)
PANEL = 8  # values a panel: [position(3), direction(3), scalar(2)]


def _rows(i: torch.Tensor, n: int) -> torch.Tensor:
    """Flat row ``b * n + i[b]`` of each sequence's slot ``i`` (B,) in a
    ``(B * n, ...)`` view of per-sequence rings."""
    i = i.long()
    return i + torch.arange(i.shape[0], device=i.device) * n


def ring_write_plain(nav, X, plan, fr_nav, kf_nav) -> None:
    """Plain version: write the moved tree into ``fr_nav[b, head]``, then
    ``fr_nav[b, best]`` into ``kf_nav[b, slot]`` where ``write`` (every
    sequence's slot is written; one that does not write gets its own tree
    back), in place."""
    B, F = fr_nav.shape[:2]
    K_l = kf_nav.shape[1]
    head, best, slot, write = plan.unbind(-1)
    moved = transform_tree(SearchTree(nav=nav), X[:, :3, :3], X[:, :3, 3]).nav
    fr = fr_nav.view((B * F,) + fr_nav.shape[2:])
    kf = kf_nav.view((B * K_l,) + kf_nav.shape[2:])
    fr.index_copy_(0, _rows(head, F), moved)
    rows = _rows(slot, K_l)
    kf.index_copy_(0, rows, torch.where(write.bool()[:, None, None],
                                        fr.index_select(0, _rows(best, F)),
                                        kf.index_select(0, rows)))


def _check(nav, X, plan, fr_nav, kf_nav) -> None:
    """Raise on what neither version takes (every device)."""
    dev, dtype = nav.device, nav.dtype
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"ring_write: unsupported device {dev}")
    if any(t.device != dev for t in (X, plan, fr_nav, kf_nav)):
        raise ValueError("ring_write: operands on different devices")
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"ring_write: nav must be float32/float64, got {dtype}")
    if any(t.dtype != dtype for t in (X, fr_nav, kf_nav)):
        raise TypeError(f"ring_write: X, fr_nav and kf_nav must be nav's {dtype}")
    if plan.dtype != torch.int32:
        raise TypeError(f"ring_write: plan must be int32, got {plan.dtype}")
    if nav.dim() != 3 or nav.shape[-1] != NAV_WIDTH:
        raise ValueError(f"ring_write: want nav (B, M, {NAV_WIDTH}), got {tuple(nav.shape)}")
    B, M = nav.shape[:2]
    for name, t, shape in (("X", X, (B, 4, 4)), ("plan", plan, (B, 4))):
        if tuple(t.shape) != shape:
            raise ValueError(f"ring_write: want {name} {shape}, got {tuple(t.shape)}")
    for name, t in (("fr_nav", fr_nav), ("kf_nav", kf_nav)):
        if t.dim() != 4 or t.shape[0] != B or t.shape[2:] != (M, NAV_WIDTH) or t.shape[1] < 1:
            raise ValueError(f"ring_write: want {name} (B, n, M, {NAV_WIDTH}) with B, M = "
                             f"{B}, {M}, got {tuple(t.shape)}")


def ring_write(nav, X, plan, fr_nav, kf_nav) -> None:
    """The frame record and promotion of :func:`ring_write_plain` (same
    arguments), in place: the plain version for CPU tensors, the kernel
    for CUDA ones."""
    _check(nav, X, plan, fr_nav, kf_nav)
    if nav.device.type == "cpu":
        ring_write_plain(nav, X, plan, fr_nav, kf_nav)
    else:  # the rings are written in place: they must be contiguous already
        launch(nav.contiguous(), X.contiguous(), plan.contiguous(), fr_nav, kf_nav)


def launch(nav, X, plan, fr_nav, kf_nav) -> None:
    """Run the kernel on CUDA tensors (arguments as :func:`ring_write`;
    every operand contiguous, the rings and the tree 16-byte aligned);
    one count."""
    _check(nav, X, plan, fr_nav, kf_nav)
    for name, t in (("nav", nav), ("X", X), ("plan", plan), ("fr_nav", fr_nav),
                    ("kf_nav", kf_nav)):
        if not t.is_contiguous():
            raise ValueError(f"ring_write: {name} must be contiguous")
    for name, t in (("nav", nav), ("fr_nav", fr_nav), ("kf_nav", kf_nav), ("plan", plan)):
        if t.data_ptr() % 16:
            raise ValueError(f"ring_write: {name} must start on a 16-byte boundary")
    B, M = nav.shape[:2]
    _launch("ring_write", nav.dtype, nav.device, nav.data_ptr(), X.data_ptr(), plan.data_ptr(),
            fr_nav.data_ptr(), kf_nav.data_ptr(), B, M * NAV_WIDTH // PANEL, fr_nav.shape[1],
            kf_nav.shape[1])
