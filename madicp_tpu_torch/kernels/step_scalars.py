"""The step's scalars (K14): CUDA kernels and plain versions.

Two entry points, each one launch a step whatever the batch B:

- :func:`predict`: the constant-velocity prediction ``X0 = X
  exp_se3_split(v / hz)`` (``pipeline.cpp:146-152``), the counterpart of
  the JAX package's ``madicp_tpu/models/pipeline.py:723`` with
  ``madicp_tpu/ops/lie.py:147`` ``exp_se3_split``;
- :func:`tail`: everything after the Gauss-Newton rounds but the trees
  (``pipeline.cpp:197-262``): the inlier ratio and ``promote``, the
  trajectory and velocity estimate, ``-log det H``, the frame record's
  scalars, the best frame, the keyframe slot and the promotion's
  bookkeeping, and the ``plan`` the ring write (K13,
  :mod:`madicp_tpu_torch.kernels.ring_write`) moves the trees by; the
  counterpart of ``madicp_tpu/models/pipeline.py:736-792`` without the
  tree copies, ``madicp_tpu/models/vel_estimator.py:21``
  ``estimate_velocity`` and ``madicp_tpu/ops/icp_core.py:262``
  ``neg_logdet``.

XLA lowered those, so no Pallas kernel stands behind them. The kernels
live in ``csrc/step_scalars.cu`` (design and bound in its header);
:func:`predict_plain` and :func:`tail_plain` are the same math in tensor
ops, through the functions the package's other callers use
(``ops/lie.py`` ``exp_se3_split`` and ``se3_compose``,
``ops/velocity.py`` ``estimate_velocity``, ``ops/icp_core.py``
``neg_logdet``), each written one operation at a time in the kernels'
order, with constants as 0-dim tensors of the working type: ``v / hz``
and ``1 / hz`` are true divisions on every device, ``p_th`` is compared
in the working type, and the counts are integers. So each kernel equals
its plain version bit for bit where the CUDA math library's ``sin``,
``atan2``, ``asin`` and ``log`` equal torch's (torch's CUDA ops call the
same functions).

:func:`tail` writes the new state's fields into the tensors of ``out``
where it is given: the step hands over the state itself
(``models/step_graph.py`` ``step_in_place``), so a step writes its state
in place and copies nothing afterwards; the plain version copies its
results into them. Without ``out`` every field is a fresh tensor.

Dispatch is by the tensors' device and nothing else: CPU tensors take the
plain version, CUDA tensors take the kernel or the call raises. The
wrappers allocate only their outputs, read nothing back to the host and
launch on the current stream, so they run inside CUDA graph capture. One
``counter`` counts both entry points' launches.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from madicp_tpu_torch.kernels import build
from madicp_tpu_torch.ops.icp_core import neg_logdet
from madicp_tpu_torch.ops.lie import exp_se3_split, scalars, se3_compose
from madicp_tpu_torch.ops.velocity import estimate_velocity

counter = build.LaunchCounter()
# the __global__ functions of csrc/step_scalars.cu, as a CUDA trace names them
KERNEL_NAMES = ("predict_kernel", "tail_kernel")
_launch = build.Launcher("step_scalars", {  # the stream last
    "predict": [ctypes.c_void_p] * 3 + [ctypes.c_int] + [ctypes.c_void_p] * 2,
    "tail": [ctypes.c_void_p] * 3 + [ctypes.c_double, ctypes.c_int, ctypes.c_void_p],
}, counter)
MAX_FRAMES = 32  # the tail kernel holds a frame a lane
MAX_WINDOW = 33  # and a pose pair a lane
# TailIn's pointers, then TailOut's (csrc/step_scalars.cu), in one array
_TAIL_PTRS = ctypes.c_void_p * 36
_TAIL_DIMS = ctypes.c_int * 6


class Tail(NamedTuple):
    """What :func:`tail` returns: the new state's fields it forms (the
    destination's own tensors where ``out`` is given), the step's
    outputs, and the ring write's ``plan``."""

    velocity: torch.Tensor        # (B, 6)
    traj: torch.Tensor            # (B, W, 4, 4)
    traj_count: torch.Tensor      # (B,) int32
    ratio: torch.Tensor           # (B,) inlier ratio
    n_leaves: torch.Tensor        # (B,) int64 valid leaves
    promote: torch.Tensor         # (B,) bool
    fr_valid: torch.Tensor        # (B, F) bool
    fr_weight: torch.Tensor       # (B, F)
    fr_seq: torch.Tensor          # (B, F) int32
    fr_pose: torch.Tensor         # (B, F, 4, 4)
    fr_head: torch.Tensor         # (B,) int32
    kf_valid: torch.Tensor        # (B, K_l) bool
    kf_head: torch.Tensor         # (B,) int32
    keyframe_to_map: torch.Tensor  # (B, 4, 4)
    seq_keyframe: torch.Tensor    # (B,) int32
    seq: torch.Tensor             # (B,) int32
    plan: torch.Tensor            # (B, 4) int32: fr head, best, kf slot (clamped), write


# the state fields the tail reads, with their dtype kind ("f": the
# working type) and their shape after the batch
_STATE = (("velocity", "f", ("6",)), ("traj", "f", ("W", "4", "4")),
          ("traj_count", torch.int32, ()), ("fr_valid", torch.bool, ("F",)),
          ("fr_weight", "f", ("F",)), ("fr_seq", torch.int32, ("F",)),
          ("fr_pose", "f", ("F", "4", "4")), ("fr_head", torch.int32, ()),
          ("kf_valid", torch.bool, ("K",)), ("kf_head", torch.int32, ()),
          ("keyframe_to_map", "f", ("4", "4")), ("seq", torch.int32, ()),
          ("seq_keyframe", torch.int32, ()))


# -------------------------------------------------------------- predict --
def predict_plain(X: torch.Tensor, v: torch.Tensor, hz: torch.Tensor) -> torch.Tensor:
    """Plain version: ``X exp_se3_split(v / hz)`` of poses ``X (B, 4, 4)``,
    velocities ``v (B, 6)`` and a 0-dim rate ``hz``."""
    return se3_compose(X, exp_se3_split(v / hz))


def _check_predict(X, v, hz) -> None:
    dev, dtype = X.device, X.dtype
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"step_scalars.predict: unsupported device {dev}")
    if any(t.device != dev for t in (v, hz)):
        raise ValueError("step_scalars.predict: X, v and hz on different devices")
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"step_scalars.predict: X must be float32/float64, got {dtype}")
    if v.dtype != dtype or hz.dtype != dtype:
        raise TypeError(f"step_scalars.predict: v {v.dtype} and hz {hz.dtype} must be X's {dtype}")
    if X.dim() != 3 or X.shape[1:] != (4, 4) or tuple(v.shape) != (X.shape[0], 6) or hz.dim():
        raise ValueError(f"step_scalars.predict: want X (B, 4, 4), v (B, 6), hz (), got "
                         f"{tuple(X.shape)}, {tuple(v.shape)}, {tuple(hz.shape)}")


def predict(X: torch.Tensor, v: torch.Tensor, hz: torch.Tensor) -> torch.Tensor:
    """The predicted poses of :func:`predict_plain` (same arguments): the
    plain version for CPU tensors, the kernel for CUDA ones (on contiguous
    copies of operands that are not)."""
    _check_predict(X, v, hz)
    if X.device.type == "cpu":
        return predict_plain(X, v, hz)
    return launch_predict(X.contiguous(), v.contiguous(), hz)


def launch_predict(X: torch.Tensor, v: torch.Tensor, hz: torch.Tensor) -> torch.Tensor:
    """Run the prediction kernel on CUDA tensors (contiguous; arguments
    and result as :func:`predict`); one count."""
    _check_predict(X, v, hz)
    _contiguous("step_scalars.predict", X=X, v=v)
    out = torch.empty_like(X)
    _launch("predict", X.dtype, X.device, X.data_ptr(), v.data_ptr(), hz.data_ptr(),
            X.shape[0], out.data_ptr())
    return out


# ----------------------------------------------------------------- tail --
def tail_plain(state, X, H, matched, valid, hz, *, p_th: float, num_keyframes: int,
               kf_offset: int = 0, out=None) -> Tail:
    """Plain version of the step's tail for B sequences: ``state`` holds
    the batched fields of :data:`_STATE` (a ``PipelineState``), ``X (B,
    4, 4)`` the rounds' pose, ``H (B, 6, 6)`` the last round's normal
    matrix, ``matched`` and ``valid`` (B, L) the last round's matches and
    the leaf mask, ``hz`` the 0-dim rate; ``p_th`` the promotion
    threshold, ``num_keyframes`` the ring's global size and ``kf_offset``
    the global slot of this state's first keyframe (a process writes only
    a slot it holds). ``out``: a state whose tensors (those of
    :data:`_STATE` and ``X``) take the new state, usually ``state``
    itself (:func:`tail`); the result's fields are then those tensors."""
    if out is not None:
        _check_out(out, state)
    dtype, dev = X.dtype, X.device
    B = X.shape[0]
    F, K_l = state.fr_valid.shape[1], state.kf_valid.shape[1]
    one, thr, inf = scalars(X, 1.0, p_th, float("inf"))
    # ---- inlier ratio over final-round matches (pipeline.cpp:197-204)
    n_leaves = valid.sum(-1)
    ratio = (matched & valid).sum(-1).to(dtype) / torch.clamp(n_leaves, min=1).to(dtype)
    promote = ratio < thr
    # ---- trajectory + velocity smoothing (pipeline.cpp:206-217)
    traj = torch.cat([state.traj[:, 1:], X[:, None]], dim=1)
    traj_count = state.traj_count + 1
    velocity = estimate_velocity(state.velocity, traj, traj_count, one / hz)
    # ---- frame record (pipeline.cpp:219-232)
    head = state.fr_head
    at = torch.arange(F, device=dev) == head[:, None]  # (B, F)
    fr_valid = state.fr_valid | at
    fr_weight = torch.where(at, neg_logdet(H)[:, None], state.fr_weight)
    fr_seq = torch.where(at, state.seq[:, None], state.fr_seq)
    fr_pose = torch.where(at[..., None, None], X[:, None], state.fr_pose)
    # ---- keyframe promotion (pipeline.cpp:234-262), masked per sequence
    best = torch.argmin(torch.where(fr_valid, fr_weight, inf), dim=-1)
    best_seq = torch.gather(fr_seq, 1, best[:, None])[:, 0]
    slot = state.kf_head - kf_offset  # only where this process holds the ring head
    write = promote & (slot >= 0) & (slot < K_l)
    kf_valid = state.kf_valid | (write[:, None]
                                 & (torch.arange(K_l, device=dev) == slot[:, None]))
    # drop window frames at or before the promoted one (pipeline.cpp:246-251)
    fr_valid = torch.where(promote[:, None], fr_valid & (fr_seq > best_seq[:, None]), fr_valid)
    plan = torch.stack([head, best.to(torch.int32), torch.clamp(slot, 0, K_l - 1),
                        write.to(torch.int32)], dim=-1).to(torch.int32)
    new = Tail(
        velocity=velocity,
        traj=traj,
        traj_count=traj_count,
        ratio=ratio,
        n_leaves=n_leaves,
        promote=promote,
        fr_valid=fr_valid,
        fr_weight=fr_weight,
        fr_seq=fr_seq,
        fr_pose=fr_pose,
        fr_head=(head + 1) % F,
        kf_valid=kf_valid,
        kf_head=torch.where(promote, (state.kf_head + 1) % num_keyframes, state.kf_head),
        keyframe_to_map=torch.where(promote[:, None, None], fr_pose[torch.arange(B, device=dev),
                                                                    best], state.keyframe_to_map),
        seq_keyframe=torch.where(promote, best_seq, state.seq_keyframe),
        seq=state.seq + 1,
        plan=plan,
    )
    if out is None:
        return new
    # every value is formed before the first copy: reads before writes
    out.X.copy_(X)
    for name, _, _ in _STATE:
        getattr(out, name).copy_(getattr(new, name))
    return new._replace(**{name: getattr(out, name) for name, _, _ in _STATE})


def _contiguous(what: str, **tensors) -> None:
    for name, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")


def _check_tail(state, X, H, matched, valid, hz, num_keyframes, kf_offset) -> tuple:
    """Raise on what neither version takes (every device); ``(B, L, W, F,
    K_l)``."""
    dev, dtype = X.device, X.dtype
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"step_scalars.tail: unsupported device {dev}")
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"step_scalars.tail: X must be float32/float64, got {dtype}")
    if X.dim() != 3 or X.shape[1:] != (4, 4):
        raise ValueError(f"step_scalars.tail: want X (B, 4, 4), got {tuple(X.shape)}")
    B = X.shape[0]
    if matched.dim() != 2 or matched.shape[0] != B:
        raise ValueError(f"step_scalars.tail: want matched (B, L), got {tuple(matched.shape)}")
    L = matched.shape[1]
    sizes = {"4": 4, "6": 6, "W": state.traj.shape[-3], "F": state.fr_valid.shape[-1],
             "K": state.kf_valid.shape[-1]}
    fields = [("H", H, "f", ("6", "6")), ("matched", matched, torch.bool, ("L",)),
              ("valid", valid, torch.bool, ("L",))]
    fields += [(name, getattr(state, name), kind, shape) for name, kind, shape in _STATE]
    sizes["L"] = L
    for name, t, kind, shape in fields:
        if t.device != dev:
            raise ValueError(f"step_scalars.tail: {name} on {t.device}, X on {dev}")
        want = dtype if kind == "f" else kind
        if t.dtype != want:
            raise TypeError(f"step_scalars.tail: {name} must be {want}, got {t.dtype}")
        if tuple(t.shape) != (B,) + tuple(sizes[s] for s in shape):
            raise ValueError(f"step_scalars.tail: want {name} (B, {', '.join(shape)}) with B = "
                             f"{B}, got {tuple(t.shape)}")
    if hz.device != dev or hz.dtype != dtype or hz.dim():
        raise ValueError("step_scalars.tail: hz must be a 0-dim tensor of X's type and device")
    if not 1 <= sizes["F"] <= MAX_FRAMES or not 2 <= sizes["W"] <= MAX_WINDOW:
        raise ValueError(f"step_scalars.tail: a window of 1-{MAX_FRAMES} frames and a "
                         f"trajectory of 2-{MAX_WINDOW} poses, got {sizes['F']}, {sizes['W']}")
    if num_keyframes < 1:
        raise ValueError(f"step_scalars.tail: num_keyframes must be >= 1, got {num_keyframes}")
    return B, L, sizes["W"], sizes["F"], sizes["K"]


def _check_out(out, state) -> None:
    """Raise unless every destination in ``out`` (the fields of
    :data:`_STATE` and ``X``) has its state field's shape, type and
    device and is contiguous (the kernel writes it as one block; a copy
    made here would leave the caller's tensor unwritten)."""
    for name in ("X",) + tuple(name for name, _, _ in _STATE):
        d, s = getattr(out, name), getattr(state, name)
        if d.dtype != s.dtype or d.device != s.device:
            raise TypeError(f"step_scalars.tail: out.{name} is {d.dtype} on {d.device}, the "
                            f"state's {s.dtype} on {s.device}")
        if d.shape != s.shape:
            raise ValueError(f"step_scalars.tail: out.{name} {tuple(d.shape)}, the state's "
                             f"{tuple(s.shape)}")
        if not d.is_contiguous():
            raise ValueError(f"step_scalars.tail: out.{name} must be contiguous")


def tail(state, X, H, matched, valid, hz, *, p_th: float, num_keyframes: int,
         kf_offset: int = 0, out=None) -> Tail:
    """The step's tail of :func:`tail_plain` (same arguments): the plain
    version for CPU tensors, the kernel for CUDA ones (on contiguous
    copies of operands that are not; a destination in ``out`` must be
    contiguous)."""
    dims = _check_tail(state, X, H, matched, valid, hz, num_keyframes, kf_offset)
    kw = dict(p_th=p_th, num_keyframes=num_keyframes, kf_offset=kf_offset)
    if X.device.type == "cpu":
        return tail_plain(state, X, H, matched, valid, hz, **kw, out=out)
    if out is not None:
        _check_out(out, state)
    # a copy only where an operand is not contiguous (the keyframe-sharded
    # step's all-reduced H)
    ops = [t if t.is_contiguous() else t.contiguous() for t in (X, H, matched, valid)]
    if not all(getattr(state, name).is_contiguous() for name, _, _ in _STATE):
        state = state._replace(**{name: getattr(state, name).contiguous()
                                  for name, _, _ in _STATE})
    return _launch_tail(state, *ops, hz, dims, out, **kw)


def launch_tail(state, X, H, matched, valid, hz, *, p_th: float, num_keyframes: int,
                kf_offset: int = 0, out=None) -> Tail:
    """Run the tail kernel on CUDA tensors (every operand contiguous;
    arguments and result as :func:`tail`); one count."""
    dims = _check_tail(state, X, H, matched, valid, hz, num_keyframes, kf_offset)
    if out is not None:
        _check_out(out, state)
    _contiguous("step_scalars.tail", X=X, H=H, matched=matched, valid=valid,
                **{name: getattr(state, name) for name, _, _ in _STATE})
    return _launch_tail(state, X, H, matched, valid, hz, dims, out, p_th=p_th,
                        num_keyframes=num_keyframes, kf_offset=kf_offset)


def _launch_tail(state, X, H, matched, valid, hz, dims, out, *, p_th: float,
                 num_keyframes: int, kf_offset: int) -> Tail:
    B, L, W, F, K_l = dims
    dev, dtype = X.device, X.dtype
    names = [name for name, _, _ in _STATE]
    dst = [getattr(out, name) for name in names] if out is not None else [
        torch.empty_like(getattr(state, name)) for name in names]
    new = Tail(**dict(zip(names, dst)), ratio=torch.empty(B, dtype=dtype, device=dev),
               n_leaves=torch.empty(B, dtype=torch.int64, device=dev),
               promote=torch.empty(B, dtype=torch.bool, device=dev),
               plan=torch.empty((B, 4), dtype=torch.int32, device=dev))
    # TailIn, then TailOut (csrc/step_scalars.cu): X (0 where not written),
    # the state's fields, then the step's outputs
    ptrs = _TAIL_PTRS(X.data_ptr(), H.data_ptr(), matched.data_ptr(), valid.data_ptr(),
                      hz.data_ptr(), *(getattr(state, name).data_ptr() for name in names),
                      out.X.data_ptr() if out is not None else 0,
                      *(t.data_ptr() for t in dst), new.ratio.data_ptr(),
                      new.n_leaves.data_ptr(), new.promote.data_ptr(), new.plan.data_ptr())
    at = ctypes.addressof(ptrs)
    dims = _TAIL_DIMS(L, W, F, K_l, num_keyframes, kf_offset)
    _launch("tail", dtype, dev, at, at + 18 * ctypes.sizeof(ctypes.c_void_p),
            ctypes.addressof(dims), float(p_th), B)
    return new
