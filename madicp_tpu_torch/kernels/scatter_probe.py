"""Segment-sum design points of the scatter probe: CUDA kernels and plain versions.

Four wrappers, each the counterpart of one TPU kernel of
``scripts/pallas_scatter_probe.py``, in that probe's argument order and
layouts (``idx`` may be ``(N,)`` or the probe's ``(1, N)``); every id
outside ``[0, M)`` drops:

- :func:`onehot_segsum`  ``(16, N)`` values -> ``(16, M)`` sums; replaces
  ``make_onehot_segsum`` (``:66``). Modes ``f32`` and ``highest`` are a
  full-FP32 scatter on CUDA cores; ``bf16x3`` is the one-hot contraction
  on the tensor cores with each value split into three exact bf16 parts.
- :func:`fused_moments`  ``(N, 3)`` points -> ``(M, 16)`` sums of
  ``[d, outer6(d), 1, 0 x 6]``, the bf16x3 contraction with the moment
  columns formed in the kernel; replaces ``make_fused_moments`` (``:155``).
- :func:`rmw_segsum`     ``(Q, 16)`` -> ``(Mq, 16)``, summed in row order:
  bitwise equal to a float32 ``np.add.at``; replaces ``rmw_kernel``
  (``:365``). The TPU kernel indexed out-of-range ids with undefined
  results; here they drop.
- :func:`scatter_segsum` the same function, unordered; replaces
  ``scat_kernel`` (``:401``).

The kernels are in ``csrc/scatter_probe.cu`` (design and bounds in its
header). Beside each wrapper is its plain PyTorch version (``*_ref``).
Arguments are checked on every device; then CPU tensors take the plain
version and CUDA tensors launch the kernel or the call raises. Each
launch adds one to ``launches[<wrapper name>]``.
"""

from __future__ import annotations

import ctypes

import torch

from madicp_tpu_torch.kernels import build

MODES = ("f32", "highest", "bf16x3")
RMW_MAX_ROWS = 2048  # the in-order kernel keeps the table in shared memory
_MAX_N = 2**26  # 16 N and 16 M, plus a grid's stride, stay within a C int

launches = {"onehot_segsum": 0, "fused_moments": 0, "rmw_segsum": 0,
            "scatter_segsum": 0}


# ------------------------------------------------------ plain versions --
def segsum16_ref(idx: torch.Tensor, rows: torch.Tensor, m: int) -> torch.Tensor:
    """``(N, C)`` rows -> ``(m, C)`` segment sums in ``rows``' dtype:
    ``index_add_`` into a table with one spare row that takes every
    dropped id."""
    ids = idx.reshape(-1).long()
    ids = torch.where((ids >= 0) & (ids < m), ids, m)
    tab = torch.zeros((m + 1, rows.shape[1]), dtype=rows.dtype, device=rows.device)
    tab.index_add_(0, ids, rows)
    return tab[:m]


def bf16x3_parts(v: torch.Tensor):
    """Truncation split of float32 ``v`` into hi, mid, lo with
    ``hi + mid + lo == v`` exactly, each exact in bf16
    (``pallas_scatter_probe.py:113-123``)."""
    mask = torch.tensor(-65536, dtype=torch.int32, device=v.device)
    hi = (v.view(torch.int32) & mask).view(torch.float32)
    r1 = v - hi
    mid = (r1.view(torch.int32) & mask).view(torch.float32)
    return hi, mid, r1 - mid


def moment_columns16(d: torch.Tensor) -> torch.Tensor:
    """(N, 3) -> (N, 16) columns ``[d, outer6(d), 1, 0 x 6]``."""
    x, y, z = d[:, 0], d[:, 1], d[:, 2]
    zero = torch.zeros_like(x)
    return torch.stack([x, y, z, x * x, x * y, x * z, y * y, y * z, z * z,
                        torch.ones_like(x), *([zero] * 6)], dim=1)


def onehot_segsum_ref(idx2d, vals_t, M: int, mode: str = "f32") -> torch.Tensor:
    """Plain version of :func:`onehot_segsum`: the segment sum of the
    rows (``f32``, ``highest``), or the sum of the three bf16 parts'
    segment sums (``bf16x3``)."""
    if mode == "bf16x3":
        parts = bf16x3_parts(vals_t)
        return sum(segsum16_ref(idx2d, p.T, M) for p in parts).T
    return segsum16_ref(idx2d, vals_t.T, M).T


def fused_moments_ref(idx2d, d, M: int) -> torch.Tensor:
    """Plain version of :func:`fused_moments`: the moment columns in
    float32, split in three bf16 parts, the parts' segment sums added."""
    return sum(segsum16_ref(idx2d, p, M) for p in bf16x3_parts(moment_columns16(d)))


def rmw_segsum_ref(idx, vals, Mq: int) -> torch.Tensor:
    """Plain version of :func:`rmw_segsum`: an in-order loop over the
    rows, ``out[idx[i]] += vals[i]``."""
    out = torch.zeros((Mq, vals.shape[1]), dtype=vals.dtype, device=vals.device)
    for i, j in enumerate(idx.reshape(-1).tolist()):
        if 0 <= j < Mq:
            out[j] += vals[i]
    return out


def scatter_segsum_ref(idx, vals, Mq: int) -> torch.Tensor:
    """Plain version of :func:`scatter_segsum`."""
    return segsum16_ref(idx, vals, Mq)


# ------------------------------------------------------------ wrappers --
def _checked(name: str, idx, x, shape: tuple, n: int, m: int) -> bool:
    """Check the arguments (``x`` of ``shape``, ``n`` ids); True when
    they lie on a CUDA device (launch the kernel), False on the CPU (take
    the plain version)."""
    if x.dtype != torch.float32:
        raise TypeError(f"{name}: values must be float32, got {x.dtype}")
    if idx.dtype != torch.int32:
        raise TypeError(f"{name}: idx must be int32, got {idx.dtype}")
    if tuple(x.shape) != shape or idx.shape not in ((n,), (1, n)):
        raise ValueError(f"{name}: want values {shape} and idx ({n},) or (1, {n}), "
                         f"got {tuple(x.shape)} and {tuple(idx.shape)}")
    if not (1 <= m <= _MAX_N and n <= _MAX_N):
        raise ValueError(f"{name}: need 1 <= M <= {_MAX_N} and N <= {_MAX_N}, "
                         f"got M={m}, N={n}")
    if idx.device != x.device:
        raise ValueError(f"{name}: idx and values on different devices")
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if not (x.is_contiguous() and idx.is_contiguous()):
        raise ValueError(f"{name}: idx and values must be contiguous")
    return True


def _launch(name: str, symbol: str, idx, x, n: int, m: int, out,
            scratch=None) -> torch.Tensor:
    lib = build.load("scatter_probe")
    fn = getattr(lib, symbol)
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(idx.data_ptr(), x.data_ptr(), n, m,
                None if scratch is None else scratch.data_ptr(), out.data_ptr(), stream)
    build.raise_on_error(lib, rc, name)
    launches[name] += 1
    return out


def onehot_segsum(idx2d, vals_t, M: int, mode: str = "f32") -> torch.Tensor:
    """``(16, M)`` segment sums of the ``(16, N)`` float32 ``vals_t``
    columns by ``idx2d``; see the module docstring for the modes."""
    if mode not in MODES:
        raise ValueError(f"onehot_segsum: mode must be one of {MODES}, got {mode!r}")
    n = vals_t.shape[-1]
    if not _checked("onehot_segsum", idx2d, vals_t, (16, n), n, M):
        return onehot_segsum_ref(idx2d, vals_t, M, mode)
    if mode != "bf16x3":
        out = torch.zeros((16, M), dtype=torch.float32, device=vals_t.device)
        return _launch("onehot_segsum", "onehot_segsum16_f32", idx2d, vals_t, n, M, out)
    out = torch.empty((16, M), dtype=torch.float32, device=vals_t.device)
    scratch = torch.zeros(16 * M, dtype=torch.float64, device=vals_t.device)
    return _launch("onehot_segsum", "onehot_segsum16_bf16x3", idx2d, vals_t, n, M,
                   out, scratch)


def fused_moments(idx2d, d, M: int) -> torch.Tensor:
    """``(M, 16)`` sums of the moment columns of the ``(N, 3)`` float32
    points ``d`` (columns 10-15 zero)."""
    n = d.shape[0]
    if not _checked("fused_moments", idx2d, d, (n, 3), n, M):
        return fused_moments_ref(idx2d, d, M)
    out = torch.empty((M, 16), dtype=torch.float32, device=d.device)
    scratch = torch.zeros(16 * M, dtype=torch.float64, device=d.device)
    return _launch("fused_moments", "fused_moments16", idx2d, d, n, M, out, scratch)


def rmw_segsum(idx, vals, Mq: int) -> torch.Tensor:
    """``(Mq, 16)`` segment sums of the ``(Q, 16)`` float32 rows, each
    entry summed in row order (bitwise a float32 ``np.add.at``);
    ``Mq <= RMW_MAX_ROWS``; on the card ``vals`` is 16-byte aligned."""
    q = vals.shape[0]
    if Mq > RMW_MAX_ROWS:
        raise ValueError(f"rmw_segsum: Mq must be <= {RMW_MAX_ROWS}, got {Mq}")
    if not _checked("rmw_segsum", idx, vals, (q, 16), q, Mq):
        return rmw_segsum_ref(idx, vals, Mq)
    if vals.data_ptr() % 16:
        raise ValueError("rmw_segsum: vals must be 16-byte aligned")
    out = torch.empty((Mq, 16), dtype=torch.float32, device=vals.device)
    return _launch("rmw_segsum", "rmw_segsum16", idx, vals, q, Mq, out)


def scatter_segsum(idx, vals, Mq: int) -> torch.Tensor:
    """``(Mq, 16)`` segment sums of the ``(Q, 16)`` float32 rows, in no
    fixed order."""
    q = vals.shape[0]
    if not _checked("scatter_segsum", idx, vals, (q, 16), q, Mq):
        return scatter_segsum_ref(idx, vals, Mq)
    out = torch.zeros((Mq, 16), dtype=torch.float32, device=vals.device)
    return _launch("scatter_segsum", "scatter_segsum16", idx, vals, q, Mq, out)
