"""ctypes binding for the native ``.bin`` scan loader.

The shared library is compiled from ``loader.cpp`` on first use with the
system ``g++`` (a plain C ABI through ctypes needs no Python headers) by
``kernels/build.py::build_library``, as the CUDA kernels are: into
``build/madicp_tpu_torch/`` beside the package (listed in
``.gitignore``), named by a hash of the source and flags, so an edited
source rebuilds at its first use and nothing is written into the
package. When the compiler or the build directory is
unavailable the loader reports ``available() == False`` and the readers
fall back to numpy.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import numpy as np

from madicp_tpu_torch.kernels.build import build_library

_SRC = Path(__file__).resolve().parent / "loader.cpp"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lib: Optional[ctypes.CDLL] = None
_tried = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        lib = ctypes.CDLL(str(build_library(_SRC, "g++", GXX_FLAGS)))
    except (OSError, RuntimeError):
        return None
    lib.madicp_read_bin.restype = ctypes.c_long
    lib.madicp_read_bin.argtypes = [
        ctypes.c_char_p, ctypes.c_double, ctypes.c_double,
        ctypes.c_int, ctypes.POINTER(ctypes.c_double), ctypes.c_long,
    ]
    lib.madicp_bin_records.restype = ctypes.c_long
    lib.madicp_bin_records.argtypes = [ctypes.c_char_p]
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def read_bin(
    path,
    min_range: float,
    max_range: float,
    apply_correction: bool = False,
) -> np.ndarray:
    """Read, range-filter and (optionally) correct one ``.bin`` scan.

    Returns an (N, 3) float64 array, bitwise equal to the numpy reader's.
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("native loader unavailable")
    p = str(path).encode()
    cap = lib.madicp_bin_records(p)
    if cap < 0:
        raise FileNotFoundError(path)
    out = np.empty((max(cap, 1), 3), np.float64)
    n = lib.madicp_read_bin(
        p,
        float(min_range),
        float(max_range),
        1 if apply_correction else 0,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        cap,
    )
    if n < 0:
        raise IOError(f"failed to read {path}")
    return out[:n]
