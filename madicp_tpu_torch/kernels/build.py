"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface and loaded with ``ctypes``
(no PyTorch headers: a build takes seconds, not minutes). Libraries go to
``build/madicp_tpu_torch/`` beside the package (listed in
``.gitignore``), named by a hash of the source, the headers beside it
(``csrc/*.cuh``) and the flags, so an edited source or header rebuilds
at its first use and an unchanged one is reused. :class:`Launcher` calls
a library's launch functions on the current stream and counts them.
``native/loader.py`` builds its C++ loader with ``g++`` through the same
helpers. Nothing is compiled at import time.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "madicp_tpu_torch"
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
)
SOURCES = ("segsum_moments", "scatter_probe", "descent", "icp_terms", "build_nodes",
           "build_points", "gn_update", "certify_slack", "deskew", "step_scalars", "ring_write")

_loaded: dict[str, ctypes.CDLL] = {}


class LaunchCounter:
    """A kernel's launch count: a plain integer its wrapper advances by one
    a launch and callers reset."""

    def __init__(self):
        self.launches = 0


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "madicp_tpu_torch: nvcc not found (PATH, $CUDA_HOME/bin, "
        "/usr/local/cuda/bin); the CUDA kernels cannot be built"
    )


def hashed_library(src: Path, flags) -> Path:
    """The library built from ``src`` with ``flags``: under ``BUILD_DIR``,
    named by the source's stem and a hash of the source, the ``*.cuh``
    headers beside it and the flags."""
    headers = b"".join(h.read_bytes() for h in sorted(src.parent.glob("*.cuh")))
    h = hashlib.sha256(src.read_bytes() + headers + " ".join(flags).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{src.stem}_{h}.so"


def start_build(src: Path, compiler: str, flags):
    """Start ``compiler flags -o <tmp> src`` into a temporary file in
    ``BUILD_DIR``; None when the library for this hash already exists."""
    out = hashed_library(src, flags)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.Popen(
            [compiler, *flags, "-o", tmp, str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
    except OSError:
        os.unlink(tmp)
        raise
    return proc, tmp, out


def finish_build(started) -> Path:
    """Wait for a build of ``start_build`` and move its library into
    place (atomic: a concurrent build never sees a partial file)."""
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"{proc.args[0]} failed for {proc.args[-1]}:\n{log}")
    os.replace(tmp, out)
    return out


def build_library(src: Path, compiler: str, flags) -> Path:
    """Build ``src`` at first use; the hashed library's path."""
    started = start_build(src, compiler, flags)
    return hashed_library(src, flags) if started is None else finish_build(started)


def library_path(name: str) -> Path:
    return hashed_library(CSRC / f"{name}.cu", NVCC_FLAGS)


def build_all(names=SOURCES) -> dict[str, Path]:
    """Compile every listed source, all ``nvcc`` processes at once."""
    todo = [name for name in names if not library_path(name).exists()]
    started = [start_build(CSRC / f"{name}.cu", nvcc(), NVCC_FLAGS) for name in todo]
    for s in started:
        if s is not None:
            finish_build(s)
    return {name: library_path(name) for name in names}


def raise_on_error(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise when a launch function of ``lib`` returned a CUDA error code."""
    if rc != 0:
        lib.madicp_cuda_error_string.restype = ctypes.c_char_p
        lib.madicp_cuda_error_string.argtypes = [ctypes.c_int]
        msg = lib.madicp_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg} ({rc})")


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built at first use."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build_all((name,))[name]))
        _loaded[name] = lib
    return lib


class Launcher:
    """The launch functions of ``csrc/<name>.cu``: ``launcher(fn, dtype,
    device, *args)`` calls its ``<fn>_f32`` or ``<fn>_f64`` entry (by
    ``dtype``) with ``args`` and ``device``'s current stream, on that
    device; it raises on the CUDA error code the entry returns and
    counts one launch in ``counter``. ``argtypes`` maps each ``fn`` to
    the ctypes of its arguments, the stream last."""

    def __init__(self, name: str, argtypes: dict, counter: LaunchCounter):
        self.name, self.argtypes, self.counter = name, argtypes, counter
        self._fns: dict = {}

    def _fn(self, fn: str, dtype: torch.dtype):
        entry = self._fns.get((fn, dtype))
        if entry is None:
            entry = getattr(load(self.name), f"{fn}_{'f32' if dtype == torch.float32 else 'f64'}")
            entry.argtypes = self.argtypes[fn]
            entry.restype = ctypes.c_int
            self._fns[(fn, dtype)] = entry
        return entry

    def __call__(self, fn: str, dtype: torch.dtype, dev: torch.device, *args) -> None:
        current = dev.index == torch.cuda.current_device()
        with contextlib.nullcontext() if current else torch.cuda.device(dev):
            rc = self._fn(fn, dtype)(*args, torch.cuda.current_stream(dev).cuda_stream)
        if rc:
            raise_on_error(load(self.name), rc, f"{self.name} {fn}")
        self.counter.launches += 1
