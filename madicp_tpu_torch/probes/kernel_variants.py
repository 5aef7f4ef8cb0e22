"""Variants of the package's CUDA sources, built only here, for tracing
where a kernel's time goes. Used by
:mod:`madicp_tpu_torch.probes.kernel_trace` on the card.

- :func:`build_variant` compiles ``csrc/<name>.cu`` with extra ``-D``
  flags and/or a text transform into ``build/madicp_tpu_torch/variants/``
  (keyed by a hash of the text and the flags) and loads it;
  :func:`use_variant` makes a wrapper launch it in place of the package's
  library (its argument handling, counts and checks unchanged).
- :func:`stamp_source` inserts ``clock64`` stamps at a kernel's phase
  boundaries (``// phase: <name>`` lines); :func:`read_stamps` reads the
  cycles of block 0's thread 0 back, :func:`read_warp_stamps` those of
  each warp of block 0.
- :func:`sass_counts` counts each kernel's SASS instructions
  (``cuobjdump -sass``).
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import re
import subprocess
from pathlib import Path

from madicp_tpu_torch.kernels import build

VARIANT_DIR = build.BUILD_DIR / "variants"

STAMP_HEADER = r"""
__device__ long long madicp_stamps[32];
#define MADICP_STAMP(i)                                                     \
  do {                                                                      \
    long long t_;                                                           \
    asm volatile("mov.u64 %0, %%clock64;" : "=l"(t_)::"memory");           \
    if (blockIdx.x == 0 && threadIdx.x == 0) madicp_stamps[i] = t_;         \
  } while (0)
"""
STAMP_FOOTER = r"""
extern "C" int madicp_read_stamps(long long* host, int n) {
  return static_cast<int>(cudaMemcpyFromSymbol(host, madicp_stamps, n * sizeof(long long)));
}
"""


# per_warp: lane 0 of every warp of block 0 stamps its own slot of a
# phase, so warps that run different branches are read apart
STAMP_WARPS = 32
STAMP_PER_WARP_HEADER = r"""
__device__ long long madicp_stamps[32 * 32];
#define MADICP_STAMP(i)                                                     \
  do {                                                                      \
    long long t_;                                                           \
    asm volatile("mov.u64 %0, %%clock64;" : "=l"(t_)::"memory");           \
    if (blockIdx.x == 0 && (threadIdx.x & 31) == 0)                         \
      madicp_stamps[(i) * 32 + (threadIdx.x >> 5)] = t_;                    \
  } while (0)
"""
STAMP_CLEAR = r"""
extern "C" int madicp_clear_stamps(int n) {
  static long long zeros[32 * 32] = {};
  return static_cast<int>(cudaMemcpyToSymbol(madicp_stamps, zeros, n * sizeof(long long)));
}
"""


def stamp_source(text: str, per_warp: bool = False) -> tuple:
    """(instrumented source, phase labels): a ``MADICP_STAMP(i)`` before
    each ``// phase: <label>`` line; phase i runs from stamp i to stamp
    i + 1. The stamp's ``memory`` clobber keeps loads and stores on their
    side of it, not the arithmetic, so the split is approximate. With
    ``per_warp`` each warp of block 0 keeps its own stamp of a phase
    (:func:`read_warp_stamps`); else block 0's thread 0 stamps."""
    lines = text.split("\n")
    marks = [(i, m.group(1)) for i, line in enumerate(lines)
             if (m := re.match(r"^\s*// phase: (\w+)", line))]
    if not marks:
        raise ValueError("stamp_source: the source marks no phase")
    out = list(lines)
    for n, (i, label) in enumerate(reversed(marks)):
        out.insert(i, f"  MADICP_STAMP({len(marks) - 1 - n});")
    labels = [label for _, label in marks]
    if len(labels) > 32:
        raise ValueError(f"stamp_source: {len(labels)} phases, at most 32")
    header = STAMP_PER_WARP_HEADER if per_warp else STAMP_HEADER
    return header + "\n".join(out) + STAMP_FOOTER + STAMP_CLEAR, labels


def build_variant(name: str, defines=(), transform=None, source: str = None) -> tuple:
    """(loaded library, its path) of ``csrc/<name>.cu`` (or ``source``)
    after ``transform`` (text to text), built with the package's flags
    and ``-D`` each of ``defines``; the headers beside the sources are
    found as the package's are."""
    text = source if source is not None else (build.CSRC / f"{name}.cu").read_text()
    if transform is not None:
        text = transform(text)
    flags = (*build.NVCC_FLAGS, f"-I{build.CSRC}", *(f"-D{d}" for d in defines))
    h = hashlib.sha256((text + " ".join(flags)).encode()).hexdigest()[:16]
    VARIANT_DIR.mkdir(parents=True, exist_ok=True)
    src = VARIANT_DIR / f"{name}_{h}.cu"
    lib = VARIANT_DIR / f"lib{name}_{h}.so"
    if not lib.exists():
        src.write_text(text)
        proc = subprocess.run([build.nvcc(), *flags, "-o", str(lib), str(src)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the {name} variant:\n{proc.stdout}"
                               f"{proc.stderr}")
    return ctypes.CDLL(str(lib)), lib


@contextlib.contextmanager
def use_variant(launcher: build.Launcher, lib: ctypes.CDLL):
    """Within the block ``launcher`` (a wrapper's ``_launch``) calls
    ``lib``'s entries in place of the package library's."""
    saved_lib, saved_fns = build._loaded.get(launcher.name), launcher._fns
    build._loaded[launcher.name], launcher._fns = lib, {}
    try:
        yield
    finally:
        launcher._fns = saved_fns
        if saved_lib is None:
            build._loaded.pop(launcher.name, None)
        else:
            build._loaded[launcher.name] = saved_lib


def read_stamps(lib: ctypes.CDLL, n: int) -> list:
    """The ``n`` clock64 stamps of the last launch of a stamped variant."""
    buf = (ctypes.c_longlong * n)()
    lib.madicp_read_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.madicp_read_stamps.restype = ctypes.c_int
    build.raise_on_error(lib, lib.madicp_read_stamps(buf, n), "read_stamps")
    return list(buf)


def clear_stamps(lib: ctypes.CDLL) -> None:
    """Zero a stamped variant's stamps (before the launch to read)."""
    lib.madicp_clear_stamps.argtypes = [ctypes.c_int]
    lib.madicp_clear_stamps.restype = ctypes.c_int
    build.raise_on_error(lib, lib.madicp_clear_stamps(32 * STAMP_WARPS), "clear_stamps")


def read_warp_stamps(lib: ctypes.CDLL, labels: list) -> dict:
    """{phase label: {warp: clock64 cycles after the first stamp of the
    launch}} of a ``per_warp`` stamped variant's last launch (block 0;
    the phases a warp never reached left out; a label the source marks
    twice gets its index)."""
    raw = read_stamps(lib, 32 * STAMP_WARPS)
    t0 = min((t for t in raw if t), default=0)
    return {(label if labels.count(label) == 1 else f"{label}_{i}"):
            {w: raw[i * STAMP_WARPS + w] - t0 for w in range(STAMP_WARPS)
             if raw[i * STAMP_WARPS + w]}
            for i, label in enumerate(labels)}


def sass_counts(lib_path: Path) -> dict:
    """{mangled kernel: SASS instructions} of a built library
    (``cuobjdump -sass``; the NOP padding excluded)."""
    tool = Path(build.nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(tool), "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True).stdout
    out, cur = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = m.group(1)
            out[cur] = 0
        elif cur and re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+\S", line) and " NOP" not in line:
            out[cur] += 1
    return out
