"""Variants of the package's CUDA sources, built only here: for tracing
where a kernel's time goes and for A/Bs that the package ships no switch
for. Used by :mod:`madicp_tpu_torch.probes.kernel_trace` on the card.

- :func:`build_variant` compiles ``csrc/<name>.cu`` with extra ``-D``
  flags and/or a text transform into ``build/madicp_tpu_torch/variants/``
  (keyed by a hash of the text and the flags) and loads it;
  :func:`use_variant` makes a wrapper launch it in place of the package's
  library (its argument handling, counts and checks unchanged).
- :func:`stamp_source` inserts ``clock64`` stamps at a kernel's phase
  boundaries (``// phase: <name>`` lines); :func:`read_stamps` reads the
  cycles of block 0's thread 0 back.
- :func:`launch_source` varies how K10's or K11's kernel is launched
  and what it does where it would wait for the kernel before it;
  :func:`programmatic_source` makes it a programmatic dependent of that
  kernel (Hopper's programmatic dependent launch, which the package does
  not ship: PERF.md §6, PR 15).
- :func:`ring_write_split_source` cuts K13 into the two launches of its
  rejected form, the frame record alone and then the promotion alone
  (PERF.md §6, PR 18).
- :data:`TAIL_ONE_BLOCK` is K14's tail in its earlier one-block design
  (``probes/csrc/tail_one_block.cu``), :func:`tail_one_block` launches it
  with fresh outputs, and :func:`tail_cut_source` cuts it to the flag
  counts alone or to the chain alone (the velocity, LU and window-pose
  warps with the counts from constants), to attribute its time.
- :func:`sass_counts` counts each kernel's SASS instructions
  (``cuobjdump -sass``); :func:`graph_edges` counts a CUDA graph's edges
  and its programmatic ones (libcuda).
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import re
import subprocess
from pathlib import Path

import torch

from madicp_tpu_torch.kernels import build

VARIANT_DIR = build.BUILD_DIR / "variants"
TAIL_ONE_BLOCK = Path(__file__).resolve().parent / "csrc" / "tail_one_block.cu"

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


# Programmatic dependent launch: a kernel launched with
# cudaLaunchAttributeProgrammaticStreamSerialization may start while the
# kernel before it on the stream still runs, once that kernel's blocks have
# all executed griddepcontrol.launch_dependents (or exited). Until it
# executes griddepcontrol.wait it may read only what the kernel right
# before it does not write. Ordering rule of these variants: a kernel
# releases its dependents only after its own wait, so when a dependent
# starts, every launch before its predecessor has completed.
LAUNCH_HEADER = r"""
#include <cuda_runtime.h>
template <int NATTRS, typename... Params, typename... Args>
static cudaError_t madicp_launch_ex(void (*kernel)(Params...), dim3 grid, dim3 block,
                                    cudaStream_t stream, Args... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = NATTRS;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}
"""
# where each kernel waits for the kernel before it: K10 before it reads
# anything (H and b are K7's output); K11 after it has loaded the slack,
# the leaves, their norms and flags (the slack's writer, K6, ran two
# launches back), before it reads the poses (X is K10's output)
PDL_WAIT_BEFORE = {"gn_update": r"^  if \(s >= n\) return;",
                   "certify_slack": r"^  // phase: bound"}
# what a variant puts at that point
AT_WAIT = {"griddepcontrol": ('asm volatile("griddepcontrol.wait;" ::: "memory"); '
                              'asm volatile("griddepcontrol.launch_dependents;" ::: "memory");'),
           "barrier": 'asm volatile("" ::: "memory");'}  # a compiler barrier alone
LAUNCH = re.compile(r"(\S+)<<<grid, block, 0, stream>>>\(")


def launch_source(name: str, text: str, at_wait: str = None, launch: str = None) -> str:
    """``csrc/<name>.cu``'s ``text`` (K10 or K11) with :data:`AT_WAIT`\
    ``[at_wait]`` at its :data:`PDL_WAIT_BEFORE` point and its ``<<<>>>``
    launch made by ``cudaLaunchKernelEx``: ``launch="ex"`` with no
    attribute, ``"programmatic"`` as a programmatic dependent (the
    launcher's ``cudaGetLastError`` still reports a refused launch)."""
    lines = text.split("\n")
    at = [i for i, line in enumerate(lines) if re.match(PDL_WAIT_BEFORE[name], line)]
    if len(at) != 1 or len(LAUNCH.findall(text)) != 1:
        raise ValueError(f"launch_source: {name}'s wait point or launch changed")
    if at_wait:
        lines.insert(at[0], "  " + AT_WAIT[at_wait])
    text = "\n".join(lines)
    if launch:
        n = {"ex": 0, "programmatic": 1}[launch]
        text = LAUNCH_HEADER + LAUNCH.sub(rf"madicp_launch_ex<{n}>(\1, grid, block, stream, ", text)
    return text


def programmatic_source(name: str, text: str) -> str:
    """``text`` with its kernel waiting for, then releasing, the kernel
    before it and launched as its programmatic dependent."""
    return launch_source(name, text, "griddepcontrol", "programmatic")


# K13's lines the two-launch form cuts at: the merged kernel's promotion
# store, and the statement before which the promotion alone returns
RING_PROMOTE = r"^  if \(write\) \*key = pl\.y == pl\.x \? ov : \*src;$"
RING_FRAME_START = r"^  V v = \{\};$"
RING_PROMOTE_ONLY = ("  if (!write) return;  // the whole block: b is the block's\n"
                     "  if (in) *key = *src;\n  return;")


def ring_write_split_source(text: str, part: str) -> str:
    """``csrc/ring_write.cu``'s ``text`` as one of the two launches of its
    two-launch form: ``part="frame"`` writes the moved tree into the
    window and copies nothing; ``part="promote"``, launched after it with
    the same arguments, copies the window's tree ``best`` into the
    keyframe slot where ``write`` (a block of a sequence that does not
    write reads one flag and exits) and moves nothing."""
    lines = text.split("\n")
    at = {key: [i for i, line in enumerate(lines) if re.match(pattern, line)]
          for key, pattern in (("promote", RING_PROMOTE), ("frame", RING_FRAME_START))}
    if any(len(v) != 1 for v in at.values()):
        raise ValueError("ring_write_split_source: the kernel's promotion store or frame "
                         "record changed")
    if part == "frame":
        del lines[at["promote"][0]]
    elif part == "promote":
        lines.insert(at["frame"][0], RING_PROMOTE_ONLY)
    else:
        raise ValueError(f"ring_write_split_source: part must be frame or promote, got {part!r}")
    return "\n".join(lines)


# the one-block tail's branches: the three chain warps', and the flag
# count's (the line after it marks the phase)
TAIL_CHAIN_BRANCHES = (r"^  if \(warp == 1\) \{$", r"^  \} else if \(warp == 2\) \{$",
                       r"^  \} else if \(warp == 3\) \{$")
TAIL_COUNT_BRANCH = r"^  \} else \{$"
TAIL_COUNT_ONLY = "  } else if (warp == 0 || warp >= 4) {"
# the count's loads: from this line up to the first "#pragma unroll" after it
TAIL_COUNT_LOADS = r"^    int nv = 0, nm = 0, done = 0;$"
TAIL_CONSTANT_COUNTS = "    int nv = 200, nm = 190;  // no flag is loaded"


def tail_cut_source(text: str, keep: str) -> str:
    """The one-block tail's source ``text`` (:data:`TAIL_ONE_BLOCK`) cut
    to ``keep="counts"``: the velocity, LU and window-pose warps do
    nothing (each of their branches never taken), the five count warps
    count, warp 0 forms the window from an unset ``-log det``; or to
    ``keep="chain"``: no flag is loaded, each count thread starts from
    constants (a ratio of 0.95), and the three chain warps and warp 0
    run as in the kernel."""
    lines = text.split("\n")
    find = lambda pattern: [i for i, line in enumerate(lines)  # noqa: E731
                            if re.match(pattern, line)]
    chain = [find(p) for p in TAIL_CHAIN_BRANCHES]
    count = [i for i in find(TAIL_COUNT_BRANCH) if lines[i + 1].strip() == "// phase: counts"]
    loads = find(TAIL_COUNT_LOADS)
    if any(len(at) != 1 for at in chain) or len(count) != 1 or len(loads) != 1:
        raise ValueError("tail_cut_source: the tail's branches or its count loads changed")
    if keep == "counts":
        for (at,), cond in zip(chain, ("  if (false) {", "  } else if (false) {",
                                      "  } else if (false) {")):
            lines[at] = cond
        lines[count[0]] = TAIL_COUNT_ONLY
    elif keep == "chain":
        end = next(i for i in range(loads[0], len(lines)) if lines[i] == "#pragma unroll")
        lines[loads[0]:end] = [TAIL_CONSTANT_COUNTS]
    else:
        raise ValueError(f"tail_cut_source: keep must be counts or chain, got {keep!r}")
    return "\n".join(lines)


def tail_one_block(lib: ctypes.CDLL, state, X, H, matched, valid, hz, *, p_th: float,
                   num_keyframes: int, kf_offset: int = 0):
    """The step's tail by the one-block kernel of ``lib`` (a build of
    :data:`TAIL_ONE_BLOCK` or a cut of it) on contiguous CUDA tensors:
    arguments and result as ``step_scalars.tail`` without ``out``, every
    field of the result a fresh tensor; one count on K14's counter."""
    from madicp_tpu_torch.kernels import step_scalars as k14

    B, L, W, F, K_l = k14._check_tail(state, X, H, matched, valid, hz, num_keyframes, kf_offset)
    f, i32 = dict(dtype=X.dtype, device=X.device), dict(dtype=torch.int32, device=X.device)
    flag = dict(dtype=torch.bool, device=X.device)
    out = k14.Tail(
        velocity=torch.empty((B, 6), **f), traj=torch.empty((B, W, 4, 4), **f),
        traj_count=torch.empty(B, **i32), ratio=torch.empty(B, **f),
        n_leaves=torch.empty(B, dtype=torch.int64, device=X.device),
        promote=torch.empty(B, **flag), fr_valid=torch.empty((B, F), **flag),
        fr_weight=torch.empty((B, F), **f), fr_seq=torch.empty((B, F), **i32),
        fr_pose=torch.empty((B, F, 4, 4), **f), fr_head=torch.empty(B, **i32),
        kf_valid=torch.empty((B, K_l), **flag), kf_head=torch.empty(B, **i32),
        keyframe_to_map=torch.empty((B, 4, 4), **f), seq_keyframe=torch.empty(B, **i32),
        seq=torch.empty(B, **i32), plan=torch.empty((B, 4), **i32))
    ins = [X, H, matched, valid, hz] + [getattr(state, name) for name, _, _ in k14._STATE]
    if not all(t.is_contiguous() for t in ins):
        raise ValueError("tail_one_block: every operand must be contiguous")
    in_ptrs = (ctypes.c_void_p * len(ins))(*(t.data_ptr() for t in ins))
    out_ptrs = (ctypes.c_void_p * len(out))(*(t.data_ptr() for t in out))  # TailOut's order
    dims = (ctypes.c_int * 6)(L, W, F, K_l, num_keyframes, kf_offset)
    fn = getattr(lib, "tail_f32" if X.dtype == torch.float32 else "tail_f64")
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_double, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(X.device):
        rc = fn(ctypes.addressof(in_ptrs), ctypes.addressof(out_ptrs), ctypes.addressof(dims),
                float(p_th), B, torch.cuda.current_stream(X.device).cuda_stream)
    build.raise_on_error(lib, rc, "tail_one_block")
    k14.counter.launches += 1
    return out


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


class _EdgeData(ctypes.Structure):  # CUgraphEdgeData
    _fields_ = [("from_port", ctypes.c_ubyte), ("to_port", ctypes.c_ubyte),
                ("type", ctypes.c_ubyte), ("reserved", ctypes.c_ubyte * 5)]


CU_GRAPH_DEPENDENCY_TYPE_PROGRAMMATIC = 1


def graph_edges(raw_graph: int) -> dict:
    """{"edges", "programmatic"} of a captured CUDA graph (its
    ``cudaGraph_t`` as an integer: ``CUDAGraph(keep_graph=True)``'s
    ``raw_cuda_graph()``), from libcuda's ``cuGraphGetEdges_v2``."""
    lib = ctypes.CDLL("libcuda.so.1")
    fn = lib.cuGraphGetEdges_v2
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.POINTER(ctypes.c_size_t)]
    n = ctypes.c_size_t(0)
    rc = fn(raw_graph, None, None, None, ctypes.byref(n))
    if rc:
        raise RuntimeError(f"cuGraphGetEdges_v2 failed with CUresult {rc}")
    nodes = (ctypes.c_void_p * max(n.value, 1))
    data = (_EdgeData * max(n.value, 1))()
    rc = fn(raw_graph, nodes(), nodes(), data, ctypes.byref(n))
    if rc:
        raise RuntimeError(f"cuGraphGetEdges_v2 failed with CUresult {rc}")
    prog = sum(data[i].type == CU_GRAPH_DEPENDENCY_TYPE_PROGRAMMATIC for i in range(n.value))
    return {"edges": n.value, "programmatic": prog}
