"""The odometry step as captured CUDA graphs over static buffers.

Counterpart of the JAX package's compiled, donated step
(``madicp_tpu/models/pipeline.py:837-873``): there a scan is one compiled
program that updates the state's buffers in place; here a scan is the
replay of one ``torch.cuda.CUDAGraph`` that reads its inputs from static
buffers and leaves the new state in the state's own tensors.

- :func:`step_in_place` is the captured body: ``odometry_step``, then the
  new state copied into the state's tensors (the rings are written in
  place already). It is a plain function on tensors; every eager step
  (on the CPU, the first scans, under a timer, on a mesh) runs it too.
- :class:`StepGraphs` holds one batch's static buffers — the state's 16
  fields, the points ``(B, N, 3)`` and the masks ``(B, N)`` — and one
  graph per configuration, the counterpart of a jit cache entry (the
  configuration holds ``max_icp_iterations``; the batch is fixed). The
  graphs read and write the same buffers and share one memory pool: they
  never run at once, and each replay's output is cloned out of the pool
  at once, so a graph that later reuses that memory clobbers nothing
  that is still read.
- The first odometry scan runs eagerly on a side stream, as torch's
  capture recipe warms up: it builds the kernels, creates the cuBLAS and
  cuSOLVER handles and workspaces, and is that scan's own result (the
  rings never advance twice). A graph is captured just before its first
  replay, so from the second odometry scan on every scan is a replay; a
  configuration first met later (the realtime budget's new iteration
  count) is captured at its first scan. A capture that fails raises:
  nothing falls back to an eager step.
- A replay launches the step's kernels (the segment-sum, the build's node
  and point passes, the descent and the ICP terms) without passing
  through their wrappers, so each graph
  adds the launches its capture recorded to each kernel's counter on
  every replay.
"""

from __future__ import annotations

import ctypes
import time
from typing import NamedTuple

import torch

from madicp_tpu_torch.kernels import build_nodes, build_points, descent, icp_terms, segsum
from madicp_tpu_torch.models.pipeline import (
    PipelineState,
    StepOutput,
    _map,
    initialize_step,
    odometry_step,
)
from madicp_tpu_torch.ops.tree import SearchTree


# the launch counter of every kernel the step runs, by wrapper name
COUNTERS = {"segsum_moments": segsum.counter, "descend": descent.counter,
            "icp_terms": icp_terms.counter, "build_nodes": build_nodes.counter,
            "build_points": build_points.counter}


def _tensors(state: PipelineState):
    return (f.nav if isinstance(f, SearchTree) else f for f in state)


def write_state(dst: PipelineState, src: PipelineState) -> None:
    """Copy every field of ``src`` into the tensor of ``dst`` that holds
    it (a field that already is that memory is left alone). Shapes must
    match: a copy that broadcast would corrupt the state silently."""
    for name, d, s in zip(dst._fields, _tensors(dst), _tensors(src)):
        if s.shape != d.shape:
            raise ValueError(f"state field {name}: shape {tuple(s.shape)}, the buffers "
                             f"hold {tuple(d.shape)}")
        if s is d or (s.device == d.device and s.data_ptr() == d.data_ptr()
                      and s.is_contiguous() and d.is_contiguous()):
            continue
        d.copy_(s)


def step_in_place(cfg, state: PipelineState, points, valid, timer=None,
                  **kw) -> StepOutput:
    """One odometry step that leaves the new state in ``state``'s own
    tensors; returns the step's output, which aliases none of them.
    ``kw``: :func:`~madicp_tpu_torch.models.pipeline.odometry_step`'s
    keywords (the keyframe-sharded step's)."""
    new, out = odometry_step(cfg, state, points, valid, None, timer, **kw)
    write_state(state, new)
    return out


class _Graph(NamedTuple):
    graph: torch.cuda.CUDAGraph
    out: StepOutput  # in the pool: cloned after every replay
    launches: dict  # kernel name -> its launches a replay
    capture_ms: float
    nodes: int


def graph_nodes(graph: torch.cuda.CUDAGraph) -> int:
    """Node count of a graph captured with ``keep_graph=True``, from
    ``cuGraphGetNodes`` of libcuda."""
    lib = ctypes.CDLL("libcuda.so.1")
    lib.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.POINTER(ctypes.c_size_t)]
    n = ctypes.c_size_t(0)
    rc = lib.cuGraphGetNodes(graph.raw_cuda_graph(), None, ctypes.byref(n))
    if rc:
        raise RuntimeError(f"cuGraphGetNodes failed with CUresult {rc}")
    return n.value


class StepGraphs:
    """A batch's state in static buffers, stepped eagerly or by replaying
    one captured graph a configuration (see the module docstring).

    ``state``: a batched state (leading B on every field) whose tensors
    become the static buffers. On the CPU every step is eager."""

    def __init__(self, state: PipelineState, n_points: int, dtype):
        self.state = state
        dev = state.X.device
        self._cuda = dev.type == "cuda"
        self._graphs: dict = {}
        self._warm = False
        if self._cuda:
            B = state.X.shape[0]
            self.points = torch.zeros((B, n_points, 3), dtype=dtype, device=dev)
            self.valid = torch.zeros((B, n_points), dtype=torch.bool, device=dev)
            self._pool = torch.cuda.graph_pool_handle()

    def assign(self, state: PipelineState) -> None:
        """Copy ``state`` (same shapes, any device) into the static
        buffers; the captured graphs go on reading them."""
        write_state(self.state, state)

    def initialize(self, cfg, points, valid, timer=None, **kw) -> StepOutput:
        """The first scan's bootstrap, eagerly, into the buffers."""
        new, out = initialize_step(cfg, self.state, points, valid, None, timer, **kw)
        write_state(self.state, new)
        return out

    def step(self, cfg, points, valid, timer=None, **kw) -> StepOutput:
        """One odometry step of every sequence: a replay of ``cfg``'s
        graph on CUDA from the second odometry scan on; eager on the CPU,
        with a ``timer`` (its events cannot be replayed) and with ``kw``
        (the keyframe-sharded step issues collectives). The output is the
        caller's own: it aliases no buffer and no later step changes it."""
        if not self._cuda or timer is not None or kw:
            return step_in_place(cfg, self.state, points, valid, timer, **kw)
        if not self._warm:
            return self._warm_up(cfg, points, valid)
        if points is not self.points:
            self.points.copy_(points)
            self.valid.copy_(valid)
        g = self._graphs.get(cfg)
        if g is None:
            g = self._graphs[cfg] = self._capture(cfg)
        g.graph.replay()
        for name, n in g.launches.items():
            COUNTERS[name].launches += n
        return _map(torch.clone, g.out)

    def _warm_up(self, cfg, points, valid) -> StepOutput:
        dev = self.state.X.device
        main = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            out = step_in_place(cfg, self.state, points, valid)
        main.wait_stream(side)
        self._warm = True
        for t in out:  # made on the side stream, read on the caller's
            t.record_stream(main)
        return out

    def _capture(self, cfg) -> _Graph:
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        before = {name: c.launches for name, c in COUNTERS.items()}
        t0 = time.perf_counter()
        # thread_local: a thread that stages the next scan (the CLI's
        # prefetcher copies to the card) does not break the capture
        with torch.cuda.graph(graph, pool=self._pool, capture_error_mode="thread_local"):
            out = step_in_place(cfg, self.state, self.points, self.valid)
        graph.instantiate()
        capture_ms = (time.perf_counter() - t0) * 1e3
        launches = {}
        for name, c in COUNTERS.items():  # a capture runs nothing
            launches[name] = c.launches - before[name]
            c.launches = before[name]
        return _Graph(graph, out, launches, capture_ms, graph_nodes(graph))

    def ready(self, cfg) -> bool:
        """Whether a step of ``cfg`` now runs as it will from here on: on
        the CPU always, on CUDA once its graph is captured."""
        return not self._cuda or cfg in self._graphs

    def captured(self) -> dict:
        """{configuration: (capture ms, nodes, {kernel name: launches a
        replay})} of every graph captured so far."""
        return {cfg: (g.capture_ms, g.nodes, g.launches) for cfg, g in self._graphs.items()}

    def pool_bytes(self) -> int:
        """Bytes the caching allocator holds in this object's graph pool."""
        pool = tuple(self._pool)
        return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
                   if tuple(s["segment_pool_id"]) == pool)
