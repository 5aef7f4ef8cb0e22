"""Fleet mode: many sequences stepped as one batch.

The reference processes one sequence per process (SURVEY.md §2 P4). A
fleet holds one pipeline state per sequence, stacked on a leading batch
axis, and advances every sequence with one batched step: the batch folds
into the flat axes the step already has (the build's segments, the
rings' rows, the association's queries), so a scan of B sequences issues
the kernels of one scan. The JAX package's fleet is ``jax.vmap`` of its
step; here the batch axis is explicit, and each sequence's keyframe
promotion is masked on the device (no host read inside a step).

With a mesh (:mod:`madicp_tpu_torch.parallel.mesh`) the batch splits over
the ``seq`` axis (each rank steps its B/seq sequences; nothing crosses
``seq`` inside a step) and each sequence's keyframe ring over the ``kf``
axis (:mod:`madicp_tpu_torch.parallel.sharded_icp`).

The states live in static buffers
(:class:`~madicp_tpu_torch.models.step_graph.StepGraphs`). Without a mesh,
on CUDA, a batched scan is the replay of one captured graph from the
second odometry scan on. With a mesh the step issues
``torch.distributed`` collectives and runs eagerly (capturing them is
not done here); so do the first two scans and every scan on the CPU.
:attr:`Fleet.trace` switches the program's trace on, as
``Pipeline.trace`` does: ``madicp.compute`` (with ``madicp.copy_in``,
``madicp.replay`` and ``madicp.clone_out``) and ``madicp.pose`` (with
``madicp.pose.wait``) on the host, the step's phases on the device.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from madicp_tpu_torch.models.pipeline import (
    PipelineConfig,
    PipelineState,
    StepOutput,
    init_state,
)
from madicp_tpu_torch.models.step_graph import StepGraphs
from madicp_tpu_torch.utils.timing import host_span
from madicp_tpu_torch.parallel.mesh import (
    axis_index,
    axis_size,
    make_global,
    read_replicated,
)


class Fleet:
    """Batched odometry over ``n_seq`` independent sequences."""

    def __init__(
        self,
        cfg: PipelineConfig,
        n_seq: int,
        mesh=None,
        shard_points: bool = False,
        device=None,
    ):
        """``mesh``: a ``(seq, kf)`` mesh of the world's ranks (None: this
        process steps every sequence with its whole ring). ``shard_points``
        (needs a mesh with a ``kf`` axis) also splits each scan's tree
        build over ``kf``; its results differ from the replicated build
        only by the order of partial sums. ``device``: CUDA unless the
        caller names another (a bare ``"cuda"`` takes the local rank's
        card); raises on a host without CUDA unless given ``"cpu"``."""
        from madicp_tpu_torch.kernels import segsum
        from madicp_tpu_torch.parallel.distributed import local_device
        from madicp_tpu_torch.parallel.sharded_icp import kf_rounds_fn, points_shard

        if shard_points and (mesh is None or "kf" not in mesh.mesh_dim_names):
            raise ValueError("shard_points needs a mesh with a 'kf' axis")
        if mesh is not None and "seq" not in mesh.mesh_dim_names:
            raise ValueError("fleet mesh needs a 'seq' axis")
        self.cfg = cfg
        self.n_seq = n_seq
        self.mesh = mesh
        self.device = local_device(device)
        n_s, i_s = axis_size(mesh, "seq"), axis_index(mesh, "seq")
        n_kf, i_kf = axis_size(mesh, "kf"), axis_index(mesh, "kf")
        if n_seq % n_s:
            raise ValueError(f"{n_seq} sequences do not split over a seq axis of {n_s}")
        if cfg.num_keyframes % n_kf:
            raise ValueError(f"{cfg.num_keyframes} keyframes do not split over a kf "
                             f"axis of {n_kf}")
        b = n_seq // n_s
        self.sequences = range(i_s * b, (i_s + 1) * b)  # this rank's
        self._kf_offset = i_kf * (cfg.num_keyframes // n_kf)
        self._rounds = None if mesh is None else kf_rounds_fn(cfg, mesh.get_group("kf"))
        self._shard = (points_shard(mesh.get_group("kf"), i_kf, n_kf, cfg.n_points)
                       if shard_points else None)
        self._graphs = StepGraphs(
            init_state(cfg, self.device, batch=b, num_keyframes=cfg.num_keyframes // n_kf),
            cfg.n_points, cfg.dtype)
        self._initialized = False
        self.trace = None  # utils.timing.Trace while on
        if self.device.type == "cuda":
            # the build's widest level: B * 2^depth segments. Its workspace
            # is allocated now, before anything could capture the step
            n_pts = b * (cfg.n_points // n_kf if shard_points else cfg.n_points)
            segsum.reserve(self.device, n_pts, b << cfg.depth)

    @property
    def states(self) -> PipelineState:
        """This rank's batched states: the static buffers, which every
        scan overwrites in place (copy what must outlive a scan)."""
        return self._graphs.state

    @states.setter
    def states(self, states: PipelineState) -> None:
        """Copy batched states of this fleet's shapes into the buffers."""
        self._graphs.assign(states)

    def _local(self, x, dtype):
        """This rank's sequences of a whole batch, on the device."""
        x = x if isinstance(x, torch.Tensor) else np.asarray(x)
        if self.mesh is not None:
            x = make_global(x, ("seq",), self.mesh)
        return torch.as_tensor(x, device=self.device).to(dtype)

    def compute(self, stamps, points, valid) -> StepOutput:
        """Advance every sequence by one scan.

        Args:
            stamps: (B,) timestamps.
            points: (B, N, 3) padded clouds.
            valid:  (B, N) masks.
        Every process passes the whole batch. Returns the batched
        StepOutput of this rank's sequences (:attr:`sequences`), the
        caller's own: no later scan changes it. Sequences advance in
        lockstep, so the first scan's bootstrap is one host-side flag;
        the step itself reads nothing on the host.
        """
        del stamps
        tr = self.trace
        with host_span(tr, "madicp.compute"):
            with host_span(tr, "madicp.copy_in"):
                pts = self._local(points, self.cfg.dtype)
                val = self._local(valid, torch.bool)
            kw = {} if self.mesh is None else dict(kf_offset=self._kf_offset,
                                                   points_shard=self._shard)
            if self._initialized:
                if self.mesh is not None:
                    kw["icp_rounds_fn"] = self._rounds
                return self._graphs.step(self.cfg, pts, val, tr, **kw)
            self._initialized = True
            return self._graphs.initialize(self.cfg, pts, val, tr, **kw)

    def poses(self) -> np.ndarray:
        """(B, 4, 4) current poses of every sequence (gathered over the
        ``seq`` axis)."""
        tr = self.trace
        with host_span(tr, "madicp.pose", None if tr is None else tr.last_step):
            with host_span(tr, "madicp.pose.wait"):
                X = self.states.X
                if self.mesh is not None and axis_size(self.mesh, "seq") > 1:
                    parts = [torch.empty_like(X) for _ in range(axis_size(self.mesh, "seq"))]
                    dist.all_gather(parts, X.contiguous(), group=self.mesh.get_group("seq"))
                    X = torch.cat(parts)
                poses = read_replicated(X)
            if tr is not None:
                tr.collect()
        return poses

