"""The ``(seq, kf)`` process mesh and which state fields it splits.

One process holds one device, so a mesh is a grid of ranks: a
:class:`~torch.distributed.device_mesh.DeviceMesh` of shape ``(seq, kf)``
with dimension names ``("seq", "kf")``. Rank ``r`` sits at ``seq = r //
kf``, ``kf = r % kf`` (the JAX package's row-major device grid). The
``kf`` group should be the fastest link: the keyframe-sharded step
all-reduces its 6x6 normal equations over it once a GN round. ``seq``
carries nothing inside a step (sequences never communicate).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from madicp_tpu_torch.models.pipeline import PipelineState
from madicp_tpu_torch.ops.tree import SearchTree


def make_mesh(kf: int = 1, seq: int = 1):
    """Create the ``(seq, kf)`` mesh over the ranks of the world, which
    must hold exactly ``seq * kf`` processes (see
    :mod:`madicp_tpu_torch.parallel.distributed`). Raises ``ValueError``
    outside such a world: a mesh is never run on one process quietly."""
    from torch.distributed.device_mesh import init_device_mesh

    need = kf * seq
    if kf < 1 or seq < 1:
        raise ValueError(f"mesh axes must be >= 1, got seq={seq}, kf={kf}")
    if not dist.is_initialized():
        raise ValueError(
            f"a (seq={seq}, kf={kf}) mesh needs a torch.distributed world of {need} "
            f"processes: launch with python -m torch.distributed.run "
            f"--nproc-per-node {need} ... and call parallel.distributed.initialize()")
    if dist.get_world_size() != need:
        raise ValueError(f"need {need} processes, have {dist.get_world_size()}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (seq, kf), mesh_dim_names=("seq", "kf"))


def axis_size(mesh, name: str) -> int:
    """Ranks along the mesh axis ``name`` (1 for ``mesh=None``)."""
    if mesh is None:
        return 1
    return mesh.size(mesh.mesh_dim_names.index(name))


def axis_index(mesh, name: str) -> int:
    """This rank's coordinate along the mesh axis ``name``."""
    if mesh is None:
        return 0
    return mesh.get_local_rank(name)


def state_shardings(batched: bool = False) -> PipelineState:
    """Which mesh axis splits each leading axis of every state field (the
    JAX package's ``PartitionSpec`` layout, ``parallel/mesh.py:57-86``):
    the keyframe ring (``kf_tree``, ``kf_valid``) along K over ``kf``,
    everything else whole (it is small: poses, windows, counters; the
    frame window stays whole because a promotion copies across the two
    rings). With ``batched=True`` every field gains a leading sequence
    axis split over ``seq``. Each entry is a tuple of axis names or
    ``None``, one per leading axis."""
    b = ("seq",) if batched else ()
    rep = b
    return PipelineState(
        X=rep, velocity=rep, traj=rep, traj_count=rep,
        kf_tree=SearchTree(nav=b + ("kf",)), kf_valid=b + ("kf",), kf_head=rep,
        keyframe_to_map=rep, fr_tree=SearchTree(nav=rep), fr_valid=rep,
        fr_weight=rep, fr_seq=rep, fr_pose=rep, fr_head=rep, seq=rep,
        seq_keyframe=rep,
    )


def take_block(x, spec, coords: dict):
    """The block of ``x`` at ``coords``: each leading axis named in
    ``spec`` (a tuple of mesh axis names or ``None``) whose name is in
    ``coords`` (``{name: (index, count)}``) is cut into ``count`` equal
    blocks and block ``index`` is kept. Works on numpy arrays and tensors
    alike (a tensor's block is a view)."""
    for dim, name in enumerate(spec):
        if name not in coords:
            continue
        i, n = coords[name]
        size = x.shape[dim]
        if size % n:
            raise ValueError(f"axis {dim} of size {size} does not split over {n} ranks "
                             f"of mesh axis {name!r}")
        w = size // n
        x = x[(slice(None),) * dim + (slice(i * w, (i + 1) * w),)]
    return x


def make_global(x, spec, mesh):
    """This rank's share of a value every process holds in full: each
    leading axis named in ``spec`` is cut into equal blocks along its mesh
    axis and this rank's block is kept (the counterpart of the JAX
    package's ``make_global``)."""
    return take_block(x, spec, {name: (axis_index(mesh, name), axis_size(mesh, name))
                                for name in spec if name is not None})


def read_replicated(t) -> np.ndarray:
    """This rank's copy of a replicated value, as numpy."""
    if isinstance(t, torch.Tensor):
        return t.detach().to("cpu", copy=True).numpy()
    return np.asarray(t)

