"""Process groups: joining a ``torch.distributed`` world and its topology.

The JAX package joins hosts into one ``jax.distributed`` runtime and
forms a ``(seq, kf)`` mesh over the global devices. Here one process
drives one device, processes join one ``torch.distributed`` group, and
the mesh is a :class:`~torch.distributed.device_mesh.DeviceMesh` over the
ranks (:mod:`madicp_tpu_torch.parallel.mesh`). Launch N processes with

    python -m torch.distributed.run --nproc-per-node N <script or -m module> ...

whose environment names the rendezvous, or pass the coordinator's
address, the world size and the rank to :func:`initialize`. Nothing
tells a program of a cluster: ranks are taken to share one host unless
``LOCAL_WORLD_SIZE`` says otherwise.

Backend rule: NCCL when every rank has a card of its own; gloo on the
CPU, and when ranks share a card, because NCCL refuses two ranks on one
device (gloo carries CUDA tensors through the host). The backend is
chosen, never a silent fallback: ``backend="nccl"`` where ranks share a
card raises. The per-round all-reduce of the keyframe-sharded step
rides the chosen backend; :func:`barrier` always rides a gloo group, so
it has a deadline of its own (``monitored_barrier``).
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

_world: dict = {"backend": None, "barrier_group": None, "device": None}


def local_device(device=None) -> torch.device:
    """This rank's device: ``device`` if it names an index or the CPU;
    otherwise (``None`` or a bare ``"cuda"``) the card of the local rank
    modulo the cards present. Raises where CUDA is asked for and absent."""
    from madicp_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        local_rank = int(os.environ.get("LOCAL_RANK", "0"))
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
    return dev


def choose_backend(device: torch.device, local_world_size: int) -> str:
    """The backend rule of this module: ``"nccl"`` where every rank of
    this host has a card of its own, ``"gloo"`` on the CPU and where
    ranks share a card."""
    if device.type != "cuda":
        return "gloo"
    return "nccl" if local_world_size <= torch.cuda.device_count() else "gloo"


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    backend: Optional[str] = None,
    device=None,
    timeout_seconds: int = 1800,
) -> dict:
    """Join (or no-op into) a ``torch.distributed`` world.

    With no arguments, the environment of ``torch.distributed.run``
    (``WORLD_SIZE``, ``RANK``, ``MASTER_ADDR``/``MASTER_PORT``) is used.
    A world of one process is a no-op unless ``backend`` is named (then
    a one-rank group is formed, which runs every collective for real).
    ``coordinator_address`` is ``host:port`` of rank 0. ``backend``
    defaults to the module's rule; naming ``"nccl"`` where ranks share a
    card, or where the device is the CPU, raises ``ValueError``. The
    ``timeout_seconds`` deadline covers the group's set-up and its
    collectives: a cold start of one rank (kernel builds) can stall its
    peers for minutes. Returns :func:`topology`.
    """
    env_world = os.environ.get("WORLD_SIZE")
    if num_processes is None and env_world is not None:
        num_processes = int(env_world)
        process_id = int(os.environ.get("RANK", "0"))
    world = 1 if num_processes is None else int(num_processes)
    if world < 1:
        raise ValueError(f"num_processes must be >= 1, got {num_processes}")
    dev = local_device(device)
    _world["device"] = dev
    if dist.is_initialized() or (world == 1 and backend is None):
        return topology()
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    rule = choose_backend(dev, local_world)
    if backend is None:
        backend = rule
    elif backend == "nccl" and rule != "nccl":
        raise ValueError(
            f"backend='nccl' needs a card for every rank: {local_world} ranks on "
            f"this host, device {dev}, {torch.cuda.device_count()} cards; NCCL refuses "
            "two ranks on one card (use gloo)")
    elif backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got {backend!r}")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    timeout = datetime.timedelta(seconds=timeout_seconds)
    init = "env://" if coordinator_address is None else f"tcp://{coordinator_address}"
    dist.init_process_group(backend, init_method=init, world_size=world,
                            rank=0 if process_id is None else int(process_id),
                            timeout=timeout)
    _world["backend"] = backend
    _world["barrier_group"] = (dist.group.WORLD if backend == "gloo"
                               else dist.new_group(backend="gloo", timeout=timeout))
    return topology()


def shutdown() -> None:
    """Leave the world (no-op outside one)."""
    if dist.is_initialized():
        dist.destroy_process_group()
    _world.update(backend=None, barrier_group=None)


def barrier(name: str, *, timeout_seconds: int = 1800) -> None:
    """Block until every rank reaches this barrier (no-op outside a
    world of more than one process).

    A ``monitored_barrier`` on a gloo group, not a collective of the
    compute backend, so it has the explicit deadline given here and
    names the ranks that missed it. Use it to line ranks up before the
    first collective when their progress may be minutes apart (a cold
    kernel build on one rank). Reference analog: the implicit OpenMP
    barrier after the keyframe loop, ``pipeline.cpp:185``.
    """
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return
    try:
        dist.monitored_barrier(group=_world["barrier_group"],
                               timeout=datetime.timedelta(seconds=timeout_seconds),
                               wait_all_ranks=True)
    except RuntimeError as e:
        raise RuntimeError(f"barrier {name!r}: {e}") from e


def topology() -> dict:
    """Summarise the process/device topology for logging."""
    dev = _world["device"] or local_device(None if torch.cuda.is_available() else "cpu")
    on = dist.is_initialized()
    return {
        "process_index": dist.get_rank() if on else 0,
        "process_count": dist.get_world_size() if on else 1,
        "local_devices": torch.cuda.device_count() if dev.type == "cuda" else 1,
        "global_devices": dist.get_world_size() if on else 1,
        "platform": "gpu" if dev.type == "cuda" else "cpu",
        "device": str(dev),
        "backend": dist.get_backend() if on else None,
    }


def fleet_mesh(num_keyframes_axis: int = 1):
    """The standard fleet mesh over every rank of the world: ``kf`` of
    the given size, ``seq`` the rest (sequences never communicate)."""
    from madicp_tpu_torch.parallel.mesh import make_mesh

    n = dist.get_world_size() if dist.is_initialized() else 1
    if n % num_keyframes_axis != 0:
        raise ValueError(f"{n} processes not divisible by kf axis {num_keyframes_axis}")
    return make_mesh(kf=num_keyframes_axis, seq=n // num_keyframes_axis)
