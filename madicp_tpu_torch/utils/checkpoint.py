"""Pipeline checkpoint / resume, in the JAX package's file format.

The reference has no checkpointing — a crash loses the run and the only
artifact is the appended ``estimate.txt`` (SURVEY.md §5). Here the whole
odometry state (pose, velocity, trajectory window, keyframe and frame
rings) is a ``PipelineState`` of device tensors, so a checkpoint is one
``.npz`` plus the static config as JSON; ``load_pipeline`` reconstructs
a Pipeline mid-sequence bit for bit.

The file is the one ``madicp_tpu.utils.checkpoint`` writes and reads:
``__config__`` (the config as JSON, ``dtype`` named ``"float32"`` or
``"float64"``), ``__realtime__``, ``__rt_its_max__``, ``__rt_every__``
and ``leaf_{i}``, the state's 16 arrays in ``PipelineState`` field order
(each ``SearchTree`` is its ``nav``, the JAX pytree's flatten order). A
checkpoint of either package resumes in the other.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
from pathlib import Path

import numpy as np
import torch

CHECKPOINT_NAME = "pipeline.ckpt.npz"
_DTYPES = {"float32": torch.float32, "float64": torch.float64}
_DTYPE_NAMES = {v: k for k, v in _DTYPES.items()}


def _snapshot(state) -> dict:
    """The state as host numpy arrays, ``leaf_{i}`` in flatten order.

    Always a copy: the step updates the rings in place, and on the CPU
    ``Tensor.cpu()`` is the same storage, so a file written from it in
    the background would race the next step."""
    arrays = {}
    for i, name in enumerate(state._fields):
        t = getattr(state, name)
        t = t.nav if name.endswith("_tree") else t
        arrays[f"leaf_{i}"] = t.detach().to("cpu", copy=True).numpy()
    return arrays


def save_pipeline(path, pipe, background: bool = False):
    """Write a Pipeline's static config + full device state to ``path``.

    The device->host snapshot is taken synchronously, as a copy (a
    consistent checkpoint needs the state as of NOW, and the next step
    overwrites the rings in place), but the file write — the
    multi-second part at flagship scale (~0.4 GB of rings) — can run on
    a background thread (``background=True``; returns the ``Thread``,
    join it before process exit). The file is uncompressed (the state is
    float arenas that deflate poorly), written to a temp
    sibling and atomically renamed, so a crash mid-write never corrupts
    the previous checkpoint.
    """
    cfg = dataclasses.asdict(pipe.cfg)
    cfg["dtype"] = _DTYPE_NAMES[pipe.cfg.dtype]
    arrays = _snapshot(pipe.state)
    meta = dict(
        __config__=json.dumps(cfg),
        __realtime__=np.asarray(pipe.realtime),
        # realtime-calibration host state lives OUTSIDE cfg: the
        # CONFIGURED iteration ceiling (cfg.max_icp_iterations may be a
        # temporarily shrunk value at save time) and the recal cadence
        __rt_its_max__=np.asarray(pipe._rt_its_max),
        __rt_every__=np.asarray(pipe._rt_every),
    )
    path = Path(path)
    tmp = path.with_name(path.name + ".tmp.npz")

    def _write():
        np.savez(tmp, **meta, **arrays)
        os.replace(tmp, path)

    if background:
        t = threading.Thread(target=_write, name="madicp-ckpt", daemon=False)
        t.start()
        return t
    _write()
    return None


def load_pipeline(path, device=None):
    """Reconstruct a Pipeline (config + state) from a checkpoint file of
    either package, on ``device`` (CUDA unless the caller passes
    ``device="cpu"``)."""
    from madicp_tpu_torch.models.pipeline import Pipeline, PipelineConfig, PipelineState
    from madicp_tpu_torch.utils.convert import state_from_numpy

    with np.load(path, allow_pickle=False) as z:
        cfg_d = json.loads(str(z["__config__"]))
        realtime = bool(z["__realtime__"])
        dtype = _DTYPES[cfg_d.pop("dtype")]
        cfg = PipelineConfig(dtype=dtype, **cfg_d)
        pipe = Pipeline(
            sensor_hz=cfg.sensor_hz,
            deskew=cfg.deskew,
            b_max=cfg.b_max,
            rho_ker=cfg.rho_ker,
            p_th=cfg.p_th,
            b_min=cfg.b_min,
            b_ratio=cfg.b_ratio,
            num_keyframes=cfg.num_keyframes,
            realtime=realtime,
            n_points=cfg.n_points,
            depth=cfg.depth,
            max_leaves=cfg.max_leaves,
            max_icp_iterations=cfg.max_icp_iterations,
            dtype=dtype,
            device=device,
        )
        # the ctor takes the public surface; the fully parsed config is
        # assigned as well so NO field falls back to a default
        pipe.cfg = cfg
        # older checkpoints lack these keys: keep the saved cfg's value
        if "__rt_its_max__" in z:
            pipe._rt_its_max = int(z["__rt_its_max__"])
            pipe._rt_every = int(z["__rt_every__"])
        arrays = {name: z[f"leaf_{i}"] for i, name in enumerate(PipelineState._fields)}
        pipe.state = None  # free the ctor's state before the restored one
        pipe.state = state_from_numpy(cfg, arrays, pipe.device)
    # restore the host-side first-scan flag from the restored state
    pipe._initialized = pipe.current_id() > 0
    return pipe


def checkpoint_path(estimate_dir) -> Path:
    return Path(estimate_dir) / CHECKPOINT_NAME
