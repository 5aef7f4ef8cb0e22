"""Carry a pipeline state across from the JAX package.

The JAX package's ``PipelineState`` and this package's share field names,
shapes and layouts, so a JAX state given as numpy arrays continues here:
stop a JAX pipeline mid-drive, convert, and keep driving the port.
"""

from __future__ import annotations

import numpy as np
import torch

from madicp_tpu_torch.models.pipeline import PipelineConfig, PipelineState
from madicp_tpu_torch.ops.tree import SearchTree

_INT_FIELDS = ("traj_count", "kf_head", "fr_seq", "fr_head", "seq", "seq_keyframe")
_BOOL_FIELDS = ("kf_valid", "fr_valid")
_TREE_FIELDS = ("kf_tree", "fr_tree")


def state_from_numpy(cfg: PipelineConfig, arrays, device) -> PipelineState:
    """``arrays``: a mapping from every ``PipelineState`` field name to a
    numpy array, with ``kf_tree`` / ``fr_tree`` given as their ``nav``
    arrays ``(K, M, 56)`` / ``(FRAME_WINDOW, M, 56)``. Floats take
    ``cfg.dtype``; counters int32; masks bool."""
    dev = torch.device(device)
    missing = set(PipelineState._fields) - set(arrays)
    if missing:
        raise KeyError(f"state_from_numpy: missing fields {sorted(missing)}")
    expect = {
        "kf_tree": (cfg.num_keyframes, cfg.arena, 56),
        "fr_tree": (None, cfg.arena, 56),
    }
    fields = {}
    for name in PipelineState._fields:
        a = np.asarray(arrays[name])
        if name in _INT_FIELDS:
            t = torch.as_tensor(a.astype(np.int32), device=dev)
        elif name in _BOOL_FIELDS:
            t = torch.as_tensor(a.astype(bool), device=dev)
        else:
            t = torch.tensor(a, dtype=cfg.dtype, device=dev)
        if name in _TREE_FIELDS:
            want = expect[name]
            if t.dim() != 3 or any(w not in (None, s) for w, s in zip(want, t.shape)):
                raise ValueError(
                    f"state_from_numpy: {name} has shape {tuple(t.shape)}, "
                    f"want {want} for this configuration"
                )
            t = SearchTree(nav=t.contiguous())
        fields[name] = t
    return PipelineState(**fields)
