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
    arrays ``(K, M, 56)`` / ``(FRAME_WINDOW, M, 56)``. A fleet's state
    (the JAX ``Fleet.states``) carries a leading axis of B sequences on
    every field, ``X`` (B, 4, 4). Floats take ``cfg.dtype``; counters
    int32; masks bool."""
    dev = torch.device(device)
    missing = set(PipelineState._fields) - set(arrays)
    if missing:
        raise KeyError(f"state_from_numpy: missing fields {sorted(missing)}")
    lead = np.shape(arrays["X"])[:-2]
    if len(lead) > 1:
        raise ValueError(f"state_from_numpy: X has shape {np.shape(arrays['X'])}, "
                         "want (4, 4) or (B, 4, 4)")
    expect = {
        "kf_tree": lead + (cfg.num_keyframes, cfg.arena, 56),
        "fr_tree": lead + (None, cfg.arena, 56),
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
            if t.dim() != len(want) or any(w not in (None, s) for w, s in zip(want, t.shape)):
                raise ValueError(
                    f"state_from_numpy: {name} has shape {tuple(t.shape)}, "
                    f"want {want} for this configuration"
                )
            t = SearchTree(nav=t.contiguous())
        elif t.shape[:len(lead)] != lead:
            raise ValueError(f"state_from_numpy: {name} has shape {tuple(t.shape)}, "
                             f"want a leading {lead}")
        fields[name] = t
    return PipelineState(**fields)


def _kf_fields(state: PipelineState):
    """``(name, is_tree, spec)`` of every field that
    :func:`~madicp_tpu_torch.parallel.mesh.state_shardings` splits over
    ``kf``, batched or not as ``state`` is."""
    from madicp_tpu_torch.parallel.mesh import state_shardings

    specs = state_shardings(batched=state.X.dim() == 3)
    for name, spec in zip(specs._fields, specs):
        tree = isinstance(spec, SearchTree)
        spec = spec.nav if tree else spec
        if "kf" in spec:
            yield name, tree, spec


def kf_shard(state: PipelineState, index: int, count: int) -> PipelineState:
    """One process's share of a whole state when the keyframe ring is
    split over ``count`` processes: block ``index`` of every field split
    over ``kf`` (copies), every other field whole. Batched or not."""
    from madicp_tpu_torch.parallel.mesh import take_block

    fields = {}
    for name, tree, spec in _kf_fields(state):
        f = getattr(state, name)
        t = take_block(f.nav if tree else f, spec, {"kf": (index, count)}).clone()
        fields[name] = SearchTree(nav=t) if tree else t
    return state._replace(**fields)


def kf_unshard(shards) -> PipelineState:
    """The inverse of :func:`kf_shard`: the split fields joined along
    their ``kf`` axis in shard order; every other field from the first
    shard."""
    fields = {}
    for name, tree, spec in _kf_fields(shards[0]):
        parts = [getattr(s, name) for s in shards]
        t = torch.cat([p.nav for p in parts] if tree else parts, dim=spec.index("kf"))
        fields[name] = SearchTree(nav=t) if tree else t
    return shards[0]._replace(**fields)
