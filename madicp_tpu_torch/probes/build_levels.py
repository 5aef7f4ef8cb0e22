"""Every call of one MAD-tree build, recorded and held against the plain
versions: the node math (K9, :mod:`madicp_tpu_torch.kernels.build_nodes`)
and the per-point pass and leaf pick (K8,
:mod:`madicp_tpu_torch.kernels.build_points`).

:func:`record_build` runs :func:`madicp_tpu_torch.ops.tree.build_tree`
once and keeps, for every call of the build's functions, its inputs as
they were before the call and its results (the tables it returned and
those it changed in place; of ``d_next`` the rows that are defined,
those of points that advance). :func:`check_calls` runs the plain version of
each recorded call on copies of its inputs and compares: on the card it
holds each kernel to its plain version at every level. :func:`replay_build`
builds again with every function routed to its plain version
(:func:`plain_build`) and the segment-sum replaying the recorded tables
(:func:`replaying`), so
the two builds see the same moments (the segment-sum's float64 atomics may
round its last bit differently from one run to the next) and their trees
must agree bit for bit. ``chip_smoke.py``'s ``tree`` phase and the ``cuda``
tests of ``tests/test_torch_build_kernels.py`` use them; on the CPU every
call is the plain version already.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch

from madicp_tpu_torch.kernels import build_nodes as bn
from madicp_tpu_torch.kernels import build_points as bp
import madicp_tpu_torch.ops.tree as tree_mod

KERNELS = {  # kernel -> its functions in the build
    "build_nodes": ("build_nodes", "close_level"),
    "build_points": ("build_points", "pick_dmin", "pick_near"),
}
_MODULE = {"build_nodes": bn, "close_level": bn, "build_points": bp, "pick_dmin": bp,
           "pick_near": bp}


def _close_level_plain(state, ext, arena, *, level):
    bn.close_level_plain(state, ext, arena, level=level)


PLAIN = {"build_nodes": bn.build_nodes_plain, "close_level": _close_level_plain,
         "build_points": bp.build_points_plain, "pick_dmin": bp.pick_dmin_plain,
         "pick_near": bp.pick_near_plain}
# positions of the arguments a call changes in place
IN_PLACE = {"build_nodes": (2,), "close_level": (2,), "build_points": (3, 4, 6),
            "pick_dmin": (), "pick_near": ()}


class Call(NamedTuple):
    name: str
    args: tuple  # as they were before the call (copies)
    kwargs: dict
    results: tuple  # returned tensors, then the arguments changed in place


def copy_args(x):
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, tuple):
        return tuple(copy_args(t) for t in x)
    return x


def results(name, out, args) -> tuple:
    """A call's results as :class:`Call` keeps them: the tensors ``out``
    it returned (``d_next`` of a point pass on its defined rows, 0
    elsewhere), then clones of the arguments it changed in place."""
    returned = () if out is None else (out,) if isinstance(out, torch.Tensor) else tuple(out)
    returned = tuple(t.clone() for t in returned)
    if name == "build_points":  # d_next is defined where its point advances
        d_next, idx_next = returned
        returned = (torch.where((idx_next != bp.DROP)[:, None], d_next, 0.0), idx_next)
    return returned + tuple(args[i].clone() for i in IN_PLACE[name])


@contextlib.contextmanager
def _patched(replace: dict):
    real = {name: getattr(_MODULE[name], name) for name in replace}
    for name, fn in replace.items():
        setattr(_MODULE[name], name, fn)
    try:
        yield
    finally:
        for name, fn in real.items():
            setattr(_MODULE[name], name, fn)


def plain_build():
    """A context in which the build's functions take their plain versions
    on the card too (the kernels' counters stand still)."""
    return _patched(dict(PLAIN))


def record_build(points, valid, *, depth, b_max, b_min):
    """``(tree, point_leaf, calls, moments)`` of one ``build_tree``: every
    call of the build's functions (:class:`Call`, in order) and every
    segment-sum call as ``(d, idx, table)``."""
    calls, moments = [], []
    real_segsum = tree_mod.segsum_moments

    def recorder(name):
        real = getattr(_MODULE[name], name)

        def call(*args, **kwargs):
            before = copy_args(args)
            out = real(*args, **kwargs)
            calls.append(Call(name, before, kwargs, results(name, out, args)))
            return out

        return call

    def segsum(d, idx, sz):
        out = real_segsum(d, idx, sz)
        moments.append((d.clone(), idx.clone(), out.clone()))
        return out

    tree_mod.segsum_moments = segsum
    try:
        with _patched({name: recorder(name) for name in _MODULE}):
            tree, point_leaf = tree_mod.build_tree(points, valid, depth=depth, b_max=b_max,
                                                   b_min=b_min)
    finally:
        tree_mod.segsum_moments = real_segsum
    return tree, point_leaf, calls, moments


def compare(a: torch.Tensor, b: torch.Tensor) -> tuple:
    """(equal as ``torch.equal`` counts it, but NaN equal to NaN, largest
    absolute difference elsewhere). An arena's rows of the levels a call
    has not reached yet hold whatever its allocation held, NaN included."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False, float("inf")
    if not a.numel():
        return True, 0.0
    if not a.is_floating_point():
        return torch.equal(a, b), float((a - b).abs().max())
    nan = a.isnan() & b.isnan()
    same = bool(((a == b) | nan).all())
    return same, float(torch.where(nan, 0.0, a.double() - b.double()).abs().max())


def check_calls(calls) -> dict:
    """Each recorded call against its plain version on copies of its
    inputs: per kernel, ``{"calls", "equal", "max_abs_err", "unequal"}``
    (the first calls whose results differ, by name and level)."""
    out = {k: {"calls": 0, "equal": True, "max_abs_err": 0.0, "unequal": []} for k in KERNELS}
    for c in calls:
        kernel = next(k for k, names in KERNELS.items() if c.name in names)
        args = copy_args(c.args)
        want = results(c.name, PLAIN[c.name](*args, **c.kwargs), args)
        row = out[kernel]
        row["calls"] += 1
        for i, (a, b) in enumerate(zip(c.results, want)):
            same, err = compare(a, b)
            row["max_abs_err"] = max(row["max_abs_err"], err)
            if not same:
                row["equal"] = False
                if len(row["unequal"]) < 8:
                    row["unequal"].append({"call": c.name, "level": c.kwargs.get("level"),
                                           "result": i})
    return out


@contextlib.contextmanager
def replaying(moments, check: bool = True):
    """A context in which ``build_tree``'s segment-sum returns the recorded
    tables of ``moments`` level by level, from the first again at each
    build; with ``check`` each call's ``idx`` and the rows of ``d`` it
    reads (its live points') must equal the recorded ones (a call that
    differs raises)."""
    level = [0]

    def segsum(d, idx, sz):
        d0, idx0, table = moments[level[0]]
        level[0] = (level[0] + 1) % len(moments)
        if check:
            live = ((idx0 >= 0) & (idx0 < sz))[:, None]
            if not (torch.equal(idx, idx0) and torch.equal(torch.where(live, d, 0.0),
                                                           torch.where(live, d0, 0.0))):
                raise AssertionError(f"replaying: the segment-sum's input of the level of "
                                     f"{sz} segments differs from the recorded build's")
        return table

    real_segsum = tree_mod.segsum_moments
    tree_mod.segsum_moments = segsum
    try:
        yield
    finally:
        tree_mod.segsum_moments = real_segsum


def replay_build(points, valid, moments, *, depth, b_max, b_min):
    """``build_tree`` with the plain versions and the segment-sum replaying
    ``moments`` (:func:`replaying`, checked): ``(tree, point_leaf)``."""
    with replaying(moments), plain_build():
        return tree_mod.build_tree(points, valid, depth=depth, b_max=b_max, b_min=b_min)
