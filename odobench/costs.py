"""Peaks of the card and the bytes and operations a step's kernels need,
frozen here so a later change to the program cannot move the yardstick.

Sources:

- :data:`H100_BYTES_PER_S`, :data:`H100_PEAK_FLOPS`, :func:`bound_ms`:
  ``madicp_tpu_torch/utils/timing.py:20-33`` (NVIDIA's H100 SXM data
  sheet: 3.35 TB/s of HBM3, 67 TFLOP/s float32 and 34 float64 on the CUDA
  cores).
- :func:`build_cost`: ``madicp_tpu_torch/probes/build_levels.py:206``
  ``call_cost`` (each input read once and each output written once,
  counting what the call's data needs; here a cloud's points without the
  rows that pad it), with the segment-sum's count of
  ``chip_smoke.py:413`` and the operation counts of
  ``madicp_tpu_torch/probes/build_levels.py:49-50`` and
  ``chip_smoke.py:488``. The level statistics it takes come from the
  reference's build of one of the cell's own scans
  (``reference.build_tree``), not from the program.
- :func:`terms_cost`: ``chip_smoke.py:820-822`` (K7: payload, points, X,
  H, b), ``chip_smoke.py:1893`` (K10: X, the terms and weights in; X, H,
  b out) and ``chip_smoke.py:1910-1912`` (K11: slack, flags, leaves, the
  need count).
"""

from __future__ import annotations

H100_BYTES_PER_S = 3.35e12
H100_PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}

NODE_FLOPS = 400  # a node: the eigensolver ~350, its fields ~50
POINT_FLOPS = 24  # a point of a level: d2 3, v 15, a norm 6
SEGSUM_FLOPS_PER_POINT = 19  # 9 products + 10 adds (chip_smoke.py:241)
TERMS_FLOPS_PER_ENTRY = 114  # gate 17, residual 5, u 15, m x u 9, weight 8, s J 6, sums 54
GN_FLOPS_PER_SEQUENCE = 450  # chip_smoke.py:1052
GN_FLOPS_PER_KEYFRAME = 84  # the keyframe sum: a product and an add of 42 values
SLACK_FLOPS_PER_LEAF, SLACK_FLOPS_PER_ENTRY = 45, 3  # chip_smoke.py:1055
ESIZE = {"float32": 4, "float64": 8}


def bound_ms(nbytes: float, flops: float, dtype: str) -> float:
    """The least milliseconds an H100 could take: the larger of ``nbytes``
    over the memory rate and ``flops`` over the peak rate of ``dtype``."""
    return max(nbytes / H100_BYTES_PER_S, flops / H100_PEAK_FLOPS[dtype]) * 1e3


def build_cost(stats: list, batch: int, dtype: str) -> tuple:
    """(bytes, operations) of one build of ``batch`` clouds: for every
    level the segment-sum, the node pass and the point pass, then the last
    level's close and the two leaf picks. Only a cloud's points count, not
    the rows that pad it to the program's ``n_points``: the padded rows the
    kernels read are the program's overhead, not part of the bound (the
    original counts every row of the call's arrays; on a cloud without
    padding the two agree). ``stats[l]``: the points the level's point pass
    holds live, those that retire there, those that advance, and the
    distinct nodes they sit in (one cloud; the batch's clouds are taken
    alike); ``stats[0]["live"]`` is the cloud's points."""
    e = ESIZE[dtype]
    k = e  # keys have the floats' width
    depth = len(stats) - 1
    M = 2 << depth
    n = batch * stats[0]["live"]
    nbytes = flops = 0
    for level, s in enumerate(stats):
        nseg = batch << level
        parents = 0 if level == 0 else nseg // 2
        # segment-sum: every point's delta and id read, the table written
        nbytes += n * (3 * e + 4) + nseg * 10 * e
        flops += n * SEGSUM_FLOPS_PER_POINT
        # nodes: 10 moments read, pack, state and arena row written, 6 keys
        # set; a parent's mean and normal, state, keys read, bbox0 and leaf
        # written; at level 0 each cloud's row 0 cleared
        nbytes += (nseg * (10 + 13 + 8 + 10) * e + nseg * 6 * k
                   + parents * ((6 + 8 + 2) * e + 6 * k)
                   + (batch * 12 * e if level == 0 else 0))
        flops += nseg * NODE_FLOPS
        live, dead, adv, nodes = (batch * s[x] for x in ("live", "dead", "adv", "nodes"))
        nbytes += (n * 8 + (live + dead + adv) * 3 * e + nodes * (13 * e + 6 * k)
                   + (live - adv) * (8 + e))
        flops += live * POINT_FLOPS
    nseg = batch << depth
    nbytes += nseg * (3 * e + 6 * k)  # the last close
    flops += nseg * 10
    rows = batch * M
    for near in (False, True):  # the picks: least distance, then lowest index
        nbytes += n + n * (8 + e) + rows * k + (rows * 8 if near else 0)
        flops += n * 3
    return nbytes, flops


def terms_cost(batch: int, keyframes: int, leaves: int, rounds: int, dtype: str) -> tuple:
    """(bytes, operations) of a scan's terms and solve: ``rounds`` calls
    of K7 and K10, ``rounds - 1`` of K11 (the certified later rounds).
    ``leaves``: a scan's leaves, not the program's capacity for them (the
    slots past a scan's leaves are the program's overhead)."""
    e = ESIZE[dtype]
    B, K, L = batch, keyframes, leaves
    k7 = B * (K * L * (8 * e + 1) + L * (3 * e + 1) + 16 * e + K * 42 * e)
    k10 = B * (16 + 43 * K + 16 + 42) * e
    k11 = B * K * L * (2 * e + 1) + B * L * (4 * e + 1) + B * K + B * 32 * e + 16 * B
    nbytes = rounds * (k7 + k10) + (rounds - 1) * k11
    flops = (rounds * B * (K * L * TERMS_FLOPS_PER_ENTRY + GN_FLOPS_PER_SEQUENCE
                           + GN_FLOPS_PER_KEYFRAME * K)
             + (rounds - 1) * B * (L * SLACK_FLOPS_PER_LEAF + K * L * SLACK_FLOPS_PER_ENTRY))
    return nbytes, flops
