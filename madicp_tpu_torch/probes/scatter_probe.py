"""Segment-sum designs on the card, the port of ``scripts/pallas_scatter_probe.py``.

The JAX probe is the same-process A/B that chose the TPU build's
segment-sum design. This one asks its question on Hopper, on the same
inputs (the same N, R, sizes and ``default_rng(0)`` draws, in the same
order), through the kernels of
:mod:`madicp_tpu_torch.kernels.scatter_probe`:

- A   ``onehot_segsum`` in modes f32, highest and bf16x3, at each M;
- A2  ``fused_moments`` beside "moment columns + scatter" and beside the
      main path's ``segsum_moments`` (the same sums, another design);
- B   ``rmw_segsum``, the in-order segment sum, at Q = 8192, Mq = 256;
- C   ``scatter_segsum``, unordered, at the same shapes.

Every case is checked before it is timed: the kernel against the plain
version in float64 (``atol 1e-3``, float32 reassociation), and
``rmw_segsum`` also bitwise against its in-order float32 plain version.
Then it prints one line for people and one JSON line with ``ms`` (eager
calls, CUDA events over R calls: what a caller pays), ``device_ms`` (R
calls in one CUDA graph, replayed: the kernel without its host
wrapper), ``plain_ms``, ``library_ms`` (one ``index_add_`` computing the
same sums, in its own order), ``bound_ms``/``bound_by`` (the function's
bytes over 3.35 TB/s or its float32 operations over the peak, the
larger), ``design_ops_ms`` (the dense one-hot contraction's tensor-core
flops over the bf16 peak: the floor of that design, not of the function;
null for the scatters), ``max_abs_err`` and the card with its power
limit.

Run on the card, output to a file:

    python -m madicp_tpu_torch.probes.scatter_probe > scatter_probe.log

``--device cpu`` runs the plain versions and their checks only, with no
times; ``--n`` and ``--sizes`` cut the shapes of sections A and A2. The
exit code is 1 when a check fails.
"""

from __future__ import annotations

import argparse
import json
import sys
from dataclasses import dataclass, field
from functools import partial
from typing import Callable, Optional

import numpy as np
import torch

from madicp_tpu_torch.kernels import scatter_probe as sp
from madicp_tpu_torch.kernels import segsum
from madicp_tpu_torch.utils.device import card_name, resolve_device
from madicp_tpu_torch.utils.timing import H100_PEAK_FLOPS, bound_ms, event_ms, graph_ms

N = 131072
R = 20
SIZES = (64, 256, 1024, 4096, 16384)  # the JAX probe's PROBE_SIZES
Q, MQ = 8192, 256
TOL = 1e-3  # float32 reassociation over ~2000 terms of N(0, 1)
RMW_PLAIN_REPS = 2  # the in-order plain loop launches one add per row
MOMENT_FLOPS = 19  # a point's 9 products and 10 adds


@dataclass
class Case:
    """One kernel at one shape, with everything it is held against."""

    section: str
    kernel: str
    mode: Optional[str]
    m: int
    n: int
    call: Callable  # the wrapper
    plain: Callable  # its plain version, same inputs
    want: Callable  # the sums in float64
    library: Optional[Callable]  # one PyTorch call for the same sums
    nbytes: int  # each input read once, the output written once
    flops: int  # the function's float32 operations
    design_flops: int = 0  # the dense contraction's bf16 flops, where used
    bitwise: bool = False  # must equal the plain version bit for bit
    plain_reps: Optional[int] = None
    baselines: dict = field(default_factory=dict)  # other designs, same sums

    @property
    def name(self) -> str:
        return self.kernel + (f"[{self.mode}]" if self.mode else "")


def _draw_ids(rng, m: int, n: int, dev) -> torch.Tensor:
    """(1, n) ids in [0, m], 5% of them m (dropped), as the JAX probe
    draws them."""
    idx = rng.integers(0, m, n).astype(np.int32)
    idx[rng.random(n) < 0.05] = m
    return torch.as_tensor(idx[None, :], device=dev)


def _cols64(idx2d, vals_t, m):
    return sp.segsum16_ref(idx2d, vals_t.double().T, m).T


def _moments(idx2d, d, m):
    """Moment columns, then one scatter: the JAX build's path."""
    return sp.segsum16_ref(idx2d, sp.moment_columns16(d), m)


def cases(device, n: int = N, sizes=SIZES) -> list:
    """Every case of the probe, inputs drawn in the JAX probe's order."""
    dev = torch.device(device)
    rng = np.random.default_rng(0)
    vals = rng.normal(0, 1, (n, 16)).astype(np.float32)
    vals_t = torch.as_tensor(vals.T.copy(), device=dev)
    out = []
    for m in sizes:
        idx2d = _draw_ids(rng, m, n, dev)
        tab = torch.zeros((16, m + 1), dtype=torch.float32, device=dev)
        for mode in sp.MODES:
            dense = mode == "bf16x3"
            out.append(Case(
                "A", "onehot_segsum", mode, m, n,
                call=partial(sp.onehot_segsum, idx2d, vals_t, m, mode),
                plain=partial(sp.onehot_segsum_ref, idx2d, vals_t, m, mode),
                want=partial(_cols64, idx2d, vals_t, m),
                library=partial(tab.index_add_, 1, idx2d.reshape(-1).long(), vals_t),
                nbytes=n * 16 * 4 + n * 4 + 16 * m * 4, flops=n * 16,
                design_flops=2 * n * m * 16 * 3 if dense else 0))

    d = torch.as_tensor(rng.normal(0, 1, (n, 3)).astype(np.float32), device=dev)
    mom = sp.moment_columns16(d)
    for m in sizes:
        idx2d = _draw_ids(rng, m, n, dev)
        tab = torch.zeros((m + 1, 16), dtype=torch.float32, device=dev)
        out.append(Case(
            "A2", "fused_moments", None, m, n,
            call=partial(sp.fused_moments, idx2d, d, m),
            plain=partial(sp.fused_moments_ref, idx2d, d, m),
            want=partial(_moments, idx2d, d.double(), m),
            library=partial(tab.index_add_, 0, idx2d.reshape(-1).long(), mom),
            nbytes=n * 3 * 4 + n * 4 + m * 16 * 4, flops=n * MOMENT_FLOPS,
            design_flops=2 * n * m * 16 * 3,
            baselines={"mom_scatter": partial(_moments, idx2d, d, m),
                       "segsum_moments": partial(
                           segsum.segsum_moments, d, idx2d.reshape(-1), m)}))

    idx_q = torch.as_tensor(rng.integers(0, MQ, Q).astype(np.int32)[None, :], device=dev)
    vals_q = torch.as_tensor(rng.normal(0, 1, (Q, 16)).astype(np.float32), device=dev)
    want_q = partial(sp.segsum16_ref, idx_q, vals_q.double(), MQ)
    rows_bytes = Q * 16 * 4 + Q * 4 + MQ * 16 * 4
    tab_q = torch.zeros((MQ, 16), dtype=torch.float32, device=dev)
    # the same sums for B and C; index_add_ does not keep row order
    lib_q = partial(tab_q.index_add_, 0, idx_q.reshape(-1).long(), vals_q)
    out.append(Case(
        "B", "rmw_segsum", None, MQ, Q,
        call=partial(sp.rmw_segsum, idx_q, vals_q, MQ),
        plain=partial(sp.rmw_segsum_ref, idx_q, vals_q, MQ),
        want=want_q, library=lib_q, nbytes=rows_bytes, flops=Q * 16,
        bitwise=True, plain_reps=RMW_PLAIN_REPS))
    out.append(Case(
        "C", "scatter_segsum", None, MQ, Q,
        call=partial(sp.scatter_segsum, idx_q, vals_q, MQ),
        plain=partial(sp.scatter_segsum_ref, idx_q, vals_q, MQ),
        want=want_q, library=lib_q, nbytes=rows_bytes, flops=Q * 16))
    return out


def check(case: Case) -> dict:
    """The kernel (the plain version on the CPU) against the float64 sums
    and, where ``case.bitwise``, bit for bit against the plain version."""
    got = case.call()
    err = float((got.double() - case.want()).abs().max())
    out = {"max_abs_err": err, "tol": TOL}
    ok = err <= TOL
    if case.bitwise:
        out["bitwise_equal_to_plain"] = bool(torch.equal(got, case.plain()))
        ok = ok and out["bitwise_equal_to_plain"]
    out["ok"] = ok
    return out


def measure(case: Case, reps: int) -> dict:
    out = {"ms": event_ms(case.call, reps), "device_ms": graph_ms(case.call, reps),
           "plain_ms": event_ms(case.plain, case.plain_reps or reps),
           "library_ms": event_ms(case.library, reps) if case.library else None}
    for name, fn in case.baselines.items():
        out[f"{name}_ms"] = event_ms(fn, reps)
        out[f"{name}_device_ms"] = graph_ms(fn, reps)
    return out


def _human(rec: dict) -> str:
    name = rec["kernel"] + (f"[{rec['mode']}]" if rec["mode"] else "")
    line = (f"{rec['section']:2s} {name:22s} M={rec['M']:<6d} err {rec['max_abs_err']:.1e}"
            + ("" if rec["ok"] else " FAILS its check"))
    if "ms" in rec:
        lib = rec["library_ms"]
        line += (f" | {rec['ms']:.4f} ms eager, {rec['device_ms']:.4f} ms device "
                 f"({rec['device_ms'] * 1e6 / rec['n']:.3f} ns/row), plain "
                 f"{rec['plain_ms']:.4f}, index_add_ "
                 + ("-" if lib is None else f"{lib:.4f}")
                 + f", bound {rec['bound_ms']:.5f} ({rec['bound_by']})"
                 + ("" if rec["design_ops_ms"] is None
                    else f", dense design's flops {rec['design_ops_ms']:.4f}"))
    return line


def run(device="cuda", n: int = N, sizes=SIZES, reps: int = R, emit=print) -> list:
    """Check, then time (on the card), every case; one human and one JSON
    line each through ``emit``. Returns the JSON records."""
    dev = resolve_device(device)
    card = card_name(dev)
    emit(f"scatter probe on {card}: N={n}, R={reps}, sizes={list(sizes)}, Q={Q}, Mq={MQ}")
    records = []
    for case in cases(dev, n, sizes):
        rec = {"probe": "scatter", "section": case.section, "kernel": case.kernel,
               "mode": case.mode, "M": case.m, "n": case.n, "card": card}
        rec.update(check(case))
        rec["bound_ms"], rec["bound_by"] = bound_ms(case.nbytes, case.flops, "float32")
        rec["design_ops_ms"] = (case.design_flops / H100_PEAK_FLOPS["bf16"] * 1e3
                                if case.design_flops else None)
        if dev.type == "cuda" and rec["ok"]:
            rec.update(measure(case, reps))
        emit(_human(rec))
        emit(json.dumps(rec))
        records.append(rec)
    return records


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu: plain versions and checks only")
    ap.add_argument("--n", type=int, default=N, help="rows of sections A and A2")
    ap.add_argument("--sizes", default=",".join(map(str, SIZES)),
                    help="table sizes M of sections A and A2")
    args = ap.parse_args(argv)
    sizes = [int(s) for s in args.sizes.split(",")]
    records = run(args.device, args.n, sizes, emit=lambda s: print(s, flush=True))
    bad = [r for r in records if not r["ok"]]
    if bad:
        print(f"scatter_probe: {len(bad)} case(s) failed their check", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
