"""Readings of the correctness check on many seeds in one process, for
setting its limits (``limits/<workload>.json``: above the largest sound
reading, below the smallest control reading):

- ``--mode sound``: the program as the configuration states it;
- ``--mode control``: the control, the plain reference put in the
  program's place and computed in the nearest precision below the
  configuration's float32 with TF32 off: float32 with TF32 matmuls (the
  program has no such path: it pins TF32 off).

Run on the card, one line a seed::

    python3 -m odobench.control --workload kitti.cli --mode control \\
        --seeds 101 102 103 --seconds 2

The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys

from odobench import reference
from odobench.loader import Loader
from odobench.run import Recorder, cell_inputs, check, checked_sequences, run_cell


def _tf32(on: bool) -> tuple:
    import torch

    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = on
    return saved


def control_answers(config, lap, prime, offsets, n_check, device, dtype,
                    sequences) -> Recorder:
    """The reference's answers in ``dtype`` over the first ``n_check``
    odometry scans of ``sequences``, as the program's are recorded (the
    others' copied from the first's, which no check reads)."""
    P = reference.Params.of(config)
    S, B = len(lap), len(offsets)
    steps = [[None] * B for _ in range(n_check)]
    for s in sequences:
        o = offsets[s]
        odo = reference.Odometry(P, device, dtype=dtype)
        odo.bootstrap(lap[o % S])
        odo.prime(*prime[s])
        for j in range(n_check):
            steps[j][s] = odo.step(lap[(o + 1 + j) % S])
    rec = Recorder(B)
    for st in steps:
        st = [r or st[sequences[0]] for r in st]
        rec.add(0.0, 0.0, 0.0, 0.0, 0.0, [r["pose"] for r in st], [r["ratio"] for r in st],
                [r["promote"] for r in st], [r["leaves_dropped"] for r in st])
    return rec


def readings(workload: str, seed: int, seconds: float, mode: str, device="cuda",
             loader=None, n_check=None) -> dict:
    """The check's numbers of one short run of ``workload`` in ``mode``."""
    import torch

    loader = loader or Loader()
    if mode == "control":
        config, _, limits, lap, offsets, prime, D = cell_inputs(loader, workload, seed, device)
        n = int(limits["reference_scans"]) if n_check is None else n_check
        seqs = checked_sequences(len(offsets), seed)
        saved = _tf32(True)
        try:
            rec = control_answers(config, lap, prime, offsets, n, device, torch.float32, seqs)
        finally:
            _tf32(saved[0])
        numbers = check(rec, n, lap, prime, offsets, config, limits, device, slice(0, n), D,
                        seqs)
    else:
        numbers = run_cell(workload, seed, seconds, False, device=device, loader=loader,
                           n_check=n_check)["check"]
    return numbers["readings"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m odobench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--mode", choices=("sound", "control"), required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    for seed in args.seeds:
        r = readings(args.workload, seed, args.seconds, args.mode)
        print(json.dumps({"workload": args.workload, "mode": args.mode, "seed": seed, **r}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
