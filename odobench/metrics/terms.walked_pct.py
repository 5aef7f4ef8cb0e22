"""The share (%) of the terms kernels' leaf slots that they walk: 100 x
the slots a round below each sequence's bound (its keyframes times its
valid leaves) over the slots they hold (keyframes x leaf slots), the mean
over every sequence-scan of the span sub-window (``spans.py``; the
program's counts, read with its stamps). None where the program records
no such count."""

from odobench import spans


def read(run):
    summ = spans.summary(run)
    if not summ:
        return None
    shares = [100.0 * w / n
              for c in summ["drained"]["counters"] if "terms_walked" in c
              for w, n in zip(c["terms_walked"], c["terms_slots"]) if n > 0]
    return sum(shares) / len(shares) if shares else None
