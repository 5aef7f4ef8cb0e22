"""Device ms from one step's last stamp to the next step's first (the
card waits for the host), the mean over the span sub-window's
consecutive steps (``spans.py``; the program's trace)."""

import statistics

from odobench import spans


def read(run):
    summ = spans.summary(run)
    gaps = spans.gaps_ms(summ["drained"]) if summ else []
    return statistics.fmean(gaps) if gaps else None
