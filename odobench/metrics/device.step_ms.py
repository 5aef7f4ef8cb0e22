"""Device ms a step of the program's ``madicp.step`` span (its first stamp
to its last), the mean over the span sub-window (``spans.py``; the
program's trace)."""

from odobench import spans


def read(run):
    return spans.mean_ms(spans.summary(run), spans.STEP)
