"""Device ms a step of the program's ``tail`` phase spans (stamps of the
card's clock at the phase's boundaries, summed over the step),
the mean over the span sub-window (``spans.py``; the program's trace)."""

from odobench import spans


def read(run):
    return spans.mean_ms(spans.summary(run), "tail")
