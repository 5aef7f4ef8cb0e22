"""Host ms a step of the program's ``madicp.replay`` span (the static
buffers' copy and the graph's replay), the mean over the span sub-window
(``spans.py``; the program's trace)."""

from odobench import spans


def read(run):
    return spans.mean_ms(spans.summary(run), "madicp.replay")
