"""Host ms a step of the program's ``madicp.copy_in`` spans (the host to
device copies: ``Pipeline.stage``'s, the fleet's ``Fleet.compute`` batch),
the mean over the span sub-window (``spans.py``; the program's trace)."""

from odobench import spans


def read(run):
    return spans.mean_ms(spans.summary(run), "madicp.copy_in")
