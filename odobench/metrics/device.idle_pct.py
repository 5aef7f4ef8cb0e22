"""The share (%) of the traced sub-window's own wall time in which no
kernel, copy or set runs on the card (the union of their intervals)."""

from odobench import trace


def read(run):
    if not run.trace or run.trace.get("window") is None:
        return None
    records = [r for r in run.trace["device"]
               if r[2] > run.trace["window"][0] and r[1] < run.trace["window"][1]]
    if not records:
        return None
    return 100.0 * trace.idle_share(records, run.trace["window"])
