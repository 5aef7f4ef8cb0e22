"""Mean host ms a window step waits, from the return of
``compute_device`` (``Fleet.compute``) until its pose is on the host: the
step's device work as the host sees it, without the host's own staging
and enqueue (which vary with the shared host's state from run to run)."""

import statistics


def read(run):
    return statistics.fmean(run.wait_ms) if run.wait_ms else None
