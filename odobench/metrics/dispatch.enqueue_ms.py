"""Mean host ms from entering ``compute_device`` (``Fleet.compute``) to
its return over the window's steps: the replay's enqueue, the fleet's
copy of its batch to the card included."""

import statistics


def read(run):
    return statistics.fmean(run.enqueue_ms) if run.enqueue_ms else None
