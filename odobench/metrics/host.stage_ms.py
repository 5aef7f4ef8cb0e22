"""Mean host ms a window step spends staging its scans: around each
``Pipeline.stage`` call (the CLI's loop with ``--no-prefetch``), around
the loop's padding of the batch (the fleet)."""

import statistics


def read(run):
    return statistics.fmean(run.stage_ms) if run.stage_ms else None
