"""The 95th percentile (linear interpolation) over every scan of the
window of the time from the call that hands the scan to the program until
its pose is on the host (the CLI's "odometry ms"); a batched step's scans
each take the step's time (host clock)."""

import numpy as np


def read(run):
    return float(np.percentile(run.latency_ms, 95)) if run.latency_ms else None
