"""Every sequence-scan completed in the window over the window's wall
time (host clock)."""


def read(run):
    return run.scans / run.window_s if run.window_s > 0 else None
