"""Seconds from the process's start to the first timed scan: the lap's
scans made, the program built and loaded, the ring primed, the shapes
warmed up and the step's graph captured (host clock)."""


def read(run):
    return run.setup_s
