"""The least time an H100 needs for one of the cell's builds (bytes and
operations from the reference's level statistics of a scan of the cell,
``costs.build_cost``) over the build kernels' device time a step, in %."""

from odobench import costs


def read(run):
    ms = run.layer_ms("build")
    if not ms or not run.build_stats:
        return None
    nbytes, flops = costs.build_cost(run.build_stats, run.batch, run.dtype)
    return 100.0 * costs.bound_ms(nbytes, flops, run.dtype) / ms
