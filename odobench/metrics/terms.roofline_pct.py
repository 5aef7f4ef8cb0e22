"""The least time an H100 needs for a step's terms and solve (K7, K10,
K11: bytes and operations from their shapes at the mean leaves of the
scans the reference followed, ``costs.terms_cost``) over
the terms+solve kernels' device time a step, in %."""

from odobench import costs, reference


def read(run):
    ms = run.layer_ms("terms")
    if not ms or not run.leaves:
        return None
    nbytes, flops = costs.terms_cost(run.batch, run.config["num_keyframes"], run.leaves,
                                     reference.MAX_ICP_ITS, run.dtype)
    return 100.0 * costs.bound_ms(nbytes, flops, run.dtype) / ms
