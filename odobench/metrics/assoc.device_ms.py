"""Device ms a step of the kernels that ``kernels/`` places in the
``association`` layer, summed over the traced sub-window (torch.profiler)."""


def read(run):
    return run.layer_ms("association")
