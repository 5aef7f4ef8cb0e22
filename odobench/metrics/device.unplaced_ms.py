"""Device ms a step of the kernels that no file of ``kernels/`` places,
summed over the traced sub-window (torch.profiler); copies and sets
left out."""


def read(run):
    return run.layer_ms(None)
