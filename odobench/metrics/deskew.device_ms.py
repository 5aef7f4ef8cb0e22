"""Device ms a step of the kernels that ``kernels/`` places in the
``deskew`` layer, summed over the traced sub-window (torch.profiler)."""


def read(run):
    return run.layer_ms("deskew")
