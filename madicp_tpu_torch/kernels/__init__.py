"""Hand-written CUDA kernels for Hopper, their ctypes wrappers and plain
PyTorch versions (one wrapper module per kernel, e.g. :mod:`.segsum`),
and their nvcc build (:mod:`.build`)."""
