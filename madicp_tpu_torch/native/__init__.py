"""Native (C++) host-side components.

The device path is PyTorch and CUDA; the host runtime around it — the
dataset decode/filter hot loop and scan prefetching — mirrors the
reference's C++ data path (``bin_runner.cpp:125-165``) natively:

- :mod:`madicp_tpu_torch.native.loader` — C++ ``.bin`` record reader with
  range filtering and the KITTI vertical-angle correction, bound via
  ctypes and compiled on first use into ``build/madicp_tpu_torch/``.
- :mod:`madicp_tpu_torch.native.prefetch` — background-thread scan
  prefetcher that overlaps disk I/O + decode with device compute.
"""
