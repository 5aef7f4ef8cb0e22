"""The benchmark of ``madicp_tpu_torch``, the PyTorch and CUDA port of
MAD-ICP odometry: ``python3 -m odobench --workload <name> --seed <n>
--seconds <s> --trace <0|1>`` runs one cell of ``BENCHMARK.json`` once on
a CUDA card (see ``run.py``)."""
