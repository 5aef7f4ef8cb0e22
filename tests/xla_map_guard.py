"""Pytest plugin: release JAX's compiled executables before a test process
runs out of memory mappings.

Each XLA:CPU executable that JAX keeps in its caches holds three anonymous
mappings (code, read-only data, data) per compiled kernel, and one pipeline
configuration compiles a few thousand kernels. A process that runs a dozen
of the pipeline tests, as one pytest-xdist worker may, reaches the kernel's
``vm.max_map_count`` (65530 by default), and its next compile or
compilation-cache load segfaults. After each test this plugin counts the
process's mappings and, past half of that limit, calls
``jax.clear_caches()``: later tests compile again (or load from the
persistent compilation cache) what they use, and compute the same results.
A test process that never imports JAX is left alone.

It is registered by ``pytest_plugins`` in ``test_torch_package.py``, and
only a process that collects that file loads it: every process of a run
over ``tests/`` does, but a JAX test file run alone
(``python -m pytest tests/test_pipeline.py``) runs unguarded. Load it by
name there:

    PYTHONPATH=tests python -m pytest -p xla_map_guard tests/test_pipeline.py

The card's runs of ``test_torch_package.py`` load it too; with no JAX
imported it does nothing.
"""

from __future__ import annotations

import sys


def _read(path: str) -> str | None:
    try:
        with open(path) as f:
            return f.read()
    except OSError:
        return None


def pytest_runtest_logfinish(nodeid, location):
    jax = sys.modules.get("jax")
    limit = _read("/proc/sys/vm/max_map_count")
    maps = _read("/proc/self/maps")
    if jax is None or limit is None or maps is None:
        return
    if maps.count("\n") > int(limit) // 2:
        jax.clear_caches()
