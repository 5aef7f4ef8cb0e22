"""Minimal natural sorting (the reference depends on the ``natsort``
package for file ordering, ``kitti_reader.py:48``; this image ships
without it)."""

from __future__ import annotations

import re

_NUM = re.compile(r"(\d+)")


def natural_key(s) -> tuple:
    return tuple(
        int(tok) if tok.isdigit() else tok
        for tok in _NUM.split(str(s))
    )


def natsorted(items):
    return sorted(items, key=natural_key)
