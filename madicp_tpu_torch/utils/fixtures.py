"""Synthetic scene generators (parity with the reference's demo fixture
``apps/utils/tools/tools_utils.py:3-21``)."""

from __future__ import annotations

import numpy as np


def generate_four_walls_pointcloud(
    wall_height: float = 2.0,
    wall_width: float = 4.0,
    points_per_wall: int = 10000,
    rng=None,
) -> np.ndarray:
    """Four axis-aligned walls plus a floor, uniformly sampled.

    Uses ``np.random`` when ``rng`` is None so seeded scripts reproduce the
    reference demos exactly (``nn_search.py:36``).
    """
    r = rng if rng is not None else np.random

    def plane(xr, yr, zr, n):
        x = r.uniform(xr[0], xr[1], n)
        y = r.uniform(yr[0], yr[1], n)
        z = r.uniform(zr[0], zr[1], n)
        return np.column_stack((x, y, z))

    w, h, n = wall_width, wall_height, points_per_wall
    wall1 = plane([0, w], [0, 0], [0, h], n)
    wall2 = plane([0, w], [w, w], [0, h], n)
    wall3 = plane([0, 0], [0, w], [0, h], n)
    wall4 = plane([w, w], [0, w], [0, h], n)
    floor = plane([0, w], [0, w], [0, 0], n)
    return np.vstack((wall1, wall2, wall3, wall4, floor))

