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



def two_orientation_world(rng, density: int = 1) -> np.ndarray:
    """Ground plus eight walls along x and eight along y in an 80 m square
    (``scripts/accuracy_probe.py``'s world): x translation is observable,
    unlike in a world whose walls all run along x. 40,800 points times
    ``density``."""
    pts = [rng.uniform([-40, -40, -0.05], [40, 40, 0.05], (12000 * density, 3))]
    for i in range(8):
        y = -35 + 10 * i + rng.uniform(-2, 2)
        pts.append(rng.uniform([-40, y - 0.03, 0], [40, y + 0.03, 6], (1800 * density, 3)))
    for i in range(8):
        x = -35 + 10 * i + rng.uniform(-2, 2)
        pts.append(rng.uniform([x - 0.03, -40, 0], [x + 0.03, 40, 6], (1800 * density, 3)))
    return np.concatenate(pts)


def spinning_scan(world_pts: np.ndarray, pose: np.ndarray) -> np.ndarray:
    """Project world points into the sensor frame at ``pose`` (lidar->world)."""
    R = pose[:3, :3]
    t = pose[:3, 3]
    return (world_pts - t) @ R


def _exp_so3(rotvec: np.ndarray) -> np.ndarray:
    """Rodrigues' formula for rotation vectors (..., 3) -> (..., 3, 3);
    exactly the identity at 0."""
    rotvec = np.asarray(rotvec, dtype=np.float64)
    theta = np.linalg.norm(rotvec, axis=-1)[..., None, None]
    K = np.zeros(rotvec.shape[:-1] + (3, 3))
    K[..., 0, 1], K[..., 0, 2], K[..., 1, 2] = -rotvec[..., 2], rotvec[..., 1], -rotvec[..., 0]
    K[..., 1, 0], K[..., 2, 0], K[..., 2, 1] = rotvec[..., 2], -rotvec[..., 1], rotvec[..., 0]
    safe = np.where(theta > 0, theta, 1.0)
    a = np.where(theta > 0, np.sin(safe) / safe, 1.0)
    b = np.where(theta > 0, (1.0 - np.cos(safe)) / safe**2, 0.5)
    return np.eye(3) + a * K + b * (K @ K)


def capture_time(sensor_pts: np.ndarray, sensor_hz: float) -> np.ndarray:
    """When a spinning sensor sees each point, from its azimuth in the
    sensor frame: +pi at ``t = -ts`` down to -pi at ``t = 0``, the scan's
    end (the deskew convention of ``pipeline.cpp:79-123``)."""
    az = np.arctan2(sensor_pts[:, 1], sensor_pts[:, 0])
    return -(az + np.pi) / (2.0 * np.pi) / sensor_hz


def skewed_sweep(world_pts: np.ndarray, pose_end: np.ndarray, v_lin, omega,
                 sensor_hz: float, iterations: int = 3) -> np.ndarray:
    """One sweep of a spinning sensor moving at a constant body velocity:
    each world point in the sensor frame of the moment the sensor sees it.

    ``pose_end`` (lidar -> world) is the pose at the scan's end (``t =
    0``); at time ``t`` in ``[-ts, 0]`` the sensor is at ``pose_end @ [exp(
    omega t) | v_lin t]``, the motion a deskew with velocity ``(v_lin,
    omega)`` undoes. A point's capture time follows its azimuth
    (:func:`capture_time`), which depends on the time: ``iterations``
    fixed-point steps from the scan-end frame (each shrinks the time's
    error by ~``|d az / d t| ts / 2 pi``, a few percent at walking to
    driving speeds). With a zero velocity the sweep is
    :func:`spinning_scan` exactly."""
    v_lin = np.asarray(v_lin, dtype=np.float64)
    omega = np.asarray(omega, dtype=np.float64)
    p_end = spinning_scan(world_pts, pose_end)
    p = p_end
    for _ in range(iterations):
        t = capture_time(p, sensor_hz)[:, None]
        R = _exp_so3(omega * t)  # (M, 3, 3): sensor at t -> sensor at the end
        p = np.einsum("mji,mj->mi", R, p_end - v_lin * t)
    return p


class SweepDrive:
    """Scans of a spinning sensor moving through a static world at a
    constant body velocity, after ``rest`` scans at a standstill.

    Between two scan ends the sensor moves by ``D = [exp(omega ts) |
    v_lin ts]``, so the naive velocity of two consecutive scan-end poses
    is ``(v_lin, omega)`` and a deskew with it undoes the sweep's skew.
    :meth:`pose` is scan ``k``'s end pose in the world, :meth:`truth` the
    same in the frame of scan 0's end (where an odometry run starts),
    :meth:`sweep` the sensor-frame cloud of scan ``k`` (``points`` of the
    world points within range of its end pose, drawn a scan from
    ``seed``), :meth:`static_scan` the same points with no skew."""

    def __init__(self, world_pts, sensor_hz: float, v_lin, omega, points: int,
                 min_range: float = 0.0, max_range: float = np.inf, rest: int = 0,
                 seed: int = 0):
        self.world = np.asarray(world_pts, dtype=np.float64)
        self.hz, self.points = float(sensor_hz), int(points)
        self.v_lin = np.asarray(v_lin, dtype=np.float64)
        self.omega = np.asarray(omega, dtype=np.float64)
        self.min_range, self.max_range = float(min_range), float(max_range)
        self.rest, self.seed = int(rest), int(seed)
        self.step = np.eye(4)
        self.step[:3, :3] = _exp_so3(self.omega / self.hz)
        self.step[:3, 3] = self.v_lin / self.hz

    def moving(self, k: int) -> bool:
        """Whether the sensor moves during scan ``k``'s sweep."""
        return self.rest == 0 or k >= self.rest

    def pose(self, k: int) -> np.ndarray:
        """Scan ``k``'s end pose (lidar -> world): ``D^(k - rest + 1)``
        while moving, the identity before."""
        return np.linalg.matrix_power(self.step, k - self.rest + 1) if self.moving(k) \
            else np.eye(4)

    def truth(self, k: int) -> np.ndarray:
        """Scan ``k``'s end pose in the frame of scan 0's end."""
        return np.linalg.solve(self.pose(0), self.pose(k))

    def _chosen(self, k: int) -> np.ndarray:
        local = spinning_scan(self.world, self.pose(k))
        r = np.linalg.norm(local, axis=1)
        idx = np.flatnonzero((r > self.min_range) & (r < self.max_range))
        if len(idx) < self.points:
            raise ValueError(f"scan {k}: {len(idx)} world points in range, want {self.points}")
        rng = np.random.default_rng([self.seed, k + (1 << 20)])
        return self.world[np.sort(rng.choice(idx, self.points, replace=False))]

    def sweep(self, k: int, dtype=np.float32) -> np.ndarray:
        """Scan ``k`` as the sensor records it (points, 3)."""
        moving = self.moving(k)
        return skewed_sweep(self._chosen(k), self.pose(k), self.v_lin if moving else 0.0 * self.v_lin,
                            self.omega if moving else 0.0 * self.omega, self.hz).astype(dtype)

    def static_scan(self, k: int, dtype=np.float32) -> np.ndarray:
        """Scan ``k``'s points with no skew: the world as seen from its end
        pose."""
        return spinning_scan(self._chosen(k), self.pose(k)).astype(dtype)
