"""The one traffic generator: a sensor driving a closed lap through a
synthetic world, one lap of scans made from the seed.

Frozen copies (so a later change to the program cannot move the
yardstick), each named with its original:

- :func:`two_orientation_world`: ``madicp_tpu_torch/utils/fixtures.py:41``
  (ground plus walls along x and along y, so every axis of a pose is
  observable), widened here to a square of any size and wall spacing; at
  the original's size it draws the original's points.
- :func:`capture_time` and :func:`skewed_sweep`:
  ``madicp_tpu_torch/utils/fixtures.py:71, 80`` (each point seen from the
  pose of the moment the sensor sees it), in torch so a lap is made on
  the card.
- :class:`LapDrive` follows ``madicp_tpu_torch/utils/fixtures.py:111``
  ``SweepDrive`` (a fresh draw of the world points in range for every
  scan), with the draw made on the card by a seeded ``torch.Generator``.
- :func:`exp_so3`: ``madicp_tpu_torch/utils/fixtures.py:54`` ``_exp_so3``.

A drive moves at a constant body velocity ``(speed, 0, 0)`` and yaw rate
``2 pi hz / lap_scans``, so ``D = [exp(omega / hz) | v / hz]`` is the
motion between two scan ends and ``D ** lap_scans`` is the identity: the
lap closes, and a stream that cycles through it is one continuous drive.
With ``speed`` 0 the sensor stands still and every scan is a fresh draw
from one pose.
"""

from __future__ import annotations

import math

import numpy as np
import torch

WALLS_SEED = 7  # the walls' layout, one for every seed


def exp_so3(rotvec) -> np.ndarray:
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


def exp_so3_torch(rotvec: torch.Tensor) -> torch.Tensor:
    """:func:`exp_so3` of a tensor (..., 3) -> (..., 3, 3)."""
    theta = torch.linalg.norm(rotvec, dim=-1)[..., None, None]
    z = torch.zeros_like(rotvec[..., 0])
    x, y, w = rotvec.unbind(-1)
    K = torch.stack([torch.stack([z, -w, y], -1), torch.stack([w, z, -x], -1),
                     torch.stack([-y, x, z], -1)], -2)
    safe = torch.where(theta > 0, theta, torch.ones_like(theta))
    a = torch.where(theta > 0, torch.sin(safe) / safe, torch.ones_like(theta))
    b = torch.where(theta > 0, (1.0 - torch.cos(safe)) / safe**2, torch.full_like(theta, 0.5))
    eye = torch.eye(3, dtype=rotvec.dtype, device=rotvec.device)
    return eye + a * K + b * (K @ K)


def two_orientation_world(rng, density: float = 1.0, half: float = 40.0,
                          spacing: float = 10.0, center=(0.0, 0.0),
                          wall_height: float = 6.0, walls=None) -> np.ndarray:
    """Ground plus ``2 half / spacing`` walls along x and as many along y
    in a square of side ``2 half`` around ``center``; ground and wall
    densities as the original's (12,000 ground points a 6,400 m^2 and 1,800
    points a wall of 80 m, times ``density``). Each wall's offset from its
    place on the grid (within 2 m) comes from ``walls``, a generator of its
    own where given, else from ``rng`` between the points as the original
    draws it. With the defaults it is the original's world, point for
    point."""
    walls = rng if walls is None else walls
    cx, cy = center
    n_walls = int(round(2 * half / spacing))
    n_ground = int(round(12000 * density * (half / 40.0) ** 2))
    n_wall = int(round(1800 * density * half / 40.0))
    pts = [rng.uniform([cx - half, cy - half, -0.05], [cx + half, cy + half, 0.05],
                       (n_ground, 3))]
    for i in range(n_walls):
        y = cy - half + spacing / 2 + spacing * i + walls.uniform(-2, 2)
        pts.append(rng.uniform([cx - half, y - 0.03, 0], [cx + half, y + 0.03, wall_height],
                               (n_wall, 3)))
    for i in range(n_walls):
        x = cx - half + spacing / 2 + spacing * i + walls.uniform(-2, 2)
        pts.append(rng.uniform([x - 0.03, cy - half, 0], [x + 0.03, cy + half, wall_height],
                               (n_wall, 3)))
    return np.concatenate(pts)


def spinning_scan(world_pts: torch.Tensor, pose: torch.Tensor) -> torch.Tensor:
    """World points in the sensor frame at ``pose`` (lidar -> world)."""
    return (world_pts - pose[:3, 3]) @ pose[:3, :3]


def capture_time(sensor_pts: torch.Tensor, sensor_hz: float) -> torch.Tensor:
    """When a spinning sensor sees each point, from its azimuth: +pi at
    ``t = -ts`` down to -pi at ``t = 0``, the scan's end."""
    az = torch.atan2(sensor_pts[:, 1], sensor_pts[:, 0])
    return -(az + math.pi) / (2.0 * math.pi) / sensor_hz


def skewed_sweep(world_pts: torch.Tensor, pose_end: torch.Tensor, v_lin, omega,
                 sensor_hz: float, iterations: int = 3) -> torch.Tensor:
    """One sweep of a sensor moving at a constant body velocity: each
    world point in the sensor frame of the moment the sensor sees it (the
    sensor at ``pose_end @ [exp(omega t) | v_lin t]`` at time ``t`` in
    ``[-ts, 0]``; ``iterations`` fixed-point steps from the scan-end
    frame). With a zero velocity it is :func:`spinning_scan`."""
    like = dict(dtype=world_pts.dtype, device=world_pts.device)
    v_lin = torch.as_tensor(np.asarray(v_lin, np.float64), **like)
    omega = torch.as_tensor(np.asarray(omega, np.float64), **like)
    p_end = spinning_scan(world_pts, pose_end)
    p = p_end
    for _ in range(iterations):
        t = capture_time(p, sensor_hz)[:, None]
        R = exp_so3_torch(omega * t)  # (M, 3, 3): sensor at t -> sensor at the end
        p = torch.einsum("mji,mj->mi", R, p_end - v_lin * t)
    return p


class LapDrive:
    """The scans of one lap: the sensor's end pose of scan ``k`` is
    ``start @ D^k`` (``start`` the lap's first pose), :meth:`truth` the
    same in the frame of scan 0 (where an odometry run starts), and
    :meth:`scan` the sensor-frame cloud of ``points`` world points in
    range, drawn afresh for every scan, skewed by the motion during the
    sweep where ``skew``. Negative ``k`` are the scans before the drive
    (the priming ring's), the lap's last scans."""

    def __init__(self, world, sensor_hz: float, speed: float, lap_scans: int, points: int,
                 min_range: float, max_range: float, height: float, skew: bool, seed: int,
                 visible=math.inf):
        self.world = np.asarray(world, dtype=np.float64)
        self.hz, self.S, self.points = float(sensor_hz), int(lap_scans), int(points)
        self.min_range, self.max_range = float(min_range), float(max_range)
        self.skew, self.seed = bool(skew), int(seed)
        self.visible = float(visible)
        moving = speed > 0
        self.v_lin = np.array([speed, 0.0, 0.0])
        self.omega = np.array([0.0, 0.0, 2 * math.pi * self.hz / self.S if moving else 0.0])
        self.step = np.eye(4)
        self.step[:3, :3] = exp_so3(self.omega / self.hz)
        self.step[:3, 3] = self.v_lin / self.hz
        self.start = np.eye(4)
        self.start[2, 3] = height
        self._on: dict = {}  # the world on each device

    def truth(self, k: int) -> np.ndarray:
        """Scan ``k``'s end pose in the frame of scan 0's: ``D^k``."""
        return np.linalg.matrix_power(self.step, k % self.S)

    def pose(self, k: int) -> np.ndarray:
        """Scan ``k``'s end pose in the world (lidar -> world)."""
        return self.start @ self.truth(k)

    def chosen(self, k: int, device) -> torch.Tensor:
        """The world points scan ``k`` sees: ``points`` of those in range,
        drawn afresh for every scan with a generator on ``device`` seeded
        from ``[seed, k]``, kept in the world's order."""
        world = self._world(device)
        pose = torch.as_tensor(self.pose(k), device=device)
        k = k % self.S
        r = torch.linalg.norm(world - pose[:3, 3], dim=1)
        idx = torch.nonzero((r > self.min_range) & (r < min(self.max_range, self.visible)))[:, 0]
        if idx.numel() < self.points:
            raise ValueError(f"scan {k}: {idx.numel()} world points in range, want {self.points}")
        state = np.random.SeedSequence([self.seed, k]).generate_state(1, np.uint64)[0]
        g = torch.Generator(device=device).manual_seed(int(state) >> 1)
        pick = torch.randperm(idx.numel(), generator=g, device=device)[: self.points]
        return world[torch.sort(idx[pick]).values]

    def _world(self, device) -> torch.Tensor:
        key = str(torch.device(device))
        if key not in self._on:
            self._on[key] = torch.as_tensor(self.world, device=device)
        return self._on[key]

    def scan(self, k: int, device, skew=None) -> torch.Tensor:
        """Scan ``k`` as the sensor records it: (points, 3) float64 on
        ``device``; unskewed where ``skew`` is False."""
        pts = self.chosen(k, device)
        pose = torch.as_tensor(self.pose(k), device=device)
        if not (self.skew if skew is None else skew):
            return spinning_scan(pts, pose)
        return skewed_sweep(pts, pose, self.v_lin, self.omega, self.hz)

    def lap(self, device) -> list:
        """Every scan of the lap, float32 numpy arrays in host memory
        (where a dataset reader hands scans over)."""
        return [self.scan(k, device).to(torch.float32).cpu().numpy() for k in range(self.S)]


def make_drive(config: dict, traffic: dict, seed: int) -> LapDrive:
    """The drive of a configuration (sensor) and a traffic mix (lap and
    world) for ``seed``: the world is centred on the lap and reaches
    ``world.margin_m`` beyond it. Its layout (where each wall stands) is
    the same for every seed, so every seed's lap asks the same work of
    the program; the seed draws the world's points and each scan's."""
    w = traffic["world"]
    speed, S = float(traffic["speed_m_s"]), int(traffic["lap_scans"])
    hz = float(config["sensor_hz"])
    radius = speed * S / hz / (2 * math.pi)
    rng = np.random.default_rng([seed, 7])
    world = two_orientation_world(rng, density=w["density"], half=radius + w["margin_m"],
                                  spacing=w["wall_spacing_m"], center=(0.0, radius),
                                  wall_height=w["wall_height_m"],
                                  walls=np.random.default_rng(WALLS_SEED))
    return LapDrive(world, hz, speed, S, config["assumed"]["scan_points"],
                    config["min_range"], config["max_range"], config["sensor_height_m"],
                    config["skewed_sweeps"], seed, traffic.get("visible_m", math.inf))
