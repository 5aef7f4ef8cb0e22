"""Trajectory IO and evaluation metrics.

Output parity: KITTI 3x4 row-major pose lines with the estimate conjugated
by the sensor extrinsics (reference ``apps/utils/utils.py:31-34``,
``bin_runner.cpp:253-269``). The evaluation half (ATE RMSE, KITTI
segment-drift) implements the standard published definitions so the
benchmark harness can score trajectories against ground truth or against
reference-produced golden files (BASELINE.md).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def transformed_pose(lidar_to_world: np.ndarray, lidar_to_base: np.ndarray) -> np.ndarray:
    """``base_to_world = E @ T @ E^-1`` with E = lidar_to_base."""
    E = np.asarray(lidar_to_base, float)
    return E @ np.asarray(lidar_to_world, float) @ np.linalg.inv(E)


def write_transformed_pose(estimate_file, lidar_to_world, lidar_to_base) -> None:
    """Append one KITTI-format line (12 scalars, first 3 rows row-major)."""
    T = transformed_pose(lidar_to_world, lidar_to_base)
    np.savetxt(estimate_file, T[:3].reshape(-1, 12))


def save_kitti_poses(path, poses: Sequence[np.ndarray], lidar_to_base=None) -> None:
    with open(path, "w") as f:
        E = np.eye(4) if lidar_to_base is None else lidar_to_base
        for T in poses:
            write_transformed_pose(f, T, E)


def load_kitti_poses(path) -> np.ndarray:
    """Read an (N, 4, 4) pose array from a KITTI 12-scalar-per-line file."""
    flat = np.loadtxt(path).reshape(-1, 3, 4)
    n = flat.shape[0]
    out = np.tile(np.eye(4), (n, 1, 1))
    out[:, :3, :] = flat
    return out


def ate_rmse(est: np.ndarray, gt: np.ndarray, align: bool = True) -> float:
    """Absolute trajectory error (RMSE of translations), optionally after a
    closed-form SE(3) alignment (Horn/Umeyama without scale)."""
    p = np.asarray(est)[:, :3, 3]
    q = np.asarray(gt)[: len(p), :3, 3]
    p = p[: len(q)]
    if align and len(p) >= 3:
        mp, mq = p.mean(0), q.mean(0)
        H = (p - mp).T @ (q - mq)
        U, _, Vt = np.linalg.svd(H)
        D = np.diag([1.0, 1.0, np.sign(np.linalg.det(Vt.T @ U.T))])
        R = Vt.T @ D @ U.T
        t = mq - R @ mp
        p = p @ R.T + t
    return float(np.sqrt(np.mean(np.sum((p - q) ** 2, axis=1))))


def _trajectory_distances(poses: np.ndarray) -> np.ndarray:
    d = np.linalg.norm(np.diff(poses[:, :3, 3], axis=0), axis=1)
    return np.concatenate([[0.0], np.cumsum(d)])


def kitti_drift(
    est: np.ndarray,
    gt: np.ndarray,
    lengths: Sequence[float] = (100, 200, 300, 400, 500, 600, 700, 800),
    step: int = 10,
) -> dict:
    """KITTI odometry benchmark drift: mean relative translational error (%)
    and rotational error (deg/m) over all sub-segments of the given lengths.
    """
    est = np.asarray(est)
    gt = np.asarray(gt)[: len(est)]
    est = est[: len(gt)]
    dist = _trajectory_distances(gt)

    t_errs, r_errs = [], []
    for first in range(0, len(gt), step):
        for length in lengths:
            target = dist[first] + length
            last = int(np.searchsorted(dist, target))
            if last >= len(gt):
                continue
            gt_rel = np.linalg.inv(gt[first]) @ gt[last]
            est_rel = np.linalg.inv(est[first]) @ est[last]
            err = np.linalg.inv(est_rel) @ gt_rel
            t_errs.append(np.linalg.norm(err[:3, 3]) / length)
            ang = np.arccos(
                np.clip((np.trace(err[:3, :3]) - 1.0) / 2.0, -1.0, 1.0)
            )
            r_errs.append(ang / length)
    if not t_errs:
        return {"t_err_pct": float("nan"), "r_err_deg_per_m": float("nan"), "segments": 0}
    return {
        "t_err_pct": 100.0 * float(np.mean(t_errs)),
        "r_err_deg_per_m": float(np.degrees(np.mean(r_errs))),
        "segments": len(t_errs),
    }
