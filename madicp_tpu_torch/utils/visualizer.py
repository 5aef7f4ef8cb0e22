"""Live Open3D visualizer (optional dependency, gated).

Feature parity with the reference ``Visualizer`` (``visualizer.py:39-111``)
and the JAX package's: current scan in white, local-map leaves colored by
height, green trajectory segments, keyframe markers, SPACE pause / X
recenter. It draws host numpy arrays (``Pipeline.current_leaves()``,
``model_leaves()``, the poses). Open3D is imported when a Visualizer is
made; when it is missing, the class degrades to a no-op so headless runs
and the CLI work unchanged.
"""

from __future__ import annotations

import numpy as np


def _z_colormap(z: np.ndarray) -> np.ndarray:
    """Simple plasma-like height colormap without matplotlib."""
    if len(z) == 0:
        return np.zeros((0, 3))
    lo, hi = float(z.min()), float(z.max())
    t = (z - lo) / (hi - lo) if hi > lo else np.zeros_like(z)
    return np.stack([0.2 + 0.8 * t, 0.1 + 0.4 * t, 0.9 - 0.8 * t], axis=1)


class Visualizer:
    def __init__(self, window_name: str = "madicp_tpu_torch"):
        try:
            import open3d as o3d
        except ImportError:
            o3d = None
        self._o3d = o3d
        self.enabled = o3d is not None
        self.paused = False
        self._traj_pts: list[np.ndarray] = []
        # keyframe marker poses (one green sphere each, reference
        # visualizer.py:101-105); tracked even headless for testability
        self._kf_poses: list[np.ndarray] = []
        if not self.enabled:
            print("[visualizer] open3d not installed — running headless")
            return
        self.vis = o3d.visualization.VisualizerWithKeyCallback()
        self.vis.create_window(window_name, width=1280, height=720)
        self.scan = o3d.geometry.PointCloud()
        self.map = o3d.geometry.PointCloud()
        self.traj = o3d.geometry.LineSet()
        self.vis.add_geometry(self.scan)
        self.vis.add_geometry(self.map)
        self.vis.add_geometry(self.traj)
        self.vis.register_key_callback(ord(" "), self._toggle_pause)
        self.vis.register_key_callback(ord("X"), self._recenter)
        self._first = True

    def _toggle_pause(self, _vis):  # pragma: no cover
        self.paused = not self.paused
        return False

    def _recenter(self, _vis):  # pragma: no cover
        self.vis.reset_view_point(True)
        return False

    def update(self, current_leaves, model_leaves, pose, keyframe_pose):
        """Refresh the scene. ``keyframe_pose`` is non-None only on scans
        that promoted a keyframe (the CLI mirrors the reference's call
        pattern); each one adds a persistent green marker sphere at the
        keyframe origin, like the reference (``visualizer.py:101-105``,
        ``SPHERE_SIZE = 0.20``)."""
        pose = np.asarray(pose)
        self._traj_pts.append(pose[:3, 3].copy())
        if keyframe_pose is not None:
            self._kf_poses.append(np.asarray(keyframe_pose).copy())
        if not self.enabled:
            return
        o3d = self._o3d
        while self.paused:  # pragma: no cover
            self.vis.poll_events()
            self.vis.update_renderer()
        cl = np.asarray(current_leaves) if current_leaves is not None else None
        if cl is not None and len(cl):
            self.scan.points = o3d.utility.Vector3dVector(cl)
            self.scan.paint_uniform_color([1.0, 1.0, 1.0])
            self.vis.update_geometry(self.scan)
        ml = np.asarray(model_leaves) if model_leaves is not None else None
        if ml is not None and len(ml):
            self.map.points = o3d.utility.Vector3dVector(ml)
            self.map.colors = o3d.utility.Vector3dVector(_z_colormap(ml[:, 2]))
            self.vis.update_geometry(self.map)
        if keyframe_pose is not None:
            sphere = o3d.geometry.TriangleMesh.create_sphere(0.20)
            sphere.paint_uniform_color([0.0, 1.0, 0.0])
            sphere.transform(np.asarray(keyframe_pose))
            self.vis.add_geometry(sphere, reset_bounding_box=False)
        if len(self._traj_pts) >= 2:
            pts = np.stack(self._traj_pts)
            lines = [[i, i + 1] for i in range(len(pts) - 1)]
            self.traj.points = o3d.utility.Vector3dVector(pts)
            self.traj.lines = o3d.utility.Vector2iVector(lines)
            self.traj.colors = o3d.utility.Vector3dVector(
                [[0.0, 1.0, 0.0]] * len(lines)
            )
            self.vis.update_geometry(self.traj)
        if self._first:
            self.vis.reset_view_point(True)
            self._first = False
        self.vis.poll_events()
        self.vis.update_renderer()

    def close(self):
        if self.enabled:
            self.vis.destroy_window()
