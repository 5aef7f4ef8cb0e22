"""Pairwise-registration demo (parity with the reference tool
``apps/utils/tools/mad_registration.py:48-133``): perturb a copy of the
four-walls cloud and recover identity in 15 ICP iterations.

With ``viz=True`` (and open3d installed) each iteration is animated:
one ICP round at a time, the transformed query cloud redrawn, and a
green line per matched point pair — the reference's per-iteration
match-line visualization (``mad_registration.py:100-133``). Headless
environments fall back to the plain compute."""

from __future__ import annotations

import numpy as np
import torch

from madicp_tpu_torch.models.registration import MADicp
from madicp_tpu_torch.ops.lie import exp_so3
from madicp_tpu_torch.utils.fixtures import generate_four_walls_pointcloud

MAX_ITERATIONS = 15


def _euler_xyz_matrix(ax, ay, az) -> np.ndarray:
    def rot(omega):
        return exp_so3(torch.tensor(omega, dtype=torch.float64)).numpy()

    return rot([0.0, 0.0, az]) @ rot([0.0, ay, 0.0]) @ rot([ax, 0.0, 0.0])


def _run_with_viz(madicp, ref_cloud, query_cloud, T_guess) -> np.ndarray:
    """Per-iteration animation with match lines (reference
    ``mad_registration.py:100-133``); requires open3d."""
    import time

    import open3d as o3d

    from madicp_tpu_torch.models.nn import MADtree

    tree = MADtree(device=madicp.device)
    tree.build(ref_cloud)  # per-point leaves: NN lines hit real points

    vis = o3d.visualization.Visualizer()
    vis.create_window("mad_registration", width=1280, height=720)
    ref_pcd = o3d.geometry.PointCloud()
    ref_pcd.points = o3d.utility.Vector3dVector(ref_cloud)
    ref_pcd.paint_uniform_color([0.0, 0.0, 1.0])
    query_pcd = o3d.geometry.PointCloud()
    query_pcd.points = o3d.utility.Vector3dVector(query_cloud)
    query_pcd.paint_uniform_color([1.0, 0.0, 0.0])
    vis.add_geometry(ref_pcd)
    vis.add_geometry(query_pcd)
    opt = vis.get_render_option()
    opt.point_size = 5
    opt.background_color = np.asarray([1.0, 1.0, 1.0])
    opt.line_width = 2.0

    T = np.asarray(T_guess)
    line_set = None
    for _ in range(MAX_ITERATIONS):
        T = madicp.compute(T, icp_iterations=1)
        moved = query_cloud @ T[:3, :3].T + T[:3, 3]
        matched_pts, _ = tree.search_cloud(moved)

        query_pcd.points = o3d.utility.Vector3dVector(moved)
        vis.update_geometry(query_pcd)
        if line_set is not None:
            vis.remove_geometry(line_set, reset_bounding_box=False)
        n = len(moved)
        line_set = o3d.geometry.LineSet(
            points=o3d.utility.Vector3dVector(np.vstack([moved, matched_pts])),
            lines=o3d.utility.Vector2iVector([[i, i + n] for i in range(n)]),
        )
        line_set.colors = o3d.utility.Vector3dVector([[0, 1, 0]] * n)
        vis.add_geometry(line_set, reset_bounding_box=False)
        vis.poll_events()
        vis.update_renderer()
        time.sleep(0.1)
    vis.run()
    vis.destroy_window()
    return T


def main(points_per_wall: int = 1000, seed: int = 42, viz: bool = False,
         device=None) -> np.ndarray:
    np.random.seed(seed)
    ref_cloud = generate_four_walls_pointcloud(points_per_wall=points_per_wall)
    query_cloud = ref_cloud.copy()

    T_guess = np.eye(4)
    T_guess[:3, :3] = _euler_xyz_matrix(0.1, 0.1, 0.1)
    T_guess[:3, 3] = np.random.rand(3)
    print("init guess T\n", T_guess)
    print("gt T\n", np.eye(4))

    madicp = MADicp(device=device)
    madicp.set_reference_cloud(ref_cloud)
    madicp.set_query_cloud(query_cloud)
    if viz:
        try:
            import open3d  # noqa: F401
        except ImportError:
            print("[mad_registration] open3d not installed — running headless")
            viz = False
    if viz:
        T_est = _run_with_viz(madicp, ref_cloud, query_cloud, T_guess)
    else:
        T_est = madicp.compute(
            T_guess, icp_iterations=MAX_ITERATIONS, print_stats=True
        )
    print("estimate \n", T_est)
    return T_est


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--viz", action="store_true", help="per-iteration viz")
    ap.add_argument("--points-per-wall", type=int, default=1000)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--device", type=str, default="cuda")
    a = ap.parse_args()
    main(points_per_wall=a.points_per_wall, seed=a.seed, viz=a.viz, device=a.device)
