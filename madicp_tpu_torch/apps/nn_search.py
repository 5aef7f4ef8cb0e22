"""NN-search demo (parity with the reference tool
``apps/utils/tools/nn_search.py:38-61``): per-point-leaf MAD-tree over the
four-walls fixture; the full-cloud self-match error must be zero."""

from __future__ import annotations

import numpy as np

from madicp_tpu_torch.models.nn import MADtree
from madicp_tpu_torch.utils.fixtures import generate_four_walls_pointcloud


def main(points_per_wall: int = 2000, seed: int = 42, device=None) -> float:
    np.random.seed(seed)
    cloud = generate_four_walls_pointcloud(points_per_wall=points_per_wall)

    print("single point nn")
    qp = cloud[0, :]
    tree = MADtree(device=device)
    tree.build(cloud)
    ref_point, ref_normal = tree.search(qp)
    print(f"query point {qp}")
    print(f"ref point {ref_point} | ref normal {ref_normal}")
    print(f"error in matching {np.linalg.norm(ref_point - qp)}")

    print(10 * "=")
    print("full cloud nn")
    ref_pts, _ = tree.search_cloud(cloud)
    tot = float(np.sum(np.linalg.norm(ref_pts - cloud, axis=1)))
    print(f"error in matching {tot}")
    return tot


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--points-per-wall", type=int, default=2000)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--device", type=str, default="cuda")
    a = ap.parse_args()
    main(points_per_wall=a.points_per_wall, seed=a.seed, device=a.device)
