"""Configs, dataset IO, trajectory tooling, state conversion, devices."""

from madicp_tpu_torch.utils.config import (  # noqa: F401
    DATASET_CONFIGS,
    MAD_PARAMS,
    load_dataset_config,
    load_mad_params,
)
from madicp_tpu_torch.utils.trajectory import (  # noqa: F401
    write_transformed_pose,
    load_kitti_poses,
    save_kitti_poses,
    ate_rmse,
    kitti_drift,
)
from madicp_tpu_torch.utils.fixtures import generate_four_walls_pointcloud  # noqa: F401
