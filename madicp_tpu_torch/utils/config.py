"""Configuration system — one source of truth.

The reference duplicates every preset between Python dicts and YAML
``.cfg`` files (``configurations/mad_params.py`` vs ``default.cfg``,
``dataset_configurations.py`` vs ``datasets/*.cfg`` — a drift risk noted
in SURVEY.md §5). Here the presets live once, as dataclasses; YAML files
with the same keys are accepted by path, exactly like the reference CLI
(``apps/mad_icp.py:114-153``).
"""

from __future__ import annotations

from dataclasses import dataclass, field, asdict
from pathlib import Path
from typing import Optional

import numpy as np


@dataclass(frozen=True)
class MADParams:
    """Solver parameters (reference ``mad_params.py:31-47``)."""

    b_max: float = 0.2    # [m] max size of tree leaves
    b_min: float = 0.1    # [m] plane-predecessor flatness threshold
    b_ratio: float = 0.02  # search-radius growth with range
    p_th: float = 0.8     # inlier-ratio threshold for keyframe promotion
    rho_ker: float = 0.1  # huber threshold (sqrt applied in the solver)
    n: int = 10           # velocity smoothing window


@dataclass(frozen=True)
class DatasetConfig:
    """Sensor/dataset envelope (reference ``dataset_configurations.py:31-147``)."""

    min_range: float
    max_range: float
    sensor_hz: float
    deskew: bool
    lidar_to_base: tuple
    rosbag_topic: Optional[str] = None
    apply_correction: bool = False

    @property
    def extrinsics(self) -> np.ndarray:
        return np.asarray(self.lidar_to_base, dtype=float)


def _mat(rows) -> tuple:
    return tuple(tuple(float(x) for x in r) for r in rows)


_I4 = _mat(np.eye(4))

MAD_PARAMS = {
    "default": MADParams(),
}

DATASET_CONFIGS = {
    "hilti_2021": DatasetConfig(
        min_range=0.7, max_range=100, sensor_hz=10, deskew=False,
        rosbag_topic="/os_cloud_node/points",
        lidar_to_base=_mat([
            [1, 0.0025, -0.0065, 0.0100],
            [0.0025, -1, 0.0003, -0.0066],
            [-0.0065, -0.0003, -1, 0.0947],
            [0, 0, 0, 1],
        ]),
    ),
    "kitti": DatasetConfig(
        min_range=0.7, max_range=120, sensor_hz=10, deskew=False,
        apply_correction=True,
        lidar_to_base=_mat([
            [4.276802385584e-04, -9.999672484946e-01, -8.084491683471e-03, -1.198459927713e-02],
            [-7.210626507497e-03, 8.081198471645e-03, -9.999413164504e-01, -5.403984729748e-02],
            [9.999738645903e-01, 4.859485810390e-04, -7.206933692422e-03, -2.921968648686e-01],
            [0, 0, 0, 1],
        ]),
    ),
    "mulran": DatasetConfig(
        min_range=0.7, max_range=120, sensor_hz=10, deskew=True,
        lidar_to_base=_mat([
            [-1, -0.0058, 0, 1.7042],
            [0.0058, -1, 0, -0.0210],
            [0, 0, 1, 1.8047],
            [0, 0, 0, 1],
        ]),
    ),
    "newer_college_os0": DatasetConfig(
        min_range=0.7, max_range=50, sensor_hz=10, deskew=False,
        rosbag_topic="/os_cloud_node/points",
        lidar_to_base=_mat([
            [1, 0, 0, 0.001],
            [0, 1, 0, 0],
            [0, 0, 1, 0.090683],
            [0, 0, 0, 1],
        ]),
    ),
    "newer_college_os1": DatasetConfig(
        min_range=0.7, max_range=120, sensor_hz=10, deskew=False,
        rosbag_topic="/os1_cloud_node/points",
        lidar_to_base=_mat([
            [-0.7071, -0.7071, 0, -0.0843],
            [0.7071, -0.7071, 0, -0.0250],
            [0, 0, 1, 0.0502],
            [0, 0, 0, 1],
        ]),
    ),
    "vbr_os0": DatasetConfig(
        min_range=0, max_range=50, sensor_hz=10, deskew=False,
        rosbag_topic="/ouster/points", lidar_to_base=_I4,
    ),
    "vbr_os1": DatasetConfig(
        min_range=1.3, max_range=120, sensor_hz=20, deskew=True,
        rosbag_topic="/ouster/points", lidar_to_base=_I4,
    ),
}


def load_dataset_config(name_or_path) -> DatasetConfig:
    """Resolve a dataset config by preset name or YAML file path
    (reference ``apps/mad_icp.py:114-134``)."""
    p = Path(str(name_or_path))
    if p.is_file():
        import yaml

        with open(p) as f:
            d = yaml.safe_load(f)
        return DatasetConfig(
            min_range=float(d["min_range"]),
            max_range=float(d["max_range"]),
            sensor_hz=float(d["sensor_hz"]),
            deskew=bool(d["deskew"]),
            lidar_to_base=_mat(d["lidar_to_base"]),
            rosbag_topic=d.get("rosbag_topic"),
            apply_correction=bool(d.get("apply_correction", False)),
        )
    name = str(name_or_path)
    if name in DATASET_CONFIGS:
        return DATASET_CONFIGS[name]
    raise KeyError(
        f"dataset '{name}' not found; presets: {', '.join(DATASET_CONFIGS)}"
    )


def load_mad_params(name_or_path) -> MADParams:
    """Resolve solver params by preset name or YAML file path
    (reference ``apps/mad_icp.py:137-153``)."""
    p = Path(str(name_or_path))
    if p.is_file():
        import yaml

        with open(p) as f:
            d = yaml.safe_load(f)
        return MADParams(
            b_max=float(d["b_max"]),
            b_min=float(d["b_min"]),
            b_ratio=float(d["b_ratio"]),
            p_th=float(d["p_th"]),
            rho_ker=float(d["rho_ker"]),
            n=int(d["n"]),
        )
    name = str(name_or_path)
    if name in MAD_PARAMS:
        return MAD_PARAMS[name]
    raise KeyError(f"mad params '{name}' not found; presets: {', '.join(MAD_PARAMS)}")


def dump_yaml(cfg, path) -> None:
    """Write a preset as a YAML file round-trippable by the loaders."""
    import yaml

    d = asdict(cfg)
    if "lidar_to_base" in d:
        d["lidar_to_base"] = [list(r) for r in d["lidar_to_base"]]
        if d.get("rosbag_topic") is None:
            d.pop("rosbag_topic")
    with open(path, "w") as f:
        yaml.safe_dump(d, f)
