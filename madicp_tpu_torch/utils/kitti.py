"""KITTI-format ``.bin`` dataset reader.

Parity with the reference ``KittiReader`` (``kitti_reader.py:36-95``):
naturally-sorted ``*.bin`` glob, float32 N x 4 records (dtype overridable
via a ``.dtype.pkl`` in the directory), range filter, optional 0.205
degree vertical-angle correction (the undocumented "KITTI magic",
``kitti_reader.py:58,73-79``, ``bin_runner.cpp:55,153-161``), synthetic
timestamps at the sensor rate.

If the native loader (madicp_tpu_torch.native) builds, reads go through
its C++ path (bitwise equal to the numpy one); otherwise pure numpy.
"""

from __future__ import annotations

import pickle
from pathlib import Path
from typing import Tuple

import numpy as np

from madicp_tpu_torch.utils.natsort import natsorted


# the native loader's constant (loader.cpp): np.radians(0.205) is one ulp
# away, and with it the two readers would differ in the last bit
CORRECTION_RAD = 0.205 * np.pi / 180.0


def apply_vertical_correction(points: np.ndarray, angle_rad: float = CORRECTION_RAD) -> np.ndarray:
    """Rotate every point by ``angle_rad`` about ``p x z`` (toward +z).

    Rodrigues applied per point, vectorised (reference
    ``kitti_reader.py:73-79``). Points on the z axis have no rotation
    axis and stay as they are, as in the native loader.
    """
    axis = np.cross(points, np.array([0.0, 0.0, 1.0]))
    norms = np.linalg.norm(axis, axis=1, keepdims=True)
    on_axis = norms == 0
    k = axis / np.where(on_axis, 1.0, norms)
    c = np.cos(angle_rad)
    s = np.sin(angle_rad)
    kxp = np.cross(k, points)
    kdp = np.sum(k * points, axis=1, keepdims=True)
    return np.where(on_axis, points, points * c + kxp * s + k * kdp * (1.0 - c))


def read_bin_numpy(path, cdtype, min_range: float, max_range: float,
                   apply_correction: bool) -> np.ndarray:
    """The numpy reader of one ``.bin`` scan: (N, 3) float64 points."""
    cloud = np.fromfile(path, dtype=cdtype).reshape(-1, 4)[:, :3]
    cloud = cloud.astype(np.float64)
    norms = np.linalg.norm(cloud, axis=1)
    pts = cloud[(norms >= min_range) & (norms <= max_range)]
    if apply_correction:
        pts = apply_vertical_correction(pts)
    return pts


class KittiReader:
    def __init__(
        self,
        data_dir: Path,
        min_range: float = 0,
        max_range: float = 200,
        apply_correction: bool = False,
        *args,
        **kwargs,
    ):
        sensor_hz = kwargs.pop("sensor_hz", 10.0)
        data_dir = Path(data_dir)
        self.file_names = natsorted(data_dir.glob("*.bin"))
        self.min_range = float(min_range)
        self.max_range = float(max_range)
        self.apply_correction = bool(apply_correction)
        self.time = 0.0
        self.time_inc = 1.0 / float(sensor_hz)
        self.file_index = 0
        self.cdtype = np.float32
        dtype_pkl = data_dir / ".dtype.pkl"
        if dtype_pkl.exists():
            with open(dtype_pkl, "rb") as f:
                self.cdtype = pickle.load(f)
        self._native = None
        if not dtype_pkl.exists():
            from madicp_tpu_torch.native import loader as native_loader

            if native_loader.available():
                self._native = native_loader

    def __len__(self):
        return len(self.file_names)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        return

    def __iter__(self):
        self.file_index = 0
        self.time = 0.0
        return self

    def __next__(self):
        if self.file_index >= len(self.file_names):
            raise StopIteration
        item = self[self.file_index]
        self.file_index += 1
        self.time += self.time_inc
        return item

    def __getitem__(self, item) -> Tuple[float, np.ndarray]:
        """Random access by scan index (timestamps are synthetic at the
        sensor rate, so ``reader[k]`` is ``((k+1)/hz, points_k)``)."""
        path = self.file_names[item]
        if self._native is not None:
            pts = self._native.read_bin(
                path, self.min_range, self.max_range, self.apply_correction
            )
        else:
            pts = read_bin_numpy(path, self.cdtype, self.min_range,
                                 self.max_range, self.apply_correction)
        return (item + 1) * self.time_inc, pts
