"""ROS PointCloud2 decoding (library-independent).

Behavior parity with the reference's ``point_cloud2.py:61-188``: a
structured dtype is assembled from the message's field descriptors
(honouring offsets, counts and the point step), bytes are viewed in place,
endianness is fixed, xyz is stacked, NaNs dropped, ranges filtered and
per-point timestamps normalised to [0, 1] (ones when absent). Works on any
message-like object exposing ``fields`` (each with ``name``, ``offset``,
``datatype``, ``count``), ``width``, ``height``, ``point_step``,
``is_bigendian`` and ``data`` — rosbags/mcap messages or plain
``types.SimpleNamespace`` test doubles.
"""

from __future__ import annotations

import sys
from typing import Iterable, List, Optional, Tuple

import numpy as np

# sensor_msgs/PointField datatype codes
_DATATYPES = {
    1: np.dtype(np.int8),
    2: np.dtype(np.uint8),
    3: np.dtype(np.int16),
    4: np.dtype(np.uint16),
    5: np.dtype(np.int32),
    6: np.dtype(np.uint32),
    7: np.dtype(np.float32),
    8: np.dtype(np.float64),
}

DUMMY_FIELD_PREFIX = "unnamed_field"


def dtype_from_fields(fields: Iterable, point_step: Optional[int] = None) -> np.dtype:
    names: List[str] = []
    formats: List[str] = []
    offsets: List[int] = []
    for i, f in enumerate(fields):
        base = _DATATYPES[int(f.datatype)]
        name = f.name if f.name else f"{DUMMY_FIELD_PREFIX}_{i}"
        count = int(getattr(f, "count", 1))
        if count <= 0:
            raise ValueError("PointField count must be positive")
        for a in range(count):
            sub = f"{name}_{a}" if count > 1 else name
            if sub in names:
                raise ValueError(f"duplicate field name {sub!r}")
            names.append(sub)
            offsets.append(int(f.offset) + a * base.itemsize)
            formats.append(base.str)
    spec = {"names": names, "formats": formats, "offsets": offsets}
    if point_step is not None:
        spec["itemsize"] = int(point_step)
    return np.dtype(spec)


def read_points(cloud, field_names: Optional[List[str]] = None) -> np.ndarray:
    points = np.frombuffer(
        bytes(cloud.data),
        dtype=dtype_from_fields(cloud.fields, point_step=cloud.point_step),
        count=int(cloud.width) * int(cloud.height),
    )
    if field_names is not None:
        missing = [n for n in field_names if n not in points.dtype.names]
        if missing:
            raise ValueError(f"fields {missing} not present in PointCloud2")
        points = points[list(field_names)]
    if (sys.byteorder != "little") != bool(cloud.is_bigendian):
        points = points.byteswap()
    return points


def read_point_cloud(msg, min_range: float, max_range: float) -> Tuple[np.ndarray, np.ndarray]:
    """PointCloud2 -> ((N,3) float64 points, (N,) timestamps in [0,1])."""
    field_names = ["x", "y", "z"]
    t_field = None
    for f in msg.fields:
        if f.name in ("t", "timestamp", "time"):
            t_field = f.name
            field_names.append(t_field)
            break

    structured = read_points(msg, field_names=field_names)
    points = np.column_stack(
        [structured["x"], structured["y"], structured["z"]]
    ).astype(np.float64)

    keep = ~np.any(np.isnan(points), axis=1)
    points = points[keep]
    structured = structured[keep]
    norms = np.linalg.norm(points, axis=1)
    rng = (norms > min_range) & (norms < max_range)
    points = points[rng]

    if t_field and points.shape[0] > 0:
        ts = structured[t_field][rng].astype(np.float64)
        lo, hi = float(ts.min()), float(ts.max())
        ts = (ts - lo) / (hi - lo) if hi > lo else np.ones_like(ts)
    else:
        ts = np.ones(points.shape[0])
    return points, ts
