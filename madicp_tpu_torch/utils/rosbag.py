"""ROS1 / ROS2 / MCAP dataset readers (optional dependencies, gated).

Behavior parity with the reference readers (``ros_reader.py:38-97``,
``ros2_reader.py:38-90``, ``mcap_reader.py:38-127``): topic-filtered
PointCloud2 iteration with range filtering via
:mod:`madicp_tpu_torch.utils.pointcloud2`. The ``rosbags`` / ``mcap`` packages
are not part of this image; constructing a reader without them raises a
clear error instead of exiting, and everything else in the framework works
without them.
"""

from __future__ import annotations

from pathlib import Path
from typing import Tuple

import numpy as np

from madicp_tpu_torch.utils.natsort import natsorted
from madicp_tpu_torch.utils.pointcloud2 import read_point_cloud


class _RosbagsReaderBase:
    """Shared rosbags.AnyReader logic for ROS1 .bag and ROS2 .db3."""

    GLOB = "*.bag"

    def __init__(self, data_dir: Path, min_range=0, max_range=200, *args, **kwargs):
        topic = kwargs.pop("topic", None)
        try:
            from rosbags.highlevel import AnyReader
        except ModuleNotFoundError as e:
            raise ImportError(
                "the 'rosbags' package is required for bag reading: "
                "pip install -U rosbags"
            ) from e
        if topic is None:
            raise ValueError("a PointCloud2 topic must be specified")

        data_dir = Path(data_dir)
        if data_dir.is_file():
            self.bag = AnyReader([data_dir])
        else:
            self.bag = AnyReader(natsorted(data_dir.glob(self.GLOB)))
        self.bag.open()
        connections = [c for c in self.bag.connections if c.topic == topic]
        if not connections:
            available = sorted({c.topic for c in self.bag.connections})
            raise ValueError(f"topic {topic!r} not in bag; available: {available}")
        self.msgs = self.bag.messages(connections=connections)
        self.min_range = min_range
        self.max_range = max_range
        self.topic = topic
        self.num_messages = self.bag.topics[topic].msgcount
        self._cursor = 0

    def __len__(self):
        return self.num_messages

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        if hasattr(self, "bag"):
            self.bag.close()

    def __iter__(self):
        return self

    def __next__(self):
        return self[self._cursor]

    def __getitem__(self, item) -> Tuple[float, np.ndarray]:
        """Sequential access only: bag messages are a stream, not files.

        ``reader[i]`` is valid exactly when ``i`` is the next unread
        index (so ``for i in range(len(r)): r[i]`` and iteration both
        work); anything else raises instead of silently returning the
        wrong scan. True random access exists only on
        :class:`~madicp_tpu_torch.utils.kitti.KittiReader` (one file per scan).
        """
        if item != self._cursor:
            raise IndexError(
                f"bag streams are sequential: next readable index is "
                f"{self._cursor}, got {item}"
            )
        connection, timestamp, rawdata = next(self.msgs)
        self._cursor += 1
        msg = self.bag.deserialize(rawdata, connection.msgtype)
        points, _ = read_point_cloud(
            msg, min_range=self.min_range, max_range=self.max_range
        )
        # rosbags stamps are nanoseconds; every reader yields SECONDS
        return timestamp * 1e-9, points


class Ros1Reader(_RosbagsReaderBase):
    GLOB = "*.bag"


class Ros2Reader(_RosbagsReaderBase):
    GLOB = "*.db3"


class McapReader:
    def __init__(self, data_dir: Path, min_range=0, max_range=200, *args, **kwargs):
        topic = kwargs.pop("topic", None)
        if topic is None:
            raise ValueError("a PointCloud2 topic must be specified")
        try:
            from mcap.reader import make_reader
            from mcap_ros2.reader import read_ros2_messages
        except ModuleNotFoundError as e:
            raise ImportError(
                "the 'mcap'/'mcap-ros2-support' packages are required for "
                "mcap reading: pip install -U mcap-ros2-support"
            ) from e

        data_dir = Path(data_dir)
        mcap_file = next(data_dir.glob("*.mcap"), None) if data_dir.is_dir() else data_dir
        if mcap_file is None or not Path(mcap_file).is_file():
            raise FileNotFoundError(f"no .mcap file under {data_dir}")
        self._reader = make_reader(open(mcap_file, "rb"))
        summary = self._reader.get_summary()

        schema_ids = [
            s.id
            for s in summary.schemas.values()
            if s.name == "sensor_msgs/msg/PointCloud2"
        ]
        pc2_topics = [
            ch.topic
            for ch in summary.channels.values()
            if ch.schema_id in schema_ids
        ]
        if topic not in pc2_topics:
            raise ValueError(
                f"topic {topic!r} is not a PointCloud2 topic; available: {pc2_topics}"
            )
        self.topic = topic
        self.num_messages = sum(
            count
            for cid, count in summary.statistics.channel_message_counts.items()
            if summary.channels[cid].topic == topic
        )
        self.msgs = read_ros2_messages(str(mcap_file), topics=[topic])
        self.min_range = min_range
        self.max_range = max_range
        self._cursor = 0

    def __len__(self):
        return self.num_messages

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        return

    def __iter__(self):
        return self

    def __next__(self):
        return self[self._cursor]

    def __getitem__(self, item) -> Tuple[float, np.ndarray]:
        """Sequential access only (see ``_RosbagsReaderBase.__getitem__``)."""
        if item != self._cursor:
            raise IndexError(
                f"mcap streams are sequential: next readable index is "
                f"{self._cursor}, got {item}"
            )
        msg = next(self.msgs).ros_msg
        self._cursor += 1
        points, _ = read_point_cloud(
            msg, min_range=self.min_range, max_range=self.max_range
        )
        stamp = msg.header.stamp.sec + msg.header.stamp.nanosec * 1e-9
        return stamp, points
