"""sensor_msgs/PointCloud2 decoding without any ROS distribution.

Counterpart of `vfmreg_tpu/kiss/point_cloud2.py` (the reference's
`kiss_icp/tools/point_cloud2.py`, itself from ROS2's sensor_msgs_py) for the
mcap / rosbag readers: a PointCloud2-shaped message (duck-typed: `.fields`
with name/offset/datatype/count, `.width`, `.height`, `.point_step`,
`.row_step`, `.data`, `.is_bigendian`) is decoded into a numpy structured
array through one strided view, with no per-point Python loop.

`read_point_cloud` keeps the reference's behaviour (`point_cloud2.py:59-89`):
xyz plus the first of ("t", "timestamp", "time") as per-point time, NaN rows
dropped from the points, timestamps min-max normalised. The reference
normalises timestamps computed from the unfiltered rows, and so does this.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

# sensor_msgs/PointField datatype codes.
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


def dtype_from_fields(fields, field_names: Optional[List[str]] = None, point_step: Optional[int] = None) -> np.dtype:
    """Structured dtype covering the selected fields at their byte offsets."""
    names, formats, offsets = [], [], []
    for f in fields:
        if field_names is not None and f.name not in field_names:
            continue
        base = _DATATYPES[int(f.datatype)]
        count = int(getattr(f, "count", 1) or 1)
        for c in range(count):
            names.append(f.name if count == 1 else f"{f.name}_{c}")
            formats.append(base)
            offsets.append(int(f.offset) + c * base.itemsize)
    spec = {"names": names, "formats": formats, "offsets": offsets}
    if point_step is not None:
        spec["itemsize"] = int(point_step)
    return np.dtype(spec)


def read_points(msg, field_names: Optional[List[str]] = None) -> np.ndarray:
    """PointCloud2 -> structured array of the selected fields ([N] rows)."""
    dtype = dtype_from_fields(msg.fields, field_names, int(msg.point_step))
    n = int(msg.width) * int(msg.height)
    buf = bytes(msg.data)[: n * int(msg.point_step)]
    pts = np.frombuffer(buf, dtype=dtype, count=n)
    if bool(getattr(msg, "is_bigendian", False)):
        pts = pts.byteswap()
    return pts


def read_point_cloud(msg) -> Tuple[np.ndarray, np.ndarray]:
    """(points [N, 3] f64 with NaN rows dropped, timestamps [M] in [0, 1])."""
    field_names = ["x", "y", "z"]
    t_field = None
    for f in msg.fields:
        if f.name in ("t", "timestamp", "time"):
            t_field = f.name
            field_names.append(t_field)
            break

    structured = read_points(msg, field_names=field_names)
    points = np.column_stack([structured["x"], structured["y"], structured["z"]])
    points = points[~np.any(np.isnan(points), axis=1)]

    if t_field:
        timestamps = structured[t_field].astype(np.float64)
        lo, hi = np.min(timestamps), np.max(timestamps)
        timestamps = (timestamps - lo) / (hi - lo) if hi > lo else np.zeros_like(timestamps)
    else:
        timestamps = np.ones(points.shape[0])
    return points.astype(np.float64), timestamps
