"""KITTI-format readers (counterpart of `hortimapping_tpu/data/kitti.py`).

Vestigial, as in the reference: no entry point calls them; they ship for
API completeness.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from hortimapping_tpu_torch.data.mesh import PointCloud


def read_calib_file(filepath: str) -> Dict[str, np.ndarray]:
    """Parse `key: v0 v1 ...` calibration lines into float arrays; 12-value
    entries are reshaped to (3, 4) projection/extrinsic matrices, lines
    without a colon or with a non-numeric value are skipped."""
    calib: Dict[str, np.ndarray] = {}
    with open(filepath) as f:
        for line in f:
            if ":" not in line:
                continue
            key, value = line.split(":", 1)
            try:
                vals = np.array([float(x) for x in value.split()])
            except ValueError:
                continue
            calib[key.strip()] = vals.reshape(3, 4) if vals.size == 12 else vals
    return calib


def read_velodyne_bin(path: str) -> PointCloud:
    """A KITTI velodyne scan (float32 x, y, z, intensity records) as a point
    cloud of its xyz."""
    scan = np.fromfile(path, dtype=np.float32).reshape(-1, 4)
    return PointCloud(scan[:, :3])
