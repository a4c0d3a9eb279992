"""Base class of the 3-D metrics (counterpart of
`hortimapping_tpu/metrics/metric.py`): geometry coercion and the
empty-prediction guard.

Accepted geometries are the host containers (`TriangleMesh`, sampled with
1 M points as the reference metric does; `PointCloud`) and (N, >=3) arrays;
the output is a plain (N, 3) numpy array.
"""

from __future__ import annotations

import numpy as np

from hortimapping_tpu_torch.data.mesh import PointCloud, TriangleMesh

MESH_SAMPLE_POINTS = 1_000_000


class Metrics3D:
    @staticmethod
    def convert_to_points(geom, n_sample: int = MESH_SAMPLE_POINTS) -> np.ndarray:
        if isinstance(geom, TriangleMesh):
            return geom.sample_points_uniformly(n_sample).points
        if isinstance(geom, PointCloud):
            return np.asarray(geom.points)[:, :3]
        arr = np.asarray(geom)
        if arr.ndim != 2 or arr.shape[1] < 3:
            raise TypeError(f"unsupported geometry of shape {arr.shape}")
        return arr[:, :3].astype(np.float64)

    @staticmethod
    def prediction_is_empty(geom) -> bool:
        if isinstance(geom, TriangleMesh):
            return len(geom.vertices) == 0
        if isinstance(geom, PointCloud):
            return len(geom) == 0
        return np.asarray(geom).shape[0] == 0
