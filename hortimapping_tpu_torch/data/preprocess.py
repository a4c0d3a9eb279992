"""Submap preprocessing and pose initialisation on the host (counterpart of
`hortimapping_tpu/data/preprocess.py`): largest-cluster cleaning through the
native DBSCAN, isolated-triangle filtering, and the AABB + background-support
pose init. numpy throughout, so it matches the JAX package bit for bit.
"""

from __future__ import annotations

import math
from collections import Counter
from typing import Optional, Tuple

import numpy as np

from hortimapping_tpu_torch import native
from hortimapping_tpu_torch.data.mesh import PointCloud, TriangleMesh


def clean_pcd(
    pcd: PointCloud,
    cluster_dist_thre: float = 0.01,
    outlier_point_ratio: float = 0.02,
) -> PointCloud:
    """Keep the largest DBSCAN cluster (`utils.py:407-417`).

    min_points = outlier_point_ratio * |cloud|; the kept label is the most
    common one — including the noise label -1 if noise dominates, matching
    the reference's `Counter.most_common` semantics.
    """
    n = len(pcd)
    if n == 0:
        return pcd
    min_instance_pts = int(n * outlier_point_ratio)
    labels = native.dbscan(pcd.points, eps=cluster_dist_thre, min_points=min_instance_pts)
    mode_label = Counter(labels.tolist()).most_common(1)[0][0]
    return pcd.select(np.where(labels == mode_label)[0])


def clean_mesh(
    mesh: TriangleMesh,
    sample_point_count: int = 5000,
    cluster_dist_thre: float = 0.01,
    outlier_point_ratio: float = 0.02,
    filter_isolated_mesh: bool = False,
    filter_cluster_min_tri: int = 20,
    seed: int = 0,
) -> PointCloud:
    """Uniform-sample the submap mesh then largest-cluster filter
    (`utils.py:389-405`). `filter_isolated_mesh` drops triangle clusters
    smaller than `filter_cluster_min_tri` first."""
    if filter_isolated_mesh and mesh.faces.shape[0] > 0:
        labels, counts = _cluster_connected_triangles(mesh.faces)
        keep = counts[labels] >= filter_cluster_min_tri
        mesh = TriangleMesh(mesh.vertices, mesh.faces[keep], mesh.vertex_colors)
    pcd = mesh.sample_points_uniformly(sample_point_count, seed=seed)
    return clean_pcd(pcd, cluster_dist_thre, outlier_point_ratio)


def _cluster_connected_triangles(faces: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Connected components of the triangle adjacency graph (shared vertex).

    Open3D `cluster_connected_triangles` analog; returns (label per triangle,
    triangle count per cluster).
    """
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    n_faces = faces.shape[0]
    n_verts = int(faces.max()) + 1 if n_faces else 0
    # triangle-vertex incidence; triangles sharing a vertex are connected
    rows = np.repeat(np.arange(n_faces), 3)
    inc = coo_matrix(
        (np.ones(3 * n_faces, np.int8), (rows, faces.reshape(-1))),
        shape=(n_faces, n_verts),
    ).tocsr()
    adj = inc @ inc.T
    _, labels = connected_components(adj, directed=False)
    counts = np.bincount(labels)
    return labels, counts


def get_pose_init(
    cur_pcd: PointCloud,
    bg_pcd: Optional[PointCloud],
    bbx_pad: float = 0.01,
    min_bbx_size: float = 0.03,
    max_bbx_size: float = 0.16,
    min_nearby_bg_pts: int = 10,
    max_init_rot_deg: float = 45.0,
    rot_on: bool = True,
) -> Tuple[np.ndarray, float, float, bool]:
    """Initial (center, yaw-around-y, bbox size, valid) for one fruit.

    Reference `get_pose_init` (`utils.py:420-459`): AABB size gate
    [min, max]; center shifted along +y by half the residual extent (+1 cm
    when y is the largest extent — sensor noise heuristic); initial y-yaw
    from the mean direction of background points in a box behind/above the
    fruit (the peduncle support), clamped to +-max_init_rot_deg.
    """
    box_min, box_max = cur_pcd.aabb()
    cur_center = (box_min + box_max) / 2.0
    cur_extent = box_max - box_min
    bbx_size = float(cur_extent.max()) + bbx_pad

    valid_flag = min_bbx_size <= bbx_size <= max_bbx_size
    init_rot_y_rad = 0.0
    max_init_rot = max_init_rot_deg / 180.0 * math.pi

    if valid_flag:
        cur_center = cur_center.copy()
        cur_center[1] += (bbx_size - cur_extent[1]) * 0.5
        if cur_extent[1] == cur_extent.max():
            cur_center[1] += 0.01
        if rot_on and bg_pcd is not None and len(bg_pcd) > 0:
            box_bg_min = [
                cur_center[0] - 0.6 * bbx_size,
                cur_center[1] - 0.8 * bbx_size,
                cur_center[2] + 0.2 * bbx_size,
            ]
            box_bg_max = [
                cur_center[0] + 0.6 * bbx_size,
                cur_center[1] + 1.0 * bbx_size,
                cur_center[2] + 1.2 * bbx_size,
            ]
            bg_crop = bg_pcd.crop(box_bg_min, box_bg_max)
            if len(bg_crop) > min_nearby_bg_pts:
                rot_vec = np.mean(bg_crop.points - cur_center, axis=0)
                init_rot_y_rad = 0.5 * math.pi - np.arctan2(rot_vec[2], rot_vec[0])
                init_rot_y_rad = max(min(init_rot_y_rad, max_init_rot), -max_init_rot)

    return cur_center, init_rot_y_rad, bbx_size, valid_flag


def build_T_wo(
    center: np.ndarray,
    init_rot_y_rad: float,
    scale: float,
    rot_on: bool = True,
    scale_on: bool = True,
) -> np.ndarray:
    """Object->world Sim(3) from the pose-init triple.

    Mirrors the entry-script assembly (`test_wild_completion.py:196-209`):
    R_wo = RotY(yaw) * s, t_wo = center.
    """
    T = np.eye(4, dtype=np.float64)
    yaw = init_rot_y_rad if rot_on else 0.0
    c, s = math.cos(yaw), math.sin(yaw)
    R = np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])
    T[:3, :3] = R * (scale if scale_on else 1.0)
    T[:3, 3] = center
    return T


def get_deg_between_vectors(v1: np.ndarray, v2: np.ndarray) -> float:
    """Angle between two vectors in degrees (`utils.py:462-479`)."""
    cosine = np.dot(v1, v2) / (np.linalg.norm(v1) * np.linalg.norm(v2))
    return float(np.degrees(np.arccos(np.clip(cosine, -1.0, 1.0))))
