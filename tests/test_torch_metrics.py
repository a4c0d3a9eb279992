"""The port's 3-D metrics (`hortimapping_tpu_torch/metrics/`) against the
JAX package's (`hortimapping_tpu/metrics/`) on the CPU, on the same clouds
and meshes.

Tolerances. Nearest-neighbour distances: both packages run the same f32
brute force (recentred, the neighbour picked by the expanded form, the
distance recomputed directly) up to 1e8 pairs and scipy's KD-tree above, so
distances agree within 1e-6 m and Chamfer means within 1e-7 m. Precision
and recall compare distances with thresholds (strict `<`): a point whose
distance lies within rounding of a threshold may flip, so each percentage
may move by at most one point of its cloud (100 / N); the AUC by as much.
The brute force and the KD-tree agree within 1e-6 m.
"""

import numpy as np
import pytest
import torch

from hortimapping_tpu.data.mesh import PointCloud as JPointCloud
from hortimapping_tpu.data.mesh import TriangleMesh as JTriangleMesh
from hortimapping_tpu.metrics import ChamferDistance as JChamfer
from hortimapping_tpu.metrics import Metrics3D as JMetrics3D
from hortimapping_tpu.metrics import PrecisionRecall as JPR
from hortimapping_tpu_torch.data.mesh import PointCloud, TriangleMesh
from hortimapping_tpu_torch.metrics import chamfer
from hortimapping_tpu_torch.metrics.chamfer import ChamferDistance
from hortimapping_tpu_torch.metrics.metric import MESH_SAMPLE_POINTS, Metrics3D
from hortimapping_tpu_torch.metrics.precision_recall import PrecisionRecall

CPU = torch.device("cpu")


def _fruit_pair(seed, n_gt=3000, n_pt=2500, offset=(0.3, -0.1, 0.6)):
    """A GT ellipsoid cloud and a noisy, slightly larger prediction, both
    away from the origin (world frame)."""
    rng = np.random.default_rng(seed)
    radii = np.array([0.04, 0.035, 0.05])

    def cloud(n, scale, noise):
        d = rng.normal(size=(n, 3))
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        return (d * radii * scale + rng.normal(size=(n, 3)) * noise + offset).astype(np.float32)

    return cloud(n_gt, 1.0, 0.0), cloud(n_pt, 1.05, 0.002)


def _uv_sphere(r=0.05, n_lat=24, n_lon=48, center=(0.0, 0.0, 0.5)):
    th = np.linspace(0, np.pi, n_lat + 1)
    ph = np.linspace(0, 2 * np.pi, n_lon, endpoint=False)
    T, P = np.meshgrid(th, ph, indexing="ij")
    v = np.stack([np.sin(T) * np.cos(P), np.sin(T) * np.sin(P), np.cos(T)], -1).reshape(-1, 3)
    faces = []
    for i in range(n_lat):
        for j in range(n_lon):
            a, b = i * n_lon + j, i * n_lon + (j + 1) % n_lon
            c, d = a + n_lon, b + n_lon
            faces += [[a, c, b], [b, c, d]]
    return (v * r + center).astype(np.float32), np.asarray(faces, np.int32)


def test_chamfer_matches_jax_on_clouds():
    cd, jcd = ChamferDistance(CPU), JChamfer()
    for seed in range(3):
        gt, pt = _fruit_pair(seed)
        cd.update(gt, pt)
        jcd.update(gt, pt)
        # the containers are accepted as well as arrays
        cd.update(PointCloud(gt), PointCloud(pt))
        jcd.update(JPointCloud(gt), JPointCloud(pt))
    np.testing.assert_allclose(cd.cd_array, jcd.cd_array, rtol=0, atol=1e-7)
    assert abs(cd.compute() - jcd.compute()) <= 1e-7
    assert 1e-3 < cd.compute() < 5e-3
    cd.reset()
    assert cd.cd_array == []


def test_precision_recall_matches_jax():
    pr, jpr = PrecisionRecall(0.001, 0.01, 100, device=CPU), JPR(0.001, 0.01, 100)
    n_min = None
    for seed in range(3):
        gt, pt = _fruit_pair(10 + seed)
        pr.update(gt, pt)
        jpr.update(gt, pt)
        n_min = min(len(gt), len(pt)) if n_min is None else min(n_min, len(gt), len(pt))
    tol = 100.0 / n_min
    for got, want in zip(pr.compute_at_all_thresholds(), jpr.compute_at_all_thresholds()):
        np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    for t in (0.001, 0.005, 0.0052, 0.01):
        got, want = pr.compute_at_threshold(t), jpr.compute_at_threshold(t)
        assert got[3] == want[3] == pr.find_nearest_threshold(t)
        np.testing.assert_allclose(got[:3], want[:3], rtol=0, atol=tol)
    np.testing.assert_allclose(pr.compute_auc(), jpr.compute_auc(), rtol=0, atol=tol)
    p5 = pr.compute_at_threshold(0.005)
    assert 0 < p5[2] < 100


def test_empty_prediction_scores_zero():
    gt, _ = _fruit_pair(3)
    cd, jcd = ChamferDistance(CPU), JChamfer()
    pr, jpr = PrecisionRecall(0.001, 0.01, 10, device=CPU), JPR(0.001, 0.01, 10)
    for empty in (np.zeros((0, 3), np.float32), PointCloud(np.zeros((0, 3), np.float32)),
                  TriangleMesh(np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32))):
        cd.update(gt, empty)
        pr.update(gt, empty)
        assert Metrics3D.prediction_is_empty(empty)
    jcd.update(gt, np.zeros((0, 3), np.float32))
    jpr.update(gt, np.zeros((0, 3), np.float32))
    assert cd.cd_array == [0, 0, 0] == jcd.cd_array * 3
    assert all(np.array_equal(x, np.zeros(10)) for x in pr.compute_at_all_thresholds())
    np.testing.assert_array_equal(pr.compute_at_all_thresholds()[2], jpr.compute_at_all_thresholds()[2])


def test_metrics3d_coerces_like_jax():
    v, f = _uv_sphere()
    got = Metrics3D.convert_to_points(TriangleMesh(v, f), n_sample=5000)
    want = JMetrics3D.convert_to_points(JTriangleMesh(v, f), n_sample=5000)
    np.testing.assert_array_equal(got, want)
    assert MESH_SAMPLE_POINTS == 1_000_000
    arr = np.arange(12, dtype=np.float32).reshape(3, 4)
    np.testing.assert_array_equal(Metrics3D.convert_to_points(arr),
                                  JMetrics3D.convert_to_points(arr))
    assert Metrics3D.convert_to_points(arr).dtype == np.float64
    with pytest.raises(TypeError):
        Metrics3D.convert_to_points(np.zeros((3, 2)))


def test_mesh_metrics_match_jax_through_the_kdtree():
    """A mesh prediction is sampled with 1 M points (the reference metric),
    ~3e9 pairs: both packages take the KD-tree."""
    v, f = _uv_sphere()
    rng = np.random.default_rng(8)
    d = rng.normal(size=(3000, 3))
    gt = (d / np.linalg.norm(d, axis=1, keepdims=True) * 0.051 + (0.0, 0.0, 0.5)).astype(np.float32)
    assert gt.shape[0] * MESH_SAMPLE_POINTS > chamfer.BRUTE_FORCE_MAX_PAIRS["cpu"]
    cd, jcd = ChamferDistance(CPU), JChamfer()
    cd.update(gt, TriangleMesh(v, f))
    jcd.update(gt, JTriangleMesh(v, f))
    assert abs(cd.cd_array[0] - jcd.cd_array[0]) <= 1e-7
    pr, jpr = PrecisionRecall(0.0005, 0.005, 10, device=CPU), JPR(0.0005, 0.005, 10)
    pr.update(gt, TriangleMesh(v, f))
    jpr.update(gt, JTriangleMesh(v, f))
    for got, want in zip(pr.compute_at_all_thresholds(), jpr.compute_at_all_thresholds()):
        np.testing.assert_allclose(got, want, rtol=0, atol=100.0 / gt.shape[0])


@pytest.mark.parametrize("n_a,n_b", [(5000, 3000), (17, 9000), (4097, 1)])
def test_brute_force_and_kdtree_agree(n_a, n_b):
    rng = np.random.default_rng(n_a + n_b)
    a = (rng.normal(size=(n_a, 3)) * 0.05 + 0.6).astype(np.float32)
    b = (rng.normal(size=(n_b, 3)) * 0.05 + 0.6).astype(np.float32)
    brute = chamfer.nn_distances(torch.as_tensor(a), torch.as_tensor(b)).numpy()
    tree = chamfer.nn_distances_kdtree(a, b)
    np.testing.assert_allclose(brute, tree, rtol=0, atol=1e-6)
    # a tile smaller than the query count, and the engine selection
    np.testing.assert_allclose(chamfer.nn_distances(torch.as_tensor(a), torch.as_tensor(b),
                                                    tile=7).numpy(), tree, rtol=0, atol=1e-6)
    np.testing.assert_allclose(chamfer.nn_distances_np(a, b, CPU), tree, rtol=0, atol=1e-6)


def test_engine_switches_above_the_pair_limit(monkeypatch):
    a = np.zeros((10, 3), np.float32)
    b = np.ones((10, 3), np.float32)
    calls = []
    monkeypatch.setattr(chamfer, "nn_distances_kdtree",
                        lambda x, y: calls.append("tree") or np.zeros(len(x), np.float32))
    chamfer.nn_distances_np(a, b, CPU)
    assert calls == []
    monkeypatch.setitem(chamfer.BRUTE_FORCE_MAX_PAIRS, "cpu", 99)
    chamfer.nn_distances_np(a, b, CPU)
    assert calls == ["tree"]
