"""The port's RGB-D layer (`hortimapping_tpu_torch/data/rgbd.py`) against
OpenCV and the JAX package on the CPU.

Tolerances. `bilateral_filter` vs `cv2.bilateralFilter(d, 3, 15, 15)`:
within 4 float32 ulps of OpenCV's value at every pixel (OpenCV sums in
float32 from an interpolated weight table in its own order; the port sums
the exact weights in float64; measured worst 3 ulps). `erode` is exact
(bit-equal to `cv2.erode`), and `preprocess_depth` is held within the
filter's 4 ulps (the erosion only picks values). `backproject` is bit-equal
to the JAX package's: the same float64 arithmetic and float32 cast.
"""

import cv2
import numpy as np
import pytest

from hortimapping_tpu.data import rgbd as jrgbd
from hortimapping_tpu_torch.data import rgbd

ULPS = 4


def _depth_map(seed, H, W, zero_frac=0.2, lo=0.2, hi=1.0):
    rng = np.random.default_rng(seed)
    d = (rng.random((H, W)) * (hi - lo) + lo).astype(np.float32)
    d[rng.random(d.shape) < zero_frac] = 0.0
    return d


def _within_ulps(got, want):
    return np.all(np.abs(got - want) <= ULPS * np.spacing(np.abs(want)))


@pytest.mark.parametrize("shape,seed", [((120, 160), 0), ((7, 5), 1), ((1, 9), 2), ((48, 64), 3)])
def test_bilateral_filter_matches_opencv(shape, seed):
    d = _depth_map(seed, *shape)
    want = cv2.bilateralFilter(d, 3, 15, 15)
    got = rgbd.bilateral_filter(d)
    assert got.dtype == np.float32 and got.shape == d.shape
    assert _within_ulps(got, want), np.abs(got - want).max()
    # the borders (reflect-101) and the pixels next to zeros are in the map;
    # a flat map passes through
    flat = np.full(shape, 0.5, np.float32)
    np.testing.assert_array_equal(rgbd.bilateral_filter(flat), cv2.bilateralFilter(flat, 3, 15, 15))


def test_bilateral_filter_on_a_smooth_surface_with_holes():
    """A tilted plane (what a camera sees of a wall) with a block of zeros
    at the border and isolated holes."""
    v, u = np.mgrid[0:60, 0:80]
    d = (0.4 + 0.002 * u + 0.001 * v).astype(np.float32)
    d[:6, :10] = 0.0
    d[30, 40] = d[11, 79] = 0.0
    want = cv2.bilateralFilter(d, 3, 15, 15)
    assert _within_ulps(rgbd.bilateral_filter(d), want)


@pytest.mark.parametrize("size", [5, 1, 2])
def test_erode_matches_opencv(size):
    d = _depth_map(4, 50, 70)
    k = 2 * size + 1
    el = cv2.getStructuringElement(cv2.MORPH_RECT, (k, k), (size, size))
    np.testing.assert_array_equal(rgbd.erode(d, size), cv2.erode(d, el))
    m = (d > 0.5).astype(np.uint8)
    np.testing.assert_array_equal(rgbd.erode(m, size), cv2.erode(m, el))


def test_preprocess_depth_matches_opencv_and_jax():
    d = _depth_map(5, 96, 128)
    el = cv2.getStructuringElement(cv2.MORPH_RECT, (11, 11), (5, 5))
    want = cv2.erode(cv2.bilateralFilter(d, 3, 15, 15), el)
    got = rgbd.preprocess_depth(d)
    assert _within_ulps(got, want)
    assert _within_ulps(got, jrgbd.preprocess_depth(d))
    # the erosion itself is exact: on OpenCV's filtered map it is bit-equal
    np.testing.assert_array_equal(rgbd.erode(cv2.bilateralFilter(d, 3, 15, 15)), want)


@pytest.mark.parametrize("use_mask,use_pose,use_rgb", [
    (False, False, False), (True, False, False), (True, True, True), (False, True, True)])
def test_backproject_bit_equal_to_jax(use_mask, use_pose, use_rgb):
    rng = np.random.default_rng(6)
    H, W = 40, 56
    d = _depth_map(7, H, W, lo=0.1, hi=1.3)   # some pixels beyond depth_trunc
    K = np.array([[50.4, 0, 28.0], [0, 50.4, 20.0], [0, 0, 1.0]])
    mask = (rng.random((H, W)) < 0.6).astype(np.uint8) if use_mask else None
    pose = None
    if use_pose:
        pose = np.eye(4)
        pose[:3, :3] = np.linalg.qr(rng.normal(size=(3, 3)))[0]
        pose[:3, 3] = rng.normal(size=3)
    rgb = rng.integers(0, 256, (H, W, 3), dtype=np.uint8) if use_rgb else None
    got = rgbd.backproject(d, K, pose=pose, rgb=rgb, mask=mask, depth_trunc=1.0)
    want = jrgbd.backproject(d, K, pose=pose, rgb=rgb, mask=mask, depth_trunc=1.0)
    assert len(got) > 100
    assert got.points.dtype == np.float32
    np.testing.assert_array_equal(got.points, want.points)
    if use_rgb:
        np.testing.assert_array_equal(got.colors, want.colors)
    else:
        assert got.colors is None and want.colors is None


def test_bilateral_filter_refuses_another_diameter():
    with pytest.raises(ValueError, match="d=3"):
        rgbd.bilateral_filter(np.zeros((4, 4), np.float32), d=5)
