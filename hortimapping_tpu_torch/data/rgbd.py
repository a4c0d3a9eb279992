"""RGB-D preprocessing: depth filtering and masked back-projection
(counterpart of `hortimapping_tpu/data/rgbd.py`), in numpy without OpenCV.

The challenge loader filters every depth map as `cv2.bilateralFilter(depth,
3, 15, 15)` followed by an erosion with an 11x11 rectangle (the JAX package
runs OpenCV for both). Here:
* `bilateral_filter` is OpenCV's filter at d=3 written out: at that diameter
  OpenCV keeps the window's pixels within radius 1, the centre and its four
  4-neighbours (the corners lie at sqrt(2)); the border is reflect-101;
  weights exp(-r^2 / (2 sigma_space^2)) * exp(-(v - c)^2 / (2 sigma_color^2)).
  OpenCV sums in float32 in its own order and takes the colour weight from
  an interpolated table, so the two agree to a few float32 ulps, not bit
  for bit; this version sums the exact weights in float64.
* `erode` is the rectangle's min filter (scipy's), exact: out-of-image
  pixels take no part, as OpenCV's default border for erosion (+inf) makes
  them.
* `backproject` keeps the JAX package's float64 arithmetic and its final
  float32 cast, so the same depth gives the same cloud bit for bit.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from hortimapping_tpu_torch.data.mesh import PointCloud

# the 4-neighbours of the d=3 window, in OpenCV's row-major order
_CROSS = ((-1, 0), (0, -1), (0, 1), (1, 0))


def bilateral_filter(depth: np.ndarray, d: int = 3, sigma_color: float = 15.0,
                     sigma_space: float = 15.0) -> np.ndarray:
    """`cv2.bilateralFilter(depth, 3, sigma_color, sigma_space)` on a
    float32 (H, W) map (module docstring)."""
    if d != 3:
        raise ValueError(f"bilateral_filter: only d=3 (the challenge loader's) is supported, got {d}")
    depth = np.ascontiguousarray(depth, np.float32)
    if depth.ndim != 2:
        raise ValueError(f"bilateral_filter: expected an (H, W) map, got shape {depth.shape}")
    if float(depth.max()) - float(depth.min()) < np.finfo(np.float32).eps:
        return depth.copy()   # a flat map passes through, as in OpenCV
    H, W = depth.shape
    pad = np.pad(depth, 1, mode="reflect").astype(np.float64)   # reflect-101
    c = depth.astype(np.float64)
    gc = -0.5 / (sigma_color * sigma_color)
    w_space = np.exp(-0.5 / (sigma_space * sigma_space))          # r = 1
    num = c.copy()                                                # the centre, weight 1
    den = np.ones_like(c)
    for dy, dx in _CROSS:
        v = pad[1 + dy:1 + dy + H, 1 + dx:1 + dx + W]
        w = w_space * np.exp((v - c) ** 2 * gc)
        num += w * v
        den += w
    return (num / den).astype(np.float32)


def erode(img: np.ndarray, erosion_size: int = 5) -> np.ndarray:
    """`cv2.erode` with a (2*size+1)^2 MORPH_RECT element: the min over the
    pixels of the window that lie in the image."""
    from scipy.ndimage import minimum_filter

    img = np.asarray(img)
    fill = np.inf if np.issubdtype(img.dtype, np.floating) else np.iinfo(img.dtype).max
    return minimum_filter(img, size=2 * erosion_size + 1, mode="constant", cval=fill)


def preprocess_depth(depth: np.ndarray, erosion_size: int = 5) -> np.ndarray:
    """Bilateral filter + rect erosion, the challenge loader's depth path."""
    return erode(bilateral_filter(depth), erosion_size)


def backproject(
    depth: np.ndarray,                  # (H, W) metric depth
    K: np.ndarray,                      # (3, 3)
    pose: Optional[np.ndarray] = None,  # (4, 4) camera-to-world
    rgb: Optional[np.ndarray] = None,   # (H, W, 3) uint8
    mask: Optional[np.ndarray] = None,  # (H, W) bool/uint8, pixels to keep
    depth_trunc: float = 1.0,
) -> PointCloud:
    """Masked RGB-D back-projection to a world-frame point cloud: pixels
    with depth <= 0, depth >= depth_trunc or outside the mask are dropped
    (Open3D `create_from_rgbd_image(depth * mask, depth_scale=1,
    depth_trunc)` and the extrinsic transform)."""
    dm = depth.astype(np.float64)
    if mask is not None:
        dm = dm * (np.asarray(mask) != 0)
    keep = (dm > 0.0) & (dm < depth_trunc)
    v, u = np.nonzero(keep)
    z = dm[v, u]
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    x = (u - cx) * z / fx
    y = (v - cy) * z / fy
    pts = np.stack([x, y, z], axis=-1)
    if pose is not None:
        pts = pts @ np.asarray(pose)[:3, :3].T + np.asarray(pose)[:3, 3]
    colors = None
    if rgb is not None:
        colors = rgb[v, u].astype(np.float64) / 255.0
    return PointCloud(pts.astype(np.float32), colors)
