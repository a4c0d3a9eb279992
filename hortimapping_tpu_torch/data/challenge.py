"""ECCV shape-completion challenge dataset loader (counterpart of
`hortimapping_tpu/data/challenge.py`).

Directory layout per fruit:
    <data_source>/<split>/<fruit_id>/
        gt/pcd/fruit.ply                 laser-scanned GT (absent on 'test')
        input/intrinsic.json             column-major 3x3 K
        input/masks/<frame>.png          instance masks, 8-bit 1-channel
        input/poses/<frame>.txt          camera-to-world 4x4
        input/color/<frame>.png          colour, 8-bit 3-channel
        input/depth/<frame>.npy          metric depth

Images are read through `data/imageio.py` (colour comes in BGR, as OpenCV
reads it, and is flipped to RGB); every depth map goes through
`rgbd.preprocess_depth`, and the fused cloud of an item is the sum of the
frames' masked back-projections.
"""

from __future__ import annotations

import json
import os
from typing import Dict

import numpy as np

from hortimapping_tpu_torch.data import imageio
from hortimapping_tpu_torch.data.mesh import PointCloud
from hortimapping_tpu_torch.data.ply import read_ply
from hortimapping_tpu_torch.data.rgbd import backproject, preprocess_depth


def load_K(path: str) -> np.ndarray:
    """intrinsic.json stores the matrix column-major."""
    with open(path) as f:
        data = json.load(f)["intrinsic_matrix"]
    return np.reshape(data, (3, 3), order="F")


def read_mask(path: str) -> np.ndarray:
    """An 8-bit 1-channel mask PNG as (H, W) uint8: what
    `cv2.imread(path, cv2.IMREAD_GRAYSCALE)` returns for such a file.
    Anything else raises: a colour mask would need OpenCV's grey conversion."""
    img = imageio.imread(path)
    if img.ndim != 2 or img.dtype != np.uint8:
        raise ValueError(f"{path}: a mask must be an 8-bit 1-channel PNG, got shape "
                         f"{img.shape} {img.dtype}")
    return img


def read_rgb(path: str) -> np.ndarray:
    """An 8-bit 3-channel PNG as (H, W, 3) uint8 RGB."""
    img = imageio.imread(path)
    if img.ndim != 3 or img.shape[2] != 3 or img.dtype != np.uint8:
        raise ValueError(f"{path}: a colour image must be an 8-bit 3-channel PNG, got shape "
                         f"{img.shape} {img.dtype}")
    return np.ascontiguousarray(img[..., ::-1])


class ShapeCompletionDataset:
    def __init__(
        self,
        data_source: str,
        split: str = "train",
        return_pcd: bool = True,
        return_rgbd: bool = True,
    ):
        assert return_pcd or return_rgbd, "enable at least one of return_pcd/return_rgbd"
        self.data_source = data_source
        self.split = split
        self.return_pcd = return_pcd
        self.return_rgbd = return_rgbd
        self.fruit_list = self._get_file_paths()

    def _get_file_paths(self) -> Dict[str, Dict[str, str]]:
        root = os.path.join(self.data_source, self.split)
        return {fid: {"path": os.path.join(root, fid)} for fid in sorted(os.listdir(root))}

    def get_gt(self, fid: str) -> PointCloud:
        verts, _, colors = read_ply(
            os.path.join(self.fruit_list[fid]["path"], "gt", "pcd", "fruit.ply"))
        return PointCloud(verts, colors)

    def get_rgbd(self, fid: str) -> Dict:
        fid_root = self.fruit_list[fid]["path"]
        intrinsic = load_K(os.path.join(fid_root, "input", "intrinsic.json"))
        rgbd_data: Dict = {
            "intrinsic": intrinsic,
            "pcd": PointCloud(np.zeros((0, 3), np.float32), np.zeros((0, 3))),
            "frames": {},
        }
        for frameid in sorted(os.listdir(os.path.join(fid_root, "input", "masks"))):
            pose = np.loadtxt(os.path.join(fid_root, "input", "poses", frameid.replace("png", "txt")))
            rgb = read_rgb(os.path.join(fid_root, "input", "color", frameid))
            depth = np.load(os.path.join(fid_root, "input", "depth", frameid.replace("png", "npy")))
            depth = preprocess_depth(depth)
            mask = read_mask(os.path.join(fid_root, "input", "masks", frameid))
            frame_key = frameid.replace(".png", "")
            rgbd_data["frames"][frame_key] = {
                "rgb": rgb, "depth": depth, "mask": mask, "pose": pose, "fname": frame_key,
            }
            if self.return_pcd:
                rgbd_data["pcd"] = rgbd_data["pcd"] + backproject(
                    depth, intrinsic, pose=pose, rgb=rgb, mask=mask, depth_trunc=1.0)
        return rgbd_data

    def __len__(self) -> int:
        return len(self.fruit_list)

    def __getitem__(self, idx: int) -> Dict:
        fid = list(self.fruit_list.keys())[idx]
        item: Dict = {"fid": fid}
        if self.split != "test":
            item["groundtruth_pcd"] = self.get_gt(fid)
        input_data = self.get_rgbd(fid)
        if self.return_pcd:
            item["rgbd_pcd"] = input_data["pcd"]
        if self.return_rgbd:
            item["rgbd_intrinsic"] = input_data["intrinsic"]
            item["rgbd_frames"] = input_data["frames"]
        return item
