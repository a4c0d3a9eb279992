"""Generate synthetic datasets for the pipelines (counterpart of
`hortimapping_tpu/tools/make_demo_data.py`):
the BUP20-style scene below; `make_challenge_dataset` (ECCV challenge
layout, `pipeline/challenge.py`), `make_lab_dataset` (IGG lab layout,
`pipeline/lab.py`) and `make_greenhouse_dataset` (CKA greenhouse layout,
`pipeline/greenhouse.py`), whose layouts their docstrings give (`main`
writes the greenhouse one with `--layout greenhouse`).

N fruits of the synthetic ellipsoid world (`tools/synthetic.py`) with known
codes and poses stand in front of a background wall and are observed by a
pinhole camera. Output layout (what `pipeline/wild.run_wild_completion`
reads):

    <out>/cam_info.yaml
    <out>/<frame>_submap_id.png      instance-id image (uint8)
    <out>/<frame>_depth.tiff         z-depth [m] (float32 tiff)
    <out>/<frame>_color.png          RGB (flat instance colours)
    <out>/<frame>_pose.txt           T_wc row-major
    <out>/submaps/00001_Background.ply
    <out>/submaps/<id>_Sweetpepper.ply   (partial observed-side mesh)
    <out>/gt_poses.npz, gt_codes.npz     ground truth for evaluation

Frames are ray-marched in float64 on a torch device, all fruits at once
(and, for the challenge, lab and greenhouse layouts, all frames of a fruit
or scene at once); `write_scene` writes any layout of fruits and camera
poses, `main` by default the JAX package's scene: the same arguments, draws
and files.

Run:  python -m hortimapping_tpu_torch.tools.make_demo_data --out data/synthetic_bup
      [--layout greenhouse --n_fruits 4 --n_frames 20 --width 640 --height 480]
"""

from __future__ import annotations

import argparse
import json
import os
from typing import List, Sequence, Tuple

import numpy as np
import torch

from hortimapping_tpu_torch import native
from hortimapping_tpu_torch.data import imageio
from hortimapping_tpu_torch.data.mesh import PointCloud, TriangleMesh
from hortimapping_tpu_torch.data.ply import write_mesh, write_point_cloud
from hortimapping_tpu_torch.device import resolve_device
from hortimapping_tpu_torch.models.decoder import DecoderSpec
from hortimapping_tpu_torch.models.workspace import load_specs
from hortimapping_tpu_torch.tools.synthetic import SyntheticCategory, _ellipsoid_sdf_np
from hortimapping_tpu_torch.vis import color_table

WALL_Z = 0.55
MARCH_ELEMS = 1 << 23   # fruit x ray pairs marched at once: bounds the [fruits, rays, 3] temporaries


def _ellipsoid_sdf(x: torch.Tensor, radii: torch.Tensor) -> torch.Tensor:
    """`_ellipsoid_sdf_np` for [K, N, 3] points under [K, 3] radii."""
    r = radii[:, None, :]
    k0 = torch.linalg.norm(x / r, dim=-1)
    k1 = torch.linalg.norm(x / (r * r), dim=-1)
    k1 = torch.where(k1 == 0.0, torch.ones_like(k1), k1)
    return torch.where(k0 == 0.0, -radii.min(dim=1).values[:, None], k0 * (k0 - 1.0) / k1)


class _Fruits:
    """The fruits of a scene on a device: world->object rotation and
    translation [K, 3, 3] / [K, 3], radii [K, 3], Sim(3) scale [K], f64."""

    def __init__(self, fruits: Sequence[Tuple[np.ndarray, np.ndarray]], device):
        T = np.array([T_ow for T_ow, _ in fruits], np.float64).reshape(-1, 4, 4)
        self.R = torch.as_tensor(T[:, :3, :3]).to(device)
        self.t = torch.as_tensor(T[:, :3, 3]).to(device)
        self.radii = torch.as_tensor(np.array([r for _, r in fruits], np.float64).reshape(-1, 3)
                                     ).to(device)
        self.s = torch.as_tensor(
            np.array([np.linalg.det(Ti[:3, :3]) ** (1.0 / 3.0) for Ti in T])).to(device)


def scene_sdf(x_w: torch.Tensor, fr: _Fruits, wall_z: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(distance, instance) of the union scene at [N, 3] world points:
    instance 0 = none, 1 = wall, k+2 = fruit k. Where fruits tie, the first
    wins, as the JAX package's sequential `closer = dk < d` loop."""
    d = wall_z - x_w[:, 2]                     # plane z = wall_z, normal -z
    inst = torch.ones(x_w.shape[0], dtype=torch.int64, device=x_w.device)
    if fr.R.shape[0] == 0:
        return d, inst
    x_o = x_w[None] @ fr.R.transpose(1, 2) + fr.t[:, None, :]
    dk = _ellipsoid_sdf(x_o, fr.radii) / fr.s[:, None]
    d_f, k = dk.min(dim=0)                     # first minimum, as torch documents
    closer = d_f < d
    return torch.where(closer, d_f, d), torch.where(closer, k + 2, inst)


def march_cameras(T_wcs: Sequence[np.ndarray], K: np.ndarray, pix: torch.Tensor,
                  fruits: Sequence[Tuple[np.ndarray, np.ndarray]], wall_z: float,
                  ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Ray-march the [N, 2] (u, v) pixels `pix` (float64, on the device the
    march runs on) seen from each camera T_wc for 96 steps, the rays of all
    cameras side by side in one march: per camera (z-depth [N] f64,
    instance [N] int64), 0 where a ray hits nothing. Rays are independent:
    any subset of a frame, alone or beside other cameras' rays, marches to
    the values of the whole frame's march."""
    dev = pix.device
    fr = _Fruits(fruits, dev)
    f64 = torch.float64
    invK = torch.as_tensor(np.linalg.inv(K)).to(dev)
    cams = [(torch.as_tensor(np.asarray(T, np.float64)[:3, :3]).to(dev),
             torch.as_tensor(np.asarray(T, np.float64)[:3, 3]).to(dev)) for T in T_wcs]
    n = pix.shape[0]
    chunk = max(1, MARCH_ELEMS // max(len(fruits), 1))
    pix_h = torch.cat([pix, torch.ones(n, 1, dtype=f64, device=dev)], dim=1)
    dirs_c = pix_h @ invK.T                                  # z=1-normalised
    unit = dirs_c / torch.linalg.norm(dirs_c, dim=-1, keepdim=True)
    dirs_w = torch.cat([unit @ R_wc.T for R_wc, _ in cams])
    origins = torch.cat([origin.expand(n, 3) for _, origin in cams])
    t = torch.full((dirs_w.shape[0],), 0.05, dtype=f64, device=dev)
    for lo in range(0, t.shape[0], chunk):
        o, dw, tc = origins[lo:lo + chunk], dirs_w[lo:lo + chunk], t[lo:lo + chunk]
        for _ in range(96):
            d, _ = scene_sdf(o + tc[:, None] * dw, fr, wall_z)
            tc = tc + torch.clamp(d, -0.05, 0.5)
        t[lo:lo + chunk] = tc
    out = []
    for c, (R_wc, origin) in enumerate(cams):
        depth = torch.empty(n, dtype=f64, device=dev)
        inst = torch.empty(n, dtype=torch.int64, device=dev)
        for lo in range(0, n, chunk):
            hi = min(lo + chunk, n)
            tc = t[c * n + lo:c * n + hi]
            x = origin + tc[:, None] * dirs_w[c * n + lo:c * n + hi]
            d, ins = scene_sdf(x, fr, wall_z)
            hit = (d.abs() < 1e-3) & (tc > 0) & (tc < 5.0)
            inst[lo:hi] = torch.where(hit, ins, 0)
            x_c = (x - origin) @ R_wc                        # world -> cam
            depth[lo:hi] = torch.where(hit, x_c[:, 2], 0.0)
        out.append((depth, inst))
    return out


def march_pixels(T_wc: np.ndarray, K: np.ndarray, pix: torch.Tensor,
                 fruits: Sequence[Tuple[np.ndarray, np.ndarray]], wall_z: float,
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`march_cameras` of one camera: (z-depth [N] f64, instance [N] int64)."""
    return march_cameras([T_wc], K, pix, fruits, wall_z)[0]


def render_frames(T_wcs: Sequence[np.ndarray], K: np.ndarray, W: int, H: int,
                  fruits: Sequence[Tuple[np.ndarray, np.ndarray]], wall_z: float,
                  device: str | torch.device = "cuda"):
    """Ray-march every pixel of each camera in float64 on `device`, all
    cameras in one march: per camera (depth z [m] (H, W) float32, instance
    id (H, W) uint8, rgb (H, W, 3) uint8), on the host."""
    dev = resolve_device(device)
    v, u = torch.meshgrid(torch.arange(H, dtype=torch.float64, device=dev),
                          torch.arange(W, dtype=torch.float64, device=dev), indexing="ij")
    out = []
    for depth, inst in march_cameras(T_wcs, K, torch.stack([u, v], dim=-1).reshape(-1, 2),
                                     fruits, wall_z):
        inst = inst.cpu().numpy()
        rgb = np.zeros((H * W, 3), np.uint8)
        rgb[inst == 1] = (90, 90, 90)
        for k in range(len(fruits)):
            rgb[inst == k + 2] = tuple(int(c * 255) for c in color_table[(k + 2) % 10])
        out.append((depth.cpu().numpy().reshape(H, W).astype(np.float32),
                    inst.reshape(H, W).astype(np.uint8), rgb.reshape(H, W, 3)))
    return out


def render_frame(T_wc: np.ndarray, K: np.ndarray, W: int, H: int,
                 fruits: Sequence[Tuple[np.ndarray, np.ndarray]], wall_z: float,
                 device: str | torch.device = "cuda"):
    """`render_frames` of one camera: (depth z [m] (H, W) float32, instance
    id (H, W) uint8, rgb (H, W, 3) uint8), on the host."""
    return render_frames([T_wc], K, W, H, fruits, wall_z, device)[0]


def partial_fruit_mesh(T_wo: np.ndarray, radii: np.ndarray,
                       keep_dir_w: np.ndarray, grid_n: int = 48) -> TriangleMesh:
    """Observed-side mesh: iso-surface of the ellipsoid, keeping triangles
    whose centroid faces `keep_dir_w` (simulates a partial submap)."""
    r = float(np.max(radii)) * 1.3
    g = np.linspace(-r, r, grid_n)
    X, Y, Z = np.meshgrid(g, g, g, indexing="ij")
    pts = np.stack([X, Y, Z], axis=-1)
    sdf = _ellipsoid_sdf_np(pts, radii).astype(np.float32)
    verts, faces = native.marching_tetrahedra(sdf, 0.0, spacing=float(g[1] - g[0]))
    verts = verts - r  # index space -> object frame
    T_wo33, t_wo = T_wo[:3, :3], T_wo[:3, 3]
    verts_w = verts @ T_wo33.T + t_wo
    centroids = verts_w[faces].mean(axis=1)
    keep = (centroids - t_wo) @ keep_dir_w > -0.1 * np.linalg.norm((centroids - t_wo), axis=1)
    return TriangleMesh(verts_w.astype(np.float32), faces[keep])


def wall_mesh(wall_z: float, half: float = 0.6, center=(0.0, 0.0)) -> TriangleMesh:
    cx, cy = center
    v = np.array([
        [cx - half, cy - half, wall_z], [cx + half, cy - half, wall_z],
        [cx + half, cy + half, wall_z], [cx - half, cy + half, wall_z],
    ], np.float32)
    f = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    return TriangleMesh(v, f)


def draw_fruits(rng: np.random.Generator, n_fruits: int, code_len: int,
                spacing: float = 0.12) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """Codes and object->world poses of a row of fruits along x, in the JAX
    generator's draw order: per fruit a code, a yaw, a height jitter."""
    T_wos, codes = [], []
    for k in range(n_fruits):
        code = (rng.normal(size=code_len) * 0.4).astype(np.float32)
        yaw = rng.uniform(-0.4, 0.4)
        c, s = np.cos(yaw), np.sin(yaw)
        T_wo = np.eye(4)
        T_wo[:3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        T_wo[:3, 3] = [spacing * (k - (n_fruits - 1) / 2), rng.uniform(-0.03, 0.03), 0.45]
        T_wos.append(T_wo)
        codes.append(code)
    return T_wos, codes


def look_at(cam_pos: np.ndarray, target: np.ndarray) -> np.ndarray:
    """Camera->world pose at `cam_pos` looking at `target`, image y along
    world +y."""
    zc = target - cam_pos
    zc = zc / np.linalg.norm(zc)
    xc = np.cross(np.array([0.0, 1.0, 0.0]), zc)
    xc /= np.linalg.norm(xc)
    yc = np.cross(zc, xc)
    T_wc = np.eye(4)
    T_wc[:3, 0], T_wc[:3, 1], T_wc[:3, 2], T_wc[:3, 3] = xc, yc, zc, cam_pos
    return T_wc


def sweep_poses(n_frames: int) -> List[np.ndarray]:
    """The JAX generator's camera sweep in front of the fruits."""
    poses = []
    for fi in range(n_frames):
        ang = 0.5 * np.sin(2 * np.pi * fi / n_frames)
        cam_pos = np.array([0.25 * np.sin(ang), 0.05 * np.cos(2 * ang), -0.02])
        poses.append(look_at(cam_pos, np.array([0.0, 0.0, 0.45])))
    return poses


def row_poses(n_frames: int, x_first: float, x_last: float, distance: float,
              fruit_z: float = 0.45) -> List[np.ndarray]:
    """A camera driving along a row of fruits (along x at height 0), facing
    it square from `distance`, as a robot records a crop row."""
    return [look_at(np.array([x, 0.0, fruit_z - distance]), np.array([x, 0.0, fruit_z]))
            for x in np.linspace(x_first, x_last, n_frames)]


def intrinsics(W: int, H: int) -> np.ndarray:
    return np.array([[0.9 * W, 0, W / 2], [0, 0.9 * W, H / 2], [0, 0, 1.0]])


def write_scene(out: str, T_wos: Sequence[np.ndarray], codes: Sequence[np.ndarray],
                proj: np.ndarray, base_radius: float, cam_poses: Sequence[np.ndarray],
                K: np.ndarray, W: int, H: int, wall_z: float = WALL_Z,
                wall_half: float = 0.6, device: str | torch.device = "cuda") -> int:
    """Render and write a scene in the layout of the module docstring (the
    wall centred at the origin); returns the bytes written."""
    import yaml

    os.makedirs(out, exist_ok=True)
    submap_dir = os.path.join(out, "submaps")
    os.makedirs(submap_dir, exist_ok=True)
    radii = [base_radius * np.exp(proj @ code) for code in codes]
    fruits = [(np.linalg.inv(T_wo), r) for T_wo, r in zip(T_wos, radii)]
    with open(os.path.join(out, "cam_info.yaml"), "w") as f:
        yaml.safe_dump({"intrinsics": K.tolist(), "extrinsics": np.eye(4).tolist(),
                        "img_size": [H, W]}, f)
    for fi, T_wc in enumerate(cam_poses):
        depth, inst, rgb = render_frame(T_wc, K, W, H, fruits, wall_z, device)
        stem = os.path.join(out, f"{fi:05d}")
        imageio.imwrite(stem + "_submap_id.png", inst)
        imageio.imwrite(stem + "_depth.tiff", depth)
        imageio.imwrite(stem + "_color.png", rgb[..., ::-1])   # BGR, as OpenCV writes
        with open(stem + "_pose.txt", "w") as f:
            f.write("\n".join(" ".join(str(x) for x in row) for row in T_wc))

    # submaps: wall + partial fruit meshes (observed from the -z side)
    write_mesh(os.path.join(submap_dir, "00001_Background.ply"),
               wall_mesh(wall_z, half=wall_half, center=(0.0, 0.0)))
    for k, (T_wo, r) in enumerate(zip(T_wos, radii)):
        mesh = partial_fruit_mesh(T_wo, r, keep_dir_w=np.array([0.0, 0.0, -1.0]))
        write_mesh(os.path.join(submap_dir, f"{k + 2:05d}_Sweetpepper.ply"), mesh)

    np.savez(os.path.join(out, "gt_poses.npz"), np.stack(T_wos))
    np.savez(os.path.join(out, "gt_codes.npz"), np.stack(codes))
    with open(os.path.join(out, "meta.json"), "w") as f:
        json.dump({"n_fruits": len(T_wos), "n_frames": len(cam_poses),
                   "wall_z": wall_z, "base_radius": base_radius}, f)
    return _tree_bytes(out)


def _unit_dirs(rng: np.random.Generator, n: int) -> np.ndarray:
    dirs = rng.normal(size=(n, 3))
    return dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)


def make_challenge_fruit(out_dir: str, cat: SyntheticCategory, proj: np.ndarray,
                         code: np.ndarray, n_frames: int = 5, W: int = 160, H: int = 120,
                         with_gt: bool = True, seed: int = 0,
                         device: str | torch.device = "cuda") -> int:
    """Write one fruit in the ECCV challenge directory layout:
    gt/pcd/fruit.ply, input/intrinsic.json (column-major K),
    input/{masks,poses,color}/<frame>.png|txt and input/depth/<frame>.npy.
    The fruit sits at the origin (the challenge solves with the pose known)
    and the masks are {0,1}-valued, as the real challenge's. Returns the
    bytes written."""
    device = resolve_device(device)
    radii = cat.base_radius * np.exp(proj @ code)
    fruits = [(np.eye(4), radii)]
    K = intrinsics(W, H)
    for sub in ["input/masks", "input/poses", "input/color", "input/depth"]:
        os.makedirs(os.path.join(out_dir, sub), exist_ok=True)
    with open(os.path.join(out_dir, "input", "intrinsic.json"), "w") as f:
        json.dump({"intrinsic_matrix": K.flatten(order="F").tolist()}, f)

    rng = np.random.default_rng(seed)
    poses = []
    for fi in range(n_frames):
        ang = 2 * np.pi * fi / n_frames
        cam_pos = np.array([0.3 * np.sin(ang), 0.1 * np.cos(2 * ang),
                            -0.3 * abs(np.cos(ang)) - 0.05])
        poses.append(look_at(cam_pos, np.zeros(3)))
    for fi, (T_wc, (depth, inst, rgb)) in enumerate(
            zip(poses, render_frames(poses, K, W, H, fruits, 0.5, device))):
        name = f"{fi:05d}"
        imageio.imwrite(os.path.join(out_dir, "input", "masks", name + ".png"),
                        (inst == 2).astype(np.uint8))
        np.savetxt(os.path.join(out_dir, "input", "poses", name + ".txt"), T_wc)
        imageio.imwrite(os.path.join(out_dir, "input", "color", name + ".png"), rgb[..., ::-1])
        np.save(os.path.join(out_dir, "input", "depth", name + ".npy"), depth.astype(np.float32))

    if with_gt:
        os.makedirs(os.path.join(out_dir, "gt", "pcd"), exist_ok=True)
        write_point_cloud(os.path.join(out_dir, "gt", "pcd", "fruit.ply"),
                          PointCloud((_unit_dirs(rng, 4000) * radii).astype(np.float32)))
    return _tree_bytes(out_dir)


def make_challenge_dataset(out: str, deepsdf_dir: str, split: str = "val", n_fruits: int = 2,
                           n_frames: int = 5, seed: int = 11, W: int = 160, H: int = 120,
                           device: str | torch.device = "cuda") -> int:
    """Challenge-layout dataset of synthetic fruits, the JAX generator's
    codes (one draw a fruit from `default_rng(seed)`) and GT draws (fruit k
    from `default_rng(seed + k)`). Returns the bytes written."""
    device = resolve_device(device)
    cat, _ = category(deepsdf_dir)
    proj = cat.projection()
    rng = np.random.default_rng(seed)
    for k in range(n_fruits):
        code = (rng.normal(size=cat.spec.code_length) * 0.4).astype(np.float32)
        make_challenge_fruit(os.path.join(out, split, f"fruit_{k:02d}"), cat, proj, code,
                             n_frames=n_frames, W=W, H=H, seed=seed + k, device=device)
    return _tree_bytes(os.path.join(out, split))


def make_lab_dataset(out: str, deepsdf_dir: str, n_fruits: int = 2, n_frames: int = 6,
                     W: int = 160, H: int = 120, seed: int = 5,
                     device: str | torch.device = "cuda") -> int:
    """IGG-lab layout dataset of synthetic fruits. Per fruit directory:
        realsense/{color,depth,masks}/<frame>.{png,npy,png}  (1-based frames,
                                   depth in mm, 255-valued masks)
        realsense/intrinsic.json   (column-major K, depth_scale, height, width)
        realsense/scene/integrated.ply  (the fused fruit surface, map frame)
        tf/tf_allposes.npz         (per-frame camera pose in the GT frame)
        tf/bounding_box.npz        (crop box, world frame)
        laser/fruit.ply            (GT cloud, fruit frame)
    plus a split.json listing every fruit under "test". The fruit sits at
    the origin of its GT frame, whose camera poses are the frames' T_wc;
    draws from `default_rng(seed)`: per fruit its code, then its GT
    directions, as the JAX generator. Returns the bytes written."""
    device = resolve_device(device)
    cat, _ = category(deepsdf_dir)
    proj = cat.projection()
    rng = np.random.default_rng(seed)
    depth_scale = 1000.0
    K = intrinsics(W, H)
    u, v = np.meshgrid(np.arange(W), np.arange(H))
    fruit_ids = []
    for k in range(n_fruits):
        fid = f"fruit_{k:02d}"
        fruit_ids.append(fid)
        base = os.path.join(out, fid)
        rgbd = os.path.join(base, "realsense")
        for sub in ["color", "depth", "masks", "scene"]:
            os.makedirs(os.path.join(rgbd, sub), exist_ok=True)
        os.makedirs(os.path.join(base, "tf"), exist_ok=True)
        os.makedirs(os.path.join(base, "laser"), exist_ok=True)

        code = (rng.normal(size=cat.spec.code_length) * 0.4).astype(np.float32)
        radii = cat.base_radius * np.exp(proj @ code)
        fruits = [(np.eye(4), radii)]
        with open(os.path.join(rgbd, "intrinsic.json"), "w") as f:
            json.dump({"intrinsic_matrix": K.flatten(order="F").tolist(),
                       "height": H, "width": W, "depth_scale": depth_scale}, f)

        tfs, all_pts = [], []
        for fi in range(n_frames):
            ang = 2 * np.pi * fi / n_frames
            cam_pos = np.array([0.3 * np.sin(ang), 0.08 * np.cos(ang),
                                -0.3 * abs(np.cos(ang)) - 0.08])
            tfs.append(look_at(cam_pos, np.zeros(3)))
        for fi, (T_gc, (depth, inst, rgb)) in enumerate(
                zip(tfs, render_frames(tfs, K, W, H, fruits, 0.6, device))):
            name = f"{fi + 1:05d}"
            imageio.imwrite(os.path.join(rgbd, "masks", name + ".png"),
                            ((inst == 2) * 255).astype(np.uint8))
            imageio.imwrite(os.path.join(rgbd, "color", name + ".png"), rgb[..., ::-1])
            np.save(os.path.join(rgbd, "depth", name + ".npy"),
                    (depth * depth_scale).astype(np.float32))
            hit = inst.reshape(-1) == 2
            if hit.any():
                z = depth.reshape(-1)[hit]
                uu, vv = u.reshape(-1)[hit], v.reshape(-1)[hit]
                x = (uu - K[0, 2]) * z / K[0, 0]
                y = (vv - K[1, 2]) * z / K[1, 1]
                p_c = np.stack([x, y, z], -1)
                all_pts.append(p_c @ T_gc[:3, :3].T + T_gc[:3, 3])

        np.savez(os.path.join(base, "tf", "tf_allposes.npz"), np.stack(tfs))
        # the map is stored in the frame of the first camera
        map_g = np.concatenate(all_pts)
        T_mw = np.linalg.inv(tfs[0])
        map_m = map_g @ T_mw[:3, :3].T + T_mw[:3, 3]
        write_point_cloud(os.path.join(rgbd, "scene", "integrated.ply"),
                          PointCloud(map_m.astype(np.float32)))
        r = float(np.max(radii)) * 1.4
        np.savez(os.path.join(base, "tf", "bounding_box.npz"),
                 np.array([[-r, -r, -r], [r, r, r]]))
        write_point_cloud(os.path.join(base, "laser", "fruit.ply"),
                          PointCloud((_unit_dirs(rng, 3000) * radii).astype(np.float32)))

    with open(os.path.join(out, "split.json"), "w") as f:
        json.dump({"train": [], "test": fruit_ids}, f)
    return _tree_bytes(out)


def make_greenhouse_dataset(out: str, deepsdf_dir: str, n_fruits: int = 2, n_frames: int = 6,
                            W: int = 160, H: int = 120, seed: int = 9,
                            device: str | torch.device = "cuda") -> int:
    """CKA-greenhouse layout dataset (`pipeline/greenhouse.py`):
        before/realsense/{color,depth,submap_ids}/<frame>.{png,npy,_submap_id.png}
        before/realsense/intrinsic.json   (column-major K, depth_scale, height, width)
        before/rostf_poses_no_jump.npz, rostf_poses_metashape_aligned.npz
        before/metashape/scaled_poses.npz
        before/submaps/00001_Background.ply, 000NN_Sweetpepper.ply
        fruits_measured/{info,info_usable}.json
        fruits_measured/<fruit>/tf/{tf_allposes,tf,bounding_box}.npz
        fruits_measured/<fruit>/laser/fruit_clean.ply

    One world frame w: fruit k sits at T_wg_k on a row along x, cameras
    sweep in w (the aligned poses are T_wc), and the metashape frame m is
    chosen so that T_wm = I (ros_tfs[0] = T_BC, metashape_poses[0] = I):
    multi-frame reads T_mg = T_wg. tfs_cam[i] = inv(T_wg) @ T_wc_i, so the
    single-frame evaluation's T_wg = inv(T_CW_SINGLE) @ inv(tfs_cam[i]) matches
    its back-projection of the frame through the fixed extrinsic. Fruit k
    is submap id k + 2. Draws from `default_rng(seed)` in the JAX
    generator's order: per fruit a code and a y offset, then per fruit its
    GT directions. Returns the bytes written."""
    from hortimapping_tpu_torch.pipeline.greenhouse import T_BC

    device = resolve_device(device)
    cat, _ = category(deepsdf_dir)
    proj = cat.projection()
    rng = np.random.default_rng(seed)
    depth_scale = 1000.0
    K = intrinsics(W, H)
    wall_z = 0.8

    base = os.path.join(out, "before")
    rgbd = os.path.join(base, "realsense")
    for sub in ["color", "depth", "submap_ids"]:
        os.makedirs(os.path.join(rgbd, sub), exist_ok=True)
    os.makedirs(os.path.join(base, "metashape"), exist_ok=True)
    submap_dir = os.path.join(base, "submaps")
    os.makedirs(submap_dir, exist_ok=True)
    gt_base = os.path.join(out, "fruits_measured")
    with open(os.path.join(rgbd, "intrinsic.json"), "w") as f:
        json.dump({"intrinsic_matrix": K.flatten(order="F").tolist(),
                   "height": H, "width": W, "depth_scale": depth_scale}, f)

    T_wgs, radii = [], []
    for k in range(n_fruits):
        code = (rng.normal(size=cat.spec.code_length) * 0.4).astype(np.float32)
        radii.append(cat.base_radius * np.exp(proj @ code))
        T_wg = np.eye(4)
        T_wg[:3, 3] = [0.15 * (k - (n_fruits - 1) / 2), rng.uniform(-0.03, 0.03), 0.6]
        T_wgs.append(T_wg)

    cam_tfs = []
    for fi in range(n_frames):
        t = fi / max(n_frames - 1, 1)
        cam_pos = np.array([-0.2 + 0.4 * t, 0.02 * np.sin(6 * t), 0.1])
        cam_tfs.append(look_at(cam_pos, np.array([cam_pos[0] * 0.5, 0.0, 0.6])))
    fruits = [(np.linalg.inv(T_wg), r) for T_wg, r in zip(T_wgs, radii)]
    for fi, (depth, inst, rgb) in enumerate(render_frames(cam_tfs, K, W, H, fruits, wall_z,
                                                          device)):
        name = f"{fi:05d}"
        imageio.imwrite(os.path.join(rgbd, "color", name + ".png"), rgb[..., ::-1])
        np.save(os.path.join(rgbd, "depth", name + ".npy"),
                (depth * depth_scale).astype(np.float32))
        # the wall (1) is no submap: id 0 there
        imageio.imwrite(os.path.join(rgbd, "submap_ids", name + "_submap_id.png"),
                        np.where(inst >= 2, inst, 0).astype(np.uint8))

    cam_tfs = np.stack(cam_tfs)
    np.savez(os.path.join(base, "rostf_poses_metashape_aligned.npz"), cam_tfs)
    np.savez(os.path.join(base, "rostf_poses_no_jump.npz"), np.tile(T_BC[None], (n_frames, 1, 1)))
    np.savez(os.path.join(base, "metashape", "scaled_poses.npz"),
             np.tile(np.eye(4)[None], (n_frames, 1, 1)))

    write_mesh(os.path.join(submap_dir, "00001_Background.ply"), wall_mesh(wall_z, half=0.8))
    info = {}
    for k, (T_wg, r) in enumerate(zip(T_wgs, radii)):
        sid = k + 2
        write_mesh(os.path.join(submap_dir, f"{sid:05d}_Sweetpepper.ply"),
                   partial_fruit_mesh(T_wg, r, keep_dir_w=np.array([0.0, 0.0, -1.0])))
        fid = f"fruit_{k:02d}"
        fdir = os.path.join(gt_base, fid)
        os.makedirs(os.path.join(fdir, "tf"), exist_ok=True)
        os.makedirs(os.path.join(fdir, "laser"), exist_ok=True)
        info[fid] = {"submap_id": sid, "begin_frame": 0, "end_frame": n_frames}
        np.savez(os.path.join(fdir, "tf", "tf_allposes.npz"),
                 np.stack([np.linalg.inv(T_wg) @ cam_tfs[i] for i in range(n_frames)]))
        np.savez(os.path.join(fdir, "tf", "tf.npz"), T_wg)
        b = float(np.max(r)) * 1.4
        np.savez(os.path.join(fdir, "tf", "bounding_box.npz"), np.array([[-b, -b, -b], [b, b, b]]))
        write_point_cloud(os.path.join(fdir, "laser", "fruit_clean.ply"),
                          PointCloud((_unit_dirs(rng, 3000) * r).astype(np.float32)))
    for fn in ("info.json", "info_usable.json"):
        with open(os.path.join(gt_base, fn), "w") as f:
            json.dump(info, f)
    return _tree_bytes(out)


def _tree_bytes(root: str) -> int:
    return sum(os.path.getsize(os.path.join(dp, fn)) for dp, _, fns in os.walk(root) for fn in fns)


def category(deepsdf_dir: str) -> Tuple[SyntheticCategory, float]:
    """The synthetic category of a decoder directory and its base radius."""
    specs = load_specs(deepsdf_dir)
    base_radius = float(specs.get("synthetic", {}).get("base_radius", 0.06))
    cat = SyntheticCategory(spec=DecoderSpec(code_length=int(specs["CodeLength"])),
                            base_radius=base_radius)
    return cat, base_radius


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="data/synthetic_bup")
    ap.add_argument("--deepsdf_dir", default="assets/synthetic_pepper_32")
    ap.add_argument("--n_fruits", type=int, default=3)
    ap.add_argument("--n_frames", type=int, default=12)
    ap.add_argument("--width", type=int, default=256)
    ap.add_argument("--height", type=int, default=192)
    ap.add_argument("--seed", type=int, default=None,
                    help="default 7 (bup), 9 (greenhouse)")
    ap.add_argument("--layout", choices=("bup", "greenhouse"), default="bup",
                    help="bup: the wild pipeline's scene (default); greenhouse: one CKA data dir")
    ap.add_argument("--device", default="cuda", help="device of the ray march (cuda or cpu)")
    args = ap.parse_args(argv)

    W, H = args.width, args.height
    if args.layout == "greenhouse":
        make_greenhouse_dataset(args.out, args.deepsdf_dir, args.n_fruits, args.n_frames, W, H,
                                seed=9 if args.seed is None else args.seed, device=args.device)
        print(f"wrote synthetic greenhouse dataset to {args.out}")
        return
    cat, base_radius = category(args.deepsdf_dir)
    rng = np.random.default_rng(7 if args.seed is None else args.seed)
    T_wos, codes = draw_fruits(rng, args.n_fruits, cat.spec.code_length)
    write_scene(args.out, T_wos, codes, cat.projection(), base_radius,
                sweep_poses(args.n_frames), intrinsics(W, H), W, H, device=args.device)
    print(f"wrote synthetic BUP-style dataset to {args.out}")


if __name__ == "__main__":
    main()
