"""BUP20 wild sweet-pepper completion pipeline (counterpart of
`hortimapping_tpu/pipeline/wild.py`).

Reads posed frames (`<frame>_submap_id.png`, `_depth.tiff`, `_pose.txt`) and
submap meshes (`submaps/*.ply`) and, per fruit submap: cleans the submap
into a surface cloud, initialises the pose from its AABB and the nearby
background, samples foreground and background rays per frame, solves latent
code and Sim(3) pose, gates outliers and writes `submaps_complete/<name>.ply`,
`submaps_clean/<name>.ply`, `submaps_pose/<name>.npy` (= T_wo) and a resume
manifest.

Three phases, in the JAX package's order and semantics:
1. host preprocessing of every submap (`prepare_submaps`) into fixed-shape
   observation buffers;
2. one batched `warmstart_solve` of all prepared fruits on the device or,
   with an interactive visualizer (`vis.interactive`), `solve_interactive`:
   each fruit solved alone with every LM iteration's mesh replayed in the
   window; or, over a fruit mesh of more than one shard (`mesh=`, or every
   card when more than one is visible), the single-start retrieval warm
   start and `shard_joint_opt`, with no rescue and no multi-start, as the
   JAX package's multi-device branch;
3. outlier gates, one batched grid decode and host meshing, the outputs.

Run:  python -m hortimapping_tpu_torch.pipeline.wild -c configs/wild_pepper_tpu.yaml
"""

from __future__ import annotations

import argparse
import json
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from hortimapping_tpu_torch.config import JointOptConfig, load_config
from hortimapping_tpu_torch.data import imageio
from hortimapping_tpu_torch.data.mesh import PointCloud
from hortimapping_tpu_torch.data.ply import read_mesh, write_mesh, write_point_cloud
from hortimapping_tpu_torch.data.preprocess import build_T_wo, clean_mesh, get_pose_init
from hortimapping_tpu_torch.data.rays import get_render_data, render_data_to_observations
from hortimapping_tpu_torch.device import resolve_device
from hortimapping_tpu_torch.models.workspace import config_decoder, load_latent_vectors
from hortimapping_tpu_torch.ops.mesher import MeshExtractor
from hortimapping_tpu_torch.optim.lm import shape_pose_joint_opt_traced
from hortimapping_tpu_torch.optim.state import OptResult, stack_observations
from hortimapping_tpu_torch.optim.warmstart import maybe_retrieval_init, warmstart_solve
from hortimapping_tpu_torch.parallel.sharding import FruitMesh, fruit_mesh, shard_joint_opt
from hortimapping_tpu_torch.utils.misc import set_random_seed, trace_if_enabled
from hortimapping_tpu_torch.vis import color_table, make_visualizer


@dataclass
class FruitResult:
    name: str
    submap_id: int
    T_wo: np.ndarray
    latent: np.ndarray
    iter_count: int
    valid: bool
    reason: str = ""


@dataclass
class Prepared:
    """One fruit that phase 1 accepted."""

    name: str
    submap_id: int
    obs: object          # FruitObservations with numpy fields
    T_ow0: np.ndarray
    clean_pcd: PointCloud
    color: np.ndarray
    n_matched: int       # frames that matched the submap (before the n_frame pick)


def load_frames(data_base: str, begin_frame: int, end_frame: int,
                every_frame: int) -> Tuple[Dict, Dict, Dict]:
    """(instance-id images, depth images (f64), T_wc poses), keyed by frame
    id, of the `<frame>_submap_id.png` / `_depth.tiff` / `_pose.txt` triples
    in the frame window (rgb is visualisation-only and not read)."""
    submap_id_imgs, depth_imgs, cam_poses = {}, {}, {}
    frame_count = 0
    for fname in sorted(os.listdir(data_base)):
        if "id" not in fname:
            continue
        if frame_count < begin_frame or frame_count > end_frame or frame_count % every_frame != 0:
            frame_count += 1
            continue
        path = os.path.join(data_base, fname)
        pose_path = path.replace("submap_id.png", "pose.txt")
        if not os.path.isfile(pose_path):
            continue
        with open(pose_path) as f:
            T_wc = np.asarray([float(x) for x in f.read().split()], np.float64).reshape(4, 4)
        frame_id = fname.split("_")[0]
        submap_id_imgs[frame_id] = imageio.imread(path)
        depth_imgs[frame_id] = np.asarray(
            imageio.imread(path.replace("submap_id.png", "depth.tiff")), float)
        cam_poses[frame_id] = T_wc
        frame_count += 1
    return submap_id_imgs, depth_imgs, cam_poses


def pose_outlier_reason(T_wo: np.ndarray, opt_cfg: JointOptConfig) -> str:
    """Final scale / pitch / roll gates; '' when the pose is acceptable."""
    from scipy.spatial.transform import Rotation

    final_scale = np.linalg.det(T_wo[:3, :3]) ** (1.0 / 3.0)
    if not (opt_cfg.outlier_scale_min <= final_scale <= opt_cfg.outlier_scale_max):
        return f"scale {final_scale:.3f} outlier"
    euler = Rotation.from_matrix(T_wo[:3, :3] / final_scale).as_euler("zyx", degrees=True)
    _, pitch, roll = euler[0], euler[1], euler[2]
    if abs(pitch) > opt_cfg.outlier_rot_max_deg:
        return f"pitch {pitch:.1f} deg outlier"
    if abs(roll) > opt_cfg.outlier_rot_max_deg:
        return f"roll {roll:.1f} deg outlier"
    return ""


def prepare_submaps(cfg: Dict, opt_cfg: JointOptConfig, frames: Tuple[Dict, Dict, Dict],
                    img_size, invK: np.ndarray, init_latent: np.ndarray,
                    done_names) -> Tuple[List[Prepared], List[FruitResult]]:
    """Phase 1 on the host: every submap not yet done becomes observation
    buffers and a pose init, or a rejected result ("no valid match",
    "bbox gate")."""
    submap_id_imgs, depth_imgs, cam_poses = frames
    submap_folder = os.path.join(cfg["data_dir"], "submaps")
    object_radius_max_m = float(cfg["vis"]["object_radius_max_m"])
    bg_pcd: Optional[PointCloud] = None
    prepared: List[Prepared] = []
    results: List[FruitResult] = []
    for submap_name in sorted(os.listdir(submap_folder)):
        submap_cat = submap_name.split("_")[1].split(".")[0]
        submap_id = int(submap_name.split("_")[0])
        if submap_cat != "Background" and submap_name in done_names:
            continue
        if submap_id > 1 and submap_id < cfg["begin_submap"]:
            continue
        mesh = read_mesh(os.path.join(submap_folder, submap_name))
        if submap_cat == "Background":
            bg_pcd = mesh.sample_points_uniformly(500000).voxel_down_sample(0.005)
            continue

        render_data = get_render_data(
            submap_id, submap_id_imgs, depth_imgs, cam_poses, img_size, invK,
            n_fg_pix=opt_cfg.n_fg_pix, n_bg_pix=opt_cfg.n_bg_pix, n_bg_pad=opt_cfg.n_bg_pad,
        )
        if render_data["count"] == 0:
            results.append(FruitResult(submap_name, submap_id, np.eye(4), init_latent, 0, False,
                                       "no valid match"))
            continue

        cur_pcd_world = clean_mesh(mesh, opt_cfg.recon_n_pts, opt_cfg.recon_cluster_dist_m)
        center, yaw, bbx_size, valid_flag = get_pose_init(cur_pcd_world, bg_pcd)
        if not valid_flag:
            results.append(FruitResult(submap_name, submap_id, np.eye(4), init_latent, 0, False,
                                       "bbox gate"))
            continue

        object_radius_m = object_radius_max_m * 0.8
        scale_init = (max(bbx_size / (2 * object_radius_m), 0.5)
                      if opt_cfg.pose_init_scale_on else 1.0)
        T_wo0 = build_T_wo(center, yaw, scale_init, rot_on=opt_cfg.pose_init_rot_on)
        obs = render_data_to_observations(
            render_data, cur_pcd_world.points, opt_cfg.n_frame,
            opt_cfg.n_fg_pix, opt_cfg.n_bg_pix, opt_cfg.recon_n_pts,
        )
        mean_color = (np.mean(cur_pcd_world.colors, axis=0)
                      if cur_pcd_world.colors is not None else color_table[submap_id % 10])
        prepared.append(Prepared(submap_name, submap_id, obs, np.linalg.inv(T_wo0),
                                 cur_pcd_world, mean_color, render_data["count"]))
    return prepared, results


def write_outputs(out_dirs: Dict[str, str], name: str, mesh, clean_pcd: PointCloud,
                  T_wo: np.ndarray) -> None:
    """The completed mesh, the cleaned cloud and the pose of one fruit."""
    write_mesh(os.path.join(out_dirs["complete"], name), mesh)
    write_point_cloud(os.path.join(out_dirs["clean"], name), clean_pcd)
    np.save(os.path.join(out_dirs["pose"], name.replace("ply", "npy")), T_wo)


def solve_interactive(params, spec, opt_cfg: JointOptConfig, latent_table: torch.Tensor,
                      obs_b, lat0: torch.Tensor, T0: torch.Tensor, prepared: List[Prepared],
                      mesher: MeshExtractor, vis, cube_radius: float,
                      dev: torch.device) -> OptResult:
    """The interactive branch of phase 2: the batch's start codes and poses
    (the retrieval warm start where configured), then each fruit in turn:
    its scan shown, the visualizer's verdict (SPACE solves, N skips: the
    fruit keeps its start, 0 iterations, failed), the traced single-fruit
    solve, and its trajectory replayed (each iteration's code meshed and
    posed, then shown). The trajectory's poses cross to the host in one copy
    a fruit; the solve itself never waits for the host. Returns the stacked
    per-fruit results."""
    lat0, T0 = maybe_retrieval_init(params, spec, opt_cfg, latent_table, obs_b, lat0, T0,
                                    device=dev)
    outs = []
    for i, p in enumerate(prepared):
        vis.clean_vis()
        vis.add_scan(p.clean_pcd)
        if vis.stop():   # the user skipped this fruit
            outs.append(OptResult(lat0[i], T0[i], torch.zeros((), dtype=torch.int32, device=dev),
                                  torch.ones((), dtype=torch.bool, device=dev),
                                  torch.zeros((), dtype=torch.bool, device=dev)))
            continue
        res_i, (lat_traj, T_traj) = shape_pose_joint_opt_traced(
            params, spec, opt_cfg, p.obs, lat0[i], T0[i], cube_radius, device=dev)
        T_traj = T_traj.cpu().numpy()
        for it in range(int(res_i.iter_count)):
            mesh_it = mesher.complete_mesh(lat_traj[it], np.linalg.inv(T_traj[it]), p.color)
            vis.update_mesh_pose(mesh_it, np.eye(4), it)
        vis.stop()
        outs.append(res_i)
    return OptResult(*(torch.stack(field) for field in zip(*outs)))


def run_wild_completion(cfg: Dict, log=print, device: str | torch.device = "cuda",
                        mesh: Optional[FruitMesh] = None) -> List[FruitResult]:
    """The pipeline on `device` (results gathered there); phase 2 shards the
    batch over `mesh` where it has more than one shard (default: every card
    when more than one is visible)."""
    dev = resolve_device(device)
    set_random_seed(42)
    opt_cfg = JointOptConfig.from_dict(cfg)
    vis_cfg = cfg.get("vis", {})
    log_on = vis_cfg.get("log_on", False)
    vis = make_visualizer(vis_cfg.get("vis_on", False),
                          pause_time_s=vis_cfg.get("vis_pause_s", 1e-2))

    params, spec = config_decoder(cfg["deepsdf_dir"], "latest", device=dev)
    latents_train = load_latent_vectors(cfg["deepsdf_dir"], "latest", device=dev)
    init_latent = latents_train.mean(0).cpu().numpy()

    submap_folder = os.path.join(cfg["data_dir"], "submaps")
    out_dirs = {"complete": submap_folder + "_complete", "clean": submap_folder + "_clean",
                "pose": submap_folder + "_pose"}
    for d in out_dirs.values():
        os.makedirs(d, exist_ok=True)

    object_radius_max_m = float(cfg["vis"]["object_radius_max_m"])
    voxels_dim = int(2 * object_radius_max_m * 1e3 / float(cfg["vis"]["mc_res_mm"]))

    cam_param = load_config(cfg["cam_info_path"])
    invK = np.linalg.inv(np.asarray(cam_param["intrinsics"]))
    img_size = cam_param["img_size"]

    frames = load_frames(cfg["data_dir"], cfg["begin_frame"], cfg["end_frame"], cfg["every_frame"])
    if log_on:
        log(f"loaded {len(frames[0])} frames")

    # resume: a manifest of completed submaps lets a killed run pick up
    # where it left off
    manifest_path = os.path.join(out_dirs["complete"], "manifest.json")
    done_names = set()
    if cfg.get("resume", False) and os.path.isfile(manifest_path):
        with open(manifest_path) as f:
            done_names = {r["name"] for r in json.load(f) if r["valid"]}
        if log_on:
            log(f"resume: skipping {len(done_names)} completed submaps")

    # ---------------- phase 1: host preprocessing, all submaps ----------------
    prepared, results = prepare_submaps(cfg, opt_cfg, frames, img_size, invK, init_latent,
                                        done_names)
    if not prepared:
        log("no valid submaps")
        return results

    # ---------------- phase 2: one batched solve ----------------
    obs_b = stack_observations([p.obs for p in prepared], dev)
    lat0 = torch.as_tensor(init_latent).to(dev)[None, :].repeat(len(prepared), 1)
    T0 = torch.as_tensor(np.stack([p.T_ow0 for p in prepared]).astype(np.float32)).to(dev)
    mesher = MeshExtractor(params, spec, voxels_dim, object_radius_max_m,
                           method=vis_cfg.get("iso_method", "mt"), device=dev)
    n_dev = (mesh.size if mesh is not None
             else torch.cuda.device_count() if dev.type == "cuda" else 1)
    with trace_if_enabled("wild_joint_opt"):
        if getattr(vis, "interactive", False):
            res = solve_interactive(params, spec, opt_cfg, latents_train, obs_b, lat0, T0,
                                    prepared, mesher, vis, object_radius_max_m, dev)
        elif n_dev > 1:
            lat0, T0 = maybe_retrieval_init(params, spec, opt_cfg, latents_train, obs_b, lat0, T0,
                                            device=dev)
            res = shard_joint_opt(params, spec, opt_cfg, obs_b, lat0, T0, object_radius_max_m,
                                  mesh or fruit_mesh(), device=dev)
        else:
            res = warmstart_solve(params, spec, opt_cfg, latents_train, obs_b, lat0, T0,
                                  object_radius_max_m, device=dev)

    # ---------------- phase 3: gates, batched meshing, outputs ----------------
    latents = res.latent.cpu().numpy()
    T_ows = res.T_ow.cpu().numpy()
    iters = res.iter_count.cpu().numpy()
    failed = res.failed.cpu().numpy()

    keep_idx, keep_T_wo = [], []
    for i, p in enumerate(prepared):
        if failed[i]:
            results.append(FruitResult(p.name, p.submap_id, np.eye(4), latents[i], int(iters[i]),
                                       False, "optimization failed"))
            continue
        T_wo = np.linalg.inv(T_ows[i])
        reason = pose_outlier_reason(T_wo, opt_cfg)
        if reason:
            results.append(FruitResult(p.name, p.submap_id, T_wo, latents[i], int(iters[i]),
                                       False, reason))
            continue
        keep_idx.append(i)
        keep_T_wo.append(T_wo)

    if keep_idx:
        meshes = mesher.complete_mesh_batch(torch.as_tensor(latents[keep_idx]).to(dev), keep_T_wo,
                                            [prepared[i].color for i in keep_idx])
        for mesh_out, i, T_wo in zip(meshes, keep_idx, keep_T_wo):
            p = prepared[i]
            write_outputs(out_dirs, p.name, mesh_out, p.clean_pcd, T_wo)
            results.append(FruitResult(p.name, p.submap_id, T_wo, latents[i], int(iters[i]), True))
            if log_on:
                log(f"completed {p.name} in {int(iters[i])} iters")
            vis.update_mesh_pose(mesh_out, np.eye(4), 0)

    # the per-fruit manifest, merged with the entries of earlier runs
    merged = {}
    if os.path.isfile(manifest_path):
        try:
            with open(manifest_path) as f:
                merged = {r["name"]: r for r in json.load(f)}
        except (json.JSONDecodeError, OSError):
            merged = {}
    for r in results:
        merged[r.name] = {"name": r.name, "submap_id": r.submap_id, "valid": r.valid,
                          "reason": r.reason, "iter_count": r.iter_count}
    with open(manifest_path, "w") as f:
        json.dump(sorted(merged.values(), key=lambda r: r["name"]), f, indent=1)
    return results


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("-c", "--config", default=os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
        "configs", "wild_pepper.yaml"), help="path to the config file (.yaml)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    results = run_wild_completion(load_config(args.config), device=args.device)
    print(f"completed {sum(r.valid for r in results)}/{len(results)} submaps")


if __name__ == "__main__":
    main()
