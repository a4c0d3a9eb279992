"""Commercial-greenhouse (CKA) evaluation against measured ground-truth fruits
(counterpart of `hortimapping_tpu/pipeline/greenhouse.py`).

`fruits_measured/info.json` maps fruit id -> {submap_id, begin_frame,
end_frame}; each fruit directory carries tf/tf_allposes.npz (T_gc a frame),
tf/tf.npz (T_mg, into the photogrammetry reconstruction's frame),
tf/bounding_box.npz and laser/fruit_clean.ply (the GT cloud, downsampled to
1 mm here).

Single-frame: for each sampled frame, the masked depth back-projected
through the fixed extrinsic T_cw = [[0,0,-1],[-1,0,0],[0,1,0]] is the
surface cloud, and the GT pose is T_wg = T_wc @ inv(T_gc). Multi-frame:
the submap mesh (with a pose init against the background cloud), or with
`use_homa: false` the photogrammetry reconstruction cropped by the fruit's
box, is the surface input; the aligned camera poses feed a multi-frame
render term; T_wg = T_wm @ T_mg with T_wm = (inv(ros_tfs[0]) @ T_bc) @
inv(metashape_poses[0]). Every instance is one lane of a single batched
solve.

Both modes report shape metrics (CD, P/R/F1 at 5 mm) and pose metrics: the
translation error ||t_wg - t_wo|| [mm] of the de-scaled estimate and the
angle [deg] between its z-axis and the GT's, on the host in numpy; and write
per-fruit result dirs (complete_mesh / gt_pcd / estimated_pose / gt_pose
.ply).

Run:  python -m hortimapping_tpu_torch.pipeline.greenhouse -c configs/cka_pepper_tpu.yaml --multi
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List

import numpy as np
import torch

from hortimapping_tpu_torch.config import JointOptConfig, load_config
from hortimapping_tpu_torch.data import imageio
from hortimapping_tpu_torch.data.mesh import PointCloud, TriangleMesh
from hortimapping_tpu_torch.data.ply import read_mesh, read_point_cloud, write_mesh, write_point_cloud
from hortimapping_tpu_torch.data.preprocess import (
    build_T_wo,
    clean_mesh,
    clean_pcd,
    get_deg_between_vectors,
    get_pose_init,
)
from hortimapping_tpu_torch.data.rays import get_render_data, render_data_to_observations
from hortimapping_tpu_torch.data.rgbd import backproject
from hortimapping_tpu_torch.device import resolve_device
from hortimapping_tpu_torch.metrics.chamfer import ChamferDistance
from hortimapping_tpu_torch.metrics.precision_recall import PrecisionRecall
from hortimapping_tpu_torch.models.workspace import config_decoder, load_latent_vectors
from hortimapping_tpu_torch.ops.mesher import MeshExtractor
from hortimapping_tpu_torch.optim.lm import shape_opt_deepsdf_batched
from hortimapping_tpu_torch.optim.state import stack_observations
from hortimapping_tpu_torch.optim.warmstart import warmstart_solve
from hortimapping_tpu_torch.utils.misc import get_time, set_random_seed, wandb_log_summary

# fixed extrinsic initial guess of the handheld single-frame setup
T_CW_SINGLE = np.array(
    [[0, 0, -1, 0], [-1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 0, 1]], np.float64
)
# hand-fixed base -> camera transform of the robot
T_BC = np.array(
    [[0.0, -1.0, 0.0, 1.85999882],
     [0.0, 0.0, 1.0, -0.23719681],
     [-1.0, 0.0, 0.0, 2.02642561],
     [0.0, 0.0, 0.0, 1.0]]
)


def _coordinate_frame_mesh(size: float = 0.1) -> TriangleMesh:
    """A small RGB axis triad: three thin axis-aligned quads coloured
    x = red, y = green, z = blue."""
    w = size * 0.02
    verts, faces, colors = [], [], []
    for ax, col in ((0, [1.0, 0, 0]), (1, [0, 1.0, 0]), (2, [0, 0, 1.0])):
        base = len(verts)
        for corner in range(4):
            v = np.zeros(3)
            v[ax] = size if corner >= 2 else 0.0
            v[(ax + 1) % 3] = w if corner % 2 else -w
            verts.append(v)
            colors.append(col)
        faces += [[base, base + 1, base + 2], [base + 1, base + 3, base + 2]]
    return TriangleMesh(np.asarray(verts, np.float32), np.asarray(faces, np.int32),
                        np.asarray(colors, np.float64))


def _load_intrinsics(rgbd_base: str):
    with open(os.path.join(rgbd_base, "intrinsic.json")) as f:
        cam = json.load(f)
    K = np.array(cam["intrinsic_matrix"]).reshape(3, 3).T  # column-major
    return K, [cam["height"], cam["width"]], cam["depth_scale"]


def read_frame(rgbd_base: str, img_id_str: str, submap_id: int, depth_scale: float):
    """(submap-id image with every other id set to 0, metric depth) of one
    frame, or None where the frame has no submap-id image."""
    sid_path = os.path.join(rgbd_base, "submap_ids", img_id_str + "_submap_id.png")
    if not os.path.exists(sid_path):
        return None
    sid_img = imageio.imread(sid_path)
    if sid_img.ndim != 2:
        raise ValueError(f"{sid_path}: expected a one-channel submap-id image")
    sid_img[sid_img != submap_id] = 0
    depth_m = np.load(os.path.join(rgbd_base, "depth", img_id_str + ".npy")) / depth_scale
    return sid_img, depth_m


def background_cloud(submap_folder: str) -> PointCloud:
    """The background submap sampled at 500k points, in 1 cm voxels: the
    support the pose init looks for behind and above a fruit."""
    bg_mesh = read_mesh(os.path.join(submap_folder, "00001_Background.ply"))
    return bg_mesh.sample_points_uniformly(500000).voxel_down_sample(0.01)


def prepare_greenhouse_instances(cfg: Dict, opt_cfg: JointOptConfig,
                                 multi_frame: bool) -> List[Dict]:
    """Host preprocessing of every optimisation instance (fruit in multi
    mode, fruit x sampled frame in single mode), deterministic from the
    seeded generators (a local `default_rng(42)` and numpy's global one,
    in the JAX package's order). Each dict: label, rd, obs, points_w,
    T_ow0, T_wg, gt_points_w, gt_count, result_dir."""
    object_radius_max_m = float(cfg["vis"]["object_radius_max_m"])
    deepsdf_baseline = cfg.get("baseline_name") == "DeepSDF"
    frame_per_fruit = int(cfg.get("frame_per_fruit", 20))
    data_dirs = cfg["data_dir"]
    if isinstance(data_dirs, str):
        data_dirs = [data_dirs]

    rng = np.random.default_rng(42)
    prepared: List[Dict] = []
    for data_dir in data_dirs:
        # both modes read the "before" capture sequence
        input_base = os.path.join(data_dir, "before")
        rgbd_base = os.path.join(input_base, "realsense")
        K, img_size, depth_scale = _load_intrinsics(rgbd_base)
        invK = np.linalg.inv(K)
        rgb_files = sorted(os.listdir(os.path.join(rgbd_base, "color")))

        gt_base = os.path.join(data_dir, "fruits_measured")
        info_name = "info_usable.json" if cfg.get("useable_only") else "info.json"
        with open(os.path.join(gt_base, info_name)) as f:
            gt_fruits_info = json.load(f)
        if cfg.get("fruit_id", "none") != "none":
            gt_fruits_info = {cfg["fruit_id"]: gt_fruits_info[cfg["fruit_id"]]}

        if multi_frame:
            ros_tfs = np.load(os.path.join(input_base, "rostf_poses_no_jump.npz"),
                              allow_pickle=True)["arr_0"]
            cam_tfs = np.load(os.path.join(input_base, "rostf_poses_metashape_aligned.npz"),
                              allow_pickle=True)["arr_0"]
            metashape_poses = np.load(os.path.join(input_base, "metashape", "scaled_poses.npz"),
                                      allow_pickle=True)["arr_0"]
            T_wm = (np.linalg.inv(ros_tfs[0]) @ T_BC) @ np.linalg.inv(metashape_poses[0])
            submap_folder = os.path.join(input_base, "submaps")
            bg_pcd = background_cloud(submap_folder)

        for fruit_id, fruit_info in gt_fruits_info.items():
            cur_submap_id = fruit_info["submap_id"]
            begin_frame, end_frame = fruit_info["begin_frame"], fruit_info["end_frame"]
            fruit_base = os.path.join(gt_base, fruit_id)
            tf_folder = os.path.join(fruit_base, "tf")
            tfs_cam = np.load(os.path.join(tf_folder, "tf_allposes.npz"),
                              allow_pickle=True)["arr_0"]
            result_dir = os.path.join(fruit_base, "result_" + cfg["run_name"])
            os.makedirs(result_dir, exist_ok=True)
            gt_pcd = read_point_cloud(
                os.path.join(fruit_base, "laser", "fruit_clean.ply")).voxel_down_sample(1e-3)
            sample_idx = np.linspace(
                begin_frame, end_frame - 1,
                min(end_frame - begin_frame + 1, frame_per_fruit),
            ).astype(np.int32)

            if multi_frame:
                T_mg = np.load(os.path.join(tf_folder, "tf.npz"), allow_pickle=True)["arr_0"]
                T_wg = T_wm @ T_mg
                if cfg.get("use_homa", True):
                    submap_mesh = read_mesh(os.path.join(
                        submap_folder, f"{cur_submap_id:05d}_Sweetpepper.ply"))
                    pcd_w = clean_mesh(submap_mesh, opt_cfg.recon_n_pts,
                                       opt_cfg.recon_cluster_dist_m)
                    center, yaw, bbx_size, valid = get_pose_init(pcd_w, bg_pcd)
                    if not valid:
                        continue
                    scale_init = (
                        max(bbx_size / (2 * object_radius_max_m * 0.8), 0.5)
                        if (opt_cfg.pose_init_scale_on and not deepsdf_baseline) else 1.0
                    )
                    T_wo0 = build_T_wo(center, yaw, scale_init,
                                       rot_on=opt_cfg.pose_init_rot_on and not deepsdf_baseline)
                else:
                    recon = read_point_cloud(os.path.join(fruit_base, "reconstruction.ply"))
                    bbx = np.load(os.path.join(tf_folder, "bounding_box.npz"),
                                  allow_pickle=True)["arr_0"]
                    recon_g = recon.transform(np.linalg.inv(T_mg)).crop(bbx[0], bbx[1])
                    pcd_w = recon_g.transform(T_mg).transform(T_wm)
                    n0 = len(pcd_w)
                    if n0 == 0:
                        continue
                    pcd_w = pcd_w.select(rng.random(n0) < min(opt_cfg.recon_n_pts / n0, 1.0))
                    pcd_w = clean_pcd(pcd_w, opt_cfg.recon_cluster_dist_m)
                    T_wo0 = np.eye(4)
                    T_wo0[:3, 3] = np.mean(pcd_w.aabb(), axis=0)

                id_imgs, depth_imgs, poses = {}, {}, {}
                for img_id in sample_idx:
                    img_id_str = rgb_files[img_id].split(".")[0]
                    frame = read_frame(rgbd_base, img_id_str, cur_submap_id, depth_scale)
                    if frame is None:
                        continue
                    id_imgs[img_id_str], depth_imgs[img_id_str] = frame
                    poses[img_id_str] = cam_tfs[img_id]
                rd = get_render_data(
                    cur_submap_id, id_imgs, depth_imgs, poses, img_size, invK,
                    n_fg_pix=opt_cfg.n_fg_pix, n_bg_pix=opt_cfg.n_bg_pix,
                    n_bg_pad=opt_cfg.n_bg_pad, max_bbx_size=400,
                )
                if rd["count"] == 0:
                    continue
                obs = render_data_to_observations(
                    rd, pcd_w.points, opt_cfg.n_frame,
                    opt_cfg.n_fg_pix, opt_cfg.n_bg_pix, opt_cfg.recon_n_pts,
                )
                prepared.append(dict(
                    label=fruit_id, rd=rd, obs=obs, points_w=pcd_w.points,
                    T_ow0=np.linalg.inv(T_wo0), T_wg=T_wg,
                    gt_points_w=gt_pcd.transform(T_wg).points,
                    gt_count=len(gt_pcd), result_dir=result_dir))
            else:
                T_wc = np.linalg.inv(T_CW_SINGLE)
                for img_id in sample_idx:
                    img_id_str = rgb_files[img_id].split(".")[0]
                    frame = read_frame(rgbd_base, img_id_str, cur_submap_id, depth_scale)
                    if frame is None:
                        continue
                    sid_img, depth_m = frame
                    pcd = backproject(depth_m, K, pose=T_wc, mask=sid_img > 0, depth_trunc=1.0)
                    n0 = len(pcd)
                    if n0 < 0.2 * opt_cfg.recon_n_pts:
                        continue  # too few 3-D points
                    pcd = pcd.select(rng.random(n0) < min(opt_cfg.recon_n_pts / n0, 1.0))
                    pcd = clean_pcd(pcd, opt_cfg.recon_cluster_dist_m)
                    T_wo0 = np.eye(4)
                    T_wo0[:3, 3] = np.mean(pcd.aabb(), axis=0)
                    rd = get_render_data(
                        cur_submap_id, {img_id_str: sid_img}, {img_id_str: depth_m},
                        {img_id_str: T_wc}, img_size, invK,
                        n_fg_pix=opt_cfg.n_fg_pix, n_bg_pix=opt_cfg.n_bg_pix,
                        n_bg_pad=opt_cfg.n_bg_pad, max_bbx_size=400,
                    )
                    if rd["count"] == 0:
                        continue
                    obs = render_data_to_observations(
                        rd, pcd.points, opt_cfg.n_frame,
                        opt_cfg.n_fg_pix, opt_cfg.n_bg_pix, opt_cfg.recon_n_pts,
                    )
                    T_wg = T_wc @ np.linalg.inv(tfs_cam[img_id])
                    prepared.append(dict(
                        label=f"{fruit_id}/{img_id_str}", rd=rd, obs=obs,
                        points_w=pcd.points, T_ow0=np.linalg.inv(T_wo0), T_wg=T_wg,
                        gt_points_w=gt_pcd.transform(T_wg).points,
                        gt_count=len(gt_pcd), result_dir=result_dir))
    return prepared


def pose_errors(T_ow: np.ndarray, T_wg: np.ndarray):
    """(translation error [mm], z-axis angle [deg], de-scaled T_wo) of one
    solved f32 pose against the GT, in numpy on the host: the inverse and
    the angle's arccos (near 1) are computed in float64 by numpy."""
    T_wo = np.linalg.inv(T_ow)
    final_scale = np.linalg.det(T_wo[:3, :3]) ** (1.0 / 3.0)
    T_wo_descale = T_wo.copy()
    T_wo_descale[:3, :3] /= final_scale
    tran = np.linalg.norm(T_wg[:3, 3] - T_wo_descale[:3, 3]) * 1e3
    rot = get_deg_between_vectors(T_wo_descale[:3, 2], T_wg[:3, 2])
    return tran, rot, T_wo_descale


def write_result_dir(result_dir: str, mesh: TriangleMesh, gt_pts_w: np.ndarray,
                     T_wo_descale: np.ndarray, T_wg: np.ndarray) -> None:
    write_mesh(os.path.join(result_dir, "complete_mesh.ply"), mesh)
    write_point_cloud(os.path.join(result_dir, "gt_pcd.ply"), PointCloud(gt_pts_w))
    write_mesh(os.path.join(result_dir, "estimated_pose.ply"),
               _coordinate_frame_mesh().transform(T_wo_descale))
    write_mesh(os.path.join(result_dir, "gt_pose.ply"), _coordinate_frame_mesh().transform(T_wg))


def run_greenhouse_eval(cfg: Dict, multi_frame: bool, log=print,
                        device: str | torch.device = "cuda") -> Dict:
    dev = resolve_device(device)
    set_random_seed(42)
    opt_cfg = JointOptConfig.from_dict(cfg)
    params, spec = config_decoder(cfg["deepsdf_dir"], "latest", device=dev)
    latents_train = load_latent_vectors(cfg["deepsdf_dir"], "latest", device=dev)
    init_latent = latents_train.mean(0)

    object_radius_max_m = float(cfg["vis"]["object_radius_max_m"])
    voxels_dim = int(2 * object_radius_max_m * 1e3 / float(cfg["vis"]["mc_res_mm"]))
    deepsdf_baseline = cfg.get("baseline_name") == "DeepSDF"

    prepared = prepare_greenhouse_instances(cfg, opt_cfg, multi_frame)
    if not prepared:
        log("no valid instances")
        return {}

    # ---------------- batched solve ----------------
    B = len(prepared)
    lat0 = init_latent[None, :].repeat(B, 1)
    T0 = torch.as_tensor(np.stack([p["T_ow0"] for p in prepared]).astype(np.float32)).to(dev)
    obs_b = stack_observations([p["obs"] for p in prepared], dev)
    t0 = get_time()
    if deepsdf_baseline:
        # the baseline keeps the table-mean init and the fixed pose: a
        # retrieval warm start here would report non-baseline numbers under
        # the baseline's name
        lat_b, it_b = shape_opt_deepsdf_batched(params, spec, opt_cfg, obs_b.points_w,
                                                obs_b.point_valid, lat0, device=dev)
        latents, T_ows, iters = lat_b.cpu().numpy(), T0.cpu().numpy(), it_b.cpu().numpy()
    else:
        res = warmstart_solve(params, spec, opt_cfg, latents_train, obs_b, lat0, T0,
                              object_radius_max_m, device=dev)
        latents, T_ows = res.latent.cpu().numpy(), res.T_ow.cpu().numpy()
        iters = res.iter_count.cpu().numpy()
    t_total = get_time() - t0

    # ---------------- meshing, pose metrics, outputs ----------------
    mesher = MeshExtractor(params, spec, voxels_dim, object_radius_max_m,
                           method=cfg["vis"].get("iso_method", "mt"), device=dev)
    meshes = mesher.complete_mesh_batch(torch.as_tensor(latents).to(dev),
                                        [np.linalg.inv(T) for T in T_ows])
    cd_metric = ChamferDistance(dev)
    pr_metric = PrecisionRecall(min_t=0.001, max_t=0.01, num=100, device=dev)
    tran_err, rot_err = [], []
    for i, (p, mesh) in enumerate(zip(prepared, meshes)):
        complete = mesh.sample_points_uniformly(p["gt_count"])
        cd_metric.update(p["gt_points_w"], complete.points)
        pr_metric.update(p["gt_points_w"], complete.points)
        tran, rot, T_wo_descale = pose_errors(T_ows[i], p["T_wg"])
        tran_err.append(tran)
        rot_err.append(rot)
        write_result_dir(p["result_dir"], mesh, p["gt_points_w"], T_wo_descale, p["T_wg"])

    pr, re, f1, thre = pr_metric.compute_at_threshold(0.005)
    cd = cd_metric.compute()
    summary = {
        "CD[mm]": cd * 1e3, "F-score[%]": f1, "Precision[%]": pr, "Recall[%]": re,
        "threshold[mm]": thre,
        "Error_trans[mm]": float(np.mean(tran_err)), "TransStd[mm]": float(np.std(tran_err)),
        "Error_rot[deg]": float(np.mean(rot_err)), "RotStd[deg]": float(np.std(rot_err)),
        "cd_per_fruit_mm": [float(c) * 1e3 for c in cd_metric.cd_array],
        "tran_err_per_fruit_mm": [float(t) for t in tran_err],
        "rot_err_per_fruit_deg": [float(r) for r in rot_err],
        "timing_s": t_total / B, "iteration": float(np.mean(iters)), "frames": B,
    }
    target = "the whole test set" if cfg.get("fruit_id", "none") == "none" else cfg["fruit_id"]
    log(f"Results on {target}")
    log(f"CD        [mm]: {summary['CD[mm]']}")
    log(f"F-score    [%]: {f1}")
    log(f"Precision  [%]: {pr}")
    log(f"Recall:    [%]: {re}")
    log(f"TransError[mm]: {summary['Error_trans[mm]']}")
    log(f"TransStd  [mm]: {summary['TransStd[mm]']}")
    log(f"RotError [deg]: {summary['Error_rot[deg]']}")
    log(f"RotStd   [deg]: {summary['RotStd[deg]']}")
    log(f"timing     [s]: {summary['timing_s']}")
    log(f"iteration     : {summary['iteration']}")
    log(f"calculated over {B} frames")
    wandb_log_summary("HOMA", cfg["run_name"], summary,
                      cfg.get("vis", {}).get("wandb_log_on", False))
    return summary


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("-c", "--config", default=os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
        "configs", "cka_pepper.yaml"), help="path to the config file (.yaml)")
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument("--multi", dest="multi_frame", action="store_true",
                      help="one optimisation per fruit over its sampled frames "
                           "(eval_wild_multi_frames.py)")
    mode.add_argument("--single", dest="multi_frame", action="store_false",
                      help="one optimisation per sampled frame (eval_wild_single_frame.py)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    run_greenhouse_eval(load_config(args.config), args.multi_frame, device=args.device)


if __name__ == "__main__":
    main()
