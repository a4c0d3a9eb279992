"""ECCV shape-completion challenge runner (counterpart of
`hortimapping_tpu/pipeline/challenge.py`).

Per fruit of a challenge split on disk: the fused masked RGB-D cloud is
cropped to a 1.5-radius box, randomly downsampled to `recon.n_pts`,
cleaned to its largest cluster, and solved with the pose known (identity;
the scale stays free) or by the code-only DeepSDF baseline
(`baseline_name: DeepSDF`); the meshes go to `results/<run>/<split>/<fid>.ply`
and the summary reports Chamfer-L1, P/R/F1 at 5 mm, the mean time and the
mean iterations per fruit.

Three phases, in the JAX package's order and semantics:
1. host preprocessing of every fruit (`prepare_fruits`: loading and depth
   filtering, crop, downsample, cleaning, ray sampling);
2. one batched solve of all fruits on the device (`warmstart_solve` with
   `pose_known=True`, or `shape_opt_deepsdf_batched`); its wall time over
   the fruits is the reported per-fruit time;
3. one batched grid decode and host meshing, the files and the metrics.

Run:  python -m hortimapping_tpu_torch.pipeline.challenge -c configs/shape_completion_challenge_pepper_tpu.yaml
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from hortimapping_tpu_torch.config import JointOptConfig, load_config
from hortimapping_tpu_torch.data.challenge import ShapeCompletionDataset
from hortimapping_tpu_torch.data.mesh import PointCloud
from hortimapping_tpu_torch.data.ply import write_mesh
from hortimapping_tpu_torch.data.preprocess import clean_pcd
from hortimapping_tpu_torch.data.rays import get_render_data, render_data_to_observations
from hortimapping_tpu_torch.device import resolve_device
from hortimapping_tpu_torch.metrics.chamfer import ChamferDistance
from hortimapping_tpu_torch.metrics.precision_recall import PrecisionRecall
from hortimapping_tpu_torch.models.workspace import config_decoder, load_latent_vectors
from hortimapping_tpu_torch.ops.mesher import MeshExtractor
from hortimapping_tpu_torch.optim.lm import shape_opt_deepsdf_batched
from hortimapping_tpu_torch.optim.state import stack_observations
from hortimapping_tpu_torch.optim.warmstart import warmstart_solve
from hortimapping_tpu_torch.utils.misc import get_time, set_random_seed, wandb_log_summary

# (fid, observations (numpy), cleaned surface cloud, GT cloud or None)
Prepared = Tuple[str, object, PointCloud, Optional[PointCloud]]


def prepare_fruits(cfg: Dict, opt_cfg: JointOptConfig, dataset: ShapeCompletionDataset,
                   ) -> List[Prepared]:
    """Phase 1 on the host: every fruit of the split with a non-empty
    cropped cloud becomes fixed-shape observation buffers. Draws from
    `default_rng(42)` (downsampling) and numpy's global RNG (rays) in the
    JAX package's order."""
    object_radius_max_m = float(cfg["vis"]["object_radius_max_m"])
    frame_per_fruit = int(cfg.get("frame_per_fruit", opt_cfg.n_frame))
    cur_submap_id = 1   # masks are 0/1; the fruit is instance 1
    prepared: List[Prepared] = []
    rng = np.random.default_rng(42)
    for fruit in dataset:
        fid = fruit["fid"]
        if "lab" in fid and cfg.get("skip_lab_data", False):
            continue
        invK = np.linalg.inv(fruit["rgbd_intrinsic"])
        frames = fruit["rgbd_frames"]
        frame_ids = np.array(list(frames.keys()))
        sample_idx = np.linspace(
            0, len(frame_ids) - 1, min(len(frame_ids), frame_per_fruit)).astype(np.int32)
        img_size = frames[frame_ids[0]]["rgb"].shape[:-1]

        # fused masked cloud -> crop to the 1.5 r box -> downsample -> clean
        bound = np.ones(3) * object_radius_max_m * 1.5
        map_pcd = fruit["rgbd_pcd"].crop(-bound, bound)
        n0 = len(map_pcd)
        if n0 == 0:
            continue
        map_pcd = map_pcd.select(rng.random(n0) < min(opt_cfg.recon_n_pts / n0, 1.0))
        map_pcd = clean_pcd(map_pcd, opt_cfg.recon_cluster_dist_m)

        id_imgs, depth_imgs, poses = {}, {}, {}
        for idx in frame_ids[sample_idx]:
            fr = frames[idx]
            id_imgs[fr["fname"]] = (np.asarray(fr["mask"]) > 0).astype(np.int32)
            depth_imgs[fr["fname"]] = fr["depth"]
            poses[fr["fname"]] = fr["pose"]
        render_data = get_render_data(
            cur_submap_id, id_imgs, depth_imgs, poses, img_size, invK,
            n_fg_pix=opt_cfg.n_fg_pix, n_bg_pix=opt_cfg.n_bg_pix,
            n_bg_pad=opt_cfg.n_bg_pad, max_bbx_size=1000,
        )
        obs = render_data_to_observations(
            render_data, map_pcd.points, opt_cfg.n_frame,
            opt_cfg.n_fg_pix, opt_cfg.n_bg_pix, opt_cfg.recon_n_pts,
        )
        prepared.append((fid, obs, map_pcd, fruit.get("groundtruth_pcd")))
    return prepared


def run_challenge(cfg: Dict, log=print, device: str | torch.device = "cuda") -> Dict:
    dev = resolve_device(device)
    set_random_seed(42)
    opt_cfg = JointOptConfig.from_dict(cfg)

    params, spec = config_decoder(cfg["deepsdf_dir"], "latest", device=dev)
    latents_train = load_latent_vectors(cfg["deepsdf_dir"], "latest", device=dev)
    init_latent = latents_train.mean(0)

    object_radius_max_m = float(cfg["vis"]["object_radius_max_m"])
    voxels_dim = int(2 * object_radius_max_m * 1e3 / float(cfg["vis"]["mc_res_mm"]))
    deepsdf_baseline = cfg.get("baseline_name") == "DeepSDF"

    dataset = ShapeCompletionDataset(cfg["data_dir"], cfg["split"])
    result_folder = os.path.join(cfg["data_dir"], "results", cfg["run_name"], cfg["split"])
    os.makedirs(result_folder, exist_ok=True)
    cd_metric = ChamferDistance(dev)
    pr_metric = PrecisionRecall(min_t=0.001, max_t=0.01, num=100, device=dev)

    # ---------------- phase 1: host preprocessing ----------------
    prepared = prepare_fruits(cfg, opt_cfg, dataset)
    if not prepared:
        log("no fruits found")
        return {}

    # ---------------- phase 2: batched solve ----------------
    B = len(prepared)
    lat0 = init_latent[None, :].repeat(B, 1)
    T0 = torch.eye(4, dtype=torch.float32, device=dev)[None].repeat(B, 1, 1)
    t0 = get_time()
    obs_b = stack_observations([p[1] for p in prepared], dev)
    if deepsdf_baseline:
        # shape only, the pose frozen at identity (the points are already
        # about in the object frame)
        lat_b, iter_b = shape_opt_deepsdf_batched(params, spec, opt_cfg, obs_b.points_w,
                                                  obs_b.point_valid, lat0, device=dev)
        latents, T_ows, iters = lat_b.cpu().numpy(), T0.cpu().numpy(), iter_b.cpu().numpy()
        failed = np.zeros(B, bool)
    else:
        res = warmstart_solve(params, spec, opt_cfg, latents_train, obs_b, lat0, T0,
                              object_radius_max_m, pose_known=True, device=dev)
        latents, T_ows = res.latent.cpu().numpy(), res.T_ow.cpu().numpy()
        iters, failed = res.iter_count.cpu().numpy(), res.failed.cpu().numpy()
    t_total = get_time() - t0

    # ---------------- phase 3: meshing, metrics, summary ----------------
    mesher = MeshExtractor(params, spec, voxels_dim, object_radius_max_m,
                           method=cfg["vis"].get("iso_method", "mt"), device=dev)
    meshes = mesher.complete_mesh_batch(torch.as_tensor(latents).to(dev),
                                        [np.linalg.inv(T) for T in T_ows])
    gt_valid = cfg["split"] != "test"
    for (fid, _, _, gt_pcd), mesh in zip(prepared, meshes):
        write_mesh(os.path.join(result_folder, fid + ".ply"), mesh)
        if gt_valid and gt_pcd is not None:
            complete_pcd = mesh.sample_points_uniformly(len(gt_pcd))
            cd_metric.update(gt_pcd.points, complete_pcd.points)
            pr_metric.update(gt_pcd.points, complete_pcd.points)

    summary: Dict = {
        "fruits": B,
        "failed": int(failed.sum()),
        "timing_s": t_total / B,
        "iteration": float(np.mean(iters)),
    }
    if gt_valid:
        pr, re, f1, thre = pr_metric.compute_at_threshold(0.005)
        cd = cd_metric.compute()
        summary.update({
            "CD[mm]": cd * 1e3, "F-score[%]": f1, "Precision[%]": pr,
            "Recall[%]": re, "threshold[mm]": thre,
            # per-fruit CDs [mm] in dataset order, for paired comparisons
            "cd_per_fruit_mm": [float(c) * 1e3 for c in cd_metric.cd_array],
        })
        log(f"Results on the {cfg['split']} set")
        log(f"CD        [mm]: {cd * 1e3}")
        log(f"F-score    [%]: {f1}")
        log(f"Precision  [%]: {pr}")
        log(f"Recall:    [%]: {re}")
        log(f"threshold [mm]: {thre}")
    log(f"timing     [s]: {summary['timing_s']}")
    log(f"iteration     : {summary['iteration']}")
    log(f"calculated over {B} fruits")
    wandb_log_summary("HOMA", cfg["run_name"], summary,
                      cfg.get("vis", {}).get("wandb_log_on", False))
    return summary


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("-c", "--config", default=os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
        "configs", "shape_completion_challenge_pepper.yaml"),
        help="path to the config file (.yaml)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    run_challenge(load_config(args.config), device=args.device)


if __name__ == "__main__":
    main()
