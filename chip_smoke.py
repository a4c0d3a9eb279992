#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Phases (one line each; any failure ends the run with a non-zero exit):
  1. device: the card's name and power limit, torch/CUDA versions, the build
     of the four kernel libraries (nvcc, in parallel) and of the host library
     (g++);
  2. B3, the decoder forward kernel, vs its plain PyTorch version at both
     retrieval scoring shapes (bench: bf16, 16 fruits x 256 codes x 128
     points; greenhouse: f32, 16 fruits x 128 codes x 256 points), with the
     code each point set retrieves;
  3. B4, the shared-latent kernel, vs its plain version on the mesher's 40^3
     grid under the batch's 32 retrieved codes, f32 and bf16, each meshed and
     held to the surface gate (vertex distance to the f32 zero level set);
  4. B1, the fwd+input-grad kernel, and B2, the fused render kernel (three
     launches: forward + render, band backward, per-ray sums), vs their
     plain versions at every shape of both paths (bench coarse and fine,
     greenhouse full resolution), B2 gated as the repo's fused-kernel gate
     (ROADMAP.md "Rules") plus a small f32 case, each bit-equal across two
     launches; B1 in the lanes form the LM launches (two frozen lanes),
     beside one flat launch of the same rows; B2's time split by launch with
     its band rows and their fill of 64-row chunks;
  5. the bench path: the bench.py workload (32 synthetic peppers, seed 42)
     at the full width of assets/synthetic_pepper_32 through retrieval warm
     start, coarse-to-fine LM and 40^3 meshing, timed with its split, mean
     Chamfer-L1 against the analytic GT surfaces and all four launch counts;
     then its functional gate: the same with every kernel swapped for its
     plain version must reach the same mean Chamfer-L1 within 0.3 mm;
  6. the greenhouse path: configs/cka_pepper_tpu.yaml on the same batch
     through `warmstart_solve` (f32 retrieval, 50-iteration LM with damped
     rotation tangents, selective multi-start rescue) and
     `complete_mesh_batch` at 40^3, timed with its split, the rescue's lanes
     and all four launch counts;
  7. the trust-region path: configs/shape_completion_challenge_pepper_tpu.yaml
     (5 frames x 300 rays x 20 samples, 5-scale retrieval) at B=8: B1, B2,
     B3 and B4 vs their plain versions at the shapes this path gives them,
     the timed path with all four launch counts, and its functional gate
     (every kernel against its plain version, mean Chamfer-L1 within 0.3 mm);
  8. the greenhouse path's functional gate at B=8: every kernel against its
     plain version, mean Chamfer-L1 within 0.3 mm;
  9. the wild path: a BUP20-like row (32 fruits, 50 frames of 1280x720, the
     camera 0.8 m from the row) written by the port's generator to a
     temporary directory; B1 and B2 (B3 and B4 where the path's batch is not
     32) vs their plain versions on the path's own observations, invalid
     frame slots included; `run_wild_completion` on
     configs/wild_pepper_tpu.yaml timed with its split (load frames, phase 1,
     solve, meshing, writing), at least 24 of 32 fruits valid, all four
     launch counts; a resumed run that skips every valid fruit and leaves
     their manifest entries equal; its functional gate (plain versions, mean
     Chamfer-L1 to the GT ellipsoids within 0.3 mm);
 10. the challenge path: an ECCV-challenge split (32 fruits, 5 frames of
     640x480 each: masks, poses, colour, depth .npy, GT clouds) written by
     the port's generator to a temporary directory; B1 (the SDF term, and
     the DeepSDF baseline's lanes form: the table mean, pose frozen, two
     lanes finished), B2, B3 and B4 vs their plain versions on the path's
     own observations;
     `run_challenge` on configs/shape_completion_challenge_pepper_tpu.yaml
     (pose known) timed as the median of 3 after a warm-up with its split
     (load + depth filter, cleaning, ray sampling, solve, meshing, metrics,
     writing), CD and P/R/F1 at 5 mm against the GT clouds, all four launch
     counts; the DeepSDF baseline run with its B1 launches; the functional
     gate at B=8 (plain versions, mean CD within 0.3 mm);
 11. the lab path: 32 peppers in the IGG lab layout (5 frames of 640x480)
     from the port's generator; `run_lab_eval` under
     configs/lab_pepper_tpu.yaml multi-frame on all 32 and single-frame on
     the first 4 fruits (20 lanes of one valid frame each), each timed as
     the median of 3 after a warm-up with its split, launch counts and CD,
     and B1, B2, B3 and B4 vs their plain versions on each run's own
     observations; the multi-frame functional gate at B=8; 8 berries under
     configs/lab_berry.yaml multi-frame (10 frames, cut from 50), timed the
     same way, B1 and B2 vs their plain versions on the berry run's
     observations, B4 on the berry's 80^3 grid under the surface gate of
     phase 3, and the berry run's functional gate;
 12. the greenhouse path from disk: 8 CKA-layout data dirs of 4 fruits (seeds
     9-16, 20 frames of 640x480 each) written by the port's generator;
     `run_greenhouse_eval` multi-frame under configs/cka_pepper_tpu.yaml on
     all 32 fruits, timed as the median of 2 after a warm-up with its split
     (reading frames and PNGs, cleaning, pose init, background sampling,
     ray sampling, solve, meshing, metrics, writing), CD, F-score, the pose
     errors, the rescue's lanes and all four launch counts; B1, B2, B3 and
     B4 vs their plain versions on the run's own observations; the
     functional gate on the first 2 dirs (8 fruits, mean CD within 0.3 mm,
     pose errors beside); single-frame under
     configs/cka_pepper_single_tpu.yaml on the first dir (a lane a sampled
     frame), timed the same way, B1, B2, B3 and B4 vs their plain versions
     on its observations (B4 in the mesher's launches of `decode_chunk`
     codes), each run's median of 2, cut from 3 for the script's time;
 13. the serving path: `CompletionServer` (bench config with unit-scale
     bf16 retrieval, coarse-to-fine LM, 40^3 meshing, max_batch 32) warmed
     up, then a burst of 64 requests served as two batches of 32, each lane
     equal to the direct `joint_opt_packed` of its batch at width 32 within
     1e-5, the served meshes' CD to the GT surfaces, all four launch
     counts; a stream of 40 requests one every 10 ms (widths, latency p50 /
     p95 / max, fruits/s); admission control (`ServerOverloaded` at
     max_queue 8) and a deadline of 0 behind a busy batch
     (`DeadlineExceeded`);
 14. the training path at full width: 256 ellipsoid scenes of the pepper
     family (16384 + 16384 samples each) written as DeepSDF SdfSamples to a
     temporary directory; `train_deepsdf` on an experiment of
     assets/synthetic_pepper_32's architecture (8 x 512, C = 32) at 64 x 8192
     rows a step for 20 epochs (80 steps) with a snapshot at epoch 10: ms a
     step, rows/s, the share of the f32 bound, peak memory, a falling loss;
     a resumed run from the snapshot held to the first run's losses; the
     checkpoint loaded by `config_decoder` and 8 codes of its table meshed
     (B4, counted over the path), B4 against its plain version on that
     decoder, and two steps of a small decoder on the card held to the same
     steps on the CPU (replayed draws; TF32 off);
 15. the asset build and the torch checkpoint: `make_category` of
     synthetic_pepper_32 (12000 steps x 8192 rows, cut and the cut printed if
     the script would pass 1000 s) timed, its SDF error on 65536 held-out
     points within 1.5x the shipped decoder's; the shipped decoder written as
     the reference's weight-normed `.pth` files and loaded on the card, its
     SDF within 1e-6 of the native load's;
 16. one JSON line of kernel records (the four kernels at their greenhouse
     shapes, then each kernel on the greenhouse-from-disk runs and the
     served batches, and B4 on the trained decoder), then the JSON result
     line.
With --profile FILE, one bench batch, one greenhouse batch, one wild run, one
challenge run, one lab multi-frame run, one greenhouse-from-disk run, one
served burst and one training epoch are traced by torch.profiler
(device-time tables appended to FILE, idle share printed), and one more
greenhouse batch with the SDF term's frozen-lane skip turned off.

Run from the repository root: python3 chip_smoke.py [--quick] [--profile FILE]
(--quick stops after phase 4). The JAX package is never imported.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

H100_HBM_BYTES_S = 3.35e12     # HBM3 rate, H100 SXM data sheet
H100_F32_FLOPS = 67e12         # float32 outside the tensor cores
H100_BF16_FLOPS = 989e12       # bf16 dense tensor-core rate
N_FRUITS = 32
CUBE_RADIUS = 0.08             # object_radius_max_m of wild_pepper.yaml
VOXELS = 40                    # int(2 * 0.08 * 1e3 / 4.0 mm), bench.py
N_TR = 8                       # fruits of the trust-region path
N_GATE = 8                     # fruits of the greenhouse path's functional gate
GREENHOUSE_YAML = "cka_pepper_tpu.yaml"
CHALLENGE_YAML = "shape_completion_challenge_pepper_tpu.yaml"
CD_GATE_MM = 0.3
WILD_YAML = "wild_pepper_tpu.yaml"
WILD_SIZE = (1280, 720)        # BUP20's frames (W, H)
WILD_DISTANCE = 0.8            # camera to fruit row (m): a fruit's box stays under 300 px
WILD_FRAMES = 50               # camera steps of 7.6 cm along the row (63 steps of 6 cm
                               # took the phase to 104 s; its budget is ~90 s)
WILD_SEED = 7                  # make_demo_data's default seed
WILD_MIN_VALID = 0.75         # share of the row's fruits that must come out valid
CHALLENGE_SIZE = (640, 480)    # the challenge's RealSense frames (W, H)
CHALLENGE_FRAMES = 5           # frame_per_fruit of the challenge YAML
LAB_YAML = "lab_pepper_tpu.yaml"
BERRY_YAML = "lab_berry.yaml"
LAB_FRAMES = 5                 # cut from lab_pepper_tpu.yaml's frame_per_fruit 10 for the
                               # phase's time (its n_frame is 5)
LAB_SINGLE_FRUITS = 4          # fruits of the single-frame run (one lane a frame)
BERRY_FRUITS = 8
BERRY_FRAMES = 10              # cut from lab_berry.yaml's frame_per_fruit 50: its n_frame is 10
N_PATH_GATE = 8                # fruits of the challenge and lab functional gates
GREENHOUSE_SINGLE_YAML = "cka_pepper_single_tpu.yaml"
GH_DIRS = 8                    # CKA-layout data dirs of the greenhouse path (seeds 9-16)
GH_FRUITS_PER_DIR = 4          # every fruit stays in view of the generator's sweep
GH_FRAMES = 20                 # frame_per_fruit of the CKA YAMLs: every frame sampled
GH_GATE_DIRS = 2               # dirs of the greenhouse functional gate (8 fruits)
GH_REPS = 2                    # timed runs of each greenhouse run, cut from 3 for the
                               # script's time (a multi-frame run of the 32 fruits takes
                               # ~22 s, ~10 s of it sampling the 8 background submaps)
GH_MEMORY = "greenhouse in memory"   # the path of the kernels line's first four rows
TRAIN_SCENES = 256             # SdfSamples scenes of the training path (~134 MB)
TRAIN_SAMPLES = 16384          # samples of each sign a scene
TRAIN_EPOCHS = 20              # 4 steps an epoch at ScenesPerBatch 64: 80 steps
SCRIPT_BUDGET_S = 1000         # phase 15 cuts the asset build's steps to end the script by then
HELD_OUT = 65536               # held-out points of the built decoder's SDF error
KERNEL_SOURCES = {             # kernel: (its source, the TPU kernel it replaces)
    "mlp_fwd_grad": ("hortimapping_tpu_torch/csrc/mlp_fwd_grad.cu",
                     "hortimapping_tpu/ops/pallas_mlp.py:198"),
    "fused_render": ("hortimapping_tpu_torch/csrc/fused_render.cu",
                     "hortimapping_tpu/ops/pallas_render.py:100"),
    "mlp_fwd": ("hortimapping_tpu_torch/csrc/mlp_fwd.cu", "hortimapping_tpu/ops/pallas_mlp.py:169"),
    "mlp_shared_latent": ("hortimapping_tpu_torch/csrc/mlp_shared_latent.cu",
                          "hortimapping_tpu/ops/pallas_mlp.py:303"),
}
# B3 in bf16 vs its plain version: a summation-order flip moves one
# activation by one bf16 ulp (2^-8 relative), which reaches the tanh output
# damped; the median stays near f32 level and 99 % of rows stay within 2 %
# of the clamping distance (0.1). The ranking gate: where kernel and plain
# scores pick different codes, the plain scores of the two must tie within
# 1e-4 (a mean of 128-256 clamped |sdf| values).
B3_BF16_GATE = dict(med=1e-4, p99=2e-3, score=1e-4)
# B4 in bf16 vs its plain version: the same chain on the same kind of rows
# (code | xyz), so the same median and p99 gates as B3
B4_BF16_GATE = dict(med=B3_BF16_GATE["med"], p99=B3_BF16_GATE["p99"])
# kernel vs plain gates of the render term (tools/fused_check.py TOL, the
# repo's fused-kernel gate): bf16 at the bench shape; f32 much tighter, since
# there kernel and plain differ only in summation order
RENDER_TOL = {
    "bf16": dict(res_med=2e-3, res_p90=4e-3, flip_frac=0.20, relH=0.35, relb=0.45,
                 relH_blk=0.35),
    "f32": dict(res_med=1e-6, res_p90=1e-5, flip_frac=0.01, relH=1e-3, relb=1e-2,
                relH_blk=1e-3),
}


def bench_cfg():
    """The bench solver config (bench.py bench_cfg; its coarse_fused_tr, the
    JAX kernel's ray tile, has no counterpart: the CUDA kernel sizes its own)."""
    from hortimapping_tpu_torch.config import JointOptConfig

    return JointOptConfig(
        scale_on=True, n_fg_pix=200, n_bg_pix=200, n_frame=10,
        n_sample_on_ray=30, recon_n_pts=2000, max_iter=50,
        coarse_to_fine=True, fine_max_iter=2,
        coarse_frame_stride=4, coarse_ray_frac=0.3, coarse_sample_frac=0.35,
        coarse_pts_frac=0.3, coarse_max_iter=8,
        fine_ray_frac=0.6, fine_sample_frac=0.75, fine_pts_frac=0.6,
    )


def cuda_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def chain_macs(pk):
    """Multiply-adds per row of the decoder forward and of its input-grad
    backward."""
    fwd = pk.in_dim * pk.D + pk.n_mid * pk.D * pk.D + pk.D
    bwd = pk.D + pk.n_mid * pk.D * pk.D + pk.D * pk.in_dim
    return fwd, bwd


def weight_bytes(pk):
    el = 2 if pk.bf16 else 4
    fwd, _ = chain_macs(pk)
    return fwd * el + (pk.D * (pk.n_mid + 1) + 1) * 4


def build_batch(spec, cfg, device, n=None):
    """The bench.py batch (synthetic peppers from seed 42) at the
    observation shapes of `cfg`: (observations, pose inits T_ow0, GT surface
    points per fruit)."""
    import numpy as np

    from hortimapping_tpu_torch.optim.state import stack_observations
    from hortimapping_tpu_torch.tools.synthetic import SyntheticCategory, make_scene

    cat = SyntheticCategory(spec=spec, base_radius=0.06)
    rng = np.random.default_rng(42)
    obs_list, T_list, gts = [], [], []
    for b in range(N_FRUITS if n is None else n):
        code = (rng.normal(size=spec.code_length) * 0.3).astype(np.float32)
        T_wo = np.eye(4, dtype=np.float32)
        T_wo[:3, 3] = rng.normal(size=3) * 0.1
        obs, gt = make_scene(cat, code, T_wo, n_frames=cfg.n_frame, n_fg=cfg.n_fg_pix,
                             n_bg=cfg.n_bg_pix, n_points=cfg.recon_n_pts, seed=b)
        obs_list.append(obs)
        T_list.append(np.linalg.inv(T_wo).astype(np.float32))
        gts.append(gt)
    import torch

    T0 = torch.as_tensor(np.stack(T_list)).to(device)
    return stack_observations(obs_list, device), T0, gts


def render_gates(got, want, lane_active, pose_dim):
    """Fused-kernel gate metrics of kernel (got) vs plain (want) outputs:
    residual delta median / p90 / fraction > 1e-3 over the plain version's
    valid rays, the worst relative Frobenius delta of the per-fruit normal
    equations J^T J / n and J^T r / n of each term, and (relH_blk) the worst
    of that delta over the diagonal blocks of J^T J of the translation,
    rotation, scale and latent columns, so that an error confined to the
    small rotation or scale columns (scaled by |p| ~ 0.06 m) cannot hide
    under the larger ones."""
    import torch

    jd_g, jm_g, res_g = got
    jd_w, jm_w, res_w = want
    act = lane_active.reshape(-1)
    ok = (res_w[..., 2] > 0.5) & act[:, None, None]
    J = jd_w.shape[-1]
    blocks = [(0, 3), (3, 6)] + ([(6, 7)] if pose_dim == 7 else []) + [(pose_dim, J)]
    out = dict(res_med=0.0, res_p90=0.0, flip_frac=0.0, relH=0.0, relb=0.0, relH_blk=0.0)
    for k in (0, 1):
        d = (res_g[..., k] - res_w[..., k]).abs()[ok].double()
        out["res_med"] = max(out["res_med"], float(d.median()))
        out["res_p90"] = max(out["res_p90"], float(torch.quantile(d, 0.9)))
        out["flip_frac"] = max(out["flip_frac"], float((d > 1e-3).double().mean()))
    for b in torch.nonzero(act).reshape(-1).tolist():
        okb = ok[b]
        n = max(int(okb.sum()), 1)
        for k, jg, jw in ((0, jd_g, jd_w), (1, jm_g, jm_w)):
            Jg, Jw = jg[b][okb].double(), jw[b][okb].double()
            rg, rw = res_g[b][okb][:, k].double(), res_w[b][okb][:, k].double()
            Hg, Hw = Jg.T @ Jg / n, Jw.T @ Jw / n
            bg, bw = Jg.T @ rg / n, Jw.T @ rw / n
            out["relH"] = max(out["relH"], float((Hg - Hw).norm() / Hw.norm().clamp_min(1e-30)))
            out["relb"] = max(out["relb"], float((bg - bw).norm() / bw.norm().clamp_min(1e-12)))
            for s, e in blocks:
                dH, Hb = Hg[s:e, s:e] - Hw[s:e, s:e], Hw[s:e, s:e]
                out["relH_blk"] = max(out["relH_blk"],
                                      float(dH.norm() / Hb.norm().clamp_min(1e-30)))
    return out


def bound(nbytes: float, flops: float, peak: float):
    """(bound ms, what bounds it) for the given bytes and operations."""
    t_bytes, t_ops = nbytes / H100_HBM_BYTES_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, "operations" if t_ops > t_bytes else "bytes"


def check_mlp(phase, pk32, table, lanes, rows_per_lane, dev, x=None):
    """B1 in f32 vs its plain version in the form the LM launches it: inputs
    [lanes, rows_per_lane, C+3] (one code of the latent table a lane, points
    at fruit scale; or the rows `x` a path gives it) with two frozen lanes;
    timed, with its bound over the active lanes' rows, and beside the same
    rows as one flat launch without a mask."""
    import torch

    from hortimapping_tpu_torch.ops import mlp_kernels

    if x is None:
        gen = torch.Generator(device=dev).manual_seed(0)
        codes = table[torch.randint(0, table.shape[0], (lanes,), generator=gen, device=dev)]
        xyz = torch.randn(lanes, rows_per_lane, 3, generator=gen, device=dev) * 0.06
        x = torch.cat([codes[:, None].expand(lanes, rows_per_lane, codes.shape[1]), xyz],
                      dim=-1).contiguous()
    active = torch.ones(lanes, dtype=torch.bool, device=dev)
    active[[5, 17 % lanes]] = False  # frozen lanes exercise the skip
    s_k, g_k = mlp_kernels.mlp_sdf_and_input_grad(pk32, x, active)
    s_p, g_p = mlp_kernels.mlp_sdf_and_input_grad_plain(pk32, x, active)
    s_2, g_2 = mlp_kernels.mlp_sdf_and_input_grad(pk32, x, active)
    torch.cuda.synchronize()
    assert torch.equal(s_k, s_2) and torch.equal(g_k, g_2), (phase, "B1 differs between launches")
    assert not s_k[~active].any() and not g_k[~active].any(), (phase, "frozen lanes not zero")
    err_s = float((s_k - s_p).abs().max())
    err_g = float((g_k - g_p).abs().max())
    g_scale = float(g_p.abs().max())
    # f32 on both sides, sums of up to 512 products in another order
    assert err_s <= 1e-5 and err_g <= 1e-4 * g_scale, (phase, err_s, err_g, g_scale)
    ms = cuda_ms(lambda: mlp_kernels.mlp_sdf_and_input_grad(pk32, x, active), 20)
    plain_ms = cuda_ms(lambda: mlp_kernels.mlp_sdf_and_input_grad_plain(pk32, x, active), 5)
    flat = x.reshape(-1, x.shape[-1])
    flat_ms = cuda_ms(lambda: mlp_kernels.mlp_sdf_and_input_grad(pk32, flat), 20)
    n_act = int(active.sum()) * rows_per_lane
    fwd, bwd = chain_macs(pk32)
    flops = 2.0 * (fwd + bwd) * n_act
    nbytes = (n_act * pk32.in_dim + lanes * rows_per_lane * (pk32.in_dim + 1) + lanes) * 4
    bound_ms, bound_by = bound(nbytes + weight_bytes(pk32), flops, H100_F32_FLOPS)
    # blocks of 64 rows: each lane rounded up to whole clusters, frozen lanes
    # exit at once; the card holds `wave` blocks at a time
    wave = mlp_kernels.CLUSTER * mlp_kernels.wave_and_smem("mlp_fwd_grad", pk32)[0]
    assert wave > 0, (phase, "no block fits on a SM", wave)
    per_lane = -(-rows_per_lane // (64 * mlp_kernels.CLUSTER)) * mlp_kernels.CLUSTER
    blocks = int(active.sum()) * per_lane
    flat_blocks = -(-lanes * rows_per_lane // (64 * mlp_kernels.CLUSTER)) * mlp_kernels.CLUSTER
    print(f"B1 mlp_fwd_grad vs plain, {phase} SDF term: {lanes} lanes x {rows_per_lane} rows "
          f"f32, 2 frozen | max|d sdf| {err_s:.3g} max|d grad| {err_g:.3g} (of {g_scale:.3g}), "
          f"frozen lanes zero | kernel {ms:.3f} ms ({flops / ms / 1e9:.1f} TFLOP/s; {blocks} active "
          f"blocks of {per_lane * lanes}, {blocks / wave:.2f} waves of {wave}), plain "
          f"{plain_ms:.3f} ms, bound {bound_ms:.3f} ms ({bound_by}, f32 CUDA-core peak) | the "
          f"{lanes * rows_per_lane} rows as one flat launch without a mask {flat_ms:.3f} ms "
          f"({flat_blocks} blocks, {flat_blocks / wave:.2f} waves) | no single PyTorch call",
          flush=True)
    return dict(x=x, err=max(err_s, err_g), ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by)


def check_render(phase, pk16, pk32, sub_obs, sub_cfg, latent, T_ow, dev,
                 cube_radius=CUBE_RADIUS):
    """B2 vs its plain version at one LM phase's render shape (its
    subsampled observations and config, the path's cube radius) with two
    frozen lanes: bf16 under the fused-kernel gate, and a small f32 slice
    under the tight one; timed, with its bound."""
    import torch

    from hortimapping_tpu_torch.ops import mlp_kernels, render_kernel
    from hortimapping_tpu_torch.ops.render import sample_points
    from hortimapping_tpu_torch.optim.lm import render_geometry

    T_oc, depths, bbx = render_geometry(sub_cfg, sub_obs, T_ow, cube_radius)
    pts = sample_points(sub_obs.rays, depths, T_oc).contiguous()
    is_fg = torch.arange(sub_cfg.n_rays, device=dev) < sub_cfg.n_fg_pix
    ray_valid = sub_obs.ray_valid & sub_obs.frame_valid[..., None]
    B = latent.shape[0]
    lane_active = torch.ones(B, dtype=torch.bool, device=dev)
    lane_active[[5, 17 % B]] = False  # frozen lanes exercise the skip
    rkw = dict(pose_dim=sub_cfg.pose_dim, scale_on=sub_cfg.scale_on,
               log_occ_on=sub_cfg.log_sdf_occ, occ_cutoff=sub_cfg.occ_cutoff_m,
               occlusion_on=sub_cfg.occlusion_on, occlusion_th=0.03, min_grad_th=1e-6)
    rargs = (latent, pts, sub_obs.depth_obs, is_fg, ray_valid, depths, bbx, lane_active)
    stats = {}
    want = render_kernel.fused_render_plain(pk16, *rargs, stats=stats, **rkw)
    got = render_kernel.fused_render(pk16, *rargs, **rkw)
    again = render_kernel.fused_render(pk16, *rargs, **rkw)
    torch.cuda.synchronize()
    assert all(torch.equal(g, a) for g, a in zip(got, again)), (phase, "B2 differs between launches")
    for t in got:
        assert bool(torch.isfinite(t).all())
    assert float(got[2][~lane_active].abs().max()) == 0.0
    gates = render_gates(got, want, lane_active, sub_cfg.pose_dim)
    tol = RENDER_TOL["bf16"]
    assert all(gates[k] <= tol[k] for k in tol), (phase, gates, tol)
    # small f32 case, tight: 2 fruits x 2 frames x 64 rays of the same inputs
    sl, nr = slice(0, 2), min(64, pts.shape[2])
    small = (latent[sl], pts[sl, :2, :nr].contiguous(), sub_obs.depth_obs[sl, :2, :nr],
             is_fg[:nr], ray_valid[sl, :2, :nr], depths[sl, :2], bbx[sl, :2], lane_active[sl])
    g32 = render_kernel.fused_render(pk32, *small, **rkw)
    w32 = render_kernel.fused_render_plain(pk32, *small, **rkw)
    torch.cuda.synchronize()
    gates32 = render_gates(g32, w32, lane_active[sl], sub_cfg.pose_dim)
    assert all(gates32[k] <= RENDER_TOL["f32"][k] for k in RENDER_TOL["f32"]), (phase, gates32)
    ms = cuda_ms(lambda: render_kernel.fused_render(pk16, *rargs, **rkw), 5)
    plain_ms = cuda_ms(lambda: render_kernel.fused_render_plain(pk16, *rargs, **rkw), 2)
    # the three launches timed apart on the same inputs
    rl = render_kernel.render_forward(pk16, *rargs, **rkw)
    offsets = render_kernel.band_offsets(rl.counts)
    cd, cm = render_kernel.render_band(pk16, latent, rl, offsets, sub_cfg.pose_dim)
    split = dict(
        fwd=cuda_ms(lambda: render_kernel.render_forward(pk16, *rargs, **rkw), 5),
        scan=cuda_ms(lambda: render_kernel.band_offsets(rl.counts), 5),
        band=cuda_ms(lambda: render_kernel.render_band(pk16, latent, rl, offsets,
                                                       sub_cfg.pose_dim), 5),
        sum=cuda_ms(lambda: render_kernel.render_sum(rl, offsets, cd, cm), 5))
    total = int(offsets[-1])  # for the line below; the path never reads it on the host
    chunks = -(-total // 64)
    n_chunks = -(-chunks // mlp_kernels.CLUSTER) * mlp_kernels.CLUSTER
    fwd, bwd = chain_macs(pk16)
    flops = 2.0 * (fwd * stats["active_samples"] + bwd * stats["band_samples"])
    _, F, R, M, _ = pts.shape
    J = sub_cfg.pose_dim + latent.shape[1]
    nbytes = (pts.numel() * 4 + B * F * R * (4 + 1) + R + depths.numel() * 4 + bbx.numel() * 4
              + latent.numel() * 4 + B + weight_bytes(pk16) + B * F * R * (2 * J + 4) * 4)
    bound_ms, bound_by = bound(nbytes, flops, H100_BF16_FLOPS)
    fmt = lambda d: "{" + ", ".join(f"{k} {v:.3g}" for k, v in d.items()) + "}"
    print(f"B2 fused_render vs plain, {phase} phase: B={B} F={F} R={R} M={M} (rays a tile "
          f"{render_kernel.ray_tile(pk16, latent.shape[1], sub_cfg.pose_dim, M)}) bf16 "
          f"{fmt(gates)} (gates {fmt(tol)}) | f32 small {fmt(gates32)} | bit-equal across two "
          f"launches | kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound {bound_ms:.3f} ms "
          f"({bound_by}, bf16 tensor peak; {stats['active_samples']} samples fwd, "
          f"{stats['band_samples']} band samples bwd) | no single PyTorch call", flush=True)
    print(f"  B2 launches, {phase}: forward + render {split['fwd']:.3f} ms | scan of the band "
          f"counts {split['scan']:.3f} ms | band backward {split['band']:.3f} ms over {total} "
          f"band rows in {chunks} chunks of 64 (fill {total / max(64 * n_chunks, 1):.3f} of the "
          f"{n_chunks} chunks run, one wave of clusters of {mlp_kernels.CLUSTER} taking them in "
          f"turn) | per-ray sums {split['sum']:.3f} ms | scratch: band records "
          f"{rl.recs.numel() * 4 / 1e6:.1f} MB, contributions {(cd.numel() + cm.numel()) * 4 / 1e6:.1f}"
          f" MB (room for every sample)", flush=True)
    return dict(err=max(float((g - w).abs().max()) for g, w in zip(got, want)), ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, split=split)


def wave_schedule(name: str, pk, chunks: int, ms: float) -> str:
    """The schedule of a forward-only launch (B3 `mlp_fwd`, B4
    `mlp_shared_latent`) of `chunks` 64-row chunks, as the kernel computes
    it: one wave of clusters of CLUSTER blocks, chunk pair g to cluster g
    mod the clusters launched; the dynamic shared memory of a block in pk's
    type; the weight bytes read from L2 at `ms`, modelled (once per chunk
    pair, multicast to the cluster), not counted."""
    from hortimapping_tpu_torch.ops import mlp_kernels

    wave, smem = mlp_kernels.wave_and_smem(name, pk)
    assert wave > 0, (name, "no block fits on a SM", wave)
    pairs = -(-chunks // mlp_kernels.CLUSTER)
    clusters = min(wave, pairs)
    return (f"{chunks} chunks of 64 rows in {pairs} pairs, one wave of {wave} clusters of "
            f"{mlp_kernels.CLUSTER} ({clusters} launched) taking {pairs // clusters}-"
            f"{-(-pairs // clusters)} pairs each | dynamic smem a block {smem} B "
            f"({'bf16' if pk.bf16 else 'f32'}) | "
            f"weights read from L2 at {pairs * weight_bytes(pk) / ms / 1e9:.2f} TB/s (modelled "
            f"traffic: once per chunk pair)")


def fwd_bound(pk, n_rows: int, in_bytes: float, out_bytes: float):
    """(flops, bound ms, what bounds it) of a forward over n_rows rows."""
    flops = 2.0 * chain_macs(pk)[0] * n_rows
    peak = H100_BF16_FLOPS if pk.bf16 else H100_F32_FLOPS
    return (flops, *bound(in_bytes + out_bytes + weight_bytes(pk), flops, peak))


def check_fwd(phase, pk, codes, pts, valid, clamp):
    """B3 vs its plain version on the scoring rows of one retrieval launch:
    every code of `codes` [N, C] against every point set of `pts` [G, P, 3].
    f32 is held to max |d sdf| <= 1e-5. bf16 feeds a ranking: the tensor
    cores sum in another order than the plain version, so an activation now
    and then rounds one bf16 ulp the other way; it is held by the median and
    p99 of |d sdf| and by the code each point set retrieves (the argmin of
    the mean clamped |sdf|, as `_score_codes`), never by the maximum."""
    import torch

    from hortimapping_tpu_torch.ops import mlp_kernels

    N, C = codes.shape
    G, P, _ = pts.shape
    x = torch.cat([codes[None, :, None, :].expand(G, N, P, C),
                   pts[:, None].expand(G, N, P, 3)], dim=-1).reshape(-1, C + 3).contiguous()
    got = mlp_kernels.mlp_sdf(pk, x)
    want = mlp_kernels.mlp_sdf_plain(pk, x)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    d = (got - want).abs()
    err = float(d.max())
    med, p99 = float(d.median()), float(torch.quantile(d, 0.99))

    def scores(sdf):
        e = torch.clamp(sdf.abs().reshape(G, N, P), max=clamp)
        return (e * valid[:, None, :]).sum(-1) / valid.sum(-1).clamp(min=1)[:, None]

    s_got, s_want = scores(got), scores(want)
    k_got, k_want = s_got.argmin(1), s_want.argmin(1)
    ar = torch.arange(G, device=x.device)
    score_gap = float((s_want[ar, k_got] - s_want[ar, k_want]).abs().max())
    n_same = int((k_got == k_want).sum())
    if pk.bf16:
        gates = dict(med=B3_BF16_GATE["med"], p99=B3_BF16_GATE["p99"], score=B3_BF16_GATE["score"])
        assert med <= gates["med"] and p99 <= gates["p99"], (phase, med, p99)
        assert score_gap <= gates["score"], (phase, n_same, score_gap)
        gate_s = (f"median {med:.3g} p99 {p99:.3g} max {err:.3g} (gates median {gates['med']}, "
                  f"p99 {gates['p99']}) | top-1 code equal for {n_same}/{G} point sets, worst plain-"
                  f"score gap of the two picks {score_gap:.3g} (gate {gates['score']})")
    else:
        assert err <= 1e-5 and n_same == G, (phase, err, n_same)
        gate_s = f"max {err:.3g} (gate 1e-5) | top-1 code equal for {n_same}/{G} point sets"
    ms = cuda_ms(lambda: mlp_kernels.mlp_sdf(pk, x), 10)
    plain_ms = cuda_ms(lambda: mlp_kernels.mlp_sdf_plain(pk, x), 3)
    rows = x.shape[0]
    flops, bound_ms, bound_by = fwd_bound(pk, rows, rows * pk.in_dim * 4, rows * 4)
    mode = "bf16" if pk.bf16 else "f32"
    print(f"B3 mlp_fwd vs plain, {phase} scoring: {G} point sets x {N} codes x {P} points = "
          f"{rows} rows {mode} | |d sdf| {gate_s} | kernel {ms:.3f} ms ({flops / ms / 1e9:.1f} "
          f"TFLOP/s), plain {plain_ms:.3f} ms, bound {bound_ms:.3f} ms ({bound_by}, "
          f"{'bf16 tensor' if pk.bf16 else 'f32 CUDA-core'} peak) | no single PyTorch call | "
          f"{wave_schedule('mlp_fwd', pk, -(-rows // 64), ms)}", flush=True)
    return dict(err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)


def surface_distances(pk32, meshes, latents):
    """Per-vertex distance of the meshes to the decoder's zero level set:
    |sdf| from the plain f32 decoder over the norm of its xyz gradient (B1,
    f32), as tests/test_native_meshing.py bounds it. Vertices are in the
    object frame at cube-radius scale, the decoder's input coordinates."""
    import torch

    from hortimapping_tpu_torch.ops import mlp_kernels

    dev = latents.device
    C = latents.shape[1]
    rows = torch.cat([torch.cat([lat.expand(m.vertices.shape[0], C),
                                 torch.as_tensor(m.vertices).to(dev)], dim=1)
                      for lat, m in zip(latents, meshes)])
    sdf = mlp_kernels.mlp_sdf_plain(pk32, rows)
    _, g = mlp_kernels.mlp_sdf_and_input_grad(pk32, rows)
    return sdf.abs() / torch.linalg.norm(g[:, C:], dim=1).clamp_min(1e-6)


def check_shared_latent(phase, params, spec, pk16, pk32, latents, dev, surface=True,
                        voxels=VOXELS, cube_radius=CUBE_RADIUS):
    """B4 vs its plain version on the mesher's grid (voxels^3 points under
    each of `latents`), launched on the mesher's `decode_chunk` codes at a
    time as the mesher launches it: f32 held to max |d sdf| <= 1e-5, bf16 to the median
    and p99 of |d sdf| (B4_BF16_GATE; a sign flip near zero moves a vertex by
    a fraction of a voxel, so never to a per-point maximum). With `surface`,
    the mesher's grid of each mode and the plain version's grid are meshed
    and their vertex distance to the plain f32 decoder's zero level set is
    measured; the mesher's mode must pass the surface gate (p95 < 0.35
    voxel, p99.9 < 1 voxel), and the plain grid of the same mode shows what
    of that distance is the mode's precision."""
    import torch

    from hortimapping_tpu_torch.ops import mlp_kernels
    from hortimapping_tpu_torch.ops.mesher import MeshExtractor

    B = latents.shape[0]
    voxel = 2.0 * cube_radius / (voxels - 1)
    default = MeshExtractor(params, spec, voxels_dim=voxels, cube_radius=cube_radius, device=dev)
    mesher_mode = "bf16" if default.packed is not None and default.packed.bf16 else "f32"
    out, surf = {}, {}

    def surface_quantiles(mesher, grids):
        meshes = mesher.meshes_from_grids(grids)
        assert all(m.faces.shape[0] > 100 for m in meshes)
        dist = surface_distances(pk32, meshes, latents) / voxel
        return (*(float(torch.quantile(dist, q)) for q in (0.95, 0.999)), dist.numel())

    for mode, pk in (("f32", pk32), ("bf16", pk16)):
        mesher = MeshExtractor(params, spec, voxels_dim=voxels, cube_radius=cube_radius,
                               bf16=pk.bf16, device=dev)
        pts = mesher.voxel_points
        chunks = [latents[lo:lo + mesher.decode_chunk]
                  for lo in range(0, B, mesher.decode_chunk)]
        kernel = lambda: torch.cat([mlp_kernels.mlp_sdf_shared_latent(pk, c, pts) for c in chunks])
        plain = lambda: torch.cat([mlp_kernels.mlp_sdf_shared_latent_plain(pk, c, pts)
                                   for c in chunks])
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        assert bool(torch.isfinite(got).all())
        d = (got - want).abs()
        err, med = float(d.max()), float(d.median())
        p99 = float(torch.quantile(d.reshape(-1), 0.99))
        if pk.bf16:
            assert med <= B4_BF16_GATE["med"] and p99 <= B4_BF16_GATE["p99"], (phase, med, p99)
            gate_s = f"(gates median {B4_BF16_GATE['med']}, p99 {B4_BF16_GATE['p99']})"
        else:
            assert err <= 1e-5, (phase, err)
            gate_s = "(gate max 1e-5)"
        surf_s = ""
        if surface:
            surf[mode] = surface_quantiles(mesher, mesher.decode_grids(latents))
            p95_p, p999_p, _ = surface_quantiles(mesher, want.to(torch.float16))
            surf_s = (f" | surface: vertex distance p95 {surf[mode][0]:.4f} p99.9 "
                      f"{surf[mode][1]:.4f} voxel over {surf[mode][2]} vertices (plain {mode} "
                      f"grid: p95 {p95_p:.4f} p99.9 {p999_p:.4f})")
        ms = cuda_ms(kernel, 5)
        plain_ms = cuda_ms(plain, 2)
        rows = B * pts.shape[0]
        n0 = chunks[0].shape[0]
        first_launch = wave_schedule("mlp_shared_latent", pk, n0 * -(-pts.shape[0] // 64),
                                     ms * n0 / B)
        flops, bound_ms, bound_by = fwd_bound(pk, rows, pts.numel() * 4 + latents.numel() * 4,
                                              rows * 4)
        out[mode] = dict(err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)
        print(f"B4 mlp_shared_latent vs plain, {phase} grid, {mode}: {B} codes x {voxels}^3 points "
              f"= {rows} rows, in launches of {[c.shape[0] for c in chunks]} codes | |d sdf| "
              f"median {med:.3g} p99 {p99:.3g} max {err:.3g} {gate_s}"
              f"{surf_s} | kernel {ms:.3f} ms ({flops / ms / 1e9:.1f} TFLOP/s), plain "
              f"{plain_ms:.3f} ms, bound {bound_ms:.3f} ms ({bound_by}, "
              f"{'bf16 tensor' if pk.bf16 else 'f32 CUDA-core'} peak) | no single PyTorch call | "
              f"first launch (its time pro rata by codes): {first_launch}",
              flush=True)
    if surface:
        p95, p999, _ = surf[mesher_mode]
        assert p95 < 0.35 and p999 < 1.0, (mesher_mode, surf)
        print(f"B4 surface gate ({mesher_mode}, the mesher's mode): p95 {p95:.4f} < 0.35 voxel, "
              f"p99.9 {p999:.4f} < 1 voxel", flush=True)
    return out[mesher_mode]


@contextlib.contextmanager
def no_lane_skip():
    """The SDF term of the LM without its frozen-lane skip (every lane
    decoded), as before the skip existed."""
    from hortimapping_tpu_torch.optim import lm

    orig = lm.sdf_residuals
    lm.sdf_residuals = lambda *a, **k: orig(*a[:7])
    try:
        yield
    finally:
        lm.sdf_residuals = orig


def profile_main(run, smi, path: str, label: str) -> None:
    """Trace one batch of a path with torch.profiler: its device-time table
    is appended to `path`, one summary line goes to stdout."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    dev_us = sum(e.self_device_time_total for e in events if e.device_type == DeviceType.CUDA)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "a") as f:
        f.write(f"==== {label}: {smi}\nwall {wall * 1e3:.1f} ms, device busy "
                f"{dev_us / 1e3:.1f} ms\n")
        f.write(events.table(sort_by="self_cuda_time_total", row_limit=40) + "\n")
    print(f"profile, {label}: one traced batch {wall * 1e3:.1f} ms wall, kernels busy "
          f"{dev_us / 1e3:.1f} ms (device idle share {1 - dev_us / 1e3 / (wall * 1e3):.3f}; "
          f"table in {path})", flush=True)


class LaunchCounts:
    """The four kernels' launch counters: set to 0 when made, read by
    `read` after the run they count."""

    ALL = ("mlp_fwd_grad", "fused_render", "mlp_fwd", "mlp_shared_latent")

    def __init__(self):
        from hortimapping_tpu_torch.ops import mlp_kernels, render_kernel

        mlp_kernels.launches = mlp_kernels.launches_fwd = mlp_kernels.launches_shared_latent = 0
        render_kernel.launches = render_kernel.launches_band = render_kernel.launches_sum = 0
        self.n = {}
        self.b2 = {}

    def read(self) -> None:
        from hortimapping_tpu_torch.ops import mlp_kernels, render_kernel

        self.n = dict(mlp_fwd_grad=mlp_kernels.launches, fused_render=render_kernel.launches,
                      mlp_fwd=mlp_kernels.launches_fwd,
                      mlp_shared_latent=mlp_kernels.launches_shared_latent)
        self.b2 = dict(band=render_kernel.launches_band, sums=render_kernel.launches_sum)

    def require(self, names, path: str) -> None:
        assert all(self.n[k] > 0 for k in names), (path, self.n)
        # B2's band backward and per-ray sums are kernels of the path too
        assert "fused_render" not in names or min(self.b2.values()) > 0, (path, self.b2)

    def __str__(self) -> str:
        return (", ".join(f"{k} {v}" for k, v in self.n.items())
                + f" (B2's band backward {self.b2['band']}, per-ray sums {self.b2['sums']})")


class Stages:
    """Host time of the stages of one warm-started batch (or of the
    functions `targets` names: (stage, owner, attribute)): the outermost call
    of each wrapped function, closed by a synchronize, summed over its calls.
    The stages nest (the rescue's re-retrieval and multi-start count under
    the rescue); what no stage covers is `rest`."""

    def __init__(self, targets=None):
        from hortimapping_tpu_torch.ops.mesher import MeshExtractor
        from hortimapping_tpu_torch.optim import lm, warmstart

        self.targets = targets or (("retrieval", warmstart, "_retrieve"),
                                   ("main LM", lm, "solve_in_chunks"),
                                   ("objective + rescue", warmstart, "selective_rescue"),
                                   ("grid decode", MeshExtractor, "decode_grids"),
                                   ("host meshing", MeshExtractor, "meshes_from_grids"))
        self.t = {}
        self._depth = 0

    def _wrap(self, name, fn):
        import torch

        def timed(*a, **k):
            if self._depth:
                return fn(*a, **k)
            self._depth += 1
            t0 = time.perf_counter()
            try:
                out = fn(*a, **k)
                torch.cuda.synchronize()
            finally:
                self._depth -= 1
            self.t[name] = self.t.get(name, 0.0) + time.perf_counter() - t0
            return out

        return timed

    @contextlib.contextmanager
    def timing(self):
        self.t = {}
        saved = [(owner, attr, getattr(owner, attr)) for _, owner, attr in self.targets]
        for name, owner, attr in self.targets:
            setattr(owner, attr, self._wrap(name, getattr(owner, attr)))
        try:
            yield
        finally:
            for owner, attr, fn in saved:
                setattr(owner, attr, fn)

    def split(self) -> dict:
        out = {name: self.t.get(name, 0.0) for name, _, _ in self.targets}
        out["rest"] = self.t["batch"] - sum(out.values())
        return out


@contextlib.contextmanager
def plain_versions():
    """Every kernel swapped for its plain PyTorch version, on the card."""
    from hortimapping_tpu_torch.ops import mlp_kernels, render_kernel

    swaps = ((mlp_kernels, "_fwd_grad_cuda", mlp_kernels._fwd_grad_plain),
             (render_kernel, "_fused_render_cuda", render_kernel.fused_render_plain),
             (mlp_kernels, "_fwd_cuda", mlp_kernels.forward_plain),
             (mlp_kernels, "_shared_latent_cuda", mlp_kernels.shared_latent_plain))
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    for mod, name, fn in swaps:
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def inverse_poses(res):
    """T_wo of each fruit (host, f64) from the solved T_ow."""
    import numpy as np

    return np.linalg.inv(res.T_ow.double().cpu().numpy())


def check_result(res, meshes, n: int, C: int) -> None:
    import torch

    assert not bool(res.failed.any())
    assert bool(torch.isfinite(res.latent).all()) and bool(torch.isfinite(res.T_ow).all())
    assert res.latent.shape == (n, C) and len(meshes) == n
    assert all(m.faces.shape[0] > 100 for m in meshes)


def mean_cd_mm(meshes, gts, dev) -> float:
    """Mean Chamfer-L1 (mm) of world-frame meshes (100k area-weighted
    samples each) against the GT surface points."""
    import numpy as np
    import torch

    from hortimapping_tpu_torch.metrics.chamfer import chamfer_distance

    g = torch.Generator(device=dev).manual_seed(1)
    return float(np.mean([chamfer_distance(torch.as_tensor(gt).to(dev),
                                           m.sample_points_on_device(100_000, g, dev))
                          for m, gt in zip(meshes, gts)])) * 1e3


def wild_path(params, spec, table, pk16, pk32, smi, dev, profile=None, n_fruits=N_FRUITS,
              size=WILD_SIZE, n_frames=WILD_FRAMES, reps=3,
              deepsdf_dir=os.path.join(ROOT, "assets", "synthetic_pepper_32")):
    """Phase 9, the wild path: a BUP20-like row of `n_fruits` fruits written
    to a temporary directory by the port's generator, B1 and B2 (and B3 and
    B4 where the path's batch is not N_FRUITS) against their plain versions
    on the path's own observations, `run_wild_completion` on
    configs/wild_pepper_tpu.yaml timed with its split and launch counts, a
    resumed run, and the functional gate against the GT ellipsoids."""
    import collections
    import tempfile

    import numpy as np
    import torch

    from hortimapping_tpu_torch.config import JointOptConfig, load_config
    from hortimapping_tpu_torch.data.mesh import PointCloud, TriangleMesh
    from hortimapping_tpu_torch.data.ply import read_mesh
    from hortimapping_tpu_torch.ops.mesher import MeshExtractor
    from hortimapping_tpu_torch.optim.lm import _subsample, subsample_observations
    from hortimapping_tpu_torch.optim.state import stack_observations
    from hortimapping_tpu_torch.optim.warmstart import maybe_retrieval_init
    from hortimapping_tpu_torch.pipeline import wild
    from hortimapping_tpu_torch.tools import make_demo_data as gen
    from hortimapping_tpu_torch.utils.misc import set_random_seed

    t_phase = time.perf_counter()
    cfg = load_config(os.path.join(ROOT, "configs", WILD_YAML))
    cfg["deepsdf_dir"] = deepsdf_dir
    cfg["vis"]["log_on"] = False
    min_valid = int(np.ceil(WILD_MIN_VALID * n_fruits))
    opt_cfg = JointOptConfig.from_dict(cfg)
    assert opt_cfg.fused_bf16  # the render kernel runs bf16 here, as check_render holds it
    C = spec.code_length
    W, H = size
    quiet = lambda *a: None
    with tempfile.TemporaryDirectory(prefix="chip_smoke_wild_") as scene:
        cfg["data_dir"] = scene
        cfg["cam_info_path"] = os.path.join(scene, "cam_info.yaml")

        # 1. the scene: fruits drawn as make_demo_data.main draws them, at
        # its 0.12 m spacing, a camera driving along the row
        cat, base_radius = gen.category(cfg["deepsdf_dir"])
        proj = cat.projection()
        T_wos, codes = gen.draw_fruits(np.random.default_rng(WILD_SEED), n_fruits, C)
        x_end = 0.12 * (n_fruits - 1) / 2
        t0 = time.perf_counter()
        nbytes = gen.write_scene(scene, T_wos, codes, proj, base_radius,
                                 gen.row_poses(n_frames, -x_end, x_end, WILD_DISTANCE),
                                 gen.intrinsics(W, H), W, H, wall_half=x_end + 0.6, device=dev)
        render_s = time.perf_counter() - t0
        dirs = np.random.default_rng(1).normal(size=(4096, 3))
        dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
        gts = [((dirs * base_radius * np.exp(proj @ code)) @ T[:3, :3].T + T[:3, 3])
               .astype(np.float32) for T, code in zip(T_wos, codes)]

        # phase 1 of the pipeline once, with its own split: the path's own
        # observation batch
        cam = load_config(cfg["cam_info_path"])
        frames = wild.load_frames(scene, cfg["begin_frame"], cfg["end_frame"], cfg["every_frame"])
        set_random_seed(42)
        p1 = Stages(targets=(("read submaps", wild, "read_mesh"),
                             ("background sampling", TriangleMesh, "sample_points_uniformly"),
                             ("background voxels", PointCloud, "voxel_down_sample"),
                             ("ray sampling", wild, "get_render_data"),
                             ("cleaning", wild, "clean_mesh"),
                             ("pose init", wild, "get_pose_init"),
                             ("packing", wild, "render_data_to_observations")))
        with p1.timing():
            t0 = time.perf_counter()
            prepared, rejected = wild.prepare_submaps(
                cfg, opt_cfg, frames, cam["img_size"],
                np.linalg.inv(np.asarray(cam["intrinsics"])), table.mean(0).cpu().numpy(), set())
            p1.t["batch"] = time.perf_counter() - t0
        B = len(prepared)
        matched = np.array([p.n_matched for p in prepared])
        obs = stack_observations([p.obs for p in prepared], dev)
        slots_off = int((~obs.frame_valid).sum())
        rays_off = int((~(obs.ray_valid & obs.frame_valid[..., None])).sum())
        print(f"wild scene: {n_fruits} fruits, {n_frames} frames {W}x{H} (cut from 63 for the "
              f"phase's time), camera {WILD_DISTANCE} m from the row | rendered and written in {render_s:.1f} s, {nbytes / 1e6:.1f} MB | "
              f"phase 1 prepared {B}/{n_fruits} (rejected: "
              f"{dict(collections.Counter(r.reason for r in rejected))}) | matched frames per "
              f"fruit min {matched.min()} median {np.median(matched):.0f} max {matched.max()} "
              f"(n_frame {opt_cfg.n_frame}) | invalid frame slots {slots_off} of "
              f"{obs.frame_valid.numel()}, invalid rays {rays_off} of {obs.ray_valid.numel()}",
              flush=True)
        print("wild phase 1 split (ms): " + ", ".join(f"{k} {v * 1e3:.1f}"
                                                     for k, v in p1.split().items()), flush=True)
        assert B >= min_valid, (B, [r.reason for r in rejected])
        assert np.median(matched) >= opt_cfg.n_frame and slots_off > 0, (matched, slots_off)

        # 2. the kernels at this path's shapes, on its own observations, at
        # the retrieved codes and poses
        T0 = torch.as_tensor(np.stack([p.T_ow0 for p in prepared]).astype(np.float32)).to(dev)
        lat0 = table.mean(0, keepdim=True).expand(B, C).contiguous()
        lat_r, T_r = maybe_retrieval_init(params, spec, opt_cfg, table, obs, lat0, T0, device=dev)
        for phase, (o, c) in (("wild coarse", subsample_observations(obs, opt_cfg)),
                              ("wild fine", _subsample(obs, opt_cfg, opt_cfg.fine_frame_stride,
                                                       opt_cfg.fine_ray_frac,
                                                       opt_cfg.fine_sample_frac,
                                                       opt_cfg.fine_pts_frac))):
            pts_o = o.points_w @ T_r[:, :3, :3].transpose(1, 2) + T_r[:, None, :3, 3]
            x = torch.cat([lat_r[:, None].expand(B, pts_o.shape[1], C), pts_o], dim=-1)
            check_mlp(phase, pk32, table, B, pts_o.shape[1], dev, x=x.contiguous())
            check_render(phase, pk16, pk32, o, c, lat_r, T_r, dev)
        if B != N_FRUITS:
            P = opt_cfg.retrieval_score_pts
            pts0 = obs.points_w @ T0[:, :3, :3].transpose(1, 2) + T0[:, None, :3, 3]
            check_fwd("wild", pk16 if opt_cfg.retrieval_score_bf16 else pk32, table,
                      pts0[:16, :P], obs.point_valid[:16, :P], spec.clamping_distance)
            check_shared_latent("wild", params, spec, pk16, pk32, lat_r, dev, surface=False)

        # 3. the timed path
        stages = Stages(targets=(("load frames", wild, "load_frames"),
                                 ("phase 1", wild, "prepare_submaps"),
                                 ("solve", wild, "warmstart_solve"),
                                 ("meshing", MeshExtractor, "complete_mesh_batch"),
                                 ("writing", wild, "write_outputs")))

        def run(cfg_):
            with stages.timing():
                t0 = time.perf_counter()
                results = wild.run_wild_completion(cfg_, log=quiet, device=dev)
                torch.cuda.synchronize()
                stages.t["batch"] = time.perf_counter() - t0
            return results

        run(cfg)  # warm-up
        if profile:
            profile_main(lambda: run(cfg), smi, profile, "wild path")
        times, splits = [], []
        for _ in range(reps):
            counts = LaunchCounts()
            results = run(cfg)
            counts.read()
            times.append(stages.t["batch"])
            splits.append(stages.split())
        counts.require(LaunchCounts.ALL, "wild path")
        valid = sorted(r.name for r in results if r.valid)
        solved = [r.iter_count for r in results if r.reason not in ("no valid match", "bbox gate")]
        ms = float(np.median(times)) * 1e3
        med = {k: float(np.median([sp[k] for sp in splits])) * 1e3 for k in splits[0]}
        print(f"wild path: configs/{WILD_YAML} on the row | {ms:.1f} ms a run (median of {reps}: "
              f"{[round(t * 1e3, 1) for t in times]}), {ms / n_fruits:.2f} ms/fruit | valid "
              f"{len(valid)}/{n_fruits}, not valid: "
              f"{dict(collections.Counter(r.reason for r in results if not r.valid))} | mean "
              f"iters {float(np.mean(solved)):.2f} | launches {counts} | {smi}", flush=True)
        print("wild path split (median ms): " + ", ".join(f"{k} {v:.1f}" for k, v in med.items()),
              flush=True)
        assert len(valid) >= min_valid, (len(valid), [(r.name, r.reason) for r in results])
        meshes_k = {n: read_mesh(os.path.join(scene, "submaps_complete", n)) for n in valid}

        # 4. resume: every valid fruit skipped, its manifest entry unchanged.
        # A re-run fruit draws other rays than before (the global RNG stream
        # no longer passes the skipped fruits, in both packages), so its
        # entry is the re-run's.
        manifest = os.path.join(scene, "submaps_complete", "manifest.json")
        with open(manifest) as f:
            before = {e["name"]: e for e in json.load(f)}
        again = wild.run_wild_completion(dict(cfg, resume=True), log=quiet, device=dev)
        with open(manifest) as f:
            after = {e["name"]: e for e in json.load(f)}
        redone = sorted(r.name for r in again)
        kept = all(after[n] == before[n] for n in valid)
        updated = all(after[r.name]["valid"] == r.valid and after[r.name]["reason"] == r.reason
                      for r in again)
        print(f"wild resume: {len(valid)} valid fruits skipped, {len(redone)} re-run "
              f"({sum(r.valid for r in again)} now valid) | manifest: valid entries "
              f"{'unchanged' if kept else 'CHANGED'}, {len(after)} entries, "
              f"{'equal' if after == before else 'the re-run entries updated'}", flush=True)
        assert not set(redone) & set(valid) and kept and updated and set(after) == set(before), (
            redone, valid)

        # 5. functional gate: the same scene with every kernel swapped for
        # its plain version, CD to the GT ellipsoids over fruits valid in both
        with plain_versions():
            t0 = time.perf_counter()
            results_p = wild.run_wild_completion(cfg, log=quiet, device=dev)
            t_plain = time.perf_counter() - t0
        valid_p = sorted(r.name for r in results_p if r.valid)
        both = sorted(set(valid) & set(valid_p))
        gt_of = lambda n: gts[int(n.split("_")[0]) - 2]
        cd_k = mean_cd_mm([meshes_k[n] for n in both], [gt_of(n) for n in both], dev)
        cd_p = mean_cd_mm([read_mesh(os.path.join(scene, "submaps_complete", n)) for n in both],
                          [gt_of(n) for n in both], dev)
        gap = cd_k - cd_p
        print(f"wild functional gate: {len(both)} fruits valid in both runs (kernels {len(valid)}:"
              f" {valid}; plain {len(valid_p)}: {valid_p}) | mean CD kernels {cd_k:.4f} mm vs "
              f"plain {cd_p:.4f} mm, gap {gap:+.4f} mm (gate {CD_GATE_MM} mm) | plain run "
              f"{t_plain * 1e3:.1f} ms | wild phase {time.perf_counter() - t_phase:.1f} s",
              flush=True)
        assert len(both) >= min_valid and abs(gap) <= CD_GATE_MM, (both, gap)


def subset_dir(src_split: str, dst_root: str, split: str, names) -> str:
    """A challenge data dir whose split holds links to the fruits `names`
    of `src_split` (the functional gate's subset); returns its root."""
    os.makedirs(os.path.join(dst_root, split), exist_ok=True)
    for n in names:
        os.symlink(os.path.join(src_split, n), os.path.join(dst_root, split, n))
    return dst_root


@contextlib.contextmanager
def capture_solve(module, seen: dict):
    """Within the block, `module.warmstart_solve` records the observations,
    start latents and pose inits it is called with, and its result, into
    `seen`."""
    solve = module.warmstart_solve

    def capture(params, spec, cfg, table, obs, lat0, T0, *a, **k):
        res = solve(params, spec, cfg, table, obs, lat0, T0, *a, **k)
        seen.update(obs=obs, lat0=lat0, T0=T0, res=res)
        return res

    module.warmstart_solve = capture
    try:
        yield
    finally:
        module.warmstart_solve = solve


def challenge_path(params, spec, table, pk16, pk32, smi, dev, profile=None, n_fruits=N_FRUITS,
                   size=CHALLENGE_SIZE, n_frames=CHALLENGE_FRAMES, reps=3, n_gate=N_PATH_GATE,
                   deepsdf_dir=os.path.join(ROOT, "assets", "synthetic_pepper_32")):
    """Phase 10, the ECCV challenge path: a split of `n_fruits` fruits written
    by the port's generator to a temporary directory; B1 (the SDF term and
    the DeepSDF baseline's lanes form), B2, B3 and B4 against their plain
    versions on the path's own observations; `run_challenge` under
    configs/shape_completion_challenge_pepper_tpu.yaml timed with its split,
    its CD and F-score at 5 mm against the generator's GT clouds and the
    four launch counts; the DeepSDF baseline run; the path's functional
    gate at `n_gate` fruits."""
    import tempfile

    import numpy as np
    import torch

    from hortimapping_tpu_torch.config import JointOptConfig, load_config
    from hortimapping_tpu_torch.data.challenge import ShapeCompletionDataset
    from hortimapping_tpu_torch.data.mesh import TriangleMesh
    from hortimapping_tpu_torch.metrics.chamfer import ChamferDistance
    from hortimapping_tpu_torch.metrics.precision_recall import PrecisionRecall
    from hortimapping_tpu_torch.ops.mesher import MeshExtractor
    from hortimapping_tpu_torch.optim.warmstart import maybe_retrieval_init
    from hortimapping_tpu_torch.pipeline import challenge
    from hortimapping_tpu_torch.tools import make_demo_data as gen

    t_phase = time.perf_counter()
    cfg = load_config(os.path.join(ROOT, "configs", CHALLENGE_YAML))
    cfg.update(deepsdf_dir=deepsdf_dir, split="val", run_name="chip_smoke")
    opt_cfg = JointOptConfig.from_dict(cfg)
    assert opt_cfg.fused_bf16  # the render kernel runs bf16 here, as check_render holds it
    C = spec.code_length
    W, H = size
    quiet = lambda *a: None
    with tempfile.TemporaryDirectory(prefix="chip_smoke_challenge_") as root:
        cfg["data_dir"] = root
        t0 = time.perf_counter()
        nbytes = gen.make_challenge_dataset(root, deepsdf_dir, "val", n_fruits, n_frames, W=W,
                                            H=H, device=dev)
        render_s = time.perf_counter() - t0

        # the timed path
        stages = Stages(targets=(
            ("load + depth filter", ShapeCompletionDataset, "__getitem__"),
            ("cleaning", challenge, "clean_pcd"),
            ("ray sampling", challenge, "get_render_data"),
            ("solve", challenge, "warmstart_solve"),
            ("baseline solve", challenge, "shape_opt_deepsdf_batched"),
            ("meshing", MeshExtractor, "complete_mesh_batch"),
            ("metrics: mesh sampling", TriangleMesh, "sample_points_uniformly"),
            ("metrics: Chamfer", ChamferDistance, "update"),
            ("metrics: P/R", PrecisionRecall, "update"),
            ("writing", challenge, "write_mesh")))

        def run(cfg_):
            with stages.timing():
                t0 = time.perf_counter()
                summary = challenge.run_challenge(cfg_, log=quiet, device=dev)
                torch.cuda.synchronize()
                stages.t["batch"] = time.perf_counter() - t0
            return summary

        # the warm-up run hands over the path's own observations
        seen = {}
        with capture_solve(challenge, seen):
            run(cfg)
        obs = seen["obs"]
        B = obs.points_w.shape[0]
        assert B == n_fruits, B
        print(f"challenge split: {n_fruits} fruits x {n_frames} frames {W}x{H} (challenge "
              f"layout: masks, poses, colour, depth .npy, GT clouds) rendered and written in "
              f"{render_s:.1f} s, {nbytes / 1e6:.1f} MB | fused clouds "
              f"{int(obs.point_valid.sum())} of {obs.point_valid.numel()} point slots, "
              f"{int((obs.ray_valid & obs.frame_valid[..., None]).sum())} of "
              f"{obs.ray_valid.numel()} rays", flush=True)

        # the kernels at this path's shapes, on its own observations
        T0 = torch.eye(4, device=dev)[None].repeat(B, 1, 1)
        lat0 = table.mean(0, keepdim=True).expand(B, C).contiguous()
        lat_r, T_r = maybe_retrieval_init(params, spec, opt_cfg, table, obs, lat0, T0, device=dev)
        P = opt_cfg.retrieval_score_pts
        scales = torch.linspace(opt_cfg.retrieval_scale_min, opt_cfg.retrieval_scale_max,
                                opt_cfg.retrieval_n_scales, device=dev)
        S = scales.shape[0]
        G = min(16, B)   # one scoring launch: score_chunk fruits x the scales
        check_fwd("challenge", pk16 if opt_cfg.retrieval_score_bf16 else pk32,
                  table[:(1 << 15) // P],
                  (scales[None, :, None, None] * obs.points_w[:G, None, :P]).reshape(G * S, P, 3),
                  obs.point_valid[:G, None, :P].expand(G, S, P).reshape(G * S, P),
                  spec.clamping_distance)
        check_shared_latent("challenge", params, spec, pk16, pk32, lat_r, dev, surface=False)
        pts_o = obs.points_w @ T_r[:, :3, :3].transpose(1, 2) + T_r[:, None, :3, 3]
        N_pts = pts_o.shape[1]
        check_mlp("challenge", pk32, table, B, N_pts, dev,
                  x=torch.cat([lat_r[:, None].expand(B, N_pts, C), pts_o], dim=-1).contiguous())
        # the DeepSDF baseline's lanes form: the table mean, the pose frozen
        # at identity (points as observed), two lanes finished
        b1_base = check_mlp("challenge DeepSDF baseline", pk32, table, B, N_pts, dev,
                            x=torch.cat([lat0[:, None].expand(B, N_pts, C), obs.points_w],
                                        dim=-1).contiguous())
        b2 = check_render("challenge", pk16, pk32, obs, opt_cfg, lat_r, T_r, dev)

        times, splits = [], []
        for _ in range(reps):
            counts = LaunchCounts()
            summary = run(cfg)
            counts.read()
            times.append(stages.t["batch"])
            splits.append(stages.split())
        counts.require(LaunchCounts.ALL, "challenge path")
        ms = float(np.median(times)) * 1e3
        med = {k: float(np.median([sp[k] for sp in splits])) * 1e3 for k in splits[0]}
        print(f"challenge path: configs/{CHALLENGE_YAML} (init_mode {opt_cfg.init_mode}, "
              f"trust_region {opt_cfg.trust_region}, pose known) on the split | {ms:.1f} ms a run "
              f"(median of {reps}: {[round(t * 1e3, 1) for t in times]}), {ms / B:.2f} ms/fruit | "
              f"solve {summary['timing_s'] * 1e3:.2f} ms/fruit (the summary's timing) | failed "
              f"{summary['failed']} | mean iters {summary['iteration']:.2f} | CD "
              f"{summary['CD[mm]']:.4f} mm, F-score {summary['F-score[%]']:.2f} %, precision "
              f"{summary['Precision[%]']:.2f} %, recall {summary['Recall[%]']:.2f} % at "
              f"{summary['threshold[mm]'] * 1e3:.1f} mm vs the GT clouds | launches {counts} | "
              f"{smi}", flush=True)
        print("challenge path split (median ms): " + ", ".join(
            f"{k} {v:.1f}" for k, v in med.items() if k != "baseline solve"), flush=True)
        if profile:
            profile_main(lambda: challenge.run_challenge(cfg, log=quiet, device=dev), smi, profile,
                         "challenge path")
        assert summary["fruits"] == B and summary["failed"] == 0, summary
        assert np.isfinite(summary["CD[mm]"]) and len(summary["cd_per_fruit_mm"]) == B
        written = sorted(os.listdir(os.path.join(root, "results", "chip_smoke", "val")))
        assert written == sorted(f"{f}.ply" for f in os.listdir(os.path.join(root, "val"))), written

        # the DeepSDF baseline: code-only LM, B1 in its lanes form
        cfg_b = dict(cfg, baseline_name="DeepSDF", run_name="chip_smoke_deepsdf")
        counts = LaunchCounts()
        summary_b = run(cfg_b)
        counts.read()
        counts.require(("mlp_fwd_grad", "mlp_shared_latent"), "challenge DeepSDF baseline")
        print(f"challenge DeepSDF baseline: {stages.t['batch'] * 1e3:.1f} ms a run (solve "
              f"{stages.t.get('baseline solve', 0.0) * 1e3:.1f} ms, {summary_b['timing_s'] * 1e3:.2f}"
              f" ms/fruit) | mean iters {summary_b['iteration']:.2f} | CD "
              f"{summary_b['CD[mm]']:.4f} mm, F-score {summary_b['F-score[%]']:.2f} % | B1 "
              f"launches {counts.n['mlp_fwd_grad']} (all: {counts}) | {smi}", flush=True)
        assert np.isfinite(summary_b["CD[mm]"]) and counts.n["fused_render"] == 0

        # functional gate: the first n_gate fruits, kernels vs plain versions
        names = sorted(os.listdir(os.path.join(root, "val")))[:n_gate]
        gate_root = subset_dir(os.path.join(root, "val"), os.path.join(root, "gate"), "val",
                               names)
        cfg_g = dict(cfg, data_dir=gate_root)
        t0 = time.perf_counter()
        s_k = challenge.run_challenge(dict(cfg_g, run_name="kernels"), log=quiet, device=dev)
        t_k = time.perf_counter() - t0
        with plain_versions():
            t0 = time.perf_counter()
            s_p = challenge.run_challenge(dict(cfg_g, run_name="plain"), log=quiet, device=dev)
            t_p = time.perf_counter() - t0
        gap = s_k["CD[mm]"] - s_p["CD[mm]"]
        print(f"challenge functional gate: B={n_gate}, mean CD kernels {s_k['CD[mm]']:.4f} mm vs "
              f"plain {s_p['CD[mm]']:.4f} mm, gap {gap:+.4f} mm (gate {CD_GATE_MM} mm) | run "
              f"kernels {t_k * 1e3:.1f} ms, plain {t_p * 1e3:.1f} ms | mean iters kernels "
              f"{s_k['iteration']:.2f}, plain {s_p['iteration']:.2f} | challenge phase "
              f"{time.perf_counter() - t_phase:.1f} s", flush=True)
        assert abs(gap) <= CD_GATE_MM, gap
    return dict(b1_baseline=b1_base, b2=b2)


def check_path_kernels(label, params, spec, table, pk16, pk32, opt_cfg, obs, T0, dev,
                       which=("mlp_fwd", "mlp_shared_latent", "mlp_fwd_grad", "fused_render")):
    """B3, B4, B1 and B2 (those of `which`) against their plain versions on
    a path's own observations (a unit-scale retrieval's: one scoring
    launch of up to 16 lanes), at its retrieved codes and poses; returns
    each kernel's check by name."""
    import torch

    from hortimapping_tpu_torch.optim.warmstart import maybe_retrieval_init

    B, C = obs.points_w.shape[0], spec.code_length
    lat0 = table.mean(0, keepdim=True).expand(B, C).contiguous()
    lat_r, T_r = maybe_retrieval_init(params, spec, opt_cfg, table, obs, lat0, T0, device=dev)
    out = {}
    if "mlp_fwd" in which:
        P = opt_cfg.retrieval_score_pts
        G = min(16, B)   # one scoring launch: score_chunk lanes at unit scale
        pts0 = obs.points_w @ T0[:, :3, :3].transpose(1, 2) + T0[:, None, :3, 3]
        out["mlp_fwd"] = check_fwd(label, pk16 if opt_cfg.retrieval_score_bf16 else pk32,
                                   table[:(1 << 15) // P], pts0[:G, :P], obs.point_valid[:G, :P],
                                   spec.clamping_distance)
    if "mlp_shared_latent" in which:
        out["mlp_shared_latent"] = check_shared_latent(label, params, spec, pk16, pk32, lat_r,
                                                       dev, surface=False)
    pts_o = obs.points_w @ T_r[:, :3, :3].transpose(1, 2) + T_r[:, None, :3, 3]
    N_pts = pts_o.shape[1]
    out["mlp_fwd_grad"] = check_mlp(
        label, pk32, table, B, N_pts, dev,
        x=torch.cat([lat_r[:, None].expand(B, N_pts, C), pts_o], -1).contiguous())
    out["fused_render"] = check_render(label, pk16, pk32, obs, opt_cfg, lat_r, T_r, dev)
    return out


def lab_split(names, path: str) -> str:
    """A lab split file listing the fruits `names` under "test"; returns its path."""
    with open(path, "w") as f:
        json.dump({"train": [], "test": list(names)}, f)
    return path


def lab_path(params, spec, table, pk16, pk32, smi, dev, profile=None, n_fruits=N_FRUITS,
             size=CHALLENGE_SIZE, n_frames=LAB_FRAMES, n_single=LAB_SINGLE_FRUITS,
             n_berry=BERRY_FRUITS, berry_frames=BERRY_FRAMES, n_gate=N_PATH_GATE, reps=3,
             deepsdf_dir=os.path.join(ROOT, "assets", "synthetic_pepper_32"),
             berry_dir=os.path.join(ROOT, "assets", "synthetic_berry_32")):
    """Phase 11, the IGG lab path: `n_fruits` peppers in the lab layout
    written by the port's generator; `run_lab_eval` under
    configs/lab_pepper_tpu.yaml multi-frame on all fruits and single-frame
    on the first `n_single`, each timed as the median of `reps` after a
    warm-up with its split, launch counts and CD, and B1, B2, B3 and B4
    held against their plain versions on each run's own observations; the
    multi-frame functional gate at `n_gate` fruits; then `n_berry` berries
    under configs/lab_berry.yaml multi-frame, timed the same way, with B1
    and B2 against their plain versions on the berry run's observations,
    B4 on the berry's 80^3 grid under the surface gate of phase 3, and the
    berry run's functional gate."""
    import tempfile

    import numpy as np
    import torch

    from hortimapping_tpu_torch.config import JointOptConfig, load_config
    from hortimapping_tpu_torch.data.mesh import TriangleMesh
    from hortimapping_tpu_torch.metrics.chamfer import ChamferDistance
    from hortimapping_tpu_torch.metrics.precision_recall import PrecisionRecall
    from hortimapping_tpu_torch.models.workspace import config_decoder, load_latent_vectors
    from hortimapping_tpu_torch.ops import mlp_kernels
    from hortimapping_tpu_torch.ops.mesher import MeshExtractor
    from hortimapping_tpu_torch.pipeline import lab
    from hortimapping_tpu_torch.tools import make_demo_data as gen

    t_phase = time.perf_counter()
    cfg = load_config(os.path.join(ROOT, "configs", LAB_YAML))
    cfg.update(deepsdf_dir=deepsdf_dir, run_name="chip_smoke_lab")
    cfg["vis"]["log_on"] = False
    opt_cfg = JointOptConfig.from_dict(cfg)
    assert opt_cfg.fused_bf16  # the render kernel runs bf16 here, as check_render holds it
    assert opt_cfg.retrieval_n_scales == 1
    W, H = size
    quiet = lambda *a: None
    with tempfile.TemporaryDirectory(prefix="chip_smoke_lab_") as root:
        pepper, berry = os.path.join(root, "pepper"), os.path.join(root, "berry")
        t0 = time.perf_counter()
        nbytes = gen.make_lab_dataset(pepper, deepsdf_dir, n_fruits, n_frames, W, H, device=dev)
        render_s = time.perf_counter() - t0
        names = [f"fruit_{k:02d}" for k in range(n_fruits)]
        cfg.update(data_dir=pepper, split=os.path.join(pepper, "split.json"))

        stages = Stages(targets=(
            ("load + preprocess", lab, "prepare_lab_instances"),
            ("solve", lab, "warmstart_solve"),
            ("meshing", MeshExtractor, "complete_mesh_batch"),
            ("metrics: mesh sampling", TriangleMesh, "sample_points_uniformly"),
            ("metrics: Chamfer", ChamferDistance, "update"),
            ("metrics: P/R", PrecisionRecall, "update")))

        def run(cfg_, multi, label, need=LaunchCounts.ALL):
            """A warm-up, then `reps` timed runs; returns the last summary
            and what its solve was given and gave."""
            seen = {}
            lab.run_lab_eval(cfg_, multi, log=quiet, device=dev)
            times, splits = [], []
            with capture_solve(lab, seen):
                for _ in range(reps):
                    counts = LaunchCounts()
                    with stages.timing():
                        t0 = time.perf_counter()
                        summary = lab.run_lab_eval(cfg_, multi, log=quiet, device=dev)
                        torch.cuda.synchronize()
                        stages.t["batch"] = time.perf_counter() - t0
                    counts.read()
                    times.append(stages.t["batch"])
                    splits.append(stages.split())
            counts.require(need, label)
            n = summary["frames"]
            ms = float(np.median(times)) * 1e3
            med = {k: float(np.median([sp[k] for sp in splits])) * 1e3 for k in splits[0]}
            print(f"{label}: {n} instances | {ms:.1f} ms a run (median of {reps} after a warm-up: "
                  f"{[round(t * 1e3, 1) for t in times]}), {ms / n:.2f} ms an instance | solve "
                  f"{summary['timing_s'] * 1e3:.2f} ms an instance (the summary's timing) | mean "
                  f"iters {summary['iteration']:.2f} | CD {summary['CD[mm]']:.4f} mm, F-score "
                  f"{summary['F-score[%]']:.2f} % at 5 mm vs the laser GT | launches {counts} | "
                  f"{smi}", flush=True)
            print(f"{label} split (median ms): " + ", ".join(f"{k} {v:.1f}" for k, v in med.items()),
                  flush=True)
            assert np.isfinite(summary["CD[mm]"]) and len(summary["cd_per_fruit_mm"]) == n
            return summary, seen

        def check_kernels(label, obs, T0):
            check_path_kernels(label, params, spec, table, pk16, pk32, opt_cfg, obs, T0, dev)

        # multi-frame on all fruits
        s_multi, seen = run(cfg, True, f"lab path, multi-frame (configs/{LAB_YAML})")
        assert s_multi["frames"] == n_fruits
        if profile:
            profile_main(lambda: lab.run_lab_eval(cfg, True, log=quiet, device=dev), smi, profile,
                         "lab path, multi-frame")
        obs = seen["obs"]
        print(f"lab set: {n_fruits} peppers x {n_frames} frames {W}x{H} (cut from frame_per_fruit "
              f"{cfg['frame_per_fruit']}; lab layout: depth in mm, 255-valued masks, integrated "
              f"map, laser GT) rendered and written in {render_s:.1f} s, {nbytes / 1e6:.1f} MB | "
              f"multi-frame: {int(obs.frame_valid.sum())} of {obs.frame_valid.numel()} frame "
              f"slots, {int(obs.point_valid.sum())} of {obs.point_valid.numel()} point slots",
              flush=True)
        check_kernels("lab multi-frame", obs, seen["T0"])

        # single-frame on the first n_single fruits: a lane a frame, the
        # other frame slots of each lane invalid
        cfg_s = dict(cfg, split=lab_split(names[:n_single], os.path.join(root, "single.json")))
        s_single, seen = run(cfg_s, False, f"lab path, single-frame, {n_single} fruits")
        assert s_single["frames"] >= n_single
        obs = seen["obs"]
        print(f"lab single-frame: {obs.points_w.shape[0]} lanes, {int(obs.frame_valid.sum())} of "
              f"{obs.frame_valid.numel()} frame slots valid", flush=True)
        check_kernels("lab single-frame", obs, seen["T0"])

        # functional gate: multi-frame on the first n_gate fruits
        cfg_g = dict(cfg, split=lab_split(names[:n_gate], os.path.join(root, "gate.json")))
        t0 = time.perf_counter()
        s_k = lab.run_lab_eval(cfg_g, True, log=quiet, device=dev)
        t_k = time.perf_counter() - t0
        with plain_versions():
            t0 = time.perf_counter()
            s_p = lab.run_lab_eval(cfg_g, True, log=quiet, device=dev)
            t_p = time.perf_counter() - t0
        gap = s_k["CD[mm]"] - s_p["CD[mm]"]
        print(f"lab functional gate (multi-frame): B={n_gate}, mean CD kernels "
              f"{s_k['CD[mm]']:.4f} mm vs plain {s_p['CD[mm]']:.4f} mm, gap {gap:+.4f} mm (gate "
              f"{CD_GATE_MM} mm) | run kernels {t_k * 1e3:.1f} ms, plain {t_p * 1e3:.1f} ms | mean "
              f"iters kernels {s_k['iteration']:.2f}, plain {s_p['iteration']:.2f}", flush=True)
        assert abs(gap) <= CD_GATE_MM, gap

        # berries: configs/lab_berry.yaml (0.04 m at 1 mm: an 80^3 grid)
        cfg_b = load_config(os.path.join(ROOT, "configs", BERRY_YAML))
        cfg_b.update(deepsdf_dir=berry_dir, run_name="chip_smoke_berry")
        cfg_b["vis"]["log_on"] = False
        opt_b = JointOptConfig.from_dict(cfg_b)
        assert opt_b.fused_bf16 and opt_b.init_mode == "mean"
        t0 = time.perf_counter()
        nbytes = gen.make_lab_dataset(berry, berry_dir, n_berry, berry_frames, W, H, device=dev)
        render_s = time.perf_counter() - t0
        cfg_b.update(data_dir=berry, split=os.path.join(berry, "split.json"))
        vis = cfg_b["vis"]
        radius = vis["object_radius_max_m"]
        voxels = int(2 * radius * 1e3 / vis["mc_res_mm"])
        print(f"berry set: {n_berry} berries x {berry_frames} frames {W}x{H} (cut from "
              f"frame_per_fruit {cfg_b['frame_per_fruit']}; n_frame "
              f"{cfg_b['opt']['render']['n_frame']}) rendered and written in {render_s:.1f} s, "
              f"{nbytes / 1e6:.1f} MB | grid {voxels}^3 at {vis['mc_res_mm']} mm", flush=True)
        # mean init (no opt.tpu block): no scoring launch
        s_berry, seen = run(cfg_b, True, f"lab berry, multi-frame (configs/{BERRY_YAML})",
                            need=("mlp_fwd_grad", "fused_render", "mlp_shared_latent"))
        params_b, spec_b = config_decoder(berry_dir, device=dev)
        table_b = load_latent_vectors(berry_dir, device=dev)
        pk16_b = mlp_kernels.pack_params(params_b, spec_b, torch.bfloat16)
        pk32_b = mlp_kernels.pack_params(params_b, spec_b, torch.float32)
        # B1 and B2 at the berry run's start (the table mean, the pose inits)
        obs, lat0, T0 = seen["obs"], seen["lat0"], seen["T0"]
        B = obs.points_w.shape[0]
        pts_o = obs.points_w @ T0[:, :3, :3].transpose(1, 2) + T0[:, None, :3, 3]
        N_pts = pts_o.shape[1]
        check_mlp("berry", pk32_b, table_b, B, N_pts, dev,
                  x=torch.cat([lat0[:, None].expand(B, N_pts, -1), pts_o], -1).contiguous())
        check_render("berry", pk16_b, pk32_b, obs, opt_b, lat0.contiguous(), T0, dev,
                     cube_radius=radius)
        b4 = check_shared_latent("berry", params_b, spec_b, pk16_b, pk32_b, seen["res"].latent,
                                 dev, voxels=voxels, cube_radius=radius)
        # the berry run's functional gate
        with plain_versions():
            t0 = time.perf_counter()
            s_bp = lab.run_lab_eval(cfg_b, True, log=quiet, device=dev)
            t_p = time.perf_counter() - t0
        gap = s_berry["CD[mm]"] - s_bp["CD[mm]"]
        print(f"berry functional gate: B={n_berry}, mean CD kernels {s_berry['CD[mm]']:.4f} mm vs "
              f"plain {s_bp['CD[mm]']:.4f} mm, gap {gap:+.4f} mm (gate {CD_GATE_MM} mm) | plain run "
              f"{t_p * 1e3:.1f} ms | mean iters kernels {s_berry['iteration']:.2f}, plain "
              f"{s_bp['iteration']:.2f} | lab phase {time.perf_counter() - t_phase:.1f} s",
              flush=True)
        assert abs(gap) <= CD_GATE_MM, gap
    return dict(b4_berry=b4, berry_cd=s_berry["CD[mm]"])


def kernel_record(name: str, check: dict, launches: int, path: str) -> dict:
    """One row of the kernels line: a kernel's check on a path's shape and
    its launches on that path's run."""
    source, replaces = KERNEL_SOURCES[name]
    return dict(name=name, route="cuda", source=source, replaces=replaces, launches=launches,
                max_abs_err=check["err"], ms=check["ms"], plain_ms=check["plain_ms"],
                bound_ms=check["bound_ms"], bound_by=check["bound_by"], library_ms=None,
                path=path)


def greenhouse_path(params, spec, table, pk16, pk32, smi, dev, profile=None, n_dirs=GH_DIRS,
                    fruits_per_dir=GH_FRUITS_PER_DIR, size=CHALLENGE_SIZE, n_frames=GH_FRAMES,
                    reps=GH_REPS, n_gate_dirs=GH_GATE_DIRS, single_dirs=1,
                    deepsdf_dir=os.path.join(ROOT, "assets", "synthetic_pepper_32")):
    """Phase 12, the greenhouse path from disk: `n_dirs` CKA-layout data
    dirs of `fruits_per_dir` fruits (seeds 9, 10, ...) written by the port's
    generator; `run_greenhouse_eval` multi-frame under
    configs/cka_pepper_tpu.yaml on all of them, timed as the median of
    `reps` after a warm-up with its split, CD, F-score, pose errors, the
    rescue's lanes and launch counts; B1, B2, B3 and B4 against their plain
    versions on the run's own observations; the functional gate on the
    first `n_gate_dirs` dirs; single-frame under
    configs/cka_pepper_single_tpu.yaml on the first `single_dirs` dirs,
    timed the same way, with B1, B2, B3 and B4 against their plain
    versions on its observations. Returns the kernels-line rows of both
    runs."""
    import tempfile

    import numpy as np
    import torch

    from hortimapping_tpu_torch.config import JointOptConfig, load_config
    from hortimapping_tpu_torch.data.mesh import TriangleMesh
    from hortimapping_tpu_torch.metrics.chamfer import ChamferDistance
    from hortimapping_tpu_torch.metrics.precision_recall import PrecisionRecall
    from hortimapping_tpu_torch.ops.mesher import MeshExtractor
    from hortimapping_tpu_torch.optim import warmstart
    from hortimapping_tpu_torch.pipeline import greenhouse
    from hortimapping_tpu_torch.tools import make_demo_data as gen

    t_phase = time.perf_counter()
    cfg = load_config(os.path.join(ROOT, "configs", GREENHOUSE_YAML))
    cfg.update(deepsdf_dir=deepsdf_dir, run_name="chip_smoke_gh")
    cfg["vis"]["log_on"] = False
    opt_cfg = JointOptConfig.from_dict(cfg)
    cfg_1 = load_config(os.path.join(ROOT, "configs", GREENHOUSE_SINGLE_YAML))
    cfg_1.update(deepsdf_dir=deepsdf_dir, run_name="chip_smoke_gh_single")
    cfg_1["vis"]["log_on"] = False
    opt_1 = JointOptConfig.from_dict(cfg_1)
    assert opt_cfg.fused_bf16 and opt_1.fused_bf16  # B2 runs bf16, as check_render holds it
    W, H = size
    quiet = lambda *a: None
    rows = []
    with tempfile.TemporaryDirectory(prefix="chip_smoke_greenhouse_") as root:
        dirs = [os.path.join(root, f"cka_{k}") for k in range(n_dirs)]
        t0 = time.perf_counter()
        nbytes = sum(gen.make_greenhouse_dataset(d, deepsdf_dir, fruits_per_dir, n_frames, W, H,
                                                 seed=9 + k, device=dev)
                     for k, d in enumerate(dirs))
        render_s = time.perf_counter() - t0
        cfg["data_dir"] = dirs
        n_fruits = n_dirs * fruits_per_dir
        print(f"greenhouse sets: {n_dirs} CKA-layout dirs x {fruits_per_dir} fruits (seeds 9-"
              f"{8 + n_dirs}), {n_frames} frames {W}x{H} each (frame_per_fruit "
              f"{cfg['frame_per_fruit']}: every frame sampled) rendered and written in "
              f"{render_s:.1f} s, {nbytes / 1e6:.1f} MB", flush=True)

        stages = Stages(targets=(
            ("reading frames and PNGs", greenhouse, "read_frame"),
            ("background sampling", greenhouse, "background_cloud"),
            ("cleaning", greenhouse, "clean_mesh"),
            ("cleaning (clouds)", greenhouse, "clean_pcd"),
            ("pose init", greenhouse, "get_pose_init"),
            ("ray sampling", greenhouse, "get_render_data"),
            ("solve", greenhouse, "warmstart_solve"),
            ("baseline solve", greenhouse, "shape_opt_deepsdf_batched"),
            ("meshing", MeshExtractor, "complete_mesh_batch"),
            ("metrics: mesh sampling", TriangleMesh, "sample_points_uniformly"),
            ("metrics: Chamfer", ChamferDistance, "update"),
            ("metrics: P/R", PrecisionRecall, "update"),
            ("writing", greenhouse, "write_result_dir")))

        def run(cfg_, multi, label):
            """A warm-up, then `reps` timed runs; returns the last summary,
            what its solve was given and gave, and the launch counts."""
            seen = {}
            greenhouse.run_greenhouse_eval(cfg_, multi, log=quiet, device=dev)
            times, splits = [], []
            with capture_solve(greenhouse, seen):
                for _ in range(reps):
                    counts = LaunchCounts()
                    with stages.timing():
                        t0 = time.perf_counter()
                        summary = greenhouse.run_greenhouse_eval(cfg_, multi, log=quiet,
                                                                 device=dev)
                        torch.cuda.synchronize()
                        stages.t["batch"] = time.perf_counter() - t0
                    counts.read()
                    times.append(stages.t["batch"])
                    splits.append(stages.split())
            counts.require(LaunchCounts.ALL, label)
            n = summary["frames"]
            ms = float(np.median(times)) * 1e3
            med = {k: float(np.median([sp[k] for sp in splits])) * 1e3 for k in splits[0]}
            info = dict(warmstart.LAST_RESCUE_INFO)
            print(f"{label}: {n} instances | {ms:.1f} ms a run (median of {reps} after a warm-up: "
                  f"{[round(t * 1e3, 1) for t in times]}), {ms / n:.2f} ms an instance | solve "
                  f"{summary['timing_s'] * 1e3:.2f} ms an instance (the summary's timing) | mean "
                  f"iters {summary['iteration']:.2f} | CD {summary['CD[mm]']:.4f} mm, F-score "
                  f"{summary['F-score[%]']:.2f} % at 5 mm | Error_trans "
                  f"{summary['Error_trans[mm]']:.3f} mm, Error_rot {summary['Error_rot[deg]']:.3f} "
                  f"deg | rescue: n_rescued {info.get('n_rescued')}, lanes {info.get('lanes')}, "
                  f"accepted {info.get('accepted')} | launches {counts} | {smi}", flush=True)
            print(f"{label} split (median ms): " + ", ".join(
                f"{k} {v:.1f}" for k, v in med.items() if k != "baseline solve"), flush=True)
            assert np.isfinite(summary["CD[mm]"]) and len(summary["cd_per_fruit_mm"]) == n
            assert np.isfinite(summary["Error_trans[mm]"]) and np.isfinite(summary["Error_rot[deg]"])
            return summary, seen, counts

        # multi-frame on every dir
        s_multi, seen, counts = run(cfg, True, f"greenhouse from disk, multi-frame "
                                               f"(configs/{GREENHOUSE_YAML})")
        assert s_multi["frames"] == n_fruits, s_multi["frames"]
        if profile:
            profile_main(lambda: greenhouse.run_greenhouse_eval(cfg, True, log=quiet, device=dev),
                         smi, profile, "greenhouse from disk, multi-frame")
        obs = seen["obs"]
        print(f"greenhouse multi-frame observations: B={obs.points_w.shape[0]}, "
              f"{int(obs.frame_valid.sum())} of {obs.frame_valid.numel()} frame slots, "
              f"{int(obs.point_valid.sum())} of {obs.point_valid.numel()} point slots", flush=True)
        checks = check_path_kernels("greenhouse from disk, multi-frame", params, spec, table,
                                    pk16, pk32, opt_cfg, obs, seen["T0"], dev)
        rows += [kernel_record(k, c, counts.n[k], "greenhouse from disk, multi-frame")
                 for k, c in checks.items()]

        # functional gate: the first n_gate_dirs dirs, kernels vs plain versions
        cfg_g = dict(cfg, data_dir=dirs[:n_gate_dirs], run_name="chip_smoke_gh_gate")
        t0 = time.perf_counter()
        s_k = greenhouse.run_greenhouse_eval(cfg_g, True, log=quiet, device=dev)
        t_k = time.perf_counter() - t0
        with plain_versions():
            t0 = time.perf_counter()
            s_p = greenhouse.run_greenhouse_eval(cfg_g, True, log=quiet, device=dev)
            t_p = time.perf_counter() - t0
        gap = s_k["CD[mm]"] - s_p["CD[mm]"]
        print(f"greenhouse functional gate (multi-frame): B={s_k['frames']}, mean CD kernels "
              f"{s_k['CD[mm]']:.4f} mm vs plain {s_p['CD[mm]']:.4f} mm, gap {gap:+.4f} mm (gate "
              f"{CD_GATE_MM} mm) | Error_trans kernels {s_k['Error_trans[mm]']:.3f} mm, plain "
              f"{s_p['Error_trans[mm]']:.3f} mm | Error_rot kernels {s_k['Error_rot[deg]']:.3f} "
              f"deg, plain {s_p['Error_rot[deg]']:.3f} deg | run kernels {t_k * 1e3:.1f} ms, plain "
              f"{t_p * 1e3:.1f} ms | mean iters kernels {s_k['iteration']:.2f}, plain "
              f"{s_p['iteration']:.2f}", flush=True)
        assert abs(gap) <= CD_GATE_MM, gap

        # single-frame on the first single_dirs dirs: a lane a frame, the
        # other frame slots of each lane invalid
        cfg_1["data_dir"] = dirs[:single_dirs]
        s_single, seen, counts = run(cfg_1, False, f"greenhouse from disk, single-frame, "
                                                   f"{single_dirs * fruits_per_dir} fruits")
        obs = seen["obs"]
        print(f"greenhouse single-frame: {obs.points_w.shape[0]} lanes, "
              f"{int(obs.frame_valid.sum())} of {obs.frame_valid.numel()} frame slots valid",
              flush=True)
        assert s_single["frames"] >= single_dirs * fruits_per_dir
        checks = check_path_kernels("greenhouse from disk, single-frame", params, spec, table,
                                    pk16, pk32, opt_1, obs, seen["T0"], dev)
        rows += [kernel_record(k, c, counts.n[k], "greenhouse from disk, single-frame")
                 for k, c in checks.items()]
    print(f"greenhouse phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    return rows


def serve_requests(spec, cfg, seed: int, n: int, latent0, prefix: str):
    """`n` requests of bench.py's synthetic peppers (the draws of
    `build_batch` from `seed`, scene k from seed k) at the observation
    shapes of `cfg`, and their GT surface points."""
    import numpy as np

    from hortimapping_tpu_torch.serve import CompletionRequest
    from hortimapping_tpu_torch.tools.synthetic import SyntheticCategory, make_scene

    cat = SyntheticCategory(spec=spec, base_radius=0.06)
    rng = np.random.default_rng(seed)
    reqs, gts = [], []
    for b in range(n):
        code = (rng.normal(size=spec.code_length) * 0.3).astype(np.float32)
        T_wo = np.eye(4, dtype=np.float32)
        T_wo[:3, 3] = rng.normal(size=3) * 0.1
        obs, gt = make_scene(cat, code, T_wo, n_frames=cfg.n_frame, n_fg=cfg.n_fg_pix,
                             n_bg=cfg.n_bg_pix, n_points=cfg.recon_n_pts, seed=b)
        reqs.append(CompletionRequest(f"{prefix}_{b:02d}", obs, latent0,
                                      np.linalg.inv(T_wo).astype(np.float32)))
        gts.append(gt)
    return reqs, gts


def serve_path(params, spec, table, smi, dev, profile=None, n_batch=N_FRUITS, n_stream=40,
               stream_period_s=0.01, voxels=VOXELS):
    """Phase 13, the serving path: `CompletionServer` over the one-call
    packed solve (bench config with its unit-scale bf16 retrieval,
    coarse-to-fine LM, meshing at `voxels`^3) on the card, warmed up
    first. A burst of 2 x `n_batch` requests served as two full batches,
    each lane equal to the direct `joint_opt_packed` of its batch at the
    same width; the served meshes' CD to the GT surfaces; a stream of
    `n_stream` requests one every `stream_period_s`; admission control and
    deadlines. Returns the burst's launch counts."""
    import dataclasses
    import threading

    import numpy as np
    import torch

    from hortimapping_tpu_torch.ops.mesher import MeshExtractor
    from hortimapping_tpu_torch.optim.lm import joint_opt_packed
    from hortimapping_tpu_torch.optim.state import stack_observations
    from hortimapping_tpu_torch.serve import CompletionServer, DeadlineExceeded, ServerOverloaded

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(bench_cfg(), init_mode="retrieval", retrieval_score_pts=128,
                              retrieval_n_scales=1, retrieval_scale_min=1.0,
                              retrieval_scale_max=1.0, retrieval_score_bf16=True)
    lat0 = table.mean(0).cpu().numpy()
    reqs_a, gts_a = serve_requests(spec, cfg, 42, n_batch, lat0, "bench")
    reqs_b, gts_b = serve_requests(spec, cfg, 43, n_batch, lat0, "s43")
    reqs, gts = reqs_a + reqs_b, gts_a + gts_b
    mesher = MeshExtractor(params, spec, voxels_dim=voxels, cube_radius=CUBE_RADIUS, device=dev)

    def server(**kw):
        srv = CompletionServer(params, spec, cfg, CUBE_RADIUS, max_batch=n_batch,
                               latent_table=table, mesher=mesher, device=dev, **kw)
        t0 = time.perf_counter()
        srv.warmup(reqs[0])
        return srv, time.perf_counter() - t0

    # 1. burst: two full batches
    srv, warm_s = server()
    counts = LaunchCounts()
    with srv:
        t0 = time.perf_counter()
        results = [f.result(timeout=600) for f in [srv.submit(r) for r in reqs]]
        burst_s = time.perf_counter() - t0
    counts.read()
    counts.require(LaunchCounts.ALL, "serving burst")
    assert [r.fruit_id for r in results] == [r.fruit_id for r in reqs]
    assert all(r.batch_size == n_batch for r in results), [r.batch_size for r in results]
    gap_lat = gap_T = 0.0
    for lo in (0, n_batch):
        batch = reqs[lo:lo + n_batch]
        res, _ = joint_opt_packed(
            params, spec, cfg, stack_observations([r.obs for r in batch], dev),
            torch.as_tensor(np.stack([r.latent0 for r in batch])).to(dev),
            torch.as_tensor(np.stack([r.T_ow0 for r in batch])).to(dev), CUBE_RADIUS,
            latent_table=table, device=dev)
        lat, T_ow = res.latent.cpu().numpy(), res.T_ow.cpu().numpy()
        for i, r in enumerate(results[lo:lo + n_batch]):
            assert r.iter_count == int(res.iter_count[i]) and r.failed == bool(res.failed[i])
            assert r.converged == bool(res.converged[i])
            gap_lat = max(gap_lat, float(np.abs(r.latent - lat[i]).max()))
            gap_T = max(gap_T, float(np.abs(r.T_ow - T_ow[i]).max()))
    assert gap_lat <= 1e-5 and gap_T <= 1e-5, (gap_lat, gap_T)
    assert not any(r.failed for r in results)
    assert all(r.mesh is not None and r.mesh.faces.shape[0] > 100 for r in results)
    cd = mean_cd_mm([r.mesh for r in results], gts, dev)
    lat_ms = sorted(r.latency_s * 1e3 for r in results)
    print(f"serving burst: {len(reqs)} requests (the bench batch and {n_batch} from seed 43), "
          f"configs bench + unit-scale bf16 retrieval, c2f LM, {voxels}^3 meshing | warmup "
          f"{warm_s:.1f} s (widths 1-{n_batch}) | served in {burst_s * 1e3:.1f} ms as 2 batches "
          f"of {n_batch} ({len(reqs) / burst_s:.1f} fruits/s), latency first batch "
          f"{lat_ms[0]:.1f}-{lat_ms[n_batch - 1]:.1f} ms, second {lat_ms[n_batch]:.1f}-"
          f"{lat_ms[-1]:.1f} ms | each lane vs the direct "
          f"joint_opt_packed at width {n_batch}: max |d latent| {gap_lat:.3g}, max |d T_ow| "
          f"{gap_T:.3g} (gate 1e-5), iterations and flags equal | mean iters "
          f"{np.mean([r.iter_count for r in results]):.2f} | served meshes mean CD-L1 {cd:.4f} mm "
          f"| launches {counts} | {smi}", flush=True)
    if profile:
        srv_p, _ = server()
        with srv_p:
            profile_main(lambda: [f.result(timeout=600) for f in [srv_p.submit(r) for r in reqs]],
                         smi, profile, "serving burst")

    # 2. stream: one request every stream_period_s
    srv, _ = server()
    stream = reqs[:n_stream]
    futs = []
    with srv:
        def producer():
            for r in stream:
                futs.append(srv.submit(r))
                time.sleep(stream_period_s)

        prod = threading.Thread(target=producer)
        prod.start()
        prod.join(timeout=600)
        assert not prod.is_alive()
        got = [f.result(timeout=600) for f in futs]
        stats = srv.stats()
    widths = sorted({srv._batch_width(r.batch_size) for r in got})
    lat_ms = sorted(r.latency_s * 1e3 for r in got)
    assert len(got) == n_stream and not any(r.failed for r in got)
    print(f"serving stream: {n_stream} requests, one every {stream_period_s * 1e3:.0f} ms | "
          f"batches of {sorted({r.batch_size for r in got})} real lanes at widths {widths} | "
          f"latency p50 {stats['latency_p50_s'] * 1e3:.1f} ms, p95 "
          f"{stats['latency_p95_s'] * 1e3:.1f} ms, max {lat_ms[-1]:.1f} ms | "
          f"{stats['fruits_per_sec']:.2f} fruits/s (stats(), wall since start) | {smi}",
          flush=True)

    # 3. admission control and deadlines
    srv = CompletionServer(params, spec, cfg, CUBE_RADIUS, max_batch=n_batch, latent_table=table,
                           device=dev, max_queue=8)
    accepted, refused = [], 0
    with srv:
        for r in reqs:
            try:
                accepted.append(srv.submit(r))
            except ServerOverloaded:
                refused += 1
        done = [f.result(timeout=600) for f in accepted]
        t0 = time.perf_counter()
        while srv.stats()["inflight"] and time.perf_counter() - t0 < 10.0:
            time.sleep(0.001)   # the Futures' callbacks free their places
        # a deadline of 0 behind a busy batch: expired when packed
        busy = [srv.submit(r) for r in reqs[:4]]
        late = srv.submit(dataclasses.replace(reqs[4], deadline_s=0.0))
        try:
            late.result(timeout=600)
            expired = False
        except DeadlineExceeded:
            expired = True
        busy = [f.result(timeout=600) for f in busy]
        stats = srv.stats()
    print(f"serving admission control: max_queue 8, a burst of {len(reqs)}: {len(accepted)} "
          f"accepted and resolved ({sum(not r.failed for r in done)} not failed), {refused} "
          f"refused with ServerOverloaded | deadline 0 behind a busy batch of 4: "
          f"{'DeadlineExceeded' if expired else 'SERVED'} (deadline_expired "
          f"{stats['deadline_expired']}) | serving phase {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    assert refused > 0 and len(done) == len(accepted) >= 8 and len(busy) == 4
    assert expired and stats["deadline_expired"] == 1 and stats["inflight"] == 0
    return counts.n


def write_sdf_samples(root: str, cat, n_scenes: int, n_each: int, seed: int = 0):
    """DeepSDF SdfSamples of `n_scenes` ellipsoids of the category's family
    (codes ~ N(0, 0.5^2)), `n_each` samples of each sign a scene: points
    near the surface (a surface point moved along its ray by N(0, 0.1^2)
    of its radius) and uniform in the box of half-width 2.5 base radii, as
    upstream DeepSDF mixes near-surface and uniform samples. -> the names."""
    import numpy as np

    from hortimapping_tpu_torch.tools.synthetic import _ellipsoid_sdf_np

    rng = np.random.default_rng(seed)
    proj = cat.projection()
    ext = 2.5 * cat.base_radius
    os.makedirs(os.path.join(root, "SdfSamples"), exist_ok=True)
    names = []
    for s in range(n_scenes):
        radii = cat.base_radius * np.exp(proj @ (rng.normal(size=cat.spec.code_length) * 0.5))
        d = rng.normal(size=(3 * n_each, 3))
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        x = np.concatenate([d * radii * (1.0 + rng.normal(size=(3 * n_each, 1)) * 0.1),
                            rng.uniform(-ext, ext, size=(n_each // 2, 3))])
        sdf = _ellipsoid_sdf_np(x, radii)
        samples = np.concatenate([x, sdf[:, None]], axis=-1).astype(np.float32)
        pos, neg = samples[sdf >= 0][:n_each], samples[sdf < 0][:n_each]
        assert pos.shape[0] == neg.shape[0] == n_each, (s, pos.shape, neg.shape)
        names.append(f"ellipsoid_{s:04d}")
        np.savez(os.path.join(root, "SdfSamples", names[-1] + ".npz"), pos=pos, neg=neg)
    return names


def train_experiment(root: str, data: str, arch_dir: str, **fields) -> str:
    """An experiment directory with `arch_dir`'s architecture and the
    upstream DeepSDF training fields (overridden by `fields`)."""
    with open(os.path.join(arch_dir, "specs.json")) as f:
        arch = json.load(f)
    specs = dict(
        Description="chip_smoke training path", DataSource=data, CodeLength=arch["CodeLength"],
        NetworkSpecs=arch["NetworkSpecs"], ClampingDistance=arch["ClampingDistance"],
        ScenesPerBatch=64, SamplesPerScene=8192, NumEpochs=TRAIN_EPOCHS, CodeRegularization=True,
        CodeRegularizationLambda=1e-4, CodeInitStdDev=0.01,
        LearningRateSchedule=[{"Type": "Step", "Initial": 5e-4, "Interval": 500, "Factor": 0.5},
                              {"Type": "Step", "Initial": 1e-3, "Interval": 500, "Factor": 0.5}])
    specs.update(fields)
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, "specs.json"), "w") as f:
        json.dump(specs, f, indent=2)
    return root


@contextlib.contextmanager
def replayed_training(init, draws=None, record=None):
    """The trainer started from `init` (a function of the device) and, with
    `record`, its draws appended there, or with `draws`, those draws moved
    to the run's device and replayed in turn."""
    from hortimapping_tpu_torch.train import deepsdf

    saved = deepsdf.init_decoder_params, deepsdf._draw_step
    orig_draw = deepsdf._draw_step
    deepsdf.init_decoder_params = lambda spec, g, dev: init(dev)

    def draw(*a):
        if draws is not None:
            return tuple(t.to(a[4].device) for t in draws.pop(0))
        record.append(tuple(t.cpu() for t in orig_draw(*a)))
        return record[-1]

    deepsdf._draw_step = draw
    try:
        yield
    finally:
        deepsdf.init_decoder_params, deepsdf._draw_step = saved


def train_steps_card_vs_cpu(root: str, data: str, arch_dir: str, names, dev) -> None:
    """Two training steps of a small decoder (4 x 128, C = 32, 8 scenes of
    2048 samples) on the card against the same steps on the CPU, from one
    init and the CPU's draws replayed on the card. Both f32: the epoch losses
    within 1e-6 (their predictions differ by f32 rounding, ~2e-7), the
    weights and codes within a hundredth of their group's lr (Adam's first
    steps move each by ~lr; a gradient near zero moves its weight by up to
    lr * dg / eps). A forward of the same decoder with TF32 on shows what
    the gates would see were TF32 on (~1e-3)."""
    import numpy as np
    import torch

    from hortimapping_tpu_torch.models.decoder import (
        DecoderSpec,
        decoder_apply,
        init_decoder_params,
    )
    from hortimapping_tpu_torch.train import deepsdf

    fields = dict(CodeLength=32, NetworkSpecs={"dims": [128] * 4, "latent_in": [2]},
                  ScenesPerBatch=8, SamplesPerScene=2048, NumEpochs=2)
    exp_cpu, exp_card = (train_experiment(os.path.join(root, d), data, arch_dir, **fields)
                         for d in ("cpu", "card"))
    spec = DecoderSpec(code_length=32, dims=(128,) * 4, latent_in=(2,))
    init_cpu = init_decoder_params(spec, torch.Generator().manual_seed(3), "cpu")

    def init(device):
        return {k: {kk: v.clone().to(device) for kk, v in p.items()} for k, p in init_cpu.items()}

    kw = dict(split=list(names[:8]), save=False, log=lambda *a: None)
    draws = []
    with replayed_training(init, record=draws):
        res_cpu = deepsdf.train_deepsdf(exp_cpu, device="cpu", **kw)
    n_draws = len(draws)
    with replayed_training(init, draws=draws):
        res_card = deepsdf.train_deepsdf(exp_card, device=dev, **kw)
    assert n_draws == 2 and not draws and not torch.backends.cuda.matmul.allow_tf32
    d_loss = float(np.abs(res_card.losses - res_cpu.losses).max())
    d_w = max(float((res_card.params[k][kk].cpu() - res_cpu.params[k][kk]).abs().max())
              for k in res_cpu.params for kk in ("w", "b"))
    d_z = float(np.abs(res_card.latent_codes - res_cpu.latent_codes).max())
    # the same decoder's forward on the card with TF32 on, against the CPU
    rows = torch.cat([torch.randn(65536, 32, generator=torch.Generator().manual_seed(4)) * 0.5,
                      torch.rand(65536, 3, generator=torch.Generator().manual_seed(5)) * 0.3
                      - 0.15], dim=1)
    want = decoder_apply(res_cpu.params, spec, rows)
    params_card = {k: {kk: v.to(dev) for kk, v in p.items()} for k, p in res_cpu.params.items()}
    f32 = float((decoder_apply(params_card, spec, rows.to(dev)).cpu() - want).abs().max())
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32 = float((decoder_apply(params_card, spec, rows.to(dev)).cpu() - want).abs().max())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    print(f"training steps, card vs CPU (4 x 128, C 32, 8 scenes x 2048 samples, 2 steps, the "
          f"CPU's draws replayed): epoch losses {res_card.losses.round(6).tolist()} | |d loss| "
          f"{d_loss:.3g} (gate 1e-6) | |d weight| {d_w:.3g} (gate 5e-6 = lr/100), "
          f"|d code| {d_z:.3g} (gate 1e-5) | forward of that decoder vs the CPU: f32 "
          f"{f32:.3g}, with TF32 on {tf32:.3g}", flush=True)
    assert d_loss <= 1e-6 and d_w <= 5e-6 and d_z <= 1e-5, (d_loss, d_w, d_z)


def train_path(smi, dev, profile=None, n_scenes=TRAIN_SCENES, n_each=TRAIN_SAMPLES,
               epochs=TRAIN_EPOCHS, scenes_per_batch=64, samples_per_scene=8192, voxels=VOXELS):
    """Phase 14, the training path at full width: `n_scenes` ellipsoid scenes
    of the pepper category written as SdfSamples to a temporary directory,
    an experiment of `assets/synthetic_pepper_32`'s architecture (8 x 512,
    C = 32, latent_in 4) at ScenesPerBatch x SamplesPerScene rows a step,
    `train_deepsdf` for `epochs` epochs with a snapshot half-way, a resumed
    run from that snapshot to the end (its epoch losses within 1e-3 of the
    first run's: PyTorch does not promise a CUDA backward's summation
    order), the written checkpoint loaded by `config_decoder` and 8 codes of
    its table meshed (B4: the path's only kernel, counted over the whole
    path), then B4 against its plain version on that decoder and two steps
    on the card against the CPU. With `profile`, one more epoch continued
    from the end is traced. -> B4's kernel record."""
    import tempfile

    import numpy as np
    import torch

    from hortimapping_tpu_torch.models.decoder import DecoderSpec
    from hortimapping_tpu_torch.models.workspace import (
        config_decoder,
        load_latent_vectors,
        load_specs,
    )
    from hortimapping_tpu_torch.ops import mlp_kernels
    from hortimapping_tpu_torch.ops.mesher import MeshExtractor
    from hortimapping_tpu_torch.tools.synthetic import SyntheticCategory
    from hortimapping_tpu_torch.train import deepsdf

    t_phase = time.perf_counter()
    arch_dir = os.path.join(ROOT, "assets", "synthetic_pepper_32")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        with np.load(os.path.join(arch_dir, "native", "latest.npz")) as z:
            cat = SyntheticCategory(spec=DecoderSpec.from_specs_json(load_specs(arch_dir)),
                                    base_radius=float(z["synthetic.base_radius"]))
        t0 = time.perf_counter()
        names = write_sdf_samples(os.path.join(tmp, "data"), cat, n_scenes, n_each)
        data_s = time.perf_counter() - t0
        nbytes = sum(os.path.getsize(os.path.join(tmp, "data", "SdfSamples", n + ".npz"))
                     for n in names)
        fields = dict(ScenesPerBatch=scenes_per_batch, SamplesPerScene=samples_per_scene,
                      NumEpochs=epochs)
        exp_a = train_experiment(os.path.join(tmp, "run"), os.path.join(tmp, "data"), arch_dir,
                                 **fields)
        stamps = []
        counts = LaunchCounts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = deepsdf.train_deepsdf(exp_a, num_epochs=epochs, snapshot_every=epochs // 2,
                                    epochs_per_call=1, save=False, device=dev,
                                    log=lambda msg: stamps.append(time.perf_counter()))
        wall = time.perf_counter() - t0
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        res_b = deepsdf.train_deepsdf(exp_a, num_epochs=epochs, snapshot_every=epochs // 2,
                                      epochs_per_call=1, resume=True, device=dev,
                                      log=lambda msg: None)
        params, spec = config_decoder(exp_a, device=dev)
        table = load_latent_vectors(exp_a, device=dev)
        mesher = MeshExtractor(params, spec, voxels_dim=voxels, cube_radius=CUBE_RADIUS,
                               device=dev)
        meshes = mesher.meshes_from_grids(mesher.decode_grids(table[:8]))
        torch.cuda.synchronize()
        counts.read()
        counts.require(("mlp_shared_latent",), "training path")

        spe = res.timing["steps_per_epoch"]
        epoch_s = np.diff(np.asarray([t0] + stamps))
        ms_step = float(np.median(epoch_s[1:])) * 1e3 / spe
        rows = scenes_per_batch * (samples_per_scene // 2) * 2
        macs = sum(i * o for i, o in spec.layer_dims())
        bound_ms = 6.0 * macs * rows / H100_F32_FLOPS * 1e3   # forward 2, backward 4 flops a MAC
        losses = res.losses
        d_resume = float(np.abs(res_b.losses[epochs // 2:] - losses[epochs // 2:]).max()
                         / losses.max())
        print(f"training path: {n_scenes} scenes x {n_each} + {n_each} samples of the "
              f"synthetic_pepper_32 family ({nbytes / 1e6:.1f} MB, written in {data_s:.1f} s) | "
              f"{len(spec.dims)} x {spec.dims[0]}, C {spec.code_length}, latent_in "
              f"{list(spec.latent_in)} | {scenes_per_batch} x {samples_per_scene} = {rows} rows a "
              f"step, {spe} steps an epoch, {epochs} epochs in {wall:.1f} s | {ms_step:.1f} ms a "
              f"step (median of epochs 2-{epochs} / {spe}), {rows / ms_step * 1e3:.4g} rows/s, "
              f"f32 bound {bound_ms:.1f} ms ({macs} MACs a row x 6 flops at 67 TFLOP/s): "
              f"{bound_ms / ms_step * 100:.1f} % of it | peak memory {peak_gb:.2f} GB | loss "
              f"first epoch {losses[0]:.5f}, last {losses[-1]:.5f} | resumed from the epoch-"
              f"{epochs // 2} snapshot: |d loss| {d_resume:.3g} of the loss (gate 1e-3), run "
              f"{res_b.timing['wall_s']:.1f} s | trained table {tuple(table.shape)}, 8 codes "
              f"meshed at {voxels}^3: faces {[m.faces.shape[0] for m in meshes]} | launches "
              f"{counts} | {smi}", flush=True)
        assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
        assert np.array_equal(res_b.losses[:epochs // 2], losses[:epochs // 2])
        assert d_resume <= 1e-3, d_resume
        assert table.shape == (n_scenes, spec.code_length)
        if profile:
            profile_main(lambda: deepsdf.train_deepsdf(
                exp_a, num_epochs=epochs + 1, resume=True, save=False, device=dev,
                log=lambda msg: None), smi, profile, "training path, one epoch")

        pk32 = mlp_kernels.pack_params(params, spec, torch.float32)
        pk16 = mlp_kernels.pack_params(params, spec, torch.bfloat16)
        b4 = check_shared_latent("trained decoder", params, spec, pk16, pk32, table[:8], dev,
                                 surface=False, voxels=voxels)
        train_steps_card_vs_cpu(tmp, os.path.join(tmp, "data"), arch_dir, names, dev)
    print(f"training phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    return kernel_record("mlp_shared_latent", b4, counts.n["mlp_shared_latent"],
                         "training path: the trained decoder's 8 codes")


def write_pth_experiment(root: str, src: str) -> None:
    """Experiment `src` (a native checkpoint) rewritten as the reference's
    torch checkpoint: `ModelParameters/latest.pth` weight-normed under
    DataParallel's `module.` prefix (each row of v scaled apart from W, g its
    norm) and `LatentCodes/latest.pth` as an `nn.Embedding` state dict."""
    import shutil

    import torch

    from hortimapping_tpu_torch.models.workspace import config_decoder, load_latent_vectors

    params, _ = config_decoder(src, device="cpu")
    state = {}
    for name, p in params.items():
        w = p["w"].T.contiguous()                       # torch Linear: [out, in]
        v = w * torch.linspace(0.5, 2.0, w.shape[0])[:, None]
        state[f"module.{name}.weight_v"] = v
        state[f"module.{name}.weight_g"] = torch.linalg.norm(w, dim=1, keepdim=True)
        state[f"module.{name}.bias"] = p["b"]
    for sub in ("ModelParameters", "LatentCodes"):
        os.makedirs(os.path.join(root, sub))
    shutil.copy(os.path.join(src, "specs.json"), root)
    torch.save({"epoch": 2000, "model_state_dict": state},
               os.path.join(root, "ModelParameters", "latest.pth"))
    torch.save({"epoch": 2000, "latent_codes": {"weight": load_latent_vectors(src, device="cpu")}},
               os.path.join(root, "LatentCodes", "latest.pth"))


def asset_path(smi, dev, t_script0: float, name="synthetic_pepper_32", budget_s=SCRIPT_BUDGET_S,
               n_held_out=HELD_OUT, n_pth=4096):
    """Phase 15, the asset build and the `.pth` load: `make_category(name)`
    at the category's own steps and rows (cut, and the cut printed, if the
    script would pass `budget_s`), timed; its decoder's mean |pred -
    clamp(analytic SDF)| on `n_held_out` points drawn as the trainer draws
    them (a generator of its own) within 1.5x the shipped decoder's; then
    the shipped decoder rewritten as the reference's `.pth` files and loaded
    through `config_decoder` / `load_latent_vectors` on the card: the codes
    equal, the SDF on `n_pth` points within 1e-6 of the native load's."""
    import tempfile

    import numpy as np
    import torch

    from hortimapping_tpu_torch.models.decoder import decoder_apply
    from hortimapping_tpu_torch.models.workspace import config_decoder, load_latent_vectors
    from hortimapping_tpu_torch.tools import make_assets
    from hortimapping_tpu_torch.tools.synthetic import (
        SyntheticCategory,
        synthetic_batch,
        train_synthetic_decoder,
    )

    t_phase = time.perf_counter()
    cfg = make_assets.CATEGORIES[name]
    cat = SyntheticCategory(spec=cfg["spec"], base_radius=cfg["base_radius"])
    # ms a step at the category's shape: a short run after a warm-up one
    train_synthetic_decoder(cat, 1, steps=20, batch=cfg["batch"], lr=cfg["lr"], device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    train_synthetic_decoder(cat, 1, steps=200, batch=cfg["batch"], lr=cfg["lr"], device=dev)
    torch.cuda.synchronize()
    ms_step = (time.perf_counter() - t0) / 200 * 1e3
    left = budget_s - (time.perf_counter() - t_script0) - 20.0   # the rest of this phase
    steps = cfg["steps"]
    cut = ""
    if steps * ms_step / 1e3 > left:
        steps = max(1000, int(left * 1e3 / ms_step))
        cut = f" (cut from {cfg['steps']} steps to end the script by {budget_s} s)"
    shipped_dir = os.path.join(ROOT, "assets", name)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_assets_") as tmp:
        t0 = time.perf_counter()
        out_dir = make_assets.make_category(name, tmp, device=dev, steps=steps)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        with np.load(os.path.join(out_dir, "native", "latest.npz")) as zp, \
                np.load(os.path.join(shipped_dir, "native", "latest.npz")) as zs:
            assert np.array_equal(zp["synthetic.projection"], zs["synthetic.projection"])
            assert sorted(zp.files) == sorted(zs.files)
            proj = torch.as_tensor(zp["synthetic.projection"]).to(dev)
        g = torch.Generator(device=dev).manual_seed(20261017)
        inputs, target = synthetic_batch(g, cat, proj, n_held_out)
        err = {}
        for label, d in (("built", out_dir), ("shipped", shipped_dir)):
            params, spec = config_decoder(d, device=dev)
            pred = decoder_apply(params, spec, inputs)[..., 0]
            err[label] = float((pred - target).abs().mean())
        print(f"asset build: make_category({name!r}) {steps} steps x {cfg['batch']} rows"
              f"{cut} in {build_s:.1f} s ({ms_step:.2f} ms a step in a 200-step run) | mean "
              f"|pred - clamp(sdf)| on {n_held_out} held-out points, codes ~ N(0, 0.5^2): "
              f"built {err['built']:.6f}, shipped {err['shipped']:.6f} (ratio "
              f"{err['built'] / err['shipped']:.3f}, gate 1.5) | {smi}", flush=True)
        assert err["built"] <= 1.5 * err["shipped"], err

        exp = os.path.join(tmp, "pth")
        write_pth_experiment(exp, shipped_dir)
        params_x, spec_x = config_decoder(exp, device=dev)
        codes_x = load_latent_vectors(exp, device=dev)
        cached = os.path.isfile(os.path.join(exp, "native", "latest.npz"))
        params_n, spec_n = config_decoder(shipped_dir, device=dev)
        codes_n = load_latent_vectors(shipped_dir, device=dev)
        assert spec_x == spec_n and torch.equal(codes_x, codes_n) and cached
        x = torch.cat([codes_n[torch.arange(n_pth, device=dev) % codes_n.shape[0]],
                       inputs[:n_pth, spec_n.code_length:]], dim=1)
        d_sdf = float((decoder_apply(params_x, spec_x, x) - decoder_apply(params_n, spec_n, x))
                      .abs().max())
        d_w = max(float((params_x[k][kk] - params_n[k][kk]).abs().max())
                  for k in params_n for kk in ("w", "b"))
    print(f"torch checkpoint: the shipped {name} as weight-normed ModelParameters/latest.pth "
          f"('module.' prefix) + nn.Embedding LatentCodes/latest.pth, loaded on the card | codes "
          f"equal, native cache written | |d weight| {d_w:.3g}, |d sdf| {d_sdf:.3g} on {n_pth} "
          f"points (gate 1e-6) | asset phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    assert d_sdf <= 1e-6, d_sdf


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true", help="stop after the kernel phases")
    ap.add_argument("--profile", metavar="FILE",
                    help="also trace one main-path batch with torch.profiler, table to FILE")
    args = ap.parse_args()
    t_script0 = time.perf_counter()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(ROOT, "hortimapping_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import numpy as np

    from hortimapping_tpu_torch import native, resolve_device
    from hortimapping_tpu_torch.config import JointOptConfig, load_config
    from hortimapping_tpu_torch.models.workspace import config_decoder, load_latent_vectors
    from hortimapping_tpu_torch.ops import cuda_build, mlp_kernels, render_kernel
    from hortimapping_tpu_torch.ops.mesher import MeshExtractor
    from hortimapping_tpu_torch.optim.lm import _subsample, subsample_observations
    from hortimapping_tpu_torch.optim import warmstart
    from hortimapping_tpu_torch.optim.warmstart import (
        maybe_retrieval_init,
        multi_start_joint_opt,
        retrieval_init_batched,
        retrieval_joint_opt,
        warmstart_solve,
    )

    dev = resolve_device("cuda")  # pins TF32 off: f32 means f32 here

    # ---------------- 1. device + build ----------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    cuda_build.build_all()
    native.load()
    build_s = time.perf_counter() - t0
    print(f"device: {smi} | torch {torch.__version__} cuda {torch.version.cuda} | "
          f"build of {len(cuda_build.KERNELS)} kernel libraries + host library {build_s:.1f} s",
          flush=True)
    for name in cuda_build.KERNELS:
        for line in cuda_build.ptxas_summary(cuda_build.build_log(name)):
            print(f"  ptxas {name}: {line}")

    params, spec = config_decoder(os.path.join(ROOT, "assets", "synthetic_pepper_32"), device=dev)
    table = load_latent_vectors(os.path.join(ROOT, "assets", "synthetic_pepper_32"), device=dev)
    cfg = bench_cfg()
    gh_cfg = JointOptConfig.from_dict(load_config(os.path.join(ROOT, "configs", GREENHOUSE_YAML)))
    C = spec.code_length
    pk32 = mlp_kernels.pack_params(params, spec, torch.float32)
    pk16 = mlp_kernels.pack_params(params, spec, torch.bfloat16)
    records = {}
    b1_smem = {pk.bf16: mlp_kernels.wave_and_smem("mlp_fwd_grad", pk)[1] for pk in (pk32, pk16)}
    r_smem = render_kernel._lib().horti_render_smem
    tr_gh = render_kernel.tiling(1, gh_cfg.n_sample_on_ray)[0]
    print(f"  dynamic shared memory a block at {pk32.n_mid + 1} x {pk32.D}: B1 f32 "
          f"{b1_smem[False]} B, bf16 {b1_smem[True]} B; B2 forward + render (bf16, "
          f"{tr_gh} rays) {r_smem(0, pk16.D, pk16.n_mid, pk16.in_dim, C, tr_gh, 1)} B, band "
          f"backward bf16 {r_smem(1, pk16.D, pk16.n_mid, pk16.in_dim, C, tr_gh, 1)} B, f32 "
          f"{r_smem(1, pk32.D, pk32.n_mid, pk32.in_dim, C, tr_gh, 0)} B", flush=True)

    # the bench batch (bench.py: 32 synthetic peppers, seed 42); the
    # greenhouse config has the same observation shapes
    obs, T0, gts = build_batch(spec, cfg, dev)
    lat_r, T_r, _, _ = retrieval_init_batched(
        params, spec, table, obs.points_w, obs.point_valid, n_score_pts=128, n_scales=1,
        scale_min=1.0, scale_max=1.0, T_init=T0, score_bf16=True)
    lat_g, T_g, _, _ = retrieval_init_batched(
        params, spec, table, obs.points_w, obs.point_valid, n_score_pts=gh_cfg.retrieval_score_pts,
        n_scales=1, scale_min=1.0, scale_max=1.0, T_init=T0, score_bf16=False)
    pts_o = obs.points_w @ T0[:, :3, :3].transpose(1, 2) + T0[:, None, :3, 3]

    # ---------------- 2. B3 vs plain, at both scoring shapes ----------------
    # one launch of each: 16 fruits (score_chunk) of the batch at unit scale
    b3 = {"bench": check_fwd("bench", pk16, table, pts_o[:16, :128], obs.point_valid[:16, :128],
                             spec.clamping_distance)}
    n_blk = (1 << 15) // gh_cfg.retrieval_score_pts   # _score_codes' block of codes
    b3["greenhouse"] = check_fwd("greenhouse", pk32, table[:n_blk],
                                 pts_o[:16, :gh_cfg.retrieval_score_pts],
                                 obs.point_valid[:16, :gh_cfg.retrieval_score_pts],
                                 spec.clamping_distance)
    records["mlp_fwd"] = kernel_record("mlp_fwd", b3["greenhouse"], 0, GH_MEMORY)

    # ---------------- 3. B4 vs plain, on the mesher's grid ----------------
    b4 = check_shared_latent("bench and greenhouse", params, spec, pk16, pk32, lat_r, dev)
    records["mlp_shared_latent"] = kernel_record("mlp_shared_latent", b4, 0, GH_MEMORY)

    # ---------------- 4. B1 and B2 vs plain, at the SDF and render shapes ----------------
    b1 = {}
    for phase, n in (("bench coarse", int(cfg.recon_n_pts * cfg.coarse_pts_frac)),
                     ("bench fine", int(cfg.recon_n_pts * cfg.fine_pts_frac)),
                     ("greenhouse", gh_cfg.recon_n_pts)):
        b1[phase] = check_mlp(phase, pk32, table, N_FRUITS, n, dev)
    # the same chain in bf16 on the tensor cores (the render kernel's mode)
    x = b1["bench fine"]["x"].reshape(-1, pk16.in_dim)
    flops = 2.0 * sum(chain_macs(pk16)) * x.shape[0]
    s16, g16 = mlp_kernels.mlp_sdf_and_input_grad(pk16, x)
    assert bool(torch.isfinite(s16).all()) and bool(torch.isfinite(g16).all())
    ms_16 = cuda_ms(lambda: mlp_kernels.mlp_sdf_and_input_grad(pk16, x), 20)
    # modelled, not counted: each cluster of 64-row blocks reads the weights
    # from L2 once forward and once backward
    l2_bytes = 2 * -(-x.shape[0] // (64 * mlp_kernels.CLUSTER)) * weight_bytes(pk16)
    print(f"B1 in bf16 (wgmma), bench fine rows: {ms_16:.3f} ms, {flops / ms_16 / 1e9:.1f} "
          f"TFLOP/s, weights read from L2 at {l2_bytes / ms_16 / 1e9:.2f} TB/s (modelled "
          f"traffic: once forward, once backward per cluster of {mlp_kernels.CLUSTER} 64-row "
          f"blocks)", flush=True)
    records["mlp_fwd_grad"] = kernel_record(
        "mlp_fwd_grad", dict(b1["greenhouse"], err=max(r["err"] for r in b1.values())), 0,
        GH_MEMORY)

    b2 = {"bench coarse": check_render("bench coarse", pk16, pk32,
                                       *subsample_observations(obs, cfg), lat_r, T_r, dev)}
    b2["bench fine"] = check_render("bench fine", pk16, pk32, *_subsample(
        obs, cfg, cfg.fine_frame_stride, cfg.fine_ray_frac, cfg.fine_sample_frac,
        cfg.fine_pts_frac), lat_r, T_r, dev)
    b2["greenhouse"] = check_render("greenhouse", pk16, pk32, obs, gh_cfg, lat_g, T_g, dev)
    records["fused_render"] = kernel_record(
        "fused_render", dict(b2["greenhouse"], err=max(r["err"] for r in b2.values())), 0,
        GH_MEMORY)
    if args.quick:
        print(json.dumps({"kernels": list(records.values())}))
        return 0

    # ---------------- 5. bench path ----------------
    mesher = MeshExtractor(params, spec, voxels_dim=VOXELS, cube_radius=CUBE_RADIUS, device=dev)
    mesher32 = MeshExtractor(params, spec, voxels_dim=VOXELS, cube_radius=CUBE_RADIUS, bf16=False,
                             device=dev)
    split = {}

    def run_bench():
        t0 = time.perf_counter()
        res = retrieval_joint_opt(
            params, spec, cfg, table, obs, T0, CUBE_RADIUS, n_score_pts=128, n_scales=1,
            scale_min=1.0, scale_max=1.0, score_bf16=True, device=dev)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        grids = mesher.decode_grids(res.latent)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        meshes = mesher.meshes_from_grids(grids)
        torch.cuda.synchronize()
        split.update(solve=t1 - t0, decode=t2 - t1, mt=time.perf_counter() - t2)
        return res, [m.transform(T) for m, T in zip(meshes, inverse_poses(res))]

    run_bench()  # warm-up: first launches, cuBLAS/cuSOLVER handles
    times, splits = [], []
    for _ in range(3):
        counts = LaunchCounts()
        t0 = time.perf_counter()
        res, meshes = run_bench()
        times.append(time.perf_counter() - t0)
        counts.read()
        splits.append(dict(split))
    counts.require(LaunchCounts.ALL, "bench path")
    check_result(res, meshes, N_FRUITS, C)
    cd_k = mean_cd_mm(meshes, gts, dev)
    cd_32 = mean_cd_mm([m.transform(T) for m, T in
                        zip(mesher32.extract_batch(res.latent), inverse_poses(res))], gts, dev)
    ms_batch = float(np.median(times)) * 1e3
    print(f"bench path: B={N_FRUITS} synthetic_pepper_32 (9 layers x 512) | retrieval + c2f LM "
          f"+ 40^3 meshing | {ms_batch:.1f} ms/batch (median of {len(times)}: "
          f"{[round(t * 1e3, 1) for t in times]}), {ms_batch / N_FRUITS:.2f} ms/fruit | "
          f"mean iters {float(res.iter_count.float().mean()):.2f} | mean CD-L1 {cd_k:.4f} mm "
          f"(f32 grids of the same codes: {cd_32:.4f} mm) | launches {counts} | {smi}", flush=True)
    med = {k: float(np.median([s[k] for s in splits])) * 1e3 for k in splits[0]}
    print(f"bench path split (median ms): retrieval + LM {med['solve']:.1f}, grid decode "
          f"{med['decode']:.1f}, host marching tetrahedra {med['mt']:.1f}", flush=True)
    if args.profile:
        profile_main(run_bench, smi, args.profile, "bench path")

    with plain_versions():
        run_bench()  # warm-up of the plain path
        t_plain = []
        for _ in range(3):
            t0 = time.perf_counter()
            res_p, meshes_p = run_bench()
            t_plain.append(time.perf_counter() - t0)
    cd_p = mean_cd_mm(meshes_p, gts, dev)
    gap = cd_k - cd_p
    print(f"bench functional gate: mean CD kernels {cd_k:.4f} mm vs plain {cd_p:.4f} mm, gap "
          f"{gap:+.4f} mm (gate {CD_GATE_MM} mm) | plain-path batch "
          f"{np.median(t_plain) * 1e3:.1f} ms (median of 3: {[round(t * 1e3, 1) for t in t_plain]})"
          f" | mean iters plain {float(res_p.iter_count.float().mean()):.2f}", flush=True)
    assert abs(gap) <= CD_GATE_MM, gap

    # ---------------- 6. greenhouse path (this slice's main path) ----------------
    lat_mean = table.mean(0, keepdim=True).expand(N_FRUITS, C).contiguous()
    stages = Stages()

    def run_gh(o, T, lat0, cfg_, n):
        with stages.timing():
            t0 = time.perf_counter()
            res = warmstart_solve(params, spec, cfg_, table, o, lat0, T, CUBE_RADIUS, device=dev)
            meshes = mesher.complete_mesh_batch(res.latent, inverse_poses(res))
            torch.cuda.synchronize()
            stages.t["batch"] = time.perf_counter() - t0
        check_result(res, meshes, n, C)
        return res, meshes

    print(f"greenhouse path: configs/{GREENHOUSE_YAML} (init_mode {gh_cfg.init_mode}, "
          f"{gh_cfg.retrieval_n_scales} scale, {gh_cfg.retrieval_score_pts} points "
          f"{'bf16' if gh_cfg.retrieval_score_bf16 else 'f32'} scoring; max_iter "
          f"{gh_cfg.max_iter}, rot_damp {gh_cfg.rot_damp}, rescue_starts {gh_cfg.rescue_starts}, "
          f"coarse_to_fine {gh_cfg.coarse_to_fine}) | B={N_FRUITS}, {gh_cfg.n_frame} frames x "
          f"{gh_cfg.n_rays} rays x {gh_cfg.n_sample_on_ray} samples, {gh_cfg.recon_n_pts} points",
          flush=True)
    run_gh(obs, T0, lat_mean, gh_cfg, N_FRUITS)  # warm-up
    times, splits = [], []
    while len(times) < (2 if times and times[0] > 10.0 else 3):
        counts = LaunchCounts()
        res, meshes = run_gh(obs, T0, lat_mean, gh_cfg, N_FRUITS)
        counts.read()
        times.append(stages.t["batch"])
        splits.append(stages.split())
    counts.require(LaunchCounts.ALL, "greenhouse path")
    for name, n in counts.n.items():
        records[name]["launches"] = n
    info = dict(warmstart.LAST_RESCUE_INFO)
    cd_gh = mean_cd_mm(meshes, gts, dev)
    ms_batch = float(np.median(times)) * 1e3
    med = {k: float(np.median([s[k] for s in splits])) * 1e3 for k in splits[0]}
    print(f"greenhouse path: {ms_batch:.1f} ms/batch (median of {len(times)}: "
          f"{[round(t * 1e3, 1) for t in times]}), {ms_batch / N_FRUITS:.2f} ms/fruit | "
          f"mean iters {float(res.iter_count.float().mean()):.2f} (converged "
          f"{int(res.converged.sum())}/{N_FRUITS}) | mean CD-L1 {cd_gh:.4f} mm | rescue: "
          f"n_rescued {info.get('n_rescued')}, lanes {info.get('lanes')}, accepted "
          f"{info.get('accepted')} | launches {counts} | {smi}", flush=True)
    print("greenhouse path split (median ms): " + ", ".join(f"{k} {v:.1f}" for k, v in med.items()),
          flush=True)
    if not info.get("n_rescued"):
        # no hard lane: run the rescue's multi-start once, at its own shape
        _, _, top_codes, top_T = retrieval_init_batched(
            params, spec, table, obs.points_w[:4], obs.point_valid[:4], top_k=4,
            n_score_pts=gh_cfg.retrieval_score_pts, n_scales=1, scale_min=1.0, scale_max=1.0,
            T_init=T0[:4])
        o4 = type(obs)(*(a[:4] for a in obs))
        ms_res = multi_start_joint_opt(params, spec, gh_cfg, o4, top_codes, top_T, CUBE_RADIUS,
                                       device=dev)
        assert not bool(ms_res.failed.any()) and bool(torch.isfinite(ms_res.latent).all())
        print(f"greenhouse multi-start (no hard lane in the batch): 4 fruits x K=4 starts, mean "
              f"iters {float(ms_res.iter_count.float().mean()):.2f}", flush=True)
    if args.profile:
        profile_main(lambda: run_gh(obs, T0, lat_mean, gh_cfg, N_FRUITS), smi, args.profile,
                     "greenhouse path")
        with no_lane_skip():
            profile_main(lambda: run_gh(obs, T0, lat_mean, gh_cfg, N_FRUITS), smi, args.profile,
                         "greenhouse path, SDF term without the frozen-lane skip")

    def functional_gate(label, o, T, lat0, cfg_, n, gts_):
        """The path on `o` with the kernels, then with every kernel swapped
        for its plain version: mean Chamfer-L1 within CD_GATE_MM."""
        res_k, meshes_k = run_gh(o, T, lat0, cfg_, n)
        t_k = stages.t["batch"]
        with plain_versions():
            res_p, meshes_p = run_gh(o, T, lat0, cfg_, n)
            t_p = stages.t["batch"]
        cd_k, cd_p = mean_cd_mm(meshes_k, gts_, dev), mean_cd_mm(meshes_p, gts_, dev)
        gap = cd_k - cd_p
        print(f"{label} functional gate: B={n}, mean CD kernels {cd_k:.4f} mm vs plain "
              f"{cd_p:.4f} mm, gap {gap:+.4f} mm (gate {CD_GATE_MM} mm) | batch kernels "
              f"{t_k * 1e3:.1f} ms, plain {t_p * 1e3:.1f} ms | mean iters kernels "
              f"{float(res_k.iter_count.float().mean()):.2f}, plain "
              f"{float(res_p.iter_count.float().mean()):.2f}", flush=True)
        assert abs(gap) <= CD_GATE_MM, (label, gap)

    # ---------------- 7. trust-region path ----------------
    tr_cfg = JointOptConfig.from_dict(load_config(os.path.join(ROOT, "configs", CHALLENGE_YAML)))
    assert tr_cfg.fused_bf16  # the render kernel runs bf16 here, as check_render holds it
    obs_tr, T0_tr, gts_tr = build_batch(spec, tr_cfg, dev, n=N_TR)
    lat_tr = lat_mean[:N_TR]
    # every kernel at the shapes this path gives it: one scoring launch (the
    # batch's fruits x 5 scales against one block of codes), the grid of the
    # retrieved codes, the SDF term and the render term at the retrieved
    # codes and poses
    lat_rt, T_rt = maybe_retrieval_init(params, spec, tr_cfg, table, obs_tr, lat_tr, T0_tr,
                                        device=dev)
    P = tr_cfg.retrieval_score_pts
    pts_tr = (obs_tr.points_w @ T0_tr[:, :3, :3].transpose(1, 2) + T0_tr[:, None, :3, 3])[:, :P]
    scales = torch.linspace(tr_cfg.retrieval_scale_min, tr_cfg.retrieval_scale_max,
                            tr_cfg.retrieval_n_scales, device=dev)
    S = scales.shape[0]
    check_fwd("trust region", pk16 if tr_cfg.retrieval_score_bf16 else pk32,
              table[:(1 << 15) // P],
              (scales[None, :, None, None] * pts_tr[:, None]).reshape(N_TR * S, P, 3),
              obs_tr.point_valid[:, None, :P].expand(N_TR, S, P).reshape(N_TR * S, P),
              spec.clamping_distance)
    check_shared_latent("trust region", params, spec, pk16, pk32, lat_rt, dev, surface=False)
    check_mlp("trust region", pk32, table, N_TR, tr_cfg.recon_n_pts, dev)
    check_render("trust region", pk16, pk32, obs_tr, tr_cfg, lat_rt, T_rt, dev)

    run_gh(obs_tr, T0_tr, lat_tr, tr_cfg, N_TR)  # warm-up
    t_tr = []
    for _ in range(3):
        counts = LaunchCounts()
        res_tr, meshes_tr = run_gh(obs_tr, T0_tr, lat_tr, tr_cfg, N_TR)
        counts.read()
        t_tr.append(stages.t["batch"])
    counts.require(LaunchCounts.ALL, "trust-region path")
    print(f"trust-region path: configs/{CHALLENGE_YAML} (trust_region {tr_cfg.trust_region}, "
          f"{tr_cfg.retrieval_n_scales}-scale retrieval, max_iter {tr_cfg.max_iter}) | B={N_TR}, "
          f"{tr_cfg.n_frame} frames x {tr_cfg.n_rays} rays x {tr_cfg.n_sample_on_ray} samples, "
          f"{tr_cfg.recon_n_pts} points | {np.median(t_tr) * 1e3:.1f} ms/batch (median of 3: "
          f"{[round(t * 1e3, 1) for t in t_tr]}) | mean iters "
          f"{float(res_tr.iter_count.float().mean()):.2f} (converged "
          f"{int(res_tr.converged.sum())}/{N_TR}) | mean CD-L1 {mean_cd_mm(meshes_tr, gts_tr, dev):.4f}"
          f" mm | launches {counts} | {smi}", flush=True)
    functional_gate("trust-region", obs_tr, T0_tr, lat_tr, tr_cfg, N_TR, gts_tr)

    # ---------------- 8. functional gate of the greenhouse path ----------------
    o8 = type(obs)(*(a[:N_GATE] for a in obs))
    functional_gate("greenhouse", o8, T0[:N_GATE], lat_mean[:N_GATE], gh_cfg, N_GATE, gts[:N_GATE])

    # ---------------- 9. wild path ----------------
    wild_path(params, spec, table, pk16, pk32, smi, dev, profile=args.profile)

    # ---------------- 10. challenge path ----------------
    challenge_path(params, spec, table, pk16, pk32, smi, dev, profile=args.profile)

    # ---------------- 11. lab path ----------------
    lab_path(params, spec, table, pk16, pk32, smi, dev, profile=args.profile)

    # ---------------- 12. greenhouse path from disk ----------------
    rows = greenhouse_path(params, spec, table, pk16, pk32, smi, dev, profile=args.profile)

    # ---------------- 13. serving path ----------------
    served = serve_path(params, spec, table, smi, dev, profile=args.profile)
    # the served batches run the bench shapes, held in phases 2-4
    rows += [kernel_record(k, c, served[k], "served batches (bench shapes)")
             for k, c in (("mlp_fwd_grad", b1["bench fine"]), ("fused_render", b2["bench fine"]),
                          ("mlp_fwd", b3["bench"]), ("mlp_shared_latent", b4))]

    # ---------------- 14. training path ----------------
    rows.append(train_path(smi, dev, profile=args.profile))

    # ---------------- 15. asset build and the torch checkpoint ----------------
    asset_path(smi, dev, t_script0)

    # ---------------- 16. the JSON lines ----------------
    print(json.dumps({"kernels": list(records.values()) + rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
