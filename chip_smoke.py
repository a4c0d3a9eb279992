#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Phases (one line each; any failure ends the run with a non-zero exit):
  1. device: the card's name and power limit, torch/CUDA versions, the build
     of both kernel libraries (nvcc, in parallel) and of the host library (g++);
  2. B1, the decoder fwd+input-grad kernel, vs its plain PyTorch version at
     both SDF-term shapes of the main path (coarse 32 x 600 points, fine
     32 x 1200, f32), one line each;
  3. B2, the fused render kernel, vs its plain version at both render shapes
     of the main path (coarse B=32, F=3, R=120, M=10; fine B=32, F=10,
     R=240, M=22) in the working bf16, gated as the repo's fused-kernel gate
     (ROADMAP.md "Rules") plus a per-block check of J^T J, and at each shape
     a small f32 case under a tight tolerance, one line each;
  4. the main path: the bench.py workload (32 synthetic peppers, seed 42) at
     the full width of assets/synthetic_pepper_32 through retrieval warm
     start, coarse-to-fine LM and meshing at 40^3, timed (whole batch, and
     split into solve / grid decode / host marching tetrahedra), with
     Chamfer-L1 against the analytic GT surfaces and the launch counts of
     both kernels; with --profile FILE, one more batch traced by
     torch.profiler (its device-time table written to FILE);
  5. the functional gate: the same solve with the plain versions swapped in
     must reach the same mean Chamfer-L1 within 0.3 mm;
  6. one JSON line per kernel record, then the JSON result line.

Run from the repository root: python3 chip_smoke.py [--quick] [--profile FILE]
(--quick stops after phase 3). The JAX package is never imported.
"""

from __future__ import annotations

import argparse
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
CD_GATE_MM = 0.3
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


def build_batch(spec, cfg, device):
    import numpy as np

    from hortimapping_tpu_torch.optim.state import stack_observations
    from hortimapping_tpu_torch.tools.synthetic import SyntheticCategory, make_scene

    cat = SyntheticCategory(spec=spec, base_radius=0.06)
    rng = np.random.default_rng(42)
    obs_list, T_list, gts = [], [], []
    for b in range(N_FRUITS):
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


def check_mlp(phase, pk32, table, n_rows, dev):
    """B1 in f32 vs its plain version on n_rows [code | xyz] rows (codes of
    the latent table, points at fruit scale); timed, with its bound."""
    import torch

    from hortimapping_tpu_torch.ops import mlp_kernels

    gen = torch.Generator(device=dev).manual_seed(0)
    codes = table[torch.randint(0, table.shape[0], (n_rows,), generator=gen, device=dev)]
    xyz = torch.randn(n_rows, 3, generator=gen, device=dev) * 0.06
    x = torch.cat([codes, xyz], dim=1).contiguous()
    s_k, g_k = mlp_kernels.mlp_sdf_and_input_grad(pk32, x)
    s_p, g_p = mlp_kernels.mlp_sdf_and_input_grad_plain(pk32, x)
    torch.cuda.synchronize()
    err_s = float((s_k - s_p).abs().max())
    err_g = float((g_k - g_p).abs().max())
    g_scale = float(g_p.abs().max())
    # f32 on both sides, sums of up to 512 products in another order
    assert err_s <= 1e-5 and err_g <= 1e-4 * g_scale, (phase, err_s, err_g, g_scale)
    ms = cuda_ms(lambda: mlp_kernels.mlp_sdf_and_input_grad(pk32, x), 20)
    plain_ms = cuda_ms(lambda: mlp_kernels.mlp_sdf_and_input_grad_plain(pk32, x), 5)
    fwd, bwd = chain_macs(pk32)
    flops = 2.0 * (fwd + bwd) * n_rows
    bound_ms, bound_by = bound(n_rows * (2 * pk32.in_dim + 1) * 4 + weight_bytes(pk32), flops,
                               H100_F32_FLOPS)
    print(f"B1 mlp_fwd_grad vs plain, {phase} SDF term: {n_rows} rows f32 | max|d sdf| "
          f"{err_s:.3g} max|d grad| {err_g:.3g} (of {g_scale:.3g}) | kernel {ms:.3f} ms "
          f"({flops / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.3f} ms, bound {bound_ms:.3f} ms "
          f"({bound_by}, f32 CUDA-core peak) | no single PyTorch call", flush=True)
    return dict(x=x, flops=flops, err=max(err_s, err_g), ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by)


def check_render(phase, pk16, pk32, sub_obs, sub_cfg, latent, T_ow, dev):
    """B2 vs its plain version at one LM phase's render shape (its
    subsampled observations and config) with two frozen lanes: bf16 under
    the fused-kernel gate, and a small f32 slice under the tight one;
    timed, with its bound."""
    import torch

    from hortimapping_tpu_torch.ops import render_kernel
    from hortimapping_tpu_torch.ops.render import sample_points
    from hortimapping_tpu_torch.optim.lm import render_geometry

    T_oc, depths, bbx = render_geometry(sub_cfg, sub_obs, T_ow, CUBE_RADIUS)
    pts = sample_points(sub_obs.rays, depths, T_oc).contiguous()
    is_fg = torch.arange(sub_cfg.n_rays, device=dev) < sub_cfg.n_fg_pix
    ray_valid = sub_obs.ray_valid & sub_obs.frame_valid[..., None]
    lane_active = torch.ones(N_FRUITS, dtype=torch.bool, device=dev)
    lane_active[[5, 17]] = False  # frozen lanes exercise the skip
    rkw = dict(pose_dim=sub_cfg.pose_dim, scale_on=sub_cfg.scale_on,
               log_occ_on=sub_cfg.log_sdf_occ, occ_cutoff=sub_cfg.occ_cutoff_m,
               occlusion_on=sub_cfg.occlusion_on, occlusion_th=0.03, min_grad_th=1e-6)
    rargs = (latent, pts, sub_obs.depth_obs, is_fg, ray_valid, depths, bbx, lane_active)
    stats = {}
    want = render_kernel.fused_render_plain(pk16, *rargs, stats=stats, **rkw)
    got = render_kernel.fused_render(pk16, *rargs, **rkw)
    torch.cuda.synchronize()
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
    fwd, bwd = chain_macs(pk16)
    flops = 2.0 * (fwd * stats["active_samples"] + bwd * stats["band_samples"])
    B, F, R, M, _ = pts.shape
    J = sub_cfg.pose_dim + latent.shape[1]
    nbytes = (pts.numel() * 4 + B * F * R * (4 + 1) + R + depths.numel() * 4 + bbx.numel() * 4
              + latent.numel() * 4 + B + weight_bytes(pk16) + B * F * R * (2 * J + 4) * 4)
    bound_ms, bound_by = bound(nbytes, flops, H100_BF16_FLOPS)
    fmt = lambda d: "{" + ", ".join(f"{k} {v:.3g}" for k, v in d.items()) + "}"
    print(f"B2 fused_render vs plain, {phase} phase: B={B} F={F} R={R} M={M} (rays a tile "
          f"{render_kernel.ray_tile(pk16, latent.shape[1], sub_cfg.pose_dim, M)}) bf16 "
          f"{fmt(gates)} (gates {fmt(tol)}) | f32 small {fmt(gates32)} | kernel {ms:.3f} ms, "
          f"plain {plain_ms:.3f} ms, bound {bound_ms:.3f} ms ({bound_by}, bf16 tensor peak; "
          f"{stats['active_samples']} samples fwd, {stats['band_samples']} band samples bwd) "
          f"| no single PyTorch call", flush=True)
    return dict(err=max(float((g - w).abs().max()) for g, w in zip(got, want)), ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)


def profile_main(run, smi, path: str) -> None:
    """Trace one main-path batch with torch.profiler: the device-time table
    goes to `path`, one summary line to stdout."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    dev_us = sum(e.self_device_time_total for e in events if e.device_type == DeviceType.CUDA)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write(f"{smi}\nwall {wall * 1e3:.1f} ms, device busy {dev_us / 1e3:.1f} ms\n")
        f.write(events.table(sort_by="self_cuda_time_total", row_limit=40))
    print(f"profile: one traced batch {wall * 1e3:.1f} ms wall, kernels busy {dev_us / 1e3:.1f} ms "
          f"(device idle share {1 - dev_us / 1e3 / (wall * 1e3):.3f}; table in {path})", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true", help="stop after the kernel phases")
    ap.add_argument("--profile", metavar="FILE",
                    help="also trace one main-path batch with torch.profiler, table to FILE")
    args = ap.parse_args()

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
    from hortimapping_tpu_torch.metrics.chamfer import chamfer_distance
    from hortimapping_tpu_torch.models.workspace import config_decoder, load_latent_vectors
    from hortimapping_tpu_torch.ops import cuda_build, mlp_kernels, render_kernel
    from hortimapping_tpu_torch.ops.mesher import MeshExtractor
    from hortimapping_tpu_torch.optim.lm import _subsample, subsample_observations
    from hortimapping_tpu_torch.optim.warmstart import retrieval_init_batched, retrieval_joint_opt

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
          f"build of both kernel libraries + host library {build_s:.1f} s", flush=True)
    for name in cuda_build.KERNELS:
        for line in cuda_build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")

    params, spec = config_decoder(os.path.join(ROOT, "assets", "synthetic_pepper_32"), device=dev)
    table = load_latent_vectors(os.path.join(ROOT, "assets", "synthetic_pepper_32"), device=dev)
    cfg = bench_cfg()
    C = spec.code_length
    records = []

    # ---------------- 2. B1 vs plain, at the SDF term's two shapes ----------------
    pk32 = mlp_kernels.pack_params(params, spec, torch.float32)
    pk16 = mlp_kernels.pack_params(params, spec, torch.bfloat16)
    b1 = {}
    for phase, frac in (("coarse", cfg.coarse_pts_frac), ("fine", cfg.fine_pts_frac)):
        b1[phase] = check_mlp(phase, pk32, table, N_FRUITS * int(cfg.recon_n_pts * frac), dev)
    # the same chain in bf16 on the tensor cores (the render kernel's mode)
    x, flops = b1["fine"]["x"], b1["fine"]["flops"]
    s16, g16 = mlp_kernels.mlp_sdf_and_input_grad(pk16, x)
    assert bool(torch.isfinite(s16).all()) and bool(torch.isfinite(g16).all())
    ms_16 = cuda_ms(lambda: mlp_kernels.mlp_sdf_and_input_grad(pk16, x), 20)
    # modelled, not counted: each 32-row block reads the weights from L2 once
    # forward and once backward
    l2_bytes = 2 * -(-x.shape[0] // 32) * weight_bytes(pk16)
    print(f"B1 in bf16 (tensor cores), fine rows: {ms_16:.3f} ms, {flops / ms_16 / 1e9:.1f} "
          f"TFLOP/s, weights read from L2 at {l2_bytes / ms_16 / 1e9:.2f} TB/s (modelled "
          f"traffic: once forward, once backward per 32-row block)", flush=True)
    fine = b1["fine"]
    records.append(dict(
        name="mlp_fwd_grad", route="cuda", source="hortimapping_tpu_torch/csrc/mlp_fwd_grad.cu",
        replaces="hortimapping_tpu/ops/pallas_mlp.py:198", launches=0,
        max_abs_err=max(r["err"] for r in b1.values()), ms=fine["ms"], plain_ms=fine["plain_ms"],
        bound_ms=fine["bound_ms"], bound_by=fine["bound_by"], library_ms=None,
    ))

    # ---------------- 3. B2 vs plain, at the render term's two shapes ----------------
    obs, T0, gts = build_batch(spec, cfg, dev)
    lat_r, T_r, _, _ = retrieval_init_batched(
        params, spec, table, obs.points_w, obs.point_valid, n_score_pts=128, n_scales=1,
        scale_min=1.0, scale_max=1.0, T_init=T0, score_bf16=True)
    b2 = {"coarse": check_render("coarse", pk16, pk32, *subsample_observations(obs, cfg),
                                 lat_r, T_r, dev)}
    b2["fine"] = check_render("fine", pk16, pk32, *_subsample(
        obs, cfg, cfg.fine_frame_stride, cfg.fine_ray_frac, cfg.fine_sample_frac,
        cfg.fine_pts_frac), lat_r, T_r, dev)
    fine = b2["fine"]
    records.append(dict(
        name="fused_render", route="cuda", source="hortimapping_tpu_torch/csrc/fused_render.cu",
        replaces="hortimapping_tpu/ops/pallas_render.py:100", launches=0,
        max_abs_err=max(r["err"] for r in b2.values()), ms=fine["ms"], plain_ms=fine["plain_ms"],
        bound_ms=fine["bound_ms"], bound_by=fine["bound_by"], library_ms=None,
    ))
    if args.quick:
        print(json.dumps({"kernels": records}))
        return 0

    # ---------------- 4. main path ----------------
    mesher = MeshExtractor(params, spec, voxels_dim=VOXELS, cube_radius=CUBE_RADIUS, device=dev)

    split = {}

    def run():
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
        return res, meshes

    def mean_cd_mm(res, meshes):
        T_wo = np.linalg.inv(res.T_ow.double().cpu().numpy())
        g = torch.Generator(device=dev).manual_seed(1)
        cds = []
        for mesh, gt, T in zip(meshes, gts, T_wo):
            pts_m = mesh.transform(T).sample_points_uniformly(100_000, g, dev)
            cds.append(chamfer_distance(torch.as_tensor(gt).to(dev), pts_m))
        return float(np.mean(cds)) * 1e3

    run()  # warm-up: first launches, cuBLAS/cuSOLVER handles
    times, splits, counts = [], [], None
    for _ in range(3):
        mlp_kernels.launches = 0
        render_kernel.launches = 0
        t0 = time.perf_counter()
        res, meshes = run()
        times.append(time.perf_counter() - t0)
        counts = (mlp_kernels.launches, render_kernel.launches)
        splits.append(dict(split))
    assert counts[0] > 0 and counts[1] > 0, counts
    assert not bool(res.failed.any())
    assert bool(torch.isfinite(res.latent).all()) and bool(torch.isfinite(res.T_ow).all())
    assert res.latent.shape == (N_FRUITS, C) and len(meshes) == N_FRUITS
    assert all(m.faces.shape[0] > 100 for m in meshes)
    cd_k = mean_cd_mm(res, meshes)
    ms_batch = float(np.median(times)) * 1e3
    records[0]["launches"], records[1]["launches"] = counts
    print(f"main path: B={N_FRUITS} synthetic_pepper_32 (9 layers x 512) | retrieval + c2f LM "
          f"+ 40^3 meshing | {ms_batch:.1f} ms/batch (median of {len(times)}: "
          f"{[round(t * 1e3, 1) for t in times]}), {ms_batch / N_FRUITS:.2f} ms/fruit | "
          f"mean iters {float(res.iter_count.float().mean()):.2f} | mean CD-L1 {cd_k:.4f} mm | "
          f"launches mlp_fwd_grad {counts[0]}, fused_render {counts[1]} | {smi}", flush=True)
    med = {k: float(np.median([s[k] for s in splits])) * 1e3 for k in splits[0]}
    print(f"main path split (median ms): retrieval + LM {med['solve']:.1f}, grid decode "
          f"{med['decode']:.1f}, host marching tetrahedra {med['mt']:.1f}", flush=True)
    if args.profile:
        profile_main(run, smi, args.profile)

    # ---------------- 5. functional gate: plain versions swapped in ----------------
    saved = (mlp_kernels._fwd_grad_cuda, render_kernel._fused_render_cuda)
    mlp_kernels._fwd_grad_cuda = mlp_kernels.chain_plain
    render_kernel._fused_render_cuda = render_kernel.fused_render_plain
    try:
        run()  # warm-up of the plain path
        t_plain = []
        for _ in range(3):
            t0 = time.perf_counter()
            res_p, meshes_p = run()
            t_plain.append(time.perf_counter() - t0)
    finally:
        mlp_kernels._fwd_grad_cuda, render_kernel._fused_render_cuda = saved
    cd_p = mean_cd_mm(res_p, meshes_p)
    gap = cd_k - cd_p
    print(f"functional gate: mean CD kernels {cd_k:.4f} mm vs plain {cd_p:.4f} mm, gap "
          f"{gap:+.4f} mm (gate {CD_GATE_MM} mm) | plain-path batch {np.median(t_plain) * 1e3:.1f} "
          f"ms (median of 3: {[round(t * 1e3, 1) for t in t_plain]}) | "
          f"mean iters plain {float(res_p.iter_count.float().mean()):.2f}", flush=True)
    assert abs(gap) <= CD_GATE_MM, gap

    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
