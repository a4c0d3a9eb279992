"""The LM iteration's sync-free pieces on the CPU: the closed-form 3x3
determinant and 4x4 affine inverse against `torch.linalg`, the solve's CPU
route, and `lm_iteration` split into the segments the card replays as CUDA
graphs, held bit for bit to the iteration written as one function.

The card's side (the solve kernel, the capture, graphs on against off) is
in `tests/test_torch_card.py`. This file imports neither JAX nor the JAX
package.
"""

import math

import numpy as np
import pytest
import torch

from hortimapping_tpu_torch.config import JointOptConfig
from hortimapping_tpu_torch.models.decoder import DecoderSpec
from hortimapping_tpu_torch.models.workspace import params_from_jax
from hortimapping_tpu_torch.ops import linalg
from hortimapping_tpu_torch.ops.lie import exp_se3, exp_sim3_ref, rotation_matrix_to_angle
from hortimapping_tpu_torch.ops.recon import sdf_residuals
from hortimapping_tpu_torch.ops.render import render_residuals
from hortimapping_tpu_torch.optim import lm
from hortimapping_tpu_torch.optim.state import OptState, init_state, stack_observations
from hortimapping_tpu_torch.tools.synthetic import SyntheticCategory, make_scene
from hortimapping_tpu_torch.utils import trace
from torch_port_common import load_npz_params, widen_decoder_np

torch.set_num_threads(1)

CUBE_RADIUS = 0.08
SHAPES = dict(n_fg_pix=24, n_bg_pix=24, n_frame=3, n_sample_on_ray=12, recon_n_pts=200)


def _sim3(rng, n, scale_lo, scale_hi, drift):
    """n Sim(3) matrices [n, 4, 4] (random rotation, scale, translation)
    with `drift` of noise on the 3x4 block, as LM updates leave them."""
    w = torch.as_tensor(rng.normal(size=(n, 6)) * [0.1, 0.1, 0.1, 1.0, 1.0, 1.0],
                        dtype=torch.float32)
    T = exp_se3(w)
    s = torch.as_tensor(rng.uniform(scale_lo, scale_hi, size=n), dtype=torch.float32)
    T[:, :3, :3] *= s[:, None, None]
    T[:, :3, :] += torch.as_tensor(rng.normal(size=(n, 3, 4)) * drift, dtype=torch.float32)
    return T


def _rel(got, want):
    return float((got.double() - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("case", ["drifted", "small_scale", "near_singular"])
def test_det3_and_inv4_match_torch_linalg(case):
    """det3 and inv4 against torch.linalg in f32, both held to a float64
    inverse: the closed forms are no less accurate than the LU's. Near a
    singular block (one direction squashed to 1e-4) both lose the same
    digits to its condition."""
    rng = np.random.default_rng({"drifted": 0, "small_scale": 1, "near_singular": 2}[case])
    if case == "near_singular":
        T = _sim3(rng, 64, 0.8, 1.2, 0.0)
        T[:, :3, 2] = T[:, :3, 1] * 1.5 + T[:, :3, 2] * 1e-4
    else:
        scale = (0.8, 1.25) if case == "drifted" else (1e-3, 2e-3)
        T = _sim3(rng, 64, *scale, 1e-3 if case == "drifted" else 0.0)
    T64 = T.double()
    det64 = torch.linalg.det(T64[:, :3, :3])
    inv64 = torch.linalg.inv(T64)
    for got, ref in ((linalg.det3(T[:, :3, :3]), torch.linalg.det(T[:, :3, :3])),):
        err, err_ref = _rel(got, det64), _rel(ref, det64)
        assert err <= max(4 * err_ref, 1e-6), (err, err_ref)
    got, ref = linalg.inv4(T), torch.linalg.inv(T)
    err, err_ref = _rel(got, inv64), _rel(ref, inv64)
    assert err <= max(4 * err_ref, 1e-6), (err, err_ref)
    assert torch.equal(got[:, 3], torch.tensor([0.0, 0.0, 0.0, 1.0]).expand(64, 4))
    # the CPU routes keep torch.linalg's own numbers
    assert torch.equal(linalg.det(T[:, :3, :3]), torch.linalg.det(T[:, :3, :3]))
    assert torch.equal(linalg.inv(T), torch.linalg.inv(T))


def test_solve_on_the_cpu_is_solve_ex_and_a_singular_lane_is_not_finite():
    rng = np.random.default_rng(3)
    A = torch.as_tensor(rng.normal(size=(5, 39, 39)), dtype=torch.float32)
    H = A @ A.transpose(1, 2) + 0.1 * torch.eye(39)
    H[2, :7] = 0.0
    H[2, :, :7] = 0.0   # a lane with nothing observed: its pose block is zero
    b = torch.as_tensor(rng.normal(size=(5, 39)), dtype=torch.float32)
    x = linalg.solve(H, b)
    torch.testing.assert_close(x, torch.linalg.solve_ex(H, b[..., None])[0][..., 0], rtol=0,
                               atol=0, equal_nan=True)
    finite = torch.isfinite(x).all(-1)
    assert finite.tolist() == [True, True, False, True, True]


@pytest.fixture(scope="module")
def small():
    params_np, fields, table, base_radius = load_npz_params("synthetic_small_8")
    params_np, fields = widen_decoder_np(params_np, fields, 128)
    spec = DecoderSpec(**fields)
    cat = SyntheticCategory(spec=spec, base_radius=base_radius)
    rng = np.random.default_rng(5)
    obs_list, T_list = [], []
    for b in range(4):
        code = (rng.normal(size=spec.code_length) * 0.3).astype(np.float32)
        T_wo = np.eye(4, dtype=np.float32)
        T_wo[:3, 3] = rng.normal(size=3) * 0.1
        o, _ = make_scene(cat, code, T_wo, SHAPES["n_frame"], SHAPES["n_fg_pix"],
                          SHAPES["n_bg_pix"], SHAPES["recon_n_pts"], seed=50 + b)
        obs_list.append(o)
        T0 = np.linalg.inv(T_wo).astype(np.float32)
        T0[:3, 3] += rng.normal(size=3).astype(np.float32) * 0.01
        T_list.append(T0)
    obs = stack_observations(obs_list, "cpu")
    lat0 = torch.as_tensor(np.tile(table.mean(0, keepdims=True), (4, 1)).astype(np.float32))
    return dict(params=params_from_jax(params_np, "cpu"), spec=spec, obs=obs, lat0=lat0,
                T0=torch.as_tensor(np.stack(T_list)))


def _iteration_as_one_function(params, spec, cfg, obs, state, cube_radius, pose_known, packs,
                               code_known):
    """The fixed-lambda LM iteration written as one function, with
    torch.linalg's det, inverse and solve: the arithmetic the segments of
    `lm.lm_iteration` must keep on the CPU."""
    pose_dim = cfg.pose_dim
    i, latent, T_ow = state.i, state.latent, state.T_ow
    lane_active = ~(state.done | state.failed)
    B, C = latent.shape
    D = pose_dim + C
    f32 = torch.float32
    is_fg = torch.arange(cfg.n_rays) < cfg.n_fg_pix
    cur_scale = torch.linalg.det(T_ow[:, :3, :3]) ** (-1.0 / 3.0)
    T_oc = T_ow[:, None] @ obs.T_wc
    T_co = torch.linalg.inv(T_oc)
    depth_range = (cube_radius * cur_scale)[:, None].expand(T_co.shape[:2])
    depths = lm._linspace(T_co[..., 2, 3] - 1.0 * depth_range,
                          T_co[..., 2, 3] + 0.8 * depth_range, cfg.n_sample_on_ray)
    rr = render_residuals(params, spec, latent, obs.rays, is_fg,
                          obs.ray_valid & obs.frame_valid[..., None], obs.depth_obs, T_oc, depths,
                          depth_range, lm._render_config(cfg, spec), lane_active, packs.render)
    obs_count = rr.ray_ok.sum((1, 2)).to(f32)
    failed = obs_count == 0.0
    robust_active = i >= cfg.robust_iter
    w2_d = lm._robust_w2(rr.res_d, cfg.render_robust_th_m, robust_active[:, None, None])
    H_d, b_d = lm._term_normal_eq(rr.jac_d, rr.res_d, w2_d, obs_count, cfg.w_depth)
    H_m, b_m = lm._term_normal_eq(rr.jac_m, rr.res_m, torch.ones_like(rr.res_m), obs_count,
                                  cfg.w_mask)
    pts_o = obs.points_w @ T_ow[:, :3, :3].transpose(1, 2) + T_ow[:, None, :3, 3]
    rec = sdf_residuals(params, spec, latent, pts_o, obs.point_valid, cfg.scale_on, packs.sdf,
                        lane_active)
    recon_count = obs.point_valid.sum(-1).to(f32)
    w2_r = lm._robust_w2(rec.res, cfg.recon_robust_th_m, robust_active[:, None])
    H_r, b_r = lm._term_normal_eq(rec.jac, rec.res, w2_r, recon_count, cfg.w_recon)
    code_mask = (torch.arange(D) >= pose_dim).to(f32)
    H_c = torch.diag(cfg.w_codereg * code_mask)
    b_c = torch.cat([torch.zeros(B, pose_dim, dtype=f32), -cfg.w_codereg * latent], 1)
    H = H_d + H_m + H_r + H_c
    if cfg.scale_on:
        H[:, pose_dim - 1, pose_dim - 1] += cfg.s_damp
    if cfg.yaw_damp > 0.0:
        H[:, 4, 4] += cfg.yaw_damp
    if cfg.rot_damp > 0.0:
        idx = torch.arange(3, 6)
        H[:, idx, idx] += cfg.rot_damp
    b = b_d + b_m + b_r + b_c
    H = lm.apply_lm_damping(H, cfg)

    delta = torch.linalg.solve_ex(H, b[..., None])[0][..., 0].clone()
    if pose_known:
        delta[:, :6] = 0.0
    if code_known:
        delta[:, pose_dim:] = 0.0
    delta_p, delta_c = delta[:, :pose_dim], delta[:, pose_dim:]
    delta_T = exp_sim3_ref(delta_p) if cfg.scale_on else exp_se3(delta_p)
    latent_new, T_new = latent + delta_c, delta_T @ T_ow
    scale_new = torch.linalg.det(T_new[:, :3, :3]) ** (-1.0 / 3.0)
    delta_scale = torch.linalg.det(delta_T[:, :3, :3]) ** (1.0 / 3.0)
    delta_tran = torch.linalg.norm(delta_T[:, :3, 3], dim=-1) * scale_new
    delta_rot = rotation_matrix_to_angle(delta_T[:, :3, :3] * scale_new[:, None, None]) * 180.0 / math.pi
    past = i > 1
    conv_g = (b.abs().max(-1).values < cfg.epsilon_g) & past
    conv_c = ((delta_c / (latent_new + 1e-12)).abs().max(-1).values < cfg.epsilon_c) & past
    if code_known:
        conv_c = torch.zeros_like(conv_c)
    conv_p = ((delta_tran < cfg.epsilon_t) & (delta_rot < cfg.epsilon_r)
              & (delta_scale < cfg.epsilon_s) & past)
    if pose_known:
        conv_p = torch.zeros_like(conv_p)
    conv = conv_g | conv_c | conv_p
    done = conv | (i >= cfg.max_iter - 1)
    keep = failed
    return OptState(torch.where(keep[:, None], latent, latent_new),
                    torch.where(keep[:, None, None], T_ow, T_new),
                    torch.where(keep, i, i + 1), torch.where(keep, state.iter_count, i + 1),
                    done | keep, keep, torch.where(keep, state.converged, conv))


@pytest.mark.parametrize("case", ["sim3", "se3_rot_damp", "pose_known", "code_known"])
def test_cpu_iteration_is_bit_equal_to_one_function(small, case):
    """Five iterations of `lm.lm_iteration` on the CPU, from a state with a
    lane done and a lane with no valid frame, equal the one-function
    iteration bit for bit at every step, across the robust-weight switch."""
    over = dict(se3_rot_damp=dict(scale_on=False, rot_damp=0.3, yaw_damp=0.1)).get(case, {})
    cfg = JointOptConfig(max_iter=6, robust_iter=2, lm_lambda_0=0.5, fused_bf16=False,
                         **dict(SHAPES, **over))
    pose_known, code_known = case == "pose_known", case == "code_known"
    obs = small["obs"]
    obs = obs._replace(frame_valid=obs.frame_valid.clone())
    obs.frame_valid[3] = False
    s = init_state(small["lat0"], small["T0"])
    s = s._replace(done=torch.tensor([False, True, False, False]))
    packs = lm.make_packs(small["params"], small["spec"], cfg)
    for _ in range(5):
        got = lm.lm_iteration(small["params"], small["spec"], cfg, obs, s, CUBE_RADIUS,
                              pose_known, packs, code_known)
        want = _iteration_as_one_function(small["params"], small["spec"], cfg, obs, s,
                                          CUBE_RADIUS, pose_known, packs, code_known)
        for name, g, w in zip(OptState._fields, got, want):
            assert torch.equal(g, w), name
        # lane 1, done, is skipped by the kernels and reads as failed; lane 3
        # has no valid frame
        assert got.failed.tolist() == [False, True, False, True]
        s = lm._freeze_if_done(s, got)


def test_iteration_spans_say_no_graph_off_the_card(small):
    """While tracing, every `lm.iteration` of a CPU solve carries graph 0,
    and no key is kept: graphs are for the card alone."""
    cfg = JointOptConfig(max_iter=3, robust_iter=1, lm_lambda_0=0.5, **SHAPES)
    trace.force(True)
    try:
        lm.shape_pose_joint_opt_batched(small["params"], small["spec"], cfg, small["obs"],
                                        small["lat0"], small["T0"], CUBE_RADIUS, device="cpu")
        its = [s for s in trace.spans() if s.name == "lm.iteration"]
    finally:
        trace.force(None)
    assert its and all(s.attrs["graph"] == 0 for s in its)
    assert not lm._graphed


def test_solve_kernel_refuses_a_system_wider_than_it_takes():
    """The card's route takes D <= MAX_SOLVE_DIM and refuses a wider system
    by name before it launches, rather than giving way to another solve."""
    D = linalg.MAX_SOLVE_DIM + 1
    H = torch.eye(D).expand(2, D, D).contiguous()
    with pytest.raises(ValueError, match=f"D <= {linalg.MAX_SOLVE_DIM}, got {D}"):
        linalg._solve_cuda(H, torch.ones(2, D))


def test_a_replaced_normal_equations_assembles_the_iteration(small, monkeypatch):
    """The iteration's one hook: a function in place of
    `lm.normal_equations` is called once an iteration with the state's
    iterate and active lanes, and its (H, b) are what the step solves;
    the iteration then carries graph 0."""
    cfg = JointOptConfig(max_iter=3, robust_iter=1, lm_lambda_0=0.5, fused_bf16=False, **SHAPES)
    s = init_state(small["lat0"], small["T0"])
    s = s._replace(done=torch.tensor([False, True, False, False]))
    packs = lm.make_packs(small["params"], small["spec"], cfg)
    args = (small["params"], small["spec"], cfg, small["obs"])
    want = lm.lm_iteration(*args, s, CUBE_RADIUS, False, packs)
    orig, calls = lm.normal_equations, []

    def halved(*a, **k):
        calls.append(a[8].clone())
        H, b, failed = orig(*a, **k)
        return H, 0.5 * b, failed

    monkeypatch.setattr(lm, "normal_equations", halved)
    trace.force(True)
    try:
        with trace.span("lm.iteration"):
            got = lm.lm_iteration(*args, s, CUBE_RADIUS, False, packs)
        its = [sp for sp in trace.spans() if sp.name == "lm.iteration"]
    finally:
        trace.force(None)
    assert len(calls) == 1 and calls[0].tolist() == [True, False, True, True]
    assert its[-1].attrs["graph"] == 0
    moved = ~got.failed
    # half of b is half the step: the code moves half as far
    torch.testing.assert_close(got.latent[moved] - s.latent[moved],
                               0.5 * (want.latent[moved] - s.latent[moved]), rtol=1e-4, atol=1e-7)
