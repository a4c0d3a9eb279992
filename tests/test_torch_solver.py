"""PyTorch port vs the JAX package: the solver variants of the greenhouse and
challenge paths (trust region, code-frozen pose polish, staged and chunked
solves), the LM objective, the multi-start pick, the selective rescue and
`warmstart_solve` under scaled-down shipped configs, on identical numpy
inputs on the CPU.

The JAX package runs its CPU route (dense render path, XLA decoder); the
port its kernel route with the plain versions (fused render term in f32).
The decoder is the trained 64-wide `synthetic_small_8`, zero-padded to the
128-wide hidden layers the kernels take. Per-lane `iter_count`, `failed`
and `converged` must be equal; latent and pose agree within 2e-4 (f32 sums
over ~10^3 rays and points in another order, compounded over <= 10
iterations; the bench-path solve of `test_torch_slice.py` sits at ~4e-5).

The LM objective is piecewise smooth: a sample crossing a band or in-radius
edge switches its ray in or out, so two states 1e-7 apart can differ in cost
by 1e-5 relative in either package (measured on the JAX package alone). The
trust region reads that cost to adapt its lambda, so such a crossing sends
the two packages down different trajectories. The scenes of the
trajectory tests below (seeds) are ones on which no lane of either package
meets an edge; there the port tracks JAX to ~1e-7. The trust region is also
held on a batch of scenes that were not picked, by what a split trajectory
must still share: the per-lane iteration counts and flags, and the final
objective (`test_trust_region_final_objective_matches_jax`).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hortimapping_tpu import config as jconfig
from hortimapping_tpu.models.decoder import DecoderSpec as JSpec
from hortimapping_tpu.optim import lm as jlm
from hortimapping_tpu.optim import warmstart as jws
from hortimapping_tpu.optim.state import OptResult as JResult
from hortimapping_tpu_torch import config as tconfig
from hortimapping_tpu_torch.models.decoder import DecoderSpec as TSpec
from hortimapping_tpu_torch.models.workspace import params_from_jax
from hortimapping_tpu_torch.optim import lm as tlm
from hortimapping_tpu_torch.optim import warmstart as tws
from hortimapping_tpu_torch.optim.state import OptResult as TResult
from hortimapping_tpu_torch.optim.state import stack_observations
from hortimapping_tpu_torch.parallel.sharding import pad_to_multiple
from hortimapping_tpu_torch.tools.synthetic import SyntheticCategory, make_scene
from torch_port_common import load_npz_params, widen_decoder_np

torch.set_num_threads(1)

CUBE_RADIUS = 0.08
CONFIGS = os.path.join(os.path.dirname(__file__), "..", "configs")
# the observation shapes every case solves at; the fused term in f32 so both
# packages solve the same f32 problem
SHAPES = dict(n_fg_pix=24, n_bg_pix=24, n_frame=3, n_sample_on_ray=12, recon_n_pts=200,
              fused_bf16=False)
BASE = dict(scale_on=True, max_iter=5, lm_lambda_0=0.5, robust_iter=2, **SHAPES)


@pytest.fixture(scope="module")
def small():
    params_np, fields, table, base_radius = load_npz_params("synthetic_small_8")
    params_np, fields = widen_decoder_np(params_np, fields, 128)
    return dict(jp=jax.tree_util.tree_map(jnp.asarray, params_np), jspec=JSpec(**fields),
                tp=params_from_jax(params_np, "cpu"), tspec=TSpec(**fields), table=table,
                base_radius=base_radius)


def _cfgs(**over):
    kw = dict(BASE, **over)
    return jconfig.JointOptConfig(**kw), tconfig.JointOptConfig(**kw)


def _batch(small, seed, n):
    """n synthetic fruits at SHAPES, posed off the origin: (JAX obs, port
    obs, pose inits T_ow0 [n, 4, 4], table-mean codes [n, C])."""
    cat = SyntheticCategory(spec=small["tspec"], base_radius=small["base_radius"])
    rng = np.random.default_rng(seed)
    obs_list, T_list = [], []
    for b in range(n):
        code = (rng.normal(size=small["tspec"].code_length) * 0.3).astype(np.float32)
        T_wo = np.eye(4, dtype=np.float32)
        T_wo[:3, 3] = rng.normal(size=3) * 0.1
        o, _ = make_scene(cat, code, T_wo, SHAPES["n_frame"], SHAPES["n_fg_pix"],
                          SHAPES["n_bg_pix"], SHAPES["recon_n_pts"], seed=seed * 10 + b)
        obs_list.append(o)
        # a pose init 2 cm and a few degrees off the truth
        T0 = np.linalg.inv(T_wo).astype(np.float32)
        T0[:3, 3] += rng.normal(size=3).astype(np.float32) * 0.01
        T_list.append(T0)
    jobs = jax.tree_util.tree_map(lambda *xs: jnp.stack([jnp.asarray(x) for x in xs]), *obs_list)
    lat0 = np.tile(small["table"].mean(0, keepdims=True), (n, 1)).astype(np.float32)
    return jobs, stack_observations(obs_list, "cpu"), np.stack(T_list), lat0


def _assert_same(got, want, atol=2e-4):
    np.testing.assert_array_equal(got.iter_count.numpy(), np.asarray(want.iter_count))
    np.testing.assert_array_equal(got.failed.numpy(), np.asarray(want.failed))
    np.testing.assert_array_equal(got.converged.numpy(), np.asarray(want.converged))
    np.testing.assert_allclose(got.latent.numpy(), np.asarray(want.latent), atol=atol, rtol=0)
    np.testing.assert_allclose(got.T_ow.numpy(), np.asarray(want.T_ow), atol=atol, rtol=0)


def _t(*arrays):
    return [torch.as_tensor(np.array(a)) for a in arrays]


# ---------------------------------------------------------------- solver variants

def test_trust_region_solve_matches_jax(small):
    jc, tc = _cfgs(trust_region=True, lm_lambda_0=0.1, robust_iter=1, max_iter=6)
    jobs, tobs, T0, lat0 = _batch(small, 3, 3)   # lane 1 stops on a convergence test
    want = jlm.shape_pose_joint_opt_batched(small["jp"], small["jspec"], jc, jobs,
                                            jnp.asarray(lat0), jnp.asarray(T0), CUBE_RADIUS)
    got = tlm.shape_pose_joint_opt_batched(small["tp"], small["tspec"], tc, tobs, *_t(lat0, T0),
                                           CUBE_RADIUS, device="cpu")
    _assert_same(got, want)
    assert got.converged.tolist() == [False, True, False]


def test_trust_region_final_objective_matches_jax(small):
    """16 scenes of the first seed, not picked: some lanes split from the
    JAX trajectory at an edge crossing. Per lane, `iter_count`, `failed` and
    `converged` must be equal, and the final LM objective within 10 % of the
    starting one of JAX's final (a split ends elsewhere on the same descent:
    over 160 lanes of 40 seeds at this size, `tests/torch_tr_scan.py`, the
    worst was 4.7 %, the port lower on 19 lanes and higher on 13, every
    count and flag equal). The mean of those signed gaps must lie within
    1 % (it was -0.04 % over the 160 lanes): no bias."""
    jc, tc = _cfgs(trust_region=True, lm_lambda_0=0.1, robust_iter=1, max_iter=8)
    jobs, tobs, T0, lat0 = _batch(small, 0, 16)
    want = jlm.shape_pose_joint_opt_batched(small["jp"], small["jspec"], jc, jobs,
                                            jnp.asarray(lat0), jnp.asarray(T0), CUBE_RADIUS)
    got = tlm.shape_pose_joint_opt_batched(small["tp"], small["tspec"], tc, tobs, *_t(lat0, T0),
                                           CUBE_RADIUS, device="cpu")
    np.testing.assert_array_equal(got.iter_count.numpy(), np.asarray(want.iter_count))
    np.testing.assert_array_equal(got.failed.numpy(), np.asarray(want.failed))
    np.testing.assert_array_equal(got.converged.numpy(), np.asarray(want.converged))
    f0 = tws.objective_value_batched(small["tp"], small["tspec"], tc, tobs, *_t(lat0, T0),
                                     CUBE_RADIUS, device="cpu").numpy()
    f_t = tws.objective_value_batched(small["tp"], small["tspec"], tc, tobs, got.latent,
                                      got.T_ow, CUBE_RADIUS, device="cpu").numpy()
    f_j = np.asarray(jws.objective_value_batched(small["jp"], small["jspec"], jc, jobs,
                                                 want.latent, want.T_ow, CUBE_RADIUS))
    assert np.all(f_t < 0.5 * f0) and np.all(f_j < 0.5 * f0)   # both solves descend
    gap = (f_t - f_j) / f0
    assert np.abs(gap).max() <= 0.1, gap
    assert abs(gap.mean()) <= 0.01, gap


def test_pose_polish_matches_jax(small):
    jc, tc = _cfgs(pose_polish_iters=3)
    jobs, tobs, T0, lat0 = _batch(small, 2, 2)
    main = jlm.shape_pose_joint_opt_batched(small["jp"], small["jspec"], jc, jobs,
                                            jnp.asarray(lat0), jnp.asarray(T0), CUBE_RADIUS)
    # lane 1 failed the main solve: it must not polish
    main = main._replace(failed=jnp.asarray([False, True]))
    want = jlm.maybe_pose_polish(small["jp"], small["jspec"], jc, jobs, main, CUBE_RADIUS)
    got = tlm.maybe_pose_polish(small["tp"], small["tspec"], tc, tobs, TResult(*_t(*main)),
                                CUBE_RADIUS, device="cpu")
    _assert_same(got, want)
    assert int(got.iter_count[0]) > int(main.iter_count[0])           # lane 0 polished
    assert int(got.iter_count[1]) == int(main.iter_count[1])          # lane 1 did not
    np.testing.assert_array_equal(got.latent.numpy(), np.asarray(main.latent))  # code frozen
    assert not np.allclose(got.T_ow[0].numpy(), np.asarray(main.T_ow[0]))       # pose moved


def test_staged_joint_opt_matches_jax(small):
    jc, tc = _cfgs(max_iter=6)
    jobs, tobs, T0, lat0 = _batch(small, 3, 3)
    want = jlm.staged_joint_opt(small["jp"], small["jspec"], jc, jobs, jnp.asarray(lat0),
                                jnp.asarray(T0), CUBE_RADIUS, stage1_iters=2)
    got = tlm.staged_joint_opt(small["tp"], small["tspec"], tc, tobs, *_t(lat0, T0), CUBE_RADIUS,
                               stage1_iters=2, device="cpu")
    _assert_same(got, want)
    assert int(got.iter_count.max()) > 2   # some lane went on to stage 2


def test_solve_in_chunks_pads_the_last_chunk(small):
    jc, tc = _cfgs(max_iter=4)
    jobs, tobs, T0, lat0 = _batch(small, 4, 3)
    want = jlm.solve_in_chunks(small["jp"], small["jspec"], jc, jobs, jnp.asarray(lat0),
                               jnp.asarray(T0), CUBE_RADIUS, max_batch=2)
    got = tlm.solve_in_chunks(small["tp"], small["tspec"], tc, tobs, *_t(lat0, T0), CUBE_RADIUS,
                              max_batch=2, device="cpu")
    _assert_same(got, want)
    assert got.latent.shape[0] == 3 and not bool(got.failed.any())
    # the padded lanes of the last chunk fail at their first iteration
    obs_p, lat_p, T_p, n = pad_to_multiple(tlm.FruitObservations(*(a[2:] for a in tobs)),
                                           *_t(lat0[2:], T0[2:]), 2)
    assert n == 1 and lat_p.shape[0] == 2
    pad = tlm.shape_pose_joint_opt_batched(small["tp"], small["tspec"], tc, obs_p, lat_p, T_p,
                                           CUBE_RADIUS, device="cpu")
    assert pad.failed.tolist() == [False, True] and pad.iter_count.tolist()[1] == 0


# ---------------------------------------------------------------- warm starts

def test_objective_value_matches_jax(small):
    jc, tc = _cfgs()
    jobs, tobs, T0, lat0 = _batch(small, 5, 3)
    lat = lat0 + np.random.default_rng(0).normal(size=lat0.shape).astype(np.float32) * 0.1
    # lane 2 sees nothing: its objective is +inf
    fv = np.asarray(jobs.frame_valid).copy()
    fv[2] = False
    jobs = jobs._replace(frame_valid=jnp.asarray(fv))
    tobs = tobs._replace(frame_valid=torch.as_tensor(fv))
    want = np.asarray(jws.objective_value_batched(small["jp"], small["jspec"], jc, jobs,
                                                  jnp.asarray(lat), jnp.asarray(T0), CUBE_RADIUS))
    got = tws.objective_value_batched(small["tp"], small["tspec"], tc, tobs, *_t(lat, T0),
                                      CUBE_RADIUS, device="cpu").numpy()
    assert np.isinf(got[2]) and np.isinf(want[2])
    np.testing.assert_allclose(got[:2], want[:2], rtol=2e-5, atol=0)


def test_multi_start_picks_the_same_start(small):
    jc, tc = _cfgs(max_iter=4)
    jobs, tobs, T0, _ = _batch(small, 6, 2)
    _, _, top_codes, top_T = jws.retrieval_init_batched(
        small["jp"], small["jspec"], jnp.asarray(small["table"]), jobs.points_w,
        jobs.point_valid, top_k=3, n_score_pts=64, n_scales=1, scale_min=1.0, scale_max=1.0,
        T_init=jnp.asarray(T0))
    want = jws.multi_start_joint_opt(small["jp"], small["jspec"], jc, jobs, top_codes, top_T,
                                     CUBE_RADIUS)
    got = tws.multi_start_joint_opt(small["tp"], small["tspec"], tc, tobs, *_t(top_codes, top_T),
                                    CUBE_RADIUS, device="cpu")
    _assert_same(got, want)
    # the pick is the start whose solve ends lowest: one of the K solves
    single = tlm.solve_in_chunks(small["tp"], small["tspec"], tc,
                                 tlm.FruitObservations(*(a.repeat_interleave(3, 0) for a in tobs)),
                                 *_t(np.asarray(top_codes).reshape(6, -1),
                                     np.asarray(top_T).reshape(6, 4, 4)), CUBE_RADIUS,
                                 device="cpu")
    for b in range(2):
        assert any(torch.equal(got.latent[b], single.latent[3 * b + k]) for k in range(3))


def test_selective_rescue_matches_jax(small):
    """A batch with hand-marked hard lanes (as tests/test_warmstart.py builds
    it): lane 0 converged, lanes 1-2 unconverged with a far-off code. Both
    packages re-solve the same lanes and accept the same rescues."""
    jc, tc = _cfgs(init_mode="retrieval", rescue_starts=3, retrieval_score_pts=64,
                   retrieval_n_scales=1, retrieval_scale_min=1.0, retrieval_scale_max=1.0)
    jobs, tobs, T0, lat0 = _batch(small, 7, 3)
    good = jlm.solve_in_chunks(small["jp"], small["jspec"], jc, jobs, jnp.asarray(lat0),
                               jnp.asarray(T0), CUBE_RADIUS)
    res = JResult(latent=good.latent.at[1:].add(5.0), T_ow=good.T_ow, iter_count=good.iter_count,
                  failed=jnp.zeros(3, bool), converged=jnp.array([True, False, False]))
    table = small["table"]
    want, winfo = jws.selective_rescue(small["jp"], small["jspec"], jc, jobs, res,
                                       jnp.asarray(table), jnp.asarray(T0), CUBE_RADIUS)
    got, tinfo = tws.selective_rescue(small["tp"], small["tspec"], tc, tobs, TResult(*_t(*res)),
                                      *_t(table, T0), CUBE_RADIUS, device="cpu")
    for key in ("n_total", "n_rescued", "lanes", "unconverged", "outliers", "accepted"):
        assert tinfo[key] == winfo[key], key
    assert tinfo["lanes"] == [1, 2] and tinfo["accepted"] == [0, 1]
    np.testing.assert_allclose(tinfo["cost_before"], winfo["cost_before"], rtol=2e-5)
    np.testing.assert_allclose(tinfo["cost_after"], winfo["cost_after"], rtol=2e-3)
    _assert_same(got, want)
    np.testing.assert_array_equal(got.latent[0].numpy(), np.asarray(res.latent[0]))


def _shipped(name, **over):
    """A shipped config through both packages' loaders, cut to SHAPES."""
    jc = jconfig.JointOptConfig.from_dict(jconfig.load_config(os.path.join(CONFIGS, name)))
    tc = tconfig.JointOptConfig.from_dict(tconfig.load_config(os.path.join(CONFIGS, name)))
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    over = dict(SHAPES, **over)
    return dataclasses.replace(jc, **over), dataclasses.replace(tc, **over)


# greenhouse: retrieval at unit scale, rot_damp, selective rescue from 4
# starts; challenge: 5-scale retrieval, trust region
SHIPPED = {
    "greenhouse": ("cka_pepper_tpu.yaml", dict(max_iter=4, retrieval_score_pts=64)),
    "challenge": ("shape_completion_challenge_pepper_tpu.yaml",
                  dict(max_iter=5, retrieval_score_pts=64)),
}


@pytest.mark.parametrize("case", list(SHIPPED))
def test_warmstart_solve_matches_jax(small, case):
    name, over = SHIPPED[case]
    jc, tc = _shipped(name, **over)
    jobs, tobs, T0, lat0 = _batch(small, 8, 2)
    table = small["table"]
    want = jws.warmstart_solve(small["jp"], small["jspec"], jc, jnp.asarray(table), jobs,
                               jnp.asarray(lat0), jnp.asarray(T0), CUBE_RADIUS)
    winfo = dict(jws.LAST_RESCUE_INFO)
    got = tws.warmstart_solve(small["tp"], small["tspec"], tc, torch.as_tensor(table), tobs,
                              *_t(lat0, T0), CUBE_RADIUS, device="cpu")
    tinfo = tws.LAST_RESCUE_INFO
    _assert_same(got, want)
    if case == "greenhouse":
        assert tc.rescue_starts == 4 and tc.rot_damp > 0
        for key in ("lanes", "outliers", "accepted"):
            assert tinfo[key] == winfo[key], key
        assert tinfo["n_rescued"] > 0   # the 4-iteration budget leaves lanes unconverged
    else:
        assert tc.trust_region and tinfo == {}
