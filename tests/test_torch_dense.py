"""PyTorch port vs the JAX package: the dense render route (the fused
render kernel's plain version and the route of a decoder the kernel does
not take), on the CPU.

* `render_residuals` against JAX's, vmapped over frames and lanes: B = 2
  lanes x F = 2 frames with padded rays and a bg ray without depth, Sim(3)
  and SE(3), linear and logistic occupancy;
* the port's plain bf16 forward chain (B3's plain version) against JAX's
  bf16 `decoder_apply`;
* the normal equations (decoder plain and through the packed chain), each
  LM iteration and a short coarse-to-fine solve on
  `tests/test_torch_slice.py`'s bench fixture with `fused_render: false`;
* the fused route's condition `pose_dim + C <= 128` (a C = 122 code under
  Sim(3) takes the dense route in both packages);
* the JAX package's compacted render route (`opt.tpu.jac_cap`, `fwd_cap`,
  `fwd_bf16`), which the port does not have: no YAML in `configs/` sets it,
  and a config that does is refused by name before any solve.

Tolerances. f32 on both sides with sums in other orders: values within 2e-5
of each output's largest magnitude (or of 0.05, where all are smaller), the
boolean outputs equal (as `tests/test_torch_render.py`). The bf16 forward:
XLA's bf16 dot and the port's bf16-rounded operands give the same products
summed in another order (measured: median |d sdf| 2e-9, max 1.6e-4 over
5000 rows).
"""

import dataclasses
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hortimapping_tpu import config as jconfig
from hortimapping_tpu.models.decoder import DecoderSpec as JSpec
from hortimapping_tpu.models.decoder import decoder_apply as japply
from hortimapping_tpu.ops import render as jrender_mod
from hortimapping_tpu.ops.render import RenderConfig as JRC
from hortimapping_tpu.ops.render import render_residuals as jrender
from hortimapping_tpu.optim import lm as jlm
from hortimapping_tpu.optim import state as jstate
from hortimapping_tpu.optim.lm import normal_equations as jne
from hortimapping_tpu.optim.warmstart import retrieval_joint_opt as jsolve
from hortimapping_tpu_torch import config as tconfig
from hortimapping_tpu_torch import serve as tserve
from hortimapping_tpu_torch.models.decoder import DecoderSpec as TSpec
from hortimapping_tpu_torch.models.workspace import params_from_jax
from hortimapping_tpu_torch.ops import mlp_kernels
from hortimapping_tpu_torch.ops import render as trender_mod
from hortimapping_tpu_torch.ops.render import RenderConfig as TRC
from hortimapping_tpu_torch.ops.render import render_residuals as trender
from hortimapping_tpu_torch.ops.render import takes_fused
from hortimapping_tpu_torch.optim import lm as tlm
from hortimapping_tpu_torch.optim import state as tstate
from hortimapping_tpu_torch.optim import warmstart as twarm
from hortimapping_tpu_torch.optim.lm import normal_equations as tne
from hortimapping_tpu_torch.optim.warmstart import retrieval_init_batched as tinit
from hortimapping_tpu_torch.optim.warmstart import retrieval_joint_opt as tsolve
from test_torch_slice import CUBE_RADIUS, RETRIEVAL, _batch, _cfg_kwargs, small  # noqa: F401
from torch_port_common import random_decoder_np

torch.set_num_threads(1)

FIELDS = dict(code_length=8, dims=(128,) * 4, latent_in=(2,), clamping_distance=0.1)
TOL = 2e-5
B, F, R_FG, R_BG, M = 2, 2, 20, 20, 24
CONFIGS = sorted(glob.glob(os.path.join(os.path.dirname(__file__), "..", "configs", "*.yaml")))


@pytest.fixture(scope="module")
def world():
    params_np = random_decoder_np(JSpec(**FIELDS), 1)
    return jax.tree_util.tree_map(jnp.asarray, params_np), params_from_jax(params_np, "cpu")


def _scenes(seed):
    """B lanes x F frames of rays around a fruit-sized object, numpy: rays,
    ray_valid, depth_obs, T_oc, sampled depths, bbx radius, latents."""
    rng = np.random.default_rng(seed)
    R = R_FG + R_BG
    rays = np.empty((B, F, R, 3), np.float32)
    depth_obs = np.empty((B, F, R), np.float32)
    T_oc = np.empty((B, F, 4, 4), np.float32)
    for b in range(B):
        for f in range(F):
            ang = np.concatenate([rng.normal(size=(R_FG, 2)) * 0.08,
                                  rng.normal(size=(R_BG, 2)) * 0.35])
            rays[b, f] = np.concatenate([ang, np.ones((R, 1))], axis=-1)
            depth_obs[b, f] = 0.3 + rng.normal(size=R) * 0.03
            depth_obs[b, f, R_FG + 2] = 0.0  # a bg ray without depth
            T_co = np.eye(4)
            T_co[:3, 3] = [0.01 * b, -0.02 + 0.01 * f, 0.3]
            a = 0.2 + 0.3 * f + 0.1 * b
            T_co[:3, :3] = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                                     [0, 0, 1]]) * (1.1 - 0.05 * b)
            T_oc[b, f] = np.linalg.inv(T_co)
    ray_valid = np.ones((B, F, R), bool)
    ray_valid[1, 1, 35:] = False      # padded rays
    depths = np.broadcast_to(np.linspace(0.2, 0.42, M, dtype=np.float32), (B, F, M)).copy()
    bbx = np.full((B, F), 0.12, np.float32)
    latent = (rng.normal(size=(B, FIELDS["code_length"])) * 0.05).astype(np.float32)
    return rays, ray_valid, depth_obs, T_oc, depths, bbx, latent


def _is_fg():
    return np.arange(R_FG + R_BG) < R_FG


def _port(tp, scenes, cfg):
    rays, rv, dobs, T_oc, depths, bbx, latent = (torch.as_tensor(a) for a in scenes)
    return trender(tp, TSpec(**FIELDS), latent, rays, torch.as_tensor(_is_fg()), rv, dobs, T_oc,
                   depths, bbx, cfg)


def _jax(jp, scenes, cfg):
    """JAX's per-frame `render_residuals`, vmapped over frames and lanes."""
    rays, rv, dobs, T_oc, depths, bbx, latent = (jnp.asarray(a) for a in scenes)
    is_fg = jnp.asarray(_is_fg())

    def frame(lat, r, v, d, T, s, bb):
        return jrender(jp, JSpec(**FIELDS), lat, r, is_fg, v, d, T, s, bb, cfg)

    fn = jax.jit(jax.vmap(jax.vmap(frame, in_axes=(None, 0, 0, 0, 0, 0, 0))))
    return fn(latent, rays, rv, dobs, T_oc, depths, bbx)


def _close(got, want, what, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    # floor 0.05: where every residual is tiny (res_m of a fg ray is an
    # occupancy sum near 1 minus 1), it still rounds at f32's 6e-8 of 1
    scale = max(float(np.max(np.abs(want))), 0.05)
    np.testing.assert_allclose(got, want, atol=tol * scale, rtol=0, err_msg=what)


def _held(got, want):
    np.testing.assert_array_equal(got.ray_ok.numpy(), np.asarray(want.ray_ok))
    np.testing.assert_array_equal(got.frame_ok.numpy(), np.asarray(want.frame_ok))
    for name in ("res_d", "res_m", "jac_d", "jac_m"):
        _close(getattr(got, name).numpy(), getattr(want, name), name)


@pytest.mark.parametrize("log_occ_on", [True, False], ids=["logistic", "linear"])
@pytest.mark.parametrize("scale_on", [True, False], ids=["sim3", "se3"])
def test_dense_render_batched_matches_jax(world, scale_on, log_occ_on):
    """The dense route on [B, F] leading axes (B = F = 2; padded rays in one
    frame, a bg ray without depth in each) against JAX's per-frame function
    vmapped over both."""
    jp, tp = world
    scenes = _scenes(3)
    kw = dict(scale_on=scale_on, log_occ_on=log_occ_on, occ_cutoff=0.15, min_valid_sample=10)
    got = _port(tp, scenes, TRC(**kw))
    want = _jax(jp, scenes, JRC(**kw))
    _held(got, want)
    # every frame valid and rays in the band in each: the Jacobians are held
    assert bool(got.frame_ok.all())
    assert int(got.ray_ok.sum(-1).min()) >= 10, got.ray_ok.sum(-1)


def test_bf16_forward_chain_matches_jax(world):
    """B3's plain bf16 chain (bf16 retrieval scoring, `retrieval_score_bf16`)
    against JAX's bf16 `decoder_apply`: the same products,
    summed in another order, so the median stays at f32 level and a row
    that rounds an activation one bf16 ulp the other way differs by at most
    a few bf16 ulps of the output."""
    jp, tp = world
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.normal(size=(5000, 8)) * 0.05, rng.normal(size=(5000, 3)) * 0.1],
                       1).astype(np.float32)
    want = np.asarray(japply(jp, JSpec(**FIELDS), jnp.asarray(x), jnp.bfloat16)[..., 0])
    pk = mlp_kernels.pack_params(tp, TSpec(**FIELDS), torch.bfloat16)
    got = mlp_kernels.mlp_sdf(pk, torch.as_tensor(x)).numpy()
    d = np.abs(got - want) / np.abs(want).max()
    assert np.median(d) <= 1e-6 and d.max() <= 2e-3, (np.median(d), d.max())


@pytest.mark.parametrize("use_pallas", [False, True], ids=["plain", "packed"])
def test_normal_equations_dense_match_jax(small, use_pallas, monkeypatch):  # noqa: F811
    """The LM normal equations on the dense route, the decoder evaluated
    plain or through the packed fwd+input-grad chain (B1's plain version),
    against JAX's with its plain decoder."""
    jobs, tobs, T0, _ = _batch(small, 42)
    kw = _cfg_kwargs(coarse_to_fine=False, fused_render=False)
    jc = jconfig.JointOptConfig(**kw, use_pallas=False)
    tc = tconfig.JointOptConfig(**kw, use_pallas=use_pallas)
    assert not takes_fused(tlm._render_config(tc, small["tspec"]), small["tspec"])
    calls = []
    chain = mlp_kernels.mlp_sdf_and_input_grad
    monkeypatch.setattr(mlp_kernels, "mlp_sdf_and_input_grad",
                        lambda *a, **k: calls.append(1) or chain(*a, **k))
    rng = np.random.default_rng(0)
    lat = (rng.normal(size=(2, 8)) * 0.1).astype(np.float32)
    i = np.array([0, 7], np.int32)
    H, b, failed = tne(small["tp"], small["tspec"], tc, tobs, torch.as_tensor(lat),
                       torch.as_tensor(T0), torch.as_tensor(i), CUBE_RADIUS)
    assert bool(calls) == use_pallas
    for k in range(2):
        o = jax.tree_util.tree_map(lambda a: a[k], jobs)
        Hj, bj, fj = jne(small["jp"], small["jspec"], jc, o, jnp.asarray(lat[k]),
                         jnp.asarray(T0[k]), jnp.int32(i[k]), CUBE_RADIUS)
        assert bool(failed[k]) == bool(fj)
        np.testing.assert_allclose(H[k].numpy(), np.asarray(Hj), atol=2e-5 * float(np.abs(Hj).max()), rtol=0)
        np.testing.assert_allclose(b[k].numpy(), np.asarray(bj), atol=2e-5 * float(np.abs(bj).max()), rtol=0)


def _bench_dense(small):  # noqa: F811
    """(JAX cfg, port cfg, JAX obs, port obs, T0, retrieved start latent and
    pose) of the bench schedule on the dense route."""
    kw = _cfg_kwargs(fused_render=False, coarse_max_iter=4)
    jobs, tobs, T0, _ = _batch(small, 42)
    lat, T, _, _ = tinit(small["tp"], small["tspec"], torch.as_tensor(small["table"]),
                         tobs.points_w, tobs.point_valid, T_init=torch.as_tensor(T0), **RETRIEVAL)
    return (jconfig.JointOptConfig(**kw), tconfig.JointOptConfig(**kw), jobs, tobs, T0,
            lat.numpy(), T.numpy())


def _fine(lm, obs, cfg):
    """The fine phase's observations and config (`coarse_to_fine_joint_opt`)."""
    o, c = lm._subsample(obs, cfg, cfg.fine_frame_stride, cfg.fine_ray_frac, cfg.fine_sample_frac,
                         cfg.fine_pts_frac)
    return o, dataclasses.replace(c, max_iter=cfg.fine_max_iter, coarse_to_fine=False,
                                  robust_iter=0)


def test_lm_iteration_dense_matches_jax(small):  # noqa: F811
    """Every LM iteration of the port's dense bench solve (coarse and fine
    phase) against JAX's iteration from the same state: the next latent and
    pose within 1e-5."""
    jc, tc, jobs, tobs, _, lat, T = _bench_dense(small)
    phases = [(tlm.subsample_observations(tobs, tc), jlm.subsample_observations(jobs, jc)),
              (_fine(tlm, tobs, tc), _fine(jlm, jobs, jc))]
    s = tstate.init_state(torch.as_tensor(lat), torch.as_tensor(T))
    steps = 0
    for (to, tcfg), (jo, jcfg) in phases:
        assert not takes_fused(tlm._render_config(tcfg, small["tspec"]), small["tspec"])
        packs = tlm.make_packs(small["tp"], small["tspec"], tcfg)
        s = tstate.init_state(s.latent, s.T_ow)
        for _ in range(tcfg.max_iter):
            new = tlm.lm_iteration(small["tp"], small["tspec"], tcfg, to, s, CUBE_RADIUS, False,
                                   packs)
            for k in range(2):
                want = jlm.lm_iteration(small["jp"], small["jspec"], jcfg,
                                        jax.tree_util.tree_map(lambda a: a[k], jo),
                                        jstate.OptState(*(jnp.asarray(a[k].numpy()) for a in s)),
                                        CUBE_RADIUS, False)
                np.testing.assert_allclose(new.latent[k].numpy(), np.asarray(want.latent),
                                           atol=1e-5, rtol=0)
                np.testing.assert_allclose(new.T_ow[k].numpy(), np.asarray(want.T_ow),
                                           atol=1e-5, rtol=0)
            s = tlm._freeze_if_done(s, new)
            steps += 1
    assert steps == 6


def test_bench_path_dense_matches_jax(small):  # noqa: F811
    """The bench schedule on the dense route (retrieval, 4 coarse + 2 fine
    iterations): iteration counts and flags equal, latents and poses within
    2e-4 (the bound of `tests/test_torch_slice.py`'s bench path) of JAX's
    own run, or, for a lane that JAX's solve continued from the port's first
    coarse iterate ends more than 2e-4 from JAX's own run, of the nearest of
    the two. The port's and JAX's first iterates agree within 1e-5
    (asserted, the bound of each iteration above). Lane 1 (the fixture's
    second fruit) is such a lane: from the port's first iterate JAX ends
    1.3e-3 from its own run and within 1e-6 of the port (measured 7.3e-7;
    a sample on a band edge, as in `tests/test_torch_challenge.py`), while
    lane 0 is held to JAX's own (measured 4.2e-7)."""
    jc, tc, jobs, tobs, T0, lat, T = _bench_dense(small)
    want = jsolve(small["jp"], small["jspec"], jc, jnp.asarray(small["table"]), jobs,
                  jnp.asarray(T0), CUBE_RADIUS, **RETRIEVAL)
    got = tsolve(small["tp"], small["tspec"], tc, torch.as_tensor(small["table"]), tobs,
                 torch.as_tensor(T0), CUBE_RADIUS, device="cpu", **RETRIEVAL)
    np.testing.assert_array_equal(got.iter_count.numpy(), np.asarray(want.iter_count))
    np.testing.assert_array_equal(got.failed.numpy(), np.asarray(want.failed))
    np.testing.assert_array_equal(got.converged.numpy(), np.asarray(want.converged))

    # the probe: JAX continued from the port's first coarse iterate
    to, tcc = tlm.subsample_observations(tobs, tc)
    jo, jcc = jlm.subsample_observations(jobs, jc)
    first_t = tlm.shape_pose_joint_opt_batched(
        small["tp"], small["tspec"], dataclasses.replace(tcc, max_iter=1), to,
        torch.as_tensor(lat), torch.as_tensor(T), CUBE_RADIUS, device="cpu")
    first_j = jlm.shape_pose_joint_opt_batched(
        small["jp"], small["jspec"], dataclasses.replace(jcc, max_iter=1), jo, jnp.asarray(lat),
        jnp.asarray(T), CUBE_RADIUS)
    for a, b in ((first_t.latent, first_j.latent), (first_t.T_ow, first_j.T_ow)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=0)
    r_a = jlm._continue_joint_opt_batched(small["jp"], small["jspec"], jcc, jo,
                                          jnp.asarray(first_t.latent.numpy()),
                                          jnp.asarray(first_t.T_ow.numpy()), CUBE_RADIUS, False, 1)
    fo, fc = _fine(jlm, jobs, jc)
    probe = jlm.shape_pose_joint_opt_batched(small["jp"], small["jspec"], fc, fo, r_a.latent,
                                             r_a.T_ow, CUBE_RADIUS)

    def dist(res):
        return np.maximum(np.abs(got.latent.numpy() - np.asarray(res.latent)).max(1),
                          np.abs(got.T_ow.numpy() - np.asarray(res.T_ow)).max((1, 2)))

    moved = np.maximum(np.abs(np.asarray(probe.latent) - np.asarray(want.latent)).max(1),
                       np.abs(np.asarray(probe.T_ow) - np.asarray(want.T_ow)).max((1, 2))) > 2e-4
    d_own, d_probe = dist(want), dist(probe)
    held = np.where(moved, np.minimum(d_own, d_probe), d_own)
    assert np.all(held <= 2e-4), (d_own, d_probe, moved)
    assert moved.tolist() == [False, True], moved   # the lane the docstring names


@pytest.mark.parametrize("path", CONFIGS, ids=[os.path.basename(p) for p in CONFIGS])
def test_shipped_configs_pass_the_port_check(path):
    """No shipped YAML sets the compacted route's fields, so the refusal
    reaches none of them."""
    tconfig.JointOptConfig.from_dict(tconfig.load_config(path)).check_ported()


@pytest.mark.parametrize("field, value", [("jac_cap", 0), ("fwd_cap", 0), ("fwd_bf16", True)],
                         ids=["jac_cap", "fwd_cap", "fwd_bf16"])
def test_compacted_settings_are_refused(small, field, value, monkeypatch):  # noqa: F811
    """A config that sets one of the compacted route's fields (here the auto
    budget, which the JAX package ignores on its fused route, as this config
    would run) is refused by name by the batch pipelines' solve, the batched
    LM solve and the server, before any retrieval or LM loop runs."""
    cfg = tconfig.JointOptConfig(**_cfg_kwargs(**{field: value}))
    assert cfg.fused_resolved(small["tspec"])
    ran = []
    monkeypatch.setattr(tlm, "_loop", lambda *a, **k: ran.append("lm"))
    monkeypatch.setattr(twarm, "retrieval_init_batched", lambda *a, **k: ran.append("retrieval"))
    _, tobs, T0, _ = _batch(small, 42)
    lat0 = torch.zeros(2, small["tspec"].code_length)
    T0 = torch.as_tensor(T0)
    table = torch.as_tensor(small["table"])
    calls = (
        lambda: twarm.warmstart_solve(small["tp"], small["tspec"], cfg, table, tobs, lat0, T0,
                                      CUBE_RADIUS, device="cpu"),
        lambda: tlm.shape_pose_joint_opt_batched(small["tp"], small["tspec"], cfg, tobs, lat0,
                                                 T0, CUBE_RADIUS, device="cpu"),
        lambda: tserve.CompletionServer(small["tp"], small["tspec"], cfg, CUBE_RADIUS,
                                        device="cpu"),
    )
    for call in calls:
        with pytest.raises(NotImplementedError, match=field):
            call()
    assert not ran, ran


@pytest.mark.parametrize("scale_on", [True, False], ids=["sim3", "se3"])
def test_fused_route_needs_the_jacobian_in_128_columns(scale_on, monkeypatch):
    """C = 122: pose_dim + C is 129 under Sim(3), so both packages take the
    dense route though the decoder is kernel-supported (in_dim 125), and
    agree there; under SE(3) (128) both take the fused route. The port packs
    the dense route's f32 weights for it."""
    fields = dict(code_length=122, dims=(128,) * 3, latent_in=(), clamping_distance=0.1)
    params_np = random_decoder_np(JSpec(**fields), 2, scale=0.5)
    jp = jax.tree_util.tree_map(jnp.asarray, params_np)
    tp = params_from_jax(params_np, "cpu")
    assert mlp_kernels.supported(TSpec(**fields))
    fused_calls = []

    def refuse(*a, **k):
        fused_calls.append(1)
        raise RuntimeError("fused route")

    monkeypatch.setattr(jrender_mod, "_render_residuals_fused", refuse)
    monkeypatch.setattr(trender_mod, "_render_residuals_fused", refuse)
    rays, rv, dobs, T_oc, depths, bbx, _ = _scenes(5)
    latent = (np.random.default_rng(6).normal(size=(B, 122)) * 0.05).astype(np.float32)
    kw = dict(scale_on=scale_on, log_occ_on=True, occ_cutoff=0.15, min_valid_sample=10,
              fused=True, fused_bf16=False)
    jargs = (jnp.asarray(latent[0]), jnp.asarray(rays[0, 0]), jnp.asarray(_is_fg()),
             jnp.asarray(rv[0, 0]), jnp.asarray(dobs[0, 0]), jnp.asarray(T_oc[0, 0]),
             jnp.asarray(depths[0, 0]), jnp.float32(bbx[0, 0]))
    targs = (torch.as_tensor(latent[:1]), torch.as_tensor(rays[:1, :1]),
             torch.as_tensor(_is_fg()), torch.as_tensor(rv[:1, :1]), torch.as_tensor(dobs[:1, :1]),
             torch.as_tensor(T_oc[:1, :1]), torch.as_tensor(depths[:1, :1]),
             torch.as_tensor(bbx[:1, :1]))
    cfg = tconfig.JointOptConfig(scale_on=scale_on, fused_render=True, fused_bf16=True)
    packs = tlm.make_packs(tp, TSpec(**fields), cfg)
    if scale_on:
        want = jrender(jp, JSpec(**fields), *jargs, JRC(**kw))
        got = trender(tp, TSpec(**fields), *targs, TRC(**kw))
        assert not fused_calls
        _held(type(got)(*(t[0, 0] for t in got)), want)
        assert not packs.render.bf16       # the dense route's f32 weights
    else:
        for call in (lambda: jrender(jp, JSpec(**fields), *jargs, JRC(**kw)),
                     lambda: trender(tp, TSpec(**fields), *targs, TRC(**kw))):
            with pytest.raises(RuntimeError, match="fused route"):
                call()
        assert len(fused_calls) == 2
        assert packs.render.bf16
