"""PyTorch port vs the JAX package: the render term.

* the port's dense masked path vs `ops/render.render_residuals` (dense);
* `fused_render_plain` vs the Pallas `fused_render`, run as the JAX
  package's own tests run it on the CPU (interpret mode, f32).

Both sides compute in f32 on the CPU; sums run in other orders, so values
agree to ~1e-6 of each output's largest magnitude (bound 2e-5 below), and
the boolean outputs (ray_ok, frame_ok) agree exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hortimapping_tpu.models.decoder import DecoderSpec as JSpec
from hortimapping_tpu.ops import pallas_mlp, pallas_render
from hortimapping_tpu.ops.render import RenderConfig as JRC
from hortimapping_tpu.ops.render import render_residuals as jrender
from hortimapping_tpu_torch.models.decoder import DecoderSpec as TSpec
from hortimapping_tpu_torch.models.workspace import params_from_jax
from hortimapping_tpu_torch.ops import mlp_kernels, render_kernel
from hortimapping_tpu_torch.ops.render import RenderConfig as TRC
from hortimapping_tpu_torch.ops.render import render_residuals as trender
from torch_port_common import random_decoder_np

torch.set_num_threads(1)

FIELDS = dict(code_length=8, dims=(128,) * 4, latent_in=(2,), clamping_distance=0.1)
TOL = 2e-5


@pytest.fixture(scope="module")
def world():
    params_np = random_decoder_np(JSpec(**FIELDS), 1)
    return (jax.tree_util.tree_map(jnp.asarray, params_np), params_from_jax(params_np, "cpu"))


def _scene(seed, R_fg=24, R_bg=24, M=24):
    rng = np.random.default_rng(seed)
    R = R_fg + R_bg
    ang = np.concatenate([rng.normal(size=(R_fg, 2)) * 0.08, rng.normal(size=(R_bg, 2)) * 0.35])
    rays = np.concatenate([ang, np.ones((R, 1))], axis=-1).astype(np.float32)
    depth_obs = (0.3 + rng.normal(size=R) * 0.03).astype(np.float32)
    depth_obs[R_fg + 2] = 0.0  # a bg ray without depth
    T_co = np.eye(4, dtype=np.float32)
    T_co[:3, 3] = [0.01, -0.02, 0.3]
    c, s = np.cos(0.2), np.sin(0.2)
    T_co[:3, :3] = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]]) * 1.1
    T_oc = np.linalg.inv(T_co).astype(np.float32)
    depths = np.linspace(0.2, 0.42, M).astype(np.float32)
    latent = (rng.normal(size=FIELDS["code_length"]) * 0.05).astype(np.float32)
    return rays, depth_obs, T_oc, depths, latent


def _b(a):
    """numpy -> torch with the leading [B=1, F=1] axes."""
    return torch.as_tensor(np.array(a))[None, None]


def _close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.max(np.abs(want))), 1e-6)
    np.testing.assert_allclose(got, want, atol=TOL * scale, rtol=0, err_msg=what)


DENSE_CASES = {
    "se3_linear": dict(scale_on=False, log_occ_on=False),
    "se3_log": dict(scale_on=False, log_occ_on=True),
    "sim3_linear": dict(scale_on=True, log_occ_on=False),
    "sim3_log": dict(scale_on=True, log_occ_on=True),
    "occlusion_off": dict(scale_on=True, log_occ_on=True, occlusion_on=False),
    "padded_rays": dict(scale_on=True, log_occ_on=True, n_valid=40),
    "invalid_frame": dict(scale_on=True, log_occ_on=False, min_valid_sample=100000),
}


@pytest.mark.parametrize("case", list(DENSE_CASES))
def test_dense_render_matches_jax(world, case):
    jp, tp = world
    kw = dict(DENSE_CASES[case])
    n_valid = kw.pop("n_valid", 48)
    kw.setdefault("min_valid_sample", 10)
    kw.setdefault("occlusion_on", True)
    rays, depth_obs, T_oc, depths, latent = _scene(3)
    R = rays.shape[0]
    rv = np.arange(R) < n_valid
    want = jrender(jp, JSpec(**FIELDS), jnp.asarray(latent), jnp.asarray(rays),
                   jnp.arange(R) < 24, jnp.asarray(rv), jnp.asarray(depth_obs),
                   jnp.asarray(T_oc), jnp.asarray(depths), jnp.float32(0.12),
                   JRC(occ_cutoff=0.15, **kw))
    got = trender(tp, TSpec(**FIELDS), torch.as_tensor(latent)[None], _b(rays),
                  torch.arange(R) < 24, _b(rv), _b(depth_obs), _b(T_oc), _b(depths),
                  torch.tensor([[0.12]]), TRC(occ_cutoff=0.15, **kw))
    np.testing.assert_array_equal(got.ray_ok[0, 0].numpy(), np.asarray(want.ray_ok))
    assert bool(got.frame_ok[0, 0]) == bool(want.frame_ok)
    for name in ("res_d", "res_m", "jac_d", "jac_m"):
        _close(getattr(got, name)[0, 0].numpy(), getattr(want, name), name)
    if case == "padded_rays":
        assert not got.ray_ok[0, 0, 40:].any()
    if case == "invalid_frame":
        assert not got.ray_ok.any() and float(got.res_d.abs().max()) == 0.0


FUSED_CASES = {
    "sim3_log": dict(R_fg=24, M=24, scale_on=True, log_occ_on=True, active=True),
    "nondivisible_se3_linear": dict(R_fg=21, M=19, scale_on=False, log_occ_on=False, active=True),
    "inactive_lane": dict(R_fg=24, M=10, scale_on=True, log_occ_on=True, active=False),
}


@pytest.mark.parametrize("case", list(FUSED_CASES))
def test_fused_plain_matches_pallas(world, case):
    jp, tp = world
    c = FUSED_CASES[case]
    rays, depth_obs, T_oc, depths, latent = _scene(5, R_fg=c["R_fg"], M=c["M"])
    R = rays.shape[0]
    pts = ((rays[:, None, :] * depths[None, :, None]) @ T_oc[:3, :3].T + T_oc[:3, 3]).astype(np.float32)
    pose_dim = 7 if c["scale_on"] else 6
    kw = dict(pose_dim=pose_dim, scale_on=c["scale_on"], log_occ_on=c["log_occ_on"],
              occ_cutoff=0.15, occlusion_on=True, occlusion_th=0.03, min_grad_th=1e-6)
    jspec = JSpec(**FIELDS)
    jd, jm, res = pallas_render.fused_render(
        pallas_mlp.pack_params(jp, jspec), pallas_mlp.packed_spec(jspec), jspec,
        jnp.asarray(latent), jnp.asarray(pts), jnp.asarray(depth_obs), jnp.arange(R) < c["R_fg"],
        jnp.ones(R, bool), jnp.asarray(depths), jnp.float32(0.12), jnp.asarray(c["active"]),
        bf16=False, tr=16, **kw)
    J = pose_dim + FIELDS["code_length"]
    pk = mlp_kernels.pack_params(tp, TSpec(**FIELDS))
    gd, gm, gres = render_kernel.fused_render(
        pk, torch.as_tensor(latent)[None], _b(pts), _b(depth_obs), torch.arange(R) < c["R_fg"],
        torch.ones(1, 1, R, dtype=torch.bool), _b(depths), torch.tensor([[0.12]]),
        torch.tensor([c["active"]]), **kw)
    res = np.asarray(res)[:R, :4]
    np.testing.assert_array_equal(gres[0, 0, :, 2].numpy(), res[:, 2])   # ray_ok
    np.testing.assert_array_equal(gres[0, 0, :, 3].numpy(), res[:, 3])   # in-radius count
    _close(gres[0, 0].numpy(), res, "res")
    _close(gd[0, 0].numpy(), np.asarray(jd)[:R, :J], "jac_d")
    _close(gm[0, 0].numpy(), np.asarray(jm)[:R, :J], "jac_m")
    if not c["active"]:
        assert float(gd.abs().max()) == 0.0 and float(gres.abs().max()) == 0.0
    else:
        assert gres[0, 0, :, 2].sum() > 0


def test_fused_route_epilogue_matches_dense(world):
    """The fused route (plain version on the CPU) with its min_valid_sample
    gate agrees with the port's dense path on the same frame."""
    _, tp = world
    rays, depth_obs, T_oc, depths, latent = _scene(6)
    R = rays.shape[0]
    args = (tp, TSpec(**FIELDS), torch.as_tensor(latent)[None], _b(rays), torch.arange(R) < 24,
            torch.ones(1, 1, R, dtype=torch.bool), _b(depth_obs), _b(T_oc), _b(depths),
            torch.tensor([[0.12]]))
    base = TRC(scale_on=True, log_occ_on=True, occ_cutoff=0.15, min_valid_sample=10)
    dense = trender(*args, base)
    fused = trender(*args, dataclasses.replace(base, fused=True, fused_bf16=False))
    assert torch.equal(dense.ray_ok, fused.ray_ok)
    for name in ("res_d", "res_m", "jac_d", "jac_m"):
        _close(getattr(fused, name).numpy(), getattr(dense, name).numpy(), name)

