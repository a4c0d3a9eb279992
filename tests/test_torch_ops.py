"""PyTorch port vs the JAX package: decoder, geometry ops, the fwd+input-grad
chain and the SDF term, on identical numpy inputs (CPU, small sizes).

Tolerances: f32 against f32. The two packages sum in different orders
(PyTorch's CPU matmul vs XLA's), so values agree to a few f32 ulps of their
magnitude, not bit for bit; each assert states its bound.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hortimapping_tpu.models import decoder as jdec
from hortimapping_tpu.ops import lie as jlie
from hortimapping_tpu.ops import pallas_mlp
from hortimapping_tpu.ops import recon as jrecon
from hortimapping_tpu.ops import robust as jrobust
from hortimapping_tpu.ops import sdf as jsdf
from hortimapping_tpu_torch.models import decoder as tdec
from hortimapping_tpu_torch.models.workspace import config_decoder, load_latent_vectors, params_from_jax
from hortimapping_tpu_torch.ops import lie as tlie
from hortimapping_tpu_torch.ops import mlp_kernels
from hortimapping_tpu_torch.ops import recon as trecon
from hortimapping_tpu_torch.ops import robust as trobust
from hortimapping_tpu_torch.ops import sdf as tsdf
from torch_port_common import ASSETS, load_npz_params, random_decoder_np

torch.set_num_threads(1)

SKIP = dict(code_length=8, dims=(128,) * 4, latent_in=(2,), clamping_distance=0.1)
NOSKIP = dict(code_length=8, dims=(128,) * 3, latent_in=(), clamping_distance=0.1)


def _t(a):
    return torch.as_tensor(np.array(a))


def _close(got, want, rtol_of_max, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.max(np.abs(want))), 1e-6)
    np.testing.assert_allclose(got, want, atol=rtol_of_max * scale, rtol=0, err_msg=what)


# ---------------------------------------------------------------- lie / sdf / robust

def _tangents(seed, n=64):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(n, 7)) * 0.3).astype(np.float32)
    x[0, 3:6] = 0.0                     # theta = 0 branch
    x[1, 3:6] = 1e-9                    # theta below eps
    x[2, 6] = 0.0                       # s = 0
    x[3, 6] = 5e-9                      # 0 < s <= 1e-8: the quirk zeroes c
    x[4, 6] = -0.2                      # s < 0: the quirk zeroes c
    x[5, 3:6] = 0.0
    x[5, 6] = -0.1                      # theta = 0 with s < 0
    return x


def test_exp_se3_matches_jax():
    x = _tangents(0)[:, :6]
    _close(tlie.exp_se3(_t(x)).numpy(), jlie.exp_se3(jnp.asarray(x)), 1e-6)


def test_exp_sim3_ref_matches_jax_including_quirk():
    x = _tangents(1)
    got = tlie.exp_sim3_ref(_t(x)).numpy()
    want = np.asarray(jlie.exp_sim3_ref(jnp.asarray(x)))
    _close(got, want, 1e-6)
    # the quirk: a negative scale step drops the c*I term, so the
    # translation differs from the true exponential's
    true = np.asarray(jlie.exp_sim3(jnp.asarray(x[4:5])))
    assert np.abs(got[4, :3, 3] - true[0, :3, 3]).max() > 1e-3


def test_pose_jacobians_and_angle_match_jax():
    rng = np.random.default_rng(2)
    p = rng.normal(size=(10, 3)).astype(np.float32)
    _close(tlie.points_to_pose_jacobian_se3(_t(p)).numpy(),
           jlie.points_to_pose_jacobian_se3(jnp.asarray(p)), 0)
    _close(tlie.points_to_pose_jacobian_sim3(_t(p)).numpy(),
           jlie.points_to_pose_jacobian_sim3(jnp.asarray(p)), 0)
    R = np.asarray(jlie.exp_se3(jnp.asarray(_tangents(3)[:, :6])))[:, :3, :3]
    _close(tlie.rotation_matrix_to_angle(_t(R)).numpy(),
           jlie.rotation_matrix_to_angle(jnp.asarray(R)), 1e-5)


def test_occupancy_and_huber_match_jax():
    s = np.linspace(-0.05, 0.05, 101).astype(np.float32)
    _close(tsdf.sdf_to_occupancy(_t(s), 0.01).numpy(), jsdf.sdf_to_occupancy(jnp.asarray(s), 0.01), 1e-7)
    sig = jsdf.logistic_sigma(0.01)
    assert tsdf.logistic_sigma(0.01) == sig
    _close(tsdf.sdf_to_occupancy_log(_t(s), sig).numpy(),
           jsdf.sdf_to_occupancy_log(jnp.asarray(s), sig), 1e-6)
    r = np.concatenate([[0.0], np.linspace(-0.2, 0.2, 50)]).astype(np.float32)
    got = trobust.huber_weights(_t(r), 0.05).numpy()
    _close(got, jrobust.huber_weights(jnp.asarray(r), 0.05), 1e-6)
    assert got[0] == 0.0  # w(0) = 0, as the reference


# ---------------------------------------------------------------- decoder

@pytest.mark.parametrize("name", ["synthetic_small_8", "synthetic_pepper_32"])
def test_decoder_sdf_and_input_grad_match_jax(name):
    params_np, fields, _, _ = load_npz_params(name)
    jspec, tspec = jdec.DecoderSpec(**fields), tdec.DecoderSpec(**fields)
    rng = np.random.default_rng(4)
    x = (rng.normal(size=(200, jspec.in_dim)) * 0.1).astype(np.float32)
    want_s, want_g = jdec.decoder_sdf_and_input_grad(
        jax.tree_util.tree_map(jnp.asarray, params_np), jspec, jnp.asarray(x))
    params, spec = config_decoder(f"{ASSETS}/{name}", device="cpu")
    assert spec == tspec
    got_s, got_g = tdec.decoder_sdf_and_input_grad(params, spec, _t(x))
    # 8x512 in f32: sums of 512 terms in another order, ~1e-6 of the max
    _close(got_s.numpy(), want_s, 2e-6, "sdf")
    _close(got_g.numpy(), want_g, 2e-5, "grad")


def test_latent_table_loads():
    table = load_latent_vectors(f"{ASSETS}/synthetic_pepper_32", device="cpu")
    _, _, want, _ = load_npz_params("synthetic_pepper_32")
    assert torch.equal(table, torch.as_tensor(want))


# ---------------------------------------------------------------- fwd+input-grad chain

@pytest.mark.parametrize("fields", [SKIP, NOSKIP], ids=["latent_in", "no_skip"])
def test_mlp_plain_matches_pallas_f32(fields):
    jspec, tspec = jdec.DecoderSpec(**fields), tdec.DecoderSpec(**fields)
    params_np = random_decoder_np(jspec, 5)
    x = (np.random.default_rng(6).normal(size=(300, jspec.in_dim)) * 0.3).astype(np.float32)
    jp = jax.tree_util.tree_map(jnp.asarray, params_np)
    want_s, want_g = pallas_mlp.mlp_sdf_and_input_grad(
        pallas_mlp.pack_params(jp, jspec), pallas_mlp.packed_spec(jspec), jnp.asarray(x))
    pk = mlp_kernels.pack_params(params_from_jax(params_np, "cpu"), tspec)
    got_s, got_g = mlp_kernels.mlp_sdf_and_input_grad(pk, _t(x))
    # explicit chain vs the interpreted Pallas chain, both f32: ~1e-7 of max
    _close(got_s.numpy(), want_s, 1e-6, "sdf")
    _close(got_g.numpy(), want_g, 1e-6, "grad")


def test_mlp_plain_bf16_close_to_pallas_bf16():
    jspec, tspec = jdec.DecoderSpec(**SKIP), tdec.DecoderSpec(**SKIP)
    params_np = random_decoder_np(jspec, 7)
    x = (np.random.default_rng(8).normal(size=(300, jspec.in_dim)) * 0.3).astype(np.float32)
    jp = jax.tree_util.tree_map(jnp.asarray, params_np)
    want_s, want_g = pallas_mlp.mlp_sdf_and_input_grad(
        pallas_mlp.pack_params(jp, jspec, jnp.bfloat16), pallas_mlp.packed_spec(jspec),
        jnp.asarray(x), bf16=True)
    tp = params_from_jax(params_np, "cpu")
    got_s, got_g = mlp_kernels.mlp_sdf_and_input_grad(
        mlp_kernels.pack_params(tp, tspec, torch.bfloat16), _t(x))
    f32_s, f32_g = mlp_kernels.mlp_sdf_and_input_grad(mlp_kernels.pack_params(tp, tspec), _t(x))
    # bf16 rounding of each layer's operands: the two bf16 chains agree to a
    # few bf16 ulps (another summation order can round an activation the
    # other way), far closer than either is to f32
    _close(got_s.numpy(), want_s, 4e-3, "sdf")
    _close(got_g.numpy(), want_g, 4e-3, "grad")
    assert np.abs(got_g.numpy() - f32_g.numpy()).max() > 10 * np.abs(got_g.numpy() - np.asarray(want_g)).max()


def test_supported_specs():
    assert mlp_kernels.supported(tdec.DecoderSpec(**SKIP))
    assert mlp_kernels.supported(tdec.DecoderSpec(**NOSKIP))
    assert mlp_kernels.supported(tdec.DecoderSpec())
    assert not mlp_kernels.supported(tdec.DecoderSpec(code_length=8, dims=(64,) * 4, latent_in=(2,)))
    assert not mlp_kernels.supported(tdec.DecoderSpec(code_length=8, dims=(1024,) * 4, latent_in=(2,)))


# ---------------------------------------------------------------- SDF term

@pytest.mark.parametrize("scale_on", [False, True])
def test_sdf_residuals_match_jax(scale_on):
    jspec, tspec = jdec.DecoderSpec(**SKIP), tdec.DecoderSpec(**SKIP)
    params_np = random_decoder_np(jspec, 10)
    rng = np.random.default_rng(11)
    lat = (rng.normal(size=(2, 8)) * 0.1).astype(np.float32)
    pts = (rng.normal(size=(2, 50, 3)) * 0.05).astype(np.float32)
    valid = np.arange(50)[None, :] < np.array([[40], [50]])
    jp = jax.tree_util.tree_map(jnp.asarray, params_np)
    tp = params_from_jax(params_np, "cpu")
    pk = mlp_kernels.pack_params(tp, tspec)
    got = trecon.sdf_residuals(tp, tspec, _t(lat), _t(pts), _t(valid), scale_on, pk)
    for b in range(2):
        want = jrecon.sdf_residuals(jp, jspec, jnp.asarray(lat[b]), jnp.asarray(pts[b]),
                                    jnp.asarray(valid[b]), scale_on)
        _close(got.res[b].numpy(), want.res, 1e-6, "res")
        _close(got.jac[b].numpy(), want.jac, 1e-6, "jac")
