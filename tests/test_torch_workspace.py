"""The port's torch-checkpoint load (`hortimapping_tpu_torch/models/workspace.py`)
against the JAX package's, on `.pth` files this test writes with
`torch.save`: the three weight parameterisations, with and without the
DataParallel `module.` prefix, both `LatentCodes` layouts, and
`config_decoder`'s fallback with its native cache. Both packages fold the
weight norm in numpy f32 in the same order, so the weights must be equal
bit for bit; the SDF through each package's decoder agrees to f32 rounding
of a 3-layer chain (1e-6 of its largest magnitude)."""

import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from hortimapping_tpu.models import decoder as jdec
from hortimapping_tpu.models import workspace as jws
from hortimapping_tpu_torch.models import decoder as tdec
from hortimapping_tpu_torch.models import workspace as tws

torch.set_num_threads(1)

FIELDS = dict(code_length=8, dims=(32, 32, 32), latent_in=(2,), clamping_distance=0.1)
SPECS_JSON = ('{"CodeLength": 8, "ClampingDistance": 0.1, "NetworkSpecs": '
              '{"dims": [32, 32, 32], "latent_in": [2], "weight_norm": true}}')


class _Decoder(nn.Module):
    """The reference decoder's layer names (`lin0` .. `lin3`), weights under
    one of three parameterisations."""

    def __init__(self, param: str):
        super().__init__()
        spec = tdec.DecoderSpec(**FIELDS)
        torch.manual_seed(7)
        for l, (fan_in, fan_out) in enumerate(spec.layer_dims()):
            lin = nn.Linear(fan_in, fan_out)
            if param == "weight_norm":
                lin = torch.nn.utils.weight_norm(lin)
            elif param == "parametrize":
                lin = torch.nn.utils.parametrizations.weight_norm(lin)
            setattr(self, f"lin{l}", lin)
        with torch.no_grad():   # g away from ||v||, so the fold is not the identity
            for p_name, p in self.named_parameters():
                if p_name.endswith(("weight_g", "original0")):
                    p.mul_(torch.linspace(0.5, 1.5, p.numel()).reshape(p.shape))


def _write_experiment(root, param: str, module_prefix: bool, n_codes: int = 5,
                      embedding: bool = True):
    os.makedirs(os.path.join(root, "ModelParameters"))
    os.makedirs(os.path.join(root, "LatentCodes"))
    with open(os.path.join(root, "specs.json"), "w") as f:
        f.write(SPECS_JSON)
    state = _Decoder(param).state_dict()
    if module_prefix:
        state = {"module." + k: v for k, v in state.items()}
    torch.save({"epoch": 3, "model_state_dict": state},
               os.path.join(root, "ModelParameters", "latest.pth"))
    codes = torch.as_tensor(np.random.default_rng(1).normal(size=(n_codes, 8)), dtype=torch.float32)
    blob = {"weight": codes} if embedding else codes
    torch.save({"epoch": 3, "latent_codes": blob}, os.path.join(root, "LatentCodes", "latest.pth"))
    return codes.numpy()


def _equal_params(tparams, jparams):
    assert sorted(tparams) == sorted(jparams)
    for name in jparams:
        for k in ("w", "b"):
            want = np.asarray(jparams[name][k])
            got = tparams[name][k].numpy()
            assert got.dtype == np.float32 and np.array_equal(got, want), (name, k)


@pytest.mark.parametrize("module_prefix", [False, True], ids=["plain_keys", "module_prefix"])
@pytest.mark.parametrize("param", ["weight_norm", "weight", "parametrize"])
def test_convert_torch_checkpoint_matches_jax(tmp_path, param, module_prefix):
    _write_experiment(str(tmp_path), param, module_prefix)
    pth = os.path.join(tmp_path, "ModelParameters", "latest.pth")
    want = jws.convert_torch_checkpoint(pth, jdec.DecoderSpec(**FIELDS))
    got = tws.convert_torch_checkpoint(pth, tdec.DecoderSpec(**FIELDS), device="cpu")
    _equal_params(got, want)
    # the fold reproduces torch's own weight norm (the old API recomputes
    # `weight` only in a forward, so fold v and g with torch's function)
    lin1 = _Decoder(param).lin1
    weight = (torch._weight_norm(lin1.weight_v, lin1.weight_g, 0) if param == "weight_norm"
              else lin1.weight)
    assert torch.allclose(got["lin1"]["w"], weight.detach().T, rtol=0, atol=1e-6)


def test_convert_torch_checkpoint_missing_layer_raises(tmp_path):
    _write_experiment(str(tmp_path), "weight", False)
    pth = os.path.join(tmp_path, "ModelParameters", "latest.pth")
    deeper = tdec.DecoderSpec(**dict(FIELDS, dims=(32,) * 4))
    with pytest.raises(KeyError, match="lin4"):
        tws.convert_torch_checkpoint(pth, deeper, device="cpu")


@pytest.mark.parametrize("embedding", [True, False], ids=["embedding_state_dict", "raw_tensor"])
def test_latent_codes_from_pth_match_jax(tmp_path, embedding):
    codes = _write_experiment(str(tmp_path), "weight_norm", True, embedding=embedding)
    got = tws.load_latent_vectors(str(tmp_path), device="cpu")
    want = np.asarray(jws.load_latent_vectors(str(tmp_path)))
    assert got.dtype == torch.float32 and np.array_equal(got.numpy(), want)
    assert np.array_equal(want, codes)


def test_config_decoder_falls_back_to_pth_and_caches(tmp_path):
    """No native checkpoint: both packages convert the `.pth` and write the
    native cache beside it (no latent table in it, so the codes still come
    from `LatentCodes/`); the second load reads the cache, and each
    package's cache is the other's."""
    exp_t, exp_j = str(tmp_path / "port"), str(tmp_path / "jax")
    codes = _write_experiment(exp_t, "parametrize", True)
    shutil.copytree(exp_t, exp_j)
    params, spec = tws.config_decoder(exp_t, device="cpu")
    jparams, jspec = jws.config_decoder(exp_j)
    _equal_params(params, jparams)
    assert spec == tdec.DecoderSpec(**FIELDS)
    for exp in (exp_t, exp_j):
        with np.load(os.path.join(exp, "native", "latest.npz")) as z:
            assert "latent_codes" not in z.files and int(z["spec.code_length"]) == 8
    with np.load(os.path.join(exp_t, "native", "latest.npz")) as zt, \
            np.load(os.path.join(exp_j, "native", "latest.npz")) as zj:
        assert sorted(zt.files) == sorted(zj.files)
        for k in zj.files:
            assert zt[k].dtype == zj[k].dtype and np.array_equal(zt[k], zj[k]), k
    os.remove(os.path.join(exp_t, "ModelParameters", "latest.pth"))
    cached, _ = tws.config_decoder(exp_t, device="cpu")     # from the cache alone
    _equal_params(cached, jparams)
    assert np.array_equal(tws.load_latent_vectors(exp_t, device="cpu").numpy(), codes)

    pts = np.random.default_rng(2).normal(size=(100, 3)).astype(np.float32) * 0.05
    want = np.asarray(jdec.decoder_sdf(jparams, jspec, jnp.asarray(codes[0]), jnp.asarray(pts)))
    got = tdec.decoder_sdf(cached, spec, torch.as_tensor(codes[0]), torch.as_tensor(pts)).numpy()
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


def test_config_decoder_read_only_keeps_the_conversion_in_memory(tmp_path, monkeypatch):
    """An experiment directory that cannot be written (the cache's write
    raises an OSError) still loads; nothing is cached."""
    exp = str(tmp_path)
    _write_experiment(exp, "weight_norm", False)

    def read_only(*a, **k):
        raise PermissionError("read-only file system")

    monkeypatch.setattr(tws, "save_native_checkpoint", read_only)
    params, _ = tws.config_decoder(exp, device="cpu")
    _equal_params(params, jws.convert_torch_checkpoint(
        os.path.join(exp, "ModelParameters", "latest.pth"), jdec.DecoderSpec(**FIELDS)))
    assert not os.path.exists(os.path.join(exp, "native"))


def test_config_decoder_without_any_checkpoint_raises(tmp_path):
    with open(os.path.join(tmp_path, "specs.json"), "w") as f:
        f.write(SPECS_JSON)
    with pytest.raises(FileNotFoundError, match="native or torch"):
        tws.config_decoder(str(tmp_path), device="cpu")
    with pytest.raises(FileNotFoundError, match="no latent codes"):
        tws.load_latent_vectors(str(tmp_path), device="cpu")
