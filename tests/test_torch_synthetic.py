"""The port's synthetic-decoder trainer and asset tool
(`hortimapping_tpu_torch/tools/{synthetic,make_assets}.py`) against the JAX
package's on the CPU.

`train_synthetic_decoder` runs a 4 x 64, C = 8 decoder for 30 steps of 256
rows on both packages: the port starts from JAX's init and replays the
draws of JAX's `fold_in(key, s)` keys. The schedule's warmup is 3 steps,
so the first step runs at lr 0 (it fills Adam's moments and moves nothing).
Both run f32 in different summation orders; the weights agree to 5.5e-7 of
their 1.5 after moving ~1e-2, held at 5e-6. The ellipsoid functions agree
to f32 rounding (1e-6 of their magnitude)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from hortimapping_tpu.models import decoder as jdec
from hortimapping_tpu.tools import make_assets as jassets
from hortimapping_tpu.tools import synthetic as jsyn
from hortimapping_tpu_torch.models import decoder as tdec
from hortimapping_tpu_torch.models.workspace import params_from_jax
from hortimapping_tpu_torch.tools import make_assets as tassets
from hortimapping_tpu_torch.tools import synthetic as tsyn

torch.set_num_threads(1)

FIELDS = dict(code_length=8, dims=(64,) * 4, latent_in=(2,), clamping_distance=0.1)
WEIGHT_TOL = 5e-6


def test_ellipsoid_radii_and_sdf_match_jax():
    rng = np.random.default_rng(0)
    cat = tsyn.SyntheticCategory(spec=tdec.DecoderSpec(**FIELDS), base_radius=0.05)
    proj = cat.projection()
    codes = (rng.normal(size=(50, 8)) * 0.5).astype(np.float32)
    want_r = np.asarray(jax.vmap(lambda c: jsyn.ellipsoid_radii(c, jnp.asarray(proj), 0.05))(
        jnp.asarray(codes)))
    got_r = tsyn.ellipsoid_radii(torch.as_tensor(codes), torch.as_tensor(proj), 0.05).numpy()
    assert np.abs(got_r - want_r).max() <= 1e-6 * want_r.max()
    x = (rng.normal(size=(50, 3)) * 0.06).astype(np.float32)
    x[0] = 0.0                                        # the centre: -min(radii)
    x[1] = want_r[1] * np.array([1.0, 0.0, 0.0], np.float32)   # on the surface
    want = np.asarray(jax.vmap(jsyn.ellipsoid_sdf)(jnp.asarray(x), jnp.asarray(want_r)))
    got = tsyn.ellipsoid_sdf(torch.as_tensor(x), torch.as_tensor(want_r)).numpy()
    assert got[0] == -want_r[0].min() and abs(got[1]) <= 1e-8
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    # against the scene generator's numpy twin (one ellipsoid a call), in
    # float64: the two norms sum in other orders
    x64, r64 = x.astype(np.float64), want_r.astype(np.float64)
    got64 = tsyn.ellipsoid_sdf(torch.as_tensor(x64), torch.as_tensor(r64)).numpy()
    twin = np.array([tsyn._ellipsoid_sdf_np(x64[i], r64[i]) for i in range(50)])
    assert np.abs(got64 - twin).max() <= 1e-14 * np.abs(twin).max()


@pytest.mark.parametrize("steps", [30, 12000])
def test_warmup_cosine_lr_matches_optax(steps):
    lr = 3e-4
    sched = optax.warmup_cosine_decay_schedule(0.0, lr, min(200, steps // 10), steps, lr * 1e-2)
    at = np.unique(np.r_[np.arange(0, 40), np.linspace(0, steps + 5, 200).astype(int)])
    got = np.array([tsyn.warmup_cosine_lr(int(s), lr, min(200, steps // 10), steps, lr * 1e-2)
                    for s in at])
    want = np.array([float(sched(int(s))) for s in at])
    assert got[0] == 0.0 and want[0] == 0.0
    assert np.abs(got - want).max() <= 1e-6 * lr      # optax evaluates in f32


def test_train_synthetic_decoder_matches_jax(monkeypatch):
    steps, batch, lr, seed = 30, 256, 1e-3, 0
    key = jax.random.PRNGKey(seed)
    jcat = jsyn.SyntheticCategory(spec=jdec.DecoderSpec(**FIELDS), base_radius=0.05)
    want, want_proj = jsyn.train_synthetic_decoder(jcat, key, steps=steps, batch=batch, lr=lr)

    extent = 2.5 * jcat.base_radius
    draws = []
    for s in range(steps):
        kc, kx, ks = jax.random.split(jax.random.fold_in(key, s), 3)
        draws.append(tuple(torch.as_tensor(np.array(a)) for a in (
            jax.random.normal(kc, (batch, 8)) * 0.5,
            jax.random.uniform(kx, (batch, 3), minval=-extent, maxval=extent),
            jax.random.normal(ks, (batch, 3)),
            jax.random.normal(jax.random.fold_in(ks, 1), (batch, 1)) * 0.01)))
    draws = iter(draws)
    init = jax.tree_util.tree_map(np.array, jdec.init_decoder_params(jcat.spec, key))
    monkeypatch.setattr(tsyn, "_draw_synthetic_step", lambda *a: next(draws))
    monkeypatch.setattr(tsyn, "init_decoder_params", lambda spec, g, dev: params_from_jax(init, dev))
    tcat = tsyn.SyntheticCategory(spec=tdec.DecoderSpec(**FIELDS), base_radius=0.05)
    got, got_proj = tsyn.train_synthetic_decoder(tcat, seed, steps=steps, batch=batch, lr=lr,
                                                 device="cpu")
    assert next(draws, None) is None
    assert np.array_equal(got_proj, want_proj)
    moved = 0.0
    for name in want:
        for k in ("w", "b"):
            w = np.asarray(want[name][k])
            assert np.abs(got[name][k].numpy() - w).max() <= WEIGHT_TOL, (name, k)
            moved = max(moved, np.abs(w - init[name][k]).max())
    assert moved > 100 * WEIGHT_TOL        # the tolerance is far below what training moved


def test_make_category_writes_what_jax_writes(tmp_path, monkeypatch):
    """A tiny category (4 x 16, 3 steps of 64 rows) built by both packages:
    the same specs.json, the same `.npz` keys, dtypes and host-drawn arrays
    (code table, projection, base radius); the trained weights differ only
    by the two packages' draws."""
    entry = dict(spec=None, base_radius=0.04, steps=3, batch=64, lr=1e-3)
    fields = dict(code_length=4, dims=(16,) * 4, latent_in=(2,), clamping_distance=0.05)
    monkeypatch.setattr(jassets, "CATEGORIES", {"tiny": dict(entry, spec=jdec.DecoderSpec(**fields))})
    monkeypatch.setattr(tassets, "CATEGORIES", {"tiny": dict(entry, spec=tdec.DecoderSpec(**fields))})
    j_dir = jassets.make_category("tiny", str(tmp_path / "jax"))
    t_dir = tassets.make_category("tiny", str(tmp_path / "port"), device="cpu")
    with open(os.path.join(j_dir, "specs.json")) as f_j, open(os.path.join(t_dir, "specs.json")) as f_t:
        assert f_t.read() == f_j.read()
    with np.load(os.path.join(j_dir, "native", "latest.npz")) as zj, \
            np.load(os.path.join(t_dir, "native", "latest.npz")) as zt:
        assert sorted(zt.files) == sorted(zj.files)
        for k in zj.files:
            assert zt[k].dtype == zj[k].dtype and zt[k].shape == zj[k].shape, k
            if not k.startswith("lin"):
                assert np.array_equal(zt[k], zj[k]), k


def test_make_assets_needs_out(capsys):
    with pytest.raises(SystemExit):
        tassets.main(["--only", "synthetic_small_8", "--device", "cpu"])
    assert "--out" in capsys.readouterr().err
