"""The port's DeepSDF trainer (`hortimapping_tpu_torch/train/deepsdf.py`)
against the JAX package's, on the CPU at small size: the sphere dataset of
`tests/test_train.py` (3 x 48 net, C = 4, 6 scenes).

The parity cases start the port from JAX's `init_decoder_params(spec,
PRNGKey(seed))` and replay the draws JAX's key splits give (per epoch `k, ke
= split(k)`, `split(ke, steps)`; per step `ks, kd = split(.)`, `kp, kn =
split(kd)`), computed here with `jax.random`. Tolerances: both run f32, in
different summation orders (XLA's and PyTorch's CPU matmuls), so they agree
to ~1e-7 until a ReLU pre-activation or an L1 residual lands within rounding
of zero: there the gradient has a kink, one package takes the other side of
it, and Adam carries the difference on. The CodeBound case crosses one
(layer 2, a pre-activation of 6e-8 in epoch 3): after 4 epochs its losses
differ by 2.0e-7, its weights by 2.1e-5 (of 0.75), its biases by 3.0e-6 and
its codes by 8.4e-6 (of 0.016). The bounds below are 4-5x those."""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hortimapping_tpu.models import decoder as jdec
from hortimapping_tpu.models import workspace as jws
from hortimapping_tpu.train import deepsdf as jdeep
from hortimapping_tpu_torch.models import decoder as tdec
from hortimapping_tpu_torch.models import workspace as tws
from hortimapping_tpu_torch.train import deepsdf as tdeep
from test_train import _make_dataset, _make_experiment

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QUIET = dict(log=lambda *a: None)
# absolute: a kink moves a weight, a bias or a code by a share of one
# Adam step, whatever the tensor's own scale
LOSS_TOL = 1e-6      # per epoch (losses ~0.01-0.03)
PARAM_TOL = 1e-4     # weights up to ~2, biases ~0.02
CODE_TOL = 4e-5      # codes ~0.02


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("sdf_data"))
    _make_dataset(root, n_scenes=6)
    return root


def _experiment(path, data, **overrides):
    _make_experiment(str(path), data)
    with open(os.path.join(path, "specs.json")) as f:
        specs = json.load(f)
    specs.update(overrides)
    with open(os.path.join(path, "specs.json"), "w") as f:
        json.dump(specs, f)
    return str(path)


def _jax_draws(seed, n_scenes, scenes, half, pos_n, neg_n, n_epochs, steps):
    """The draws of JAX's trainer, step by step, as int64 tensors."""
    k = jax.random.PRNGKey(seed)
    out = []
    for _ in range(n_epochs):
        k, ke = jax.random.split(k)
        for step_key in jax.random.split(ke, steps):
            ks, kd = jax.random.split(step_key)
            sid = jax.random.randint(ks, (scenes,), 0, n_scenes)
            kp, kn = jax.random.split(kd)

            def draw(kk, counts):
                idx = jax.random.randint(kk, (scenes, half), 0, 1 << 30)
                return idx % jnp.maximum(jnp.asarray(counts)[sid], 1)[:, None]

            out.append(tuple(torch.tensor(np.asarray(a), dtype=torch.int64)
                             for a in (sid, draw(kp, pos_n), draw(kn, neg_n))))
    return out


def _replay_jax(monkeypatch, data, spec, seed, scenes, half, n_epochs, steps):
    """Make the port start from JAX's init and take JAX's draws."""
    _, pos_n, _, neg_n, names = jdeep.load_sdf_samples(data)
    draws = iter(_jax_draws(seed, len(names), scenes, half, pos_n, neg_n, n_epochs, steps))
    init = jax.tree_util.tree_map(np.array, jdec.init_decoder_params(spec, jax.random.PRNGKey(seed)))
    monkeypatch.setattr(tdeep, "_draw_step", lambda *a: next(draws))
    monkeypatch.setattr(tdeep, "init_decoder_params",
                        lambda spec_, g, dev: tws.params_from_jax(init, dev))
    return draws


def _assert_params_close(got, want, tol, what):
    for name in want:
        for k in ("w", "b"):
            w = np.asarray(want[name][k], np.float64)
            err = np.abs(got[name][k].detach().cpu().double().numpy() - w).max()
            assert err <= tol, (what, name, k, err)


def test_load_sdf_samples_bit_equal(data):
    for n_cap in (16384, 1000):          # the scenes hold ~3000 a sign: the second subsamples
        want = jdeep.load_sdf_samples(data, n_cap=n_cap)
        got = tdeep.load_sdf_samples(data, n_cap=n_cap)
        for g, w in zip(got[:4], want[:4]):
            assert g.dtype == w.dtype and np.array_equal(g, w)
        assert got[4] == want[4]
    split = {"spheres": {"ball": ["sphere_03", "sphere_01"]}}
    got, want = tdeep.load_sdf_samples(data, split), jdeep.load_sdf_samples(data, split)
    assert got[4] == want[4] == ["sphere_03", "sphere_01"]
    assert np.array_equal(got[0], want[0])


@pytest.mark.parametrize("code_bound", [None, 0.02], ids=["unbounded", "code_bound"])
def test_train_matches_jax_with_replayed_draws(tmp_path, data, monkeypatch, code_bound):
    """4 epochs of 2 steps (ScenesPerBatch 3 of 6 scenes, 256 samples a
    scene) on both packages; tolerances in the module docstring."""
    over = dict(ScenesPerBatch=3, SamplesPerScene=256)
    if code_bound is not None:
        over["CodeBound"] = code_bound    # about the codes' norms: the bound projects some
    n_epochs = 4
    want = jdeep.train_deepsdf(_experiment(tmp_path / "jax", data, **over), num_epochs=n_epochs,
                               save=False, **QUIET)
    spec = jdec.DecoderSpec(code_length=4, dims=(48, 48, 48), latent_in=(1,))
    draws = _replay_jax(monkeypatch, data, spec, 0, 3, 128, n_epochs, 2)
    got = tdeep.train_deepsdf(_experiment(tmp_path / "port", data, **over), num_epochs=n_epochs,
                              save=False, device="cpu", **QUIET)
    assert next(draws, None) is None                # every draw was taken, in order
    assert got.names == want.names and got.timing["steps_per_epoch"] == 2
    assert np.abs(got.losses - want.losses).max() <= LOSS_TOL, (got.losses, want.losses)
    assert got.losses[-1] < got.losses[0]
    assert np.abs(got.latent_codes - want.latent_codes).max() <= CODE_TOL
    if code_bound is not None:
        assert np.linalg.norm(got.latent_codes, axis=1).max() <= code_bound * (1 + 1e-6)
    _assert_params_close(got.params, want.params, PARAM_TOL, "params")


def test_snapshot_resume_is_bit_identical(tmp_path, data):
    exp_a = _experiment(tmp_path / "straight", data)
    exp_b = _experiment(tmp_path / "resumed", data)
    res_a = tdeep.train_deepsdf(exp_a, num_epochs=10, save=False, device="cpu", **QUIET)
    # a crash between epochs 5 and 10: only the mid-run snapshot is on disk
    tdeep.train_deepsdf(exp_b, num_epochs=10, save=False, snapshot_every=5, device="cpu", **QUIET)
    params_mid, spec_mid = tws.config_decoder(exp_b, device="cpu")
    assert spec_mid.code_length == 4 and len(params_mid) == 4
    assert tws.load_latent_vectors(exp_b, device="cpu").shape == (6, 4)
    res_b = tdeep.train_deepsdf(exp_b, num_epochs=10, save=False, resume=True, device="cpu",
                                **QUIET)
    assert np.array_equal(res_a.losses, res_b.losses)
    assert np.array_equal(res_a.latent_codes, res_b.latent_codes)
    for name in res_a.params:
        for k in ("w", "b"):
            assert torch.equal(res_a.params[name][k], res_b.params[name][k])


def test_resume_refuses_a_mismatched_experiment_and_the_other_package(tmp_path, data):
    exp = _experiment(tmp_path / "exp", data)
    tdeep.train_deepsdf(exp, num_epochs=8, save=False, snapshot_every=5, device="cpu", **QUIET)
    assert os.path.isfile(tdeep._train_state_path(exp))
    # the JAX trainer refuses the port's snapshot rather than misread it
    with pytest.raises(ValueError, match="specs.json or the dataset changed"):
        jdeep.train_deepsdf(exp, num_epochs=10, save=False, resume=True, **QUIET)
    with open(os.path.join(exp, "specs.json")) as f:
        specs = json.load(f)
    specs["NetworkSpecs"]["dims"] = [48, 48, 48, 48]
    with open(os.path.join(exp, "specs.json"), "w") as f:
        json.dump(specs, f)
    with pytest.raises(ValueError, match="specs.json or the dataset changed"):
        tdeep.train_deepsdf(exp, num_epochs=10, save=False, resume=True, device="cpu", **QUIET)

    # and the port refuses the JAX trainer's snapshot
    exp_j = _experiment(tmp_path / "jax", data)
    jdeep.train_deepsdf(exp_j, num_epochs=8, save=False, snapshot_every=5, **QUIET)
    with pytest.raises(ValueError, match="not a training state of this package"):
        tdeep.train_deepsdf(exp_j, num_epochs=10, save=False, resume=True, device="cpu", **QUIET)


def test_timing_steady_epochs_counts_actual_first_chunk(tmp_path, data):
    """JAX's `steady_epochs`: the first chunk's actual length and the resume
    offset are subtracted."""
    exp_a = _experiment(tmp_path / "snap", data)
    res_a = tdeep.train_deepsdf(exp_a, num_epochs=10, save=False, snapshot_every=5,
                                device="cpu", **QUIET)
    assert res_a.timing["steady_epochs"] == 5
    assert set(res_a.timing) == {"wall_s", "steady_wall_s", "steady_epochs", "steps_per_epoch"}
    res_b = tdeep.train_deepsdf(exp_a, num_epochs=10, save=False, resume=True, device="cpu",
                                **QUIET)
    assert res_b.timing["steady_epochs"] == 0
    exp_c = _experiment(tmp_path / "chunks", data)
    res_c = tdeep.train_deepsdf(exp_c, num_epochs=10, save=False, epochs_per_call=4,
                                device="cpu", **QUIET)
    assert res_c.timing["steady_epochs"] == 6


def _jax_mesh_draws(seed, n_scenes, scenes, half, pos_n, neg_n, n_epochs, steps, n_shards):
    """The draws of JAX's trainer on a mesh of `n_shards` devices: each
    device folds its index into the step key (`fold_in(step_key, i)`), then
    draws as `_jax_draws` does; in order epoch, step, device."""
    k = jax.random.PRNGKey(seed)
    out = []
    for _ in range(n_epochs):
        k, ke = jax.random.split(k)
        for step_key in jax.random.split(ke, steps):
            for i in range(n_shards):
                ks, kd = jax.random.split(jax.random.fold_in(step_key, i))
                sid = jax.random.randint(ks, (scenes,), 0, n_scenes)
                kp, kn = jax.random.split(kd)

                def draw(kk, counts):
                    idx = jax.random.randint(kk, (scenes, half), 0, 1 << 30)
                    return idx % jnp.maximum(jnp.asarray(counts)[sid], 1)[:, None]

                out.append(tuple(torch.tensor(np.asarray(a), dtype=torch.int64)
                                 for a in (sid, draw(kp, pos_n), draw(kn, neg_n))))
    return out


def test_mesh_training_matches_jax_data_parallel(tmp_path, data, monkeypatch):
    """The counterpart of `tests/test_train.py::test_training_data_parallel_mesh`:
    JAX's trainer over `fruit_mesh(8)` (ScenesPerBatch 6 rounded up to 8,
    one scene a device, gradients and loss `pmean`-ed) against the port over
    8 CPU shards with JAX's per-device draws replayed, at the file's
    tolerances; the port's rounding message is JAX's."""
    from hortimapping_tpu.parallel import fruit_mesh as jfruit_mesh
    from hortimapping_tpu_torch.parallel import fruit_mesh

    n_epochs, over = 4, dict(SamplesPerScene=256)
    want = jdeep.train_deepsdf(_experiment(tmp_path / "jax", data, **over), num_epochs=n_epochs,
                               mesh=jfruit_mesh(8), save=False, **QUIET)
    spec = jdec.DecoderSpec(code_length=4, dims=(48, 48, 48), latent_in=(1,))
    _, pos_n, _, neg_n, names = jdeep.load_sdf_samples(data)
    draws = iter(_jax_mesh_draws(0, len(names), 1, 128, pos_n, neg_n, n_epochs, 1, 8))
    init = jax.tree_util.tree_map(np.array, jdec.init_decoder_params(spec, jax.random.PRNGKey(0)))
    monkeypatch.setattr(tdeep, "_draw_step", lambda *a: next(draws))
    monkeypatch.setattr(tdeep, "init_decoder_params",
                        lambda spec_, g, dev: tws.params_from_jax(init, dev))
    said = []
    got = tdeep.train_deepsdf(_experiment(tmp_path / "port", data, **over), num_epochs=n_epochs,
                              mesh=fruit_mesh(devices=["cpu"] * 8), save=False, device="cpu",
                              log=said.append)
    assert next(draws, None) is None                # every shard's draw was taken, in order
    assert ("[train] ScenesPerBatch=6 is not divisible by 8 devices; rounding the global "
            "scene batch up to 8") in said
    assert np.abs(got.losses - want.losses).max() <= LOSS_TOL, (got.losses, want.losses)
    assert np.abs(got.latent_codes - want.latent_codes).max() <= CODE_TOL
    _assert_params_close(got.params, want.params, PARAM_TOL, "params")


def test_mesh_training_resume_is_bit_identical(tmp_path, data):
    """Under a mesh of 3 shards: each shard's generator is in the snapshot,
    so a run resumed from it ends bit for bit where the straight run ends;
    a snapshot of another number of shards is refused. A mesh that spans
    processes trains: 2 processes of one shard each (gloo on 127.0.0.1,
    `tools/multihost_smoke.py --train`) end bit-equal to the one-process
    2-shard run (`tests/test_torch_train_mp.py` holds the other layouts)."""
    from hortimapping_tpu_torch.parallel import fruit_mesh
    from hortimapping_tpu_torch.tools import multihost_smoke

    mesh = fruit_mesh(devices=["cpu"] * 3)
    kw = dict(num_epochs=6, save=False, device="cpu", mesh=mesh, **QUIET)
    exp_a = _experiment(tmp_path / "straight", data)
    exp_b = _experiment(tmp_path / "resumed", data)
    res_a = tdeep.train_deepsdf(exp_a, **kw)
    tdeep.train_deepsdf(exp_b, snapshot_every=3, **kw)
    res_b = tdeep.train_deepsdf(exp_b, resume=True, **kw)
    assert np.array_equal(res_a.losses, res_b.losses)
    assert np.array_equal(res_a.latent_codes, res_b.latent_codes)
    for name in res_a.params:
        for k in ("w", "b"):
            assert torch.equal(res_a.params[name][k], res_b.params[name][k])
    with pytest.raises(ValueError, match="on 3 shards, not 2"):
        tdeep.train_deepsdf(exp_b, resume=True, **dict(kw, mesh=fruit_mesh(devices=["cpu"] * 2)))
    exp_c = _experiment(tmp_path / "processes", data)
    want = tdeep.train_deepsdf(exp_c, **dict(kw, num_epochs=2,
                                              mesh=fruit_mesh(devices=["cpu"] * 2)))
    out = str(tmp_path / "out")
    for rc, said, report in multihost_smoke.run_workers(
            ["--device", "cpu", "--train", exp_c, "--local_shards", "1", "--epochs", "2",
             "--out", out], timeout=100):
        assert rc == 0 and report is not None and report["shards"] == 2, said[-4000:]
        with np.load(os.path.join(out, f"rank{report['process_id']}.npz")) as z:
            assert np.array_equal(z["losses"], want.losses)
            assert np.array_equal(z["codes"], want.latent_codes)
            for name in want.params:
                for k in ("w", "b"):
                    assert np.array_equal(z[f"params.{name}.{k}"], want.params[name][k].numpy())


def test_python_m_entry_writes_a_checkpoint(tmp_path, data):
    exp = _experiment(tmp_path / "exp", data)
    out = subprocess.run(
        [sys.executable, "-m", "hortimapping_tpu_torch.train.deepsdf", "-e", exp, "--epochs", "3",
         "--snapshot_every", "2", "--device", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "epoch    3/3" in out.stdout and "saved" in out.stdout
    params, spec = tws.config_decoder(exp, device="cpu")
    assert spec.code_length == 4 and tws.load_latent_vectors(exp, device="cpu").shape == (6, 4)
    assert os.path.isfile(tdeep._train_state_path(exp))


def test_each_package_loads_the_others_checkpoint(tmp_path, data):
    """A port-written `native/latest.npz` gives JAX's loaders the port's SDF
    and codes, and a JAX-written one the port's loaders JAX's."""
    pts = np.random.default_rng(3).normal(size=(64, 3)).astype(np.float32) * 0.06
    for writer in ("port", "jax"):
        exp = _experiment(tmp_path / writer, data)
        if writer == "port":
            res = tdeep.train_deepsdf(exp, num_epochs=2, device="cpu", **QUIET)
        else:
            res = jdeep.train_deepsdf(exp, num_epochs=2, **QUIET)
        jp, jspec = jws.config_decoder(exp)
        jcodes = np.asarray(jws.load_latent_vectors(exp))
        tp, tspec = tws.config_decoder(exp, device="cpu")
        tcodes = tws.load_latent_vectors(exp, device="cpu").numpy()
        assert np.array_equal(jcodes, res.latent_codes) and np.array_equal(tcodes, res.latent_codes)
        assert (jspec.code_length, jspec.dims, jspec.latent_in, jspec.clamping_distance) == (
            tspec.code_length, tspec.dims, tspec.latent_in, tspec.clamping_distance)
        for name in jp:
            for k in ("w", "b"):
                assert np.array_equal(np.asarray(jp[name][k]), tp[name][k].numpy())
        for s in range(3):
            want = np.asarray(jdec.decoder_sdf(jp, jspec, jnp.asarray(jcodes[s]), jnp.asarray(pts)))
            got = tdec.decoder_sdf(tp, tspec, torch.as_tensor(tcodes[s]), torch.as_tensor(pts))
            # the same weights, two summation orders
            assert np.abs(got.numpy() - want).max() <= 1e-6 * max(np.abs(want).max(), 1e-3)
