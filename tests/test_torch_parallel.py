"""The port's fruit-parallel layer (`hortimapping_tpu_torch/parallel/`) and the
last small modules against the JAX package's, on the CPU.

The sharded solve runs `tests/test_parallel.py`'s world (synthetic_small_8,
its CFG: 2 frames x 64 rays x 16 samples, 64 points, 3 iterations, lambda
0.5) on 8 CPU shards against JAX's `shard_joint_opt` on the session's 8
virtual devices: within 1e-4 with equal iteration counts, JAX's own bound
between its sharded and unsharded programs. Each shard is a whole
single-start solve of its lanes, so the port's sharded result equals, bit
for bit, the port's unsharded solve of each shard's lanes at the shard's
width.
"""

import dataclasses
import getpass
import json
import os
import subprocess
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from hortimapping_tpu import config as jconfig
from hortimapping_tpu.models import decoder as jdec
from hortimapping_tpu.models import workspace as jws
from hortimapping_tpu.ops import robust as jrobust
from hortimapping_tpu.parallel import fruit_mesh as jfruit_mesh
from hortimapping_tpu.parallel import shard_joint_opt as jshard_joint_opt
from hortimapping_tpu.utils import misc as jmisc
from hortimapping_tpu_torch import config as tconfig
from hortimapping_tpu_torch.config import JointOptConfig
from hortimapping_tpu_torch.models import decoder as tdec
from hortimapping_tpu_torch.models import workspace as tws
from hortimapping_tpu_torch.ops import robust as trobust
from hortimapping_tpu_torch.optim import lm as tlm
from hortimapping_tpu_torch.optim.state import FruitObservations
from hortimapping_tpu_torch.parallel import sharding
from hortimapping_tpu_torch.parallel import fruit_mesh, init_multi_host, shard_joint_opt
from hortimapping_tpu_torch.utils import misc as tmisc
from test_parallel import ASSET_DIR, CFG as JCFG, _batch

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = JointOptConfig(**dataclasses.asdict(JCFG))
C2F = dict(coarse_to_fine=True, fine_max_iter=2, coarse_frame_stride=2, fine_ray_frac=0.6,
           fine_sample_frac=0.75, fine_pts_frac=0.6)
RETRIEVAL = dict(init_mode="retrieval", retrieval_score_pts=32, retrieval_n_scales=3)

pytestmark = pytest.mark.skipif(not os.path.isdir(ASSET_DIR), reason="synthetic assets not built")


@pytest.fixture(scope="module")
def world():
    jp, jspec = jws.config_decoder(ASSET_DIR)
    params, spec = tws.config_decoder(ASSET_DIR, device="cpu")
    return jp, jspec, params, spec


def _port(obs, lat, T):
    return (FruitObservations(*(torch.as_tensor(np.array(a)) for a in obs)),
            torch.as_tensor(np.array(lat)), torch.as_tensor(np.array(T)))


def _table(spec):
    return (np.random.default_rng(5).normal(size=(16, spec.code_length)) * 0.3).astype(np.float32)


def test_fruit_mesh_of_cpu_entries_and_its_refusal_without_a_card():
    mesh = fruit_mesh(devices=["cpu"] * 8)
    assert mesh.size == 8 and mesh.devices == (torch.device("cpu"),) * 8
    assert (mesh.rank, mesh.world_size) == (0, 1)
    assert fruit_mesh(devices=["cpu"] * 3).size == 3
    if torch.cuda.is_available():
        assert fruit_mesh().size == torch.cuda.device_count()
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        fruit_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        fruit_mesh(2)


@pytest.mark.parametrize("case", ["plain", "padding", "coarse_to_fine", "retrieval"])
def test_shard_joint_opt_matches_jax_on_8_devices(world, case):
    """5 fruits pad to 8 (3 lanes fail at once and are dropped); retrieval
    runs inside each shard against the replicated table."""
    jp, jspec, params, spec = world
    n = 5 if case == "padding" else 8
    over = C2F if case == "coarse_to_fine" else RETRIEVAL if case == "retrieval" else {}
    jcfg = dataclasses.replace(JCFG, **over)
    cfg = JointOptConfig(**dataclasses.asdict(jcfg))
    table = _table(spec) if case == "retrieval" else None
    obs, lat, T = _batch(jspec, n)
    want = jshard_joint_opt(jp, jspec, jcfg, obs, lat, T, cube_radius=0.1, mesh=jfruit_mesh(),
                            latent_table=None if table is None else jnp.asarray(table))
    got = shard_joint_opt(params, spec, cfg, *_port(obs, lat, T), 0.1,
                          fruit_mesh(devices=["cpu"] * 8),
                          latent_table=None if table is None else torch.as_tensor(table),
                          device="cpu")
    assert got.latent.shape == (n, spec.code_length) and got.T_ow.shape == (n, 4, 4)
    np.testing.assert_allclose(got.latent.numpy(), np.asarray(want.latent), atol=1e-4, rtol=0)
    np.testing.assert_allclose(got.T_ow.numpy(), np.asarray(want.T_ow), atol=1e-4, rtol=0)
    np.testing.assert_array_equal(got.iter_count.numpy(), np.asarray(want.iter_count))
    np.testing.assert_array_equal(got.failed.numpy(), np.asarray(want.failed))
    assert not got.failed.any()


@pytest.mark.parametrize("case", ["plain", "retrieval_padded"])
def test_sharded_result_is_the_unsharded_solve_of_each_shard(world, case):
    """4 shards of 2 lanes (and 7 fruits padded to 8 with retrieval: the last
    shard holds one real lane and a padded one): each shard's lanes equal
    `joint_opt` of those lanes alone, bit for bit; the sharded solve leaves
    numpy's and torch's global generators where they were."""
    _, jspec, params, spec = world
    retrieval = case == "retrieval_padded"
    cfg = dataclasses.replace(CFG, **RETRIEVAL) if retrieval else CFG
    table = torch.as_tensor(_table(spec)) if retrieval else None
    n = 7 if retrieval else 8
    obs, lat, T = _port(*_batch(jspec, n, seed=3))
    np_state, torch_state = np.random.get_state(), torch.random.get_rng_state()
    got = shard_joint_opt(params, spec, cfg, obs, lat, T, 0.1, fruit_mesh(devices=["cpu"] * 4),
                          latent_table=table, device="cpu")
    after = np.random.get_state()
    assert after[0] == np_state[0] and np.array_equal(after[1], np_state[1])
    assert after[2:] == np_state[2:]
    assert torch.equal(torch.random.get_rng_state(), torch_state)
    obs_p, lat_p, T_p, _ = sharding.pad_to_multiple(obs, lat, T, 4)
    for s in range(4):
        lo, hi = 2 * s, 2 * s + 2
        want = tlm.joint_opt(params, spec, cfg, FruitObservations(*(a[lo:hi] for a in obs_p)),
                             lat_p[lo:hi], T_p[lo:hi], 0.1, latent_table=table, device="cpu")
        for field, a, b in zip(want._fields, got, want):
            assert torch.equal(a[lo:min(hi, n)], b[:min(hi, n) - lo]), (s, field)


def test_an_exception_in_one_shard_reaches_the_caller(world, monkeypatch):
    _, jspec, params, spec = world
    obs, lat, T = _port(*_batch(jspec, 8))
    lat[5, 0] = 7.0        # marks the lanes of shard 2 (of 4)
    solve, seen = tlm.joint_opt, []

    def failing(params_, spec_, cfg_, obs_, latent0, *a, **k):
        if bool((latent0 == 7.0).any()):
            raise FloatingPointError("shard 2 failed")
        seen.append(latent0.shape[0])
        return solve(params_, spec_, cfg_, obs_, latent0, *a, **k)

    monkeypatch.setattr(tlm, "joint_opt", failing)
    with pytest.raises(FloatingPointError, match="shard 2 failed"):
        shard_joint_opt(params, spec, CFG, obs, lat, T, 0.1, fruit_mesh(devices=["cpu"] * 4),
                        device="cpu")
    assert seen == [2, 2, 2]          # the other shards ran to their end first


def test_replicas_are_made_once_a_device_and_config(world, monkeypatch):
    """A second solve with the same params, device and config packs nothing
    again (the counterpart of JAX's cached sharded program)."""
    _, jspec, params, spec = world
    obs, lat, T = _port(*_batch(jspec, 4))
    calls = []
    make = tlm.make_packs
    monkeypatch.setattr(tlm, "make_packs", lambda *a, **k: calls.append(1) or make(*a, **k))
    mesh = fruit_mesh(devices=["cpu"] * 4)
    cfg = dataclasses.replace(CFG, max_iter=1)
    first = shard_joint_opt(params, spec, cfg, obs, lat, T, 0.1, mesh, device="cpu")
    assert len(calls) == 1
    again = shard_joint_opt(params, spec, cfg, obs, lat, T, 0.1, mesh, device="cpu")
    assert len(calls) == 1 and all(torch.equal(a, b) for a, b in zip(first, again))


def test_init_multi_host_passes_its_arguments_through(monkeypatch):
    import torch.distributed as dist

    calls = {}

    def fake_init(backend, init_method=None, world_size=-1, rank=-1, **kw):
        calls.update(backend=backend, init_method=init_method, world_size=world_size, rank=rank)

    monkeypatch.setattr(dist, "init_process_group", fake_init)
    mesh = init_multi_host("10.0.0.1:1234", 4, 2, devices=["cpu"] * 3)
    assert calls == {"backend": "gloo", "init_method": "tcp://10.0.0.1:1234", "world_size": 4,
                     "rank": 2}
    assert (mesh.rank, mesh.world_size, mesh.size) == (2, 4, 12)
    # the standard environment variables by default
    for k, v in (("MASTER_ADDR", "10.0.0.9"), ("MASTER_PORT", "29500"), ("WORLD_SIZE", "2"),
                 ("RANK", "1")):
        monkeypatch.setenv(k, v)
    mesh = init_multi_host(devices=["cpu"])
    assert calls == {"backend": "gloo", "init_method": "tcp://10.0.0.9:29500", "world_size": 2,
                     "rank": 1}
    assert (mesh.rank, mesh.world_size, mesh.size) == (1, 2, 2)


def test_two_process_smoke_on_the_cpu():
    """`tools/multihost_smoke.py --device cpu`: two processes joined over gloo
    on 127.0.0.1, 2 CPU shards each; every process holds the whole gathered
    result, the same in both."""
    out = subprocess.run(
        [sys.executable, "-m", "hortimapping_tpu_torch.tools.multihost_smoke", "--device", "cpu",
         "--timeout", "100"], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout[-4000:] + out.stderr[-2000:]
    reports = [json.loads(l.split("MULTIHOST_SMOKE_OK ", 1)[1]) for l in out.stdout.splitlines()
               if "MULTIHOST_SMOKE_OK " in l]
    assert sorted(r["process_id"] for r in reports) == [0, 1]
    assert all(r["shards"] == 4 and len(r["failed"]) == 4 and not any(r["failed"])
               for r in reports)
    assert reports[0]["result"] == reports[1]["result"]


# ---------------- the small functions ----------------

def test_get_configs_matches_jax(tmp_path):
    data = {"opt": {"n_frame": 4, "tpu": {"max_iter": 3}}, "runs": [{"name": "a"}, 2]}
    for ext, dump in ((".json", json.dump), (".yaml", yaml.safe_dump)):
        path = str(tmp_path / f"cfg{ext}")
        with open(path, "w") as f:
            dump(data, f)
        got, want = tconfig.get_configs(path), jconfig.get_configs(path)
        assert got == want == data
        assert got.opt.tpu.max_iter == want.opt.tpu.max_iter == 3
        assert got.runs[0].name == want.runs[0].name == "a"
        assert type(got.opt).__name__ == type(want.opt).__name__ == "ForceKeyErrorDict"
        got.opt.extra = want.opt.extra = 1
        assert got == want and got["opt"]["extra"] == 1
        for cfg in (got, want):
            with pytest.raises(AttributeError):
                cfg.missing
            with pytest.raises(KeyError):
                cfg["missing"]


def test_robust_residuals_match_jax():
    res = np.random.default_rng(0).normal(size=(64, 7)).astype(np.float32) * 0.05
    res[0, :3] = 0.0
    for b in (0.01, 0.05):
        wr, w2 = trobust.robust_residuals(torch.as_tensor(res), b)
        jwr, jw2 = jrobust.robust_residuals(jnp.asarray(res), b)
        np.testing.assert_allclose(wr.numpy(), np.asarray(jwr), rtol=1e-6, atol=1e-9)
        np.testing.assert_allclose(w2.numpy(), np.asarray(jw2), rtol=1e-6, atol=1e-9)
        assert w2[0, 0] == 0.0      # the reference's w(0) = 0


def test_decoder_sdf_grad_at_matches_jax(world):
    jp, jspec, params, spec = world
    rng = np.random.default_rng(1)
    latent = rng.normal(size=spec.code_length).astype(np.float32) * 0.3
    xyz = (rng.uniform(-0.08, 0.08, size=(5, 40, 3))).astype(np.float32)
    got = tdec.decoder_sdf_grad_at(params, spec, torch.as_tensor(latent), torch.as_tensor(xyz))
    want = jdec.decoder_sdf_grad_at(jp, jspec, jnp.asarray(latent), jnp.asarray(xyz))
    for g, w, shape in zip(got, want, ((5, 40), (5, 40, spec.code_length), (5, 40, 3))):
        assert tuple(g.shape) == shape
        # the same weights, two summation orders (f32)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=2e-6 * max(1.0, np.abs(np.asarray(w)).max()))


def test_setup_wandb_matches_jax(tmp_path, monkeypatch, capsys):
    """With a `wandb` module: the key asked for once, cached in
    `<user>_wandb.key` and put in WANDB_API_KEY, then read from the file;
    without one: a notice and nothing written. Both packages alike."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(getpass, "getuser", lambda: "grower")
    monkeypatch.delenv("WANDB_API_KEY", raising=False)
    monkeypatch.setitem(sys.modules, "wandb", types.ModuleType("wandb"))
    asked = []
    monkeypatch.setattr("builtins.input", lambda prompt: asked.append(prompt) or "k3y\n")
    logs = {}
    for name, setup in (("port", tmisc.setup_wandb), ("jax", jmisc.setup_wandb)):
        if os.path.exists("grower_wandb.key"):
            os.remove("grower_wandb.key")
        os.environ.pop("WANDB_API_KEY", None)
        setup()
        first_key = os.environ["WANDB_API_KEY"]
        setup()   # the cached key, no prompt
        with open("grower_wandb.key") as f:
            logs[name] = (first_key, os.environ["WANDB_API_KEY"], f.read(),
                          capsys.readouterr().out)
    assert logs["port"] == logs["jax"] == ("k3y", "k3y", "k3y\n",
                                           "wandb api key loaded from grower_wandb.key\n")
    assert len(asked) == 2
    monkeypatch.setitem(sys.modules, "wandb", None)     # import wandb raises ImportError
    os.remove("grower_wandb.key")
    tmisc.setup_wandb()
    jmisc.setup_wandb()
    out = capsys.readouterr().out.splitlines()
    assert out == ["wandb not installed; remote logging disabled"] * 2
    assert not os.path.exists("grower_wandb.key")


def test_distributed_checkpoint_round_trip_matches_orbax(world, tmp_path):
    """The port's `torch.distributed.checkpoint` pair holds what JAX's Orbax
    pair holds for the same decoder and codes: the same tree, bit for bit,
    under `<dir>/dcp/<checkpoint>/` (Orbax: `<dir>/orbax/<checkpoint>/`)."""
    jp, jspec, params, spec = world
    codes = tws.load_latent_vectors(ASSET_DIR, device="cpu")
    jpath = jws.save_orbax_checkpoint(str(tmp_path / "jax"), "latest", jp, jspec,
                                      latent_codes=codes.numpy())
    tpath = tws.save_distributed_checkpoint(str(tmp_path / "port"), "latest", params, spec,
                                            latent_codes=codes)
    assert tpath == os.path.abspath(str(tmp_path / "port" / "dcp" / "latest"))
    jparams, jspec2, jcodes = jws.load_orbax_checkpoint(jpath)
    tparams, tspec2, tcodes = tws.load_distributed_checkpoint(tpath, device="cpu")
    assert tspec2 == spec and (jspec2.code_length, jspec2.dims, jspec2.latent_in,
                               jspec2.clamping_distance) == (
        spec.code_length, spec.dims, spec.latent_in, spec.clamping_distance)
    assert list(tparams) == list(params) and set(jparams) == set(tparams)
    for name in tparams:
        for k in ("w", "b"):
            assert np.array_equal(tparams[name][k].numpy(), np.asarray(jparams[name][k]))
            assert tparams[name][k].dtype == torch.float32
    assert np.array_equal(tcodes.numpy(), np.asarray(jcodes))
    # no codes: None, as JAX's
    path = tws.save_distributed_checkpoint(str(tmp_path / "nocodes"), "latest", params, spec)
    assert tws.load_distributed_checkpoint(path, device="cpu")[2] is None
