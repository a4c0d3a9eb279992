"""The port's DeepSDF trainer over a fruit mesh that spans processes: two
processes joined over gloo on 127.0.0.1 (`tools/multihost_smoke.py --train`),
each with CPU shards of its own, on the sphere dataset of
`tests/test_train.py` (6 scenes, 3 x 48 net, C = 4; ScenesPerBatch 6
rounded up to 8 over 4 global shards).

The oracle is the port's own one-process mesh of the same global shard
count (`tests/test_torch_train.py::test_mesh_training_matches_jax_data_parallel`
holds that to JAX's `fruit_mesh(8)` run). Every process, here and in the
workers, runs one intra-op thread, so each shard's sums keep one order and
the two layouts agree bit for bit: the shards draw on the same generators,
and the gathered rows are averaged in global shard order in both."""

import os
import shutil
import sys
import time

import numpy as np
import pytest
import torch

from hortimapping_tpu_torch.parallel import fruit_mesh
from hortimapping_tpu_torch.tools import multihost_smoke
from hortimapping_tpu_torch.train import deepsdf as tdeep
from test_torch_train import _experiment
from test_train import _make_dataset

torch.set_num_threads(1)

QUIET = dict(log=lambda *a: None)
EPOCHS = 6
SPAWN_TIMEOUT = 100    # seconds for both workers of a spawn; each takes ~5-10 s here
# a worker script that runs the smoke's worker with one trainer function
# wrapped (`patch`), to force a failure or to record the writes
WORKER_SCRIPT = """import sys
from hortimapping_tpu_torch.tools import multihost_smoke
from hortimapping_tpu_torch.train import deepsdf
rank = int(sys.argv[sys.argv.index("--worker") + 1])
{patch}
sys.exit(multihost_smoke.main(sys.argv[1:]))
"""
FAIL_RANK_1 = """apply, calls = deepsdf.decoder_apply, []
def failing(*a, **k):
    calls.append(1)
    if rank == 1 and len(calls) > 2:   # from rank 1's second step on
        raise FloatingPointError("forced failure")
    return apply(*a, **k)
deepsdf.decoder_apply = failing
"""
START_APART = {
    # rank 1's first bias moved by 1e-3 at the init
    "parameters": """init = deepsdf.init_decoder_params
def shifted(spec, g, dev):
    p = init(spec, g, dev)
    if rank == 1:
        p["lin0"]["b"] += 1e-3
    return p
deepsdf.init_decoder_params = shifted
""",
    # rank 1 holds one shard, rank 0 two
    "shards": """if rank == 1:
    sys.argv[sys.argv.index("--local_shards") + 1] = "1"
""",
}
RECORD_WRITES = """for name in ("save_native_checkpoint", "_save_train_state"):
    def spy(*a, _fn=getattr(deepsdf, name), _name=name, **k):
        print(f"WROTE rank {rank} {_name}", flush=True)
        return _fn(*a, **k)
    setattr(deepsdf, name, spy)
"""


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("sdf_data"))
    _make_dataset(root, n_scenes=6)
    return root


def _one_process(exp, shards=4, **kw):
    return tdeep.train_deepsdf(exp, save=False, device="cpu",
                               mesh=fruit_mesh(devices=["cpu"] * shards), **dict(QUIET, **kw))


def _two_processes(exp, out=None, local_shards=2, patch=None, **kw):
    """Spawn the two workers on `exp` -> [(rc, output, report)] by rank."""
    args = ["--device", "cpu", "--train", exp, "--local_shards", str(local_shards)]
    for k, v in kw.items():
        args += [f"--{k}"] if v is True else [f"--{k}", str(v)]
    if out is not None:
        args += ["--out", out]
    command = None
    if patch is not None:
        path = os.path.join(os.path.dirname(exp), "worker.py")
        with open(path, "w") as f:
            f.write(WORKER_SCRIPT.format(patch=patch))
        command = [sys.executable, path]
    return multihost_smoke.run_workers(args, SPAWN_TIMEOUT, command)


def _ok(results):
    for rc, out, report in results:
        assert rc == 0 and report is not None, out[-4000:]
    return [r for _, _, r in results]


def _assert_equal_to(out_dir, res):
    """Both processes' results bit-equal to the one-process run `res`."""
    for rank in (0, 1):
        with np.load(os.path.join(out_dir, f"rank{rank}.npz")) as z:
            assert np.array_equal(z["losses"], res.losses), (rank, z["losses"], res.losses)
            assert np.array_equal(z["codes"], res.latent_codes), rank
            for name, p in res.params.items():
                for k in ("w", "b"):
                    assert np.array_equal(z[f"params.{name}.{k}"], p[k].numpy()), (rank, name, k)


@pytest.fixture(scope="module")
def straight(tmp_path_factory, data):
    """The one-process run on 4 CPU shards, EPOCHS epochs."""
    return _one_process(_experiment(tmp_path_factory.mktemp("straight") / "exp", data),
                        num_epochs=EPOCHS)


@pytest.fixture(scope="module")
def snapshot_2x2(tmp_path_factory, data):
    """A 2 x 2 run to EPOCHS with a snapshot at EPOCHS / 2 and no final
    write (a crash after the snapshot): the experiment directory."""
    exp = _experiment(tmp_path_factory.mktemp("snap_2x2") / "exp", data)
    _ok(_two_processes(exp, epochs=EPOCHS, snapshot_every=EPOCHS // 2))
    return exp


def test_two_processes_equal_the_one_process_mesh(tmp_path, data, straight):
    """2 processes x 2 shards against 1 process x 4 shards: losses, codes
    and weights bit-equal, in both processes; the rounding message counts
    the global shards."""
    exp = _experiment(tmp_path / "exp", data)
    results = _two_processes(exp, out=str(tmp_path / "out"), epochs=EPOCHS)
    reports = _ok(results)
    assert [r["process_id"] for r in reports] == [0, 1]
    assert all(r["shards"] == 4 and r["processes"] == 2 and r["steps"] == EPOCHS
               for r in reports)
    assert reports[0]["result"] == reports[1]["result"]
    _assert_equal_to(str(tmp_path / "out"), straight)
    for _, out, _ in results:
        assert ("[train] ScenesPerBatch=6 is not divisible by 4 devices; rounding the global "
                "scene batch up to 8") in out
    assert straight.losses[-1] < straight.losses[0]


@pytest.mark.parametrize("direction", ["1x4_to_2x2", "2x2_to_1x4"])
def test_snapshot_resumes_across_layouts(tmp_path, data, straight, snapshot_2x2, direction):
    """A snapshot at epoch 3 of 6 on one layout, resumed on the other, ends
    bit-equal to the straight 1 x 4 run."""
    if direction == "1x4_to_2x2":
        exp = _experiment(tmp_path / "exp", data)
        _one_process(exp, num_epochs=EPOCHS, snapshot_every=EPOCHS // 2)
        with np.load(tdeep._train_state_path(exp)) as z:
            assert int(z["shards"]) == 4 and int(z["epoch"]) == EPOCHS // 2
        results = _two_processes(exp, out=str(tmp_path / "out"), epochs=EPOCHS, resume=True)
        reports = _ok(results)
        assert all(f"resumed at epoch {EPOCHS // 2}/{EPOCHS}" in out for _, out, _ in results)
        assert all(r["steps"] == EPOCHS - EPOCHS // 2 for r in reports)
        _assert_equal_to(str(tmp_path / "out"), straight)
    else:
        exp = str(tmp_path / "exp")
        shutil.copytree(snapshot_2x2, exp)
        with np.load(tdeep._train_state_path(exp)) as z:
            assert int(z["shards"]) == 4 and int(z["epoch"]) == EPOCHS // 2
            assert {f"generator.{g}" for g in (1, 2, 3)} <= set(z.files)
        res = _one_process(exp, num_epochs=EPOCHS, resume=True)
        assert np.array_equal(res.losses, straight.losses)
        assert np.array_equal(res.latent_codes, straight.latent_codes)
        for name, p in straight.params.items():
            for k in ("w", "b"):
                assert torch.equal(res.params[name][k], p[k]), (name, k)


def test_a_snapshot_of_another_shard_count_is_refused(tmp_path, snapshot_2x2):
    """The 4-shard snapshot is refused by 2 processes x 1 shard and by one
    process of 2 shards: the draws would differ."""
    exp = str(tmp_path / "exp")
    shutil.copytree(snapshot_2x2, exp)
    for rc, out, report in _two_processes(exp, local_shards=1, epochs=EPOCHS, resume=True):
        assert rc != 0 and report is None
        assert "was written by a run on 4 shards, not 2" in out, out[-4000:]
    with pytest.raises(ValueError, match="on 4 shards, not 2"):
        _one_process(exp, shards=2, num_epochs=EPOCHS, resume=True)


def test_a_failing_shard_fails_every_process(tmp_path, data):
    """An exception in rank 1's shards at its second step raises in both
    processes within that step, naming rank 1 and its first shard (global
    shard 2); neither waits out the spawn's timeout."""
    exp = _experiment(tmp_path / "exp", data)
    t0 = time.monotonic()
    results = _two_processes(exp, epochs=EPOCHS, patch=FAIL_RANK_1)
    assert time.monotonic() - t0 < SPAWN_TIMEOUT / 2
    for rank, (rc, out, report) in enumerate(results):
        assert rc not in (0, None) and report is None, (rank, out[-4000:])
        assert "training step failed on rank 1: RuntimeError: shard 2: FloatingPointError: " \
               "forced failure" in out, (rank, out[-4000:])
        assert "epoch    1/6" in out and "epoch    2/6" not in out, (rank, out[-4000:])


@pytest.mark.parametrize("what", sorted(START_APART))
def test_processes_that_start_apart_refuse_to_train(tmp_path, data, what):
    """Processes whose parameters differ at the start, or that hold
    different numbers of shards, raise in every process before a step."""
    exp = _experiment(tmp_path / "exp", data)
    want = {"parameters": "the processes of the mesh start from different states",
            "shards": "processes hold [2, 1] shards: a fruit mesh needs the same number in each"}
    for rank, (rc, out, report) in enumerate(_two_processes(exp, epochs=EPOCHS,
                                                            patch=START_APART[what])):
        assert rc not in (0, None) and report is None, (rank, out[-4000:])
        assert want[what] in out and "epoch    1/6" not in out, (rank, out[-4000:])


def test_only_rank_0_writes(tmp_path, data):
    """With snapshots every 2 epochs and the final save, rank 0 alone writes
    the checkpoint and the training state (each snapshot and the end); both
    processes return its path, and the state holds every global shard's
    generator."""
    exp = _experiment(tmp_path / "exp", data)
    results = _two_processes(exp, epochs=4, snapshot_every=2, save=True, patch=RECORD_WRITES)
    reports = _ok(results)
    wrote = [[l.split()[-1] for l in out.splitlines() if l.startswith("WROTE rank ")]
             for _, out, _ in results]
    assert wrote[0] == ["save_native_checkpoint", "_save_train_state"] * 2, wrote
    assert wrote[1] == [], wrote
    assert all("WROTE rank 1" not in out for _, out, _ in results)
    path = os.path.join(exp, "native", "latest.npz")
    assert [r["checkpoint"] for r in reports] == [path, path] and os.path.isfile(path)
    with np.load(path) as z:
        codes = z["latent_codes"]
    with np.load(tdeep._train_state_path(exp)) as z:
        assert int(z["shards"]) == 4 and int(z["epoch"]) == 4
        assert np.array_equal(z["codes"], codes)
        assert {"generator"} | {f"generator.{g}" for g in (1, 2, 3)} <= set(z.files)
        # each global shard's generator state is its own
        assert len({z["generator"].tobytes()} | {z[f"generator.{g}"].tobytes()
                                                  for g in (1, 2, 3)}) == 4
