"""The port's `CompletionServer` against the JAX package's on the CPU: the
cases of `tests/test_serve.py` (synthetic_small_8, its CFG: 2 frames x 64
rays x 16 samples, 64 points, 3 iterations, lambda 0.5) on both packages,
at its `_requests`.

Tolerances. Each port result is held lane for lane to the JAX server's
result for the same request (single device, `use_mesh=False`): iteration
counts, `failed` flags and `batch_size` equal, latent and pose within 2e-4
(`tests/test_torch_solver.py`: f32 sums in another order over 3
iterations). The fixed-lambda schedule of `CFG` carries a few lanes across
render-band edges (`tests/test_torch_challenge.py` docstring). Such a lane
is also solved alone under JAX's two probes of that file: JAX's solve
continued from the port's first iterate (which must agree with JAX's own
within 1e-6), and JAX's LM iteration dispatched op by op. Where a probe
moves JAX's lane by more than 2e-4, the port's lane is held, at the same
2e-4, to the one of JAX's runs (served, or a probe's) that lies nearest to
it. Each case names the lanes so held, and no other lane may take that
route: on these cases 2 of the ~60 served lanes (`fruit_001` of seed 55,
`fruit_025` of seed 3; measured: each within 1e-6 of both probes, 1.5e-3
and 1.4e-2 from JAX's served run).
Where a case holds the server to a direct solve in the same package at the
same batch width, the bound is JAX's own 1e-5. Served meshes lie within
half a voxel of JAX's (mean symmetric nearest-neighbour distance). The
fruit-parallel server (`use_mesh=True`, 8 CPU shards) is held to JAX's
sharded server on its 8 virtual devices at the same bounds, and to the
port's direct `shard_joint_opt` of the batch within 1e-5.
"""

import dataclasses
import threading
import time
from concurrent.futures import Future

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from hortimapping_tpu.optim import lm as jlm
from hortimapping_tpu.serve import CompletionServer as JServer
from hortimapping_tpu_torch.models.workspace import config_decoder
from hortimapping_tpu_torch.ops.mesher import MeshExtractor
from hortimapping_tpu_torch.optim import lm as tlm
from hortimapping_tpu_torch.optim.state import FruitObservations, stack_observations
from hortimapping_tpu_torch.optim.warmstart import warmstart_solve
from hortimapping_tpu_torch.config import JointOptConfig
from hortimapping_tpu_torch.serve import (
    CompletionRequest,
    CompletionServer,
    DeadlineExceeded,
    ServerOverloaded,
    _assemble_batch_np,
    _shape_key,
)
from test_serve import ASSET_DIR, CFG as JCFG, _requests as _jax_requests
from test_serve import config_decoder as jconfig_decoder
from test_serve import pytestmark  # noqa: F401  (skip without the synthetic assets)

torch.set_num_threads(1)

CFG = JointOptConfig(**dataclasses.asdict(JCFG))
VOXELS, RADIUS = 24, 0.1


@pytest.fixture(scope="module")
def decoders():
    jp, jspec = jconfig_decoder(ASSET_DIR)
    params, spec = config_decoder(ASSET_DIR, device="cpu")
    return jp, jspec, params, spec


def _port(req) -> CompletionRequest:
    """The port's request for a JAX request (host numpy fields)."""
    return CompletionRequest(
        fruit_id=req.fruit_id, obs=FruitObservations(*(np.asarray(a) for a in req.obs)),
        latent0=np.asarray(req.latent0), T_ow0=np.asarray(req.T_ow0),
        pose_known=req.pose_known, deadline_s=req.deadline_s)


def _requests(decoders, n, seed=0):
    """`tests/test_serve.py`'s requests: (JAX's, the port's)."""
    jreqs = _jax_requests(decoders[1], n, seed)
    return jreqs, [_port(r) for r in jreqs]


def _bucket_b(decoders, seed, first, prefix):
    """A second shape bucket (3 frames), as `tests/test_serve.py` makes it."""
    from hortimapping_tpu.serve import CompletionRequest as JRequest
    from hortimapping_tpu.tools.synthetic import SyntheticCategory, make_scene

    spec = decoders[1]
    cat = SyntheticCategory(spec=spec)
    rng = np.random.default_rng(seed)
    jreqs = []
    for b in range(2):
        code = rng.normal(size=spec.code_length).astype(np.float32) * 0.3
        T_wo = np.eye(4, dtype=np.float32)
        obs, _ = make_scene(cat, code, T_wo, n_frames=3, n_fg=JCFG.n_fg_pix,
                            n_bg=JCFG.n_bg_pix, n_points=JCFG.recon_n_pts, seed=first + b)
        jreqs.append(JRequest(fruit_id=f"{prefix}_{b}", obs=obs,
                              latent0=np.zeros(spec.code_length, np.float32),
                              T_ow0=np.linalg.inv(T_wo).astype(np.float32)))
    return jreqs, [_port(r) for r in jreqs]


def _server(decoders, cfg=CFG, **kw):
    return CompletionServer(decoders[2], decoders[3], cfg, cube_radius=RADIUS, device="cpu", **kw)


def _jax_served(decoders, jreqs, cfg=JCFG, table=None, sequential=False, use_mesh=False, **kw):
    """JAX's server (single device, or sharded over the session's 8 virtual
    devices) on the requests (all submitted, then waited for; or each waited
    for before the next is submitted): results by fruit id."""
    with JServer(decoders[0], decoders[1], cfg, cube_radius=RADIUS, use_mesh=use_mesh,
                 latent_table=table, **kw) as srv:
        if sequential:
            results = [srv.submit(r).result(timeout=600) for r in jreqs]
        else:
            results = [f.result(timeout=600) for f in [srv.submit(r) for r in jreqs]]
    return {r.fruit_id: r for r in results}


def _jax_probes(decoders, jreq, jcfg):
    """JAX's solve of the request alone under the two probes of the module
    docstring: (latent, T_ow) of each."""
    from hortimapping_tpu.serve import _assemble_batch_np as jassemble
    from test_torch_challenge import jax_op_by_op

    assert jcfg.init_mode == "mean" and not jcfg.coarse_to_fine and jcfg.pose_polish_iters == 0
    obs, lat0, T0 = jassemble([jreq], 1)
    first_cfg = dataclasses.replace(jcfg, max_iter=1)
    tobs = FruitObservations(*(torch.as_tensor(np.array(a)) for a in obs))
    first_t = tlm.shape_pose_joint_opt_batched(
        decoders[2], decoders[3], JointOptConfig(**dataclasses.asdict(first_cfg)), tobs,
        torch.as_tensor(lat0), torch.as_tensor(T0), RADIUS, device="cpu")
    first_j = jlm.shape_pose_joint_opt_batched(decoders[0], decoders[1], first_cfg, obs, lat0, T0,
                                               RADIUS)
    np.testing.assert_allclose(first_t.latent.numpy(), np.asarray(first_j.latent), atol=1e-6,
                               rtol=0)
    np.testing.assert_allclose(first_t.T_ow.numpy(), np.asarray(first_j.T_ow), atol=1e-6, rtol=0)
    runs = [jlm._continue_joint_opt_batched(decoders[0], decoders[1], jcfg, obs,
                                            jnp.asarray(first_t.latent.numpy()),
                                            jnp.asarray(first_t.T_ow.numpy()), RADIUS, False, 1),
            jax_op_by_op(None, decoders[0], decoders[1], jcfg, None, obs, lat0, T0, RADIUS, False)]
    return [(np.asarray(r.latent[0]), np.asarray(r.T_ow[0])) for r in runs]


def _gap(latent_a, T_a, latent_b, T_b):
    return max(np.abs(latent_a - latent_b).max(), np.abs(T_a - T_b).max())


def _held(results, jax_res, decoders, jreqs, moved=(), batch_size=True, jcfg=JCFG):
    """Each port result lane for lane to JAX's (module docstring); `jreqs`:
    the JAX requests. `moved`: the fruit ids of the lanes a probe moves,
    which are held to the nearest of JAX's runs; exactly these may be."""
    jreqs = {r.fruit_id: r for r in jreqs}
    held_to_probe = set()
    for got in results:
        want = jax_res[got.fruit_id]
        assert got.fruit_id == want.fruit_id
        assert got.iter_count == want.iter_count and got.failed == want.failed
        assert got.converged == want.converged
        if batch_size:
            assert got.batch_size == want.batch_size
        if _gap(got.latent, got.T_ow, want.latent, want.T_ow) <= 2e-4:
            continue
        probes = _jax_probes(decoders, jreqs[got.fruit_id], jcfg)
        assert max(_gap(*p, want.latent, want.T_ow) for p in probes) > 2e-4, got.fruit_id
        nearest = min(_gap(got.latent, got.T_ow, *run)
                      for run in [(want.latent, want.T_ow), *probes])
        assert nearest <= 2e-4, (got.fruit_id, nearest)
        held_to_probe.add(got.fruit_id)
    assert held_to_probe == set(moved)


def _direct(decoders, reqs, solver=tlm.shape_pose_joint_opt_batched, cfg=CFG):
    obs = stack_observations([r.obs for r in reqs], "cpu")
    lat0 = torch.as_tensor(np.stack([r.latent0 for r in reqs]))
    T0 = torch.as_tensor(np.stack([r.T_ow0 for r in reqs]))
    return solver(decoders[2], decoders[3], cfg, obs, lat0, T0, RADIUS, device="cpu")


def test_serve_matches_direct_batched_solve(decoders):
    jreqs, reqs = _requests(decoders, 5)
    want = _direct(decoders, reqs)
    with _server(decoders, max_batch=5) as srv:
        futs = [srv.submit(r) for r in reqs]
        results = [f.result(timeout=300) for f in futs]
    assert [r.fruit_id for r in results] == [r.fruit_id for r in reqs]
    for i, r in enumerate(results):
        np.testing.assert_allclose(r.latent, want.latent[i].numpy(), atol=1e-5)
        np.testing.assert_allclose(r.T_ow, want.T_ow[i].numpy(), atol=1e-5)
        assert r.iter_count == int(want.iter_count[i])
        assert not r.failed and r.batch_size == 5 and r.latency_s > 0
    stats = srv.stats()
    assert stats["completed"] == 5 and stats["fruits_per_sec"] > 0 and stats["devices"] == 1
    _held(results, _jax_served(decoders, jreqs, max_batch=5), decoders, jreqs)


def test_serve_partial_batch_padding(decoders):
    """3 requests with max_batch=8: a width-4 solve whose padded lane must
    not leak into the results."""
    jreqs, reqs = _requests(decoders, 3, seed=42)
    with _server(decoders, max_batch=8, max_wait_s=2.0) as srv:
        results = [f.result(timeout=300) for f in [srv.submit(r) for r in reqs]]
    assert all(not r.failed and r.batch_size == 3 for r in results)
    _held(results, _jax_served(decoders, jreqs, max_batch=8, max_wait_s=2.0), decoders, jreqs)


def test_padded_lane_fails_at_once_and_leaves_the_real_lanes(decoders):
    """The padding of `_assemble_batch_np`: masks False, numeric buffers
    repeating the last real lane, code zero, pose identity. The padded lane
    fails at its first iteration, and the real lanes equal the unpadded
    solve at their own width within 1e-5 (the batch width changes only
    summation orders)."""
    _, reqs = _requests(decoders, 3, seed=42)
    obs, lat0, T0 = _assemble_batch_np(reqs, 4)
    assert not obs.ray_valid[3].any() and not obs.frame_valid[3].any()
    assert not obs.point_valid[3].any()
    np.testing.assert_array_equal(obs.rays[3], obs.rays[2])
    np.testing.assert_array_equal(lat0[3], 0.0)
    np.testing.assert_array_equal(T0[3], np.eye(4))
    res, _ = tlm.joint_opt_packed(decoders[2], decoders[3], CFG,
                                  FruitObservations(*(torch.as_tensor(a) for a in obs)),
                                  torch.as_tensor(lat0), torch.as_tensor(T0), RADIUS,
                                  device="cpu")
    assert bool(res.failed[3]) and int(res.iter_count[3]) == 0
    assert not bool(res.failed[:3].any())
    assert bool(torch.isfinite(res.latent).all()) and bool(torch.isfinite(res.T_ow).all())
    want = _direct(decoders, reqs)
    np.testing.assert_allclose(res.latent[:3].numpy(), want.latent.numpy(), atol=1e-5, rtol=0)
    np.testing.assert_allclose(res.T_ow[:3].numpy(), want.T_ow.numpy(), atol=1e-5, rtol=0)


def test_serve_multiple_waves_reuse_program(decoders):
    """Two waves through one server: the second is no slower than the
    first (same shapes: nothing is set up again)."""
    jreqs_a, reqs_a = _requests(decoders, 4)
    jreqs_b, reqs_b = _requests(decoders, 4, seed=9)
    srv = _server(decoders, max_batch=4)
    with srv:
        t0 = time.perf_counter()
        first_res = [srv.submit(r).result(timeout=300) for r in reqs_a]
        first = time.perf_counter() - t0
        t0 = time.perf_counter()
        second_res = [srv.submit(r).result(timeout=300) for r in reqs_b]
        second = time.perf_counter() - t0
    assert second < max(2.0 * first, first + 1.0), (first, second)
    assert srv.stats()["completed"] == 8
    for jreqs, res in ((jreqs_a, first_res), (jreqs_b, second_res)):
        _held(res, _jax_served(decoders, jreqs, max_batch=4, sequential=True), decoders, jreqs)


def test_serve_meshing(decoders):
    """Meshing through the one-copy buffer (`pack_solve_with_grids`): every
    result carries its mesh, within half a voxel of JAX's."""
    from hortimapping_tpu.ops.mesher import MeshExtractor as JMesher

    jreqs, reqs = _requests(decoders, 2, seed=7)
    mesher = MeshExtractor(decoders[2], decoders[3], voxels_dim=VOXELS, cube_radius=RADIUS,
                           device="cpu")
    with _server(decoders, max_batch=2, mesher=mesher) as srv:
        results = [srv.submit(r).result(timeout=300) for r in reqs]
    jax_res = _jax_served(decoders, jreqs, max_batch=2, sequential=True,
                          mesher=JMesher(decoders[0], decoders[1], voxels_dim=VOXELS,
                                         cube_radius=RADIUS))
    _held(results, jax_res, decoders, jreqs)
    voxel = 2 * RADIUS / (VOXELS - 1)
    for r in results:
        assert r.mesh is not None and r.mesh.vertices.shape[0] > 0
        a, b = r.mesh.vertices, np.asarray(jax_res[r.fruit_id].mesh.vertices)
        gap = 0.5 * (cKDTree(b).query(a)[0].mean() + cKDTree(a).query(b)[0].mean())
        assert gap <= 0.5 * voxel, gap


def test_serve_mixed_shape_buckets(decoders):
    """Two observation shapes are packed into separate batches."""
    jreqs_a, reqs_a = _requests(decoders, 2, seed=1)
    jreqs_b, reqs_b = _bucket_b(decoders, 5, 50, "b")
    with _server(decoders, max_batch=8, max_wait_s=1.0) as srv:
        results = [f.result(timeout=600) for f in [srv.submit(r) for r in reqs_a + reqs_b]]
    assert all(r.batch_size == 2 and not r.failed for r in results)
    assert _shape_key(reqs_a[0]) != _shape_key(reqs_b[0])
    _held(results, _jax_served(decoders, jreqs_a + jreqs_b, max_batch=8, max_wait_s=1.0),
          decoders, jreqs_a + jreqs_b)


def test_serve_minority_bucket_not_starved(decoders):
    """A steady majority-shape stream does not starve a minority bucket:
    the bucket whose head request is oldest is served first."""
    jmaj, majority = _requests(decoders, 30, seed=3)
    jmin, minority = _bucket_b(decoders, 77, 99, "minority")
    minority = minority[0]
    order = []

    def track(fut, tag):
        fut.add_done_callback(lambda f: order.append(tag))
        return fut

    results = {}
    with _server(decoders, max_batch=2, max_wait_s=0.01) as srv:
        srv.submit(majority[0]).result(timeout=600)
        srv.submit(minority).result(timeout=600)
        futs = [track(srv.submit(r), "A") for r in majority[1:7]]
        lock = threading.Lock()

        def producer():
            for r in majority[7:]:
                with lock:
                    futs.append(track(srv.submit(r), "A"))
                time.sleep(0.02)

        prod = threading.Thread(target=producer)
        prod.start()
        time.sleep(0.05)   # the minority arrives while the majority stream flows
        fut_b = track(srv.submit(minority), "B")
        prod.join(timeout=600)
        assert not prod.is_alive()
        results[minority.fruit_id] = fut_b.result(timeout=600)
        with lock:
            for f in futs:
                r = f.result(timeout=600)
                results[r.fruit_id] = r
    pos_b = order.index("B")
    assert pos_b < len(order) - 8, f"minority request served at {pos_b}/{len(order)}: starved"
    assert srv.stats()["latency_p95_s"] > 0.0
    jreqs = jmaj + jmin[:1]
    _held(results.values(), _jax_served(decoders, jreqs, max_batch=2), decoders, jreqs,
          moved={"fruit_025"}, batch_size=False)


def test_serve_coarse_to_fine_matches_direct(decoders):
    jcfg = dataclasses.replace(JCFG, coarse_to_fine=True, fine_max_iter=2, coarse_frame_stride=2)
    cfg = JointOptConfig(**dataclasses.asdict(jcfg))
    jreqs, reqs = _requests(decoders, 3, seed=21)
    want = _direct(decoders, reqs, tlm.coarse_to_fine_joint_opt, cfg)
    with _server(decoders, cfg, max_batch=3) as srv:
        results = [f.result(timeout=600) for f in [srv.submit(r) for r in reqs]]
    for i, r in enumerate(results):
        assert not r.failed
        np.testing.assert_allclose(r.latent, want.latent[i].numpy(), atol=1e-5)
        np.testing.assert_allclose(r.T_ow, want.T_ow[i].numpy(), atol=1e-5)
    _held(results, _jax_served(decoders, jreqs, jcfg, max_batch=3), decoders, jreqs, jcfg=jcfg)


def test_serve_restart_after_stop_raises(decoders):
    srv = _server(decoders)
    srv.start()
    srv.stop()
    with pytest.raises(RuntimeError, match="restart"):
        srv.start()
    with pytest.raises(RuntimeError, match="not running"):
        srv.submit(_requests(decoders, 1)[1][0])


def _cpu_mesh():
    from hortimapping_tpu_torch.parallel import fruit_mesh

    return fruit_mesh(devices=["cpu"] * 8)


def test_serve_sharded_matches_direct_and_jax(decoders):
    """The counterpart of `test_serve_sharded_matches_single_device`: with
    `use_mesh=True` over 8 CPU shards max_batch 5 rounds up to 8, the server
    reports 8 devices, and each served lane equals the port's direct
    `shard_joint_opt` of the batch within 1e-5 and JAX's sharded serving on
    its 8 virtual devices at the module's bounds; None and False serve on
    the one device."""
    from hortimapping_tpu_torch.parallel import shard_joint_opt

    jreqs, reqs = _requests(decoders, 5, seed=33)
    srv = _server(decoders, max_batch=5, use_mesh=True, mesh=_cpu_mesh())
    assert srv.max_batch == 8 and srv._batch_width(5) == 8 and srv._batch_width(1) == 8
    with srv:
        results = [f.result(timeout=600) for f in [srv.submit(r) for r in reqs]]
    assert srv.stats()["devices"] == 8 and all(r.batch_size == 5 for r in results)
    obs, lat0, T0 = _assemble_batch_np(reqs, 8)
    want = shard_joint_opt(decoders[2], decoders[3], CFG,
                           FruitObservations(*(torch.as_tensor(a) for a in obs)),
                           torch.as_tensor(lat0), torch.as_tensor(T0), RADIUS, _cpu_mesh(),
                           device="cpu")
    for i, r in enumerate(results):
        assert not r.failed and r.iter_count == int(want.iter_count[i])
        np.testing.assert_allclose(r.latent, want.latent[i].numpy(), atol=1e-5, rtol=0)
        np.testing.assert_allclose(r.T_ow, want.T_ow[i].numpy(), atol=1e-5, rtol=0)
    _held(results, _jax_served(decoders, jreqs, max_batch=5, use_mesh=True), decoders, jreqs)
    for use_mesh in (None, False):
        assert _server(decoders, use_mesh=use_mesh).stats()["devices"] == 1


def test_serve_meshing_sharded(decoders):
    """`tests/test_serve.py::test_serve_meshing`'s sharded half: meshing
    through the one-copy buffer behind the sharded solve; every result
    carries its mesh, within half a voxel of JAX's sharded server's."""
    from hortimapping_tpu.ops.mesher import MeshExtractor as JMesher

    jreqs, reqs = _requests(decoders, 2, seed=7)
    mesher = MeshExtractor(decoders[2], decoders[3], voxels_dim=VOXELS, cube_radius=RADIUS,
                           device="cpu")
    with _server(decoders, max_batch=2, mesher=mesher, use_mesh=True, mesh=_cpu_mesh()) as srv:
        results = [srv.submit(r).result(timeout=300) for r in reqs]
    jax_res = _jax_served(decoders, jreqs, max_batch=2, sequential=True, use_mesh=True,
                          mesher=JMesher(decoders[0], decoders[1], voxels_dim=VOXELS,
                                         cube_radius=RADIUS))
    _held(results, jax_res, decoders, jreqs)
    voxel = 2 * RADIUS / (VOXELS - 1)
    for r in results:
        assert r.mesh is not None and r.mesh.vertices.shape[0] > 0
        a, b = r.mesh.vertices, np.asarray(jax_res[r.fruit_id].mesh.vertices)
        gap = 0.5 * (cKDTree(b).query(a)[0].mean() + cKDTree(a).query(b)[0].mean())
        assert gap <= 0.5 * voxel, gap


def test_serve_admission_control(decoders):
    jreqs, reqs = _requests(decoders, 4, seed=55)
    srv = _server(decoders, max_batch=8, max_wait_s=2.0, max_queue=2)
    with srv:
        f0 = srv.submit(reqs[0])
        f1 = srv.submit(reqs[1])
        with pytest.raises(ServerOverloaded):
            srv.submit(reqs[2])
        assert srv.stats()["inflight"] == 2
        r0, r1 = f0.result(timeout=600), f1.result(timeout=600)
        f3 = srv.submit(reqs[3])
        r3 = f3.result(timeout=600)
    assert srv.stats()["inflight"] == 0
    jax_res = _jax_served(decoders, jreqs[:2], max_batch=8, max_wait_s=2.0)
    jax_res.update(_jax_served(decoders, jreqs[3:], max_batch=8))
    assert not any(r.failed for r in (r0, r1, r3))
    _held((r0, r1, r3), jax_res, decoders, jreqs, moved={"fruit_001"})


def test_serve_deadline(decoders):
    jreqs, reqs = _requests(decoders, 3, seed=77)
    expired_req = dataclasses.replace(reqs[0], deadline_s=0.0)
    ok_req = dataclasses.replace(reqs[1], deadline_s=60.0)
    with _server(decoders, max_batch=4, max_wait_s=1.0) as srv:
        f_exp = srv.submit(expired_req)
        f_ok = srv.submit(ok_req)
        f_plain = srv.submit(reqs[2])
        with pytest.raises(DeadlineExceeded):
            f_exp.result(timeout=300)
        r_ok, r_plain = f_ok.result(timeout=300), f_plain.result(timeout=300)
        stats = srv.stats()
    assert stats["deadline_expired"] == 1 and stats["completed"] == 2
    assert not r_ok.failed and not r_plain.failed
    _held((r_ok, r_plain), _jax_served(decoders, jreqs[1:], max_batch=4, max_wait_s=1.0), decoders,
          jreqs)


def test_serve_batch_width_capped_and_warmed(decoders):
    srv = _server(decoders, max_batch=12)
    jsrv = JServer(decoders[0], decoders[1], JCFG, cube_radius=RADIUS, max_batch=12,
                   use_mesh=False)
    assert [srv._batch_width(n) for n in (1, 3, 8, 9, 12)] == [1, 4, 8, 12, 12]
    assert ([srv._batch_width(n) for n in range(1, 40)]
            == [jsrv._batch_width(n) for n in range(1, 40)])
    warm = set()
    w = 1
    while w < srv.max_batch:
        warm.add(srv._batch_width(w))
        w *= 2
    warm.add(srv._batch_width(srv.max_batch))
    assert {srv._batch_width(n) for n in range(1, srv.max_batch + 1)} == warm


def test_serve_warmup_then_serve(decoders):
    jreqs, reqs = _requests(decoders, 3, seed=77)
    srv = _server(decoders, max_batch=4)
    srv.warmup(reqs[0])  # before start(): no worker needed
    with srv:
        got = [f.result(timeout=600) for f in [srv.submit(r) for r in reqs]]
    want = _direct(decoders, reqs)
    for i, g in enumerate(got):
        np.testing.assert_allclose(g.latent, want.latent[i].numpy(), atol=1e-5)
    _held(got, _jax_served(decoders, jreqs, max_batch=4), decoders, jreqs)


def test_serve_retrieval_warmstart_matches_direct(decoders):
    jcfg = dataclasses.replace(JCFG, init_mode="retrieval", retrieval_score_pts=32,
                               retrieval_n_scales=3)
    cfg = JointOptConfig(**dataclasses.asdict(jcfg))
    with pytest.raises(ValueError, match="latent_table"):
        _server(decoders, cfg)
    table = (np.random.default_rng(5).normal(size=(16, decoders[3].code_length)) * 0.3
             ).astype(np.float32)
    jreqs, reqs = _requests(decoders, 3, seed=7)
    obs = stack_observations([r.obs for r in reqs], "cpu")
    want = warmstart_solve(decoders[2], decoders[3], cfg, torch.as_tensor(table), obs,
                           torch.as_tensor(np.stack([r.latent0 for r in reqs])),
                           torch.as_tensor(np.stack([r.T_ow0 for r in reqs])), RADIUS,
                           device="cpu")
    with _server(decoders, cfg, max_batch=3, latent_table=table) as srv:
        results = [f.result(timeout=600) for f in [srv.submit(r) for r in reqs]]
    for i, r in enumerate(results):
        assert not r.failed
        np.testing.assert_allclose(r.latent, want.latent[i].numpy(), atol=1e-5)
        np.testing.assert_allclose(r.T_ow, want.T_ow[i].numpy(), atol=1e-5)
    _held(results, _jax_served(decoders, jreqs, jcfg, table=jnp.asarray(table), max_batch=3),
          decoders, jreqs, jcfg=jcfg)


def test_serve_multi_start_rejected(decoders):
    cfg = JointOptConfig(**dataclasses.asdict(dataclasses.replace(
        JCFG, init_mode="retrieval", multi_start=2, retrieval_score_pts=32)))
    with pytest.raises(ValueError, match="multi_start"):
        _server(decoders, cfg, latent_table=np.zeros((8, decoders[3].code_length), np.float32))


def test_serve_warmup_multiple_buckets(decoders):
    jreqs_a, reqs_a = _requests(decoders, 2, seed=11)
    jreqs_b, reqs_b = _bucket_b(decoders, 13, 60, "wb")
    srv = _server(decoders, max_batch=2, max_wait_s=0.5)
    srv.warmup([reqs_a[0], reqs_b[0], reqs_a[1]])  # the third sample: a bucket seen
    with srv:
        results = [f.result(timeout=600) for f in [srv.submit(r) for r in reqs_a + reqs_b]]
    assert all(not r.failed and r.batch_size == 2 for r in results)
    _held(results, _jax_served(decoders, jreqs_a + jreqs_b, max_batch=2, max_wait_s=0.5),
          decoders, jreqs_a + jreqs_b)


def test_serve_expire_skips_done_future(decoders):
    """A request whose Future is already resolved (cancelled between submit
    and pack) is dropped but not counted as expired; a live one past its
    deadline is."""
    req = dataclasses.replace(_requests(decoders, 1, seed=5)[1][0], deadline_s=0.0)
    srv = _server(decoders, max_batch=2)
    try:
        t_past = time.perf_counter() - 1.0
        fut_cancelled: Future = Future()
        fut_cancelled.cancel()
        assert srv._expire((req, fut_cancelled, t_past)) is True
        assert srv.stats()["deadline_expired"] == 0
        fut_live: Future = Future()
        assert srv._expire((req, fut_live, t_past)) is True
        assert srv.stats()["deadline_expired"] == 1
        assert isinstance(fut_live.exception(), DeadlineExceeded)
    finally:
        srv.stop()


def test_worker_failure_resolves_every_future(decoders, monkeypatch):
    """An exception in the worker's solve resolves each Future of the batch
    with it; the server then serves the next batch."""
    _, reqs = _requests(decoders, 3, seed=2)
    calls = []
    real = tlm.joint_opt_packed

    def failing_once(*a, **k):
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("solve failed")
        return real(*a, **k)

    monkeypatch.setattr(tlm, "joint_opt_packed", failing_once)
    with _server(decoders, max_batch=2, max_wait_s=0.5) as srv:
        futs = [srv.submit(r) for r in reqs[:2]]
        for f in futs:
            with pytest.raises(RuntimeError, match="solve failed"):
                f.result(timeout=300)
        assert not srv.submit(reqs[2]).result(timeout=300).failed

