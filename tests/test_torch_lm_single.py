"""The port's single-fruit solvers, its one-call serving solve and the
mesher's one-copy packing against the JAX package on the CPU, on the world
of `tests/test_lm_e2e.py` (its CFG: 5 frames x 128 rays x 24 samples, 300
points, Sim(3), lambda 0.1, <= 30 iterations; its synthetic_small_8 decoder
widened to the kernels' 128 units, so the port runs the plain versions of
its kernels, the render term in f32, and JAX its CPU route, as in
`tests/test_torch_solver.py`).

Tolerances.
* Every LM iteration the port runs in these tests (`jax_steps`): from the
  same state, JAX's iteration gives the port's next state within 2e-4 in
  latent and pose on every live lane, with equal iteration counts and
  flags (one iteration's f32 sums in another order: ~1e-6; a sample that
  sits on a band edge can switch within the step: measured <= 8.2e-5).
  This world's 30-iteration
  solves are not held end to end: their objective is piecewise smooth (a
  sample crossing a band edge switches its ray), and the ~1e-7 by which the
  packages' iterates differ grows to 1e-2 over 8 - 30 iterations on most of
  its fruits, as it does between JAX's own compiled and stepped loops on
  the greenhouse fixture (`tests/test_torch_greenhouse.py`).
* End to end at 3 iterations a phase (`joint_opt_packed`): iteration counts
  and flags equal, latent and pose within 2e-4 (`tests/test_torch_solver.py`).
* The traced solve: `max_iter` entries, the frozen ones repeating the final
  state bit for bit, the last equal to the untraced solve's result.
* Batched against single in the port, on `test_lm_e2e.py`'s own world (its
  64-wide decoder): the property of
  `test_lm_e2e.py::test_batched_matches_single` (iteration counts equal,
  latent within 0.03, translation error within 2 mm).
* `joint_opt_packed` against its own steps called one by one: bit for bit.
* `pack_solve_with_grids`: the head bit for bit `pack_result`, the grids
  bit for bit `decode_grids` (f16), the meshes from the unpacked grids
  those of `extract_batch`.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hortimapping_tpu import config as jconfig
from hortimapping_tpu.optim import lm as jlm
from hortimapping_tpu.optim.state import FruitObservations as JObs
from hortimapping_tpu.optim.state import OptState as JState
from hortimapping_tpu_torch import config as tconfig
from hortimapping_tpu_torch.ops.mesher import MeshExtractor
from hortimapping_tpu_torch.optim import lm as tlm
from hortimapping_tpu_torch.optim import warmstart as tws
from hortimapping_tpu_torch.optim.state import OptResult, stack_observations
from hortimapping_tpu.models.decoder import DecoderSpec as JSpec
from hortimapping_tpu.tools.synthetic import SyntheticCategory
from hortimapping_tpu_torch.models.decoder import DecoderSpec as TSpec
from hortimapping_tpu_torch.models.workspace import config_decoder, params_from_jax
from test_lm_e2e import ASSET_DIR, CUBE_RADIUS, _fruit, _gt_pose, _translation_error
from test_lm_e2e import CFG as E2E_CFG
from torch_port_common import load_npz_params, widen_decoder_np

torch.set_num_threads(1)

# the fused render term in f32 on both sides, so both packages solve the
# same f32 problem (`tests/test_torch_solver.py`)
CFG = dataclasses.replace(E2E_CFG, fused_bf16=False)
TCFG = tconfig.JointOptConfig(**dataclasses.asdict(CFG))

pytestmark = pytest.mark.skipif(not os.path.isdir(ASSET_DIR), reason="synthetic assets not built")


@pytest.fixture(scope="module")
def widened():
    """synthetic_small_8 zero-padded to the 128-wide hidden layers the
    port's kernels take (the same function exactly): (numpy params, spec
    fields, base radius)."""
    params_np, fields, _, base_radius = load_npz_params("synthetic_small_8")
    return (*widen_decoder_np(params_np, fields, 128), base_radius)


@pytest.fixture(scope="module")
def world(widened):
    """`test_lm_e2e.py`'s world on the widened decoder, as `_fruit` takes
    it: (JAX params, JAX spec, category, projection)."""
    params_np, fields, base_radius = widened
    spec = JSpec(**fields)
    cat = SyntheticCategory(spec=spec, base_radius=base_radius)
    return jax.tree_util.tree_map(jnp.asarray, params_np), spec, cat, cat.projection()


@pytest.fixture(scope="module")
def port(widened):
    params_np, fields, _ = widened
    spec = TSpec(**fields)
    table = np.asarray(np.random.default_rng(5).normal(size=(16, spec.code_length)) * 0.3,
                       np.float32)
    return params_from_jax(params_np, "cpu"), spec, table


def _init(world, seed, center, scale, offset=(0.010, -0.008, 0.006)):
    code_gt, T_wo_gt, obs, _ = _fruit(world, seed, center, scale)
    _, T_ow0 = _gt_pose(np.asarray(center) + np.asarray(offset))
    return obs, np.zeros(world[1].code_length, np.float32), T_ow0.astype(np.float32), T_wo_gt


def _same(got, want, atol=2e-4):
    np.testing.assert_array_equal(np.asarray(got.iter_count), np.asarray(want.iter_count))
    np.testing.assert_array_equal(np.asarray(got.failed), np.asarray(want.failed))
    np.testing.assert_array_equal(np.asarray(got.converged), np.asarray(want.converged))
    np.testing.assert_allclose(np.asarray(got.latent), np.asarray(want.latent), atol=atol, rtol=0)
    np.testing.assert_allclose(np.asarray(got.T_ow), np.asarray(want.T_ow), atol=atol, rtol=0)


def _np(res):
    return OptResult(*(a.numpy() for a in res))


@pytest.fixture
def jax_steps(world, monkeypatch):
    """Holds every `lm_iteration` of the port to JAX's iteration from the
    same state (module docstring); yields the list of steps checked."""
    checked, gaps = [], []
    step_t = tlm.lm_iteration
    steps_j = {}

    def held(params, spec, cfg, obs, state, cube_radius, pose_known, packs=None,
             code_known=False):
        new = step_t(params, spec, cfg, obs, state, cube_radius, pose_known, packs, code_known)
        key = (cfg, cube_radius, pose_known, code_known)
        if key not in steps_j:
            jc = jconfig.JointOptConfig(**dataclasses.asdict(cfg))
            steps_j[key] = jax.jit(jax.vmap(lambda o, st: jlm.lm_iteration(
                world[0], world[1], jc, o, st, cube_radius, pose_known, code_known)))
        want = steps_j[key](JObs(*(jnp.asarray(a.numpy()) for a in obs)),
                            JState(*(jnp.asarray(a.numpy()) for a in state)))
        # lanes already done or failed keep their state (`_freeze_if_done`)
        live = ~(state.done | state.failed).numpy()
        for f in ("i", "iter_count", "done", "failed", "converged"):
            np.testing.assert_array_equal(getattr(new, f).numpy()[live],
                                          np.asarray(getattr(want, f))[live])
        gap = max(float(np.abs(new.latent.numpy() - np.asarray(want.latent))[live].max(initial=0)),
                  float(np.abs(new.T_ow.numpy() - np.asarray(want.T_ow))[live].max(initial=0)))
        assert gap <= 2e-4, gap
        gaps.append(gap)
        checked.append(code_known)
        return new

    monkeypatch.setattr(tlm, "lm_iteration", held)
    yield checked
    print(f"{len(gaps)} iterations held to JAX's, worst gap {max(gaps, default=0.0):.3g}")


@pytest.mark.parametrize("pose_known", [False, True])
def test_single_fruit_solve_matches_jax(world, port, jax_steps, pose_known):
    """`test_lm_e2e.py`'s fruit (seed 11: 1.5 cm off, scale 1.1): every
    iteration held to JAX's; with the pose free, the recovery its JAX test
    asks (translation error halved and under 6 mm, scale within 0.12)."""
    params, spec, _ = port
    obs, lat0, T0, T_wo_gt = _init(world, 11, [0.4, 0.1, 0.2], 1.1)
    got = tlm.shape_pose_joint_opt(params, spec, TCFG, obs, lat0, T0, CUBE_RADIUS,
                                   pose_known=pose_known, device="cpu")
    assert got.latent.shape == (spec.code_length,) and got.T_ow.shape == (4, 4)
    assert got.iter_count.shape == () and not bool(got.failed)
    assert len(jax_steps) == int(got.iter_count) > 2
    if not pose_known:
        terr = _translation_error(got.T_ow.numpy(), T_wo_gt)
        assert terr < 0.5 * _translation_error(T0, T_wo_gt) and terr < 0.006
        assert abs(np.linalg.det(np.linalg.inv(got.T_ow.double().numpy())[:3, :3]) ** (1 / 3)
                   - 1.1) < 0.12
    else:
        s0 = np.linalg.det(T0[:3, :3]) ** (1 / 3)
        s1 = np.linalg.det(got.T_ow.numpy()[:3, :3]) ** (1 / 3)
        np.testing.assert_allclose(got.T_ow.numpy()[:3, :3] / s1, T0[:3, :3] / s0, atol=1e-4)


def test_batched_matches_single_fruit(port):
    """`test_lm_e2e.py::test_batched_matches_single` in the port, on its own
    world (the 64-wide decoder): three fruits solved alone and as one
    batch."""
    params, spec = config_decoder(ASSET_DIR, device="cpu")
    with np.load(os.path.join(ASSET_DIR, "native", "latest.npz")) as z:
        proj, base_radius = z["synthetic.projection"], float(z["synthetic.base_radius"])
    jspec = JSpec(code_length=spec.code_length, dims=spec.dims, latent_in=spec.latent_in,
                  clamping_distance=spec.clamping_distance)
    e2e = (None, jspec, SyntheticCategory(spec=jspec, base_radius=base_radius), proj)
    fruits = [_init(e2e, 21, [0.3, 0.0, 0.1], 1.0, (0.008, 0.005, -0.006)),
              _init(e2e, 22, [-0.2, 0.15, 0.3], 1.1, (0.008, 0.005, -0.006)),
              _init(e2e, 23, [0.0, -0.1, -0.25], 0.95, (0.008, 0.005, -0.006))]
    cfg = tconfig.JointOptConfig(**dataclasses.asdict(E2E_CFG))
    singles = [tlm.shape_pose_joint_opt(params, spec, cfg, o, l, T, CUBE_RADIUS, device="cpu")
               for o, l, T, _ in fruits]
    batched = tlm.shape_pose_joint_opt_batched(
        params, spec, cfg, stack_observations([f[0] for f in fruits], "cpu"),
        torch.as_tensor(np.stack([f[1] for f in fruits])),
        torch.as_tensor(np.stack([f[2] for f in fruits])), CUBE_RADIUS, device="cpu")
    for i, (single, fruit) in enumerate(zip(singles, fruits)):
        assert int(batched.iter_count[i]) == int(single.iter_count)
        np.testing.assert_allclose(batched.latent[i].numpy(), single.latent.numpy(), atol=0.03)
        e_single = _translation_error(single.T_ow.numpy(), fruit[3])
        e_batched = _translation_error(batched.T_ow[i].numpy(), fruit[3])
        assert abs(e_single - e_batched) < 2e-3, (e_single, e_batched)


def test_traced_trajectory_matches_jax(world, port, jax_steps):
    """The whole trajectory of `shape_pose_joint_opt_traced`: exactly
    `max_iter` steps, each held to JAX's iteration from the port's previous
    state (the frozen ones too), the frozen ones repeating the final state;
    JAX's traced solve stores the same number of steps."""
    params, spec, _ = port
    cfg, tcfg = (dataclasses.replace(c, max_iter=12) for c in (CFG, TCFG))
    obs, lat0, T0, _ = _init(world, 22, [-0.2, 0.15, 0.3], 1.1, (0.008, 0.005, -0.006))
    want, (w_lat, w_T) = jlm.shape_pose_joint_opt_traced(
        world[0], world[1], cfg, obs, jnp.asarray(lat0), jnp.asarray(T0), CUBE_RADIUS)
    got, (g_lat, g_T) = tlm.shape_pose_joint_opt_traced(params, spec, tcfg, obs, lat0, T0,
                                                        CUBE_RADIUS, device="cpu")
    assert len(jax_steps) == cfg.max_iter
    assert g_lat.shape == w_lat.shape == (cfg.max_iter, spec.code_length)
    assert g_T.shape == w_T.shape == (cfg.max_iter, 4, 4)
    n = int(got.iter_count)
    assert bool(got.converged) and n < cfg.max_iter   # the last steps are frozen
    for k in range(n - 1, cfg.max_iter):
        assert torch.equal(g_lat[k], got.latent) and torch.equal(g_T[k], got.T_ow)
    # this fruit's trajectory stays within the flat bound of JAX's
    _same(_np(got), want)
    np.testing.assert_allclose(g_lat.numpy(), np.asarray(w_lat), atol=2e-4, rtol=0)
    np.testing.assert_allclose(g_T.numpy(), np.asarray(w_T), atol=2e-4, rtol=0)
    plain = tlm.shape_pose_joint_opt(params, spec, tcfg, obs, lat0, T0, CUBE_RADIUS, device="cpu")
    assert torch.equal(plain.latent, got.latent) and torch.equal(plain.T_ow, got.T_ow)


PACKED = {
    "mean": dict(),
    "retrieval_c2f_polish": dict(init_mode="retrieval", retrieval_score_pts=64,
                                 retrieval_n_scales=3, coarse_to_fine=True, fine_max_iter=3,
                                 coarse_frame_stride=2, coarse_max_iter=3, pose_polish_iters=3),
}


@pytest.mark.parametrize("case", list(PACKED))
def test_joint_opt_packed_matches_jax(world, port, jax_steps, case):
    """Two fruits (`test_lm_e2e.py`'s polish test), 3 iterations a phase,
    end to end against JAX's `joint_opt_packed`, every iteration held to
    JAX's; and against the port's own steps called one by one."""
    params, spec, table = port
    jc = dataclasses.replace(CFG, max_iter=3, **PACKED[case])
    tc = tconfig.JointOptConfig(**dataclasses.asdict(jc))
    fruits = [_init(world, 31, [0.25, 0.05, 0.1], 1.05, (0.012, -0.007, 0.009)),
              _init(world, 32, [-0.15, 0.1, 0.2], 1.0, (0.012, -0.007, 0.009))]
    obs_np = [f[0] for f in fruits]
    lat0 = np.stack([f[1] for f in fruits])
    T0 = np.stack([f[2] for f in fruits])
    retrieve = jc.init_mode == "retrieval"
    jobs = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *obs_np)
    want, want_packed = jlm.joint_opt_packed(
        world[0], world[1], jc, jobs, jnp.asarray(lat0), jnp.asarray(T0), CUBE_RADIUS,
        latent_table=jnp.asarray(table) if retrieve else None)
    tobs = stack_observations(obs_np, "cpu")
    got, packed = tlm.joint_opt_packed(
        params, spec, tc, tobs, torch.as_tensor(lat0), torch.as_tensor(T0), CUBE_RADIUS,
        latent_table=torch.as_tensor(table) if retrieve else None, device="cpu")
    _same(_np(got), want)
    assert jax_steps and (any(jax_steps) == (jc.pose_polish_iters > 0))
    assert packed.shape == want_packed.shape == (2, spec.code_length + 19)
    assert torch.equal(packed, tlm.pack_result(got))
    np.testing.assert_allclose(packed.numpy(), np.asarray(want_packed), atol=2e-4, rtol=0)
    # the same steps called one by one
    lat_s, T_s = torch.as_tensor(lat0), torch.as_tensor(T0)
    if retrieve:
        lat_s, T_s = tws.maybe_retrieval_init(params, spec, tc, torch.as_tensor(table), tobs,
                                              lat_s, T_s, device="cpu")
    solver = tlm.coarse_to_fine_joint_opt if tc.coarse_to_fine else tlm.shape_pose_joint_opt_batched
    steps = solver(params, spec, tc, tobs, lat_s, T_s, CUBE_RADIUS, device="cpu")
    steps = tlm.maybe_pose_polish(params, spec, tc, tobs, steps, CUBE_RADIUS, device="cpu")
    for a, b in zip(got, steps):
        assert torch.equal(a, b)


def test_pack_solve_with_grids_round_trip(world, port):
    params, spec, _ = port
    mesher = MeshExtractor(params, spec, voxels_dim=24, cube_radius=0.1, device="cpu")
    rng = np.random.default_rng(0)
    B, C = 3, spec.code_length
    T = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    T[:, :3, 3] = rng.normal(size=(B, 3)) * 0.1
    res = OptResult(torch.as_tensor(rng.normal(size=(B, C)).astype(np.float32) * 0.3),
                    torch.as_tensor(T), torch.tensor([3, 7, 30], dtype=torch.int32),
                    torch.tensor([False, True, False]), torch.tensor([True, False, False]))
    buf = mesher.pack_solve_with_grids(res)
    assert buf.dtype == torch.int16 and buf.shape == (B, 2 * (C + 19) + 24 ** 3)
    head, grids = mesher.unpack_solve_with_grids(buf.numpy().view(np.uint16))
    np.testing.assert_array_equal(head.view(np.uint32),
                                  tlm.pack_result(res).numpy().view(np.uint32))
    want = mesher.decode_grids(res.latent).numpy().reshape(B, 24, 24, 24)
    assert grids.dtype == np.float16
    np.testing.assert_array_equal(grids.view(np.uint16), want.view(np.uint16))
    got_m = mesher.meshes_from_grids(torch.from_numpy(grids))
    want_m = mesher.extract_batch(res.latent)
    for a, b in zip(got_m, want_m):
        np.testing.assert_array_equal(a.vertices, b.vertices)
        np.testing.assert_array_equal(a.faces, b.faces)
