"""The strawberry configuration (`configs/lab_berry.yaml` as the benchmark
runs it: Sim(3), logistic occupancy at a 5 mm cutoff, no occlusion, 15
samples a ray, no robust weights, the berry's clamp 0.05, 1 mm grids in a
0.04 m cube) through the port on the CPU, against the benchmark's plain
reference (`benchmark/lib/reference.py`: plain torch in f32, loaded by
path, importing nothing of the port).

The decoder has the berry's layout (8 layers, `latent_in` [4]) at width 64
and code 8, drawn from a seed; its xyz inputs are scaled by the cube's
radius and its last layer set so that the SDF spreads about +-0.02 m over
the cube and its zero set crosses the grid. Width 64 takes the port's plain
f32 routes on the CPU (the kernels take widths of 128 and up).

Each tolerance is written with its reason, and each test also holds the
reference computed with bf16 operands where the configuration states f32
to the same tolerance, which it must fail.
"""

import dataclasses
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from hortimapping_tpu_torch.config import JointOptConfig
from hortimapping_tpu_torch.models.decoder import DecoderSpec, decoder_apply
from hortimapping_tpu_torch.models.workspace import params_from_jax
from hortimapping_tpu_torch.ops import mesher
from hortimapping_tpu_torch.ops.mesher import MeshExtractor
from hortimapping_tpu_torch.ops.render import sample_points
from hortimapping_tpu_torch.optim import lm
from hortimapping_tpu_torch.optim.state import init_state, stack_observations
from hortimapping_tpu_torch.tools.synthetic import SyntheticCategory, make_scene
from hortimapping_tpu_torch.utils import trace
from torch_port_common import random_decoder_np

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
RADIUS = 0.04                      # the berry's cube (configs/lab_berry.yaml: 0.04 m at 1 mm)
SPEC = DecoderSpec(code_length=8, dims=(64,) * 8, latent_in=(4,), clamping_distance=0.05)
F32 = {"render": "f32", "sdf": "f32", "algebra": "f32"}

torch.set_num_threads(1)


def _reference():
    path = os.path.join(ROOT, "benchmark", "lib", "reference.py")
    spec = importlib.util.spec_from_file_location("bench_reference_strawberry", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


R = _reference()


def _solver_cfg() -> JointOptConfig:
    """The benchmark's strawberry solver at a test's size: 3 frames of 48 +
    24 rays at its 15 samples, 128 surface points."""
    with open(os.path.join(ROOT, "benchmark", "configs", "strawberry_lab.json")) as f:
        solver = json.load(f)["solver"]
    solver.update(n_frame=3, n_fg_pix=48, n_bg_pix=24, recon_n_pts=128)
    return JointOptConfig(**solver)


CFG = _solver_cfg()


@pytest.fixture(scope="module")
def decoder(tmp_path_factory):
    """(port params, reference decoder) of the same seeded weights."""
    p = random_decoder_np(SPEC, 18)
    p["lin0"]["w"][SPEC.code_length:] /= RADIUS
    p["lin4"]["w"][-3:] /= RADIUS
    params = params_from_jax(p, "cpu")
    pts = torch.as_tensor(mesher.create_voxel_grid(16)) * RADIUS
    x = torch.cat([torch.zeros(pts.shape[0], SPEC.code_length), pts], -1)
    h = torch.atanh(decoder_apply(params, SPEC, x)[:, 0].clamp(-0.999999, 0.999999))
    s = 0.02 / float(h.std())
    p["lin8"]["w"] = (p["lin8"]["w"] * s).astype(np.float32)
    p["lin8"]["b"] = ((p["lin8"]["b"] - float(h.median())) * s).astype(np.float32)
    path = tmp_path_factory.mktemp("berry_decoder") / "latest.npz"
    np.savez(path, **{f"{k}.{w}": v[w] for k, v in p.items() for w in ("w", "b")})
    dec = R.Decoder(str(path), SPEC.dims, SPEC.latent_in, SPEC.clamping_distance, "cpu")
    return params_from_jax(p, "cpu"), dec


@pytest.fixture(scope="module")
def batch():
    """Observations of 3 synthetic berries (radius 0.03 m), their pose inits
    (the true pose, centre offset by N(0, 3 mm)) and start codes."""
    cat = SyntheticCategory(spec=SPEC, base_radius=0.03)
    rng = np.random.default_rng(7)
    obs, T0 = [], []
    for k in range(3):
        code = (rng.normal(size=SPEC.code_length) * 0.3).astype(np.float32)
        T_wo = np.eye(4, dtype=np.float32)
        T_wo[:3, 3] = rng.normal(size=3) * 0.1
        o, _ = make_scene(cat, code, T_wo, n_frames=CFG.n_frame, n_fg=CFG.n_fg_pix,
                          n_bg=CFG.n_bg_pix, n_points=CFG.recon_n_pts, seed=100 + k)
        obs.append(o)
        T_wo[:3, 3] += rng.normal(size=3) * 0.003
        T0.append(np.linalg.inv(T_wo))
    lat0 = torch.as_tensor(rng.normal(size=(3, SPEC.code_length)) * 0.1, dtype=torch.float32)
    return stack_observations(obs, "cpu"), lat0, torch.as_tensor(np.stack(T0), dtype=torch.float32)


def _pose_gap(A, B):
    """Per lane, the 3 x 4 block's norm of A - B, translation in cube radii."""
    d = (A.double() - B.double())[:, :3, :].clone()
    d[:, :, 3] /= RADIUS
    return torch.linalg.norm(d.reshape(d.shape[0], -1), dim=-1)


@pytest.mark.parametrize("steps", [0, 2], ids=["start", "third_iterate"])
def test_lm_step_matches_the_reference(decoder, batch, steps):
    """One LM iteration of the port from the same iterate as the
    reference's step: the code and the pose it reaches, per lane, over the
    length of the reference's step. Tolerance 1e-4 of the step: both are f32
    (the port's plain routes, the reference's plain decoder) and differ only
    by the order of their sums, which moves the step by ~1e-7-1e-6 of its
    length here; a bf16 render or SDF term moves it by 1-15 %, normal
    equations rounded to bf16 by 0.1-0.5 %."""
    params, dec = decoder
    obs, lat0, T0 = batch
    state = init_state(lat0, T0)
    for _ in range(steps):
        state = lm.lm_iteration(params, SPEC, CFG, obs, state, RADIUS, pose_known=False)
    assert not bool(state.failed.any())
    new = lm.lm_iteration(params, SPEC, CFG, obs, state, RADIUS, pose_known=False)
    view = R.views(list(obs), dataclasses.asdict(CFG))[0]

    def gaps(prec):
        lat_r, T_r, _ = R.lm_step(dec, view, state.latent, state.T_ow, state.i, RADIUS, prec)
        code = torch.linalg.norm((new.latent - lat_r).double(), dim=-1)
        code_len = torch.linalg.norm((lat_r - state.latent).double(), dim=-1)
        pose = _pose_gap(new.T_ow, T_r)
        pose_len = _pose_gap(T_r, state.T_ow)
        return code / code_len, pose / pose_len

    code, pose = gaps(F32)
    assert float(code.max()) < 1e-4 and float(pose.max()) < 1e-4, (code, pose)
    for part in ("render", "sdf", "algebra"):
        code, pose = gaps(dict(F32, **{part: "bf16"}))
        assert float(torch.maximum(code, pose).max()) > 1e-4, (part, code, pose)


def test_render_residuals_match_the_reference(decoder, batch):
    """The render term alone with occlusion off at the 5 mm cutoff: depth
    and mask residuals and their [pose | code] Jacobians over every ray of
    the frames that pass the in-radius gate. Tolerances: residuals 1e-6 m /
    1e-6 and Jacobians 1e-5 of their largest entry, room for the f32
    order-of-sum noise of a cumulative product over 15 samples (here the
    residuals agree exactly and the Jacobians to 1e-7); bf16 operands move
    the residuals by 1e-2 and the Jacobians by 14-18 %."""
    params, dec = decoder
    obs, lat0, T0 = batch
    is_fg, ray_mask, T_oc, depths, rng = lm._render_inputs(CFG, RADIUS, obs.T_wc, obs.ray_valid,
                                                           obs.frame_valid, T0)
    rcfg = lm._render_config(CFG, SPEC)
    assert not rcfg.occlusion_on and rcfg.occ_cutoff == 0.005 and rcfg.log_occ_on
    got = lm.render_residuals(params, SPEC, lat0, obs.rays, is_fg, ray_mask, obs.depth_obs, T_oc,
                              depths, rng, rcfg)
    pts = sample_points(obs.rays, depths, T_oc)
    kw = dict(pose_dim=CFG.pose_dim, log_occ_on=True, occ_cutoff=0.005, occlusion_on=False,
              occlusion_th=0.03, min_grad_th=1e-6)

    def gaps(prec):
        rr = R.render_rays(dec, lat0, pts, obs.depth_obs, is_fg, ray_mask, depths, rng, kw, prec)
        ok = (rr.count.sum(-1) >= 100)[..., None]
        assert torch.equal(ok[..., 0], got.frame_ok)
        g = ok.float()
        jd, jm = rr.jac_d * g[..., None], rr.jac_m * g[..., None]
        return (float((got.res_d - rr.res_d * g).abs().max()),
                float((got.res_m - rr.res_m * g).abs().max()),
                float((got.jac_d - jd).abs().max() / jd.abs().max()),
                float((got.jac_m - jm).abs().max() / jm.abs().max()),
                bool(torch.equal(got.ray_ok, rr.ray_ok & ok)))

    tol = (1e-6, 1e-6, 1e-5, 1e-5)
    assert bool(got.frame_ok.any()) and bool(got.ray_ok.any())
    *g, ray_ok = gaps("f32")
    assert ray_ok and all(a < t for a, t in zip(g, tol)), g
    *g, _ = gaps("bf16")
    assert any(a > t for a, t in zip(g, tol)), g


@pytest.mark.parametrize("chunk", [2, 1], ids=["3_chunks", "5_chunks"])
def test_chunked_grid_decode(decoder, monkeypatch, chunk):
    """5 codes decoded `chunk` at a time (the 80^3 grid's 6-code chunks, cut
    to size) against one chunk, bit for bit, and against the reference's
    grid. Tolerance: half a float16 step of the value (the grids cross to
    the host as f16), |sdf| 2^-11, plus 1e-6 for the f32 order of sums and
    f16's subnormal steps; the port reaches 0.87-0.94 of it, a grid of bf16
    operands 600-1100 times it at nearly every point."""
    params, dec = decoder
    d = 16
    one = MeshExtractor(params, SPEC, voxels_dim=d, cube_radius=RADIUS, device="cpu")
    monkeypatch.setattr(mesher, "ACTIVATION_BUDGET", chunk * d**3 * max(SPEC.dims) * 4)
    cut = MeshExtractor(params, SPEC, voxels_dim=d, cube_radius=RADIUS, device="cpu")
    assert one.decode_chunk >= 5 and cut.decode_chunk == chunk
    lat = torch.as_tensor(np.random.default_rng(3).normal(size=(5, SPEC.code_length)) * 0.3,
                          dtype=torch.float32)
    got = cut.decode_grids(lat)
    assert got.dtype == torch.float16 and torch.equal(got, one.decode_grids(lat))
    pts = R.voxel_points(d, RADIUS, "cpu")
    assert torch.equal(pts, cut.voxel_points)
    crossed = 0
    for k in range(5):
        ref = R.grid_sdf(dec, lat[k], pts)
        crossed += int((ref > 0).any() and (ref < 0).any())
        tol = ref.abs() * 2.0**-11 + 1e-6
        assert bool(((got[k].float() - ref).abs() <= tol).all())
        low = R.grid_sdf(dec, lat[k], pts, "bf16")
        assert not bool(((got[k].float() - low).abs() <= tol).all())
    assert crossed == 5


def _grids(params, d, n, seed=4):
    m = MeshExtractor(params, SPEC, voxels_dim=d, cube_radius=RADIUS, device="cpu")
    lat = torch.as_tensor(np.random.default_rng(seed).normal(size=(n, SPEC.code_length)) * 0.3,
                          dtype=torch.float32)
    return m, m.decode_grids(lat)


def test_threaded_meshing_equals_serial(decoder, monkeypatch):
    """At d = 64 and 6 fruits, on a process allowed 6 CPUs,
    `meshes_from_grids` meshes on 6 threads; its meshes are the serial
    ones, vertex for vertex and face for face."""
    monkeypatch.setattr(os, "sched_getaffinity", lambda pid: set(range(6)))
    m, grids = _grids(decoder[0], 64, 6)
    got = m.meshes_from_grids(grids)
    want = [m._grid_to_mesh(g) for g in grids.cpu().numpy().reshape(-1, 64, 64, 64)]
    assert len(got) == 6 and sum(w.faces.shape[0] > 0 for w in want) == 6
    for a, b in zip(got, want):
        assert np.array_equal(a.vertices, b.vertices) and np.array_equal(a.faces, b.faces)


@pytest.mark.parametrize("d,n,threads", [(16, 5, 1), (64, 4, 1), (64, 6, 6)])
def test_meshing_spans(decoder, monkeypatch, d, n, threads):
    """While tracing is on: `mesh.decode` with the codes, the grid's points
    and the chunks, `mesh.host` with its threads (on a process allowed
    `threads` CPUs, n >= threads: that many), and `mesh.readback` inside
    it; while it is off, nothing is recorded."""
    monkeypatch.setattr(os, "sched_getaffinity", lambda pid: set(range(threads)))
    params = decoder[0]
    trace.force(True)
    try:
        m, grids = _grids(params, d, n)
        m.meshes_from_grids(grids)
        spans = trace.spans()
    finally:
        trace.force(None)
    by = {s.name: [t for t in spans if t.name == s.name] for s in spans}
    assert sorted(by) == ["mesh.decode", "mesh.host", "mesh.readback"]
    (dec,), (host,), (rb,) = by["mesh.decode"], by["mesh.host"], by["mesh.readback"]
    assert dec.attrs == {"codes": n, "points": d**3, "chunks": -(-n // m.decode_chunk)}
    assert host.attrs == {"fruits": n, "threads": threads}
    assert rb.parent == host.sid and host.t0 <= rb.t0 <= rb.t1 <= host.t1
    assert dec.t1 <= host.t0

    trace.force(False)
    try:
        before = len(trace.spans())
        m.meshes_from_grids(m.decode_grids(torch.zeros(2, SPEC.code_length)))
        assert len(trace.spans()) == before
    finally:
        trace.force(None)
