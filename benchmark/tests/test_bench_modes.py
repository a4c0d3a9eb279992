"""The check under the solver modes no cell runs yet, each read through the
overrides of the strawberry cell at `test_bench_strawberry.py`'s size: the
trust-region LM of the Shape Completion Challenge's configuration (from a
(code, scale) retrieval over 5 scales), the (code, scale) retrieval alone
(5 scales from 0.85 to 1.2, fixed lambda), and lab_berry.yaml's mean start.
In each a sound run is correct, and the control and a timed path broken
underneath are not; the faults that only one mode can have are planted
there. Beside them: the reference's step without a lambda is today's, and
the recorder counts the trust region's work an iteration."""

import dataclasses
import json
import math
import os

import numpy as np
import pytest
import torch

from conftest import BENCH, ROOT
from lib import check, scenes
from lib import reference as R
from lib.harness import merge, run_cell
from test_bench_check import lowered, patch, state_unchanged
from test_bench_strawberry import CELL, TINY

OVERRIDES = os.path.join(BENCH, "overrides")


def solver_of(name: str) -> dict:
    with open(os.path.join(OVERRIDES, name)) as f:
        return json.load(f)["config"]["solver"]


SCALES = {"retrieval_n_scales": 5, "retrieval_scale_min": 0.85, "retrieval_scale_max": 1.2}


def mode_overrides(mode: str, max_iter=None) -> dict:
    """TINY over the mode's solver block: the challenge's trust region (8
    iterations, so that some lanes roll back, or `max_iter`), the 5-scale
    retrieval on the cell's own solver, or lab_berry.yaml's mean start."""
    if mode == "trust_region":
        solver = dict(solver_of("challenge_solver.json"))
    elif mode == "scales":
        solver = dict(SCALES)
    else:
        solver = dict(solver_of("lab_berry_solver.json"))
    over = merge({"config": {"solver": solver}}, TINY)
    if mode == "trust_region":
        over["config"]["solver"]["max_iter"] = max_iter or 8
    return over


MODES = ["trust_region", "scales", "mean"]


def run(mode, before=None, seed=3000000013, max_iter=None):
    seen = {}

    def hook(ctx):
        seen["ctx"] = ctx
        return before(ctx) if before is not None else (lambda: None)

    res, _, _ = run_cell(ROOT, CELL, seed, 2.0, False, require_cuda=False,
                         overrides=mode_overrides(mode, max_iter), before=hook)
    return res, seen["ctx"]


def tr_state_unchanged(ctx):
    """Every lane of the trust region's iteration returns its input
    iterate."""
    from hortimapping_tpu_torch.optim import lm

    def make(orig):
        def f(params, spec, cfg, obs, ts, *a, **k):
            new = orig(params, spec, cfg, obs, ts, *a, **k)
            return new._replace(base=new.base._replace(latent=ts.base.latent.clone(),
                                                       T_ow=ts.base.T_ow.clone()))
        return f
    return patch(lm, "lm_iteration_tr", make)


@pytest.mark.parametrize("mode", MODES)
def test_a_sound_run_is_correct(mode):
    res, ctx = run(mode)
    assert res["correct"], res["check"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert all(math.isfinite(v["value"]) for v in res["check"].values()), res["check"]
    assert ("retrieval_gap" in res["check"]) == (mode != "mean")
    if mode == "trust_region":
        assert any(s.get("rolled_back") for s in ctx.check_steps), ctx.check_steps


@pytest.mark.parametrize("mode", MODES)
def test_the_control_is_not_correct(mode):
    res, _ = run(mode, lowered)
    failing = [k for k, v in res["check"].items() if not v["value"] <= v["limit"]]
    assert failing and not res["correct"], res["check"]


@pytest.mark.parametrize("mode", MODES)
def test_a_state_left_unchanged_is_not_correct(mode):
    before = tr_state_unchanged if mode == "trust_region" else state_unchanged(slice(None))
    res, _ = run(mode, before)
    assert not res["correct"], res["check"]


def test_a_step_at_ten_times_the_lambda_is_not_correct():
    """The trust region damps its step by ten times the lambda it keeps; a
    roll-back is among the steps compared (at the challenge's own 20
    iterations: at 8, ten times the damping leaves no step to roll back)."""
    from hortimapping_tpu_torch.optim import lm

    def before(ctx):
        def make(orig):
            def f(H, cfg, lam=None):
                return orig(H, cfg, lam * 10.0 if isinstance(lam, torch.Tensor) else lam)
            return f
        return patch(lm, "apply_lm_damping", make)

    res, ctx = run("trust_region", before, max_iter=20)
    assert not res["correct"], res["check"]
    assert any(s.get("rolled_back") for s in ctx.check_steps if s["kind"] in ("step", "watch"))


def test_retrieval_at_the_grids_first_scale_exceeds_the_limit():
    """Retrieval returns the best code at the grid's first scale, with that
    scale, in place of the best (code, scale) of the grid."""
    from hortimapping_tpu_torch.optim import warmstart

    def before(ctx):
        def make(orig):
            def f(*a, **k):
                return orig(*a, **dict(k, n_scales=1, scale_max=k["scale_min"]))
            return f
        return patch(warmstart, "retrieval_init_batched", make)

    res, _ = run("scales", before)
    gap = res["check"]["retrieval_gap"]
    assert gap["value"] > gap["limit"], res["check"]
    assert not res["correct"]


def test_a_skipped_retrieval_reads_inf():
    """Under `init_mode: retrieval` a solve that starts from the table mean
    without retrieving records no start: the gap reads inf."""
    from hortimapping_tpu_torch.optim import warmstart

    def before(ctx):
        def make(orig):
            def f(params, spec, cfg, latent_table, obs, T_init, top_k=None, packs=None):
                B, K = T_init.shape[0], cfg.retrieval_top_k if top_k is None else top_k
                lat = latent_table.mean(0)[None].expand(B, -1)
                return (lat, T_init, lat[:, None].expand(B, K, -1),
                        T_init[:, None].expand(B, K, 4, 4))
            return f
        return patch(warmstart, "_retrieve", make)

    res, _ = run("scales", before)
    assert res["check"]["retrieval_gap"]["value"] == float("inf"), res["check"]
    assert not res["correct"]


def test_the_trust_region_wrapper_counts_every_iterations_work():
    """With the recorder's work counted, each call of the trust region's
    iteration in the window adds one render and one SDF entry, at the
    configured samples a ray, and counts as an LM iteration."""
    from hortimapping_tpu_torch.optim import lm

    calls = []

    def before(ctx):
        ctx.rec.traced = True

        def make(orig):
            def f(params, spec, cfg, obs, ts, *a, **k):
                if ctx.rec.on:
                    calls.append(cfg.n_sample_on_ray)
                return orig(params, spec, cfg, obs, ts, *a, **k)
            return f
        return patch(lm, "lm_iteration_tr", make)

    res, ctx = run("trust_region", before)
    assert res["correct"], res["check"]
    work = ctx.rec.work
    assert calls and len(work["render"]) == len(work["sdf"]) == len(calls)
    assert [m for _, m in work["render"]] == calls
    assert sum(b.n_iters for b in ctx.rec.batches) == len(calls)


def _view_and_lanes(solver: dict):
    """A small view of two synthetic berries and their lanes (codes near the
    table's, the true poses, iterations on both sides of `robust_iter`)."""
    with open(os.path.join(BENCH, "configs", "strawberry_lab.json")) as f:
        cfg = json.load(f)
    sc = dict(cfg["scene"], n_frames=2, n_fg=16, n_bg=8, n_points=32)
    pool = scenes.build_pool(sc, cfg["decoder"]["code_length"], 2, 7, workers=1)
    dev = torch.device("cpu")
    dec = R.load_decoder(ROOT, cfg["decoder"], dev)
    obs = check._obs_batch(pool, [0, 1], dev)
    solver = dict(cfg["solver"], **solver, n_frame=2, n_fg_pix=16, n_bg_pix=8,
                  n_sample_on_ray=10, recon_n_pts=32)
    v = R.views(obs, solver)[0]
    g = torch.Generator().manual_seed(5)
    lat = 0.1 * torch.randn(2, cfg["decoder"]["code_length"], generator=g)
    T = torch.linalg.inv(torch.as_tensor(np.stack([p.T_wo for p in pool[:2]]),
                                         dtype=torch.float64)).float()
    i = torch.tensor([0, solver["robust_iter"] + 1])
    return dec, v, lat, T, i, float(cfg["meshing"]["cube_radius_m"])


@pytest.mark.parametrize("lm_eye", [False, True])
def test_the_reference_step_without_a_lambda_is_todays(lm_eye):
    """Without a lambda the normal equations are damped as before the
    per-lane lambda existed (the fixed lambda_0 on the undamped H), bit for
    bit, and so is the step; a lambda a lane equal to lambda_0 gives the
    same bits."""
    dec, v, lat, T, i, cube = _view_and_lanes({"lm_lambda_0": 0.1, "lm_eye": lm_eye,
                                               "robust_iter": 1})
    F32 = check.F32
    lam0 = v.cfg["lm_lambda_0"]
    off = R.normal_equations(dec, v._replace(cfg=dict(v.cfg, lm_on=False)), lat, T, i, cube, F32)
    diag = torch.diagonal(off.H, dim1=-2, dim2=-1)
    if lm_eye:
        H = off.H + lam0 * diag.max(-1).values[:, None, None] * torch.eye(off.H.shape[-1])
    else:
        H = off.H + lam0 * torch.diag_embed(diag)
    t = R.normal_equations(dec, v, lat, T, i, cube, F32)
    assert torch.equal(t.H, H) and torch.equal(t.b, off.b)
    lam = torch.full((2,), lam0)
    assert torch.equal(R.normal_equations(dec, v, lat, T, i, cube, F32, lam).H, t.H)
    a = R.lm_step(dec, v, lat, T, i, cube, F32)
    b = R.lm_step(dec, v, lat, T, i, cube, F32, lam)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(a[0], lat)
    # another lambda moves the step
    c = R.lm_step(dec, v, lat, T, i, cube, F32, lam * 10.0)
    assert not torch.equal(a[0], c[0])


@pytest.mark.parametrize("name, yaml", [("challenge_solver.json",
                                         "shape_completion_challenge_pepper_tpu.yaml"),
                                        ("lab_berry_solver.json", "lab_berry.yaml")])
def test_the_override_files_are_their_yamls(name, yaml):
    from hortimapping_tpu_torch.config import JointOptConfig, load_config

    cfg = JointOptConfig.from_dict(load_config(os.path.join(ROOT, "configs", yaml)))
    assert solver_of(name) == dataclasses.asdict(cfg)
