"""The check decides `correct`: a sound run of a cell passes it, and a run
with its timed path broken underneath, or with the control (the reference
one precision down in the program's place), does not. Each runs a whole
cell without looking for a chip, at a size a test run holds: 4 frames of
64 + 64 rays and 30 samples, 96 surface points, 264 codes, a 16^3 grid,
batches of 4, in f32 throughout (so the configuration states f32 and the
control computes in bf16)."""

import numpy as np
import pytest
import torch

from conftest import ROOT
from lib import control
from lib.harness import run_cell

F32 = {"retrieval": "f32", "render": "f32", "sdf": "f32", "algebra": "f32", "grid": "f32"}


def tiny(cell: str) -> dict:
    solver = {"n_frame": 4, "n_fg_pix": 64, "n_bg_pix": 64, "n_sample_on_ray": 30,
              "recon_n_pts": 96, "retrieval_score_pts": 16, "fused_bf16": False,
              "retrieval_score_bf16": False}
    if "cka" in cell:
        solver["max_iter"] = 4
    return {"config": {"solver": solver, "latent_table": {"codes": 264}, "precision": F32,
                       "meshing": {"voxels": 16, "grid_bf16": False}, "serving": {"max_batch": 4}},
            "workload": {"params": {"pool": 8, "batch": 4, "in_flight": 8, "rate_per_s": 4.0},
                         "pool_workers": 1,
                         "check": {"cd_samples": 2000, "steps": 64, "residual_steps": 8,
                                   "final_steps": 8, "meshes": 4, "retrieval_fruits": 4,
                                   "grid_batches": 2}}}


def run(cell, before=None, seconds=2.0, seed=3000000007):
    res, lines, _ = run_cell(ROOT, cell, seed, seconds, False, require_cuda=False,
                             overrides=tiny(cell), before=before)
    return res


def patch(owner, name, make):
    orig = getattr(owner, name)
    setattr(owner, name, make(orig))
    return lambda: setattr(owner, name, orig)


def state_unchanged(lanes, parts=("latent", "T_ow")):
    """The LM step of `lanes` (a slice) returns the `parts` of its input
    iterate unchanged."""
    def before(ctx):
        from hortimapping_tpu_torch.optim import lm

        def make(orig):
            def f(params, spec, cfg, obs, state, *a, **k):
                new = orig(params, spec, cfg, obs, state, *a, **k)
                out = {}
                for part in parts:
                    x = getattr(new, part).clone()
                    x[lanes] = getattr(state, part)[lanes]
                    out[part] = x
                return new._replace(**out)
            return f
        return patch(lm, "lm_iteration", make)
    return before


def answer_altered(ctx):
    """The served answer's code replaced by another code of the table where
    the result is packed."""
    from hortimapping_tpu_torch.optim import lm

    def make(orig):
        def f(res):
            return orig(res._replace(latent=res.latent + 0.25))
        return f
    return patch(lm, "pack_result", make)


def batch_answer_altered(ctx):
    from hortimapping_tpu_torch.optim import warmstart

    def make(orig):
        def f(*a, **k):
            res = orig(*a, **k)
            return res._replace(latent=res.latent + 0.25)
        return f
    return patch(warmstart, "warmstart_solve", make)


def lowered(ctx):
    undo = control.install(ctx.reference, control.lowered(ctx.config["precision"]),
                           trust_region=ctx.config["solver"]["trust_region"])
    return lambda: control.uninstall(undo)


@pytest.mark.parametrize("cell", ["sweetpepper_bup20.serve_saturated", "sweetpepper_cka.batch32"])
def test_a_sound_run_is_correct(cell):
    res = run(cell)
    assert res["correct"], res["check"]
    assert res["attempted"] > 0 and res["failed"] == 0


@pytest.mark.parametrize("fault", [
    pytest.param(("sweetpepper_bup20.serve_saturated", state_unchanged(slice(None))), id="state_unchanged"),
    pytest.param(("sweetpepper_bup20.serve_saturated", state_unchanged(slice(2, None))), id="half_the_batch"),
    pytest.param(("sweetpepper_bup20.serve_saturated", state_unchanged(slice(3, 4))), id="one_lane"),
    pytest.param(("sweetpepper_bup20.serve_saturated", state_unchanged(slice(None), ("T_ow",))),
                 id="pose_unchanged"),
    pytest.param(("sweetpepper_bup20.serve_saturated", answer_altered), id="answer_altered"),
    pytest.param(("sweetpepper_cka.batch32", state_unchanged(slice(None))), id="batch_state_unchanged"),
    pytest.param(("sweetpepper_cka.batch32", state_unchanged(slice(3, 4))), id="batch_one_lane"),
    pytest.param(("sweetpepper_cka.batch32", state_unchanged(slice(None), ("T_ow",))),
                 id="batch_pose_unchanged"),
    pytest.param(("sweetpepper_cka.batch32", batch_answer_altered), id="batch_answer_altered"),
])
def test_a_broken_path_is_not_correct(fault):
    cell, before = fault
    res = run(cell, before)
    assert not res["correct"], res["check"]


@pytest.mark.parametrize("cell", ["sweetpepper_bup20.serve_saturated", "sweetpepper_cka.batch32"])
def test_the_control_is_not_correct(cell):
    res = run(cell, lowered)
    failing = [k for k, v in res["check"].items() if not v["value"] <= v["limit"]]
    assert failing and not res["correct"], res["check"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["sweetpepper_bup20.serve_saturated", "sweetpepper_cka.batch32"])
def test_the_control_is_not_correct_on_the_card(card, cell):
    res = run(cell, lowered)
    assert not res["correct"], res["check"]
