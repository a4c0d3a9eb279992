"""The reader of `render.fwd_row_share` on hand-made device counters: the
forward's chain rows over the active lanes' samples, and nothing on a
program that counts neither (or records no counters at all)."""

import os

import pytest

from conftest import BENCH
from lib.harness import load_module
from test_bench_program_trace import ctx_of


def read(ctx):
    return load_module(os.path.join(BENCH, "metrics", "render.fwd_row_share.py"),
                       "t_metric_render_fwd_row_share").read(ctx)


def test_fwd_row_share_over_the_active_samples():
    counters = {"render.rows": 3 * 10 * 400 * 30, "render.fwd_rows": 154800,
                "render.band_rows": 900}
    assert read(ctx_of([], counters)) == pytest.approx(100.0 * 154800 / 360000)
    assert read(ctx_of([], {"render.rows": 200, "render.fwd_rows": 200})) == pytest.approx(100.0)
    # every sample out of radius: no chain row
    assert read(ctx_of([], {"render.rows": 200, "render.fwd_rows": 0})) == pytest.approx(0.0)


def test_fwd_row_share_is_none_without_the_counters():
    # a program that counts the band alone (the counters read 0)
    assert read(ctx_of([], {"render.band_rows": 900})) is None
    assert read(ctx_of([], {"render.rows": 0, "render.fwd_rows": 0})) is None
    # a program that records no counters at all
    ctx = ctx_of([])
    ctx.program_trace = None
    assert read(ctx) is None
