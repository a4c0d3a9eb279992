"""The reader of `lm.graph_share` on hand-made spans: the share of LM
iterations outside the rescue whose `graph` attribute is 1, the raise
where an iteration's flag read is missing, and nothing where no span
carries the attribute (a program that records it not)."""

import os

import pytest

from conftest import BENCH
from lib.harness import load_module
from test_bench_program_trace import _lm_spans, ctx_of


def read(ctx):
    return load_module(os.path.join(BENCH, "metrics", "lm.graph_share.py"),
                       "t_metric_lm_graph_share").read(ctx)


def _with_graph(flags):
    """`_lm_spans` with `graph` set on its iterations, in order (None: left
    out)."""
    it = iter(flags)
    out = []
    for s in _lm_spans():
        if s.name == "lm.iteration":
            g = next(it)
            if g is not None:
                s = s._replace(attrs=dict(s.attrs, graph=g))
        out.append(s)
    return out


def test_graph_share_over_iterations_outside_the_rescue():
    # the rescue's iteration (the third) is left out whatever it carries
    assert read(ctx_of(_with_graph([1, 1, 0]))) == pytest.approx(100.0)
    assert read(ctx_of(_with_graph([1, 0, 1]))) == pytest.approx(50.0)
    assert read(ctx_of(_with_graph([0, None, 1]))) == pytest.approx(0.0)


def test_graph_share_is_none_without_the_attribute():
    assert read(ctx_of(_lm_spans())) is None
    assert read(ctx_of(_with_graph([None, None, 1]))) is None
    assert read(ctx_of([], keys=())) is None


def test_graph_share_raises_without_a_flag_read():
    with pytest.raises(RuntimeError):
        read(ctx_of([s for s in _with_graph([1, 1, 1]) if s.sid != 4]))
