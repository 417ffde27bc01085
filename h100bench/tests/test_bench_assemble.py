"""align.assemble_pct, the stitching's share of the chunks' wall: the
reader on a fabricated run, and None where the span is absent (a program
without it)."""

import types

import pytest

from benchlib.cell import metric_reader

READ = "align.assemble_pct"


def _ctx(perfs, walls):
    return types.SimpleNamespace(
        window_s=sum(walls), trace=None, jobs_done=[
            {"wall": w, "bp": 1_000_000, "perf": p}
            for w, p in zip(walls, perfs)])


def test_reader_sums_the_span_over_the_jobs_wall():
    # job 1 holds the span and its counters, job 2 the span and a stranger
    perfs = [{"align.assemble_s": 0.5, "align.assemble.self_s": 0.4,
              "align.assemble.pieces": 900, "align.plan_s": 3.0},
             {"align.assemble_s": 1.0, "other_s": 2.0}]
    got = metric_reader(READ)(_ctx(perfs, [4.0, 6.0]))
    assert got == pytest.approx(100.0 * 1.5 / 10.0)


def test_reader_is_none_without_the_span():
    read = metric_reader(READ)
    assert read(_ctx([{"align.plan_s": 1.0}, {}], [2.0, 3.0])) is None
    assert read(_ctx([], [])) is None
    # a share of nothing
    assert read(_ctx([{"align.assemble_s": 1.0}], [0.0])) is None
