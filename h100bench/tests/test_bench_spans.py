"""The per-layer metrics that read the port's spans: each reader on a
fabricated run, and None where its counters are absent (a program
without the spans)."""

import types

import pytest

from benchlib.cell import metric_reader

# (metric, the counters it sums)
SPAN_METRICS = {
    "align.fetch_pct": ("align.loop.fetch_s",),
    "align.loop_self_pct": ("cli.main.self_s", "align.loop.self_s"),
    "align.engine_self_pct": ("align.engine.self_s",),
    "align.inversion_pct": ("align.inversion_s",),
    "map.index_build_pct": ("map.index_s",),
    "map.host_phases_pct": ("map.sketch_s", "map.l2_host_s", "map.pool_s"),
}


def _ctx(perfs, walls):
    return types.SimpleNamespace(
        window_s=sum(walls), trace=None, jobs_done=[
            {"wall": w, "bp": 1_000_000, "perf": p}
            for w, p in zip(walls, perfs)])


@pytest.mark.parametrize("name", sorted(SPAN_METRICS))
def test_reader_sums_its_counters_over_the_jobs_wall(name):
    keys = SPAN_METRICS[name]
    # job 1 holds every counter, job 2 the first only, with a stranger
    perfs = [{k: 0.5 for k in keys} | {"align.plan_s": 3.0},
             {keys[0]: 1.0, "other_s": 2.0}]
    got = metric_reader(name)(_ctx(perfs, [4.0, 6.0]))
    assert got == pytest.approx(100.0 * (0.5 * len(keys) + 1.0) / 10.0)


@pytest.mark.parametrize("name", sorted(SPAN_METRICS))
def test_reader_is_none_without_its_counters(name):
    read = metric_reader(name)
    assert read(_ctx([{"align.plan_s": 1.0}, {}], [2.0, 3.0])) is None
    assert read(_ctx([], [])) is None
    # a share of nothing
    assert read(_ctx([{k: 1.0 for k in SPAN_METRICS[name]}], [0.0])) is None
