"""The window's job boundary, rates and tail, the idle share on a
synthetic trace, and the result line's shape."""

import json
import types

import pytest

import run as runner
from benchlib import readers, trace, window
from benchlib.cell import metric_reader
from jobs import align_chunks, map_pairs


def test_window_ends_at_the_first_boundary_after_its_length(monkeypatch):
    clock = [0.0]
    monkeypatch.setattr(window.time, "monotonic", lambda: clock[0])
    walls = [3.0, 4.0, 2.5, 5.0]

    def run_job(job, k):
        clock[0] += walls[k % len(walls)]
        return {"job": job, "k": k}

    done, length = window.run_window(["a", "b"], 9.0, run_job)
    # 3, 7, 9.5: the job that crosses 9 s ends the window, not the one
    # before it
    assert [d["job"] for d in done] == ["a", "b", "a"]
    assert length == pytest.approx(9.5)


def test_window_goes_round_the_jobs_again(monkeypatch):
    clock = [0.0]
    monkeypatch.setattr(window.time, "monotonic", lambda: clock[0])

    def run_job(job, k):
        clock[0] += 1.0
        return job

    done, _ = window.run_window(["a", "b", "c"], 4.5, run_job)
    assert done == ["a", "b", "c", "a", "b"]


@pytest.mark.parametrize("values,want", [
    ([1.0], 1.0), ([3.0, 1.0, 2.0], 3.0),
    (list(range(1, 21)), 19), (list(range(1, 101)), 95),
    (list(range(1, 41)), 38)])
def test_p95_nearest_rank(values, want):
    assert window.p95(values) == want


def test_rates_take_all_work_over_the_whole_window():
    ctx = types.SimpleNamespace(window_s=10.0, jobs_done=[
        {"bp": 2_000_000, "wall": 3.0}, {"bp": 1_000_000, "wall": 2.0},
        {"bp": 3_000_000, "wall": 6.0}])
    got = align_chunks.end_to_end(ctx)
    assert got["aligned_mbps"] == pytest.approx(0.6)
    assert got["align_chunk_p95_s"] == 6.0
    assert map_pairs.end_to_end(ctx)["mapped_mbps"] == pytest.approx(0.6)


def test_per_layer_window_readers_give_the_end_to_end_numbers():
    ctx = types.SimpleNamespace(window_s=10.0, jobs_done=[
        {"bp": 2_000_000, "wall": 3.0}, {"bp": 1_000_000, "wall": 2.0},
        {"bp": 3_000_000, "wall": 6.0}])
    want = align_chunks.end_to_end(ctx)
    for name in ("aligned_mbps", "align_chunk_p95_s"):
        assert metric_reader(f"window.{name}")(ctx) == want[name]
    assert metric_reader("window.aligned_mbps")(
        types.SimpleNamespace(window_s=10.0, jobs_done=[])) is None


def test_idle_share_and_gaps_on_a_synthetic_trace():
    tr = {"window": (0.0, 10.0),
          "device": [("seg_wfa_kernel", 1.0, 2.0),
                     ("seg_wfa_kernel", 1.5, 2.5),     # overlaps: once
                     ("Memcpy HtoD", 6.0, 6.5),
                     ("late", 9.5, 11.0)],              # clipped at 10
          "spans": [("job:align_chunks", 0.0, 5.0),
                    ("align.engine_batch", 0.5, 3.0),
                    ("job:align_chunks", 5.0, 10.0)]}
    s = trace.summarize(tr)
    assert s["busy_s"] == pytest.approx(1.5 + 0.5 + 0.5)
    ctx = types.SimpleNamespace(trace=s)
    assert readers.idle_pct(ctx) == pytest.approx(75.0)
    ops = dict(s["breakdown"]["device_ops"])
    assert ops["seg_wfa_kernel"] == pytest.approx(2.0)
    assert ops["late"] == pytest.approx(0.5)
    idle = dict(s["breakdown"]["idle_gaps"])
    # 0-1 and 2.5-3 lie in the engine's span's... 0-1's middle (0.5) is
    # its start; 2.5-6's middle (4.25) is in the first job only
    assert idle["align.engine_batch"] == pytest.approx(1.0)
    assert idle["job:align_chunks"] == pytest.approx(3.5 + 3.0)
    assert readers.device_ms(ctx, "seg_wfa") == pytest.approx(2000.0)


def test_idle_share_is_not_read_without_device_events():
    ctx = types.SimpleNamespace(trace=trace.summarize(
        {"window": (0.0, 1.0), "device": [], "spans": []}))
    assert readers.idle_pct(ctx) is None
    assert readers.device_ms(ctx, "seg_wfa") is None


def test_span_union_counts_nested_calls_once():
    sp = trace.Spans()
    sp.items = [("a", 0.0, 4.0), ("a", 1.0, 2.0), ("b", 3.0, 6.0),
                ("c", 0.0, 10.0)]
    ctx = types.SimpleNamespace(spans=sp)
    assert readers.span_union(ctx, ("a", "b")) == pytest.approx(6.0)


def test_result_line_shape():
    res = {"correct": True, "attempted": 3, "failed": 0,
           "metrics": {"aligned_mbps": {"value": 1.5, "unit": "Mbp/s"}},
           "breakdown": {"device_ops": [["k", 0.1]], "idle_gaps": []},
           "checks": [{"name": "bad_records", "value": 0, "limit": 0}]}
    device = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
              "count": 1, "memory_peak_bytes": 5}
    line = runner.result_line(res, device)
    obj = json.loads(line)
    assert list(obj) == ["correct", "attempted", "failed", "metrics",
                         "device", "breakdown", "checks"]
    assert obj["checks"] == {"bad_records": {"value": 0, "limit": 0}}
    assert "\n" not in line
