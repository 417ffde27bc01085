"""The port's spans (wfmash_tpu_torch/utils/perf.py): the self-time
arithmetic on a fake clock, the profiler ranges they open only while
torch's profiler runs, the records kept only while a recorder is
attached, and the counters a small `-i` run and a small `-m` run fill
for every span of their paths. Tolerance: exact, except where a counter
sums the same seconds in another order (relative 1e-9)."""

import io
import os
import re
import subprocess
import sys
import threading
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest
import torch

from wfmash_tpu_torch import cli
from wfmash_tpu_torch.utils import perf

from util import mutate, random_dna, write_fasta

REPO = Path(__file__).resolve().parents[1]

ALIGN_SPANS = {
    "cli.main", "map.identity", "align.loop", "align.loop.parse",
    "align.loop.fetch", "align.loop.write", "align.engine", "align.plan",
    "align.seg_solve", "align.exact", "align.device_wait",
    "align.escalate", "align.inversion", "align.assemble",
    "align.device", "align.tier.pack", "align.tier.launch",
    "align.tier.collect", "align.patch"}
MAP_SPANS = {
    "cli.main", "map.index", "map.index.fetch", "map.index.winnow",
    "map.index.table", "map.index.upload", "map.queries", "map.pool",
    "map.sketch", "map.l1", "map.l1.device", "map.l2", "map.l2.device",
    "map.l2_host", "map.write"}


@pytest.fixture
def clock(monkeypatch):
    """time.monotonic_ns as a clock the test sets."""
    now = [0]
    monkeypatch.setattr(perf.time, "monotonic_ns", lambda: now[0])
    perf.reset()
    return now


def _s(key):
    return round(perf.get(key) * 1e9)


def test_self_time_is_the_duration_less_the_union_of_children(clock):
    with perf.span("outer") as outer:
        clock[0] = 10
        with perf.span("a"):
            clock[0] = 15
            with perf.span("a.leaf"):
                clock[0] = 25
            clock[0] = 30
        # b overlaps a on another thread: the union counts once
        started, release = threading.Event(), threading.Event()

        def other():
            with perf.span("b", parent=outer):
                started.set()
                release.wait()

        clock[0] = 20
        th = threading.Thread(target=other)
        th.start()
        started.wait()
        clock[0] = 50
        release.set()
        th.join()
        clock[0] = 100
    assert (_s("outer_s"), _s("outer.self_s")) == (100, 60)
    assert (_s("a_s"), _s("a.self_s")) == (20, 10)
    assert (_s("a.leaf_s"), _s("a.leaf.self_s")) == (10, 10)
    assert (_s("b_s"), _s("b.self_s")) == (30, 30)
    assert perf._stack() == []


def test_adopted_and_overhanging_children(clock):
    """A thread's spans nest under the span it adopts; a child still
    running when its parent closes is clipped to the parent."""
    records = None
    with perf.recording() as records:
        with perf.span("eng") as eng:
            opened, release = threading.Event(), threading.Event()

            def device_thread():
                with perf.adopt(eng):
                    clock[0] = 5
                    with perf.span("dev"):
                        clock[0] = 8
                        with perf.span("dev.pack"):
                            clock[0] = 9
                    with perf.span("late"):
                        opened.set()
                        release.wait()
                        clock[0] = 70

            th = threading.Thread(target=device_thread)
            th.start()
            opened.wait()
            clock[0] = 40
        release.set()
        th.join()
    assert (_s("eng_s"), _s("eng.self_s")) == (40, 36)
    assert (_s("dev_s"), _s("dev.self_s")) == (4, 3)
    assert (_s("late_s"), _s("late.self_s")) == (61, 61)
    by = {r["name"]: r for r in records}
    assert by["dev"]["parent"] == by["eng"]["id"]
    assert by["dev.pack"]["parent"] == by["dev"]["id"]
    assert {r["call"] for r in records} == {by["eng"]["id"]}
    assert by["dev"]["thread"] != by["eng"]["thread"]
    assert by["late"]["end"] - by["late"]["start"] == 61


def test_records_are_kept_only_while_a_recorder_is_attached(clock):
    with perf.span("before"):
        pass
    with perf.recording() as records:
        with perf.span("during"):
            clock[0] = 3
    with perf.span("after"):
        pass
    assert [r["name"] for r in records] == ["during"]
    assert records[0]["start"] == 0 and records[0]["end"] == 3
    assert perf._recorders == []


def test_record_function_only_while_the_profiler_runs(monkeypatch):
    import torch.autograd.profiler as ap

    entered = []
    real = ap.record_function

    def counted(name, *a, **kw):
        entered.append(name)
        return real(name, *a, **kw)

    monkeypatch.setattr(ap, "record_function", counted)
    with perf.span("quiet"):
        with perf.span("quiet.inner"):
            pass
    assert entered == []
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]):
        with perf.span("loud"):
            pass
    assert entered == ["loud"]


def test_spans_are_user_annotations_in_a_cpu_profile():
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with perf.span("trace.outer"):
            with perf.span("trace.inner"):
                torch.ones(8).sum()
    names = {ev.name() for ev in prof.profiler.kineto_results.events()
             if ev.is_user_annotation()}
    assert {"trace.outer", "trace.inner"} <= names


def _check_spans(snap, spans):
    for name in spans:
        assert f"{name}_s" in snap, name
        assert f"{name}.self_s" in snap, name
        assert 0 <= snap[f"{name}.self_s"] <= snap[f"{name}_s"], name


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """A 14 kb target; a query with SNPs and an insertion, and a second
    one of 5 kb (two queries: `-t 2` forks); the mapping PAF from the
    port's own `-m` run."""
    d = tmp_path_factory.mktemp("trace")
    rng = np.random.default_rng(11)
    t = random_dna(rng, 14_000)
    q = (mutate(rng, t[:8_000], 0.01) + random_dna(rng, 40)
         + mutate(rng, t[8_000:], 0.02))
    write_fasta(d / "t.fa", {"t1": t})
    write_fasta(d / "q.fa", {"q1": q,
                             "q2": mutate(rng, t[3_000:8_000], 0.02)})
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("WFMASH_TPU_TORCH_DEVICE", "cpu")
        mp.setenv("WFMASH_TPU_DEVICE_L1", "0")
        buf = io.StringIO()
        with redirect_stdout(buf):
            assert cli.main([str(d / "t.fa"), str(d / "q.fa"), "-m"]) == 0
    (d / "m.paf").write_text(buf.getvalue())
    assert buf.getvalue().count("\n") >= 1
    return d


def _align(pair, monkeypatch):
    for k in list(os.environ):
        if k.startswith("WFMASH_TPU_"):
            monkeypatch.delenv(k)
    monkeypatch.setenv("WFMASH_TPU_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("WFMASH_TPU_SEGMENTED", "1")
    perf.reset()
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert cli.main([str(pair / "t.fa"), str(pair / "q.fa"),
                         "-i", str(pair / "m.paf")]) == 0
    return buf.getvalue(), perf.snapshot()


def test_align_run_fills_every_span_and_records_change_nothing(
        pair, monkeypatch):
    plain, _ = _align(pair, monkeypatch)
    with perf.recording() as records:
        paf, snap = _align(pair, monkeypatch)
    assert paf == plain and "\tcg:Z:" in paf
    _check_spans(snap, ALIGN_SPANS)
    # the counters the metrics read are their spans' totals
    for name in ("align.plan", "align.device", "align.seg_solve"):
        total = sum(r["end"] - r["start"] for r in records
                    if r["name"] == name)
        assert snap[f"{name}_s"] == pytest.approx(total / 1e9, rel=1e-9)
    assert snap["align.device_calls"] >= 1
    # one call: every record carries the root's id; the solver's spans on
    # the device-phase thread are children of an align.engine span
    root = [r for r in records if r["name"] == "cli.main"]
    assert len(root) == 1
    assert {r["call"] for r in records} == {root[0]["id"]}
    by_id = {r["id"]: r for r in records}

    def ancestors(r):
        while r["parent"] is not None:
            r = by_id[r["parent"]]
            yield r["name"]

    engine_threads = {r["thread"] for r in records
                      if r["name"] == "align.engine"}
    device = [r for r in records if r["name"] == "align.device"]
    assert device and all("align.engine" in ancestors(r) for r in device)
    assert any(r["thread"] not in engine_threads for r in device)
    # no span is left open on this thread
    assert perf._stack() == []


def test_align_run_counts_the_pieces_it_stitches(pair, monkeypatch,
                                                capsys):
    """align.assemble.pieces and align.assemble.ops are the pieces of
    every block the engine stitched and the ops it gave them, and the
    WFMASH_TPU_PERF dump prints both."""
    from wfmash_tpu_torch.align import cigar

    stitched = []
    stitch = cigar.stitch_pieces

    def spy(pieces):
        ops = stitch(pieces)
        stitched.append((len(pieces), len(ops)))
        return ops

    monkeypatch.setattr(cigar, "stitch_pieces", spy)
    paf, snap = _align(pair, monkeypatch)
    assert "\tcg:Z:" in paf
    # some block was planned into more than one piece
    assert any(n > 1 for n, _ in stitched)
    assert snap["align.assemble.pieces"] == sum(n for n, _ in stitched)
    assert snap["align.assemble.ops"] == sum(k for _, k in stitched)
    perf.dump()
    err = capsys.readouterr().err
    for key in ("align.assemble.pieces", "align.assemble.ops"):
        assert f"[wfmash::perf] {key} = {snap[key]:.3f}" in err


def test_map_run_fills_every_span_and_dumps_them(pair):
    """`-m -t 2` through the device stages on CPU tensors, in its own
    process (the pool forks): WFMASH_TPU_PERF=1 prints every span's
    total and self time at exit."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("WFMASH_TPU_")}
    env.update(PYTHONPATH=str(REPO), WFMASH_TPU_TORCH_DEVICE="cpu",
               WFMASH_TPU_DEVICE_L1="1", WFMASH_TPU_PERF="1")
    r = subprocess.run(
        [sys.executable, "-m", "wfmash_tpu_torch", "t.fa", "q.fa", "-m",
         "-t", "2"], capture_output=True, text=True, timeout=300, env=env,
        cwd=str(pair))
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout == (pair / "m.paf").read_text()
    snap = {k: float(v) for k, v in re.findall(
        r"\[wfmash::perf\] (\S+) = ([-0-9.e+]+)", r.stderr)}
    _check_spans(snap, MAP_SPANS)
    assert snap["map.device_s"] == pytest.approx(
        snap["map.l1.device_s"] + snap["map.l2.device_s"], abs=2e-3)
    assert snap["map.device_calls"] >= 1 and snap["map.l2_device_calls"] >= 1


@pytest.fixture(scope="module")
def divergent_batch():
    """One SegmentedEngine batch on the CPU, recorded: a 650 bp block at
    ~34% divergence (substitutions alone) that no anchor plan holds, and
    a 2 kb block at ~11% that plans into pieces. The first goes whole to
    the exact engine, whose tiers cannot settle it, so it re-enters the
    sweep recursion: kernel B's plain version. The exact engine's span
    ladder stops at 512 lanes to keep the sweep short on the CPU."""
    from wfmash_tpu_torch.align.segmented import SegmentedEngine
    from wfmash_tpu_torch.align.wfa_exact import ExactWfaEngine
    from wfmash_tpu_torch.align.wfa_np import Penalties

    p = Penalties(5, 8, 2, 24, 1)
    cpu = torch.device("cpu")
    eng = SegmentedEngine(p, ExactWfaEngine(p, cpu, max_span=513), cpu)
    rng = np.random.default_rng(2)
    a = random_dna(rng, 650)
    jobs = [(mutate(rng, a, 0.45), a, None)]
    b = random_dna(rng, 2_000)
    jobs.append((mutate(rng, b, 0.15), b, None))
    perf.reset()
    with perf.recording() as records:
        out = eng.align_batch(jobs)
    return eng, out, records, perf.snapshot()


def test_engine_counters_on_a_divergent_batch(divergent_batch):
    """The counters align.exact_blocks, .banded and .inversions are the
    engine's stats; align.segments and align.escalated count wider than
    the reference's stats (every piece and whole job; every cause); the
    pieces escalated are at most the pieces, and the sum of their
    causes; every sweep that had problems counted lanes."""
    eng, out, _, snap = divergent_batch
    assert all(ops for ops in out)
    for key in ("exact_blocks", "banded", "inversions"):
        assert snap.get(f"align.{key}", 0) == eng.stats[key], key
    assert snap["align.segments"] >= eng.stats["segments"] > 0
    assert snap.get("align.escalated.tier_reject", 0) \
        >= eng.stats["escalated"]
    assert snap["align.escalated.unanchorable"] == 1
    assert snap["align.exact_blocks"] == 1
    assert 1 <= snap["align.escalated"] <= snap["align.segments"]
    assert snap["align.escalated"] == sum(
        snap.get(f"align.escalated.{c}", 0)
        for c in ("tier_reject", "oversize", "unanchorable"))
    problems = sum(v for k, v in snap.items()
                   if k.startswith("align.sweep_problems."))
    assert problems > 0 and snap["align.sweep.lanes"] > 0
    assert snap["align.sweep.lanes"] == eng.exact.sweeps.lanes
    assert 1 <= snap["align.sweep.launches"] <= problems


def test_sweep_lanes_wherever_it_has_problems(monkeypatch):
    """Per ExactSweeps.sweep call: the lanes it adds are above 0 wherever
    its problems are, and it adds one launch; a call whose problems are
    all done at score 0 adds neither."""
    from wfmash_tpu_torch.align.wfa_exact import ExactWfaEngine
    from wfmash_tpu_torch.align.wfa_np import Penalties
    from wfmash_tpu_torch.align.wfa_sweep import ExactSweeps

    calls = []
    real = ExactSweeps.sweep

    def spy(self, *a, **kw):
        before = perf.snapshot()
        got = real(self, *a, **kw)
        after = perf.snapshot()
        calls.append({k: after.get(k, 0) - before.get(k, 0)
                      for k in after})
        return got

    monkeypatch.setattr(ExactSweeps, "sweep", spy)
    p = Penalties(5, 8, 2, 24, 1)
    eng = ExactWfaEngine(p, torch.device("cpu"), host_len=64)
    rng = np.random.default_rng(5)
    t = random_dna(rng, 300)
    jobs = [(mutate(rng, t, 0.05), t, None), (t[:200], t[:200], None)]
    perf.reset()
    out = eng.align_batch(jobs)
    assert out[1] == [(200, "=")]
    assert calls
    for c in calls:
        problems = sum(v for k, v in c.items()
                       if k.startswith("align.sweep_problems."))
        if problems > 0:
            assert c["align.sweep.lanes"] > 0
            assert c["align.sweep.launches"] == 1
        else:
            assert c.get("align.sweep.lanes", 0) == 0
            assert c.get("align.sweep.launches", 0) == 0
    assert perf.get("align.sweep.lanes") == eng.sweeps.lanes


def _self_ns(rec, records):
    kids = [(r["start"], r["end"]) for r in records
            if r["parent"] == rec["id"]]
    return (rec["end"] - rec["start"]) - perf._covered(
        kids, rec["start"], rec["end"])


def test_escalate_and_exact_are_separate_spans(divergent_batch):
    """align.exact (the host pass beside the device thread, under
    align.seg_solve) and align.escalate (tier failures after the join,
    under align.engine) are separate spans; each one's counters are its
    records' durations and self times, and the self times of the engine
    thread's spans add up to the engine's wall."""
    _, _, records, snap = divergent_batch
    by_id = {r["id"]: r for r in records}
    (eng,) = [r for r in records if r["name"] == "align.engine"]
    exact = [r for r in records if r["name"] == "align.exact"]
    escalate = [r for r in records if r["name"] == "align.escalate"]
    assert exact and escalate
    assert all(by_id[r["parent"]]["name"] == "align.seg_solve"
               for r in exact)
    assert all(r["parent"] == eng["id"] for r in escalate)
    for x in exact:
        for e in escalate:
            assert x["end"] <= e["start"] or e["end"] <= x["start"]
    for name, recs in (("align.exact", exact), ("align.escalate", escalate)):
        wall = sum(r["end"] - r["start"] for r in recs)
        own = sum(_self_ns(r, records) for r in recs)
        assert snap[f"{name}_s"] == pytest.approx(wall / 1e9, rel=1e-9)
        assert snap[f"{name}.self_s"] == pytest.approx(own / 1e9, rel=1e-9)
    # the exact engine's work on the unanchorable block is align.exact's
    assert snap["align.exact_s"] > snap["align.escalate_s"]
    main = [r for r in records if r["thread"] == eng["thread"]
            and eng["start"] <= r["start"] and r["end"] <= eng["end"]]
    total = sum(_self_ns(r, records) for r in main)
    assert total == pytest.approx(eng["end"] - eng["start"], abs=2e6)
