"""The divergent configuration: its generator (seeded, byte-stable, the
stated divergence profile), the readers of the divergent.align cell's
per-layer metrics, kernel B's operations roofline, and whole runs of the
cell at a small size on the CPU (a sound run is correct, the control is
not)."""

import hashlib
import json
import os
import time
import types

import numpy as np
import pytest
import torch
from scipy import stats

from benchlib import inputs, sweep_ops
from benchlib.cell import ROOT, load_json, metric_reader, run_cell

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
GEN = inputs.generator("divergent_pair")

# sha256 of the files generate(d, seed, 200_000) writes
PINNED = {
    5: {"t.fa": "dc85fb0ddd2a6a7465da6223162e9ceb"
                "455851afae9f5604134608e1b7b758b8",
        "q.fa": "34da2bd69821edef4bf3f1f19acaf460"
                "88838a402e6e75331ecab40fc60127ce"},
    2 ** 31 + 17: {"t.fa": "901935e2340c12167801cf34fcabffdd"
                           "90d1bddb6931bda8ad3161d853eb4f16",
                   "q.fa": "f27b0dcc178cb1b31f3811b6bf634469"
                           "d56d074b235ec0d5363fe12c36d62093"},
}


def _sha(path):
    with open(path, "rb") as fh:
        return hashlib.sha256(fh.read()).hexdigest()


@pytest.mark.parametrize("seed", sorted(PINNED))
def test_generator_is_seeded_and_byte_stable(tmp_path, seed):
    a, b = tmp_path / "a", tmp_path / "b"
    a.mkdir()
    b.mkdir()
    files = GEN.generate(str(a), seed, 200_000)
    assert files == ["t.fa", "t.fa.fai", "q.fa", "q.fa.fai"]
    GEN.generate(str(b), seed, 200_000)
    for f in files:
        assert (a / f).read_bytes() == (b / f).read_bytes(), f
    assert {f: _sha(a / f) for f in PINNED[seed]} == PINNED[seed]
    other = tmp_path / "c"
    other.mkdir()
    GEN.generate(str(other), seed + 1, 200_000)
    assert (other / "q.fa").read_bytes() != (a / "q.fa").read_bytes()


def _clipped_gamma_cdf(x):
    """CDF of the stated profile: gamma of shape 2 and mean 0.12, clipped
    to [0.02, 0.30] (the clipped mass sits on the two ends)."""
    x = np.asarray(x, float)
    f = stats.gamma.cdf(x, GEN.SHAPE, scale=GEN.MEAN / GEN.SHAPE)
    return np.where(x < GEN.LO, 0.0, np.where(x >= GEN.HI, 1.0, f))


def test_window_divergence_follows_the_profile():
    """4000 windows' d against the clipped gamma: the largest gap between
    the two CDFs (right-continuous, the atoms at 0.02 and 0.30 included)
    stays under 0.03, twice the 5% Kolmogorov bound 1.36 / sqrt(4000)."""
    d = GEN.window_divergence(np.random.default_rng(7), GEN.WINDOW * 4000)
    assert len(d) == 4000
    assert d.min() == GEN.LO and d.max() == GEN.HI
    grid = np.concatenate([np.sort(d), np.linspace(0.0, 0.35, 200)])
    emp = np.searchsorted(np.sort(d), grid, side="right") / len(d)
    assert np.abs(emp - _clipped_gamma_cdf(grid)).max() < 0.03
    # the atoms: gamma's mass below 0.02 and above 0.30
    low = stats.gamma.cdf(GEN.LO, GEN.SHAPE, scale=GEN.MEAN / GEN.SHAPE)
    high = stats.gamma.sf(GEN.HI, GEN.SHAPE, scale=GEN.MEAN / GEN.SHAPE)
    assert abs((d == GEN.LO).mean() - low) < 0.01
    assert abs((d == GEN.HI).mean() - high) < 0.01


def test_events_change_d_of_each_windows_bases():
    """A 2 Mb pair: per window, the bases its small events change (SNPs,
    inserted and deleted bases) over the window's length track the
    window's d (the ladder's mix: d / 1.45 events a base, 1.45 bases an
    event); the histogram of those realized shares follows the profile
    as d's does; the long indels come one every ~50 kb, 100 bp-10 kb."""
    bp = 2_000_000
    anc, der, d, ev = GEN.make_pair(bp, 2 ** 31 + 41)
    w = GEN.WINDOW
    changed = np.bincount(ev["snp"] // w, minlength=len(d)).astype(float)
    for key in ("small_ins", "small_del"):
        at, n = ev[key]
        changed += np.bincount(at // w, weights=n, minlength=len(d))
    real = changed / w
    assert np.corrcoef(real, d)[0, 1] > 0.98
    assert abs(real.mean() / d.mean() - 1) < 0.02
    assert np.abs(real - d).max() < 0.05
    # the share of SNPs among the small events: 90%
    n_small = (len(ev["snp"]) + len(ev["small_ins"][0])
               + len(ev["small_del"][0]))
    assert abs(len(ev["snp"]) / n_small - GEN.SNP_SHARE) < 0.005
    grid = np.linspace(0.0, 0.35, 36)
    emp = np.searchsorted(np.sort(real), grid, side="right") / len(real)
    assert np.abs(emp - _clipped_gamma_cdf(grid)).max() < 0.15
    long_at, long_len, long_ins = ev["long"]
    assert 20 <= len(long_at) <= 60
    assert long_len.min() >= GEN.LONG_MIN and long_len.max() <= GEN.LONG_MAX
    assert 0.25 < long_ins.mean() < 0.75
    assert len(anc) == bp
    # every inserted base, less the union of the deleted ranges, less the
    # structural deletion of bp / 100, plus the duplication of 3 bp / 1000
    deleted = np.zeros(bp, bool)
    for at, n in zip(np.concatenate([ev["small_del"][0],
                                     long_at[~long_ins]]),
                     np.concatenate([ev["small_del"][1],
                                     long_len[~long_ins]])):
        deleted[at:at + n] = True
    inserted = ev["small_ins"][1].sum() + long_len[long_ins].sum()
    assert len(der) == (bp + inserted - deleted.sum() - bp // 100
                        + 3 * bp // 1000)


def _ctx(perfs, walls, by_name=None):
    trace = None if by_name is None else {"by_name": by_name,
                                          "busy_s": 1.0, "window_s": 10.0}
    return types.SimpleNamespace(
        window_s=sum(walls), trace=trace, jobs_done=[
            {"wall": w, "bp": 1_000_000, "perf": p}
            for w, p in zip(walls, perfs)])


@pytest.mark.parametrize("name,key", [("align.exact_pct", "align.exact_s"),
                                      ("align.escalate_pct",
                                       "align.escalate_s")])
def test_span_share_readers(name, key):
    read = metric_reader(name)
    perfs = [{key: 0.5, "align.plan_s": 3.0}, {key: 1.5}]
    assert read(_ctx(perfs, [4.0, 6.0])) == pytest.approx(20.0)
    assert read(_ctx([{"align.plan_s": 1.0}], [2.0])) is None


def test_escalated_share_reader():
    read = metric_reader("align.escalated_share")
    perfs = [{"align.segments": 300.0, "align.escalated": 3.0},
             {"align.segments": 100.0, "align.escalated.tier_reject": 1.0}]
    assert read(_ctx(perfs, [1.0, 1.0])) == pytest.approx(0.75)
    # a program without the counters
    assert read(_ctx([{"align.exact_s": 1.0}], [1.0])) is None


def test_sweep_readers_on_a_fabricated_trace():
    ms_per_mbp = metric_reader("kernel.sweep_wfa.ms_per_mbp")
    roofline = metric_reader("kernel.sweep_wfa.ops_roofline_pct")
    names = {"void sweep_wfa_shared_kernel<true>(...)": 0.003,
             "sweep_wfa_global_kernel(...)": 0.001,
             "seg_wfa_kernel(...)": 0.5}
    perfs = [{"align.sweep.lanes": 1e9}, {"align.sweep.lanes": 5e8}]
    ctx = _ctx(perfs, [2.0, 2.0], names)
    assert ms_per_mbp(ctx) == pytest.approx(4.0 / 2.0)
    want = 100.0 * 1.5e9 * sweep_ops.SWEEP_OPS_PER_LANE / 67e12 / 4e-3
    assert roofline(ctx) == pytest.approx(want)
    # no launch in the window, or a program that does not count lanes
    quiet = {"seg_wfa_kernel(...)": 0.5}
    assert ms_per_mbp(_ctx(perfs, [2.0], quiet)) is None
    assert roofline(_ctx(perfs, [2.0], quiet)) is None
    assert roofline(_ctx([{}], [2.0], names)) is None
    assert ms_per_mbp(_ctx(perfs, [2.0])) is None


def test_roofline_of_a_known_launch_is_under_100():
    """A launch that reached 10^9 lanes in 2 ms: 91 x 10^9 operations at
    67 Top/s take 1.358 ms, 67.9% of the 2 ms."""
    assert sweep_ops.SWEEP_OPS_PER_LANE == 91
    got = sweep_ops.ops_roofline_pct(10 ** 9, 2.0)
    assert got == pytest.approx(100 * 91e9 / 67e12 / 2e-3)
    assert 0 < got < 100
    # the least time is the bound: a launch as fast as the bound reads 100%
    assert sweep_ops.ops_roofline_pct(
        10 ** 9, sweep_ops.sweep_ops_ms(10 ** 9)) == pytest.approx(100.0)


def test_frozen_arithmetic_is_chip_smokes():
    import chip_smoke

    assert sweep_ops.SWEEP_OPS_PER_LANE == chip_smoke.SWEEP_OPS_PER_LANE
    assert sweep_ops.INT_OPS_PER_S == chip_smoke.INT_OPS_PER_S


def _run(tmp_path, monkeypatch, control=False):
    """divergent.align on divergent_tiny (the generator at 80 kb) on the
    card's path, the segmented engine, run by the plain versions of both
    kernels: one job of every mapping record, then the check."""
    monkeypatch.setenv("WFMASH_TPU_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("WFMASH_TPU_SEGMENTED", "1")
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    with open(os.path.join(DATA, "divergent_tiny.json")) as fh:
        cfg = json.load(fh)
    traffic = dict(load_json("traffic", "divergent_chunks_1mbp.json"),
                   sample=6)
    res = run_cell(bench, "divergent.align", 2 ** 31 + 99, 0.01, False,
                   torch.device("cpu"), time.monotonic(), control=control,
                   work_root=str(tmp_path), config=cfg, traffic=traffic)
    return res, {c["name"]: c for c in res["checks"]}


def test_divergent_tiny_sound_run_is_correct(tmp_path, monkeypatch):
    res, checks = _run(tmp_path, monkeypatch)
    assert res["correct"], res["checks"]
    assert res["attempted"] == 1 and res["failed"] == 0


def test_divergent_tiny_control_is_not_correct(tmp_path, monkeypatch):
    res, checks = _run(tmp_path, monkeypatch, control=True)
    assert not res["correct"]
    assert checks["score_excess"]["value"] > checks["score_excess"]["limit"]
