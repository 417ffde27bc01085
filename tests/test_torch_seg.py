"""The port's segment WFA (wfmash_tpu_torch.align.wfa_seg) against the JAX
package's Pallas kernel and host solver, and against the wfa_np spec.

On the CPU, run_seg runs the kernel's plain PyTorch version; the reference
kernel runs in Pallas interpret mode. Both get the same chunk buffer,
packed by the port's pack_chunk from jobs made with numpy from a seed.
All values are integers, so the tolerance is exact: byte equality, with
two stated exceptions that the port's per-problem stop brings:

* term col 8 (swept levels) is per group in the reference and per
  problem in the port;
* a capped problem whose lockstep group kept sweeping may finish above
  its cap in the reference; the port stops it at the cap ("scorecap").
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wfmash_tpu.align import wfa_pallas_seg as R
from wfmash_tpu.align.wfa_np import EndsFree, Penalties, wfa_align
from wfmash_tpu_torch.align import wfa_seg as T

from test_wfa import make_pair
from util import mutate, random_dna

torch.set_num_threads(1)

PATCH = Penalties(5, 8, 2, 24, 1)
WFLIGN = Penalties(2, 3, 1, 3, 1)
SMALL = dict(PB=4, K=64, smax=64, lseg=256, groups=2)


def _snps(rng, n, k):
    """A pair that differs by k isolated substitutions (score k*x)."""
    q = random_dna(rng, n)
    t = bytearray(q)
    for pos in np.linspace(5, n - 5, k).astype(int):
        t[pos] = 67 if t[pos] != 67 else 71
    return q, bytes(t)


def _job_mix(rng):
    """(jobs, max_scores) for one small chunk: end-to-end pairs, ends-free
    patches, skew, IUPAC bytes, and capped jobs. Row 0 (score 4x) is
    capped at 8 while its group peers (score 11x) sweep deeper: under
    PATCH the reference finishes it above its cap (the lockstep case)."""
    jobs, caps = [], []
    jobs.append((*_snps(rng, 100, 4), None))
    caps.append(8)
    for _ in range(3):
        jobs.append((*_snps(rng, 200, 11), None))
        caps.append(None)
    t = random_dna(rng, 90)
    jobs.append((mutate(rng, t, 0.06), t, EndsFree(target_begin=90,
                                                   query_begin=90)))
    t = random_dna(rng, 100)
    jobs.append((mutate(rng, t, 0.06), t, EndsFree(target_end=100,
                                                   query_end=100)))
    s = random_dna(rng, 200)
    jobs.append((s, s[:70] + s[110:], None))               # 40 bp deletion
    odd = bytearray(random_dna(rng, 120))
    odd[10:14] = b"RYNN"
    jobs.append((bytes(odd), bytes(odd[:60] + b"K" + odd[61:]), None))
    caps += [None, None, 30, None]
    return jobs, caps


def _check_kernel_outputs(ref_runs, ref_out, runs, out, caps, maxr):
    """Returns the number of rows that took the lockstep-cap exception."""
    cols = [j for j in range(ref_out.shape[1]) if j != 8]
    n_exc = 0
    for b in range(ref_out.shape[0]):
        cap = caps[b] or 0
        if cap and (not ref_out[b, 0] or ref_out[b, 1] > cap):
            # stopped at its cap: not done, no runs, clean cursor
            assert out[b, 0] == 0 and out[b, 2] == 1, b
            assert out[b, 4] == maxr - 1 and out[b, 5] == 1, b
            assert (runs[b] == T.OP_SENTINEL << 13).all(), b
            n_exc += bool(ref_out[b, 0])
            continue
        np.testing.assert_array_equal(ref_runs[b], runs[b], err_msg=str(b))
        np.testing.assert_array_equal(ref_out[b, cols], out[b, cols],
                                      err_msg=str(b))
    return n_exc


@pytest.mark.parametrize("pen", [PATCH, WFLIGN], ids=["patch", "wflign"])
def test_run_seg_matches_pallas_kernel(pen):
    rng = np.random.default_rng(21)
    jobs, caps = _job_mix(rng)
    sol = T.SegmentSolver(pen, "cpu", **SMALL)
    idxs = list(range(len(jobs)))
    assert all(sol.accepts(len(q), len(t), ef) for q, t, ef in jobs)
    buf, meta = sol.pack_chunk(idxs, jobs, caps)
    assert buf.shape == (8, 256 + 64) and not meta.get("give_up")
    ref_runs, ref_out = R._run_seg(
        jnp.asarray(buf), penalties=pen, PB=4, K=64, smax=64,
        maxr=sol.maxr, interpret=True)
    ref_runs = np.asarray(ref_runs).reshape(8, sol.maxr)
    ref_out = np.asarray(ref_out).reshape(8, -1)
    before = T.LAUNCHES
    runs, out = T.run_seg(torch.from_numpy(buf), penalties=pen, K=64,
                          smax=64, maxr=sol.maxr)
    assert T.LAUNCHES == before          # the CPU path launches no kernel
    assert runs.dtype == torch.int32 and out.dtype == torch.int16
    assert out.shape == (8, T.NTERM + T.RUNS_CAP)
    caps_rows = [c or 0 for c in caps]
    n_exc = _check_kernel_outputs(ref_runs, ref_out, runs.numpy(),
                                  out.numpy(), caps_rows, sol.maxr)
    if pen is PATCH:
        assert n_exc == 1                # row 0: the lockstep-cap case
    assert ref_out[:, 0].sum() >= 6      # the mix really solves


def test_pack_chunk_matches_reference_buffer(monkeypatch):
    """pack_chunk writes the reference's fused chunk buffer byte for byte
    (captured at the reference's launch, which is stubbed out here)."""
    rng = np.random.default_rng(22)
    jobs, caps = _job_mix(rng)
    got = {}

    def capture(buf, **kw):
        got["buf"] = np.asarray(buf)
        B = buf.shape[0]
        return (np.zeros((B, kw["maxr"]), np.int32),
                np.zeros((B // kw["PB"], kw["PB"], 16 + 128), np.int16))

    monkeypatch.setattr(R, "_run_seg", capture)
    ref = R.SegmentSolver(PATCH, interpret=True, **SMALL)
    ref._dispatch_chunk(list(range(len(jobs))), jobs, caps)
    buf, meta = T.SegmentSolver(PATCH, "cpu", **SMALL).pack_chunk(
        list(range(len(jobs))), jobs, caps)
    np.testing.assert_array_equal(got["buf"], buf)
    # more than 14 distinct bytes: the chunk gives up on both sides
    many = [(bytes(range(65, 85)), bytes(range(65, 85)), None)]
    assert T.SegmentSolver(PATCH, "cpu", **SMALL).pack_chunk(
        [0], many, None)[0] is None
    assert ref._dispatch_chunk([0], many, None).get("give_up")


def _solver_jobs(rng):
    """The job mixes of tests/test_wfa_seg.py, at the small envelope."""
    jobs, caps = [], []
    for _ in range(6):
        n = int(rng.integers(40, 230))
        jobs.append(make_pair(rng, n, sub=0.05, indel=0.02, max_indel=8))
        caps.append(None)
    s = random_dna(rng, 240)
    jobs += [(s, s), (s[:200], s[:200]), (b"", s[:50]), (s[:50], b""),
             (s[:64], bytes(64)), (s[:100] + s[180:240], s[:240]),
             (random_dna(rng, 300), random_dna(rng, 300))]
    caps += [None, None, None, None, None, None, None]
    for i in range(4):                   # ends-free boundary patches
        n = int(rng.integers(60, 110))
        t = random_dna(rng, n)
        q = mutate(rng, t, 0.06)
        ef = (EndsFree(target_begin=n, query_begin=len(q)) if i % 2 == 0
              else EndsFree(target_end=n, query_end=len(q)))
        jobs.append((q, t, ef))
        caps.append(None)
    for _ in range(6):                   # two-letter tie-break fuzz
        n = int(rng.integers(20, 180))
        t = bytes(rng.choice([65, 67], size=n).astype(np.uint8))
        q = bytearray(t)
        for _ in range(int(rng.integers(0, 8))):
            pos = int(rng.integers(0, len(q)))
            q[pos] = 67 if q[pos] == 65 else 65
        jobs.append((bytes(q), t))
        caps.append(None)
    q, t = make_pair(rng, 150, sub=0.1, indel=0.02, max_indel=4)
    jobs += [(q, t), (q, t)]
    caps += [5, 60]                      # refuted / solved under its cap
    return jobs, caps


def _statuses_equal(ref_st, st, ref_res, caps):
    """Per-job statuses equal, but for the one lockstep-cap exception."""
    for i, (a, b) in enumerate(zip(ref_st, st)):
        if a != b:
            code_a = a[0] if isinstance(a, tuple) else a
            code_b = b[0] if isinstance(b, tuple) else b
            assert code_a == "ok" and code_b == "scorecap" and caps[i], i
            assert ref_res[i] is not None


def test_segment_solver_matches_reference():
    rng = np.random.default_rng(23)
    jobs, caps = _solver_jobs(rng)
    ref = R.SegmentSolver(PATCH, interpret=True, **SMALL)
    port = T.SegmentSolver(PATCH, "cpu", **SMALL)
    out = {}
    for name, sol in (("ref", ref), ("port", port)):
        st, unc = [], []
        res = sol.solve(jobs, status=st, max_scores=caps, uncertified=unc)
        out[name] = (res, st, unc)
    (r_res, r_st, r_unc), (p_res, p_st, p_unc) = out["ref"], out["port"]
    _statuses_equal(r_st, p_st, r_res, caps)
    for i in range(len(jobs)):
        if r_st[i] == p_st[i]:
            assert r_res[i] == p_res[i], i
    assert r_unc == p_unc
    assert {"ok", "envelope", "scorecap"} <= set(p_st)
    for (q, t, *ef), ops, s in zip(jobs, p_res, p_st):
        if ops is not None and s == "ok":
            assert ops == wfa_align(q, t, PATCH, ef[0] if ef else None)[1]


def test_tiered_solver_matches_reference():
    """The cascade over two small tiers (a job too divergent or too skewed
    for tier 1 must come back from tier 2), with the tier table read from
    the reference by from_reference."""
    rng = np.random.default_rng(24)
    ref = R.TieredSegmentSolver(PATCH, interpret=True)
    ref.tiers = (R.SegmentSolver(PATCH, interpret=True, **SMALL),
                 R.SegmentSolver(PATCH, interpret=True, PB=4, K=128,
                                 smax=160, lseg=512, groups=2))
    port = T.TieredSegmentSolver.from_reference(ref, "cpu")
    assert [(t.K, t.smax, t.lseg) for t in port.tiers] == \
        [(64, 64, 256), (128, 160, 512)]
    jobs = [make_pair(rng, int(rng.integers(60, 230)), sub=0.04, indel=0.01,
                      max_indel=5) for _ in range(5)]
    s = random_dna(rng, 400)
    jobs.append((s, s[:150] + s[190:]))          # skew 40: tier 2 only
    jobs.append((s, s[:150] + s[230:]))          # skew 80: uncertified
    jobs.append(_snps(rng, 220, 16))              # score 80 > 64: tier 2
    jobs.append((random_dna(rng, 200), random_dna(rng, 200)))
    caps = [None] * (len(jobs) - 1) + [100]
    out = {}
    for name, sol in (("ref", ref), ("port", port)):
        st, unc = [], []
        res = sol.solve(jobs, status=st, max_scores=caps, uncertified=unc)
        out[name] = (res, st, unc)
    assert out["ref"][0] == out["port"][0]
    _statuses_equal(out["ref"][1], out["port"][1], out["ref"][0], caps)
    assert out["ref"][2] == out["port"][2]
    st = out["port"][1]
    assert st[5] == st[7] == ("ok", 160) and st[6] == ("uncert", 160)
    assert out["port"][2][6] is not None
    for (q, t), ops, s in zip(jobs, out["port"][0], st):
        if s[0] == "ok":
            assert ops == wfa_align(q, t, PATCH)[1]


def test_default_tier_table_matches_reference():
    ref = R.TieredSegmentSolver(PATCH)
    assert T.TIERS == tuple((t.PB, t.K, t.smax, t.lseg, t.groups)
                            for t in ref.tiers)
    port = T.TieredSegmentSolver(PATCH, "cpu")
    assert [(t.maxr, t.max_call) for t in port.tiers] == \
        [(t.maxr, t.max_call) for t in ref.tiers]


def test_long_cigar_over_runs_cap():
    """A CIGAR of more than RUNS_CAP runs is read back from runs_full (the
    overflow path the reference never tests) and equals wfa_np's."""
    rng = np.random.default_rng(25)
    q = random_dna(rng, 450)
    t = bytearray(q)
    for pos in range(3, 450, 6):                  # isolated mismatches
        t[pos] = b"C"[0] if t[pos] != b"C"[0] else b"G"[0]
    t = bytes(t)
    sol = T.SegmentSolver(PATCH, "cpu", PB=2, K=512, smax=400, lseg=512,
                          groups=1)
    st = []
    got = sol.solve([(q, t), (q[:100], t[:100])], status=st)
    assert st == ["ok", "ok"]
    ref = wfa_align(q, t, PATCH)[1]
    assert len(ref) > T.RUNS_CAP
    assert got[0] == ref
    assert got[1] == wfa_align(q[:100], t[:100], PATCH)[1]


def test_run_seg_rejects_what_it_cannot_run():
    buf = torch.zeros((2, 128 + 64), dtype=torch.uint8)
    kw = dict(penalties=PATCH, K=64, smax=16, maxr=160)
    with pytest.raises(ValueError):
        T.run_seg(buf.to(torch.int32), **kw)
    with pytest.raises(ValueError):
        T.run_seg(buf.to("meta"), **kw)
    with pytest.raises(ValueError):
        T.run_seg(buf, **dict(kw, K=2048))
    runs, out = T.run_seg(buf, **kw)            # all-padding rows finish at 0
    assert (out[:, 0] == 1).all() and (out[:, 4] == 159).all()


@pytest.mark.parametrize("pen", [PATCH, WFLIGN], ids=["patch", "wflign"])
def test_run_seg_deep_scores_and_level_zero(pen):
    """Scores several times the deepest lag of the recurrence (the sweep's
    lag window wraps around more than once), a long gap that takes the
    second gap piece, and rows that finish at level 0, in one chunk of a
    deep, narrow launch shape: run_seg equals the Pallas kernel byte for
    byte (term col 8 aside)."""
    rng = np.random.default_rng(26)
    deep = dict(PB=4, K=64, smax=128, lseg=256, groups=2)
    s = random_dna(rng, 220)
    q6, t6 = _snps(rng, 230, 6)
    jobs = [(*_snps(rng, 200, 16), None),          # 16 mismatches
            (s, s, None),                           # done at level 0
            (q6, t6[:100] + t6[120:], None),        # 20 bp gap + mismatches
            (*_snps(rng, 240, 21), None),           # 21 mismatches
            (s[:90], s[:90], EndsFree(target_end=90, query_end=90)),
            (*_snps(rng, 150, 9), None)]
    sol = T.SegmentSolver(pen, "cpu", **deep)
    assert all(sol.accepts(len(q), len(t), ef) for q, t, ef in jobs)
    buf, _ = sol.pack_chunk(list(range(len(jobs))), jobs, None)
    ref_runs, ref_out = R._run_seg(
        jnp.asarray(buf), penalties=pen, PB=4, K=64, smax=128,
        maxr=sol.maxr, interpret=True)
    ref_runs = np.asarray(ref_runs).reshape(8, sol.maxr)
    ref_out = np.asarray(ref_out).reshape(8, -1)
    runs, out = T.run_seg(torch.from_numpy(buf), penalties=pen, K=64,
                          smax=128, maxr=sol.maxr)
    n_exc = _check_kernel_outputs(ref_runs, ref_out, runs.numpy(),
                                  out.numpy(), [0] * 8, sol.maxr)
    assert n_exc == 0
    out = out.numpy()
    assert out[:6, 0].all()                         # every job solves
    assert out[1, 1] == 0 and out[4, 1] == 0        # at level 0
    lag = max(pen.mismatch, pen.gap_opening1 + pen.gap_extension1,
              pen.gap_opening2 + pen.gap_extension2)
    assert out[0, 1] == 16 * pen.mismatch and out[3, 1] == 21 * pen.mismatch
    assert out[3, 1] > 2 * lag                      # the window wrapped
    assert out[2, 1] == 6 * pen.mismatch + pen.gap_cost(20)
    assert pen.gap_cost(20) == pen.gap_opening2 + 20 * pen.gap_extension2
