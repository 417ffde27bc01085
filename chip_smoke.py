"""Smoke run of the PyTorch/CUDA port on one GPU: `python3 chip_smoke.py`.

Phases (any failure exits non-zero; nothing is caught):
1. the card's name and power limit; a CUDA device is required;
2. build the two CUDA kernels (nvcc) and the five native host libraries
   (g++), all started together;
3. per segment tier, one full chunk of generated jobs packed by the port's
   pack_chunk: the segment kernel and its plain PyTorch version (on the
   card and on a CPU copy) must agree byte for byte (term col 8, the
   per-problem level counter, aside);
4. the tiered solver on the card: every `ok` CIGAR must equal wfa_np's;
5. per span-ladder step K = 256..4096, one seeded batch (both split axes,
   some problems solved before the sweep) and one batch built to touch
   the band edge: the sweep kernel and its plain PyTorch version on the
   card must agree exactly on all five outputs;
6. ExactWfaEngine.align_batch on seeded 2-40 kb blocks: every CIGAR
   replays and scores the native exact WFA's score; the sweep kernel must
   have launched;
7. the CLI (`wfmash_tpu_torch target.fa query.fa -t 1`) in-process on the
   6 Mb synthetic pair of tests/test_scale.py, once on the default path
   (SegmentedEngine) and once with WFMASH_TPU_SEGMENTED=0 (ExactWfaEngine
   alone): exit 0, kernel launches counted from 0 for each run, sampled
   CIGARs replay exactly, query coverage >= 0.95; a run that passed its
   gates is made once more under torch.profiler for the card's busy
   share (reported only).
The last lines are the card line, the kernel table as JSON, and the
result as JSON.

Bounds in the kernel table: `bound_ms` is the larger of (bytes each input
is read and each output written once) / 3.35 TB/s and (32-bit integer
operations on the wavefront's lanes) / 67 Top/s, the card's published HBM
rate and its published non-tensor fp32 rate. That rate is in FLOP, an FMA
counted as two: the card runs 33.5 T fp32 instructions a second and
half as many int32 ones, so dividing integer operations by 67 T/s
understates the least time and never overstates it. Only the lanes a
level's wavefront can have reached are counted (the seeded lanes widened
by one a side per level, inside the band), from this run's data: the
sweep kernel counts them itself, the segment kernel's are summed here
from its level counter and each problem's seeded lanes. No single PyTorch
call computes either function: `library_ms` is null.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

ACGT = np.frombuffer(b"ACGT", np.uint8)
SEED = 20261016
N_SAMPLE = 60
MIN_COVERAGE = 0.95
MIN_SPEC_CHECKS = 200

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, published
INT_OPS_PER_S = 67e12          # non-tensor fp32 FLOP rate, published
# 32-bit operations (one per compare, add, select or logic operation) that
# the recurrences need per wavefront lane and level. Not counted: address
# arithmetic, the match extension and the backtrace (they depend on the
# data), packing an anchor (only at a crossing), and the int16 narrowing
# of the segment kernel's history.
# Segment kernel (csrc/seg_wfa.cu, the forward sweep's loop body):
#   10  gap cells: D1, D2 one max each; I1, I2 max, > NEG, + 1, select
#    3  mismatch candidate: > NEG, + 1, select
#    4  M = max of the five candidates
#    9  bounds: v = m - k, four compares, three ANDs, select
#   14  accept test on the extended cell: v, two end tests of two
#       compares and a subtraction each with >= 0, four ANDs, one OR
SEG_OPS_PER_LANE = 10 + 3 + 4 + 9 + 14
# Sweep kernel (csrc/sweep_wfa.cu, gap_wave and the level loop's body):
#   52  four gap cells of 13: the segment kernel's 3 (D) or 5 (I), then
#       select the anchor, the gap-open cell (D: a subtraction; two
#       selects), and the crossing (anchor unset, offset on the split
#       line with a subtraction for D, two ANDs, select)
#    3  mismatch candidate
#    5  its crossing: anchor unset, on the split line (subtraction,
#       compare), AND, select
#   12  M = first strict maximum of five with its anchor: four compares,
#       eight selects
#   10  bounds on offset and anchor: v, four compares, three ANDs, two
#       selects
#    6  crossing inside the extension run (one split axis a problem):
#       anchor unset, two compares, two ANDs, select
#    3  finish: end diagonal, offset >= qlen, AND
SWEEP_OPS_PER_LANE = 52 + 3 + 5 + 12 + 10 + 6 + 3
# ring words the sweep kernel loads (22) and stores (14) per lane and level
SWEEP_RING_BYTES_PER_LANE = 36 * 4


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# generated jobs
# ---------------------------------------------------------------------------


def _mutate(rng, codes, snp, dele):
    t = codes.copy()
    s = rng.random(len(t)) < snp
    t[s] = (t[s] + rng.integers(1, 4, int(s.sum()))) % 4
    return np.delete(t, np.nonzero(rng.random(len(t)) < dele)[0])


def _pair(rng, lo, hi, snp, dele):
    """scripts/segk_profile.py's generator: random query, target = query
    with SNPs and single-base deletions."""
    q = rng.integers(0, 4, int(rng.integers(lo, hi))).astype(np.uint8)
    return ACGT[q].tobytes(), ACGT[_mutate(rng, q, snp, dele)].tobytes()


def _patch(rng, lo, hi, snp, head):
    from wfmash_tpu_torch.align.wfa_np import EndsFree

    q, t = _pair(rng, lo, hi, snp, 0.005)
    if head:
        return q, t, EndsFree(target_begin=len(t), query_begin=len(q))
    return q, t, EndsFree(target_end=len(t), query_end=len(q))


def _skewed(rng, lo, hi, cut):
    q, t = _pair(rng, lo, hi, 0.03, 0.005)
    a = int(rng.integers(0, len(t) - cut))
    return q, t[:a] + t[a + cut:], None


def _odd_bytes(rng, lo, hi):
    """A pair with IUPAC bytes (R, Y) beside ACGTN: the chunk remap path."""
    q, t = _pair(rng, lo, hi, 0.04, 0.01)
    qa = bytearray(q)
    ta = bytearray(t)
    for arr in (qa, ta):
        for pos in rng.integers(0, len(arr), 4):
            arr[int(pos)] = b"NRY"[int(rng.integers(0, 3))]
    return bytes(qa), bytes(ta), None


def tier_jobs(rng, tier_no):
    """(jobs, max_scores) for one tier's chunk: the main path's piece mix
    at that tier's envelope, plus capped jobs, patches, skew, odd bytes."""
    jobs, caps = [], []

    def add(n, make, cap=None):
        for _ in range(n):
            j = make()
            jobs.append(j if len(j) == 3 else (j[0], j[1], None))
            caps.append(cap)

    if tier_no == 0:
        add(3900, lambda: _pair(rng, 200, 340, 0.05, 0.01))
        add(40, lambda: _patch(rng, 100, 200, 0.06, True))
        add(40, lambda: _patch(rng, 100, 200, 0.06, False))
        add(40, lambda: _skewed(rng, 250, 340, 40))
        add(40, lambda: _pair(rng, 200, 340, 0.05, 0.01), cap=40)
        add(20, lambda: _odd_bytes(rng, 150, 300))
    elif tier_no == 1:
        add(600, lambda: _pair(rng, 300, 480, 0.10, 0.02))
        add(150, lambda: _pair(rng, 400, 470, 0.15, 0.0))   # > 128 runs
        add(150, lambda: _skewed(rng, 380, 480, 80))
        add(80, lambda: _patch(rng, 200, 400, 0.08, True))
        add(44, lambda: _pair(rng, 300, 480, 0.10, 0.02), cap=150)
    elif tier_no == 2:
        add(350, lambda: _pair(rng, 1000, 1900, 0.05, 0.01))
        add(100, lambda: _patch(rng, 800, 1900, 0.03, False))
        add(62, lambda: _pair(rng, 1200, 1900, 0.09, 0.01))  # > 128 runs
    elif tier_no == 3:
        add(128, lambda: _patch(rng, 2000, 4000, 0.02, True))
        add(128, lambda: _pair(rng, 2000, 4000, 0.02, 0.005))
    else:
        add(400, lambda: _pair(rng, 500, 1000, 0.20, 0.02))
        add(112, lambda: _pair(rng, 600, 1000, 0.12, 0.0))  # > 128 runs
    return jobs, caps


def spec_jobs(rng):
    """The tiered solver's mix for the wfa_np check (phase 4)."""
    from wfmash_tpu_torch.align.wfa_np import EndsFree

    jobs = [(*_pair(rng, 200, 340, 0.05, 0.01), None) for _ in range(170)]
    jobs += [_patch(rng, 100, 200, 0.06, bool(i % 2)) for i in range(20)]
    jobs += [_skewed(rng, 250, 400, 60) for _ in range(10)]
    jobs += [_odd_bytes(rng, 150, 300) for _ in range(10)]
    jobs += [(*_pair(rng, 400, 460, 0.15, 0.0), None) for _ in range(8)]
    jobs += [(*_pair(rng, 900, 1400, 0.05, 0.01), None) for _ in range(6)]
    jobs += [(*_pair(rng, 500, 700, 0.22, 0.02), None) for _ in range(3)]
    q, t = _pair(rng, 200, 300, 0.05, 0.01)
    jobs += [(b"", t, None), (q, b"", None), (b"", b"", None),
             (b"", t, EndsFree(target_begin=len(t)))]
    return jobs


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def build_phase():
    """Both nvcc builds and the five g++ builds, all started together."""
    from wfmash_tpu_torch import _build, native
    from wfmash_tpu_torch.align import wfa_seg, wfa_sweep

    def timed(fn):
        t0 = time.monotonic()
        got = fn()
        return got, time.monotonic() - t0

    builds = dict(seg_wfa=wfa_seg._lib, sweep_wfa=wfa_sweep._lib,
                  winnow=native.get_lib, l1l2=native.get_l1l2_lib,
                  anchors=native.get_anchors_lib, wfa=native.get_wfa_lib,
                  segsolve=native.get_segsolve_lib)
    t0 = time.monotonic()
    with ThreadPoolExecutor(len(builds)) as pool:
        futs = {k: pool.submit(timed, fn) for k, fn in builds.items()}
        done = {k: f.result() for k, f in futs.items()}
    wall = time.monotonic() - t0
    for name in ("seg_wfa", "sweep_wfa"):
        for line in _build.ptxas_report.get(name, "").splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"[build] ptxas {name}: {line.strip()}")
    missing = [k for k, (lib, _) in done.items() if lib is None]
    if missing:
        raise RuntimeError(f"libraries failed to build: {missing}")
    log("[build] " + ", ".join(f"{k} {t:.2f} s" for k, (_, t) in done.items())
        + f"; wall {wall:.2f} s")


def _cuda_ms(fn, reps):
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


def _bound(bytes_ms, ops_ms):
    """The larger of the two least times, with its name."""
    if bytes_ms >= ops_ms:
        return f"{bytes_ms:.4f} ms by bytes"
    return f"{ops_ms:.4f} ms by operations"


def _wavefront_lanes(lo0, hi0, levels, K):
    """Lanes computed by levels 0 .. levels - 1 of a wavefront seeded on
    lanes lo0 .. hi0 that widens by one lane a side per level inside a
    band of K lanes; arrays, one entry a problem."""
    total = 0
    for lo, hi, n in zip(lo0.tolist(), hi0.tolist(), levels.tolist()):
        s = np.arange(n, dtype=np.int64)
        total += int((np.minimum(K - 1, hi + s) - np.maximum(0, lo - s)
                      + 1).clip(min=0).sum())
    return total


def _diff(a, b):
    """(max abs difference, rows differing) of two (runs_full, out16)
    pairs, term col 8 (per-problem swept levels) aside."""
    keep = [j for j in range(a[1].shape[1]) if j != 8]
    d_runs = (a[0].long().cpu() - b[0].long().cpu()).abs()
    d_out = (a[1][:, keep].long().cpu() - b[1][:, keep].long().cpu()).abs()
    err = max(int(d_runs.max()), int(d_out.max()))
    return err, int((d_runs.sum(1) + d_out.sum(1) > 0).sum())


def tier_phase(p, dev, rng):
    """Kernel vs plain version on one full chunk per tier: the plain
    version runs on the card (its time is the one reported) and, through
    run_seg's CPU path, on a CPU copy of the same buffer."""
    import torch

    from wfmash_tpu_torch.align import wfa_seg

    solver = wfa_seg.TieredSegmentSolver(p, dev)
    rows = []
    for no, tier in enumerate(solver.tiers):
        jobs, caps = tier_jobs(rng, no)
        idxs = [i for i, (q, t, ef) in enumerate(jobs)
                if tier.accepts(len(q), len(t), ef)][:tier.max_call]
        buf_np, _ = tier.pack_chunk(idxs, jobs, caps)
        buf = torch.from_numpy(buf_np).to(dev)
        kw = dict(penalties=p, K=tier.K, smax=tier.smax, maxr=tier.maxr)
        _cuda_ms(lambda: wfa_seg.run_seg(buf, **kw), 1)      # first launch
        k_ms, kern = _cuda_ms(lambda: wfa_seg.run_seg(buf, **kw), 3)
        p_ms, plain = _cuda_ms(
            lambda: wfa_seg.seg_sweep_torch(buf, **kw), 1)
        t0 = time.monotonic()
        plain_cpu = wfa_seg.run_seg(buf.cpu(), **kw)
        c_ms = (time.monotonic() - t0) * 1e3
        err, n_bad = _diff(kern, plain)
        err_c, n_bad_c = _diff(kern, plain_cpu)
        term = kern[1][:, :16].cpu().numpy()
        used = (tier.maxr - 1) - term[:, 4].astype(np.int64)
        # swept cells: each problem's wavefront lanes x 5 states; level 0
        # seeds the begin-free diagonals -tb .. qb around diagonal c
        par = buf_np[:, -64:].copy().view("<i4").astype(np.int64)
        mid_lane = tier.K // 2 + par[:, 3]
        lanes = _wavefront_lanes(
            np.clip(mid_lane - par[:, 4], 0, tier.K - 1),
            np.clip(mid_lane + par[:, 5], 0, tier.K - 1),
            term[:, 8].astype(np.int64), tier.K)
        cells = lanes * 5
        # the least the card could take: chunk buffer read once, both
        # outputs and every swept history cell (int16) written once; the
        # recurrences' 32-bit operations on the swept lanes
        nbytes = (buf.numel() + kern[0].numel() * 4 + kern[1].numel() * 2
                  + cells * 2)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = lanes * SEG_OPS_PER_LANE / INT_OPS_PER_S * 1e3
        log(f"[tier t{no + 1}] K={tier.K} smax={tier.smax} "
            f"lseg={tier.lseg} rows={buf.shape[0]} jobs={len(idxs)} "
            f"done={int(term[:len(idxs), 0].sum())} "
            f"max_runs={int(used.max())} levels="
            f"{int(term[:, 8].astype(np.int64).sum())} lanes={lanes} "
            f"kernel {k_ms:.3f} ms "
            f"({cells / k_ms / 1e6:.2f} Gcells/s; bound {_bound(bytes_ms, ops_ms)}"
            f"), plain on the card "
            f"{p_ms:.3f} ms (rows differing {n_bad}, max_abs_err {err}), "
            f"plain on a CPU copy {c_ms:.1f} ms (rows differing {n_bad_c}, "
            f"max_abs_err {err_c})")
        if n_bad or n_bad_c:
            raise RuntimeError(f"tier t{no + 1}: kernel and plain version "
                               f"disagree on {max(n_bad, n_bad_c)} rows")
        rows.append(dict(tier=no + 1, ms=k_ms, plain_ms=p_ms,
                         err=max(err, err_c), bytes_ms=bytes_ms,
                         ops_ms=ops_ms))
    return rows


def spec_phase(p, dev, rng):
    """The tiered solver on the card against the wfa_np spec."""
    from wfmash_tpu_torch.align.wfa_np import wfa_align
    from wfmash_tpu_torch.align import wfa_seg

    jobs = spec_jobs(rng)
    solver = wfa_seg.TieredSegmentSolver(p, dev)
    status: list = []
    got = solver.solve(jobs, status=status)
    n_ok = n_long = 0
    t0 = time.monotonic()
    for (q, t, ef), ops, st in zip(jobs, got, status):
        if ops is None:
            continue
        _, ref = wfa_align(q, t, p, ef)
        if ops != ref:
            raise RuntimeError(f"CIGAR differs from wfa_np on a "
                               f"{len(q)}x{len(t)} job ({st})")
        n_ok += 1
        n_long += len(ops) > wfa_seg.RUNS_CAP
    log(f"[spec] {n_ok}/{len(jobs)} ok CIGARs equal wfa_np's "
        f"({n_long} with > {wfa_seg.RUNS_CAP} runs; statuses "
        f"{sorted({s[0] for s in status})}; check {time.monotonic() - t0:.1f}"
        f" s)")
    if n_ok < MIN_SPEC_CHECKS or n_long == 0:
        raise RuntimeError(f"spec check covered {n_ok} jobs, {n_long} long")


# span-ladder steps of the exact engine: (K, shortest, longest block)
SWEEP_STEPS = ((256, 1000, 2000), (512, 2000, 4000), (1024, 4000, 8000),
               (2048, 8000, 16000), (4096, 16000, 48000))
SWEEP_BATCH = 128
SWEEP_MAX_S = 30000


def _sweep_inputs(pairs, K, flip_axis=()):
    """The arrays ExactWfaEngine._sweep_batch hands the sweep for these
    (query, target) byte pairs; rows in flip_axis split the shorter
    axis."""
    from wfmash_tpu_torch.align.wfa_exact import _lcp_np
    from wfmash_tpu_torch.align.wfa_sweep import NEG_I, UNSET32

    B = len(pairs)
    qlen = np.array([len(q) for q, _ in pairs], np.int32)
    tlen = np.array([len(t) for _, t in pairs], np.int32)
    L = -(-(int(max(qlen.max(), tlen.max())) + 8) // 64) * 64
    query = np.full((B, L), 0x01, np.uint8)
    target = np.full((B, L), 0x02, np.uint8)
    lcp = np.zeros(B, np.int32)
    for i, (q, t) in enumerate(pairs):
        query[i, :len(q)] = np.frombuffer(q, np.uint8)
        target[i, :len(t)] = np.frombuffer(t, np.uint8)
        lcp[i] = _lcp_np(query[i, :len(q)], target[i, :len(t)])
    axis_q = qlen > tlen
    axis_q[list(flip_axis)] ^= True
    mid = np.where(axis_q, qlen // 2, tlen // 2).astype(np.int32)
    done0 = (lcp >= qlen) & (lcp >= tlen)
    seed_off = np.full((B, K), NEG_I, np.int32)
    seed_anc = np.full((B, K), UNSET32, np.uint32)
    seed_off[:, K // 2] = lcp
    cr = ~done0 & (lcp > mid)
    seed_anc[cr, K // 2] = (mid[cr].astype(np.uint32) << 16) \
        | mid[cr].astype(np.uint32)
    par = np.zeros((B, 8), np.int32)
    par[:, 0], par[:, 1], par[:, 2], par[:, 3], par[:, 4] = (
        qlen, tlen, axis_q, mid, done0)
    return dict(query=query, target=target, par=par, seed_off=seed_off,
                seed_anc=seed_anc.view(np.int32), done0=done0)


def _edge_pairs(rng, n):
    """Balanced 300 bp out-and-back excursions (|m - n| = 0): the path
    leaves a K = 512 band, as tests/test_wfa_pallas.py builds it."""
    out = []
    for _ in range(n):
        s = ACGT[rng.integers(0, 4, 700)].tobytes()
        ins = ACGT[rng.integers(0, 4, 300)].tobytes()
        jns = ACGT[rng.integers(0, 4, 300)].tobytes()
        out.append((s[:200] + ins + s[200:], s[:500] + jns + s[500:]))
    return out


def sweep_phase(p, dev, rng):
    """Sweep kernel vs plain version on the card, one batch per ladder
    step and one band-edge batch: all five outputs equal, exactly."""
    import torch

    from wfmash_tpu_torch.align import wfa_sweep

    batches = []
    for K, lo, hi in SWEEP_STEPS:
        pairs = [_pair(rng, lo, hi, float(rng.uniform(0.02, 0.05)), 0.002)
                 for _ in range(SWEEP_BATCH)]
        for i in (5, 77):                       # solved before the sweep
            pairs[i] = (pairs[i][0], pairs[i][0])
        batches.append((f"K={K}", K, pairs, range(0, SWEEP_BATCH, 3)))
    batches.append(("edge K=512", 512, _edge_pairs(rng, 8), (1, 4)))
    rows = []
    for name, K, pairs, flip in batches:
        d = _sweep_inputs(pairs, K, flip)
        ten = {k: torch.from_numpy(v).to(dev) for k, v in d.items()
               if k != "done0"}
        kw = dict(penalties=p, K=K, max_s=SWEEP_MAX_S)
        _cuda_ms(lambda: wfa_sweep.run_sweep(**ten, **kw), 1)  # first launch
        k_ms, kern = _cuda_ms(lambda: wfa_sweep.run_sweep(**ten, **kw), 3)
        p_ms, plain = _cuda_ms(lambda: wfa_sweep.sweep_torch(**ten, **kw), 1)
        kern, plain = kern.cpu().numpy(), plain.cpu().numpy()
        keep = ~d["done0"]
        diff = np.abs(kern[:, :4].astype(np.int64)
                      - plain[:, :4].astype(np.int64))
        n_bad = int((diff.sum(1) > 0).sum())
        levels = int(kern[:, 4].astype(np.int64).sum())
        lanes = int(wfa_sweep.term_lanes(kern).sum())
        if lanes != int(wfa_sweep.term_lanes(plain).sum()):
            raise RuntimeError(f"sweep {name}: kernel and plain version "
                               "count different wavefront lanes")
        n_axis_q = int(d["par"][keep, 2].sum())
        # the least the card could take: every input read and the term
        # rows written once (the rings are scratch and do not count); the
        # recurrences' 32-bit operations on the swept lanes
        nbytes = sum(t.numel() * t.element_size() for t in ten.values()) \
            + kern.nbytes
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = lanes * SWEEP_OPS_PER_LANE / INT_OPS_PER_S * 1e3
        log(f"[sweep {name}] B={len(pairs)} L={d['query'].shape[1]} "
            f"lengths {int(d['par'][:, 0].min())}-"
            f"{int(d['par'][:, 0].max())} done0={int(d['done0'].sum())} "
            f"query-axis={n_axis_q} finished={int(kern[keep, 0].sum())} "
            f"clipped={int(kern[:, 3].sum())} max_score="
            f"{int(kern[:, 1].max())} levels={levels} lanes={lanes} kernel "
            f"{k_ms:.3f} ms ({lanes * 5 / k_ms / 1e6:.2f} Gcells/s, "
            f"{int(kern[:, 4].max()) and k_ms * 1e3 / int(kern[:, 4].max()):.2f}"
            f" us a level of the deepest problem, ring traffic "
            f"{lanes * SWEEP_RING_BYTES_PER_LANE / k_ms / 1e9:.2f} TB/s; "
            f"bound {_bound(bytes_ms, ops_ms)}), plain "
            f"on the card {p_ms:.1f} ms (rows differing {n_bad}, "
            f"max_abs_err {int(diff.max())})")
        if n_bad:
            raise RuntimeError(f"sweep {name}: kernel and plain version "
                               f"disagree on {n_bad} rows")
        if not kern[keep, 0].all() or (kern[keep, 2] == -1).any():
            raise RuntimeError(f"sweep {name}: unfinished problems or "
                               "missing anchors")
        if name.startswith("edge") and not kern[:, 3].all():
            raise RuntimeError("the band-edge batch did not touch the edge")
        rows.append(dict(name=name, ms=k_ms, plain_ms=p_ms,
                         err=int(diff.max()), bytes_ms=bytes_ms,
                         ops_ms=ops_ms))
    return rows


def _block(rng, n, snp, indel):
    """A (query, target) block of ~n bp: SNPs, single-base deletions and
    one deletion of `indel` bp in the target."""
    q, t = _pair(rng, n, n + 1, snp, 0.002)
    a = int(rng.integers(n // 4, n // 2))
    return q, t[:a] + t[a + indel:]


def exact_phase(p, dev, rng):
    """ExactWfaEngine.align_batch on seeded blocks: CIGARs replay and
    score what the native exact WFA scores."""
    import torch

    from wfmash_tpu_torch.align import cigar as C
    from wfmash_tpu_torch.align import wfa_seg, wfa_sweep
    from wfmash_tpu_torch.align.wfa_exact import ExactWfaEngine
    from wfmash_tpu_torch.align.wfa_np import score_cigar
    from wfmash_tpu_torch.align.wfa_vec import wfa_align

    sizes = (2000, 3000, 5000, 8000, 12000, 16000, 20000, 26000, 32000,
             40000)
    jobs = [(*_block(rng, n, float(rng.uniform(0.02, 0.05)) if n <= 20000
                     else 0.02, int(rng.integers(150, 500))), None)
            for n in sizes for _ in range(2)]
    eng = ExactWfaEngine(p, dev)
    wfa_sweep.LAUNCHES = wfa_seg.LAUNCHES = 0
    t0 = time.monotonic()
    got = eng.align_batch(jobs)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    n_sweep, n_seg = wfa_sweep.LAUNCHES, wfa_seg.LAUNCHES
    t0 = time.monotonic()
    scores = []
    for (q, t, _), ops in zip(jobs, got):
        if not C.validate(ops, q, t, 0, 0):
            raise RuntimeError(f"exact engine: CIGAR of a {len(q)}x{len(t)} "
                               "block does not replay")
        want, _ = wfa_align(q, t, p)
        if score_cigar(ops, p) != want:
            raise RuntimeError(f"exact engine: score {score_cigar(ops, p)} "
                               f"!= native exact {want} on {len(q)}x{len(t)}")
        scores.append(want)
    log(f"[exact] {len(jobs)} blocks of {sizes[0]}-{sizes[-1]} bp: all "
        f"CIGARs replay with the native exact scores ({min(scores)}-"
        f"{max(scores)}); align_batch {wall:.2f} s, sweep_wfa launches "
        f"{n_sweep}, seg_wfa launches {n_seg}, swept levels "
        f"{eng.sweeps.levels}, wavefront lanes {eng.sweeps.lanes}; native check {time.monotonic() - t0:.1f} s")
    if n_sweep == 0:
        raise RuntimeError("the exact engine never launched sweep_wfa")


def write_pair(tmp, bp):
    """The synthetic pair of tests/test_scale.py as bgzf FASTA files."""
    from scale_demo import make_pair, write_fasta_bgzf

    anc, der = make_pair(bp, seed=42)
    pt, pq = os.path.join(tmp, "anc.fa.gz"), os.path.join(tmp, "der.fa.gz")
    write_fasta_bgzf(pt, "anc", anc)
    write_fasta_bgzf(pq, "der", der)
    return pt, pq, ACGT[anc].tobytes(), ACGT[der].tobytes()


def _busy_share(tag, run):
    """A second run of the same command under torch.profiler: the card's
    time by kernel, and its share of the run's wall (reported, not gated;
    the profiled run's output is discarded)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with open(os.devnull, "w") as fh, contextlib.redirect_stdout(fh), \
            profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3
    by_name: dict = {}
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        name = next((k for k in ("seg_wfa", "sweep_wfa", "Memcpy")
                     if k in ev.key), "other")
        ms, n = by_name.get(name, (0.0, 0))
        by_name[name] = (ms + us / 1e3, n + ev.count)
    busy = sum(ms for ms, _ in by_name.values())
    if not by_name:
        log(f"[{tag}] device time: not measured (the profiler saw no "
            "device activity)")
        return
    log(f"[{tag}] profiled run: wall {wall_ms:.0f} ms, device time "
        f"{busy:.3f} ms ({100 * busy / wall_ms:.2f}% of the wall): "
        + ", ".join(f"{k} {ms:.3f} ms in {n}" for k, (ms, n)
                    in sorted(by_name.items())))


@contextlib.contextmanager
def _engine_switch(segmented):
    """WFMASH_TPU_SEGMENTED set for the default path or for the exact
    engine alone, and taken out again."""
    os.environ["WFMASH_TPU_SEGMENTED"] = "auto" if segmented else "0"
    try:
        yield
    finally:
        del os.environ["WFMASH_TPU_SEGMENTED"]


def e2e_phase(tmp, pair, segmented=True):
    """The port's CLI in-process on the pair of write_pair: the default
    path, or ExactWfaEngine alone (WFMASH_TPU_SEGMENTED=0). Returns the
    launches of (seg_wfa, sweep_wfa), both counted from 0."""
    import torch

    from wfmash_tpu_torch import cli
    from wfmash_tpu_torch.align import cigar as C
    from wfmash_tpu_torch.align import wfa_seg, wfa_sweep
    from wfmash_tpu_torch.sketch.kmers import reverse_complement
    from wfmash_tpu_torch.utils import perf

    pt, pq, anc_b, der_b = pair
    tag = "e2e" if segmented else "e2e SEGMENTED=0"
    out_paf = os.path.join(tmp, f"out{int(segmented)}.paf")
    perf.reset()
    wfa_seg.LAUNCHES = wfa_sweep.LAUNCHES = 0
    t0 = time.monotonic()
    with open(out_paf, "w") as fh, contextlib.redirect_stdout(fh), \
            _engine_switch(segmented):
        rc = cli.main([pt, pq, "-t", "1"])
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = (wfa_seg.LAUNCHES, wfa_sweep.LAUNCHES)
    log(f"[{tag}] {len(anc_b) / 1e6:g} Mb pair: exit {rc}, wall {wall:.2f} "
        f"s, seg_wfa launches {launches[0]}, sweep_wfa launches "
        f"{launches[1]}")
    log(f"[{tag}] counters: " + ", ".join(
        f"{k} {v:.3f}" for k, v in sorted(perf.snapshot().items())))
    gate = launches[0] if segmented else launches[1]
    if rc != 0 or gate == 0:
        raise RuntimeError(f"CLI exit {rc}, launches {launches}")

    rows = [ln for ln in open(out_paf) if "\tcg:Z:" in ln]
    if not rows:
        raise RuntimeError("no aligned rows")
    der_rc = bytes(reverse_complement(np.frombuffer(der_b, np.uint8)))
    pick = np.random.default_rng(0).choice(
        len(rows), min(N_SAMPLE, len(rows)), replace=False)
    for i in pick:
        f = rows[int(i)].rstrip("\n").split("\t")
        ops = C.parse(next(c[5:] for c in f[12:] if c.startswith("cg:Z:")))
        qs, qe, ts = int(f[2]), int(f[3]), int(f[7])
        q, q_start = (der_rc, len(der_b) - qe) if f[4] == "-" else (der_b, qs)
        if not C.validate(ops, q, anc_b, q_start, ts):
            raise RuntimeError(f"CIGAR replay failed on row {i}")
    iv = sorted((int(ln.split("\t")[2]), int(ln.split("\t")[3]))
                for ln in rows)
    cov = end = 0
    for a, b in iv:
        a = max(a, end)
        if b > a:
            cov += b - a
            end = b
    cov_frac = cov / len(der_b)
    log(f"[{tag}] {len(rows)} rows, {len(pick)} sampled CIGARs replay "
        f"exactly, query coverage {cov_frac:.4f}")
    if cov_frac < MIN_COVERAGE:
        raise RuntimeError(f"coverage {cov_frac:.4f} < {MIN_COVERAGE}")
    with _engine_switch(segmented):
        _busy_share(tag, lambda: cli.main([pt, pq, "-t", "1"]))
    return launches


def kernel_row(name, replaces, launches, rows):
    """One entry of the kernel table from a phase's per-shape rows."""
    bytes_ms = sum(r["bytes_ms"] for r in rows)
    ops_ms = sum(r["ops_ms"] for r in rows)
    return dict(
        name=name, route="cuda", source=f"wfmash_tpu_torch/csrc/{name}.cu",
        replaces=replaces, launches=launches,
        max_abs_err=max(r["err"] for r in rows),
        ms=sum(r["ms"] for r in rows),
        plain_ms=sum(r["plain_ms"] for r in rows),
        bound_ms=max(bytes_ms, ops_ms),
        bound_by="bytes" if bytes_ms >= ops_ms else "operations",
        library_ms=None)


E2E_BP = 6_000_000     # the end-to-end pair's size
PHASES = ("tiers", "spec", "sweep", "exact", "e2e", "e2e0")


def main(argv=None) -> int:
    """`--phases a,b` runs a subset (the build always runs) while a
    kernel is being worked on; only a run of every phase prints the
    kernel table and the result line."""
    import argparse

    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default=",".join(PHASES))
    args = ap.parse_args(argv)
    phases = args.phases.split(",")
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    card = card_line()
    log(f"[card] {card}")
    from wfmash_tpu_torch.align.wfa_np import Penalties

    dev = torch.device("cuda")
    p = Penalties(5, 8, 2, 24, 1)    # the align path's defaults (params.py)
    rng = np.random.default_rng(SEED)
    build_phase()
    tiers = tier_phase(p, dev, rng) if "tiers" in phases else None
    if "spec" in phases:
        spec_phase(p, dev, rng)
    sweeps = sweep_phase(p, dev, rng) if "sweep" in phases else None
    if "exact" in phases:
        exact_phase(p, dev, rng)
    seg_launches = sweep_launches = None
    with tempfile.TemporaryDirectory() as tmp:
        if "e2e" in phases or "e2e0" in phases:
            pair = write_pair(tmp, E2E_BP)
        if "e2e" in phases:
            seg_launches, _ = e2e_phase(tmp, pair)
        if "e2e0" in phases:
            _, sweep_launches = e2e_phase(tmp, pair, segmented=False)
    if set(phases) != set(PHASES):
        log(f"partial run ({args.phases}): no result line")
        return 0
    kernels = [
        kernel_row("seg_wfa", "wfmash_tpu/align/wfa_pallas_seg.py:109",
                   seg_launches, tiers),
        kernel_row("sweep_wfa", "wfmash_tpu/align/wfa_pallas.py:140",
                   sweep_launches, sweeps)]
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
