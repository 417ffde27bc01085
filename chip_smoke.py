"""Smoke run of the PyTorch/CUDA port on one GPU: `python3 chip_smoke.py`.

Phases (any failure exits non-zero; nothing is caught):
1. the card's name and power limit; a CUDA device is required;
2. build the two CUDA kernels (nvcc) and the five native host libraries
   (g++), all started together;
3. per segment tier, one full chunk of generated jobs packed by the port's
   pack_chunk: the segment kernel and its plain PyTorch version (on the
   card, and on a CPU copy of every fourth row) must agree byte for byte
   (term col 8, the per-problem level counter, aside);
4. the tiered solver on the card: every `ok` CIGAR must equal wfa_np's;
5. per span-ladder step K = 256..4096, one seeded batch (both split axes,
   some problems solved before the sweep) and one batch built to touch
   the band edge, then one batch of 65534 bp problems (the 16-bit edge of
   the ring words), one cut short, one under a second penalty set, one
   under penalties that send the shape to the global-ring kernel, one
   along the outermost block boundaries of each cluster size and one of
   long near-identical blocks (`sweep_batches`): the sweep
   kernel and its plain PyTorch version on the card must agree exactly on
   all five outputs, each line says which kernel the shape took
   (wfa_sweep.kernel_choice) and how many problems the card holds at
   once, and the ladder's steps must take the shared-memory kernel as one
   block (K <= 512) or a cluster of 2, 4, 8;
6. ExactWfaEngine.align_batch on seeded 2-40 kb blocks: every CIGAR
   replays and scores the native exact WFA's score; the sweep kernel must
   have launched;
7. the mapping's device stages on the 6 Mb synthetic pair of
   tests/test_scale.py with the CLI's default parameters: every fragment
   of the query through DeviceL1.candidates and every candidate through
   DeviceL2.walk on the card. Every row the device answers must equal the
   native host stage's answer and the same torch program's on CPU
   tensors, and at least 90% of the fragments and of the candidates must
   be answered by the device and not left to the host. These are torch
   programs, not hand-written kernels: they are not in the kernel table;
8. the CLI (`wfmash_tpu_torch target.fa query.fa -t 1`) in-process on the
   same pair, once on the default path (SegmentedEngine) and once with
   WFMASH_TPU_SEGMENTED=0 (ExactWfaEngine alone), mapping through the
   device stages as is the default on a card: exit 0, kernel launches
   counted from 0 for each run, device L1 and L2 calls counted, sampled
   CIGARs replay exactly, query coverage >= 0.95, the PAF byte-equal to
   that of one more run with WFMASH_TPU_DEVICE_L1=0 (host mapping) and,
   on the default path, to that of a run with `-t 4` (forked workers
   beside the CUDA context);
9. the multi-device paths (wfmash_tpu_torch/parallel/) over eight logical
   shards of cuda:0, and over the machine's cards too where it has more
   than one: one chunk of every tier split over the shards (kernel A
   launched once a shard, runs and out16 byte-equal to the unsharded
   solve), ShardedDeviceL1 over a (2, 4) mesh on every fragment of the
   pair (equal to the native host stage where it answers, rows left to
   the host by the reference's rule), diagonal_sharded_wfa_steps (K =
   2048) and data_parallel_wfa_steps bit-equal to advance_torch
   unsharded, the CLI with WFMASH_TPU_DEVICE_L1=mesh and
   WFMASH_TPU_ALIGN_MESH=force (PAF byte-equal to the default run's, more
   than 15 kernel-A launches, replay and coverage), entry() and
   dryrun_multichip(8);
10. golden: every case of tests/torch_golden/manifest.json, output bytes
   that the JAX package's CLI wrote on the CPU (scripts/torch_golden.py):
   each case's inputs made anew with this file's copy of the generators
   (a hash other than the manifest's is "input drift", not a fault of the
   port), the port's CLI in-process on the card, mapping through the
   device stages, and its output byte-equal to the golden (M1 also with
   WFMASH_TPU_DEVICE_L1=0; A0 is the e2e phase's own run, the same argv
   and inputs); kernel A launched in A0-A2, kernel B in A3, and the port's
   tiers t3-t5 and sweep spans K >= 1024 reached where the reference's
   were. This file reads the goldens as data and imports nothing of the
   JAX package. The cases of the scale phase are left to it;
11. scale: the port's CLI on the card at the size its users run, the
   manifest's cases B1 and B0 (the 100 Mb pair of scripts/scale_demo.py,
   mapped; aligned), Y1 and Y2 (a yeast-sized 8-genome PanSN pangenome:
   upstream's yeast mapping test; its S288C/Y12 pair aligned). B1, Y1
   and Y2 run in this process and must write the golden bytes, Y1 cover
   each sequence >= 0.89, Y2 replay every CIGAR and align > 11 Mb; B0
   runs in a process of its own and meets scale_demo.py's gates (peak RSS
   <= 8 GB, 200 sampled CIGARs replay, coverage >= 0.95, kernel A
   launched) and the sha256 of the reference's output; B0's alignment
   alone runs once more, from B1's PAF (`-i`), under torch.profiler for
   the card's busy share while it aligns (reported only).
   Each case prints a `[scale <case>]` line (walls, rows, launches and
   CUDA-event ms of both kernels, device L1/L2 calls and the rows left to
   the host, the index's bytes, peak device memory, B0's peak RSS and its
   RSS over the run).
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
import dataclasses
import hashlib
import io
import json
import os
import re
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
MIN_DEVICE_SHARE = 0.90    # of fragments (L1) and candidates (L2)
# the segment kernel's plain version runs on the card on every row of a
# tier's chunk, and through run_seg's CPU path on every fourth row (a
# row is one problem; the whole chunk took 27-94 s a tier on the CPU)
CPU_COPY_STRIDE = 4

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
# 32-bit ring words the global-ring sweep kernel loads (22) and stores (14)
# per lane and level (the shared-memory kernel has no such traffic)
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
    run_seg's CPU path, on a CPU copy of every fourth row of that buffer."""
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
        plain_cpu = wfa_seg.run_seg(
            buf[::CPU_COPY_STRIDE].contiguous().cpu(), **kw)
        c_ms = (time.monotonic() - t0) * 1e3
        err, n_bad = _diff(kern, plain)
        err_c, n_bad_c = _diff([a[::CPU_COPY_STRIDE] for a in kern],
                               plain_cpu)
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
            f"plain on a CPU copy of every {CPU_COPY_STRIDE}th row "
            f"{c_ms:.1f} ms (rows differing {n_bad_c}, "
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
SWEEP_CUT_S = 1400     # max_s of the batch that is cut short
# the kernel each batch must take: blocks of the cluster that holds the
# rings in shared memory, 0 for the global-ring kernel
SWEEP_KERNELS = {"K=256": 1, "K=512": 1, "K=1024": 2, "K=2048": 4,
                 "K=4096": 8, "deep-ring K=512": 0, "boundary K=1024": 2,
                 "boundary K=2048": 4, "boundary K=4096": 8}


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


def _longest_pairs(rng, n):
    """Queries of 65534 bases, the longest the sweep takes, against targets
    with a few substitutions, one deletion of 5-12 bases in the middle and
    a shorter run of extra bases at the end: few levels, and M cells at
    offset 65534 beside the end diagonal whose insertion cells pass what
    a 16-bit ring word holds."""
    out = []
    for _ in range(n):
        q = rng.integers(0, 4, 65534).astype(np.uint8)
        t = q.copy()
        for pos in rng.integers(100, 65000, int(rng.integers(2, 6))):
            t[pos] = (t[pos] + rng.integers(1, 4)) % 4
        cut = int(rng.integers(5, 13))
        a = int(rng.integers(20000, 40000))
        tail = rng.integers(0, 4, int(rng.integers(3, cut))).astype(np.uint8)
        t = np.concatenate([t[:a], t[a + cut:], tail])
        out.append((ACGT[q].tobytes(), ACGT[t].tobytes()))
    return out


# penalties whose rings exceed a block's shared memory at 512 lanes
# ((6 * 66 + 32 * 3) * 512 B = 246 KiB): the global-ring kernel's shape
DEEP_RING_PENALTIES = (5, 8, 2, 64, 1)
WFLIGN_PENALTIES = (2, 3, 1, 3, 1)


def _boundary_pairs(rng, n, K):
    """Problems whose paths run along the first or the last block boundary
    of a K-lane cluster (lanes 511/512 and K - 513/K - 512), on alternate
    sides: one gap of about K / 2 - 512 bases carries the path there from
    the seed lane K / 2 (at K = 1024 the seed lane is that boundary), and
    SNPs and 1-3 base indels of both directions then take it to and fro
    across the boundary."""
    out = []
    for i in range(n):
        q = rng.integers(0, 4, int(rng.integers(3000, 5000))).astype(np.uint8)
        t = q.copy()
        s = rng.random(len(t)) < 0.02
        t[s] = (t[s] + rng.integers(1, 4, int(s.sum()))) % 4
        parts, at = [], 0
        for pos in np.nonzero(rng.random(len(t)) < 0.006)[0]:
            if pos < at:
                continue
            n_gap = int(rng.integers(1, 4))
            parts.append(t[at:pos])
            if rng.random() < 0.5:                      # extra target bases
                parts.append(rng.integers(0, 4, n_gap).astype(np.uint8))
                at = pos
            else:                                       # target bases lost
                at = pos + n_gap
        parts.append(t[at:])
        t = np.concatenate(parts)
        shift = K // 2 - 512 + int(rng.integers(-3, 4))
        a = int(rng.integers(300, 600))
        if shift > 0 and i % 2:         # towards lane K - 512
            t = np.concatenate([t[:a], t[a + shift:]])
        elif shift > 0:                 # towards lane 512
            t = np.concatenate([t[:a], rng.integers(0, 4, shift)
                                .astype(np.uint8), t[a:]])
        out.append((ACGT[q].tobytes(), ACGT[t].tobytes()))
    return out


def sweep_batches(rng, p):
    """The batches of `sweep_phase` as (name, K, pairs, rows that split the
    shorter axis, penalties, max_s), and how many of them are the ladder's
    (one per ladder step and the band-edge batch, under the align path's
    penalties p: the six timed since the kernel was first ported). Then
    one batch each at the 16-bit length limit, cut short at a level that
    is no multiple of a cluster's meeting interval, under a second penalty
    set, under penalties that send the shape to the global-ring kernel,
    along a cluster's outermost block boundaries at each cluster size, and
    of long near-identical blocks at the first ladder step."""
    from wfmash_tpu_torch.align.wfa_np import Penalties

    batches = []
    for K, lo, hi in SWEEP_STEPS:
        pairs = [_pair(rng, lo, hi, float(rng.uniform(0.02, 0.05)), 0.002)
                 for _ in range(SWEEP_BATCH)]
        for i in (5, 77):                       # solved before the sweep
            pairs[i] = (pairs[i][0], pairs[i][0])
        batches.append((f"K={K}", K, pairs, range(0, SWEEP_BATCH, 3), p,
                        SWEEP_MAX_S))
    batches.append(("edge K=512", 512, _edge_pairs(rng, 8), (1, 4), p,
                    SWEEP_MAX_S))
    n_ladder = len(batches)
    batches.append(("65534 bp K=256", 256, _longest_pairs(rng, 8), (1, 4, 6),
                    p, SWEEP_MAX_S))
    # some problems finish before the cut, the others report unfinished
    name, K, pairs, flip, _, _ = batches[2]
    batches.append((f"cut at {SWEEP_CUT_S} {name}", K, pairs[:64],
                    range(0, 64, 3), p, SWEEP_CUT_S))
    K, lo, hi = SWEEP_STEPS[1]
    for name, pen in (("wflign", WFLIGN_PENALTIES),
                      ("deep-ring", DEEP_RING_PENALTIES)):
        pairs = [_pair(rng, lo, hi, float(rng.uniform(0.02, 0.05)), 0.002)
                 for _ in range(SWEEP_BATCH // 2)]
        batches.append((f"{name} K={K}", K, pairs,
                        range(0, SWEEP_BATCH // 2, 3), Penalties(*pen),
                        SWEEP_MAX_S))
    for K in (1024, 2048, 4096):
        batches.append((f"boundary K={K}", K, _boundary_pairs(rng, 32, K),
                        range(0, 32, 3), p, SWEEP_MAX_S))
    pairs = [_pair(rng, 30000, 48000, 0.001, 0.0001)
             for _ in range(SWEEP_BATCH)]
    batches.append(("40 kb 0.1% K=256", 256, pairs,
                    range(0, SWEEP_BATCH, 3), p, SWEEP_MAX_S))
    return batches, n_ladder


def sweep_phase(p, dev, rng):
    """Sweep kernel vs plain version on the card, on every batch of
    `sweep_batches`. All five outputs equal, exactly. At shapes that take
    the shared-memory kernel the global-ring kernel is launched on the same
    inputs too, for its time beside the other's on this card, and held to
    the same outputs."""
    import torch

    from wfmash_tpu_torch.align import wfa_sweep

    batches, n_ladder = sweep_batches(rng, p)
    rows = []
    for name, K, pairs, flip, pen, max_s in batches:
        d = _sweep_inputs(pairs, K, flip)
        ten = {k: torch.from_numpy(v).to(dev) for k, v in d.items()
               if k != "done0"}
        kw = dict(penalties=pen, K=K, max_s=max_s)
        cluster = wfa_sweep.kernel_choice(pen, K)
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        _cuda_ms(lambda: wfa_sweep.run_sweep(**ten, **kw), 1)  # first launch
        scratch = torch.cuda.max_memory_allocated() - base
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
        deepest = int(kern[:, 4].max())
        # the least the card could take: every input read and the term
        # rows written once (the rings are scratch and do not count); the
        # recurrences' 32-bit operations on the swept lanes
        nbytes = sum(t.numel() * t.element_size() for t in ten.values()) \
            + kern.nbytes
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = lanes * SWEEP_OPS_PER_LANE / INT_OPS_PER_S * 1e3
        if cluster:
            took = (f"{wfa_sweep.kernel_name(cluster)} "
                    f"({wfa_sweep.active_clusters(pen, K)} problems at once, "
                    f"{scratch} B of scratch and outputs allocated)")
            g_ms, glob = _cuda_ms(lambda: wfa_sweep._launch(
                *ten.values(), pen, K, max_s, 0), 3)
            n_glob = int((glob.cpu().numpy() != kern).any(1).sum())
            if n_glob:
                raise RuntimeError(f"sweep {name}: the global-ring kernel "
                                   f"differs on {n_glob} rows")
            ring = (f"global-ring kernel {g_ms:.3f} ms on the same inputs "
                    "(equal outputs)")
        else:
            took = (f"{wfa_sweep.kernel_name(cluster)} ({scratch} B of "
                    "scratch and outputs allocated)")
            g_ms = None
            ring = (f"ring traffic "
                    f"{lanes * SWEEP_RING_BYTES_PER_LANE / k_ms / 1e9:.2f} "
                    "TB/s")
        log(f"[sweep {name}] {took}; penalties {dataclasses.astuple(pen)} "
            f"B={len(pairs)} L={d['query'].shape[1]} max_s={max_s} "
            f"lengths {int(d['par'][:, 0].min())}-"
            f"{int(d['par'][:, 0].max())} done0={int(d['done0'].sum())} "
            f"query-axis={n_axis_q} finished={int(kern[keep, 0].sum())} "
            f"clipped={int(kern[:, 3].sum())} max_score="
            f"{int(kern[:, 1].max())} levels={levels} lanes={lanes} kernel "
            f"{k_ms:.3f} ms ({lanes * 5 / k_ms / 1e6:.2f} Gcells/s, "
            f"{deepest and k_ms * 1e3 / deepest:.2f}"
            f" us a level of the deepest problem, {ring}; "
            f"bound {_bound(bytes_ms, ops_ms)}), plain "
            f"on the card {p_ms:.1f} ms (rows differing {n_bad}, "
            f"max_abs_err {int(diff.max())})")
        if n_bad:
            raise RuntimeError(f"sweep {name}: kernel and plain version "
                               f"disagree on {n_bad} rows")
        fin = kern[:, 0] != 0
        if max_s == SWEEP_MAX_S and not fin[keep].all():
            raise RuntimeError(f"sweep {name}: unfinished problems")
        if max_s != SWEEP_MAX_S and (fin[keep].all() or not fin.any()):
            raise RuntimeError(f"sweep {name}: the cut at level {max_s} "
                               "does not split the batch")
        if (kern[fin, 2] == -1).any():
            raise RuntimeError(f"sweep {name}: missing anchors")
        if name.startswith("edge") and not kern[:, 3].all():
            raise RuntimeError("the band-edge batch did not touch the edge")
        want = SWEEP_KERNELS.get(name)
        if want is not None and cluster != want:
            raise RuntimeError(f"sweep {name}: took "
                               f"{wfa_sweep.kernel_name(cluster)}")
        rows.append(dict(name=name, ms=k_ms, plain_ms=p_ms,
                         err=int(diff.max()), bytes_ms=bytes_ms,
                         ops_ms=ops_ms, global_ms=g_ms))
    def total(key, some):
        return sum(r[key] for r in some)

    first = rows[:n_ladder]
    log(f"[sweep] the ladder's {n_ladder} batches: kernel "
        f"{total('ms', first):.3f} ms, global-ring kernel "
        f"{total('global_ms', first):.3f} ms, bound "
        f"{max(total('bytes_ms', first), total('ops_ms', first)):.3f} ms; "
        f"all {len(rows)} batches: kernel {total('ms', rows):.3f} ms")
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


def _map_setup(pair):
    """(params, mapper, index, entries, frags) for the pair under the CLI's
    default parameters: the target's index, the query's fragment sketches
    [(frag_index, q_len, sketch, ok)] and the L1 stage's input rows for
    the fragments that pass the sketch gates."""
    from wfmash_tpu_torch import cli
    from wfmash_tpu_torch.index.build import build_index
    from wfmash_tpu_torch.io.fasta import FastaReader
    from wfmash_tpu_torch.io.seqids import SequenceIdManager
    from wfmash_tpu_torch.map.engine import Mapper

    pt, pq = pair[:2]
    mp = cli.parse_args([pt, pq, "-t", "1"])[0]
    cli.apply_auto_identity(mp)
    idm = SequenceIdManager(
        mp.query_sequences, mp.ref_sequences, mp.query_prefix,
        [mp.target_prefix] if mp.target_prefix else [],
        mp.prefix_delim if mp.skip_prefix else "", mp.query_list,
        mp.target_list)
    mapper = Mapper(mp, idm)
    index = build_index(
        mp, [(idm.get_sequence_id("anc"), FastaReader(pt).fetch("anc"))],
        log=log)
    q_seqid = idm.get_sequence_id("der")
    q_group = int(mapper.group_of([q_seqid])[0])
    t0 = time.monotonic()
    entries = mapper.sketch_query(FastaReader(pq).fetch("der"))
    sketch_s = time.monotonic() - t0
    frags = [dict(hashes=sk.hashes, n=sk.sketch_size, q_len=q_len,
                  q_seqid=q_seqid, q_group=q_group,
                  min_hits=mapper._minimum_hits_for(q_len, sk))
             for _, q_len, sk, ok in entries if ok]
    log(f"[map] parameters: window {mp.window_length}, k {mp.kmer_size}, "
        f"sketch size {mp.sketch_size}, identity "
        f"{mp.percentage_identity:.4f}; index: "
        f"{len(index.unique_hashes)} unique hashes, "
        f"{len(index.endpoints)} endpoints, {len(index.minmer_index)} "
        f"records; query: {len(entries)} fragments sketched in "
        f"{sketch_s * 1e3:.0f} ms, {len(frags)} pass the sketch gates")
    return mp, mapper, index, [e for e in entries if e[3]], frags


def _chunk_ms(chunks, run):
    """CUDA-event ms of run(chunk) for each chunk (one call each, after
    one untimed call on the first chunk), and the peak device memory
    allocated above what was held before."""
    import torch

    _cuda_ms(lambda: run(chunks[0]), 1)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    ms = [_cuda_ms(lambda c=c: run(c), 1)[0] for c in chunks]
    return ms, torch.cuda.max_memory_allocated() - base


def _ms_line(ms):
    return (f"{len(ms)} chunks, {sum(ms):.3f} ms in all, a chunk "
            f"{min(ms):.3f}-{max(ms):.3f} ms (median "
            f"{sorted(ms)[len(ms) // 2]:.3f})")


def map_phase(pair, dev):
    """DeviceL1 and DeviceL2 on the card over every fragment and candidate
    of the pair, against the native host stages and against the same torch
    programs on CPU tensors."""
    import torch

    from wfmash_tpu_torch.map import l1l2
    from wfmash_tpu_torch.map.l1_device import DeviceL1
    from wfmash_tpu_torch.map.l2_device import DeviceL2
    from wfmash_tpu_torch.utils import perf

    mp, mapper, index, entries, frags = _map_setup(pair)
    perf.reset()

    # ---- L1 -----------------------------------------------------------
    t0 = time.monotonic()
    d1 = DeviceL1(index, mapper._group_arr, mp, mapper.sketch_cutoffs,
                  device=dev)
    torch.cuda.synchronize()
    upload_ms = (time.monotonic() - t0) * 1e3
    t0 = time.monotonic()
    got = d1.candidates(frags)
    l1_wall = time.monotonic() - t0
    l1_calls = int(perf.get("map.device_calls"))
    t0 = time.monotonic()
    got_cpu = DeviceL1(index, mapper._group_arr, mp, mapper.sketch_cutoffs,
                       device="cpu").candidates(frags)
    l1_cpu = time.monotonic() - t0
    t0 = time.monotonic()
    host = [[(c.seq_id, c.range_start, c.range_end, c.intersection_size)
             for c in mapper._host_l1(sk, q_len, f["q_seqid"], f["q_group"],
                                      f["min_hits"], index)]
            for (_, q_len, sk, _), f in zip(entries, frags)]
    l1_host = time.monotonic() - t0
    n_dev = sum(g is not None for g in got)
    bad = sum(g is not None and g != h for g, h in zip(got, host))
    bad_cpu = sum(g != c for g, c in zip(got, got_cpu))
    chunks = [d1._pack(frags[c0:c0 + d1.BATCH])
              for c0 in range(0, len(frags), d1.BATCH)]
    ms, peak = _chunk_ms(chunks, lambda c: d1._run(*c))
    share1 = n_dev / len(frags)
    log(f"[map L1] {len(frags)} fragments, {l1_calls}"
        f" calls, answered on the card {n_dev} ({100 * share1:.2f}%), left "
        f"to the host {len(frags) - n_dev}; candidates "
        f"{sum(len(g) for g in got if g)}; rows differing from the native "
        f"host stage {bad}, from the program on CPU tensors {bad_cpu}")
    log(f"[map L1] index upload {upload_ms:.1f} ms; on the card: "
        f"{_ms_line(ms)}, sketch width {chunks[0][0].shape[1]}, cap "
        f"{d1.cap}, peak device memory of a chunk {peak / 1e6:.1f} MB; "
        f"candidates() wall {l1_wall * 1e3:.0f} ms (packing, copies and "
        f"row lists included); native host stage on the same rows "
        f"{l1_host * 1e3:.0f} ms; the program on CPU tensors "
        f"{l1_cpu * 1e3:.0f} ms")
    if bad or bad_cpu:
        raise RuntimeError(f"device L1 differs on {bad} rows from the host "
                           f"stage, on {bad_cpu} from the CPU-tensor run")

    # ---- L2 -----------------------------------------------------------
    rows = [(sk, q_len, l1l2.L1Candidate(*r))
            for (_, q_len, sk, _), g in zip(entries, host) for r in g]
    d2 = DeviceL2(index, mp, device=dev)
    t0 = time.monotonic()
    got = d2.walk(rows)
    l2_wall = time.monotonic() - t0
    l2_calls = int(perf.get("map.l2_device_calls"))
    t0 = time.monotonic()
    got_cpu = DeviceL2(index, mp, device="cpu").walk(rows)
    l2_cpu = time.monotonic() - t0
    t0 = time.monotonic()
    host2 = [l1l2.compute_l2_mapped_regions(sk, q_len, cand, index, mp)
             for sk, q_len, cand in rows]
    l2_host = time.monotonic() - t0

    def keys(ms_):
        return None if ms_ is None else [
            (m.seq_id, m.mean_optimal_pos, m.optimal_start, m.optimal_end,
             m.shared_sketch_size, m.strand) for m in ms_]

    n_dev = sum(g is not None for g in got)
    bad = sum(g is not None and keys(g) != keys(h)
              for g, h in zip(got, host2))
    bad_cpu = sum(keys(g) != keys(c) for g, c in zip(got, got_cpu))
    t0 = time.monotonic()
    prep = d2._prepare(rows)
    chunks = [d2._pack(rows, prep, k0, min(k0 + d2.BATCH, n_dev))
              for k0 in range(0, n_dev, d2.BATCH)]
    events_s = time.monotonic() - t0
    ms, peak = _chunk_ms(chunks, d2._run)
    widths = [c[0].shape[1] for c in chunks]
    # the products' operations: 2 B E E 3 (S + 1) a chunk
    flop = sum(2 * c[0].shape[0] * c[0].shape[1] ** 2 * 3 * (d2.S_CAP + 1)
               for c in chunks)
    share2 = n_dev / max(len(rows), 1)
    log(f"[map L2] {len(rows)} candidates, "
        f"{l2_calls} calls, answered on the "
        f"card {n_dev} ({100 * share2:.2f}%), left to the host "
        f"{len(rows) - n_dev}; mappings {sum(len(g) for g in got if g)}; "
        f"rows differing from the native host walk {bad}, from the program "
        f"on CPU tensors {bad_cpu}")
    log(f"[map L2] on the card: {_ms_line(ms)}, events a chunk "
        f"{min(widths)}-{max(widths)}, {flop / 1e9:.1f} GFLOP of products "
        f"({flop / sum(ms) / 1e9:.2f} TFLOP/s), peak device memory of a "
        f"chunk {peak / 1e6:.1f} MB; walk() wall {l2_wall * 1e3:.0f} ms "
        f"(of it the host's event windows and packing {events_s * 1e3:.0f} "
        f"ms; copies and the run replay included); native host walk on the "
        f"same rows {l2_host * 1e3:.0f} ms; the program on CPU tensors "
        f"{l2_cpu * 1e3:.0f} ms")
    if bad or bad_cpu:
        raise RuntimeError(f"device L2 differs on {bad} rows from the host "
                           f"walk, on {bad_cpu} from the CPU-tensor run")
    if min(share1, share2) < MIN_DEVICE_SHARE:
        raise RuntimeError(
            f"the device answered {share1:.4f} of the fragments and "
            f"{share2:.4f} of the candidates; the gate is "
            f"{MIN_DEVICE_SHARE}")


def write_split_query(tmp, der_b, n):
    """The pair's query cut into n sequences, as a plain FASTA file with
    its .fai: with several queries and `-t` above 1 the mapping forks its
    workers."""
    path = os.path.join(tmp, f"der{n}.fa")
    step = -(-len(der_b) // n)
    with open(path, "wb") as fh, open(path + ".fai", "w") as fai:
        for i in range(n):
            seq = der_b[i * step:(i + 1) * step]
            fh.write(b">der_%d\n" % i)
            fai.write(f"der_{i}\t{len(seq)}\t{fh.tell()}\t{len(seq)}\t"
                      f"{len(seq) + 1}\n")
            fh.write(seq + b"\n")
    return path


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
                     if k in ev.key), "torch operators")
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


@contextlib.contextmanager
def _env(**env):
    """`env` set in os.environ for the block, and the old values put
    back."""
    before = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in before.items():
            if v is None:
                del os.environ[k]
            else:
                os.environ[k] = v


def _done_in(text, what):
    """The seconds of the CLI's "<what> done in" message in text (nan when
    it has none)."""
    m = re.search(what + r" done in ([0-9.]+)s", text)
    return float(m.group(1)) if m else float("nan")


def _cli_call(argv, out_paf, segmented, **env):
    """One in-process run of the port's CLI with its output in out_paf and
    `env` set for its duration; the run's messages go on to the standard
    error. Returns (exit code, wall s, the messages)."""
    import torch

    from wfmash_tpu_torch import cli

    err = io.StringIO()
    try:
        t0 = time.monotonic()
        with open(out_paf, "w") as fh, contextlib.redirect_stdout(fh), \
                contextlib.redirect_stderr(err), _engine_switch(segmented), \
                _env(**env):
            rc = cli.main(argv)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    finally:
        sys.stderr.write(err.getvalue())
    return rc, wall, err.getvalue()


def _run_cli(argv, out_paf, segmented, **env):
    """_cli_call's (exit code, wall s, the "mapping done in" seconds)."""
    rc, wall, text = _cli_call(argv, out_paf, segmented, **env)
    return rc, wall, _done_in(text, "mapping")


def _check_paf(tag, out_paf, seqs, sample=N_SAMPLE):
    """The aligned rows of out_paf (one query): `sample` sampled rows must
    replay (replay_row, over the _Seqs seqs) and the rows must cover
    MIN_COVERAGE of the query."""
    rows = [ln for ln in open(out_paf) if "\tcg:Z:" in ln]
    if not rows:
        raise RuntimeError("no aligned rows")
    pick = np.random.default_rng(0).choice(
        len(rows), min(sample, len(rows)), replace=False)
    for i in pick:
        if not replay_row(rows[int(i)], seqs)[0]:
            raise RuntimeError(f"CIGAR replay failed on row {i}")
    cov_frac = _covered(
        (int(ln.split("\t")[2]), int(ln.split("\t")[3])) for ln in rows
    ) / int(rows[0].split("\t")[1])
    log(f"[{tag}] {len(rows)} rows, {len(pick)} sampled CIGARs replay "
        f"exactly, query coverage {cov_frac:.4f}")
    if cov_frac < MIN_COVERAGE:
        raise RuntimeError(f"coverage {cov_frac:.4f} < {MIN_COVERAGE}")


def e2e_phase(tmp, pair, segmented=True):
    """The port's CLI in-process on the pair of write_pair: the default
    path, or ExactWfaEngine alone (WFMASH_TPU_SEGMENTED=0), mapping
    through the device stages (the default on a card). Returns the
    launches of (seg_wfa, sweep_wfa), both counted from 0, the perf
    counters and the wall of that run."""
    from wfmash_tpu_torch.align import wfa_seg, wfa_sweep
    from wfmash_tpu_torch.utils import perf

    pt, pq, anc_b, der_b = pair
    tag = "e2e" if segmented else "e2e SEGMENTED=0"
    out_paf = os.path.join(tmp, f"out{int(segmented)}.paf")
    perf.reset()
    wfa_seg.LAUNCHES = wfa_sweep.LAUNCHES = 0
    rc, wall, map_s = _run_cli([pt, pq, "-t", "1"], out_paf, segmented)
    launches = (wfa_seg.LAUNCHES, wfa_sweep.LAUNCHES)
    snap = perf.snapshot()
    log(f"[{tag}] {len(anc_b) / 1e6:g} Mb pair: exit {rc}, wall {wall:.2f} "
        f"s, seg_wfa launches {launches[0]}, sweep_wfa launches "
        f"{launches[1]}, device L1 calls "
        f"{int(snap.get('map.device_calls', 0))}, device L2 calls "
        f"{int(snap.get('map.l2_device_calls', 0))}")
    log(f"[{tag}] counters: " + ", ".join(
        f"{k} {v:.3f}" for k, v in sorted(snap.items())))
    gate = launches[0] if segmented else launches[1]
    if rc != 0 or gate == 0:
        raise RuntimeError(f"CLI exit {rc}, launches {launches}")
    if not (snap.get("map.device_calls") and snap.get("map.l2_device_calls")):
        raise RuntimeError("the CLI's default mapping did not call the "
                           "device stages")
    left = [snap["map.l1_host_rows"] / snap["map.l1_rows"],
            snap["map.l2_host_rows"] / snap["map.l2_rows"]]
    if max(left) > 1 - MIN_DEVICE_SHARE:
        raise RuntimeError(f"the device stages left {left[0]:.4f} of the "
                           f"fragments and {left[1]:.4f} of the candidates "
                           "to the host")

    _check_paf(tag, out_paf, _Seqs(known=dict(anc=pair[2], der=pair[3])))

    # the same command with the host mapping, and (default path) with four
    # workers forked beside the CUDA context: the same bytes
    want = open(out_paf, "rb").read()
    others = [("WFMASH_TPU_DEVICE_L1=0", "1", dict(WFMASH_TPU_DEVICE_L1="0"))]
    if segmented:
        others.append(("-t 4", "4", {}))
    for name, threads, env in others:
        other_paf = os.path.join(tmp, "other.paf")
        perf.reset()
        rc, wall2, map2_s = _run_cli([pt, pq, "-t", threads], other_paf,
                                     segmented, **env)
        same = open(other_paf, "rb").read() == want
        log(f"[{tag}] {name}: exit {rc}, wall {wall2:.2f} s, device L1 "
            f"calls {int(perf.get('map.device_calls'))}, PAF "
            f"{'byte-equal' if same else 'DIFFERS'}; mapping done in "
            f"{map_s:.2f} s with the device stages (-t 1), {map2_s:.2f} s "
            f"in this run")
        if rc != 0 or not same:
            raise RuntimeError(f"{tag}: the run with {name} exits {rc} or "
                               "writes another PAF")
        if bool(env) != (perf.get("map.device_calls") == 0):
            raise RuntimeError(f"{tag}: {name} took the wrong mapping route")
    if segmented:
        # four queries: with -t 4 the sketching and the L2 + filter stages
        # run in four forked workers while this process holds the card
        pq4 = write_split_query(tmp, der_b, 4)
        pafs = []
        for threads in ("1", "4"):
            perf.reset()
            rc, wall2, map2_s = _run_cli(
                [pt, pq4, "-m", "-t", threads], os.path.join(tmp, "m.paf"),
                segmented)
            pafs.append(open(os.path.join(tmp, "m.paf"), "rb").read())
            log(f"[{tag}] mapping only, the query as four sequences, -t "
                f"{threads}: exit {rc}, wall {wall2:.2f} s, mapping done in "
                f"{map2_s:.2f} s, device L1 calls "
                f"{int(perf.get('map.device_calls'))}, "
                f"{pafs[-1].count(b'der_')} rows")
            if rc != 0 or not perf.get("map.device_calls"):
                raise RuntimeError(f"{tag}: mapping with -t {threads} "
                                   f"exits {rc} or skipped the device")
        if pafs[0] != pafs[1] or not pafs[0]:
            raise RuntimeError(f"{tag}: forked workers change the mapping")
    return launches, snap, wall


# ---------------------------------------------------------------------------
# golden: the reference's own output bytes (tests/torch_golden/)
# ---------------------------------------------------------------------------

GOLDEN_DIR = os.path.join(ROOT, "tests", "torch_golden")


# copies of the generators of scripts/torch_golden.py (the JAX package's
# CLI wrote the goldens from these inputs; this file reads them as data)

def golden_write_fasta(path, seqs, width=60):
    """Plain FASTA, `width` bases a line, and its .fai."""
    fai = []
    with open(path, "wb") as fh:
        for name, seq in seqs.items():
            fh.write(b">" + name.encode() + b"\n")
            off = fh.tell()
            for i in range(0, len(seq), width):
                fh.write(seq[i:i + width] + b"\n")
            fai.append(f"{name}\t{len(seq)}\t{off}\t{width}\t{width + 1}\n")
    with open(str(path) + ".fai", "w") as fh:
        fh.write("".join(fai))


def _golden_snps(rng, codes, rate):
    out = codes.copy()
    pos = rng.random(len(out)) < rate
    out[pos] = (out[pos] + rng.integers(1, 4, int(pos.sum()))) % 4
    return out


def _golden_small_indels(rng, codes, rate, longest):
    sites = np.sort(rng.choice(len(codes) - longest, int(len(codes) * rate),
                               replace=False))
    lens = rng.integers(1, longest + 1, len(sites))
    ins = rng.random(len(sites)) < 0.5
    parts, at = [], 0
    for s, n, i in zip(sites.tolist(), lens.tolist(), ins.tolist()):
        if s < at:
            continue
        parts.append(codes[at:s])
        if i:
            parts.append(rng.integers(0, 4, n).astype(np.uint8))
            at = s
        else:
            at = s + n
    parts.append(codes[at:])
    return np.concatenate(parts)


def _golden_scale_pair(d, bp, seed):
    from scale_demo import make_pair, write_fasta_bgzf

    anc, der = make_pair(bp, seed=seed)
    # the two files compressed at once (zlib lets go of the GIL)
    with ThreadPoolExecutor(2) as pool:
        list(pool.map(lambda nc: write_fasta_bgzf(
            os.path.join(d, nc[0] + ".fa.gz"), *nc),
            (("anc", anc), ("der", der))))
    return ["anc.fa.gz", "anc.fa.gz.fai", "der.fa.gz", "der.fa.gz.fai"]


def _golden_pangenome(d, bp, seed):
    rng = np.random.default_rng(seed)
    anc = rng.integers(0, 4, bp).astype(np.uint8)
    seqs = {}
    for hap in range(8):
        s = _golden_small_indels(
            rng, _golden_snps(rng, anc, 0.01 + 0.005 * hap), 0.0005, 8)
        if hap % 3 == 2:
            s = np.concatenate([s[len(s) // 2:], s[:len(s) // 2]])
        seqs[f"g{hap}#1#chr1"] = ACGT[s].tobytes()
    golden_write_fasta(os.path.join(d, "pan.fa"), seqs)
    return ["pan.fa", "pan.fa.fai"]


def _golden_indel_pair(d, bp, seed, snp, events):
    rng = np.random.default_rng(seed)
    tgt = rng.integers(0, 4, bp).astype(np.uint8)
    q = _golden_small_indels(rng, _golden_snps(rng, tgt, snp), 0.0005, 8)
    if events:
        for f, kind, n in ((0.85, "del", 800), (0.72, "ins", 400),
                           (0.55, "del", 2500), (0.45, "div", 700),
                           (0.3, "ins", 1500), (0.12, "div", 3000)):
            a = int(len(q) * f)
            if kind == "del":
                q = np.concatenate([q[:a], q[a + n:]])
            elif kind == "ins":
                q = np.concatenate(
                    [q[:a], rng.integers(0, 4, n).astype(np.uint8), q[a:]])
            else:
                q = q.copy()
                q[a:a + n] = _golden_snps(rng, q[a:a + n],
                                          0.3 if n < 1000 else 0.04)
    golden_write_fasta(os.path.join(d, "t.fa"), {"t": ACGT[tgt].tobytes()})
    golden_write_fasta(os.path.join(d, "q.fa"), {"q": ACGT[q].tobytes()})
    return ["t.fa", "t.fa.fai", "q.fa", "q.fa.fai"]


GOLDEN_YEAST_KB = (230, 813, 317, 1532, 577, 270, 1091, 563, 440, 746, 667,
                   1078, 924, 784, 1091, 948)


def _golden_yeast_pangenome(d, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    anc = [rng.integers(0, 4, round(kb * 1000 * scale)).astype(np.uint8)
           for kb in GOLDEN_YEAST_KB]
    for unit, copies in ((6000, 30), (330, 300)):
        elem = rng.integers(0, 4, unit).astype(np.uint8)
        for c in rng.integers(0, len(anc), max(2, round(copies * scale))):
            copy = _golden_snps(rng, elem, rng.uniform(0.01, 0.03))
            if rng.random() < 0.5:
                copy = 3 - copy[::-1]
            at = int(rng.integers(0, len(anc[c]) - unit))
            anc[c][at:at + unit] = copy
    seqs = {}
    for h in range(8):
        chroms = [_golden_small_indels(
            rng, _golden_snps(rng, a, 0.003 + 0.001 * h), 0.0005, 8)
            for a in anc]
        if h in (2, 5):
            a, b = (int(x) for x in rng.choice(len(chroms), 2,
                                               replace=False))
            ia = int(rng.integers(len(chroms[a]) // 4,
                                  3 * len(chroms[a]) // 4))
            ib = int(rng.integers(len(chroms[b]) // 4,
                                  3 * len(chroms[b]) // 4))
            chroms[a], chroms[b] = (
                np.concatenate([chroms[a][:ia], chroms[b][ib:]]),
                np.concatenate([chroms[b][:ib], chroms[a][ia:]]))
        if h in (3, 4, 6):
            n = round((40_000 if h != 4 else 20_000) * scale)
            c = int(rng.integers(0, len(chroms)))
            at = int(rng.integers(0, len(chroms[c]) - n))
            s = chroms[c]
            if h == 4:
                chroms[c] = np.concatenate([s[:at], s[at + n:]])
            else:
                chroms[c] = np.concatenate(
                    [s[:at], 3 - s[at:at + n][::-1], s[at + n:]])
        for c, s in enumerate(chroms):
            seqs[f"g{h}#1#chr{c + 1}"] = ACGT[s].tobytes()
    golden_write_fasta(os.path.join(d, "pan.fa"), seqs)
    return ["pan.fa", "pan.fa.fai"]


GOLDEN_GENERATORS = {"scale_pair": _golden_scale_pair,
                     "pangenome": _golden_pangenome,
                     "indel_pair": _golden_indel_pair,
                     "yeast_pangenome": _golden_yeast_pangenome}


def _sha256s(d, names):
    """{file name: sha256} of the named files in directory d."""
    import hashlib

    out = {}
    for n in names:
        with open(os.path.join(d, n), "rb") as fh:
            out[n] = hashlib.sha256(fh.read()).hexdigest()
    return out


def golden_inputs(entry, d):
    """Write a manifest entry's inputs into directory d with this file's
    copy of its generator; {file name: sha256}."""
    return _sha256s(d, GOLDEN_GENERATORS[entry["generator"]](
        d, **entry["args"]))


def golden_manifest():
    with open(os.path.join(GOLDEN_DIR, "manifest.json")) as fh:
        return json.load(fh)


def golden_bytes(entry):
    """The reference's output bytes of a manifest entry, uncompressed."""
    import gzip

    path = os.path.join(GOLDEN_DIR, entry["output"])
    with open(path, "rb") as fh:
        data = fh.read()
    return gzip.decompress(data) if path.endswith(".gz") else data


# the manifest's cases kept as row digests (scripts/torch_golden.DIGESTS)
GOLDEN_DIGESTS = ("B0",)


def golden_row_digests(out):
    """scripts/torch_golden.row_digests: a line a row, its first 12
    columns and the sha256 of its tags (what a digests case keeps)."""
    lines = []
    for ln in out.splitlines():
        cols = ln.split(b"\t")
        tags = hashlib.sha256(b"\t".join(cols[12:])).hexdigest().encode()
        lines.append(b"\t".join(cols[:12] + [tags]) + b"\n")
    return b"".join(lines)


def golden_reach(snap):
    """The port's reach from its perf counters, in the manifest's terms:
    which of t3-t5 took jobs, and whether a sweep ran at K >= 1024."""
    out = {t: snap.get(f"align.tier_jobs.{t}", 0) > 0
           for t in ("t3", "t4", "t5")}
    out["K>=1024"] = any(
        k.startswith("align.sweep_problems.K") and int(k[22:]) >= 1024
        and v > 0 for k, v in snap.items())
    return out


def golden_counts(snap):
    """(tier jobs, sweep problems by span) from the port's perf counters,
    keyed as the manifest keys the reference's."""
    tiers = {k[16:]: int(v) for k, v in snap.items()
             if k.startswith("align.tier_jobs.") and v}
    spans = {k[22:]: int(v) for k, v in snap.items()
             if k.startswith("align.sweep_problems.K") and v}
    return tiers, spans


def first_difference(got, want):
    """(line number, the port's line, the reference's line) of the first
    line where two outputs differ."""
    g, w = got.splitlines(), want.splitlines()
    for i in range(max(len(g), len(w))):
        a = g[i] if i < len(g) else b"<none>"
        b = w[i] if i < len(w) else b"<none>"
        if a != b:
            return i + 1, a, b
    return None


def golden_case_argv(tmp, case, e, made, prefix="golden"):
    """A manifest case's argv with its inputs made in a directory under
    tmp (`prefix` and a number) by this file's copy of its generator (once
    for each generator and arguments: `made` maps them to (directory,
    input hashes)); the inputs
    must hash as the manifest records ("input drift" otherwise: the
    generator's output changed, not a fault of the port)."""
    key = json.dumps([e["generator"], e["args"]], sort_keys=True)
    if key not in made:
        d = os.path.join(tmp, f"{prefix}{len(made)}")
        os.makedirs(d)
        made[key] = (d, golden_inputs(e, d))
    d, hashes = made[key]
    if hashes != e["inputs"]:
        bad = sorted(n for n in set(hashes) | set(e["inputs"])
                     if hashes.get(n) != e["inputs"].get(n))
        raise RuntimeError(
            f"golden {case}: input drift: {bad} hash otherwise than "
            "the manifest records (the generator's output changed on "
            "this machine; not a fault of the port)")
    return [os.path.join(d, a) if a in e["inputs"] else a for a in e["argv"]]


def golden_phase(tmp, e2e=None):
    """The port's CLI, in-process on the card with mapping through the
    device stages (the default there), on every case of
    tests/torch_golden/manifest.json, held to the bytes the reference
    (`python -m wfmash_tpu`, on the CPU, Pallas interpret mode) wrote.
    Each case's inputs are first made anew with this file's copy of its
    generator and must hash as the manifest records ("input drift"
    otherwise: a fault of the inputs, not of the port). M1 runs once more
    with WFMASH_TPU_DEVICE_L1=0. A0 is the e2e phase's own run (the same
    argv and inputs) when that phase ran: `e2e` is then (its PAF, its
    launches, its perf counters, its wall), and write_pair's files, whose
    hashes are checked, are in tmp. The full-alignment cases must
    launch kernel A (A0-A2) or kernel B (A3), and the port must reach the
    tiers t3-t5 and the sweep spans K >= 1024 that the reference reached."""
    from wfmash_tpu_torch.align import wfa_seg, wfa_sweep
    from wfmash_tpu_torch.utils import perf

    man = golden_manifest()
    made: dict = {}     # (generator, args) -> (directory, input hashes)
    t_phase = time.monotonic()
    cases = {c: e for c, e in man["cases"].items() if c not in SCALE_CASES}
    for case, e in cases.items():
        if e2e is not None and e["generator"] == "scale_pair" and \
                e["args"] == {"bp": E2E_BP, "seed": 42}:
            made.setdefault(json.dumps([e["generator"], e["args"]],
                                       sort_keys=True),
                            (tmp, _sha256s(tmp, e["inputs"])))
        argv = golden_case_argv(tmp, case, e, made)
        want = golden_bytes(e)
        # the engine switch; the reference's other variables (its JAX
        # platform and Pallas backend, its counters) mean nothing here
        env = {"WFMASH_TPU_SEGMENTED": e["env"]["WFMASH_TPU_SEGMENTED"]}
        runs = [("", {})]
        if case == "M1":
            runs.append((" WFMASH_TPU_DEVICE_L1=0",
                         {"WFMASH_TPU_DEVICE_L1": "0"}))
        for label, extra in runs:
            out = os.path.join(tmp, f"golden_{case}.out")
            if case == "A0" and e2e is not None:
                got = open(e2e[0], "rb").read()
                launches, snap, wall = e2e[1:]
                label = " (the e2e phase's run)"
            else:
                perf.reset()
                wfa_seg.LAUNCHES = wfa_sweep.LAUNCHES = 0
                rc, wall, _ = _run_cli(argv, out, True, **env, **extra)
                launches = (wfa_seg.LAUNCHES, wfa_sweep.LAUNCHES)
                snap = perf.snapshot()
                if rc != 0:
                    raise RuntimeError(f"golden {case}{label}: exit {rc}")
                got = open(out, "rb").read()
            rows = sum(1 for ln in got.splitlines()
                       if not ln.startswith(b"@"))
            log(f"[golden {case}]{label} {rows} rows, seg_wfa launches "
                f"{launches[0]}, sweep_wfa launches {launches[1]}, wall "
                f"{wall:.2f} s, device L1 calls "
                f"{int(snap.get('map.device_calls', 0))}: "
                + ("byte-equal to the reference" if got == want
                   else "DIFFERS from the reference"))
            if got != want:
                line, a, b = first_difference(got, want)
                log(f"[golden {case}] first difference, line {line}:\n"
                    f"  port:      {a[:400]!r}\n  reference: {b[:400]!r}")
                raise RuntimeError(f"golden {case}{label}: the port's "
                                   "output differs from the reference's")
            if e["tier_jobs"] or e["sweep_problems"]:
                tiers, spans = golden_counts(snap)
                reach = golden_reach(snap)
                log(f"[golden {case}] tier jobs {tiers} (reference "
                    f"{e['tier_jobs']}), sweep problems by span {spans} "
                    f"(reference {e['sweep_problems']}), reach {reach}")
                if reach != e["reach"]:
                    raise RuntimeError(f"golden {case}: the port reaches "
                                       f"{reach}, the reference {e['reach']}")
            if case.startswith("A") and case != "A3" and not launches[0]:
                raise RuntimeError(f"golden {case}: kernel A never launched")
            if case == "A3" and not launches[1]:
                raise RuntimeError("golden A3: kernel B never launched")
    log(f"[golden] {len(cases)} cases byte-equal to the reference "
        f"in {time.monotonic() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# scale: the port at the size its users run (tests/torch_golden/ B0-Y2)
# ---------------------------------------------------------------------------

SCALE_CASES = ("B1", "Y1", "Y2", "B0")
SCALE_RSS_GB = 8.0          # scripts/scale_demo.py's peak-RSS ceiling
SCALE_SAMPLE = 200          # B0's sampled CIGARs (scale_demo's --sample)
SCALE_TIMEOUT_S = 600       # B0's run in a process of its own
Y_MIN_SEQ_COVERAGE = 0.89   # upstream's yeast mapping test, per sequence
Y_MIN_ALIGNED = 11_000_000  # upstream's MAF check of its yeast pair
SCALE_RSS_STEP_GB = 0.25    # GB: B0's RSS moves this much between points
# B0's process: prints its peak RSS (its children's: the run alone)
_RSS_SHIM = ("import resource, subprocess, sys\n"
             "r = subprocess.run(sys.argv[1:])\n"
             "print('PEAK_KB=%d' % resource.getrusage("
             "resource.RUSAGE_CHILDREN).ru_maxrss, file=sys.stderr)\n"
             "sys.exit(r.returncode)\n")


@contextlib.contextmanager
def kernel_events():
    """CUDA events around every launch of either kernel in the block (the
    libraries' launch entry points wrapped, and put back after); the
    yielded dict holds {kernel: [launches, device ms]} once the block
    ends."""
    import torch

    from wfmash_tpu_torch.align import wfa_seg, wfa_sweep

    got: dict = {}
    wrapped = []
    for name, lib in (("seg_wfa", wfa_seg._lib()),
                      ("sweep_wfa", wfa_sweep._lib())):
        fn = name + "_launch"
        orig, evs = getattr(lib, fn), []

        def timed(*a, _orig=orig, _evs=evs):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            err = _orig(*a)
            e1.record()
            _evs.append((e0, e1))
            return err

        setattr(lib, fn, timed)
        wrapped.append((name, lib, fn, orig, evs))
    try:
        yield got
    finally:
        for name, lib, fn, orig, evs in wrapped:
            setattr(lib, fn, orig)
        torch.cuda.synchronize()
        for name, lib, fn, orig, evs in wrapped:
            got[name] = [len(evs), sum(a.elapsed_time(b) for a, b in evs)]


@contextlib.contextmanager
def index_bytes():
    """The bytes of the tensors that each DeviceL1 and DeviceL2 built in
    the block holds (the target index on the card), and of the numpy
    columns it keeps on the host: {class: bytes, class + " host":
    bytes}."""
    import torch

    from wfmash_tpu_torch.map import l1_device, l2_device

    got: dict = {}
    saved = []
    for cls in (l1_device.DeviceL1, l2_device.DeviceL2):
        def counted(self, *a, _init=cls.__init__, _name=cls.__name__, **kw):
            _init(self, *a, **kw)
            held = list(vars(self).values())
            got[_name] = got.get(_name, 0) + sum(
                v.numel() * v.element_size() for v in held
                if torch.is_tensor(v))
            got[_name + " host"] = got.get(_name + " host", 0) + sum(
                v.nbytes for v in held if isinstance(v, np.ndarray))

        saved.append((cls, cls.__init__))
        cls.__init__ = counted
    try:
        yield got
    finally:
        for cls, init in saved:
            cls.__init__ = init


def scale_child(argv):
    """The port's CLI in this process, as the scale phase runs B0 (under
    _RSS_SHIM); its exit code. One `[scale child] {...}` line on the
    standard error: the CLI's wall, the kernels' launches and device ms,
    the perf counters, the index's bytes on the card, the card's peak
    allocated bytes and this process's RSS over the run ([s from the
    CLI's start, GB] read from /proc/self/status every 0.2 s: the RSS
    after `import torch`, then a point each time it moved by more than
    SCALE_RSS_STEP_GB, so the CLI's "done in" messages place the peak in
    its stages)."""
    import threading

    import torch

    from wfmash_tpu_torch import cli
    from wfmash_tpu_torch.utils import perf

    def rss_gb():
        with open("/proc/self/status") as fh:
            return next(int(ln.split()[1]) / 1e6 for ln in fh
                        if ln.startswith("VmRSS"))

    t0 = time.monotonic()
    rss, stop = [[0.0, rss_gb()]], threading.Event()

    def sample():
        while not stop.wait(0.2):
            gb = rss_gb()
            if abs(gb - rss[-1][1]) > SCALE_RSS_STEP_GB:
                rss.append([time.monotonic() - t0, gb])

    sampler = threading.Thread(target=sample, daemon=True)
    sampler.start()
    with kernel_events() as kev, index_bytes() as ib:
        rc = cli.main(argv)
    wall = time.monotonic() - t0
    stop.set()
    sampler.join()
    sys.stdout.flush()
    print("[scale child] " + json.dumps(dict(
        rc=rc, wall=wall, kernels=kev, perf=perf.snapshot(), index_bytes=ib,
        peak_device_bytes=torch.cuda.max_memory_allocated(),
        rss_timeline=rss)), file=sys.stderr, flush=True)
    return rc


def _scale_in_process(argv, out, env):
    """One in-process run of the port's CLI on the card: what the
    `[scale <case>]` line reports."""
    import torch

    from wfmash_tpu_torch.align import wfa_seg, wfa_sweep
    from wfmash_tpu_torch.utils import perf

    perf.reset()
    wfa_seg.LAUNCHES = wfa_sweep.LAUNCHES = 0
    torch.cuda.reset_peak_memory_stats()
    with kernel_events() as kev, index_bytes() as ib:
        rc, wall, text = _cli_call(argv, out, True, **env)
    if rc != 0:
        raise RuntimeError(f"the CLI exits {rc}")
    if [kev["seg_wfa"][0], kev["sweep_wfa"][0]] != [wfa_seg.LAUNCHES,
                                                     wfa_sweep.LAUNCHES]:
        raise RuntimeError("launch counts and launch events disagree")
    return dict(wall=wall, text=text, kernels=kev, perf=perf.snapshot(),
                index_bytes=ib,
                peak_device_bytes=torch.cuda.max_memory_allocated())


def _scale_subprocess(argv, out, env):
    """B0's run: scale_child in a process of its own under _RSS_SHIM, the
    output in out; the child's report with the CLI's messages and the peak
    RSS added. Every process it starts is ended before it returns."""
    import signal

    child = ("import sys; sys.path.insert(0, %r); import chip_smoke; "
             "sys.exit(chip_smoke.scale_child(sys.argv[1:]))" % ROOT)
    with open(out, "w") as fh:
        proc = subprocess.Popen(
            [sys.executable, "-c", _RSS_SHIM, sys.executable, "-c", child,
             *argv], stdout=fh, stderr=subprocess.PIPE, text=True,
            env={**os.environ, **env}, start_new_session=True)
        try:
            _, err = proc.communicate(timeout=SCALE_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.communicate()
            raise RuntimeError(f"no end within {SCALE_TIMEOUT_S} s")
    sys.stderr.write(err[-20000:])
    m = re.search(r"\[scale child\] (.*)", err)
    if proc.returncode != 0 or m is None:
        raise RuntimeError(f"the CLI's process exits {proc.returncode}")
    got = json.loads(m.group(1))
    got["text"] = err
    got["peak_rss_gb"] = int(re.search(r"PEAK_KB=(\d+)", err).group(1)) / 1e6
    return got


class _Seqs:
    """Sequences by name, as given (`known`) or fetched once from FASTA
    files, and their reverse complements."""

    def __init__(self, paths=(), known=None):
        from wfmash_tpu_torch.io.fasta import FastaReader

        self.readers = [FastaReader(p) for p in paths]
        self.fwd: dict = dict(known or {})
        self.rev: dict = {}

    def get(self, name, rc=False):
        from wfmash_tpu_torch.sketch.kmers import reverse_complement

        if name not in self.fwd:
            r = next(r for r in self.readers if name in r)
            self.fwd[name] = r.fetch(name)
        if not rc:
            return self.fwd[name]
        if name not in self.rev:
            self.rev[name] = bytes(reverse_complement(
                np.frombuffer(self.fwd[name], np.uint8)))
        return self.rev[name]


def replay_row(line, seqs):
    """(replays, aligned bases) of one PAF row with a CIGAR: every `=` of
    the port's align/cigar.py matches and every `X` mismatches, and the
    CIGAR spans the row's query and target intervals exactly (pafcheck's
    rule); aligned bases are its M, = and X columns."""
    from wfmash_tpu_torch.align import cigar as C

    f = line.rstrip("\n").split("\t")
    ops = C.parse(next(c[5:] for c in f[12:] if c.startswith("cg:Z:")))
    qs, qe, ts, te = int(f[2]), int(f[3]), int(f[7]), int(f[8])
    q = seqs.get(f[0], f[4] == "-")
    q_start = len(q) - qe if f[4] == "-" else qs
    span_q = sum(n for n, op in ops if op in "M=XI")
    span_t = sum(n for n, op in ops if op in "M=XD")
    ok = (span_q, span_t) == (qe - qs, te - ts) and C.validate(
        ops, q, seqs.get(f[5]), q_start, ts)
    return ok, sum(n for n, op in ops if op in "M=X")


def _covered(intervals):
    """Bases under the union of [start, end) intervals."""
    cov = end = 0
    for a, b in sorted(intervals):
        a = max(a, end)
        if b > a:
            cov += b - a
            end = b
    return cov


def seq_coverage(paf, fai):
    """{sequence: share of its bases under the union of its rows' query
    intervals} for each sequence of a .fai that `-L` leaves a target: one
    of a lower id (file order) in another PanSN group (`-Y '#'`)."""
    lens, groups = {}, []
    with open(fai) as fh:
        for ln in fh:
            name, n = ln.split("\t")[:2]
            lens[name] = int(n)
            groups.append(name[:name.rfind("#") + 1])
    ivs: dict = {}
    for ln in paf.decode().splitlines():
        f = ln.split("\t")
        ivs.setdefault(f[0], []).append((int(f[2]), int(f[3])))
    return {name: _covered(ivs.get(name, ())) / lens[name]
            for i, name in enumerate(lens)
            if any(g != groups[i] for g in groups[:i])}


def _scale_line(case, r, rows, inputs_s):
    """The `[scale <case>]` line of a run's report (inputs_s: the seconds
    its inputs took to make, 0 when an earlier case made them)."""
    snap = r["perf"]
    (a_n, a_ms), (b_n, b_ms) = r["kernels"]["seg_wfa"], \
        r["kernels"]["sweep_wfa"]
    text = r["text"]
    extra = (f", host peak RSS {r['peak_rss_gb']:.3f} GB"
             if "peak_rss_gb" in r else "")
    log(f"[scale {case}] inputs {inputs_s:.1f} s; wall {r['wall']:.2f} s "
        f"(mapping done in "
        f"{_done_in(text, 'mapping'):.2f} s, aligning done in "
        f"{_done_in(text, 'aligning'):.2f} s), {rows} rows, seg_wfa "
        f"{a_n} launches / {a_ms:.3f} ms, sweep_wfa {b_n} launches / "
        f"{b_ms:.3f} ms, device L1 calls "
        f"{int(snap.get('map.device_calls', 0))}, L2 calls "
        f"{int(snap.get('map.l2_device_calls', 0))}, map.l1_rows "
        f"{int(snap.get('map.l1_rows', 0))}, map.l1_host_rows "
        f"{int(snap.get('map.l1_host_rows', 0))}, map.l2_rows "
        f"{int(snap.get('map.l2_rows', 0))}, map.l2_host_rows "
        f"{int(snap.get('map.l2_host_rows', 0))}, index on the card "
        f"{r['index_bytes']} B, peak device memory "
        f"{r['peak_device_bytes'] / 1e9:.3f} GB{extra}")
    log(f"[scale {case}] counters: " + ", ".join(
        f"{k} {v:.3f}" for k, v in sorted(snap.items())))
    if "rss_timeline" in r:
        log(f"[scale {case}] host RSS over the run (s from the CLI's start: "
            "GB): " + ", ".join(f"{t:.1f}: {gb:.3f}"
                                for t, gb in r["rss_timeline"]))


def scale_phase(tmp):
    """The port's CLI on the card, mapping through the device stages (the
    default there), at the size its users run: the 100 Mb pair of
    scripts/scale_demo.py (B) and a yeast-sized 8-genome PanSN pangenome
    (Y), each made anew with this file's copy of its generator and held to
    the manifest's input hashes. B1 (B mapped), Y1 (upstream's yeast
    mapping test) and Y2 (upstream's S288C/Y12 pair, aligned) run in this
    process and must be byte-equal to the reference's goldens; Y1's
    sequences each covered >= Y_MIN_SEQ_COVERAGE, Y2's every CIGAR
    replays and aligns > Y_MIN_ALIGNED bases. B0 (B aligned, the argv of
    scripts/scale_demo.py) runs in a process of its own and meets that
    script's gates (exit 0, peak RSS <= SCALE_RSS_GB, SCALE_SAMPLE sampled
    CIGARs replay, query coverage >= MIN_COVERAGE, kernel A launched), and
    its output's sha256 equals the reference's (its golden is its row
    digests, which name the first differing row otherwise); its
    alignment alone runs once more in this process, from B1's PAF (`-i`:
    B0's mapping), under torch.profiler for the card's busy share while it
    aligns."""
    man = golden_manifest()
    made: dict = {}
    t_phase = time.monotonic()
    for case in SCALE_CASES:
        e = man["cases"][case]
        t0 = time.monotonic()
        argv = golden_case_argv(tmp, case, e, made, "scale")
        inputs_s = time.monotonic() - t0
        env = {"WFMASH_TPU_SEGMENTED": e["env"]["WFMASH_TPU_SEGMENTED"]}
        out = os.path.join(tmp, f"scale_{case}.out")
        r = (_scale_subprocess if case == "B0" else _scale_in_process)(
            argv, out, env)
        got = open(out, "rb").read()
        _scale_line(case, r, got.count(b"\n"), inputs_s)
        if case in GOLDEN_DIGESTS:
            same = hashlib.sha256(got).hexdigest() == e["output_sha256"]
            log(f"[scale {case}] output sha256 "
                + ("equal to the reference's" if same else
                   "DIFFERS from the reference's"))
            if not same:
                diff = first_difference(golden_row_digests(got),
                                        golden_bytes(e))
                log(f"[scale {case}] first differing row digest, line "
                    f"{diff[0]}:\n  port:      {diff[1][:400]!r}\n"
                    f"  reference: {diff[2][:400]!r}")
                raise RuntimeError(f"scale {case}: the port's output "
                                   "differs from the reference's")
        else:
            want = golden_bytes(e)
            log(f"[scale {case}] " + ("byte-equal to the reference"
                                      if got == want else
                                      "DIFFERS from the reference"))
            if got != want:
                line, a, b = first_difference(got, want)
                log(f"[scale {case}] first difference, line {line}:\n"
                    f"  port:      {a[:400]!r}\n  reference: {b[:400]!r}")
                raise RuntimeError(f"scale {case}: the port's output "
                                   "differs from the reference's")
        if case == "Y1":
            cov = seq_coverage(got, argv[0] + ".fai")
            low = min(cov, key=cov.get)
            log(f"[scale Y1] per-sequence coverage of {len(cov)} sequences "
                f"(-L leaves the first group no target): least "
                f"{cov[low]:.4f} ({low}), mean "
                f"{sum(cov.values()) / len(cov):.4f}")
            if cov[low] < Y_MIN_SEQ_COVERAGE:
                raise RuntimeError(f"scale Y1: {low} covered {cov[low]:.4f}"
                                   f" < {Y_MIN_SEQ_COVERAGE}")
        if case == "Y2":
            seqs = _Seqs([argv[0]])
            lines = [ln for ln in got.decode().splitlines()
                     if "\tcg:Z:" in ln]
            checked = [replay_row(ln, seqs) for ln in lines]
            bad = [i for i, (ok, _) in enumerate(checked) if not ok]
            aligned = sum(n for _, n in checked)
            log(f"[scale Y2] {len(lines)} CIGARs, {len(bad)} fail to "
                f"replay; {aligned} aligned bases")
            if not lines or bad or aligned <= Y_MIN_ALIGNED:
                raise RuntimeError(f"scale Y2: rows {bad[:5]} fail to replay"
                                   f" or {aligned} aligned bases <= "
                                   f"{Y_MIN_ALIGNED}")
        if case == "B0":
            _check_paf("scale B0", out, _Seqs(argv[:2]), SCALE_SAMPLE)
            if r["peak_rss_gb"] > SCALE_RSS_GB or not r["kernels"][
                    "seg_wfa"][0]:
                raise RuntimeError(
                    f"scale B0: peak RSS {r['peak_rss_gb']:.3f} GB (ceiling "
                    f"{SCALE_RSS_GB}), seg_wfa launches "
                    f"{r['kernels']['seg_wfa'][0]}")
            # its alignment once more, from B1's PAF: B0's own mapping
            # (the same argv less -m), so the mapping is not run twice
            realign = [*argv[:2], "-i", os.path.join(tmp, "scale_B1.out"),
                       "-t", "1"]
            with _env(**env):
                from wfmash_tpu_torch import cli

                _busy_share("scale B0, aligning alone: -i B1's PAF",
                            lambda: cli.main(realign))
    log(f"[scale] {len(SCALE_CASES)} cases in "
        f"{time.monotonic() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# mesh: the multi-device paths over logical shards
# ---------------------------------------------------------------------------

MESH_SHARDS = 8        # logical shards of cuda:0 in the mesh phase
MESH_DIAG_K = 2048     # band of the diagonal-sharded problem
MESH_DIAG_LEVELS = 300
MESH_DP_LEVELS = 200   # levels of the data-parallel batch


@contextlib.contextmanager
def _mesh_devices(devs):
    """parallel.mesh.mesh_devices replaced in-process by `devs` (how a CLI
    run gets logical shards), and put back."""
    from wfmash_tpu_torch.parallel import mesh as mesh_mod

    real = mesh_mod.mesh_devices
    mesh_mod.mesh_devices = lambda device=None: list(devs)
    try:
        yield
    finally:
        mesh_mod.mesh_devices = real


def _sync_all(devs):
    import torch

    for d in sorted({d.index for d in devs}):
        torch.cuda.synchronize(d)


def _mesh_ms(fn, devs, reps):
    """ms a call of fn: CUDA events when every device is one card, else
    the host clock between synchronisations of all the cards."""
    if len(set(devs)) == 1:
        return _cuda_ms(fn, reps)
    _sync_all(devs)
    t0 = time.monotonic()
    for _ in range(reps):
        out = fn()
    _sync_all(devs)
    return (time.monotonic() - t0) * 1e3 / reps, out


def mesh_tier_phase(p, devs, rng, tag):
    """Kernel A sharded: one chunk of each tier through the tiers of
    a TieredSegmentSolver with a mesh over devs, against the unsharded
    solve on devs[0]: runs and out16 byte-equal. Returns the launches of
    the sharded dispatches."""
    import torch

    from wfmash_tpu_torch.align import wfa_seg
    from wfmash_tpu_torch.parallel.mesh import Mesh

    dev = devs[0]
    mesh = Mesh(devs, ("data",))
    base = wfa_seg.TieredSegmentSolver(p, dev).tiers
    sharded = wfa_seg.TieredSegmentSolver(p, dev, mesh=mesh).tiers
    launches = 0
    for no, (one, sh) in enumerate(zip(base, sharded)):
        if sh.mesh is None:
            log(f"[mesh {tag} t{no + 1}] not sharded: {len(devs)} devices "
                f"do not divide groups = {sh.groups}")
            continue
        jobs, caps = tier_jobs(rng, no)
        idxs = [i for i, (q, t, ef) in enumerate(jobs)
                if one.accepts(len(q), len(t), ef)][:one.max_call]
        want = one._dispatch_chunk(idxs, jobs, caps)
        n0 = wfa_seg.LAUNCHES
        got = sh._dispatch_chunk(idxs, jobs, caps)
        n_launch = wfa_seg.LAUNCHES - n0
        launches += n_launch
        same = all(np.array_equal(wfa_seg._host(got[k]),
                                  wfa_seg._host(want[k]))
                   for k in ("runs_full", "out16"))
        buf, _ = one.pack_chunk(idxs, jobs, caps)
        kw = dict(penalties=p, K=one.K, smax=one.smax, maxr=one.maxr)
        whole = torch.from_numpy(buf).to(dev)
        one_ms, _ = _cuda_ms(lambda: wfa_seg.run_seg(whole, **kw), 3)
        chunk_ms, _ = _mesh_ms(lambda: wfa_seg._run_seg_sharded(
            buf, len(idxs), devs, **kw), devs, 3)
        per = buf.shape[0] // len(devs)
        n_ranges = -(-len(idxs) // per)      # ranges that hold job rows
        shard_ms = []
        for i, d in enumerate(devs[:n_ranges]):
            part = torch.from_numpy(buf[i * per:(i + 1) * per]).to(d)
            with torch.cuda.device(d):
                shard_ms.append(_cuda_ms(
                    lambda: wfa_seg.run_seg(part, **kw), 3)[0])
        log(f"[mesh {tag} t{no + 1}] K={one.K} rows={buf.shape[0]} "
            f"jobs={len(idxs)} over {len(devs)} devices: {n_launch} "
            f"launches of {per} rows, runs "
            f"and out16 {'byte-equal' if same else 'DIFFER'} to the "
            f"unsharded solve; a shard's kernel "
            f"{min(shard_ms):.3f}-{max(shard_ms):.3f} ms (sum "
            f"{sum(shard_ms):.3f}), the sharded chunk {chunk_ms:.3f} ms "
            f"with its uploads, unsharded kernel {one_ms:.3f} ms")
        if not same or n_launch != n_ranges:
            raise RuntimeError(f"tier t{no + 1}: the sharded chunk differs "
                               f"or took {n_launch} launches")
    return launches


def mesh_l1_phase(pair, devs):
    """ShardedDeviceL1 over a (2, n/2) mesh on every fragment of the pair:
    equal to the native host stage wherever it answers, and leaving to the
    host exactly the rows the reference's rule leaves: those one device
    leaves, and those whose endpoints in one shard's hash range pass
    cap // n_shard."""
    import torch

    from wfmash_tpu_torch.map.l1_device import DeviceL1, _order_key
    from wfmash_tpu_torch.parallel.mesh import ShardedDeviceL1, make_mesh
    from wfmash_tpu_torch.utils import perf

    mp, mapper, index, entries, frags = _map_setup(pair)
    mesh = make_mesh(2, len(devs) // 2, devs)
    sd = ShardedDeviceL1(index, mapper._group_arr, mp, mapper.sketch_cutoffs,
                         mesh)
    _sync_all(devs)
    perf.reset()
    t0 = time.monotonic()
    got = sd.candidates(frags)
    _sync_all(devs)
    wall = time.monotonic() - t0
    calls = int(perf.get("map.device_calls"))
    single = DeviceL1(index, mapper._group_arr, mp, mapper.sketch_cutoffs,
                      device=devs[0]).candidates(frags)
    host = [[(c.seq_id, c.range_start, c.range_end, c.intersection_size)
             for c in mapper._host_l1(sk, q_len, f["q_seqid"], f["q_group"],
                                      f["min_hits"], index)]
            for (_, q_len, sk, _), f in zip(entries, frags)]
    uh = _order_key(np.asarray(index.unique_hashes))
    offs = np.asarray(index.endpoint_offsets, np.int64)
    cap_l = sd.cap // sd.n_shard
    want_none = []
    for f, s in zip(frags, single):
        keys = _order_key(np.asarray(f["hashes"], np.uint64))
        idx = np.searchsorted(uh, keys).clip(max=len(uh) - 1)
        hit = uh[idx] == keys
        n_ep = np.where(hit, offs[idx + 1] - offs[idx], 0)
        shard = np.searchsorted(sd.bounds, idx, side="right") - 1
        per_shard = np.bincount(shard, weights=n_ep, minlength=sd.n_shard)
        want_none.append(s is None or bool((per_shard > cap_l).any()))
    n_dev = sum(g is not None for g in got)
    bad = sum(g is not None and g != h for g, h in zip(got, host))
    bad_rule = sum((g is None) != w for g, w in zip(got, want_none))
    share = n_dev / len(frags)
    log(f"[mesh L1] ShardedDeviceL1 on a {mesh.shape} mesh of "
        f"{len(set(devs))} device(s): {len(frags)} fragments, {calls} "
        f"calls, {wall * 1e3:.0f} ms, answered {n_dev} ({100 * share:.2f}%)"
        f"; rows differing from the native host stage {bad}, rows whose "
        f"host route differs from the reference's rule {bad_rule}; "
        f"shard_ep_counts {sd.shard_ep_counts}")
    if bad or bad_rule or share < MIN_DEVICE_SHARE:
        raise RuntimeError(f"sharded L1: {bad} rows differ, {bad_rule} "
                           f"break the overflow rule, share {share:.4f}")


def _wave_inputs(pairs, K, R, dev):
    """advance_torch's inputs for byte pairs: rows padded with 0x01 / 0x02,
    a score-0 seed on the centre lane, target-axis splits."""
    import torch

    from wfmash_tpu_torch.align.wfa_sweep import NEG_I

    B = len(pairs)
    L = -(-(max(max(len(q), len(t)) for q, t in pairs) + 8) // 64) * 64
    query = np.full((B, L), 0x01, np.uint8)
    target = np.full((B, L), 0x02, np.uint8)
    for i, (q, t) in enumerate(pairs):
        query[i, :len(q)] = np.frombuffer(q, np.uint8)
        target[i, :len(t)] = np.frombuffer(t, np.uint8)
    qlen = torch.tensor([len(q) for q, _ in pairs], dtype=torch.int32,
                        device=dev)
    tlen = torch.tensor([len(t) for _, t in pairs], dtype=torch.int32,
                        device=dev)
    off = torch.full((B, R, 5, K), NEG_I, dtype=torch.int32, device=dev)
    off[:, 0, 0, K // 2] = 0
    anc = torch.full((B, R, 5, K), -1, dtype=torch.int32, device=dev)
    return ((off, anc, anc.clone(),
             torch.full((B, R, 4, K), -1, dtype=torch.int32, device=dev)),
            (torch.from_numpy(query).to(dev), torch.from_numpy(target).to(dev),
             qlen, tlen, torch.zeros(B, dtype=torch.bool, device=dev),
             tlen // 2))


def mesh_wavefront_phase(p, devs, rng):
    """diagonal_sharded_wfa_steps on one problem (K = 2048 over the
    devices) and data_parallel_wfa_steps on a batch, each bit-equal to
    advance_torch unsharded on the card."""
    import torch

    from wfmash_tpu_torch.align.wfa_sweep import (NEG_I, advance_torch,
                                                  ring_size)
    from wfmash_tpu_torch.parallel.mesh import (Mesh, data_parallel_wfa_steps,
                                                diagonal_sharded_wfa_steps)

    dev = devs[0]
    R = ring_size(p)
    mesh = Mesh(devs, ("data",))
    K = MESH_DIAG_K
    state, seq = _wave_inputs([_pair(rng, 6000, 6001, 0.03, 0.003)], K, R,
                              dev)
    t0 = time.monotonic()
    one = state
    for s in range(1, MESH_DIAG_LEVELS + 1):
        one = advance_torch(*one, s, *seq, K, R, p)[:4]
    _sync_all(devs)
    one_s = time.monotonic() - t0
    t0 = time.monotonic()
    got = diagonal_sharded_wfa_steps(*state, *seq, mesh, MESH_DIAG_LEVELS, p)
    _sync_all(devs)
    sh_s = time.monotonic() - t0
    same = all(torch.equal(a, b) for a, b in zip(one, got))
    live = (one[0][0, MESH_DIAG_LEVELS % R, 0] > NEG_I).cpu().numpy()
    per = K // len(devs)
    by_shard = [int(live[i * per:(i + 1) * per].sum())
                for i in range(len(devs))]
    log(f"[mesh diagonal] one {int(seq[2][0])} x {int(seq[3][0])} problem, "
        f"K={K} over {len(devs)} shards, {MESH_DIAG_LEVELS} levels: rings "
        f"and anchors {'bit-equal' if same else 'DIFFER'} to advance_torch "
        f"unsharded; live lanes at the last level {int(live.sum())} "
        f"(per shard {by_shard}); wall {sh_s:.2f} s sharded, {one_s:.2f} s "
        "unsharded")
    if not same or not live.any():
        raise RuntimeError("diagonal-sharded steps differ from unsharded")
    Kd = 256
    state, seq = _wave_inputs([_pair(rng, 1000, 2000, 0.04, 0.004)[:2]
                               for _ in range(4 * len(devs))], Kd, R, dev)
    t0 = time.monotonic()
    want = data_parallel_wfa_steps(state[0], *seq[:4], Mesh([dev], ("data",)),
                                   MESH_DP_LEVELS, p)
    _sync_all(devs)
    one_s = time.monotonic() - t0
    t0 = time.monotonic()
    got = data_parallel_wfa_steps(state[0], *seq[:4], mesh, MESH_DP_LEVELS, p)
    _sync_all(devs)
    sh_s = time.monotonic() - t0
    same = torch.equal(want, got)
    log(f"[mesh data-parallel] {state[0].shape[0]} problems of 1-2 kb, "
        f"K={Kd}, {MESH_DP_LEVELS} levels over {len(devs)} shards: offsets "
        f"{'bit-equal' if same else 'DIFFER'} to one device; wall "
        f"{sh_s:.2f} s sharded, {one_s:.2f} s unsharded")
    if not same:
        raise RuntimeError("data-parallel steps differ from unsharded")


def mesh_cli_phase(tmp, pair, devs):
    """The CLI on the pair on the default path, then with the mesh routes
    (WFMASH_TPU_DEVICE_L1=mesh, WFMASH_TPU_ALIGN_MESH=force) over devs:
    the same PAF bytes, replay and coverage, and more kernel-A launches.
    Returns the mesh run's kernel-A launches."""
    from wfmash_tpu_torch.align import wfa_seg, wfa_sweep
    from wfmash_tpu_torch.utils import perf

    pt, pq = pair[:2]
    mesh_env = dict(WFMASH_TPU_DEVICE_L1="mesh",
                    WFMASH_TPU_ALIGN_MESH="force")
    pafs, launches = {}, {}
    for name, env in (("default", {}), ("mesh", mesh_env)):
        out = os.path.join(tmp, f"mesh-{name}.paf")
        perf.reset()
        wfa_seg.LAUNCHES = wfa_sweep.LAUNCHES = 0
        with _mesh_devices(devs):
            rc, wall, map_s = _run_cli([pt, pq, "-t", "1"], out, True, **env)
        launches[name] = (wfa_seg.LAUNCHES, wfa_sweep.LAUNCHES)
        snap = perf.snapshot()
        log(f"[mesh e2e {name}] exit {rc}, wall {wall:.2f} s, mapping done "
            f"in {map_s:.2f} s, seg_wfa launches {launches[name][0]}, "
            f"sweep_wfa launches {launches[name][1]}, device L1 calls "
            f"{int(snap.get('map.device_calls', 0))}, rows left to the host "
            f"{int(snap.get('map.l1_host_rows', 0))} of "
            f"{int(snap.get('map.l1_rows', 0))}, align.device_calls "
            f"{int(snap.get('align.device_calls', 0))}")
        if rc != 0:
            raise RuntimeError(f"mesh e2e {name}: exit {rc}")
        _check_paf(f"mesh e2e {name}", out,
                   _Seqs(known=dict(anc=pair[2], der=pair[3])))
        pafs[name] = open(out, "rb").read()
    same = pafs["mesh"] == pafs["default"]
    log(f"[mesh e2e] PAF of the mesh run {'byte-equal' if same else 'DIFFERS'}"
        f" to the default run's; seg_wfa launches {launches['mesh'][0]} "
        f"against {launches['default'][0]}")
    if not same or launches["mesh"][0] <= 15:
        raise RuntimeError("the mesh run writes another PAF or launched "
                           f"kernel A {launches['mesh'][0]} times")
    return launches["mesh"][0]


def mesh_dryrun_phase(devs):
    import torch

    from wfmash_tpu_torch.parallel import dryrun

    fn, args = dryrun.entry(devs[0])
    t0 = time.monotonic()
    out = fn(*args)
    torch.cuda.synchronize()
    log(f"[mesh dryrun] entry() ran on {devs[0]}: {tuple(out.shape)} in "
        f"{(time.monotonic() - t0) * 1e3:.0f} ms")
    dryrun.dryrun_multichip(len(devs), devs)


def mesh_phase(p, tmp, pair, rng):
    """Every multi-device path over eight logical shards of cuda:0, and
    over the machine's cards too where it has more than one. Returns the
    mesh CLI run's kernel-A launches."""
    import torch

    logical = [torch.device("cuda", 0)] * MESH_SHARDS
    t0 = time.monotonic()
    tier_launches = mesh_tier_phase(p, logical, rng, "logical")
    mesh_l1_phase(pair, logical)
    mesh_wavefront_phase(p, logical, rng)
    cli_launches = mesh_cli_phase(tmp, pair, logical)
    mesh_dryrun_phase(logical)
    n = torch.cuda.device_count()
    if n > 1:
        cards = [torch.device("cuda", i) for i in range(n)]
        mesh_tier_phase(p, cards, rng, "cards")
        if n % 2 == 0:
            mesh_l1_phase(pair, cards)
        mesh_dryrun_phase(cards)
    else:
        log("[mesh] one card: the multi-device paths ran over eight logical "
            "shards of cuda:0 only")
    log(f"[mesh] phase wall {time.monotonic() - t0:.1f} s; kernel-A "
        f"launches: {tier_launches} over the five tier chunks, "
        f"{cli_launches} in the mesh CLI run")
    return cli_launches


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
PHASES = ("tiers", "spec", "sweep", "exact", "map", "e2e", "e2e0", "mesh",
          "golden", "scale")


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
    walls = {}

    def timed(name, fn, *a, **kw):
        t0 = time.monotonic()
        got = fn(*a, **kw)
        walls[name] = time.monotonic() - t0
        return got

    timed("build", build_phase)
    tiers = (timed("tiers", tier_phase, p, dev, rng) if "tiers" in phases
             else None)
    if "spec" in phases:
        timed("spec", spec_phase, p, dev, rng)
    sweeps = (timed("sweep", sweep_phase, p, dev, rng) if "sweep" in phases
              else None)
    if "exact" in phases:
        timed("exact", exact_phase, p, dev, rng)
    seg_launches = sweep_launches = mesh_launches = None
    with tempfile.TemporaryDirectory() as tmp:
        if {"map", "e2e", "e2e0", "mesh"} & set(phases):
            pair = timed("pair", write_pair, tmp, E2E_BP)
        if "map" in phases:
            timed("map", map_phase, pair, dev)
        if "e2e" in phases:
            launches, e2e_snap, e2e_wall = timed("e2e", e2e_phase, tmp, pair)
            seg_launches = launches[0]
            e2e = (os.path.join(tmp, "out1.paf"), launches, e2e_snap,
                   e2e_wall)
        if "e2e0" in phases:
            (_, sweep_launches), _, _ = timed("e2e0", e2e_phase, tmp, pair,
                                              segmented=False)
        if "mesh" in phases:
            mesh_launches = timed("mesh", mesh_phase, p, tmp, pair, rng)
        if "golden" in phases:
            timed("golden", golden_phase, tmp,
                  e2e if "e2e" in phases else None)
        if "scale" in phases:
            timed("scale", scale_phase, tmp)
    log("[phases] " + ", ".join(f"{k} {v:.1f} s" for k, v in walls.items())
        + f"; in all {sum(walls.values()):.1f} s")
    if set(phases) != set(PHASES):
        log(f"partial run ({args.phases}): no result line")
        return 0
    kernels = [
        kernel_row("seg_wfa", "wfmash_tpu/align/wfa_pallas_seg.py:109",
                   seg_launches, tiers),
        kernel_row("sweep_wfa", "wfmash_tpu/align/wfa_pallas.py:140",
                   sweep_launches, sweeps)]
    # kernel A's launches in the mesh CLI run (eight logical shards)
    kernels[0]["mesh_launches"] = mesh_launches
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
