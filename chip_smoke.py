"""Smoke run of the PyTorch/CUDA port on one GPU: `python3 chip_smoke.py`.

Phases (any failure exits non-zero):
1. the card's name and power limit; a CUDA device is required;
2. build the segment WFA kernel (nvcc) and the native host libraries (g++);
3. per segment tier, one full chunk of generated jobs packed by the port's
   pack_chunk: the kernel and its plain PyTorch version (on the card and
   on a CPU copy) must agree byte for byte (term col 8, the per-problem
   level counter, aside);
4. the tiered solver on the card: every `ok` CIGAR must equal wfa_np's;
5. the CLI (`wfmash_tpu_torch target.fa query.fa -t 1`) in-process on the
   6 Mb synthetic pair of tests/test_scale.py: exit 0, kernel launches,
   sampled CIGARs replay exactly, query coverage >= 0.95.
The last lines are the card line, the kernel table as JSON, and the
result as JSON.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

ACGT = np.frombuffer(b"ACGT", np.uint8)
SEED = 20261016
N_SAMPLE = 60
MIN_COVERAGE = 0.95
MIN_SPEC_CHECKS = 200


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
    from wfmash_tpu.align.wfa_np import EndsFree

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
    from wfmash_tpu.align.wfa_np import EndsFree

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
    from wfmash_tpu import native
    from wfmash_tpu_torch import _build
    from wfmash_tpu_torch.align import wfa_seg

    t0 = time.monotonic()
    wfa_seg._lib()
    t_nvcc = time.monotonic() - t0
    for line in _build.ptxas_report.get("seg_wfa", "").splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            log(f"[build] ptxas: {line.strip()}")
    t0 = time.monotonic()
    libs = dict(winnow=native.get_lib(), l1l2=native.get_l1l2_lib(),
                anchors=native.get_anchors_lib(), wfa=native.get_wfa_lib(),
                segsolve=native.get_segsolve_lib())
    t_gpp = time.monotonic() - t0
    missing = [k for k, v in libs.items() if v is None]
    if missing:
        raise RuntimeError(f"native host libraries failed to build: "
                           f"{missing}")
    log(f"[build] seg_wfa kernel (nvcc) {t_nvcc:.2f} s; native host "
        f"libraries (g++) {t_gpp:.2f} s")


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
        # swept cells: each problem's levels x K lanes x 5 states
        cells = int(term[:, 8].astype(np.int64).sum()) * tier.K * 5
        log(f"[tier t{no + 1}] K={tier.K} smax={tier.smax} "
            f"lseg={tier.lseg} rows={buf.shape[0]} jobs={len(idxs)} "
            f"done={int(term[:len(idxs), 0].sum())} "
            f"max_runs={int(used.max())} kernel {k_ms:.3f} ms "
            f"({cells / k_ms / 1e6:.2f} Gcells/s), plain on the card "
            f"{p_ms:.3f} ms (rows differing {n_bad}, max_abs_err {err}), "
            f"plain on a CPU copy {c_ms:.1f} ms (rows differing {n_bad_c}, "
            f"max_abs_err {err_c})")
        if n_bad or n_bad_c:
            raise RuntimeError(f"tier t{no + 1}: kernel and plain version "
                               f"disagree on {max(n_bad, n_bad_c)} rows")
        rows.append(dict(tier=no + 1, ms=k_ms, plain_ms=p_ms,
                         err=max(err, err_c)))
    return rows


def spec_phase(p, dev, rng):
    """The tiered solver on the card against the wfa_np spec."""
    from wfmash_tpu.align.wfa_np import wfa_align
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


def e2e_phase(tmp, bp=6_000_000):
    """The port's CLI in-process on the 6 Mb pair of tests/test_scale.py."""
    import torch

    from scale_demo import make_pair, write_fasta_bgzf

    from wfmash_tpu.align import cigar as C
    from wfmash_tpu.sketch.kmers import reverse_complement
    from wfmash_tpu.utils import perf
    from wfmash_tpu_torch import cli
    from wfmash_tpu_torch.align import wfa_seg

    anc, der = make_pair(bp, seed=42)
    pt, pq = os.path.join(tmp, "anc.fa.gz"), os.path.join(tmp, "der.fa.gz")
    write_fasta_bgzf(pt, "anc", anc)
    write_fasta_bgzf(pq, "der", der)
    out_paf = os.path.join(tmp, "out.paf")
    os.environ["WFMASH_TPU_DEVICE_L1"] = "0"
    perf.reset()
    wfa_seg.LAUNCHES = 0
    t0 = time.monotonic()
    with open(out_paf, "w") as fh, contextlib.redirect_stdout(fh):
        rc = cli.main([pt, pq, "-t", "1"])
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = wfa_seg.LAUNCHES
    log(f"[e2e] {bp / 1e6:g} Mb pair: exit {rc}, wall {wall:.2f} s, "
        f"kernel launches {launches}")
    log("[e2e] counters: " + ", ".join(
        f"{k} {v:.3f}" for k, v in sorted(perf.snapshot().items())))
    if rc != 0 or launches == 0:
        raise RuntimeError(f"CLI exit {rc}, {launches} kernel launches")

    anc_b = ACGT[anc].tobytes()
    der_b = ACGT[der].tobytes()
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
    log(f"[e2e] {len(rows)} rows, {len(pick)} sampled CIGARs replay "
        f"exactly, query coverage {cov_frac:.4f}")
    if cov_frac < MIN_COVERAGE:
        raise RuntimeError(f"coverage {cov_frac:.4f} < {MIN_COVERAGE}")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    card = card_line()
    log(f"[card] {card}")
    from wfmash_tpu.align.wfa_np import Penalties

    dev = torch.device("cuda")
    p = Penalties(5, 8, 2, 24, 1)    # the align path's defaults (params.py)
    rng = np.random.default_rng(SEED)
    build_phase()
    tiers = tier_phase(p, dev, rng)
    spec_phase(p, dev, rng)
    with tempfile.TemporaryDirectory() as tmp:
        launches = e2e_phase(tmp)
    kernels = [dict(
        name="seg_wfa", route="cuda", source="wfmash_tpu_torch/csrc/seg_wfa.cu",
        replaces="wfmash_tpu/align/wfa_pallas_seg.py:109",
        launches=launches, max_abs_err=max(r["err"] for r in tiers),
        ms=sum(r["ms"] for r in tiers),
        plain_ms=sum(r["plain_ms"] for r in tiers))]
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
