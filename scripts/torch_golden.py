"""Golden outputs of the reference CLI, for the port's byte-parity checks.

Runs the JAX package's CLI (`wfmash_tpu.cli.main`, what `python -m
wfmash_tpu` runs, unmodified) on the CPU over generated inputs, its Pallas
kernels in interpret mode (`JAX_PLATFORMS=cpu WFMASH_TPU_SEGMENTED=1
WFMASH_TPU_WFA_BACKEND=pallas-interpret`: past the "no accelerator" branch
of `make_engine`, with the exact engine on the Pallas composition a TPU
runs). Each case writes one output file into tests/torch_golden/ (gzip
when over GZIP_OVER bytes) and its entry in manifest.json: the generator
with its arguments, the sha256 of every input file as written, the argv and
environment, the output's sha256 and rows, the wall it took, the
reference's `WFMASH_TPU_PERF=1` counters, and the jobs each segment tier
took and the problems each sweep span took. Those two are counted by
wrappers around `SegmentSolver._dispatch_chunk` and `PallasSweeps.sweep`
that call through unchanged (the reference's own counters do not split
tiers or spans). The manifest also holds `reference_sha256`, a hash of
the reference package's sources (`reference_hash`).

The cases of SCALE run at the size users run (the 100 Mb pair of
scripts/scale_demo.py, a yeast-sized 8-genome pangenome) and are held on
the card by chip_smoke.py's `scale` phase; B0 (the 100 Mb pair aligned,
an output of 10.5 MB) keeps its row digests (`row_digests`) and the
sha256 of the whole output instead of the bytes. On an 8-core CPU: B1
85 s, Y1 43 s, Y2 261 s, B0 1174 s (the four ran at once).

    JAX_PLATFORMS=cpu python scripts/torch_golden.py [--cases M1,A1]
        [--work DIR] [--timeout S]

The case table is CASES. Inputs come from the generators below, which
`chip_smoke.py` copies (it imports nothing of the JAX package and reads
the goldens as data); tests/test_torch_golden.py holds both copies to the
recorded input hashes.
"""

from __future__ import annotations

import argparse
import contextlib
import fcntl
import gzip
import hashlib
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))
GOLDEN = os.path.join(ROOT, "tests", "torch_golden")
ACGT = np.frombuffer(b"ACGT", np.uint8)
GZIP_OVER = 1_000_000

# the reference's five tier envelopes (K, smax) -> the port's tier names
TIER_NAMES = {(128, 128): "t1", (256, 384): "t2", (512, 768): "t3",
              (1024, 512): "t4", (256, 2048): "t5"}

ENV = {"JAX_PLATFORMS": "cpu", "WFMASH_TPU_SEGMENTED": "1",
       "WFMASH_TPU_WFA_BACKEND": "pallas-interpret", "WFMASH_TPU_PERF": "1"}


# ---- generators (chip_smoke.py keeps a copy of each) ----------------------

def write_fasta(path, seqs, width=60):
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


def _snps(rng, codes, rate):
    """codes with a share `rate` of positions changed to another base."""
    out = codes.copy()
    pos = rng.random(len(out)) < rate
    out[pos] = (out[pos] + rng.integers(1, 4, int(pos.sum()))) % 4
    return out


def _small_indels(rng, codes, rate, longest):
    """codes with indels of 1..longest bp at a share `rate` of positions,
    half deletions and half insertions of random bases."""
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


def scale_pair(d, bp, seed):
    """scripts/scale_demo.make_pair written as chip_smoke.write_pair writes
    it: anc.fa.gz and der.fa.gz, BGZF, with their .fai."""
    from scale_demo import make_pair, write_fasta_bgzf

    anc, der = make_pair(bp, seed=seed)
    write_fasta_bgzf(os.path.join(d, "anc.fa.gz"), "anc", anc)
    write_fasta_bgzf(os.path.join(d, "der.fa.gz"), "der", der)
    return ["anc.fa.gz", "anc.fa.gz.fai", "der.fa.gz", "der.fa.gz.fai"]


def pangenome(d, bp, seed):
    """The 8-haplotype PanSN generator of tests/test_coverage_pangenome.py
    at `bp` a haplotype: haplotype h at 1% + 0.5% h of substitutions, with
    0.05% of indels of 1-8 bp of both directions, and every third one with
    its halves swapped. pan.fa with its .fai."""
    rng = np.random.default_rng(seed)
    anc = rng.integers(0, 4, bp).astype(np.uint8)
    seqs = {}
    for hap in range(8):
        s = _small_indels(rng, _snps(rng, anc, 0.01 + 0.005 * hap),
                          0.0005, 8)
        if hap % 3 == 2:
            s = np.concatenate([s[len(s) // 2:], s[:len(s) // 2]])
        seqs[f"g{hap}#1#chr1"] = ACGT[s].tobytes()
    write_fasta(os.path.join(d, "pan.fa"), seqs)
    return ["pan.fa", "pan.fa.fai"]


def indel_pair(d, bp, seed, snp, events):
    """t.fa (target `t`) and q.fa (query `q`): the query is the target with
    a share `snp` of substitutions and 0.05% of 1-8 bp indels of both
    directions. With events, also (positions as shares of bp, in target
    order): a 3 kb stretch at 4% substitutions (0.12), an insertion of
    1500 bp into the query (0.3), a 700 bp stretch at 30% (0.45), a
    deletion of 2500 bp from the query (0.55), an insertion of 400 bp
    (0.72) and a deletion of 800 bp (0.85)."""
    rng = np.random.default_rng(seed)
    tgt = rng.integers(0, 4, bp).astype(np.uint8)
    q = _small_indels(rng, _snps(rng, tgt, snp), 0.0005, 8)
    if events:
        # the query's coordinates follow the target's within ~0.1% here;
        # apply the events from the right so earlier positions hold
        at = lambda f: int(len(q) * f)    # noqa: E731
        for f, kind, n in ((0.85, "del", 800), (0.72, "ins", 400),
                           (0.55, "del", 2500), (0.45, "div", 700),
                           (0.3, "ins", 1500), (0.12, "div", 3000)):
            a = at(f)
            if kind == "del":
                q = np.concatenate([q[:a], q[a + n:]])
            elif kind == "ins":
                q = np.concatenate(
                    [q[:a], rng.integers(0, 4, n).astype(np.uint8), q[a:]])
            else:
                q = q.copy()
                q[a:a + n] = _snps(rng, q[a:a + n],
                                   0.3 if n < 1000 else 0.04)
    write_fasta(os.path.join(d, "t.fa"), {"t": ACGT[tgt].tobytes()})
    write_fasta(os.path.join(d, "q.fa"), {"q": ACGT[q].tobytes()})
    return ["t.fa", "t.fa.fai", "q.fa", "q.fa.fai"]


# S288C's sixteen nuclear chromosomes, kb
YEAST_KB = (230, 813, 317, 1532, 577, 270, 1091, 563, 440, 746, 667, 1078,
            924, 784, 1091, 948)


def yeast_pangenome(d, seed, scale=1.0):
    """An 8-genome PanSN pangenome of yeast's shape. The ancestor has
    YEAST_KB's chromosomes (12.07 Mb), over which copies of a 6 kb element
    (30 of them) and of a 330 bp element (300), each diverged 1-3% and on
    either strand, are written in place. Haplotype h (`g{h}#1#chr{c}`)
    has 0.3% + 0.1% h of substitutions and 0.05% of 1-8 bp indels of both
    directions; h = 2 and 5 carry a reciprocal translocation between two
    chromosomes, h = 3 and 6 a 40 kb inversion, h = 4 a 20 kb deletion.
    `scale` multiplies every length but the elements' (chromosomes, events)
    and the numbers of copies (at least two of each). pan.fa with its
    .fai."""
    rng = np.random.default_rng(seed)
    anc = [rng.integers(0, 4, round(kb * 1000 * scale)).astype(np.uint8)
           for kb in YEAST_KB]
    for unit, copies in ((6000, 30), (330, 300)):
        elem = rng.integers(0, 4, unit).astype(np.uint8)
        for c in rng.integers(0, len(anc), max(2, round(copies * scale))):
            copy = _snps(rng, elem, rng.uniform(0.01, 0.03))
            if rng.random() < 0.5:
                copy = 3 - copy[::-1]
            at = int(rng.integers(0, len(anc[c]) - unit))
            anc[c][at:at + unit] = copy
    seqs = {}
    for h in range(8):
        chroms = [_small_indels(rng, _snps(rng, a, 0.003 + 0.001 * h),
                                0.0005, 8) for a in anc]
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
    write_fasta(os.path.join(d, "pan.fa"), seqs)
    return ["pan.fa", "pan.fa.fai"]


GENERATORS = {"scale_pair": scale_pair, "pangenome": pangenome,
              "indel_pair": indel_pair, "yeast_pangenome": yeast_pangenome}

PAN = ("pangenome", dict(bp=400_000, seed=7))
BIG = ("scale_pair", dict(bp=100_000_000, seed=42))
YEAST = ("yeast_pangenome", dict(seed=8))
A2_PAIR = ("indel_pair", dict(bp=50_000, seed=11, snp=0.005, events=True))

# name -> (generator, its arguments, argv, environment over ENV); in the
# order they are made
CASES = {
    "M1": ("scale_pair", dict(bp=6_000_000, seed=42),
           ["anc.fa.gz", "der.fa.gz", "-m", "-t", "1"], {}),
    "M2": (*PAN, ["pan.fa", "-m"], {}),
    "M3": (*PAN, ["pan.fa", "-m", "-o"], {}),
    "M4": (*PAN, ["pan.fa", "-m", "-L", "-n", "7"], {}),
    "M5": (*PAN, ["pan.fa", "-m", "-M"], {}),
    "M6": (*PAN, ["pan.fa", "-m", "-x", "0.3675"], {}),
    "M7": (*PAN, ["pan.fa", "-m", "-N", "-j", "0"], {}),
    "A1": ("scale_pair", dict(bp=600_000, seed=42),
           ["anc.fa.gz", "der.fa.gz", "-t", "1"], {}),
    "A2": (*A2_PAIR, ["t.fa", "q.fa", "-t", "1"], {}),
    "S1": (*A2_PAIR, ["t.fa", "q.fa", "-a", "-t", "1"], {}),
    "A3": ("indel_pair", dict(bp=12_000, seed=13, snp=0.025, events=False),
           ["t.fa", "q.fa", "-t", "1"], {"WFMASH_TPU_SEGMENTED": "0"}),
    "A0": ("scale_pair", dict(bp=6_000_000, seed=42),
           ["anc.fa.gz", "der.fa.gz", "-t", "1"], {}),
    # at the size its users run: the 100 Mb pair of scripts/scale_demo.py
    # and upstream's yeast tests (-p 95 -n 7 -m -L -Y '#'; a -T/-Q pair)
    "B1": (*BIG, ["anc.fa.gz", "der.fa.gz", "-m", "-t", "1"], {}),
    "Y1": (*YEAST, ["pan.fa", "-p", "95", "-n", "7", "-m", "-L", "-Y", "#",
                    "-t", "4"], {}),
    "Y2": (*YEAST, ["pan.fa", "-T", "g0#", "-Q", "g1#", "-t", "4"], {}),
    "B0": (*BIG, ["anc.fa.gz", "der.fa.gz", "-t", "1"], {}),
}
# the cases chip_smoke.py's scale phase runs (its golden phase and the
# tier-1 tests leave them out: minutes each)
SCALE = ("B1", "Y1", "Y2", "B0")
# the cases whose output is kept as row digests (row_digests), not bytes
DIGESTS = ("B0",)


def make_inputs(case, d):
    """Write case's inputs into directory d; {file name: sha256}."""
    gen, args = CASES[case][:2]
    names = GENERATORS[gen](d, **args)
    return {n: sha256_file(os.path.join(d, n)) for n in names}


def sha256_file(path):
    h = hashlib.sha256()
    with open(path, "rb") as fh:
        for blk in iter(lambda: fh.read(1 << 20), b""):
            h.update(blk)
    return h.hexdigest()


def reference_hash(root=ROOT):
    """sha256 over the sorted relative paths and bytes of the reference
    package's `*.py` and `*.cpp` files."""
    files = []
    for dp, dn, fn in os.walk(os.path.join(root, "wfmash_tpu")):
        dn[:] = [x for x in dn if x != "__pycache__"]
        files += [os.path.join(dp, f) for f in fn
                  if f.endswith((".py", ".cpp"))]
    h = hashlib.sha256()
    for rel in sorted(os.path.relpath(f, root).replace(os.sep, "/")
                      for f in files):
        h.update(rel.encode() + b"\0")
        with open(os.path.join(root, rel), "rb") as fh:
            h.update(fh.read() + b"\0")
    return h.hexdigest()


def output_name(case, nbytes, sam):
    if case in DIGESTS:
        return case + ".rows.gz"
    ext = ".sam" if sam else ".paf"
    return case + ext + (".gz" if nbytes > GZIP_OVER else "")


def row_digests(out):
    """What a DIGESTS case keeps of an output too large for the tree: a
    line a row, its first 12 columns verbatim and the sha256 of the rest
    (the tags, CIGAR among them); a port's output is held to it row by
    row (chip_smoke.first_difference on both sides' digests)."""
    lines = []
    for ln in out.splitlines():
        cols = ln.split(b"\t")
        tags = hashlib.sha256(b"\t".join(cols[12:])).hexdigest().encode()
        lines.append(b"\t".join(cols[:12] + [tags]) + b"\n")
    return b"".join(lines)


def read_output(entry, golden=GOLDEN):
    """The golden file of a manifest entry, uncompressed: the output bytes,
    or for a DIGESTS case its row digests."""
    path = os.path.join(golden, entry["output"])
    with open(path, "rb") as fh:
        data = fh.read()
    return gzip.decompress(data) if path.endswith(".gz") else data


# ---- the reference run ----------------------------------------------------

def _observed_main(argv):
    """wfmash_tpu.cli.main(argv) with the jobs a segment tier takes and the
    problems a sweep span takes counted on the way (both methods called
    through unchanged); the counts go to the standard error as one
    `[torch_golden] counts {...}` line."""
    sys.path.insert(0, ROOT)
    from wfmash_tpu import cli
    from wfmash_tpu.align import wfa_pallas, wfa_pallas_seg

    tiers: dict = {}
    spans: dict = {}
    dispatch = wfa_pallas_seg.SegmentSolver._dispatch_chunk
    sweep = wfa_pallas.PallasSweeps.sweep

    def counted_dispatch(self, idxs, jobs, max_scores):
        name = TIER_NAMES.get((self.K, self.smax), f"K{self.K}s{self.smax}")
        tiers[name] = tiers.get(name, 0) + len(idxs)
        return dispatch(self, idxs, jobs, max_scores)

    def counted_sweep(self, *a, **kw):
        done0, K = a[8], a[10]
        spans[str(K)] = spans.get(str(K), 0) + int((~done0).sum())
        return sweep(self, *a, **kw)

    wfa_pallas_seg.SegmentSolver._dispatch_chunk = counted_dispatch
    wfa_pallas.PallasSweeps.sweep = counted_sweep
    try:
        rc = cli.main(argv)
    finally:
        sys.stdout.flush()
        print("[torch_golden] counts " + json.dumps(
            {"tier_jobs": tiers, "sweep_problems": spans}),
            file=sys.stderr, flush=True)
    return rc


def reach(tier_jobs, sweep_problems):
    """Which of t3-t5 took jobs, and whether a sweep ran at K >= 1024."""
    out = {t: tier_jobs.get(t, 0) > 0 for t in ("t3", "t4", "t5")}
    out["K>=1024"] = any(int(k) >= 1024 and n > 0
                         for k, n in sweep_problems.items())
    return out


def run_case(case, work, timeout):
    """Make case's inputs in work/<case>, run the reference on them and
    return (manifest entry, output bytes)."""
    gen, args, argv, env_over = CASES[case]
    d = os.path.join(work, case)
    os.makedirs(d, exist_ok=True)
    inputs = make_inputs(case, d)
    # no WFMASH_TPU_* switch of the caller's shell reaches the reference
    env = {**{k: v for k, v in os.environ.items()
              if not k.startswith("WFMASH_TPU_")}, **ENV, **env_over}
    t0 = time.monotonic()
    r = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--observe", "--", *argv],
        cwd=d, env=env, capture_output=True, timeout=timeout)
    wall = time.monotonic() - t0
    err = r.stderr.decode(errors="replace")
    if r.returncode != 0:
        raise RuntimeError(f"{case}: the reference exits {r.returncode}:\n"
                           + err[-4000:])
    counts = json.loads(re.search(r"\[torch_golden\] counts (.*)",
                                  err).group(1))
    perf = {m.group(1): float(m.group(2)) for m in re.finditer(
        r"\[wfmash::perf\] (\S+) = ([-0-9.e+]+)", err)}
    out = r.stdout
    sam = "-a" in argv
    entry = dict(
        generator=gen, args=args, inputs=inputs, argv=argv,
        env={**ENV, **env_over},
        output=output_name(case, len(out), sam),
        output_sha256=hashlib.sha256(out).hexdigest(),
        output_bytes=len(out),
        rows=sum(1 for ln in out.splitlines() if not ln.startswith(b"@")),
        wall_s=round(wall, 3), perf=perf, **counts,
        reach=reach(counts["tier_jobs"], counts["sweep_problems"]))
    return entry, out


def store(case, entry, out, golden=GOLDEN):
    """Write the output file and merge the entry into manifest.json (under
    a lock: several cases may run at once)."""
    os.makedirs(golden, exist_ok=True)
    if case in DIGESTS:
        out = row_digests(out)
        entry["digests_sha256"] = hashlib.sha256(out).hexdigest()
    data = (gzip.compress(out, mtime=0) if entry["output"].endswith(".gz")
            else out)
    with open(os.path.join(golden, entry["output"]), "wb") as fh:
        fh.write(data)
    entry["stored_sha256"] = hashlib.sha256(data).hexdigest()
    path = os.path.join(golden, "manifest.json")
    with open(path + ".lock", "w") as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)
        man = (json.load(open(path)) if os.path.exists(path)
               else {"cases": {}})
        man["reference_sha256"] = reference_hash()
        man["host"] = host_line()
        man["cases"][case] = entry
        man["cases"] = {c: man["cases"][c] for c in CASES
                        if c in man["cases"]}
        tmp = path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(man, fh, indent=1, sort_keys=False)
            fh.write("\n")
        os.replace(tmp, path)
    os.remove(path + ".lock")


def host_line():
    """The machine the walls were taken on: CPU model, cores, JAX."""
    model = "unknown CPU"
    with contextlib.suppress(OSError):
        for ln in open("/proc/cpuinfo"):
            if ln.startswith("model name"):
                model = ln.split(":", 1)[1].strip()
                break
    try:
        import jax
        jv = jax.__version__
    except ImportError:
        jv = "absent"
    return f"{model}, {os.cpu_count()} cores, JAX {jv}, CPU interpret mode"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cases", default=",".join(CASES))
    ap.add_argument("--work", default=None,
                    help="directory for the inputs [a temporary one]")
    ap.add_argument("--timeout", type=float, default=7200.0,
                    help="seconds a case may take")
    ap.add_argument("--observe", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("rest", nargs="*")
    args = ap.parse_args(argv)
    if args.observe:
        return _observed_main(args.rest)
    with (contextlib.nullcontext(args.work) if args.work
          else tempfile.TemporaryDirectory()) as work:
        for case in args.cases.split(","):
            entry, out = run_case(case, work, args.timeout)
            store(case, entry, out)
            print(f"[torch_golden] {case}: {entry['rows']} rows, "
                  f"{entry['output_bytes']} bytes, {entry['wall_s']} s, "
                  f"reach {entry['reach']}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
