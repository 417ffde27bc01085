"""The align loop's sequence cache (wfmash_tpu_torch/align/engine.py):
each name's merged record intervals, fetched once and sliced per record.

Every job built through the interval caches equals the job of a
record's own fetch (no cache) and the JAX package's job from its
whole-sequence cache, field by field; a spent budget gives the same jobs
through per-record fetches; `align.loop.fetched_bp` counts the union of
the records' clamped spans, not whole sequences; and `run_alignment`
writes the same PAF through either path.
"""

from __future__ import annotations

import dataclasses
import io
from contextlib import redirect_stdout

import numpy as np
import pytest

from util import mutate, random_dna, revcomp
from wfmash_tpu.align import engine as ref_engine
from wfmash_tpu.io.fasta import FastaReader as RefReader
from wfmash_tpu_torch import cli
from wfmash_tpu_torch.align import engine
from wfmash_tpu_torch.io.fasta import FastaReader
from wfmash_tpu_torch.params import AlignParams
from wfmash_tpu_torch.utils import perf

T_PAD, Q_PAD = 500, 300


def _write_fasta(path, seqs: dict, width: int = 60):
    """A FASTA of `width`-column lines and its .fai."""
    fai = []
    with open(path, "wb") as fh:
        for name, seq in seqs.items():
            fh.write(b">" + name.encode() + b"\n")
            fai.append(f"{name}\t{len(seq)}\t{fh.tell()}\t{width}\t"
                       f"{width + 1}\n")
            for i in range(0, len(seq), width):
                fh.write(seq[i:i + width] + b"\n")
    with open(f"{path}.fai", "w") as fh:
        fh.writelines(fai)


def _messy(rng, seq: bytes) -> bytes:
    """Lower case and IUPAC codes here and there: normalisation matters."""
    arr = np.frombuffer(seq, dtype=np.uint8).copy()
    low = rng.random(len(arr)) < 0.2
    arr[low] = arr[low] | 0x20
    arr[rng.random(len(arr)) < 0.01] = ord("r")
    arr[rng.random(len(arr)) < 0.01] = ord("N")
    return arr.tobytes()


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """t.fa: chrA 23456, chrB 9001, chrC 4000 bp. q.fa: qA a mutated copy
    of chrA[:12345], qB the reverse complement of a mutated chrB[:6000]."""
    d = tmp_path_factory.mktemp("fetch")
    rng = np.random.default_rng(15)
    t = {"chrA": random_dna(rng, 23_456), "chrB": random_dna(rng, 9_001),
         "chrC": random_dna(rng, 4_000)}
    q = {"qA": mutate(rng, t["chrA"][:12_345], 0.01),
         "qB": revcomp(mutate(rng, t["chrB"][:6_000], 0.01))}
    _write_fasta(d / "t.fa", {k: _messy(rng, v) for k, v in t.items()})
    _write_fasta(d / "q.fa", {k: _messy(rng, v) for k, v in q.items()})
    return d


def _paf(q, qlen, qs, qe, strand, t, tlen, ts, te, chain=None):
    row = (f"{q}\t{qlen}\t{qs}\t{qe}\t{strand}\t{t}\t{tlen}\t{ts}\t{te}\t"
           f"{te - ts}\t{te - ts}\t60\tid:f:0.95")
    if chain is not None:
        row += f"\tkc:f:1\tch:Z:{chain}"
    return row + "\n"


# (name, PAF line): target padding 500 on both ends, query padding 300 on
# chain ends only
PAIR_ROWS = [
    ("scattered",
     _paf("qA", 12345, 800, 1800, "+", "chrA", 23456, 800, 1800)),
    ("scattered", _paf("qA", 12345, 9000, 9800, "+", "chrA", 23456,
                       9000, 9800)),
    ("overlapping", _paf("qA", 12345, 1500, 3200, "+", "chrA", 23456,
                         1500, 3200)),
    # padded target [4500, 6500) and [6500, 8500): they touch
    ("touching", _paf("qA", 12345, 5000, 6000, "+", "chrA", 23456,
                      5000, 6000)),
    ("touching", _paf("qA", 12345, 7000, 8000, "+", "chrA", 23456,
                      7000, 8000)),
    # the middle of a chain of three: no query padding; query [1000,
    # 2000) and the next piece's [2000, 2500) touch
    ("chain middle", _paf("qA", 12345, 1000, 2000, "+", "chrA", 23456,
                          1000, 2000, chain="7.2.3")),
    ("chain middle", _paf("qA", 12345, 2000, 2500, "+", "chrA", 23456,
                          2000, 2500, chain="8.2.3")),
    # the PAF claims longer sequences than the FASTA holds: the fetch
    # clamps query and target
    ("past the end", _paf("qA", 12700, 12000, 12600, "+", "chrC", 4500,
                          3500, 4400, chain="9.1.1")),
    ("minus strand", _paf("qB", 6000, 1000, 2500, "-", "chrB", 9001,
                          3500, 5000)),
    ("minus strand", _paf("qB", 6000, 4000, 5900, "-", "chrB", 9001,
                          100, 2000)),
    ("absent target", _paf("qA", 12345, 100, 900, "+", "chrZ", 23456,
                           100, 900)),
    ("absent query", _paf("qZ", 12345, 100, 900, "+", "chrA", 23456,
                          100, 900)),
]

# query and target the same file
SELF_ROWS = [
    ("same file", _paf("chrB", 9001, 100, 1900, "+", "chrA", 23456,
                       200, 2000)),
    ("same file", _paf("chrA", 23456, 1800, 3000, "+", "chrA", 23456,
                       20000, 21200)),
    ("same file", _paf("chrC", 4000, 3000, 3999, "-", "chrB", 9001,
                       8000, 9001)),
]


def _params(tdir, query, paf=None):
    return AlignParams(
        ref_sequences=[str(tdir / "t.fa")],
        query_sequences=[str(tdir / query)],
        mashmap_paf_file=str(paf) if paf else "",
        target_padding=T_PAD, query_padding=Q_PAD)


def _fields(job):
    return {f.name: getattr(job, f.name)
            for f in dataclasses.fields(job)}


def _jobs(files, query, lines, cached=True):
    """Each line's port job (or the exception it raised) through the
    interval caches (`cached`) or through per-record fetches."""
    rows = [engine.parse_mashmap_row(line, T_PAD, Q_PAD) for line in lines]
    tr = FastaReader(str(files / "t.fa"))
    qr = tr if query == "t.fa" else FastaReader(str(files / query))
    caches = (engine._plan_caches(rows, tr, qr, query == "t.fa")
              if cached else (None, None))
    out = []
    for row in rows:
        try:
            out.append(_fields(engine.build_job(
                row, tr, qr, _params(files, query), *caches)))
        except KeyError as e:
            out.append(e)
    return out


def _reference_jobs(files, query, lines):
    """The JAX package's jobs from its whole-sequence caches."""
    from wfmash_tpu.params import AlignParams as RefParams

    tr = RefReader(str(files / "t.fa"))
    qr = tr if query == "t.fa" else RefReader(str(files / query))
    budget = [10**9]
    tc = ref_engine._NormCache(tr, budget)
    qc = tc if query == "t.fa" else ref_engine._NormCache(qr, budget)
    params = RefParams(ref_sequences=[str(files / "t.fa")],
                       query_sequences=[str(files / query)],
                       target_padding=T_PAD, query_padding=Q_PAD)
    out = []
    for line in lines:
        row = ref_engine.parse_mashmap_row(line, T_PAD, Q_PAD)
        try:
            out.append(_fields(ref_engine.build_job(
                row, tr, qr, params, tc, qc)))
        except KeyError as e:
            out.append(e)
    return out


@pytest.mark.parametrize("query,cases", [("q.fa", PAIR_ROWS),
                                         ("t.fa", SELF_ROWS)],
                         ids=["pair", "same-file"])
def test_interval_jobs_equal_per_record_and_reference_jobs(
        files, query, cases, monkeypatch):
    monkeypatch.delenv("WFMASH_TPU_ALIGN_SEQ_CACHE_MB", raising=False)
    lines = [line for _, line in cases]
    got = _jobs(files, query, lines)
    plain = _jobs(files, query, lines, cached=False)
    ref = _reference_jobs(files, query, lines)
    for (case, _), g, p, r in zip(cases, got, plain, ref):
        if case.startswith("absent"):
            assert all(isinstance(x, KeyError) for x in (g, p, r)), case
            continue
        assert isinstance(g, dict), (case, g)
        assert g == p, case
        assert g["query"] == r["query"] and g["target"] == r["target"], case
        assert {k: v for k, v in g.items() if k not in ("query", "target")} \
            == {k: v for k, v in r.items() if k not in ("query", "target")}, \
            case
    by_case = {case: g for (case, _), g in zip(cases, got)}
    if query == "q.fa":
        clamped = by_case["past the end"]
        assert (clamped["query_length"], clamped["target_length"]) == (
            12_345 - 11_700, 4_000 - 3_000)
        assert set(by_case["minus strand"]["query"]) <= set(b"ACGTN")


def test_a_spent_budget_gives_the_same_jobs_per_record(files, monkeypatch):
    """A budget of ten bytes holds no name: every record fetches its own
    ranges, counted record by record, and the jobs are the same."""
    lines = [line for _, line in PAIR_ROWS]
    monkeypatch.delenv("WFMASH_TPU_ALIGN_SEQ_CACHE_MB", raising=False)
    held = _jobs(files, "q.fa", lines)
    monkeypatch.setenv("WFMASH_TPU_ALIGN_SEQ_CACHE_MB", "0.00001")
    spent = _jobs(files, "q.fa", lines)
    for a, b in zip(held, spent):
        assert (a == b) if isinstance(a, dict) else isinstance(b, KeyError)
    perf.reset()
    found = _jobs(files, "q.fa", [line for case, line in PAIR_ROWS
                                  if not case.startswith("absent")])
    assert perf.get("align.loop.fetched_bp") == sum(
        j["query_length"] + j["target_length"] for j in found)


def _runs(spans: dict, lengths: dict) -> list:
    """(name, first, last) of each run of bases that the [start, end)
    spans, clamped to each name, cover: what one fetch a run reads."""
    out = []
    for name, ranges in spans.items():
        mask = np.zeros(lengths[name] + 2, dtype=np.int8)
        for lo, hi in ranges:
            mask[1 + max(0, lo):1 + min(hi, lengths[name])] = 1
        edges = np.flatnonzero(np.diff(mask))
        out += [(name, int(lo), int(hi) - 1)
                for lo, hi in zip(edges[::2], edges[1::2])]
    return out


def _count_fetches(monkeypatch) -> list:
    calls = []
    fetch = FastaReader.fetch
    monkeypatch.setattr(FastaReader, "fetch", lambda self, *a: (
        calls.append(a), fetch(self, *a))[1])
    return calls


def test_fetched_bp_is_the_union_of_the_records_spans(files, monkeypatch):
    """Scattered records read the union of their clamped spans, one fetch
    a covered run, far less than the sequences they sit on; records that
    tile a sequence, in both roles of one file, read it exactly once."""
    monkeypatch.delenv("WFMASH_TPU_ALIGN_SEQ_CACHE_MB", raising=False)
    lines = [line for case, line in PAIR_ROWS
             if not case.startswith("absent")]
    calls = _count_fetches(monkeypatch)
    perf.reset()
    _jobs(files, "q.fa", lines)
    tlen = {r.name: r.length for r in FastaReader(str(files / "t.fa")).records}
    qlen = {r.name: r.length for r in FastaReader(str(files / "q.fa")).records}
    tspans, qspans = {}, {}
    for line in lines:
        row = engine.parse_mashmap_row(line, T_PAD, Q_PAD)
        tspans.setdefault(row["target_name"], []).append(
            (row["r_start"], row["r_end"]))
        qspans.setdefault(row["query_name"], []).append(
            (row["q_start"], row["q_end"]))
    runs = _runs(tspans, tlen) + _runs(qspans, qlen)
    assert sorted(calls) == sorted(runs)
    want = sum(hi + 1 - lo for _, lo, hi in runs)
    assert perf.get("align.loop.fetched_bp") == want
    assert want < 0.6 * (sum(tlen.values()) + sum(qlen.values()))

    # chrA tiled by pieces that touch, as query and as target: one
    # interval, fetched once
    tiles = [_paf("chrA", 23456, s, min(s + 2_500, 23_456), "+", "chrA",
                  23456, s, min(s + 2_500, 23_456))
             for s in range(0, 23_456, 2_500)]
    calls.clear()
    perf.reset()
    _jobs(files, "t.fa", tiles)
    assert perf.get("align.loop.fetched_bp") == 23_456
    assert calls == [("chrA", 0, 23_455)]


@pytest.fixture(scope="module")
def mapped(tmp_path_factory):
    """A 30 kb target, three 8 kb queries and the port's mapping PAF."""
    d = tmp_path_factory.mktemp("fetch_run")
    rng = np.random.default_rng(21)
    t = random_dna(rng, 30_000)
    _write_fasta(d / "t.fa", {"t1": t, "t2": random_dna(rng, 5_000)})
    _write_fasta(d / "q.fa", {
        f"q{i}": mutate(rng, t[i * 9_000:i * 9_000 + 8_000], 0.01)
        for i in range(3)})
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("WFMASH_TPU_TORCH_DEVICE", "cpu")
        mp.setenv("WFMASH_TPU_DEVICE_L1", "0")
        buf = io.StringIO()
        with redirect_stdout(buf):
            assert cli.main([str(d / "t.fa"), str(d / "q.fa"), "-m",
                             "-p", "90", "-j", "0"]) == 0
    lines = buf.getvalue().splitlines(keepends=True)
    assert len(lines) >= 3
    return d, lines


def _run(d, lines, monkeypatch, budget=None):
    """run_alignment of the port on `lines`; (PAF text, fetched_bp)."""
    monkeypatch.setenv("WFMASH_TPU_TORCH_DEVICE", "cpu")
    monkeypatch.delenv("WFMASH_TPU_SEGMENTED", raising=False)
    if budget is None:
        monkeypatch.delenv("WFMASH_TPU_ALIGN_SEQ_CACHE_MB", raising=False)
    else:
        monkeypatch.setenv("WFMASH_TPU_ALIGN_SEQ_CACHE_MB", budget)
    (d / "chunk.paf").write_text("".join(lines))
    params = _params(d, "q.fa", d / "chunk.paf").finalize(1000)
    perf.reset()
    out = io.StringIO()
    engine.run_alignment(params, out, "cpu")
    return out.getvalue(), perf.get("align.loop.fetched_bp")


def test_run_alignment_writes_the_same_paf_through_either_path(
        mapped, monkeypatch):
    """Every other record of the mapping, as a chunk holds them: the
    intervals read no more than the records' own fetches and the PAF is
    the same as through a spent budget."""
    d, lines = mapped
    chunk = lines[::2]
    held, held_bp = _run(d, chunk, monkeypatch)
    spent, spent_bp = _run(d, chunk, monkeypatch, budget="0")
    assert held == spent and held.count("\n") >= len(chunk)
    assert "\tcg:Z:" in held
    assert 0 < held_bp <= spent_bp


def test_absent_names_are_logged_and_skipped(mapped, monkeypatch, capsys):
    d, lines = mapped
    absent = [lines[0].replace("\tt1\t", "\tt9\t", 1),
              "q9" + lines[0][lines[0].index("\t"):]]
    full, _ = _run(d, lines[:2], monkeypatch)
    capsys.readouterr()
    got, _ = _run(d, absent[:1] + lines[:2] + absent[1:], monkeypatch)
    err = capsys.readouterr().err
    assert got == full
    assert err.count("[wfmash::align] Error extracting record") == 2
