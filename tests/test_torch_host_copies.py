"""The port's copies of the reference's host modules, held to their
originals on the same inputs.

wfmash_tpu_torch keeps its own copy of every host module it runs (it
imports nothing of wfmash_tpu). This file covers the copies no other
test_torch_* file holds against the reference: io/fasta.py (plain, BGZF
with and without .gzi, the gzip spool, the error on a missing .fai), io/seqids.py,
index/store.py, map/external.py, map/ani.py, map/stats.py,
sketch/murmur.py, cli.parse_args, utils/tempfiles.py and
utils/progress.py; the mapping modes of runner.run_mapping, on the port's
host stages and on its device stages over CPU tensors (the per-row host
handoff under each mode); and map/engine.Mapper.sketch_query, which the
port computes with the batched native sketcher where the reference
sketches each fragment alone. Each case builds its inputs in tmp_path
after the reference's own test of the module, runs them through both
packages and requires equal results: bytes for files and outputs, values
for everything returned.
"""

from __future__ import annotations

import dataclasses
import gzip
import importlib
import io
import os
import re
import struct
import zlib

import numpy as np
import pytest
import torch

from util import mutate, random_dna, revcomp, write_fasta

torch.set_num_threads(1)

U64 = 0xFFFFFFFFFFFFFFFF


def _both(name):
    """(the reference's module `name`, the port's copy of it)."""
    return tuple(importlib.import_module(f"{pkg}.{name}")
                 for pkg in ("wfmash_tpu", "wfmash_tpu_torch"))


# ---- io/fasta.py -----------------------------------------------------------

def _bgzf(data: bytes, block: int):
    """(BGZF bytes with the EOF marker, the .gzi bytes for its blocks)."""
    out = bytearray()
    pairs = []
    for i in range(0, len(data), block):
        if i:
            pairs.append((len(out), i))
        chunk = data[i:i + block]
        co = zlib.compressobj(6, zlib.DEFLATED, -15)
        comp = co.compress(chunk) + co.flush()
        total = 12 + 6 + len(comp) + 8
        out += struct.pack("<4BI2BH2B2H", 0x1f, 0x8b, 8, 4, 0, 0, 0, 6,
                           66, 67, 2, total - 1)
        out += comp + struct.pack("<II", zlib.crc32(chunk) & 0xFFFFFFFF,
                                  len(chunk))
    out += bytes.fromhex(
        "1f8b08040000000000ff0600424302001b0003000000000000000000")
    gzi = struct.pack("<Q", len(pairs)) + b"".join(
        struct.pack("<QQ", c, u) for c, u in pairs)
    return bytes(out), gzi


def _fasta_bytes(seqs, width=60):
    buf, fai = bytearray(), []
    for name, seq in seqs.items():
        buf += f">{name}\n".encode()
        off = len(buf)
        for i in range(0, len(seq), width):
            buf += seq[i:i + width] + b"\n"
        fai.append(f"{name}\t{len(seq)}\t{off}\t{width}\t{width + 1}\n")
    return bytes(buf), "".join(fai)


FASTA_KINDS = ("plain", "plain_no_fai", "bgzf_4k_blocks", "bgzf_gzi",
               "gzip_spool")


def _write_kind(d, kind, seqs):
    data, fai = _fasta_bytes(seqs)
    if kind.startswith("plain"):
        path = d / "x.fa"
        path.write_bytes(data)
    elif kind == "gzip_spool":
        path = d / "x.fa.gz"
        path.write_bytes(gzip.compress(data, mtime=0))   # not BGZF
    else:
        path = d / "x.fa.gz"
        blob, gzi = _bgzf(data, 4096 if kind == "bgzf_4k_blocks" else 60000)
        path.write_bytes(blob)
        if kind == "bgzf_gzi":
            (d / "x.fa.gz.gzi").write_bytes(gzi)
    if kind != "plain_no_fai":
        (d / (path.name + ".fai")).write_text(fai)
    return str(path)


def _fasta_trace(fasta, path, rng_seed):
    """What a reader of the module `fasta` answers on path: names,
    lengths, its kind, whole sequences, 60 random ranges, the bounded
    block cache, the block table (scan and .gzi) and the files left beside
    the input; or the error the reader raises."""
    try:
        r = fasta.FastaReader(path)
    except OSError as e:
        return [type(e).__name__, str(e).replace(path, "PATH")]
    rng = np.random.default_rng(rng_seed)
    out = [r.names, [r.seq_len(n) for n in r.names]]
    out += [r.fetch(n) for n in r.names]
    out.append(r._kind)
    if r._kind == "bgzf":
        r._bgzf.CACHE_BLOCKS = 8
    for _ in range(60):
        n = r.names[int(rng.integers(len(r.names)))]
        a = int(rng.integers(0, r.seq_len(n)))
        b = min(r.seq_len(n) - 1, a + int(rng.integers(0, 3000)))
        out.append(r.fetch(n, a, b))
        if r._kind == "bgzf":
            out.append(len(r._bgzf._cache))
    out.append(r._data is None)
    out.append(fasta._scan_bgzf_blocks(path))
    out.append(fasta._read_gzi(path + ".gzi"))
    d = os.path.dirname(path)
    out.append(sorted((f, open(os.path.join(d, f), "rb").read())
                      for f in os.listdir(d)))
    return out


@pytest.mark.parametrize("kind", FASTA_KINDS)
def test_fasta_reader(tmp_path, kind):
    """After test_fasta_bgzf.py:96, :114, :135: every answer of the port's
    FastaReader equals the reference's, on each container."""
    rng = np.random.default_rng(5)
    seqs = {"s1": random_dna(rng, 70_001), "s2": random_dna(rng, 12_345),
            "s3": random_dna(rng, 500).lower() + b"NNNN"}
    got = []
    for i, fasta in enumerate(_both("io.fasta")):
        d = tmp_path / str(i)
        d.mkdir()
        got.append(_fasta_trace(fasta, _write_kind(d, kind, seqs), 1))
    assert got[0] == got[1]
    if kind == "plain_no_fai":
        assert got[1][0] == "FileNotFoundError"
    else:
        assert got[1][2:5] == [seqs["s1"], seqs["s2"], seqs["s3"]]


# ---- io/seqids.py -----------------------------------------------------------

SEQIDS_CASES = {
    "pansn": dict(query_prefixes=None, target_prefixes=None,
                  prefix_delim="#"),
    "no_delim": dict(query_prefixes=None, target_prefixes=None,
                     prefix_delim=""),
    "prefixes": dict(query_prefixes=["g3"], target_prefixes=["g1", "g2#1"],
                     prefix_delim="#"),
    "lists": dict(query_prefixes=None, target_prefixes=None,
                  prefix_delim="#", lists=True),
}


@pytest.mark.parametrize("case", sorted(SEQIDS_CASES))
def test_sequence_ids(tmp_path, case):
    kw = dict(SEQIDS_CASES[case])
    rng = np.random.default_rng(3)
    write_fasta(tmp_path / "t.fa", {
        "g1#1#chr1": random_dna(rng, 900), "g1#1#chr2": random_dna(rng, 700),
        "g2#1#chr1": random_dna(rng, 800), "g2#2#chr1": random_dna(rng, 600)})
    write_fasta(tmp_path / "q.fa", {
        "g3#1#chr1": random_dna(rng, 500), "g1#1#chr1x": random_dna(rng, 400),
        "plain": random_dna(rng, 300)})
    if kw.pop("lists", False):
        (tmp_path / "ql.txt").write_text("g3#1#chr1\nplain\n")
        (tmp_path / "tl.txt").write_text("g1#1#chr2\ng2#1#chr1\n")
        kw.update(query_list=str(tmp_path / "ql.txt"),
                  target_list=str(tmp_path / "tl.txt"))
    got = []
    for seqids in _both("io.seqids"):
        m = seqids.SequenceIdManager(
            [str(tmp_path / "q.fa")], [str(tmp_path / "t.fa")], **kw)
        ids = range(len(m.names))
        got.append((m.names, m.lengths, m.group_ids, m.group_id_to_prefix,
                    m.name_to_id, m.get_query_sequence_names(),
                    m.get_target_sequence_names(),
                    [m.get_ref_group(i) for i in ids],
                    [m.get_sequence_length(i) for i in ids]))
    assert got[0] == got[1]


# ---- the mapping: runner.run_mapping under each mode ------------------------

def _mode_inputs(case):
    """(target seqs, query seqs, MapParams overrides) after
    test_mapping_modes.py and test_mapping_e2e.py."""
    modes = dict(percentage_identity=0.85, auto_pct_identity=False,
                 scaffold_gap=0)
    e2e = dict(percentage_identity=0.9, auto_pct_identity=False)
    if case in ("one_to_one", "map_n1"):
        rng = np.random.default_rng(0)
        t = random_dna(rng, 30_000)
        extra = dict(num_mappings_for_segment=1)
        if case == "one_to_one":
            from wfmash_tpu.params import FILTER_ONETOONE
            extra["filter_mode"] = FILTER_ONETOONE
        return ({"t1": t}, {"good": t[2_000:22_000],
                            "bad": mutate(rng, t[2_000:22_000], 0.05)},
                {**modes, **extra})
    if case == "sparsify":
        rng = np.random.default_rng(1)
        t = random_dna(rng, 60_000)
        return ({"t1": t}, {"q1": mutate(rng, t, 0.01)},
                {**modes, "sparsity_hash_threshold": U64 // 16})
    if case == "lower_triangular":
        rng = np.random.default_rng(2)
        a = random_dna(rng, 20_000)
        s = {"s1": a, "s2": mutate(rng, a, 0.01)}
        return s, dict(s), {**modes, "skip_self": True,
                            "lower_triangular": True}
    if case == "merge_off":
        rng = np.random.default_rng(3)
        t = random_dna(rng, 20_000)
        return ({"t1": t}, {"q1": mutate(rng, t[1_000:15_000], 0.01)},
                {**modes, "merge_mappings": False})
    if case in ("no_split", "no_split_scaffold"):
        rng = np.random.default_rng(71)
        base = random_dna(rng, 30_000)
        extra = dict(percentage_identity=0.85, auto_pct_identity=False,
                     split=False)
        if case == "no_split":
            extra["scaffold_gap"] = 0
        return {"t1": base}, {"q1": mutate(rng, base, 0.02)}, extra
    if case == "forward":
        rng = np.random.default_rng(0)
        t = random_dna(rng, 30_000)
        return {"t1": t}, {"q1": t[5_000:15_000]}, e2e
    if case == "reverse":
        rng = np.random.default_rng(1)
        t = random_dna(rng, 30_000)
        return ({"t1": t}, {"q1": revcomp(t[20_000:26_000])},
                {**e2e, "scaffold_gap": 0})
    if case == "diverged":
        rng = np.random.default_rng(2)
        t = random_dna(rng, 25_000)
        return {"t1": t}, {"q1": mutate(rng, t[2_000:14_000], 0.05)}, e2e
    if case == "self_group":
        rng = np.random.default_rng(4)
        seq = random_dna(rng, 15_000)
        s = {"sampleA#1#chr1": seq, "sampleA#2#chr1": seq,
             "sampleB#1#chr1": seq, "sampleB#1#chr2": seq}
        return s, dict(s), e2e
    if case == "max_length_split":
        rng = np.random.default_rng(6)
        t = random_dna(rng, 120_000)
        return {"t1": t}, {"q1": t}, {**e2e, "max_mapping_length": 50_000}
    if case == "many_targets":
        # several candidates a fragment: one query against five copies
        rng = np.random.default_rng(8)
        base = random_dna(rng, 40_000)
        t = {f"t{i}": mutate(rng, base, 0.01 * (i + 1)) for i in range(5)}
        return t, {"q1": mutate(rng, base, 0.01)}, {
            **modes, "num_mappings_for_segment": 3}
    raise KeyError(case)


MODE_CASES = ("one_to_one", "map_n1", "sparsify", "lower_triangular",
              "merge_off", "no_split", "no_split_scaffold", "forward",
              "reverse", "diverged", "self_group", "max_length_split",
              "many_targets")


def _map_both(tmp_path, case, monkeypatch, route):
    rparams, pparams = _both("params")
    rrunner, prunner = _both("runner")

    tseqs, qseqs, over = _mode_inputs(case)
    write_fasta(tmp_path / "t.fa", tseqs)
    write_fasta(tmp_path / "q.fa", qseqs)
    common = dict(ref_sequences=[str(tmp_path / "t.fa")],
                  query_sequences=[str(tmp_path / "q.fa")], **over)
    want = io.StringIO()
    rrunner.run_mapping(rparams.MapParams(**common).finalize(), want)
    monkeypatch.setenv("WFMASH_TPU_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("WFMASH_TPU_DEVICE_L1", route)
    got = io.StringIO()
    prunner.run_mapping(pparams.MapParams(**common).finalize(), got)
    return want.getvalue(), got.getvalue()


@pytest.mark.parametrize("route", ["0", "1"])
@pytest.mark.parametrize("case", MODE_CASES)
def test_mapping_modes(tmp_path, monkeypatch, case, route):
    """run_mapping of both packages under each mode of
    test_mapping_modes.py:32-111 and case of test_mapping_e2e.py:32-133:
    the port's PAF bytes equal the reference's on its host stages (0) and
    on its device stages over CPU tensors (1)."""
    want, got = _map_both(tmp_path, case, monkeypatch, route)
    assert got == want
    # the reference's own cases: -N with scaffolds maps nothing, and the
    # struct hashes of this input's mappings all lie above U64 // 16
    if case not in ("no_split_scaffold", "sparsify"):
        assert want, f"{case}: the fixture maps nothing"


# ---- index/store.py ---------------------------------------------------------

def _index_common(tmp_path):
    rng = np.random.default_rng(0)
    t1 = random_dna(rng, 12_000)
    t2 = random_dna(rng, 9_000)
    q = mutate(rng, t1[1_000:9_000], 0.02)
    write_fasta(tmp_path / "t.fa", {"t1": t1, "t2": t2})
    write_fasta(tmp_path / "q.fa", {"q1": q})
    return dict(ref_sequences=[str(tmp_path / "t.fa")],
                query_sequences=[str(tmp_path / "q.fa")],
                percentage_identity=0.9, auto_pct_identity=False,
                index_by_size=10_000, scaffold_gap=0)


PACKAGES = ("wfmash_tpu", "wfmash_tpu_torch")


def _run_map(pkg, mp_kw):
    out = io.StringIO()
    mp = importlib.import_module(f"{pkg}.params").MapParams(**mp_kw)
    importlib.import_module(f"{pkg}.runner").run_mapping(mp.finalize(), out)
    return out.getvalue()


@pytest.mark.parametrize("writer", PACKAGES)
def test_index_store_roundtrip(tmp_path, monkeypatch, writer):
    """After test_index_store.py:14: both packages write the same index
    bytes (two subsets), and each package reads the index the `writer`
    package wrote to the reference's direct mapping bytes."""
    monkeypatch.setenv("WFMASH_TPU_TORCH_DEVICE", "cpu")
    common = _index_common(tmp_path)
    direct = _run_map("wfmash_tpu", common)
    assert direct.strip()
    blobs = []
    for pkg in PACKAGES:
        path = tmp_path / f"{pkg}.idx"
        _run_map(pkg, dict(common, index_filename=str(path),
                           create_index_only=True))
        blobs.append(path.read_bytes())
    assert blobs[0] == blobs[1]
    idx = str(tmp_path / f"{writer}.idx")
    for pkg in PACKAGES:
        assert _run_map(pkg, dict(common, index_filename=idx)) == direct


def test_index_store_rejects_mismatched_params(tmp_path, monkeypatch):
    """After test_index_store.py:57: both refuse an index written under
    other parameters, with the same message."""
    monkeypatch.setenv("WFMASH_TPU_TORCH_DEVICE", "cpu")
    rng = np.random.default_rng(1)
    t1 = random_dna(rng, 8_000)
    write_fasta(tmp_path / "t.fa", {"t1": t1})
    write_fasta(tmp_path / "q.fa", {"q1": t1[:4_000]})
    common = dict(ref_sequences=[str(tmp_path / "t.fa")],
                  query_sequences=[str(tmp_path / "q.fa")],
                  percentage_identity=0.9, auto_pct_identity=False)
    msgs = []
    for pkg in PACKAGES:
        idx = str(tmp_path / f"{pkg}.idx")
        _run_map(pkg, dict(common, index_filename=idx,
                           create_index_only=True))
        with pytest.raises(ValueError, match="do not match") as e:
            _run_map(pkg, dict(common, kmer_size=17, index_filename=idx))
        msgs.append(str(e.value).replace(idx, "IDX"))
    assert msgs[0] == msgs[1]


# ---- map/external.py ---------------------------------------------------------

def _external_inputs(tmp_path, case):
    if case == "cigar_reattached":
        rng = np.random.default_rng(1)
        target = random_dna(rng, 30_000)
        write_fasta(tmp_path / "t.fa", {"t1": target})
        write_fasta(tmp_path / "q.fa", {"q1": target[2_000:12_000]})
        (tmp_path / "seeds.paf").write_text(
            "q1\t10000\t0\t10000\t+\tt1\t30000\t2000\t12000\t"
            "500\t10000\t60\tid:f:99.0\tcg:Z:10000=\n")
        return dict(merge_mappings=False, scaffold_gap=0)
    rng = np.random.default_rng(0)
    target = random_dna(rng, 60_000)
    write_fasta(tmp_path / "t.fa", {"t1": target})
    write_fasta(tmp_path / "q.fa", {"q1": target[5_000:45_000]})
    with open(tmp_path / "seeds.paf", "w") as fh:
        for i in range(0, 40_000 - 1000, 1000):
            fh.write(f"q1\t40000\t{i}\t{i + 1000}\t+\tt1\t60000\t{5000 + i}"
                     f"\t{6000 + i}\t50\t1000\t60\tid:f:99.0\t"
                     "cg:Z:1000=\n")
        fh.write("q1\t40000\t100\t1100\t+\tt1\t60000\t55000\t56000\t"
                 "50\t1000\t60\tid:f:99.0\n")
    return dict(scaffold_gap=10_000 if case == "scaffold" else 0,
                scaffold_min_length=5_000, scaffold_max_deviation=2_000)


@pytest.mark.parametrize("case", ["scaffold", "no_scaffold",
                                  "cigar_reattached"])
def test_external_seeds(tmp_path, case):
    """After test_external.py:50-71 and its CIGAR case: the annotated rows
    of process_external_seeds are the reference's bytes."""
    from wfmash_tpu.map import external as rext
    from wfmash_tpu.params import MapParams as RMP
    from wfmash_tpu_torch.map import external as pext
    from wfmash_tpu_torch.params import MapParams as PMP

    over = _external_inputs(tmp_path, case)
    kw = dict(ref_sequences=[str(tmp_path / "t.fa")],
              query_sequences=[str(tmp_path / "q.fa")],
              percentage_identity=0.9, auto_pct_identity=False,
              external_seeds_file=str(tmp_path / "seeds.paf"),
              use_external_seeds=True, **over)
    outs = []
    for ext, MP in ((rext, RMP), (pext, PMP)):
        out = io.StringIO()
        ext.process_external_seeds(MP(**kw).finalize(), out)
        outs.append(out.getvalue())
    assert outs[0] == outs[1] and outs[0]


# ---- map/ani.py and map/stats.py ---------------------------------------------

@pytest.mark.parametrize("groups,percentile", [(2, 50), (3, 25), (3, 75)])
def test_ani_identity(tmp_path, groups, percentile):
    """After test_mapping_modes.py's ANI case: the auto identity of both
    packages is the same number."""
    from wfmash_tpu.map.ani import estimate_identity_for_groups as rani
    from wfmash_tpu.params import MapParams as RMP
    from wfmash_tpu_torch.map.ani import estimate_identity_for_groups as pani
    from wfmash_tpu_torch.params import MapParams as PMP

    rng = np.random.default_rng(4)
    base = random_dna(rng, 120_000)
    seqs = {f"g{g + 1}#1#c": mutate(rng, base, 0.02 * g)
            for g in range(groups)}
    write_fasta(tmp_path / "all.fa", seqs)
    kw = dict(ref_sequences=[str(tmp_path / "all.fa")],
              query_sequences=[str(tmp_path / "all.fa")],
              auto_pct_identity=True, ani_percentile=percentile)
    a = rani(RMP(**kw).finalize())
    b = pani(PMP(**kw).finalize())
    assert a is not None and a == b


def test_map_stats():
    """Every function of map/stats.py over a grid of its arguments."""
    from wfmash_tpu.map import stats as r
    from wfmash_tpu_torch.map import stats as p

    for k in (11, 15, 19):
        for j in np.linspace(0.0, 1.0, 23):
            assert r.j2md(float(j), k) == p.j2md(float(j), k)
            assert r.md2j(float(j), k) == p.md2j(float(j), k)
        for s in (50, 200):
            for d in (0.0, 0.01, 0.05, 0.2):
                for ci in (0.75, 0.95, 0.999):
                    assert r.md_lower_bound(d, s, k, ci) == \
                        p.md_lower_bound(d, s, k, ci)
            for ident in (0.7, 0.85, 0.9, 0.95, 0.99):
                assert r.estimate_minimum_hits(s, k, ident) == \
                    p.estimate_minimum_hits(s, k, ident)
                assert r.estimate_minimum_hits_relaxed(s, k, ident, 0.75) \
                    == p.estimate_minimum_hits_relaxed(s, k, ident, 0.75)
    for ss, diff, conf in ((100, 0.0, 0.999), (237, 0.01, 0.95)):
        np.testing.assert_array_equal(
            r.compute_sketch_cutoffs(ss, 15, diff, conf),
            p.compute_sketch_cutoffs(ss, 15, diff, conf))


# ---- sketch/murmur.py -------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 42, 0xFFFFFFFF])
def test_murmur(seed):
    """The scalar hash over keys of 0-40 bytes and the vectorised hash of
    64-bit keys, with each seed."""
    from wfmash_tpu.sketch import murmur as r
    from wfmash_tpu_torch.sketch import murmur as p

    rng = np.random.default_rng(seed)
    for n in range(41):
        key = bytes(rng.integers(0, 256, n, dtype=np.uint8))
        assert r.murmur3_low64_scalar(key, seed) == \
            p.murmur3_low64_scalar(key, seed)
    keys = rng.integers(0, 2**63, 4096, dtype=np.int64).astype(np.uint64)
    keys[:4] = [0, 1, U64, 2**63]
    np.testing.assert_array_equal(r.murmur3_x64_128_low64(keys, seed),
                                  p.murmur3_x64_128_low64(keys, seed))


# ---- map/engine.py: sketch_query ----------------------------------------------

SKETCH_QUERIES = ("plain", "tail", "lowercase_n", "low_complexity", "short")


def _sketch_query_seq(case):
    rng = np.random.default_rng(9)
    if case == "plain":
        return random_dna(rng, 20_000)
    if case == "tail":
        return random_dna(rng, 20_777)
    if case == "lowercase_n":
        a = bytearray(random_dna(rng, 12_345))
        a[100:3000] = bytes(a[100:3000]).lower()
        a[5000:5600] = b"N" * 600
        return bytes(a)
    if case == "low_complexity":
        return b"AC" * 2500 + random_dna(rng, 3000) + b"A" * 2200
    if case == "short":
        return random_dna(rng, 1_500)
    raise KeyError(case)


@pytest.mark.parametrize("case", SKETCH_QUERIES)
def test_sketch_query(tmp_path, case):
    """Mapper.sketch_query: the port's batched native sketcher gives every
    fragment the sketch (hashes, positions, strands, complexity) and the
    gate the reference's per-fragment sketch_fragment gives."""
    from wfmash_tpu import cli as rcli
    from wfmash_tpu.io.seqids import SequenceIdManager as RIdm
    from wfmash_tpu.map.engine import Mapper as RMapper
    from wfmash_tpu_torch import cli as pcli
    from wfmash_tpu_torch.io.seqids import SequenceIdManager as PIdm
    from wfmash_tpu_torch.map.engine import Mapper as PMapper

    seq = _sketch_query_seq(case)
    rng = np.random.default_rng(10)
    write_fasta(tmp_path / "t.fa", {"t1": random_dna(rng, 30_000)})
    write_fasta(tmp_path / "q.fa", {"q1": seq})
    argv = [str(tmp_path / "t.fa"), str(tmp_path / "q.fa"), "-m", "-p", "90"]
    got = []
    for cli, Idm, Mapper in ((rcli, RIdm, RMapper), (pcli, PIdm, PMapper)):
        mp = cli.parse_args(argv)[0]
        idm = Idm(mp.query_sequences, mp.ref_sequences)
        rows = Mapper(mp, idm).sketch_query(seq)
        got.append([(fi, q_len, ok, sk.sketch_size, sk.kmer_complexity,
                     sk.hashes.tolist(), sk.wpos.tolist(),
                     sk.wpos_end.tolist(), sk.strand.tolist())
                    for fi, q_len, sk, ok in rows])
    assert got[0] == got[1]
    if case != "short":
        assert got[0] and any(r[2] for r in got[0])


# ---- cli.parse_args ---------------------------------------------------------

PARSE_CASES = {
    "defaults": ["-m"],
    "align_defaults": [],
    "units_presets": ["-m", "-w", "2k", "-c", "1k", "-P", "100k", "-p",
                      "ani25+5", "-S", "5k", "-j", "50k", "-D", "20k", "-n",
                      "7", "-s", "100"],
    "no_filter": ["-m", "-f"],
    "one_to_one": ["-m", "-o"],
    "identity": ["-m", "-p", "85"],
    "group_prefix_off": ["-m", "-Y", ""],
    "self_maps": ["-m", "-X"],
    "hg_filter": ["-m", "--hg-filter", "2.0,5,99"],
    "modes": ["-m", "-L", "-M", "-x", "0.25", "-N", "-j", "0", "-l", "10k",
              "-k", "17", "-H", "2", "-F", "0.001", "-r", "3", "-O", "0.5"],
    "alignment": ["-g", "3,5,2,20,1", "-E", "500", "-U", "200", "-a", "-d",
                  "--min-length", "64", "--min-block-id", "0.2",
                  "--wflambda-segment", "512", "--strict-parity", "-t",
                  "3"],
    "prefixes": ["-m", "-T", "g1", "-Q", "g2", "--scaffold-overlap", "0.7"],
    "invalid_window": ["-m", "-w", "50"],
    "invalid_window_align": ["-w", "20k"],
    "invalid_identity": ["-m", "-p", "30"],
    "invalid_block": ["-l", "50k"],
}


def _parse(pkg_cli, argv):
    try:
        got = pkg_cli.parse_args(argv)
    except SystemExit as e:
        return ("exit", e.code)
    return tuple(dataclasses.asdict(x) if dataclasses.is_dataclass(x)
                 else x for x in got)


@pytest.mark.parametrize("case", sorted(PARSE_CASES))
def test_parse_args(tmp_path, case, capsys):
    """After test_cli.py:22-165: the port's own parser returns the
    reference's MapParams and AlignParams field for field (and the same
    approx/remap flags), or exits as the reference does."""
    from wfmash_tpu import cli as rcli
    from wfmash_tpu_torch import cli as pcli

    rng = np.random.default_rng(0)
    write_fasta(tmp_path / "t.fa", {"t1": random_dna(rng, 3000)})
    write_fasta(tmp_path / "q.fa", {"q1": random_dna(rng, 2000)})
    t, q = str(tmp_path / "t.fa"), str(tmp_path / "q.fa")
    argv = [t, q] + PARSE_CASES[case]
    want, got = _parse(rcli, argv), _parse(pcli, argv)
    assert got == want
    assert (want[0] == "exit") == case.startswith("invalid")
    # the all-vs-all default query
    assert _parse(pcli, [t] + PARSE_CASES[case]) == \
        _parse(rcli, [t] + PARSE_CASES[case])


# ---- utils/tempfiles.py and utils/progress.py -----------------------------------

def _tempfile_trace(mod, d):
    mod.set_dir(str(d))
    mod.set_keep_temp(False)
    p = mod.create(".paf")
    out = [os.path.exists(p), os.path.dirname(p) == str(d),
           re.sub(r"[^.]+(?=\.paf$)", "X", os.path.basename(p))[:11],
           mod.keep_temp()]
    mod._cleanup()
    out.append(os.path.exists(p))
    mod.set_keep_temp(True)
    p2 = mod.create(".sam")
    mod._cleanup()
    out += [os.path.exists(p2), mod.keep_temp(), os.path.splitext(p2)[1]]
    mod.set_keep_temp(False)
    mod.set_dir(None)
    os.unlink(p2)
    return out


def test_tempfiles(tmp_path):
    """After test_aux.py:13: the registry of both packages creates, names,
    removes and keeps files alike."""
    from wfmash_tpu.utils import tempfiles as r
    from wfmash_tpu_torch.utils import tempfiles as p

    (tmp_path / "r").mkdir()
    (tmp_path / "p").mkdir()
    assert _tempfile_trace(r, tmp_path / "r") == \
        _tempfile_trace(p, tmp_path / "p")


@pytest.mark.parametrize("quiet", [False, True])
def test_progress_meter(capsys, quiet):
    """After test_aux.py:34: the meter of both packages writes the same
    lines (times aside), and nothing when quiet."""
    from wfmash_tpu.utils import progress as r
    from wfmash_tpu_torch.utils import progress as p

    outs = []
    for mod in (r, p):
        mod.set_quiet(quiet)
        try:
            m = mod.ProgressMeter(100, "[test] phase", heartbeat_s=60.0)
            m.increment(50)
            m.increment(50)
            m.finish()
        finally:
            mod.set_quiet(False)
        outs.append(re.sub(r"[0-9]+\.[0-9]+s", "Ts", capsys.readouterr().err))
    assert outs[0] == outs[1]
    assert ("[test] phase done in Ts" in outs[0]) != quiet
