"""The frozen copies write what the scripts they were copied from write,
and split and pair as those scripts do."""

import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest

from benchlib import chunking, inputs
from benchlib.cell import ROOT


def _script(name):
    spec = importlib.util.spec_from_file_location(
        f"script_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.path.remove(os.path.join(ROOT, "scripts"))
    return mod


@pytest.mark.parametrize("seed", [8, 2 ** 31 + 17])
def test_yeast_pangenome_bytes(tmp_path, seed):
    golden = _script("torch_golden")
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    inputs.generator("yeast_pangenome").generate(str(tmp_path / "a"), seed,
                                                 scale=0.05)
    golden.yeast_pangenome(str(tmp_path / "b"), seed, scale=0.05)
    for name in ("pan.fa", "pan.fa.fai"):
        assert (tmp_path / "a" / name).read_bytes() == \
            (tmp_path / "b" / name).read_bytes()


@pytest.mark.parametrize("seed", [42, 2 ** 31 + 5])
def test_make_pair_bases(tmp_path, seed):
    demo = _script("scale_demo")
    golden = _script("torch_golden")
    pair = inputs.generator("assembly_pair")
    ours = pair.make_pair(1_000_000, seed)
    theirs = demo.make_pair(1_000_000, seed)
    for a, b in zip(ours, theirs):
        assert np.array_equal(a, b)
    pair.generate(str(tmp_path), seed, 1_000_000)
    golden.write_fasta(str(tmp_path / "ref.fa"),
                       {"anc": inputs.ACGT[theirs[0]].tobytes()})
    assert (tmp_path / "t.fa").read_bytes() == \
        (tmp_path / "ref.fa").read_bytes()


def test_generate_reports_lengths(tmp_path):
    got = inputs.generate({"generator": "assembly_pair",
                           "args": {"bp": 200_000}}, 3, str(tmp_path))
    assert got["files"] == ["t.fa", "t.fa.fai", "q.fa", "q.fa.fai"]
    assert got["lengths"]["anc"] == 200_000
    assert got["lengths"]["der"] > 0


def test_chunks_match_the_split_script(tmp_path):
    import gzip

    with gzip.open(os.path.join(ROOT, "tests", "torch_golden", "Y1.paf.gz"),
                   "rt") as fh:
        lines = fh.readlines()
    paf = tmp_path / "m.paf"
    paf.write_text("".join(lines))
    n = 37
    subprocess.run([sys.executable, os.path.join(
        ROOT, "scripts", "split_approx_mappings_in_chunks.py"), str(paf),
        str(n)], check=True)
    ours = chunking.balance([chunking.mapping_weight(l) for l in lines], n)
    for k, idx in enumerate(ours):
        want = (tmp_path / f"m.paf.chunk_{k}.paf").read_text()
        assert "".join(lines[i] for i in idx) == want
    total = sum(chunking.query_span(l) for l in lines)
    chunks = chunking.split_chunks(lines, total / n)
    assert len(chunks) == n
    assert sorted(sum(chunks, [])) == sorted(lines)


def test_pairs_match_all2all_jobs(tmp_path):
    inputs.generator("yeast_pangenome").generate(str(tmp_path), 3,
                                                 scale=0.03)
    fa = str(tmp_path / "pan.fa")
    out = subprocess.run([sys.executable, os.path.join(
        ROOT, "scripts", "all2all_jobs.py"), fa, "-n", "1", "-t", "h",
        "-q", "h"], check=True, capture_output=True, text=True).stdout
    want = [(l.split(" -T ")[1].split()[0], l.split(" -Q ")[1].split()[0])
            for l in out.splitlines()]
    with open(fa + ".fai") as fh:
        names = [l.split("\t")[0] for l in fh]
    groups = chunking.group(names, "h")
    got = [(tg, qs[0]) for tg, qs in chunking.pairings(groups, groups, 1)]
    assert got == want and len(got) == 56
