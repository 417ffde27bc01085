"""The port on a divergent pair, as the benchmark's divergent.align cell
makes it (h100bench/inputs/divergent_pair.py at 80 kb: 10 kb windows at
2-30% divergence, long deletions of 2.0 and 6.4 kb), under upstream's
`-p 80`, on the CPU:

(a) the port's CLI writes the JAX package's bytes: the `-m -p 80`
    mapping on both of the port's mapping routes (the host stages, and
    the device stages on CPU tensors), and the whole `-p 80` run and the
    `-i` alignment of that mapping on the CPU's default engine (the
    native host engine, the reference's "no accelerator" branch);
(b) the card's path, the segmented engine (`WFMASH_TPU_SEGMENTED=1`, run
    by the plain versions of both kernels), sends pieces the tiers failed
    on to the exact engine and kernel B's plain version, and counts them:
    `align.sweep_problems.*` and `align.sweep.lanes` above 0, escalations
    at most the pieces; every record it writes passes the benchmark's
    record check (h100bench/reference/align_check.py), the records
    cover the mapping within the cell's `uncovered_share` limit, and
    they score within its `score_excess` limit of the band-256 optimum
    (h100bench/reference/dp.py).

The JAX package's segmented engine runs its kernels in Pallas interpret
mode on the CPU, many minutes at this size, so (b) holds the port's
segmented records to the plain reference instead;
tests/test_torch_golden.py holds that path to the reference's bytes on
its A2 case, and tests/test_torch_exact.py the exact engine.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_golden import _cli

H100BENCH = Path(__file__).resolve().parents[1] / "h100bench"
if str(H100BENCH) not in sys.path:
    sys.path.insert(0, str(H100BENCH))

from benchlib import inputs  # noqa: E402
from reference import align_check, dp, paf  # noqa: E402
from reference.fasta import read_sequences  # noqa: E402

SEED, BP = 11, 80_000
ARGV = ["t.fa", "q.fa", "-p", "80"]
PEN = (5, 8, 2, 24, 1)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """The pair, and the reference CLI's `-m -p 80` mapping of it."""
    from wfmash_tpu import cli

    d = tmp_path_factory.mktemp("divergent")
    inputs.generator("divergent_pair").generate(str(d), SEED, BP)
    mp = pytest.MonkeyPatch()
    try:
        rc, out, _ = _cli(cli.main, ARGV + ["-m"], d,
                          {"JAX_PLATFORMS": "cpu"}, mp)
    finally:
        mp.undo()
    assert rc == 0 and out.count(b"\n") >= 4
    (d / "m.paf").write_bytes(out)
    return d


def test_the_pair_holds_a_long_indel_and_divergent_windows():
    _, _, d, ev = inputs.generator("divergent_pair").make_pair(BP, SEED)
    long_at, long_len, long_ins = ev["long"]
    assert any(2_000 <= n <= 8_000 for n in long_len)
    assert d.max() > 0.15 and d.min() < 0.1


@pytest.mark.parametrize("route", ["0", "1"])
def test_port_maps_as_the_reference(pair, route, monkeypatch):
    from wfmash_tpu_torch import cli

    rc, out, _ = _cli(cli.main, ARGV + ["-m"], pair,
                      {"WFMASH_TPU_TORCH_DEVICE": "cpu",
                       "WFMASH_TPU_DEVICE_L1": route}, monkeypatch)
    assert rc == 0
    assert out == (pair / "m.paf").read_bytes()


@pytest.mark.parametrize("extra", [[], ["-i", "m.paf"]])
def test_port_aligns_as_the_reference_on_the_cpu_default(pair, extra,
                                                         monkeypatch):
    from wfmash_tpu import cli as ref_cli
    from wfmash_tpu_torch import cli

    rc, want, _ = _cli(ref_cli.main, ARGV + extra, pair,
                       {"JAX_PLATFORMS": "cpu"}, monkeypatch)
    assert rc == 0 and want.count(b"\tcg:Z:") >= 4
    rc, got, _ = _cli(cli.main, ARGV + extra, pair,
                      {"WFMASH_TPU_TORCH_DEVICE": "cpu"}, monkeypatch)
    assert rc == 0
    assert got == want


@pytest.fixture(scope="module")
def segmented(pair):
    """The `-i` run of the mapping on the segmented engine: its PAF and
    the port's counters over the run."""
    from wfmash_tpu_torch import cli
    from wfmash_tpu_torch.utils import perf

    mp = pytest.MonkeyPatch()
    try:
        perf.reset()
        rc, out, _ = _cli(cli.main, ARGV + ["-i", "m.paf"], pair,
                          {"WFMASH_TPU_TORCH_DEVICE": "cpu",
                           "WFMASH_TPU_SEGMENTED": "1"}, mp)
        snap = perf.snapshot()
    finally:
        mp.undo()
    assert rc == 0
    return out.decode(), snap


def test_segmented_path_escalates_to_kernel_b(segmented):
    _, snap = segmented
    problems = sum(v for k, v in snap.items()
                   if k.startswith("align.sweep_problems."))
    assert problems > 0
    assert snap["align.sweep.lanes"] > 0
    assert 1 <= snap["align.sweep.launches"] <= problems
    assert 1 <= snap["align.escalated"] <= snap["align.segments"]
    assert snap["align.escalated"] == sum(
        snap.get(f"align.escalated.{c}", 0)
        for c in ("tier_reject", "oversize", "unanchorable"))
    assert snap["align.escalate_s"] > 0


def test_segmented_records_pass_the_benchmarks_check(pair, segmented):
    """Every record replays and states what its CIGAR gives; the records
    cover the mapping as the cell's limit asks, the whole mapping taken
    as one chunk; over all of them, (S - R) / R stays under the cell's
    limit, S the CIGAR's cost and R the band-256 optimum of its two
    ranges."""
    text, _ = segmented
    seqs = {}
    for f in ("t.fa", "q.fa"):
        seqs.update(read_sequences(str(pair / f)))
    records = [paf.parse(line) for line in text.splitlines()]
    sound = []
    for rec in records:
        got = align_check.check_record(rec, seqs)
        assert not isinstance(got, str), got
        sound.append(got)
    assert len(sound) >= 4
    with open(H100BENCH / "traffic" / "divergent_chunks_1mbp.json") as fh:
        limits = json.load(fh)["limits"]
    mapping = (pair / "m.paf").read_text().splitlines(keepends=True)
    assert align_check.uncovered_share(mapping, records) \
        <= limits["uncovered_share"]
    best = dp.banded([(q, t) for _, q, t in sound], PEN,
                     align_check.BAND, torch.device("cpu"))
    excess = [(paf.score(ops, PEN) - r) / max(r, 1)
              for (ops, _, _), r in zip(sound, best)]
    assert max(excess) <= limits["score_excess"]
    assert np.isfinite(excess).all()
