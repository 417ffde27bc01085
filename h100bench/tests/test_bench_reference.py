"""The plain reference: the banded DP against the port's exact WFA (used
here only as a second witness), the traceback, the replay and the tags,
and the mapping judge's k-mer identity."""

import numpy as np
import pytest

from reference import align_check, dp, map_check, paf
from reference.fasta import reverse_complement

PEN = (5, 8, 2, 24, 1)
ACGT = np.frombuffer(b"ACGT", np.uint8)


def _pairs(seed, count=24):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        t = rng.choice(ACGT, int(rng.integers(20, 500)))
        q = t.copy()
        q[rng.random(len(q)) < 0.04] = ord("A")
        for _ in range(int(rng.integers(0, 4))):
            at = int(rng.integers(0, max(1, len(q) - 5)))
            n = int(rng.integers(1, 40))
            q = (np.concatenate([q[:at], q[at + n:]]) if rng.random() < 0.5
                 else np.concatenate([q[:at], rng.choice(ACGT, n), q[at:]]))
        out.append((q if len(q) else ACGT[:1], t))
    return out


@pytest.mark.parametrize("seed", [1, 2])
def test_banded_optimum_is_the_exact_wfa_score(seed):
    from wfmash_tpu_torch.align import wfa_np

    pen = wfa_np.Penalties(*PEN)
    pairs = _pairs(seed)
    got = dp.banded(pairs, PEN, 96, "cpu")
    want = [wfa_np.wfa_align(q.tobytes(), t.tobytes(), pen)[0]
            for q, t in pairs]
    assert got == want


def test_edit_distance_traceback_replays_at_its_score():
    pairs = _pairs(3, 8)
    scores, rows = dp.banded(pairs, align_check.EDIT, 96, "cpu",
                             keep_rows=True)
    for b, (q, t) in enumerate(pairs):
        ops = dp.traceback_linear(q, t, rows[:, b].numpy(), 96,
                                  align_check.EDIT)
        assert paf.replay(q, t, ops) is None
        assert paf.score(ops, align_check.EDIT) == scores[b]
        assert paf.score(ops, PEN) >= dp.banded([(q, t)], PEN, 96, "cpu")[0]


def test_replay_names_what_is_wrong():
    q = np.frombuffer(b"ACGTACGT", np.uint8)
    t = np.frombuffer(b"ACGAACGT", np.uint8)
    assert paf.replay(q, t, [(3, "="), (1, "X"), (4, "=")]) is None
    assert "does not replay" in paf.replay(q, t, [(8, "=")])
    assert "spans" in paf.replay(q, t, [(3, "="), (1, "X"), (3, "=")])
    assert paf.replay(q, t, [(8, "M")]) == "M in the CIGAR"


def _record(q, t, ops, **over):
    m, x, i, ibp, d, dbp, tb, qb = paf.counts(ops)
    bi = m / (m + x + ibp + dbp)
    line = "\t".join(map(str, [
        "q", len(q), 0, len(q), "+", "t", len(t), 0, len(t), m, max(tb, qb),
        int(round(paf.phred(1 - bi))), f"gi:f:{m / (m + x + i + d):.6g}",
        f"bi:f:{bi:.6g}", "md:f:0.99", "cg:Z:" + "".join(f"{n}{op}" for n, op in ops)]))
    rec = paf.parse(line + "\t\n")
    rec.update(over)
    return rec


def test_check_record_holds_tags_to_the_cigar():
    q = np.frombuffer(b"ACGTTACGT", np.uint8)
    t = np.frombuffer(b"ACGTACGA", np.uint8)
    ops = [(4, "="), (1, "I"), (3, "="), (1, "X")]
    seqs = {"q": q, "t": t}
    got = align_check.check_record(_record(q, t, ops), seqs)
    assert not isinstance(got, str)
    assert "matches" in align_check.check_record(
        _record(q, t, ops, nmatch=6), seqs)
    assert "length" in align_check.check_record(
        _record(q, t, ops, qlen=99), seqs)
    rec = _record(q, t, ops)
    rec["tags"]["gi"] = "0.5"
    assert "gi" in align_check.check_record(rec, seqs)


def test_uncovered_share():
    chunk = ["q\t100\t0\t100\t+\tt\t100\t0\t100\t1\t100\t60\n",
             "q\t100\t200\t300\t+\tu\t100\t0\t100\t1\t100\t60\n"]
    recs = [{"qname": "q", "tname": "t", "qs": 10, "qe": 60},
            {"qname": "q", "tname": "t", "qs": 50, "qe": 90},
            {"qname": "q", "tname": "x", "qs": 200, "qe": 300}]
    assert align_check.uncovered_share(chunk, recs) == pytest.approx(0.6)


def test_containment_identity():
    rng = np.random.default_rng(5)
    t = rng.choice(ACGT, 20_000)
    q = t[5000:9000].copy()
    assert map_check.containment_identity(q, t, 15) == pytest.approx(1.0)
    with_n = q.copy()
    with_n[::100] = ord("N")           # k-mers holding N are left out
    assert map_check.containment_identity(with_n, t, 15) == 1.0
    q[::100] = np.where(q[::100] == ord("A"), ord("C"), ord("A"))
    assert 0.98 < map_check.containment_identity(q, t, 15) < 0.995
    other = rng.choice(ACGT, 4000)
    assert map_check.containment_identity(other, t, 15) < 0.6
    assert np.array_equal(map_check.kmer_set(reverse_complement(t), 15),
                          map_check.kmer_set(t, 15))
