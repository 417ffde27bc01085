"""The judge of the align cells: every record of every chunk the window
aligned, against the sequences read back from the FASTA files.

Numbers compared (each against its limit in the traffic file):
- `bad_records`: records that do not parse, name a sequence or a length
  that is not the input's, lie outside their sequences, whose CIGAR does
  not replay (each = on equal bases, each X on different ones, its
  lengths the record's spans), or whose matches, block length, mapping
  quality, gi or bi are not what the CIGAR gives. Exact: limit 0.
- `uncovered_share`: over the chunks, the largest share of a chunk's
  mapped query bases that no alignment record of the same query and
  target sequences covers.
- `score_excess`: over a sample of records drawn from the seed (the
  longest one always in it), the largest (S - R) / R, where S is the
  record CIGAR's two-piece gap-affine cost under the deployment's
  penalties and R the optimum of the same two ranges within a band
  (`dp.banded`).

The control (`control=True`) puts the reference in the program's place
for the sampled records: it aligns each of their ranges under edit
distance (the cheaper scoring a faster kernel could take instead of the
stated penalties) and scores that path instead of the record's.
"""

from __future__ import annotations

import random

import numpy as np

from . import dp, paf
from .fasta import read_sequences, reverse_complement

BAND = 256
EDIT = (1, 0, 1, 0, 1)


def _record_problem(rec: dict, seqs: dict):
    """(query, target) bases of the record, or what is wrong with it."""
    q = seqs.get(rec["qname"])
    t = seqs.get(rec["tname"])
    if q is None or t is None:
        return "names a sequence the input does not have"
    if rec["qlen"] != len(q) or rec["tlen"] != len(t):
        return "sequence length is not the input's"
    if not (0 <= rec["qs"] < rec["qe"] <= len(q)
            and 0 <= rec["ts"] < rec["te"] <= len(t)):
        return "coordinates outside the sequences"
    if rec["strand"] not in "+-":
        return "strand is not + or -"
    qb = q[rec["qs"]:rec["qe"]]
    if rec["strand"] == "-":
        qb = reverse_complement(qb)
    return qb, t[rec["ts"]:rec["te"]]


def check_record(rec: dict, seqs: dict):
    """(ops, query bases, target bases) of a sound record, else a string
    saying what is wrong."""
    got = _record_problem(rec, seqs)
    if isinstance(got, str):
        return got
    qb, tb = got
    if "cg" not in rec["tags"]:
        return "no CIGAR"
    try:
        ops = paf.cigar_ops(rec["tags"]["cg"])
    except ValueError as e:
        return str(e)
    why = paf.replay(qb, tb, ops)
    if why is not None:
        return why
    m, x, i, ibp, d, dbp, _, _ = paf.counts(ops)
    gi = m / (m + x + i + d)
    bi = m / (m + x + ibp + dbp)
    want = {"matches": (rec["nmatch"], m),
            "block length": (rec["block"], max(len(tb), len(qb))),
            "mapping quality": (rec["mapq"], int(round(paf.phred(1.0 - bi)))),
            "gi": (rec["tags"].get("gi"), f"{gi:.6g}"),
            "bi": (rec["tags"].get("bi"), f"{bi:.6g}")}
    for what, (has, should) in want.items():
        if has != should:
            return f"{what} {has}, the CIGAR gives {should}"
    return ops, qb, tb


def _covered(intervals) -> int:
    total, end = 0, -1
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def uncovered_share(chunk: list[str], records: list[dict]) -> float:
    """Share of the chunk's mapped query bases that no alignment record
    of the same (query, target) pair covers."""
    spans: dict = {}
    for rec in records:
        spans.setdefault((rec["qname"], rec["tname"]), []).append(
            (rec["qs"], rec["qe"]))
    mapped = covered = 0
    for line in chunk:
        f = line.split("\t")
        qs, qe = int(f[2]), int(f[3])
        mapped += qe - qs
        covered += _covered([(max(s, qs), min(e, qe))
                             for s, e in spans.get((f[0], f[5]), ())
                             if min(e, qe) > max(s, qs)])
    return 1.0 - covered / mapped if mapped else 0.0


def judge(jobs: list[dict], fasta: list[str], pen, sample: int, seed: int,
          device, control: bool = False) -> dict:
    """jobs: [{"chunk": mapping lines, "out": the job's PAF path}].
    Returns {"numbers": {name: value}, "notes": [what was wrong]}."""
    outs = []
    notes: list[str] = []
    for job in jobs:
        recs = []
        with open(job["out"]) as fh:
            for line in fh:
                if not line.strip():
                    continue
                try:
                    recs.append(paf.parse(line))
                except (ValueError, IndexError):
                    recs.append(None)
        outs.append(recs)
    seqs: dict = {}
    for path in dict.fromkeys(fasta):
        seqs.update(read_sequences(path))
    bad = 0
    sound = []
    worst_uncovered = 0.0
    for job, recs in zip(jobs, outs):
        ok = []
        for rec in recs:
            got = "does not parse" if rec is None else check_record(rec, seqs)
            if isinstance(got, str):
                bad += 1
                if len(notes) < 5:
                    notes.append(f"{job['out']}: {got}")
            else:
                ok.append(rec)
                sound.append(got)
        worst_uncovered = max(worst_uncovered,
                              uncovered_share(job["chunk"], ok))
    excess = 0.0
    if sound:
        rng = random.Random(seed)
        longest = max(range(len(sound)),
                      key=lambda k: max(len(sound[k][1]), len(sound[k][2])))
        rest = [k for k in range(len(sound)) if k != longest]
        picked = [longest] + rng.sample(rest, min(sample - 1, len(rest)))
        pairs = [(sound[k][1], sound[k][2]) for k in picked]
        best = dp.banded(pairs, pen, BAND, device)
        if control:
            paths = []
            for lo in range(0, len(pairs), 4):
                part = pairs[lo:lo + 4]
                _, rows = dp.banded(part, EDIT, BAND, device, keep_rows=True)
                paths += [dp.traceback_linear(q, t, rows[:, b].numpy(),
                                              BAND, EDIT)
                          for b, (q, t) in enumerate(part)]
                del rows
        else:
            paths = [sound[k][0] for k in picked]
        excess = max((paf.score(ops, pen) - r) / max(r, 1)
                     for ops, r in zip(paths, best))
    return {"numbers": {"bad_records": bad,
                        "uncovered_share": worst_uncovered,
                        "score_excess": excess},
            "notes": notes}
