"""The judge of the map cells: every mapping record of every pair job the
window ran, against the sequences read back from the FASTA file.

Numbers compared (each against its limit in the traffic file):
- `bad_records`: records that do not parse, whose query or target is not
  in the job's -Q or -T group, whose lengths are not the input's, whose
  ranges start outside their sequences or are empty, or whose id:f is
  missing or outside (0, 1]. A mapping's ends are estimates and may pass
  a sequence's end (the JAX package's own outputs do: 120 of Y1's 8906
  records); they are read clipped. Exact: limit 0.
- `uncovered_share`: over the jobs, the largest share of the query
  group's bases that no record of the job covers.
- `identity_gap`: over a sample of records drawn from the seed (the
  longest one always in it), the largest gap between the record's id:f
  and the identity that the query range's whole set of canonical k-mers
  gives against the target range widened on each side by the query span
  and one mapping window (a mapping's target coordinates are
  approximate: a sequence's last, short fragment is placed up to a
  window off): Mash's containment estimate c ** (1 / k), c the share of
  the query's k-mers found in the target window. A record shorter than a
  window (a sequence's last bases: 4 bp records occur) is read as the
  window that ends where it ends, the fragment the mapper sketched.
"""

from __future__ import annotations

import random

import numpy as np

from . import paf
from .fasta import read_sequences

_CODE = np.full(256, 4, np.uint8)
for _i, _b in enumerate(b"ACGT"):
    _CODE[_b] = _i


def kmer_set(seq: np.ndarray, k: int) -> np.ndarray:
    """The distinct canonical k-mers (2 bits a base, min of a k-mer and
    its reverse complement) of seq; k-mers holding another base than
    A, C, G, T are left out."""
    c = _CODE[seq].astype(np.int64)
    n = len(c) - k + 1
    if n <= 0:
        return np.zeros(0, np.int64)
    fwd = np.zeros(n, np.int64)
    rev = np.zeros(n, np.int64)
    bad = np.zeros(n, bool)
    for j in range(k):
        w = c[j:j + n]
        bad |= w == 4
        fwd = (fwd << 2) | (w & 3)
        rev |= (3 - (w & 3)) << (2 * j)
    return np.unique(np.minimum(fwd, rev)[~bad])


def containment_identity(q: np.ndarray, t: np.ndarray, k: int) -> float:
    sq, st = kmer_set(q, k), kmer_set(t, k)
    if not len(sq):
        return 0.0
    c = len(np.intersect1d(sq, st, assume_unique=True)) / len(sq)
    return c ** (1.0 / k)


def _covered(intervals) -> int:
    total, end = 0, -1
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def _problem(rec, job, seqs):
    if rec is None:
        return "does not parse"
    if not rec["qname"].startswith(job["query"]) \
            or not rec["tname"].startswith(job["target"]):
        return "query or target outside the job's groups"
    q, t = seqs.get(rec["qname"]), seqs.get(rec["tname"])
    if q is None or t is None:
        return "names a sequence the input does not have"
    if rec["qlen"] != len(q) or rec["tlen"] != len(t):
        return "sequence length is not the input's"
    if not (0 <= rec["qs"] < min(rec["qe"], len(q))
            and 0 <= rec["ts"] < min(rec["te"], len(t))):
        return "coordinates outside the sequences"
    if rec["strand"] not in "+-":
        return "strand is not + or -"
    try:
        ident = float(rec["tags"]["id"])
    except (KeyError, ValueError):
        return "no id:f"
    if not 0 < ident <= 1:
        return "id:f outside (0, 1]"
    return None


def judge(jobs: list[dict], fasta: str, k: int, window: int, sample: int,
          seed: int) -> dict:
    """jobs: [{"out": PAF path, "target": -T prefix, "query": -Q prefix}].
    Returns {"numbers": {name: value}, "notes": [what was wrong]}."""
    seqs = read_sequences(fasta)
    bad, notes, sound = 0, [], []
    worst_uncovered = 0.0
    for job in jobs:
        recs = []
        with open(job["out"]) as fh:
            for line in fh:
                if line.strip():
                    try:
                        recs.append(paf.parse(line))
                    except (ValueError, IndexError):
                        recs.append(None)
        ok = []
        for rec in recs:
            why = _problem(rec, job, seqs)
            if why is None:
                ok.append(rec)
            else:
                bad += 1
                if len(notes) < 5:
                    notes.append(f"{job['out']}: {why}")
        sound += ok
        spans: dict = {}
        for rec in ok:
            spans.setdefault(rec["qname"], []).append(
                (rec["qs"], min(rec["qe"], rec["qlen"])))
        qnames = [n for n in seqs if n.startswith(job["query"])]
        total = sum(len(seqs[n]) for n in qnames)
        covered = sum(_covered(spans.get(n, ())) for n in qnames)
        worst_uncovered = max(worst_uncovered,
                              1.0 - covered / total if total else 0.0)
    gap = 0.0
    if sound:
        rng = random.Random(seed)
        longest = max(range(len(sound)), key=lambda i: min(
            sound[i]["qe"], sound[i]["qlen"]) - sound[i]["qs"])
        rest = [i for i in range(len(sound)) if i != longest]
        for i in [longest] + rng.sample(rest, min(sample - 1, len(rest))):
            rec = sound[i]
            qe = min(rec["qe"], rec["qlen"])
            qs = min(rec["qs"], max(0, qe - window))
            pad = qe - qs + window
            ref = containment_identity(
                seqs[rec["qname"]][qs:qe],
                seqs[rec["tname"]][max(0, rec["ts"] - pad):rec["te"] + pad],
                k)
            gap = max(gap, abs(float(rec["tags"]["id"]) - ref))
    return {"numbers": {"bad_records": bad,
                        "uncovered_share": worst_uncovered,
                        "identity_gap": gap},
            "notes": notes}
