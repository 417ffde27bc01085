"""PAF records and CIGAR strings, read as plain data."""

from __future__ import annotations

import math
import re

import numpy as np

_OP = re.compile(r"(\d+)([=XIDM])")


def parse(line: str) -> dict:
    f = line.rstrip("\n").rstrip("\t").split("\t")
    rec = {"qname": f[0], "qlen": int(f[1]), "qs": int(f[2]),
           "qe": int(f[3]), "strand": f[4], "tname": f[5],
           "tlen": int(f[6]), "ts": int(f[7]), "te": int(f[8]),
           "nmatch": int(f[9]), "block": int(f[10]), "mapq": int(f[11]),
           "tags": {}}
    for tag in f[12:]:
        key, _, val = tag.partition(":")
        rec["tags"][key] = val.partition(":")[2]
    return rec


def read(path: str) -> list[dict]:
    with open(path) as fh:
        return [parse(line) for line in fh if line.strip()]


def cigar_ops(cg: str) -> list[tuple[int, str]]:
    ops = [(int(n), op) for n, op in _OP.findall(cg)]
    if "".join(f"{n}{op}" for n, op in ops) != cg:
        raise ValueError("not a CIGAR of =, X, I, D, M runs")
    return ops


def gap_cost(n: int, pen) -> int:
    x, o1, e1, o2, e2 = pen
    return min(o1 + e1 * n, o2 + e2 * n) if n > 0 else 0


def score(ops, pen) -> int:
    """Two-piece gap-affine cost of a CIGAR: pen = (x, o1, e1, o2, e2)."""
    s = 0
    for n, op in ops:
        if op == "X":
            s += n * pen[0]
        elif op in "ID":
            s += gap_cost(n, pen)
    return s


def counts(ops):
    """(matches, mismatches, insertion runs, inserted bp, deletion runs,
    deleted bp, target bp, query bp)."""
    m = x = i = ibp = d = dbp = 0
    for n, op in ops:
        if op == "=":
            m += n
        elif op == "X":
            x += n
        elif op == "I":
            i += 1
            ibp += n
        elif op == "D":
            d += 1
            dbp += n
    return m, x, i, ibp, d, dbp, m + x + dbp, m + x + ibp


def phred(prob: float) -> float:
    """-10 log10(prob), 255 at 0 and 1 and outside [0, 255]."""
    if prob == 1:
        return 255.0
    p = -10.0 * math.log10(prob) if prob > 0 else 255.0
    return 255.0 if (p < 0 or p > 255) else p


def replay(q: np.ndarray, t: np.ndarray, ops) -> str | None:
    """None when `ops` aligns all of q to all of t, each = on equal bases
    and each X on different ones; else what is wrong."""
    n = np.array([k for k, _ in ops], np.int64)
    kind = np.array(["=XIDM".index(op) for _, op in ops], np.int64)
    if (kind == 4).any():
        return "M in the CIGAR"
    if len(ops) and (n <= 0).any():
        return "a run of length 0"
    qstep = np.where(kind != 3, n, 0)
    tstep = np.where(kind != 2, n, 0)
    if qstep.sum() != len(q) or tstep.sum() != len(t):
        return (f"CIGAR spans {qstep.sum()} query / {tstep.sum()} target bp,"
                f" the record {len(q)} / {len(t)}")
    qs = np.cumsum(qstep) - qstep
    ts = np.cumsum(tstep) - tstep
    diag = kind < 2
    dn = n[diag]
    if not dn.size:
        return None
    ramp = np.arange(dn.sum()) - np.repeat(np.cumsum(dn) - dn, dn)
    qi = np.repeat(qs[diag], dn) + ramp
    ti = np.repeat(ts[diag], dn) + ramp
    want_eq = np.repeat(kind[diag] == 0, dn)
    bad = (q[qi] == t[ti]) != want_eq
    if bad.any():
        at = int(np.argmax(bad))
        return (f"{'=' if want_eq[at] else 'X'} at query {int(qi[at])}, "
                f"target {int(ti[at])} does not replay")
    return None
