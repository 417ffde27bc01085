"""Gap-affine two-piece wavefront alignment — host reference implementation.

This is the executable specification of the WFA recursion used throughout
the aligner (the batched JAX/Pallas engines are cross-checked against it,
and it is itself cross-checked against an O(nm) dynamic-programming oracle
in tests).

Semantics reconstructed from the published WFA/biWFA algorithm and the
reference's call surface (the WFA2-lib submodule is empty in the reference
checkout; see SURVEY.md §2.6). Conventions:

* pattern = TARGET (v axis, length n), text = QUERY (h axis, length m) —
  matching the reference's alignEnd2End(target, query) call order
  (wflign.cpp:148), so CIGAR 'I' consumes query and 'D' consumes target,
  as PAF expects;
* diagonal k = h - v; wavefront offsets store h;
* penalties: match 0, mismatch x, gap length l costs
  min(o1 + l*e1, o2 + l*e2) (two-piece affine);
* states M, I1, I2, D1, D2 with the standard recurrences:
    I*[s][k] = max(M[s-o*-e*][k-1], I*[s-e*][k-1]) + 1
    D*[s][k] = max(M[s-o*-e*][k+1], D*[s-e*][k+1])
    M[s][k]  = extend(max(M[s-x][k]+1, I1,I2,D1,D2[s][k]))
* ends-free: begin-free seeds extra score-0 wavefront entries on diagonals
  [-pattern_begin_free, text_begin_free]; end-free accepts termination on
  the free tail boundary; free gaps are emitted as leading/trailing I/D
  ops (WFA2's CIGARs include them — the patching logic depends on the
  CIGAR consuming the full sequences);
* backtrace tie-break priority (documented, deterministic): at an M cell
  prefer mismatch, then I1, I2, D1, D2; inside a gap state prefer gap-open
  over gap-extend. (WFA2's exact tie order is unverifiable here; parity is
  enforced on score/validity, not tie choices.)
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

NEG = -(1 << 30)


@dataclass(frozen=True)
class Penalties:
    mismatch: int
    gap_opening1: int
    gap_extension1: int
    gap_opening2: int
    gap_extension2: int

    def gap_cost(self, length: int) -> int:
        if length <= 0:
            return 0
        return min(
            self.gap_opening1 + length * self.gap_extension1,
            self.gap_opening2 + length * self.gap_extension2,
        )


@dataclass(frozen=True)
class EndsFree:
    """Free-gap spans: (pattern==target, text==query)."""

    target_begin: int = 0
    target_end: int = 0
    query_begin: int = 0
    query_end: int = 0


def score_cigar(ops, p: Penalties) -> int:
    """Cost of a CIGAR under two-piece affine penalties."""
    s = 0
    for n, op in ops:
        if op == "X":
            s += n * p.mismatch
        elif op in "ID":
            s += p.gap_cost(n)
    return s


def _lcp(a: bytes, b: bytes, i: int, j: int) -> int:
    n = 0
    la, lb = len(a), len(b)
    while i + n < la and j + n < lb and a[i + n] == b[j + n]:
        n += 1
    return n


class _History:
    """Per-score wavefronts stored sparsely as dicts k -> offset."""

    def __init__(self):
        self.M: list[dict[int, int] | None] = []
        self.I1: list[dict[int, int] | None] = []
        self.I2: list[dict[int, int] | None] = []
        self.D1: list[dict[int, int] | None] = []
        self.D2: list[dict[int, int] | None] = []

    def push(self, M, I1, I2, D1, D2):
        self.M.append(M)
        self.I1.append(I1)
        self.I2.append(I2)
        self.D1.append(D1)
        self.D2.append(D2)

    @staticmethod
    def get(wf_list, s, k):
        if s < 0 or s >= len(wf_list) or wf_list[s] is None:
            return NEG
        return wf_list[s].get(k, NEG)


def wfa_align(
    query: bytes,
    target: bytes,
    p: Penalties,
    ends_free: EndsFree | None = None,
    max_score: int | None = None,
):
    """Align; returns (score, ops) or (None, None) if max_score exceeded.

    ops is an RLE CIGAR list [(n, op)] with op in '=XID' consuming the FULL
    query and target (free end gaps included).
    """
    m, n = len(query), len(target)
    ef = ends_free or EndsFree()

    if m == 0 and n == 0:
        return 0, []

    hist = _History()

    # score-0 seeds
    M0: dict[int, int] = {}

    def seed(k, off):
        if M0.get(k, NEG) < off:
            M0[k] = off

    seed(0, _lcp(query, target, 0, 0))
    for v0 in range(1, min(ef.target_begin, n) + 1):
        k = -v0
        seed(k, _lcp(query, target, 0, v0))
    for h0 in range(1, min(ef.query_begin, m) + 1):
        seed(h0, h0 + _lcp(query, target, h0, 0))

    def is_done(Ms):
        """Return end (k, offset) if some M offset reaches an accepting cell
        (deterministic: smallest diagonal wins)."""
        if not Ms:
            return None
        for k in sorted(Ms):
            h = Ms[k]
            v = h - k
            if h == m and v <= n and n - v <= ef.target_end and v >= 0:
                return (k, h)
            if v == n and h <= m and m - h <= ef.query_end and h >= 0:
                return (k, h)
        return None

    end = is_done(M0)
    hist.push(M0, None, None, None, None)
    s = 0
    x, o1, e1, o2, e2 = (
        p.mismatch,
        p.gap_opening1,
        p.gap_extension1,
        p.gap_opening2,
        p.gap_extension2,
    )

    while end is None:
        s += 1
        if max_score is not None and s > max_score:
            return None, None
        Ms: dict[int, int] = {}
        I1s: dict[int, int] = {}
        I2s: dict[int, int] = {}
        D1s: dict[int, int] = {}
        D2s: dict[int, int] = {}

        src_keys = set()
        for wf_list, off in (
            (hist.M, s - x),
            (hist.M, s - o1 - e1),
            (hist.M, s - o2 - e2),
            (hist.I1, s - e1),
            (hist.I2, s - e2),
            (hist.D1, s - e1),
            (hist.D2, s - e2),
        ):
            if 0 <= off < len(wf_list) and wf_list[off]:
                src_keys.update(wf_list[off].keys())
        if not src_keys:
            hist.push(None, None, None, None, None)
            if s > (m + n) * max(x, e1 + o1, e2 + o2) + o1 + o2 + 10:
                raise RuntimeError("WFA failed to converge")
            continue

        lo = min(src_keys) - 1
        hi = max(src_keys) + 1
        g = _History.get
        for k in range(lo, hi + 1):
            i1 = max(g(hist.M, s - o1 - e1, k - 1), g(hist.I1, s - e1, k - 1))
            if i1 > NEG:
                i1 += 1
                I1s[k] = i1
            i2 = max(g(hist.M, s - o2 - e2, k - 1), g(hist.I2, s - e2, k - 1))
            if i2 > NEG:
                i2 += 1
                I2s[k] = i2
            d1 = max(g(hist.M, s - o1 - e1, k + 1), g(hist.D1, s - e1, k + 1))
            if d1 > NEG:
                D1s[k] = d1
            d2 = max(g(hist.M, s - o2 - e2, k + 1), g(hist.D2, s - e2, k + 1))
            if d2 > NEG:
                D2s[k] = d2
            mm = g(hist.M, s - x, k)
            best = max(
                mm + 1 if mm > NEG else NEG,
                I1s.get(k, NEG),
                I2s.get(k, NEG),
                D1s.get(k, NEG),
                D2s.get(k, NEG),
            )
            if best <= NEG:
                continue
            h = best
            v = h - k
            if v < 0 or v > n or h < 0 or h > m:
                continue
            h += _lcp(query, target, h, v)
            Ms[k] = h

        hist.push(Ms, I1s, I2s, D1s, D2s)
        end = is_done(Ms)

    return s, _backtrace(hist, s, end, query, target, p, ef, m, n)


def _backtrace(hist, s, end, query, target, p: Penalties, ef: EndsFree,
               m: int, n: int):
    x, o1, e1, o2, e2 = (
        p.mismatch,
        p.gap_opening1,
        p.gap_extension1,
        p.gap_opening2,
        p.gap_extension2,
    )
    g = _History.get
    k, h = end
    ops_rev: list[tuple[int, str]] = []  # built backwards

    def emit(nn, op):
        if nn <= 0:
            return
        if ops_rev and ops_rev[-1][1] == op:
            ops_rev[-1] = (ops_rev[-1][0] + nn, op)
        else:
            ops_rev.append((nn, op))

    # trailing free gap
    v = h - k
    if h == m and v < n:
        emit(n - v, "D")
    elif v == n and h < m:
        emit(m - h, "I")

    state = "M"
    while True:
        if state == "M":
            cur = h
            if s == 0:
                # walk down to the seed
                seed_off = max(0, k)
                emit(cur - seed_off, "=")
                if k < 0:
                    emit(-k, "D")
                elif k > 0:
                    emit(k, "I")
                break
            mm = g(hist.M, s - x, k)
            cands = [
                ("X", (mm + 1) if mm > NEG else NEG),
                ("I1", g(hist.I1, s, k)),
                ("I2", g(hist.I2, s, k)),
                ("D1", g(hist.D1, s, k)),
                ("D2", g(hist.D2, s, k)),
            ]
            pre = max(c for _, c in cands)
            emit(cur - pre, "=")  # the extension run
            h = pre
            for name, c in cands:
                if c == pre:
                    if name == "X":
                        emit(1, "X")
                        s -= x
                        h -= 1
                        # stay in M
                    else:
                        state = name
                    break
        elif state in ("I1", "I2"):
            o, e = (o1, e1) if state == "I1" else (o2, e2)
            wf = hist.I1 if state == "I1" else hist.I2
            emit(1, "I")
            open_ = g(hist.M, s - o - e, k - 1)
            ext = g(wf, s - e, k - 1)
            # prefer open
            if open_ > NEG and open_ + 1 == h:
                s -= o + e
                h -= 1
                k -= 1
                state = "M"
            elif ext > NEG and ext + 1 == h:
                s -= e
                h -= 1
                k -= 1
            else:  # pragma: no cover - inconsistent history
                raise RuntimeError("backtrace failure in I state")
        elif state in ("D1", "D2"):
            o, e = (o1, e1) if state == "D1" else (o2, e2)
            wf = hist.D1 if state == "D1" else hist.D2
            emit(1, "D")
            open_ = g(hist.M, s - o - e, k + 1)
            ext = g(wf, s - e, k + 1)
            if open_ > NEG and open_ == h:
                s -= o + e
                k += 1
                state = "M"
            elif ext > NEG and ext == h:
                s -= e
                k += 1
            else:  # pragma: no cover
                raise RuntimeError("backtrace failure in D state")

    ops_rev.reverse()
    # merge (emit built runs backwards; adjacent same ops already merged)
    return ops_rev


# ---------------------------------------------------------------------------
# O(nm) dynamic-programming oracle (tests only)
# ---------------------------------------------------------------------------

def dp_align(query: bytes, target: bytes, p: Penalties,
             ends_free: EndsFree | None = None):
    """Optimal two-piece-affine alignment score by full DP (oracle)."""
    ef = ends_free or EndsFree()
    m, n = len(query), len(target)
    INF = 1 << 30
    x, o1, e1, o2, e2 = (
        p.mismatch,
        p.gap_opening1,
        p.gap_extension1,
        p.gap_opening2,
        p.gap_extension2,
    )

    # DP over (v target, h query); states M/I1/I2/D1/D2
    M = np.full((n + 1, m + 1), INF, dtype=np.int64)
    I1 = np.full((n + 1, m + 1), INF, dtype=np.int64)
    I2 = np.full((n + 1, m + 1), INF, dtype=np.int64)
    D1 = np.full((n + 1, m + 1), INF, dtype=np.int64)
    D2 = np.full((n + 1, m + 1), INF, dtype=np.int64)

    # Begin-free entry points are M states (WFA seeds); any gap after a
    # free begin is paid from there.
    M[0, 0] = 0
    for v in range(1, min(ef.target_begin, n) + 1):
        M[v, 0] = 0
    for h in range(1, min(ef.query_begin, m) + 1):
        M[0, h] = 0
    for v in range(1, n + 1):
        D1[v, 0] = min(M[v - 1, 0] + o1 + e1, D1[v - 1, 0] + e1)
        D2[v, 0] = min(M[v - 1, 0] + o2 + e2, D2[v - 1, 0] + e2)
        M[v, 0] = min(M[v, 0], D1[v, 0], D2[v, 0])
    for h in range(1, m + 1):
        I1[0, h] = min(M[0, h - 1] + o1 + e1, I1[0, h - 1] + e1)
        I2[0, h] = min(M[0, h - 1] + o2 + e2, I2[0, h - 1] + e2)
        M[0, h] = min(M[0, h], I1[0, h], I2[0, h])

    q = np.frombuffer(bytes(query), dtype=np.uint8)
    t = np.frombuffer(bytes(target), dtype=np.uint8)

    for v in range(1, n + 1):
        for h in range(1, m + 1):
            I1[v, h] = min(M[v, h - 1] + o1 + e1, I1[v, h - 1] + e1)
            I2[v, h] = min(M[v, h - 1] + o2 + e2, I2[v, h - 1] + e2)
            D1[v, h] = min(M[v - 1, h] + o1 + e1, D1[v - 1, h] + e1)
            D2[v, h] = min(M[v - 1, h] + o2 + e2, D2[v - 1, h] + e2)
            sub = M[v - 1, h - 1] + (0 if q[h - 1] == t[v - 1] else x)
            M[v, h] = min(sub, I1[v, h], I2[v, h], D1[v, h], D2[v, h])

    best = int(M[n, m])
    for v in range(n + 1):
        if n - v <= ef.target_end:
            best = min(best, int(M[v, m]))
    for h in range(m + 1):
        if m - h <= ef.query_end:
            best = min(best, int(M[n, h]))
    return best
