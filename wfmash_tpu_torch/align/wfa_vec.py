"""Vectorized host WFA — same semantics as wfa_np, NumPy wavefront arrays.

Drop-in replacement for :func:`wfa_np.wfa_align` (same tie-breaking rules,
same ends-free behavior; cross-checked in tests). Wavefronts are dense
int32 arrays over the live diagonal range per score; extension compares
CHUNK-byte slabs via fancy indexing with sentinel-padded sequences (query
pad 0x01, target pad 0x02 — out-of-range mismatches need no masks).

Used for boundary patches and recursion leaves of the device engine; the
dict-based wfa_np remains the executable spec.
"""

from __future__ import annotations

import numpy as np

from .wfa_np import EndsFree, Penalties

NEG = np.int32(-(1 << 28))
CHUNK = 32


class _WF:
    """One score level: five offset arrays over diagonals [lo, lo+len)."""

    __slots__ = ("lo", "M", "I1", "I2", "D1", "D2")

    def __init__(self, lo, M, I1, I2, D1, D2):
        self.lo = lo
        self.M = M
        self.I1 = I1
        self.I2 = I2
        self.D1 = D1
        self.D2 = D2


def _get(hist, s, name, lo, n):
    """Source wavefront values aligned to diagonals [lo, lo+n), NEG-filled."""
    if s < 0 or s >= len(hist) or hist[s] is None:
        return None
    wf = hist[s]
    arr = getattr(wf, name)
    if arr is None:
        return None
    out = np.full(n, NEG, dtype=np.int32)
    src_lo, src_n = wf.lo, len(arr)
    a = max(lo, src_lo)
    b = min(lo + n, src_lo + src_n)
    if a < b:
        out[a - lo : b - lo] = arr[a - src_lo : b - src_lo]
    return out


def _get_scalar(hist, s, name, k):
    if s < 0 or s >= len(hist) or hist[s] is None:
        return int(NEG)
    wf = hist[s]
    arr = getattr(wf, name)
    if arr is None:
        return int(NEG)
    idx = k - wf.lo
    if idx < 0 or idx >= len(arr):
        return int(NEG)
    return int(arr[idx])


def wfa_align(query: bytes, target: bytes, p: Penalties,
              ends_free: EndsFree | None = None,
              max_score: int | None = None):
    """Exact WFA: native C++ fast path (bit-identical, tested), Python
    fallback below (`wfa_align_py`, the vectorized spec twin)."""
    from ..native import wfa_align_ops_native

    got = wfa_align_ops_native(query, target, p, ends_free, max_score)
    if got is not NotImplemented:
        return got
    return wfa_align_py(query, target, p, ends_free, max_score)


def wfa_align_py(query: bytes, target: bytes, p: Penalties,
                 ends_free: EndsFree | None = None,
                 max_score: int | None = None):
    m, n = len(query), len(target)
    ef = ends_free or EndsFree()
    if m == 0 and n == 0:
        return 0, []

    q = np.frombuffer(bytes(query) + b"\x01" * (CHUNK + 8), dtype=np.uint8)
    t = np.frombuffer(bytes(target) + b"\x02" * (CHUNK + 8), dtype=np.uint8)
    x, o1, e1, o2, e2 = (p.mismatch, p.gap_opening1, p.gap_extension1,
                         p.gap_opening2, p.gap_extension2)

    def extend(offs, kvec):
        """Vectorized LCP extension of valid offsets."""
        valid = offs > NEG
        if not valid.any():
            return offs
        h = np.where(valid, offs, 0)
        v = h - np.where(valid, kvec, 0)
        active = valid.copy()
        car = np.arange(CHUNK)
        while active.any():
            ia = np.nonzero(active)[0]
            qc = q[h[ia, None] + car[None, :]]
            tc = t[v[ia, None] + car[None, :]]
            eq = qc == tc
            run = np.cumprod(eq, axis=1).sum(axis=1)
            h[ia] += run
            v[ia] += run
            active[ia] = run == CHUNK
        out = offs.copy()
        out[valid] = h[valid]
        return out

    # score-0 seeds
    lo0 = -min(ef.target_begin, n)
    hi0 = min(ef.query_begin, m)
    kvec0 = np.arange(lo0, hi0 + 1, dtype=np.int64)
    M0 = np.maximum(kvec0, 0).astype(np.int32)
    M0 = extend(M0, kvec0)
    hist: list = [_WF(lo0, M0, None, None, None, None)]

    def find_end(wf):
        if wf is None or wf.M is None:
            return None
        kv = np.arange(wf.lo, wf.lo + len(wf.M), dtype=np.int64)
        h = wf.M.astype(np.int64)
        v = h - kv
        ok = (h > NEG) & (
            ((h == m) & (v >= 0) & (v <= n) & (n - v <= ef.target_end))
            | ((v == n) & (h >= 0) & (h <= m) & (m - h <= ef.query_end))
        )
        idx = np.nonzero(ok)[0]
        if len(idx) == 0:
            return None
        i = idx[0]  # smallest diagonal (deterministic)
        return int(kv[i]), int(h[i])

    end = find_end(hist[0])
    s = 0
    score_cap = (m + n) * max(x, e1 + o1, e2 + o2) + o1 + o2 + 10

    while end is None:
        s += 1
        if max_score is not None and s > max_score:
            return None, None
        if s > score_cap:
            raise RuntimeError("WFA failed to converge")
        # live range from sources
        lo = None
        hi = None
        for ss, name in ((s - x, "M"), (s - o1 - e1, "M"), (s - o2 - e2, "M"),
                         (s - e1, "I1"), (s - e2, "I2"),
                         (s - e1, "D1"), (s - e2, "D2")):
            if 0 <= ss < len(hist) and hist[ss] is not None:
                arr = getattr(hist[ss], name)
                if arr is not None and len(arr):
                    l0 = hist[ss].lo
                    lo = l0 if lo is None else min(lo, l0)
                    hi = l0 + len(arr) - 1 if hi is None else max(hi, l0 + len(arr) - 1)
        if lo is None:
            hist.append(None)
            continue
        lo -= 1
        hi += 1
        nk = hi - lo + 1
        kvec = np.arange(lo, hi + 1, dtype=np.int64)

        m_x = _get(hist, s - x, "M", lo, nk)
        m_o1 = _get(hist, s - o1 - e1, "M", lo, nk)
        m_o2 = _get(hist, s - o2 - e2, "M", lo, nk)
        i1_e = _get(hist, s - e1, "I1", lo, nk)
        i2_e = _get(hist, s - e2, "I2", lo, nk)
        d1_e = _get(hist, s - e1, "D1", lo, nk)
        d2_e = _get(hist, s - e2, "D2", lo, nk)

        def shift_r(a):  # value at k-1
            if a is None:
                return None
            out = np.full(nk, NEG, dtype=np.int32)
            out[1:] = a[:-1]
            return out

        def shift_l(a):  # value at k+1
            if a is None:
                return None
            out = np.full(nk, NEG, dtype=np.int32)
            out[:-1] = a[1:]
            return out

        def vmax(a, b):
            if a is None:
                return b
            if b is None:
                return a
            return np.maximum(a, b)

        i1 = vmax(shift_r(m_o1), shift_r(i1_e))
        i1 = None if i1 is None else np.where(i1 > NEG, i1 + 1, NEG).astype(np.int32)
        i2 = vmax(shift_r(m_o2), shift_r(i2_e))
        i2 = None if i2 is None else np.where(i2 > NEG, i2 + 1, NEG).astype(np.int32)
        d1 = vmax(shift_l(m_o1), shift_l(d1_e))
        d2 = vmax(shift_l(m_o2), shift_l(d2_e))

        mm = None if m_x is None else np.where(m_x > NEG, m_x + 1, NEG).astype(np.int32)
        Mnew = vmax(vmax(vmax(mm, i1), vmax(i2, d1)), d2)
        if Mnew is not None:
            h = Mnew.astype(np.int64)
            v = h - kvec
            ok = (Mnew > NEG) & (h >= 0) & (h <= m) & (v >= 0) & (v <= n)
            Mnew = np.where(ok, Mnew, NEG).astype(np.int32)
            Mnew = extend(Mnew, kvec)
        wf = _WF(lo, Mnew, i1, i2, d1, d2)
        hist.append(wf)
        end = find_end(wf)

    return s, _backtrace(hist, s, end, p, ef, m, n)


def _backtrace(hist, s, end, p: Penalties, ef: EndsFree, m: int, n: int):
    """Identical rules to wfa_np._backtrace, reading array history."""
    x, o1, e1, o2, e2 = (p.mismatch, p.gap_opening1, p.gap_extension1,
                         p.gap_opening2, p.gap_extension2)
    k, h = end
    ops_rev: list = []

    def emit(nn, op):
        if nn <= 0:
            return
        if ops_rev and ops_rev[-1][1] == op:
            ops_rev[-1] = (ops_rev[-1][0] + nn, op)
        else:
            ops_rev.append((nn, op))

    v = h - k
    if h == m and v < n:
        emit(n - v, "D")
    elif v == n and h < m:
        emit(m - h, "I")

    g = _get_scalar
    state = "M"
    while True:
        if state == "M":
            cur = h
            if s == 0:
                seed_off = max(0, k)
                emit(cur - seed_off, "=")
                if k < 0:
                    emit(-k, "D")
                elif k > 0:
                    emit(k, "I")
                break
            mm = g(hist, s - x, "M", k)
            cands = [
                ("X", (mm + 1) if mm > NEG else int(NEG)),
                ("I1", g(hist, s, "I1", k)),
                ("I2", g(hist, s, "I2", k)),
                ("D1", g(hist, s, "D1", k)),
                ("D2", g(hist, s, "D2", k)),
            ]
            pre = max(c for _, c in cands)
            emit(cur - pre, "=")
            h = pre
            for name, c in cands:
                if c == pre:
                    if name == "X":
                        emit(1, "X")
                        s -= x
                        h -= 1
                    else:
                        state = name
                    break
        elif state in ("I1", "I2"):
            o, e = (o1, e1) if state == "I1" else (o2, e2)
            wf_name = state
            emit(1, "I")
            open_ = g(hist, s - o - e, "M", k - 1)
            ext = g(hist, s - e, wf_name, k - 1)
            if open_ > NEG and open_ + 1 == h:
                s -= o + e
                h -= 1
                k -= 1
                state = "M"
            elif ext > NEG and ext + 1 == h:
                s -= e
                h -= 1
                k -= 1
            else:  # pragma: no cover
                raise RuntimeError("backtrace failure in I state")
        else:
            o, e = (o1, e1) if state == "D1" else (o2, e2)
            wf_name = state
            emit(1, "D")
            open_ = g(hist, s - o - e, "M", k + 1)
            ext = g(hist, s - e, wf_name, k + 1)
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
    return ops_rev
