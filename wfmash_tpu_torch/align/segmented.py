"""Anchor-chain segmented alignment — the TPU-native wflambda.

The reference's hierarchical path (WFlign::wflign_affine_wavefront,
reference: src/common/wflign/src/wflign.cpp:1061-1175) cracks a huge
alignment into 256-base segments under a guiding wavefront with lazy
per-segment WFAs. That wavefront exists because the CPU must avoid touching
segments off the optimal path; on TPU the economics invert — thousands
of small segment WFAs in lockstep are nearly free (wfa_seg),
while a score-serial whole-block sweep is the bottleneck. So instead of
a guiding wavefront we pin the path with an exact-match anchor chain:

1. exact unique k-mer matches (2-bit packed codes, no hashing — matches
   are certain) between the block's query and target;
2. longest-increasing-subsequence chaining (strictly colinear);
3. cuts at anchor midpoints spaced >= seg_target apart — every cut lies
   INSIDE an exact match run, so each segment is aligned end-to-end
   independently and the stitched CIGAR replays exactly;
4. all segments from ALL blocks solve in lockstep on device; segments
   the kernel cannot certify (long, divergent, big indels, band-edge)
   escalate to the exact crossing-payload engine.

Divergence from the reference's default (exact biWFA per block) is a
documented fidelity-ledger item: segment CIGARs are exact WFAs between
anchor cuts, so results are replay-exact and near-optimal, but a path
that would stray from the anchor chain can differ from the global
optimum (same trade the reference itself made for years when wflambda
was its default path). WFMASH_TPU_SEGMENTED=0 restores exact biWFA.
"""

from __future__ import annotations

import sys
import threading

import numpy as np

from ..utils import perf
from . import cigar
from .wfa_np import EndsFree, Penalties, score_cigar
from .wfa_seg import TieredSegmentSolver

# 2-bit base codes; anything else (N etc.) invalidates overlapping k-mers
_B2 = np.full(256, -1, np.int8)
for _b, _c in ((ord("A"), 0), (ord("C"), 1), (ord("G"), 2), (ord("T"), 3)):
    _B2[_b] = _c

ANCHOR_K = 21


def _kmer_codes(seq: np.ndarray, k: int):
    """(L,) u8 -> (codes (L-k+1,) uint64, valid bool mask). Exact 2-bit
    packing (k <= 31): equal codes <=> equal k-mers, no collisions."""
    n = len(seq) - k + 1
    if n <= 0:
        return np.empty(0, np.uint64), np.empty(0, bool)
    b = _B2[seq]
    valid1 = b >= 0
    bu = np.where(valid1, b, 0).astype(np.uint64)
    code = np.zeros(n, np.uint64)
    for j in range(k):
        code = (code << np.uint64(2)) | bu[j:j + n]
    # a k-mer is valid iff all k bases are valid
    cs = np.concatenate(([0], np.cumsum(~valid1)))
    valid = (cs[k:] - cs[:-k]) == 0
    return code, valid


def _unique_positions(codes: np.ndarray, valid: np.ndarray):
    """Positions of k-mers occurring exactly once; returns (codes, pos)
    sorted by code."""
    pos = np.nonzero(valid)[0]
    c = codes[pos]
    # unstable sort is fine: only count-1 codes survive, so the order
    # within equal-code groups never reaches the output (stable radix
    # argsort on u64 costs ~5x an introsort)
    order = np.argsort(c)
    c, pos = c[order], pos[order]
    if len(c) == 0:
        return c, pos
    first = np.concatenate(([True], c[1:] != c[:-1]))
    count = np.diff(np.concatenate((np.nonzero(first)[0], [len(c)])))
    uniq = np.repeat(count == 1, count)
    return c[uniq], pos[uniq]


def _lis_chain(qpos: np.ndarray, tpos: np.ndarray):
    """Longest strictly-increasing chain of (qpos asc, tpos) anchors
    (patience sorting, O(n log n)); returns kept indices. Native C++
    fast path (bit-identical, tested); Python fallback below."""
    n = len(qpos)
    if n == 0:
        return np.empty(0, np.int64)
    order = np.lexsort((tpos, qpos))
    t = tpos[order]
    from ..native import lis_chain_native

    kept = lis_chain_native(t)
    if kept is not None:
        return order[kept]
    tails = []          # smallest tail tpos per chain length
    tails_idx = []
    parent = np.full(n, -1, np.int64)
    import bisect

    for i in range(n):
        j = bisect.bisect_left(tails, t[i])
        if j > 0:
            parent[i] = tails_idx[j - 1]
        if j == len(tails):
            tails.append(t[i])
            tails_idx.append(i)
        else:
            tails[j] = t[i]
            tails_idx[j] = i
    # walk back from the longest chain's last element
    out = []
    i = tails_idx[-1]
    while i >= 0:
        out.append(i)
        i = parent[i]
    out.reverse()
    return order[np.array(out, np.int64)]


def _rare_positions(codes: np.ndarray, valid: np.ndarray, max_occ: int):
    """Positions of k-mers occurring <= max_occ times (code-sorted)."""
    pos = np.nonzero(valid)[0]
    c = codes[pos]
    order = np.argsort(c, kind="stable")
    c, pos = c[order], pos[order]
    if len(c) == 0:
        return c, pos
    first = np.concatenate(([True], c[1:] != c[:-1]))
    count = np.diff(np.concatenate((np.nonzero(first)[0], [len(c)])))
    keep = np.repeat(count <= max_occ, count)
    return c[keep], pos[keep]


def find_anchors(q: np.ndarray, t: np.ndarray, k: int = ANCHOR_K,
                 max_occ: int = 1, max_pairs: int = 200_000):
    """Colinear chain of exact k-mer matches: (qpos, tpos) arrays
    (strictly increasing in both), possibly empty.

    max_occ > 1 admits REPEATED k-mers (up to max_occ occurrences per
    side, cartesian-paired) — the LIS chain then selects the colinear
    subset; needed for repeat-dense loci where unique k-mers are rare.
    """
    from ..native import find_anchors_native

    nat = find_anchors_native(q.tobytes(), t.tobytes(), k, max_occ,
                              max_pairs)
    if nat is not None:
        return nat
    qc, qv = _kmer_codes(q, k)
    tc, tv = _kmer_codes(t, k)
    if max_occ <= 1:
        if len(q) > 16384:
            # density sampling (spec rule, native twin in anchors.cpp):
            # big blocks carry ~1 unique anchor per bp — thousands of
            # times denser than the cut spacing needs; stride-4 query
            # positions quarter the join/sort/LIS cost
            qv = qv & (np.arange(len(qv)) % 4 == 0)
        return _match_chain(qc, qv, tc, tv)
    cq, pq = _rare_positions(qc, qv, max_occ)
    ct, pt = _rare_positions(tc, tv, max_occ)
    if len(cq) == 0 or len(ct) == 0:
        return np.empty(0, np.int64), np.empty(0, np.int64)
    tmap: dict = {}
    prev = None
    for c, p in zip(ct.tolist(), pt.tolist()):
        if c != prev:
            tmap[c] = [p]
            prev = c
        else:
            tmap[c].append(p)
    qs, ts = [], []
    for c, p in zip(cq.tolist(), pq.tolist()):
        hits = tmap.get(c)
        if hits:
            for tp in hits:
                qs.append(p)
                ts.append(tp)
            if len(qs) > max_pairs:
                break
    qpos = np.asarray(qs, np.int64)
    tpos = np.asarray(ts, np.int64)
    keep = _lis_chain(qpos, tpos)
    qpos, tpos = qpos[keep], tpos[keep]
    if len(qpos) > 1:
        mono = np.concatenate(([True], np.diff(qpos) > 0))
        qpos, tpos = qpos[mono], tpos[mono]
    return qpos, tpos


def _match_chain(qc, qv, tc, tv):
    cq, pq = _unique_positions(qc, qv)
    ct, pt = _unique_positions(tc, tv)
    ia = np.searchsorted(ct, cq)
    ia = np.clip(ia, 0, max(len(ct) - 1, 0))
    if len(ct) == 0 or len(cq) == 0:
        return np.empty(0, np.int64), np.empty(0, np.int64)
    hit = ct[ia] == cq
    qpos, tpos = pq[hit], pt[ia[hit]]
    keep = _lis_chain(qpos, tpos)
    qpos, tpos = qpos[keep], tpos[keep]
    # enforce strict monotonicity on qpos too (LIS is on tpos)
    if len(qpos) > 1:
        mono = np.concatenate(([True], np.diff(qpos) > 0))
        qpos, tpos = qpos[mono], tpos[mono]
    return qpos, tpos


def pick_cuts(qpos: np.ndarray, tpos: np.ndarray, k: int,
              seg_target: int, max_side: int, max_diff: int):
    """Choose cut points (anchor midpoints) so consecutive cuts are
    >= seg_target apart and each resulting segment fits the kernel
    envelope where possible. Returns (qcuts, tcuts) arrays."""
    qc, tc = [], []
    mid = k // 2
    n = len(qpos)
    # both arrays are strictly increasing (LIS + monotonicity filter),
    # so the greedy "skip while below threshold" scan can jump straight
    # to the first admissible anchor with searchsorted — the per-anchor
    # Python loop was the planning phase's hottest spot (~7 s per LPA
    # all-vs-all run)
    last_q = last_t = -(1 << 30)
    i = 0
    while i < n:
        cq_, ct_ = int(qpos[i]) + mid, int(tpos[i]) + mid
        if cq_ - last_q < seg_target or ct_ - last_t < seg_target:
            j1 = np.searchsorted(qpos, last_q + seg_target - mid)
            j2 = np.searchsorted(tpos, last_t + seg_target - mid)
            i = max(int(j1), int(j2), i + 1)
            continue
        qc.append(cq_)
        tc.append(ct_)
        last_q, last_t = cq_, ct_
        i += 1
    return qc, tc


def _solver_accepts(qlen, tlen, lseg, K):
    return (qlen < lseg and tlen < lseg and abs(qlen - tlen) < K // 2 - 1)


def _plan_bounds(q: bytes, t: bytes, seg_target: int, lseg: int, K: int):
    """Anchor-chain planning for one block: k=21 unique anchors, k=13
    rare-kmer retry, one recursive re-anchoring pass for oversize
    inter-anchor spans. Returns (bounds_q, bounds_t) or None when the
    block cannot be segmented (caller falls back to the exact path).
    One native call (anchors.cpp:plan_block, bit-identical — tested)
    with _plan_bounds_py as the spec fallback."""
    from ..native import plan_block_native

    nat = plan_block_native(q, t, seg_target, lseg, K)
    if nat is not NotImplemented:
        return nat
    return _plan_bounds_py(q, t, seg_target, lseg, K)


def _plan_bounds_py(q: bytes, t: bytes, seg_target: int, lseg: int,
                    K: int):
    """Executable spec for plan_block (pure host/numpy — safe in
    fork-pool children; find_anchors itself may use the native core)."""
    qa = np.frombuffer(q, np.uint8)
    ta = np.frombuffer(t, np.uint8)
    half = K // 2 - 8
    # anchor-k ladder: divergent blocks (down to the -p 70 floor) rarely
    # share unique 21-mers, but rare 13-mers still land every ~60 bp;
    # smaller k only ever ADDS cut choices (cuts stay exact matches)
    qc, tc = pick_cuts(*find_anchors(qa, ta, ANCHOR_K), ANCHOR_K,
                       seg_target, lseg - 1, half)
    if len(qc) < max(2, len(q) // (4 * lseg)):
        qc, tc = pick_cuts(*find_anchors(qa, ta, 13, max_occ=4), 13,
                           seg_target, lseg - 1, half)
    if len(qc) < max(2, len(q) // (8 * lseg)):
        # 25-40% divergent regions rarely share rare 13-mers; exact
        # 11-mers still land every ~50 bp there and cuts stay exact
        qc, tc = pick_cuts(*find_anchors(qa, ta, 11, max_occ=8), 11,
                           seg_target, lseg - 1, half)
    if len(qc) < 2:
        return None
    bounds_q = [0] + qc + [len(q)]
    bounds_t = [0] + tc + [len(t)]
    # refine: an inter-anchor span too big for the kernel gets one
    # recursive re-anchoring pass (tighter spacing) — every extra cut
    # keeps the piece off the expensive exact path
    rq, rt = [0], [0]
    for pi in range(len(bounds_q) - 1):
        sq0, sq1 = bounds_q[pi], bounds_q[pi + 1]
        st0, st1 = bounds_t[pi], bounds_t[pi + 1]
        big = not (_solver_accepts(sq1 - sq0, st1 - st0, lseg, K)
                   or sq1 == sq0 or st1 == st0)
        if big and sq1 - sq0 >= 64 and st1 - st0 >= 64:
            sp, tp2 = find_anchors(qa[sq0:sq1], ta[st0:st1], 13, max_occ=4)
            sqc, stc = pick_cuts(sp, tp2, 13, 128, lseg - 1, half)
            if not sqc:
                sp, tp2 = find_anchors(qa[sq0:sq1], ta[st0:st1], 11,
                                       max_occ=8)
                sqc, stc = pick_cuts(sp, tp2, 11, 128, lseg - 1, half)
            rq.extend(c + sq0 for c in sqc)
            rt.extend(c + st0 for c in stc)
        rq.append(sq1)
        rt.append(st1)
    return rq, rt


def segmented_host_align(q: bytes, t: bytes, p, seg_target: int = 256,
                         depth: int = 0):
    """Anchor-cut the block and solve every piece exactly on the native
    host WFA — the capped-score fallback of the latency-aware host
    engine (no device involved). Pieces are end-to-end exact; cuts lie
    inside exact k-mer matches, so the stitched CIGAR is replayable and
    near-optimal (same trade as the segmented device default, see
    ARCHITECTURE.md fidelity ledger). Pieces whose score exceeds a
    refinement cap re-anchor once at the full k ladder (divergent
    homology splits into cheap sub-pieces; unanchorable junk gets the
    trivial diagonal alignment). Returns merged (count, op) runs or
    None when the block is unanchorable (caller stays exact)."""
    import os as _os

    from ..native import segmented_solve_native, wfa_align_batch_native
    from .wfa_vec import wfa_align as _wfa

    if depth == 0:
        # one native call for the whole block (plan + placement +
        # pieces + caps + refinement recursion + stitch); this function
        # body remains the executable spec (bit-identical, tested)
        nat = segmented_solve_native(
            q, t, p, seg_target,
            int(_os.environ.get("WFMASH_TPU_REFINE_CAP", "800")))
        if nat is not NotImplemented:
            return nat
    bounds = _plan_bounds(q, t, seg_target, 512, 256)
    if bounds is None:
        return None
    bq, bt = bounds
    out: list = []

    def emit(cnt, op):
        if cnt <= 0:
            return
        if out and out[-1][1] == op:
            out[-1] = (out[-1][0] + cnt, op)
        else:
            out.append((cnt, op))

    plan: list = []      # ('P', piece_idx) | ('G', pre, piece_idx, post)
    #                      | ('I'/'D', count); pre/post are op-run lists
    pieces: list = []
    for i in range(len(bq) - 1):
        sq = q[bq[i]:bq[i + 1]]
        st = t[bt[i]:bt[i + 1]]
        if not sq:
            plan.append(("D", len(st), None, None))
        elif not st:
            plan.append(("I", len(sq), None, None))
            continue
        elif abs(len(sq) - len(st)) > 400:
            # structural gap: an end-to-end WFA pays O(skew) score
            # levels just to emit the gap. Place the SHORT side inside
            # the long one by k-mer diagonal voting, pin the flanks as
            # plain gap runs, align the middle end-to-end — the same
            # (ledgered) treatment as the segmented device path.
            skew = len(sq) - len(st)
            off = (_place_short(st, sq) if skew > 0
                   else _place_short(sq, st))
            if off is None:
                plan.append(("P", len(pieces), None, None))
                pieces.append((sq, st))
            elif skew > 0:
                plan.append(("G", [(off, "I")] if off else [],
                             len(pieces),
                             [(skew - off, "I")] if skew - off else []))
                pieces.append((sq[off:off + len(st)], st))
            else:
                plan.append(("G", [(off, "D")] if off else [],
                             len(pieces),
                             [(-skew - off, "D")] if -skew - off else []))
                pieces.append((sq, st[off:off + len(sq)]))
        else:
            plan.append(("P", len(pieces), None, None))
            pieces.append((sq, st))
    # per-piece caps, two purposes: (a) junk — a piece whose exact
    # score would exceed 55% of its all-mismatch bill (d >~ 0.55:
    # padding flanks, inserted sequence) is not homology; (b) refine —
    # at depth 0 a piece deeper than REFINE_CAP re-anchors at the full
    # k ladder instead of paying O(score^2) whole. Capped pieces that
    # re-anchor solve as sub-pieces; unanchorable ones get the trivial
    # diagonal alignment (ledgered with the segmented junk treatment).
    REFINE_CAP = int(_os.environ.get("WFMASH_TPU_REFINE_CAP", "800"))
    junk = [(p.mismatch * min(len(sq), len(st))) * 55 // 100 + 64
            for sq, st in pieces]
    # REFINE_CAP <= 0 disables the refine cap (junk cap only) — the
    # same convention as the native twin (segsolve.cpp)
    caps = ([min(j, REFINE_CAP) for j in junk]
            if depth == 0 and REFINE_CAP > 0 else junk)
    solved = wfa_align_batch_native(pieces, p, max_scores=caps)
    if solved is None:                       # per-piece fallback
        solved = [_wfa(sq, st, p, None, max_score=c)
                  for (sq, st), c in zip(pieces, caps)]
    fixed = []
    for (s_, ops_), pc in zip(solved, pieces):
        if ops_ is not None:
            fixed.append((s_, ops_))
            continue
        sub = (segmented_host_align(pc[0], pc[1], p, seg_target=128,
                                    depth=1)
               if depth == 0 and min(len(pc[0]), len(pc[1])) >= 96
               else None)
        fixed.append((None, sub if sub is not None else _diag_ops(*pc)))
    solved = fixed
    def emit_runs(runs):
        # bulk append with only the junction run merged (solver output
        # is already RLE-merged internally)
        if not runs:
            return
        i = 0
        if out and out[-1][1] == runs[0][1]:
            out[-1] = (out[-1][0] + runs[0][0], runs[0][1])
            i = 1
        out.extend(runs[i:])

    for ent in plan:
        if ent[0] == "P":
            emit_runs(solved[ent[1]][1])
        elif ent[0] == "G":
            _, pre, pi, post = ent
            emit_runs(pre)
            emit_runs(solved[pi][1])
            emit_runs(post)
        else:
            emit(ent[1], ent[0])
    return out


def _place_short(short: bytes, long_: bytes, k: int = 13,
                 max_occ: int = 8):
    """Best placement offset of `short` inside `long_` by k-mer diagonal
    voting (coarse 32-wide buckets, refined by the median in-bucket
    diagonal). Returns an offset in [0, len(long_) - len(short)] or None
    when fewer than 5 k-mer votes exist (no homology signal)."""
    from ..native import place_short_native

    nat = place_short_native(short, long_, k, max_occ)
    if nat is not NotImplemented:
        return nat
    s = np.frombuffer(short, np.uint8)
    l = np.frombuffer(long_, np.uint8)
    cs, ps = _rare_positions(*_kmer_codes(s, k), max_occ)
    cl, pl = _rare_positions(*_kmer_codes(l, k), max_occ)
    if len(cs) == 0 or len(cl) == 0:
        return None
    # merge-join the code-sorted lists, cartesian within equal runs
    diags = []
    i = j = 0
    while i < len(cs) and j < len(cl) and len(diags) < 100_000:
        if cs[i] < cl[j]:
            i += 1
        elif cs[i] > cl[j]:
            j += 1
        else:
            c = cs[i]
            i2 = i
            while i2 < len(cs) and cs[i2] == c:
                i2 += 1
            j2 = j
            while j2 < len(cl) and cl[j2] == c:
                j2 += 1
            for a in range(i, i2):
                for b in range(j, j2):
                    diags.append(int(pl[b]) - int(ps[a]))
            i, j = i2, j2
    if len(diags) < 5:
        return None
    d = np.asarray(diags)
    lim = len(long_) - len(short)
    d = d[(d >= -32) & (d <= lim + 32)]
    if len(d) < 5:
        return None
    bucket = d // 32
    vals, counts = np.unique(bucket, return_counts=True)
    best = vals[np.argmax(counts)]
    inb = d[bucket == best]
    return int(np.clip(np.median(inb), 0, lim))


def _diag_ops(q: bytes, t: bytes):
    """Trivial replayable alignment: per-base =/X along the main
    diagonal + the length difference as one trailing gap run. Score is
    within x*min(m,n) of optimal by construction; used only for
    junk-level pieces (proven score > the deepest tier budget)."""
    m, n = len(q), len(t)
    L = min(m, n)
    ops: list = []
    if L:
        eq = np.frombuffer(q, np.uint8)[:L] == np.frombuffer(
            t, np.uint8)[:L]
        flip = np.nonzero(np.diff(eq))[0]
        start = 0
        for f in list(flip) + [L - 1]:
            ops.append((int(f) + 1 - start, "=" if eq[start] else "X"))
            start = int(f) + 1
    if m > n:
        ops.append((m - n, "I"))
    elif n > m:
        ops.append((n - m, "D"))
    return ops


def _rev_try_host(rq, st, p, budget):
    """Fork-pool worker: score-bounded rev-comp try (pure numpy)."""
    from .wfa_vec import wfa_align as host_wfa

    _, rops = host_wfa(rq, st, p, max_score=budget)
    return rops


class _Batch:
    """One align_batch call's working state, handed from phase to phase.

    Job lists hold (job_index, piece_index, q, t, ends_free); placed_jobs
    hold (job_index, piece_index, mid_q, mid_t, pre, post), pre and post
    being the flank gap runs. plans[ji] is job ji's list of piece CIGARs
    ([None] while a job taken whole is unsolved)."""

    def __init__(self, jobs, stream):
        self.jobs = jobs
        self.plans: list = [None] * len(jobs)
        self.seg_jobs: list = []      # on the tier stream
        self.exact_jobs: list = []    # whole blocks and oversize pieces
        self.placed_jobs: list = []   # structural-gap middles
        self.escal_jobs: list = []    # tier rejects
        self.bounds_of: dict = {}     # ji -> (bounds_q, bounds_t)
        self.stream = stream
        self.mids: list = []          # the placed middles' tier results
        self.mids_unc: list = []
        self.device_error = None
        self.device_thread = None


class SegmentedEngine:
    """Engine wrapper: large blocks go anchored+segmented, everything
    else (small blocks, ends-free patch jobs, escalations) delegates to
    the wrapped exact engine. API-compatible with ExactWfaEngine /
    HostWfaEngine (align / align_batch).

    One route: the tiers take small blocks, boundary patches and
    pieces; tier rejects and whatever no tier's envelope holds go to the
    ExactWfaEngine, whose recursion leaves land back in the same tiers."""

    def __init__(self, penalties: Penalties, exact_engine, device,
                 seg_target: int = 256, min_block: int = 600, solver=None):
        self.p = penalties
        self.exact = exact_engine
        self.seg_target = seg_target
        self.min_block = min_block
        self.solver = solver or TieredSegmentSolver(penalties, device)
        # the exact engine's leaf batching runs on the same tiers. Under
        # segmentation it only sees leftovers (oversize gaps, unanchorable
        # blocks): the tiers accept everything <= ~2 kb, so 2-8 kb
        # leftovers go through its sweep recursion, and it takes banded
        # leaf results as the pieces are taken (fidelity-ledger
        # divergence)
        exact_engine.seg_solver = self.solver
        exact_engine.HOST_LEN = 1900
        exact_engine.banded_leaves = True
        self.stats = {"segments": 0, "escalated": 0, "exact_blocks": 0,
                      "inversions": 0, "banded": 0}
        self.threads = exact_engine.threads
        self.min_inversion_length = 23   # align_parameters.hpp:70
        # strict-parity mode skips the rev-comp inversion try entirely
        # (the emitting code is dead in the reference binary)
        self.detect_inversions = True
        # per-align_batch inversion records:
        # dict(ji, qa, qb, ta, tb, ops) with block-relative coords
        self.inversions: list = []

    @staticmethod
    def _escalate(cause: str, n: int = 1) -> None:
        """Counts n pieces sent on to the exact engine: the perf counters
        align.escalated and align.escalated.<cause>, the cause one of
        `tier_reject` (the tiers failed it), `oversize` (no tier's
        envelope holds it) and `unanchorable` (a block with no anchor
        plan). `stats` keeps the reference's narrower count: the tier
        rejects of the planned segments."""
        perf.add("align.escalated", n)
        perf.add(f"align.escalated.{cause}", n)

    def align(self, query: bytes, target: bytes, ends_free=None):
        return self.align_batch([(query, target, ends_free)])[0]

    def align_batch(self, jobs, bounds=None):
        """jobs: [(query, target, ends_free|None)] -> [ops | None].
        bounds (per-job score bounds) is the engines' common signature;
        the tiers take boundary patches without it."""
        before = dict(self.stats)
        with perf.span("align.engine") as eng:
            out = self._align_batch(jobs, eng)
        # these counters count as the reference's stats do; align.segments
        # and align.escalated count wider (_plan, _escalate)
        for key in ("exact_blocks", "banded", "inversions"):
            perf.add(f"align.{key}", self.stats[key] - before[key])
        return out

    def _align_batch(self, jobs, eng):
        """align_batch's phases, each a span under `eng` but the tiers'
        results taken into the plans (_accept, _placed_middles), which
        are eng's own time. self.inversions accumulates: the align loop
        clears it before each record batch and drains it after, and the
        patch stage's align() calls in between must keep the mains'."""
        with perf.span("align.plan"):
            b = _Batch(jobs, self.solver.stream(certify=True))
            # the device thread consumes the stream while planning fills it
            b.device_thread = threading.Thread(
                target=self._device_phase, args=(b, eng),
                name="wfmash-device-phase")
            b.device_thread.start()
            self._plan(b)
        with perf.span("align.seg_solve"):
            self._solve(b)
        self._accept(b)
        self._placed_middles(b)
        # tier rejects on the exact engine (a span apart from align.exact,
        # the host pass beside the device)
        with perf.span("align.escalate"):
            self._run_exact(b, b.escal_jobs, allow_seg=False)
        with perf.span("align.inversion"):
            if self.detect_inversions:
                self._detect_inversions(b, self._inversion_candidates(b))
        with perf.span("align.assemble"):
            return self._assemble(b)

    def _plan(self, b):
        """Small blocks and ends-free jobs (boundary patches) go to the
        tiers whole when an envelope holds them, else to the exact engine.
        Then each larger block gets an anchor plan against the cheap
        tier's envelope (512/256: re-anchoring an oversize span into
        ~256 bp tier-1 pieces beats solving it whole on a deep tier), and
        its pieces are classified as they are cut, so they reach the
        device thread while later blocks still plan."""
        todo = []
        for ji, (q, t, ef) in enumerate(b.jobs):
            q, t = bytes(q), bytes(t)
            if (ef is None and len(q) >= self.min_block
                    and len(t) >= self.min_block):
                todo.append((ji, q, t))
                continue
            b.plans[ji] = [None]
            if q and t and self.solver.accepts(len(q), len(t), ef):
                self._push_seg(b, ji, 0, q, t, ef)
            else:
                b.exact_jobs.append((ji, 0, q, t, ef))
                self.stats["exact_blocks"] += 1
                self._escalate("oversize")
        for ji, q, t in todo:
            pb = _plan_bounds(q, t, self.seg_target, 512, 256)
            if pb is None:
                b.plans[ji] = [None]
                b.exact_jobs.append((ji, 0, q, t, None))
                self.stats["exact_blocks"] += 1
                self._escalate("unanchorable")
                continue
            bq, bt = pb
            b.bounds_of[ji] = (bq, bt)
            b.plans[ji] = [None] * (len(bq) - 1)
            for pi in range(len(bq) - 1):
                self._classify(b, ji, pi, q[bq[pi]:bq[pi + 1]],
                               t[bt[pi]:bt[pi + 1]])
        self.stats["segments"] += len(b.seg_jobs)
        # align.segments: every piece planned and every job taken whole
        perf.add("align.segments", len(b.seg_jobs) + len(b.placed_jobs)
                 + len(b.exact_jobs))

    def _classify(self, b, ji, pi, sq, st):
        """Routes one planned piece: onto the tier stream when an envelope
        holds it end to end. A piece with a multi-hundred-bp length skew
        is a structural gap, where an end-to-end WFA would pay O(skew)
        score levels just to emit the gap: both ends of its LONGER side
        go free instead (the shorter side aligns locally, the rest comes
        out as leading/trailing gap runs, and stitching stays replay-
        exact). Too big for the tiers' ends-free envelope (an unbounded
        host ends-free WFA on a multi-kb piece costs seconds), the SHORT
        side is placed inside the long one by k-mer diagonal voting, the
        flanks become plain gap runs and the middle aligns end to end on
        the tiers: near-optimal and replay-exact (ledgered with the
        segmented mode's anchor-pinning divergence)."""
        if self.solver.accepts(len(sq), len(st)) or not sq or not st:
            self._push_seg(b, ji, pi, sq, st, None)
            return
        skew = len(sq) - len(st)
        if abs(skew) <= 400:
            b.exact_jobs.append((ji, pi, sq, st, None))
            self._escalate("oversize")
            return
        ef = (EndsFree(query_begin=skew, query_end=skew) if skew > 0 else
              EndsFree(target_begin=-skew, target_end=-skew))
        if self.solver.accepts(len(sq), len(st), ef):
            self._push_seg(b, ji, pi, sq, st, ef)
            return
        off = _place_short(st, sq) if skew > 0 else _place_short(sq, st)
        if off is None:
            b.exact_jobs.append((ji, pi, sq, st, ef))
            self._escalate("oversize")
        elif skew > 0:
            b.placed_jobs.append(
                (ji, pi, sq[off:off + len(st)], st,
                 [(off, "I")] if off else [],
                 [(skew - off, "I")] if skew - off else []))
        else:
            b.placed_jobs.append(
                (ji, pi, sq, st[off:off + len(sq)],
                 [(off, "D")] if off else [],
                 [(-skew - off, "D")] if -skew - off else []))

    def _score_ub(self, sq, st, ef=None):
        """A job's trivial score bound, all mismatches plus one gap for
        the length difference, so a garbage piece stops sweeping at it
        instead of at the tier's smax; None for an ends-free job, whose
        free spans void it."""
        if ef is not None:
            return None
        return (self.p.mismatch * min(len(sq), len(st))
                + self.p.gap_cost(abs(len(sq) - len(st))))

    def _push_seg(self, b, ji, pi, sq, st, ef):
        b.seg_jobs.append((ji, pi, sq, st, ef))
        b.stream.add((sq, st, ef), self._score_ub(sq, st, ef))

    def _device_phase(self, b, eng):
        """The device thread: tier-1 chunks launch while the main thread
        still plans, the deeper tiers follow once the stream closes, then
        the placed middles (planning is over once run() returns). The
        native WFA releases the GIL, so planning, the host exact pass and
        the device overlap instead of alternating."""
        try:
            # the solver's spans on this thread are eng's children
            with perf.adopt(eng):
                b.stream.run()
                if b.placed_jobs:
                    mids = [(q, t) for _, _, q, t, _, _ in b.placed_jobs]
                    b.mids = self.solver.solve(
                        mids, max_scores=[self._score_ub(q, t)
                                          for q, t in mids],
                        uncertified=b.mids_unc)
        except BaseException as e:  # re-raised on join
            b.device_error = e

    def _solve(self, b):
        """Closes the stream, runs the host exact pass beside the device
        thread (align.exact), then waits for the thread
        (align.device_wait)."""
        b.stream.close()
        try:
            with perf.span("align.exact"):
                self._run_exact(b, b.exact_jobs, allow_seg=True)
        finally:
            with perf.span("align.device_wait"):
                b.device_thread.join()
        if b.device_error is not None:
            raise b.device_error

    def _run_exact(self, b, batch, allow_seg):
        """Solves batch on the exact engine into the plans. Tier rejects
        already failed the tiers and must not go back to them
        (allow_seg=False); whole blocks and oversize pieces may still
        batch their recursion leaves there."""
        if not batch:
            return
        got = self.exact.align_batch(
            [(q, t, ef) for _, _, q, t, ef in batch], allow_seg=allow_seg)
        for (ji, pi, _, _, _), ops in zip(batch, got):
            b.plans[ji][pi] = ops

    @staticmethod
    def _banded(unc):
        """The CIGAR of an uncertified tier result, (ops, score, cert) of
        a band-edge contact above the certificate on a divergent piece:
        replayable and score-valid, just not provably optimal. Taken ONLY
        when the score is under 3x the certificate bound; far above it
        the true path left the band (repeat diagonal shifts give garbage
        all-indel in-band paths). Same trade wfmash's historical
        wflambda + WFmash pruning made."""
        if unc is None:
            return None
        ops, score, cert = unc
        return ops if score < 3 * max(cert, 1) else None

    def _accept(self, b):
        """The tier stream's results into the plans, banded ones taken
        (_banded) and junk-level pieces given the diagonal path; the rest
        go on b.escal_jobs."""
        res, status, unc = b.stream.res, b.stream.st, b.stream.unc
        for k, ((ji, pi, sq, st, ef), ops) in enumerate(
                zip(b.seg_jobs, res)):
            if ops is None:
                ops = self._banded(unc[k])
                if ops is not None:
                    self.stats["banded"] += 1
            if (ops is None and ef is None and max(len(sq), len(st)) <= 2047
                    and status[k][0] == "scorecap"):
                # junk-level piece: every banded sweep ran out of score
                # budget without finding a path within the trivial
                # all-mismatch bound — exact alignment of near-random
                # sequence would buy a few percent of score for seconds of
                # host time. The diagonal path instead (replayable;
                # ledgered with the banded-piece divergence).
                ops = _diag_ops(sq, st)
                self.stats["banded"] += 1
            if ops is None:
                b.escal_jobs.append((ji, pi, sq, st, ef))
                self.stats["escalated"] += 1
                self._escalate("tier_reject")
            else:
                b.plans[ji][pi] = ops

    def _placed_middles(self, b):
        """The placed structural-gap middles' tier results into the plans,
        banded ones taken, tier rejects solved on the exact engine (the
        bounded middle, never the ends-free piece), each wrapped in its
        flank gap runs."""
        if not b.placed_jobs:
            return
        got = b.mids
        for k, ops in enumerate(got):
            if ops is None:
                got[k] = self._banded(b.mids_unc[k])
                if got[k] is not None:
                    self.stats["banded"] += 1
        host = [k for k, ops in enumerate(got) if ops is None]
        if host:
            self._escalate("tier_reject", len(host))
            with perf.span("align.escalate"):
                solved = self.exact.align_batch(
                    [(b.placed_jobs[k][2], b.placed_jobs[k][3], None)
                     for k in host], allow_seg=False)
            for k, ops in zip(host, solved):
                got[k] = ops
        for (ji, pi, _, _, pre, post), ops in zip(b.placed_jobs, got):
            wrapped = (cigar.merge_adjacent(pre, list(ops)) if pre
                       else list(ops))
            b.plans[ji][pi] = (cigar.merge_adjacent(wrapped, post) if post
                               else wrapped)

    def _inversion_candidates(self, b):
        """Pieces for the rev-comp try (wflign_patch.cpp:405-538): every
        DIVERGENT piece of a planned block, the tier rejects and each
        piece whose forward score is at least a quarter of its
        all-mismatch bill. Score-based, not routing-based: the deeper
        tiers solve many divergent pieces forward on the device. The bar
        sits below an inverted region's cheapest forward treatment,
        skipping it with two gap runs (~2*gap_cost(len), ~2 a base with
        e2=1), not near the mismatch bill."""
        cands = [e for e in b.escal_jobs if e[0] in b.bounds_of]
        seen = {(e[0], e[1]) for e in b.escal_jobs}
        for ji, pi, sq, st, ef in b.seg_jobs + b.exact_jobs:
            if (ji, pi) in seen or ji not in b.bounds_of or ef is not None:
                continue
            ops = b.plans[ji][pi]
            if ops is None:
                continue
            bill = self.p.mismatch * min(len(sq), len(st))
            if 4 * score_cigar(ops, self.p) >= bill:
                cands.append((ji, pi, sq, st, ef))
        return cands

    def _assemble(self, b):
        """Each job's pieces stitched into one CIGAR; None, with a
        warning, for a job with a piece left unsolved."""
        results = []
        n_pieces = n_ops = 0
        for ji, pieces in enumerate(b.plans):
            holes = [pi for pi, ops in enumerate(pieces) if ops is None]
            if holes:
                print(f"[wfmash::align] WARNING: block {ji} "
                      f"(q={len(b.jobs[ji][0])} t={len(b.jobs[ji][1])}) "
                      f"unresolved: plan={len(pieces)} holes={holes[:8]}",
                      file=sys.stderr)
                results.append(None)
                continue
            ops = cigar.stitch_pieces(pieces)
            n_pieces += len(pieces)
            n_ops += len(ops)
            results.append(ops)
        perf.add("align.assemble.pieces", n_pieces)
        perf.add("align.assemble.ops", n_ops)
        return results

    def _detect_inversions(self, b, candidates):
        """Reverse-complement try on divergent pieces (reference:
        wflign_patch.cpp:405-538 — the forward alignment stays in the
        main CIGAR; a rev-comp alignment that completes within
        ceil(0.9 * fwd_score) steps is recorded for a separate
        pt:Z:true iv:Z:true PAF row)."""
        import math

        from ..sketch.kmers import reverse_complement

        mil = self.min_inversion_length
        cands = [(ji, pi, sq, st) for ji, pi, sq, st, ef in candidates
                 if ef is None and len(sq) >= mil and len(st) >= mil
                 and b.plans[ji][pi] is not None]
        if not cands:
            return
        rev_jobs = [(bytes(reverse_complement(bytearray(sq))), st)
                    for _, _, sq, st in cands]
        budgets = [int(math.ceil(
            score_cigar(b.plans[ji][pi], self.p) * 0.9))
            for (ji, pi, _, _) in cands]
        rev_got = self._rev_native(rev_jobs, budgets)
        if rev_got is None:
            rev_got = self._rev_tiers(rev_jobs, budgets)
        for (ji, pi, sq, st), rops, budget in zip(cands, rev_got, budgets):
            if rops is None or score_cigar(rops, self.p) > budget:
                continue
            bq, bt = b.bounds_of[ji]
            self.inversions.append(dict(
                ji=ji, qa=bq[pi], qb=bq[pi + 1], ta=bt[pi],
                tb=bt[pi + 1], ops=rops))
            self.stats["inversions"] += 1

    def _rev_native(self, rev_jobs, budgets):
        """One capped native call for ALL tries: each either completes
        within its budget (exact evidence) or is PROVEN over it (the cap
        rejection). A device pre-screen cannot prune this — banded
        failures prove nothing about out-of-band paths and banded
        successes are non-canonical co-optimals — and the native optimum
        is the reference's answer. None without the native library."""
        from ..native import (WfaMemoryBudget, get_wfa_lib,
                              wfa_align_batch_native)

        try:
            if get_wfa_lib() is None:
                return None
        except Exception:   # pragma: no cover - import failure
            return None
        try:
            solved = wfa_align_batch_native(rev_jobs, self.p,
                                            max_scores=budgets)
        except WfaMemoryBudget:   # pragma: no cover - giant piece
            return None
        return None if solved is None else [ops for _, ops in solved]

    def _rev_tiers(self, rev_jobs, budgets):
        """The tries on the tiers, without the native library. certify=
        False: a banded rev-comp CIGAR within budget is a real alignment
        within budget (sound evidence of the inversion), and the 0.9x
        forward budget rides into the kernel as a per-job score cap. Only
        a within-budget result is conclusive: a banded sweep at the score
        cap proves nothing about OUT-OF-BAND rev paths within budget (gap
        ladders can leave any fixed band for less than these budgets),
        and a banded CIGAR over budget may shadow an in-band optimum under
        it — both retry exact-capped on the host, matching the native
        route's (and the reference's) semantics. (The former shortcut
        "scorecap proves over-budget" missed 122 of 242 LPA
        inversions.)"""
        from ..native import WfaMemoryBudget, wfa_align_batch_native

        rev_got = self.solver.solve(rev_jobs, certify=False,
                                    max_scores=budgets)
        fb = [k for k, rops in enumerate(rev_got)
              if rops is None or score_cigar(rops, self.p) > budgets[k]]
        if not fb:
            return rev_got
        got = None
        try:
            solved = wfa_align_batch_native(
                [rev_jobs[k] for k in fb], self.p,
                max_scores=[budgets[k] for k in fb])
            if solved is not None:
                got = [ops for _, ops in solved]
        except WfaMemoryBudget:   # pragma: no cover - giant piece
            got = None
        fb_args = [(rev_jobs[k][0], rev_jobs[k][1], self.p,
                    budgets[k]) for k in fb]
        if got is None and self.threads > 1 and len(fb) >= 8:
            from ..utils.hostpool import get_pool

            pool = get_pool(self.threads)
            if pool is not None:
                got = pool.starmap(
                    _rev_try_host, fb_args,
                    chunksize=max(1, len(fb) // (4 * self.threads)))
        if got is None:
            got = [_rev_try_host(*a) for a in fb_args]
        for k, rops in zip(fb, got):
            rev_got[k] = rops
        return rev_got
