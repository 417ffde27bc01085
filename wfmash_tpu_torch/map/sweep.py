"""Plane-sweep mapping filters (query axis and reference axis).

Equivalent of skch::Filter (reference: src/map/include/filter.hpp:38-535):
a sweep over BEGIN/END events keeps, at every event position, the
highest-scoring mappings (score = identity * log(blockLength)) plus up to
``secondaryToKeep`` secondaries, kills mappings overlapping a kept one by
more than ``overlapThreshold``, and finally drops everything never marked
good. The BST ordering is (score, start, id) DESCENDING; equal-best ties
are all kept (filter.hpp:95-130).

The reference's event vector is pre-sized with 2n default (0,0,0) entries
(filter.hpp:194,258 — a quirk); those only make no-op erases before any
insert, so they are not reproduced.
"""

from __future__ import annotations

import math

import numpy as np

from .l1l2 import FLAG_DISCARD, FLAG_OVERLAPPED, FLAG_REV


def _scores(m: np.ndarray) -> np.ndarray:
    """score = blockNucIdentity() * log(blockLength), lowest() when
    blockLength or identity <= 0 (filter.hpp:47-52)."""
    ident = (m["nuc_identity"].astype(np.float32) / np.float32(10000.0)).astype(
        np.float64
    )
    bl = m["block_length"].astype(np.float64)
    with np.errstate(divide="ignore"):
        s = ident * np.log(bl)
    s[(bl <= 0) | (ident <= 0)] = -np.finfo(np.float64).max
    return s


def _mark_good(order, state_discard, state_overlapped, scores,
               overlap_lo, overlap_hi, secondary_to_keep, overlap_threshold):
    """markGood on the current BST contents (filter.hpp:95-163).

    ``order``: list of mapping indices in BST order (descending
    (score, start, tiebreak))."""
    if not order:
        return
    beg = order[0]
    kept = 0
    i = 0
    nL = len(order)
    while i < nL:
        it = order[i]
        if (scores[beg] > scores[it] or not state_discard[it]) and kept > secondary_to_keep:
            break
        state_discard[it] = False
        kept += 1
        i += 1
    kit = i

    if overlap_threshold < 1.0:
        for j in range(kit, nL):
            idx = order[j]
            for l in range(kit):
                idx2 = order[l]
                lo = max(overlap_lo[idx], overlap_lo[idx2])
                hi = min(overlap_hi[idx], overlap_hi[idx2])
                ov = max(0, int(hi - lo))
                x_len = overlap_hi[idx] - overlap_lo[idx]
                y_len = overlap_hi[idx2] - overlap_lo[idx2]
                denom = min(x_len, y_len)
                overlap = ov / denom if denom > 0 else 0.0
                if overlap > overlap_threshold:
                    state_overlapped[idx] = True
                    state_discard[idx] = True
                    break


def _run_sweep(m, events, bst_sort_key, scores, overlap_lo, overlap_hi,
               secondary_to_keep, overlap_threshold):
    """Generic sweep: events = sorted list of (group_pos_key, type, idx)
    where type 1=BEGIN, 2=END; group boundary on group_pos_key change."""
    from bisect import insort, bisect_left

    discard = np.ones(len(m), dtype=bool)
    overlapped = np.zeros(len(m), dtype=bool)
    bst: list = []  # sorted by bst_sort_key(idx)

    i = 0
    n_ev = len(events)
    while i < n_ev:
        j = i
        key0 = events[i][0]
        while j < n_ev and events[j][0] == key0:
            j += 1
        for e in events[i:j]:
            idx = e[2]
            k = bst_sort_key(idx)
            if e[1] == 1:
                insort(bst, k)
            else:
                p = bisect_left(bst, k)
                if p < len(bst) and bst[p] == k:
                    bst.pop(p)
        order = [k[-1] for k in bst]
        _mark_good(order, discard, overlapped, scores,
                   overlap_lo, overlap_hi, secondary_to_keep, overlap_threshold)
        i = j

    return ~(discard | overlapped)


def filter_by_query_axis(m: np.ndarray, secondary_to_keep: int,
                         overlap_threshold: float) -> np.ndarray:
    """query::liFilterAlgorithm (filter.hpp:171-235). Returns keep mask."""
    n = len(m)
    if n <= 1:
        return np.ones(n, dtype=bool)
    scores = _scores(m)
    q_start = m["query_start"].astype(np.int64)
    q_end = q_start + m["block_length"]

    # BST order: (score, queryStartPos, refSeqId) DESCENDING (filter.hpp:64)
    def bst_key(idx):
        return (-scores[idx], -int(q_start[idx]), -int(m["ref_seq_id"][idx]), idx)

    events = []
    for idx in range(n):
        events.append((int(q_start[idx]), 1, idx))
        events.append((int(q_end[idx]), 2, idx))
    events.sort()

    return _run_sweep(m, events, bst_key, scores, q_start, q_end,
                      secondary_to_keep, overlap_threshold)


def filter_by_ref_axis(m: np.ndarray, seq_lengths, secondary_to_keep: int,
                       overlap_threshold: float) -> np.ndarray:
    """ref::filterMappings (filter.hpp:473-534). Returns keep mask.
    ``seq_lengths``: callable ref_seq_id -> length (for end-position +1
    wrap, filter.hpp:452-465)."""
    n = len(m)
    if n <= 1:
        return np.ones(n, dtype=bool)
    scores = _scores(m)
    r_start = m["ref_start"].astype(np.int64)
    r_end = r_start + m["block_length"]

    def bst_key(idx):
        return (-scores[idx], -int(r_start[idx]), idx)

    events = []
    for idx in range(n):
        events.append(((int(m["ref_seq_id"][idx]), int(r_start[idx])), 1, idx))
        seq_id = int(m["ref_seq_id"][idx])
        pos = int(r_end[idx])
        if pos == seq_lengths(seq_id) - 1:
            ekey = (seq_id + 1, 0)
        else:
            ekey = (seq_id, pos + 1)
        events.append((ekey, 2, idx))
    events.sort()

    return _run_sweep(m, events, bst_key, scores, r_start, r_end,
                      secondary_to_keep, overlap_threshold)


def filter_by_group(
    m: np.ndarray,
    secondary_to_keep: int,
    filter_ref: bool,
    group_of,            # callable seq_id array -> group array
    seq_lengths,         # callable seq_id -> length
    params,
) -> np.ndarray:
    """FilterUtils::filterByGroup (mappingFilter.hpp:220-296): plane sweep
    within each target group; returns the filtered array re-sorted by
    (queryStart, refSeqId, refStart, strand)."""
    from ..params import FILTER_MAP, FILTER_ONETOONE

    if len(m) == 0:
        return m.copy()

    order = np.lexsort((m["ref_start"], m["ref_seq_id"]))
    m = m[order]
    out_parts = []

    if params.filter_mode in (FILTER_MAP, FILTER_ONETOONE):
        groups = group_of(m["ref_seq_id"])
        i = 0
        n = len(m)
        while i < n:
            j = i + 1
            if params.skip_prefix:
                while j < n and groups[j] == groups[i]:
                    j += 1
            else:
                j = n
            sub = m[i:j]
            sub = sub[np.lexsort((sub["ref_start"], sub["ref_seq_id"],
                                  sub["query_start"]))]
            if filter_ref:
                keep = filter_by_ref_axis(sub, seq_lengths, secondary_to_keep,
                                          params.overlap_threshold)
            else:
                keep = filter_by_query_axis(sub, secondary_to_keep,
                                            params.overlap_threshold)
            out_parts.append(sub[keep])
            i = j
        out = np.concatenate(out_parts) if out_parts else m[:0]
    else:
        out = m.copy()

    strand_bit = (out["flags"] & FLAG_REV) != 0
    final_order = np.lexsort(
        (strand_bit, out["ref_start"], out["ref_seq_id"], out["query_start"])
    )
    return out[final_order]
