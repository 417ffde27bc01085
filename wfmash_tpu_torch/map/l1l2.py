"""L1/L2 mapping stages for one query fragment.

Host-exact equivalents of MappingCore (reference:
src/map/include/mappingCore.hpp) and SlideMapper (slidingMap.hpp):

* L1: join the fragment's sketch hashes against the index posting table,
  merge all interval endpoints sorted by (seq_id, pos, side), and sweep to
  find windows whose distinct-hash intersection reaches the (hypergeometric,
  two-pass) minimum-hit threshold;
* L2: within each L1 candidate range, slide over the position-sorted minmer
  records maintaining the bottom-s union pivot (SlideMapper) to find the
  offsets maximizing the shared-sketch count, then gate by identity.

For split mapping every fragment has len == windowLength so windowLen
(= Q.len - w) is 0 and the hash-dedup branches are bypassed — both paths are
implemented, matching the reference's branches.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass

import numpy as np

from ..params import MapParams, STRAND_FWD, STRAND_REV
from ..sketch.minhash import FragmentSketch
from . import stats

# Compact mapping record (base_types.hpp:154-253)
MAPPING_DTYPE = np.dtype(
    [
        ("ref_seq_id", np.uint32),
        ("ref_start", np.uint32),
        ("query_start", np.uint32),
        ("block_length", np.uint32),
        ("n_merged", np.uint32),
        ("conserved_sketches", np.uint32),
        ("nuc_identity", np.uint16),   # scaled x10000
        ("flags", np.uint8),           # bit0 strand REV, bit1 discard, bit2 overlapped
        ("kmer_complexity", np.uint8),  # scaled x100
    ]
)

FLAG_REV = 0x01
FLAG_DISCARD = 0x02
FLAG_OVERLAPPED = 0x04


@dataclass
class L1Candidate:
    seq_id: int
    range_start: int
    range_end: int
    intersection_size: int


def get_seed_interval_points(
    sketch: FragmentSketch,
    index,
    query_seq_id: int,
    query_group: int,
    group_of,           # callable seq_id -> group
    params: MapParams,
) -> np.ndarray:
    """Gather + filter + sort interval endpoints for the fragment's sketch
    hashes (mappingCore.hpp:81-131). Returns an ENDPOINT_DTYPE array sorted
    by (seq_id, pos, side)."""
    starts, ends = index.lookup(sketch.hashes)
    lens = ends - starts
    total = int(lens.sum())
    if total == 0:
        return index.endpoints[:0]
    # gather all ranges with one fancy index (a per-range structured
    # concatenate costs ~36 field promotions per fragment): expand
    # [s, e) ranges into a flat index vector by cumsum-of-steps
    nz = lens > 0
    S = starts[nz].astype(np.int64)
    L = lens[nz].astype(np.int64)
    csum = np.cumsum(L)
    idx = np.ones(total, np.int64)
    idx[0] = S[0]
    idx[csum[:-1]] = S[1:] - (S[:-1] + L[:-1] - 1)
    pts = index.endpoints[np.cumsum(idx)]

    # self/group/lower-triangular skip (mappingCore.hpp:109-118)
    tgt_groups = group_of(pts["seq_id"])
    skip = np.zeros(len(pts), dtype=bool)
    if params.skip_self or params.skip_prefix:
        skip |= tgt_groups == query_group
    if params.lower_triangular:
        skip |= query_seq_id <= pts["seq_id"]
    pts = pts[~skip]

    order = np.lexsort((pts["side"], pts["pos"], pts["seq_id"]))
    return pts[order]


def compute_l1_candidate_regions(
    sketch_size: int,
    q_len: int,
    pts: np.ndarray,
    minimum_hits: int,
    params: MapParams,
    sketch_cutoffs: np.ndarray,
    out: list[L1Candidate],
) -> None:
    """Two-pass interval-stacking sweep (mappingCore.hpp:136-301) over one
    group's endpoint subrange."""
    if len(pts) == 0:
        return
    window_len = max(0, q_len - params.window_length)
    cluster_len = params.window_length

    pos = np.ascontiguousarray(pts["pos"], dtype=np.int64)
    seq = np.ascontiguousarray(pts["seq_id"], dtype=np.int64)
    side = np.ascontiguousarray(pts["side"], dtype=np.int8)
    hashes = np.ascontiguousarray(pts["hash"], dtype=np.uint64)

    # native fast path (bit-identical C++ port; tests cross-check)
    from ..native import l1_sweep_native

    nat = l1_sweep_native(
        pos, seq, side, hashes, window_len, minimum_hits,
        params.stage1_topANI_filter, params.stage2_full_scan, sketch_size,
        max(1.0, params.sketch_size / 1000.0), sketch_cutoffs)
    if nat is not None:
        local = [L1Candidate(seq_id=a, range_start=b, range_end=c,
                             intersection_size=d) for (a, b, c, d) in nat]
        _join_candidates(local, out, cluster_len)
        return

    def sweep():
        """Yield (seq_id, position, coverage) per distinct event position."""
        n = len(pts)
        overlap = 0
        freq: dict[int, int] = {}
        trailing = 0
        leading = 0
        while leading < n:
            lead_seq = seq[leading]
            lead_pos = pos[leading]
            while trailing < n and (
                (seq[trailing] == lead_seq and pos[trailing] <= lead_pos - window_len)
                or seq[trailing] < lead_seq
            ):
                if side[trailing] == -1:  # CLOSE
                    h = int(hashes[trailing])
                    if window_len != 0:
                        freq[h] = freq.get(h, 0) - 1
                    if window_len == 0 or freq.get(h, 0) == 0:
                        overlap -= 1
                trailing += 1
            # the reference groups the leading advance by POSITION ONLY
            # (mappingCore.hpp:176,238) — not by (seq, pos)
            while leading < n and pos[leading] == lead_pos:
                if side[leading] == 1:  # OPEN
                    h = int(hashes[leading])
                    if window_len == 0 or freq.get(h, 0) == 0:
                        overlap += 1
                    if window_len != 0:
                        freq[h] = freq.get(h, 0) + 1
                leading += 1
            yield lead_seq, lead_pos, overlap

    # ---- pass 1: best intersection (when stage1 filter enabled)
    if params.stage1_topANI_filter:
        best = 0
        for _, _, cov in sweep():
            best = max(best, cov)
        if best < minimum_hits:
            return
        bucket = int(
            min(best, sketch_size)
            / max(1.0, params.sketch_size / 1000.0)  # fixed::ss_table_max
        )
        minimum_hits = max(int(sketch_cutoffs[bucket]), minimum_hits)

    # ---- pass 2: emit candidate regions
    local: list[L1Candidate] = []
    in_cand = False
    cand = None
    prev = None  # (seq, pos, coverage at that pos)
    for lead_seq, lead_pos, cov in _pairwise_prev(sweep()):
        # cov here is the coverage of the PREVIOUS position (see helper)
        prev_seq, prev_pos, prev_overlap = cov
        if prev_overlap >= minimum_hits:
            if in_cand and cand.seq_id != prev_seq:
                local.append(cand)
                cand = None
                in_cand = False
            if not in_cand:
                cand = L1Candidate(
                    seq_id=int(prev_seq),
                    range_start=int(prev_pos - window_len),
                    range_end=int(prev_pos - window_len),
                    intersection_size=int(prev_overlap),
                )
                in_cand = True
            else:
                if params.stage2_full_scan:
                    cand.intersection_size = max(cand.intersection_size, int(prev_overlap))
                    cand.range_end = int(prev_pos - window_len)
                elif cand.intersection_size < prev_overlap:
                    cand.intersection_size = int(prev_overlap)
                    cand.range_start = int(prev_pos - window_len)
                    cand.range_end = int(prev_pos - window_len)
        else:
            if in_cand:
                local.append(cand)
                cand = None
            in_cand = False
    if in_cand:
        local.append(cand)

    _join_candidates(local, out, cluster_len)


def _join_candidates(local, out, cluster_len):
    """join proximal candidates (mappingCore.hpp:287-300)"""
    for c in local:
        if (
            not out
            or c.seq_id != out[-1].seq_id
            or c.range_start > out[-1].range_end + cluster_len
        ):
            out.append(c)
        else:
            out[-1].range_end = c.range_end
            out[-1].intersection_size = max(
                c.intersection_size, out[-1].intersection_size
            )


def _pairwise_prev(it):
    """Reproduce the reference's sampling: the coverage of position P is
    examined in the round AFTER P was processed (mappingCore.hpp:216-249);
    the final position's coverage is never examined (always zero when
    windowLen == 0 — the last event is a CLOSE)."""
    prev = None
    for seq_id, p, cov in it:
        if prev is not None:
            yield seq_id, p, prev
        prev = (seq_id, p, cov)


class SlideMapper:
    """Bottom-s union pivot over the query sketch (slidingMap.hpp:27-212)."""

    __slots__ = (
        "q_hashes", "q_strand", "strand_vote", "num_before", "active",
        "pivot", "piv_rank", "shared_sketch", "strand_votes",
        "intersection_size", "sketch_size",
    )

    def __init__(self, sketch: FragmentSketch):
        n = sketch.sketch_size
        self.sketch_size = n
        self.q_hashes = [int(h) for h in sketch.hashes]     # ascending
        self.q_strand = [int(s) for s in sketch.strand]
        self.strand_vote = [0] * n
        self.num_before = [1] * n
        self.active = [False] * n
        self.pivot = n - 1          # index of last element
        self.piv_rank = n
        self.shared_sketch = 0
        self.strand_votes = 0
        self.intersection_size = 0

    def insert(self, h: int, strand: int) -> None:
        loc = bisect.bisect_left(self.q_hashes, h)
        if loc >= len(self.q_hashes):
            return
        if self.q_hashes[loc] == h:
            self.active[loc] = True
            self.strand_vote[loc] += self.q_strand[loc] * strand
            self.intersection_size += 1
            if self.q_hashes[loc] <= self.q_hashes[self.pivot]:
                self.shared_sketch += 1
                self.strand_votes += self.strand_vote[loc]
        else:
            self.num_before[loc] += 1
            if self.q_hashes[loc] <= self.q_hashes[self.pivot]:
                self.piv_rank += 1
            if self.piv_rank > self.sketch_size:
                self.shared_sketch -= 1 if self.active[self.pivot] else 0
                self.strand_votes -= self.strand_vote[self.pivot]
                self.piv_rank -= self.num_before[self.pivot]
                self.pivot -= 1

    def delete(self, h: int, strand: int) -> None:
        loc = bisect.bisect_left(self.q_hashes, h)
        if loc >= len(self.q_hashes):
            return
        if self.q_hashes[loc] == h:
            if self.q_hashes[loc] <= self.q_hashes[self.pivot]:
                self.shared_sketch -= 1
                self.strand_votes -= self.strand_vote[loc]
            self.active[loc] = False
            self.strand_vote[loc] = 0
            self.intersection_size -= 1
        else:
            self.num_before[loc] -= 1
            if self.q_hashes[loc] <= self.q_hashes[self.pivot]:
                self.piv_rank -= 1
            if (
                self.pivot + 1 < len(self.q_hashes)
                and self.piv_rank + self.num_before[self.pivot + 1]
                <= self.sketch_size
            ):
                self.pivot += 1
                self.shared_sketch += 1 if self.active[self.pivot] else 0
                self.strand_votes += self.strand_vote[self.pivot]
                self.piv_rank += self.num_before[self.pivot]


@dataclass
class L2Mapping:
    seq_id: int
    mean_optimal_pos: int
    optimal_start: int
    optimal_end: int
    shared_sketch_size: int
    strand: int


def compute_l2_mapped_regions(
    sketch: FragmentSketch,
    q_len: int,
    candidate: L1Candidate,
    index,
    params: MapParams,
) -> list[L2Mapping]:
    """Sliding shared-sketch maximization within an L1 candidate
    (mappingCore.hpp:306-442)."""
    mi = index.minmer_index
    window_len = max(0, q_len - params.window_length)

    # native fast path (bit-identical C++ port; tests cross-check)
    from ..native import l2_walk_native

    nat = l2_walk_native(
        index.soa(), candidate.seq_id, candidate.range_start,
        candidate.range_end, np.ascontiguousarray(sketch.hashes, np.uint64),
        np.ascontiguousarray(sketch.strand, np.int8), window_len,
        params.window_length)
    if nat is not None:
        return [
            L2Mapping(seq_id=a, mean_optimal_pos=b, optimal_start=c,
                      optimal_end=d, shared_sketch_size=e,
                      strand=STRAND_FWD if f > 0 else STRAND_REV)
            for (a, b, c, d, e, f) in nat
        ]

    # lower_bound by (seq_id, wpos) >= (cand.seq_id, range_start - w - 1)
    lo_key_seq = candidate.seq_id
    lo_key_pos = candidate.range_start - params.window_length - 1
    lo = _lower_bound_records(mi, lo_key_seq, lo_key_pos)

    import heapq

    sliding: list[tuple[int, int]] = []  # (wpos_end, record index) min-heap
    freq: dict[int, int] = {}
    slide = SlideMapper(sketch)

    out: list[L2Mapping] = []
    best_sketch_size = 1
    in_cand = False
    cur = None
    i = lo
    n = len(mi)

    # set up window: records before range_start still covering it
    while i < n and mi["seq_id"][i] == candidate.seq_id and mi["wpos"][i] < candidate.range_start:
        if mi["wpos_end"][i] > candidate.range_start:
            h = int(mi["hash"][i])
            if window_len > 0:
                freq[h] = freq.get(h, 0) + 1
            if window_len == 0 or freq.get(h, 0) == 1:
                heapq.heappush(sliding, (int(mi["wpos_end"][i]), i))
                slide.insert(h, int(mi["strand"][i]))
        i += 1

    prev_i = i
    while i < n and mi["seq_id"][i] == candidate.seq_id and mi["wpos"][i] <= candidate.range_end + window_len:
        prev_strand_votes = slide.strand_votes
        wpos = int(mi["wpos"][i])

        # Eviction mirrors mappingCore.hpp:358-368: only the first record of
        # each hash sits in the heap; duplicate arrivals only bumped freq, so
        # the front's freq is drained one per loop pass before the pop.
        while sliding and sliding[0][0] <= wpos - window_len:
            j = sliding[0][1]
            h = int(mi["hash"][j])
            if window_len > 0:
                freq[h] = freq.get(h, 0) - 1
            if window_len == 0 or freq.get(h, 0) == 0:
                slide.delete(h, int(mi["strand"][j]))
                heapq.heappop(sliding)

        h = int(mi["hash"][i])
        if window_len > 0:
            freq[h] = freq.get(h, 0) + 1
        if window_len == 0 or freq.get(h, 0) == 1:
            slide.insert(h, int(mi["strand"][i]))
            heapq.heappush(sliding, (int(mi["wpos_end"][i]), i))
        else:
            i += 1
            continue

        if slide.shared_sketch > best_sketch_size:
            out.clear()
            in_cand = True
            best_sketch_size = slide.shared_sketch
            cur = L2Mapping(
                seq_id=candidate.seq_id,
                mean_optimal_pos=0,
                optimal_start=wpos - window_len,
                optimal_end=wpos - window_len,
                shared_sketch_size=slide.shared_sketch,
                strand=0,
            )
        elif slide.shared_sketch == best_sketch_size:
            if not in_cand:
                cur = L2Mapping(
                    seq_id=candidate.seq_id,
                    mean_optimal_pos=0,
                    optimal_start=wpos - window_len,
                    optimal_end=wpos - window_len,
                    shared_sketch_size=slide.shared_sketch,
                    strand=0,
                )
            in_cand = True
            cur.optimal_end = wpos - window_len
        else:
            if in_cand:
                _close_l2(cur, prev_strand_votes, out, params)
                cur = None
            in_cand = False
        prev_i = i
        i += 1

    if in_cand:
        _close_l2(cur, slide.strand_votes, out, params)

    return out


def _close_l2(cur: L2Mapping, strand_votes: int, out: list[L2Mapping],
              params: MapParams) -> None:
    cur.mean_optimal_pos = (cur.optimal_start + cur.optimal_end) // 2
    cur.strand = STRAND_FWD if strand_votes >= 0 else STRAND_REV
    if not out or out[-1].optimal_end + params.window_length < cur.optimal_start:
        out.append(
            L2Mapping(
                seq_id=cur.seq_id,
                mean_optimal_pos=cur.mean_optimal_pos,
                optimal_start=cur.optimal_start,
                optimal_end=cur.optimal_end,
                shared_sketch_size=cur.shared_sketch_size,
                strand=cur.strand,
            )
        )
    else:
        out[-1].optimal_end = cur.optimal_end
        out[-1].mean_optimal_pos = (out[-1].optimal_start + out[-1].optimal_end) // 2


def _lower_bound_records(mi: np.ndarray, seq_id: int, wpos: int) -> int:
    """First index with (seq_id, wpos) >= key, over the (seq_id, wpos)-sorted
    record array."""
    lo = np.searchsorted(mi["seq_id"], seq_id, side="left")
    hi = np.searchsorted(mi["seq_id"], seq_id, side="right")
    return int(lo + np.searchsorted(mi["wpos"][lo:hi], wpos, side="left"))
