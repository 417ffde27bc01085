"""Windowed minmer extraction for the reference (target) index.

Equivalent of CommonFunc::addMinmers (reference:
src/map/include/commonFunc.hpp:439-708). For every sliding window of
``windowSize`` bases (equivalently ``w-k+1`` consecutive k-mer starts), the
s smallest DISTINCT canonical k-mer hashes form the window's sketch; the
output is one interval record per maximal run of windows where a hash stays
in the sketch with a constant strand-vote sign, then records longer than
``windowSize`` are chunked, sorted by (wpos, wpos_end) and consecutively
deduplicated by (wpos, hash).

Faithfully reproduced reference quirks (all observable in output):

* NO initial scan for 'N' inside the first k-mer: a k-mer starting at
  i < k-1 is only invalidated by 'N's at positions >= k-1 (addMinmers
  initializes ambig_kmer_count = 0, unlike sketchSequence);
* strand-split rule: a record is closed and reopened whenever an
  occurrence enters/leaves while the vote sum is zero or becomes zero
  (commonFunc.hpp:536-543, 570-577);
* on eviction of the largest sketch hash, its pending occurrences are
  returned to the backlog heap only if pos > currentWindowId (strictly;
  commonFunc.hpp:615);
* final flush closes open records at len - k + 1 (one past the last
  window id; commonFunc.hpp:653);
* records with wpos == wpos_end are dropped; chunk splitting appends the
  chunks after the un-split records before the final sort
  (commonFunc.hpp:661-693);
* strand sign: sum < 0 -> REV else FWD (the AMBIG arm at :672 is
  unreachable).

This Python implementation is the executable spec (validated against a
brute-force per-window oracle in tests); the C++ native scanner
(`wfmash_tpu/native`) reproduces it at speed and is cross-checked against it.
"""

from __future__ import annotations

import bisect
import heapq
from collections import deque

import numpy as np

from .kmers import (
    kmer_window_matrix,
    normalize,
    reverse_complement,
    valid_kmer_mask,  # noqa: F401  (used by tests/oracles)
)
from .murmur import murmur3_x64_128_low64

RECORD_DTYPE = np.dtype(
    [
        ("hash", np.uint64),
        ("wpos", np.int64),
        ("wpos_end", np.int64),
        ("seq_id", np.int32),
        ("strand", np.int8),
    ]
)


def _hash_stream(seq_bytes, k: int):
    """(canonical_hash, vote) arrays over ALL positions + validity mask.

    Validity follows addMinmers' lazy ambig counter: position i is invalid
    iff any of seq[max(i, k-1) .. i+k-1] is 'N' (no initial in-kmer scan).
    Palindromic positions (fwd == bwd) are also invalid.
    """
    s = normalize(seq_bytes)
    n = len(s) - k + 1
    if n <= 0:
        return (
            np.empty(0, dtype=np.uint64),
            np.empty(0, dtype=np.int8),
            np.empty(0, dtype=bool),
        )
    fwd = murmur3_x64_128_low64(kmer_window_matrix(s, k))
    bwd = murmur3_x64_128_low64(kmer_window_matrix(reverse_complement(s), k))[::-1]
    canon = np.minimum(fwd, bwd)
    vote = np.where(fwd < bwd, 1, -1).astype(np.int8)

    # ambig: N at position j+k-1 invalidates steps j..j+k-1
    is_n_at_tail = s[k - 1 :] == ord("N")  # indexed by step i -> seq[i+k-1]
    invalid = np.zeros(n, dtype=bool)
    idx = np.nonzero(is_n_at_tail[:n])[0]
    for j in idx:  # vectorized below for long runs
        invalid[j : j + k] = True
    valid = ~invalid & (fwd != bwd)
    return canon, vote, valid


class _Entry:
    __slots__ = ("wpos", "strand", "poslist")

    def __init__(self, wpos: int):
        self.wpos = wpos
        self.strand = 0
        self.poslist = deque()  # (pos, vote)


def winnow_minmers(seq_bytes, k: int, window_size: int, sketch_size: int,
                   seq_id: int = 0) -> np.ndarray:
    """Extract minmer interval records for one reference sequence."""
    canon, vote, valid = _hash_stream(seq_bytes, k)
    n = len(canon)
    records: list[tuple[int, int, int, int]] = []  # (hash, wpos, wend, strand)
    if n == 0:
        return np.empty(0, dtype=RECORD_DTYPE)

    q: deque = deque()  # (hash, vote, pos) of valid kmers, arrival order
    sw: dict[int, _Entry] = {}
    sw_keys: list[int] = []  # sorted hashes of sw (sketch is small)
    heap: list[tuple[int, int, int]] = []  # (hash, pos, vote)

    for i in range(n):
        W = i + k - window_size

        # ---- expiry of the window's oldest kmer (at most one per step)
        if q and q[0][2] < W:
            leaving_hash, leaving_vote, _ = q.popleft()
            if sw_keys and leaving_hash <= sw_keys[-1]:
                # Invariant: every active hash <= max(sketch) is in the
                # sketch (the reference dereferences find() unchecked).
                e = sw[leaving_hash]
                if len(e.poslist) == 1:
                    records.append((leaving_hash, e.wpos, W, e.strand))
                    del sw[leaving_hash]
                    sw_keys.pop(bisect.bisect_left(sw_keys, leaving_hash))
                else:
                    if e.strand - leaving_vote == 0 or e.strand == 0:
                        records.append((leaving_hash, e.wpos, W, e.strand))
                        e.wpos = W
                    e.strand -= leaving_vote
                    e.poslist.popleft()

        # ---- arrival of the current kmer
        if valid[i]:
            h = int(canon[i])
            v = int(vote[i])
            q.append((h, v, i))
            e = sw.get(h)
            if e is not None:
                e.poslist.append((i, v))
                if e.strand + v == 0 or e.strand == 0:
                    records.append((h, e.wpos, W, e.strand))
                    e.wpos = W
                e.strand += v
            else:
                heapq.heappush(heap, (h, i, v))

        # ---- sketch maintenance once windows are full
        if W >= 0:
            while heap and heap[0][1] < W:
                heapq.heappop(heap)

            if (sw_keys and heap and len(sw_keys) == sketch_size
                    and heap[0][0] < sw_keys[-1]):
                largest_hash = sw_keys.pop()
                e = sw.pop(largest_hash)
                records.append((largest_hash, e.wpos, W, e.strand))
                for pos, pvote in e.poslist:
                    if pos > W:  # strictly; commonFunc.hpp:615
                        heapq.heappush(heap, (largest_hash, pos, pvote))

            while heap and len(sw_keys) < sketch_size:
                if heap[0][1] < W:
                    heapq.heappop(heap)
                    if not heap:
                        break
                nh = heap[0][0]
                e = _Entry(W)
                sw[nh] = e
                bisect.insort(sw_keys, nh)
                while heap and heap[0][0] == nh:
                    _, pos, pvote = heapq.heappop(heap)
                    e.poslist.append((pos, pvote))
                    e.strand += pvote

    # ---- flush open records (ascending hash, rank <= s)
    flush_end = n  # len - k + 1
    for h in sw_keys[:sketch_size]:
        e = sw[h]
        records.append((h, e.wpos, flush_end, e.strand))

    return _postprocess(records, window_size, seq_id)


def _postprocess(records, window_size: int, seq_id: int) -> np.ndarray:
    # drop invalid/empty records (commonFunc.hpp:661-666)
    kept = [(h, a, b, s) for (h, a, b, s) in records if a >= 0 and b >= 0 and a != b]
    # chunk long windows; chunks appended after unchunked (commonFunc.hpp:670-693)
    out = []
    chunks = []
    for h, a, b, s in kept:
        sgn = -1 if s < 0 else 1
        if b > a + window_size:
            c = a
            while c < b:
                chunks.append((h, c, min(c + window_size, b), sgn))
                c += window_size
        else:
            out.append((h, a, b, sgn))
    out.extend(chunks)
    if not out:
        return np.empty(0, dtype=RECORD_DTYPE)
    arr = np.empty(len(out), dtype=RECORD_DTYPE)
    arr["hash"] = np.array([r[0] for r in out], dtype=np.uint64)
    arr["wpos"] = [r[1] for r in out]
    arr["wpos_end"] = [r[2] for r in out]
    arr["seq_id"] = seq_id
    arr["strand"] = [r[3] for r in out]
    # sort by (wpos, wpos_end) then consecutive-dedup by (wpos, hash)
    order = np.lexsort((arr["wpos_end"], arr["wpos"]))
    arr = arr[order]
    if len(arr) > 1:
        same = (arr["wpos"][1:] == arr["wpos"][:-1]) & (
            arr["hash"][1:] == arr["hash"][:-1]
        )
        keep_mask = np.concatenate([[True], ~same])
        arr = arr[keep_mask]
    return arr


def sketch_sequence_streaming(seq_bytes, k: int, sketch_size: int,
                              window_size: int, seq_id: int) -> np.ndarray:
    """Whole-sequence streaming MinHash reference sketch
    (--streaming-minhash, reference: commonFunc.hpp:338-427 +
    streamingMinHash.hpp:89-99).

    Multiset bottom-s over every canonical k-mer occurrence (duplicates
    occupy sketch slots, as the reference max-heap does); each retained
    occurrence emits one record anchored at the hash's FIRST position
    with span window_size and strand FWD, sorted by wpos.
    """
    from .kmers import canonical_kmer_hashes

    pos, canon, _vote = canonical_kmer_hashes(seq_bytes, k)
    if len(canon) == 0:
        return np.empty(0, dtype=RECORD_DTYPE)
    order = np.argsort(canon, kind="stable")
    kept = canon[order][:sketch_size]
    # first occurrence position per hash
    first_of = {}
    for p, h in zip(pos.tolist(), canon.tolist()):
        if h not in first_of:
            first_of[h] = p
    out = np.empty(len(kept), dtype=RECORD_DTYPE)
    out["hash"] = kept
    out["wpos"] = [first_of[h] for h in kept.tolist()]
    out["wpos_end"] = out["wpos"] + window_size
    out["seq_id"] = seq_id
    out["strand"] = 1
    return out[np.argsort(out["wpos"], kind="stable")]
