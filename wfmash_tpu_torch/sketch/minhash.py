"""Fragment bottom-s MinHash sketches (query side).

Equivalent of CommonFunc::sketchSequence (reference:
src/map/include/commonFunc.hpp:217-323). Functional semantics (derived from
the heap/map event flow and proven equivalent in tests):

* kept hashes = the s smallest DISTINCT canonical hashes of the fragment's
  valid, non-palindromic k-mers (once a hash is evicted from the bottom-s it
  can never re-enter, and a hash that will end among the s smallest is never
  rejected on first sight);
* per kept hash: wpos = first occurrence, wpos_end = last occurrence,
  strand = sign of the summed per-occurrence votes (FWD > 0, AMBIG == 0,
  REV < 0);
* output sorted ascending by hash (the reference fills the vector back to
  front popping the max-heap).

Also computes the k-mer complexity estimate used for filtering
(mappingCore.hpp:72-74).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .kmers import canonical_kmer_hashes

U64_MAX_F = float(0xFFFFFFFFFFFFFFFF)


@dataclass
class FragmentSketch:
    hashes: np.ndarray      # uint64, ascending
    wpos: np.ndarray        # int64 first-occurrence positions
    wpos_end: np.ndarray    # int64 last-occurrence positions
    strand: np.ndarray      # int8: 1 FWD / 0 AMBIG / -1 REV
    kmer_complexity: float
    sketch_size: int        # == len(hashes)


def sketch_fragment(seq, k: int, sketch_size: int) -> FragmentSketch:
    """Bottom-s sketch of one fragment (host NumPy path)."""
    seq_len = len(seq)
    pos, canon, vote = canonical_kmer_hashes(seq, k)
    n_kmers = max(0, seq_len - k + 1)
    if len(canon) == 0:
        return FragmentSketch(
            hashes=np.empty(0, dtype=np.uint64),
            wpos=np.empty(0, dtype=np.int64),
            wpos_end=np.empty(0, dtype=np.int64),
            strand=np.empty(0, dtype=np.int8),
            kmer_complexity=0.0,
            sketch_size=0,
        )

    uniq, inv = np.unique(canon, return_inverse=True)
    kept = min(sketch_size, len(uniq))
    in_sketch = inv < kept
    inv_k = inv[in_sketch]
    pos_k = pos[in_sketch]
    vote_k = vote[in_sketch].astype(np.int64)

    # first/last occurrence + vote sums per kept hash
    order = np.argsort(inv_k, kind="stable")
    inv_sorted = inv_k[order]
    pos_sorted = pos_k[order]
    starts = np.searchsorted(inv_sorted, np.arange(kept))
    ends = np.searchsorted(inv_sorted, np.arange(kept), side="right")
    wpos = pos_sorted[starts]
    wpos_end = pos_sorted[ends - 1]
    votes = np.bincount(inv_k, weights=vote_k, minlength=kept)[:kept]
    strand = np.sign(votes).astype(np.int8)

    max_hash_01 = float(uniq[kept - 1]) / U64_MAX_F
    complexity = (kept / max_hash_01) / (n_kmers * 2) if max_hash_01 > 0 else 0.0

    return FragmentSketch(
        hashes=uniq[:kept],
        wpos=wpos,
        wpos_end=wpos_end,
        strand=strand,
        kmer_complexity=float(complexity),
        sketch_size=kept,
    )
