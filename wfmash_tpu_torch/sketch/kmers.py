"""Canonical k-mer hashing over DNA byte arrays (host / NumPy path).

Reproduces the reference's per-k-mer pipeline bit-for-bit
(src/map/include/commonFunc.hpp):

* `makeUpperCaseAndValidDNA` (:132-142): uppercase, then any byte that is
  not A/C/G/T becomes 'N';
* `reverseComplement` (:74-83): A<->T, C<->G, all other (normalized) bytes
  map to themselves (N -> N);
* hashes: MurmurHash3_x64_128 low-64, seed 42, of the k-mer bytes; the
  backward hash is the hash of the reverse-complemented k-mer;
* a k-mer is *valid* iff its window contains no 'N' (the ambig_kmer_count
  logic in sketchSequence/addMinmers reduces to exactly this);
* canonical hash = min(fwd, bwd); positions where fwd == bwd (palindromic
  hash) are skipped; strand vote = +1 if fwd < bwd else -1.
"""

from __future__ import annotations

import numpy as np

from .murmur import murmur3_x64_128_low64

# -- byte tables -------------------------------------------------------------

_UPPER = np.arange(256, dtype=np.uint8)
_lower = (np.arange(256) >= ord("a")) & (np.arange(256) <= ord("z"))
_UPPER[_lower] = (np.arange(256)[_lower] - 32).astype(np.uint8)

_NORMALIZE = np.full(256, ord("N"), dtype=np.uint8)
for _b in b"ACGT":
    _NORMALIZE[_b] = _b
_NORMALIZE = _NORMALIZE[_UPPER]  # uppercase first, then validity

_COMPLEMENT = np.arange(256, dtype=np.uint8)
for _x, _y in zip(b"ACGT", b"TGCA"):
    _COMPLEMENT[_x] = _y


def normalize(seq: np.ndarray | bytes) -> np.ndarray:
    """Uppercase + non-ACGT -> 'N'. Returns uint8 array."""
    arr = np.frombuffer(bytes(seq), dtype=np.uint8) if isinstance(
        seq, (bytes, bytearray)
    ) else np.asarray(seq, dtype=np.uint8)
    return _NORMALIZE[arr]


def reverse_complement(seq: np.ndarray) -> np.ndarray:
    return _COMPLEMENT[np.asarray(seq, dtype=np.uint8)][::-1]


def kmer_window_matrix(seq: np.ndarray, k: int) -> np.ndarray:
    """(N, k) view-like matrix of all k-mers of a 1-D uint8 sequence."""
    n = len(seq) - k + 1
    if n <= 0:
        return np.empty((0, k), dtype=np.uint8)
    return np.lib.stride_tricks.sliding_window_view(seq, k)


def valid_kmer_mask(seq_norm: np.ndarray, k: int) -> np.ndarray:
    """True where the k-mer window [i, i+k) contains no 'N'."""
    n = len(seq_norm) - k + 1
    if n <= 0:
        return np.zeros(0, dtype=bool)
    is_n = (seq_norm == ord("N")).astype(np.int32)
    cs = np.concatenate([[0], np.cumsum(is_n)])
    return (cs[k:] - cs[:-k]) == 0


def canonical_kmer_hashes(seq, k: int):
    """Compute canonical k-mer hashes for one sequence.

    Returns (pos, hash, vote):
      pos   int64 positions of kept k-mers (valid, non-palindromic)
      hash  uint64 canonical hashes (min of fwd/revcomp hash)
      vote  int8 strand votes (+1 fwd < bwd, -1 otherwise)
    """
    s = normalize(seq)
    n = len(s) - k + 1
    if n <= 0:
        return (
            np.empty(0, dtype=np.int64),
            np.empty(0, dtype=np.uint64),
            np.empty(0, dtype=np.int8),
        )
    # native batch hasher (bit-identical; tests cross-check both paths)
    from ..native import canonical_hashes_native

    nat = canonical_hashes_native(s.tobytes(), k)
    if nat is not None:
        return nat
    fwd = murmur3_x64_128_low64(kmer_window_matrix(s, k))
    rc = reverse_complement(s)
    # revcomp of k-mer at i == k-mer of rc at (len - i - k); hashing rc's
    # windows and reversing the order aligns them (commonFunc.hpp:263-266).
    bwd = murmur3_x64_128_low64(kmer_window_matrix(rc, k))[::-1]
    keep = valid_kmer_mask(s, k) & (fwd != bwd)
    pos = np.nonzero(keep)[0].astype(np.int64)
    canon = np.minimum(fwd[keep], bwd[keep])
    vote = np.where(fwd[keep] < bwd[keep], 1, -1).astype(np.int8)
    return pos, canon, vote
