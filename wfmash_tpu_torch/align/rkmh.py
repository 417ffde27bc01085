"""rkmh mini-MinHash: sketch + mash-distance gate for segment pairs.

Port of the reference's rkmh (src/common/wflign/src/rkmh.cpp:45-140),
upstream used by the wflambda guide alignment to gate segment pairs by
approximate divergence before spending a WFA on them. Faithful quirks:

* only ``len - k`` k-mer positions are hashed (the last k-mer is
  dropped, rkmh.cpp:66);
* forward-strand hashes only (no canonical min(fwd, rc)), low 64 bits
  of MurmurHash3_x64_128 with seed 42;
* k-mers containing non-ACGT bases hash to ``2**64 - 1`` and are
  stripped after the bottom-``sketch_size`` truncation (so low-
  complexity/ambiguous windows shrink the sketch, rkmh.cpp:85-96);
* ``compare`` merges the two sorted sketches counting commons; the
  distance is ``-log(2c / (d + c)) / k`` clamped to [0, 1], with
  distance 1 when nothing is shared (rkmh.cpp:99-140).
"""

from __future__ import annotations

import math

import numpy as np

from ..sketch.murmur import murmur3_x64_128_low64

U64_MAX = np.uint64(0xFFFFFFFFFFFFFFFF)
_ACGT = np.zeros(256, dtype=bool)
for b in b"ACGT":
    _ACGT[b] = True


def hash_sequence(seq: bytes, k: int, sketch_size: int) -> np.ndarray:
    """Bottom-``sketch_size`` sketch of the forward k-mer hashes."""
    n = len(seq) - k  # reference drops the final k-mer (rkmh.cpp:66)
    if n <= 0:
        return np.empty(0, dtype=np.uint64)
    arr = np.frombuffer(seq, dtype=np.uint8)
    ok = _ACGT[arr]
    # k-mer i is canonical iff all bases in [i, i+k) are ACGT
    run = np.cumsum(ok.astype(np.int64))
    window_ok = (run[k - 1:] - np.concatenate([[0], run[:-k]])) == k
    window_ok = window_ok[:n]
    hashes = np.full(n, U64_MAX, dtype=np.uint64)
    idx = np.nonzero(window_ok)[0]
    if len(idx):
        from ..sketch.kmers import kmer_window_matrix

        windows = kmer_window_matrix(arr, k)[:n][idx]
        hashes[idx] = murmur3_x64_128_low64(windows)
    hashes.sort()
    hashes = hashes[:sketch_size]
    return hashes[hashes != U64_MAX]


def compare(alpha: np.ndarray, beta: np.ndarray, k: int) -> float:
    """Merge-count mash distance between two sorted sketches."""
    i = j = 0
    common = 0
    denom = 0
    la, lb = len(alpha), len(beta)
    while i < la and j < lb:
        if alpha[i] == beta[j]:
            i += 1
            j += 1
            common += 1
        elif alpha[i] > beta[j]:
            j += 1
        else:
            i += 1
        denom += 1
    denom += (la - i) + (lb - j)
    if common == 0:
        return 1.0
    if common == denom:
        return 0.0
    distance = -math.log(2.0 * common / (denom + common)) / k
    return min(distance, 1.0)
