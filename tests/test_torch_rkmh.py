"""The port's copy of the rkmh mini-MinHash gate (align/rkmh.py) against
the JAX package's: sketches and distances on seeded sequences with
ambiguous bases, on sequences no longer than k, and with an empty sketch.
Tolerance: exact (the same uint64 sketches, the same float distances).
"""

import numpy as np
import pytest

from wfmash_tpu.align import rkmh as ref
from wfmash_tpu_torch.align import rkmh as port

from util import mutate, random_dna


def _seqs():
    rng = np.random.default_rng(17)
    out = []
    for n in (2000, 700, 120):
        s = bytearray(random_dna(rng, n))
        for pos in rng.integers(0, n, n // 50):
            s[int(pos)] = ord("N") if rng.random() < 0.7 else ord("n")
        out.append(bytes(s))
    out.append(b"N" * 40 + random_dna(rng, 30))   # mostly ambiguous
    out += [random_dna(rng, 16), random_dna(rng, 17), b"ACG", b""]
    return out


@pytest.mark.parametrize("k,size", [(16, 64), (8, 1000), (21, 200)])
def test_hash_sequence_equals_reference(k, size):
    seqs = _seqs()
    for s in seqs:
        got = port.hash_sequence(s, k, size)
        want = ref.hash_sequence(s, k, size)
        assert got.dtype == want.dtype == np.uint64
        np.testing.assert_array_equal(got, want)
    # sequences of at most k bases have no k-mer the gate hashes
    assert all(len(port.hash_sequence(s, k, size)) == 0 for s in seqs
               if len(s) <= k)


def test_compare_equals_reference():
    rng = np.random.default_rng(19)
    a = random_dna(rng, 3000)
    k, size = 16, 128
    sk = [port.hash_sequence(x, k, size) for x in
          (a, mutate(rng, a, 0.01), mutate(rng, a, 0.08),
           random_dna(rng, 3000), b"N" * 100, b"ACGT")]
    assert len(sk[-1]) == 0 and len(sk[-2]) == 0      # empty sketches
    for x in sk:
        for y in sk:
            assert port.compare(x, y, k) == ref.compare(x, y, k)
    assert port.compare(sk[0], sk[0], k) == 0.0
    assert port.compare(sk[0], sk[3], k) == 1.0
    assert port.compare(sk[0], sk[-1], k) == 1.0
    assert 0.0 < port.compare(sk[0], sk[1], k) < port.compare(sk[0], sk[2], k)
