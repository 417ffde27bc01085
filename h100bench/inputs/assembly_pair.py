"""Two assemblies of one genome, as t.fa (the target `anc`) and q.fa (the
query `der`), each plain FASTA with its .fai.

`make_pair` is a frozen copy of scripts/scale_demo.py's, so that a later
change to the script cannot move the yardstick (the script writes BGZF;
the pair is written as plain FASTA here).
"""

from __future__ import annotations

import os

import numpy as np

from benchlib.inputs import ACGT, write_fasta


def make_pair(bp: int, seed: int):
    rng = np.random.default_rng(seed)
    anc = rng.integers(0, 4, bp, dtype=np.int8).astype(np.uint8)
    der = anc.copy()
    # 2% SNPs
    snp = rng.random(bp) < 0.02
    der[snp] = (der[snp] + rng.integers(1, 4, int(snp.sum()),
                                        dtype=np.int8).astype(np.uint8)) % 4
    # 0.2% small indels: delete 1-5 bp at random sites (vectorized via mask)
    delmask = np.ones(bp, bool)
    sites = rng.choice(bp - 10, bp // 1000, replace=False)
    for w in range(5):
        delmask[sites[rng.random(len(sites)) < 0.5] + w] = False
    der = der[delmask[:len(der)]]
    # structural events (positions relative to bp)
    inv_a, inv_l = bp // 3, 500_000
    der[inv_a:inv_a + inv_l] = 3 - der[inv_a:inv_a + inv_l][::-1]
    del_a, del_l = 2 * bp // 3, 1_000_000
    der = np.concatenate([der[:del_a], der[del_a + del_l:]])
    dup_a, dup_l = bp // 5, 300_000
    der = np.concatenate([der[:dup_a + dup_l],
                          der[dup_a:dup_a + dup_l],
                          der[dup_a + dup_l:]])
    return anc, der


def generate(d, seed, bp):
    anc, der = make_pair(bp, seed)
    write_fasta(os.path.join(d, "t.fa"), {"anc": ACGT[anc].tobytes()})
    write_fasta(os.path.join(d, "q.fa"), {"der": ACGT[der].tobytes()})
    return ["t.fa", "t.fa.fai", "q.fa", "q.fa.fai"]
