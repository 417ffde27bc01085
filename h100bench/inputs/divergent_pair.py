"""Two assemblies of related species, as t.fa (the target `anc`) and q.fa
(the query `der`), each plain FASTA with its .fai.

From the seed, with NumPy alone and without a loop over bases:
- the ancestor: `bp` uniform random bases;
- the local divergence: one value d per WINDOW bases of the ancestor,
  drawn from a gamma distribution of shape 2 and mean 0.12, clipped to
  [0.02, 0.30];
- small events where d of a window's bases are changed, as
  scripts/divergence_ladder.py's `mutate` counts it: events at
  d / (0.9 + 0.1 x 5.5) a base, of which 90% are SNPs and 10% indels of
  1-10 bp (uniform), half insertions of random bases before the base and
  half deletions from it;
- long indels: one every LONG_EVERY bases on average, placed uniformly,
  of log-uniform length in [100, 10000] bp, half insertions of random
  bases and half deletions;
- the three structural events of assembly_pair.make_pair, at the same
  positions and of the same shares of `bp`: an inversion of bp / 200 at
  bp / 3, a deletion of bp / 100 at 2 bp / 3 and a tandem duplication of
  3 bp / 1000 at bp / 5 (500 kb, 1 Mb and 300 kb at 100 Mb, as there).
"""

from __future__ import annotations

import os

import numpy as np

from benchlib.inputs import ACGT, write_fasta

WINDOW = 10_000
SHAPE, MEAN, LO, HI = 2.0, 0.12, 0.02, 0.30
SNP_SHARE = 0.9
MEAN_INDEL = 5.5          # 1-10 bp, uniform
LONG_EVERY = 50_000
LONG_MIN, LONG_MAX = 100, 10_000


def window_divergence(rng, bp: int) -> np.ndarray:
    """d of each WINDOW-base window of the ancestor."""
    n = -(-bp // WINDOW)
    return np.clip(rng.gamma(SHAPE, MEAN / SHAPE, n), LO, HI)


def events(rng, bp: int, d: np.ndarray) -> dict:
    """The small events and long indels on an ancestor of bp bases whose
    windows have divergence d: positions of the ancestor and lengths."""
    rate = np.repeat((d / (SNP_SHARE + (1 - SNP_SHARE) * MEAN_INDEL))
                     .astype(np.float32), WINDOW)[:bp]
    at = np.flatnonzero(rng.random(bp, dtype=np.float32) < rate)
    kind = rng.random(len(at))
    small_ins = at[(kind >= SNP_SHARE) & (kind < (1 + SNP_SHARE) / 2)]
    small_del = at[kind >= (1 + SNP_SHARE) / 2]
    n_long = rng.poisson(bp / LONG_EVERY)
    long_at = np.sort(rng.integers(0, bp, n_long))
    long_len = np.exp(rng.uniform(np.log(LONG_MIN), np.log(LONG_MAX),
                                  n_long)).astype(np.int64)
    long_ins = rng.random(n_long) < 0.5
    return {"snp": at[kind < SNP_SHARE],
            "small_ins": (small_ins, rng.integers(1, 11, len(small_ins))),
            "small_del": (small_del, rng.integers(1, 11, len(small_del))),
            "long": (long_at, long_len, long_ins)}


def _edit(anc, rng, ev: dict) -> np.ndarray:
    """anc with ev's SNPs, its insertions of random bases before their
    positions and its deletions from theirs (overlapping deletions
    delete once)."""
    long_at, long_len, long_ins = ev["long"]
    ins_at = np.concatenate([ev["small_ins"][0], long_at[long_ins]])
    ins_len = np.concatenate([ev["small_ins"][1], long_len[long_ins]])
    order = np.argsort(ins_at, kind="stable")
    ins_at, ins_len = ins_at[order], ins_len[order]
    del_at = np.concatenate([ev["small_del"][0], long_at[~long_ins]])
    del_len = np.concatenate([ev["small_del"][1], long_len[~long_ins]])
    der = anc.copy()
    snp = ev["snp"]
    der[snp] = (der[snp] + rng.integers(1, 4, len(snp), dtype=np.uint8)) % 4
    n = len(der)
    cover = np.zeros(n + 1, np.int32)
    np.add.at(cover, del_at, 1)
    np.add.at(cover, np.minimum(del_at + del_len, n), -1)
    keep = np.cumsum(cover[:n]) == 0
    at = np.repeat(ins_at, ins_len)
    out = np.insert(der, at, rng.integers(0, 4, len(at), dtype=np.uint8))
    return out[np.insert(keep, at, True)]


def make_pair(bp: int, seed: int):
    """(ancestor, derived) as uint8 codes 0-3, the windows' d and the
    events (`events`)."""
    rng = np.random.default_rng(seed)
    anc = rng.integers(0, 4, bp, dtype=np.uint8)
    d = window_divergence(rng, bp)
    ev = events(rng, bp, d)
    der = _edit(anc, rng, ev)
    # structural events (positions and lengths relative to bp)
    inv_a, inv_l = bp // 3, bp // 200
    der[inv_a:inv_a + inv_l] = 3 - der[inv_a:inv_a + inv_l][::-1]
    del_a, del_l = 2 * bp // 3, bp // 100
    der = np.concatenate([der[:del_a], der[del_a + del_l:]])
    dup_a, dup_l = bp // 5, 3 * bp // 1000
    der = np.concatenate([der[:dup_a + dup_l],
                          der[dup_a:dup_a + dup_l],
                          der[dup_a + dup_l:]])
    return anc, der, d, ev


def generate(d, seed, bp):
    anc, der, _, _ = make_pair(bp, seed)
    write_fasta(os.path.join(d, "t.fa"), {"anc": ACGT[anc].tobytes()})
    write_fasta(os.path.join(d, "q.fa"), {"der": ACGT[der].tobytes()})
    return ["t.fa", "t.fa.fai", "q.fa", "q.fa.fai"]
