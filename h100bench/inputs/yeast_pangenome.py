"""An 8-genome PanSN pangenome of yeast's shape, as pan.fa with its .fai.

A frozen copy of scripts/torch_golden.py's `yeast_pangenome`, `_snps`,
`_small_indels` and `YEAST_KB`, so that a later change to the script
cannot move the yardstick.
"""

from __future__ import annotations

import os

import numpy as np

from benchlib.inputs import ACGT, write_fasta


def _snps(rng, codes, rate):
    """codes with a share `rate` of positions changed to another base."""
    out = codes.copy()
    pos = rng.random(len(out)) < rate
    out[pos] = (out[pos] + rng.integers(1, 4, int(pos.sum()))) % 4
    return out


def _small_indels(rng, codes, rate, longest):
    """codes with indels of 1..longest bp at a share `rate` of positions,
    half deletions and half insertions of random bases."""
    sites = np.sort(rng.choice(len(codes) - longest, int(len(codes) * rate),
                               replace=False))
    lens = rng.integers(1, longest + 1, len(sites))
    ins = rng.random(len(sites)) < 0.5
    parts, at = [], 0
    for s, n, i in zip(sites.tolist(), lens.tolist(), ins.tolist()):
        if s < at:
            continue
        parts.append(codes[at:s])
        if i:
            parts.append(rng.integers(0, 4, n).astype(np.uint8))
            at = s
        else:
            at = s + n
    parts.append(codes[at:])
    return np.concatenate(parts)


YEAST_KB = (230, 813, 317, 1532, 577, 270, 1091, 563, 440, 746, 667, 1078,
            924, 784, 1091, 948)


def generate(d, seed, scale=1.0):
    """The ancestor has YEAST_KB's chromosomes (12.07 Mb), over which
    copies of a 6 kb element (30 of them) and of a 330 bp element (300),
    each diverged 1-3% and on either strand, are written in place.
    Haplotype h (`g{h}#1#chr{c}`) has 0.3% + 0.1% h of substitutions and
    0.05% of 1-8 bp indels of both directions; h = 2 and 5 carry a
    reciprocal translocation between two chromosomes, h = 3 and 6 a 40 kb
    inversion, h = 4 a 20 kb deletion. `scale` multiplies every length but
    the elements' (chromosomes, events) and the numbers of copies (at
    least two of each)."""
    rng = np.random.default_rng(seed)
    anc = [rng.integers(0, 4, round(kb * 1000 * scale)).astype(np.uint8)
           for kb in YEAST_KB]
    for unit, copies in ((6000, 30), (330, 300)):
        elem = rng.integers(0, 4, unit).astype(np.uint8)
        for c in rng.integers(0, len(anc), max(2, round(copies * scale))):
            copy = _snps(rng, elem, rng.uniform(0.01, 0.03))
            if rng.random() < 0.5:
                copy = 3 - copy[::-1]
            at = int(rng.integers(0, len(anc[c]) - unit))
            anc[c][at:at + unit] = copy
    seqs = {}
    for h in range(8):
        chroms = [_small_indels(rng, _snps(rng, a, 0.003 + 0.001 * h),
                                0.0005, 8) for a in anc]
        if h in (2, 5):
            a, b = (int(x) for x in rng.choice(len(chroms), 2,
                                               replace=False))
            ia = int(rng.integers(len(chroms[a]) // 4,
                                  3 * len(chroms[a]) // 4))
            ib = int(rng.integers(len(chroms[b]) // 4,
                                  3 * len(chroms[b]) // 4))
            chroms[a], chroms[b] = (
                np.concatenate([chroms[a][:ia], chroms[b][ib:]]),
                np.concatenate([chroms[b][:ib], chroms[a][ia:]]))
        if h in (3, 4, 6):
            n = round((40_000 if h != 4 else 20_000) * scale)
            c = int(rng.integers(0, len(chroms)))
            at = int(rng.integers(0, len(chroms[c]) - n))
            s = chroms[c]
            if h == 4:
                chroms[c] = np.concatenate([s[:at], s[at + n:]])
            else:
                chroms[c] = np.concatenate(
                    [s[:at], 3 - s[at:at + n][::-1], s[at + n:]])
        for c, s in enumerate(chroms):
            seqs[f"g{h}#1#chr{c + 1}"] = ACGT[s].tobytes()
    write_fasta(os.path.join(d, "pan.fa"), seqs)
    return ["pan.fa", "pan.fa.fai"]
