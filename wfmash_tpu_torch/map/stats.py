"""Mapping statistics: mash distance <-> Jaccard, confidence bounds,
minimum-hit estimation, and the hypergeometric stage-1 cutoff table.

Equivalent of skch::Stat (reference: src/map/include/map_stats.hpp:56-269)
and skch::Map::setProbs (computeMap.hpp:234-293). The reference computes
j2md/md2j in C `float` (with the pow() in double); identities feed keep/drop
decisions, so we reproduce the float32 rounding exactly. GSL's
binomial/hypergeometric tails map to scipy.stats (same underlying
definitions).
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
from scipy.special import betainc
from scipy.stats import binom, hypergeom


def j2md(j: float, k: int) -> float:
    """Jaccard -> mash distance, float32 semantics (map_stats.hpp:56-66)."""
    j = np.float32(j)
    if j == 0:
        return 1.0
    if j == 1:
        return 0.0
    # 2*j/(1+j) evaluated in float32, pow/1- in double, result cast to float32
    ratio = np.float32(np.float32(2) * j) / np.float32(np.float32(1) + j)
    return float(np.float32(1.0 - math.pow(float(ratio), 1.0 / k)))


def md2j(d: float, k: int) -> float:
    """Mash distance -> Jaccard, float32 semantics (map_stats.hpp:74-79)."""
    sim = float(np.float32(np.float32(1) - np.float32(d)))
    p = math.pow(sim, k)
    return float(np.float32(p / (2.0 - p)))


@lru_cache(maxsize=100000)
def md_lower_bound(d: float, s: int, k: int, ci: float) -> float:
    """Lower bound on distance d within confidence interval ci
    (map_stats.hpp:92-124, GSL branch)."""
    # C++: float q2 = (1.0 - ci)/2  — double arithmetic, float32 result
    q2 = float(np.float32((1.0 - float(np.float32(ci))) / 2.0))
    j = md2j(d, k)
    x = max(int(math.ceil(s * j)), 1)
    while x <= s:
        # P(X >= x) for X ~ Binom(s, j) — regularized incomplete beta;
        # identical to binom.sf(x-1, s, j) but ~30x faster per call
        cdf_complement = float(betainc(x, s - x + 1, j))
        if cdf_complement < q2:
            x -= 1
            break
        x += 1
    jaccard = float(np.float32(np.float32(x) / np.float32(s)))
    return j2md(jaccard, k)


def estimate_minimum_hits(s: int, k: int, perc_identity: float) -> int:
    """(map_stats.hpp:133-144)"""
    mash_dist = float(np.float32(1.0 - float(np.float32(perc_identity))))
    jaccard = md2j(mash_dist, k)
    return int(math.ceil(1.0 * s * jaccard))


def estimate_minimum_hits_relaxed(
    s: int, k: int, perc_identity: float, confidence_interval: float
) -> int:
    """(map_stats.hpp:155-180)"""
    start = estimate_minimum_hits(s, k, perc_identity)
    relaxed = start
    for i in range(start, -1, -1):
        jaccard = float(np.float32(1.0 * i / s))
        d = j2md(jaccard, k)
        d_lower = md_lower_bound(d, s, k, confidence_interval)
        id_upper = float(np.float32(1.0 - float(np.float32(d_lower))))
        if np.float32(id_upper) >= np.float32(perc_identity):
            relaxed = i
        else:
            break
    return relaxed


def compute_sketch_cutoffs(
    sketch_size: int,
    kmer_size: int,
    ani_diff: float,
    ani_diff_conf: float,
    ss_table_max: float = 1000.0,
) -> np.ndarray:
    """Stage-1 hypergeometric cutoff table (computeMap.hpp:234-293).

    cutoffs[cmax] = minimum required intersection size for an L1 candidate
    when the best candidate's intersection is cmax.
    """
    ss = int(min(sketch_size, ss_table_max))
    cutoffs = np.ones(ss + 1, dtype=np.int32)
    min_p = 1.0 - ani_diff_conf

    # pdf(y; population 2*ss - ci with ss successes, ci draws)
    y = np.arange(ss + 1)

    pdf_cache = {}
    cdf_cache = {}

    def pdf_row(ci):
        if ci not in pdf_cache:
            pdf_cache[ci] = hypergeom.pmf(y, 2 * ss - ci, ss, ci)
        return pdf_cache[ci]

    def cdf_row(ci):
        # cdf row = cumsum of the pmf row (matches scipy's scalar cdf to
        # ~1e-15; a scalar hypergeom.cdf costs ~160 us and the binary
        # search makes thousands of them)
        if ci not in cdf_cache:
            cdf_cache[ci] = np.cumsum(pdf_row(ci))
        return cdf_cache[ci]

    def dist_diff(cmax: int, ci: int) -> bool:
        pr_above = 0.0
        pm = pdf_row(cmax)
        cr = cdf_row(ci)
        for ymax in range(cmax + 1):
            pymax = pm[ymax]
            if ani_diff == 0:
                yi_cutoff = float(ymax)
            else:
                yi_cutoff = math.floor(
                    md2j(j2md(ymax / ss, kmer_size) + ani_diff, kmer_size) * ss
                )
            ki = int(yi_cutoff) - 1
            if ki >= 0:
                pi_acc = float(cr[min(ki, ss)])
            else:
                pi_acc = 0.0
            pr_above += pymax * (1.0 - pi_acc)
            if pr_above > min_p:
                return True
        return pr_above > min_p

    for cmax in range(1, ss + 1):
        # binary search for the first ci in [0, ss) with dist_diff True
        lo, hi = 0, ss  # search over ss_range[0:ss]
        while lo < hi:
            mid = (lo + hi) // 2
            if dist_diff(cmax, mid):
                hi = mid
            else:
                lo = mid + 1
        ci = lo
        cutoffs[cmax] = max(ci, 1)
    return cutoffs
