"""Union-find chaining + merge of split-fragment mappings.

Equivalent of MappingFilterUtils::mergeMappingsInRangeWithChains
(reference: src/map/include/mappingFilter.hpp:381-571) with dset64's
union-by-rank root selection (common/dset64.hpp:88-118 — higher rank wins;
on rank ties the SMALLER root id wins and its rank increments), which the
downstream chain ordering observes.

Mappings are numpy MAPPING_DTYPE arrays; chain info is a parallel
(chain_id, chain_pos, chain_len) array.
"""

from __future__ import annotations

import numpy as np

from ..params import MapParams, STRAND_FWD
from .l1l2 import MAPPING_DTYPE, FLAG_REV

CHAIN_DTYPE = np.dtype(
    [("chain_id", np.uint32), ("chain_pos", np.uint16), ("chain_len", np.uint16)]
)


class _DisjointSets:
    """dset64-compatible union-find (rank rules affect root identities)."""

    def __init__(self, n: int):
        self.parent = list(range(n))
        self.rank = [0] * n

    def find(self, x: int) -> int:
        while self.parent[x] != x:
            self.parent[x] = self.parent[self.parent[x]]
            x = self.parent[x]
        return x

    def unite(self, a: int, b: int) -> int:
        a, b = self.find(a), self.find(b)
        if a == b:
            return a
        r1, r2 = self.rank[a], self.rank[b]
        if r1 > r2 or (r1 == r2 and a < b):
            a, b = b, a
            r1, r2 = r2, r1
        self.parent[a] = b
        if r1 == r2:
            self.rank[b] += 1
        return b


def strand_of(m) -> int:
    return -1 if (int(m["flags"]) & FLAG_REV) else STRAND_FWD


def scale_identity(identity: float) -> int:
    """setNucIdentity: roundf(float(identity) * 10000.0f) (base_types.hpp:206)."""
    x = float(np.float32(np.float32(identity) * np.float32(10000.0)))
    return int(np.floor(x + 0.5))


def scale_complexity(complexity: float) -> int:
    """setKmerComplexity: roundf(float(c) * 100.0f) (base_types.hpp:210).

    Complexity can exceed 1.0 for tiny fragments (few k-mers, small
    max-hash denominator); the reference's static_cast<uint8_t> then
    wraps modulo 256 on x86, so reproduce that instead of overflowing."""
    x = float(np.float32(np.float32(complexity) * np.float32(100.0)))
    return int(np.floor(x + 0.5)) & 0xFF


def query_end(m) -> int:
    return int(m["query_start"]) + int(m["block_length"])


def ref_end(m) -> int:
    return int(m["ref_start"]) + int(m["block_length"])


def merge_mappings_with_chains(
    mappings: np.ndarray,
    max_dist: int,
    params: MapParams,
) -> tuple[np.ndarray, np.ndarray]:
    """Returns (merged_mappings, chain_info)."""
    n = len(mappings)
    if not params.split or n < 2:
        chains = np.zeros(n, dtype=CHAIN_DTYPE)
        chains["chain_id"] = np.arange(n)
        chains["chain_pos"] = 1
        chains["chain_len"] = 1
        return mappings.copy(), chains

    m = mappings
    strand = np.where((m["flags"] & FLAG_REV) != 0, -1, 1)
    q_start = m["query_start"].astype(np.int64)
    q_end = q_start + m["block_length"]
    r_start = m["ref_start"].astype(np.int64)
    r_end = r_start + m["block_length"]

    # sort by (refSeqId, strand, queryStart, refStart)
    p = np.lexsort((r_start, q_start, strand, m["ref_seq_id"]))
    m = m[p]
    strand, q_start, q_end = strand[p], q_start[p], q_end[p]
    r_start, r_end = r_start[p], r_end[p]
    split_id = p.astype(np.int64).copy()  # original index = stable chain id

    from ..native import chain_roots_native

    nat = chain_roots_native(
        m["ref_seq_id"], strand, q_start, q_end, r_start, r_end,
        split_id, max_dist, params.window_length // 5)
    if nat is not None:
        roots = nat
        return _emit_merged(m, strand, q_start, q_end, r_start, r_end,
                            roots, params)

    ds = _DisjointSets(n)
    INF = float("inf")
    pair_score = [INF] * n
    pair_id = [0] * n

    # geometric best-pair chaining within (refSeqId, strand) runs
    g0 = 0
    while g0 < n:
        g1 = g0 + 1
        while (
            g1 < n
            and m["ref_seq_id"][g1] == m["ref_seq_id"][g0]
            and strand[g1] == strand[g0]
        ):
            g1 += 1
        for i in range(g0, g1):
            if pair_score[i] != INF:
                ds.unite(int(split_id[i]), pair_id[i])
            best_score = INF
            best_j = g1
            for j in range(i + 1, g1):
                if q_start[j] > q_end[i] + max_dist:
                    break
                q_dist = max(0, int(q_start[j] - q_end[i]))
                if strand[i] == STRAND_FWD:
                    r_dist = int(r_start[j] - r_end[i])
                else:
                    r_dist = int(r_start[i] - r_end[j])
                if (
                    q_dist <= max_dist
                    and r_dist >= -(params.window_length // 5)
                    and r_dist <= max_dist
                ):
                    dist_sq = float(q_dist) * q_dist + float(r_dist) * r_dist
                    if dist_sq < best_score and dist_sq < pair_score[j]:
                        best_score = dist_sq
                        best_j = j
            if best_j != g1:
                pair_score[best_j] = best_score
                pair_id[best_j] = int(split_id[i])
        g0 = g1

    for i in range(n):
        if pair_score[i] != INF:
            ds.unite(int(split_id[i]), pair_id[i])
    roots = np.array([ds.find(int(s)) for s in split_id], dtype=np.int64)
    return _emit_merged(m, strand, q_start, q_end, r_start, r_end,
                        roots, params)


def _emit_merged(m, strand, q_start, q_end, r_start, r_end, roots,
                 params):
    """Merge chained runs into output mappings (shared by the native
    chain_roots fast path and the Python spec)."""
    n = len(m)
    # sort by (root, queryStart, refStart)
    p2 = np.lexsort((r_start, q_start, roots))
    m = m[p2]
    strand = strand[p2]
    q_start, q_end = q_start[p2], q_end[p2]
    r_start, r_end = r_start[p2], r_end[p2]
    roots = roots[p2]

    out = []
    chains = []
    chain_id_map: dict[int, int] = {}
    next_chain_id = 0

    i = 0
    while i < n:
        j = i
        while j + 1 < n and roots[j + 1] == roots[i]:
            j += 1

        root = int(roots[i])
        if root not in chain_id_map:
            chain_id_map[root] = next_chain_id
            next_chain_id += 1
        chain_id = chain_id_map[root]
        chain_len = j - i + 1
        chain_pos = 1

        frag_start = i
        while frag_start <= j:
            frag_end = frag_start
            while frag_end + 1 <= j:
                query_span = q_end[frag_end + 1] - q_start[frag_start]
                ref_span = r_end[frag_end + 1] - r_start[frag_start]
                if max(query_span, ref_span) >= params.max_mapping_length:
                    break
                frag_end += 1

            merged = m[frag_start].copy()
            qs = int(q_start[frag_start])
            qe = int(q_end[frag_end])
            r_start_fwd = int(r_start[frag_start])
            r_end_fwd = int(r_end[frag_end])
            total_id = 0.0
            total_comp = 0.0
            total_conserved = 0
            is_rev = strand[frag_start] == -1
            for k in range(frag_start, frag_end + 1):
                # per-element float32 unscale, float64 accumulation (C++:
                # double += float getNucIdentity())
                total_id += float(np.float32(m["nuc_identity"][k]) / np.float32(1e4))
                total_comp += float(np.float32(m["kmer_complexity"][k]) / np.float32(100))
                total_conserved += int(m["conserved_sketches"][k])
                if is_rev:
                    r_start_fwd = min(r_start_fwd, int(r_start[k]))
                    r_end_fwd = max(r_end_fwd, int(r_end[k]))

            n_merged = frag_end - frag_start + 1
            merged["query_start"] = qs
            merged["ref_start"] = (
                r_start_fwd if not is_rev else int(r_start[frag_end])
            )
            merged["block_length"] = max(qe - qs, r_end_fwd - r_start_fwd)
            merged["n_merged"] = n_merged
            merged["nuc_identity"] = scale_identity(total_id / n_merged)
            merged["kmer_complexity"] = scale_complexity(total_comp / n_merged)
            merged["conserved_sketches"] = total_conserved
            out.append(merged)
            chains.append((chain_id, chain_pos, chain_len))
            chain_pos += 1
            frag_start = frag_end + 1
        i = j + 1

    merged_arr = np.array(out, dtype=MAPPING_DTYPE) if out else np.empty(0, MAPPING_DTYPE)
    chain_arr = np.array(chains, dtype=CHAIN_DTYPE) if chains else np.empty(0, CHAIN_DTYPE)
    return merged_arr, chain_arr


def merge_mappings(mappings: np.ndarray, max_dist: int, params: MapParams) -> np.ndarray:
    """Legacy interface used by the scaffold filter (mergeMappingsInRange,
    mappingFilter.hpp:577-736). Semantics identical except no chain info; a
    not-split / size<2 input is returned unchanged."""
    if not params.split or len(mappings) < 2:
        return mappings.copy()
    merged, _ = merge_mappings_with_chains(mappings, max_dist, params)
    return merged
