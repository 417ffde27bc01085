"""Post-merge mapping filters: weak, length-mismatch, sparsification,
scaffold synteny, and boundary sanity.

Equivalents of (reference: src/map/include/mappingFilter.hpp):
* filterWeakMappings        (:154-179)
* filterFalseHighIdentity   (:184-198)
* sparsifyMappings          (:203-215) with the base_types.hpp:237-247
  struct hash (std::hash<integral> == identity in libstdc++)
* filterByScaffolds         (:831-1016) — KD-tree replaced by a batched
  brute-force nearest-anchor distance (anchors are few; vectorizes cleanly)
* MappingOutput::mappingBoundarySanityCheck (mappingOutput.hpp:31-69)
"""

from __future__ import annotations

import math

import numpy as np

from ..params import MapParams, FILTER_MAP, FILTER_ONETOONE
from .chain import merge_mappings
from .l1l2 import FLAG_REV
from .sweep import filter_by_group

U64 = 0xFFFFFFFFFFFFFFFF


def filter_weak_mappings(
    m: np.ndarray, min_count: int, params: MapParams, seq_len_of, query_len: int
) -> np.ndarray:
    """Drop short/thin merged mappings; thresholds halved at sequence
    boundaries (mappingFilter.hpp:154-179). Returns keep mask."""
    if len(m) == 0:
        return np.ones(0, dtype=bool)
    q_start = m["query_start"].astype(np.int64)
    q_end = q_start + m["block_length"]
    r_start = m["ref_start"].astype(np.int64)
    r_end = r_start + m["block_length"]
    ref_lens = np.array([seq_len_of(int(s)) for s in m["ref_seq_id"]], dtype=np.int64)

    w = params.window_length
    is_boundary = (
        (q_start < w)
        | (q_end > query_len - w)
        | (r_start < w)
        | (r_end > ref_lens - w)
    )
    bl = m["block_length"].astype(np.int64)
    nm = m["n_merged"].astype(np.int64)
    drop = np.where(
        is_boundary,
        (bl < params.block_length // 2) | (nm < min_count // 2),
        (bl < params.block_length) | (nm < min_count),
    )
    return ~drop


def filter_false_high_identity(m: np.ndarray, params: MapParams) -> np.ndarray:
    """Drop mappings whose query/ref length mismatch contradicts the
    estimated identity (mappingFilter.hpp:184-198). Returns keep mask.

    With the compact struct, q_l == r_l == blockLength, so delta == 0 and
    len_id_bound == 1 — the filter keeps everything unless blockLength is 0
    (0/0 -> nan). Implemented faithfully anyway for future width-bearing
    records."""
    if len(m) == 0:
        return np.ones(0, dtype=bool)
    q_l = m["block_length"].astype(np.float64)
    r_l = m["block_length"].astype(np.float64)
    delta = np.abs(r_l - q_l)
    with np.errstate(invalid="ignore", divide="ignore"):
        len_id_bound = 1.0 - delta / ((q_l + r_l) / 2.0)
    cutoff = min(0.7, float(params.percentage_identity) ** 3)
    keep = ~(len_id_bound < cutoff)
    return keep


def _hash_combine(s: int, v: int) -> int:
    return (s ^ (v + 0x9E3779B9 + ((s << 6) & U64) + (s >> 2))) & U64


def mapping_struct_hash(row) -> int:
    """base_types.hpp:237-247 hash() over the compact record."""
    s = 0
    for v in (
        int(row["ref_seq_id"]),
        int(row["ref_start"]),
        int(row["query_start"]),
        int(row["block_length"]),
        int(row["nuc_identity"]),
        int(row["conserved_sketches"]),
        int(row["flags"]),
    ):
        s = _hash_combine(s, v)
    return s


def sparsify_mappings(m: np.ndarray, params: MapParams) -> np.ndarray:
    """Keep mappings whose struct hash <= threshold (mappingFilter.hpp:203-215)."""
    if params.sparsity_hash_threshold >= U64 or len(m) == 0:
        return np.ones(len(m), dtype=bool)
    hashes = np.array([mapping_struct_hash(r) for r in m], dtype=np.uint64)
    return ~(hashes > np.uint64(params.sparsity_hash_threshold))


def filter_by_scaffolds(
    m: np.ndarray,
    params: MapParams,
    group_of,
    seq_len_of,
    scaffold_writer=None,   # callable(chains_array) for --scaffold-out
    anchor_keys_out: set | None = None,  # filled with anchor identity keys
) -> np.ndarray:
    """Scaffold synteny filter (mappingFilter.hpp:831-1016). Returns the
    surviving subset of ``m`` (order preserved). When ``anchor_keys_out``
    is given it collects (q_start, r_start, ref_seq_id, rev) keys of the
    anchor mappings — the external seeder tags kept mappings
    st:Z:scaffold/rescued from this set (externalSeeder.hpp:188-201)."""
    if params.scaffold_gap <= 0 or len(m) == 0:
        return m

    original = m.copy()

    # merge into scaffold chains at the scaffold gap
    chains = merge_mappings(m.copy(), params.scaffold_gap, params)

    # length filter
    chains = chains[chains["block_length"] >= params.scaffold_min_length]

    # plane sweep with scaffold overlap threshold
    if len(chains) and params.filter_mode in (FILTER_MAP, FILTER_ONETOONE):
        import dataclasses

        scaffold_params = dataclasses.replace(
            params, overlap_threshold=params.scaffold_overlap_threshold
        )
        chains = filter_by_group(
            chains,
            params.num_mappings_for_scaffold - 1,
            False,
            group_of,
            seq_len_of,
            scaffold_params,
        )

    if scaffold_writer is not None and len(chains):
        scaffold_writer(chains)

    if len(chains) == 0:
        return m[:0]

    # anchors: original mappings fully inside some chain's bounds
    anchors = []
    c_qs = chains["query_start"].astype(np.int64)
    c_qe = c_qs + chains["block_length"]
    c_rs = chains["ref_start"].astype(np.int64)
    c_re = c_rs + chains["block_length"]
    c_rev = (chains["flags"] & FLAG_REV) != 0
    for row in original:
        qs = int(row["query_start"])
        qe = qs + int(row["block_length"])
        rs = int(row["ref_start"])
        re_ = rs + int(row["block_length"])
        rev = bool(row["flags"] & FLAG_REV)
        ok = (
            (chains["ref_seq_id"] == row["ref_seq_id"])
            & (c_rev == rev)
            & (c_qs <= qs)
            & (qe <= c_qe)
            & (c_rs <= rs)
            & (re_ <= c_re)
        )
        if np.any(ok):
            anchors.append(row)
            if anchor_keys_out is not None:
                anchor_keys_out.add((qs, rs, int(row["ref_seq_id"]), rev))
    if not anchors:
        return m[:0]
    anchors = np.array(anchors, dtype=m.dtype)

    # nearest-anchor Euclidean distance on (q_mid, r_mid), float32 midpoints
    ax = anchors["query_start"].astype(np.float32) + anchors["block_length"].astype(np.float32) * np.float32(0.5)
    ay = anchors["ref_start"].astype(np.float32) + anchors["block_length"].astype(np.float32) * np.float32(0.5)
    mx = m["query_start"].astype(np.float32) + m["block_length"].astype(np.float32) * np.float32(0.5)
    my = m["ref_start"].astype(np.float32) + m["block_length"].astype(np.float32) * np.float32(0.5)
    # (n, a) distance matrix in blocks to bound memory
    keep = np.zeros(len(m), dtype=bool)
    max_dist = np.float32(params.scaffold_max_deviation)
    block = max(1, 8_000_000 // max(1, len(anchors)))
    for i in range(0, len(m), block):
        dx = mx[i : i + block, None] - ax[None, :]
        dy = my[i : i + block, None] - ay[None, :]
        d = np.sqrt(dx * dx + dy * dy)
        keep[i : i + block] = d.min(axis=1) <= max_dist
    return m[keep]


def boundary_sanity_check(m: np.ndarray, query_len: int, seq_len_of) -> None:
    """Clamp coordinates in place (mappingOutput.hpp:31-69)."""
    for row in m:
        ref_len = seq_len_of(int(row["ref_seq_id"]))
        if row["ref_start"] >= ref_len:
            row["ref_start"] = ref_len - 1
        if int(row["ref_start"]) + int(row["block_length"]) >= ref_len:
            row["block_length"] = ref_len - 1 - int(row["ref_start"])
        if row["query_start"] >= query_len:
            row["query_start"] = query_len
        if int(row["query_start"]) + int(row["block_length"]) >= query_len:
            row["block_length"] = query_len - int(row["query_start"])
