"""Group-wise ANI auto-identity estimation (default -p ani50-2).

Equivalent of Stat::estimate_identity_for_groups (reference:
src/map/include/map_stats.hpp:325-822):

* per sequence: bottom-4096 MULTISET (StreamingMinHash keeps duplicates)
  of canonical k=21-mer hashes (palindromic-hash k-mers skipped, N-window
  k-mers skipped including an initial in-k-mer scan);
* per PanSN group (query side and target side separately): bottom-4096
  multiset of the union of its sequences' sketches;
* pairwise group Jaccard = multiset-intersection / min(|q|,|t|) ->
  ANI = 1 - j2md(jaccard, 21);
* the chosen identity = the ani_percentile-th percentile (index
  percentile*n/100 of the ascending ANI list) + ani_adjustment/100,
  clamped to [0,1]. Self-group comparisons are skipped. The reference's
  "self mode" ordered-pair dedup compares vector ADDRESSES and never
  triggers (map_stats.hpp:707), so both (A,B) and (B,A) are counted.

Returns None when no sketches/overlaps exist (caller keeps the default
identity 0.70, map_stats.hpp:662-666, 770-773).
"""

from __future__ import annotations

import sys

import numpy as np

from ..io.fasta import FastaReader
from ..io.seqids import SequenceIdManager
from ..params import MapParams
from ..sketch.kmers import canonical_kmer_hashes

ESTIMATION_K = 21
ESTIMATION_SKETCH_SIZE = 4096
# k-mers hashed a block at a time: a whole sequence's hash arrays take
# ~17 bytes a base (1.7 GB for a 100 Mb chromosome)
SKETCH_BLOCK = 1 << 22


def log(msg):
    print(msg, file=sys.stderr)


def _bottom(h: np.ndarray, size: int) -> np.ndarray:
    """The bottom-`size` multiset of h, ascending."""
    if len(h) > size:
        h = np.partition(h, size)[:size]
    return np.sort(h)


def _sequence_sketch(seq: bytes, k: int, size: int) -> np.ndarray:
    """Bottom-`size` multiset of seq's canonical k-mer hashes, ascending,
    taken SKETCH_BLOCK k-mers at a time (blocks overlap by k - 1 bases, so
    each k-mer is in one block; a bottom multiset of bottom multisets is
    the whole one's)."""
    best = np.empty(0, dtype=np.uint64)
    for i0 in range(0, max(len(seq) - k + 1, 1), SKETCH_BLOCK):
        _, canon, _ = canonical_kmer_hashes(seq[i0:i0 + SKETCH_BLOCK + k - 1],
                                            k)
        best = _bottom(np.concatenate([best, canon]), size)
    return best


def _multiset_bottom(parts: list[np.ndarray], size: int) -> np.ndarray:
    if not parts:
        return np.empty(0, dtype=np.uint64)
    allh = np.sort(np.concatenate(parts))
    return allh[:size]


def _multiset_intersection(a: np.ndarray, b: np.ndarray) -> int:
    ua, ca = np.unique(a, return_counts=True)
    ub, cb = np.unique(b, return_counts=True)
    common, ia, ib = np.intersect1d(ua, ub, return_indices=True)
    return int(np.minimum(ca[ia], cb[ib]).sum())


def estimate_identity_for_groups(params: MapParams) -> float | None:
    from .stats import j2md

    log(
        f"[wfmash::auto-identity] Starting identity estimation with "
        f"k={ESTIMATION_K}, sketch_size={ESTIMATION_SKETCH_SIZE}"
    )
    idm = SequenceIdManager(
        params.query_sequences,
        params.ref_sequences,
        params.query_prefix,
        [params.target_prefix] if params.target_prefix else [],
        params.prefix_delim if params.skip_prefix else "",
        params.query_list,
        params.target_list,
    )

    readers = {}
    for f in set(params.query_sequences + params.ref_sequences):
        readers[f] = FastaReader(f)

    query_names = set(idm.get_query_sequence_names())
    target_names = set(idm.get_target_sequence_names())

    query_group_parts: dict[int, list[np.ndarray]] = {}
    target_group_parts: dict[int, list[np.ndarray]] = {}

    seen = set()
    for f, reader in readers.items():
        for name in reader.names:
            if name in seen or name not in idm.name_to_id:
                continue
            seen.add(name)
            is_q = name in query_names
            is_t = name in target_names
            if not (is_q or is_t):
                continue
            seq = reader.fetch(name)
            sk = _sequence_sketch(seq, ESTIMATION_K, ESTIMATION_SKETCH_SIZE)
            gid = idm.get_ref_group(idm.get_sequence_id(name))
            if is_q:
                query_group_parts.setdefault(gid, []).append(sk)
            if is_t:
                target_group_parts.setdefault(gid, []).append(sk)

    if not query_group_parts or not target_group_parts:
        log("[wfmash::auto-identity] Warning: no sequences found; using default")
        return None

    q_sketches = {
        g: _multiset_bottom(parts, ESTIMATION_SKETCH_SIZE)
        for g, parts in query_group_parts.items()
    }
    t_sketches = {
        g: _multiset_bottom(parts, ESTIMATION_SKETCH_SIZE)
        for g, parts in target_group_parts.items()
    }

    anis = []
    for qg, qs in sorted(q_sketches.items()):
        for tg, ts in sorted(t_sketches.items()):
            if qg == tg:
                continue
            if len(qs) == 0 or len(ts) == 0:
                continue
            inter = _multiset_intersection(qs, ts)
            if inter == 0:
                continue
            jaccard = inter / min(len(qs), len(ts))
            ani = 1.0 - j2md(jaccard, ESTIMATION_K)
            anis.append(ani)
            log(
                f"[wfmash::auto-identity] Group {qg} vs {tg}: "
                f"{inter}/{min(len(qs), len(ts))} sketches overlap, "
                f"Jaccard={jaccard:.4f}, ANI={ani * 100:.2f}%"
            )

    if not anis:
        log(
            "[wfmash::auto-identity] Warning: no k-mer overlap between groups; "
            "using default identity"
        )
        return None

    anis.sort()
    idx = min((params.ani_percentile * len(anis)) // 100, len(anis) - 1)
    selected = anis[idx]
    adjusted = min(1.0, max(0.0, selected + params.ani_adjustment / 100.0))
    log(
        f"[wfmash::auto-identity] Selected ani{params.ani_percentile} = "
        f"{selected * 100:.2f}%, adjusted to {adjusted * 100:.2f}%"
    )
    return adjusted
