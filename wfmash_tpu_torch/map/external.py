"""External PAF seed processing (-K): bypass MinHash, reuse the filter
pipeline.

Equivalent of ExternalSeeder::processExternalSeeds (reference:
src/map/include/externalSeeder.hpp:46-512): seeds from a PAF file are
converted to mapping records, grouped by query, pushed through the SAME
merge/filter/scaffold pipeline as MinHash mappings, and written as PAF
(with the original cg:Z CIGAR re-attached to mappings whose coordinates
survived unchanged).
"""

from __future__ import annotations

import sys

import numpy as np

from ..io.paf import parse_paf_line, write_mapping_rows
from ..io.seqids import SequenceIdManager
from ..params import MapParams
from .chain import scale_identity
from .engine import Mapper
from .l1l2 import FLAG_REV, MAPPING_DTYPE


def log(msg):
    print(msg, file=sys.stderr)


def load_paf_seeds(seed_file: str, idm: SequenceIdManager):
    """Returns {query_name: (query_len, [row dicts])}."""
    grouped: dict[str, tuple[int, list]] = {}
    n = 0
    with open(seed_file) as fh:
        for line in fh:
            if not line.strip():
                continue
            try:
                rec = parse_paf_line(line)
            except (ValueError, IndexError):
                continue
            if rec["target_name"] not in idm.name_to_id:
                continue
            entry = grouped.setdefault(rec["query_name"], (rec["query_len"], []))
            entry[1].append(rec)
            n += 1
    log(f"[wfmash::externalSeeder] Loaded {n} seeds")
    return grouped


def seed_to_mapping(rec, idm: SequenceIdManager):
    m = np.zeros((), dtype=MAPPING_DTYPE)
    m["ref_seq_id"] = idm.get_sequence_id(rec["target_name"])
    m["ref_start"] = rec["target_start"]
    m["query_start"] = rec["query_start"]
    m["block_length"] = max(
        rec["target_end"] - rec["target_start"],
        rec["query_end"] - rec["query_start"],
    )
    m["n_merged"] = 1
    m["conserved_sketches"] = rec["matches"]
    identity = rec["matches"] / max(1, rec["block_length"])
    if "id" in rec["tags"]:
        try:
            identity = float(rec["tags"]["id"][1])
        except ValueError:
            pass
    m["nuc_identity"] = scale_identity(min(1.0, identity))
    m["flags"] = FLAG_REV if rec["strand"] == "-" else 0
    m["kmer_complexity"] = 100
    return m


def write_annotated_rows(out, query_name, query_len, mappings, chain_info,
                         idm, merge_mappings, cigars: dict,
                         anchor_keys: set) -> None:
    """PAF rows with the external-seeder extras (externalSeeder.hpp:
    150-243): the seed's original cg:Z re-attached to mappings whose
    exact coordinates survive, and st:Z:scaffold|rescued when scaffold
    filtering ran (anchors vs rescued-by-distance)."""
    import numpy as np

    from ..io.paf import FLAG_REV, fake_mapq, fmt_float

    if len(mappings) == 0:
        return
    order = np.argsort(mappings["query_start"], kind="stable")
    for idx in order:
        e = mappings[idx]
        nuc_id = float(np.float32(e["nuc_identity"]) / np.float32(10000.0))
        kc = float(np.float32(e["kmer_complexity"]) / np.float32(100.0))
        q_start = int(e["query_start"])
        r_start = int(e["ref_start"])
        rid = int(e["ref_seq_id"])
        rev = bool(int(e["flags"]) & FLAG_REV)
        cols = [
            query_name,
            str(query_len),
            str(q_start),
            str(q_start + int(e["block_length"])),
            "-" if rev else "+",
            idm.get_sequence_name(rid),
            str(idm.get_sequence_length(rid)),
            str(r_start),
            str(r_start + int(e["block_length"])),
            str(int(e["conserved_sketches"])),
            str(int(e["block_length"])),
            fmt_float(fake_mapq(nuc_id)),
            "id:f:" + fmt_float(nuc_id),
            "kc:f:" + fmt_float(kc),
        ]
        if merge_mappings:
            c = chain_info[idx]
            cols.append(
                f"ch:Z:{int(c['chain_id'])}.{int(c['chain_pos'])}."
                f"{int(c['chain_len'])}")
        cg = cigars.get((q_start, r_start, rid, rev))
        if cg:
            cols.append("cg:Z:" + cg)
        if anchor_keys:
            st = "scaffold" if (q_start, r_start, rid, rev) in anchor_keys \
                else "rescued"
            cols.append("st:Z:" + st)
        out.write("\t".join(cols) + "\n")


def process_external_seeds(params: MapParams, out) -> None:
    idm = SequenceIdManager(
        params.query_sequences,
        params.ref_sequences,
        params.query_prefix,
        [params.target_prefix] if params.target_prefix else [],
        params.prefix_delim if params.skip_prefix else "",
        params.query_list,
        params.target_list,
    )
    mapper = Mapper(params, idm)
    grouped = load_paf_seeds(params.external_seeds_file, idm)
    log(f"[wfmash::externalSeeder] Processing {len(grouped)} query sequences")

    for query_name, (query_len, recs) in grouped.items():
        mappings = np.array(
            [seed_to_mapping(r, idm) for r in recs], dtype=MAPPING_DTYPE
        )
        try:
            qid = idm.get_sequence_id(query_name)
            if query_len == 0:
                query_len = idm.get_sequence_length(qid)
        except KeyError:
            qid = 0
        anchor_keys: set = set()
        filtered, chain_info = mapper.filter_subset_mappings(
            mappings, qid, query_len, scaffold_anchor_keys=anchor_keys
        )
        # original CIGARs keyed by exact mapping coordinates
        # (externalSeeder.hpp:176-186)
        cigars = {}
        for r in recs:
            cg = r["tags"].get("cg")
            if cg:
                cigars[(r["query_start"], r["target_start"],
                        idm.get_sequence_id(r["target_name"]),
                        r["strand"] == "-")] = cg[1]
        write_annotated_rows(
            out, query_name, query_len, filtered, chain_info, idm,
            params.merge_mappings, cigars, anchor_keys,
        )
    log("[wfmash::externalSeeder] External seed processing complete")
