"""PAF reading/writing for mapping records.

Writer equivalent of MappingOutput::reportReadMappings (reference:
src/map/include/mappingOutput.hpp:74-138): rows sorted by query start;
pseudo-MAPQ = round(-10*log10(1 - identity)) (255 at identity 1); float
tags printed with C++ ostream default 6-significant-digit formatting.
"""

from __future__ import annotations

import math

import numpy as np

from ..map.l1l2 import FLAG_REV, MAPPING_DTYPE
from ..map.chain import CHAIN_DTYPE


def fmt_float(x: float) -> str:
    """C++ `ostream << float` default formatting (6 significant digits)."""
    s = f"{float(x):.6g}"
    return s


def fake_mapq(nuc_identity_f32: float) -> float:
    if nuc_identity_f32 == 1.0:
        return 255.0
    return float(np.float32(round(-10.0 * math.log10(1.0 - nuc_identity_f32))))


def write_mapping_rows(
    out,
    query_name: str,
    query_len: int,
    mappings: np.ndarray,
    chain_info: np.ndarray,
    idm,
    merge_mappings: bool,
) -> None:
    if len(mappings) == 0:
        return
    order = np.argsort(mappings["query_start"], kind="stable")
    for idx in order:
        e = mappings[idx]
        nuc_id = float(np.float32(e["nuc_identity"]) / np.float32(10000.0))
        kc = float(np.float32(e["kmer_complexity"]) / np.float32(100.0))
        q_start = int(e["query_start"])
        q_end = q_start + int(e["block_length"])
        r_start = int(e["ref_start"])
        r_end = r_start + int(e["block_length"])
        ref_name = idm.get_sequence_name(int(e["ref_seq_id"]))
        ref_len = idm.get_sequence_length(int(e["ref_seq_id"]))
        strand = "-" if (int(e["flags"]) & FLAG_REV) else "+"
        cols = [
            query_name,
            str(query_len),
            str(q_start),
            str(q_end),
            strand,
            ref_name,
            str(ref_len),
            str(r_start),
            str(r_end),
            str(int(e["conserved_sketches"])),
            str(int(e["block_length"])),
            fmt_float(fake_mapq(nuc_id)),
            "id:f:" + fmt_float(nuc_id),
            "kc:f:" + fmt_float(kc),
        ]
        if not merge_mappings:
            cols.append("jc:f:0")
        else:
            ch = chain_info[idx]
            cols.append(
                f"ch:Z:{int(ch['chain_id'])}.{int(ch['chain_pos'])}.{int(ch['chain_len'])}"
            )
        out.write("\t".join(cols) + "\n")


def parse_paf_line(line: str) -> dict:
    """Parse one PAF row into a dict (used by the alignment phase and the
    external-seeds path)."""
    parts = line.rstrip("\n").split("\t")
    rec = {
        "query_name": parts[0],
        "query_len": int(parts[1]),
        "query_start": int(parts[2]),
        "query_end": int(parts[3]),
        "strand": parts[4],
        "target_name": parts[5],
        "target_len": int(parts[6]),
        "target_start": int(parts[7]),
        "target_end": int(parts[8]),
        "matches": int(parts[9]),
        "block_length": int(parts[10]),
        "mapq": parts[11],
        "tags": {},
    }
    for tag in parts[12:]:
        if len(tag) >= 5 and tag[2] == ":" and tag[4] == ":":
            rec["tags"][tag[:2]] = (tag[3], tag[5:])
    return rec
