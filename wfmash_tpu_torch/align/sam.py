"""SAM output for alignments.

Port of write_alignment_sam + write_tag_and_md_string (reference:
src/common/wflign/src/wflign_patch.cpp:2480-2609): FLAG 16 for reverse
mappings, 1-based POS after indel trimming, '='/'X' extended CIGAR as
produced by the aligner, NM = mismatches + inserted_bp + deleted_bp,
gi/bi/md tags, optional MD tag derived from the target bases.
"""

from __future__ import annotations

from . import cigar as C
from .biwfa import AlignmentJob, float2phred, fmt_double
from ..sketch.kmers import reverse_complement

import numpy as np


def md_string(ops, target: bytes, t_start: int) -> str:
    """MD tag body: matched-run lengths, mismatched ref bases, ^-prefixed
    deleted ref runs (insertions don't appear)."""
    out = []
    match_run = 0
    t = t_start
    for n, op in ops:
        if op in "=M":
            match_run += n
            t += n
        elif op == "X":
            for i in range(n):
                out.append(str(match_run))
                match_run = 0
                out.append(chr(target[t + i]))
            t += n
        elif op == "D":
            out.append(str(match_run))
            match_run = 0
            out.append("^" + target[t : t + n].decode("ascii"))
            t += n
        # 'I' consumes no target and no MD entry
    out.append(str(match_run))
    return "".join(out)


def write_sam_row(out, job: AlignmentJob, ops,
                  min_identity: float, min_alignment_length: int,
                  min_block_identity: float,
                  no_seq: bool = False, emit_md: bool = False) -> bool:
    if not ops:
        return False
    trimmed, new_ref_start, new_query_start = C.trim_indels(
        ops, job.target_offset, job.query_offset
    )
    (matches, mismatches, ins, ins_bp, dels, del_bp,
     ref_aligned, q_aligned) = C.stats(trimmed)
    denom_gc = matches + mismatches + ins + dels
    denom_bi = matches + mismatches + ins_bp + del_bp
    if denom_gc == 0 or denom_bi == 0:
        return False
    gci = matches / denom_gc
    bi = matches / denom_bi
    if not (gci >= min_identity and q_aligned >= min_alignment_length
            and bi >= min_block_identity):
        return False

    flag = "16" if job.query_is_rev else "0"
    mapq = int(np.floor(float2phred(1.0 - bi) + 0.5))
    cols = [
        job.query_name,
        flag,
        job.target_name,
        str(new_ref_start + 1),
        str(mapq),
        C.format_ops(trimmed),
        "*", "0", "0",
    ]
    if no_seq:
        cols.append("*")
    else:
        rel = new_query_start - job.query_offset
        seq = job.query[rel : rel + q_aligned]
        cols.append(seq.decode("ascii"))
    cols.append("*")
    cols.append(f"NM:i:{mismatches + ins_bp + del_bp}")
    cols.append("gi:f:" + fmt_double(gci))
    cols.append("bi:f:" + fmt_double(bi))
    cols.append("md:f:" + fmt_double(job.mashmap_estimated_identity))
    if job.chain_length > 0:
        cols.append(f"ci:i:{job.chain_id}")
        cols.append(f"ch:Z:{job.chain_id}.{job.chain_length}.{job.chain_pos}")
    if emit_md:
        rel_t = new_ref_start - job.target_offset
        cols.append("MD:Z:" + md_string(trimmed, job.target, rel_t))
    out.write("\t".join(cols) + "\n")
    return True
