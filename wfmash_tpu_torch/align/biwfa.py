"""The default alignment path: end-to-end WFA + boundary patching + swizzle.

Equivalent of wflign::wavefront::do_biwfa_alignment (reference:
src/common/wflign/src/wflign.cpp:108-483):

1. end-to-end two-piece-affine WFA of target x query (the whole mapped
   block, query already strand-adjusted);
2. unless chain patching is disabled, erode the CIGAR head/tail until at
   least 11 consecutive matches are seen and >= 128 bp of both sequences
   are exposed (at most 4096), re-align the exposed ends ENDS-FREE (free
   gap at the outer boundary), erode <=3bp matches between opposing indels,
   and splice the patched ends back;
3. swizzle: swap leading "N= Dlen D" / trailing "Dlen D N=" patterns when
   sequences agree;
4. emit a PAF row (gi/bi/md/cg tags, leading/trailing indels trimmed) or a
   SAM record.

The `aligner` argument abstracts the WFA engine: any callable implementing
align(query, target, ends_free=None) -> ops. The host reference engine and
the batched JAX/TPU engine are interchangeable here.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from . import cigar as C
from .wfa_np import EndsFree, Penalties
from .wfa_vec import wfa_align

MIN_PATCH_LENGTH = 128
MAX_ERODE_LENGTH = 4096
MIN_CONSECUTIVE_MATCHES = 11


def ops_score(ops, p: Penalties) -> int:
    """2-piece-affine score of a CIGAR (cheapest flavor per gap run) —
    an upper bound on the optimal score of any problem this alignment
    is a valid candidate for."""
    s = 0
    for n, op in ops:
        if op == "X":
            s += p.mismatch * n
        elif op in "ID":
            s += min(p.gap_opening1 + p.gap_extension1 * n,
                     p.gap_opening2 + p.gap_extension2 * n)
    return s


@dataclass
class AlignmentJob:
    """One mapping record to align (sequences already extracted/normalized;
    query strand-adjusted: reverse-complemented when query_is_rev)."""

    query_name: str
    query: bytes              # the aligned region, strand-adjusted
    query_total_length: int
    query_offset: int         # offset of region start on the + strand
    query_length: int
    query_is_rev: bool
    target_name: str
    target: bytes             # target region (no padding inside)
    target_total_length: int
    target_offset: int
    target_length: int
    mashmap_estimated_identity: float
    chain_id: int = -1
    chain_length: int = 1
    chain_pos: int = 1


class HostWfaEngine:
    """Reference (host) WFA engine."""

    def __init__(self, penalties: Penalties):
        self.penalties = penalties

    def align(self, query: bytes, target: bytes, ends_free: EndsFree | None = None):
        _, ops = wfa_align(query, target, self.penalties, ends_free)
        return ops

    def align_batch(self, jobs, bounds=None):
        """jobs: list of (query, target, ends_free|None) -> list of ops.
        bounds: optional per-job score upper bounds (engines that can
        exploit them prune with them; this one ignores them).

        The native WFA releases the GIL for the whole call (ctypes) and
        its history arena is thread-local, so on multi-core hosts the
        batch fans out over a thread pool (order preserved by map)."""
        n_threads = int(getattr(self, "threads", 1))
        if n_threads > 1 and len(jobs) >= 4:
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(n_threads) as ex:
                return list(ex.map(
                    lambda j: self.align(j[0], j[1], j[2]), jobs))
        return [self.align(q, t, ef) for q, t, ef in jobs]


def patch_boundaries(ops, query: bytes, target: bytes, engine) -> list:
    """Head/tail erode + ends-free re-alignment (wflign.cpp:240-418)."""
    # -- head
    q_er, t_er, erode_ops = C.erode_head(
        ops, MIN_PATCH_LENGTH, MAX_ERODE_LENGTH, MIN_CONSECUTIVE_MATCHES
    )
    if q_er > 3 or t_er > 3:
        head_ops = engine.align(
            query[:q_er],
            target[:t_er],
            EndsFree(target_begin=t_er, query_begin=q_er),
        )
        if head_ops is not None:
            head_ops = C.erode_short_matches(head_ops, 3, is_head=True)
            ops = C.merge_adjacent(head_ops, ops[erode_ops:])

    # -- tail
    q_er, t_er, erode_start = C.erode_tail(
        ops, MIN_PATCH_LENGTH, MAX_ERODE_LENGTH, MIN_CONSECUTIVE_MATCHES
    )
    if q_er > 3 or t_er > 3:
        tail_ops = engine.align(
            query[len(query) - q_er :],
            target[len(target) - t_er :],
            EndsFree(target_end=t_er, query_end=q_er),
        )
        if tail_ops is not None:
            tail_ops = C.erode_short_matches(tail_ops, 3, is_head=False)
            ops = C.merge_adjacent(ops[:erode_start], tail_ops)
    return ops


def align_record(job: AlignmentJob, engine, disable_chain_patching=False):
    """Run the biWFA path for one record; returns final ops or None."""
    ops = engine.align(job.query, job.target)
    return finish_record(job, ops, engine, disable_chain_patching)


def finish_record(job: AlignmentJob, ops, engine, disable_chain_patching=False):
    """Patch + swizzle a record whose main alignment is already computed."""
    if ops is None:
        return None
    if not disable_chain_patching:
        ops = patch_boundaries(ops, job.query, job.target, engine)
    ops = C.try_swap_start_pattern(ops, job.query, job.target, 0, 0)
    ops = C.try_swap_end_pattern(ops, job.query, job.target, 0, 0)
    return ops


def finish_record_host(job, ops, penalties, disable_chain_patching=False):
    """Fork-pool worker for the patch/swizzle phase: host engine only
    (boundary patches always run on host regardless of main engine)."""
    return finish_record(job, ops, HostWfaEngine(penalties),
                         disable_chain_patching)


def patch_boundaries_batched(items: list, engine, trace=None) -> list:
    """items: [(ops, query, target)] -> list of patched ops.

    Replicates patch_boundaries record-for-record (head patch first,
    tail erode computed on the head-merged CIGAR, wflign.cpp:240-418)
    but batches the ends-free re-alignments across ALL records into two
    engine.align_batch calls, so they run on the device segment kernel
    instead of one host WFA per record.

    trace: optional list; appends (item_idx, kind, q_erode, t_erode,
    applied) per attempted patch (--path-patching-tsv)."""
    out = [ops for ops, _, _ in items]
    pens = getattr(engine, "penalties", None)
    head_jobs, head_meta, head_bounds = [], [], []
    for i, (ops, q, t) in enumerate(items):
        q_er, t_er, erode_ops = C.erode_head(
            ops, MIN_PATCH_LENGTH, MAX_ERODE_LENGTH, MIN_CONSECUTIVE_MATCHES
        )
        if q_er > 3 or t_er > 3:
            head_jobs.append((q[:q_er], t[:t_er],
                              EndsFree(target_begin=t_er, query_begin=q_er)))
            head_meta.append((i, erode_ops, q_er, t_er))
            # the eroded head is itself a valid ends-free candidate
            # (start at the corner — or, dropping a leading gap run, on
            # the free edge it spans — and end at the erode point), so
            # its score upper-bounds the patch optimum; engines prune
            # their wavefronts with it
            if pens:
                cand = ops[:erode_ops]
                if cand and cand[0][1] in "ID":
                    cand = cand[1:]     # leading run lies in a free span
                head_bounds.append(ops_score(cand, pens))
            else:
                head_bounds.append(None)
    if head_jobs:
        got = engine.align_batch(head_jobs, bounds=head_bounds)
        for (i, erode_ops, q_er, t_er), hops in zip(head_meta, got):
            if hops is not None:
                hops = C.erode_short_matches(hops, 3, is_head=True)
                out[i] = C.merge_adjacent(hops, out[i][erode_ops:])
            if trace is not None:
                trace.append((i, "head", q_er, t_er, hops is not None))
    tail_jobs, tail_meta, tail_bounds = [], [], []
    for i, (_, q, t) in enumerate(items):
        q_er, t_er, erode_start = C.erode_tail(
            out[i], MIN_PATCH_LENGTH, MAX_ERODE_LENGTH,
            MIN_CONSECUTIVE_MATCHES
        )
        if q_er > 3 or t_er > 3:
            tail_jobs.append((q[len(q) - q_er:], t[len(t) - t_er:],
                              EndsFree(target_end=t_er, query_end=q_er)))
            tail_meta.append((i, erode_start, q_er, t_er))
            if pens:
                cand = out[i][erode_start:]
                if cand and cand[-1][1] in "ID":
                    cand = cand[:-1]    # trailing run ends on a free edge
                tail_bounds.append(ops_score(cand, pens))
            else:
                tail_bounds.append(None)
    if tail_jobs:
        got = engine.align_batch(tail_jobs, bounds=tail_bounds)
        for (i, erode_start, q_er, t_er), tops in zip(tail_meta, got):
            if tops is not None:
                tops = C.erode_short_matches(tops, 3, is_head=False)
                out[i] = C.merge_adjacent(out[i][:erode_start], tops)
            if trace is not None:
                trace.append((i, "tail", q_er, t_er, tops is not None))
    return out


def align_records_batched(jobs: list, engine, disable_chain_patching=False,
                          trace=None):
    """Phase-structured batch: all main end-to-end alignments go through
    the (device) engine as one batch, then all boundary patches as two
    more batches, then swizzles per record. Returns a list of ops (None
    for failed records)."""
    mains = engine.align_batch([(j.query, j.target, None) for j in jobs])
    return finish_records_batched(jobs, mains, engine,
                                  disable_chain_patching, trace=trace)


def finish_records_batched(jobs: list, mains: list, engine,
                           disable_chain_patching=False, trace=None):
    """Batched patch + swizzle for records whose mains are computed.
    trace: optional list receiving (job_idx, kind, q_erode, t_erode,
    applied) patch rows (--path-patching-tsv)."""
    import time as _time

    from ..utils import perf

    keep = [i for i, ops in enumerate(mains) if ops is not None]
    out: list = [None] * len(jobs)
    _t0 = _time.monotonic()
    if not disable_chain_patching:
        ptrace = [] if trace is not None else None
        patched = patch_boundaries_batched(
            [(mains[i], jobs[i].query, jobs[i].target) for i in keep],
            engine, trace=ptrace)
        if trace is not None:
            trace.extend((keep[pi], kind, qe, te, ap)
                         for pi, kind, qe, te, ap in ptrace)
    else:
        patched = [mains[i] for i in keep]
    perf.add("align.patch_s", _time.monotonic() - _t0)
    for i, ops in zip(keep, patched):
        job = jobs[i]
        ops = C.try_swap_start_pattern(ops, job.query, job.target, 0, 0)
        ops = C.try_swap_end_pattern(ops, job.query, job.target, 0, 0)
        out[i] = ops
    return out


def float2phred(prob: float) -> float:
    """wflign_patch.cpp:2726-2734."""
    if prob == 1:
        return 255.0
    p = -10.0 * math.log10(prob) if prob > 0 else 255.0
    return 255.0 if (p < 0 or p > 255) else p


def fmt_double(x: float) -> str:
    """C++ `ostream << double` default formatting (6 significant digits)."""
    return f"{float(x):.6g}"


def write_inversion_row(out, job: AlignmentJob, inv: dict) -> bool:
    """Extra PAF row for a detected inversion patch (reference:
    wflign_patch.cpp:2361-2392 emits kept rev-comp patch alignments as
    separate rows tagged pt:Z:true iv:Z:true).

    inv: dict(qa, qb, ta, tb, ops) — block-relative region on the
    strand-adjusted query; ops aligns revcomp(block_query[qa:qb]) to
    target[ta:tb], so the row's strand is the OPPOSITE of the record's.
    """
    ops = inv["ops"]
    if not ops:
        return False
    (matches, mismatches, ins, ins_bp, dels, del_bp,
     ref_aligned, q_aligned) = C.stats(ops)
    denom_gc = matches + mismatches + ins + dels
    denom_bi = matches + mismatches + ins_bp + del_bp
    if denom_gc == 0 or denom_bi == 0:
        return False
    gi = matches / denom_gc
    bi = matches / denom_bi
    qa, qb = inv["qa"], inv["qb"]
    if job.query_is_rev:
        q_start = job.query_offset + (job.query_length - qb)
        q_end = job.query_offset + (job.query_length - qa)
        strand = "+"
    else:
        q_start = job.query_offset + qa
        q_end = job.query_offset + qb
        strand = "-"
    cols = [
        job.query_name,
        str(job.query_total_length),
        str(q_start),
        str(q_end),
        strand,
        job.target_name,
        str(job.target_total_length),
        str(job.target_offset + inv["ta"]),
        str(job.target_offset + inv["tb"]),
        str(matches),
        str(max(ref_aligned, q_aligned)),
        str(int(round(float2phred(1.0 - bi)))),
        "gi:f:" + fmt_double(gi),
        "bi:f:" + fmt_double(bi),
        "md:f:" + fmt_double(job.mashmap_estimated_identity),
        "pt:Z:true",
        "iv:Z:true",
        "cg:Z:" + C.format_ops(ops),
    ]
    out.write("\t".join(cols) + "\t\n")
    return True


def write_paf_row(out, job: AlignmentJob, ops,
                  min_identity: float, min_alignment_length: int,
                  min_block_identity: float) -> bool:
    """write_alignment_paf (wflign_patch.cpp:2611-2724)."""
    if not ops:
        return False
    (matches, mismatches, ins, ins_bp, dels, del_bp,
     _, _) = C.stats(ops)

    trimmed, new_ref_start, new_query_start = C.trim_indels(
        ops, job.target_offset, job.query_offset
    )
    (matches, mismatches, ins, ins_bp, dels, del_bp,
     ref_aligned, q_aligned) = C.stats(trimmed)
    denom_gc = matches + mismatches + ins + dels
    denom_bi = matches + mismatches + ins_bp + del_bp
    if denom_gc == 0 or denom_bi == 0:
        return False
    gap_compressed_identity = matches / denom_gc
    block_identity = matches / denom_bi
    if not (
        gap_compressed_identity >= min_identity
        and q_aligned >= min_alignment_length
        and block_identity >= min_block_identity
    ):
        return False

    aln_ref_pos = new_ref_start - job.target_offset
    if job.query_is_rev:
        rel = new_query_start - job.query_offset
        q_start = job.query_offset + (job.query_length - rel - q_aligned)
        q_end = job.query_offset + (job.query_length - rel)
    else:
        q_start = new_query_start
        q_end = new_query_start + q_aligned

    cols = [
        job.query_name,
        str(job.query_total_length),
        str(q_start),
        str(q_end),
        "-" if job.query_is_rev else "+",
        job.target_name,
        str(job.target_total_length),
        str(job.target_offset + aln_ref_pos),
        str(job.target_offset + aln_ref_pos + ref_aligned),
        str(matches),
        str(max(ref_aligned, q_aligned)),
        str(int(round(float2phred(1.0 - block_identity)))),
        "gi:f:" + fmt_double(gap_compressed_identity),
        "bi:f:" + fmt_double(block_identity),
        "md:f:" + fmt_double(job.mashmap_estimated_identity),
    ]
    if job.chain_length > 0:
        cols.append(
            f"ch:Z:{job.chain_id}.{job.chain_length}.{job.chain_pos}"
        )
    cols.append("cg:Z:" + C.format_ops(trimmed))
    out.write("\t".join(cols) + "\t\n")
    return True
