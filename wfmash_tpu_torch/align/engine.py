"""Alignment pipeline: mapping PAF records -> WFA jobs -> PAF/SAM output.

The reference's run_alignment (wfmash_tpu/align/engine.py) with the
port's engine: SegmentedEngine over the kernel tiers, the native exact
engine for escalations. Record parsing, job building, patching and the
writers are the reference's own functions.

Unlike the reference, an engine error ends the run: the reference catches
any exception of a batch, logs it and retries record by record, so a
kernel fault would drop rows and still exit 0.
"""

from __future__ import annotations

import os
import re

from wfmash_tpu.align.biwfa import (HostWfaEngine, align_records_batched,
                                    write_inversion_row, write_paf_row)
from wfmash_tpu.align.engine import (_NormCache, build_job, log,
                                     parse_mashmap_row, write_sam_header)
from wfmash_tpu.align.wfa_np import Penalties
from wfmash_tpu.io.fasta import FastaReader
from wfmash_tpu.params import AlignParams
from wfmash_tpu.utils import perf
from wfmash_tpu.utils.progress import ProgressMeter

from .segmented import SegmentedEngine


def make_engine(params: AlignParams, device):
    """SegmentedEngine over the port's TieredSegmentSolver on `device`,
    with the native exact engine (threads from params) for escalations."""
    penalties = Penalties(
        params.wfa_patching_mismatch_score,
        params.wfa_patching_gap_opening_score1,
        params.wfa_patching_gap_extension_score1,
        params.wfa_patching_gap_opening_score2,
        params.wfa_patching_gap_extension_score2,
    )
    exact = HostWfaEngine(penalties)
    exact.threads = max(1, params.threads)
    engine = SegmentedEngine(penalties, exact, device)
    if params.strict_parity:
        engine.detect_inversions = False
    return engine


def _dump_plans(params, chunk, base_idx):
    """-G/-u: per-alignment segmentation-plan dumps (debugplot.py)."""
    from wfmash_tpu.align.debugplot import (plan_rows, write_plan_png,
                                            write_plan_tsv)

    def safe(name):
        # sequence names may hold path characters ('/', PanSN '#')
        return re.sub(r"[^A-Za-z0-9._-]", "_", name)

    wf_tsv, wf_png = params.wavefront_tsv_prefix, params.wavefront_png_prefix
    for di, job in enumerate(chunk):
        rows = plan_rows(job.query, job.target)
        stem = (f"{base_idx + di:06d}.{safe(job.query_name)}_"
                f"{job.query_offset}_{safe(job.target_name)}_"
                f"{job.target_offset}")
        if wf_tsv:
            write_plan_tsv(f"{wf_tsv}{stem}.tsv", job, rows)
        if wf_png:
            write_plan_png(f"{wf_png}{stem}.png", rows, job.query_length,
                           job.target_length, params.wfplot_max_size)


def run_alignment(params: AlignParams, out, device) -> None:
    if params.target_padding < 0 or params.query_padding < 0:
        # unfinalized params would align unpadded records: apply the
        # reference's defaults for the standard 1 kb mapping window
        params.finalize(1000)
    ref_reader = FastaReader(params.ref_sequences[0])
    query_reader = FastaReader(params.query_sequences[0])

    rows = []
    with open(params.mashmap_paf_file) as fh:
        for line in fh:
            if not line.strip():
                continue
            try:
                rows.append(parse_mashmap_row(
                    line, params.target_padding, params.query_padding))
            except (ValueError, IndexError) as e:
                log(f"[wfmash::align] Warning: Skipping invalid record: {e}")

    total_q = sum(r["q_end"] - r["q_start"] for r in rows)
    log(f"[wfmash::align] Found {len(rows)} mapping records for alignment "
        f"({total_q} query bp)")

    if params.sam_format:
        write_sam_header(out, ref_reader)

    budget = [int(float(os.environ.get(
        "WFMASH_TPU_ALIGN_SEQ_CACHE_MB", "1024")) * 1e6)]
    ref_cache = _NormCache(ref_reader, budget)
    query_cache = (_NormCache(query_reader, budget)
                   if params.query_sequences[0] != params.ref_sequences[0]
                   else ref_cache)

    engine = make_engine(params, device)

    # streaming: batches bounded by total bp, so one engine batch
    # pools the segments of many records while multi-GB runs still stream
    n_aligned = 0
    n_dumped = 0
    batch_bp = int(os.environ.get("WFMASH_TPU_ALIGN_BATCH_BP",
                                  str(256 * 1024 * 1024)))
    tsv = None
    if params.path_patching_tsv:
        tsv = open(params.path_patching_tsv, "w")
        tsv.write("query.name\tquery.start\tquery.end\ttarget.name\t"
                  "target.start\ttarget.end\tkind\tquery.eroded.bp\t"
                  "target.eroded.bp\tpatch.applied\n")
    dumps = params.wavefront_tsv_prefix or params.wavefront_png_prefix
    meter = ProgressMeter(max(len(rows), 1), "[wfmash::align] aligning")
    try:
        start = 0
        while start < len(rows):
            chunk = []
            bp = 0
            while start < len(rows) and (not chunk or bp < batch_bp):
                row = rows[start]
                start += 1
                try:
                    job = build_job(row, ref_reader, query_reader, params,
                                    ref_cache, query_cache)
                except (ValueError, KeyError, IndexError, OSError) as e:
                    log(f"[wfmash::align] Error extracting record: {e}")
                    meter.increment(1)
                    continue
                chunk.append(job)
                bp += job.query_length + job.target_length
            if dumps:
                _dump_plans(params, chunk, n_dumped)
                n_dumped += len(chunk)
            engine.inversions = []
            trace = [] if tsv is not None else None
            ops_list = align_records_batched(
                chunk, engine, params.disable_chain_patching, trace=trace)
            if tsv is not None:
                for ji, kind, q_er, t_er, applied in trace:
                    j = chunk[ji]
                    tsv.write(
                        f"{j.query_name}\t{j.query_offset}\t"
                        f"{j.query_offset + j.query_length}\t"
                        f"{j.target_name}\t{j.target_offset}\t"
                        f"{j.target_offset + j.target_length}\t{kind}\t"
                        f"{q_er}\t{t_er}\t{int(applied)}\n")
                tsv.flush()
            meter.increment(len(chunk))
            for job, ops in zip(chunk, ops_list):
                if ops is None:
                    continue
                if params.sam_format:
                    from wfmash_tpu.align.sam import write_sam_row

                    write_sam_row(
                        out, job, ops,
                        params.min_identity, params.min_alignment_length,
                        params.min_block_identity,
                        no_seq=params.no_seq_in_sam,
                        emit_md=params.emit_md_tag,
                    )
                else:
                    write_paf_row(
                        out, job, ops,
                        params.min_identity, params.min_alignment_length,
                        params.min_block_identity,
                    )
                n_aligned += 1
            # inversion patches found inside this chunk's blocks emit as
            # extra rows (PAF only)
            if not params.sam_format and not params.strict_parity:
                for inv in engine.inversions:
                    if write_inversion_row(out, chunk[inv["ji"]], inv):
                        n_aligned += 1
    finally:
        if tsv is not None:
            tsv.close()
    meter.finish()
    log(f"[wfmash::align] total aligned records = {n_aligned}")
    if os.environ.get("WFMASH_TPU_PERF"):
        snap = perf.snapshot()
        for k in sorted(snap):
            log(f"[wfmash::perf] {k} = {snap[k]:.3f}")
