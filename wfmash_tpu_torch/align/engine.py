"""Alignment pipeline: mapping PAF records -> WFA jobs -> PAF/SAM output.

Equivalent of align::Aligner (reference:
src/align/include/computeAlignments.hpp:142-738), the port's counterpart
of wfmash_tpu/align/engine.py:

* scan the mapping PAF once; per record apply target padding (both ends)
  and query padding (only at chain ends);
* fetch the target and query regions, uppercase/N-normalize both,
  reverse-complement the query for '-' mappings;
* run the biWFA path (align/biwfa.py) per record on the engine that
  make_engine chooses;
* emit PAF rows (or SAM), preserving input record order.

A record whose extraction (`build_job`, a host-side read of the FASTA)
raises is logged and skipped, as in the reference. Unlike the reference,
an engine error ends the run: the reference catches any exception of a
batch, logs it and retries record by record, so a kernel fault would drop
rows and still exit 0.
"""

from __future__ import annotations

import bisect
import os
import re
import sys

import torch

from ..io.fasta import FastaReader
from ..io.paf import parse_paf_line
from ..params import AlignParams, fixed
from ..sketch.kmers import normalize, reverse_complement
from ..utils import perf
from ..utils.progress import ProgressMeter
from .biwfa import (AlignmentJob, HostWfaEngine, align_records_batched,
                    write_inversion_row, write_paf_row)
from .segmented import SegmentedEngine
from .wfa_exact import ExactWfaEngine
from .wfa_np import Penalties
from .wfa_seg import TieredSegmentSolver


def log(msg):
    print(msg, file=sys.stderr)


def parse_mashmap_row(line: str, target_padding: int, query_padding: int):
    """parseMashmapRow (computeAlignments.hpp:195-303). Returns a dict or
    raises on malformed input."""
    rec = parse_paf_line(line)
    # estimated identity from column 13 ("id:f:0.93" in mapping output)
    parts = line.rstrip("\n").split("\t")
    if len(parts) < 13:
        raise ValueError("invalid mashmap mapping record")
    id_tok = parts[12].split(":")
    try:
        mm_id = float(id_tok[-1])
    except ValueError:
        mm_id = fixed.percentage_identity

    chain_id, chain_length, chain_pos = -1, 1, 1
    if len(parts) > 14:
        ch = parts[14].split(":")
        if len(ch) == 3 and ch[0] == "ch" and ch[1] == "Z":
            sub = ch[2].split(".")
            if len(sub) == 3:
                chain_id, chain_pos, chain_length = (
                    int(sub[0]), int(sub[1]), int(sub[2])
                )

    r_start, r_end = rec["target_start"], rec["target_end"]
    q_start, q_end = rec["query_start"], rec["query_end"]
    ref_len = rec["target_len"]
    query_len = rec["query_len"]

    if target_padding > 0:
        r_start = r_start - target_padding if r_start >= target_padding else 0
        r_end = r_end + target_padding if r_end + target_padding <= ref_len else ref_len

    if query_padding > 0:
        qs = q_start
        qe = q_end
        if chain_pos == 1:
            qs = q_start - query_padding if q_start >= query_padding else 0
        if chain_pos == chain_length:
            if q_end + query_padding <= query_len:
                qe = q_end + query_padding
            else:
                qe = query_len
            # the reference commits BOTH coordinates only on the last piece
            q_start, q_end = qs, qe

    if r_start >= ref_len or r_end > ref_len:
        raise ValueError("coordinates exceed reference length")

    return {
        "query_name": rec["query_name"],
        "query_len": query_len,
        "q_start": q_start,
        "q_end": q_end,
        "is_rev": rec["strand"] == "-",
        "target_name": rec["target_name"],
        "target_len": ref_len,
        "r_start": r_start,
        "r_end": r_end,
        "mm_id": mm_id,
        "chain_id": chain_id,
        "chain_length": chain_length,
        "chain_pos": chain_pos,
    }


class _NormCache:
    """Normalised record intervals of one reader, for the align loop.

    `plan` takes every record's span on a sequence name before any job is
    built; per name the spans, clamped to the sequence, merge into sorted
    half-open intervals where they overlap or touch. An interval is
    fetched and normalised once, the first time a record needs it, and
    `get` slices a record's range out of it: dense all-vs-all records
    merge into whole sequences and read each base once, a chunk's
    scattered records read only what they span. Normalisation is a
    per-base lookup, so the slice equals a record's own fetch.

    A byte budget shared by both readers (WFMASH_TPU_ALIGN_SEQ_CACHE_MB,
    default 1024) counts interval bytes: a name whose intervals would
    exceed what is left falls back to per-record fetches. A name absent
    from the FASTA plans nothing and falls back too, so its record fails
    in build_job. Nothing outlives the run_alignment call that made it."""

    def __init__(self, reader: FastaReader, budget: list):
        self._reader = reader
        self._budget = budget        # [remaining_bytes], shared
        self._spans: dict = {}       # name -> planned (start, end)s
        self._seqs: dict = {}        # name -> (starts, ends, data) | None

    def plan(self, name: str, start: int, end: int) -> None:
        if name not in self._reader:
            return
        start, end = max(0, start), min(end, self._reader.seq_len(name))
        if start < end:
            self._spans.setdefault(name, []).append((start, end))

    def _intervals(self, name: str):
        """The name's merged intervals, its budget taken at first touch;
        None where it falls back to per-record fetches."""
        if name in self._seqs:
            return self._seqs[name]
        starts, ends = [], []
        for lo, hi in sorted(self._spans.pop(name, ())):
            if ends and lo <= ends[-1]:
                ends[-1] = max(ends[-1], hi)
            else:
                starts.append(lo)
                ends.append(hi)
        size = sum(ends) - sum(starts)
        if not starts or size > self._budget[0]:
            self._seqs[name] = None
            return None
        self._budget[0] -= size
        self._seqs[name] = got = (starts, ends, [None] * len(starts))
        return got

    def get(self, name: str, start: int, end: int):
        """Normalised bases [start, end) of `name`, clamped as `fetch`
        clamps; None where the range is not held (a per-record fetch)."""
        got = self._intervals(name)
        if got is None:
            return None
        starts, ends, data = got
        start, end = max(0, start), min(end, self._reader.seq_len(name))
        if start >= end:
            return b""
        i = bisect.bisect_right(starts, start) - 1
        if i < 0 or ends[i] < end:
            return None
        if data[i] is None:
            with perf.span("align.loop.fetch"):
                data[i] = bytes(normalize(self._reader.fetch(
                    name, starts[i], ends[i] - 1)))
            perf.add("align.loop.fetched_bp", len(data[i]))
        return data[i][start - starts[i]:end - starts[i]]


def _plan_caches(rows, ref_reader: FastaReader, query_reader: FastaReader,
                 same_file: bool):
    """The reference and query readers' interval caches over `rows`, under
    one budget; one cache holding both roles' spans where query and target
    are the same file."""
    budget = [int(float(os.environ.get(
        "WFMASH_TPU_ALIGN_SEQ_CACHE_MB", "1024")) * 1e6)]
    ref_cache = _NormCache(ref_reader, budget)
    query_cache = (ref_cache if same_file
                   else _NormCache(query_reader, budget))
    for row in rows:
        ref_cache.plan(row["target_name"], row["r_start"], row["r_end"])
        query_cache.plan(row["query_name"], row["q_start"], row["q_end"])
    return ref_cache, query_cache


def _fetch_record(reader: FastaReader, name: str, start: int,
                  end: int) -> bytes:
    """A record's own normalised range, where no cache holds it."""
    with perf.span("align.loop.fetch"):
        seq = bytes(normalize(reader.fetch(name, start, end - 1)))
    perf.add("align.loop.fetched_bp", len(seq))
    return seq


def build_job(row, ref_reader: FastaReader, query_reader: FastaReader,
              params: AlignParams, ref_cache: _NormCache | None = None,
              query_cache: _NormCache | None = None) -> AlignmentJob:
    """createSeqRecord + processAlignment prep (computeAlignments.hpp:
    582-723). The target is extracted WITHOUT the extra
    +-wflign_max_len_minor context: the reference fetches it
    (computeAlignments.hpp:609-621) but then skips past it — the
    pointer handed to do_biwfa_alignment starts at rStartPos and the
    length excludes the tail padding (computeAlignments.hpp:675,706) —
    so the live path never reads those bases. Verified vestigial."""
    target = ref_cache.get(row["target_name"], row["r_start"],
                           row["r_end"]) if ref_cache else None
    if target is None:
        target = _fetch_record(ref_reader, row["target_name"],
                               row["r_start"], row["r_end"])
    qnorm = query_cache.get(row["query_name"], row["q_start"],
                            row["q_end"]) if query_cache else None
    if qnorm is None:
        qnorm = _fetch_record(query_reader, row["query_name"],
                              row["q_start"], row["q_end"])
    if row["is_rev"]:
        query = bytes(reverse_complement(bytearray(qnorm)))
    else:
        query = qnorm
    # lengths come from the FETCHED regions, not the PAF spans: merged
    # chains can claim q_end/r_end beyond the sequence (the reference
    # emits those rows too and its faidx fetch clamps, so queryLen /
    # refLen are the clamped values — computeAlignments.hpp:645-651)
    return AlignmentJob(
        query_name=row["query_name"],
        query=query,
        query_total_length=row["query_len"],
        query_offset=row["q_start"],
        query_length=len(query),
        query_is_rev=row["is_rev"],
        target_name=row["target_name"],
        target=target,
        target_total_length=row["target_len"],
        target_offset=row["r_start"],
        target_length=len(target),
        mashmap_estimated_identity=row["mm_id"],
        chain_id=row["chain_id"],
        chain_length=row["chain_length"],
        chain_pos=row["chain_pos"],
    )


def make_engine(params: AlignParams, device):
    """WFA engine factory on an explicit device.

    WFMASH_TPU_WFA_ENGINE=host: the native HostWfaEngine alone.
    WFMASH_TPU_SEGMENTED=0: ExactWfaEngine alone (exact whole-block
    sweeps with Hirschberg splits; leaves on the segment tiers).
    Otherwise (the default): SegmentedEngine over the kernel tiers with
    ExactWfaEngine for escalations; the tiers split their chunks over the
    devices of `_align_mesh` when it gives a mesh. The reference's "auto"
    probes the
    device link first; the port runs where it is told, so on a card auto
    means segmented. What is left of the reference's rule is its "no
    accelerator" branch: on the CPU device auto gives the native
    BudgetedHostEngine, because the plain versions of the kernels lose
    badly to the native engine there; WFMASH_TPU_SEGMENTED=1 keeps the
    segmented composition on the CPU."""
    penalties = Penalties(
        params.wfa_patching_mismatch_score,
        params.wfa_patching_gap_opening_score1,
        params.wfa_patching_gap_extension_score1,
        params.wfa_patching_gap_opening_score2,
        params.wfa_patching_gap_extension_score2,
    )
    n_threads = max(1, int(params.threads))
    if os.environ.get("WFMASH_TPU_WFA_ENGINE", "auto") == "host":
        engine = HostWfaEngine(penalties)
        engine.threads = n_threads
        return engine
    seg = os.environ.get("WFMASH_TPU_SEGMENTED", "auto")
    if seg == "auto" and torch.device(device).type == "cpu":
        from ..native import get_wfa_lib

        if get_wfa_lib() is not None:
            log("[wfmash::align] no accelerator; using the native engine "
                "(override with WFMASH_TPU_SEGMENTED=1)")
            return BudgetedHostEngine(penalties, params, device)
    exact = ExactWfaEngine(penalties, device)
    exact.threads = n_threads
    if seg == "0":
        return exact
    mesh = _align_mesh(device)
    engine = SegmentedEngine(
        penalties, exact, device, solver=None if mesh is None else
        TieredSegmentSolver(penalties, device, mesh=mesh))
    if params.strict_parity:
        engine.detect_inversions = False
    return engine


def _align_mesh(device):
    """The ("data",) mesh the segment tiers shard over, or None.

    WFMASH_TPU_ALIGN_MESH (the reference's `_build_segmented`): "auto"
    (the default) shards when `mesh_devices` gives more than one distinct
    CUDA device; "force" also shards over a CPU or repeated-device list of
    more than one (the tests' and chip_smoke.py's logical shards); "0"
    turns it off. Only the segmented composition shards, as in the
    reference: ExactWfaEngine's sweeps stay on `device`."""
    from ..parallel import mesh as mesh_mod

    mode = os.environ.get("WFMASH_TPU_ALIGN_MESH", "auto")
    if mode == "0":
        return None
    devs = mesh_mod.mesh_devices(device)
    distinct_cards = len(set(devs)) > 1 and all(
        d.type == "cuda" for d in devs)
    if len(devs) > 1 and (mode == "force" or distinct_cards):
        return mesh_mod.Mesh(devs, ("data",))
    return None


class BudgetedHostEngine(HostWfaEngine):
    """Host exact engine with two escape hatches:

    * **score cap** — a main (end-to-end) block whose exact score
      exceeds WFMASH_TPU_HOST_SCORE_CAP (default 100; 0 disables) is
      re-solved via anchored segmentation with exact native WFA per
      piece (`segmented.segmented_host_align`). The probe costs one
      capped sweep (~1 ms); diverted blocks are the divergent tail
      whose O(score^2) exact cost dominates the align wall — on LPA
      they hold ~75% of the work in ~40% of the records. Near-optimal
      instead of exact for those blocks (fidelity ledger).
    * **memory budget** — a block whose full-history footprint would
      exceed WFMASH_TPU_WFA_MEM_MB raises WfaMemoryBudget from the
      native engine and reroutes through the full segmented engine
      (bounded per-piece memory) — the rare giant/divergent block
      cannot OOM the host."""

    def __init__(self, penalties, params, device):
        super().__init__(penalties)
        self._device = device
        self.threads = max(1, int(getattr(params, "threads", 1)))
        self._params = params
        self._full = None
        self.score_cap = int(os.environ.get(
            "WFMASH_TPU_HOST_SCORE_CAP", "100"))
        # boundary-patch score cap: a patch whose ends-free score would
        # exceed it keeps the ORIGINAL (pre-erode) alignment instead —
        # replayable either way; the reference would compute the
        # expensive patch (fidelity ledger). 0 disables.
        self.patch_cap = int(os.environ.get(
            "WFMASH_TPU_PATCH_SCORE_CAP", "0"))
        # solve free-begin head patches on the reversed sequences
        # (score-identical, cheaper band — see align(); ledgered)
        self.fast_head_patch = os.environ.get(
            "WFMASH_TPU_FAST_HEAD_PATCH", "1") != "0"

    def _probe_failed(self, query: bytes, target: bytes):
        """Score-cap exceeded: segmented reroute (None => whole-block
        exact path)."""
        from ..native import WfaMemoryBudget
        from .segmented import segmented_host_align

        try:
            return segmented_host_align(query, target, self.penalties)
        except WfaMemoryBudget:
            return None               # giant-skew piece: whole-block path

    def _exact_or_reroute(self, query: bytes, target: bytes,
                          ends_free=None):
        """Whole-block exact solve with the memory-budget reroute —
        the tail of align(), callable directly when the probe and
        segmented stages are already known to have run (native batch
        statuses 2/4)."""
        from ..native import WfaMemoryBudget

        try:
            return super().align(query, target, ends_free)
        except WfaMemoryBudget:
            log(f"[wfmash::align] exact history over budget for a "
                f"{len(query)}x{len(target)} block; segmented reroute")
            if self._full is None:
                eng = ExactWfaEngine(self.penalties, self._device)
                eng.threads = max(
                    1, int(getattr(self._params, "threads", 1)))
                self._full = SegmentedEngine(self.penalties, eng,
                                             self._device)
            return self._full.align(query, target, ends_free)

    def align_batch(self, jobs, bounds=None):
        """Batch fast path: ALL end-to-end main blocks run in ONE
        native call (segsolve.cpp:host_align_blocks — capped probe +
        segmented reroute + small-block exact per block), and all
        ends-free patch jobs in one more; only the rare leftovers
        (unplannable blocks, memory-budget reroutes, solver fallbacks)
        go through align() per job. Output is byte-identical to the
        per-job path (tested).

        bounds: optional per-job score upper bounds (a valid candidate
        alignment's score, e.g. the eroded ops a boundary patch
        replaces). Ends-free jobs prune their wavefronts with them —
        the optimum never exceeds a valid bound, so results are
        unchanged (bit-identical, see wfa.cpp)."""
        from ..native import WfaMemoryBudget, wfa_align_batch_native

        if int(getattr(self, "threads", 1)) > 1:
            # multi-core hosts: the per-job thread pool (GIL released
            # inside the native calls) beats one serial batched call
            return super().align_batch(jobs)
        out: list = [None] * len(jobs)
        todo = list(range(len(jobs)))
        main_idx = [i for i, (q, t, ef) in enumerate(jobs) if ef is None]
        if len(main_idx) >= 2:
            from ..native import host_align_blocks_native

            got = host_align_blocks_native(
                [(jobs[i][0], jobs[i][1]) for i in main_idx],
                self.penalties, self.score_cap, 2000,
                int(os.environ.get("WFMASH_TPU_SEG_TARGET", "256")),
                int(os.environ.get("WFMASH_TPU_REFINE_CAP", "800")))
            if got is not NotImplemented:
                done = set()
                for i, (st, runs) in zip(main_idx, got):
                    if st in (0, 1):      # exact / segmented, complete
                        out[i] = runs
                        done.add(i)
                    elif st in (2, 4):
                        # probe + segmented already ran natively
                        # (unplannable / memory budget): go straight to
                        # the exact solve + reroute tail
                        out[i] = self._exact_or_reroute(
                            jobs[i][0], jobs[i][1])
                        done.add(i)
                    # st 3 (solver fallback): full per-job path below
                todo = [i for i in todo if i not in done]
        # batch the ends-free patch jobs too (one native call); head
        # patches (free-begin only) apply the reversal transform first
        # — see align() for the rationale
        ef_idx, ef_pieces, ef_spans, ef_rev, ef_bound = [], [], [], [], []
        for i in todo:
            q, t, ef = jobs[i]
            if ef is None:
                continue
            head = ((ef.target_begin or ef.query_begin)
                    and not (ef.target_end or ef.query_end))
            if head and self.fast_head_patch:
                ef_pieces.append((q[::-1], t[::-1]))
                ef_spans.append((0, ef.target_begin, 0, ef.query_begin))
                ef_rev.append(True)
            else:
                ef_pieces.append((q, t))
                ef_spans.append((ef.target_begin, ef.target_end,
                                 ef.query_begin, ef.query_end))
                ef_rev.append(False)
            ef_bound.append(bounds[i] if bounds is not None
                            and i < len(bounds) else None)
            ef_idx.append(i)
        if len(ef_idx) >= 2:
            if self.patch_cap > 0:
                caps = [self.patch_cap if b is None
                        else min(b, self.patch_cap) for b in ef_bound]
            elif any(b is not None for b in ef_bound):
                # a valid bound can never reject (optimum <= bound), so
                # -1 per-piece results cannot occur here
                caps = [-1 if b is None else b for b in ef_bound]
            else:
                caps = None
            solved = None
            try:
                solved = wfa_align_batch_native(
                    ef_pieces, self.penalties, max_scores=caps,
                    ends_free=ef_spans)
            except WfaMemoryBudget:   # pragma: no cover - giant patch
                solved = None
            if solved is not None:
                done = set()
                for i, rev, (_, ops) in zip(ef_idx, ef_rev, solved):
                    out[i] = (None if ops is None
                              else (ops[::-1] if rev else ops))
                    done.add(i)
                todo = [i for i in todo if i not in done]
        for i in todo:
            q, t, ef = jobs[i]
            out[i] = self.align(q, t, ef)
        return out

    def align(self, query: bytes, target: bytes, ends_free=None):
        from ..native import WfaMemoryBudget
        from .biwfa import EndsFree
        from .wfa_vec import wfa_align

        if (ends_free is not None and self.fast_head_patch
                and (ends_free.target_begin or ends_free.query_begin)
                and not (ends_free.target_end or ends_free.query_end)):
            # head patches are free-BEGIN on both sides: the wavefront
            # seeds span the whole erode width, so every level combines
            # ~|tb|+|qb| live lanes even at score 0. Solving the
            # REVERSED sequences with the frees moved to the END is the
            # same problem (score-identical; the returned CIGAR is one
            # of the co-optimal alignments — tie-breaks differ from the
            # forward solve, fidelity ledger) but seeds a single lane:
            # measured 0.58 ms -> 0.21 ms per head patch on LPA.
            cap = self.patch_cap if self.patch_cap > 0 else None
            _, ops = wfa_align(
                query[::-1], target[::-1], self.penalties,
                EndsFree(target_end=ends_free.target_begin,
                         query_end=ends_free.query_begin),
                max_score=cap)
            return None if ops is None else ops[::-1]
        if ends_free is not None and self.patch_cap > 0:
            _, ops = wfa_align(query, target, self.penalties, ends_free,
                               max_score=self.patch_cap)
            return ops                     # None => caller keeps original
        if (ends_free is None and self.score_cap > 0
                and min(len(query), len(target)) >= 2000):
            try:
                _, ops = wfa_align(query, target, self.penalties, None,
                                   max_score=self.score_cap)
            except WfaMemoryBudget:   # pragma: no cover - tiny cap
                ops = None
            if ops is not None:
                return ops
            ops = self._probe_failed(query, target)
            if ops is not None:
                return ops
        return self._exact_or_reroute(query, target, ends_free)


def _dump_plans(params, chunk, base_idx):
    """-G/-u: per-alignment segmentation-plan dumps (debugplot.py)."""
    from .debugplot import (plan_rows, write_plan_png,
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
    """The align loop, in the span align.loop: align.loop.parse (the
    mapping PAF read and parsed), align.loop.fetch (each merged interval
    of the records' spans fetched and normalised at its first use, or a
    record's own ranges where the cache's budget is spent; the counter
    align.loop.fetched_bp adds the bases either read), the engine's and
    the patching's spans, and align.loop.write (each batch's rows
    written)."""
    with perf.span("align.loop"):
        _run_alignment(params, out, device)


def _run_alignment(params: AlignParams, out, device) -> None:
    if params.target_padding < 0 or params.query_padding < 0:
        # unfinalized params would align unpadded records: apply the
        # reference's defaults for the standard 1 kb mapping window
        params.finalize(1000)
    ref_reader = FastaReader(params.ref_sequences[0])
    query_reader = FastaReader(params.query_sequences[0])

    rows = []
    with perf.span("align.loop.parse"), \
            open(params.mashmap_paf_file) as fh:
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

    ref_cache, query_cache = _plan_caches(
        rows, ref_reader, query_reader,
        params.query_sequences[0] == params.ref_sequences[0])

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
                except Exception as e:
                    # the reference's rule for a host-side read of the
                    # FASTA: log, count and skip the record
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
            with perf.span("align.loop.write"):
                n_aligned += _write_rows(out, params, chunk, ops_list,
                                         engine.inversions)
    finally:
        if tsv is not None:
            tsv.close()
    meter.finish()
    log(f"[wfmash::align] total aligned records = {n_aligned}")


def _write_rows(out, params, chunk, ops_list, inversions) -> int:
    """A batch's PAF or SAM rows, and its inversion rows (PAF only);
    returns the records aligned."""
    n_aligned = 0
    for job, ops in zip(chunk, ops_list):
        if ops is None:
            continue
        if params.sam_format:
            from .sam import write_sam_row

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
    # inversion patches found inside this chunk's blocks emit as extra
    # rows (PAF only)
    if not params.sam_format and not params.strict_parity:
        for inv in inversions:
            if write_inversion_row(out, chunk[inv["ji"]], inv):
                n_aligned += 1
    return n_aligned


def write_sam_header(out, ref_reader: FastaReader) -> None:
    for rec in ref_reader.records:
        out.write(f"@SQ\tSN:{rec.name}\tLN:{rec.length}\n")
    from .. import __version__

    out.write(f"@PG\tID:wfmash\tPN:wfmash\tVN:{__version__}\tCL:wfmash\n")
