"""Top-level orchestration: target subsets -> index -> map queries -> PAF.

Mirrors skch::Map::mapQuery (reference: src/map/include/computeMap.hpp:
295-873): targets batched into <= index_by_size bp subsets, each indexed
and mapped against all queries; ONETOONE mode buffers all mappings for a
final reference-axis sweep (computeMap.hpp:789-866).
"""

from __future__ import annotations

import sys

import numpy as np

from .io.fasta import FastaReader
from .io.paf import write_mapping_rows
from .io.seqids import SequenceIdManager
from .map.chain import CHAIN_DTYPE
from .map.engine import Mapper, log
from .map.sweep import filter_by_group
from .params import FILTER_ONETOONE, MapParams
from .index.build import build_index


def create_target_subsets(idm: SequenceIdManager, target_names: list[str],
                          batch_size: int) -> list[list[str]]:
    """computeMap.hpp:295-327."""
    if batch_size <= 0:
        batch_size = 5_000_000
    subsets = []
    current: list[str] = []
    size = 0
    for name in target_names:
        current.append(name)
        size += idm.get_sequence_length(idm.get_sequence_id(name))
        if size >= batch_size:
            subsets.append(current)
            current = []
            size = 0
    if current:
        subsets.append(current)
    return subsets


# fork-pool worker state: set in the parent right before the pool is
# created; child processes inherit it via fork (copy-on-write index)
_MP_STATE: dict = {}


def _mp_run_one(qname):
    mapper = _MP_STATE["mapper"]
    index = _MP_STATE["index"]
    readers = _MP_STATE["readers"]
    seq = None
    for reader in readers.values():
        if qname in reader:
            seq = reader.fetch(qname)
            break
    if seq is None or len(seq) == 0:
        return None
    return mapper.map_query(qname, seq, index)



def filtered_names(names, prefixes, single_prefix=""):
    if single_prefix:
        return [n for n in names if n.startswith(single_prefix)]
    if prefixes:
        return [n for n in names if any(n.startswith(p) for p in prefixes)]
    return list(names)


def run_mapping(params: MapParams, out, scaffold_writer=None) -> None:
    idm = SequenceIdManager(
        params.query_sequences,
        params.ref_sequences,
        params.query_prefix,
        [params.target_prefix] if params.target_prefix else [],
        params.prefix_delim if params.skip_prefix else "",
        params.query_list,
        params.target_list,
    )

    query_names = filtered_names(idm.get_query_sequence_names(), params.query_prefix)
    target_names = filtered_names(
        idm.get_target_sequence_names(), [], params.target_prefix
    )

    mapper = Mapper(params, idm)

    # -I: adopt the batch size recorded in the index so subsets line up
    # (computeMap.hpp:349-375)
    if params.index_filename and not params.create_index_only:
        import struct

        from .index.store import MAGIC

        with open(params.index_filename, "rb") as fh:
            magic, _bi, total_batches, batch_size = struct.unpack(
                "<QQQq", fh.read(32)
            )
        if magic != MAGIC:
            raise ValueError("invalid index file format (wrong magic number)")
        if batch_size > 0:
            params.index_by_size = batch_size
            log(
                f"[wfmash::mashmap] Using batch size {batch_size} from index "
                f"file ({total_batches} subsets)"
            )

    subsets = create_target_subsets(idm, target_names, params.index_by_size)
    log(f"[wfmash::mashmap] Processing {len(subsets)} target subsets")

    query_readers = {f: FastaReader(f) for f in params.query_sequences}
    target_readers = {f: FastaReader(f) for f in params.ref_sequences}

    def build_subset(subset):
        seqs = []
        for name in subset:
            for reader in target_readers.values():
                if name in reader:
                    seqs.append((idm.get_sequence_id(name), reader.fetch(name)))
                    break
        return build_index(params, seqs, log=log)

    # -W: write the index per subset and exit (computeMap.hpp:405-416)
    if params.create_index_only:
        from .index.store import write_subset_index

        with open(params.index_filename, "wb") as fh:
            for subset_idx, subset in enumerate(subsets):
                log(
                    f"[wfmash::mashmap] Processing subset {subset_idx + 1}/"
                    f"{len(subsets)} (indexing): {params.index_filename}"
                )
                index = build_subset(subset)
                write_subset_index(
                    fh, index, subset, dict(idm.name_to_id), params,
                    subset_idx, len(subsets),
                )
        log("[wfmash::mashmap] All indices created successfully.")
        return

    # -I: stream subsets from the saved index (computeMap.hpp:431-486)
    index_stream = None
    if params.index_filename:
        from .index.store import read_subset_index

        index_stream = open(params.index_filename, "rb")

    combined: dict[int, list[np.ndarray]] = {}

    for subset_idx, subset in enumerate(subsets):
        log(
            f"[wfmash::mashmap] Processing subset {subset_idx + 1}/{len(subsets)} (mapping)"
        )
        if index_stream is not None:
            from .index.store import read_subset_index

            loaded = read_subset_index(index_stream, params)
            if loaded is None:
                raise ValueError("index file has fewer subsets than expected")
            index, _, _ = loaded
        else:
            index = build_subset(subset)

        # Mapping runs the host stages only (native winnowing, L1/L2 walk
        # and filters). The reference's device L1/L2 programs
        # (map/l1_device.py, map/l2_device.py) are not part of this
        # package yet; ROADMAP.md lists them as the next slice.

        from .utils.progress import ProgressMeter

        total_bp = sum(
            idm.get_sequence_length(idm.get_sequence_id(q))
            for q in query_names if q in idm.name_to_id)
        meter = ProgressMeter(
            max(total_bp, 1), "[wfmash::mashmap] mapping")

        def run_one(qname):
            seq = None
            for reader in query_readers.values():
                if qname in reader:
                    seq = reader.fetch(qname)
                    break
            if seq is None or len(seq) == 0:
                return None
            result = mapper.map_query(qname, seq, index)
            meter.increment(len(seq))
            return result

        # data-parallel queries (the reference's taskflow subflows,
        # computeMap.hpp:532-689). Python-level orchestration holds the
        # GIL, so real parallelism needs processes: fork shares the index
        # copy-on-write. Output order is restored by input order.
        import os as _os

        results = None
        if (params.threads > 1 and len(query_names) > 1
                and (_os.cpu_count() or 1) > 1):
            try:
                import multiprocessing as mp_mod

                ctx = mp_mod.get_context("fork")
                _MP_STATE["mapper"] = mapper
                _MP_STATE["index"] = index
                _MP_STATE["readers"] = query_readers
                with ctx.Pool(processes=min(params.threads,
                                            len(query_names))) as pool:
                    # imap (not map): children can't advance the parent's
                    # progress meter, so tick it as each result arrives
                    results = []
                    for r in pool.imap(_mp_run_one, query_names):
                        results.append(r)
                        if r is not None:
                            meter.increment(r.query_len)
            except Exception as e:  # pragma: no cover - platform-specific
                log(f"[wfmash::mashmap] fork pool unavailable ({e}); "
                    "running single-threaded")
                results = None
            finally:
                _MP_STATE.clear()
        if results is None:
            results = [run_one(q) for q in query_names]

        for qname, result in zip(query_names, results):
            if result is None:
                continue
            if params.filter_mode == FILTER_ONETOONE:
                qid = idm.get_sequence_id(qname)
                combined.setdefault(qid, []).append(result.mappings)
            else:
                write_mapping_rows(
                    out, qname, result.query_len, result.mappings,
                    result.chain_info, idm, params.merge_mappings,
                )
        meter.finish()

    if params.filter_mode == FILTER_ONETOONE:
        _one_to_one_output(params, idm, mapper, combined, out)


def _one_to_one_output(params, idm, mapper, combined, out) -> None:
    """Final reference-axis sweep per target sequence (computeMap.hpp:789-866)."""
    # group all mappings by target sequence
    by_target: dict[int, list[tuple[int, np.ndarray]]] = {}
    for qid, parts in combined.items():
        if not parts:
            continue
        allm = np.concatenate(parts)
        for row in allm:
            by_target.setdefault(int(row["ref_seq_id"]), []).append((qid, row))

    final: dict[int, list[np.ndarray]] = {}
    for tid, rows in by_target.items():
        arr = np.array([r for _, r in rows], dtype=rows[0][1].dtype)
        qids = [q for q, _ in rows]
        keep = filter_by_group(
            arr, params.num_mappings_for_segment - 1, True,
            mapper.group_of, mapper.seq_len_of, params,
        )
        # re-associate filtered rows to their query ids by record identity
        id_map: dict[bytes, list[int]] = {}
        row_size = arr.dtype.itemsize
        raw = arr.tobytes()
        for i in range(len(arr)):
            id_map.setdefault(raw[i * row_size : (i + 1) * row_size], []).append(i)
        kraw = keep.tobytes()
        for i in range(len(keep)):
            j = id_map[kraw[i * row_size : (i + 1) * row_size]].pop(0)
            final.setdefault(qids[j], []).append(keep[i])

    for qid, rows in final.items():
        qname = idm.get_sequence_name(qid)
        qlen = idm.get_sequence_length(qid)
        arr = np.array(rows, dtype=rows[0].dtype)
        chain_info = np.zeros(len(arr), dtype=CHAIN_DTYPE)
        chain_info["chain_id"] = np.arange(len(arr))
        chain_info["chain_pos"] = 1
        chain_info["chain_len"] = 1
        write_mapping_rows(out, qname, qlen, arr, chain_info, idm,
                           params.merge_mappings)
