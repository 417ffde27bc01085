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
from .utils import perf


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


def _mp_sketch_one(qname):
    """Phase-1 fork worker: fetch + fragment + sketch (pure host)."""
    mapper = _MP_STATE["mapper"]
    readers = _MP_STATE["readers"]
    seq = None
    for reader in readers.values():
        if qname in reader:
            seq = reader.fetch(qname)
            break
    if seq is None or len(seq) == 0:
        return None
    return len(seq), mapper.sketch_query(seq)


def _mp_l2_one(qname, qlen, entries):
    """Phase-3 fork worker: L2 + filters (host; index via fork COW)."""
    mapper = _MP_STATE["mapper"]
    index = _MP_STATE["index"]
    return mapper.map_query_precomputed(qname, qlen, entries, index)


def _map_queries_device(mapper, index, query_readers, query_names, params,
                        meter):
    """Phase-structured mapping with the device L1:

    1. fetch + fragment + sketch every query (fork pool, pure host);
    2. ONE stream of batched device L1 calls over ALL fragments of all
       queries, then of batched device L2 calls over all their candidates
       (parent process only);
    3. L2 walk of the rows the device left + filters per query (fork
       pool, native C++ + numpy).

    The forked workers inherit the mapper, and with it `device_l1` and
    `device_l2` whose tensors may live on a CUDA device, by copy-on-write.
    A forked child may not touch CUDA: the workers run `sketch_query` and
    `map_query_precomputed` only, which never reach those two objects, and
    every task and result that is pickled holds numpy arrays and plain
    objects only.

    Byte-identical to the host path: the device programs are identical
    per fragment and per candidate (tests/test_torch_l1.py,
    tests/test_torch_l2.py) and fragment order is preserved end to end.

    Spans (timed in this process, never in the workers): map.queries,
    and under it map.pool (the workers' start and stop), map.sketch,
    map.l1, map.l2 and map.l2_host (phases 1, 2, 2.5 and 3)."""
    with perf.span("map.queries"):
        return _map_queries_phases(mapper, index, query_readers,
                                   query_names, params, meter)


def _map_queries_phases(mapper, index, query_readers, query_names, params,
                        meter):
    results: list = []
    pool = None
    _MP_STATE.update(mapper=mapper, index=index, readers=query_readers)
    if params.threads > 1 and len(query_names) > 1:
        import multiprocessing as mp_mod

        with perf.span("map.pool"):
            pool = mp_mod.get_context("fork").Pool(processes=params.threads)
    try:
        WAVE = 64
        for w0 in range(0, len(query_names), WAVE):
            wave = query_names[w0:w0 + WAVE]
            with perf.span("map.sketch"):
                if pool is not None:
                    sketched = pool.map(_mp_sketch_one, wave)
                else:
                    sketched = [_mp_sketch_one(q) for q in wave]
            # phase 2: one batched device stream over the wave
            flat = []            # (wave_idx, entry_idx)
            frag_dicts = []
            for wi, got in enumerate(sketched):
                if got is None:
                    continue
                _, entries = got
                q_seqid = mapper.idm.get_sequence_id(wave[wi])
                q_group = int(mapper.group_of([q_seqid])[0])
                for ei, (fi, q_len, sk, ok) in enumerate(entries):
                    if ok:
                        flat.append((wi, ei))
                        frag_dicts.append(dict(
                            hashes=sk.hashes, n=sk.sketch_size,
                            q_len=q_len, q_seqid=q_seqid, q_group=q_group,
                            min_hits=mapper._minimum_hits_for(q_len, sk)))
            with perf.span("map.l1"):
                rows = mapper.device_l1.candidates(frag_dicts)
            # attach rows; drop skipped (not ok) fragments entirely
            tasks = []
            rows_of: dict = {k: r for k, r in zip(flat, rows)}
            for wi, got in enumerate(sketched):
                if got is None:
                    continue
                qlen, entries = got
                ent3 = []
                for ei, (fi, q_len, sk, ok) in enumerate(entries):
                    if ok:
                        ent3.append((fi, q_len, sk, rows_of[(wi, ei)]))
                tasks.append((wave[wi], qlen, ent3))
            # phase 2.5: batched device L2 over every candidate of the
            # wave (parent only); results ride into the fork tasks as
            # parallel lists, None = host walk for that candidate
            if mapper.device_l2 is not None:
                from .map.l1l2 import L1Candidate

                l2_rows, l2_pos = [], []
                for ti, (qname, qlen, ent3) in enumerate(tasks):
                    for ei, (fi, q_len, sk, rws) in enumerate(ent3):
                        for ci, r in enumerate(rws or ()):
                            l2_rows.append((sk, q_len, L1Candidate(*r)))
                            l2_pos.append((ti, ei, ci))
                with perf.span("map.l2"):
                    l2_got = (mapper.device_l2.walk(l2_rows) if l2_rows
                              else [])
                l2_map: dict = {}
                for (ti, ei, ci), g in zip(l2_pos, l2_got):
                    l2_map.setdefault((ti, ei), {})[ci] = g
                for ti in range(len(tasks)):
                    qname, qlen, ent3 = tasks[ti]
                    ent5 = []
                    for ei, (fi, q_len, sk, rws) in enumerate(ent3):
                        l2s = None
                        if rws and (ti, ei) in l2_map:
                            got_d = l2_map[(ti, ei)]
                            l2s = [got_d.get(ci)
                                   for ci in range(len(rws))]
                        ent5.append((fi, q_len, sk, rws, l2s))
                    tasks[ti] = (qname, qlen, ent5)
            with perf.span("map.l2_host"):
                if pool is not None:
                    got3 = pool.starmap(_mp_l2_one, tasks)
                else:
                    got3 = [_mp_l2_one(*t) for t in tasks]
            it = iter(got3)
            for wi, got in enumerate(sketched):
                if got is None:
                    results.append(None)
                else:
                    r = next(it)
                    results.append(r)
                    meter.increment(r.query_len)
    finally:
        if pool is not None:
            with perf.span("map.pool"):
                pool.terminate()
                pool.join()
        _MP_STATE.clear()
    return results


def _device_stages(mapper, index, params, device=None):
    """Set `mapper.device_l1` / `mapper.device_l2` for this target subset
    from the environment.

    WFMASH_TPU_DEVICE_L1: "1" = the batched torch program of
    map/l1_device.py on `device` (default: device.py's), "0" = host stages.
    Unset: "1" when that device is a CUDA card, "0" when it is the CPU.
    "mesh" = parallel/mesh.py's ShardedDeviceL1 over the devices that
    `mesh_devices(device)` gives, as a (2, n // 2) mesh when there are two
    or more and (1, 1) otherwise. The device L2 (map/l2_device.py, on
    `device`) rides with the device L1; WFMASH_TPU_DEVICE_L2=0 forces the
    host walk. A device stage that cannot be built, or fails, fails the
    run: there is no fallback to the host stages."""
    import os

    from . import device as device_mod

    device = device_mod.resolve(device)
    mode = os.environ.get("WFMASH_TPU_DEVICE_L1")
    if mode is None:
        mode = "1" if device.type == "cuda" else "0"
    mapper.device_l1 = mapper.device_l2 = None
    if mode == "0":
        return
    if mode == "mesh":
        from .parallel import mesh as mesh_mod

        devs = mesh_mod.mesh_devices(device)
        n_shard = 2 if len(devs) >= 2 else 1
        mapper.device_l1 = mesh_mod.ShardedDeviceL1(
            index, mapper._group_arr, params, mapper.sketch_cutoffs,
            mesh_mod.make_mesh(n_shard, len(devs) // n_shard, devs))
    else:
        from .map.l1_device import DeviceL1

        mapper.device_l1 = DeviceL1(index, mapper._group_arr, params,
                                    mapper.sketch_cutoffs, device=device)
    if os.environ.get("WFMASH_TPU_DEVICE_L2", "1") != "0":
        from .map.l2_device import DeviceL2

        mapper.device_l2 = DeviceL2(index, params, device=device)

def filtered_names(names, prefixes, single_prefix=""):
    if single_prefix:
        return [n for n in names if n.startswith(single_prefix)]
    if prefixes:
        return [n for n in names if any(n.startswith(p) for p in prefixes)]
    return list(names)


def run_mapping(params: MapParams, out, scaffold_writer=None,
                device=None) -> None:
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
        with perf.span("map.index.fetch"):
            seqs = []
            for name in subset:
                for reader in target_readers.values():
                    if name in reader:
                        seqs.append((idm.get_sequence_id(name),
                                     reader.fetch(name)))
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
                with perf.span("map.index"):
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
        with perf.span("map.index"):
            if index_stream is not None:
                from .index.store import read_subset_index

                with perf.span("map.index.load"):
                    loaded = read_subset_index(index_stream, params)
                if loaded is None:
                    raise ValueError(
                        "index file has fewer subsets than expected")
                index, _, _ = loaded
            else:
                index = build_subset(subset)
            # the device stages' copy of the index
            with perf.span("map.index.upload"):
                _device_stages(mapper, index, params, device)

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
        if mapper.device_l1 is not None:
            # phase-structured pipeline: the device stages run in the
            # parent only; sketching and L2/filters fork-pool around them
            results = _map_queries_device(
                mapper, index, query_readers, query_names, params, meter)
        elif (params.threads > 1 and len(query_names) > 1
                and (_os.cpu_count() or 1) > 1):
            try:
                import multiprocessing as mp_mod

                ctx = mp_mod.get_context("fork")
                _MP_STATE["mapper"] = mapper
                _MP_STATE["index"] = index
                _MP_STATE["readers"] = query_readers
                with perf.span("map.queries"), ctx.Pool(
                        processes=min(params.threads,
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
            with perf.span("map.queries"):
                results = [run_one(q) for q in query_names]

        with perf.span("map.write"):
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
        with perf.span("map.write"):
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
