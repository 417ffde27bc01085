"""Native (C++) host components, loaded via ctypes.

The shared library is compiled lazily from winnow.cpp on first use (g++ -O3)
and cached next to the source. Every entry point has a pure-Python
equivalent (wfmash_tpu.sketch.winnow / kmers) used as a fallback and as the
cross-check oracle in tests.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

from ..sketch.winnow import RECORD_DTYPE

_DIR = Path(__file__).parent
# sanitized builds live under separate names so the regular cache
# survives (see _gpp_flags)
_SAN = ".san" if os.environ.get("WFMASH_TPU_SANITIZE") == "1" else ""
_SRC = _DIR / "winnow.cpp"
_LIB = _DIR / f"_winnow{_SAN}.so"

_lib = None
_tried = False

# disk layout of the C Record struct (packed to 8-byte alignment)
_C_RECORD_DTYPE = np.dtype(
    [
        ("hash", "<u8"),
        ("wpos", "<i8"),
        ("wend", "<i8"),
        ("seq_id", "<i4"),
        ("strand", "<i1"),
        ("_pad", "V3"),
    ]
)


def _gpp_flags() -> list[str]:
    """Shared g++ flags for every native lib. WFMASH_TPU_SANITIZE=1
    adds UBSAN (the race/sanitizer analogue of the reference's
    -fsanitize CI builds, SURVEY §5; UBSAN works inside dlopen'd
    shared libs without an LD_PRELOAD, unlike ASAN) — used by
    tests/test_native.py::test_native_libs_ubsan_clean."""
    flags = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17"]
    if os.environ.get("WFMASH_TPU_DEBUGINFO") == "1":
        flags.append("-g")   # line info for gprofng; same codegen
    if os.environ.get("WFMASH_TPU_SANITIZE") == "1":
        flags += ["-fsanitize=undefined", "-fno-sanitize-recover=all",
                  "-g"]
    return flags


def _gpp_build(src, lib) -> None:
    """Compile src into lib through a per-process temporary file, so a
    concurrent process never loads a half-written library."""
    from ..utils import perf

    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    try:
        with perf.span("build.kernel"):
            subprocess.run(["g++", *_gpp_flags(), str(src), "-o", str(tmp)],
                           check=True, capture_output=True)
        os.replace(tmp, lib)
    finally:
        tmp.unlink(missing_ok=True)


def _compile() -> bool:
    try:
        _gpp_build(_SRC, _LIB)
        return True
    except (subprocess.CalledProcessError, FileNotFoundError) as e:
        print(f"[wfmash-tpu] native build failed ({e}); using Python fallback",
              file=sys.stderr)
        return False


def get_lib():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not _LIB.exists() or _LIB.stat().st_mtime < _SRC.stat().st_mtime:
        if not _compile():
            return None
    try:
        lib = ctypes.CDLL(str(_LIB))
    except OSError:
        return None
    lib.winnow_scan.restype = ctypes.c_int64
    lib.winnow_scan.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int32, ctypes.POINTER(ctypes.c_void_p),
    ]
    lib.free_records.argtypes = [ctypes.c_void_p]
    lib.canonical_hashes.restype = ctypes.c_int64
    lib.canonical_hashes.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.sketch_fragments.restype = ctypes.c_int64
    lib.sketch_fragments.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int,
        ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    _lib = lib
    return _lib


def canonical_hashes_native(seq: bytes, k: int):
    """Batch canonical k-mer hashing (murmur3 low-64, min(fwd, revcomp)).

    Returns (pos, canon, vote) filtered to sketch-valid k-mers —
    identical to sketch.kmers.canonical_kmer_hashes — or None when the
    native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    n = max(0, len(seq) - k + 1)
    if n == 0:
        return (np.empty(0, np.int64), np.empty(0, np.uint64),
                np.empty(0, np.int8))
    canon = np.empty(n, np.uint64)
    vote = np.empty(n, np.int8)
    vs = np.empty(n, np.uint8)
    vw = np.empty(n, np.uint8)
    lib.canonical_hashes(bytes(seq), len(seq), k, canon.ctypes.data,
                         vote.ctypes.data, vs.ctypes.data, vw.ctypes.data)
    pos = np.nonzero(vs)[0].astype(np.int64)
    return pos, canon[pos], vote[pos]


def sketch_fragments_native(seq: bytes, k: int, w: int, s: int):
    """All of one query's fragment sketches in ONE native call
    (winnow.cpp:sketch_fragments; sketch/minhash.py::sketch_fragment is
    the per-fragment spec — bit-identical, tested). Returns a list of
    FragmentSketch (one per w-window + the w-length tail window), or
    None when the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    from ..sketch.minhash import FragmentSketch

    n_main = len(seq) // w
    n_frag = n_main + (1 if n_main >= 1 and len(seq) % w else 0)
    if n_frag == 0:
        return []
    cap = n_frag * max(s, 1)
    hashes = np.empty(cap, np.uint64)
    wpos = np.empty(cap, np.int64)
    wend = np.empty(cap, np.int64)
    strand = np.empty(cap, np.int8)
    counts = np.empty(n_frag, np.int64)
    comp = np.empty(n_frag, np.float64)
    got = lib.sketch_fragments(
        bytes(seq), len(seq), k, w, s,
        hashes.ctypes.data, wpos.ctypes.data, wend.ctypes.data,
        strand.ctypes.data, counts.ctypes.data, comp.ctypes.data)
    assert got == n_frag
    out = []
    o = 0
    for f in range(n_frag):
        c = int(counts[f])
        out.append(FragmentSketch(
            hashes=hashes[o:o + c].copy(),
            wpos=wpos[o:o + c].copy(),
            wpos_end=wend[o:o + c].copy(),
            strand=strand[o:o + c].copy(),
            kmer_complexity=float(comp[f]),
            sketch_size=c,
        ))
        o += c
    return out


def winnow_minmers_native(seq: bytes, k: int, window_size: int,
                          sketch_size: int, seq_id: int = 0):
    """Native windowed minmer scan; returns RECORD_DTYPE array or None if
    the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    out = ctypes.c_void_p()
    n = lib.winnow_scan(
        bytes(seq), len(seq), k, window_size, sketch_size, seq_id,
        ctypes.byref(out),
    )
    if n <= 0 or not out.value:
        if out.value:
            lib.free_records(out)
        return np.empty(0, dtype=RECORD_DTYPE)
    # read in place, then freed: no copy of the native buffer
    c_rec = np.frombuffer(
        (ctypes.c_char * (n * _C_RECORD_DTYPE.itemsize)).from_address(
            out.value), dtype=_C_RECORD_DTYPE)
    rec = np.empty(n, dtype=RECORD_DTYPE)
    rec["hash"] = c_rec["hash"]
    rec["wpos"] = c_rec["wpos"]
    rec["wpos_end"] = c_rec["wend"]
    rec["seq_id"] = c_rec["seq_id"]
    rec["strand"] = c_rec["strand"]
    del c_rec
    lib.free_records(out)
    return rec


# ---------------------------------------------------------------------------
# Native L1/L2 mapping stages (l1l2.cpp) — bit-identical to map/l1l2.py
# ---------------------------------------------------------------------------

_SRC2 = _DIR / "l1l2.cpp"
_LIB2 = _DIR / f"_l1l2{_SAN}.so"
_lib2 = None
_tried2 = False


def get_l1l2_lib():
    global _lib2, _tried2
    if _lib2 is not None or _tried2:
        return _lib2
    _tried2 = True
    if os.environ.get("WFMASH_TPU_NO_NATIVE"):
        return None
    if not _LIB2.exists() or _LIB2.stat().st_mtime < _SRC2.stat().st_mtime:
        try:
            _gpp_build(_SRC2, _LIB2)
        except (subprocess.CalledProcessError, FileNotFoundError) as e:
            print(f"[wfmash-tpu] native l1l2 build failed ({e}); "
                  "using Python fallback", file=sys.stderr)
            return None
    try:
        lib = ctypes.CDLL(str(_LIB2))
    except OSError:
        return None
    # pointer args are declared c_void_p and passed as raw addresses
    # (ndarray.ctypes.data): data_as()/cast() cost ~3 us per pointer and
    # the L1/L2 hot path makes ~10 pointer args per native call
    vp = ctypes.c_void_p
    lib.l1_sweep.restype = ctypes.c_int64
    lib.l1_sweep.argtypes = [
        vp, vp, vp, vp, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.c_int64, ctypes.c_double,
        vp, ctypes.c_int64,
        vp, vp, vp, vp, ctypes.c_int64,
    ]
    lib.l2_walk.restype = ctypes.c_int64
    lib.l2_walk.argtypes = [
        vp, vp, vp, vp, vp,
        ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        vp, vp,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        vp, ctypes.c_int64,
    ]
    lib.l1_sweep_multi.restype = ctypes.c_int64
    lib.l1_sweep_multi.argtypes = [
        vp, vp, vp, vp,
        vp, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.c_int64, ctypes.c_double,
        vp, ctypes.c_int64,
        ctypes.c_int64,
        vp, vp, vp, vp, ctypes.c_int64,
    ]
    lib.l2_walk_multi.restype = ctypes.c_int64
    lib.l2_walk_multi.argtypes = [
        vp, vp, vp, vp, vp,
        ctypes.c_int64,
        vp, vp, vp, ctypes.c_int64,
        vp, vp,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        vp, ctypes.c_int64, vp,
    ]
    lib.l1_fragment.restype = ctypes.c_int64
    lib.l1_fragment.argtypes = [
        vp, vp, vp, vp,
        vp, vp, ctypes.c_int64,
        vp, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.c_int64, ctypes.c_double,
        vp, ctypes.c_int64,
        ctypes.c_int64,
        vp, vp, vp, vp, ctypes.c_int64,
    ]
    lib.l1_fragment_multi.restype = ctypes.c_int64
    lib.l1_fragment_multi.argtypes = [
        vp, vp, vp, vp,
        vp, vp, vp, ctypes.c_int64,
        vp, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        vp, vp, ctypes.c_int, ctypes.c_int, vp,
        ctypes.c_double, vp, ctypes.c_int64, ctypes.c_int64,
        vp, vp, vp, vp, ctypes.c_int64, vp,
    ]
    lib.chain_roots.restype = None
    lib.chain_roots.argtypes = [
        vp, vp, vp, vp, vp, vp, vp,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, vp,
    ]
    _lib2 = lib
    return _lib2


def chain_roots_native(ref_seq_id, strand, q_start, q_end, r_start,
                       r_end, split_id, max_dist, rdist_floor):
    """Union-find chain roots (l1l2.cpp:chain_roots), bit-identical to
    map.chain's Python spec (tested). Arrays must be the sorted order;
    returns int64 roots or None when the lib is unavailable."""
    lib = get_l1l2_lib()
    if lib is None:
        return None
    n = len(split_id)
    rs = np.ascontiguousarray(ref_seq_id, np.int64)
    st = np.ascontiguousarray(strand, np.int8)
    a = np.ascontiguousarray(q_start, np.int64)
    b = np.ascontiguousarray(q_end, np.int64)
    c = np.ascontiguousarray(r_start, np.int64)
    d = np.ascontiguousarray(r_end, np.int64)
    sp = np.ascontiguousarray(split_id, np.int64)
    out = np.empty(n, np.int64)
    lib.chain_roots(_ptr(rs), _ptr(st), _ptr(a), _ptr(b), _ptr(c),
                    _ptr(d), _ptr(sp), n, int(max_dist),
                    int(rdist_floor), _ptr(out))
    return out


def _ptr(a, ct=None):
    return a.ctypes.data


def l1_sweep_native(pos, seq, side, hashes, window_len, minimum_hits,
                    stage1_filter, stage2_full_scan, sketch_size,
                    cutoff_div, sketch_cutoffs):
    """Returns list of (seq, start, end, intersection) or None."""
    lib = get_l1l2_lib()
    if lib is None:
        return None
    n = len(pos)
    cap = max(16, n)
    scr = getattr(_tls, "l1", None)
    if scr is None or len(scr[0]) < cap:
        scr = tuple(np.empty(cap, np.int64) for _ in range(4))
        _tls.l1 = scr
    o_seq, o_start, o_end, o_inter = scr
    cut32 = np.ascontiguousarray(sketch_cutoffs, dtype=np.int32)
    m = lib.l1_sweep(
        _ptr(pos, ctypes.c_int64), _ptr(seq, ctypes.c_int64),
        _ptr(side, ctypes.c_int8), _ptr(hashes, ctypes.c_uint64), n,
        window_len, minimum_hits, int(stage1_filter), int(stage2_full_scan),
        sketch_size, float(cutoff_div),
        _ptr(cut32, ctypes.c_int32), len(cut32),
        _ptr(o_seq, ctypes.c_int64), _ptr(o_start, ctypes.c_int64),
        _ptr(o_end, ctypes.c_int64), _ptr(o_inter, ctypes.c_int64), cap,
    )
    if m < 0:
        return None
    return [(int(o_seq[i]), int(o_start[i]), int(o_end[i]), int(o_inter[i]))
            for i in range(m)]


import threading as _threading

_tls = _threading.local()

_cut32_cache: tuple | None = None


def _cut32(sketch_cutoffs):
    """sketch_cutoffs is the same table every call — convert once."""
    global _cut32_cache
    if _cut32_cache is None or _cut32_cache[0] is not sketch_cutoffs:
        _cut32_cache = (sketch_cutoffs, np.ascontiguousarray(
            sketch_cutoffs, dtype=np.int32))
    return _cut32_cache[1]


def l1_sweep_multi_native(pos, seq, side, hashes, grp_b, window_len,
                          minimum_hits, stage1_filter, stage2_full_scan,
                          sketch_size, cutoff_div, sketch_cutoffs,
                          cluster_len):
    """One call per FRAGMENT: per-group sweeps + the proximal join run
    natively (l1l2.cpp:l1_sweep_multi). Returns a list of
    (seq, start, end, intersection) or None when the lib is absent."""
    lib = get_l1l2_lib()
    if lib is None:
        return None
    n = len(pos)
    cap = max(16, n)
    scr = getattr(_tls, "l1", None)
    if scr is None or len(scr[0]) < cap:
        scr = tuple(np.empty(cap, np.int64) for _ in range(4))
        _tls.l1 = scr
    o_seq, o_start, o_end, o_inter = scr
    cut32 = _cut32(sketch_cutoffs)
    m = lib.l1_sweep_multi(
        _ptr(pos), _ptr(seq), _ptr(side), _ptr(hashes),
        _ptr(grp_b), len(grp_b) - 1,
        window_len, minimum_hits, int(stage1_filter),
        int(stage2_full_scan), sketch_size, float(cutoff_div),
        _ptr(cut32), len(cut32), cluster_len,
        _ptr(o_seq), _ptr(o_start), _ptr(o_end), _ptr(o_inter), cap,
    )
    if m < 0:
        return None
    return [(int(o_seq[i]), int(o_start[i]), int(o_end[i]), int(o_inter[i]))
            for i in range(m)]


def l2_walk_native(soa, cand_seq, range_start, range_end,
                   q_hashes, q_strand, window_len, w):
    """Returns list of 6-int tuples (seq, mean, start, end, shared, strand)
    or None."""
    lib = get_l1l2_lib()
    if lib is None:
        return None
    mi_hash, mi_wpos, mi_wend, mi_seq, mi_strand = soa
    cap = 4096
    out = getattr(_tls, "l2", None)
    if out is None:
        out = np.empty(cap * 6, np.int64)
        _tls.l2 = out
    m = lib.l2_walk(
        _ptr(mi_hash, ctypes.c_uint64), _ptr(mi_wpos, ctypes.c_int64),
        _ptr(mi_wend, ctypes.c_int64), _ptr(mi_seq, ctypes.c_int32),
        _ptr(mi_strand, ctypes.c_int8), len(mi_hash),
        cand_seq, range_start, range_end,
        _ptr(q_hashes, ctypes.c_uint64), _ptr(q_strand, ctypes.c_int8),
        len(q_hashes), window_len, w,
        _ptr(out, ctypes.c_int64), cap,
    )
    if m < 0:
        return None
    r = out[:m * 6].reshape(m, 6)
    return [tuple(int(v) for v in row) for row in r]


def l1_fragment_native(ep_soa, starts, ends, group_arr, query_group,
                       query_seq_id, skip_group, lower_tri, split_by_group,
                       window_len, minimum_hits, stage1_filter,
                       stage2_full_scan, sketch_size, cutoff_div,
                       sketch_cutoffs, cluster_len):
    """The whole per-fragment L1 stage natively (l1l2.cpp:l1_fragment):
    endpoint gather + skip filter + (seq,pos,side) stable sort +
    per-group sweeps + proximal join. Returns a list of
    (seq, start, end, intersection) or None (lib absent / overflow)."""
    lib = get_l1l2_lib()
    if lib is None:
        return None
    ep_pos, ep_hash, ep_seq, ep_side = ep_soa
    total = int((ends - starts).sum())
    cap = max(16, total)
    scr = getattr(_tls, "l1", None)
    if scr is None or len(scr[0]) < cap:
        scr = tuple(np.empty(cap, np.int64) for _ in range(4))
        _tls.l1 = scr
    o_seq, o_start, o_end, o_inter = scr
    cut32 = _cut32(sketch_cutoffs)
    m = lib.l1_fragment(
        _ptr(ep_pos), _ptr(ep_hash), _ptr(ep_seq), _ptr(ep_side),
        _ptr(starts), _ptr(ends), len(starts),
        _ptr(group_arr), query_group, query_seq_id,
        int(skip_group), int(lower_tri), int(split_by_group),
        window_len, minimum_hits, int(stage1_filter),
        int(stage2_full_scan), sketch_size, float(cutoff_div),
        _ptr(cut32), len(cut32), cluster_len,
        _ptr(o_seq), _ptr(o_start), _ptr(o_end), _ptr(o_inter), cap,
    )
    if m < 0:
        return None
    return [(int(o_seq[i]), int(o_start[i]), int(o_end[i]), int(o_inter[i]))
            for i in range(m)]


def l1_fragment_multi_native(ep_soa, starts, ends, s_off, group_arr,
                             query_group, query_seq_id, skip_group,
                             lower_tri, split_by_group, window_len,
                             minimum_hits, stage1_filter,
                             stage2_full_scan, sketch_size, cutoff_div,
                             sketch_cutoffs, cluster_len):
    """l1_fragment over every fragment of a query in ONE call
    (l1l2.cpp:l1_fragment_multi). starts/ends concatenate with s_off
    fragment offsets; window_len/minimum_hits/sketch_size are int64
    arrays per fragment. Returns a list (per fragment) of candidate
    lists — None entries mark per-fragment overflow fallbacks — or
    None when the lib is unavailable / the whole call failed."""
    lib = get_l1l2_lib()
    if lib is None:
        return None
    ep_pos, ep_hash, ep_seq, ep_side = ep_soa
    n_frag = len(s_off) - 1
    total = int((ends - starts).sum())
    cap = max(16, total)
    out = tuple(np.empty(cap, np.int64) for _ in range(4))
    counts = np.empty(n_frag, np.int64)
    cut32 = _cut32(sketch_cutoffs)
    m = lib.l1_fragment_multi(
        _ptr(ep_pos), _ptr(ep_hash), _ptr(ep_seq), _ptr(ep_side),
        _ptr(starts), _ptr(ends), _ptr(s_off), n_frag,
        _ptr(group_arr), query_group, query_seq_id,
        int(skip_group), int(lower_tri), int(split_by_group),
        _ptr(window_len), _ptr(minimum_hits), int(stage1_filter),
        int(stage2_full_scan), _ptr(sketch_size), float(cutoff_div),
        _ptr(cut32), len(cut32), cluster_len,
        _ptr(out[0]), _ptr(out[1]), _ptr(out[2]), _ptr(out[3]), cap,
        _ptr(counts))
    if m < 0:
        return None
    o_seq, o_start, o_end, o_inter = out
    res = []
    o = 0
    for f in range(n_frag):
        c = int(counts[f])
        if c < 0:
            res.append(None)
            continue
        res.append([(int(o_seq[o + i]), int(o_start[o + i]),
                     int(o_end[o + i]), int(o_inter[o + i]))
                    for i in range(c)])
        o += c
    return res


def l2_walk_multi_native(soa, cand_seq, range_start, range_end,
                         q_hashes, q_strand, window_len, w):
    """One call per FRAGMENT: the L2 walk over every candidate
    (l1l2.cpp:l2_walk_multi). cand_seq/range_start/range_end are
    parallel int64 arrays. Returns a list (per candidate) of lists of
    6-int tuples, or None when the lib is absent / capacity overflows."""
    lib = get_l1l2_lib()
    if lib is None:
        return None
    mi_hash, mi_wpos, mi_wend, mi_seq, mi_strand = soa
    nc = len(cand_seq)
    cap = max(4096, 64 * nc)
    scr = getattr(_tls, "l2m", None)
    if scr is None or len(scr[0]) < cap * 6 or len(scr[1]) < nc:
        scr = (np.empty(max(cap, 4096) * 6, np.int64),
               np.empty(max(nc, 64), np.int64))
        _tls.l2m = scr
    out, counts = scr
    m = lib.l2_walk_multi(
        _ptr(mi_hash), _ptr(mi_wpos), _ptr(mi_wend), _ptr(mi_seq),
        _ptr(mi_strand), len(mi_hash),
        _ptr(cand_seq), _ptr(range_start), _ptr(range_end), nc,
        _ptr(q_hashes), _ptr(q_strand),
        len(q_hashes), window_len, w,
        _ptr(out), len(out) // 6, _ptr(counts),
    )
    if m < 0:
        return None
    res = []
    o = 0
    for c in range(nc):
        k = int(counts[c])
        rows = out[o * 6:(o + k) * 6].reshape(k, 6)
        res.append([tuple(int(v) for v in row) for row in rows])
        o += k
    return res


# ---------------------------------------------------------------------------
# Native anchor helpers (anchors.cpp) — bit-identical to
# align/segmented.py::_lis_chain (tested)
# ---------------------------------------------------------------------------

_SRC3 = _DIR / "anchors.cpp"
_LIB3 = _DIR / f"_anchors{_SAN}.so"
_lib3 = None
_tried3 = False


def get_anchors_lib():
    global _lib3, _tried3
    if _lib3 is not None or _tried3:
        return _lib3
    _tried3 = True
    if not _LIB3.exists() or _LIB3.stat().st_mtime < _SRC3.stat().st_mtime:
        try:
            _gpp_build(_SRC3, _LIB3)
        except (subprocess.CalledProcessError, FileNotFoundError) as e:
            print(f"[wfmash-tpu] native anchors build failed ({e}); "
                  "using Python fallback", file=sys.stderr)
            return None
    try:
        lib = ctypes.CDLL(str(_LIB3))
        lib.lis_chain.restype = ctypes.c_int64
        lib.lis_chain.argtypes = [
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64)]
        lib.find_anchors_native.restype = ctypes.c_int64
        lib.find_anchors_native.argtypes = [
            ctypes.c_char_p, ctypes.c_int64,
            ctypes.c_char_p, ctypes.c_int64,
            ctypes.c_int, ctypes.c_int, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
        lib.place_short.restype = ctypes.c_int64
        lib.place_short.argtypes = [
            ctypes.c_char_p, ctypes.c_int64,
            ctypes.c_char_p, ctypes.c_int64,
            ctypes.c_int, ctypes.c_int]
        lib.plan_block.restype = ctypes.c_int64
        lib.plan_block.argtypes = [
            ctypes.c_char_p, ctypes.c_int64,
            ctypes.c_char_p, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
        _lib3 = lib
    except OSError:
        _lib3 = None
    return _lib3


def place_short_native(short: bytes, long_: bytes, k: int, max_occ: int):
    """Native diagonal-voting placement (anchors.cpp:place_short).
    Returns the offset, None for no-signal, or NotImplemented when the
    lib is unavailable (caller falls back to the Python spec)."""
    lib = get_anchors_lib()
    if lib is None:
        return NotImplemented
    r = lib.place_short(bytes(short), len(short), bytes(long_),
                        len(long_), k, max_occ)
    return None if r < 0 else int(r)


def find_anchors_native(q: bytes, t: bytes, k: int, max_occ: int,
                        max_pairs: int):
    """Full anchor-chain planning for one block (codes + unique/rare
    matching + LIS + monotone filter); bit-identical to
    align.segmented.find_anchors (tested). Returns (qpos, tpos) int64
    arrays, or None when the native library is unavailable."""
    lib = get_anchors_lib()
    if lib is None:
        return None
    cap = max(16, len(q))
    oq = np.empty(cap, np.int64)
    ot = np.empty(cap, np.int64)
    m = lib.find_anchors_native(bytes(q), len(q), bytes(t), len(t),
                                k, max_occ, max_pairs,
                                oq.ctypes.data, ot.ctypes.data, cap)
    if m < 0:
        return None
    return oq[:m].copy(), ot[:m].copy()


def plan_block_native(q: bytes, t: bytes, seg_target: int, lseg: int,
                      K: int):
    """Full per-block segmentation plan in ONE native call: anchor-k
    ladder + cut picking + oversize-span refinement (anchors.cpp:
    plan_block); bit-identical to align.segmented._plan_bounds
    (tested). Returns (bounds_q, bounds_t) int lists, None for an
    unplannable block, or NotImplemented when the lib is unavailable
    (caller falls back to the Python spec)."""
    lib = get_anchors_lib()
    if lib is None:
        return NotImplemented
    cap = max(64, len(q) // 8)
    while True:
        oq = np.empty(cap, np.int64)
        ot = np.empty(cap, np.int64)
        m = lib.plan_block(bytes(q), len(q), bytes(t), len(t),
                           seg_target, lseg, K,
                           oq.ctypes.data, ot.ctypes.data, cap)
        if m == -1:            # bounds overflow: retry with more room
            cap *= 4
            continue
        if m == 0:
            return None
        return oq[:m].tolist(), ot[:m].tolist()


def lis_chain_native(tpos_sorted: np.ndarray):
    """tpos of anchors pre-lexsorted by (qpos, tpos); returns kept
    indices into the sorted order, or None (Python fallback)."""
    lib = get_anchors_lib()
    if lib is None:
        return None
    t = np.ascontiguousarray(tpos_sorted, np.int64)
    out = np.empty(len(t), np.int64)
    m = lib.lis_chain(
        t.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(t), out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    return out[:m]


# ---------------------------------------------------------------------------
# Native host WFA (wfa.cpp) — bit-identical to align/wfa_vec.py (tested)
# ---------------------------------------------------------------------------

_SRC4 = _DIR / "wfa.cpp"
_LIB4 = _DIR / f"_wfa{_SAN}.so"
_lib4 = None
_tried4 = False


def get_wfa_lib():
    global _lib4, _tried4
    if _lib4 is not None or _tried4:
        return _lib4
    _tried4 = True
    if os.environ.get("WFMASH_TPU_NO_NATIVE"):
        return None
    if not _LIB4.exists() or _LIB4.stat().st_mtime < _SRC4.stat().st_mtime:
        try:
            _gpp_build(_SRC4, _LIB4)
        except (subprocess.CalledProcessError, FileNotFoundError) as e:
            print(f"[wfmash-tpu] native wfa build failed ({e}); "
                  "using Python fallback", file=sys.stderr)
            return None
    try:
        lib = ctypes.CDLL(str(_LIB4))
        lib.wfa_align_native.restype = ctypes.c_int64
        lib.wfa_align_native.argtypes = [
            ctypes.c_char_p, ctypes.c_int64,
            ctypes.c_char_p, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64,
        ]
        vp = ctypes.c_void_p
        lib.wfa_align_batch.restype = ctypes.c_int64
        lib.wfa_align_batch.argtypes = [
            vp, vp, vp, vp, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32,
            vp,
            vp, ctypes.c_int64, vp, vp, ctypes.c_int64,
        ]
        lib.wfa_align_batch_ef.restype = ctypes.c_int64
        lib.wfa_align_batch_ef.argtypes = [
            vp, vp, vp, vp, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32,
            vp, vp, vp, vp,
            vp,
            vp, ctypes.c_int64, vp, vp, ctypes.c_int64,
        ]
        _lib4 = lib
    except OSError:
        _lib4 = None
    return _lib4


class WfaMemoryBudget(MemoryError):
    """The exact full-history WFA would exceed WFMASH_TPU_WFA_MEM_MB
    (default 6144): the caller must reroute to a memory-bounded path
    (segmented / recursive) instead of the Python spec fallback, which
    has the same O(score^2) footprint."""


def wfa_align_batch_native(pieces, p, max_scores=None, ends_free=None):
    """Many small alignments in one native call.
    pieces: list of (query_bytes, target_bytes); ends_free: optional
    parallel list of (tb, te, qb, qe) free spans (None = end-to-end).
    Returns a list of (score, ops) per piece — (None, None) for a piece
    whose per-piece max_scores[i] was exceeded — or None as a whole
    (lib absent / a piece failed; caller dispatches per piece). Raises
    WfaMemoryBudget if any piece exceeds the memory cap."""
    lib = get_wfa_lib()
    if lib is None or not pieces:
        return None
    n = len(pieces)
    qoff = np.zeros(n + 1, np.int64)
    toff = np.zeros(n + 1, np.int64)
    for i, (q, t) in enumerate(pieces):
        qoff[i + 1] = qoff[i] + len(q)
        toff[i + 1] = toff[i] + len(t)
    qbuf = b"".join(bytes(q) for q, _ in pieces)
    tbuf = b"".join(bytes(t) for _, t in pieces)
    cap = int(qoff[-1] + toff[-1]) + 64 * n
    out = np.empty(cap, np.int64)
    counts = np.empty(n, np.int64)
    scores = np.empty(n, np.int64)
    mem_cap = int(float(os.environ.get(
        "WFMASH_TPU_WFA_MEM_MB", "6144")) * 1e6)
    ms_arr = None
    if max_scores is not None:
        ms_arr = np.asarray(
            [-1 if m is None else int(m) for m in max_scores], np.int64)
    if ends_free is not None:
        ef = np.asarray(
            [(0, 0, 0, 0) if e is None else tuple(int(v) for v in e)
             for e in ends_free], np.int64)
        # hold references: _ptr does not keep temporaries alive
        tb_a = np.ascontiguousarray(ef[:, 0])
        te_a = np.ascontiguousarray(ef[:, 1])
        qb_a = np.ascontiguousarray(ef[:, 2])
        qe_a = np.ascontiguousarray(ef[:, 3])
        r = lib.wfa_align_batch_ef(
            qbuf, _ptr(qoff), tbuf, _ptr(toff), n,
            p.mismatch, p.gap_opening1, p.gap_extension1,
            p.gap_opening2, p.gap_extension2,
            _ptr(tb_a), _ptr(te_a), _ptr(qb_a), _ptr(qe_a),
            _ptr(ms_arr) if ms_arr is not None else None,
            _ptr(out), cap, _ptr(counts), _ptr(scores), mem_cap)
    else:
        r = lib.wfa_align_batch(
            qbuf, _ptr(qoff), tbuf, _ptr(toff), n,
            p.mismatch, p.gap_opening1, p.gap_extension1,
            p.gap_opening2, p.gap_extension2,
            _ptr(ms_arr) if ms_arr is not None else None,
            _ptr(out), cap, _ptr(counts), _ptr(scores), mem_cap)
    if r == -4:
        raise WfaMemoryBudget("piece exceeded the history budget")
    if r < 0:
        return None
    # vectorized unpack (a per-element int()/chr() comprehension was
    # ~40% of the call's wall on big batches)
    total = int(counts[:n][counts[:n] > 0].sum()) if n else 0
    vals = out[:total]
    cnts = (vals >> 8).tolist()
    opch = (vals & 0xFF).astype(np.uint8).tobytes().decode("latin-1")
    res = []
    o = 0
    for i in range(n):
        k = int(counts[i])
        if k < 0:                    # per-piece score cap exceeded
            res.append((None, None))
            continue
        res.append((int(scores[i]),
                    list(zip(cnts[o:o + k], opch[o:o + k]))))
        o += k
    return res


_SRC5 = _DIR / "segsolve.cpp"
_LIB5 = _DIR / f"_segsolve{_SAN}.so"
_lib5 = None
_tried5 = False


def get_segsolve_lib():
    global _lib5, _tried5
    if _lib5 is not None or _tried5:
        return _lib5
    _tried5 = True
    if os.environ.get("WFMASH_TPU_NO_NATIVE"):
        return None
    deps = max(_SRC5.stat().st_mtime, _SRC4.stat().st_mtime,
               _SRC3.stat().st_mtime)
    if not _LIB5.exists() or _LIB5.stat().st_mtime < deps:
        try:
            _gpp_build(_SRC5, _LIB5)
        except (subprocess.CalledProcessError, FileNotFoundError) as e:
            print(f"[wfmash-tpu] native segsolve build failed ({e}); "
                  "using Python fallback", file=sys.stderr)
            return None
    try:
        lib = ctypes.CDLL(str(_LIB5))
        lib.segmented_solve.restype = ctypes.c_int64
        lib.segmented_solve.argtypes = [
            ctypes.c_char_p, ctypes.c_int64,
            ctypes.c_char_p, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64]
        vp = ctypes.c_void_p
        lib.host_align_blocks.restype = ctypes.c_int64
        lib.host_align_blocks.argtypes = [
            vp, vp, vp, vp, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64,
            vp, ctypes.c_int64, vp, vp, ctypes.c_int64]
        try:
            lib.segsolve_phase_times.restype = None
            lib.segsolve_phase_times.argtypes = [vp]
        except AttributeError:   # older cached .so without the timers
            pass
        _lib5 = lib
    except OSError:
        _lib5 = None
    return _lib5


def segmented_solve_native(q: bytes, t: bytes, p, seg_target: int,
                           refine_cap: int):
    """The WHOLE segmented host alignment for one block in one native
    call (segsolve.cpp; align.segmented.segmented_host_align is the
    executable spec — bit-identical, tested). Returns merged
    (count, op) runs, None when the block is unplannable (caller stays
    exact), or NotImplemented when the lib is unavailable / the solver
    failed to converge (caller falls back to the Python spec). Raises
    WfaMemoryBudget when a piece exceeds the memory cap."""
    lib = get_segsolve_lib()
    if lib is None:
        return NotImplemented
    mem_cap = int(float(os.environ.get(
        "WFMASH_TPU_WFA_MEM_MB", "6144")) * 1e6)
    cap = len(q) + len(t) + 64
    qb, tb = bytes(q), bytes(t)
    while True:
        out = np.empty(cap, np.int64)
        r = lib.segmented_solve(
            qb, len(q), tb, len(t),
            p.mismatch, p.gap_opening1, p.gap_extension1,
            p.gap_opening2, p.gap_extension2,
            seg_target, refine_cap, out.ctypes.data, cap, mem_cap)
        if r == -2:
            cap *= 4
            continue
        if r == -4:
            raise WfaMemoryBudget("segmented piece exceeded the budget")
        if r == -3:
            return NotImplemented
        if r == 0:
            return None
        vals = out[:r]
        return list(zip(
            (vals >> 8).tolist(),
            (vals & 0xFF).astype(np.uint8).tobytes().decode("latin-1")))


def segsolve_phase_times():
    """Read-and-reset the native engine's per-thread phase timers.
    Returns a dict: exact_s (passing probes = the solve itself),
    probe_fail_s (capped probes that hit the cap), plan_s, place_s,
    piece_s (piece WFAs incl. refine recursion), n_exact, n_seg,
    n_pieces. Diagnostic only (perf report / bench phase table)."""
    lib = get_segsolve_lib()
    if lib is None or not hasattr(lib, "segsolve_phase_times"):
        return {}
    buf = np.zeros(17, np.float64)
    lib.segsolve_phase_times(_ptr(buf))
    keys = ("exact_s", "probe_fail_s", "plan_s", "place_s", "piece_s",
            "n_exact", "n_seg", "n_pieces", "n_diag_fast", "n_capped",
            "piece_bp", "sum_score2", "call_s", "codes_s", "join_s",
            "lis_sort_s", "n_block_memo")
    return dict(zip(keys, buf.tolist()))


def host_align_blocks_native(blocks, p, score_cap: int, min_probe: int,
                             seg_target: int, refine_cap: int):
    """The host engine's whole main-block batch in ONE native call:
    per-block capped probe + segmented reroute + small-block exact
    (segsolve.cpp:host_align_blocks; BudgetedHostEngine.align is the
    per-block spec — byte-identical, tested). blocks: list of
    (query_bytes, target_bytes). Returns a list of (status, runs) with
    status 0 exact / 1 segmented / 2 unplannable / 3 fallback /
    4 memory-budget (runs is None for 2-4), or NotImplemented when the
    lib is unavailable."""
    lib = get_segsolve_lib()
    if lib is None or not blocks:
        return NotImplemented
    n = len(blocks)
    qoff = np.zeros(n + 1, np.int64)
    toff = np.zeros(n + 1, np.int64)
    for i, (q, t) in enumerate(blocks):
        qoff[i + 1] = qoff[i] + len(q)
        toff[i + 1] = toff[i] + len(t)
    qbuf = b"".join(bytes(q) for q, _ in blocks)
    tbuf = b"".join(bytes(t) for _, t in blocks)
    mem_cap = int(float(os.environ.get(
        "WFMASH_TPU_WFA_MEM_MB", "6144")) * 1e6)
    cap = int(qoff[-1] + toff[-1]) + 64 * n
    while True:
        out = np.empty(cap, np.int64)
        counts = np.empty(n, np.int64)
        status = np.empty(n, np.int64)
        r = lib.host_align_blocks(
            qbuf, _ptr(qoff), tbuf, _ptr(toff), n,
            p.mismatch, p.gap_opening1, p.gap_extension1,
            p.gap_opening2, p.gap_extension2,
            score_cap, min_probe, seg_target, refine_cap,
            _ptr(out), cap, _ptr(counts), _ptr(status), mem_cap)
        if r == -2:
            cap *= 4
            continue
        if r < 0:
            return NotImplemented
        break
    total = int(counts[counts > 0].sum()) if n else 0
    vals = out[:total]
    cnts = (vals >> 8).tolist()
    opch = (vals & 0xFF).astype(np.uint8).tobytes().decode("latin-1")
    res = []
    o = 0
    for i in range(n):
        st = int(status[i])
        k = int(counts[i])
        if st in (0, 1):
            res.append((st, list(zip(cnts[o:o + k], opch[o:o + k]))))
            o += k
        else:
            res.append((st, None))
    return res


def wfa_align_ops_native(query: bytes, target: bytes, p, ends_free=None,
                         max_score=None):
    """Native exact WFA. Returns (score, ops), (None, None) when
    max_score is exceeded, or NotImplemented when the native library is
    unavailable (caller falls back to the Python path). Raises
    RuntimeError on convergence failure (same contract as wfa_vec) and
    WfaMemoryBudget when the history would exceed the memory cap."""
    lib = get_wfa_lib()
    if lib is None:
        return NotImplemented
    m, n = len(query), len(target)
    tb = te = qb = qe = 0
    if ends_free is not None:
        tb, te = ends_free.target_begin, ends_free.target_end
        qb, qe = ends_free.query_begin, ends_free.query_end
    cap = m + n + 64
    out = np.empty(cap, np.int64)
    score = ctypes.c_int64(0)
    mem_cap = int(float(os.environ.get(
        "WFMASH_TPU_WFA_MEM_MB", "6144")) * 1e6)
    r = lib.wfa_align_native(
        bytes(query), m, bytes(target), n,
        p.mismatch, p.gap_opening1, p.gap_extension1,
        p.gap_opening2, p.gap_extension2,
        tb, te, qb, qe,
        -1 if max_score is None else int(max_score),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), cap,
        ctypes.byref(score), mem_cap)
    if r == -1:
        return None, None
    if r == -2:
        return NotImplemented          # cap overflow: fall back
    if r == -4:
        raise WfaMemoryBudget(f"{m}x{n} exact history > {mem_cap} bytes")
    if r < 0:
        raise RuntimeError("WFA failed to converge")
    vals = out[:r]
    ops = list(zip(
        (vals >> 8).tolist(),
        (vals & 0xFF).astype(np.uint8).tobytes().decode("latin-1")))
    return int(score.value), ops


# ---------------------------------------------------------------------------
# Tier chunk packing (tierpack.cpp) — byte-identical to align/wfa_seg.py's
# SegmentSolver.pack_chunk_py (tested)
# ---------------------------------------------------------------------------

_SRC6 = _DIR / "tierpack.cpp"
_LIB6 = _DIR / f"_tierpack{_SAN}.so"
_lib6 = None
_tried6 = False


def get_tierpack_lib():
    global _lib6, _tried6
    if _lib6 is not None or _tried6:
        return _lib6
    _tried6 = True
    if not _LIB6.exists() or _LIB6.stat().st_mtime < _SRC6.stat().st_mtime:
        try:
            _gpp_build(_SRC6, _LIB6)
        except (subprocess.CalledProcessError, FileNotFoundError) as e:
            print(f"[wfmash-tpu] native tierpack build failed ({e}); "
                  "using Python fallback", file=sys.stderr)
            return None
    try:
        lib = ctypes.CDLL(str(_LIB6))
        vp, i64 = ctypes.c_void_p, ctypes.c_int64
        lib.pack_tier_chunk.restype = i64
        lib.pack_tier_chunk.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, vp, i64, i64, i64, i64, i64,
            vp, vp, vp, vp, vp]
        _lib6 = lib
    except OSError:
        _lib6 = None
    return _lib6


def pack_tier_chunk_native(qcat: bytes, tcat: bytes, jobs: np.ndarray,
                           B: int, L: int, K: int, smax: int,
                           sym_lut: np.ndarray, gap: np.ndarray):
    """A tier chunk's fused upload buffer in ONE native call, which
    releases the GIL (tierpack.cpp). jobs: (nj, 7) int64 rows (m, n, tb,
    qb, te, qe, cap; 0 for no span and no cap); qcat/tcat: the jobs'
    sequences joined in order; gap: gap_cost(0..K/2) int64. Returns
    (buf (B, L + 64) u8, cert_b (B) i64, cert_always (B) bool), None when
    the chunk gives up (more than 14 distinct bytes), or NotImplemented
    when the lib is unavailable or a job lies outside what it packs
    (caller falls back to the Python spec)."""
    lib = get_tierpack_lib()
    if lib is None:
        return NotImplemented
    jobs = np.ascontiguousarray(jobs, np.int64)
    lut = np.ascontiguousarray(sym_lut, np.uint8)
    gap = np.ascontiguousarray(gap, np.int64)
    if (jobs.ndim != 2 or jobs.shape[1] != 7 or len(jobs) > B
            or (jobs[:, :2] < 0).any()
            or len(qcat) != jobs[:, 0].sum()
            or len(tcat) != jobs[:, 1].sum()
            or lut.shape != (256,) or gap.shape != (K // 2 + 1,)
            or L <= 0 or L % 2):
        raise ValueError("pack_tier_chunk_native: inconsistent chunk "
                         f"(jobs {jobs.shape}, B={B}, L={L}, K={K})")
    buf = np.empty((B, L + 64), np.uint8)
    cert_b = np.empty(B, np.int64)
    cert_always = np.empty(B, bool)
    r = lib.pack_tier_chunk(
        qcat, tcat, jobs.ctypes.data, len(jobs), B, L, K, smax,
        lut.ctypes.data, gap.ctypes.data, buf.ctypes.data,
        cert_b.ctypes.data, cert_always.ctypes.data)
    if r == 1:
        return None
    if r != 0:
        return NotImplemented
    return buf, cert_b, cert_always
