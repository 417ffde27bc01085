"""FASTA access via .fai indexes (plain, gzip, or BGZF files).

Host-side equivalent of wfmash's faigz wrapper over htslib faidx
(reference: src/common/faigz.h) and seqiter (src/common/seqiter.hpp):

* metadata comes from the ``.fai`` index (name, length, offset, linebases,
  linewidth) — required, as in the reference;
* `fetch(name, start, end)` returns bases with an INCLUSIVE end coordinate,
  matching ``faidx_reader_fetch_seq`` semantics (faigz.h; clamps end to the
  sequence length);
* BGZF inputs get true virtual-offset random access (faigz.h/.gzi
  semantics): the block index comes from the ``.gzi`` file when present
  or a one-time header scan otherwise, and fetches decompress ONLY the
  touched 64 KB blocks through a bounded LRU cache — peak memory is
  independent of genome size. Plain files are mmap'd (shared, read-only
  across fork children). Non-BGZF gzip (no block structure) is
  stream-decompressed once into an unlinked temp file and mmap'd, so
  residency stays page-cache-managed instead of pinning the genome in
  RAM.

Sequences are served as raw bytes (no normalization); uppercase + non-ACGT→N
normalization happens in the sketching layer exactly where the reference does
it (commonFunc.hpp:132-142).
"""

from __future__ import annotations

import gzip
import mmap
import os
import struct
import zlib
from collections import OrderedDict
from dataclasses import dataclass
from threading import Lock


@dataclass(frozen=True)
class FaiRecord:
    name: str
    length: int
    offset: int      # byte offset of first base in the (uncompressed) FASTA
    linebases: int   # bases per line
    linewidth: int   # bytes per line including newline(s)


def read_fai(path: str) -> list[FaiRecord]:
    records = []
    with open(path, "rt") as fh:
        for line in fh:
            if not line.strip():
                continue
            parts = line.rstrip("\n").split("\t")
            records.append(
                FaiRecord(
                    name=parts[0],
                    length=int(parts[1]),
                    offset=int(parts[2]),
                    linebases=int(parts[3]),
                    linewidth=int(parts[4]),
                )
            )
    return records


def _is_bgzf_header(head: bytes) -> bool:
    """BGZF = gzip with FEXTRA and a BC subfield (samtools spec)."""
    return (len(head) >= 18 and head[:2] == b"\x1f\x8b"
            and head[2] == 8 and (head[3] & 4) != 0)


def _read_gzi(path: str) -> list[tuple[int, int]] | None:
    """Parse a .gzi index: [(compressed_off, uncompressed_off)] for each
    block AFTER the first (htslib format: u64 count, then u64 pairs).
    Returns the full block table including the implicit (0, 0) entry."""
    try:
        with open(path, "rb") as fh:
            raw = fh.read()
    except OSError:
        return None
    if len(raw) < 8:
        return None
    (n,) = struct.unpack_from("<Q", raw, 0)
    if len(raw) < 8 + 16 * n:
        return None
    out = [(0, 0)]
    for i in range(n):
        c, u = struct.unpack_from("<QQ", raw, 8 + 16 * i)
        out.append((int(c), int(u)))
    return out


def _scan_bgzf_blocks(path: str) -> list[tuple[int, int]] | None:
    """One-time header scan building the (coffset, uoffset) block table
    for a BGZF file without a .gzi (reads only the 18-byte header and
    4-byte ISIZE of each ~64 KB block)."""
    blocks = []
    coff = uoff = 0
    size = os.path.getsize(path)
    with open(path, "rb") as fh:
        while coff < size:
            fh.seek(coff)
            head = fh.read(18)
            if len(head) < 18 or not _is_bgzf_header(head):
                return None
            xlen = struct.unpack_from("<H", head, 10)[0]
            extra = head[12:18]
            if xlen > 6:
                extra += fh.read(xlen - 6)
            # find the BC subfield
            bsize = None
            p = 0
            while p + 4 <= len(extra):
                si1, si2, slen = extra[p], extra[p + 1], struct.unpack_from(
                    "<H", extra, p + 2)[0]
                if si1 == 66 and si2 == 67 and slen == 2:
                    bsize = struct.unpack_from("<H", extra, p + 4)[0] + 1
                    break
                p += 4 + slen
            if bsize is None:
                return None
            fh.seek(coff + bsize - 4)
            isize = struct.unpack("<I", fh.read(4))[0]
            blocks.append((coff, uoff))
            coff += bsize
            uoff += isize
    return blocks


class _BgzfData:
    """Virtual-offset random access into a BGZF file: per-fetch, only
    the touched blocks are read and inflated, via a bounded LRU block
    cache (faigz.h semantics: shared metadata + per-process readers;
    the file handle is reopened after fork)."""

    CACHE_BLOCKS = 512          # x ~64 KB = ~32 MB bound per process

    def __init__(self, path: str, blocks: list[tuple[int, int]],
                 usize_hint: int | None = None):
        self.path = path
        self.coffs = [b[0] for b in blocks]
        self.uoffs = [b[1] for b in blocks]
        self.csize = os.path.getsize(path)
        self._cache: OrderedDict[int, bytes] = OrderedDict()
        self._fh = None
        self._fh_pid = -1
        self._lock = Lock()

    def _handle(self):
        pid = os.getpid()
        if self._fh is None or self._fh_pid != pid:
            self._fh = open(self.path, "rb")
            self._fh_pid = pid
        return self._fh

    def _block(self, i: int) -> bytes:
        got = self._cache.get(i)
        if got is not None:
            self._cache.move_to_end(i)
            return got
        fh = self._handle()
        c0 = self.coffs[i]
        c1 = self.coffs[i + 1] if i + 1 < len(self.coffs) else self.csize
        fh.seek(c0)
        raw = fh.read(c1 - c0)
        data = zlib.decompress(raw, wbits=31)
        self._cache[i] = data
        if len(self._cache) > self.CACHE_BLOCKS:
            self._cache.popitem(last=False)
        return data

    def range(self, lo: int, hi: int) -> bytes:
        """Uncompressed bytes [lo, hi) across block boundaries."""
        if hi <= lo:
            return b""
        import bisect

        i = bisect.bisect_right(self.uoffs, lo) - 1
        out = bytearray()
        pos = lo
        with self._lock:
            while pos < hi and i < len(self.uoffs):
                base = self.uoffs[i]
                blk = self._block(i)
                a = pos - base
                b = min(hi - base, len(blk))
                if a < len(blk):
                    out += blk[a:b]
                    pos = base + b
                i += 1
                if i < len(self.uoffs) and self.uoffs[i] > pos:
                    break           # gap — corrupt index
        return bytes(out)


class FastaReader:
    """Random access to an indexed FASTA file (thread-safe, lazily loaded)."""

    def __init__(self, path: str):
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        fai_path = path + ".fai"
        if not os.path.exists(fai_path):
            raise FileNotFoundError(
                f"FASTA index not found: {fai_path} (run `samtools faidx`)"
            )
        self.path = path
        self.records = read_fai(fai_path)
        self._by_name = {r.name: r for r in self.records}
        self._data = None          # bytes or mmap (gzip temp spool)
        self._gzip_tmp = None
        self._bgzf: _BgzfData | None = None
        self._mmap = None
        self._mmap_pid = -1
        self._kind: str | None = None
        self._lock = Lock()

    # -- metadata ----------------------------------------------------------
    def __contains__(self, name: str) -> bool:
        return name in self._by_name

    @property
    def names(self) -> list[str]:
        return [r.name for r in self.records]

    def seq_len(self, name: str) -> int:
        return self._by_name[name].length

    # -- data --------------------------------------------------------------
    def _init_backend(self) -> None:
        with open(self.path, "rb") as fh:
            head = fh.read(18)
        if head[:2] == b"\x1f\x8b":
            if _is_bgzf_header(head):
                blocks = _read_gzi(self.path + ".gzi") \
                    or _scan_bgzf_blocks(self.path)
            else:
                blocks = None
            if blocks:
                self._bgzf = _BgzfData(self.path, blocks)
                self._kind = "bgzf"
            else:
                # plain (non-BGZF) gzip has no random-access structure:
                # stream-decompress ONCE into an unlinked temp file and
                # mmap it — residency is page-cache-managed instead of
                # pinning the whole genome in RAM (faigz requires BGZF
                # for this case outright; we degrade gracefully)
                import tempfile

                tmp = tempfile.TemporaryFile(
                    prefix="wfmash-tpu-gunzip-")
                with gzip.open(self.path, "rb") as src:
                    while True:
                        chunk = src.read(1 << 22)
                        if not chunk:
                            break
                        tmp.write(chunk)
                tmp.flush()
                self._gzip_tmp = tmp       # keep fd alive for the mmap
                self._data = mmap.mmap(tmp.fileno(), 0,
                                       access=mmap.ACCESS_READ)
                self._kind = "gzip"
        else:
            self._kind = "plain"

    def _range(self, lo: int, hi: int) -> bytes:
        """Uncompressed file bytes [lo, hi)."""
        if self._kind is None:
            with self._lock:
                if self._kind is None:
                    self._init_backend()
        if self._kind == "bgzf":
            return self._bgzf.range(lo, hi)
        if self._kind == "gzip":
            return self._data[lo:hi]
        # plain: per-process mmap (read-only, shared pages across forks)
        pid = os.getpid()
        if self._mmap is None or self._mmap_pid != pid:
            with open(self.path, "rb") as fh:
                self._mmap = mmap.mmap(fh.fileno(), 0,
                                       access=mmap.ACCESS_READ)
            self._mmap_pid = pid
        return self._mmap[lo:hi]

    def fetch(self, name: str, start: int = 0, end: int | None = None) -> bytes:
        """Fetch bases [start, end] (0-based, INCLUSIVE end, faigz semantics).

        ``end=None`` fetches to the end of the sequence. Out-of-range
        coordinates are clamped, as htslib does.
        """
        rec = self._by_name[name]
        if end is None or end >= rec.length:
            end = rec.length - 1
        start = max(0, start)
        if end < start:
            return b""
        lb, lw = rec.linebases, rec.linewidth
        first_line = start // lb
        last_line = end // lb
        lo = rec.offset + first_line * lw + (start % lb)
        hi = rec.offset + last_line * lw + (end % lb) + 1
        raw = self._range(lo, hi)
        if first_line == last_line:
            return raw
        # strip line terminators (lw - lb trailing bytes per line);
        # terminator bytes never occur inside sequence data, so a
        # C-level replace handles the whole buffer (the per-line Python
        # loop was ~40% of the align loop's fetch cost)
        take = lb - (start % lb)
        nterm = lw - lb
        term = raw[take:take + nterm]
        if 0 < nterm <= 2 and term in (b"\n", b"\r\n", b"\r"):
            return raw.replace(term, b"")
        out = bytearray()
        # first partial line
        out += raw[:take]
        pos = take + nterm
        full_needed = last_line - first_line - 1
        for _ in range(full_needed):
            out += raw[pos : pos + lb]
            pos += lw
        out += raw[pos : pos + (end % lb) + 1]
        return bytes(out)

    def iter_seqs(self, subset: list[str] | None = None):
        """Yield (name, bytes) for each sequence (optionally restricted),
        in file (.fai) order — matches seqiter::for_each_seq_in_file."""
        allowed = set(subset) if subset is not None else None
        for rec in self.records:
            if allowed is not None and rec.name not in allowed:
                continue
            yield rec.name, self.fetch(rec.name)
