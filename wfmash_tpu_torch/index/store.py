"""Binary index persistence (-W / -I feature parity).

Byte-compatible with the reference's index format (winSketch.hpp:554-979):

  per subset:
    header:  magic 0xDEADBEEFCAFEBABE (u64), batch_idx (u64),
             total_batches (u64), batch_size (i64), num_sequences (u64),
             [name_len (u64) + name bytes]*, id-mapping dump
             (count u64, [name_len u64 + name + seq_id i32]*)
    params:  window_length (i64), sketch_size (i32), kmer_size (i32)
    sketch:  count (u64) + raw MinmerInfo records
             (hash u64, wpos i64, wpos_end i64, seq_id i32, strand i16,
              2 pad bytes -> 32 bytes, little-endian)
    posList: key count (u64), per key: hash (u64), count (u64) +
             raw IntervalPoint records (pos i64, hash u64, seq_id i32,
             side i8, 3 pad bytes -> 24 bytes)

Multiple subsets are appended back to back. We write posList keys in
ascending hash order (the reference's hash-map iteration order is
unspecified); readers accept any order.
"""

from __future__ import annotations

import struct

import numpy as np

MAGIC = 0xDEADBEEFCAFEBABE

MINMER_DISK_DTYPE = np.dtype(
    [
        ("hash", "<u8"),
        ("wpos", "<i8"),
        ("wpos_end", "<i8"),
        ("seq_id", "<i4"),
        ("strand", "<i2"),
        ("_pad", "V2"),
    ]
)

IP_DISK_DTYPE = np.dtype(
    [
        ("pos", "<i8"),
        ("hash", "<u8"),
        ("seq_id", "<i4"),
        ("side", "<i1"),
        ("_pad", "V3"),
    ]
)


def write_subset_index(
    fh,
    index,               # MinmerIndex
    target_names: list[str],
    id_mapping: dict[str, int],
    params,               # MapParams
    batch_idx: int,
    total_batches: int,
) -> None:
    fh.write(struct.pack("<QQQq", MAGIC, batch_idx, total_batches,
                         params.index_by_size))
    fh.write(struct.pack("<Q", len(target_names)))
    for name in target_names:
        b = name.encode()
        fh.write(struct.pack("<Q", len(b)))
        fh.write(b)
    fh.write(struct.pack("<Q", len(id_mapping)))
    for name, sid in id_mapping.items():
        b = name.encode()
        fh.write(struct.pack("<Q", len(b)))
        fh.write(b)
        fh.write(struct.pack("<i", sid))
    fh.write(struct.pack("<qii", params.window_length, params.sketch_size,
                         params.kmer_size))

    mi = index.minmer_index
    disk = np.zeros(len(mi), dtype=MINMER_DISK_DTYPE)
    for f in ("hash", "wpos", "wpos_end", "seq_id", "strand"):
        disk[f] = mi[f]
    fh.write(struct.pack("<Q", len(disk)))
    fh.write(disk.tobytes())

    uh = index.unique_hashes
    offs = index.endpoint_offsets
    eps = index.endpoints
    fh.write(struct.pack("<Q", len(uh)))
    for i in range(len(uh)):
        lo, hi = int(offs[i]), int(offs[i + 1])
        fh.write(struct.pack("<QQ", int(uh[i]), hi - lo))
        chunk = np.zeros(hi - lo, dtype=IP_DISK_DTYPE)
        for f in ("pos", "hash", "seq_id", "side"):
            chunk[f] = eps[f][lo:hi]
        fh.write(chunk.tobytes())


def read_subset_index(fh, params):
    """Read one subset; returns (MinmerIndex, target_names, id_mapping)
    or None at EOF."""
    from .build import MinmerIndex
    from ..sketch.winnow import RECORD_DTYPE
    from .build import ENDPOINT_DTYPE

    head = fh.read(8)
    if len(head) < 8:
        return None
    (magic,) = struct.unpack("<Q", head)
    if magic != MAGIC:
        raise ValueError("invalid index file format (wrong magic number)")
    batch_idx, total_batches, batch_size = struct.unpack("<QQq", fh.read(24))
    (n_names,) = struct.unpack("<Q", fh.read(8))
    target_names = []
    for _ in range(n_names):
        (ln,) = struct.unpack("<Q", fh.read(8))
        target_names.append(fh.read(ln).decode())
    (n_map,) = struct.unpack("<Q", fh.read(8))
    id_mapping = {}
    for _ in range(n_map):
        (ln,) = struct.unpack("<Q", fh.read(8))
        name = fh.read(ln).decode()
        (sid,) = struct.unpack("<i", fh.read(4))
        id_mapping[name] = sid
    w, s, k = struct.unpack("<qii", fh.read(16))
    if (w, s, k) != (params.window_length, params.sketch_size, params.kmer_size):
        raise ValueError(
            f"index parameters (w={w}, s={s}, k={k}) do not match the "
            f"current run (w={params.window_length}, s={params.sketch_size}, "
            f"k={params.kmer_size})"
        )

    (n_mi,) = struct.unpack("<Q", fh.read(8))
    disk = np.frombuffer(fh.read(n_mi * MINMER_DISK_DTYPE.itemsize),
                         dtype=MINMER_DISK_DTYPE)
    mi = np.zeros(n_mi, dtype=RECORD_DTYPE)
    for f in ("hash", "wpos", "wpos_end", "seq_id", "strand"):
        mi[f] = disk[f]

    (n_keys,) = struct.unpack("<Q", fh.read(8))
    hashes = []
    chunks = []
    for _ in range(n_keys):
        h, cnt = struct.unpack("<QQ", fh.read(16))
        raw = np.frombuffer(fh.read(cnt * IP_DISK_DTYPE.itemsize),
                            dtype=IP_DISK_DTYPE)
        hashes.append((h, raw))
    hashes.sort(key=lambda x: x[0])
    uh = np.array([h for h, _ in hashes], dtype=np.uint64)
    offsets = np.zeros(len(hashes) + 1, dtype=np.int64)
    eps_parts = []
    for i, (h, raw) in enumerate(hashes):
        offsets[i + 1] = offsets[i] + len(raw)
        part = np.zeros(len(raw), dtype=ENDPOINT_DTYPE)
        for f in ("pos", "hash", "seq_id", "side"):
            part[f] = raw[f]
        eps_parts.append(part)
    eps = (
        np.concatenate(eps_parts) if eps_parts
        else np.empty(0, dtype=ENDPOINT_DTYPE)
    )

    idx = MinmerIndex(
        minmer_index=mi,
        unique_hashes=uh,
        endpoint_offsets=offsets,
        endpoints=eps,
        hg_numerator=params.hg_numerator,
    )
    return idx, target_names, id_mapping
