"""Whole sequences from a plain FASTA file through its .fai."""

from __future__ import annotations

import numpy as np

_UPPER = np.arange(256, dtype=np.uint8)
_UPPER[97:123] -= 32
_COMP = np.zeros(256, np.uint8)
for _a, _b in zip(b"ACGTN", b"TGCAN"):
    _COMP[_a] = _b


def read_fai(path: str) -> dict[str, tuple[int, int, int, int]]:
    out = {}
    with open(path + ".fai") as fh:
        for line in fh:
            name, n, off, bases, width = line.split("\t")[:5]
            out[name] = (int(n), int(off), int(bases), int(width))
    return out


def read_sequences(path: str, names=None) -> dict[str, np.ndarray]:
    """name -> upper-case uint8 bases, for `names` (every sequence when
    None)."""
    fai = read_fai(path)
    out = {}
    with open(path, "rb") as fh:
        for name in (fai if names is None else names):
            n, off, bases, width = fai[name]
            lines = -(-n // bases)
            fh.seek(off)
            raw = fh.read(n + lines * (width - bases))
            seq = np.frombuffer(raw.replace(b"\n", b"").replace(b"\r", b""),
                                np.uint8)[:n]
            if len(seq) != n:
                raise ValueError(f"{path}: {name} has {len(seq)} bases, "
                                 f".fai says {n}")
            out[name] = _UPPER[seq]
    return out


def reverse_complement(seq: np.ndarray) -> np.ndarray:
    return _COMP[seq[::-1]]
