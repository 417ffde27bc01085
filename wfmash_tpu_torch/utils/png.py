"""Minimal grayscale PNG writer (pure stdlib: zlib + struct).

Debug-output helper for the -u/--prefix-png wavefront plots
(reference: parse_args.hpp:144, a WFA_PNG_TSV_TIMING debug build
option using libpng; this build keeps the dependency surface at zero).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def write_gray_png(path: str, img: np.ndarray) -> None:
    """img: (H, W) uint8 grayscale."""
    img = np.ascontiguousarray(img, np.uint8)
    h, w = img.shape

    def chunk(tag: bytes, payload: bytes) -> bytes:
        return (struct.pack(">I", len(payload)) + tag + payload
                + struct.pack(">I", zlib.crc32(tag + payload)))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0)  # 8-bit gray
    # filter byte 0 per scanline
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))
    with open(path, "wb") as fh:
        fh.write(b"\x89PNG\r\n\x1a\n")
        fh.write(chunk(b"IHDR", ihdr))
        fh.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        fh.write(chunk(b"IEND", b""))
