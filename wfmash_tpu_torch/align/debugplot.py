"""Debug wavefront/segmentation plots: -G/--tsv and -u/--prefix-png.

Reference: parse_args.hpp:142-145 (WFA_PNG_TSV_TIMING debug build):
`-G` dumps the wflambda guiding wavefront's (v, h, info) cells per
alignment, `-u` renders them as a PNG, `-z` caps the plot size. This
build's analogue of that wavefront is the anchor-chain
segmentation plan (align/segmented.py — the TPU-native wflambda), so
the dumped cells are the plan's span boundaries with the same
info-code idea:

  0  gap run / unanchorable span (no homology signal)
  1  structural-gap placement (skew pinned by diagonal voting)
  2  anchored piece (solved end-to-end)
"""

from __future__ import annotations

import numpy as np

from .segmented import _plan_bounds


def plan_rows(q: bytes, t: bytes, seg_target: int = 256):
    """(v, h, info) span-start rows for one block's segmentation plan
    (+ the terminal corner)."""
    bounds = _plan_bounds(q, t, seg_target, 512, 256)
    if bounds is None:
        return [(0, 0, 0), (len(t), len(q), 0)]
    bq, bt = bounds
    rows = []
    for i in range(len(bq) - 1):
        dq = bq[i + 1] - bq[i]
        dt = bt[i + 1] - bt[i]
        if dq == 0 or dt == 0:
            info = 0
        elif abs(dq - dt) > 400:
            info = 1
        else:
            info = 2
        rows.append((int(bt[i]), int(bq[i]), info))
    rows.append((int(bt[-1]), int(bq[-1]), 2))
    return rows


def write_plan_tsv(path: str, job, rows) -> None:
    """Header comments match the reference's out_tsv preamble
    (wflign.cpp:1050-1057); info codes documented above."""
    with open(path, "w") as fh:
        fh.write(f"# query_name={job.query_name}\n")
        fh.write(f"# query_start={job.query_offset}\n")
        fh.write(f"# query_end={job.query_offset + job.query_length}\n")
        fh.write(f"# target_name={job.target_name}\n")
        fh.write(f"# target_start={job.target_offset}\n")
        fh.write(f"# target_end={job.target_offset + job.target_length}\n")
        fh.write("# info: 0) gap run / unanchorable; 1) structural-gap"
                 " placement; 2) anchored piece\n")
        fh.write("v\th\tinfo\n")
        for v, h, info in rows:
            fh.write(f"{v}\t{h}\t{info}\n")


def write_plan_png(path: str, rows, qlen: int, tlen: int,
                   max_size: int = 1500) -> None:
    """Render the plan trajectory: darker = lower info code."""
    from ..utils.png import write_gray_png

    scale = max(1.0, max(qlen, tlen) / float(max_size))
    w = max(2, int(qlen / scale) + 1)
    h = max(2, int(tlen / scale) + 1)
    img = np.zeros((h, w), np.uint8)
    shade = {0: 80, 1: 160, 2: 255}
    pts = list(rows)
    for (v0, h0, info), (v1, h1, _) in zip(pts, pts[1:]):
        # draw the span as a line of sample points
        n = max(2, int(max(abs(v1 - v0), abs(h1 - h0)) / scale) + 1)
        vv = np.linspace(v0, v1, n) / scale
        hh = np.linspace(h0, h1, n) / scale
        img[np.clip(vv.astype(int), 0, h - 1),
            np.clip(hh.astype(int), 0, w - 1)] = shade[info]
    write_gray_png(path, img)
