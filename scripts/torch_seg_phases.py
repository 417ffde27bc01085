"""Where a chunk of the segment kernel (csrc/seg_wfa.cu) spends its time
on one GPU: set-up and forward sweep, backtrace, run compaction.

    python3 scripts/torch_seg_phases.py [--tiers 1,2,3,4,5]

The committed kernel carries no timers. This script writes a copy of its
source with three clock64() reads per block (after the sweep, after the
backtrace, at the end) into a temporary directory, builds that copy with
the port's nvcc flags, and launches it on chip_smoke.py's chunk of each
tier (the same generator and seed as its `--phases tiers` run). Thread 0
of a block stores its three spans, in SM clock cycles, in the first
entries of the block's `runs_full` row, which no CIGAR of these chunks
reaches. Printed per tier: each phase's share of the block-cycles summed
over the chunk's blocks, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# (text to find in the source, text put in its place), each found once
EDITS = (
    ("  const int l = threadIdx.x;\n",
     "  const int l = threadIdx.x;\n  const long long c0 = clock64();\n"),
    ("  // ---- backtrace (",
     "  const long long c1 = clock64();\n  // ---- backtrace ("),
    ("  // ---- compact the used runs",
     "  const long long c2 = clock64();\n  // ---- compact the used runs"),
    ("    orow[NTERM + j] = (int16_t)runs[idx];\n  }\n}\n",
     "    orow[NTERM + j] = (int16_t)runs[idx];\n  }\n  __syncthreads();\n"
     "  if (l == 0) {\n    runs[0] = (int)(c1 - c0);\n"
     "    runs[1] = (int)(c2 - c1);\n"
     "    runs[2] = (int)(clock64() - c2);\n  }\n}\n"),
)


def timed_library(tmp):
    from wfmash_tpu_torch import _build

    src = open(os.path.join(ROOT, "wfmash_tpu_torch", "csrc",
                            "seg_wfa.cu")).read()
    for old, new in EDITS:
        if src.count(old) != 1:
            raise RuntimeError(f"marker not found once: {old!r}")
        src = src.replace(old, new)
    cu = os.path.join(tmp, "seg_wfa_timed.cu")
    so = os.path.join(tmp, "libseg_wfa_timed.so")
    with open(cu, "w") as fh:
        fh.write(src)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", so, cu],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(so)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.seg_wfa_launch.restype = ci
    lib.seg_wfa_launch.argtypes = [vp, ci, ci, ci, ci, ci, ci, ci, ci, ci,
                                   ci, vp, vp, vp, vp]
    return lib


def main(argv=None) -> int:
    import torch

    import chip_smoke as cs
    from wfmash_tpu_torch.align import wfa_seg
    from wfmash_tpu_torch.align.wfa_np import Penalties

    ap = argparse.ArgumentParser()
    ap.add_argument("--tiers", default="1,2,3,4,5")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch sees no CUDA device", file=sys.stderr)
        return 1
    want = {int(t) for t in args.tiers.split(",")}
    dev = torch.device("cuda")
    p = Penalties(5, 8, 2, 24, 1)
    rng = np.random.default_rng(cs.SEED)
    print(f"[card] {cs.card_line()}", flush=True)
    solver = wfa_seg.TieredSegmentSolver(p, dev)
    with tempfile.TemporaryDirectory() as tmp:
        lib = timed_library(tmp)
        for no, tier in enumerate(solver.tiers):
            jobs, caps = cs.tier_jobs(rng, no)
            if no + 1 not in want:
                continue
            idxs = [i for i, (q, t, ef) in enumerate(jobs)
                    if tier.accepts(len(q), len(t), ef)][:tier.max_call]
            buf_np, _ = tier.pack_chunk(idxs, jobs, caps)
            buf = torch.from_numpy(buf_np).to(dev)
            B = buf.shape[0]
            runs = torch.empty((B, tier.maxr), dtype=torch.int32, device=dev)
            out16 = torch.empty((B, 16 + 128), dtype=torch.int16, device=dev)
            hist = torch.empty((B, 5, tier.smax, tier.K), dtype=torch.int16,
                               device=dev)
            for _ in range(2):          # the second launch is the one read
                err = lib.seg_wfa_launch(
                    buf.data_ptr(), B, tier.lseg, tier.K, tier.smax,
                    tier.maxr, p.mismatch, p.gap_opening1, p.gap_extension1,
                    p.gap_opening2, p.gap_extension2, hist.data_ptr(),
                    runs.data_ptr(), out16.data_ptr(),
                    torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"launch failed: CUDA error {err}")
                torch.cuda.synchronize()
            want_out = wfa_seg.run_seg(buf, penalties=p, K=tier.K,
                                       smax=tier.smax, maxr=tier.maxr)[1]
            if not torch.equal(out16, want_out):
                raise RuntimeError("the timed copy's out16 differs from the "
                                   "kernel's")
            cyc = runs[:, :3].cpu().numpy().astype(np.int64)
            tot = cyc.sum()
            sweep, bt, tail = (cyc[:, j].sum() / tot for j in range(3))
            print(f"[phases t{no + 1}] K={tier.K} smax={tier.smax} rows={B}: "
                  f"set-up and sweep {100 * sweep:.1f}%, backtrace "
                  f"{100 * bt:.1f}%, compaction {100 * tail:.1f}% of "
                  f"{tot / B:.0f} cycles a block (backtrace at most "
                  f"{100 * (cyc[:, 1] / cyc.sum(1)).max():.1f}% of a block)",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
