"""Command line of the port: `python -m wfmash_tpu_torch target.fa [query.fa]
[flags]`, the flags of wfmash_tpu's CLI.

Mapping runs the reference's native host stages (its device stages are
not ported); alignment runs the port's engine on the device named by
WFMASH_TPU_TORCH_DEVICE (default cuda). The device L1 stage stays off:
__main__ sets WFMASH_TPU_DEVICE_L1=0, and in-process callers set it too.
"""

from __future__ import annotations

import os
import sys

from wfmash_tpu.cli import parse_args

from .device import resolve


def main(argv=None) -> int:
    try:
        return _main(argv)
    except MemoryError:
        print(
            "[wfmash] ERROR: memory allocation failed.\n"
            "[wfmash] Try reducing memory usage:\n"
            "[wfmash]   * reduce the target batch size (-b), e.g. -b 1g\n"
            "[wfmash]   * reduce the number of threads (-t)\n"
            "[wfmash]   * map in subsets (-R/-Q lists) and merge PAFs",
            file=sys.stderr,
        )
        return 1


def _main(argv=None) -> int:
    mp, ap, approx_mapping, remapping = parse_args(argv)
    try:
        device = resolve()
    except RuntimeError as e:
        print(f"[wfmash] ERROR: {e}", file=sys.stderr)
        return 1

    if mp.auto_pct_identity:
        from wfmash_tpu.map.ani import estimate_identity_for_groups

        ani = estimate_identity_for_groups(mp)
        if ani is not None:
            mp.percentage_identity = ani
            if not mp.sketch_size_manually_set:
                md = 1.0 - mp.percentage_identity
                dens = 0.02 * (1.0 + md / 0.1)
                mp.sketch_size = int(dens * (mp.window_length - mp.kmer_size))

    if mp.use_external_seeds:
        from wfmash_tpu.map.external import process_external_seeds

        process_external_seeds(mp, sys.stdout)
        return 0

    from wfmash_tpu.runner import run_mapping

    if approx_mapping:
        run_mapping(mp, sys.stdout)
        return 0

    # full map + align pipeline; the handoff PAF goes through the temp
    # registry so -B places it and -Z preserves it
    from wfmash_tpu.utils import tempfiles

    if remapping:
        paf_path = ap.mashmap_paf_file
    else:
        paf_path = tempfiles.create(suffix=".paf")
        with open(paf_path, "w") as fh:
            run_mapping(mp, fh)
        ap.mashmap_paf_file = paf_path
        if tempfiles.keep_temp():
            print(f"[wfmash] keeping temp mapping PAF: {paf_path}",
                  file=sys.stderr)

    from .align import wfa_seg
    from .align.engine import run_alignment

    run_alignment(ap, sys.stdout, device)
    if os.environ.get("WFMASH_TPU_PERF"):
        print(f"[wfmash::perf] seg_wfa kernel launches = {wfa_seg.LAUNCHES}",
              file=sys.stderr)
    return 0
