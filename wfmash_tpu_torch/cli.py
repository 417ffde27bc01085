"""Command line of the port: `python -m wfmash_tpu_torch target.fa [query.fa]
[flags]`, the flag surface and defaults of wfmash (reference:
src/interface/parse_args.hpp:26-927).

Mapping runs the native host stages; alignment runs the port's engine on
the device named by WFMASH_TPU_TORCH_DEVICE (default cuda).
"""

from __future__ import annotations

import argparse
import os
import re
import sys

from . import WFMASH_COMPAT_VERSION, __version__
from .params import AlignParams, FILTER_MAP, FILTER_NONE, FILTER_ONETOONE, MapParams, fixed
from .device import resolve
from .utils.units import handy_parameter

U32_MAX = 0xFFFFFFFF
U64_MAX = 0xFFFFFFFFFFFFFFFF
I64_MAX = 0x7FFFFFFFFFFFFFFF


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="wfmash-tpu",
        description="whole-genome aligner with wfmash's capabilities (PyTorch/CUDA)",
    )
    p.add_argument("target", help="target sequences (required)")
    p.add_argument("query", nargs="?", help="query sequences (default: self-map)")
    g = p.add_argument_group("INDEXING")
    g.add_argument("-W", "--write-index", metavar="FILE")
    g.add_argument("-I", "--read-index", metavar="FILE")
    g.add_argument("-b", "--batch", metavar="SIZE", help="target batch size for indexing [4G]")
    g = p.add_argument_group("MINMERS")
    g.add_argument("-k", "--kmer-size", type=int, default=15)
    g.add_argument("-s", "--sketch-size", type=int, default=-1)
    g.add_argument("-w", "--window-size", metavar="INT", help="window size [1k]")
    g = p.add_argument_group("MAPPING")
    g.add_argument("-m", "--approx-mapping", action="store_true")
    g.add_argument("-K", "--input-seeds", metavar="FILE")
    g.add_argument("-p", "--map-pct-id", metavar="FLOAT|aniXX[+/-N]")
    g.add_argument("--ani-sketch-size", type=int, default=1000)
    g.add_argument("-n", "--mappings", metavar="INT")
    g.add_argument("-l", "--block-length", metavar="INT")
    g.add_argument("-c", "--chain-jump", metavar="INT")
    g.add_argument("-P", "--max-length", metavar="INT")
    g.add_argument("-N", "--no-split", action="store_true")
    g = p.add_argument_group("FILTERING")
    g.add_argument("-f", "--no-filter", action="store_true")
    g.add_argument("-M", "--no-merge", action="store_true")
    g.add_argument("-o", "--one-to-one", action="store_true")
    g.add_argument("-O", "--overlap", type=float, default=0.95)
    g.add_argument("-x", "--sparsify", type=float)
    g.add_argument("--hg-filter", metavar="n,Δ,conf")
    g.add_argument("--hg-numerator", type=float, default=1.0)
    g.add_argument("-H", "--l1-hits", type=int, default=3)
    g.add_argument("-F", "--filter-freq", type=float, default=0.0002)
    g = p.add_argument_group("SCAFFOLDING")
    g.add_argument("-S", "--scaffold-mass", metavar="INT")
    g.add_argument("-D", "--scaffold-dist", metavar="INT")
    g.add_argument("-j", "--scaffold-jump", metavar="INT")
    g.add_argument("-r", "--retain-per-scaffold", metavar="INT")
    g.add_argument("--scaffold-overlap", type=float, default=0.5)
    g.add_argument("--scaffold-out", metavar="FILE")
    g = p.add_argument_group("SELECTION")
    g.add_argument("-Y", "--group-prefix", metavar="C")
    g.add_argument("-X", "--self-maps", action="store_true")
    g.add_argument("-L", "--lower-triangular", action="store_true")
    g.add_argument("-T", "--target-prefix", default="")
    g.add_argument("-R", "--target-list", default="")
    g.add_argument("-Q", "--query-prefix", default="")
    g.add_argument("-A", "--query-list", default="")
    g = p.add_argument_group("ALIGNMENT")
    g.add_argument("-i", "--align-paf", metavar="FILE")
    g.add_argument("-E", "--target-padding", metavar="INT")
    g.add_argument("-U", "--query-padding", metavar="INT")
    g.add_argument("-g", "--wfa-params", metavar="m,go1,ge1,go2,ge2")
    g.add_argument("--min-length", type=int, default=32)
    g.add_argument("--min-block-id", type=float, default=0.1)
    g.add_argument("--force-wflign", action="store_true")
    g.add_argument("--wflambda-segment", type=int, default=256)
    g.add_argument("--strict-parity", action="store_true",
                   help="suppress outputs dead in the reference binary "
                        "(pt:Z/iv:Z inversion rows) for clean A/B diffs")
    g = p.add_argument_group("OUTPUT")
    g.add_argument("-a", "--sam", action="store_true")
    g.add_argument("-d", "--md-tag", action="store_true")
    g = p.add_argument_group("DEBUGGING")
    g.add_argument("--path-patching-tsv", metavar="FILE",
                   help="write per-alignment boundary-patch information "
                        "in TSV format to FILE")
    g.add_argument("-G", "--tsv", metavar="PREFIX", dest="wavefront_tsv",
                   help="write each alignment's segmentation-plan cells "
                        "(v, h, info) to PREFIX*.tsv")
    g.add_argument("-u", "--prefix-png", metavar="PREFIX",
                   dest="wavefront_png",
                   help="write each alignment's segmentation-plan plot "
                        "to PREFIX*.png")
    g.add_argument("-z", "--wfplot-max-size", type=int, default=1500,
                   metavar="N", help="max size of the wfplot [1500]")
    g = p.add_argument_group("SYSTEM")
    g.add_argument("-t", "--threads", type=int, default=1)
    g.add_argument("--streaming-minhash", action="store_true")
    g.add_argument("-B", "--tmp-base", metavar="PATH")
    g.add_argument("-Z", "--keep-temp", action="store_true")
    g.add_argument("--quiet", action="store_true")
    g.add_argument("-v", "--version", action="store_true")
    return p


def parse_args(argv=None):
    """Returns (map_params, align_params, approx_mapping, remapping)."""
    parser = build_parser()
    args = parser.parse_args(argv)

    if args.version:
        print(f"wfmash-tpu {__version__} (wfmash {WFMASH_COMPAT_VERSION} compatible)")
        sys.exit(0)

    # temp-file registry (-B dir, -Z keep; reference temp_file.hpp wiring
    # at parse_args.hpp:786-809,923)
    from .utils import tempfiles

    tempfiles.set_dir(args.tmp_base)
    tempfiles.set_keep_temp(args.keep_temp)

    if args.quiet:
        from .utils.progress import set_quiet

        set_quiet(True)

    mp = MapParams()
    ap = AlignParams()

    mp.skip_self = not args.self_maps
    mp.lower_triangular = args.lower_triangular
    mp.keep_low_pct_id = True
    if args.group_prefix is not None:
        mp.prefix_delim = args.group_prefix
        mp.skip_prefix = args.group_prefix != ""
    else:
        mp.prefix_delim = "#"
        mp.skip_prefix = True
    mp.target_list = args.target_list
    mp.target_prefix = args.target_prefix
    mp.query_list = args.query_list
    if args.query_prefix:
        mp.query_prefix = args.query_prefix.split(",")

    mp.ref_sequences = [args.target]
    ap.ref_sequences = [args.target]
    if args.query:
        mp.query_sequences = [args.query]
        ap.query_sequences = [args.query]
    else:
        print("[wfmash] Performing all-vs-all mapping including self mappings.",
              file=sys.stderr)
        mp.query_sequences = [args.target]
        ap.query_sequences = [args.target]

    if args.no_filter:
        mp.filter_mode = FILTER_NONE
    elif args.one_to_one:
        mp.filter_mode = FILTER_ONETOONE
    else:
        mp.filter_mode = FILTER_MAP

    if args.sparsify is not None:
        if args.sparsify == 1:
            mp.sparsity_hash_threshold = U64_MAX
        else:
            mp.sparsity_hash_threshold = int(args.sparsify * U64_MAX)

    if args.wfa_params:
        vals = [int(x) for x in args.wfa_params.split(",")]
        if len(vals) != 5:
            parser.error("5 scoring parameters must be given to -g/--wfa-params")
        (ap.wfa_patching_mismatch_score,
         ap.wfa_patching_gap_opening_score1,
         ap.wfa_patching_gap_extension_score1,
         ap.wfa_patching_gap_opening_score2,
         ap.wfa_patching_gap_extension_score2) = vals

    ap.emit_md_tag = args.md_tag
    ap.sam_format = args.sam
    ap.force_wflign = args.force_wflign
    import os as _os

    ap.strict_parity = (args.strict_parity
                        or _os.environ.get("WFMASH_TPU_STRICT_PARITY") == "1")
    ap.path_patching_tsv = args.path_patching_tsv
    ap.wavefront_tsv_prefix = args.wavefront_tsv
    ap.wavefront_png_prefix = args.wavefront_png
    ap.wfplot_max_size = args.wfplot_max_size
    mp.split = not args.no_split
    ap.split = not args.no_split
    mp.merge_mappings = not args.no_merge

    if args.window_size:
        w = handy_parameter(args.window_size)
        if w <= 0:
            parser.error("window size must be > 0")
        if w < 100:
            parser.error("minimum window size is 100 bp")
        if not args.approx_mapping and w > 10000:
            parser.error("window size (-w) must be <= 10kb when running alignment")
        mp.window_length = w

    if args.map_pct_id:
        m = re.match(r"^ani(\d+)([+-]\d+)?$", args.map_pct_id)
        if m:
            mp.auto_pct_identity = True
            mp.ani_percentile = int(m.group(1))
            if not 1 <= mp.ani_percentile <= 99:
                parser.error("ANI percentile must be between 1 and 99")
            mp.ani_adjustment = float(m.group(2)) if m.group(2) else 0.0
        elif args.map_pct_id == "auto":
            mp.auto_pct_identity = True
            mp.ani_percentile = 25
            mp.ani_adjustment = 0.0
        else:
            pct = float(args.map_pct_id)
            if pct < 50:
                parser.error("minimum nucleotide identity requirement should be >= 50%")
            mp.percentage_identity = pct / 100.0
            mp.auto_pct_identity = False
    # else: default ani50-2 already set in MapParams

    if args.block_length:
        l = handy_parameter(args.block_length)
        if l < 0:
            parser.error("min block length must be >= 0")
        if not args.approx_mapping and l > 30000:
            parser.error("block length (-l) must be <= 30kb when running alignment")
        mp.block_length = l
    if args.chain_jump:
        c = handy_parameter(args.chain_jump)
        if c < 0:
            parser.error("chain jump must be >= 0")
        mp.chain_gap = c
        ap.chain_gap = c
    if args.scaffold_jump:
        mp.scaffold_gap = handy_parameter(args.scaffold_jump)
    if args.scaffold_dist:
        mp.scaffold_max_deviation = handy_parameter(args.scaffold_dist)
    if args.scaffold_mass:
        mp.scaffold_min_length = handy_parameter(args.scaffold_mass)
    if args.scaffold_out:
        mp.scaffold_output_file = args.scaffold_out
    mp.scaffold_overlap_threshold = args.scaffold_overlap

    if args.max_length:
        v = I64_MAX if args.max_length == "inf" else handy_parameter(args.max_length)
        if v <= 0:
            parser.error("max mapping length must be > 0")
        mp.max_mapping_length = v

    mp.overlap_threshold = args.overlap
    mp.kmer_size = args.kmer_size
    ap.kmer_size = args.kmer_size
    ap.min_alignment_length = args.min_length
    ap.min_block_identity = args.min_block_id
    ap.wflambda_segment_length = args.wflambda_segment
    if args.target_padding:
        ap.target_padding = handy_parameter(args.target_padding)
    if args.query_padding:
        ap.query_padding = handy_parameter(args.query_padding)
    mp.threads = args.threads
    ap.threads = args.threads
    mp.sketch_size = args.sketch_size
    mp.use_streaming_minhash = args.streaming_minhash
    mp.hg_numerator = args.hg_numerator

    if args.hg_filter:
        vals = args.hg_filter.split(",")
        if len(vals) != 3:
            parser.error("hg-filter requires numerator,ani-diff,confidence")
        mp.hg_numerator = float(vals[0])
        mp.ANIDiff = float(vals[1]) / 100.0
        mp.ANIDiffConf = float(vals[2]) / 100.0

    mp.minimum_hits = args.l1_hits
    mp.max_kmer_freq = args.filter_freq
    mp.ani_sketch_size = args.ani_sketch_size

    if args.write_index:
        mp.index_filename = args.write_index
        mp.overwrite_index = True
        mp.create_index_only = True
    elif args.read_index:
        mp.index_filename = args.read_index
    if args.batch:
        mp.index_by_size = handy_parameter(args.batch)

    if args.input_seeds:
        mp.use_external_seeds = True
        mp.external_seeds_file = args.input_seeds

    approx_mapping = bool(args.approx_mapping or args.input_seeds)
    remapping = False
    if not approx_mapping:
        if args.align_paf:
            remapping = True
            mp.out_file_name = args.align_paf
            ap.mashmap_paf_file = args.align_paf
        ap.paf_output_file = "/dev/stdout"

    if args.mappings:
        n = args.mappings
        if n in ("inf", "Inf", "∞", "-1"):
            mp.num_mappings_for_segment = U32_MAX
        else:
            v = int(n)
            if v == -1:
                mp.num_mappings_for_segment = U32_MAX
            elif v <= 0:
                parser.error("-n must be > 0 or -1/inf")
            else:
                mp.num_mappings_for_segment = v
    if args.retain_per_scaffold:
        r = args.retain_per_scaffold
        if r in ("inf", "Inf", "∞", "-1"):
            mp.num_mappings_for_scaffold = U32_MAX
        else:
            v = int(r)
            if v == -1:
                mp.num_mappings_for_scaffold = U32_MAX
            elif v <= 0:
                parser.error("-r must be > 0 or -1/inf")
            else:
                mp.num_mappings_for_scaffold = v

    mp.finalize()
    ap.finalize(mp.window_length)
    return mp, ap, approx_mapping, remapping


def main(argv=None) -> int:
    try:
        return _main(argv)
    except NotImplementedError as e:
        print(f"[wfmash] ERROR: {e}", file=sys.stderr)
        return 1
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


def apply_auto_identity(mp) -> None:
    """The identity estimate of the input's groups, and the sketch size
    that follows from it, written into the mapping parameters (when the
    identity was not given)."""
    if not mp.auto_pct_identity:
        return
    from .map.ani import estimate_identity_for_groups

    ani = estimate_identity_for_groups(mp)
    if ani is not None:
        mp.percentage_identity = ani
        if not mp.sketch_size_manually_set:
            md = 1.0 - mp.percentage_identity
            dens = 0.02 * (1.0 + md / 0.1)
            mp.sketch_size = int(dens * (mp.window_length - mp.kmer_size))


def _main(argv=None) -> int:
    mp, ap, approx_mapping, remapping = parse_args(argv)
    try:
        device = resolve()
    except RuntimeError as e:
        print(f"[wfmash] ERROR: {e}", file=sys.stderr)
        return 1

    apply_auto_identity(mp)

    if mp.use_external_seeds:
        from .map.external import process_external_seeds

        process_external_seeds(mp, sys.stdout)
        return 0

    from .runner import run_mapping

    if approx_mapping:
        run_mapping(mp, sys.stdout, device=device)
        if os.environ.get("WFMASH_TPU_PERF"):
            from .utils import perf

            for k, v in sorted(perf.snapshot().items()):
                print(f"[wfmash::perf] {k} = {v:.3f}", file=sys.stderr)
        return 0

    # full map + align pipeline; the handoff PAF goes through the temp
    # registry so -B places it and -Z preserves it
    from .utils import tempfiles

    if remapping:
        paf_path = ap.mashmap_paf_file
    else:
        paf_path = tempfiles.create(suffix=".paf")
        with open(paf_path, "w") as fh:
            run_mapping(mp, fh, device=device)
        ap.mashmap_paf_file = paf_path
        if tempfiles.keep_temp():
            print(f"[wfmash] keeping temp mapping PAF: {paf_path}",
                  file=sys.stderr)

    from .align import wfa_seg, wfa_sweep
    from .align.engine import run_alignment

    run_alignment(ap, sys.stdout, device)
    if os.environ.get("WFMASH_TPU_PERF"):
        print(f"[wfmash::perf] seg_wfa kernel launches = {wfa_seg.LAUNCHES}",
              file=sys.stderr)
        print(f"[wfmash::perf] sweep_wfa kernel launches = "
              f"{wfa_sweep.LAUNCHES}", file=sys.stderr)
    return 0
