"""Configuration parameters for mapping and alignment.

Mirrors wfmash's two parameter structs and the defaults set in its CLI
parser (single source of truth there, reproduced here):

* ``skch::Parameters``   (reference: src/map/include/map_parameters.hpp:32-108)
* ``align::Parameters``  (reference: src/align/include/align_parameters.hpp:16-82)
* defaults & derived values (reference: src/interface/parse_args.hpp:26-927)
* compile-time constants ``skch::fixed`` (map_parameters.hpp:114-130)
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field


U32_MAX = 0xFFFFFFFF
U64_MAX = 0xFFFFFFFFFFFFFFFF
I64_MAX = 0x7FFFFFFFFFFFFFFF


class fixed:
    """Internal constants not exposed on the CLI (map_parameters.hpp:114-130)."""

    ss_table_max = 1000.0        # max size of dp table for hypergeometric filtering
    pval_cutoff = 1e-3           # p-value cutoff for determining window size
    confidence_interval = 0.95   # CI to relax jaccard cutoff for mapping
    percentage_identity = 0.70   # default identity in the mapping step
    ANIDiff = 0.0                # stage 1 ANI diff threshold
    ANIDiffConf = 0.999          # ANI diff confidence


# Filter modes (base_types.hpp:115-120)
FILTER_MAP = 1
FILTER_ONETOONE = 2
FILTER_NONE = 3

# Strand labels (base_types.hpp:101-106)
STRAND_FWD = 1
STRAND_AMBIG = 0
STRAND_REV = -1


@dataclass
class MapParams:
    """Mapping-phase parameters (mirrors skch::Parameters).

    Field defaults correspond to running the reference CLI with no optional
    flags (parse_args.hpp), EXCEPT fields marked "derived" which are
    computed by :meth:`finalize`.
    """

    kmer_size: int = 15                       # -k (parse_args.hpp:500-511)
    window_length: int = 1000                 # -w (parse_args.hpp:317-340)
    block_length: int = 0                     # -l (parse_args.hpp:398-415)
    chain_gap: int = 2000                     # -c (parse_args.hpp:417-428)
    max_mapping_length: int = 50000           # -P (parse_args.hpp:472-483)
    alphabet_size: int = 4
    percentage_identity: float = fixed.percentage_identity  # -p
    stage2_full_scan: bool = True             # parse_args.hpp:702
    stage1_topANI_filter: bool = True         # parse_args.hpp:701
    ANIDiff: float = fixed.ANIDiff            # --hg-filter Δ
    ANIDiffConf: float = fixed.ANIDiffConf    # --hg-filter conf
    filter_mode: int = FILTER_MAP             # -f/-o (parse_args.hpp:227-235)
    num_mappings_for_segment: int = U32_MAX   # -n, default inf (parse_args.hpp:833-857)
    num_mappings_for_scaffold: int = 1        # -r (parse_args.hpp:859-883)
    num_mappings_for_short_sequence: int = 1  # parse_args.hpp:885
    drop_rand: bool = False                   # disabled (parse_args.hpp:312)
    threads: int = 1                          # -t
    ref_sequences: list[str] = field(default_factory=list)
    query_sequences: list[str] = field(default_factory=list)
    out_file_name: str = ""
    index_filename: str = ""                  # -W / -I
    overwrite_index: bool = False
    create_index_only: bool = False
    split: bool = True                        # !-N (parse_args.hpp:311)
    lower_triangular: bool = False            # -L
    skip_self: bool = True                    # !-X (parse_args.hpp:171)
    skip_prefix: bool = True                  # -Y default '#' (parse_args.hpp:183-189)
    prefix_delim: str = "#"
    target_list: str = ""                     # -R
    target_prefix: str = ""                   # -T
    merge_mappings: bool = True               # !-M (parse_args.hpp:315)
    keep_low_pct_id: bool = True              # parse_args.hpp:173
    filter_length_mismatches: bool = True     # parse_args.hpp:698
    kmer_complexity_threshold: float = 0.0    # parse_args.hpp:656
    query_list: str = ""                      # -A
    query_prefix: list[str] = field(default_factory=list)  # -Q
    sketch_size: int = -1                     # -s; derived if <0
    sketch_size_manually_set: bool = False
    hg_numerator: float = 1.0                 # --hg-numerator / --hg-filter n
    total_reference_size: int = 0
    estimated_unique_kmers: int = 0
    sparsity_hash_threshold: int = U64_MAX    # -x (parse_args.hpp:237-248)
    overlap_threshold: float = 0.95           # -O (parse_args.hpp:494-498)
    scaffold_overlap_threshold: float = 0.5   # --scaffold-overlap (parse_args.hpp:46)
    scaffold_max_deviation: int = 100000      # -D (parse_args.hpp:442-450)
    scaffold_gap: int = 100000                # -j (parse_args.hpp:431-439)
    scaffold_min_length: int = 10000          # -S (parse_args.hpp:453-462)
    scaffold_output_file: str = ""            # --scaffold-out
    legacy_output: bool = False
    index_by_size: int = I64_MAX              # -b (parse_args.hpp:760-769)
    minimum_hits: int = 3                     # -H (parse_args.hpp:728-732)
    max_kmer_freq: float = 0.0002             # -F (parse_args.hpp:734-738)
    use_progress_bar: bool = False
    auto_pct_identity: bool = True            # default ani50-2 (parse_args.hpp:40-43)
    ani_percentile: int = 50
    ani_adjustment: float = -2.0
    use_streaming_minhash: bool = False       # --streaming-minhash (experimental)
    ani_sketch_size: int = 1000               # --ani-sketch-size
    use_external_seeds: bool = False          # -K
    external_seeds_file: str = ""

    def finalize(self) -> "MapParams":
        """Compute derived values; mirrors parse_args.hpp:636-646."""
        if self.sketch_size is None or self.sketch_size <= 0:
            md = 1.0 - self.percentage_identity
            dens = 0.02 * (1.0 + md / 0.1)
            self.sketch_size = int(dens * (self.window_length - self.kmer_size))
        else:
            self.sketch_size_manually_set = True
        if self.sketch_size > self.window_length:
            raise ValueError(
                f"sketch size ({self.sketch_size}) must be <= window size "
                f"({self.window_length})"
            )
        if self.window_length >= self.max_mapping_length:
            raise ValueError("window size should not be larger than max mapping length")
        if self.block_length >= self.max_mapping_length:
            raise ValueError("block length should not be larger than max mapping length")
        return self


@dataclass
class AlignParams:
    """Alignment-phase parameters (mirrors align::Parameters)."""

    threads: int = 1
    kmer_size: int = 15

    # WFA scoring for the main (wflign) alignment: M,X,O,E = 0,2,3,1
    # (parse_args.hpp:266-270,297-299)
    wfa_mismatch_score: int = 2
    wfa_gap_opening_score: int = 3
    wfa_gap_extension_score: int = 1
    wflign_mismatch_score: int = 2
    wflign_gap_opening_score: int = 3
    wflign_gap_extension_score: int = 1

    # Two-piece affine penalties used for the primary end-to-end alignment and
    # boundary patching: x,o1,e1,o2,e2 = 5,8,2,24,1 (parse_args.hpp:289-295)
    wfa_patching_mismatch_score: int = 5
    wfa_patching_gap_opening_score1: int = 8
    wfa_patching_gap_extension_score1: int = 2
    wfa_patching_gap_opening_score2: int = 24
    wfa_patching_gap_extension_score2: int = 1

    wflign_max_mash_dist: float = -1.0        # parse_args.hpp:301
    wflign_min_wavefront_length: int = 1024   # parse_args.hpp:302
    wflign_max_distance_threshold: float = -1.0
    wflambda_segment_length: int = 256        # parse_args.hpp:586-591

    wflign_max_len_major: int = 0             # derived: w*512 (parse_args.hpp:593)
    wflign_max_len_minor: int = 0             # derived: w*128 (parse_args.hpp:594)
    wflign_erode_k: int = -1                  # estimated from divergence
    wflign_min_inv_patch_len: int = 23        # parse_args.hpp:596
    wflign_max_patching_score: int = 0        # estimated from penalties

    target_padding: int = -1                  # -E, derived: min(w, 5000)
    query_padding: int = -1                   # -U, derived: min(w, 5000)

    min_identity: float = 0.0                 # disabled (parse_args.hpp:566)
    min_alignment_length: int = 32            # --min-length (parse_args.hpp:569-573)
    min_block_identity: float = 0.1           # --min-block-id (parse_args.hpp:576-584)

    force_wflign: bool = False                # --force-wflign
    split: bool = True
    chain_gap: int = 2000
    emit_md_tag: bool = False                 # -d
    sam_format: bool = False                  # -a
    no_seq_in_sam: bool = False
    disable_chain_patching: bool = False
    # --strict-parity: suppress outputs the current reference binary can
    # never emit (pt:Z/iv:Z inversion rows come from wflign_patch.cpp
    # code that is dead upstream) so A/B PAF diffs vs a real wfmash run
    # are clean. Also honored from env WFMASH_TPU_STRICT_PARITY=1.
    strict_parity: bool = False
    # --path-patching-tsv FILE: per-alignment boundary-patch trace
    # (reference: parse_args.hpp:146 / wflign_patch.cpp:1610-1613, a
    # WFA_PNG_TSV_TIMING debug build option there; adapted to this
    # engine's erode+ends-free patch architecture)
    path_patching_tsv: str | None = None
    # -G/--tsv PREFIX, -u/--prefix-png PREFIX, -z/--wfplot-max-size:
    # per-alignment segmentation-plan dumps (reference debug flags
    # parse_args.hpp:142-145; see align/debugplot.py)
    wavefront_tsv_prefix: str | None = None
    wavefront_png_prefix: str | None = None
    wfplot_max_size: int = 1500
    multithread_fasta_input: bool = False
    use_progress_bar: bool = False

    ref_sequences: list[str] = field(default_factory=list)
    query_sequences: list[str] = field(default_factory=list)
    mashmap_paf_file: str = ""                # -i or temp file
    paf_output_file: str = "/dev/stdout"

    def finalize(self, window_length: int) -> "AlignParams":
        """Derived values depending on the mapping window (parse_args.hpp:593-621)."""
        self.wflign_max_len_major = window_length * 512
        self.wflign_max_len_minor = window_length * 128
        if self.target_padding < 0:
            self.target_padding = min(window_length, 5000)
        if self.query_padding < 0:
            self.query_padding = min(window_length, 5000)
        return self


def fake_map_quality(nuc_identity: float) -> int:
    """PAF column 12 pseudo-quality (mappingOutput.hpp:97)."""
    if nuc_identity == 1.0:
        return 255
    return int(round(-10.0 * math.log10(1.0 - nuc_identity)))
