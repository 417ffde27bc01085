"""Anchor-chain segmented alignment over the port's segment solver.

The reference engine (wfmash_tpu/align/segmented.py) plans anchor chains
on the host, cuts blocks into ~256 bp pieces and sends pieces, small
blocks and boundary patches to a TieredSegmentSolver. Its planning,
streaming and escalation code has no jax in it and is inherited as it is;
only construction differs, because the reference's __init__ imports the
JAX solver module.
"""

from __future__ import annotations

import os

from wfmash_tpu.align import segmented as _ref

from .wfa_seg import TieredSegmentSolver


class SegmentedEngine(_ref.SegmentedEngine):
    """The reference SegmentedEngine on the port's TieredSegmentSolver.

    exact_engine takes the escalations (the port uses the native
    HostWfaEngine). Patches and inversion tries ride the kernel tiers, as
    they do on a local accelerator in the reference."""

    def __init__(self, penalties, exact_engine, device, solver=None):
        # the reference's attributes (segmented.py:519-565); its hooks
        # into the JAX exact engine (seg_solver, HOST_LEN, banded_leaves)
        # have no counterpart on the native exact engine
        self.p = penalties
        self.exact = exact_engine
        self.seg_target = 256
        self.min_block = 600
        self.solver = solver or TieredSegmentSolver(penalties, device)
        self.stats = {"segments": 0, "escalated": 0, "exact_blocks": 0,
                      "inversions": 0, "banded": 0}
        self.banded_pieces = os.environ.get(
            "WFMASH_TPU_EXACT_PIECES", "0") != "1"
        self.threads = getattr(exact_engine, "threads", 1)
        self.min_inversion_length = 23   # align_parameters.hpp:70
        self.detect_inversions = True
        self.inversions: list = []
        self._host_small_cache = False

    def _host_smalls_ok(self) -> bool:
        return False
