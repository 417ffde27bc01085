"""Kernel B's (csrc/sweep_wfa.cu) operations bound, a frozen copy of
chip_smoke.py's arithmetic under its names, so that a later change to
chip_smoke.py cannot move the yardstick.

The kernel counts the wavefront lanes its levels reached (the seeded
lanes widened by one a side per level, inside the band); the port sums
them over its launches in the perf counter `align.sweep.lanes`. Each
lane and level needs SWEEP_OPS_PER_LANE 32-bit operations of the
recurrences (address arithmetic, the match extension and the backtrace
not counted), and the card runs at most INT_OPS_PER_S of them.
"""

from __future__ import annotations

INT_OPS_PER_S = 67e12          # non-tensor fp32 FLOP rate, published
# Sweep kernel (csrc/sweep_wfa.cu, gap_wave and the level loop's body):
#   52  four gap cells of 13: the segment kernel's 3 (D) or 5 (I), then
#       select the anchor, the gap-open cell (D: a subtraction; two
#       selects), and the crossing (anchor unset, offset on the split
#       line with a subtraction for D, two ANDs, select)
#    3  mismatch candidate
#    5  its crossing: anchor unset, on the split line (subtraction,
#       compare), AND, select
#   12  M = first strict maximum of five with its anchor: four compares,
#       eight selects
#   10  bounds on offset and anchor: v, four compares, three ANDs, two
#       selects
#    6  crossing inside the extension run (one split axis a problem):
#       anchor unset, two compares, two ANDs, select
#    3  finish: end diagonal, offset >= qlen, AND
SWEEP_OPS_PER_LANE = 52 + 3 + 5 + 12 + 10 + 6 + 3


def sweep_ops_ms(lanes: int) -> float:
    """The least milliseconds the card could take for the recurrences of
    `lanes` reached lanes (chip_smoke.py's `ops_ms` of a sweep batch)."""
    return lanes * SWEEP_OPS_PER_LANE / INT_OPS_PER_S * 1e3


def ops_roofline_pct(lanes: int, kernel_ms: float) -> float:
    """Kernel B's share of its operations roofline: the operations bound
    of `lanes` over the launches' device time, in %."""
    return 100.0 * sweep_ops_ms(lanes) / kernel_ms
