"""The tier solver's share of the chunks' wall (align/wfa_seg.py's
align.device_s: host wall around pack, launch, wait and decode, on a
thread that overlaps planning)."""

from benchlib.readers import counter_share


def read(ctx):
    return counter_share(ctx, "align.device_s")
