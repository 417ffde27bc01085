"""The host exact pass's share of the chunks' wall (align/segmented.py's
span align.exact: the jobs no tier takes, solved by the exact engine
while the device thread runs the tiers)."""

from benchlib.readers import counter_share


def read(ctx):
    return counter_share(ctx, "align.exact_s")
