"""The stitching's share of the chunks' wall (align/segmented.py's span
align.assemble: each block's piece CIGARs joined into one)."""

from benchlib.readers import counter_share


def read(ctx):
    return counter_share(ctx, "align.assemble_s")
