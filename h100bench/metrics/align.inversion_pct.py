"""The inversion try's share of the chunks' wall (align/segmented.py's
span align.inversion: the reverse-complement try on divergent pieces)."""

from benchlib.readers import counter_share


def read(ctx):
    return counter_share(ctx, "align.inversion_s")
