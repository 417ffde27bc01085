"""Anchor planning's share of the chunks' wall (align/segmented.py's
align.plan_s, the boundary patches' planning included)."""

from benchlib.readers import counter_share


def read(ctx):
    return counter_share(ctx, "align.plan_s")
