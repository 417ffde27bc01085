"""The escalation pass's share of the chunks' wall (align/segmented.py's
span align.escalate: the pieces the tiers failed, solved by the exact
engine after the device thread is joined). None for a program without
the span."""

from benchlib.readers import counter_share


def read(ctx):
    return counter_share(ctx, "align.escalate_s")
