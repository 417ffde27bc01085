"""Share of the segmented engine's pieces sent on to the exact engine
(align/segmented.py's counters align.escalated over align.segments:
tier rejects, pieces no tier holds and unanchorable blocks, over every
piece and whole job the batches solved), in %. None for a program
without the counters."""

from benchlib.readers import counter_sum


def read(ctx):
    segments = counter_sum(ctx, "align.segments")
    if segments <= 0:
        return None
    return 100.0 * counter_sum(ctx, "align.escalated") / segments
